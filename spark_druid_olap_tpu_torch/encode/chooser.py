"""Per-column encoding chooser (checkpoint / compaction time).

Port counterpart of ``spark_druid_olap_tpu/encode/chooser.py``: a copy
kept inside the PyTorch package, which imports nothing of the JAX
package. The original's thresholds (``sdot.encode.min.ratio``,
``sdot.encode.rle.max.run.frac``) are constants here at its defaults,
and its ingest-time ``annotate_datasource`` hints are left out: the
snapshot writer, the chooser's only caller, measures the arrays
themselves.

One analytic O(n) pass per column (``codecs.estimate_sizes``) scores
every eligible codec; the winner must beat raw by at least
``MIN_RATIO`` or the column stays raw. Heuristics mirror what the
estimates measure:

- **bool** (validity masks): bitpack, 1 bit/row — 8x, always wins.
- **dictionary codes**: bitpack at ``ceil(log2(card))`` bits; when the
  data is sorted/low-cardinality enough that runs/rows falls under
  ``RLE_MAX_RUN_FRAC``, RLE competes and wins on long runs.
- **time days** (monotone after ingest's time sort): fordelta — the
  per-row cost is the delta width, near-zero on dense time ranges.
- **LONG/DATE metrics**: bitpack over the value range; RLE when runny.
- **floats**: raw, always (bit-exactness contract; see codecs.py).

The choice is advisory and per COLUMN; the encoder still falls back to
raw per SEGMENT chunk when a choice fails to shrink a particular chunk
(``codecs.encode_chunk``), so an adversarial segment never inflates.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from spark_druid_olap_tpu_torch.encode import codecs as CODECS

# the whole-column compression ratio (raw bytes / estimated encoded
# bytes) a codec must reach before the chooser encodes a column
MIN_RATIO = 1.2
# runs/rows above this fraction disqualify the RLE candidate outright
RLE_MAX_RUN_FRAC = 0.5


def choose_codec(arr: np.ndarray) -> Optional[str]:
    """Codec name for one column array, or None for raw. Pure function
    of the array — checkpoint and compaction choose identically."""
    if arr.ndim != 1 or len(arr) == 0:
        return None
    if arr.dtype.kind == "f":
        return None
    sizes = CODECS.estimate_sizes(arr)
    if not sizes:
        return None
    if CODECS.RLE in sizes:
        # near-unique columns degenerate to ~1 run/row; drop the RLE
        # candidate before it can win on a fluke estimate
        runs = sizes[CODECS.RLE] // (arr.dtype.itemsize + 4)
        if runs > RLE_MAX_RUN_FRAC * len(arr):
            sizes.pop(CODECS.RLE)
    if not sizes:
        return None
    codec = min(sizes, key=lambda c: (sizes[c], c))
    best = max(1, sizes[codec])
    if arr.nbytes / best < MIN_RATIO:
        return None
    return codec
