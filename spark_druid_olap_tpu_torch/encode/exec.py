"""Encoded-domain execution: aggregate and prune WITHOUT decoding.

Port of ``spark_druid_olap_tpu/encode/exec.py``: a copy kept inside the
PyTorch package, which imports nothing of the JAX package. Its caller is
``tier/handles.py`` (zone maps straight from the manifest's chunk
headers).

The routing tiers of the engine never change for encoded stores — the
device path decodes chunks on fault and computes on the same stacked
arrays as always (the ``materialize()`` fallback guarantees every query
shape works). What this module adds are the paths where the encoded
form answers a question outright:

- **zone maps from headers** (:func:`chunk_bounds`): integer codec
  headers carry vmin/vmax, so segment min/max pruning reads the header
  — no payload decode, no cold-tier fault.
- **FoR-domain interval pruning** (:func:`chunk_day_overlap`): a
  fordelta time-days header bounds the chunk's day range; an interval
  that misses it skips the chunk before any decode
  (``ops/time_ops.py:interval_day_range`` supplies the day arithmetic).
- **RLE-run aggregation** (:func:`rle_groupby`): group-by over an
  RLE-encoded dimension aggregates run-at-a-time — count partials are
  the run lengths themselves and sum partials multiply run values by
  run length (``ops/groupby.py:run_weighted_partials``), touching
  O(runs) values instead of O(rows).

These functions are pure host-side numpy over (payload, header) chunk
pairs; ``tests/test_torch_encoding.py`` holds them bit for bit against
the decoded path and the JAX package's copies.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from spark_druid_olap_tpu_torch.encode import codecs as C


def chunk_bounds(header: dict) -> Optional[Tuple[int, int]]:
    """(vmin, vmax) of an encoded chunk from its header alone (None for
    raw/float/empty chunks — those need a decode to bound)."""
    return C.header_bounds(header)


def chunk_day_overlap(header: dict, intervals) -> Optional[bool]:
    """Does a time-days chunk overlap any [lo_ms, hi_ms) interval?
    Decided purely in the FoR domain via the header's day bounds; None
    when the header carries no bounds (raw chunk) and the caller must
    fall back to the decoded mask."""
    from spark_druid_olap_tpu_torch.ops import time_ops
    b = C.header_bounds(header)
    if b is None:
        return None
    lo_day, hi_day = b
    for lo, hi in intervals:
        dlo, _rlo, dhi, rhi = time_ops.interval_day_range(int(lo), int(hi))
        # interval covers [dlo, dhi] fully only up to rhi ms on dhi;
        # day-level overlap is the prune test (row-level residual masks
        # still apply on straddling chunks)
        last = dhi if rhi > 0 else dhi - 1
        if lo_day <= last and hi_day >= dlo:
            return True
    return False


def decode_chunk(payload, header: dict) -> np.ndarray:
    """The materialize() fallback: raw rows of one chunk."""
    return C.decode_array(payload, header)


def rle_groupby(dim_payload, dim_header: dict, n_keys: int,
                metric: Optional[np.ndarray] = None,
                ) -> Dict[str, np.ndarray]:
    """Aggregate one segment chunk grouped by an RLE-encoded dimension
    without expanding the dimension to rows.

    Returns ``{"count": int64[n_keys], "sum": f64[n_keys]?}`` partials.
    ``metric`` (decoded rows, same length as the chunk) is reduced per
    run with ``np.add.reduceat`` — the dimension codes themselves never
    materialize. Falls back to a decoded group-by for non-RLE chunks.
    """
    from spark_druid_olap_tpu_torch.ops.groupby import run_weighted_partials
    if dim_header.get("c") == C.RLE:
        values, lengths = C.rle_runs(dim_payload, dim_header)
    else:
        rows = C.decode_array(dim_payload, dim_header)
        change = np.flatnonzero(np.diff(rows.astype(np.int64))) + 1
        starts = np.concatenate([[0], change]) if len(rows) \
            else np.empty(0, dtype=np.int64)
        lengths = np.diff(np.concatenate([starts, [len(rows)]])) \
            if len(rows) else np.empty(0, dtype=np.int64)
        values = rows[starts.astype(np.int64)] if len(rows) \
            else rows[:0]
    run_sums = None
    if metric is not None and len(lengths):
        starts = np.concatenate(
            [[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
        run_sums = np.add.reduceat(
            np.asarray(metric, dtype=np.float64), starts)
    return run_weighted_partials(values, lengths, n_keys,
                                 run_sums=run_sums)


def reduce_chunk(payload, header: dict, op: str):
    """sum / min / max / count over one encoded chunk, computed in the
    encoded domain where the codec allows:

    - count: the header's row count (no payload read at all)
    - min/max (integer codecs): the header's vmin/vmax
    - sum over RLE: run value x run length, O(runs)
    - sum over fordelta: first + weighted deltas (value i contributes
      (n - i) copies of delta i), O(n) adds but zero row materialization
    - anything else: decode fallback
    """
    n = int(header["n"])
    if op == "count":
        return n
    if n == 0:
        return None
    if op in ("min", "max"):
        b = C.header_bounds(header)
        if b is not None:
            return b[0] if op == "min" else b[1]
    if op == "sum":
        c = header.get("c")
        if c == C.RLE:
            values, lengths = C.rle_runs(payload, header)
            return int(np.dot(values.astype(np.int64), lengths)) \
                if values.dtype.kind in "iub" else \
                float(np.dot(values.astype(np.float64), lengths))
        if c == C.FORDELTA:
            d = C._unpack_bits(payload, n - 1,
                               int(header["bits"])).astype(np.int64)
            d += int(header["dmin"])
            weights = np.arange(n - 1, 0, -1, dtype=np.int64)
            return n * int(header["first"]) + int(np.dot(d, weights))
    rows = C.decode_array(payload, header)
    if op == "sum":
        return int(rows.astype(np.int64).sum()) \
            if rows.dtype.kind in "iub" else float(rows.sum())
    return rows.min() if op == "min" else rows.max()


def segment_bounds_from_refs(refs: Sequence) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Per-segment (mins, maxs) zone maps straight from encoded tier
    refs' headers (tier/store.py:BlobRef.header). None if any non-empty
    segment lacks header bounds — partial zone maps would silently
    unprune."""
    mins = np.full(len(refs), np.inf)
    maxs = np.full(len(refs), -np.inf)
    for i, r in enumerate(refs):
        if not r.count:
            continue
        h = r.header()
        b = C.header_bounds(h) if h is not None else None
        if b is None:
            return None
        mins[i], maxs[i] = float(b[0]), float(b[1])
    return mins, maxs
