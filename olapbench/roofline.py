"""The yardstick of the kernels' roofline shares: peaks and logical work.

A statement's least time on a card is the larger of its bytes over the
card's memory bandwidth and its operations over its float32 rate. Its
work is counted from the statement alone, whatever kernel serves it:

- bytes: the rows in its time range, times the stored width of every
  column it reads (the configuration's ``widths``), plus its answer's
  cells at 8 bytes each;
- operations: the rows in its time range times the columns it reads (one
  compare or add per value).

A fused launch of the shared-scan coalescer reads the union of its
statements' columns once, over the union of their time ranges.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from olapbench.plain import day

# Published peaks by ``torch.cuda.get_device_name(0)``: NVIDIA's data sheet
# of the H100 SXM (3.35 TB/s of HBM3, 67 TFLOP/s of float32 outside the
# tensor cores), at its full 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "ops_per_s": 67e12},
}

ANSWER_CELL_BYTES = 8


def peaks(device_name: str) -> dict:
    if device_name not in PEAKS:
        raise KeyError(f"no published peaks for {device_name!r}; add the "
                       f"card to olapbench/roofline.py PEAKS")
    return PEAKS[device_name]


Range = Optional[Tuple[Optional[str], Optional[str]]]


class TimeIndex:
    """Counts the rows whose time column lies in a union of ranges."""

    def __init__(self, days: np.ndarray):
        self.days = np.sort(days)

    def rows(self, ranges: Iterable[Range]) -> int:
        spans = []
        for r in ranges:
            if r is None:
                return len(self.days)
            lo, hi = r
            spans.append((-np.inf if lo is None else day(lo),
                          np.inf if hi is None else day(hi)))
        spans.sort()
        n, end = 0, -np.inf
        for lo, hi in spans:          # merge, then count [lo, hi) once
            lo = max(lo, end)
            if hi > lo:
                n += int(np.searchsorted(self.days, hi, "left")
                         - np.searchsorted(self.days, lo, "left"))
                end = hi
        return n


def work(widths: Dict[str, int], columns: Sequence[str], rows: int,
         answer_cells: int) -> Tuple[float, float]:
    """``(bytes, operations)`` of reading ``columns`` over ``rows`` rows
    and writing ``answer_cells`` cells."""
    missing = [c for c in columns if c not in widths]
    if missing:
        raise KeyError(f"no stored width for {missing} in the "
                       f"configuration's widths")
    return (float(rows * sum(widths[c] for c in columns)
                  + answer_cells * ANSWER_CELL_BYTES),
            float(rows * len(columns)))


def bound_s(nbytes: float, ops: float, peak: dict) -> float:
    return max(nbytes / peak["bytes_per_s"], ops / peak["ops_per_s"])


def union_columns(column_lists: Iterable[Sequence[str]]) -> List[str]:
    out: List[str] = []
    for cols in column_lists:
        out.extend(c for c in cols if c not in out)
    return out
