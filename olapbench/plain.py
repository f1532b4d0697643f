"""The plain reference's toolkit: masks, grouping and sums in numpy.

Each statement template's ``reference(t, p, P)`` computes its answer from
the generated :class:`~olapbench.data.table.Table` with these helpers
alone. ``Plain()`` computes as the configuration states (integers exact
in int64, floats in float64); ``Plain(np.float32)`` is the correctness
control: the same reference with its numbers, products and sums in
float32, accumulated in row order, as a kernel that summed into float32
accumulators would. Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

EPOCH = np.datetime64("1970-01-01", "D")


def day(iso: str) -> int:
    """Days since the epoch of an ISO date."""
    return int((np.datetime64(iso, "D") - EPOCH).astype(int))


def year_of(days: np.ndarray) -> np.ndarray:
    return (EPOCH + days.astype("timedelta64[D]")).astype(
        "datetime64[Y]").astype(np.int64) + 1970


class Plain:
    def __init__(self, table, float_dtype=np.float64):
        self.t = table
        self.f = np.dtype(float_dtype)
        self.keys: List[str] = []     # the last group()'s key columns
        # the last group()'s float aggregates: per output row, the sum of
        # the magnitudes of the values it adds up (of their mean for avg)
        self.scales: Dict[str, np.ndarray] = {}

    # -- values and masks ---------------------------------------------------
    def num(self, name: str) -> np.ndarray:
        """A numeric column: integers as int64 (exact), floats in the
        reference's float type; both in float32 in the control."""
        c = self.t.col(name)
        if c.dtype.kind in "iu" and self.f == np.float64:
            return c.astype(np.int64, copy=False)
        return c.astype(self.f, copy=False)

    def col(self, name: str) -> np.ndarray:
        return self.t.col(name)

    def cents(self, name: str) -> np.ndarray:
        """A two-decimal column as whole hundredths (exact comparisons)."""
        return np.rint(self.t.col(name) * 100).astype(np.int64)

    def eq(self, name: str, value) -> np.ndarray:
        if self.t.kind(name) == "str":
            value = self.t.code(name, value)
        return self.t.col(name) == value

    def isin(self, name: str, values: Sequence) -> np.ndarray:
        if self.t.kind(name) == "str":
            values = [self.t.code(name, v) for v in values]
        return np.isin(self.t.col(name), values)

    def between(self, name: str, lo, hi) -> np.ndarray:
        """``lo <= name <= hi``; strings by their sorted codes."""
        c = self.t.col(name)
        if self.t.kind(name) == "str":
            a, b = self.t.code_range(name, lo, hi)
            return (c >= a) & (c < b)
        return (c >= lo) & (c <= hi)

    def prefix(self, name: str, head: str) -> np.ndarray:
        """``name LIKE 'head%'``."""
        vocab = self.t.vocab(name)
        return np.isin(self.t.col(name),
                       np.flatnonzero(np.char.startswith(vocab, head)))

    # -- aggregation --------------------------------------------------------
    def _sum(self, idx: np.ndarray, vals: np.ndarray, k: int) -> np.ndarray:
        if vals.dtype.kind in "iub":
            vals = vals.astype(np.int64, copy=False)
            if not len(vals) or int(np.abs(vals).max()) * len(vals) < 2**53:
                # float64 partial sums of integers stay exact below 2^53
                return np.bincount(idx, weights=vals,
                                   minlength=k).astype(np.int64)
            acc = np.zeros(k, np.int64)
            np.add.at(acc, idx, vals)
            return acc
        if self.f == np.float64:
            return np.bincount(idx, weights=vals, minlength=k)
        acc = np.zeros(k, self.f)
        np.add.at(acc, idx, vals.astype(self.f, copy=False))
        return acc.astype(np.float64)

    def group(self, keys: List[str], mask: np.ndarray,
              aggs: Dict[str, object],
              key_values: Optional[Dict[str, np.ndarray]] = None
              ) -> pd.DataFrame:
        """GROUP BY ``keys`` over the rows of ``mask``.

        ``aggs`` maps an output column to an array of per-row values
        (summed), ``"count"`` (rows), or ``("avg", values)``. A key is a
        table column, or an array in ``key_values`` under its output name
        (a derived key such as a year). Groups with no row are absent; the
        output has the keys then the aggregates, in the dict orders the
        caller gives."""
        key_values = key_values or {}
        self.keys, self.scales = list(keys), {}
        rows = np.flatnonzero(mask)
        codes, radix = [], []
        for k in keys:
            v = key_values[k] if k in key_values else self.t.col(k)
            v = np.asarray(v)[rows].astype(np.int64)
            lo = int(v.min()) if len(v) else 0
            hi = int(v.max()) if len(v) else 0
            codes.append((v - lo, lo))
            radix.append(hi - lo + 1)
        idx = np.zeros(len(rows), np.int64)
        for (c, _), r in zip(codes, radix):
            idx = idx * r + c
        k_space = int(np.prod(radix)) if radix else 1
        dense = k_space <= 1 << 24
        if not dense:
            uniq, idx = np.unique(idx, return_inverse=True)
            k_space = len(uniq)
        n = np.bincount(idx, minlength=k_space)
        live = np.flatnonzero(n) if keys else np.arange(1)
        out = {}
        for i, k in enumerate(keys):
            flat = live if dense else uniq[live]
            for r in radix[i + 1:]:
                flat = flat // r
            v = flat % radix[i] + codes[i][1]
            if k not in key_values and self.t.kind(k) == "str":
                v = self.t.vocab(k)[v]
            out[k] = v
        for name, a in aggs.items():
            if isinstance(a, str) and a == "count":
                out[name] = n[live].astype(np.int64)
            elif isinstance(a, tuple) and a[0] == "avg":
                v = np.asarray(a[1])[rows]
                out[name] = self._sum(idx, v, k_space)[live] / n[live]
                self.scales[name] = np.bincount(
                    idx, weights=np.abs(v.astype(np.float64)),
                    minlength=k_space)[live] / n[live]
            else:
                v = np.asarray(a)[rows]
                out[name] = self._sum(idx, v, k_space)[live]
                if v.dtype.kind == "f":
                    self.scales[name] = np.bincount(
                        idx, weights=np.abs(v.astype(np.float64)),
                        minlength=k_space)[live]
        return pd.DataFrame(out)

    def total(self, mask: np.ndarray, aggs: Dict[str, object]
              ) -> pd.DataFrame:
        """One row of aggregates over the rows of ``mask`` (no GROUP BY)."""
        return self.group([], mask, aggs)
