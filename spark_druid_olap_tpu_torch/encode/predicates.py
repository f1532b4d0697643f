"""Dictionary-predicate rewrite: string predicates -> code-domain tests.

Port counterpart of ``spark_druid_olap_tpu/encode/predicates.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

Dimension columns never store strings — rows hold integer codes into a
global SORTED dictionary, and that dictionary order is exactly
lexicographic string order. Every string predicate therefore has an
integer-domain equivalent that evaluates on the ENCODED form (plain or
bit-packed codes decode to the same integers):

- equality     -> one code compare (``selector_code``)
- range/BETWEEN-> a half-open code interval (``bound_code_range``)
- IN           -> a bool mask over the dictionary, gathered by code
- LIKE/regex/contains -> the same mask, built by running the pattern
  over the O(cardinality) dictionary instead of O(rows) strings

``ops/filters.py`` lowers through these helpers, so the device masks
NEVER materialize a string column; the helpers are also pure host
functions so tests can verify the rewrite against brute-force string
evaluation on commuted / NOT / OR filter trees.
"""

from __future__ import annotations

import re
from typing import Iterable, Optional, Tuple

import numpy as np


def selector_code(dim, value: str) -> int:
    """The dictionary code of ``value``, or -1 when absent (the caller
    lowers a miss to a constant-false mask — no scan at all)."""
    return int(dim.code_of(str(value)))


def bound_code_range(dim, lower: Optional[str], upper: Optional[str],
                     lower_strict: bool, upper_strict: bool
                     ) -> Tuple[int, int]:
    """Half-open code interval [lo, hi) equivalent to the string bound —
    sorted global dictionaries make lexicographic bounds code ranges.
    lo >= hi means the bound selects nothing."""
    lo, hi = dim.code_range(
        None if lower is None else str(lower),
        None if upper is None else str(upper),
        lower_strict, upper_strict)
    return int(lo), int(hi)


def in_code_mask(dictionary: np.ndarray, values: Iterable) -> np.ndarray:
    """bool[cardinality] membership mask: mask[code] == (dict[code] in
    values). Gathering it by code is the IN filter on encoded data."""
    return np.isin(np.asarray(dictionary).astype(str),
                   np.array([str(v) for v in values]))


def pattern_code_mask(dictionary: np.ndarray, kind: str,
                      pattern: str, like_to_regex=None) -> np.ndarray:
    """bool[cardinality] mask for LIKE / regex / contains patterns,
    evaluated once per dictionary entry."""
    vals = np.asarray(dictionary)
    if kind == "like":
        if like_to_regex is None:
            from spark_druid_olap_tpu_torch.ops.expr_compile import like_to_regex
        rx = re.compile(like_to_regex(pattern))
        return np.array([bool(rx.match(s)) for s in vals])
    if kind == "regex":
        rx = re.compile(pattern)
        return np.array([bool(rx.search(s)) for s in vals])
    if kind == "contains":
        return np.array([pattern in s for s in vals])
    raise ValueError(f"pattern kind {kind!r}")


def code_mask_bounds(mask: np.ndarray) -> Tuple[int, int]:
    """Tightest [lo, hi) code interval covering a membership mask —
    lets a sparse IN over a contiguous dictionary slice degrade to the
    two-compare range test instead of a gather."""
    idx = np.flatnonzero(mask)
    if len(idx) == 0:
        return 0, 0
    return int(idx[0]), int(idx[-1]) + 1
