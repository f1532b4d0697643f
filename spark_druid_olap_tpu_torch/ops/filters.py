"""FilterSpec -> device predicate masks.

Port of ``spark_druid_olap_tpu/ops/filters.py``: ``lower_filter`` for
selector, bound (string code ranges, numeric, date and time bounds), IN
lists and large integer IN sets, pattern (LIKE / contains / regex over the
dictionary), null, logical and expression filters; ``interval_mask``;
``columns_of_filter``. Spatial filters raise ``NotImplementedError``
(ROADMAP A.1). Every filter lowers to a bool [S, R] mask over the
stacked segment tensors; string predicates become integer tests on
dictionary codes through ``encode/predicates.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_druid_olap_tpu_torch.encode import predicates as P
from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.ops import expr_compile as EC
from spark_druid_olap_tpu_torch.ops import time_ops
from spark_druid_olap_tpu_torch.ops.scan import ScanContext
from spark_druid_olap_tpu_torch.segment.column import ColumnKind


def lower_filter(f: Optional[S.FilterSpec], ctx: ScanContext):
    """Lower a FilterSpec to a bool mask (None -> None, meaning all-true)."""
    if f is None:
        return None
    if isinstance(f, S.SelectorFilter):
        return _selector(f, ctx)
    if isinstance(f, S.BoundFilter):
        return _bound(f, ctx)
    if isinstance(f, S.InFilter):
        return _in(f, ctx)
    if isinstance(f, S.NullFilter):
        nv = ctx.null_valid(f.dimension)
        valid = ctx.row_valid() if nv is None else nv
        return valid if f.negated else ~valid
    if isinstance(f, S.LogicalFilter):
        return _logical(f, ctx)
    if isinstance(f, S.ExprFilter):
        return EC._as_bool(EC.compile_expr(f.expr, ctx))
    if isinstance(f, S.PatternFilter):
        return _pattern(f, ctx)
    if isinstance(f, S.SpatialFilter):
        raise NotImplementedError(
            "SpatialFilter not ported yet (ROADMAP A.1)")
    raise EC.Unsupported(f"filter {type(f).__name__}")


def _false(ctx):
    return torch.zeros_like(ctx.row_valid())


def _nullsafe(mask, name: str, ctx: ScanContext):
    nv = ctx.null_valid(name)
    return mask if nv is None else (mask & nv)


def _selector(f: S.SelectorFilter, ctx):
    kind = ctx.kind(f.dimension)
    if f.value is None:
        nv = ctx.null_valid(f.dimension)
        return ~nv if nv is not None else _false(ctx)
    if kind == ColumnKind.DIM:
        code = P.selector_code(ctx.ds.dims[f.dimension], f.value)
        if code < 0:
            return _false(ctx)
        return _nullsafe(ctx.col(f.dimension) == code, f.dimension, ctx)
    if kind in (ColumnKind.LONG, ColumnKind.DOUBLE):
        v = float(f.value) if kind == ColumnKind.DOUBLE else int(float(f.value))
        return _nullsafe(ctx.col(f.dimension) == v, f.dimension, ctx)
    if kind == ColumnKind.DATE:
        return ctx.col(f.dimension) == time_ops.date_literal_to_days(f.value)
    if kind == ColumnKind.TIME:
        # naive literals are session-local, zoned ones absolute
        ms = time_ops.literal_to_utc_millis(f.value, ctx.tz)
        day, rem = divmod(ms, time_ops.MILLIS_PER_DAY)
        return (ctx.col(f.dimension) == day) & (ctx.time_ms() == rem)
    raise EC.Unsupported(f"selector on {kind}")


def _bound(f: S.BoundFilter, ctx):
    kind = ctx.kind(f.dimension)
    if kind == ColumnKind.DIM and not f.numeric:
        lo, hi = P.bound_code_range(
            ctx.ds.dims[f.dimension], f.lower, f.upper,
            f.lower_strict, f.upper_strict)
        if lo >= hi:
            return _false(ctx)
        codes = ctx.col(f.dimension)
        mask = None
        if lo > 0:
            mask = codes >= lo
        if hi < ctx.ds.dims[f.dimension].cardinality:
            m2 = codes < hi
            mask = m2 if mask is None else (mask & m2)
        if mask is None:
            nv = ctx.null_valid(f.dimension)
            return nv if nv is not None else ctx.row_valid()
        return _nullsafe(mask, f.dimension, ctx)
    if kind == ColumnKind.DIM and f.numeric:
        # numeric ordering over string dictionary: host-parse to LUT
        vals = ctx.dictionary(f.dimension)
        lut = np.array([_try_float(s) for s in vals], dtype=np.float32)
        arr = EC.take1d(lut, ctx.col(f.dimension))
        return _nullsafe(_range_mask(arr, f, float), f.dimension, ctx)
    if kind in (ColumnKind.LONG, ColumnKind.DOUBLE):
        conv = float if kind == ColumnKind.DOUBLE else (lambda x: int(float(x)))
        return _nullsafe(_range_mask(ctx.col(f.dimension), f, conv),
                         f.dimension, ctx)
    if kind == ColumnKind.DATE:
        return _range_mask(ctx.col(f.dimension), f,
                           time_ops.date_literal_to_days)
    if kind == ColumnKind.TIME:
        return _time_bound(f, ctx)
    raise EC.Unsupported(f"bound on {kind}")


def _try_float(s):
    try:
        return float(s)
    except (TypeError, ValueError):
        return np.nan


def _range_mask(arr, f: S.BoundFilter, conv):
    # python-scalar bounds compare in the column's own dtype (f32 for
    # DOUBLE), as the JAX engine's weakly-typed scalars do
    mask = None
    if f.lower is not None:
        lo = conv(f.lower)
        mask = (arr > lo) if f.lower_strict else (arr >= lo)
    if f.upper is not None:
        hi = conv(f.upper)
        m = (arr < hi) if f.upper_strict else (arr <= hi)
        mask = m if mask is None else (mask & m)
    return mask if mask is not None else (arr == arr)


def _time_bound(f: S.BoundFilter, ctx):
    days = ctx.col(f.dimension)
    ms = ctx.time_ms()
    mask = None
    if f.lower is not None:
        lo = time_ops.literal_to_utc_millis(f.lower, ctx.tz)
        d, r = divmod(lo, time_ops.MILLIS_PER_DAY)
        cmp = (ms > r) if f.lower_strict else (ms >= r)
        mask = (days > d) | ((days == d) & cmp)
    if f.upper is not None:
        hi = time_ops.literal_to_utc_millis(f.upper, ctx.tz)
        d, r = divmod(hi, time_ops.MILLIS_PER_DAY)
        cmp = (ms < r) if f.upper_strict else (ms <= r)
        m = (days < d) | ((days == d) & cmp)
        mask = m if mask is None else (mask & m)
    return mask if mask is not None else ctx.row_valid()


def _in(f: S.InFilter, ctx):
    kind = ctx.kind(f.dimension)
    if isinstance(f.values, E.FrozenIntSet):
        # semi-join-scale membership (EC.int_set_membership)
        if kind not in (ColumnKind.LONG, ColumnKind.DATE):
            raise EC.Unsupported("large integer IN set over non-integer")
        vals = f.values.array
        if len(vals) == 0:
            return _false(ctx)
        arr = ctx.col(f.dimension)
        if arr.dtype != torch.int64 and (
                int(vals[0]) < -(2**31) or int(vals[-1]) >= 2**31):
            raise EC.Unsupported("IN-set values exceed 32-bit column range")
        return _nullsafe(EC.int_set_membership(arr, vals), f.dimension, ctx)
    if kind == ColumnKind.DIM:
        mask = P.in_code_mask(ctx.dictionary(f.dimension), f.values)
        return _nullsafe(EC.take_mask(mask, ctx.col(f.dimension)),
                         f.dimension, ctx)
    arr = ctx.col(f.dimension)
    out = None
    for v in f.values:
        if kind == ColumnKind.DATE:
            b = arr == time_ops.date_literal_to_days(v)
        elif kind == ColumnKind.DOUBLE:
            b = arr == float(v)
        else:
            b = arr == int(float(v))
        out = b if out is None else (out | b)
    return _nullsafe(out if out is not None else _false(ctx),
                     f.dimension, ctx)


def _pattern(f: S.PatternFilter, ctx):
    if ctx.kind(f.dimension) != ColumnKind.DIM:
        raise EC.Unsupported("pattern filter on non-string column")
    try:
        mask = P.pattern_code_mask(ctx.dictionary(f.dimension), f.kind,
                                   f.pattern,
                                   like_to_regex=EC.like_to_regex)
    except ValueError:
        raise EC.Unsupported(f"pattern kind {f.kind}") from None
    return _nullsafe(EC.take_mask(mask, ctx.col(f.dimension)), f.dimension,
                     ctx)


def _logical(f: S.LogicalFilter, ctx):
    if f.op == "not":
        inner = lower_filter(f.fields[0], ctx)
        return ctx.row_valid() if inner is None else ~inner
    masks = [lower_filter(x, ctx) for x in f.fields]
    if f.op == "or":
        # an all-true (None) operand makes the whole OR all-true
        if not masks or any(m is None for m in masks):
            return None
    else:
        masks = [m for m in masks if m is not None]
        if not masks:
            return None
    out = masks[0]
    for m in masks[1:]:
        out = (out & m) if f.op == "and" else (out | m)
    return out


def interval_mask(intervals, ctx: ScanContext):
    """Residual device mask for time intervals (after host-side segment
    pruning; segments straddling an interval edge need the row-level
    mask)."""
    if not intervals or ctx.ds.time is None:
        return None
    days = ctx.col(ctx.ds.time.name)
    ms = ctx.time_ms()
    out = None
    for lo, hi in intervals:
        dlo, rlo, dhi, rhi = time_ops.interval_day_range(lo, hi)
        # open-ended bounds carry +-2^63-scale ms whose day numbers
        # overflow int32; scanned days all lie in [min_day, max_day], so
        # clamping one day past that range preserves the mask exactly
        dlo = min(max(dlo, ctx.min_day - 1), ctx.max_day + 1)
        dhi = min(max(dhi, ctx.min_day - 1), ctx.max_day + 1)
        m_lo = (days > dlo) | ((days == dlo) & (ms >= rlo))
        m_hi = (days < dhi) | ((days == dhi) & (ms < rhi))
        m = m_lo & m_hi
        out = m if out is None else (out | m)
    return out


def columns_of_filter(f: Optional[S.FilterSpec]):
    """Source columns a filter touches (for array binding)."""
    if f is None:
        return set()
    if isinstance(f, (S.SelectorFilter, S.BoundFilter, S.InFilter,
                      S.PatternFilter, S.NullFilter)):
        return {f.dimension}
    if isinstance(f, S.SpatialFilter):
        return set(f.axes)
    if isinstance(f, S.LogicalFilter):
        out = set()
        for x in f.fields:
            out |= columns_of_filter(x)
        return out
    if isinstance(f, S.ExprFilter):
        return E.columns_in(f.expr)
    return set()
