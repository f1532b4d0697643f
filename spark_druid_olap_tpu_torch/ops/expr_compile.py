"""Expression -> tensor compiler.

Port of ``spark_druid_olap_tpu/ops/expr_compile.py``: ``compile_expr`` over
the JAX compiler's whole expression surface — column references, literals,
arithmetic, comparisons, boolean logic, BETWEEN, IN lists and large integer
IN sets (``int_set_membership``), IS NULL (on a column, and on a NaN-coded
computed value), LIKE, casts, CASE, keyed lookups (the device form of a
decorrelated scalar subquery, a ``torch.searchsorted`` probe of the sorted
key table) and functions: time fields, ``date_trunc``, date arithmetic,
string functions over the host dictionary, and math. Nodes the JAX
compiler refuses raise :class:`Unsupported`, as there.

Code masks and integer sets of few runs lower to range-compare chains, as
in the JAX compiler, which keeps string predicates elementwise. The JAX
compiler's other gather-avoiding layouts (a packed bitmap for dense integer
sets, a direct-addressed table for dense lookup keys) are TPU lowering
choices with the same answers; the port probes sorted sets and key tables
with ``torch.searchsorted`` instead.

Value model (three-valued logic is handled at the planner; a null row's
payload is garbage-but-defined and masked upstream):

- ``NumValue``  — f32/i32 tensor (the JAX engine's device dtypes, so both
  engines compute identical per-row values)
- ``BoolValue`` — bool tensor
- ``TimeValue`` — int32 days (+ optional int32 ms-in-day)
- ``StrValue``  — dictionary codes + *host-side* per-code string values;
  string predicates transform the host dictionary, never device data.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch

from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ops import time_ops
from spark_druid_olap_tpu_torch.ops import timezone as _tz
from spark_druid_olap_tpu_torch.ops.scan import ScanContext
from spark_druid_olap_tpu_torch.segment.column import ColumnKind


class Unsupported(Exception):
    """Expression not compilable to the device path; the planner handles
    it via a host residual."""


@dataclasses.dataclass
class NumValue:
    arr: torch.Tensor
    is_float: bool


@dataclasses.dataclass
class BoolValue:
    arr: torch.Tensor


@dataclasses.dataclass
class TimeValue:
    days: torch.Tensor
    ms_in_day: Optional[torch.Tensor] = None


@dataclasses.dataclass
class StrValue:
    codes: torch.Tensor           # device int32 codes
    host_values: np.ndarray       # object array: code -> string


@dataclasses.dataclass
class _HostStr:
    """A string literal — stays host-side until it meets a StrValue/TimeValue."""
    s: str


def take1d(table, idx: torch.Tensor) -> torch.Tensor:
    """Gather ``table[idx]`` from a host per-code table (a LUT or a bool
    mask over a dictionary) onto ``idx``'s device."""
    t = torch.as_tensor(np.asarray(table), device=idx.device)
    return t[idx.long()]


def _range_chain(ranges, arr: torch.Tensor) -> torch.Tensor:
    """Membership as fused range compares: [(lo, hi)] inclusive."""
    out = None
    for lo, hi in ranges:
        m = (arr == lo) if lo == hi else ((arr >= lo) & (arr <= hi))
        out = m if out is None else (out | m)
    return out


def _mask_ranges(mask: np.ndarray):
    """Maximal runs of True as [(lo, hi)] inclusive code ranges."""
    sel = np.nonzero(mask)[0]
    if len(sel) == 0:
        return []
    brk = np.nonzero(np.diff(sel) > 1)[0]
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk, [len(sel) - 1]])
    return [(int(sel[s]), int(sel[e])) for s, e in zip(starts, ends)]


_CHAIN_MAX_RANGES = 24


def take_mask(mask: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """A per-code host mask applied to device codes, as the JAX compiler's
    ``_take_mask`` does: a selection of few code runs (or whose complement
    has few) lowers to range compares, which stay elementwise (the wave
    kernel's lane programs run them); others gather from the mask."""
    mask = np.asarray(mask, dtype=bool)
    ranges = _mask_ranges(mask)
    if len(ranges) <= _CHAIN_MAX_RANGES:
        if not ranges:
            return torch.zeros_like(codes, dtype=torch.bool)
        return _range_chain(ranges, codes)
    inv = _mask_ranges(~mask)
    if len(inv) <= _CHAIN_MAX_RANGES:
        if not inv:
            return torch.ones_like(codes, dtype=torch.bool)
        return ~_range_chain(inv, codes)
    return take1d(mask, codes)


def like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


def _scalar(v, dtype, ctx) -> torch.Tensor:
    return torch.tensor(v, dtype=dtype, device=ctx.device)


def _as_num(v, ctx) -> NumValue:
    if isinstance(v, NumValue):
        return v
    if isinstance(v, BoolValue):
        return NumValue(v.arr.to(torch.int32), False)
    if isinstance(v, TimeValue):
        return NumValue(v.days, False)
    if isinstance(v, StrValue):
        # cast string dim -> number via host-parsed lookup table
        lut = np.zeros(len(v.host_values), dtype=np.float32)
        for i, s in enumerate(v.host_values):
            try:
                lut[i] = float(s)
            except (TypeError, ValueError):
                lut[i] = np.nan
        return NumValue(take1d(lut, v.codes), True)
    raise Unsupported(f"cannot treat {type(v).__name__} as numeric")


def compile_expr(e: E.Expr, ctx: ScanContext):
    """Compile an expression tree to a device value over the scan context."""
    if isinstance(e, E.Column):
        return _column_value(e.name, ctx)
    if isinstance(e, E.Literal):
        return _literal_value(e.value, ctx)
    if isinstance(e, E.BinaryOp):
        return _binary(e, ctx)
    if isinstance(e, E.Comparison):
        return _comparison(e.op, compile_expr(e.left, ctx),
                           compile_expr(e.right, ctx), ctx)
    if isinstance(e, E.And):
        out = None
        for p in e.parts:
            b = _as_bool(compile_expr(p, ctx))
            out = b if out is None else out & b
        return BoolValue(out if out is not None else
                         torch.ones_like(ctx.row_valid()))
    if isinstance(e, E.Or):
        out = None
        for p in e.parts:
            b = _as_bool(compile_expr(p, ctx))
            out = b if out is None else out | b
        return BoolValue(out)
    if isinstance(e, E.Not):
        return BoolValue(~_as_bool(compile_expr(e.child, ctx)))
    if isinstance(e, E.IsNull):
        if isinstance(e.child, E.Column):
            nv = ctx.null_valid(e.child.name)
            valid = ctx.row_valid() if nv is None else nv
            return BoolValue(valid if e.negated else ~valid)
        # a computed expression's NULLs are NaN-coded only when no input
        # column is nullable (nullable column payloads are zero-filled in
        # storage): keyed-lookup misses and 0/0 are NaN
        if any(ctx.null_valid(c) is not None
               for c in E.columns_in(e.child)):
            raise Unsupported("IS NULL on expression over nullable columns")
        v = compile_expr(e.child, ctx)
        if isinstance(v, NumValue) and v.is_float:
            isnull = torch.isnan(v.arr)
            return BoolValue(~isnull if e.negated else isnull)
        raise Unsupported("IS NULL on computed expression")
    if isinstance(e, E.InList):
        v = compile_expr(e.child, ctx)
        b = _in_list(v, e.values, ctx)
        return BoolValue(~b if e.negated else b)
    if isinstance(e, E.KeyedLookup2):
        return _keyed_lookup2(e, ctx)
    if isinstance(e, E.KeyedLookup):
        return _keyed_lookup(e, ctx)
    if isinstance(e, E.Between):
        v = compile_expr(e.child, ctx)
        lo = _comparison(">=", v, compile_expr(e.low, ctx), ctx)
        hi = _comparison("<=", v, compile_expr(e.high, ctx), ctx)
        b = _as_bool(lo) & _as_bool(hi)
        return BoolValue(~b if e.negated else b)
    if isinstance(e, E.Like):
        v = compile_expr(e.child, ctx)
        if not isinstance(v, StrValue):
            raise Unsupported("LIKE on non-string")
        rx = re.compile(like_to_regex(e.pattern))
        mask = np.array([bool(rx.match(s)) for s in v.host_values],
                        dtype=bool)
        b = take_mask(mask, v.codes)
        return BoolValue(~b if e.negated else b)
    if isinstance(e, E.Func):
        return _func(e, ctx)
    if isinstance(e, E.Cast):
        return _cast(e, ctx)
    if isinstance(e, E.Case):
        return _case(e, ctx)
    raise Unsupported(f"unsupported node {type(e).__name__}")


def _lookup_miss(default, ctx) -> torch.Tensor:
    """A lookup's miss value: ``default``, or NaN for SQL NULL (its
    comparisons come out false). Values are f64, the table's own dtype,
    as on the JAX package's 64-bit routes."""
    return _scalar(np.nan if default is None else float(default),
                   torch.float64, ctx)


def _null_masked(found, key_cols, ctx):
    """A NULL key matches nothing (the decorrelated subquery aggregates
    the empty set): NULL key rows are zero-filled in storage, so the key
    column's validity must mask the probe or they would read key 0's
    group."""
    for c in key_cols:
        nv = ctx.null_valid(c.name)
        if nv is not None:
            found = found & nv
    return found


def _keyed_lookup(e: E.KeyedLookup, ctx):
    """Broadcast-join gather: binary search of the sorted key table
    (``torch.searchsorted``), then the value; misses read ``default``."""
    if not isinstance(e.key, E.Column):
        raise Unsupported("keyed lookup over computed key")
    n = _as_num(compile_expr(e.key, ctx), ctx)
    if n.is_float:
        raise Unsupported("keyed lookup over float key expression")
    tab = e.table
    miss = _lookup_miss(e.default, ctx)
    if len(tab) == 0:
        return NumValue(miss.expand(n.arr.shape), True)
    if n.arr.dtype != torch.int64 and (
            int(tab.keys[0]) < -(2**31) or int(tab.keys[-1]) >= 2**31):
        raise Unsupported("lookup keys exceed 32-bit range")
    keys = torch.tensor(tab.keys, device=n.arr.device)
    vals = torch.tensor(tab.values, device=n.arr.device)
    probe = n.arr.to(torch.int64)
    idx = torch.searchsorted(keys, probe.reshape(-1)).clamp_(
        max=len(tab) - 1).reshape(probe.shape)
    found = _null_masked(keys[idx] == probe, (e.key,), ctx)
    return NumValue(torch.where(found, vals[idx], miss), True)


def _keyed_lookup2(e: E.KeyedLookup2, ctx):
    """Composite-key broadcast join: the sorted (k1, k2) pairs (int32 by
    ``FrozenKeyedTable2``'s invariant) pack into one int64 key each, so
    the pair search is one ``torch.searchsorted`` over the packed keys,
    in the table's lexicographic order."""
    if not (isinstance(e.key1, E.Column) and isinstance(e.key2, E.Column)):
        raise Unsupported("pair lookup over computed keys")
    n1 = _as_num(compile_expr(e.key1, ctx), ctx)
    n2 = _as_num(compile_expr(e.key2, ctx), ctx)
    if n1.is_float or n2.is_float:
        raise Unsupported("pair lookup over float key expression")
    tab = e.table
    miss = _lookup_miss(e.default, ctx)
    if len(tab) == 0:
        return NumValue(miss.expand(n1.arr.shape), True)
    dev = n1.arr.device
    k1 = torch.tensor(tab.keys1, device=dev)
    k2 = torch.tensor(tab.keys2, device=dev)
    vals = torch.tensor(tab.values, device=dev)
    packed = (k1 << 32) + (k2 + (1 << 31))
    a = n1.arr.to(torch.int64)
    b = n2.arr.to(torch.int64)
    # a probe outside int32 can match no table key; clamp it out of the
    # packing's range so it cannot alias another pair
    ok = (a >= -(1 << 31)) & (a < (1 << 31)) & (b >= -(1 << 31)) \
        & (b < (1 << 31))
    probe = (a.clamp(-(1 << 31), (1 << 31) - 1) << 32) \
        + (b.clamp(-(1 << 31), (1 << 31) - 1) + (1 << 31))
    idx = torch.searchsorted(packed, probe.reshape(-1)).clamp_(
        max=len(tab) - 1).reshape(probe.shape)
    found = ok & (k1[idx] == a) & (k2[idx] == b)
    found = _null_masked(found, (e.key1, e.key2), ctx)
    return NumValue(torch.where(found, vals[idx], miss), True)


def int_set_runs(vals: np.ndarray):
    """Contiguous [lo, hi] runs of a sorted int array, or None when there
    are too many of them for a range-compare chain (the JAX compiler's
    ``int_set_runs``)."""
    if len(vals) == 0:
        return []
    lo_v, hi_v = int(vals[0]), int(vals[-1])
    span = hi_v - lo_v + 1
    if len(vals) > 2 * _CHAIN_MAX_RANGES and span > 4 * len(vals):
        return None
    arr64 = vals.astype(np.int64)
    brk = np.nonzero(np.diff(arr64) > 1)[0]
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk, [len(arr64) - 1]])
    runs = [(int(arr64[s]), int(arr64[e])) for s, e in zip(starts, ends)]
    return runs if len(runs) <= _CHAIN_MAX_RANGES else None


def int_set_lowers_to_chain(vals: np.ndarray) -> bool:
    """Whether membership in ``vals`` compiles to compare chains rather
    than a probe of the sorted set (the compaction's staged-filter split
    must agree with :func:`int_set_membership`)."""
    return int_set_runs(vals) is not None


def int_set_membership(arr: torch.Tensor, vals: np.ndarray) -> torch.Tensor:
    """Membership of integer ``arr`` in a sorted int array: a range
    compare chain for sets of few runs, else a ``torch.searchsorted``
    probe of the sorted set. Shared by the filter tier
    (``ops/filters._in``) and ``_in_list``."""
    runs = int_set_runs(vals)
    if runs is not None:
        return _range_chain(runs, arr)
    dev = torch.as_tensor(vals.astype(np.int64), device=arr.device)
    probe = arr.to(torch.int64)
    idx = torch.searchsorted(dev, probe.reshape(-1)).clamp_(
        max=len(vals) - 1).reshape(probe.shape)
    return dev[idx] == probe


def _column_value(name: str, ctx: ScanContext):
    kind = ctx.kind(name)
    arr = ctx.col(name)
    if kind == ColumnKind.DIM:
        return StrValue(arr, ctx.dictionary(name))
    if kind == ColumnKind.DOUBLE:
        return NumValue(arr, True)
    if kind == ColumnKind.LONG:
        return NumValue(arr, False)
    if kind == ColumnKind.DATE:
        return TimeValue(arr, None)
    if kind == ColumnKind.TIME:
        days, ms = arr, ctx.time_ms()
        if not _tz.is_utc(ctx.tz):
            # expressions see the instant in session-local wall-clock time
            lut = _tz.day_offset_lut(ctx.tz, ctx.min_day - 1,
                                     ctx.max_day + 1)
            days, ms = _tz.shift_days_ms(days, ms, lut, ctx.min_day - 1)
        return TimeValue(days, ms)
    raise Unsupported(f"column kind {kind}")


def _literal_value(v, ctx):
    if isinstance(v, bool):
        return BoolValue(_scalar(v, torch.bool, ctx))
    if isinstance(v, (int, np.integer)):
        return NumValue(_scalar(int(v), torch.int32, ctx), False)
    if isinstance(v, (float, np.floating)):
        return NumValue(_scalar(float(v), torch.float32, ctx), True)
    if isinstance(v, str):
        return _HostStr(v)
    import datetime as _dt
    if isinstance(v, (_dt.date, _dt.datetime, np.datetime64)):
        return TimeValue(_scalar(time_ops.date_literal_to_days(v),
                                 torch.int32, ctx))
    raise Unsupported(f"literal {v!r}")


def _binary(e: E.BinaryOp, ctx):
    lv = compile_expr(e.left, ctx)
    rv = compile_expr(e.right, ctx)
    # date +/- integer days (TPC-H: date '1998-12-01' - 90)
    if isinstance(lv, TimeValue) and isinstance(rv, NumValue) and e.op in "+-":
        d = rv.arr if e.op == "+" else -rv.arr
        return TimeValue(lv.days + d.to(torch.int32), lv.ms_in_day)
    if isinstance(lv, _HostStr):
        lv = _promote_hoststr(lv, rv, ctx)
    if isinstance(rv, _HostStr):
        rv = _promote_hoststr(rv, lv, ctx)
    ln, rn = _as_num(lv, ctx), _as_num(rv, ctx)
    is_float = ln.is_float or rn.is_float or e.op == "/"
    a, b = ln.arr, rn.arr
    if is_float:
        a = a.to(torch.float32)
        b = b.to(torch.float32)
    if e.op == "+":
        return NumValue(a + b, is_float)
    if e.op == "-":
        return NumValue(a - b, is_float)
    if e.op == "*":
        return NumValue(a * b, is_float)
    if e.op == "/":
        return NumValue(a / b, True)
    if e.op == "%":
        return NumValue(torch.remainder(a, b), is_float)
    raise Unsupported(f"operator {e.op}")


def _promote_hoststr(h: _HostStr, other, ctx):
    """Decide what a string literal means from the other operand's type."""
    if isinstance(other, TimeValue):
        return TimeValue(_scalar(time_ops.date_literal_to_days(h.s),
                                 torch.int32, ctx))
    if isinstance(other, NumValue):
        try:
            f = float(h.s)
        except ValueError:
            raise Unsupported(f"string literal {h.s!r} in numeric context")
        return NumValue(_scalar(f, torch.float32, ctx), True)
    return h


_CMP = {"=": lambda a, b: a == b, "!=": lambda a, b: a != b,
        "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
        ">": lambda a, b: a > b, ">=": lambda a, b: a >= b}


def _comparison(op: str, lv, rv, ctx):
    # string-literal vs column promotions
    if isinstance(lv, _HostStr) and isinstance(rv, _HostStr):
        raise Unsupported("literal-literal comparison should be folded")
    if isinstance(lv, _HostStr):
        flipped = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        return _comparison(flipped, rv, lv, ctx)
    if isinstance(rv, _HostStr):
        if isinstance(lv, StrValue):
            import operator
            pyop = {"=": operator.eq, "!=": operator.ne, "<": operator.lt,
                    "<=": operator.le, ">": operator.gt, ">=": operator.ge}[op]
            mask = np.array([pyop(s, rv.s) for s in lv.host_values])
            return BoolValue(take_mask(mask, lv.codes))
        rv = _promote_hoststr(rv, lv, ctx)
    if isinstance(lv, TimeValue) and isinstance(rv, TimeValue):
        ldays, rdays = lv.days, rv.days
        if lv.ms_in_day is None and rv.ms_in_day is None:
            return BoolValue(_CMP[op](ldays, rdays))
        lms = lv.ms_in_day if lv.ms_in_day is not None else 0
        rms = rv.ms_in_day if rv.ms_in_day is not None else 0
        eq = (ldays == rdays) & (lms == rms)
        if op in ("=", "!="):
            return BoolValue(eq if op == "=" else ~eq)
        lt = (ldays < rdays) | ((ldays == rdays) & (lms < rms))
        out = {"<": lt, "<=": lt | eq, ">": ~(lt | eq), ">=": ~lt}[op]
        return BoolValue(out)
    if isinstance(lv, StrValue) and isinstance(rv, StrValue):
        if lv.host_values is rv.host_values:
            return BoolValue(_CMP[op](lv.codes, rv.codes))
        raise Unsupported("comparison between two different string dims")
    ln, rn = _as_num(lv, ctx), _as_num(rv, ctx)
    a, b = ln.arr, rn.arr
    if ln.is_float or rn.is_float:
        a = a.to(torch.float32)
        b = b.to(torch.float32)
    return BoolValue(_CMP[op](a, b))


def _as_bool(v):
    if isinstance(v, BoolValue):
        return v.arr
    if isinstance(v, NumValue):
        return v.arr != 0
    raise Unsupported(f"cannot use {type(v).__name__} as boolean")


def _in_list(v, values, ctx):
    if isinstance(values, E.FrozenIntSet):
        vals = values.array
        if len(vals) == 0:
            if isinstance(v, StrValue):
                return torch.zeros_like(v.codes, dtype=torch.bool)
            return torch.zeros_like(_as_num(v, ctx).arr, dtype=torch.bool)
        n = _as_num(v, ctx)
        if n.is_float:
            # f32 compares collide for keys >= 2^24; the host evaluates
            raise Unsupported("large integer IN set over float expression")
        if n.arr.dtype != torch.int64 and (
                int(vals[0]) < -(2**31) or int(vals[-1]) >= 2**31):
            # a 32-bit probe can't hold such values; the set must not wrap
            raise Unsupported("IN-set values exceed 32-bit range")
        return int_set_membership(n.arr, vals)
    if isinstance(v, StrValue):
        vs = set(values)
        mask = np.array([s in vs for s in v.host_values])
        return take_mask(mask, v.codes)
    if isinstance(v, TimeValue):
        out = torch.zeros_like(v.days, dtype=torch.bool)
        for x in values:
            out = out | (v.days == time_ops.date_literal_to_days(x))
        return out
    n = _as_num(v, ctx)
    out = None
    for x in values:
        lit = _scalar(float(x), torch.float32, ctx) if n.is_float \
            else _scalar(int(x), torch.int32, ctx)
        b = n.arr == lit
        out = b if out is None else out | b
    return out if out is not None else torch.zeros_like(n.arr,
                                                        dtype=torch.bool)


_STR_FUNCS = {
    "lower": lambda s: s.lower(),
    "upper": lambda s: s.upper(),
    "trim": lambda s: s.strip(),
    "ltrim": lambda s: s.lstrip(),
    "rtrim": lambda s: s.rstrip(),
    "reverse": lambda s: s[::-1],
}

_TIME_FIELDS = {"year", "month", "day", "quarter", "dow", "doy", "week",
                "hour", "minute", "second"}

_FLOAT_FUNCS = {"floor": torch.floor, "ceil": torch.ceil,
                "sqrt": torch.sqrt, "exp": torch.exp, "ln": torch.log,
                "log": torch.log}


def _func(e: E.Func, ctx):
    name = e.name.lower()
    if name in _TIME_FIELDS:
        v = _coerce_time(compile_expr(e.args[0], ctx), ctx)
        return NumValue(time_ops.extract_field(name, v.days, v.ms_in_day)
                        .to(torch.int32), False)
    if name in ("date_trunc", "trunc"):
        grain = _literal_str(e.args[0]).lower()
        v = _coerce_time(compile_expr(e.args[1], ctx), ctx)
        return _date_trunc(grain, v)
    if name in ("date_add", "dateadd", "date_sub"):
        v = _coerce_time(compile_expr(e.args[0], ctx), ctx)
        n = _as_num(compile_expr(e.args[1], ctx), ctx).arr.to(torch.int32)
        return TimeValue(v.days + (n if name != "date_sub" else -n),
                         v.ms_in_day)
    if name == "datediff":
        a = _coerce_time(compile_expr(e.args[0], ctx), ctx)
        b = _coerce_time(compile_expr(e.args[1], ctx), ctx)
        return NumValue(a.days - b.days, False)
    if name == "add_months":
        v = _coerce_time(compile_expr(e.args[0], ctx), ctx)
        n = _as_num(compile_expr(e.args[1], ctx), ctx)
        y, m, d = time_ops.civil_from_days(v.days)
        mi = y * 12 + (m - 1) + n.arr.to(torch.int32)
        start = _month_start(_fdiv(mi, 12), torch.remainder(mi, 12) + 1)
        mi2 = mi + 1
        nstart = _month_start(_fdiv(mi2, 12), torch.remainder(mi2, 12) + 1)
        nd = torch.minimum(d, nstart - start)      # clamp to month length
        return TimeValue(start + nd - 1, None)
    if name in _STR_FUNCS or name in ("substr", "substring", "concat",
                                      "replace", "lpad", "rpad",
                                      "regexp_extract", "__lookup_pairs"):
        return _str_func(name, e, ctx)
    if name in ("length", "char_length"):
        v = compile_expr(e.args[0], ctx)
        if not isinstance(v, StrValue):
            raise Unsupported("length of non-string")
        lut = np.array([len(s) for s in v.host_values], dtype=np.int32)
        return NumValue(take1d(lut, v.codes), False)
    if name == "abs":
        n = _as_num(compile_expr(e.args[0], ctx), ctx)
        return NumValue(torch.abs(n.arr), n.is_float)
    if name == "round" or name in _FLOAT_FUNCS:
        a = _as_num(compile_expr(e.args[0], ctx), ctx).arr \
            .to(torch.float32)
        if name != "round":
            return NumValue(_FLOAT_FUNCS[name](a), True)
        if len(e.args) > 1:
            k = float(10 ** _literal_num(e.args[1]))
            return NumValue(torch.round(a * k) / k, True)
        return NumValue(torch.round(a), True)
    if name in ("power", "pow"):
        a = _as_num(compile_expr(e.args[0], ctx), ctx)
        b = _as_num(compile_expr(e.args[1], ctx), ctx)
        return NumValue(torch.pow(a.arr.to(torch.float32),
                                  b.arr.to(torch.float32)), True)
    from spark_druid_olap_tpu_torch.utils.host_eval import EXTRA_FUNCTIONS
    if name in EXTRA_FUNCTIONS and len(e.args) == 1:
        # a registered scalar function over a string dim maps the host
        # dictionary, so it still pushes down
        v = compile_expr(e.args[0], ctx)
        if isinstance(v, StrValue):
            fn = EXTRA_FUNCTIONS[name]
            return StrValue(v.codes, np.array([fn(s) for s in v.host_values],
                                              dtype=object))
    raise Unsupported(f"function {name}")


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _date_trunc(grain: str, v: TimeValue):
    if grain == "day":
        return TimeValue(v.days, None)
    if grain == "week":
        return TimeValue(_fdiv(v.days + 3, 7) * 7 - 3, None)
    y, m, _ = time_ops.civil_from_days(v.days)
    if grain == "year":
        return TimeValue(_month_start(y, torch.ones_like(m)), None)
    if grain == "quarter":
        return TimeValue(_month_start(y, _fdiv(m - 1, 3) * 3 + 1), None)
    if grain == "month":
        return TimeValue(_month_start(y, m), None)
    raise Unsupported(f"date_trunc grain {grain}")


_MONTH_OFFSETS = np.array([0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304,
                           334], dtype=np.int32)


def _month_start(y, m):
    """days-since-epoch of (y, m, 1), vectorized."""
    jan1 = time_ops.days_of_jan1(y)
    off = take1d(_MONTH_OFFSETS, m - 1)
    leap = ((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0)) \
        | (torch.remainder(y, 400) == 0)
    return (jan1 + off + (leap & (m > 2)).to(torch.int32)).to(torch.int32)


def _str_func(name, e: E.Func, ctx):
    """String functions = host transforms of the dictionary, then the
    device codes index the new per-code values."""
    v = compile_expr(e.args[0], ctx)
    if isinstance(v, _HostStr):
        raise Unsupported("string fn on literal should be constant-folded")
    if not isinstance(v, StrValue):
        raise Unsupported(f"{name} on non-string")

    def mapped(fn):
        return StrValue(v.codes, np.array([fn(s) for s in v.host_values],
                                          dtype=object))

    if name in _STR_FUNCS:
        return mapped(_STR_FUNCS[name])
    if name in ("substr", "substring"):
        start = int(_literal_num(e.args[1]))
        ln = int(_literal_num(e.args[2])) if len(e.args) > 2 else None
        i0 = start - 1 if start > 0 else start
        return mapped(lambda s: s[i0: i0 + ln] if ln is not None
                      else s[i0:])
    if name == "concat":
        parts = [compile_expr(a, ctx) for a in e.args]
        strs = [p for p in parts if isinstance(p, StrValue)]
        if len(strs) != 1:
            raise Unsupported("concat supports exactly one column argument")
        sv = strs[0]
        out = ["".join(p.s if isinstance(p, _HostStr) else s for p in parts)
               for s in sv.host_values]
        return StrValue(sv.codes, np.array(out, dtype=object))
    if name == "replace":
        old = _literal_str(e.args[1])
        new = _literal_str(e.args[2])
        return mapped(lambda s: s.replace(old, new))
    if name in ("lpad", "rpad"):
        n = int(_literal_num(e.args[1]))
        fill = _literal_str(e.args[2]) if len(e.args) > 2 else " "
        return mapped((lambda s: s.rjust(n, fill)) if name == "lpad"
                      else (lambda s: s.ljust(n, fill)))
    if name == "regexp_extract":
        rx = re.compile(_literal_str(e.args[1]))
        idx = int(_literal_num(e.args[2])) if len(e.args) > 2 else 1

        def rex(s):
            m = rx.search(s) if isinstance(s, str) else None
            return m.group(idx) if m is not None else None
        return mapped(rex)
    if name == "__lookup_pairs":
        if not isinstance(e.args[1], E.Literal):
            raise Unsupported("lookup table must be a literal")
        table = dict(e.args[1].value)
        return mapped(table.get)
    raise Unsupported(f"string function {name}")


def _literal_str(e: E.Expr) -> str:
    if isinstance(e, E.Literal) and isinstance(e.value, str):
        return e.value
    raise Unsupported("expected string literal argument")


def _literal_num(e: E.Expr):
    if isinstance(e, E.Literal) and isinstance(e.value, (int, float)):
        return e.value
    raise Unsupported("expected numeric literal argument")


def _coerce_time(v, ctx) -> TimeValue:
    if isinstance(v, TimeValue):
        return v
    if isinstance(v, _HostStr):
        return TimeValue(_scalar(time_ops.date_literal_to_days(v.s),
                                 torch.int32, ctx))
    if isinstance(v, StrValue):
        lut = np.array([time_ops.date_literal_to_days(s) if s else 0
                        for s in v.host_values], dtype=np.int32)
        return TimeValue(take1d(lut, v.codes))
    raise Unsupported("expected a date/time value")


def _cast(e: E.Cast, ctx):
    v = compile_expr(e.child, ctx)
    to = e.to.lower()
    if to in ("double", "float", "decimal"):
        n = _as_num(v, ctx)
        return NumValue(n.arr.to(torch.float32), True)
    if to in ("long", "int", "bigint", "integer"):
        n = _as_num(v, ctx)
        return NumValue(n.arr.to(torch.int32), False)
    if to in ("date", "timestamp"):
        return _coerce_time(v, ctx)
    if to in ("string", "varchar"):
        if isinstance(v, StrValue):
            return v
        raise Unsupported("cast to string of non-dim (needs host residual)")
    raise Unsupported(f"cast to {to}")


def _case(e: E.Case, ctx):
    branches = [(_as_bool(compile_expr(c, ctx)), compile_expr(v, ctx))
                for c, v in e.branches]
    other = compile_expr(e.otherwise, ctx) if e.otherwise is not None \
        else NumValue(_scalar(0, torch.int32, ctx), False)
    vals = [v for _, v in branches] + [other]
    if any(isinstance(v, (StrValue, _HostStr)) for v in vals):
        raise Unsupported("CASE producing strings (host residual)")
    is_float = any(_as_num(v, ctx).is_float for v in vals)

    def arr(v):
        a = _as_num(v, ctx).arr
        return a.to(torch.float32) if is_float else a

    out = arr(other)
    for cond, v in reversed(branches):
        out = torch.where(cond, arr(v), out)
    return NumValue(out, is_float)
