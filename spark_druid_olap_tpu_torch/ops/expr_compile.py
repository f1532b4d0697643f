"""Expression -> tensor compiler.

Port of ``spark_druid_olap_tpu/ops/expr_compile.py``: ``compile_expr`` for
column references, literals, arithmetic, comparisons, boolean logic,
BETWEEN, IN lists, casts and CASE — what aggregation inputs such as
``sum(l_extendedprice * (1 - l_discount))`` and expression filters need.
Functions, LIKE, keyed lookups and large integer IN sets raise
``NotImplementedError``; nodes the JAX compiler itself refuses raise
:class:`Unsupported`, as there.

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


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} not ported yet (ROADMAP A.1: full expression compiler)")


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
        raise not_ported("IS NULL on a computed expression")
    if isinstance(e, E.InList):
        if isinstance(e.values, E.FrozenIntSet):
            raise not_ported("large integer IN set")
        v = compile_expr(e.child, ctx)
        b = _in_list(v, e.values, ctx)
        return BoolValue(~b if e.negated else b)
    if isinstance(e, E.Between):
        v = compile_expr(e.child, ctx)
        lo = _comparison(">=", v, compile_expr(e.low, ctx), ctx)
        hi = _comparison("<=", v, compile_expr(e.high, ctx), ctx)
        b = _as_bool(lo) & _as_bool(hi)
        return BoolValue(~b if e.negated else b)
    if isinstance(e, E.Cast):
        return _cast(e, ctx)
    if isinstance(e, E.Case):
        return _case(e, ctx)
    if isinstance(e, (E.Func, E.Like, E.KeyedLookup, E.KeyedLookup2)):
        raise not_ported(type(e).__name__)
    raise Unsupported(f"unsupported node {type(e).__name__}")


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
            return BoolValue(take1d(mask, lv.codes))
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
    if isinstance(v, StrValue):
        vs = set(values)
        mask = np.array([s in vs for s in v.host_values])
        return take1d(mask, v.codes)
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
