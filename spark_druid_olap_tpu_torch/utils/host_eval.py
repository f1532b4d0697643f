"""Host-side (numpy) evaluator for ``ir.expr`` trees.

Port counterpart of ``spark_druid_olap_tpu/utils/host_eval.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

Three jobs, mirroring three reference facilities:

1. evaluate post-aggregation arithmetic over merged agg columns
   (≈ ``ArithmeticPostAggregationSpec`` evaluated inside Druid);
2. evaluate HAVING predicates and residual (unpushable) filters over small
   host-side result sets (≈ the FilterExec Spark leaves above the Druid scan,
   ``DruidStrategy.scala:244-270``);
3. evaluate dimension-expression transforms over the *dictionary domain*
   (code -> value) at plan time — the host half of the dictionary-functional
   string strategy.

Operates elementwise over numpy arrays or python scalars; string columns are
object arrays (dictionaries are small, python-loop cost is irrelevant).
"""

from __future__ import annotations

import datetime as _dt
import math
import re

import numpy as np
import pandas as pd

from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ops.time_ops import (
    date_literal_to_days,
    days_from_civil,
)


class HostEvalError(Exception):
    pass


def _is_str_like(v):
    if isinstance(v, str):
        return True
    return isinstance(v, np.ndarray) and v.dtype == object


def _map1(v, fn):
    if isinstance(v, np.ndarray) and v.dtype == object:
        return np.array([fn(x) for x in v], dtype=object)
    return fn(v)


import contextvars

# session timezone for host-side time bucketing/extraction (set by the SQL
# session around each statement; contextvars are per-thread, so concurrent
# server sessions don't interfere)
SESSION_TZ = contextvars.ContextVar("sdot_session_tz", default="UTC")


def _to_days(v):
    """Coerce scalar-or-array date-ish value to int days. datetime64
    INSTANTS shift into the session timezone's wall-clock day; calendar
    dates and date literals never shift."""
    if isinstance(v, np.ndarray):
        if np.issubdtype(v.dtype, np.datetime64):
            tz = SESSION_TZ.get()
            from spark_druid_olap_tpu_torch.ops import timezone as TZ
            if not TZ.is_utc(tz):
                ms = v.astype("datetime64[ms]").astype(np.int64)
                nat = np.isnat(v)
                if nat.any():
                    # NaT is int64-min; shifting it would demand an
                    # astronomically-sized offset LUT
                    ms = ms.copy()
                    ms[~nat] = TZ.shift_millis_np(ms[~nat], tz)
                else:
                    ms = TZ.shift_millis_np(ms, tz)
                return np.floor_divide(ms, 86_400_000)
            return v.astype("datetime64[D]").astype(np.int64)
        if v.dtype == object:
            return np.array([date_literal_to_days(x) for x in v],
                            dtype=np.int64)
        return v.astype(np.int64)
    return date_literal_to_days(v)


def _civil(days):
    days = np.asarray(days)
    dates = days.astype("datetime64[D]")
    y = dates.astype("datetime64[Y]").astype(np.int64) + 1970
    m = (dates.astype("datetime64[M]").astype(np.int64) % 12) + 1
    d = (dates - dates.astype("datetime64[M]")).astype(np.int64) + 1
    return y, m, d


class Precomputed(E.Expr):
    """An already-computed value injected into an expression tree (used by
    the host executor for row-wise subquery results)."""

    def __init__(self, arr):
        self.arr = arr


def _compare(op: str, a, b):
    """Two-valued comparison over already-evaluated operands (shared by
    eval_expr and the 3VL predicate walker, which evaluates operands once
    for both the result and the null masks)."""
    a, b = _cmp_promote(a, b)
    ops = {"=": "eq", "!=": "ne", "<": "lt", "<=": "le", ">": "gt",
           ">=": "ge"}
    import operator
    return getattr(operator, ops[op])(a, b)


def eval_expr(e: E.Expr, env: dict):
    """Evaluate ``e``; ``env`` maps column name -> scalar or numpy array."""
    if isinstance(e, Precomputed):
        return e.arr
    if isinstance(e, E.Column):
        if e.name not in env:
            raise HostEvalError(f"unbound column {e.name!r}")
        return env[e.name]
    if isinstance(e, E.Literal):
        return e.value
    if isinstance(e, E.BinaryOp):
        a = eval_expr(e.left, env)
        b = eval_expr(e.right, env)
        a, b = _date_promote(a, b, e.op)
        if e.op == "+":
            return a + b
        if e.op == "-":
            return a - b
        if e.op == "*":
            return a * b
        if e.op == "/":
            return np.divide(a, b)
        if e.op == "%":
            return np.mod(a, b)
        raise HostEvalError(e.op)
    if isinstance(e, E.Comparison):
        return _compare(e.op, eval_expr(e.left, env),
                        eval_expr(e.right, env))
    if isinstance(e, E.And):
        out = True
        for p in e.parts:
            out = np.logical_and(out, eval_expr(p, env))
        return out
    if isinstance(e, E.Or):
        out = False
        for p in e.parts:
            out = np.logical_or(out, eval_expr(p, env))
        return out
    if isinstance(e, E.Not):
        return np.logical_not(eval_expr(e.child, env))
    if isinstance(e, E.IsNull):
        v = eval_expr(e.child, env)
        isnull = _map_null(v)
        return np.logical_not(isnull) if e.negated else isnull
    if isinstance(e, E.InList):
        v = eval_expr(e.child, env)
        if isinstance(e.values, E.FrozenIntSet):
            arr = np.asarray(v)
            if arr.dtype == object or arr.dtype.kind == "f":
                arr = pd.to_numeric(pd.Series(arr),
                                    errors="coerce").to_numpy()
                # fractional probes match no integer set member
                ok = ~np.isnan(arr) & (arr == np.floor(arr))
                vi = np.where(ok, arr, 0).astype(np.int64)
            else:
                ok = None
                vi = arr.astype(np.int64)
            idx = np.clip(np.searchsorted(e.values.array, vi), 0,
                          max(len(e.values.array) - 1, 0))
            out = (len(e.values.array) > 0) \
                & (e.values.array[idx] == vi) if len(e.values.array) \
                else np.zeros(len(vi), dtype=bool)
            if ok is not None:
                out = out & ok
        elif _is_str_like(v):
            vals = set(e.values)
            out = _map1(v, lambda x: x in vals)
        else:
            out = np.isin(v, [x for x in e.values])
        return np.logical_not(out) if e.negated else out
    if isinstance(e, E.Between):
        v = eval_expr(e.child, env)
        lo = eval_expr(e.low, env)
        hi = eval_expr(e.high, env)
        v1, lo = _cmp_promote(v, lo)
        v2, hi = _cmp_promote(v, hi)
        out = np.logical_and(v1 >= lo, v2 <= hi)
        return np.logical_not(out) if e.negated else out
    if isinstance(e, E.Like):
        v = eval_expr(e.child, env)
        from spark_druid_olap_tpu_torch.ops.expr_compile import like_to_regex
        rx = re.compile(like_to_regex(e.pattern))
        # NULLs (None/NaN in object arrays) match nothing under either
        # polarity here; eval_pred3's Like branch adds the UNKNOWN mask
        out = _map1(v, lambda s: bool(rx.match(s))
                    if isinstance(s, str) else False)
        if isinstance(out, np.ndarray):
            out = out.astype(bool)
        return np.logical_not(out) if e.negated else out
    if isinstance(e, E.Func):
        return _func(e, env)
    if isinstance(e, E.Cast):
        v = eval_expr(e.child, env)
        to = e.to.lower()
        if to in ("double", "float", "decimal"):
            return np.asarray(v, dtype=np.float64) if isinstance(v, np.ndarray) \
                else float(v)
        if to in ("long", "int", "bigint", "integer"):
            if _is_str_like(v):
                return _map1(v, lambda s: int(float(s)))
            return np.asarray(v).astype(np.int64) if isinstance(v, np.ndarray) \
                else int(v)
        if to in ("string", "varchar"):
            if isinstance(v, np.ndarray):
                return np.array([str(x) for x in v], dtype=object)
            return str(v)
        if to in ("date", "timestamp"):
            return _to_days(v)
        raise HostEvalError(f"cast {to}")
    if isinstance(e, E.KeyedLookup):
        k = np.asarray(eval_expr(e.key, env))
        keys, vals = e.table.keys, e.table.values
        miss = np.nan if e.default is None else float(e.default)
        if k.dtype == object or k.dtype.kind == "f":
            kn = pd.to_numeric(pd.Series(k.reshape(-1)),
                               errors="coerce").to_numpy()
            ok = ~np.isnan(kn) & (kn == np.floor(kn))
            ki = np.where(ok, kn, 0).astype(np.int64)
        else:
            ok = None
            ki = k.reshape(-1).astype(np.int64)
        if len(keys) == 0:
            return np.full(ki.shape, miss)
        idx = np.clip(np.searchsorted(keys, ki), 0, len(keys) - 1)
        found = keys[idx] == ki
        if ok is not None:
            # NULL key: the correlated set is empty -> miss value
            found &= ok
        out = np.where(found, vals[idx], miss)
        return out.reshape(k.shape)
    if isinstance(e, E.KeyedLookup2):
        k1 = np.asarray(eval_expr(e.key1, env))
        k2 = np.asarray(eval_expr(e.key2, env))
        miss = np.nan if e.default is None else float(e.default)

        def intify(k):
            if k.dtype == object or k.dtype.kind == "f":
                kn = pd.to_numeric(pd.Series(k.reshape(-1)),
                                   errors="coerce").to_numpy()
                ok = ~np.isnan(kn) & (kn == np.floor(kn))
                return np.where(ok, kn, 0).astype(np.int64), ok
            return k.reshape(-1).astype(np.int64), None

        a, ok1 = intify(k1)
        b, ok2 = intify(k2)
        tab = e.table
        if len(tab) == 0:
            return np.full(a.shape, miss)
        # monotone int64 packing: keys2 offset into [0, 2^32) preserves
        # the lexicographic order of (k1, k2) pairs. Table keys fit int32
        # (FrozenKeyedTable2 invariant); PROBE values outside that range
        # must miss — their packing would wrap into false matches
        inr = (a >= -(2**31)) & (a < 2**31) & (b >= -(2**31)) & (b < 2**31)
        a0 = np.where(inr, a, 0)
        b0 = np.where(inr, b, 0)
        packed = tab.keys1 * (1 << 32) + (tab.keys2 + (1 << 31))
        probe = a0 * (1 << 32) + (b0 + (1 << 31))
        idx = np.clip(np.searchsorted(packed, probe), 0, len(tab) - 1)
        found = (packed[idx] == probe) & inr
        for ok in (ok1, ok2):
            if ok is not None:
                found &= ok
        out = np.where(found, tab.values[idx], miss)
        return out.reshape(k1.shape)
    if isinstance(e, E.Case):
        otherwise = eval_expr(e.otherwise, env) if e.otherwise is not None else 0
        out = otherwise
        for c, v in reversed(e.branches):
            cond = eval_expr(c, env)
            if not np.any(cond):
                # dead branch: skip so e.g. a NaN (SQL NULL) arm doesn't
                # promote an integer result to float64 when no row hits it
                continue
            val = eval_expr(v, env)
            out = np.where(cond, val, out)
        return out
    raise HostEvalError(f"node {type(e).__name__}")


def _map_null(v):
    if v is None:
        return np.ones((), dtype=bool)
    if isinstance(v, float) and math.isnan(v):
        return np.ones((), dtype=bool)
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            return _map1(v, lambda x: x is None
                         or (isinstance(x, float) and math.isnan(x)))
        if np.issubdtype(v.dtype, np.floating):
            return np.isnan(v)
        if np.issubdtype(v.dtype, np.datetime64) \
                or np.issubdtype(v.dtype, np.timedelta64):
            return np.isnat(v)
    return np.zeros(np.shape(v), dtype=bool)


def eval_pred3(e: E.Expr, env: dict) -> np.ndarray:
    """SQL three-valued WHERE/HAVING mask: TRUE keeps the row; UNKNOWN
    (NULL-involved, NaN/None-coded) folds to FALSE at the root, but
    propagates through NOT/AND/OR with Kleene semantics first — so
    ``NOT (x > NULL)`` and ``x <> NULL`` correctly DROP rows where a
    plain boolean evaluation would keep them."""
    t, u = _pred3(e, env)
    out = np.logical_and(t, np.logical_not(u))
    return np.asarray(out, dtype=bool)


def _pred3(e: E.Expr, env: dict):
    """-> (definitely_true, unknown) boolean masks (disjoint). All logic
    via np.logical_* so scalar (builtin-bool) operands stay safe."""
    NOT, AND, OR = np.logical_not, np.logical_and, np.logical_or

    def b(x):
        return np.asarray(x, dtype=bool)

    if isinstance(e, E.Not):
        t, u = _pred3(e.child, env)
        return AND(NOT(t), NOT(u)), u
    if isinstance(e, E.And):
        parts = [_pred3(p, env) for p in e.parts]
        t_all = parts[0][0]
        f_any = AND(NOT(parts[0][0]), NOT(parts[0][1]))
        for t, u in parts[1:]:
            t_all = AND(t_all, t)
            f_any = OR(f_any, AND(NOT(t), NOT(u)))
        return t_all, AND(NOT(t_all), NOT(f_any))
    if isinstance(e, E.Or):
        parts = [_pred3(p, env) for p in e.parts]
        t_any = parts[0][0]
        f_all = AND(NOT(parts[0][0]), NOT(parts[0][1]))
        for t, u in parts[1:]:
            t_any = OR(t_any, t)
            f_all = AND(f_all, AND(NOT(t), NOT(u)))
        return t_any, AND(NOT(t_any), NOT(f_all))
    if isinstance(e, E.Comparison):
        a = eval_expr(e.left, env)
        bb = eval_expr(e.right, env)
        u = OR(_map_null(a), _map_null(bb))
        res = b(_compare(e.op, a, bb))      # operands evaluated once
        res, u = np.broadcast_arrays(res, u)
        return AND(res, NOT(u)), u
    if isinstance(e, E.IsNull):
        res = b(eval_expr(e, env))
        return res, np.zeros(res.shape, dtype=bool)
    if isinstance(e, E.Between):
        inner = E.And((E.Comparison(">=", e.child, e.low),
                       E.Comparison("<=", e.child, e.high)))
        if e.negated:
            inner = E.Not(inner)
        return _pred3(inner, env)
    if isinstance(e, (E.InList, E.Like)):
        # membership/pattern matching implements its own list-null
        # rules; the probe being NULL makes the result UNKNOWN (never
        # TRUE — 'NOT LIKE' over a NULL must drop the row)
        u = _map_null(eval_expr(e.child, env))
        res = b(eval_expr(e, env))
        res, u = np.broadcast_arrays(res, u)
        return AND(res, NOT(u)), u
    v = eval_expr(e, env)
    u = _map_null(v)
    if isinstance(v, np.ndarray) and v.dtype == object:
        res = b(_map1(v, bool))
    elif np.any(u):
        res = b(np.where(u, False, np.nan_to_num(v)))
    else:
        res = b(v)
    res, u = np.broadcast_arrays(res, u)
    return AND(res, NOT(u)), u


def _date_promote(a, b, op):
    """date +/- int means day arithmetic."""
    a_date = isinstance(a, (np.datetime64, _dt.date)) or (
        isinstance(a, np.ndarray) and np.issubdtype(a.dtype, np.datetime64))
    if a_date and op in "+-":
        return _to_days(a), b
    return a, b


def _cmp_promote(a, b):
    """Make date-vs-string / date-vs-date comparisons integer-day compares."""
    def dateish(v):
        return isinstance(v, (np.datetime64, _dt.date)) or (
            isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.datetime64))
    if dateish(a) or dateish(b):
        return _to_days(a), _to_days(b)
    return a, b


def _func(e: E.Func, env):
    name = e.name.lower()
    args = [eval_expr(a, env) for a in e.args]
    if name in ("year", "month", "day", "quarter", "dow", "doy", "week",
                "hour", "minute", "second"):
        days = _to_days(args[0])
        y, m, d = _civil(days)
        if name == "year":
            return y
        if name == "month":
            return m
        if name == "day":
            return d
        if name == "quarter":
            return (m - 1) // 3 + 1
        if name == "dow":
            return (np.asarray(days) + 3) % 7 + 1
        if name == "doy":
            jan1 = np.array([days_from_civil(int(yy), 1, 1) for yy in np.atleast_1d(y)])
            return np.asarray(days) - (jan1 if jan1.size > 1 else jan1[0]) + 1
        if name == "week":
            return (np.asarray(days) + 3) // 7
        raise HostEvalError(f"{name} needs sub-day time")
    if name in ("date_add", "dateadd"):
        return _to_days(args[0]) + np.asarray(args[1])
    if name in ("date_sub",):
        return _to_days(args[0]) - np.asarray(args[1])
    if name == "datediff":
        return _to_days(args[0]) - _to_days(args[1])
    if name == "add_months":
        raw = _to_days(args[0])
        was_scalar = np.ndim(raw) == 0
        days = np.atleast_1d(raw)
        n = np.asarray(args[1])
        dates = days.astype("datetime64[D]")
        months = dates.astype("datetime64[M]")
        dom = (dates - months).astype(np.int64)          # 0-based day
        nm = (months.astype(np.int64) + n).astype("datetime64[M]")
        month_len = ((nm + 1).astype("datetime64[D]")
                     - nm.astype("datetime64[D]")).astype(np.int64)
        out = nm.astype("datetime64[D]") + np.minimum(dom, month_len - 1)
        return out[0] if was_scalar else out
    if name in ("date_trunc", "trunc"):
        grain = args[0].lower()
        days = _to_days(args[1])
        dates = np.asarray(days).astype("datetime64[D]")
        if grain == "day":
            return dates
        if grain == "week":
            return ((np.asarray(days) + 3) // 7 * 7 - 3).astype("datetime64[D]")
        if grain == "month":
            return dates.astype("datetime64[M]").astype("datetime64[D]")
        if grain == "year":
            return dates.astype("datetime64[Y]").astype("datetime64[D]")
        if grain == "quarter":
            mi = dates.astype("datetime64[M]").astype(np.int64)
            return (mi // 3 * 3).astype("datetime64[M]").astype("datetime64[D]")
        raise HostEvalError(grain)
    if name in ("lower", "upper", "trim", "ltrim", "rtrim", "reverse"):
        fn = {"lower": str.lower, "upper": str.upper, "trim": str.strip,
              "ltrim": str.lstrip, "rtrim": str.rstrip,
              "reverse": lambda s: s[::-1]}[name]
        return _map1(args[0], fn)
    if name in ("substr", "substring"):
        start = int(args[1])
        ln = int(args[2]) if len(args) > 2 else None
        i0 = start - 1 if start > 0 else start
        return _map1(args[0],
                     lambda s: s[i0: i0 + ln] if ln is not None else s[i0:])
    if name == "concat":
        def cc(*xs):
            return "".join(str(x) for x in xs)
        arrs = [a for a in args if isinstance(a, np.ndarray)]
        if not arrs:
            return cc(*args)
        n = len(arrs[0])
        return np.array(["".join(str(a[i] if isinstance(a, np.ndarray) else a)
                                 for a in args) for i in range(n)], dtype=object)
    if name == "replace":
        return _map1(args[0], lambda s: s.replace(args[1], args[2]))
    if name in ("length", "char_length"):
        out = _map1(args[0], len)
        return out.astype(np.int64) if isinstance(out, np.ndarray) else out
    if name in ("lpad", "rpad"):
        n = int(args[1])
        fill = args[2] if len(args) > 2 else " "
        fn = (lambda s: s.rjust(n, fill)) if name == "lpad" \
            else (lambda s: s.ljust(n, fill))
        return _map1(args[0], fn)
    if name == "abs":
        return np.abs(args[0])
    if name == "round":
        if len(args) > 1:
            return np.round(np.asarray(args[0], dtype=np.float64), int(args[1]))
        return np.round(np.asarray(args[0], dtype=np.float64))
    if name in ("floor", "ceil", "sqrt", "exp", "ln", "log"):
        fn = {"floor": np.floor, "ceil": np.ceil, "sqrt": np.sqrt,
              "exp": np.exp, "ln": np.log, "log": np.log}[name]
        return fn(np.asarray(args[0], dtype=np.float64))
    if name in ("power", "pow"):
        return np.power(np.asarray(args[0], dtype=np.float64), args[1])
    if name == "regexp_extract":
        import re as _re
        rx = _re.compile(str(args[1]))
        idx = int(args[2]) if len(args) > 2 else 1

        def rex(s):
            m = rx.search(s) if isinstance(s, str) else None
            return m.group(idx) if m is not None else None
        return _map1(args[0], rex)
    if name == "__lookup_pairs":
        # LOOKUP(col, 'name') after session resolution: args[1] is the
        # (from, to) pairs; missing keys map to null (Druid SQL LOOKUP)
        table = dict(args[1])

        def lk(s):
            return table.get(s)
        return _map1(args[0], lk)
    if name == "coalesce":
        out = args[-1]
        for a in reversed(args[:-1]):
            isnull = _map_null(a) if isinstance(a, np.ndarray) else (a is None)
            out = np.where(isnull, out, a)
        return out
    fn = EXTRA_FUNCTIONS.get(name)
    if fn is not None:
        arrs = [a for a in args if isinstance(a, np.ndarray)]
        if not arrs:
            return fn(*args)
        n = len(arrs[0])
        out = np.array([fn(*[(a[i] if isinstance(a, np.ndarray) else a)
                             for a in args]) for i in range(n)],
                       dtype=object)
        # only narrow to float64 when every non-null element is already
        # numeric: a function returning '123' must stay a string
        if all(v is None or isinstance(v, (int, float, bool, np.number))
               for v in out):
            try:
                return out.astype(np.float64)
            except (ValueError, TypeError):
                return out
        return out
    raise HostEvalError(f"function {name}")


# module-contributed SQL scalar functions (≈ the reference registering UDFs
# into Spark's global FunctionRegistry via BaseModule.registerFunctions);
# Context.install_module populates this
EXTRA_FUNCTIONS: dict = {}
