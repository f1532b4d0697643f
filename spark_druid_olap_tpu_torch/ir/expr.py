"""Scalar expression IR.

Port counterpart of ``spark_druid_olap_tpu/ir/expr.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

Plays the role Catalyst ``Expression`` trees play in the reference: the common
currency between the SQL front end, the planner's rewrite rules, and code
generation. Where the reference compiles unsupported-but-deterministic
expressions to **JavaScript executed inside Druid**
(``jscodegen/JSCodeGenerator.scala:59-66``), we compile them to **XLA** via
``ops/expr_compile.py`` — and, exactly like ``JSCodeGenerator`` returning
``None``, the compiler bails cleanly on unsupported nodes so the planner can
leave a host-side residual.

Deliberately small: no exprIds/resolution machinery — names are resolved by
the planner against the (globally-unique, star-schema-wide) column namespace,
which the reference also requires (``StarSchemaInfo.scala:127-165``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple


class FrozenIntSet:
    """Immutable sorted int64 membership set with O(1) repr/eq/hash.

    Decorrelated semi/anti joins (EXISTS -> key IN <list>) produce key lists
    reaching millions of values; carrying them as plain tuples would make
    ``repr(query)`` (the executor's program-cache key) and structural
    equality O(n). The digest stands in for the contents everywhere except
    actual membership tests, which use the sorted array directly.
    """

    __slots__ = ("array", "_digest")

    def __init__(self, values):
        import numpy as np
        arr = values if isinstance(values, np.ndarray) \
            else np.fromiter((int(v) for v in values), dtype=np.int64)
        arr = np.unique(arr.astype(np.int64, copy=False))
        arr.setflags(write=False)
        object.__setattr__(self, "array", arr)
        import hashlib
        object.__setattr__(
            self, "_digest", hashlib.sha1(arr.tobytes()).hexdigest())

    def __iter__(self):
        return iter(self.array.tolist())

    def __len__(self):
        return int(len(self.array))

    def __contains__(self, v):
        import numpy as np
        i = int(np.searchsorted(self.array, int(v)))
        return i < len(self.array) and int(self.array[i]) == int(v)

    def __repr__(self):
        return f"FrozenIntSet(n={len(self.array)}, sha={self._digest[:16]})"

    def __eq__(self, o):
        return isinstance(o, FrozenIntSet) and self._digest == o._digest

    def __hash__(self):
        return hash(self._digest)


class Expr:
    """Base scalar expression node."""

    def children(self) -> Tuple["Expr", ...]:
        return ()

    # -- convenience builders (used by tests and the planner) -----------------
    def __add__(self, o): return BinaryOp("+", self, lit(o))
    def __sub__(self, o): return BinaryOp("-", self, lit(o))
    def __mul__(self, o): return BinaryOp("*", self, lit(o))
    def __truediv__(self, o): return BinaryOp("/", self, lit(o))
    def __radd__(self, o): return BinaryOp("+", lit(o), self)
    def __rsub__(self, o): return BinaryOp("-", lit(o), self)
    def __rmul__(self, o): return BinaryOp("*", lit(o), self)
    def eq(self, o): return Comparison("=", self, lit(o))
    def ne(self, o): return Comparison("!=", self, lit(o))
    def lt(self, o): return Comparison("<", self, lit(o))
    def le(self, o): return Comparison("<=", self, lit(o))
    def gt(self, o): return Comparison(">", self, lit(o))
    def ge(self, o): return Comparison(">=", self, lit(o))


def lit(v) -> "Expr":
    return v if isinstance(v, Expr) else Literal(v)


@dataclasses.dataclass(frozen=True)
class Column(Expr):
    name: str
    # The table-alias qualifier as WRITTEN ('s2.region' -> qual='s2'),
    # carried as non-comparing metadata for the planner's alias-scoping
    # pass (planner/scoping.py) — correlated self-references like
    # 's2.region = s.region' are unresolvable from bare names alone.
    # Stripped (None) everywhere after that pass; excluded from eq/repr
    # so resolved trees and cache keys are unaffected.
    qual: Optional[str] = dataclasses.field(default=None, compare=False,
                                            repr=False)


@dataclasses.dataclass(frozen=True)
class Literal(Expr):
    value: Any


@dataclasses.dataclass(frozen=True)
class BinaryOp(Expr):
    op: str  # + - * / %
    left: Expr
    right: Expr

    def children(self): return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class Comparison(Expr):
    op: str  # = != < <= > >=
    left: Expr
    right: Expr

    def children(self): return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class And(Expr):
    parts: Tuple[Expr, ...]

    def children(self): return self.parts


@dataclasses.dataclass(frozen=True)
class Or(Expr):
    parts: Tuple[Expr, ...]

    def children(self): return self.parts


@dataclasses.dataclass(frozen=True)
class Not(Expr):
    child: Expr

    def children(self): return (self.child,)


@dataclasses.dataclass(frozen=True)
class IsNull(Expr):
    child: Expr
    negated: bool = False

    def children(self): return (self.child,)


@dataclasses.dataclass(frozen=True)
class InList(Expr):
    child: Expr
    values: Tuple[Any, ...]
    negated: bool = False

    def children(self): return (self.child,)


@dataclasses.dataclass(frozen=True)
class Between(Expr):
    child: Expr
    low: Expr
    high: Expr
    negated: bool = False

    def children(self): return (self.child, self.low, self.high)


@dataclasses.dataclass(frozen=True)
class Like(Expr):
    child: Expr
    pattern: str           # SQL LIKE pattern (% and _)
    negated: bool = False

    def children(self): return (self.child,)


@dataclasses.dataclass(frozen=True)
class Func(Expr):
    """Named scalar function call (``year``, ``month``, ``extract``,
    ``date_trunc``, ``substr``, ``lower``, ``abs``, ...)."""

    name: str
    args: Tuple[Expr, ...]

    def children(self): return self.args


@dataclasses.dataclass(frozen=True)
class Cast(Expr):
    child: Expr
    to: str  # 'long' | 'double' | 'string' | 'date' | 'timestamp'

    def children(self): return (self.child,)


@dataclasses.dataclass(frozen=True)
class Case(Expr):
    """CASE WHEN c1 THEN v1 [WHEN ...] ELSE e END."""

    branches: Tuple[Tuple[Expr, Expr], ...]
    otherwise: Optional[Expr]

    def children(self):
        out = []
        for c, v in self.branches:
            out += [c, v]
        if self.otherwise is not None:
            out.append(self.otherwise)
        return tuple(out)


# -- aggregate call (only valid inside SELECT/HAVING/ORDER trees) --------------
# comparison-operator mirror for operand swaps (a <op> b == b <flip> a);
# the single source shared by planner/executor rewrites
FLIP_CMP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
            "=": "=", "!=": "!=", "<>": "<>"}


class _FrozenTableBase:
    """Shared identity protocol for frozen lookup tables: a sha1 digest
    stands in for the contents everywhere except actual lookups — the
    executor's program-cache key is ``repr(query)`` (like
    :class:`FrozenIntSet`)."""

    __slots__ = ()

    def _freeze(self, arrays):
        import hashlib
        h = hashlib.sha1()
        for a in arrays:
            a.setflags(write=False)
            h.update(a.tobytes())
        object.__setattr__(self, "_digest", h.hexdigest())

    def __len__(self):
        return int(len(self.values))

    def __repr__(self):
        return f"{type(self).__name__}(n={len(self)}, " \
               f"sha={self._digest[:16]})"

    def __eq__(self, o):
        return type(o) is type(self) and self._digest == o._digest

    def __hash__(self):
        return hash(self._digest)


class FrozenKeyedTable(_FrozenTableBase):
    """Immutable sorted int64-key -> float64-value map."""

    __slots__ = ("keys", "values", "_digest")

    def __init__(self, keys, values):
        import numpy as np
        k = np.asarray(keys, dtype=np.int64)
        v = np.asarray(values, dtype=np.float64)
        assert k.shape == v.shape and k.ndim == 1
        order = np.argsort(k, kind="stable")
        object.__setattr__(self, "keys", k[order])
        object.__setattr__(self, "values", v[order])
        self._freeze((self.keys, self.values))


class FrozenKeyedTable2(_FrozenTableBase):
    """Immutable (int32-range, int32-range) composite-key -> float64-value
    map, sorted lexicographically. Key domains MUST fit int32: the host
    packs pairs into one int64 (k1*2^32 + offset(k2)) and the device
    compares i32 pairs — wider keys would wrap. Enforced here so every
    construction path (planner, serde) keeps the invariant."""

    __slots__ = ("keys1", "keys2", "values", "_digest")

    def __init__(self, keys1, keys2, values):
        import numpy as np
        k1 = np.asarray(keys1, dtype=np.int64)
        k2 = np.asarray(keys2, dtype=np.int64)
        v = np.asarray(values, dtype=np.float64)
        assert k1.shape == k2.shape == v.shape and k1.ndim == 1
        for k in (k1, k2):
            if len(k) and (k.min() < -(2**31) or k.max() >= 2**31):
                raise ValueError(
                    "FrozenKeyedTable2 keys must fit int32")
        order = np.lexsort((k2, k1))
        object.__setattr__(self, "keys1", k1[order])
        object.__setattr__(self, "keys2", k2[order])
        object.__setattr__(self, "values", v[order])
        self._freeze((self.keys1, self.keys2, self.values))


@dataclasses.dataclass(frozen=True)
class KeyedLookup2(Expr):
    """Composite-key broadcast join: the table value at integer pair
    (key1, key2), NULL/default on miss — the decorrelated form of a
    scalar subquery correlated on TWO columns (TPC-H q20's
    'where l_partkey = ps_partkey and l_suppkey = ps_suppkey' shape).
    Device lowering binary-searches the lexicographically-sorted pair
    arrays (no int64 needed on 32-bit backends)."""

    key1: Expr
    key2: Expr
    table: FrozenKeyedTable2
    default: Optional[float] = None

    def children(self):
        return (self.key1, self.key2)


@dataclasses.dataclass(frozen=True)
class KeyedLookup(Expr):
    """Scalar broadcast-join: the table value at integer ``key`` (NULL when
    absent). Produced by correlated-scalar-subquery inlining — the
    decorrelated per-key aggregate of ``(select agg(..) from inner where
    inner.k = outer.k)`` becomes a device gather (binary search over the
    sorted key array), keeping the OUTER query engine-pushable (TPC-H
    q2/q17 shape; ≈ Spark's RewriteCorrelatedScalarSubquery followed by a
    broadcast hash join, collapsed into the scan)."""

    key: Expr
    table: FrozenKeyedTable
    # value for keys absent from the table: None = SQL NULL (NaN-coded);
    # a float for aggregates with a non-NULL empty-group identity
    # (count(*) over zero rows is 0, not NULL)
    default: Optional[float] = None

    def children(self):
        return (self.key,)


@dataclasses.dataclass(frozen=True)
class AggCall(Expr):
    """sum/min/max/avg/count/count_distinct over an argument expression."""

    fn: str                      # sum | min | max | avg | count | count_distinct
    arg: Optional[Expr]          # None for count(*)
    distinct: bool = False
    approx: bool = False         # approximate count-distinct (HLL)
    fraction: Optional[float] = None  # quantile for percentile_approx

    def children(self):
        return (self.arg,) if self.arg is not None else ()


@dataclasses.dataclass(frozen=True)
class WindowCall(Expr):
    """``fn(args) OVER (PARTITION BY ... ORDER BY ... [ROWS ...])``.

    Never reaches the pushdown builder or the host evaluator: the
    session's window post-pass (``window/plan.py``) strips these from
    the statement, runs the base query through the normal engine /
    cluster / mesh path, and computes the window columns on device over
    the (merged) result frame.

    ``frame`` is a ROWS frame as (preceding, following) row counts with
    ``None`` meaning UNBOUNDED on that side; ``frame is None`` means the
    SQL default (unbounded preceding .. current row when ORDER BY is
    present, the whole partition otherwise)."""

    fn: str                               # rank | dense_rank | row_number |
    #                                       lag | lead | sum|min|max|avg|count
    args: Tuple[Expr, ...]
    partition_by: Tuple[Expr, ...] = ()
    order_by: Tuple[Tuple[Expr, bool], ...] = ()   # (expr, ascending)
    frame: Optional[Tuple[Optional[int], Optional[int]]] = None

    def children(self):
        return tuple(self.args) + tuple(self.partition_by) \
            + tuple(x for x, _ in self.order_by)


def walk(e: Expr):
    yield e
    for c in e.children():
        yield from walk(c)


def columns_in(e: Expr):
    return {n.name for n in walk(e) if isinstance(n, Column)}


def agg_calls_in(e: Expr):
    return [n for n in walk(e) if isinstance(n, AggCall)]


def transform(e: Expr, fn):
    """Bottom-up rewrite: rebuild each node from transformed children, then
    apply ``fn``. ≈ Catalyst ``transformUp``."""
    if isinstance(e, BinaryOp):
        e2 = BinaryOp(e.op, transform(e.left, fn), transform(e.right, fn))
    elif isinstance(e, Comparison):
        e2 = Comparison(e.op, transform(e.left, fn), transform(e.right, fn))
    elif isinstance(e, And):
        e2 = And(tuple(transform(p, fn) for p in e.parts))
    elif isinstance(e, Or):
        e2 = Or(tuple(transform(p, fn) for p in e.parts))
    elif isinstance(e, Not):
        e2 = Not(transform(e.child, fn))
    elif isinstance(e, IsNull):
        e2 = IsNull(transform(e.child, fn), e.negated)
    elif isinstance(e, InList):
        e2 = InList(transform(e.child, fn), e.values, e.negated)
    elif isinstance(e, Between):
        e2 = Between(transform(e.child, fn), transform(e.low, fn),
                     transform(e.high, fn), e.negated)
    elif isinstance(e, Like):
        e2 = Like(transform(e.child, fn), e.pattern, e.negated)
    elif isinstance(e, Func):
        e2 = Func(e.name, tuple(transform(a, fn) for a in e.args))
    elif isinstance(e, Cast):
        e2 = Cast(transform(e.child, fn), e.to)
    elif isinstance(e, Case):
        e2 = Case(tuple((transform(c, fn), transform(v, fn))
                        for c, v in e.branches),
                  None if e.otherwise is None else transform(e.otherwise, fn))
    elif isinstance(e, AggCall):
        e2 = AggCall(e.fn, None if e.arg is None else transform(e.arg, fn),
                     e.distinct, e.approx, e.fraction)
    elif isinstance(e, WindowCall):
        e2 = WindowCall(e.fn, tuple(transform(a, fn) for a in e.args),
                        tuple(transform(p, fn) for p in e.partition_by),
                        tuple((transform(x, fn), asc)
                              for x, asc in e.order_by),
                        e.frame)
    elif isinstance(e, KeyedLookup):
        e2 = KeyedLookup(transform(e.key, fn), e.table, e.default)
    elif isinstance(e, KeyedLookup2):
        e2 = KeyedLookup2(transform(e.key1, fn), transform(e.key2, fn),
                          e.table, e.default)
    else:
        e2 = e
    return fn(e2)


def to_sql(e: Expr) -> str:
    """Debug/explain rendering."""
    if isinstance(e, Column):
        return e.name
    if isinstance(e, Literal):
        return repr(e.value)
    if isinstance(e, BinaryOp):
        return f"({to_sql(e.left)} {e.op} {to_sql(e.right)})"
    if isinstance(e, Comparison):
        return f"({to_sql(e.left)} {e.op} {to_sql(e.right)})"
    if isinstance(e, And):
        return "(" + " AND ".join(to_sql(p) for p in e.parts) + ")"
    if isinstance(e, Or):
        return "(" + " OR ".join(to_sql(p) for p in e.parts) + ")"
    if isinstance(e, Not):
        return f"(NOT {to_sql(e.child)})"
    if isinstance(e, IsNull):
        return f"({to_sql(e.child)} IS {'NOT ' if e.negated else ''}NULL)"
    if isinstance(e, InList):
        vals = repr(e.values) if isinstance(e.values, FrozenIntSet) \
            else ", ".join(repr(v) for v in e.values)
        return f"({to_sql(e.child)} {'NOT ' if e.negated else ''}IN ({vals}))"
    if isinstance(e, Between):
        return (f"({to_sql(e.child)} {'NOT ' if e.negated else ''}BETWEEN "
                f"{to_sql(e.low)} AND {to_sql(e.high)})")
    if isinstance(e, Like):
        return f"({to_sql(e.child)} {'NOT ' if e.negated else ''}LIKE {e.pattern!r})"
    if isinstance(e, Func):
        return f"{e.name}({', '.join(to_sql(a) for a in e.args)})"
    if isinstance(e, Cast):
        return f"CAST({to_sql(e.child)} AS {e.to})"
    if isinstance(e, Case):
        parts = " ".join(f"WHEN {to_sql(c)} THEN {to_sql(v)}"
                         for c, v in e.branches)
        tail = f" ELSE {to_sql(e.otherwise)}" if e.otherwise is not None else ""
        return f"CASE {parts}{tail} END"
    if isinstance(e, AggCall):
        arg = "*" if e.arg is None else to_sql(e.arg)
        d = "DISTINCT " if e.distinct else ""
        frac = f", {e.fraction!r}" if e.fraction is not None else ""
        return f"{e.fn}({d}{arg}{frac})"
    if isinstance(e, WindowCall):
        arg = ", ".join(to_sql(a) for a in e.args)
        parts = []
        if e.partition_by:
            parts.append("PARTITION BY "
                         + ", ".join(to_sql(p) for p in e.partition_by))
        if e.order_by:
            parts.append("ORDER BY " + ", ".join(
                to_sql(x) + ("" if asc else " DESC")
                for x, asc in e.order_by))
        if e.frame is not None:
            parts.append(f"ROWS {e.frame!r}")
        return f"{e.fn}({arg}) OVER ({' '.join(parts)})"
    if isinstance(e, KeyedLookup):
        return f"lookup[{e.table!r}]({to_sql(e.key)})"
    if isinstance(e, KeyedLookup2):
        return f"lookup[{e.table!r}]({to_sql(e.key1)}, {to_sql(e.key2)})"
    return repr(e)
