"""General-join recognition (the ``join/`` planner's recognizer).

Port of ``spark_druid_olap_tpu/planner/joinplan.py``: the pure recognizer
:func:`try_plan` and its :class:`JoinPlan` are copies. The device join
tiers it hands a plan to (``join/broadcast.py``, ``join/partitioned.py``)
are not ported yet (ROADMAP A.7), so :func:`try_execute` makes the JAX
package's placement decision and then refuses: where the JAX engine would
run a recognized join on its device tier, the port raises
``NotImplementedError`` instead of answering on the host tier; where the
JAX engine declines (kill switch off, not recognized, build side over the
broadcast cap with no cluster), the port declines the same way and the
statement falls through to the composite and host tiers, as there.

Column attribution: the alias-scoping pass has already rewritten
duplicate self-join legs into rename projections (``__sj<i>_<col>``),
so every query-visible name maps to exactly one side — except join keys
between DIFFERENT tables, which scoping leaves bare on both sides
(``k = k``); those are equi keys on both sides and, after an inner equi
join, either side's value is THE value, so other references attribute
to the probe side."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.sql import ast as A
from spark_druid_olap_tpu_torch.utils.config import (
    JOIN_BROADCAST_MAX_BYTES,
    JOIN_ENABLED,
    JOIN_MODE,
)


class JoinUnsupported(Exception):
    """A recognized join the device tiers decline (the caller falls
    through to the composite and host tiers). The JAX package defines it
    in ``ops/hash_join.py``."""

_AGG_FNS = ("count", "sum", "min", "max", "avg")


@dataclasses.dataclass
class SideInfo:
    ds: str                        # stored datasource name
    ren: Dict[str, str]            # query-visible name -> physical column

    def phys(self, qname: str) -> str:
        return self.ren[qname]


@dataclasses.dataclass
class AggSpec:
    out: str                       # output column name
    fn: str                        # count | sum | min | max | avg
    arg: Optional[E.Expr]          # in query names; None for count(*)


@dataclasses.dataclass
class JoinPlan:
    probe: SideInfo
    build: SideInfo
    keys: List[Tuple[str, str]]            # (probe phys, build phys)
    probe_filter: Optional[E.Expr]         # physical names
    build_filter: Optional[E.Expr]         # physical names
    residual: Optional[E.Expr]             # query names (post-probe)
    colside: Dict[str, Tuple[str, str]]    # qname -> ('probe'|'build', phys)
    group_by: List[str]                    # query names
    aggs: List[AggSpec]
    having: Optional[E.Expr]
    order_by: Tuple[A.OrderItem, ...]
    limit: Optional[int]
    items: Tuple[A.SelectItem, ...]

    def probe_cols(self) -> set:
        out = {pc for pc, _ in self.keys}
        out |= {phys for q, (s, phys) in self.colside.items()
                if s == "probe"}
        if self.probe_filter is not None:
            out |= E.columns_in(self.probe_filter)
        return out

    def build_cols(self) -> set:
        out = {bc for _, bc in self.keys}
        out |= {phys for q, (s, phys) in self.colside.items()
                if s == "build"}
        if self.build_filter is not None:
            out |= E.columns_in(self.build_filter)
        return out

    def build_value_cols(self) -> set:
        """Build phys columns needed as device payload (agg args and
        residual refs — group columns travel as codes instead)."""
        used = set()
        for s in self.aggs:
            if s.arg is not None:
                used |= E.columns_in(s.arg)
        if self.residual is not None:
            used |= E.columns_in(self.residual)
        return {self.colside[q][1] for q in used
                if q in self.colside and self.colside[q][0] == "build"}

    def swapped(self) -> "JoinPlan":
        flip = {"probe": "build", "build": "probe"}
        return JoinPlan(
            probe=self.build, build=self.probe,
            keys=[(b, p) for p, b in self.keys],
            probe_filter=self.build_filter,
            build_filter=self.probe_filter,
            residual=self.residual,
            colside={q: (flip[s], c)
                     for q, (s, c) in self.colside.items()},
            group_by=self.group_by, aggs=self.aggs, having=self.having,
            order_by=self.order_by, limit=self.limit, items=self.items)


# =============================================================================
# recognition
# =============================================================================

def _unwrap_leaf(ctx, rel) -> Optional[SideInfo]:
    """A join leaf -> SideInfo, or None when outside the surface.
    Accepts a stored TableRef or the alias-scoping pass's rename
    projection (SubqueryRef over a pure column projection)."""
    store = ctx.store
    if isinstance(rel, A.TableRef):
        try:
            ds = store.get(rel.name)
        except KeyError:
            return None
        return SideInfo(rel.name, {c: c for c in ds.column_names()})
    if isinstance(rel, A.SubqueryRef):
        q = rel.query
        if not isinstance(q, A.SelectStmt) \
                or not isinstance(q.relation, A.TableRef) \
                or q.where is not None or q.group_by is not None \
                or q.having is not None or q.order_by \
                or q.limit is not None or q.distinct:
            return None
        try:
            ds = store.get(q.relation.name)
        except KeyError:
            return None
        ren: Dict[str, str] = {}
        for it in q.items:
            if not isinstance(it.expr, E.Column):
                return None
            ren[it.alias or it.expr.name] = it.expr.name
        if any(c not in ds.column_names() for c in ren.values()):
            return None
        return SideInfo(q.relation.name, ren)
    return None


def _flatten_and(e: Optional[E.Expr]) -> List[E.Expr]:
    if e is None:
        return []
    if isinstance(e, E.And):
        out = []
        for p in e.parts:
            out.extend(_flatten_and(p))
        return out
    return [e]


def _rewrite_phys(e: E.Expr, ren: Dict[str, str]) -> E.Expr:
    def fn(n):
        if isinstance(n, E.Column):
            return E.Column(ren[n.name])
        return n
    return E.transform(e, fn)


def try_plan(ctx, stmt: A.SelectStmt) -> Optional[JoinPlan]:
    """Recognize ``stmt`` as a servable two-table join; None when it is
    not (the caller falls through to the host tier)."""
    rel = stmt.relation
    if not isinstance(rel, A.Join) or rel.kind not in ("inner", "cross"):
        return None
    if stmt.distinct or isinstance(stmt.group_by, A.GroupingSets):
        return None
    a = _unwrap_leaf(ctx, rel.left)
    b = _unwrap_leaf(ctx, rel.right)
    if a is None or b is None:
        return None
    store = ctx.store
    ds_a, ds_b = store.get(a.ds), store.get(b.ds)
    vis_a, vis_b = set(a.ren), set(b.ren)
    shared = vis_a & vis_b

    def owner(name: str) -> Optional[str]:
        if name in shared:
            return "shared"
        if name in vis_a:
            return "a"
        if name in vis_b:
            return "b"
        return None

    def refs_side(e: E.Expr) -> Optional[str]:
        """'a'|'b' when every column of ``e`` resolves to one side
        (shared names count as either), 'x' for cross-side, None for
        an unknown name."""
        sides = set()
        for c in E.columns_in(e):
            o = owner(c)
            if o is None:
                return None
            sides.add(o)
        only = sides - {"shared"}
        if len(only) > 1:
            return "x"
        if only:
            return only.pop()
        return "a"      # shared-only (or constant): either side works

    # -- conjuncts: side filters / equi keys / residual -----------------------
    conjuncts = _flatten_and(rel.condition) + _flatten_and(stmt.where)
    filt: Dict[str, List[E.Expr]] = {"a": [], "b": []}
    keys_ab: List[Tuple[str, str]] = []
    residual: List[E.Expr] = []
    for c in conjuncts:
        if any(isinstance(n, (A.ScalarSubquery, A.InSubquery, A.Exists))
               for n in E.walk(c)):
            return None
        if isinstance(c, E.Comparison) and c.op == "=" \
                and isinstance(c.left, E.Column) \
                and isinstance(c.right, E.Column):
            lo, ro = owner(c.left.name), owner(c.right.name)
            if lo is None or ro is None:
                return None
            if {lo, ro} == {"a", "b"}:
                l, r = (c.left.name, c.right.name) if lo == "a" \
                    else (c.right.name, c.left.name)
                keys_ab.append((l, r))
                continue
            if lo == ro == "shared" and c.left.name == c.right.name:
                keys_ab.append((c.left.name, c.right.name))
                continue
        side = refs_side(c)
        if side is None:
            return None
        if side == "x":
            residual.append(c)
        else:
            filt[side].append(c)
    if not keys_ab:
        return None         # pure cross joins stay on the host tier

    # -- output shape ---------------------------------------------------------
    group_exprs = stmt.group_by or ()
    group_by: List[str] = []
    for g in group_exprs:
        if not isinstance(g, E.Column) or owner(g.name) is None:
            return None
        group_by.append(g.name)
    aggs: List[AggSpec] = []
    used_names: List[str] = list(group_by)
    for i, item in enumerate(stmt.items):
        e = item.expr
        if e == "*" or (isinstance(e, E.Column) and e.name == "*"):
            return None
        if isinstance(e, E.Column):
            if e.name not in group_by:
                return None
            continue
        if not isinstance(e, E.AggCall):
            return None
        if e.fn not in _AGG_FNS or e.distinct or e.approx:
            return None
        if e.arg is not None:
            for c in E.columns_in(e.arg):
                if owner(c) is None:
                    return None
                used_names.append(c)
        aggs.append(AggSpec(item.alias or f"_c{i}", e.fn, e.arg))
    if not aggs:
        return None         # row-returning joins stay on the host tier
    for r in residual:
        used_names.extend(E.columns_in(r))

    # no time columns anywhere in the join surface (the wave loop's
    # ms-since-epoch pseudo column needs interval machinery this tier
    # does not carry)
    def is_time(side: SideInfo, ds, qname: str) -> bool:
        phys = side.ren.get(qname)
        return phys is not None and ds.time is not None \
            and phys == ds.time.name
    for qname in set(used_names) | {k for k, _ in keys_ab} \
            | {k for _, k in keys_ab}:
        if is_time(a, ds_a, qname) or is_time(b, ds_b, qname):
            return None
    for side, ds, fl in (("a", ds_a, filt["a"]), ("b", ds_b, filt["b"])):
        si = a if side == "a" else b
        for f in fl:
            if any(is_time(si, ds, c) for c in E.columns_in(f)):
                return None

    # -- colside attribution (shared names resolve to side a = probe) ---------
    colside: Dict[str, Tuple[str, str]] = {}
    for qname in set(used_names):
        o = owner(qname)
        if o in ("a", "shared"):
            colside[qname] = ("probe", a.ren[qname])
        else:
            colside[qname] = ("build", b.ren[qname])

    def mk_filter(side: SideInfo, parts: List[E.Expr]) -> Optional[E.Expr]:
        if not parts:
            return None
        reww = [_rewrite_phys(p, side.ren) for p in parts]
        return reww[0] if len(reww) == 1 else E.And(tuple(reww))

    # HAVING in terms of output columns: every AggCall must match a
    # projected aggregate (the epilogue evaluates over grouped output)
    having = stmt.having
    if having is not None:
        class _NoMatch(Exception):
            pass

        def rw_having(n):
            if isinstance(n, E.AggCall):
                for s in aggs:
                    if s.fn == n.fn and s.arg == n.arg \
                            and not n.distinct and not n.approx:
                        return E.Column(s.out)
                raise _NoMatch()
            return n
        try:
            having = E.transform(having, rw_having)
        except _NoMatch:
            return None

    return JoinPlan(
        probe=a, build=b,
        keys=[(a.ren[l], b.ren[r]) for l, r in keys_ab],
        probe_filter=mk_filter(a, filt["a"]),
        build_filter=mk_filter(b, filt["b"]),
        residual=(residual[0] if len(residual) == 1
                  else E.And(tuple(residual))) if residual else None,
        colside=colside,
        group_by=group_by, aggs=aggs,
        having=having, order_by=stmt.order_by, limit=stmt.limit,
        items=stmt.items)


# =============================================================================
# execution (placement decision only)
# =============================================================================

def _side_bytes(ds, cols) -> int:
    """Upper-bound host bytes of one join side restricted to ``cols``
    (``parallel/cost.py:join_side_bytes``)."""
    from spark_druid_olap_tpu_torch.ops.scan import array_dtype
    return int(ds.num_rows) * int(sum(np.dtype(array_dtype(ds, c)).itemsize
                                      for c in cols))


def _placement(conf, plan: JoinPlan, store):
    """The JAX cost model's tier choice for ``plan`` on a store with no
    cluster attached (``parallel/cost.py:join_estimate``): ``(mode,
    reason)`` with mode ``broadcast`` or ``host``."""
    forced = str(conf.get(JOIN_MODE)).lower()
    if forced in ("broadcast", "partitioned", "host"):
        return forced, "forced by sdot.join.mode"
    build_ds = store.get(plan.build.ds)
    build_bytes = _side_bytes(build_ds, sorted(plan.build_cols()))
    cap = int(conf.get(JOIN_BROADCAST_MAX_BYTES))
    if build_bytes <= cap:
        return "broadcast", "no cluster"
    return "host", "build exceeds broadcast cap; no cluster"


_RECOGNIZE = object()   # default: recognize internally via try_plan


def try_execute(ctx, stmt: A.SelectStmt, plan=_RECOGNIZE):
    """Session hook: None = not recognized (the host tier takes over);
    :class:`JoinUnsupported` when recognized but placed on the host, as
    the JAX cost model places it. A join the JAX engine would run on its
    device join tier raises ``NotImplementedError`` (ROADMAP A.7)."""
    conf = ctx.config
    ctx.engine.last_stats.pop("join", None)
    if not bool(conf.get(JOIN_ENABLED)):
        return None
    if plan is _RECOGNIZE:
        plan = try_plan(ctx, stmt)
    if plan is None:
        return None
    mode, reason = _placement(conf, plan, ctx.store)
    if mode == "host":
        raise JoinUnsupported(reason)
    raise NotImplementedError(
        f"{mode} device join of {plan.probe.ds!r} with {plan.build.ds!r} "
        f"not ported yet (ROADMAP A.7)")
