"""Host (pandas) execution of a full SelectStmt.

Port counterpart of ``spark_druid_olap_tpu/planner/host_exec.py``: a copy
kept inside the PyTorch package, which imports nothing of the JAX package.
Two parts differ: ``datasource_frame`` reads the store's host copies
through the port's own ``_host_column_values`` (the port's stores are
always complete, so there is no cross-process gather).

The completeness safety net: whatever the device planner cannot push down
runs here — the analog of the reference leaving non-rewritten plans to plain
Spark execution (every DruidTransform returning Nil means Spark's own
strategies plan the query). Also serves as the differential-test oracle.

Supports joins (equi via merge + residual post-filter), scalar/IN/EXISTS
subqueries (uncorrelated inlined once; correlated evaluated row-wise),
aggregates, grouping sets, distinct, order/limit.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.sql import ast as A
from spark_druid_olap_tpu_torch.utils import host_eval


class HostExecError(Exception):
    pass


# SQL-queryable metadata views (≈ DruidMetadataViews.metadataDFs — the
# reference exposes druidrelations/druidservers/druidsegments as resolvable
# tables via a catalog hook, SPLSessionState.scala:67-74)
def _sys_queries(ctx):
    """In-flight queries (state queued/running, live from the engine's
    inflight registry) ahead of the completed history, with uniform
    state / lane / queued_ms / wall_ms columns so load is observable
    while it is happening."""
    rows = []
    for r in ctx.engine.inflight.snapshot():
        rows.append({"state": r["state"], "queryType": r["query_type"],
                     "datasource": r["datasource"],
                     "query_id": r["query_id"], "lane": r["lane"],
                     "tenant": r["tenant"], "startedAt": r["started_at"],
                     "queued_ms": round(r["queued_ms"], 2),
                     "wall_ms": round(r["wall_ms"], 2)})
    for rec in ctx.history.entries():
        d = rec.to_dict()
        wlm = d.get("wlm") or {}
        d.setdefault("state", "completed")
        d.setdefault("lane", wlm.get("lane"))
        d.setdefault("tenant", wlm.get("tenant"))
        d.setdefault("queued_ms", wlm.get("queued_ms", 0.0))
        d.setdefault("wall_ms", d.get("total_ms"))
        rows.append(d)
    return pd.DataFrame(rows)


def _sys_rollups(ctx):
    from spark_druid_olap_tpu_torch.mv.registry import rollups_view
    return rollups_view(ctx)


def _sys_snapshots(ctx):
    """Deep-storage state (persist/): empty frame with the view's schema
    when persistence is off — the view stays queryable either way."""
    if getattr(ctx, "persist", None) is not None:
        return ctx.persist.snapshots_view()
    cols = ["datasource", "version", "state", "current", "rows",
            "bytes", "wal_seq", "wal_bytes", "dirty", "created_at"]
    return pd.DataFrame(columns=cols)


SYS_VIEWS = {
    "sys_datasources": lambda ctx: ctx.catalog.datasources_view(),
    "sys_segments": lambda ctx: ctx.catalog.segments_view(),
    "sys_columns": lambda ctx: ctx.catalog.columns_view(),
    "sys_queries": _sys_queries,
    "sys_lanes": lambda ctx: ctx.engine.wlm.lanes_view(),
    "sys_rollups": _sys_rollups,
    "sys_snapshots": _sys_snapshots,
}


_TLS_INIT_LOCK = __import__("threading").Lock()


def ctx_tls(ctx):
    """Per-context thread-local scratch (temp frames, current query id) —
    concurrent server sessions must not see each other's state. Creation is
    locked: an unsynchronized check-then-set could let two first requests
    each install a threading.local and one lose its state mid-query."""
    tls = getattr(ctx, "_tls", None)
    if tls is None:
        import threading
        with _TLS_INIT_LOCK:
            tls = getattr(ctx, "_tls", None)
            if tls is None:
                tls = ctx._tls = threading.local()
    return tls


def temp_frames(ctx):
    return getattr(ctx_tls(ctx), "temp_frames", None)


def datasource_frame(ctx, name: str, columns=None) -> pd.DataFrame:
    """Materialize a datasource as pandas; ``columns`` (a set) limits the
    materialized columns to those present in the table (callers pass the
    statement's referenced columns — projection pushdown for the host
    tier)."""
    from spark_druid_olap_tpu_torch.parallel.executor import _host_column_values
    temps = temp_frames(ctx)
    if temps and name in temps:
        df = temps[name]
        if columns is not None:
            df = df[[c for c in df.columns if c in columns]]
        return df
    if name in SYS_VIEWS and name not in ctx.store.names():
        return SYS_VIEWS[name](ctx)
    ds = ctx.store.get(name)
    names = ds.column_names()
    if columns is not None:
        names = [c for c in names if c in columns]
    # a partial store of the multi-process mesh: a complete view of the
    # NEEDED columns, gathered across the processes in bounded pages and
    # cached per column, so the host tier serves any statement shape over
    # it (≈ DruidRelation.scala:111's Spark-side fallback scan)
    src = ds
    from spark_druid_olap_tpu_torch.utils.config import (
        HOST_GATHER_PAGE_BYTES)
    ds = ds.complete(columns=names,
                     page_bytes=ctx.config.get(HOST_GATHER_PAGE_BYTES))
    if getattr(ds, "gathered_from_partial", False):
        # the byte-bounded gather cache, per statement as the engine's
        # counters are
        ctx.engine.last_stats["gathered_bytes"] = int(
            src._gathered_cols.bytes)
    data = {c: _host_column_values(ds, c, None) for c in names}
    out = pd.DataFrame(data)
    if len(out.columns) == 0:
        # no referenced columns (e.g. count(*) only): keep the row count
        out.index = range(ds.num_rows)
    return out


_RESULT_CACHE_BOUND = 64


def result_cache(ctx, kind: str, stmt):
    """(cache_dict, key) for session-scoped result caches. Each kind
    ("assist", "subquery") gets its own bounded LRU namespace so the two
    pathways cannot evict each other's entries. The key folds in the
    store version (ingest/drop invalidates) AND the session config
    fingerprint (a timezone or precision change must never serve results
    computed under the old settings)."""
    caches = getattr(ctx, "_result_cache", None)
    if caches is None:
        caches = ctx._result_cache = {}
    cache = caches.get(kind)
    if cache is None:
        cache = caches[kind] = OrderedDict()
    key = (ctx.store.version, ctx.config.fingerprint(), repr(stmt))
    return cache, key


def result_cache_put(cache, key, value):
    """Insert with LRU eviction (oldest-inserted first), keeping the
    cache at most _RESULT_CACHE_BOUND entries *after* the insert."""
    cache[key] = value
    cache.move_to_end(key)
    while len(cache) > _RESULT_CACHE_BOUND:
        cache.popitem(last=False)


def try_engine(ctx, stmt: A.SelectStmt) -> Optional[pd.DataFrame]:
    """Engine-assisted host tier: attempt device pushdown of an
    uncorrelated sub-statement (derived table, inner block of a subquery).

    ≈ the reference's property that a non-rewritten outer plan still gets
    Druid acceleration for rewritable *subtrees* (Catalyst plans each
    relational subtree independently, so a derived table over the fact
    table hits DruidStrategy even when the outer join does not). Returns
    None when the sub-statement cannot push down.
    """
    from spark_druid_olap_tpu_torch.parallel.executor import EngineFallback
    from spark_druid_olap_tpu_torch.planner import builder as B
    from spark_druid_olap_tpu_torch.planner.plans import PlanUnsupported
    cache, key = result_cache(ctx, "assist", stmt)
    if key in cache:
        cache.move_to_end(key)               # keep hot entries resident
        return cache[key]
    try:
        from spark_druid_olap_tpu_torch.planner.decorrelate import \
            inline_subqueries
        from spark_druid_olap_tpu_torch.planner.viewmerge import merge_derived
        from spark_druid_olap_tpu_torch.sql.session import execute_planned
        stmt2 = inline_subqueries(ctx, merge_derived(ctx, stmt))
        pq = B.build(ctx, stmt2)
        df = execute_planned(ctx, pq)
        ctx.history.record(stmt2, {**ctx.engine.last_stats,
                                   "mode": "engine"},
                           sql="(engine-assisted subtree)")
    except (PlanUnsupported, EngineFallback, HostExecError,
            host_eval.HostEvalError, KeyError):
        df = None
    result_cache_put(cache, key, df)
    return df


# -- schema resolution --------------------------------------------------------

def relation_columns(ctx, rel: A.Relation) -> List[str]:
    if isinstance(rel, A.TableRef):
        temps = temp_frames(ctx)
        if temps and rel.name in temps:
            return list(temps[rel.name].columns)
        if rel.name in SYS_VIEWS and rel.name not in ctx.store.names():
            return list(SYS_VIEWS[rel.name](ctx).columns)
        return list(ctx.store.get(rel.name).column_names())
    if isinstance(rel, A.SubqueryRef):
        return select_output_names(ctx, rel.query)
    if isinstance(rel, A.Join):
        return relation_columns(ctx, rel.left) + relation_columns(ctx, rel.right)
    raise HostExecError(f"relation {type(rel).__name__}")


def select_output_names(ctx, stmt) -> List[str]:
    if isinstance(stmt, A.UnionAll):
        return select_output_names(ctx, stmt.parts[0])
    names = []
    for i, item in enumerate(stmt.items):
        if item.expr == "*" or (isinstance(item.expr, E.Column)
                                and item.expr.name == "*"):
            if stmt.relation is not None:
                names.extend(relation_columns(ctx, stmt.relation))
            continue
        if item.alias:
            names.append(item.alias)
        elif isinstance(item.expr, E.Column):
            names.append(item.expr.name)
        else:
            names.append(f"_c{i}")
    return names


# -- subquery handling --------------------------------------------------------

def _subquery_nodes(e: E.Expr):
    for n in E.walk(e):
        if isinstance(n, (A.ScalarSubquery, A.InSubquery, A.Exists)):
            yield n


def _free_columns(ctx, stmt) -> set:
    """Columns referenced by ``stmt`` that its own relation doesn't provide
    (i.e. correlation bindings)."""
    if isinstance(stmt, A.UnionAll):
        out = set()
        for p in stmt.parts:
            out |= _free_columns(ctx, p)
        return out
    visible = set(relation_columns(ctx, stmt.relation)) \
        if stmt.relation is not None else set()
    for i, item in enumerate(stmt.items):
        if item.alias:
            visible.add(item.alias)
    refs = set()

    def collect(e):
        if e is None or isinstance(e, str):
            return
        for n in E.walk(e):
            if isinstance(n, E.Column) and n.name != "*":
                refs.add(n.name)
            elif isinstance(n, (A.ScalarSubquery, A.Exists)):
                refs.update(_free_columns(ctx, n.query))
            elif isinstance(n, A.InSubquery):
                refs.update(_free_columns(ctx, n.query))

    for item in stmt.items:
        collect(item.expr if item.expr != "*" else None)
    collect(stmt.where)
    gb = stmt.group_by
    if isinstance(gb, tuple):
        for g in gb:
            collect(g)
    elif isinstance(gb, A.GroupingSets):
        for s in gb.sets:
            for g in s:
                collect(g)
    collect(stmt.having)
    for o in stmt.order_by:
        collect(o.expr)

    def collect_join_conds(rel):
        # Join ON conditions are expressions of THIS scope (a correlated
        # reference may live there); derived-table bodies declare their
        # own free columns via relation_columns, not here
        if isinstance(rel, A.Join):
            collect(rel.condition)
            collect_join_conds(rel.left)
            collect_join_conds(rel.right)

    collect_join_conds(stmt.relation)
    return refs - visible


def resolve_subqueries(ctx, e: E.Expr, env: Dict[str, np.ndarray],
                       outer_env: Optional[dict] = None) -> E.Expr:
    """Replace subquery nodes with literal values/lists/flags.

    Uncorrelated subqueries execute once. Equality-correlated ones are
    decorrelated into one grouped/semi-joined inner execution; the rest
    evaluate row-wise (slow path — the reference likewise leaves these to
    Spark)."""
    subs = list(_subquery_nodes(e))
    if not subs:
        return e

    n_rows = None
    for v in env.values():
        n_rows = len(v)
        break

    def replace(node):
        if isinstance(node, (A.ScalarSubquery, A.Exists, A.InSubquery)):
            free = _free_columns(ctx, node.query)
            free = {f for f in free if f in env or
                    (outer_env is not None and f in outer_env)}
            if not free:
                val = _execute_sub_once(ctx, node, outer_env)
                return val
            val = _execute_sub_decorrelated(ctx, node, env, free, n_rows,
                                            outer_env)
            if val is not None:
                return val
            return _execute_sub_rowwise(ctx, node, env, free, n_rows,
                                        outer_env)
        return node

    return E.transform(e, replace)


def _execute_sub_once(ctx, node, outer_env):
    df = None
    if not outer_env and getattr(ctx, "host_engine_assist", True):
        df = try_engine(ctx, node.query)
    if df is None:
        df = execute_select(ctx, node.query, outer_env=outer_env)
    if isinstance(node, A.ScalarSubquery):
        if df.shape[0] == 0:
            return E.Literal(None)
        return E.Literal(df.iloc[0, 0])
    if isinstance(node, A.Exists):
        flag = (len(df) > 0) != node.negated
        return E.Literal(flag)
    from spark_druid_olap_tpu_torch.planner.decorrelate import build_in_list_expr
    return build_in_list_expr(node.child, df.iloc[:, 0], node.negated)


_PrecomputedColumn = host_eval.Precomputed


def _expr_refs(ctx, e) -> set:
    """Column names referenced by ``e``, including the *free* columns of any
    nested subquery (a nested subquery's own columns are not references)."""
    refs = set()
    for n in E.walk(e):
        if isinstance(n, E.Column) and n.name != "*":
            refs.add(n.name)
        elif isinstance(n, (A.ScalarSubquery, A.Exists, A.InSubquery)):
            refs.update(_free_columns(ctx, n.query))
    return refs


def _has_subquery(e) -> bool:
    return any(True for _ in _subquery_nodes(e))


def _relation_free_refs(ctx, rel) -> set:
    """Free/outer references made from inside a FROM clause."""
    if rel is None or isinstance(rel, A.TableRef):
        return set()
    if isinstance(rel, A.SubqueryRef):
        return _free_columns(ctx, rel.query)
    if isinstance(rel, A.Join):
        r = _relation_free_refs(ctx, rel.left) | \
            _relation_free_refs(ctx, rel.right)
        if rel.condition is not None:
            r |= _expr_refs(ctx, rel.condition)
        return r
    return set()


def _outer_key_array(env, outer_env, name, n_rows):
    if name in env:
        v = np.asarray(env[name])
        return v if v.ndim > 0 else np.broadcast_to(v, (n_rows,))
    v = (outer_env or {}).get(name)
    if isinstance(v, np.ndarray) and v.ndim > 0:
        return None  # array from a different scope; length unknown — bail
    return np.full(n_rows, v, dtype=object) if isinstance(v, str) else \
        np.broadcast_to(np.asarray(v), (n_rows,))


def _align_key(left: pd.Series, right: pd.Series):
    """Promote two merge-key columns to a common dtype so pandas joins them."""
    lk, rk = left.to_numpy(), right.to_numpy()
    if lk.dtype == object or rk.dtype == object:
        return left.astype(object), right.astype(object)
    if lk.dtype != rk.dtype:
        try:
            t = np.result_type(lk.dtype, rk.dtype)
            return left.astype(t), right.astype(t)
        except TypeError:
            return left.astype(object), right.astype(object)
    return left, right


_MINMAX_FLIP = E.FLIP_CMP


def _residual_minmax(ctx, c, free, inner_cols):
    """(op, inner_expr, outer_col_name) when the residual conjunct is a
    single comparison 'inner_expr <op> outer_col' with op in
    {<, <=, >, >=, <>} — decidable from per-key (min, max) of the inner
    expression. op is normalized so the inner side reads on the LEFT.
    Returns None for any other shape."""
    if not isinstance(c, E.Comparison) \
            or c.op not in ("<", "<=", ">", ">=", "<>", "!="):
        return None
    for a, b, op in ((c.left, c.right, c.op),
                     (c.right, c.left, _MINMAX_FLIP.get(c.op, c.op))):
        if isinstance(b, E.Column) and b.name in free:
            try:
                arefs = _expr_refs(ctx, a)
            except Exception:  # noqa: BLE001
                return None
            if arefs and not (arefs & free) and arefs <= inner_cols \
                    and not _has_subquery(a):
                return ("<>" if op == "!=" else op, a, b.name)
    return None


def _execute_sub_decorrelated(ctx, node, env, free, n_rows, outer_env):
    """Vectorized correlated-subquery evaluation.

    Classic decorrelation: when every outer reference occurs only in
    top-level equality conjuncts of the inner WHERE (plus, for EXISTS/IN,
    residual predicates over plain inner columns), run the inner query ONCE —
    grouped by (for scalar aggregates) or projected onto (for EXISTS/IN) the
    correlation keys — then join the result back to the outer rows. The
    reference leaves correlated subqueries to Spark, whose optimizer performs
    the same rewrite (``RewriteCorrelatedScalarSubquery``); this is our host
    analog. Returns a ``Precomputed`` column or ``None`` to fall back to the
    row-wise path.
    """
    q = node.query
    if q.relation is None or q.limit is not None or q.having is not None:
        return None
    if _relation_free_refs(ctx, q.relation) & free:
        return None
    aggs = []
    for item in q.items:
        if item.expr != "*":
            aggs.extend(E.agg_calls_in(item.expr))
    is_scalar = isinstance(node, A.ScalarSubquery)
    if is_scalar:
        if len(q.items) != 1 or q.items[0].expr == "*" or not aggs \
                or q.group_by is not None or q.distinct:
            return None
        if _expr_refs(ctx, q.items[0].expr) & free:
            return None
    else:
        if q.group_by is not None or aggs:
            return None
        if isinstance(node, A.InSubquery):
            if not q.items or q.items[0].expr == "*" or \
                    _expr_refs(ctx, q.items[0].expr) & free or \
                    _has_subquery(q.items[0].expr):
                return None
    try:
        inner_cols = set(relation_columns(ctx, q.relation))
    except Exception:
        return None
    # classify WHERE conjuncts
    join_pairs = []        # (free col name, inner key expr)
    inner_conjs = []       # pushed into the single inner execution
    residual_conjs = []    # evaluated post-join (EXISTS/IN only)
    for c in _split_conjuncts(q.where):
        refs = _expr_refs(ctx, c)
        fref = refs & free
        if not fref:
            inner_conjs.append(c)
            continue
        pair = None
        if isinstance(c, E.Comparison) and c.op == "=" and \
                not _has_subquery(c):
            for a, b in ((c.left, c.right), (c.right, c.left)):
                if isinstance(a, E.Column) and a.name in free:
                    brefs = _expr_refs(ctx, b)
                    if not (brefs & free) and brefs <= inner_cols:
                        pair = (a.name, b)
                        break
        if pair is not None:
            join_pairs.append(pair)
            continue
        if is_scalar:
            return None        # scalar aggs need pure equality correlation
        rrefs = refs - free
        if not (rrefs <= inner_cols) or _has_subquery(c):
            return None
        residual_conjs.append(c)
    if not join_pairs:
        return None

    inner_where = None
    for c in inner_conjs:
        inner_where = c if inner_where is None else E.And((inner_where, c))

    # EXISTS with exactly one ordered/inequality residual against one
    # outer column -> per-key min/max instead of the row-level join:
    # 'exists inner.c <op> outer.c' is decidable from (min(c), max(c))
    # per correlation key, so the inner collapses to a GROUPED aggregate
    # (engine-pushable) and the probe is a key-merge + vector compare —
    # never the outer x inner-set cross product (TPC-H q21 shape;
    # Spark's RewritePredicateSubquery + agg pushdown does the same).
    minmax = None                  # (op, inner_expr, outer_free_name)
    if isinstance(node, A.Exists) and len(residual_conjs) == 1:
        minmax = _residual_minmax(ctx, residual_conjs[0], free, inner_cols)

    jk_cols = [f"__jk{j}" for j in range(len(join_pairs))]
    items = [A.SelectItem(b, jk_cols[j])
             for j, (_, b) in enumerate(join_pairs)]
    residual_cols = sorted(set().union(
        *[_expr_refs(ctx, c) - free for c in residual_conjs])) \
        if residual_conjs else []
    if minmax is None:
        for rc in residual_cols:
            items.append(A.SelectItem(E.Column(rc), rc))
    if is_scalar:
        items.append(A.SelectItem(q.items[0].expr, "__val"))
        q2 = dataclasses.replace(
            q, items=tuple(items), where=inner_where,
            group_by=tuple(b for _, b in join_pairs), having=None,
            order_by=(), limit=None)
    elif minmax is not None:
        items.append(A.SelectItem(E.AggCall("min", minmax[1]), "__mn"))
        items.append(A.SelectItem(E.AggCall("max", minmax[1]), "__mx"))
        q2 = dataclasses.replace(
            q, items=tuple(items), where=inner_where,
            group_by=tuple(b for _, b in join_pairs), having=None,
            order_by=(), limit=None, distinct=False)
    else:
        if isinstance(node, A.InSubquery):
            items.append(A.SelectItem(q.items[0].expr, "__inval"))
        q2 = dataclasses.replace(
            q, items=tuple(items), where=inner_where, group_by=None,
            having=None, order_by=(), limit=None, distinct=False)
    df2 = None
    if not outer_env and getattr(ctx, "host_engine_assist", True):
        df2 = try_engine(ctx, q2)
    if df2 is None:
        try:
            df2 = execute_select(ctx, q2, outer_env=outer_env)
        except (HostExecError, host_eval.HostEvalError):
            return None

    # outer side
    outer = {}
    for j, (f, _) in enumerate(join_pairs):
        arr = _outer_key_array(env, outer_env, f, n_rows)
        if arr is None:
            return None
        outer[f"__ok{j}"] = arr
    ok_cols = list(outer.keys())
    if isinstance(node, A.InSubquery):
        ch = host_eval.eval_expr(
            resolve_subqueries(ctx, node.child, env, outer_env), env)
        ch = np.asarray(ch)
        outer["__okv"] = ch if ch.ndim > 0 else \
            np.broadcast_to(ch, (n_rows,))
        ok_cols.append("__okv")
    res_free = set().union(
        *[_expr_refs(ctx, c) & free for c in residual_conjs]) \
        if residual_conjs else set()
    for f in sorted(res_free):
        arr = _outer_key_array(env, outer_env, f, n_rows)
        if arr is None:
            return None
        outer[f"__of_{f}"] = arr
    odf = pd.DataFrame(outer)
    odf["__oidx"] = np.arange(n_rows)

    right_keys = list(jk_cols)
    # NULL never equi-matches (pandas merge would pair NaN with NaN): drop
    # NULL-keyed inner rows; NULL-keyed outer rows then simply never match
    if len(df2):
        df2 = df2[~df2[right_keys].isna().any(axis=1)]
    key_ok_cols = [c for c in ok_cols if c != "__okv"]
    for lc, rc in zip(key_ok_cols, right_keys):
        odf[lc], df2[rc] = _align_key(odf[lc], df2[rc])
    if isinstance(node, A.InSubquery):
        odf["__okv"], df2["__inval"] = _align_key(odf["__okv"],
                                                  df2["__inval"])

    if is_scalar:
        merged = odf.merge(df2, left_on=ok_cols, right_on=right_keys,
                           how="left", sort=False, indicator=True)
        merged = merged.drop_duplicates("__oidx").sort_values("__oidx")
        vals = merged["__val"].to_numpy()
        # an outer row with no matching group still sees the inner GLOBAL
        # aggregate's one identity row: evaluate the select expression over
        # the empty group (count->0, sum/min/max/avg->NULL)
        unmatched = (merged["_merge"] == "left_only").to_numpy()
        if unmatched.any():
            fill = _empty_group_value(q.items[0].expr)
            vals = vals.copy()
            vals[unmatched] = fill
        return _PrecomputedColumn(vals)

    negated = getattr(node, "negated", False)
    if minmax is not None:
        op, _, fname = minmax
        if df2["__mn"].dtype.kind == "M":
            return None    # datetime min/max: row-wise fallback
        merged = odf.merge(df2, left_on=key_ok_cols, right_on=right_keys,
                           how="left", sort=False) \
            .drop_duplicates("__oidx").sort_values("__oidx")
        mn = merged["__mn"].to_numpy()
        mx = merged["__mx"].to_numpy()
        ocv = merged[f"__of_{fname}"].to_numpy()
        str_mode = mn.dtype == object       # lexicographic string min/max
        if not str_mode and ocv.dtype == object:
            ocv = pd.to_numeric(pd.Series(ocv), errors="coerce").to_numpy()
        # ordered compares are UNKNOWN on NULL (no group / all-NULL inner
        # / NULL probe) — EXISTS' UNKNOWN-drops-row rule; evaluated under
        # an explicit validity mask so string mode never compares None
        valid = (pd.Series(mn).notna() & pd.Series(ocv).notna()).to_numpy()
        hit = np.zeros(len(mn), dtype=bool)
        try:
            if op == "<":
                hit[valid] = mn[valid] < ocv[valid]
            elif op == "<=":
                hit[valid] = mn[valid] <= ocv[valid]
            elif op == ">":
                hit[valid] = mx[valid] > ocv[valid]
            elif op == ">=":
                hit[valid] = mx[valid] >= ocv[valid]
            else:                  # '<>'
                hit[valid] = (mn[valid] != ocv[valid]) \
                    | (mx[valid] != ocv[valid])
        except TypeError:
            return None            # mixed-type compare: row-wise fallback
        return _PrecomputedColumn(hit ^ negated)
    if isinstance(node, A.InSubquery) and not residual_conjs:
        # Fast path (no residual predicates): never materialize the
        # outer x per-key-inner-set cross product. Membership is a
        # keys+value equi-merge; the per-group facts 3VL needs (set
        # non-empty? contains NULL?) come from one groupby over df2.
        member = np.zeros(n_rows, dtype=bool)
        dfv = df2[df2["__inval"].notna()]
        hitm = odf[pd.Series(outer["__okv"]).notna().to_numpy()].merge(
            dfv, left_on=key_ok_cols + ["__okv"],
            right_on=right_keys + ["__inval"], how="inner", sort=False)
        if len(hitm):
            member[hitm["__oidx"].unique()] = True
        if len(df2):
            g = df2.groupby(right_keys, sort=False, dropna=False)["__inval"] \
                .agg([("__n", "size"),
                      ("__nulls", lambda s: s.isna().any())]).reset_index()
            stat = odf.merge(g, left_on=key_ok_cols, right_on=right_keys,
                             how="left", sort=False).drop_duplicates("__oidx") \
                .sort_values("__oidx")
            has_group = stat["__n"].notna().to_numpy()
            has_null_inner = stat["__nulls"].fillna(False).to_numpy(bool)
        else:
            has_group = np.zeros(n_rows, dtype=bool)
            has_null_inner = has_group
        return _PrecomputedColumn(_in_flags(
            member, has_group, has_null_inner,
            pd.isna(pd.Series(outer["__okv"])).to_numpy(), negated))

    merged = odf.merge(df2, left_on=key_ok_cols, right_on=right_keys,
                       how="inner", sort=False)
    if residual_conjs:
        menv = {}
        for j, (f, _) in enumerate(join_pairs):
            menv[f] = merged[f"__ok{j}"].to_numpy()
        for f in res_free:
            menv[f] = merged[f"__of_{f}"].to_numpy()
        for rc in residual_cols:
            menv[rc] = merged[rc].to_numpy()
        mask = np.ones(len(merged), dtype=bool)
        for c in residual_conjs:
            mask &= host_eval.eval_pred3(c, menv)
        merged = merged[mask]
    if isinstance(node, A.InSubquery):
        # residual path: merged rows = each outer row's correlated inner set
        member = np.zeros(n_rows, dtype=bool)
        has_group = np.zeros(n_rows, dtype=bool)
        has_null_inner = np.zeros(n_rows, dtype=bool)
        if len(merged):
            has_group[merged["__oidx"].unique()] = True
            nulls = merged["__inval"].isna()
            if nulls.any():
                has_null_inner[merged.loc[nulls, "__oidx"].unique()] = True
            hit = (merged["__okv"].notna() & merged["__inval"].notna() &
                   (merged["__okv"] == merged["__inval"]))
            if hit.any():
                member[merged.loc[hit, "__oidx"].unique()] = True
        return _PrecomputedColumn(_in_flags(
            member, has_group, has_null_inner,
            pd.isna(pd.Series(outer["__okv"])).to_numpy(), negated))
    flags = np.zeros(n_rows, dtype=bool)
    if len(merged):
        flags[merged["__oidx"].unique()] = True
    return _PrecomputedColumn(flags ^ negated)


def _in_flags(member, has_group, has_null_inner, nan_child, negated):
    """SQL 3VL for ``x [NOT] IN S``: membership needs a non-NULL equal pair;
    otherwise the result is UNKNOWN (-> false) when S is non-empty and x is
    NULL or S contains NULL; NOT IN over an empty S is TRUE."""
    if not negated:
        return member
    return ~member & ~(has_group & (nan_child | has_null_inner))


def _empty_group_value(expr):
    """Value of a scalar-aggregate select expression over zero input rows
    (count -> 0, other aggregates -> NULL, then the surrounding arithmetic)."""
    def rep(n):
        if isinstance(n, E.AggCall):
            return E.Literal(0 if n.fn == "count" else None)
        return n
    try:
        v = host_eval.eval_expr(E.transform(expr, rep), {})
        return v.item() if isinstance(v, np.generic) else v
    except Exception:
        return None


def _execute_sub_rowwise(ctx, node, env, free, n_rows, outer_env):
    results = []
    child_vals = None
    if isinstance(node, A.InSubquery):
        ch = host_eval.eval_expr(resolve_subqueries(ctx, node.child, env,
                                                    outer_env), env)
        child_vals = np.broadcast_to(np.asarray(ch, dtype=object), (n_rows,))
    for i in range(n_rows):
        row_env = dict(outer_env or {})
        for f in free:
            src = env if f in env else (outer_env or {})
            v = src[f]
            row_env[f] = v[i] if isinstance(v, np.ndarray) else v
        df = execute_select(ctx, node.query, outer_env=row_env)
        if isinstance(node, A.ScalarSubquery):
            results.append(None if len(df) == 0 else df.iloc[0, 0])
        elif isinstance(node, A.Exists):
            results.append((len(df) > 0) != node.negated)
        else:
            # SQL 3VL: a NULL probe, or a miss against a NULL-bearing
            # list, is UNKNOWN (never TRUE under either polarity)
            inner = df.iloc[:, 0]
            probe = child_vals[i]
            probe_null = probe is None or (isinstance(probe, float)
                                           and np.isnan(probe))
            inset = (not probe_null
                     and probe in set(inner.dropna()))
            if inset:
                results.append(not node.negated)
            elif len(inner) and (probe_null or inner.isna().any()):
                results.append(False)          # UNKNOWN -> drop
            else:
                results.append(bool(node.negated))
    arr = np.array(results, dtype=object)
    try:
        arr = arr.astype(np.float64)
    except (ValueError, TypeError):
        pass
    return _PrecomputedColumn(arr)


# -- relation materialization -------------------------------------------------

def _split_conjuncts(e: Optional[E.Expr]) -> List[E.Expr]:
    if e is None:
        return []
    if isinstance(e, E.And):
        out = []
        for p in e.parts:
            out.extend(_split_conjuncts(p))
        return out
    return [e]


def materialize_relation(ctx, rel: A.Relation, outer_env: Optional[dict],
                         need=None) -> pd.DataFrame:
    """``need``: optional set of columns the enclosing statement references
    — projection pushdown for the host tier; join keys/conditions are added
    as the walk descends. None = everything."""
    if isinstance(rel, A.TableRef):
        return datasource_frame(ctx, rel.name, columns=need)
    if isinstance(rel, A.SubqueryRef):
        if isinstance(rel.query, A.UnionAll):
            return _materialize_union(ctx, rel.query, outer_env)
        if getattr(ctx, "host_engine_assist", True):
            df = try_engine(ctx, rel.query)
            if df is not None:
                return df
        return execute_select(ctx, rel.query, outer_env=outer_env)
    if isinstance(rel, A.Join):
        if need is not None and rel.condition is not None:
            need = need | _expr_refs(ctx, rel.condition)
        left = materialize_relation(ctx, rel.left, outer_env, need)
        right = materialize_relation(ctx, rel.right, outer_env, need)
        conjs = _split_conjuncts(rel.condition)
        eq_pairs = []
        residual = []
        for c in conjs:
            if (isinstance(c, E.Comparison) and c.op == "=" and
                    isinstance(c.left, E.Column) and
                    isinstance(c.right, E.Column)):
                l, r = c.left.name, c.right.name
                if l in left.columns and r in right.columns:
                    eq_pairs.append((l, r))
                    continue
                if r in left.columns and l in right.columns:
                    eq_pairs.append((r, l))
                    continue
            residual.append(c)
        how = {"inner": "inner", "left": "left", "cross": "cross"}[rel.kind]
        if how == "left" and residual:
            # an outer join's ON residual filters the match, not the output:
            # right-only predicates pre-filter the right side (the null
            # extension survives); mixed-side residuals are unsupported
            kept = []
            for c in residual:
                # _expr_refs (not columns_in) so a nested subquery's free
                # correlated columns count as references of this predicate
                cols = _expr_refs(ctx, c)
                if cols <= set(right.columns):
                    renv = {k: right[k].to_numpy() for k in cols}
                    c2 = resolve_subqueries(ctx, c, renv, outer_env)
                    m = host_eval.eval_pred3(c2, renv)
                    right = right[m].reset_index(drop=True)
                else:
                    kept.append(c)
            if kept:
                raise HostExecError(
                    "LEFT JOIN with mixed-side non-equi ON condition")
            residual = []
        if eq_pairs:
            lk = [p[0] for p in eq_pairs]
            rk = [p[1] for p in eq_pairs]
            df = left.merge(right, left_on=lk, right_on=rk, how="inner"
                            if how == "cross" else how)
        elif how == "left" and len(right) == 0:
            # ON condition matched nothing on the right: every left row
            # survives null-extended
            df = left.copy()
            for c in right.columns:
                df[c] = np.nan
        else:
            df = left.merge(right, how="cross")
        if residual:
            env = {c: df[c].to_numpy() for c in df.columns}
            if outer_env:
                # correlated references inside a JOIN ON condition read
                # the enclosing row's scalars (broadcast by eval)
                for k, v in outer_env.items():
                    if k not in env and not isinstance(v, np.ndarray):
                        env[k] = np.full(len(df), v, dtype=object) \
                            if isinstance(v, str) else v
            mask = np.ones(len(df), dtype=bool)
            for c in residual:
                c2 = resolve_subqueries(ctx, c, env, outer_env)
                mask &= host_eval.eval_pred3(c2, env)
            df = df[mask].reset_index(drop=True)
        return df
    raise HostExecError(f"relation {type(rel).__name__}")


# -- aggregation --------------------------------------------------------------

def _agg_key(call: E.AggCall) -> str:
    return E.to_sql(call)


def _grp_key(e: E.Expr) -> str:
    return E.to_sql(e)


def _replace_for_output(e: E.Expr, agg_cols: Dict[str, str],
                        grp_cols: Dict[str, str]) -> E.Expr:
    def rep(n):
        if isinstance(n, E.AggCall) and _agg_key(n) in agg_cols:
            return E.Column(agg_cols[_agg_key(n)])
        return n

    # replace whole group-expr subtrees first (top-down), then agg calls
    def walk_replace(n):
        k = _grp_key(n)
        if k in grp_cols:
            return E.Column(grp_cols[k])
        if isinstance(n, E.AggCall):
            return rep(n)
        # rebuild children
        return None

    def go(n):
        r = walk_replace(n)
        if r is not None:
            return r
        return E.transform(n, rep)

    k = _grp_key(e)
    if k in grp_cols:
        return E.Column(grp_cols[k])
    return go(e)


def _compute_agg(series_env, df, call: E.AggCall, ctx, outer_env, group_ids,
                 n_groups):
    """Aggregate one AggCall over group ids -> array [n_groups]."""
    if call.arg is None:
        vals = np.ones(len(df), dtype=np.int64)
    else:
        arg = resolve_subqueries(ctx, call.arg, series_env, outer_env)
        vals = np.asarray(host_eval.eval_expr(arg, series_env))
        vals = np.broadcast_to(vals, (len(df),)) if vals.ndim == 0 else vals
    s = pd.Series(vals)
    g = pd.Series(group_ids)
    if call.fn == "count":
        if call.distinct:
            out = s.groupby(g).nunique()
        elif call.arg is None:
            out = s.groupby(g).size()
        else:
            out = s.groupby(g).count()
    elif call.fn == "sum":
        out = s.groupby(g).sum()
    elif call.fn == "min":
        out = s.groupby(g).min()
    elif call.fn == "max":
        out = s.groupby(g).max()
    elif call.fn == "avg":
        out = s.groupby(g).mean()
    elif call.fn == "theta":
        # theta-sketch-class approx distinct: the host tier computes exact
        # (nunique already excludes nulls, like the count-distinct branch)
        out = s.groupby(g).nunique()
    elif call.fn == "percentile":
        # host tier computes the exact quantile (the KLL estimate is
        # checked against this within the configured rank-error bound)
        out = s.astype(np.float64).groupby(g).quantile(call.fraction)
    else:
        raise HostExecError(f"aggregate {call.fn}")
    full = out.reindex(range(n_groups))
    if call.fn in ("count", "theta"):
        # keep counts integer: fillna promotes to float64
        full = full.fillna(0).astype(np.int64)
    return full.to_numpy()


def _stmt_column_refs(ctx, stmt: A.SelectStmt):
    """Columns the statement references (incl. free columns of nested
    subqueries), or None when a '*' item needs everything."""
    refs = set()

    def add(e):
        if e is None:
            return
        refs.update(_expr_refs(ctx, e))

    for item in stmt.items:
        if item.expr == "*" or (isinstance(item.expr, E.Column)
                                and item.expr.name == "*"):
            return None
        add(item.expr)
    add(stmt.where)
    add(stmt.having)
    gb = stmt.group_by
    if isinstance(gb, A.GroupingSets):
        for s in gb.sets:
            for g in s:
                add(g)
    elif gb is not None:
        for g in gb:
            add(g)
    for o in stmt.order_by:
        add(o.expr)
    return refs


def execute_select(ctx, stmt: A.SelectStmt,
                   outer_env: Optional[dict] = None) -> pd.DataFrame:
    # FROM
    if stmt.relation is None:
        df = pd.DataFrame({"__dummy__": [0]})
    else:
        # column-pruned materialization: only decode columns the statement
        # (or a join condition on the way down) references — the host-tier
        # analog of projection pushdown; decoding every string column of a
        # fact table dwarfs the actual query work otherwise
        need = _stmt_column_refs(ctx, stmt)
        df = materialize_relation(ctx, stmt.relation, outer_env, need)
    env = {c: df[c].to_numpy() for c in df.columns}
    if outer_env:
        for k, v in outer_env.items():
            if k not in env:
                env[k] = v

    # WHERE
    if stmt.where is not None:
        w = resolve_subqueries(ctx, stmt.where, env, outer_env)
        mask = host_eval.eval_pred3(w, env)
        mask = np.broadcast_to(mask, (len(df),)).astype(bool)
        df = df[mask].reset_index(drop=True)
        env = {c: df[c].to_numpy() for c in df.columns}
        if outer_env:
            for k, v in outer_env.items():
                if k not in env:
                    env[k] = v

    # aggregate detection
    agg_calls: Dict[str, E.AggCall] = {}

    def collect_aggs(e):
        if e is None or isinstance(e, str):
            return
        for n in E.walk(e):
            if isinstance(n, E.AggCall):
                agg_calls[_agg_key(n)] = n

    for item in stmt.items:
        collect_aggs(item.expr if item.expr != "*" else None)
    collect_aggs(stmt.having)
    for o in stmt.order_by:
        collect_aggs(o.expr)

    is_agg = bool(agg_calls) or stmt.group_by is not None

    out_names = select_output_names(ctx, stmt)

    if not is_agg:
        out = {}
        cols = []
        for i, item in enumerate(stmt.items):
            if item.expr == "*" or (isinstance(item.expr, E.Column)
                                    and item.expr.name == "*"):
                for c in df.columns:
                    out[c] = df[c].to_numpy()
                    cols.append(c)
                continue
            name = out_names[len(cols)]
            e2 = resolve_subqueries(ctx, item.expr, env, outer_env)
            v = host_eval.eval_expr(e2, env)
            v = np.broadcast_to(np.asarray(v), (len(df),)) \
                if np.ndim(v) == 0 else np.asarray(v)
            out[name] = v
            cols.append(name)
        res = pd.DataFrame({c: out[c] for c in cols})
        return _order_limit_distinct(ctx, res, stmt, env)

    # group sets
    if isinstance(stmt.group_by, A.GroupingSets):
        group_sets = [list(s) for s in stmt.group_by.sets]
    elif stmt.group_by is None:
        group_sets = [[]]
    else:
        group_sets = [list(stmt.group_by)]
    # resolve ordinal / alias group keys
    alias_map = {}
    for i, item in enumerate(stmt.items):
        if item.alias and item.expr != "*":
            alias_map[item.alias] = item.expr
    resolved_sets = []
    for gs in group_sets:
        rs = []
        for g in gs:
            if isinstance(g, E.Literal) and isinstance(g.value, int):
                rs.append(stmt.items[g.value - 1].expr)
            elif isinstance(g, E.Column) and g.name in alias_map:
                rs.append(alias_map[g.name])
            else:
                rs.append(g)
        resolved_sets.append(rs)

    all_group_exprs = []
    seen = set()
    for rs in resolved_sets:
        for g in rs:
            k = _grp_key(g)
            if k not in seen:
                seen.add(k)
                all_group_exprs.append(g)

    frames = []
    for rs in resolved_sets:
        frames.append(_one_grouping(ctx, stmt, df, env, rs, all_group_exprs,
                                    agg_calls, outer_env, out_names))
    res = pd.concat(frames, ignore_index=True) if len(frames) > 1 else frames[0]
    return _order_limit_distinct(ctx, res, stmt, env)


def _one_grouping(ctx, stmt, df, env, group_exprs, all_group_exprs, agg_calls,
                  outer_env, out_names):
    n = len(df)
    grp_cols: Dict[str, str] = {}
    key_arrays = []
    for j, g in enumerate(group_exprs):
        e2 = resolve_subqueries(ctx, g, env, outer_env)
        v = np.asarray(host_eval.eval_expr(e2, env))
        v = np.broadcast_to(v, (n,)) if v.ndim == 0 else v
        grp_cols[_grp_key(g)] = f"__grp{j}"
        key_arrays.append(v)
    if key_arrays:
        key_df = pd.DataFrame({f"__grp{j}": key_arrays[j]
                               for j in range(len(key_arrays))})
        codes, uniques = pd.factorize(
            pd.MultiIndex.from_frame(key_df)) if len(key_arrays) > 1 else \
            pd.factorize(key_df["__grp0"])
        group_ids = codes
        n_groups = len(uniques)
    else:
        group_ids = np.zeros(n, dtype=np.int64)
        n_groups = 1
    if n == 0:
        # grouped agg over zero rows -> zero groups; GLOBAL agg over zero
        # rows -> one row (NULL sums, 0 counts) per SQL semantics
        n_groups = 0 if key_arrays else 1

    agg_cols: Dict[str, str] = {}
    gagg = {}
    for j, (k, call) in enumerate(agg_calls.items()):
        cname = f"__agg{j}"
        agg_cols[k] = cname
        gagg[cname] = _compute_agg(env, df, call, ctx, outer_env, group_ids,
                                   n_groups)

    # group key values per group
    gkey = {}
    if key_arrays and n_groups > 0:
        first_idx = np.zeros(n_groups, dtype=np.int64)
        seen = np.zeros(n_groups, dtype=bool)
        for i, gid in enumerate(group_ids):
            if not seen[gid]:
                seen[gid] = True
                first_idx[gid] = i
        for j in range(len(key_arrays)):
            gkey[f"__grp{j}"] = key_arrays[j][first_idx]

    genv = {**gkey, **gagg}

    # HAVING
    keep = None
    if stmt.having is not None:
        h = _replace_for_output(
            resolve_subqueries(ctx, stmt.having, env, outer_env),
            agg_cols, grp_cols)
        keep = host_eval.eval_pred3(h, genv)

    out = {}
    cols = []
    for i, item in enumerate(stmt.items):
        if item.expr == "*":
            raise HostExecError("SELECT * with GROUP BY")
        name = out_names[i]
        e2 = _replace_for_output(
            resolve_subqueries(ctx, item.expr, env, outer_env),
            agg_cols, grp_cols)
        # group expr not in this grouping set -> null fill (grouping sets)
        try:
            v = host_eval.eval_expr(e2, genv)
        except host_eval.HostEvalError:
            v = np.full(n_groups, None, dtype=object)
        v = np.broadcast_to(np.asarray(v), (n_groups,)) \
            if np.ndim(v) == 0 else np.asarray(v)
        out[name] = v
        cols.append(name)
    res = pd.DataFrame({c: pd.Series(out[c]) for c in cols})
    if keep is not None:
        res = res[keep].reset_index(drop=True)
    # stash order-by helper columns
    res.attrs["order_helpers"] = _OrderHelpers(agg_cols, grp_cols, genv,
                                               keep)
    return res


class _OrderHelpers:
    """What ORDER BY needs of a grouped frame's evaluation (its aggregate
    and group columns, the per-group environment, the kept groups), held
    in ``DataFrame.attrs`` as one object that deep-copies by reference:
    pandas deep-copies ``attrs`` at every column access, and the per-group
    environment holds whole arrays, one element per group. The JAX
    package keeps the four values in ``attrs`` directly."""

    def __init__(self, agg_cols, grp_cols, genv, keep):
        self.agg_cols, self.grp_cols = agg_cols, grp_cols
        self.genv, self.keep = genv, keep

    def __deepcopy__(self, memo):
        return self


def finish_union(frames, u: A.UnionAll) -> pd.DataFrame:
    """Concatenate UNION ALL branch frames positionally under the first
    branch's names and apply the union's trailing ORDER BY / OFFSET /
    LIMIT (the one implementation shared by the session and host
    tiers)."""
    cols = None
    aligned = []
    for i, df in enumerate(frames):
        if cols is None:
            cols = list(df.columns)
        elif len(df.columns) != len(cols):
            raise HostExecError(
                f"UNION ALL branch {i} has {len(df.columns)} columns, "
                f"expected {len(cols)}")
        else:
            df = df.copy(deep=False)
            df.columns = cols
        aligned.append(df)
    out = pd.concat(aligned, ignore_index=True)
    if u.order_by:
        sort_cols, asc = [], []
        for o in u.order_by:
            e = o.expr
            if isinstance(e, E.Literal) and isinstance(e.value, int):
                if not 1 <= e.value <= len(cols):
                    raise HostExecError(
                        f"ORDER BY ordinal {e.value} out of range "
                        f"(1..{len(cols)})")
                col = cols[e.value - 1]
            elif isinstance(e, E.Column) and e.name in cols:
                col = e.name
            else:
                raise HostExecError(
                    "UNION ORDER BY must reference output columns")
            sort_cols.append(col)
            asc.append(o.ascending)
        out = out.sort_values(sort_cols, ascending=asc,
                              kind="mergesort").reset_index(drop=True)
    if u.offset:
        out = out.iloc[u.offset:].reset_index(drop=True)
    if u.limit is not None:
        out = out.head(u.limit).reset_index(drop=True)
    return out


def _materialize_union(ctx, u: A.UnionAll, outer_env):
    """Derived UNION ALL: branches materialize independently (engine
    assist per branch); see finish_union for the trailing clauses."""
    frames = []
    for part in u.parts:
        df = None
        if not outer_env and getattr(ctx, "host_engine_assist", True):
            df = try_engine(ctx, part)
        if df is None:
            df = execute_select(ctx, part, outer_env=outer_env)
        frames.append(df)
    return finish_union(frames, u)


def _order_limit_distinct(ctx, res: pd.DataFrame, stmt: A.SelectStmt, env):
    if stmt.distinct:
        res = res.drop_duplicates().reset_index(drop=True)
    if stmt.order_by:
        sort_cols = []
        ascending = []
        tmp = res.copy()
        alias_map = {}
        for i, item in enumerate(stmt.items):
            if item.expr != "*":
                alias_map[_grp_key(item.expr)] = res.columns[i] \
                    if i < len(res.columns) else None
        for j, o in enumerate(stmt.order_by):
            e = o.expr
            if isinstance(e, E.Literal) and isinstance(e.value, int):
                col = res.columns[e.value - 1]
            elif isinstance(e, E.Column) and e.name in res.columns:
                col = e.name
            elif _grp_key(e) in alias_map and alias_map[_grp_key(e)]:
                col = alias_map[_grp_key(e)]
            else:
                # compute from result columns
                envr = {c: res[c].to_numpy() for c in res.columns}
                helpers = res.attrs.get("order_helpers") \
                    or _OrderHelpers({}, {}, {}, None)
                e2 = _replace_for_output(e, helpers.agg_cols,
                                         helpers.grp_cols)
                try:
                    v = host_eval.eval_expr(e2, envr)
                except host_eval.HostEvalError:
                    keep = helpers.keep
                    fullenv = dict(helpers.genv)
                    v = np.asarray(host_eval.eval_expr(e2, fullenv))
                    if keep is not None:
                        v = v[keep]
                col = f"__ord{j}"
                tmp[col] = v
            sort_cols.append(col)
            ascending.append(o.ascending)
        tmp = tmp.sort_values(sort_cols, ascending=ascending,
                              kind="mergesort")
        res = tmp[res.columns].reset_index(drop=True)
    if stmt.offset:
        res = res.iloc[stmt.offset:].reset_index(drop=True)
    if stmt.limit is not None:
        res = res.head(stmt.limit).reset_index(drop=True)
    return res
