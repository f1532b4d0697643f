"""SQL session: parse -> plan -> execute.

Port of ``spark_druid_olap_tpu/sql/session.py``: ``run_sql``,
``explain_sql`` / ``explain_text``, the select path with its statement memo
and plan cache, UNION ALL, ``execute_planned`` and the exact count-distinct
phase 2, with the window post-pass (``window/``) and the broadcast join
tier (``planner/joinplan.try_execute``), as there. ``run_sql`` registers a
statement's ``query_id`` before planning and puts it into each spec's
``QueryContext`` (``engine.cancel`` reaches every one), and pushes its
``lane`` / ``tenant`` / ``priority`` for WLM admission. CHECKPOINT, RESTORE
and CLEAR METADATA ... PURGE run through the context's persist manager
(``persist/``) and raise "persistence is disabled" without one, as in the
JAX package. The per-statement
stats carry no device dispatch counts (the JAX engine's
``dispatch_counts``); the kernels' own launch counters take their place.

≈ the reference's end-to-end statement path: ``SPLParser`` front commands +
Catalyst planning with ``DruidStrategy`` + falling back to plain Spark when no
rewrite applies. Here: pushdown builder first; :class:`PlanUnsupported` or a
runtime :class:`EngineFallback` routes to the pandas host executor.
"""

from __future__ import annotations

import functools as _functools
import time as _time
from typing import List, Optional

import numpy as np
import pandas as pd

from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.parallel.executor import EngineFallback
from spark_druid_olap_tpu_torch.planner import builder as B
from spark_druid_olap_tpu_torch.planner import host_exec
from spark_druid_olap_tpu_torch.planner.plans import PlannedQuery, PlanUnsupported
from spark_druid_olap_tpu_torch.result import QueryResult
from spark_druid_olap_tpu_torch.sql import ast as A
from spark_druid_olap_tpu_torch.sql.parser import parse_statement
from spark_druid_olap_tpu_torch.utils import phases as PH

def resolve_lookups(ctx, stmt: A.SelectStmt) -> A.SelectStmt:
    """Inline registered lookup tables: ``LOOKUP(col, 'name')`` becomes
    ``__lookup_pairs(col, <pairs literal>)`` so both the pushdown builder
    (-> LookupExtraction) and the host evaluator see a self-contained
    expression (≈ Druid resolving a registered lookup by name)."""
    if not getattr(ctx, "lookups", None) or not isinstance(stmt,
                                                           A.SelectStmt):
        return stmt
    import dataclasses

    def fix_expr(e):
        if e is None or e == "*":
            return e

        def rep(n):
            if isinstance(n, E.Func) and n.name.lower() == "lookup" \
                    and len(n.args) == 2 \
                    and isinstance(n.args[1], E.Literal) \
                    and isinstance(n.args[1].value, str):
                lname = n.args[1].value
                table = ctx.lookups.get(lname)
                if table is None:
                    raise KeyError(f"unknown lookup {lname!r}; registered: "
                                   f"{sorted(ctx.lookups)}")
                pairs = tuple(sorted(table.items()))
                return E.Func("__lookup_pairs", (n.args[0],
                                                 E.Literal(pairs)))
            if isinstance(n, (A.ScalarSubquery, A.Exists, A.InSubquery)):
                return dataclasses.replace(n,
                                           query=resolve_lookups(ctx,
                                                                 n.query))
            return n
        return E.transform(e, rep)

    def fix_rel(rel):
        if isinstance(rel, A.Join):
            return dataclasses.replace(
                rel, left=fix_rel(rel.left), right=fix_rel(rel.right),
                condition=fix_expr(rel.condition))
        if isinstance(rel, A.SubqueryRef):
            return dataclasses.replace(rel,
                                       query=resolve_lookups(ctx, rel.query))
        return rel

    gb = stmt.group_by
    if isinstance(gb, A.GroupingSets):
        gb = A.GroupingSets(tuple(tuple(fix_expr(g) for g in s)
                                  for s in gb.sets))
    elif gb is not None:
        gb = tuple(fix_expr(g) for g in gb)
    return dataclasses.replace(
        stmt,
        items=tuple(dataclasses.replace(it, expr=fix_expr(it.expr))
                    for it in stmt.items),
        relation=None if stmt.relation is None else fix_rel(stmt.relation),
        where=fix_expr(stmt.where), group_by=gb,
        having=fix_expr(stmt.having),
        order_by=tuple(dataclasses.replace(o, expr=fix_expr(o.expr))
                       for o in stmt.order_by))


class _NegativePlan:
    """Negative plan-cache entry: the builder deterministically rejects the
    statement under the current (store, config). A dedicated type — the
    old structural sentinel (a bare ('unsupported', msg) tuple) would
    silently misclassify any future tuple-shaped plan (ADVICE r3)."""

    __slots__ = ("reason",)

    def __init__(self, reason: str):
        self.reason = reason


_UNSET = object()   # "this memo slot was never computed" (None is a value)


class _StmtMemo:
    """Planning-cascade memo for one canonical statement: every
    recognizer outcome along the select path, INCLUDING negative ones
    (window extraction found nothing, join recognizer declined, builder
    rejected). Keyed like the plan cache — (store version, config
    fingerprint, repr(stmt)) — plus a lookup-table fingerprint, so any
    ingest, config flip, CLEAR METADATA, rollup DDL (registry bumps the
    store version) or lookup registration re-plans from scratch. A warm
    repeated statement skips straight from key to cached plan."""

    __slots__ = ("window", "resolved", "pq", "join", "composite")

    def __init__(self):
        self.window = _UNSET      # None | (base_stmt, WindowPlan)
        self.resolved = _UNSET    # offset-stripped, fully resolved stmt
        self.pq = _UNSET          # PlannedQuery | _NegativePlan
        self.join = _UNSET        # JoinPlan | None (declined)
        self.composite = _UNSET   # CompositePlan | None (rejected)


def _lookups_fp(ctx) -> int:
    """Registered-lookup fingerprint for the memo key: lookup tables
    inline into the resolved statement WITHOUT bumping the store
    version, so re-registering one must miss the memo. Tables are
    dim-scale (the inlined-pairs literal already embeds them in plans),
    so hashing them per statement is noise next to the cascade."""
    lk = getattr(ctx, "lookups", None)
    if not lk:
        return 0
    return hash(tuple((n, tuple(sorted(t.items())))
                      for n, t in sorted(lk.items())))


def _memo_put(cache, key, val, bound: int) -> None:
    """LRU insert honoring sdot.plan.memo.entries (the shared
    result_cache_put has its own fixed bound)."""
    cache[key] = val
    cache.move_to_end(key)
    while len(cache) > max(1, bound):
        cache.popitem(last=False)


@_functools.lru_cache(maxsize=256)
def _parse_cached(sql: str):
    """Memoized parse (AST nodes are frozen dataclasses — safely
    shared). Timed INSIDE the miss path so ``stats['phases']['parse']``
    only appears when the parser actually ran."""
    t0 = _time.perf_counter()
    stmt = parse_statement(sql)
    PH.stash("parse", _time.perf_counter() - t0)
    return stmt


def run_sql(ctx, sql: str, query_id: Optional[str] = None,
            lane: Optional[str] = None, tenant: Optional[str] = None,
            priority: Optional[int] = None) -> QueryResult:
    if lane is not None or tenant is not None or priority is not None:
        # the request's lane / tenant / priority ride WLM's thread-local
        # state down to every spec this statement executes (subqueries and
        # composite sub-plans too), as the query id does below
        ctx.engine.wlm.push_request(lane, tenant, priority)
        try:
            return run_sql(ctx, sql, query_id=query_id)
        finally:
            ctx.engine.wlm.pop_request()
    if query_id is not None:
        # register BEFORE planning so a cancel landing at any point in the
        # statement's life is honored; the id rides thread-local state
        # down to every spec this statement executes
        tls = host_exec.ctx_tls(ctx)   # resolve BEFORE the refcount:
        ctx.engine.register_query(query_id)   # nothing between acquire
        try:                                  # and try may raise
            tls.query_id = query_id
            return _run_sql_inner(ctx, sql)
        finally:
            tls.query_id = None
            ctx.engine.release_query(query_id)
    return _run_sql_inner(ctx, sql)


def _run_sql_inner(ctx, sql: str) -> QueryResult:
    # module-contributed front commands (≈ SPLParser trying its command
    # grammar before the base parser)
    for handler in getattr(ctx, "statement_handlers", ()):
        r = handler(ctx, sql)
        if r is not None:
            return r
    # statement boundary: a previous statement's un-consumed parse time
    # must not leak into this one's accumulator
    PH.clear_stash()
    from spark_druid_olap_tpu_torch.utils.config import PLAN_MEMO_ENABLED
    if ctx.config.get(PLAN_MEMO_ENABLED):
        stmt = _parse_cached(sql)
    else:
        _tp = _time.perf_counter()
        stmt = parse_statement(sql)
        PH.stash("parse", _time.perf_counter() - _tp)
    if isinstance(stmt, A.ClearMetadata):
        from spark_druid_olap_tpu_torch.mv.registry import clear_rollups
        if stmt.datasource:
            ctx.store.drop(stmt.datasource)
            clear_rollups(ctx, stmt.datasource)
            # the drop bumps the datasource version (stale keys can never
            # hit again), but the entries themselves must not linger
            ctx.engine.result_cache.clear()
        else:
            clear_rollups(ctx)
            ctx.engine.clear_caches()  # includes the semantic result cache
        if stmt.purge and ctx.persist is not None:
            # PURGE extends the clear to deep storage — without it the
            # snapshots survive and recovery resurrects the datasources
            ctx.persist.purge(stmt.datasource)
        return QueryResult(["status"], {"status": np.array(["OK"],
                                                           dtype=object)})
    if isinstance(stmt, (A.Checkpoint, A.Restore)):
        return _run_persist_command(ctx, stmt)
    if isinstance(stmt, (A.CreateRollup, A.DropRollup, A.RefreshRollup)):
        from spark_druid_olap_tpu_torch.mv.registry import handle_statement
        msg = handle_statement(ctx, stmt)
        return QueryResult(["status"], {"status": np.array([msg],
                                                           dtype=object)})
    if isinstance(stmt, A.ExecuteRawQuery):
        from spark_druid_olap_tpu_torch.ir.serde import query_from_json
        q = query_from_json(stmt.query_json, default_ds=stmt.datasource)
        r = ctx.engine.execute(q)
        ctx.history.record(q, dict(ctx.engine.last_stats), sql=sql)
        return r
    if isinstance(stmt, A.ExplainRewrite):
        text = explain_text(ctx, stmt.query, stmt.sql)
        return QueryResult(["plan"],
                           {"plan": np.array(text.split("\n"), dtype=object)})
    return _run_select(ctx, stmt, sql)


def _run_persist_command(ctx, stmt) -> QueryResult:
    """``CHECKPOINT [ds]`` / ``RESTORE [ds]`` (persist/manager.py)."""
    if ctx.persist is None:
        raise RuntimeError(
            "persistence is disabled; set sdot.persist.path")
    if isinstance(stmt, A.Checkpoint):
        summaries = ctx.checkpoint(stmt.datasource)
        msgs = [f"checkpointed {s['datasource']} v{s['version']} "
                f"({s['rows']} rows, {s['bytes']} bytes)"
                for s in summaries] or ["nothing to checkpoint"]
        return QueryResult(["status"],
                           {"status": np.array(msgs, dtype=object)})
    report = ctx.persist.restore(stmt.datasource)
    # the restore rewinds ingest-version counters; cached results keyed
    # on the pre-restore versions could collide with post-restore keys,
    # so every derived cache drops
    ctx.engine.clear_caches()
    msgs = [f"restored {d['datasource']} from {d['source']}"
            for d in report["datasources"]] or ["nothing restored"]
    return QueryResult(["status"],
                       {"status": np.array(msgs, dtype=object)})


# spec types the shared-scan tier coalesces (parallel/sharedscan.py)
_COALESCIBLE = (S.GroupByQuerySpec, S.TimeseriesQuerySpec, S.TopNQuerySpec)


def explain_sql(ctx, sql: str) -> str:
    stmt = parse_statement(sql)
    if isinstance(stmt, A.ExplainRewrite):
        return explain_text(ctx, stmt.query, stmt.sql)
    if isinstance(stmt, (A.SelectStmt, A.UnionAll)):
        return explain_text(ctx, stmt, sql)
    return f"command: {type(stmt).__name__}"


def explain_text(ctx, stmt: A.SelectStmt, sql: str) -> str:
    """≈ ``ExplainDruidRewrite`` (reference DruidMetadataCommands.scala:49-78)
    — shows whether the query pushes down, the engine query specs, and the
    cost-model decision."""
    if isinstance(stmt, A.UnionAll):
        lines = [f"SQL: {sql.strip()}",
                 f"UNION ALL over {len(stmt.parts)} branches (each plans "
                 f"independently):"]
        for i, p in enumerate(stmt.parts):
            sub = explain_text(ctx, p, f"<branch {i}>")
            lines.append("  " + sub.replace("\n", "\n  "))
        return "\n".join(lines)
    lines = [f"SQL: {sql.strip()}"]
    from spark_druid_olap_tpu_torch.planner.scoping import (resolve_alias_scopes,
                                                      resolve_databases)
    stmt = resolve_databases(ctx, stmt)
    stmt = resolve_alias_scopes(ctx, stmt)
    stmt = resolve_lookups(ctx, stmt)
    try:
        from spark_druid_olap_tpu_torch.planner.decorrelate import (
            decorrelate_semijoins)
        from spark_druid_olap_tpu_torch.planner.viewmerge import merge_derived
        stmt = decorrelate_semijoins(ctx, merge_derived(ctx, stmt))
        pq = B.build(ctx, stmt)
    except PlanUnsupported as e:
        from spark_druid_olap_tpu_torch.planner import composite
        from spark_druid_olap_tpu_torch.planner.decorrelate import (
            stmt_has_subqueries)
        try:
            # execute=False: explain must never dispatch engine queries
            # (the inlining passes RUN subqueries) or pollute the history
            cp = composite.build_composite(ctx, stmt, execute=False)
            lines.append("pushdown: COMPOSITE (engine derived tables + "
                         "host finish)")
            lines.append(composite.describe(cp, "  "))
            return "\n".join(lines)
        except Exception:  # noqa: BLE001 — explain must never fail
            pass
        if stmt_has_subqueries(stmt):
            lines.append(
                "pushdown: DEFERRED — subqueries inline at execution "
                "(inner queries run through the engine; correlated "
                "shapes become KeyedLookup broadcast joins / per-key "
                "min-max EXISTS, planner/decorrelate.py); remaining "
                "shapes run on the host tier")
            return "\n".join(lines)
        lines.append(f"pushdown: NO ({e})")
        lines.append("execution: host (pandas fallback)")
        return "\n".join(lines)
    lines.append(f"pushdown: YES -> datasource {pq.datasource!r}, "
                 f"{len(pq.specs)} engine quer"
                 f"{'y' if len(pq.specs) == 1 else 'ies'}")
    if pq.rollup is not None:
        lines.append(f"rollup rewrite: {pq.rollup} -> scans "
                     f"{pq.specs[0].datasource!r} instead of the base "
                     f"datasource")
    from spark_druid_olap_tpu_torch.parallel.cost import explain_cost
    for i, q in enumerate(pq.specs):
        lines.append(f"  [{i}] {type(q).__name__}: dims="
                     f"{[d.output_name for d in S.query_dimensions(q)]} "
                     f"aggs={[a.name for a in S.query_aggregations(q)]} "
                     f"intervals={q.intervals}")
        lines.append("      "
                     + explain_cost(ctx, q).replace("\n", "\n      "))
    if pq.distinct_phase2:
        lines.append(f"  phase2: exact count-distinct over "
                     f"{pq.distinct_phase2.group_cols}")
    from spark_druid_olap_tpu_torch.utils.config import (SHAREDSCAN_ENABLED,
                                                   WLM_BATCH_WINDOW_MS)
    if ctx.config.get(SHAREDSCAN_ENABLED):
        n_elig = sum(1 for q in pq.specs if isinstance(q, _COALESCIBLE))
        lines.append(
            f"sharedscan: ON — {n_elig}/{len(pq.specs)} spec(s) eligible "
            f"to coalesce with concurrent queries on the same datasource "
            f"(hold window {ctx.config.get(WLM_BATCH_WINDOW_MS)}ms)")
    return "\n".join(lines)


def _run_select(ctx, stmt: A.SelectStmt, sql: str) -> QueryResult:
    from spark_druid_olap_tpu_torch.utils.config import TZ_ID
    from spark_druid_olap_tpu_torch.utils import host_eval as _he
    _tz_tok = _he.SESSION_TZ.set(ctx.config.get(TZ_ID))
    try:
        return _run_select_tz(ctx, stmt, sql)
    finally:
        _he.SESSION_TZ.reset(_tz_tok)


def _transform_tracer(ctx):
    """Per-statement rewrite tracing gated by ``sdot.debug.transformations``
    (≈ the reference's DruidTransforms debug tracing,
    ``DruidTransforms.scala:121-136``): logs each rewrite stage that
    CHANGED the statement, with O(1)-repr lookup tables."""
    from spark_druid_olap_tpu_torch.utils.config import DEBUG_TRANSFORMATIONS
    if not ctx.config.get(DEBUG_TRANSFORMATIONS):
        return lambda name, before, after: after

    import reprlib
    import sys as _sys
    rl = reprlib.Repr()
    rl.maxstring = rl.maxother = 2000
    rl.maxtuple = rl.maxlist = rl.maxdict = 40

    def trace(name, before, after):
        if after is not before:
            print(f"[sdot.rewrite] {name}: {rl.repr(after)}",
                  file=_sys.stderr)
        return after

    return trace


def _run_select_tz(ctx, stmt, sql: str) -> QueryResult:
    if isinstance(stmt, A.UnionAll):
        return _run_union(ctx, stmt, sql)
    from spark_druid_olap_tpu_torch.utils.config import (PHASES_ENABLED,
                                                   PLAN_MEMO_ENABLED,
                                                   PLAN_MEMO_ENTRIES)
    # nested entries (union branches, window base statements) get None
    # back and merge their phases into the outer statement's accumulator
    ph_tok = PH.begin(bool(ctx.config.get(PHASES_ENABLED)))
    try:
        memo = None
        memo_hit = None
        if ctx.config.get(PLAN_MEMO_ENABLED):
            with PH.phase("plan.memo"):
                _mcache, _mkey = host_exec.result_cache(ctx, "stmtmemo",
                                                        stmt)
                _mkey = _mkey + (_lookups_fp(ctx),)
                memo = _mcache.get(_mkey)
                memo_hit = memo is not None
                if memo_hit:
                    _mcache.move_to_end(_mkey)
                else:
                    memo = _StmtMemo()
                    _memo_put(_mcache, _mkey, memo,
                              int(ctx.config.get(PLAN_MEMO_ENTRIES)))
        if memo is not None and memo.window is not _UNSET:
            wp = memo.window
        else:
            with PH.phase("plan.window"):
                wp = _maybe_windows(ctx, stmt)
            if memo is not None:
                # WindowUnsupported propagates UNCACHED (slot stays
                # _UNSET): only deterministic outcomes memoize
                memo.window = wp
        if wp is not None:
            return _run_windowed(ctx, wp, sql, ph_tok)
        return _run_select_planned(ctx, stmt, sql, ph_tok, memo, memo_hit)
    finally:
        PH.end(ph_tok)   # idempotent: normally closed at stats assembly


def _run_select_planned(ctx, stmt, sql: str, ph_tok, memo,
                        memo_hit) -> QueryResult:
    t0 = _time.perf_counter()
    offset = stmt.offset
    if offset:
        # strip the offset before planning: the engine/host paths see an
        # extended LIMIT, the slice happens once here
        import dataclasses as _dc
        stmt = _dc.replace(stmt, offset=0,
                           limit=None if stmt.limit is None
                           else stmt.limit + offset)
    if memo is not None and memo.resolved is not _UNSET:
        stmt = memo.resolved
    else:
        with PH.phase("plan.resolve"):
            from spark_druid_olap_tpu_torch.planner.scoping import (
                resolve_alias_scopes, resolve_databases)
            stmt = resolve_databases(ctx, stmt)
            stmt = resolve_alias_scopes(ctx, stmt)
            stmt = resolve_lookups(ctx, stmt)
        if memo is not None:
            memo.resolved = stmt
    trace = _transform_tracer(ctx)
    rollup_status = None  # engine path only: 'rollup:<name>' | 'base'
    try:
        from spark_druid_olap_tpu_torch.planner.decorrelate import (
            decorrelate_semijoins, inline_correlated_scalars,
            inline_subqueries)
        from spark_druid_olap_tpu_torch.planner.viewmerge import merge_derived
        # statement plan cache: the rewrite passes (subquery-inlining
        # AST transforms) and the pushdown build cost ~100-200ms of
        # host CPU per statement on deep trees (TPC-H q21-class); the
        # result is deterministic given (store version, config), both
        # folded into the key by result_cache. Inlined subquery RESULTS
        # embedded in the plan stay valid under the same key.
        from spark_druid_olap_tpu_torch.utils.config import PLAN_CACHE_ENABLED
        plan_cached = False
        _pc_on = ctx.config.get(PLAN_CACHE_ENABLED)
        if memo is not None and memo.pq is not _UNSET:
            pq = memo.pq
            # the memo subsumes the plan cache (same key discipline:
            # store version + config fingerprint), so a memo-served
            # plan reports as a statement-cache hit when the plan
            # cache is on — stats["plan_cached"] keeps its contract
            plan_cached = bool(_pc_on)
            if isinstance(pq, _NegativePlan):
                raise PlanUnsupported(pq.reason)
        else:
            _pcache, _pkey = host_exec.result_cache(ctx, "plan", stmt)
            pq = _pcache.get(_pkey) if _pc_on else None
            plan_cached = pq is not None
            if plan_cached:
                _pcache.move_to_end(_pkey)
                if memo is not None:
                    memo.pq = pq
                if isinstance(pq, _NegativePlan):
                    # negative entry: the builder deterministically
                    # rejects this statement under the current
                    # store/config — skip straight to the
                    # composite/host tiers
                    raise PlanUnsupported(pq.reason)
            else:
                with PH.phase("plan.rewrite"):
                    stmt2 = trace("merge_derived", stmt,
                                  merge_derived(ctx, stmt))
                    stmt2 = trace("decorrelate_semijoins", stmt2,
                                  decorrelate_semijoins(ctx, stmt2))
                    stmt2 = trace("inline_correlated_scalars", stmt2,
                                  inline_correlated_scalars(ctx, stmt2))
                    stmt2 = trace("inline_subqueries", stmt2,
                                  inline_subqueries(ctx, stmt2))
                try:
                    with PH.phase("plan.build"):
                        pq = B.build(ctx, stmt2)
                except PlanUnsupported as pe:
                    neg = _NegativePlan(str(pe))
                    if _pc_on:
                        host_exec.result_cache_put(_pcache, _pkey, neg)
                    if memo is not None:
                        memo.pq = neg
                    raise
                if _pc_on:
                    host_exec.result_cache_put(_pcache, _pkey, pq)
                if memo is not None:
                    memo.pq = pq
        df = execute_planned(ctx, pq)
        mode = "engine"
        rollup_status = f"rollup:{pq.rollup}" if pq.rollup else "base"
    except (PlanUnsupported, EngineFallback) as e:
        df = mode = None
        if isinstance(e, PlanUnsupported):
            # general two-table joins (fact-to-fact, self-join funnel,
            # non-equi residual) on the device join tiers. Tried BEFORE
            # the composite planner: recognition is conservative (two
            # stored relations, >=1 equi key, plain aggregate shape),
            # and everything it accepts runs the probe inside the
            # device wave loop — strictly better than the composite
            # tier's gather-and-host-join finish for the same shape.
            # Any decline falls through unchanged.
            from spark_druid_olap_tpu_torch.planner import joinplan
            from spark_druid_olap_tpu_torch.utils.config import JOIN_ENABLED
            try:
                if memo is not None and memo.join is not _UNSET:
                    jp = memo.join
                else:
                    # recognition only (pure) — cost arbitration and the
                    # JOIN_ENABLED kill switch stay live in try_execute;
                    # JOIN_ENABLED is semantic (in the fingerprint), so
                    # a memoized decline can't outlive a flip
                    with PH.phase("plan.join"):
                        jp = (joinplan.try_plan(ctx, stmt)
                              if bool(ctx.config.get(JOIN_ENABLED))
                              else None)
                    if memo is not None:
                        memo.join = jp
                df = joinplan.try_execute(ctx, stmt, plan=jp)
            except joinplan.JoinUnsupported:
                df = None
            if df is not None:
                mode = "engine"
                rollup_status = "base"
        if df is None and isinstance(e, PlanUnsupported):
            # engine-planned derived tables + dim-scale host finish (the
            # reference's DruidQuery-scans-under-Spark-join shape)
            from spark_druid_olap_tpu_torch.planner import composite
            try:
                # build from the PRE-inline statement: the inlining
                # passes execute subqueries away, and the composite
                # planner needs to SEE them (its dim-only-FROM gate) and
                # plan derived tables through its own chain. Same plan
                # cache contract as the pushdown path (store version +
                # config fingerprint in the key).
                from spark_druid_olap_tpu_torch.utils.config import (
                    PLAN_CACHE_ENABLED)
                if memo is not None and memo.composite is not _UNSET:
                    cp = memo.composite
                    if cp is None:   # memoized deterministic rejection
                        raise PlanUnsupported("composite rejected (memo)")
                else:
                    _cc_on = ctx.config.get(PLAN_CACHE_ENABLED)
                    _ccache, _ckey = host_exec.result_cache(ctx, "cplan",
                                                            stmt)
                    cp = _ccache.get(_ckey) if _cc_on else None
                    if cp is not None:
                        _ccache.move_to_end(_ckey)
                    else:
                        try:
                            with PH.phase("plan.composite"):
                                cp = composite.build_composite(ctx, stmt)
                        except PlanUnsupported:
                            # deterministic rejection memoizes; runtime
                            # EngineFallback/HostExecError do NOT
                            if memo is not None:
                                memo.composite = None
                            raise
                        if _cc_on:
                            host_exec.result_cache_put(_ccache, _ckey, cp)
                    if memo is not None:
                        memo.composite = cp
                df = composite.execute_composite(ctx, cp)
                mode = "engine"
                rollup_status = "base"
            except (PlanUnsupported, EngineFallback,
                    host_exec.HostExecError):
                df = None
        if df is None:
            df = host_exec.execute_select(ctx, stmt)
            mode = f"host ({e})"
    if offset:
        df = df.iloc[offset:].reset_index(drop=True)
    stats = dict(ctx.engine.last_stats)
    stats["mode"] = mode
    if rollup_status is not None:
        stats["rollup"] = rollup_status
    stats["total_ms"] = (_time.perf_counter() - t0) * 1000
    if stats.get("cache") not in (None, "miss"):
        # a semantic result-cache hit: the engine dispatched nothing
        stats["served_from"] = "result_cache"
    if plan_cached:
        stats["plan_cached"] = True
    if memo_hit is not None:
        stats["plan_memo"] = {"hit": bool(memo_hit)}
    phases = PH.end(ph_tok)
    if phases is not None:
        stats["phases"] = {k: round(v, 3) for k, v in phases.items()}
    ctx.history.record(stmt, stats, sql=sql)
    res = QueryResult(list(df.columns),
                      {c: df[c].to_numpy() for c in df.columns})
    # partial-results mode: the degraded annotation survives the
    # DataFrame round trip (callers check r.degraded; degraded answers
    # are never cached, enforced engine-side). Host-mode statements
    # never scattered, so their stats snapshot may carry a STALE
    # cluster entry from the previous engine query — gate on mode.
    res.degraded = (stats.get("cluster") or {}).get("degraded") \
        if mode == "engine" else None
    return res


def _maybe_windows(ctx, stmt):
    """Strip ``OVER (...)`` calls BEFORE any planning (window/plan.py).
    Returns ``(base_stmt, WindowPlan)`` or None. Runs ahead of the plan
    cache on purpose: the base statement is what gets planned and cached,
    so a windowed statement and its base share cache entries."""
    from spark_druid_olap_tpu_torch.window import plan as WPLAN
    return WPLAN.extract(ctx, stmt)


def _run_windowed(ctx, wp, sql: str, ph_tok=None) -> QueryResult:
    """Window post-pass: run the base statement through the normal tiers
    (engine pushdown / composite / host), then compute the window columns
    on the device over the result frame and apply the deferred ORDER BY /
    LIMIT / OFFSET (window/exec.py). The base statement re-enters
    ``_run_select_tz`` with the phase accumulator already open, so its
    phases merge here and this statement's ``stats['phases']`` covers the
    whole pipeline."""
    from spark_druid_olap_tpu_torch.window import exec as WEXEC
    base_stmt, plan = wp
    t0 = _time.perf_counter()
    base = _run_select_tz(ctx, base_stmt, f"{sql} <window base>")
    _tw = _time.perf_counter()
    with PH.phase("epilogue"):
        df = WEXEC.apply(ctx, plan, base.to_pandas())
    stats = dict(ctx.engine.last_stats)
    stats["mode"] = "engine+window"
    stats["window"] = {"n_windows": len(plan.windows),
                       "fns": sorted({w.fn for w in plan.windows}),
                       "window_ms": round(
                           (_time.perf_counter() - _tw) * 1000, 2)}
    stats["total_ms"] = (_time.perf_counter() - t0) * 1000
    phases = PH.end(ph_tok)
    if phases is not None:
        stats["phases"] = {k: round(v, 3) for k, v in phases.items()}
    ctx.history.record(base_stmt, stats, sql=sql)
    res = QueryResult(list(df.columns),
                      {c: df[c].to_numpy() for c in df.columns})
    res.degraded = base.degraded
    return res


def _run_union(ctx, u: A.UnionAll, sql: str) -> QueryResult:
    """UNION ALL: each branch plans independently (engine pushdown per
    branch, like Spark planning each Union child), rows concatenate
    positionally under the first branch's column names, then the trailing
    ORDER BY / OFFSET / LIMIT apply."""
    t0 = _time.perf_counter()
    frames = [
        _run_select_tz(ctx, part, f"{sql} <union branch {i}>").to_pandas()
        for i, part in enumerate(u.parts)]
    df = host_exec.finish_union(frames, u)
    ctx.history.record(u, {"mode": "union",
                           "branches": len(u.parts),
                           "total_ms": (_time.perf_counter() - t0) * 1000},
                       sql=sql)
    return QueryResult(list(df.columns),
                       {c: df[c].to_numpy() for c in df.columns})


def execute_planned(ctx, pq: PlannedQuery) -> pd.DataFrame:
    import dataclasses as _dc
    qid = getattr(host_exec.ctx_tls(ctx), "query_id", None)
    frames: List[pd.DataFrame] = []
    degraded: List[dict] = []
    for q, set_dims in zip(pq.specs, pq.spec_dims):
        if qid is not None and getattr(q.context, "query_id", None) is None:
            qctx = q.context or S.QueryContext()
            q = _dc.replace(q, context=_dc.replace(qctx, query_id=qid))
        r = ctx.engine.execute(q)
        if r.degraded is not None:
            degraded.append(r.degraded)
        df = r.to_pandas()
        if "__count__" in df.columns and "__count__" not in pq.output_columns:
            df = df.drop(columns=["__count__"])
        # null-fill dims missing from this grouping set
        for d in pq.all_dims:
            if d not in df.columns:
                df[d] = None
        frames.append(df)
    df = pd.concat(frames, ignore_index=True) if len(frames) > 1 else frames[0]

    if pq.residual is not None:
        from spark_druid_olap_tpu_torch.utils import host_eval
        env = {c: df[c].to_numpy() for c in df.columns}
        # WHERE-derived conjuncts: Kleene 3VL (UNKNOWN drops the row;
        # plain eval_expr would mis-handle NULL-bearing predicates and
        # can collapse to a scalar)
        mask = np.broadcast_to(
            np.asarray(host_eval.eval_pred3(pq.residual, env), dtype=bool),
            (len(df),))
        df = df[mask].reset_index(drop=True)

    if pq.distinct_phase2 is not None:
        df = _phase2_distinct(df, pq)
        from spark_druid_olap_tpu_torch.utils import host_eval
        env = {c: df[c].to_numpy() for c in df.columns}
        for p in pq.deferred_posts:
            v = np.asarray(host_eval.eval_expr(p.expr, env))
            df[p.name] = np.broadcast_to(v, (len(df),)) if v.ndim == 0 else v
            env[p.name] = df[p.name].to_numpy()

    if pq.order_by and not pq.order_applied_in_spec:
        cols = [c for c, _ in pq.order_by]
        asc = [a for _, a in pq.order_by]
        df = df.sort_values(cols, ascending=asc, kind="mergesort")
    if pq.limit is not None and not pq.order_applied_in_spec:
        df = df.head(pq.limit)

    if pq.select_renames:
        df = df.rename(columns=pq.select_renames)
    missing = [c for c in pq.output_columns if c not in df.columns]
    if missing:
        raise EngineFallback(f"planned outputs missing: {missing}")
    if degraded:
        # engine.execute clears last_stats per spec, so a degraded
        # (partial-results) annotation from an earlier grouping set
        # would be lost — re-merge them where run_sql's stats snapshot
        # (and the final QueryResult) can see them
        merged = degraded[0] if len(degraded) == 1 else {
            "missing_shards": sorted(
                {s for d in degraded for s in d["missing_shards"]}),
            "coverage_rows": min(d["coverage_rows"] for d in degraded),
            "total_rows": max(d["total_rows"] for d in degraded)}
        ctx.engine.last_stats.setdefault("cluster", {})["degraded"] = merged
    return df[pq.output_columns].reset_index(drop=True)


def _phase2_distinct(df: pd.DataFrame, pq: PlannedQuery) -> pd.DataFrame:
    d2 = pq.distinct_phase2
    gcols = d2.group_cols
    # null arg values don't count toward count(distinct)
    nn = df[~df[d2.distinct_dim].isna()]
    if gcols:
        cnt = nn.groupby(gcols, dropna=False, as_index=False).agg(
            **{d2.distinct_out: (d2.distinct_dim, "nunique")})
    else:
        cnt = pd.DataFrame({d2.distinct_out: [nn[d2.distinct_dim].nunique()]})
    aggd = {}
    for col, fn in d2.other_aggs.items():
        aggd[col] = (col, fn)
    if gcols:
        if aggd:
            oth = df.groupby(gcols, dropna=False, as_index=False).agg(**aggd)
            out = oth.merge(cnt, on=gcols, how="left")
        else:
            out = cnt
    else:
        if aggd:
            oth = pd.DataFrame({c: [getattr(df[c], fn)()]
                                for c, (c2, fn) in aggd.items()})
            out = pd.concat([oth, cnt], axis=1)
        else:
            out = cnt
    out[d2.distinct_out] = out[d2.distinct_out].fillna(0).astype(np.int64)
    return out
