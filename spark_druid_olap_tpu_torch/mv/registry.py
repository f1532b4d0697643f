"""Rollup lifecycle: CREATE / DROP / REFRESH + metadata views.

Port counterpart of ``spark_druid_olap_tpu/mv/registry.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.
The JSON form of a definition (``rollup_to_dict`` / ``rollup_from_dict``)
is persistence's catalog entry (``persist/manager.py``).

A rollup is built by running a GroupBy over the base datasource through the
normal planner/engine path (host fallback included) and re-ingesting the
result as a first-class segment-backed datasource named
``__rollup_<name>`` — Druid's rollup-at-ingest, built from the engine's own
aggregation semantics so stored partials are definitionally consistent with
what the planner would compute from base segments.

Staleness contract: the definition records the base's ingest version at
build time (:meth:`SegmentStore.datasource_version`); any later re-ingest /
stream append / drop of the base bumps that version and the rollup is
bypassed by the matcher until ``REFRESH ROLLUP`` rebuilds it. Stale results
are never served.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd

from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.sql import ast as A

BACKING_PREFIX = "__rollup_"

# merge-closed declarable aggregate functions (avg derives at query time
# from sum+count; sketches are not losslessly re-aggregable)
_ALLOWED_FNS = ("sum", "min", "max", "count")

_ALLOWED_GRAINS = ("year", "quarter", "month", "week", "day")


@dataclasses.dataclass
class RollupDef:
    name: str
    base: str
    backing: str
    dims: Tuple[str, ...]
    agg_exprs: Tuple[E.Expr, ...]
    granularity: Optional[str]
    time_column: Optional[str]          # base time column (bucketed) or None
    built_version: int = -1
    # True when bucketing was proven to be the IDENTITY map at build time
    # (day granularity over a day-resolution time column): rollup time
    # values equal base values row-for-row, so the matcher may carry time
    # filters/intervals/extractions over verbatim
    time_identity: bool = False
    # agg input identity (mv.match.agg_key) -> stored partial column
    agg_map: Dict[tuple, str] = dataclasses.field(default_factory=dict)


def _validate(ctx, stmt: A.CreateRollup):
    try:
        ds = ctx.store.get(stmt.base)
    except KeyError:
        raise ValueError(f"unknown datasource {stmt.base!r}") from None
    cols = set(ds.column_names())
    for d in stmt.dimensions:
        if d not in cols:
            raise ValueError(f"rollup dimension {d!r} is not a column of "
                             f"{stmt.base!r}")
        if d == ds.time_column:
            raise ValueError(
                f"the time column {d!r} cannot be a rollup dimension; use "
                f"GRANULARITY to keep a bucketed time axis")
    for e in stmt.aggregations:
        if not isinstance(e, E.AggCall) or e.distinct or e.approx \
                or e.fn not in _ALLOWED_FNS:
            raise ValueError(
                f"rollup aggregation {E.to_sql(e)} is not merge-closed; "
                f"allowed: {', '.join(_ALLOWED_FNS)} (avg derives from "
                f"sum+count at query time)")
    if stmt.granularity is not None:
        if stmt.granularity not in _ALLOWED_GRAINS:
            raise ValueError(f"granularity {stmt.granularity!r} not in "
                             f"{_ALLOWED_GRAINS}")
        if ds.time_column is None:
            raise ValueError(
                f"GRANULARITY requires a time column on {stmt.base!r}")


def _coerce_numeric_objects(df: pd.DataFrame) -> pd.DataFrame:
    """Engine results can carry wide-int columns as object arrays of
    Python ints; re-ingest needs real numeric dtypes (an object column
    would dictionary-encode as a string dimension)."""
    for c in df.columns:
        if df[c].dtype == object:
            vals = df[c].tolist()
            if vals and all(isinstance(v, (int, float))
                            and not isinstance(v, bool) for v in vals):
                df[c] = pd.to_numeric(df[c])
    return df


def _build_backing(ctx, r: RollupDef) -> None:
    """(Re)build the backing datasource + agg identity map for ``r``."""
    from spark_druid_olap_tpu_torch.mv.match import agg_key
    from spark_druid_olap_tpu_torch.parallel.executor import EngineFallback
    from spark_druid_olap_tpu_torch.planner import builder as B
    from spark_druid_olap_tpu_torch.planner import host_exec
    from spark_druid_olap_tpu_torch.utils import host_eval as _he
    from spark_druid_olap_tpu_torch.utils.config import TZ_ID

    items = [A.SelectItem(E.Column(d), alias=d) for d in r.dims]
    group = [E.Column(d) for d in r.dims]
    if r.granularity is not None:
        bucket = E.Func("date_trunc", (E.Literal(r.granularity),
                                       E.Column(r.time_column)))
        items.append(A.SelectItem(bucket, alias=r.time_column))
        group.append(bucket)
    for i, e in enumerate(r.agg_exprs):
        items.append(A.SelectItem(e, alias=f"agg_{i}"))
    stmt = A.SelectStmt(items=tuple(items),
                        relation=A.TableRef(r.base),
                        group_by=tuple(group) or None)

    built_version = ctx.store.datasource_version(r.base)
    base_ds = ctx.store.get(r.base)
    # identity proof must hold for EVERY row; a partial store only sees
    # its host's rows, and a per-host divergent rewrite decision would
    # diverge program shapes across the mesh
    r.time_identity = bool(
        r.granularity == "day" and base_ds.time is not None
        and not base_ds.is_partial
        and not base_ds.time.ms_in_day.any())
    ctx._mv_building = True
    tz_tok = _he.SESSION_TZ.set(ctx.config.get(TZ_ID))
    try:
        from spark_druid_olap_tpu_torch.planner.plans import PlanUnsupported
        from spark_druid_olap_tpu_torch.sql.session import execute_planned
        try:
            pq = B.build(ctx, stmt)
        except PlanUnsupported as e:
            raise ValueError(
                f"rollup {r.name!r} definition is not engine-plannable: "
                f"{e}") from e
        try:
            df = execute_planned(ctx, pq)
        except EngineFallback:
            df = host_exec.execute_select(ctx, stmt)
    finally:
        _he.SESSION_TZ.reset(tz_tok)
        ctx._mv_building = False

    df = _coerce_numeric_objects(df.copy())
    kwargs = {}
    if r.granularity is not None:
        if not np.issubdtype(df[r.time_column].to_numpy().dtype,
                             np.datetime64):
            df[r.time_column] = pd.to_datetime(df[r.time_column])
        kwargs["time_column"] = r.time_column
    ctx.ingest_dataframe(r.backing, df, **kwargs)

    # authoritative agg identity: the specs the builder actually planned.
    # Only output partials count — hidden helper aggs (e.g. the count
    # behind a sum-of-literal post-agg) have no stored column.
    out_cols = set(df.columns)
    from spark_druid_olap_tpu_torch.ir import spec as S
    agg_map: Dict[tuple, str] = {}
    for a in S.query_aggregations(pq.specs[0]):
        if a.kind != "anyvalue" and a.name in out_cols:
            agg_map.setdefault(agg_key(a), a.name)
    r.agg_map = agg_map
    r.built_version = built_version


def create_rollup(ctx, stmt: A.CreateRollup) -> RollupDef:
    if stmt.name in ctx.rollups:
        raise ValueError(f"rollup {stmt.name!r} already exists "
                         f"(DROP ROLLUP first, or REFRESH)")
    _validate(ctx, stmt)
    ds = ctx.store.get(stmt.base)
    r = RollupDef(
        name=stmt.name, base=stmt.base,
        backing=BACKING_PREFIX + stmt.name,
        dims=tuple(stmt.dimensions), agg_exprs=tuple(stmt.aggregations),
        granularity=stmt.granularity,
        time_column=ds.time_column if stmt.granularity is not None else None)
    _build_backing(ctx, r)
    ctx.rollups[stmt.name] = r
    return r


def drop_rollup(ctx, name: str) -> None:
    r = ctx.rollups.pop(name, None)
    if r is None:
        raise ValueError(f"unknown rollup {name!r}")
    try:
        ctx.store.drop(r.backing)
    except KeyError:
        pass


def refresh_rollup(ctx, name: str) -> RollupDef:
    r = ctx.rollups.get(name)
    if r is None:
        raise ValueError(f"unknown rollup {name!r}")
    _build_backing(ctx, r)
    return r


def handle_statement(ctx, stmt) -> str:
    """Session dispatch for the rollup DDL statements."""
    if isinstance(stmt, A.CreateRollup):
        r = create_rollup(ctx, stmt)
        rows = ctx.store.get(r.backing).num_rows
        return f"rollup {r.name} created ({rows} rows)"
    if isinstance(stmt, A.DropRollup):
        drop_rollup(ctx, stmt.name)
        return f"rollup {stmt.name} dropped"
    if isinstance(stmt, A.RefreshRollup):
        r = refresh_rollup(ctx, stmt.name)
        rows = ctx.store.get(r.backing).num_rows
        return f"rollup {r.name} refreshed ({rows} rows)"
    raise TypeError(f"not a rollup statement: {type(stmt).__name__}")


def clear_rollups(ctx, datasource: Optional[str] = None) -> None:
    """CLEAR METADATA interaction: a full clear forgets every rollup (their
    backing datasources died with the store); a per-datasource clear drops
    rollups built ON that datasource (their base version bump would bypass
    them forever) and any rollup addressed by name."""
    if not getattr(ctx, "rollups", None):
        return
    if datasource is None:
        ctx.rollups.clear()
        return
    for name in [n for n, r in ctx.rollups.items()
                 if r.base == datasource or n == datasource]:
        try:
            drop_rollup(ctx, name)
        except ValueError:
            pass


def rollup_to_dict(r: RollupDef) -> dict:
    """JSON form of a rollup definition for persist/'s catalog.json.
    ``built_version`` rides along so post-recovery staleness checks
    compare against the RESTORED base ingest version — a rollup stale at
    crash time is still stale (and bypassed) after recovery."""
    from spark_druid_olap_tpu_torch.ir.serde import expr_to_dict
    return {
        "name": r.name, "base": r.base, "backing": r.backing,
        "dims": list(r.dims),
        "aggs": [expr_to_dict(e) for e in r.agg_exprs],
        "granularity": r.granularity,
        "timeColumn": r.time_column,
        "builtVersion": int(r.built_version),
        "timeIdentity": bool(r.time_identity),
        # agg_key tuples are (kind, field, sql|None, filter_repr) — all
        # JSON scalars; lists round-trip back to tuples below
        "aggMap": [[list(k), v] for k, v in r.agg_map.items()],
    }


def rollup_from_dict(d: dict) -> RollupDef:
    from spark_druid_olap_tpu_torch.ir.serde import expr_from_dict
    return RollupDef(
        name=d["name"], base=d["base"], backing=d["backing"],
        dims=tuple(d["dims"]),
        agg_exprs=tuple(expr_from_dict(e) for e in d["aggs"]),
        granularity=d.get("granularity"),
        time_column=d.get("timeColumn"),
        built_version=int(d.get("builtVersion", -1)),
        time_identity=bool(d.get("timeIdentity", False)),
        agg_map={tuple(k): v for k, v in d.get("aggMap", ())})


def rollups_view(ctx) -> pd.DataFrame:
    """``sys_rollups`` / ``GET /metadata/rollups`` — one row per rollup."""
    from spark_druid_olap_tpu_torch.mv.match import is_fresh
    rows = []
    for name in sorted(getattr(ctx, "rollups", {}) or {}):
        r = ctx.rollups[name]
        try:
            n_rows = ctx.store.get(r.backing).num_rows
        except KeyError:
            n_rows = 0
        rows.append({
            "name": r.name,
            "base": r.base,
            "datasource": r.backing,
            "dimensions": ",".join(r.dims),
            "aggregations": ",".join(E.to_sql(e) for e in r.agg_exprs),
            "granularity": r.granularity or "all",
            "rows": n_rows,
            "built_version": r.built_version,
            "base_version": ctx.store.datasource_version(r.base),
            "fresh": bool(is_fresh(ctx, r)),
        })
    cols = ["name", "base", "datasource", "dimensions", "aggregations",
            "granularity", "rows", "built_version", "base_version", "fresh"]
    return pd.DataFrame(rows, columns=cols)
