"""Rollup eligibility + spec rewrite.

Port counterpart of ``spark_druid_olap_tpu/mv/match.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

Decides whether a planned :class:`GroupByQuerySpec` can be answered from a
materialized rollup datasource and, if so, rewrites it in place of the base
scan. Runs inside the pushdown builder BEFORE spec transforms, so a
rewritten GroupBy still benefits from the timeseries/topN/search lowerings.

Eligibility (≈ Sparkline's rewrite onto the Druid rollup index; derivability
mirrors cache/subsume.py's merge table):

* every grouping dimension is *covered*: its source column is a rollup
  dimension, or is join-key-equivalent to one (``FDGraph.equivalents`` —
  value-equal on the flat datasource, so the rollup column substitutes
  exactly);
* time extractions over the base time column need the rollup's bucket
  granularity to nest inside the extraction grain (a ``day`` rollup can
  serve ``year(t)``; a ``month`` rollup cannot serve ``week``);
* every aggregation is merge-closed derivable from a stored partial:
  count -> longsum of the stored count, sum/min/max re-aggregate with the
  same kind, ``anyvalue`` carries over a covered column; sketches
  (cardinality/theta) are never derivable;
* the filter references only covered columns (never the raw time column —
  time predicates arrive as intervals);
* intervals are empty, or every endpoint is aligned to the rollup's
  bucket granularity.

Exception: when the rollup build PROVED bucketing to be the identity map
(``day`` granularity over a day-resolution time column, the BI-typical
date-keyed index), the rollup's time values equal the base's row-for-row,
so time filters, extractions, and arbitrary interval endpoints all carry
over verbatim.

A stale rollup (base re-ingested since the build) is never considered.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from spark_druid_olap_tpu_torch.cache import subsume as SUB
from spark_druid_olap_tpu_torch.cache.keys import normalize_filter
from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.ops.filters import columns_of_filter

# extraction field -> minimum calendar resolution it needs preserved
_FIELD_GRAIN = {
    "year": "year", "quarter": "quarter", "month": "month", "week": "week",
    "day": "day", "dow": "day", "doy": "day", "hour": "hour",
    "minute": "minute",
}

# agg kinds that re-aggregate losslessly over stored partials of same kind
_REAGG_KINDS = ("longsum", "doublesum", "longmin", "longmax", "doublemin",
                "doublemax")


def agg_key(a: S.AggregationSpec) -> tuple:
    """Identity of an aggregation's INPUT (kind + source), independent of
    its output name — a query's hidden avg-sum matches a declared sum."""
    return (a.kind, a.field,
            None if a.expr is None else E.to_sql(a.expr),
            repr(normalize_filter(a.filter)))


def _gran_covers(rollup_gran: str, field: str) -> bool:
    """True if re-deriving ``field`` from rollup buckets of ``rollup_gran``
    is exact: the bucket grain nests inside the field's grain."""
    need = _FIELD_GRAIN.get(field)
    if need is None and field.startswith("trunc_"):
        need = field[len("trunc_"):]
    if need is None:
        return False
    return rollup_gran == need or rollup_gran in SUB._SOURCES.get(need, ())


def is_fresh(ctx, r) -> bool:
    """Backing datasource registered AND built from the base's current
    ingest version (any re-ingest/drop of the base bumps it)."""
    try:
        ctx.store.get(r.backing)
    except KeyError:
        return False
    return r.built_version == ctx.store.datasource_version(r.base)


def try_rewrite(ctx, q) -> Tuple[Optional[S.GroupByQuerySpec], Optional[str]]:
    """Return (rewritten spec, rollup name), or (None, None)."""
    rollups = getattr(ctx, "rollups", None)
    if not rollups or getattr(ctx, "_mv_building", False):
        return None, None
    from spark_druid_olap_tpu_torch.utils.config import MV_REWRITE_ENABLED
    if not ctx.config.get(MV_REWRITE_ENABLED):
        return None, None
    if not isinstance(q, S.GroupByQuerySpec):
        return None, None

    def backing_rows(r):
        try:
            return ctx.store.get(r.backing).num_rows
        except KeyError:
            return 0

    # smallest fresh candidate first: fewest rows scanned wins
    candidates = sorted(
        (r for r in rollups.values()
         if r.base == q.datasource and is_fresh(ctx, r)),
        key=lambda r: (backing_rows(r), r.name))
    for r in candidates:
        rq = _rewrite_one(ctx, q, r)
        if rq is not None:
            return rq, r.name
    return None, None


def _rewrite_one(ctx, q: S.GroupByQuerySpec, r):
    gran = getattr(q, "granularity", None)
    if gran is not None and not gran.is_all():
        return None  # SQL-planned GroupBys carry grain via extractions

    try:
        base_tcol = ctx.store.get(r.base).time_column
    except KeyError:
        return None
    covered = set(r.dims)
    fd = None
    try:
        fd = ctx.catalog.fd_graph_for(r.base, ctx.store)
    except Exception:  # noqa: BLE001 — no star schema is not an error
        fd = None

    # identity-bucketed time (day over day-resolution data): the rollup's
    # time values EQUAL the base's, so the time column behaves like any
    # covered dimension — filters, extractions, intervals carry verbatim
    tid = getattr(r, "time_identity", False)

    def cov(col: str) -> Optional[str]:
        """Rollup column holding values equal to ``col``, or None."""
        if col == base_tcol:
            return col if tid else None  # bucketed, raw only under identity
        if col in covered:
            return col
        if fd is not None:
            for e in fd.equivalents(col):
                if e in covered:
                    return e
        return None

    def rename_expr(ex):
        """Rewrite an expression onto covered columns; None if impossible."""
        mapping = {}
        for c in E.columns_in(ex):
            cc = cov(c)
            if cc is None:
                return None
            mapping[c] = cc

        def rep(n):
            if isinstance(n, E.Column) and n.name in mapping:
                return E.Column(mapping[n.name])
            return n
        return E.transform(ex, rep)

    # -- dimensions -----------------------------------------------------------
    new_dims = []
    for d in q.dimensions:
        ext = d.extraction
        if ext is None:
            c = cov(d.dimension)
            if c is None:
                return None
            new_dims.append(dataclasses.replace(d, dimension=c))
        elif isinstance(ext, S.TimeExtraction):
            if d.dimension == base_tcol:
                # served from the bucketed time column, which keeps the
                # base column's name — carries over verbatim when exact
                if not tid and (r.granularity is None
                                or not _gran_covers(r.granularity,
                                                    ext.field)):
                    return None
                new_dims.append(d)
            else:
                c = cov(d.dimension)  # date-typed dim, stored raw
                if c is None:
                    return None
                new_dims.append(dataclasses.replace(d, dimension=c))
        elif isinstance(ext, S.ExprExtraction):
            ex2 = rename_expr(ext.expr)
            if ex2 is None:
                return None
            src = cov(d.dimension)
            if src is None:
                return None
            new_dims.append(dataclasses.replace(
                d, dimension=src,
                extraction=dataclasses.replace(ext, expr=ex2)))
        elif isinstance(ext, (S.LookupExtraction, S.RegexExtraction)):
            c = cov(d.dimension)
            if c is None:
                return None
            new_dims.append(dataclasses.replace(d, dimension=c))
        else:
            return None

    # -- filter ---------------------------------------------------------------
    new_filter, ok = _rewrite_filter(q.filter, cov, rename_expr)
    if not ok:
        return None

    # -- aggregations ---------------------------------------------------------
    new_aggs = []
    for a in q.aggregations:
        if a.kind == "anyvalue":
            c = cov(a.field)
            if c is None:
                return None
            new_aggs.append(dataclasses.replace(a, field=c))
            continue
        stored = r.agg_map.get(agg_key(a))
        if stored is None:
            return None
        if a.kind == "count":
            # stored partial counts re-aggregate as a long sum
            new_aggs.append(S.AggregationSpec("longsum", a.name,
                                              field=stored))
        elif a.kind in _REAGG_KINDS:
            new_aggs.append(S.AggregationSpec(a.kind, a.name, field=stored))
        else:
            return None  # sketches are not merge-closed from partials

    # -- intervals ------------------------------------------------------------
    if q.intervals is not None and not tid:
        if r.granularity is None:
            return None
        for lo, hi in q.intervals:
            ends = np.array([int(lo), int(hi)], dtype=np.int64)
            if not np.array_equal(
                    SUB._bucket_start_ms(r.granularity, ends), ends):
                return None  # endpoint splits a bucket

    return dataclasses.replace(
        q, datasource=r.backing, dimensions=tuple(new_dims),
        aggregations=tuple(new_aggs), filter=new_filter)


def _rewrite_filter(f, cov, rename_expr):
    """Rewrite a filter tree onto rollup columns. Returns (filter, ok).

    Exactness: the rollup groups by ALL its dimensions, so every rollup
    row carries the exact dimension values of its source rows — a filter
    over covered columns selects exactly the source rows' groups."""
    if f is None:
        return None, True
    if isinstance(f, S.SpatialFilter):
        return None, False  # spatial axes are per-row, lost in rollup
    if isinstance(f, S.LogicalFilter):
        kids = []
        for c in f.fields:
            nc, ok = _rewrite_filter(c, cov, rename_expr)
            if not ok:
                return None, False
            kids.append(nc)
        return dataclasses.replace(f, fields=tuple(kids)), True
    if isinstance(f, S.ExprFilter):
        ex2 = rename_expr(f.expr)
        if ex2 is None:
            return None, False
        return dataclasses.replace(f, expr=ex2), True
    cols = columns_of_filter(f)
    if len(cols) != 1:
        return None, False
    c = cov(next(iter(cols)))
    if c is None:
        return None, False
    return dataclasses.replace(f, dimension=c), True
