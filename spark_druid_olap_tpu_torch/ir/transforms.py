"""Spec-level rewrite rules over generated QuerySpecs.

Port counterpart of ``spark_druid_olap_tpu/ir/transforms.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

≈ ``QuerySpecTransforms`` (reference ``druid/query/QuerySpecTransforms.scala``):
a rule executor run on the query spec *after* the planner builds it —
GroupBy -> TimeSeries when there are no dimensions, GroupBy -> TopN for a
single-dim ordered-limit aggregate, add a count aggregation when a group-by
has none (so empty groups can be dropped), merge redundant bound filters.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.utils.config import (
    ALLOW_TOPN,
    Config,
    TOPN_THRESHOLD,
)

Rule = Callable[[S.QuerySpec, Config], Optional[S.QuerySpec]]


def groupby_to_timeseries(q: S.QuerySpec, conf: Config):
    """No dimensions -> timeseries (reference :119-142)."""
    if not isinstance(q, S.GroupByQuerySpec):
        return None
    if q.dimensions or q.having is not None or q.limit is not None:
        return None
    return S.TimeseriesQuerySpec(
        datasource=q.datasource, aggregations=q.aggregations,
        post_aggregations=q.post_aggregations, filter=q.filter,
        granularity=q.granularity, intervals=q.intervals, context=q.context)


def groupby_to_topn(q: S.QuerySpec, conf: Config):
    """Single dim + order-by-one-metric-desc + limit -> topN
    (reference :279-332; gated like spark.sparklinedata.druid.allow.topn)."""
    if not isinstance(q, S.GroupByQuerySpec):
        return None
    if not conf.get(ALLOW_TOPN):
        return None
    if (len(q.dimensions) != 1 or q.limit is None or q.limit.limit is None
            or len(q.limit.columns) != 1 or q.having is not None
            or not q.granularity.is_all()):
        return None
    oc = q.limit.columns[0]
    if oc.ascending:
        return None
    agg_names = {a.name for a in q.aggregations} | \
        {p.name for p in q.post_aggregations}
    if oc.name not in agg_names:
        return None
    if q.limit.limit > conf.get(TOPN_THRESHOLD):
        return None
    return S.TopNQuerySpec(
        datasource=q.datasource, dimension=q.dimensions[0], metric=oc.name,
        threshold=q.limit.limit, aggregations=q.aggregations,
        post_aggregations=q.post_aggregations, filter=q.filter,
        granularity=q.granularity, intervals=q.intervals, context=q.context)


def groupby_to_search(q: S.QuerySpec, conf: Config):
    """GroupBy over ONE dim whose only row filter is a contains/like
    pattern on that same dim, counting rows -> dictionary-scan Search query
    (reference :225-277). The search tier scans the (small) dictionary
    instead of planning a dense group-by over the full key space."""
    if not isinstance(q, S.GroupByQuerySpec):
        return None
    if (len(q.dimensions) != 1 or q.having is not None
            or q.limit is not None or q.post_aggregations
            or not q.granularity.is_all()):
        return None
    d = q.dimensions[0]
    if d.extraction is not None:
        return None
    a = q.aggregations[0] if len(q.aggregations) == 1 else None
    if a is None or a.kind != "count" or a.filter is not None \
            or a.field is not None or a.expr is not None:
        # a filtered/field count is NOT the row count the search tier returns
        return None
    f = q.filter
    if not (isinstance(f, S.PatternFilter) and f.dimension == d.dimension
            and f.kind in ("contains", "like")):
        return None
    if f.kind == "like":
        inner = f.pattern
        if not (inner.startswith("%") and inner.endswith("%")
                and len(inner) > 2):
            return None
        inner = inner[1:-1]
        if any(ch in inner for ch in "%_"):
            return None
        needle = inner
    else:
        needle = f.pattern
    return S.SearchQuerySpec(
        datasource=q.datasource, dimensions=(d.dimension,), query=needle,
        case_sensitive=True, filter=None, intervals=q.intervals,
        context=q.context, value_output=d.output_name,
        count_output=q.aggregations[0].name)


def add_count_when_no_aggs(q: S.QuerySpec, conf: Config):
    """GroupBy with zero aggregations (e.g. SELECT DISTINCT dims) gets a
    hidden count (reference :104-117 adds an 'addCountAggregate')."""
    if not isinstance(q, S.GroupByQuerySpec):
        return None
    if q.aggregations:
        return None
    import dataclasses
    return dataclasses.replace(
        q, aggregations=(S.AggregationSpec("count", "__count__"),))


def merge_spatial_bounds(filter_spec, ds):
    """Collapse conjunctive numeric BoundFilters on a spatial dim's axis
    columns into one SpatialFilter (reference: the combine-spatial-filters
    transform, QuerySpecTransforms.scala:180-223, and the spatial rewrite in
    ProjectFilterTransfom.scala:289-319). Enables segment bounding-box
    pruning; open sides become +/-inf. Only rewrites when at least one axis
    is bounded."""
    import math
    if filter_spec is None or not getattr(ds, "spatial", None):
        return filter_spec
    if isinstance(filter_spec, S.LogicalFilter) and filter_spec.op == "and":
        conjs = list(filter_spec.fields)
    else:
        conjs = [filter_spec]
    axis_to_dim = {}
    for sname, axes in ds.spatial.items():
        for ax in axes:
            axis_to_dim[ax] = sname
    # per spatial dim: accumulated [lo, hi] per axis
    boxes = {}
    used = []
    rest = []
    for c in conjs:
        if isinstance(c, S.BoundFilter) and c.dimension in axis_to_dim \
                and not c.lower_strict and not c.upper_strict:
            sname = axis_to_dim[c.dimension]
            box = boxes.setdefault(sname, {})
            try:
                lo = -math.inf if c.lower is None else float(c.lower)
                hi = math.inf if c.upper is None else float(c.upper)
            except (TypeError, ValueError):
                rest.append(c)
                continue
            cur = box.get(c.dimension, (-math.inf, math.inf))
            box[c.dimension] = (max(cur[0], lo), min(cur[1], hi))
            used.append(c)
        else:
            rest.append(c)
    if not boxes:
        return filter_spec
    for sname, box in boxes.items():
        axes = ds.spatial[sname]
        rest.append(S.SpatialFilter(
            dimension=sname, axes=axes,
            min_coords=tuple(box.get(ax, (-math.inf, math.inf))[0]
                             for ax in axes),
            max_coords=tuple(box.get(ax, (-math.inf, math.inf))[1]
                             for ax in axes)))
    if len(rest) == 1:
        return rest[0]
    return S.LogicalFilter("and", tuple(rest))


RULES: List[Rule] = [add_count_when_no_aggs, groupby_to_search,
                     groupby_to_topn,
                     groupby_to_timeseries]


def transform(q: S.QuerySpec, conf: Config,
              extra_rules=()) -> S.QuerySpec:
    """Run rules to fixpoint (bounded) — ≈ TransformExecutor batches.
    ``extra_rules`` come from installed extension modules."""
    rules = RULES + list(extra_rules)
    for _ in range(4):
        changed = False
        for rule in rules:
            r = rule(q, conf)
            if r is not None:
                q = r
                changed = True
        if not changed:
            break
    return q
