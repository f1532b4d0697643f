"""JSON serde for query specs and expressions.

Port counterpart of ``spark_druid_olap_tpu/ir/serde.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package. The
JSON is the same, so a spec written by one package loads in the other.

The IR's wire format — what travels over the serving layer and the ``ON
DATASOURCE ... EXECUTE QUERY '<json>'`` raw-query command (≈ the reference
parsing raw Druid JSON in ``PlanUtil.logicalPlan:49-66``; our JSON dialect
mirrors Druid's query JSON shape where it makes sense: ``queryType``,
``dimensions``, ``aggregations``, ``filter``, ``intervals``)."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ir import spec as S

# -- expressions --------------------------------------------------------------

_EXPR_TYPES = {
    "column": E.Column, "literal": E.Literal, "binary": E.BinaryOp,
    "cmp": E.Comparison, "and": E.And, "or": E.Or, "not": E.Not,
    "isnull": E.IsNull, "in": E.InList, "between": E.Between,
    "like": E.Like, "func": E.Func, "cast": E.Cast, "case": E.Case,
    "agg": E.AggCall, "lookup": E.KeyedLookup,
    "lookup2": E.KeyedLookup2,
}
_EXPR_NAMES = {v: k for k, v in _EXPR_TYPES.items()}


def expr_to_dict(e: Optional[E.Expr]):
    if e is None:
        return None
    t = _EXPR_NAMES.get(type(e))
    if t is None:
        raise ValueError(f"unserializable expr {type(e).__name__}")
    if isinstance(e, E.Column):
        return {"t": t, "name": e.name}
    if isinstance(e, E.Literal):
        v = e.value
        import datetime as _dt
        if isinstance(v, (_dt.date, _dt.datetime)):
            return {"t": t, "value": v.isoformat(), "date": True}
        return {"t": t, "value": v}
    if isinstance(e, E.BinaryOp):
        return {"t": t, "op": e.op, "left": expr_to_dict(e.left),
                "right": expr_to_dict(e.right)}
    if isinstance(e, E.Comparison):
        return {"t": t, "op": e.op, "left": expr_to_dict(e.left),
                "right": expr_to_dict(e.right)}
    if isinstance(e, (E.And, E.Or)):
        return {"t": t, "parts": [expr_to_dict(p) for p in e.parts]}
    if isinstance(e, E.Not):
        return {"t": t, "child": expr_to_dict(e.child)}
    if isinstance(e, E.IsNull):
        return {"t": t, "child": expr_to_dict(e.child), "negated": e.negated}
    if isinstance(e, E.InList):
        return {"t": t, "child": expr_to_dict(e.child),
                "values": list(e.values), "negated": e.negated}
    if isinstance(e, E.Between):
        return {"t": t, "child": expr_to_dict(e.child),
                "low": expr_to_dict(e.low), "high": expr_to_dict(e.high),
                "negated": e.negated}
    if isinstance(e, E.Like):
        return {"t": t, "child": expr_to_dict(e.child),
                "pattern": e.pattern, "negated": e.negated}
    if isinstance(e, E.Func):
        return {"t": t, "name": e.name,
                "args": [expr_to_dict(a) for a in e.args]}
    if isinstance(e, E.Cast):
        return {"t": t, "child": expr_to_dict(e.child), "to": e.to}
    if isinstance(e, E.Case):
        return {"t": t,
                "branches": [[expr_to_dict(c), expr_to_dict(v)]
                             for c, v in e.branches],
                "otherwise": expr_to_dict(e.otherwise)}
    if isinstance(e, E.AggCall):
        return {"t": t, "fn": e.fn, "arg": expr_to_dict(e.arg),
                "distinct": e.distinct, "approx": e.approx}
    if isinstance(e, E.KeyedLookup):
        import numpy as np
        return {"t": t, "key": expr_to_dict(e.key),
                "keys": [int(k) for k in e.table.keys],
                "values": [None if np.isnan(v) else float(v)
                           for v in e.table.values],
                "default": e.default}
    if isinstance(e, E.KeyedLookup2):
        import numpy as np
        return {"t": t, "key1": expr_to_dict(e.key1),
                "key2": expr_to_dict(e.key2),
                "keys1": [int(k) for k in e.table.keys1],
                "keys2": [int(k) for k in e.table.keys2],
                "values": [None if np.isnan(v) else float(v)
                           for v in e.table.values],
                "default": e.default}
    raise AssertionError


def expr_from_dict(d) -> Optional[E.Expr]:
    if d is None:
        return None
    t = d["t"]
    if t == "column":
        return E.Column(d["name"])
    if t == "literal":
        if d.get("date"):
            import datetime as _dt
            s = d["value"]
            return E.Literal(_dt.date.fromisoformat(s[:10]) if len(s) <= 10
                             else _dt.datetime.fromisoformat(s))
        return E.Literal(d["value"])
    if t == "binary":
        return E.BinaryOp(d["op"], expr_from_dict(d["left"]),
                          expr_from_dict(d["right"]))
    if t == "cmp":
        return E.Comparison(d["op"], expr_from_dict(d["left"]),
                            expr_from_dict(d["right"]))
    if t == "and":
        return E.And(tuple(expr_from_dict(p) for p in d["parts"]))
    if t == "or":
        return E.Or(tuple(expr_from_dict(p) for p in d["parts"]))
    if t == "not":
        return E.Not(expr_from_dict(d["child"]))
    if t == "isnull":
        return E.IsNull(expr_from_dict(d["child"]), d.get("negated", False))
    if t == "in":
        return E.InList(expr_from_dict(d["child"]), tuple(d["values"]),
                        d.get("negated", False))
    if t == "between":
        return E.Between(expr_from_dict(d["child"]),
                         expr_from_dict(d["low"]), expr_from_dict(d["high"]),
                         d.get("negated", False))
    if t == "like":
        return E.Like(expr_from_dict(d["child"]), d["pattern"],
                      d.get("negated", False))
    if t == "func":
        return E.Func(d["name"], tuple(expr_from_dict(a) for a in d["args"]))
    if t == "cast":
        return E.Cast(expr_from_dict(d["child"]), d["to"])
    if t == "case":
        return E.Case(tuple((expr_from_dict(c), expr_from_dict(v))
                            for c, v in d["branches"]),
                      expr_from_dict(d.get("otherwise")))
    if t == "agg":
        return E.AggCall(d["fn"], expr_from_dict(d.get("arg")),
                         d.get("distinct", False), d.get("approx", False))
    if t == "lookup":
        import numpy as np
        vals = np.array([np.nan if v is None else v for v in d["values"]],
                        dtype=np.float64)
        return E.KeyedLookup(
            expr_from_dict(d["key"]),
            E.FrozenKeyedTable(np.asarray(d["keys"], dtype=np.int64),
                               vals),
            d.get("default"))
    if t == "lookup2":
        import numpy as np
        vals = np.array([np.nan if v is None else v for v in d["values"]],
                        dtype=np.float64)
        return E.KeyedLookup2(
            expr_from_dict(d["key1"]), expr_from_dict(d["key2"]),
            E.FrozenKeyedTable2(np.asarray(d["keys1"], dtype=np.int64),
                                np.asarray(d["keys2"], dtype=np.int64),
                                vals),
            d.get("default"))
    raise ValueError(f"unknown expr type {t!r}")


# -- filters ------------------------------------------------------------------

def filter_to_dict(f: Optional[S.FilterSpec]):
    if f is None:
        return None
    if isinstance(f, S.SelectorFilter):
        return {"type": "selector", "dimension": f.dimension,
                "value": f.value}
    if isinstance(f, S.BoundFilter):
        return {"type": "bound", "dimension": f.dimension,
                "lower": _jsonable(f.lower), "upper": _jsonable(f.upper),
                "lowerStrict": f.lower_strict, "upperStrict": f.upper_strict,
                "numeric": f.numeric}
    if isinstance(f, S.InFilter):
        if isinstance(f.values, E.FrozenIntSet):
            return {"type": "in", "dimension": f.dimension,
                    "values": f.values.array.tolist(), "intset": True}
        return {"type": "in", "dimension": f.dimension,
                "values": [_jsonable(v) for v in f.values]}
    if isinstance(f, S.PatternFilter):
        return {"type": f.kind, "dimension": f.dimension,
                "pattern": f.pattern}
    if isinstance(f, S.NullFilter):
        return {"type": "null", "dimension": f.dimension,
                "negated": f.negated}
    if isinstance(f, S.LogicalFilter):
        return {"type": f.op,
                "fields": [filter_to_dict(x) for x in f.fields]}
    if isinstance(f, S.ExprFilter):
        return {"type": "expression", "expr": expr_to_dict(f.expr)}
    if isinstance(f, S.SpatialFilter):
        # Druid-shaped (SpatialFilterSpec/RectangularBound) plus our axes
        return {"type": "spatial", "dimension": f.dimension,
                "axes": list(f.axes),
                "bound": {"type": "rectangular",
                          "minCoords": [_jsonable(v) for v in f.min_coords],
                          "maxCoords": [_jsonable(v) for v in f.max_coords]}}
    raise ValueError(type(f).__name__)


def _jsonable(v):
    import datetime as _dt
    import numpy as np
    if isinstance(v, (_dt.date, _dt.datetime)):
        return v.isoformat()
    if isinstance(v, np.generic):
        return v.item()
    return v


def filter_from_dict(d) -> Optional[S.FilterSpec]:
    if d is None:
        return None
    t = d["type"]
    if t == "selector":
        return S.SelectorFilter(d["dimension"], d.get("value"))
    if t == "bound":
        return S.BoundFilter(d["dimension"], d.get("lower"), d.get("upper"),
                             d.get("lowerStrict", False),
                             d.get("upperStrict", False),
                             d.get("numeric", False))
    if t == "in":
        if d.get("intset"):
            return S.InFilter(d["dimension"], E.FrozenIntSet(d["values"]))
        return S.InFilter(d["dimension"], tuple(d["values"]))
    if t in ("like", "regex", "contains"):
        return S.PatternFilter(d["dimension"], t, d["pattern"])
    if t == "null":
        return S.NullFilter(d["dimension"], d.get("negated", False))
    if t in ("and", "or", "not"):
        return S.LogicalFilter(
            t, tuple(filter_from_dict(x) for x in d["fields"]))
    if t == "expression":
        return S.ExprFilter(expr_from_dict(d["expr"]))
    if t == "spatial":
        b = d["bound"]
        return S.SpatialFilter(
            d["dimension"], tuple(d.get("axes", ())),
            tuple(float(v) for v in b["minCoords"]),
            tuple(float(v) for v in b["maxCoords"]))
    raise ValueError(f"unknown filter type {t!r}")


# -- dimensions / aggregations ------------------------------------------------

def dim_to_dict(d: S.DimensionSpec):
    out = {"dimension": d.dimension, "outputName": d.output_name}
    if isinstance(d.extraction, S.TimeExtraction):
        out["extractionFn"] = {"type": "time", "field": d.extraction.field}
    elif isinstance(d.extraction, S.ExprExtraction):
        out["extractionFn"] = {"type": "expression",
                               "expr": expr_to_dict(d.extraction.expr),
                               "cardinality": d.extraction.cardinality}
    elif isinstance(d.extraction, S.LookupExtraction):
        # Druid-shaped map lookup extraction fn
        out["extractionFn"] = {
            "type": "lookup",
            "lookup": {"type": "map", "map": dict(d.extraction.lookup)},
            "retainMissingValue": d.extraction.retain_missing,
            "replaceMissingValueWith": d.extraction.replace_missing_with}
    elif isinstance(d.extraction, S.RegexExtraction):
        out["extractionFn"] = {
            "type": "regex", "expr": d.extraction.pattern,
            "index": d.extraction.index,
            "replaceMissingValue": d.extraction.replace_missing,
            "replaceMissingValueWith": d.extraction.replace_missing_with}
    return out


def dim_from_dict(d) -> S.DimensionSpec:
    ex = None
    fn = d.get("extractionFn")
    if fn is not None:
        if fn["type"] == "time":
            ex = S.TimeExtraction(fn["field"])
        elif fn["type"] == "lookup":
            ex = S.LookupExtraction(
                tuple(sorted(fn["lookup"]["map"].items())),
                fn.get("retainMissingValue", False),
                fn.get("replaceMissingValueWith"))
        elif fn["type"] == "regex":
            ex = S.RegexExtraction(
                fn["expr"], fn.get("index", 1),
                fn.get("replaceMissingValue", False),
                fn.get("replaceMissingValueWith"))
        else:
            ex = S.ExprExtraction(expr_from_dict(fn["expr"]),
                                  fn.get("cardinality"))
    return S.DimensionSpec(d["dimension"], d.get("outputName",
                                                 d["dimension"]), ex)


def agg_to_dict(a: S.AggregationSpec):
    out = {"type": a.kind, "name": a.name}
    if a.field is not None:
        out["fieldName"] = a.field
    if a.expr is not None:
        out["expr"] = expr_to_dict(a.expr)
    if a.filter is not None:
        out["filter"] = filter_to_dict(a.filter)
    if a.fraction is not None:
        out["fraction"] = a.fraction
    return out


def agg_from_dict(d) -> S.AggregationSpec:
    return S.AggregationSpec(d["type"], d["name"], d.get("fieldName"),
                             expr_from_dict(d.get("expr")),
                             filter_from_dict(d.get("filter")),
                             d.get("fraction"))


# -- query specs --------------------------------------------------------------

def query_to_dict(q: S.QuerySpec) -> dict:
    base = {"dataSource": q.datasource,
            "intervals": [list(i) for i in q.intervals]
            if getattr(q, "intervals", None) else None}
    ctxq = getattr(q, "context", None)
    if ctxq is not None and (ctxq.query_id is not None
                             or ctxq.timeout_millis is not None
                             or ctxq.prefer_sharded is not None
                             or ctxq.lane is not None
                             or ctxq.tenant is not None
                             or ctxq.priority is not None):
        # ≈ Druid's query "context" (QuerySpecContext :558-571; lane ≈
        # Druid's context "lane"/"priority" laning keys)
        base["context"] = {"queryId": ctxq.query_id,
                           "timeout": ctxq.timeout_millis,
                           "preferSharded": ctxq.prefer_sharded}
        if ctxq.lane is not None:
            base["context"]["lane"] = ctxq.lane
        if ctxq.tenant is not None:
            base["context"]["tenant"] = ctxq.tenant
        if ctxq.priority is not None:
            base["context"]["priority"] = ctxq.priority
    if isinstance(q, S.GroupByQuerySpec):
        base.update({
            "queryType": "groupBy",
            "dimensions": [dim_to_dict(d) for d in q.dimensions],
            "aggregations": [agg_to_dict(a) for a in q.aggregations],
            "postAggregations": [{"name": p.name,
                                  "expr": expr_to_dict(p.expr)}
                                 for p in q.post_aggregations],
            "filter": filter_to_dict(q.filter),
            "having": expr_to_dict(q.having.expr) if q.having else None,
            "limitSpec": {
                "columns": [{"dimension": c.name, "ascending": c.ascending}
                            for c in q.limit.columns],
                "limit": q.limit.limit} if q.limit else None,
            "granularity": {"type": q.granularity.kind,
                            "duration": q.granularity.duration_millis},
        })
        return base
    if isinstance(q, S.TimeseriesQuerySpec):
        base.update({
            "queryType": "timeseries",
            "aggregations": [agg_to_dict(a) for a in q.aggregations],
            "postAggregations": [{"name": p.name,
                                  "expr": expr_to_dict(p.expr)}
                                 for p in q.post_aggregations],
            "filter": filter_to_dict(q.filter),
            "granularity": {"type": q.granularity.kind,
                            "duration": q.granularity.duration_millis},
        })
        return base
    if isinstance(q, S.TopNQuerySpec):
        base.update({
            "queryType": "topN",
            "dimension": dim_to_dict(q.dimension),
            "metric": q.metric, "threshold": q.threshold,
            "aggregations": [agg_to_dict(a) for a in q.aggregations],
            "postAggregations": [{"name": p.name,
                                  "expr": expr_to_dict(p.expr)}
                                 for p in q.post_aggregations],
            "filter": filter_to_dict(q.filter),
        })
        return base
    if isinstance(q, S.SelectQuerySpec):
        base.update({
            "queryType": "select", "columns": list(q.columns),
            "filter": filter_to_dict(q.filter),
            "pagingSpec": {"pageSize": q.page_size, "offset": q.page_offset},
            "descending": q.descending,
        })
        return base
    if isinstance(q, S.SearchQuerySpec):
        base.update({
            "queryType": "search", "searchDimensions": list(q.dimensions),
            "query": q.query, "caseSensitive": q.case_sensitive,
            "filter": filter_to_dict(q.filter), "limit": q.limit,
        })
        if q.value_output is not None:
            base["valueOutput"] = q.value_output
            base["countOutput"] = q.count_output
        return base
    raise ValueError(type(q).__name__)


def query_to_json(q: S.QuerySpec) -> str:
    return json.dumps(query_to_dict(q))


def _gran_from(d) -> S.Granularity:
    if d is None:
        return S.GRAN_ALL
    if isinstance(d, str):
        return S.Granularity(d)
    return S.Granularity(d.get("type", "all"), d.get("duration"))


def query_from_dict(d: dict, default_ds: Optional[str] = None) -> S.QuerySpec:
    qt = d.get("queryType", "groupBy")
    ds = d.get("dataSource") or default_ds
    if ds is None:
        raise ValueError("query needs a dataSource")
    intervals = tuple(tuple(i) for i in d["intervals"]) \
        if d.get("intervals") else None
    posts = tuple(S.PostAggregationSpec(p["name"], expr_from_dict(p["expr"]))
                  for p in d.get("postAggregations", []) or [])
    aggs = tuple(agg_from_dict(a) for a in d.get("aggregations", []) or [])
    filt = filter_from_dict(d.get("filter"))
    cd = d.get("context") or {}
    qctx = S.QueryContext(cd.get("queryId"), cd.get("timeout"),
                          cd.get("preferSharded"), cd.get("lane"),
                          cd.get("tenant"), cd.get("priority")) \
        if cd else S.QueryContext()
    if qt == "groupBy":
        limit = None
        if d.get("limitSpec"):
            ls = d["limitSpec"]
            limit = S.LimitSpec(
                tuple(S.OrderByColumn(c["dimension"],
                                      c.get("ascending", True))
                      for c in ls.get("columns", [])), ls.get("limit"))
        having = None
        if d.get("having") is not None:
            having = S.HavingSpec(expr_from_dict(d["having"]))
        return S.GroupByQuerySpec(
            ds, tuple(dim_from_dict(x) for x in d.get("dimensions", [])),
            aggs, posts, filt, having, limit, _gran_from(d.get("granularity")),
            intervals, qctx)
    if qt == "timeseries":
        return S.TimeseriesQuerySpec(ds, aggs, posts, filt,
                                     _gran_from(d.get("granularity")),
                                     intervals, qctx)
    if qt == "topN":
        return S.TopNQuerySpec(ds, dim_from_dict(d["dimension"]),
                               d["metric"], d["threshold"], aggs, posts,
                               filt, _gran_from(d.get("granularity")),
                               intervals, qctx)
    if qt == "select":
        ps = d.get("pagingSpec", {})
        return S.SelectQuerySpec(ds, tuple(d.get("columns", [])), filt,
                                 intervals, ps.get("pageSize", 10000),
                                 ps.get("offset", 0),
                                 d.get("descending", False), qctx)
    if qt == "search":
        return S.SearchQuerySpec(ds, tuple(d.get("searchDimensions", [])),
                                 d.get("query", ""),
                                 d.get("caseSensitive", False), filt,
                                 d.get("limit"), intervals, qctx,
                                 d.get("valueOutput"), d.get("countOutput"))
    raise ValueError(f"unknown queryType {qt!r}")


def query_from_json(s: str, default_ds: Optional[str] = None) -> S.QuerySpec:
    return query_from_dict(json.loads(s), default_ds)
