"""Subsumption: answer a query from a *superset* cached entry.

Port counterpart of ``spark_druid_olap_tpu/cache/subsume.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

Each rule yields ``(generalized_spec, derive_fn)`` pairs from
:func:`candidates`. The cache probes the generalized spec's canonical key
and, on a hit, calls ``derive_fn(q, entry)`` to re-shape the cached rows
on the host — no device work. ``derive_fn`` returns ``None`` whenever it
cannot prove the derivation exact, and the cache falls through to the
next candidate (ultimately a miss).

Rules (mirroring classic view-matching / Druid broker merge logic):

1. **Granularity rollup** — a coarser-granularity timeseries from a
   cached finer one, for aggregations whose partials merge losslessly
   (count/longsum/doublesum re-sum; min/min, max/max). UTC sessions
   only: non-UTC bucketing shifts wall-clock boundaries through the
   engine's TZ LUTs, which host-side re-bucketing does not replicate.
   ``week`` only coarsens to ``all`` (weeks straddle month bounds).
   Float re-summation is kept because the engine's own cross-bucket
   merge is the same left-to-right ordered reduction over ascending
   buckets.
2. **TopN from GroupBy** — an (exact) TopN answered by ordering and
   heading a cached unlimited GroupBy over the same dimension.
3. **Filtered GroupBy** — a GroupBy whose filter touches only its own
   plain (extraction-free) dimensions, answered by masking rows of the
   cached unfiltered GroupBy: every group is homogeneous in its own
   dims, so a dim-only row filter is exactly a group filter.
4. **Having/limit re-evaluation** — having, order-by-limit, and post
   aggregations re-applied on a cached unconstrained GroupBy, using the
   engine's own epilogue ordering so ties land identically.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from spark_druid_olap_tpu_torch.cache import keys as K
from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.result import QueryResult
from spark_druid_olap_tpu_torch.utils import host_eval

MILLIS_PER_DAY = 86_400_000

# target granularity kind -> finer source kinds that nest inside it,
# coarsest (cheapest to merge) first
_SOURCES = {
    "all": ("year", "quarter", "month", "week", "day", "hour", "minute"),
    "year": ("quarter", "month", "day", "hour", "minute"),
    "quarter": ("month", "day", "hour", "minute"),
    "month": ("day", "hour", "minute"),
    "week": ("day", "hour", "minute"),
    "day": ("hour", "minute"),
    "hour": ("minute",),
}

# agg kind -> lossless partial-merge op (approximate sketches excluded)
_MERGE = {
    "count": "sum",
    "longsum": "sum",
    "doublesum": "sum",
    "longmin": "min",
    "doublemin": "min",
    "longmax": "max",
    "doublemax": "max",
}


def _ctx_stripped(q, **kw):
    return dataclasses.replace(q, context=S.QueryContext(), **kw)


def _post_variants(q) -> Tuple[Tuple[S.PostAggregationSpec, ...], ...]:
    """Probe both the cached-with-same-posts and cached-without-posts
    shapes; posts are always recomputed from aggs on derivation."""
    if getattr(q, "post_aggregations", ()):
        return (q.post_aggregations, ())
    return ((),)


# ---------------------------------------------------------------------------
# shared epilogue — must order ties exactly as the engine's _agg_epilogue
# ---------------------------------------------------------------------------

def _apply_epilogue(data: dict, post_aggregations, having, limit) -> dict:
    """Posts + HAVING + ORDER BY/LIMIT, byte-compatible with
    ``QueryEngine._agg_epilogue`` (same lexsort keys, same null order)."""
    from spark_druid_olap_tpu_torch.parallel.executor import _neg_key

    for pa in post_aggregations:
        data[pa.name] = np.asarray(host_eval.eval_expr(pa.expr, data))
    if having is not None:
        keep = host_eval.eval_pred3(having.expr, data)
        data = {k: v[keep] for k, v in data.items()}
    if limit is not None and limit.columns:
        order_keys = []
        for oc in reversed(limit.columns):
            k = data[oc.name]
            if k.dtype == object and all(
                    v is None or isinstance(v, (int, np.integer)) for v in k):
                nulls = np.array([v is None for v in k])
                vals = np.array([0 if v is None else int(v) for v in k],
                                dtype=np.int64)
                order_keys.append(vals if oc.ascending else -vals)
                order_keys.append(nulls)
                continue
            if k.dtype == object:
                k = k.astype(str)
            order_keys.append(k if oc.ascending else _neg_key(k))
        idx = np.lexsort(order_keys)
        if limit.limit is not None:
            idx = idx[: limit.limit]
        data = {k: v[idx] for k, v in data.items()}
    elif limit is not None and limit.limit is not None:
        data = {k: v[: limit.limit] for k, v in data.items()}
    return data


def _finish(q, data: dict) -> Optional[QueryResult]:
    """Package ``data`` into the query's expected column order."""
    want = K.expected_columns(q)
    if any(c not in data for c in want):
        return None
    return QueryResult(
        list(want), {c: np.array(data[c], copy=True) for c in want})


# ---------------------------------------------------------------------------
# rule 1 — granularity rollup (timeseries)
# ---------------------------------------------------------------------------

def _bucket_start_ms(kind: str, ms: np.ndarray) -> np.ndarray:
    """Target bucket start per row, epoch ms UTC — mirrors the engine's
    ``ops/time_ops.bucket_and_cardinality`` decode math."""
    if kind == "all":
        return np.zeros_like(ms)
    if kind == "minute":
        return ms - (ms % 60_000)
    if kind == "hour":
        return ms - (ms % 3_600_000)
    if kind == "day":
        return ms - (ms % MILLIS_PER_DAY)
    if kind == "week":
        days = ms // MILLIS_PER_DAY
        wk = (days + 3) // 7  # Monday-aligned, epoch was a Thursday
        return (wk * 7 - 3) * MILLIS_PER_DAY
    dt = ms.astype("datetime64[ms]")
    if kind == "month":
        return dt.astype("datetime64[M]").astype("datetime64[ms]").astype(np.int64)
    if kind == "quarter":
        m = dt.astype("datetime64[M]").astype(np.int64)
        return ((m // 3) * 3).astype("datetime64[M]") \
            .astype("datetime64[ms]").astype(np.int64)
    if kind == "year":
        return dt.astype("datetime64[Y]").astype("datetime64[ms]").astype(np.int64)
    raise ValueError(f"unsupported rollup target granularity {kind!r}")


def _merge_column(vals: np.ndarray, inv: np.ndarray, n: int, how: str
                  ) -> Optional[np.ndarray]:
    if vals.dtype == object:
        # wide-int sums / min-max decode to Python ints with None for
        # empty groups; merge null-skipping in plain Python
        out = [None] * n
        for g, v in zip(inv, vals):
            if v is None:
                continue
            cur = out[g]
            if cur is None:
                out[g] = v
            elif how == "sum":
                out[g] = cur + v
            elif how == "min":
                out[g] = min(cur, v)
            else:
                out[g] = max(cur, v)
        return np.array(out, dtype=object)
    if np.issubdtype(vals.dtype, np.floating):
        valid = ~np.isnan(vals)
        cnt = np.zeros(n, dtype=np.int64)
        np.add.at(cnt, inv[valid], 1)
        if how == "sum":
            out = np.zeros(n, dtype=vals.dtype)
            np.add.at(out, inv[valid], vals[valid])
        elif how == "min":
            out = np.full(n, np.inf, dtype=vals.dtype)
            np.minimum.at(out, inv[valid], vals[valid])
        else:
            out = np.full(n, -np.inf, dtype=vals.dtype)
            np.maximum.at(out, inv[valid], vals[valid])
        out[cnt == 0] = np.nan
        return out
    if np.issubdtype(vals.dtype, np.integer):
        if how == "sum":
            out = np.zeros(n, dtype=vals.dtype)
            np.add.at(out, inv, vals)
        elif how == "min":
            out = np.full(n, np.iinfo(vals.dtype).max, dtype=vals.dtype)
            np.minimum.at(out, inv, vals)
        else:
            out = np.full(n, np.iinfo(vals.dtype).min, dtype=vals.dtype)
            np.maximum.at(out, inv, vals)
        return out
    return None


def _derive_rollup(q, entry) -> Optional[QueryResult]:
    cols, data = entry
    if "timestamp" not in data:
        return None
    ts = np.asarray(data["timestamp"])
    if not np.issubdtype(ts.dtype, np.datetime64):
        return None
    target = q.granularity.kind
    if len(ts) == 0:
        if target == "all":
            return None  # global aggregate over zero rows: identity-row
            # semantics the rollup cannot reproduce — execute normally
        return QueryResult.empty(list(K.expected_columns(q)))
    ms = ts.astype("datetime64[ms]").astype(np.int64)
    buckets = _bucket_start_ms(target, ms)
    uniq, inv = np.unique(buckets, return_inverse=True)
    n = len(uniq)
    out: Dict[str, np.ndarray] = {}
    if target != "all":
        out["timestamp"] = uniq.astype("datetime64[ms]")
    for a in q.aggregations:
        how = _MERGE.get(a.kind)
        src = data.get(a.name)
        if how is None or src is None:
            return None
        merged = _merge_column(np.asarray(src), inv, n, how)
        if merged is None:
            return None
        out[a.name] = merged
    out = _apply_epilogue(out, q.post_aggregations, None, None)
    return _finish(q, out)


# ---------------------------------------------------------------------------
# rule 3 helper — host evaluation of dim-only filters over decoded groups
# ---------------------------------------------------------------------------

_SIMPLE_FILTERS = (S.SelectorFilter, S.BoundFilter, S.InFilter,
                   S.PatternFilter, S.NullFilter)


def _filter_derivable(f: S.FilterSpec, dim_map: Dict[str, str]) -> bool:
    if isinstance(f, S.LogicalFilter):
        return all(_filter_derivable(c, dim_map) for c in f.fields)
    return isinstance(f, _SIMPLE_FILTERS) and f.dimension in dim_map


def _null_mask(col: np.ndarray) -> np.ndarray:
    if col.dtype == object:
        return np.array([v is None for v in col], dtype=bool)
    if np.issubdtype(col.dtype, np.floating):
        return np.isnan(col)
    return np.zeros(len(col), dtype=bool)


def _eval_filter(f, data: dict, dim_map: Dict[str, str]
                 ) -> Optional[np.ndarray]:
    """Boolean row mask of ``f`` over decoded group columns, or None when
    a comparison cannot be proven faithful to the engine's dictionary
    semantics (caller falls through to a miss)."""
    if isinstance(f, S.LogicalFilter):
        n = len(next(iter(data.values()))) if data else 0
        if f.op == "not":
            inner = _eval_filter(f.fields[0], data, dim_map) \
                if f.fields else None
            return None if inner is None else ~inner
        acc = np.full(n, f.op == "and", dtype=bool)
        for c in f.fields:
            m = _eval_filter(c, data, dim_map)
            if m is None:
                return None
            acc = (acc & m) if f.op == "and" else (acc | m)
        return acc
    col = np.asarray(data[dim_map[f.dimension]])
    null = _null_mask(col)
    if isinstance(f, S.NullFilter):
        return ~null if f.negated else null
    if col.dtype != object:
        # engine dim filters compare against string dictionary entries;
        # only derive over decoded string columns
        return None
    svals = np.array([("" if v is None else str(v)) for v in col])
    if isinstance(f, S.SelectorFilter):
        if f.value is None:
            return null
        return (svals == str(f.value)) & ~null
    if isinstance(f, S.InFilter):
        want = {str(v) for v in f.values if v is not None}
        mask = np.isin(svals, sorted(want)) & ~null
        if any(v is None for v in f.values):
            mask |= null
        return mask
    if isinstance(f, S.BoundFilter):
        if f.numeric:
            return None  # numeric coercion order differs from lexicographic
        mask = ~null
        if f.lower is not None:
            lo = str(f.lower)
            mask &= (svals > lo) if f.lower_strict else (svals >= lo)
        if f.upper is not None:
            hi = str(f.upper)
            mask &= (svals < hi) if f.upper_strict else (svals <= hi)
        return mask
    if isinstance(f, S.PatternFilter):
        if f.kind == "contains":
            pred = lambda s: f.pattern in s
        elif f.kind == "like":
            rx = re.compile(
                "^" + "".join(
                    ".*" if ch == "%" else "." if ch == "_"
                    else re.escape(ch) for ch in f.pattern) + "$",
                re.DOTALL)
            pred = lambda s: rx.match(s) is not None
        elif f.kind == "regex":
            rx = re.compile(f.pattern)
            pred = lambda s: rx.search(s) is not None
        else:
            return None
        return np.array([pred(s) for s in svals], dtype=bool) & ~null
    return None


def _make_derive_groupby(extra_filter: Optional[S.FilterSpec]):
    def derive(q, entry) -> Optional[QueryResult]:
        cols, data = entry
        data = dict(data)
        if extra_filter is not None:
            dim_map = {d.dimension: d.output_name for d in q.dimensions
                       if d.extraction is None}
            mask = _eval_filter(extra_filter, data, dim_map)
            if mask is None:
                return None
            data = {k: np.asarray(v)[mask] for k, v in data.items()}
        # posts always recomputed from the cached aggs
        data = {k: v for k, v in data.items()
                if k not in {p.name for p in q.post_aggregations}}
        data = _apply_epilogue(data, q.post_aggregations, q.having, q.limit)
        return _finish(q, data)

    return derive


def _derive_topn(q, entry) -> Optional[QueryResult]:
    cols, data = entry
    data = {k: v for k, v in dict(data).items()
            if k not in {p.name for p in q.post_aggregations}}
    limit = S.LimitSpec((S.OrderByColumn(q.metric, ascending=False),),
                        q.threshold)
    if q.metric not in data and q.metric not in {
            p.name for p in q.post_aggregations}:
        return None
    data = _apply_epilogue(data, q.post_aggregations, None, limit)
    return _finish(q, data)


# ---------------------------------------------------------------------------
# candidate enumeration
# ---------------------------------------------------------------------------

def candidates(q, utc: bool = True) -> Iterator[tuple]:
    """Yield ``(generalized_spec, derive_fn)`` pairs, best-first."""
    if isinstance(q, S.TimeseriesQuerySpec):
        gran = q.granularity or S.GRAN_ALL
        # malformed granularity (e.g. a bare string) falls through to the
        # engine so its own contract error surfaces, not a cache traceback
        gkind = getattr(gran, "kind", None)
        if utc and gkind and all(a.kind in _MERGE for a in q.aggregations):
            for src_kind in _SOURCES.get(gkind, ()):
                for pp in _post_variants(q):
                    yield (
                        _ctx_stripped(q, granularity=S.Granularity(src_kind),
                                      post_aggregations=pp),
                        _derive_rollup,
                    )
        return
    if isinstance(q, S.TopNQuerySpec):
        for pp in _post_variants(q):
            yield (
                S.GroupByQuerySpec(
                    datasource=q.datasource,
                    dimensions=(q.dimension,),
                    aggregations=q.aggregations,
                    post_aggregations=pp,
                    filter=q.filter,
                    having=None,
                    limit=None,
                    granularity=q.granularity,
                    intervals=q.intervals,
                ),
                _derive_topn,
            )
        return
    if isinstance(q, S.GroupByQuerySpec):
        variants = []
        if q.having is not None or q.limit is not None:
            variants.append((dict(having=None, limit=None), None))
        nf = K.normalize_filter(q.filter)
        if nf is not None:
            dim_map = {d.dimension: d.output_name for d in q.dimensions
                       if d.extraction is None}
            if _filter_derivable(nf, dim_map):
                variants.append(
                    (dict(filter=None, having=None, limit=None), nf))
        for kw, extra in variants:
            for pp in _post_variants(q):
                yield (
                    _ctx_stripped(q, post_aggregations=pp, **kw),
                    _make_derive_groupby(extra),
                )
