"""Canonical cache keys for the semantic result cache.

Port counterpart of ``spark_druid_olap_tpu/cache/keys.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

A key identifies the *answer* of an engine-level QuerySpec, so it must be
insensitive to representations that cannot change the result:

* ``QueryContext`` (query id, timeout, shard preference) is stripped.
* AND/OR filter trees are flattened, TRUE conjuncts dropped, and children
  sorted; IN value lists are deduped and sorted.
* Aggregations are sorted by output name (the hit path restores the
  query's column order from the spec itself).
* Intervals are sorted and merged via the same [lo, hi) millisecond
  convention as ``ir/intervals.py``; the full range folds to ``None``.

Dimension order is deliberately *kept*: it determines the engine's fused
group-key construction and therefore row order, and two queries that
differ only in dimension order must not alias to one entry if we want
cached results bit-identical to uncached execution.

The key also folds in the per-datasource ingest version
(:meth:`SegmentStore.datasource_version`) and the port's
``Config.fingerprint()``, so invalidation is structural — any re-ingest,
drop or config change moves subsequent queries to fresh keys (≈ Druid's
segment version in its result-cache keys).

Persistence can rewind a version: an in-session RESTORE installs the
snapshot's ingest version again, so ``sql/session.py`` clears every
derived cache after it. Recovery at construction restores each
datasource's exact pre-crash version (``SegmentStore.restore``) into an
empty cache, so a key still names one datasource state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.ir.intervals import MAX_MS, MIN_MS

# Engine-level spec types the semantic cache serves. Select is excluded
# (pagination state) and Search results are cheap scans over dictionaries.
CACHEABLE_TYPES = (S.GroupByQuerySpec, S.TimeseriesQuerySpec, S.TopNQuerySpec)


def cacheable(q) -> bool:
    return isinstance(q, CACHEABLE_TYPES)


def _sort_key(f) -> str:
    return repr(f)


def normalize_filter(f: Optional[S.FilterSpec]) -> Optional[S.FilterSpec]:
    """Return a canonical filter, or None for anything equivalent to TRUE."""
    if f is None:
        return None
    if isinstance(f, S.LogicalFilter):
        if f.op in ("and", "or"):
            parts = []
            for child in f.fields:
                nc = normalize_filter(child)
                if nc is None:
                    if f.op == "or":
                        return None  # TRUE branch absorbs the OR
                    continue  # TRUE conjunct drops from the AND
                if isinstance(nc, S.LogicalFilter) and nc.op == f.op:
                    parts.extend(nc.fields)
                else:
                    parts.append(nc)
            if not parts:
                # Empty AND is TRUE; empty OR is FALSE — keep the latter.
                return None if f.op == "and" else S.LogicalFilter("or", ())
            if len(parts) == 1:
                return parts[0]
            return S.LogicalFilter(f.op, tuple(sorted(parts, key=_sort_key)))
        if f.op == "not":
            kids = tuple(
                normalize_filter(c) if normalize_filter(c) is not None else S.TrueFilter
                for c in f.fields
            )
            return S.LogicalFilter("not", kids)
        return f
    if isinstance(f, S.InFilter):
        vals = tuple(sorted(set(f.values), key=lambda v: (v is None, v)))
        return dataclasses.replace(f, values=vals)
    return f


def normalize_intervals(
    intervals: Optional[Tuple[S.Interval, ...]],
) -> Optional[Tuple[S.Interval, ...]]:
    """Sort, drop empties, merge overlapping/adjacent; full range -> None."""
    if intervals is None:
        return None
    spans = sorted((int(lo), int(hi)) for lo, hi in intervals if int(lo) < int(hi))
    merged = []
    for lo, hi in spans:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    out = tuple((lo, hi) for lo, hi in merged)
    if out == ((MIN_MS, MAX_MS),):
        return None
    return out


def normalize_aggs(
    aggs: Tuple[S.AggregationSpec, ...],
) -> Tuple[S.AggregationSpec, ...]:
    normed = tuple(
        dataclasses.replace(a, filter=normalize_filter(a.filter)) for a in aggs
    )
    return tuple(sorted(normed, key=lambda a: a.name))


#: Spec fields DELIBERATELY stripped from the canonical key even though
#: runtime code reads them (sdlint keys/K2 checks this list). Every entry
#: needs a result-neutrality argument:
#: - context: carries query_id / timeout / lane / tenant / priority —
#:   pure execution metadata. The planner and executor read it only for
#:   cancellation, deadlines, and admission routing; no field of
#:   QueryContext ever reaches an aggregation, filter, or output column,
#:   so two queries differing only in context MUST alias to one entry
#:   (that aliasing is the whole point of the result cache under
#:   per-request ids).
KEY_EXEMPT_FIELDS = ("context",)


def normalize_spec(q):
    """Canonical form of a cacheable spec: context stripped, filter/aggs/
    intervals normalized. The returned spec is only used for its repr."""
    kw = dict(
        context=S.QueryContext(),
        filter=normalize_filter(q.filter),
        intervals=normalize_intervals(q.intervals),
        aggregations=normalize_aggs(q.aggregations),
    )
    return dataclasses.replace(q, **kw)


def canonical_key(q, ds_version: int, config_fp) -> tuple:
    """Hashable key for one engine-level query answer."""
    return (
        type(q).__name__,
        q.datasource,
        int(ds_version),
        config_fp,
        repr(normalize_spec(q)),
    )


def expected_columns(q) -> Tuple[str, ...]:
    """Output column order the engine produces for ``q`` — used to restore
    the query's own order when serving from an agg-sorted cache entry."""
    cols = []
    gran = getattr(q, "granularity", None)
    if gran is not None and getattr(gran, "kind", None) != "all":
        cols.append("timestamp")
    for d in S.query_dimensions(q):
        cols.append(d.output_name)
    for a in S.query_aggregations(q):
        cols.append(a.name)
    for p in getattr(q, "post_aggregations", ()) or ():
        cols.append(p.name)
    return tuple(cols)
