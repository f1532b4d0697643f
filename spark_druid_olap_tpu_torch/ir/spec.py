"""Engine query IR — the ``DruidQuerySpec`` equivalent.

Port counterpart of ``spark_druid_olap_tpu/ir/spec.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

The reference models Druid's JSON query language as a sealed case-class
hierarchy (``DruidQuerySpec.scala``, 1126 LoC: extraction fns :31-103,
DimensionSpec :108-138, FilterSpec :152-281, AggregationSpec :283-377,
PostAggregationSpec :379-430, limit/having :437-507, QuerySpec :573-1098).
Here the same *capability surface* is a typed IR that lowers onto in-tree
XLA/Pallas kernels instead of serializing to JSON for an external cluster.

The IR is intentionally serializable (dataclasses of plain values + ``Expr``
trees) so it can travel over the serving layer (``ON DATASOURCE ... EXECUTE
QUERY <json>`` equivalent) and be rewritten by ``ir/transforms.py``
(≈ ``QuerySpecTransforms``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

from spark_druid_olap_tpu_torch.ir import expr as E

Interval = Tuple[int, int]  # [lo, hi) epoch millis, UTC


# =============================================================================
# Filters (reference: FilterSpec hierarchy, DruidQuerySpec.scala:152-281)
# =============================================================================

class FilterSpec:
    pass


@dataclasses.dataclass(frozen=True)
class SelectorFilter(FilterSpec):
    """dimension == value (reference: SelectorFilterSpec)."""
    dimension: str
    value: Optional[str]  # None selects nulls


@dataclasses.dataclass(frozen=True)
class BoundFilter(FilterSpec):
    """Range filter on a dim (lexicographic via sorted dictionary) or metric
    (numeric). Reference: BoundFilterSpec :214-253."""
    dimension: str
    lower: Optional[Any] = None
    upper: Optional[Any] = None
    lower_strict: bool = False
    upper_strict: bool = False
    numeric: bool = False


@dataclasses.dataclass(frozen=True)
class InFilter(FilterSpec):
    """dimension IN (values) (reference: ExtractionFnFilterSpec via InSet /
    Druid `in` filter)."""
    dimension: str
    values: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class PatternFilter(FilterSpec):
    """LIKE / regex / contains on a dim. Evaluated over the (small, sorted)
    dictionary on host -> constant code-mask on device; replaces Druid's
    regex/search/javascript filters (reference :176-213)."""
    dimension: str
    kind: str      # 'like' | 'regex' | 'contains'
    pattern: str


@dataclasses.dataclass(frozen=True)
class NullFilter(FilterSpec):
    dimension: str
    negated: bool = False  # True => IS NOT NULL


@dataclasses.dataclass(frozen=True)
class LogicalFilter(FilterSpec):
    """and/or/not (reference: LogicalFilterSpec / NotFilterSpec :254-269)."""
    op: str  # 'and' | 'or' | 'not'
    fields: Tuple[FilterSpec, ...]


@dataclasses.dataclass(frozen=True)
class ExprFilter(FilterSpec):
    """Arbitrary boolean expression compiled to XLA — the in-tree replacement
    for the JavaScript filter fallback (reference:
    JavascriptFilterSpec + JSCodeGenerator)."""
    expr: E.Expr


@dataclasses.dataclass(frozen=True)
class SpatialFilter(FilterSpec):
    """Rectangular-bound filter on a declared spatial dimension (reference:
    ``SpatialFilterSpec``/``RectangularBound`` DruidQuerySpec.scala:255-281).

    ``axes`` are the resolved numeric axis columns (declared at ingest via
    ``spatial_dims``); coordinates are inclusive on both bounds. Open sides
    use +/-inf. Beyond the row mask, the executor prunes whole segments
    whose per-axis bounding box misses the rectangle — the scan-era analog
    of Druid's R-tree index."""
    dimension: str
    axes: Tuple[str, ...]
    min_coords: Tuple[float, ...]
    max_coords: Tuple[float, ...]


TrueFilter = LogicalFilter("and", ())


# =============================================================================
# Dimension / extraction specs (reference: DruidQuerySpec.scala:31-138)
# =============================================================================

class ExtractionSpec:
    pass


@dataclasses.dataclass(frozen=True)
class TimeExtraction(ExtractionSpec):
    """Extract a calendar field or truncate to a grain, from the time column
    or a date-typed dim (reference: TimeFormatExtractionFunctionSpec)."""
    field: str  # 'year'|'quarter'|'month'|'week'|'day'|'dow'|'doy'|'hour'|'minute'|'trunc_<grain>'


@dataclasses.dataclass(frozen=True)
class ExprExtraction(ExtractionSpec):
    """Computed dimension: arbitrary expression over source columns, compiled
    to XLA (reference: JavaScriptExtractionFunctionSpec via JSCodeGenerator)."""
    expr: E.Expr
    cardinality: Optional[int] = None  # planner's bound on distinct outputs


@dataclasses.dataclass(frozen=True)
class LookupExtraction(ExtractionSpec):
    """Map-based dimension value translation (reference:
    LookUpExtractionFunctionSpec / InExtractionFnSpec,
    DruidQuerySpec.scala:66-103). Missing keys keep the original value when
    ``retain_missing``, become ``replace_missing_with`` when set, else null.
    Evaluated as a host transform of the (small) dictionary, then a constant
    code-remap LUT gather on device."""
    lookup: Tuple[Tuple[str, Optional[str]], ...]   # (from, to) pairs
    retain_missing: bool = False
    replace_missing_with: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class RegexExtraction(ExtractionSpec):
    """Regex capture-group extraction (reference:
    RegexExtractionFunctionSpec, DruidQuerySpec.scala:56-58). Non-matching
    values pass through unchanged unless ``replace_missing``, in which case
    they become ``replace_missing_with`` (null by default)."""
    pattern: str
    index: int = 1
    replace_missing: bool = False
    replace_missing_with: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DimensionSpec:
    """One GROUP BY output dimension (reference: DefaultDimensionSpec /
    ExtractionDimensionSpec :108-138)."""
    dimension: str                      # source column (or '__time')
    output_name: str
    extraction: Optional[ExtractionSpec] = None


# =============================================================================
# Aggregations (reference: AggregationSpec :283-377; post-aggs :379-430)
# =============================================================================

@dataclasses.dataclass(frozen=True)
class AggregationSpec:
    """kind: count | longsum | doublesum | longmin | longmax | doublemin |
    doublemax | cardinality (HLL approximate count-distinct, reference
    CardinalityAggregationSpec :340-360 / HyperUniqueAggregationSpec).

    ``field`` names a source column; ``expr`` (exclusive with field) is a
    computed input compiled to XLA (reference: JavascriptAggregationSpec via
    JSAggGenerator). ``filter`` makes it a filtered aggregation
    (reference: FilteredAggregationSpec :362-377). ``fraction`` is the
    quantile for ``kind == "quantile"`` (percentile_approx), carried on
    the spec so the broker can finalize merged KLL registers with the
    same fraction the engine would."""
    kind: str
    name: str
    field: Optional[str] = None
    expr: Optional[E.Expr] = None
    filter: Optional[FilterSpec] = None
    fraction: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class PostAggregationSpec:
    """Arithmetic over aggregation outputs, evaluated in the merge epilogue
    (reference: ArithmeticPostAggregationSpec :379-430). ``expr`` refers to
    aggregation names as columns."""
    name: str
    expr: E.Expr


# =============================================================================
# Limit / having / granularity (reference :140-150, :437-507)
# =============================================================================

@dataclasses.dataclass(frozen=True)
class OrderByColumn:
    name: str
    ascending: bool = True


@dataclasses.dataclass(frozen=True)
class LimitSpec:
    columns: Tuple[OrderByColumn, ...]
    limit: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class HavingSpec:
    """Post-aggregation predicate; expr over agg/dim output names (reference:
    HavingSpec json tree)."""
    expr: E.Expr


@dataclasses.dataclass(frozen=True)
class Granularity:
    """'all' | 'none' (row time) | calendar grains | duration millis
    (reference: DruidQueryGranularity.scala)."""
    kind: str = "all"
    duration_millis: Optional[int] = None

    def is_all(self) -> bool:
        return self.kind == "all"


GRAN_ALL = Granularity("all")


# =============================================================================
# Query specs (reference: sealed QuerySpec, DruidQuerySpec.scala:573-1098)
# =============================================================================

@dataclasses.dataclass(frozen=True)
class QueryContext:
    """Per-query execution knobs (reference: QuerySpecContext :558-571)."""
    query_id: Optional[str] = None
    timeout_millis: Optional[int] = None
    prefer_sharded: Optional[bool] = None  # force mesh execution on/off
    # workload management (wlm/): admission lane, quota tenant, queue
    # priority (higher first). None = classified by the WorkloadManager.
    lane: Optional[str] = None
    tenant: Optional[str] = None
    priority: Optional[int] = None


class QuerySpec:
    pass


@dataclasses.dataclass(frozen=True)
class GroupByQuerySpec(QuerySpec):
    datasource: str
    dimensions: Tuple[DimensionSpec, ...]
    aggregations: Tuple[AggregationSpec, ...]
    post_aggregations: Tuple[PostAggregationSpec, ...] = ()
    filter: Optional[FilterSpec] = None
    having: Optional[HavingSpec] = None
    limit: Optional[LimitSpec] = None
    granularity: Granularity = GRAN_ALL
    intervals: Optional[Tuple[Interval, ...]] = None
    context: QueryContext = QueryContext()


@dataclasses.dataclass(frozen=True)
class TimeseriesQuerySpec(QuerySpec):
    """GroupBy with no dimensions — pure (time-bucketed) aggregate
    (reference: TimeSeriesQuerySpec :709-744)."""
    datasource: str
    aggregations: Tuple[AggregationSpec, ...]
    post_aggregations: Tuple[PostAggregationSpec, ...] = ()
    filter: Optional[FilterSpec] = None
    granularity: Granularity = GRAN_ALL
    intervals: Optional[Tuple[Interval, ...]] = None
    context: QueryContext = QueryContext()


@dataclasses.dataclass(frozen=True)
class TopNQuerySpec(QuerySpec):
    """Single-dim ordered-limit aggregate; per-shard partial top-K + merge,
    approximate like Druid's topN engine (reference: TopNQuerySpec
    :767-822)."""
    datasource: str
    dimension: DimensionSpec
    metric: str                      # aggregation name ordered by (desc)
    threshold: int
    aggregations: Tuple[AggregationSpec, ...]
    post_aggregations: Tuple[PostAggregationSpec, ...] = ()
    filter: Optional[FilterSpec] = None
    granularity: Granularity = GRAN_ALL
    intervals: Optional[Tuple[Interval, ...]] = None
    context: QueryContext = QueryContext()


@dataclasses.dataclass(frozen=True)
class SelectQuerySpec(QuerySpec):
    """Raw-row paged scan (non-aggregate pushdown; reference: SelectSpec /
    PagingSpec :977-1098). ``page_offset`` is the resume cursor — the
    checkpoint/resume analog of Druid paging identifiers."""
    datasource: str
    columns: Tuple[str, ...]
    filter: Optional[FilterSpec] = None
    intervals: Optional[Tuple[Interval, ...]] = None
    page_size: int = 10000
    page_offset: int = 0
    descending: bool = False
    context: QueryContext = QueryContext()


@dataclasses.dataclass(frozen=True)
class SearchQuerySpec(QuerySpec):
    """Dimension-value search: which dictionary values (optionally restricted
    by a row filter) contain the query string (reference: SearchQuerySpec
    :870-975)."""
    datasource: str
    dimensions: Tuple[str, ...]
    query: str
    case_sensitive: bool = False
    filter: Optional[FilterSpec] = None
    limit: Optional[int] = None
    intervals: Optional[Tuple[Interval, ...]] = None
    context: QueryContext = QueryContext()
    # set when rewritten FROM a group-by (QuerySpecTransforms
    # GroupBy->Search, reference :225-277): result columns become
    # [value_output, count_output] instead of [dimension, value, count]
    value_output: Optional[str] = None
    count_output: Optional[str] = None


def topn_limit(q: "TopNQuerySpec") -> LimitSpec:
    """The ORDER BY metric DESC LIMIT threshold epilogue a TopN implies.
    One definition shared by the engine (parallel/executor.py) and the
    broker's post-merge epilogue (cluster/broker.py), so the broker's
    re-sort of merged TopN partials can never drift from the engine's
    own order/limit epilogue."""
    return LimitSpec((OrderByColumn(q.metric, ascending=False),),
                     q.threshold)


def filter_and(parts: Sequence[Optional[FilterSpec]]) -> Optional[FilterSpec]:
    fs = tuple(p for p in parts if p is not None)
    if not fs:
        return None
    if len(fs) == 1:
        return fs[0]
    return LogicalFilter("and", fs)


def query_aggregations(q: QuerySpec) -> Tuple[AggregationSpec, ...]:
    return getattr(q, "aggregations", ())


def query_dimensions(q: QuerySpec) -> Tuple[DimensionSpec, ...]:
    if isinstance(q, GroupByQuerySpec):
        return q.dimensions
    if isinstance(q, TopNQuerySpec):
        return (q.dimension,)
    return ()
