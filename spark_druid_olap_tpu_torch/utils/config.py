"""Session configuration.

Port of ``spark_druid_olap_tpu/utils/config.py``: the ``Config`` class and
only the registry entries the port reads. Keys keep the JAX package's
names, so one settings dict configures both engines; unknown ``sdot.*``
keys are accepted, as there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class ConfigEntry:
    key: str
    default: Any
    doc: str
    parse: Callable[[str], Any] = lambda s: s
    #: semantic keys change query results or plans and belong in cache
    #: fingerprints; operational keys (profiling, memo sizing) do not
    semantic: bool = True


def _parse_bool(s: str) -> bool:
    return str(s).strip().lower() in ("1", "true", "yes", "on")


_REGISTRY: Dict[str, ConfigEntry] = {}


def _entry(key: str, default: Any, doc: str, parse=None,
           semantic: bool = True) -> ConfigEntry:
    if parse is None:
        if isinstance(default, bool):
            parse = _parse_bool
        elif isinstance(default, int):
            parse = int
        elif isinstance(default, float):
            parse = float
        else:
            parse = lambda s: s
    e = ConfigEntry(key, default, doc, parse, semantic)
    _REGISTRY[key] = e
    return e


TZ_ID = _entry(
    "sdot.timezone", "UTC",
    "Timezone for time bucketing and interval arithmetic.")
SEGMENT_ROWS = _entry(
    "sdot.segment.target.rows", 1 << 20,
    "Target rows per time-sharded segment at ingest.")
GROUPBY_PALLAS_MAX_KEYS = _entry(
    "sdot.engine.groupby.pallas.max.keys", 64,
    "Dense group-by runs the fused single-pass kernel "
    "(ops/cuda_groupby.py) when the fused key cardinality is at most "
    "this; above it, the scatter tier (ops/groupby.scatter_groupby). 0 "
    "disables the kernel. The key keeps the JAX package's name so one "
    "setting drives both engines.")
GROUPBY_DENSE_MAX_KEYS = _entry(
    "sdot.engine.groupby.dense.max.keys", 1 << 22,
    "Max fused key cardinality for the dense device group-by; above it "
    "the engine switches to the hashed group-by (ops/hash_groupby.py).")
GROUPBY_SORTED_MIN_KEYS = _entry(
    "sdot.engine.groupby.sorted.min.keys", 1024,
    "Medium-K routing: key cardinalities at or above this route to the "
    "sorted-run tier even below dense.max.keys when the sorted-run gate "
    "(sdot.engine.groupby.hash.sortedrun) says so. 0 disables the "
    "medium-K reroute.")
GROUPBY_HASH_SLOTS = _entry(
    "sdot.engine.groupby.hash.slots", 0,
    "Group-table slot count for the hashed group-by (any value; used "
    "as-is). 0 = auto-size to the next power of two above the group-count "
    "upper bound min(key space, selected rows). Overflow retries at 4x up "
    "to sdot.engine.groupby.hash.max.slots.")
GROUPBY_HASH_MAX_SLOTS = _entry(
    "sdot.engine.groupby.hash.max.slots", 1 << 24,
    "Max hash-table slot count; a query whose actual group count exceeds "
    "what this table can hold falls back to the host tier "
    "(EngineFallback).")
GROUPBY_HASH_MAX_SLOTS_CPU = _entry(
    "sdot.engine.groupby.hash.max.slots.cpu", 1 << 23,
    "Hash-table slot ceiling on a cpu device (effective cap = min(this, "
    "sdot.engine.groupby.hash.max.slots)), as the JAX package applies it "
    "off the TPU. A cuda device uses hash.max.slots alone.")
GROUPBY_HASH_SORTED = _entry(
    "sdot.engine.groupby.hash.sortedrun", "auto",
    "Sorted-run aggregation for the hashed group-by tier "
    "(ops/sorted_groupby.py): ride agg values as sort payloads and "
    "replace per-agg scatters with prefix sums, segmented reductions and "
    "run-boundary reads. 'auto' = on when the device's unit cost of a "
    "sort payload row is below that of a scatter update at the query's "
    "rows per group (segment-pruned rows over min(key space, rows); "
    "parallel/cost.unit_cost); 'on'/'off' force it.")
GROUPBY_HASH_COMPACT_MIN = _entry(
    "sdot.engine.groupby.hash.compact.min.slots", 1 << 18,
    "Min hash-table slot count before the hashed group-by compacts on "
    "device (two dispatches: build the table and read its occupancy "
    "count, then copy only the occupied slots to the host) instead of "
    "transferring the full [T] table.")
COST_SORT_PAYLOAD_ROW = _entry(
    "sdot.querycostmodel.sort.payload.seconds.per.row", 6.7e-10,
    "Seconds per row per extra sort payload operand. The default is the "
    "JAX package's TPU value and is never used for a cpu or cuda device: "
    "parallel/cost.unit_cost reads each device's measured table unless "
    "this key is set explicitly.", float)
COST_SCATTER_UPDATE = _entry(
    "sdot.querycostmodel.scatter.seconds.per.update", 6.7e-9,
    "Seconds per update of a scatter into a group table that fits in "
    "cache. The default is the JAX package's TPU value and is never used "
    "for a cpu or cuda device: parallel/cost.unit_cost reads each "
    "device's measured table (on cuda a curve over rows per slot) unless "
    "this key is set explicitly.", float)
COST_SORT_ROW = _entry(
    "sdot.querycostmodel.sort.seconds.per.row", 2.2e-10,
    "Seconds per row of the late-materialization compaction (the stable "
    "partition of live rows). The default is the JAX package's TPU value "
    "and is never used for a cpu or cuda device: parallel/cost.unit_cost "
    "reads each device's measured table unless this key is set "
    "explicitly.", float)
COST_SCATTER_UPDATE_BIG = _entry(
    "sdot.querycostmodel.scatter.big.seconds.per.update", 6.7e-9,
    "Seconds per scatter update into a group table larger than "
    "sdot.querycostmodel.table.cache.bytes. The default is the JAX "
    "package's TPU value and is never used for a cpu or cuda device.",
    float)
COST_TABLE_CACHE_BYTES = _entry(
    "sdot.querycostmodel.table.cache.bytes", 24 << 20,
    "Group-table byte size above which the compaction gate prices "
    "scatter updates at the big-table unit cost.", int)
COST_GATHER_PROBE = _entry(
    "sdot.querycostmodel.gather.seconds.per.probe", 7e-9,
    "Seconds per probe of a flat 1-D device gather (the compacted "
    "column reads). The default is the JAX package's TPU value and is "
    "never used for a cuda device.", float)
COST_FUSED_ROW = _entry(
    "sdot.querycostmodel.fused.seconds.per.row", 2.3e-9,
    "Seconds per row of the fused small-K group-by kernel's one pass: "
    "what compaction saves per removed row on that tier. The default is "
    "the JAX package's TPU value; a cpu device takes it as the JAX "
    "package does there, a cuda device reads its measured value.",
    float)
HLL_LOG2M = _entry(
    "sdot.engine.hll.log2m", 11,
    "log2 of the HLL register count for approximate count-distinct "
    "(reference: Druid hyperUnique uses 2^11 registers).")
QUANTILE_LANES = _entry(
    "sdot.quantile.lanes", 256,
    "Sample lanes per KLL level for percentile_approx (ops/kll.py). "
    "Register width is 2*4*lanes + 4 int32 per group; rank error "
    "shrinks ~1/sqrt(lanes). Must match across every engine in a "
    "cluster — registers merge elementwise at the broker.")
QUANTILE_RANK_BOUND = _entry(
    "sdot.quantile.rank_bound", 0.05,
    "Maximum |rank(estimate) - fraction| the bench/loadtest percentile "
    "differential gates accept from the KLL estimate (rank space, not "
    "value space — value error is unbounded for heavy-tailed data).")
DEVICE_CACHE_BYTES = _entry(
    "sdot.engine.device.cache.bytes", 8 << 30,
    "Budget for device-resident bound column arrays (host-side bytes "
    "tracked per upload). When a new binding would exceed it the whole "
    "array cache is dropped before the upload and rebuilt on demand, so "
    "residency peaks at the budget plus one array; a scan is never "
    "refused for it. How much one scan binds at once is "
    "sdot.engine.wave.max.bytes.")
WAVE_MAX_BYTES = _entry(
    "sdot.engine.wave.max.bytes", 0,
    "Per-device byte budget for one execution wave's scan arrays; a scan "
    "whose bound arrays exceed it runs in multiple bounded waves over the "
    "segment axis. 0 = auto: on a cuda device 30% of its memory, so that "
    "two waves in flight plus the bind cache fit (the JAX package takes "
    "60% of its device's HBM limit); unbounded on the CPU, as there. "
    "Reference analog: the cost model's segments-per-query limit "
    "bounding per-historical work (DruidQueryCostModel.scala:343-414).")
TOPN_DEVICE_MIN_KEYS = _entry(
    "sdot.engine.topn.device.min.keys", 8192,
    "Min fused key cardinality before an ordered-limit group-by / topN "
    "runs its top-k selection on the device (a score sort over the "
    "per-key results, transferring only the candidate rows). Below it "
    "the full [K] result transfers and the host sorts.")
HAVING_DEVICE_MIN_KEYS = _entry(
    "sdot.engine.having.device.min.keys", 1 << 16,
    "Min fused key cardinality before an exact-comparable HAVING (one "
    "aggregate against an integer literal) is evaluated on the device: "
    "the finals stay on the device, only the passing count and then the "
    "passing groups travel to the host, which re-applies HAVING.")
SCAN_COMPACT = _entry(
    "sdot.engine.scan.compact", True,
    "Late materialization: when the filter-selectivity estimate says few "
    "rows survive, move the survivors to a static prefix and run "
    "group-key building, value derivation and aggregation at "
    "O(survivors) instead of O(rows). Overflow of the estimated budget "
    "retries uncompacted.")
SCAN_COMPACT_MIN_ROWS = _entry(
    "sdot.engine.scan.compact.min.rows", 1 << 21,
    "Scans below this many rows never compact (the partition pass wins "
    "nothing at small scale). 0 compacts every selective scan and skips "
    "the cost test.")
SELECT_DEVICE_MIN_ROWS = _entry(
    "sdot.select.device.min.rows", 1 << 17,
    "Min datasource rows before a select (raw scan) query evaluates its "
    "filter on the device (one mask pass, 32 rows per transferred "
    "word); below it the host numpy path runs. 0 forces the device path "
    "when a device filter exists.")

# --- shared-scan multi-query execution (parallel/sharedscan.py) --------------
SHAREDSCAN_ENABLED = _entry(
    "sdot.sharedscan.enabled", False,
    "Coalesce concurrent eligible queries (GroupBy / Timeseries / TopN) "
    "over the same datasource into ONE fused wave: the column union binds "
    "once, every constituent's filter and aggregation lanes run against "
    "the shared bind, and results demultiplex per query. Off by default: "
    "solo workloads pay the hold window for nothing.")
WLM_BATCH_WINDOW_MS = _entry(
    "sdot.wlm.batch.window.ms", 8.0,
    "Micro-batch hold window for the shared-scan tier: the first "
    "eligible query on a datasource holds this long for companions "
    "before dispatching (group-commit semantics). The window closes early "
    "when sdot.sharedscan.max.queries constituents have joined.", float)
SHAREDSCAN_MAX_QUERIES = _entry(
    "sdot.sharedscan.max.queries", 8,
    "Constituent cap per coalesced group: the hold window closes early "
    "at this size, bounding the fused program's width.")
SHAREDSCAN_FUSION_ENABLED = _entry(
    "sdot.sharedscan.fusion.enabled", True,
    "Cross-lane fusion planner (planner/fusion.py): each distinct "
    "sub-predicate of a fused group lowers ONCE (shared masks first, then "
    "per-lane base = row_valid & shared & residual). Bit-identical answers "
    "by construction; a planning error falls back to unfused lowering.")
SHAREDSCAN_FUSION_MAX_NODES = _entry(
    "sdot.sharedscan.fusion.max.nodes", 512,
    "Planner cost guard: per-group cap on distinct predicate nodes the "
    "fusion analysis canonicalizes; a group over the cap plans unfused. "
    "0 = uncapped.")
PALLAS_WAVE_ENABLED = _entry(
    "sdot.pallas.wave.enabled", True,
    "Shared-scan fused groups run each wave as ONE launch of the wave "
    "kernel (ops/cuda_wave.py, csrc/wave.cu) when every lane's dense "
    "aggregates ride the fused group-by kernel's tier: union columns are "
    "read once per row, shared predicates evaluate once per row, and all "
    "lanes' filtered aggregates accumulate in one launch. False runs the "
    "fused group lane by lane through ops/groupby.dense_groupby (kill "
    "switch). The key keeps the JAX package's name.")
PALLAS_WAVE_MAX_LANES = _entry(
    "sdot.pallas.wave.max.lanes", 16,
    "Max fused lanes (distinct constituent plans) one wave kernel "
    "launch accumulates; wider groups run lane by lane.", int)
CUDA_WAVE_SCRATCH_BYTES = _entry(
    "sdot.cuda.wave.scratch.bytes", 227 * 1024 - 1024,
    "Shared-memory budget (bytes) of one wave kernel block: the lane "
    "program and its descriptors, the per-warp partials of every lane's "
    "[n_keys x (dense aggregates + 1)] scratch slots (8 bytes each, 8 "
    "warps) and the warp staging area. A group that needs more is "
    "declined at build time (WaveFallback) and runs lane by lane. The "
    "port's counterpart of the JAX package's TPU VMEM budget "
    "sdot.pallas.wave.tile.bytes; values above the card's 227 KB opt-in "
    "limit less the static part are clamped to it.", int)


# --- SQL front end (sql/session.py, planner/) --------------------------------
DEBUG_TRANSFORMATIONS = _entry(
    "sdot.debug.transformations", False,
    "Log each planner transform's input and output (reference: "
    "spark.sparklinedata.druid.debug.transformations).")
NON_AGG_PUSHDOWN = _entry(
    "sdot.nonagg.handling", "push_project_and_filters",
    "Handling of non-aggregate queries: push_project_and_filters | "
    "push_filters | push_none (reference: NonAggregateQueryHandling, "
    "DruidRelationInfo.scala:27-32).")
ALLOW_TOPN = _entry(
    "sdot.querycostmodel.topn.allow", True,
    "Allow rewriting single-dim ordered-limit group-bys to the topN path "
    "(reference: spark.sparklinedata.druid.allow.topn).")
TOPN_THRESHOLD = _entry(
    "sdot.querycostmodel.topn.threshold", 100000,
    "Max limit value eligible for the topN rewrite (reference: "
    "spark.sparklinedata.druid.topn.threshold).")
DATABASE_DEFAULT = _entry(
    "sdot.database.default", "",
    "Default database namespace: an unqualified table name that is not "
    "registered resolves to '<default>.<name>' when that is. Databases "
    "are dotted name prefixes in the one store; 'db.table' in FROM "
    "always addresses explicitly.")
JOIN_ENABLED = _entry(
    "sdot.join.enabled", True,
    "General (non-star) joins execute on the device join tier when the "
    "statement shape qualifies; False routes every non-star join to the "
    "host fallback. The port recognizes such joins (planner/joinplan.py) "
    "and refuses to execute them until the join tier is ported.")
JOIN_BROADCAST_MAX_BYTES = _entry(
    "sdot.join.broadcast.max.bytes", 64 << 20,
    "Build-side byte ceiling for the broadcast device join tier; a "
    "bigger build side (with no cluster attached) goes to the host "
    "fallback. The port applies the JAX cost model's decision before it "
    "refuses the device tier.", int)
JOIN_MODE = _entry(
    "sdot.join.mode", "auto",
    "Join-tier placement override: 'auto' (cost model picks), "
    "'broadcast', 'partitioned', or 'host'.")
PHASES_ENABLED = _entry(
    "sdot.phases.enabled", True,
    "Per-query host-path phase profiler (utils/phases.py): attribute host "
    "time to named phases (parse, plan.*) emitted as stats[\"phases\"].",
    semantic=False)
PLAN_CACHE_ENABLED = _entry(
    "sdot.plan.cache.enabled", True,
    "Statement plan cache (pushdown + composite plans keyed on store "
    "version and config fingerprint).")
PLAN_MEMO_ENABLED = _entry(
    "sdot.plan.memo.enabled", True,
    "Memoize the planning-cascade outcome per canonical statement "
    "(window extraction, resolution, rewrites, built plan, join "
    "recognition, composite plan, negative outcomes included), keyed "
    "like the plan cache plus a lookup-table fingerprint.",
    semantic=False)
PLAN_MEMO_ENTRIES = _entry(
    "sdot.plan.memo.entries", 128,
    "Max memoized planning-cascade outcomes; least-recently-used "
    "statements evict past it.", int, semantic=False)
QUERY_HISTORY = _entry(
    "sdot.enable.query.history", True,
    "Record executed statements with timings into the bounded history "
    "queue (reference: spark.sparklinedata.enable.druid.query.history).")
QUERY_HISTORY_SIZE = _entry(
    "sdot.query.history.size", 500,
    "Bounded size of the in-memory query history queue (reference: "
    "DruidQueryHistory MAX_SIZE=500).")


class Config:
    """A mutable key-value session config over the registered entries."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = {}
        if overrides:
            for k, v in overrides.items():
                self.set(k, v)

    def set(self, key: str, value: Any) -> None:
        entry = _REGISTRY.get(key)
        if entry is not None and isinstance(value, str) \
                and not isinstance(entry.default, str):
            value = entry.parse(value)
        self._values[key] = value

    def fingerprint(self) -> tuple:
        """Hashable snapshot of the semantic overrides: plan and result
        caches key on it, so a config change never serves a plan built
        under the old settings. Operational keys (``semantic=False``) are
        left out; unknown keys are kept."""
        out = []
        for k, v in self._values.items():
            e = _REGISTRY.get(k)
            if e is not None and not e.semantic:
                continue
            out.append((k, repr(v)))
        return tuple(sorted(out))

    def is_set(self, entry_or_key) -> bool:
        """Whether the key was set explicitly (even to its default)."""
        key = entry_or_key.key if isinstance(entry_or_key, ConfigEntry) \
            else entry_or_key
        return key in self._values

    def get(self, entry_or_key) -> Any:
        if isinstance(entry_or_key, ConfigEntry):
            return self._values.get(entry_or_key.key, entry_or_key.default)
        entry = _REGISTRY.get(entry_or_key)
        if entry is not None:
            return self._values.get(entry.key, entry.default)
        return self._values.get(entry_or_key)
