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
BACKEND_RETRY_SECONDS = _entry(
    "sdot.engine.backend.retry.seconds", 30.0,
    "Cooldown between re-attach probes after the device is lost "
    "mid-session (a sticky CUDA error): statements are served by the host "
    "tier, and at most one probe per cooldown window checks whether the "
    "device answers again. After a sticky error no probe in that process "
    "succeeds: the device comes back with a new process.", float)
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
MESH_ENABLED = _entry(
    "sdot.mesh.enabled", True,
    "Shared-scan fused groups (parallel/sharedscan.py) shard their "
    "segment waves across the engine's mesh (parallel/meshexec.py): each "
    "slot scans its segment share, through the wave kernel when the "
    "group is wave-eligible, and the lanes' partials merge on the mesh's "
    "first device (sums add, extrema and HLL registers take the max or "
    "min, theta minima the min, KLL survivors the lex-min). False pins "
    "the fused tier and the broadcast join to one device (kill switch); "
    "solo statements keep their own cost-model decision either way.")
MESH_AUTO = _entry(
    "sdot.mesh.auto", False,
    "Build a mesh over every visible card at Context startup when more "
    "than one is visible (the in-process equivalent is "
    "Context(auto_mesh=True)).")
MESH_MIN_SEGMENTS = _entry(
    "sdot.mesh.min.segments", 2,
    "Minimum selected segments before the fused tier shards a group "
    "across the mesh; below it one device owns the whole scan.", int)
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


# --- semantic result cache (cache/) ------------------------------------------
CACHE_ENABLED = _entry(
    "sdot.cache.enabled", True,
    "Semantic query-result cache over engine aggregate results "
    "(cache/result_cache.py): identical queries are served from host "
    "memory without touching the device. Keys fold in the per-datasource "
    "ingest version, so staleness is structural: any re-ingest or drop "
    "invalidates.")
CACHE_MAX_BYTES = _entry(
    "sdot.cache.max_bytes", 256 << 20,
    "Byte budget for materialized results held by the semantic result "
    "cache; least-recently-used entries evict past it. Results larger "
    "than the whole budget are never admitted.")
CACHE_SUBSUMPTION = _entry(
    "sdot.cache.subsumption", True,
    "Answer queries from SUPERSET cached entries without re-executing "
    "(cache/subsume.py): coarser-granularity timeseries from a cached "
    "finer one, TopN and dim-filtered GroupBy from a cached "
    "unfiltered/unlimited GroupBy over the same dims, and "
    "having/limit/post-agg re-evaluation on cached partials.")

# --- workload management (wlm/) and its cost estimate (parallel/cost.py) -----
WLM_ENABLED = _entry(
    "sdot.wlm.enabled", True,
    "Admission control in front of the engine (wlm/): every query is "
    "classified into a named lane with bounded concurrency and queue "
    "depth; overload sheds with a retryable rejection instead of melting "
    "every in-flight query.", semantic=False)
WLM_LANES = _entry(
    "sdot.wlm.lanes",
    "interactive:slots=8,queue=64;reporting:slots=4,queue=32;"
    "batch:slots=2,queue=16",
    "Lane layout: 'name:slots=N,queue=N,wait_ms=N,timeout_ms=N,"
    "priority=N;...'. slots = concurrent queries in the lane, queue = "
    "bounded wait-queue depth past which admissions shed, wait_ms = max "
    "queue-wait budget (0 = only the query's own timeout bounds it), "
    "timeout_ms = default QueryContext timeout applied when the client "
    "set none, priority = default admission priority (higher first).",
    semantic=False)
WLM_DEFAULT_LANE = _entry(
    "sdot.wlm.default.lane", "interactive",
    "Lane for queries with no explicit context.lane (before cost-based "
    "demotion is considered).", semantic=False)
WLM_BATCH_COST = _entry(
    "sdot.wlm.batch.cost.threshold", 0.5,
    "Estimated single-device cost units (parallel/cost.estimate) at or "
    "above which a query without an explicit lane is demoted to the "
    "'batch' lane. 0 disables cost-based demotion. Per-tenant quotas "
    "ride the same config channel as free-form keys: "
    "'sdot.wlm.quota.<tenant>' = 'concurrent=N,budget=F,refill=F' "
    "('default' is the template for tenants without an explicit entry).",
    float, semantic=False)
COST_MODEL_ENABLED = _entry(
    "sdot.querycostmodel.enabled", True,
    "Use the cost model to pick single-device or sharded execution over "
    "the engine's mesh (parallel/cost.estimate, mesh_estimate); false "
    "always shards when a mesh of more than one slot is attached.")
COST_PER_ROW_SCAN = _entry(
    "sdot.querycostmodel.historical.processing.cost", 1e-8,
    "Abstract cost to scan and filter one row on one device "
    "(parallel/cost.estimate; the cost units WLM demotes and charges "
    "quotas in).", float)
COST_PER_ROW_MERGE = _entry(
    "sdot.querycostmodel.historical.merge.cost", 7e-8,
    "Abstract cost to merge one output row of one aggregate across the "
    "mesh's slots (parallel/cost.estimate and mesh_estimate); "
    "tools/calibrate.fit measures it from a mesh context's timings.",
    float)
COST_SHARD_EFFICIENCY = _entry(
    "sdot.querycostmodel.shard.efficiency", 1.0,
    "Parallel efficiency of the mesh's scan split in (0, 1]: 1.0 = N "
    "slots scan N-fold faster (N cards); slots that share one card "
    "split no bandwidth and measure far lower. Fit by "
    "tools/calibrate.fit from measured wall times.", float)
COST_PER_BYTE_TRANSPORT = _entry(
    "sdot.querycostmodel.transport.cost", 2.5e-9,
    "Abstract cost to move one byte of the result from the device to the "
    "host (parallel/cost.estimate).", float)
COST_PER_BYTE_INTERCONNECT = _entry(
    "sdot.querycostmodel.interconnect.cost", 5e-10,
    "Abstract cost to move one byte across the device interconnect (ICI) "
    "during the cross-chip merge of per-device partial aggregates — the "
    "mesh tier's analog of the reference's broker-merge transport term. "
    "Prices the reduction payload (merged partial bytes x (n_dev - 1)) "
    "so wide outputs on small scans correctly prefer single-device "
    "execution.", float)
COST_COMPILE = _entry(
    "sdot.querycostmodel.compile.cost", 0.05,
    "Fixed abstract cost charged per distinct program in explain's "
    "sharded price (parallel/cost.estimate); tools/calibrate.fit sets it "
    "to 0.", float)


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
    "General (non-star) joins execute on the device join tier "
    "(join/broadcast.py, join/partitioned.py) when the statement shape "
    "qualifies; False routes every non-star join to the host pandas "
    "fallback (kill switch: answers are identical, only placement "
    "changes).")
JOIN_BROADCAST_MAX_BYTES = _entry(
    "sdot.join.broadcast.max.bytes", 64 << 20,
    "Build-side byte ceiling for the broadcast hash-join tier: when the "
    "smaller side's estimated bytes fit, its hash table is built once, "
    "device-resident, and probed inside the segment wave loop. Bigger "
    "builds go to the cluster partitioned tier (when a broker is "
    "attached) or the host fallback.", int)
JOIN_MAX_MATCHES = _entry(
    "sdot.join.max.matches", 64,
    "Widest per-key duplicate group the device probe expands (the static "
    "match-expansion width C). A build side with a hotter key declines "
    "to the host fallback instead of materializing an oversized "
    "expansion.", int)
JOIN_PARTITIONS = _entry(
    "sdot.join.partitions", 0,
    "Hash-partition count for the cluster partitioned-join exchange "
    "(both sides re-shard on the join key through the historicals). "
    "0 = one partition per cluster node.", int)
JOIN_MODE = _entry(
    "sdot.join.mode", "auto",
    "Join-tier placement override: 'auto' (cost model picks), "
    "'broadcast', 'partitioned', or 'host' (device join tiers "
    "disabled for this statement shape only).")
WINDOW_ENABLED = _entry(
    "sdot.window.enabled", True,
    "Window-function post-pass (window/): OVER (PARTITION BY ... ORDER "
    "BY ...) computed by segment-sorted device functions over the "
    "grouped result frame. Off = window queries raise unsupported.")
WINDOW_MAX_FRAME = _entry(
    "sdot.window.max.frame", 1024,
    "Largest bounded ROWS frame (preceding + following + 1) the device "
    "window functions lower via shift-stacking; wider frames raise "
    "unsupported rather than materializing an unbounded shift stack.",
    int)
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
MODULES = _entry(
    "sdot.modules", "",
    "Comma-separated extension modules to install at Context creation, as "
    "package.module:ClassName (utils/modules.py; reference: "
    "spark.sparklinedata.modules via ModuleLoader).")
MV_REWRITE_ENABLED = _entry(
    "sdot.mv.rewrite.enabled", True,
    "Automatically rewrite eligible GroupBy queries onto a registered "
    "materialized rollup datasource (mv/match.py): grouping dims covered "
    "by the rollup dims (join-key equivalences count), merge-closed "
    "derivable aggregations, dim-only filters, cleanly-coarsening "
    "granularity. Stale rollups (base re-ingested since the build) are "
    "bypassed, never served.")
QUERY_HISTORY = _entry(
    "sdot.enable.query.history", True,
    "Record executed statements with timings into the bounded history "
    "queue (reference: spark.sparklinedata.enable.druid.query.history).")
QUERY_HISTORY_SIZE = _entry(
    "sdot.query.history.size", 500,
    "Bounded size of the in-memory query history queue (reference: "
    "DruidQueryHistory MAX_SIZE=500).")
# --- durable segment persistence (persist/) -----------------------------------
PERSIST_PATH = _entry(
    "sdot.persist.path", "",
    "Root directory of the on-disk snapshot store (deep storage). Empty "
    "disables persistence entirely: the segment store is volatile. Set to "
    "a directory to enable versioned checkpoints, the stream-ingest WAL, "
    "and startup recovery.")
# The next four are read only to refuse any value but their default: the
# port always persists when sdot.persist.path is set, recovers at start,
# and fsyncs every journaled batch through group commit.
PERSIST_ENABLED = _entry(
    "sdot.persist.enabled", True,
    "Persist when sdot.persist.path is set. Only true is accepted; an "
    "empty sdot.persist.path runs volatile.")
PERSIST_RECOVER = _entry(
    "sdot.persist.recover.on.start", True,
    "Recover published snapshots + WAL tails into the segment store at "
    "Context creation. Only true is accepted.")
PERSIST_WAL_FSYNC = _entry(
    "sdot.persist.wal.fsync", True,
    "fsync the write-ahead journal before a stream_ingest batch is "
    "considered committed. Only true is accepted (the kill -9 "
    "durability guarantee).", semantic=False)
PERSIST_CHECKPOINT_SECONDS = _entry(
    "sdot.persist.checkpoint.interval.seconds", 0.0,
    "Cadence of the background checkpointer folding dirty datasources "
    "into fresh snapshots. 0 disables the thread; CHECKPOINT statements "
    "and Context.checkpoint() still work.", float, semantic=False)
PERSIST_CHECKPOINT_MAX_BYTES = _entry(
    "sdot.persist.checkpoint.max.bytes", 0,
    "Byte budget for ONE background checkpoint pass: dirty datasources "
    "snapshot in ascending size order until the pass would exceed it; "
    "the rest stay dirty for the next tick. 0 = unbounded.", int,
    semantic=False)
PERSIST_KEEP_SNAPSHOTS = _entry(
    "sdot.persist.keep.snapshots", 2,
    "Published snapshot versions retained per datasource; older versions "
    "are pruned after each successful publish. Must be >= 1 (the current "
    "version is never pruned).", semantic=False)
PERSIST_VERIFY_CHECKSUMS = _entry(
    "sdot.persist.verify.checksums", True,
    "Verify per-file CRC32 checksums against the manifest during "
    "recovery. A mismatch quarantines that snapshot version and recovery "
    "falls back to the previous one (or the WAL alone).", semantic=False)
PERSIST_GROUP_COMMIT = _entry(
    "sdot.persist.wal.group.commit", True,
    "Route stream-ingest WAL appends through the shared commit queue: "
    "one fsync covers every frame queued by concurrent producers, and "
    "each ACK is released only after its covering fsync. Only true is "
    "accepted.", semantic=False)
PERSIST_COMPACT_SECONDS = _entry(
    "sdot.persist.compact.interval.seconds", 0.0,
    "Cadence of the background compactor rolling a stream-appended tail "
    "of many small segments into time-partitioned segments (atomic "
    "generation swap, no ingest-version bump). 0 disables the thread; "
    "PersistManager.compact() still works.", float, semantic=False)
PERSIST_COMPACT_MIN_SEGMENTS = _entry(
    "sdot.persist.compact.min.segments", 8,
    "Segment-count floor below which the compactor leaves a datasource "
    "alone.", int, semantic=False)
# --- compressed snapshot columns (encode/) ------------------------------------
ENCODE_ENABLED = _entry(
    "sdot.encode.enabled", False,
    "Write snapshot column blobs ENCODED (bit-packed dictionary codes, "
    "RLE runs, frame-of-reference+delta time columns, encode/codecs.py) "
    "with a per-column chooser at checkpoint/compaction time. Decoded "
    "arrays are bit-identical to the raw path.", semantic=False)
# --- host-tier safety valve ---------------------------------------------------
HOST_GATHER_PAGE_BYTES = _entry(
    "sdot.host.gather.page.bytes", 32 << 20,
    "Byte budget for ONE paged cross-process gather when "
    "Datasource.complete() reassembles a partial store's column on the "
    "host tier; larger columns exchange in multiple bounded pages "
    "instead of one unbounded allgather.")
# --- distributed serving tier (cluster/) --------------------------------------
CLUSTER_NODES = _entry(
    "sdot.cluster.nodes", "",
    "Comma-separated host:port list of historical nodes, index order = "
    "node id. Empty disables the cluster tier (single-process engine). "
    "Every process of one cluster — broker and historicals — must be "
    "given the identical list: the deterministic shard assignment "
    "(cluster/assign.py) is a pure function of this list plus the deep "
    "storage manifests.", semantic=False)
CLUSTER_ROLE = _entry(
    "sdot.cluster.role", "",
    "Role of THIS process in the cluster: 'broker' attaches the "
    "scatter/merge client to the engine; 'historical' is set by the "
    "cluster entrypoint on serving nodes; empty = not clustered.",
    semantic=False)
CLUSTER_NODE_ID = _entry(
    "sdot.cluster.node.id", 0,
    "This historical's index into sdot.cluster.nodes (which address it "
    "serves on and which shards it owns).", int, semantic=False)
CLUSTER_REPLICATION = _entry(
    "sdot.cluster.replication", 2,
    "Copies of each segment shard across historicals (clamped to the "
    "node count). The broker retries a failed shard on each replica "
    "before declaring the shard unreachable.", int, semantic=False)
CLUSTER_SHARDS = _entry(
    "sdot.cluster.shards", 0,
    "Segment shards per datasource the broker scatters over; 0 = one "
    "per node. Semantic: the shard composition fixes the partial-merge "
    "grouping (float accumulation order), so cached results are keyed "
    "on it.", int)
CLUSTER_RPC_TIMEOUT_SECONDS = _entry(
    "sdot.cluster.rpc.timeout.seconds", 30.0,
    "Socket timeout for one broker->historical subquery RPC. A timeout "
    "marks the node down and fails the attempt over to a replica.",
    float, semantic=False)
CLUSTER_RETRY_TRIES = _entry(
    "sdot.cluster.retry.tries", 3,
    "Full passes over a shard's replica set before the broker gives up "
    "on remote execution (then: local fallback if enabled, else fail). "
    "Between passes it sleeps with decorrelated-jitter backoff "
    "(utils/retry.py).", int, semantic=False)
CLUSTER_RETRY_BACKOFF_START_SECONDS = _entry(
    "sdot.cluster.retry.backoff.start.seconds", 0.05,
    "Base delay of the decorrelated-jitter backoff between replica-set "
    "passes.", float, semantic=False)
CLUSTER_RETRY_BACKOFF_CAP_SECONDS = _entry(
    "sdot.cluster.retry.backoff.cap.seconds", 2.0,
    "Delay ceiling of the decorrelated-jitter backoff between "
    "replica-set passes.", float, semantic=False)
CLUSTER_PROBE_INTERVAL_SECONDS = _entry(
    "sdot.cluster.probe.interval.seconds", 1.0,
    "Cadence of the broker's background health prober (GET /readyz on "
    "every node). A failing probe marks the node down — its shards "
    "route to replicas — and a passing one marks it back up. "
    "0 disables probing (nodes are still marked down reactively on "
    "RPC failure).", float, semantic=False)
CLUSTER_SCATTER_THREADS = _entry(
    "sdot.cluster.scatter.threads", 16,
    "Worker threads in the broker's scatter pool (concurrent subquery "
    "RPCs across all in-flight queries).", int, semantic=False)
CLUSTER_LOCAL_FALLBACK = _entry(
    "sdot.cluster.local.fallback", True,
    "When every replica of some shard is unreachable, execute the whole "
    "query on the broker's own engine (it holds a full recovered copy) "
    "instead of failing. Answers are identical; only placement changes.",
    semantic=False)
CLUSTER_PARTIAL_RESULTS = _entry(
    "sdot.cluster.partial.results", False,
    "Degraded mode: when every replica of some shard is unreachable, "
    "answer from the surviving shards and annotate the result with "
    "degraded={missing_shards, coverage_rows} instead of raising "
    "ShardUnavailable / falling back whole-query (this takes precedence "
    "over sdot.cluster.local.fallback for unreachable shards). Degraded "
    "answers are NEVER cached, so cached entries stay exact full "
    "answers and the key needs no new term.", semantic=False)
CLUSTER_BREAKER_FAILURES = _entry(
    "sdot.cluster.breaker.failures", 3,
    "Consecutive subquery failures against one node that open its "
    "circuit breaker (the broker then skips the node without an RPC "
    "until the cooldown elapses). 0 disables breakers.",
    int, semantic=False)
CLUSTER_BREAKER_COOLDOWN_SECONDS = _entry(
    "sdot.cluster.breaker.cooldown.seconds", 5.0,
    "How long an open breaker rejects attempts before letting ONE "
    "half-open probe RPC through; that probe's outcome closes or "
    "re-opens the breaker.", float, semantic=False)
CLUSTER_HEDGE_ENABLED = _entry(
    "sdot.cluster.hedge.enabled", False,
    "Hedged scatter: when a subquery RPC has not answered within the "
    "hedge delay, race a duplicate request to the next replica and take "
    "whichever answers first (the loser is discarded; replicas are "
    "exact copies, so answers are identical either way).",
    semantic=False)
CLUSTER_HEDGE_AFTER_MS = _entry(
    "sdot.cluster.hedge.after.ms", 0.0,
    "Fixed hedge delay in milliseconds; 0 = automatic (the observed "
    "subquery-latency quantile below, once enough samples exist).",
    float, semantic=False)
CLUSTER_HEDGE_QUANTILE = _entry(
    "sdot.cluster.hedge.quantile", 0.95,
    "Latency quantile of recent subquery RPCs used as the automatic "
    "hedge delay when sdot.cluster.hedge.after.ms is 0.",
    float, semantic=False)
CLUSTER_HEDGE_MIN_MS = _entry(
    "sdot.cluster.hedge.min.ms", 10.0,
    "Floor for the automatic hedge delay (keeps the quantile estimate "
    "from hedging every RPC while the sample window is still cold).",
    float, semantic=False)
CLUSTER_PROBE_JITTER = _entry(
    "sdot.cluster.probe.jitter", True,
    "Decorrelated jitter (utils/retry.backoff) on the background "
    "readyz prober's interval so N brokers don't probe a rejoining "
    "historical in lockstep; each tick lands in [0.5x, 1.5x] of "
    "sdot.cluster.probe.interval.seconds.", semantic=False)
# --- elastic topology: plan epochs (cluster/epoch.py) -------------------------
CLUSTER_EPOCH_POLL_SECONDS = _entry(
    "sdot.cluster.epoch.poll.seconds", 1.0,
    "Cadence at which a HISTORICAL polls deep storage for a newer plan "
    "epoch (cluster/epoch.py) and runs its side of the handover — warm "
    "newly owned shards before advertising, or drain-then-fence when "
    "the new epoch drops it. 0 disables the watcher thread (tests "
    "drive node.check_epoch() manually). The broker piggybacks its "
    "epoch check on the readyz prober interval.", float, semantic=False)
CLUSTER_EPOCH_DRAIN_GRACE_SECONDS = _entry(
    "sdot.cluster.epoch.drain.grace.seconds", 0.5,
    "How long a leaving historical keeps serving AFTER it observes the "
    "new epoch fully warm, before it starts draining — absorbs the "
    "window where the broker has not yet polled the same readiness and "
    "still scatters against the old epoch.", float, semantic=False)
CLUSTER_EPOCH_DRAIN_TIMEOUT_SECONDS = _entry(
    "sdot.cluster.epoch.drain.timeout.seconds", 10.0,
    "Upper bound a leaving historical waits for its in-flight "
    "subqueries to finish before fencing anyway (a stuck query must "
    "not pin a retired node forever).", float, semantic=False)
CLUSTER_REBALANCE_STRATEGY = _entry(
    "sdot.cluster.rebalance.strategy", "stable",
    "Shard owner placement: 'stable' (rendezvous hashing over logical "
    "node ids — an N->N+1 epoch moves ~1/(N+1) of the assignments, see "
    "cluster/assign.py) or 'modular' (the legacy CRC rotation, kept as "
    "a kill switch; nearly every owner moves on any topology change). "
    "Placement never changes answers, only which node serves a shard.",
    semantic=False)
CLUSTER_SUBQ_CACHE_ENABLED = _entry(
    "sdot.cluster.subq.cache.enabled", False,
    "Broker-side shard-level subquery result cache: partial results "
    "are cached per (subquery shape, shard identity, ingest version), "
    "so a repeated dashboard storm skips unchanged shards entirely. "
    "Keys carry shard identity — not node identity — so entries "
    "survive epoch transitions; the ingest-version term makes staleness "
    "impossible, so answers are bit-identical with the cache off. "
    "Opt-in: identical repeated queries are already absorbed by the "
    "broker's semantic result cache, and chaos/failover tests rely on "
    "repeats actually exercising the RPC path — enable it for mixed "
    "dashboard workloads whose queries share subquery shapes.",
    semantic=False)
CLUSTER_SUBQ_CACHE_MAX_BYTES = _entry(
    "sdot.cluster.subq.cache.max.bytes", 64 << 20,
    "Byte budget of the broker's shard-level subquery cache (LRU "
    "eviction).", int, semantic=False)
CLUSTER_INGEST_PUSH = _entry(
    "sdot.cluster.ingest.push", True,
    "Distributed ingest: after a stream-ingest batch is journaled and "
    "acknowledged on the broker (durability is ALWAYS local), push it "
    "to the time-matched shard's owners so distributed queries keep "
    "read-your-writes instead of falling back to broker-local serving "
    "until the next checkpoint. Off, or when any owner push fails, the "
    "broker's ingest-version check simply serves the datasource locally "
    "— never a correctness difference, only where the scan runs.",
    semantic=False)
CLUSTER_AUTOSCALE_ENABLED = _entry(
    "sdot.cluster.autoscale.enabled", False,
    "Autoscale hook (cluster/autoscale.py): the broker samples every "
    "historical's WLM queue depth on the prober cadence and calls the "
    "registered spawn/retire callbacks — which publish a new plan "
    "epoch — when the fleet-mean depth crosses the high/low marks. "
    "Without registered callbacks, decisions only increment counters "
    "(dry run).", semantic=False)
CLUSTER_AUTOSCALE_QUEUE_HIGH = _entry(
    "sdot.cluster.autoscale.queue.high", 8.0,
    "Fleet-mean WLM queued-query depth above which the autoscale hook "
    "signals scale-out (spawn a historical, publish an epoch adding "
    "it).", float, semantic=False)
CLUSTER_AUTOSCALE_QUEUE_LOW = _entry(
    "sdot.cluster.autoscale.queue.low", 0.5,
    "Fleet-mean WLM queued-query depth below which the autoscale hook "
    "signals scale-in (drain and retire one historical via a new "
    "epoch). Must be well under the high mark or the fleet flaps.",
    float, semantic=False)
CLUSTER_AUTOSCALE_COOLDOWN_SECONDS = _entry(
    "sdot.cluster.autoscale.cooldown.seconds", 30.0,
    "Minimum wall-clock spacing between autoscale decisions; epoch "
    "handovers in progress also suppress new signals.",
    float, semantic=False)
# --- deterministic fault injection (fault/) -----------------------------------
FAULT_PLAN = _entry(
    "sdot.fault.plan", "",
    "JSON FaultPlan ({\"seed\": S, \"rules\": [...]}) activating named "
    "injection sites in cluster RPC, persist I/O, the cold tier's reads "
    "and WLM admission. Empty (default) = every site is a zero-cost "
    "no-op.",
    semantic=False)
# --- out-of-core tiered storage (tier/) ---------------------------------------
TIER_ENABLED = _entry(
    "sdot.tier.enabled", False,
    "Recover datasources as TIERED stores: column bytes stay in the "
    "persist/ snapshot (cold tier) and fault on demand into a "
    "byte-budgeted hot set instead of loading eagerly at boot "
    "(tier/loader.py; requires sdot.persist.path). Consulted once, at "
    "recovery.", semantic=False)
TIER_BUDGET_BYTES = _entry(
    "sdot.tier.budget.bytes", 2 << 30,
    "Byte budget of the hot set (per process). Chunks over budget evict "
    "by query-history popularity, oldest touch first; chunks pinned by "
    "in-flight queries never evict, so peak residency is budget + "
    "in-flight bytes.", int, semantic=False)
TIER_VERIFY_CHECKSUMS = _entry(
    "sdot.tier.verify.checksums", True,
    "Verify each cold blob's CRC32 against the manifest on the FIRST "
    "fault that touches it (recovery itself only checks structure, "
    "keeping boot O(manifest)). A mismatch quarantines the snapshot "
    "version and re-recovers per PERSIST semantics.", semantic=False)
TIER_PREFETCH_ENABLED = _entry(
    "sdot.tier.prefetch.enabled", True,
    "Run the cold-tier prefetcher threads: the wave loop enqueues wave "
    "i+2's chunks while wave i computes on the device, hiding cold loads "
    "behind dispatch. Demand faults serve everything when disabled.",
    semantic=False)
TIER_PREFETCH_THREADS = _entry(
    "sdot.tier.prefetch.threads", 2,
    "Prefetcher worker threads draining the cold-load queue.",
    int, semantic=False)
TIER_DECODED_CACHE_BYTES = _entry(
    "sdot.tier.decoded.cache.bytes", 128 << 20,
    "Byte budget of the decode-ahead cache: decoded arrays of hot ENCODED "
    "chunks, accounted at decoded size on top of the encoded hot set. "
    "The prefetcher decodes into it and demand faults serve from it "
    "(stats[\"tier\"][\"decode_ms_saved\"]). Decoded entries evict "
    "before any encoded payload. 0 disables decode-ahead; raw stores are "
    "unaffected.", int, semantic=False)
TIER_WAVE_IO_BYTES = _entry(
    "sdot.tier.wave.io.bytes", 256 << 20,
    "Per-wave host-I/O byte cap on a tiered scan (the wave planner's I/O "
    "term, parallel/cost.tier_io_budget): forces enough waves that "
    "prefetch can overlap loads with compute. 0 disables the term. "
    "Semantic: changes the wave composition and with it float "
    "accumulation order.", int)


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
        under the old settings. Operational keys (``semantic=False``) and
        the tenant quota family are left out; unknown keys are kept."""
        out = []
        for k, v in self._values.items():
            e = _REGISTRY.get(k)
            if e is not None and not e.semantic:
                continue
            if k.startswith("sdot.wlm.quota."):
                continue    # dynamic family, admission-only
            out.append((k, repr(v)))
        return tuple(sorted(out))

    def prefixed(self, prefix: str) -> Dict[str, Any]:
        """Every explicitly-set key under ``prefix`` (free-form families
        such as ``sdot.wlm.quota.<tenant>`` ride the unknown-key channel
        and enumerate themselves this way)."""
        return {k: v for k, v in self._values.items()
                if k.startswith(prefix)}

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
