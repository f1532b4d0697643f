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
DEVICE_CACHE_BYTES = _entry(
    "sdot.engine.device.cache.bytes", 8 << 30,
    "Budget for device-resident bound column arrays (host-side bytes "
    "tracked per upload). When a new binding would exceed it the whole "
    "array cache is dropped and rebuilt on demand.")
TOPN_DEVICE_MIN_KEYS = _entry(
    "sdot.engine.topn.device.min.keys", 8192,
    "Min fused key cardinality before an ordered-limit group-by / topN "
    "runs its top-k selection on the device (a score sort over the "
    "per-key results, transferring only the candidate rows). Below it "
    "the full [K] result transfers and the host sorts.")
HAVING_DEVICE_MIN_KEYS = _entry(
    "sdot.engine.having.device.min.keys", 1 << 16,
    "Min fused key cardinality at which the JAX engine evaluates an "
    "exact-comparable HAVING on the device; the port refuses such "
    "queries until that epilogue is ported (ROADMAP A.4).")

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
