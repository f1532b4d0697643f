"""Cross-lane fusion planning: predicate CSE for shared-scan programs.

Port of ``spark_druid_olap_tpu/planner/fusion.py`` (``canon_key``,
``interval_key``, ``FusionPlan``, ``plan_lanes``, ``analyze_query``,
``plan_device_waves``, ``CSECache``), torch-free and bound to the port's
``ops/filters.py``. Its ``plan_wave_tiles`` (a TPU VMEM and f32-exactness
tile planner) has no counterpart: the port's wave kernel accumulates in
int64 / float64 and sizes its shared memory in ``ops/cuda_wave.py``.

Two halves that must agree:

- ``plan_lanes`` / ``analyze_query`` — host-side analysis over the
  ``FilterSpec`` trees. Canonicalizes every sub-predicate (AND/OR operand
  order folded, so commuted trees unify), counts total vs. distinct
  evaluations, and produces deterministic counters
  (``shared_predicates``, ``predicate_evals_saved``,
  ``column_streams_saved``) plus a program-cache token. Runs on every
  fused execution, warm program-cache runs included.
- ``CSECache`` — trace-time memoizing wrapper over
  ``ops.filters.lower_filter`` bound to one ``ScanContext``. Logical
  nodes recurse *through* the cache, so a shared sub-predicate lowers
  once and every consumer reuses the same mask. Masks combine with
  ``&``/``|``/``~`` only, which are exact on bool tensors, so CSE'd
  programs are bit-identical to unfused ones.

Planning is advisory: any planning error makes the caller lower the
unfused way, and ``CSECache`` replicates ``lower_filter``'s semantics node
for node, including the OR-of-all-true -> all-true (None) short circuit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.ops import filters as F

# canonical key of the "no filter" / all-true node; never cached (lowering
# None is free) but it must not collide with a real node's key
_TRUE_KEY = "\x00T"


def canon_key(f: Optional[S.FilterSpec]) -> str:
    """Deterministic canonical form of a filter subtree. AND/OR operand
    keys sort, so ``a AND b`` and ``b AND a`` share one key (bool masks
    combine exactly, so reusing either lowering is bit-identical). NOT
    and leaves keep structural ``repr`` — every FilterSpec is a frozen
    dataclass of plain values (large IN-sets repr as their digest via
    ``FrozenIntSet``), so ``repr`` is value-based and O(1)-ish."""
    if f is None:
        return _TRUE_KEY
    if isinstance(f, S.LogicalFilter):
        ks = [canon_key(x) for x in f.fields]
        if f.op in ("and", "or"):
            ks.sort()
        return "(" + f.op + " " + " ".join(ks) + ")"
    return repr(f)


def interval_key(intervals) -> Optional[str]:
    """Pseudo-node key for a lane's residual time-interval mask (the
    intervals tuple lowers as one unit in ``ops.filters.interval_mask``)."""
    if not intervals:
        return None
    return "(iv " + repr(tuple(intervals)) + ")"


def _walk(f: Optional[S.FilterSpec], seen: set,
          totals: List[int]) -> None:
    """Simulate one memoized lowering of ``f``: every node requests once
    per occurrence (totals[0]), but a cached subtree stops the descent —
    exactly what ``CSECache.lower`` does at trace time."""
    if f is None:
        return
    totals[0] += 1
    k = canon_key(f)
    if k in seen:
        return
    seen.add(k)
    if isinstance(f, S.LogicalFilter):
        for x in f.fields:
            _walk(x, seen, totals)


def _lane_keys(f: Optional[S.FilterSpec], out: set) -> None:
    """All distinct sub-predicate keys of one lane's tree."""
    if f is None:
        return
    out.add(canon_key(f))
    if isinstance(f, S.LogicalFilter):
        for x in f.fields:
            _lane_keys(x, out)


# one fused lane's predicate surface: (root filter, intervals tuple,
# per-aggregation filters in declaration order)
LaneExprs = Tuple[Optional[S.FilterSpec], Optional[tuple],
                  Tuple[Optional[S.FilterSpec], ...]]


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    """Host-side CSE analysis of a fused group. All counters are exact
    functions of the (sorted) lane set, never of arrival order or
    program-cache warmth."""
    n_lanes: int
    # predicate lowering REQUESTS under memoization (a request that hits
    # the cache stops the descent, so a duplicated deep subtree counts
    # once — the counter is conservative) vs. the distinct sub-predicates
    # the fused program actually evaluates
    n_nodes: int
    n_distinct: int
    shared_predicates: int         # distinct sub-predicates used by >= 2 lanes
    predicate_evals_saved: int     # n_nodes - n_distinct (= CSE cache hits)
    column_streams_saved: int      # sum(per-lane columns) - union columns
    # representative nodes for the cross-lane shared sub-predicates, in
    # canonical-key order: the builder lowers these FIRST so shared masks
    # materialize once before any lane's residual combine
    shared_nodes: Tuple[S.FilterSpec, ...] = ()
    shared_intervals: Tuple[tuple, ...] = ()

    def token(self) -> tuple:
        """Folded into the fused-program compile signature. The plan is a
        pure function of the sorted lane set, so identical groups (any
        arrival order) produce identical tokens."""
        return ("fusion", self.n_lanes, self.n_nodes, self.n_distinct,
                self.shared_predicates, self.column_streams_saved)

    def counters(self) -> dict:
        return {"shared_predicates": self.shared_predicates,
                "predicate_evals_saved": self.predicate_evals_saved,
                "predicate_evals_total": self.n_nodes,
                "column_streams_saved": self.column_streams_saved}


def plan_lanes(lanes: Sequence[LaneExprs],
               per_lane_cols: Sequence[int],
               union_cols: int,
               max_nodes: int = 0) -> FusionPlan:
    """Analyze a fused group's lanes (already deduped + sorted by plan
    signature by the caller). Raises on anything unexpected — the caller
    treats any exception as "plan unfused"."""
    seen: set = set()
    totals = [0]
    per_lane_sets: List[set] = []
    node_budget = 0
    for (filt, intervals, agg_filters) in lanes:
        lane_set: set = set()
        _lane_keys(filt, lane_set)
        for af in agg_filters:
            _lane_keys(af, lane_set)
        ik = interval_key(intervals)
        if ik is not None:
            lane_set.add(ik)
        node_budget += len(lane_set)
        if max_nodes and node_budget > max_nodes:
            raise ValueError(
                f"fusion plan over sdot.sharedscan.fusion.max.nodes "
                f"({node_budget} > {max_nodes})")
        per_lane_sets.append(lane_set)
        # memoized-traversal simulation, in the builder's lowering order
        _walk(filt, seen, totals)
        if ik is not None:
            totals[0] += 1
            seen.add(ik)   # interval tuples cache whole, never descend
        for af in agg_filters:
            _walk(af, seen, totals)
    n_distinct = len(seen)
    n_nodes = totals[0]

    counts: Dict[str, int] = {}
    for lane_set in per_lane_sets:
        for k in lane_set:
            counts[k] = counts.get(k, 0) + 1
    shared = {k for k, c in counts.items() if c >= 2}

    # representative spec node per shared key (filters only; shared
    # interval tuples are tracked separately so the builder can prelower
    # them through the interval cache)
    reps: Dict[str, S.FilterSpec] = {}
    iv_reps: Dict[str, tuple] = {}

    def _collect(f: Optional[S.FilterSpec]) -> None:
        if f is None:
            return
        k = canon_key(f)
        if k in shared and k not in reps:
            reps[k] = f
        if isinstance(f, S.LogicalFilter):
            for x in f.fields:
                _collect(x)

    for (filt, intervals, agg_filters) in lanes:
        _collect(filt)
        for af in agg_filters:
            _collect(af)
        ik = interval_key(intervals)
        if ik is not None and ik in shared and ik not in iv_reps:
            iv_reps[ik] = tuple(intervals)

    saved = n_nodes - n_distinct
    streams_saved = max(0, int(sum(per_lane_cols)) - int(union_cols))
    return FusionPlan(
        n_lanes=len(lanes), n_nodes=n_nodes, n_distinct=n_distinct,
        shared_predicates=len(shared), predicate_evals_saved=saved,
        column_streams_saved=streams_saved,
        shared_nodes=tuple(reps[k] for k in sorted(reps)),
        shared_intervals=tuple(iv_reps[k] for k in sorted(iv_reps)))


def analyze_query(filter_spec: Optional[S.FilterSpec], intervals,
                  agg_filters: Sequence[Optional[S.FilterSpec]]
                  ) -> Tuple[int, int]:
    """(total_evals, distinct_evals) for ONE query's predicate surface —
    the solo-path CSE accounting (a single query's tree repeats
    sub-predicates too: OR-of-bounds over one column, one filtered
    aggregation per month over a shared selector, ...)."""
    seen: set = set()
    totals = [0]
    _walk(filter_spec, seen, totals)
    ik = interval_key(intervals)
    if ik is not None:
        totals[0] += 1
        seen.add(ik)
    for af in agg_filters:
        _walk(af, seen, totals)
    return totals[0], len(seen)


def plan_device_waves(seg_idx, spw: int, n_dev: int,
                      seg_rows=None) -> list:
    """Partition a segment selection into dispatch waves of ``spw``
    slots and, within each wave, order the segments so the mesh's
    contiguous per-device blocks (``spw / n_dev`` slots each) carry
    balanced ROW loads: greedy LPT over per-segment valid-row counts
    (``seg_rows``: segment id -> valid rows; None keeps the original
    order). Correctness-neutral: each wave holds the same segment set and
    the merge is grouping-invariant. On one device (``n_dev`` 1) it is
    the plain split. The JAX package's ``plan_device_waves``, verbatim.

    Returns the list of per-wave segment-id arrays (the last one possibly
    short: the bind pads it to ``spw``)."""
    import numpy as _np
    seg_idx = _np.asarray(seg_idx)
    waves = [seg_idx[i: i + spw] for i in range(0, len(seg_idx), spw)]
    if n_dev <= 1 or seg_rows is None:
        return waves
    per_dev = max(1, spw // max(1, n_dev))
    out = []
    for w in waves:
        rows = _np.array([int(seg_rows.get(int(s), 0)) for s in w],
                         dtype=_np.int64)
        order = _np.argsort(-rows, kind="stable")
        buckets: list = [[] for _ in range(n_dev)]
        loads = _np.zeros(n_dev, dtype=_np.int64)
        for j in order:
            free = [d for d in range(n_dev) if len(buckets[d]) < per_dev]
            if not free:
                free = list(range(n_dev))
            d = min(free, key=lambda k: (int(loads[k]), k))
            buckets[d].append(int(w[j]))
            loads[d] += int(rows[j])
        out.append(_np.array([s for b in buckets for s in b],
                             dtype=w.dtype))
    return out


class CSECache:
    """Memoizing filter lowering bound to ONE ScanContext. Logical nodes
    recurse through the cache (plain ``lower_filter`` would recurse past
    it), leaves delegate to ``ops.filters``. A cached ``None`` (all-true)
    is a real entry — presence is tested with ``in``, not truthiness.

    MUST be rebuilt whenever the context changes shape (the late-
    materialization path swaps ``ScanContext`` for ``CompactScanContext``
    mid-core: masks from the full-width context cannot combine with
    compacted lanes)."""

    __slots__ = ("ctx", "_masks", "hits", "misses")

    def __init__(self, ctx):
        self.ctx = ctx
        self._masks: Dict[str, object] = {}
        self.hits = 0
        self.misses = 0

    def lower(self, f: Optional[S.FilterSpec]):
        if f is None:
            return None
        k = canon_key(f)
        if k in self._masks:
            self.hits += 1
            return self._masks[k]
        self.misses += 1
        if isinstance(f, S.LogicalFilter):
            m = self._logical(f)
        else:
            m = F.lower_filter(f, self.ctx)
        self._masks[k] = m
        return m

    def _logical(self, f: S.LogicalFilter):
        # mirrors ops.filters._logical exactly, with child lowering
        # routed back through the cache
        if f.op == "not":
            inner = self.lower(f.fields[0])
            return self.ctx.row_valid() if inner is None else ~inner
        masks = [self.lower(x) for x in f.fields]
        if f.op == "or":
            if not masks or any(m is None for m in masks):
                return None
        else:
            masks = [m for m in masks if m is not None]
            if not masks:
                return None
        out = masks[0]
        for m in masks[1:]:
            out = (out & m) if f.op == "and" else (out | m)
        return out

    def interval(self, intervals):
        """Memoized ``ops.filters.interval_mask`` (lanes sharing a time
        window share the residual mask)."""
        k = interval_key(intervals)
        if k is None:
            return None
        if k in self._masks:
            self.hits += 1
            return self._masks[k]
        self.misses += 1
        m = F.interval_mask(intervals, self.ctx)
        self._masks[k] = m
        return m

    def prelower(self, plan: FusionPlan) -> None:
        """Materialize the cross-lane shared masks FIRST (canonical-key
        order); every lane's residual combine is then cache hits plus
        lane-private leaves."""
        for node in plan.shared_nodes:
            self.lower(node)
        for iv in plan.shared_intervals:
            self.interval(iv)
