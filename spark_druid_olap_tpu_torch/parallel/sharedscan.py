"""Shared-scan multi-query execution: coalesce concurrent eligible queries
over one datasource into ONE fused wave.

Port of ``spark_druid_olap_tpu/parallel/sharedscan.py`` on a single
device. A BI-dashboard storm is K small concurrent queries over
the same columns; executed solo, they pay K reads of those columns and K
launches. Here:

- The first eligible query on a datasource becomes the *leader* of an open
  group and holds for ``sdot.wlm.batch.window.ms``; companions arriving in
  the window join as *followers* and park on an event. The window closes
  early at ``sdot.sharedscan.max.queries`` members.
- At close, the leader plans every member against the union segment
  selection, binds the COLUMN UNION of the group once (through the
  engine's device-array cache), runs one fused program and demultiplexes
  the per-query results. A union over the per-device wave budget
  (``sdot.engine.wave.max.bytes``) runs as waves of segments instead:
  one uncached bind and one program dispatch per wave, the next wave's
  copy in flight while the current one computes, each lane's finals
  merged across the waves on the host.
- The fused program is one launch of the wave kernel (``ops/cuda_wave.py``,
  ``csrc/wave.cu``) per wave when the group is wave-eligible, with the
  sketches the kernel's theta stripe does not hold in its epilogue;
  otherwise (the
  kernel switched off, a lane outside the fused group-by tier, a lane
  program the kernel does not run) the group stays fused and runs lane by
  lane through ``ops/groupby.dense_groupby`` and the sketch register ops
  over the shared bind. Build-time declines count in ``wave_fallbacks``
  with their reason.
- Members that cannot ride at all (hashed-tier cardinality, an empty
  prune, a filter, expression or sketch input the port does not lower)
  run solo on their own threads; that is a plan-time routing decision,
  counted in ``fallbacks``.

On purpose unlike the JAX package, an exception raised by the fused path
after planning (a kernel build, launch or CUDA error, or a bug) is
delivered to every member that rides the group instead of degrading them
to solo runs, so a failing kernel can never hide behind the solo path.

Members are re-checked for their own cancel and deadline while held
(the leader while it holds the window, followers while parked, each
member again at close): a cancelled or timed-out member drops out with
its error, and the rest ride on. A cancel or deadline of the member whose
checks the dispatch runs (the first rider) at a dispatch or wave
boundary raises in that member only; the others run solo, as in the JAX
package. WLM hands queued statements into an open group
(``open_group_hint``, ``note_handoff``), and the result cache sits above
``run``, so each constituent populates its own key. The solo path counts
no CSE, so the JAX package's ``note_solo_cse`` has no counterpart.

With a mesh on the engine (``parallel/mesh.py``) each fused group runs
the mesh tier's static precheck (``parallel/meshexec.decide``: every
disqualifying condition keeps the group on one device with a named
reason). A sharded group binds its union per slot, each slot runs the
group's program (one launch of the wave kernel per slot per wave, or the
lane-by-lane program) over its share of the wave, and the lanes' partials
merge on the mesh's first device (``meshexec.build_sharded_program``).
The per-slot partials a wave loop holds are accounted in
``meshexec.LEDGER`` (acquired and released around the wave loop), and
``stats()["mesh"]`` reports the groups, dispatches, merge bytes,
fallbacks by reason and the ledger.
"""

from __future__ import annotations

import dataclasses
import threading
import time as _time
from typing import Dict, List, Optional

import numpy as np
import torch

from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.ops import cuda_wave as CW
from spark_druid_olap_tpu_torch.ops import filters as F
from spark_druid_olap_tpu_torch.ops import groupby as G
from spark_druid_olap_tpu_torch.ops import time_ops as T
from spark_druid_olap_tpu_torch.ops.scan import (
    ScanContext,
    array_dtype,
    array_names,
)
from spark_druid_olap_tpu_torch.ops.sketch import (
    SKETCH_KINDS,
    sketch_registers,
)
from spark_druid_olap_tpu_torch.parallel import meshexec as MX
from spark_druid_olap_tpu_torch.parallel.mesh import mesh_size
from spark_druid_olap_tpu_torch.planner import fusion as FU
from spark_druid_olap_tpu_torch.result import QueryResult
from spark_druid_olap_tpu_torch.utils.config import (
    CUDA_WAVE_SCRATCH_BYTES,
    GROUPBY_DENSE_MAX_KEYS,
    GROUPBY_PALLAS_MAX_KEYS,
    GROUPBY_SORTED_MIN_KEYS,
    HLL_LOG2M,
    PALLAS_WAVE_ENABLED,
    PALLAS_WAVE_MAX_LANES,
    QUANTILE_LANES,
    SHAREDSCAN_ENABLED,
    SHAREDSCAN_FUSION_ENABLED,
    SHAREDSCAN_FUSION_MAX_NODES,
    SHAREDSCAN_MAX_QUERIES,
    TZ_ID,
    WLM_BATCH_WINDOW_MS,
)

# a member's outcome slot: None = pending, _FALLBACK = run solo on the
# member's own thread, an exception instance = raise it there, anything
# else = the demultiplexed QueryResult
_FALLBACK = object()


# how often a parked follower re-checks its own cancel and deadline
_WAIT_POLL_S = 0.02


class _Member:
    __slots__ = ("q", "t0", "leader", "event", "outcome", "stats", "tok")

    def __init__(self, q, t0, leader: bool, tok=None):
        self.q = q
        self.t0 = t0
        self.leader = leader
        self.event = threading.Event()
        self.outcome = None
        self.stats = None
        self.tok = tok               # the member's in-flight registry row


class _Group:
    __slots__ = ("gid", "ds_name", "members", "state", "close_ev")

    def __init__(self, gid: int, ds_name: str):
        self.gid = gid
        self.ds_name = ds_name
        self.members: List[_Member] = []
        self.state = "open"          # open -> closing -> closed
        self.close_ev = threading.Event()


class _LanePlan:
    """One fused-program lane: the planned form of one distinct
    constituent spec (members sharing a plan signature share a lane)."""

    __slots__ = ("q", "sig", "dims", "aggs", "post", "having", "limit",
                 "gran", "seg", "dim_plans", "agg_plans", "n_keys",
                 "routes", "needed", "time_in_play", "names")

    def __init__(self, q, sig, dims, aggs, post, having, limit, gran, seg):
        self.q = q
        self.sig = sig
        self.dims = dims
        self.aggs = aggs
        self.post = post
        self.having = having
        self.limit = limit
        self.gran = gran
        self.seg = seg


def _cache_repr(q) -> str:
    """repr(q) with the per-request QueryContext stripped: a query id or a
    timeout never shapes the program."""
    return repr(dataclasses.replace(q, context=None))


def _bind_bytes(ds, names, n_segments: int) -> int:
    return sum(n_segments * ds.padded_rows
               * np.dtype(array_dtype(ds, k)).itemsize for k in names)


class SharedScanCoalescer:
    """One per QueryEngine. ``run`` replaces ``_execute_inner`` for
    eligible queries."""

    def __init__(self, engine):
        self.engine = engine
        self._lock = threading.Lock()
        self._groups: Dict[str, _Group] = {}
        self._next_gid = 0
        # (datasource id, lane signature, day basis) -> lowers on the port
        self._lowerable: Dict[tuple, bool] = {}
        # monotone counters
        self.groups_coalesced = 0     # groups that ran >= 2 fused lanes
        self.solo_groups = 0          # window closed with one live member
        self.queries_coalesced = 0    # constituents served by fused runs
        self.fallbacks = 0            # members routed to solo execution
        self.binds_saved_bytes = 0
        self.dispatches_saved = 0
        self.wlm_handoffs = 0         # queued waiters bypassed into groups
        # fusion planner (planner/fusion.py), ticked on every fused run
        self.fusion_groups = 0
        self.fusion_fallbacks = 0     # planning errors -> unfused lowering
        self.fusion_shared_predicates = 0
        self.fusion_predicate_evals_saved = 0
        self.fusion_predicate_evals_total = 0
        self.fusion_column_streams_saved = 0
        # the solo path's own repeated sub-predicates (note_solo_cse)
        self.fusion_solo_evals_saved = 0
        self.fusion_solo_evals_total = 0
        # wave kernel (ops/cuda_wave.py): one launch per fused wave when
        # the group is wave-eligible; fallbacks count programs built lane
        # by lane while the kernel was enabled, by reason
        self.wave_launches = 0
        self.wave_fallbacks = 0
        self.wave_fallback_reasons: Dict[str, int] = {}
        self.wave_smem_peak = 0
        # the mesh tier (parallel/meshexec.py): groups dispatched over the
        # mesh's slots, their dispatches and merge bytes (from route
        # metadata), and the groups kept on one device, by reason
        self.mesh_groups = 0
        self.mesh_dispatches = 0
        self.mesh_collective_bytes = 0
        self.mesh_fallbacks: Dict[str, int] = {}

    # -- eligibility ----------------------------------------------------------
    def enabled(self) -> bool:
        return bool(self.engine.config.get(SHAREDSCAN_ENABLED))

    def should_try(self, q) -> bool:
        """Cheap pre-gate: spec shapes the fused tier can demultiplex."""
        return self.enabled() and isinstance(
            q, (S.GroupByQuerySpec, S.TimeseriesQuerySpec, S.TopNQuerySpec))

    def open_group_hint(self, datasource) -> bool:
        """True when an open group on ``datasource`` still has room: the
        WLM poll loop then hands a queued compatible query to the
        coalescer instead of draining it serially."""
        if not self.enabled() or datasource is None:
            return False
        maxq = int(self.engine.config.get(SHAREDSCAN_MAX_QUERIES))
        with self._lock:
            g = self._groups.get(datasource)
            return g is not None and g.state == "open" \
                and len(g.members) < maxq

    def note_handoff(self) -> None:
        """Called by the WLM poll loop (under its own lock, which comes
        first) when a queued waiter bypasses its lane to ride an open
        group's dispatch."""
        with self._lock:
            self.wlm_handoffs += 1

    def note_solo_cse(self, saved: int, total: int) -> None:
        """Called by the solo executor path's plan-time CSE accounting
        (one query's own tree repeating sub-predicates)."""
        with self._lock:
            self.fusion_solo_evals_saved += int(saved)
            self.fusion_solo_evals_total += int(total)

    # -- group membership -----------------------------------------------------
    def run(self, q, t0: float) -> QueryResult:
        """Join (or lead) the open group for q's datasource; return the
        demultiplexed result, or run solo."""
        eng = self.engine
        window_s = max(0.0,
                       float(eng.config.get(WLM_BATCH_WINDOW_MS)) / 1000.0)
        maxq = max(1, int(eng.config.get(SHAREDSCAN_MAX_QUERIES)))
        tok = getattr(eng._tls, "inflight_tok", None)
        with self._lock:
            g = self._groups.get(q.datasource)
            if g is not None and g.state == "open" and len(g.members) < maxq:
                m = _Member(q, t0, leader=False, tok=tok)
                g.members.append(m)
                if len(g.members) >= maxq:
                    g.state = "closing"
                    g.close_ev.set()
            else:
                self._next_gid += 1
                g = _Group(self._next_gid, q.datasource)
                m = _Member(q, t0, leader=True, tok=tok)
                g.members.append(m)
                self._groups[q.datasource] = g

        if m.leader:
            self._hold_window(g, m, window_s)
            with self._lock:
                g.state = "closed"
                if self._groups.get(q.datasource) is g:
                    del self._groups[q.datasource]
                members = list(g.members)
            self._close_group(g, members)
        else:
            while not m.event.wait(_WAIT_POLL_S):
                # the follower's OWN cancel or deadline while parked; a
                # late outcome into an abandoned slot is harmless
                eng._stage_check(q, t0)

        out = m.outcome
        if out is _FALLBACK:
            return eng._execute_inner(q, t0)
        if isinstance(out, BaseException):
            raise out
        if m.stats:
            eng.last_stats.update(m.stats)
        eng.last_stats["total_ms"] = (_time.perf_counter() - t0) * 1000
        return out

    def _hold_window(self, g: _Group, m: _Member, window_s: float) -> None:
        """Leader parks for the micro-batch window (early close when the
        group fills, or when the leader's own cancel or deadline fires:
        held time counts against timeout_millis)."""
        deadline = _time.perf_counter() + window_s
        while not g.close_ev.is_set():
            rem = deadline - _time.perf_counter()
            if rem <= 0:
                break
            g.close_ev.wait(min(rem, 0.005))
            try:
                self.engine._stage_check(m.q, m.t0)
            except BaseException:  # noqa: BLE001 — _close_group drops it
                break

    def _close_group(self, g: _Group, members: List[_Member]) -> None:
        """Runs on the leader's thread. Every member gets an outcome and
        (followers) a set event, no matter what: a member cancelled or
        timed out while held gets its error and drops out before the
        plan; members the plan routes solo get _FALLBACK; an exception of
        the fused path reaches every member that rides the group."""
        live = []
        for m in members:
            try:
                self.engine._stage_check(m.q, m.t0)
                live.append(m)
            except BaseException as e:  # noqa: BLE001 — its outcome
                m.outcome = e
        fused_tried = len(live) >= 2
        try:
            if fused_tried:
                self._run_fused(g, live)
            else:
                with self._lock:
                    self.solo_groups += 1
        except BaseException as e:  # noqa: BLE001 — delivered as outcome
            for m in live:
                if m.outcome is None:
                    m.outcome = e
        finally:
            n_fallback = 0
            for m in members:
                if m.outcome is None:
                    m.outcome = _FALLBACK
                if m.outcome is _FALLBACK and fused_tried:
                    n_fallback += 1
                if not m.leader:
                    m.event.set()
            if n_fallback:
                with self._lock:
                    self.fallbacks += n_fallback

    # -- fused planning + execution -------------------------------------------
    def _run_fused(self, g: _Group, live: List[_Member]) -> None:
        """Plan every member against the union segment selection, build or
        fetch ONE program keyed on the sorted tuple of lane signatures,
        bind the column union once, dispatch, and demultiplex. Members the
        plan declines get _FALLBACK (solo); the rest ride."""
        from spark_druid_olap_tpu_torch.parallel import executor as X
        eng = self.engine
        t_plan = _time.perf_counter()

        def solo(ms):
            for m in ms:
                m.outcome = _FALLBACK

        try:
            ds = eng.store.get(live[0].q.datasource)
        except Exception:  # noqa: BLE001 — the solo path reports the error
            return solo(live)
        if ds.is_partial or ds.num_rows == 0:
            # a partial store is never coalesced: each member runs solo
            # over the multi-process mesh, in the order the ranks agree on
            return solo(live)

        # 1-3. shape and prune, the union's day basis, plan the lanes
        plans, seg_u, min_day, max_day = self._plan_members(
            ds, [m.q for m in live])
        planned = []
        for m, lp in zip(live, plans):
            if lp is None:
                m.outcome = _FALLBACK
            else:
                planned.append((m, lp))
        if len(planned) < 2:
            return solo(m for m, _ in planned)

        # 4. dedup identical specs into shared lanes, sorted by signature
        # so the program-cache key is independent of arrival order
        by_sig: Dict[str, _LanePlan] = {}
        for _, lp in planned:
            by_sig.setdefault(lp.sig, lp)
        sigs = tuple(sorted(by_sig))
        lanes = [by_sig[s] for s in sigs]
        lane_idx = {s: i for i, s in enumerate(sigs)}

        union_cols, union_names = self._union(ds, lanes)
        # the mesh tier's static precheck: it shapes the program and the
        # wave plan (each slot's budget, spw a multiple of the mesh)
        dec = MX.decide(eng, ds, lanes, len(seg_u))
        n_dev = dec.n_dev
        spw, n_waves = eng._plan_waves(
            ds, union_names, seg_u, max(lp.n_keys for lp in lanes),
            sum(len(lp.agg_plans) for lp in lanes), n_dev)
        # the rows of one launch: every wave is padded to spw segments,
        # of which each slot launches over its share
        n_rows = spw // n_dev * ds.padded_rows

        # 5. fusion planning is advisory: an error lowers the unfused way
        fplan = None
        if bool(eng.config.get(SHAREDSCAN_FUSION_ENABLED)):
            try:
                fplan = FU.plan_lanes(
                    [(lp.q.filter, lp.q.intervals,
                      tuple(a.filter for a in lp.aggs)) for lp in lanes],
                    per_lane_cols=[len(lp.needed) for lp in lanes],
                    union_cols=len(union_cols),
                    max_nodes=int(
                        eng.config.get(SHAREDSCAN_FUSION_MAX_NODES)))
            except Exception:  # noqa: BLE001 — plan unfused
                fplan = None
                with self._lock:
                    self.fusion_fallbacks += 1

        # 6. wave eligibility, from plan metadata on every execution
        wave_on = bool(eng.config.get(PALLAS_WAVE_ENABLED))
        max_lanes = int(eng.config.get(PALLAS_WAVE_MAX_LANES))
        max_keys = int(eng.config.get(GROUPBY_PALLAS_MAX_KEYS))
        decline = CW.wave_decline(lanes, max_lanes, max_keys) \
            if wave_on else None
        wave_ok = wave_on and decline is None
        scratch = int(eng.config.get(CUDA_WAVE_SCRATCH_BYTES))

        # 7. build once, cached under a signature that carries the fusion
        # token and the wave decision
        sig = ("aggmulti", ds.name, ds.serial, n_rows, min_day, max_day,
               tuple(union_names), eng.config.get(TZ_ID), max_keys,
               # the sketch widths the program's registers are built at
               eng.config.get(HLL_LOG2M), eng.config.get(QUANTILE_LANES),
               sigs, bool(eng.config.get(SHAREDSCAN_FUSION_ENABLED)),
               int(eng.config.get(SHAREDSCAN_FUSION_MAX_NODES)),
               fplan.token() if fplan is not None else None,
               wave_on, wave_ok, max_lanes, scratch,
               # the mesh decision, re-derived on every run: a flip of
               # sdot.mesh.* or a new mesh re-keys the program
               dec.sig_fields())

        def _build():
            reason = decline
            fn = info = None
            if wave_ok:
                try:
                    fn, info = self._build_wave_program(
                        ds, lanes, min_day, max_day, fplan,
                        union_names=union_names, n_rows=n_rows,
                        max_lanes=max_lanes, scratch=scratch)
                except CW.WaveFallback as e:
                    reason = str(e)
            if fn is None:
                if reason is not None:
                    with self._lock:
                        self.wave_fallbacks += 1
                        self.wave_fallback_reasons[reason] = \
                            self.wave_fallback_reasons.get(reason, 0) + 1
                fn = self._build_fused_program(ds, lanes, min_day,
                                               max_day, fplan)
            if dec.sharded:
                # one program, traced once, run by every slot over its
                # share; the lanes merge on the root device
                fn = MX.build_sharded_program(eng, fn, lanes)
            return fn, info

        t_program = _time.perf_counter()
        prog_fn, wave_info = eng._cached_program(sig, _build)
        t_dispatch = _time.perf_counter()

        # 8. dispatch once per wave, at each boundary the first rider's
        # cancel and deadline; 9. demultiplex
        pilot = planned[0][0]
        try:
            per_lane_finals, wave_steps = self._dispatch(
                ds, union_names, seg_u, spw, n_waves, prog_fn, lanes, dec,
                lambda: eng._stage_check(pilot.q, pilot.t0))
        except (X.QueryCancelled, X.QueryTimeout) as e:
            # the pilot's own cancel or deadline: it raises, the other
            # riders run solo (as in the JAX package)
            pilot.outcome = e
            return solo(m for m, _ in planned[1:])
        t_demux = _time.perf_counter()
        results = [self._decode_lane(eng, ds, lp, fin)
                   for lp, fin in zip(lanes, per_lane_finals)]
        # host wall ms of the group's steps (dispatch: bind, the program
        # and the copy of its outputs to the host, which waits for it)
        phases = {"plan_ms": (t_program - t_plan) * 1e3,
                  "program_ms": (t_dispatch - t_program) * 1e3,
                  "dispatch_ms": (t_demux - t_dispatch) * 1e3,
                  "demux_ms": (_time.perf_counter() - t_demux) * 1e3}

        bind_bytes = _bind_bytes(ds, union_names, len(seg_u))
        solo_bytes = sum(_bind_bytes(ds, lp.names, len(lp.seg))
                         for _, lp in planned)
        saved_bytes = max(0, solo_bytes - bind_bytes)
        saved_disp = (len(planned) - 1) * n_waves
        # each slot launches the wave kernel once per wave
        launches = n_waves * n_dev
        cbytes = MX.collective_bytes(eng, lanes, n_dev) * n_waves \
            if dec.sharded else 0
        with self._lock:
            self.groups_coalesced += 1
            if dec.sharded:
                self.mesh_groups += 1
                self.mesh_dispatches += n_waves
                self.mesh_collective_bytes += cbytes
            else:
                self.mesh_fallbacks[dec.reason] = \
                    self.mesh_fallbacks.get(dec.reason, 0) + 1
            if wave_info is not None:
                self.wave_launches += launches
                self.wave_smem_peak = max(self.wave_smem_peak,
                                          wave_info["smem_bytes"])
            self.queries_coalesced += len(planned)
            self.binds_saved_bytes += saved_bytes
            self.dispatches_saved += saved_disp
            if fplan is not None:
                self.fusion_groups += 1
                self.fusion_shared_predicates += fplan.shared_predicates
                self.fusion_predicate_evals_saved += \
                    fplan.predicate_evals_saved
                self.fusion_predicate_evals_total += fplan.n_nodes
                self.fusion_column_streams_saved += \
                    fplan.column_streams_saved

        for m, lp in planned:
            li = lane_idx[lp.sig]
            fin = per_lane_finals[li]
            m.stats = {
                "datasource": ds.name, "segments": int(len(lp.seg)),
                "sharded": bool(dec.sharded),
                "rows_scanned": int(ds.num_rows),
                "groups": int(np.count_nonzero(fin["__rows__"] > 0)),
                "waves": int(n_waves), "segments_per_wave": int(spw),
                "bytes_scanned": int(bind_bytes),
                "route": "wave" if wave_info is not None else "lanes",
                "mesh": {"devices": int(n_dev), "decision": dec.reason,
                         "collective_bytes": int(cbytes)},
                "sharedscan": {
                    "group": g.gid, "queries": len(planned),
                    "lanes": len(lanes),
                    "role": "leader" if m.leader else "follower",
                    "held_ms": (t_plan - m.t0) * 1e3,
                    "phases_ms": phases,
                    "binds_saved_bytes": saved_bytes,
                    "dispatches_saved": saved_disp,
                    "fusion": (fplan.counters()
                               if fplan is not None else None),
                    "wave": dict(wave_info, launches=launches)
                    if wave_info is not None else None}}
            if wave_steps is not None:
                m.stats["wave_steps"] = wave_steps
            m.outcome = results[li]
            eng.inflight.annotate(m.tok, sharedscan_group=g.gid)

    def _plan_members(self, ds, qs):
        """Steps 1-3 of a fused run: shape and prune every spec, take the
        union segments and the day basis of the shaped ones, and plan each
        lane against that basis. Returns ``(plans, seg_u, min_day,
        max_day)``, ``plans`` aligned with ``qs`` and None for a member
        that runs solo; ``seg_u`` is None when none shapes."""
        shaped = [self._shape_member(ds, q) for q in qs]
        live = [lp for lp in shaped if lp is not None]
        if not live:
            return [None] * len(qs), None, 0, 0
        seg_u = np.unique(np.concatenate([lp.seg for lp in live]))
        mins, maxs = ds.segment_time_bounds()
        min_day = int(mins[seg_u].min() // T.MILLIS_PER_DAY)
        max_day = int(maxs[seg_u].max() // T.MILLIS_PER_DAY)
        plans = [lp if lp is not None
                 and self._plan_lane(ds, lp, min_day, max_day) else None
                 for lp in shaped]
        return plans, seg_u, min_day, max_day

    @staticmethod
    def _union(ds, lanes):
        """(union source columns, union array names) of a group's lanes."""
        cols = sorted(set().union(*[lp.needed for lp in lanes]))
        time = any(lp.time_in_play for lp in lanes)
        return cols, array_names(ds, cols, time)

    @staticmethod
    def _shape_member(ds, q) -> Optional[_LanePlan]:
        """Map the spec to the engine's (dims, aggs, post, having, limit,
        gran) shape (mirrors ``_execute_inner``) and prune segments. None:
        the member runs solo (an empty prune takes the engine's own
        empty / identity-row path)."""
        try:
            if isinstance(q, S.GroupByQuerySpec):
                dims, having, limit = list(q.dimensions), q.having, q.limit
            elif isinstance(q, S.TimeseriesQuerySpec):
                dims, having, limit = [], None, None
            elif isinstance(q, S.TopNQuerySpec):
                dims, having, limit = [q.dimension], None, S.topn_limit(q)
            else:
                return None
            seg = ds.prune_segments(q.intervals, q.filter)
            if len(seg) == 0:
                return None
            return _LanePlan(q, _cache_repr(q), dims, q.aggregations,
                             q.post_aggregations, having, limit,
                             q.granularity, seg)
        except Exception:  # noqa: BLE001 — the solo path reports the error
            return None

    def _plan_lane(self, ds, lp: _LanePlan, min_day: int,
                   max_day: int) -> bool:
        """Detailed planning against the GROUP's day basis (every lane
        shares one ScanContext). False: the member runs solo (hashed-tier
        cardinality, the medium-K reroute, anything the port does not
        lower)."""
        from spark_druid_olap_tpu_torch.parallel import executor as X
        eng = self.engine
        try:
            gran_kind = lp.gran.kind if lp.gran else "all"
            tz = eng.config.get(TZ_ID)
            dim_plans = [X.plan_dimension(d, ds, min_day, max_day, tz)
                         for d in lp.dims]
            if gran_kind != "all":
                dim_plans = [X.plan_granularity_dim(
                    lp.gran, ds, min_day, max_day, tz)] + dim_plans
            agg_plans = [X.plan_aggregation(a, ds) for a in lp.aggs]
            n_keys = 1
            for p in dim_plans:
                n_keys *= p.card
            if n_keys > eng.config.get(GROUPBY_DENSE_MAX_KEYS):
                return False    # hashed tier: solo handles it
            min_k = int(eng.config.get(GROUPBY_SORTED_MIN_KEYS))
            if min_k > 0 and n_keys >= min_k \
                    and not any(p.kind in SKETCH_KINDS for p in agg_plans) \
                    and eng._sorted_run_wanted(X._rows_of(ds, lp.seg),
                                               n_keys):
                return False    # medium-K reroute territory: keep parity
            needed = set()
            for p in dim_plans:
                needed |= set(p.source_cols)
            for p in agg_plans:
                needed |= set(p.source_cols)
            needed |= F.columns_of_filter(lp.q.filter)
            time_in_play = ds.time is not None and (
                lp.q.intervals is not None or gran_kind != "all"
                or ds.time.name in needed)
            if time_in_play:
                needed.add(ds.time.name)
            lp.dim_plans = dim_plans
            lp.agg_plans = agg_plans
            lp.n_keys = n_keys
            lp.routes = eng._plan_routes(agg_plans)
            lp.needed = needed
            lp.time_in_play = time_in_play
            lp.names = array_names(ds, sorted(needed), time_in_play)
        except Exception:  # noqa: BLE001 — the solo path reports the error
            return False
        return self._lowers(ds, lp, min_day, max_day)

    def _lowers(self, ds, lp: _LanePlan, min_day: int, max_day: int) -> bool:
        """Whether the port lowers this lane's filter, keys and aggregates,
        sketch inputs included (memoized per lane and day basis): one
        lowering over one-row CPU tensors. A lane whose lowering raises (a
        filter or expression the port does not lower yet, a sketch over a
        column kind it does not take) runs solo, where it raises the same
        error for its own query only."""
        key = (ds.serial, lp.sig, min_day, max_day,
               self.engine.config.get(TZ_ID))
        ok = self._lowerable.get(key)
        if ok is None:
            arrays = {k: torch.zeros((1, 1), dtype=CW._column_dtype(ds, k))
                      for k in lp.names}
            ctx = ScanContext(ds, arrays, min_day, max_day,
                              tz=self.engine.config.get(TZ_ID))
            try:
                CW._lane_parts(lp, ctx, None, sketches={
                    p.spec.name for p in lp.agg_plans
                    if p.kind in SKETCH_KINDS})
                ok = True
            except Exception:  # noqa: BLE001 — the solo path reports it
                ok = False
            self._lowerable[key] = ok
        return ok

    def _build_fused_program(self, ds, lanes: List[_LanePlan],
                             min_day: int, max_day: int, fplan=None):
        """The lane-by-lane program: one ScanContext over the union bind
        (with the fusion plan's CSE cache), each lane through
        ``ops/groupby.dense_groupby`` — the fused group-by kernel for
        K <= sdot.engine.groupby.pallas.max.keys, its plain scatter above —
        then its sketches' register ops."""
        eng = self.engine
        pallas_max = eng.config.get(GROUPBY_PALLAS_MAX_KEYS)
        tz = eng.config.get(TZ_ID)
        log2m = eng.config.get(HLL_LOG2M)
        kll_lanes = eng.config.get(QUANTILE_LANES)

        def fused(arrays):
            ctx = ScanContext(ds, arrays, min_day, max_day, tz=tz)
            cse = None
            if fplan is not None:
                cse = FU.CSECache(ctx)
                cse.prelower(fplan)
            outs = []
            for lp in lanes:
                base, key, dense, _ = CW._lane_parts(lp, ctx, cse)
                inputs = [G.AggInput(name, kind, vals, mask,
                                     is_int=lp.routes[name].tag == "i64")
                          for kind, name, vals, mask in dense]
                out = G.dense_groupby(key, base, lp.n_keys, inputs,
                                      lp.routes, pallas_max)
                for p in lp.agg_plans:
                    if p.kind in SKETCH_KINDS:
                        out[p.spec.name] = sketch_registers(
                            p, ctx, cse, base, key, lp.n_keys, log2m=log2m,
                            kll_lanes=kll_lanes)
                outs.append(out)
            return outs

        return fused

    def _build_wave_program(self, ds, lanes: List[_LanePlan],
                            min_day: int, max_day: int, fplan=None, *,
                            union_names, n_rows, max_lanes, scratch):
        """(wave_fn, wave_info): the group's wave as ONE launch of the wave
        kernel. Raises :class:`CW.WaveFallback` when the group does not
        lower; the caller then builds the lane-by-lane program."""
        cfg = self.engine.config
        return CW.build_wave_fn(
            ds, lanes, min_day, max_day, fplan, union_names=union_names,
            tz=cfg.get(TZ_ID), n_rows=n_rows, max_lanes=max_lanes,
            scratch_bytes=scratch, log2m=cfg.get(HLL_LOG2M),
            kll_lanes=cfg.get(QUANTILE_LANES))

    def _dispatch(self, ds, union_names, seg_u, spw, n_waves, prog_fn,
                  lanes: List[_LanePlan], dec, check):
        """One shared bind and ONE program dispatch per wave (the JAX
        package's ``_dispatch``; double-buffered like the engine's
        ``_run_waves``), ``check`` before each; per-lane finals merged
        across the waves. Sharded (``dec``): the bind is per slot, the
        waves' segments are balanced by rows across the slots
        (``planner/fusion.plan_device_waves``) and the slots' partials
        are held in ``meshexec.LEDGER`` while the loop runs. Returns
        ``(per-lane finals, the waves' steps or None in one wave)``."""
        eng = self.engine
        sketch = [[p for p in lp.agg_plans if p.kind in SKETCH_KINDS]
                  for lp in lanes]
        n_dev = dec.n_dev if dec.sharded else 1
        tok = MX.LEDGER.acquire_partials(
            MX.merged_payload_bytes(eng, lanes) * n_dev)
        try:
            return self._waves(ds, union_names, seg_u, spw, n_waves,
                               prog_fn, lanes, check, sketch, n_dev)
        finally:
            MX.LEDGER.release_partials(tok)

    def _waves(self, ds, union_names, seg_u, spw, n_waves, prog_fn, lanes,
               check, sketch, n_dev):
        from spark_druid_olap_tpu_torch.parallel import executor as X

        def lane_finals(outs):
            # every lane's outputs in one device-to-host copy
            host = X._to_host({(i, k): v for i, out in enumerate(outs)
                               for k, v in out.items()})
            return [X._finals_from_out(
                {k: v for (j, k), v in host.items() if j == i}, lp.routes,
                lp.n_keys, sketch[i]) for i, lp in enumerate(lanes)]

        eng = self.engine
        prog = prog_fn if n_dev > 1 else (lambda a: prog_fn(a[0]))
        if n_waves == 1:
            arrays = eng._bind_arrays(ds, union_names, seg_u, n_dev)
            check()
            return lane_finals(prog(arrays)), None
        seg_rows = {int(si): int(ds.segments[int(si)].num_rows)
                    for si in seg_u} if n_dev > 1 else None
        binder = X._WaveBinder(ds, union_names, spw, eng.device,
                               eng.mesh if n_dev > 1 else None)
        finals = None
        for outs in binder.stream(
                prog, FU.plan_device_waves(seg_u, spw, n_dev, seg_rows),
                check):
            f = lane_finals(outs)
            finals = f if finals is None else [
                X._merge_wave_finals(a, b, lp.routes, sketch[i])
                for i, (a, b, lp) in enumerate(zip(finals, f, lanes))]
        return finals, binder.steps()

    @staticmethod
    def _decode_lane(eng, ds, lp: _LanePlan, finals) -> QueryResult:
        """Host demultiplex of one lane: the solo dense decode (group
        selection, dictionary decode, sketch estimates, identity row,
        epilogue)."""
        from spark_druid_olap_tpu_torch.parallel import executor as X
        rows = finals["__rows__"]
        sel = np.nonzero(rows > 0)[0]
        gran_kind = lp.gran.kind if lp.gran else "all"
        global_empty = (not lp.dim_plans and gran_kind == "all"
                        and len(sel) == 0)
        if global_empty:
            sel = np.zeros(1, dtype=np.int64)
        data: Dict[str, np.ndarray] = {}
        columns: List[str] = []
        if lp.dim_plans:
            code_lists = G.unfuse_key(sel, [p.card for p in lp.dim_plans])
            for p, codes in zip(lp.dim_plans, code_lists):
                data[p.output_name] = p.decode(codes)
                columns.append(p.output_name)
        for p in lp.agg_plans:
            name = p.spec.name
            data[name] = X._decode_agg_value(ds, p, lp.routes.get(name),
                                             finals[name][sel],
                                             eng.partial_sketches)
            columns.append(name)
        if global_empty:
            data.update(X._identity_row(
                {p.spec.name: p.kind for p in lp.agg_plans
                 if p.kind in ("sum", "min", "max")}))
        data = eng._agg_epilogue(data, columns, lp.post, lp.having,
                                 lp.limit)
        return QueryResult(columns, data)

    # -- observability --------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            total = self.fusion_predicate_evals_total \
                + self.fusion_solo_evals_total
            saved = self.fusion_predicate_evals_saved \
                + self.fusion_solo_evals_saved
            return {"enabled": self.enabled(),
                    "groups_coalesced": self.groups_coalesced,
                    "solo_groups": self.solo_groups,
                    "queries_coalesced": self.queries_coalesced,
                    "fallbacks": self.fallbacks,
                    "binds_saved_bytes": self.binds_saved_bytes,
                    "dispatches_saved": self.dispatches_saved,
                    "wlm_handoffs": self.wlm_handoffs,
                    "wave_launches": self.wave_launches,
                    "wave_fallbacks": self.wave_fallbacks,
                    "wave_fallback_reasons":
                        dict(self.wave_fallback_reasons),
                    "wave_smem_bytes_peak": self.wave_smem_peak,
                    "mesh": {
                        "devices": mesh_size(self.engine.mesh),
                        "groups": self.mesh_groups,
                        "dispatches": self.mesh_dispatches,
                        "collective_bytes": self.mesh_collective_bytes,
                        "fallbacks": dict(self.mesh_fallbacks),
                        "partials": MX.LEDGER.stats()},
                    "fusion": {
                        "groups": self.fusion_groups,
                        "plan_fallbacks": self.fusion_fallbacks,
                        "shared_predicates":
                            self.fusion_shared_predicates,
                        "predicate_evals_saved":
                            self.fusion_predicate_evals_saved,
                        "predicate_evals_total":
                            self.fusion_predicate_evals_total,
                        "column_streams_saved":
                            self.fusion_column_streams_saved,
                        "solo_evals_saved": self.fusion_solo_evals_saved,
                        "solo_evals_total": self.fusion_solo_evals_total,
                        "cse_hit_rate": round(saved / total, 4)
                        if total else 0.0}}
