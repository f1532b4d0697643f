"""Admission control: classify -> quota -> lane queue -> slot.

Port counterpart of ``spark_druid_olap_tpu/wlm/admit.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

≈ Druid's `QueryScheduler.laneQuery/run` + the prioritization strategies:
every engine query passes through :meth:`WorkloadManager.admit` before
any planning/binding/dispatch work happens. Classification is by
explicit ``context.lane``, else by the calibrated cost model —
queries whose estimated single-chip cost crosses
``sdot.wlm.batch.cost.threshold`` are demoted to the batch lane (≈
Druid's `HiLoQueryLaningStrategy` sending "low" priority queries to a
bounded lane). Admission within a lane is priority-ordered FIFO; load
past the queue bound or wait budget sheds with :class:`LaneFullError`
(HTTP 429 + ``Retry-After`` at the serving layer), so overload degrades
to fast rejections instead of collapsing every in-flight query.

Queue wait is charged against the query's own deadline (the engine's
``t0`` is taken before admission), and a cooperative cancel registered
for the query id is honored *while queued* — the waiter unhooks itself
without ever taking a slot.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Tuple

from spark_druid_olap_tpu_torch.utils import phases as PH
from spark_druid_olap_tpu_torch.wlm.lanes import (AdmissionRejected, Lane,
                                                  LaneConfig, parse_lanes)
from spark_druid_olap_tpu_torch.wlm.quota import (QuotaManager,
                                                  quotas_from_config)

# how often a queued waiter polls for grant/cancel/deadline; grants set
# the waiter's Event so the happy path wakes immediately — the poll only
# bounds cancel/timeout latency
_POLL_S = 0.02


class LaneFullError(AdmissionRejected):
    """Lane queue depth or queue-wait budget exceeded — load shed."""


class _IngestContext:
    """QueryContext stand-in for stream-ingest admission: pins the
    ``ingest`` lane, inherits everything else from the lane config."""
    lane = "ingest"
    tenant = None
    priority = None
    timeout_millis = None
    query_id = None


class _IngestShim:
    """Synthetic spec routing a stream-ingest batch through lane
    admission. No datasource / aggregations: the shared-scan handoff
    and cost model both pass it over, so only the ``ingest`` lane's
    slot/queue accounting applies."""
    context = _IngestContext()
    datasource = None
    aggregations = ()


_INGEST_SHIM = _IngestShim()


@dataclasses.dataclass
class Ticket:
    """Proof of admission; passed back to :meth:`WorkloadManager.release`."""
    lane: str
    tenant: Optional[str]
    priority: int
    queued_ms: float
    est_cost: float
    demoted: bool
    timeout_millis: Optional[int]   # effective (context or lane default)
    _lane_obj: Lane = dataclasses.field(repr=False, default=None)
    _started: float = 0.0
    # admitted via the shared-scan handoff: the query rides a coalesced
    # group's dispatch instead of a lane slot, so release() must not hand
    # back a slot it never took
    coalesced: bool = False

    def stats(self) -> dict:
        d = {"lane": self.lane, "queued_ms": round(self.queued_ms, 2),
             "priority": self.priority}
        if self.tenant:
            d["tenant"] = self.tenant
        if self.demoted:
            d["demoted"] = True
        if self.coalesced:
            d["coalesced_handoff"] = True
        return d


class WorkloadManager:
    """One per QueryEngine. Reads its lane/quota layout from the session
    Config lazily, so a config change (tests, operator SET) takes effect
    on the next admission without a rebuild handshake."""

    def __init__(self, config):
        self._config = config
        self._lock = threading.Lock()
        self._lanes = {}
        self._lanes_src: Optional[str] = None
        self._default_lane = "interactive"
        self.quotas = QuotaManager()
        self._tls = threading.local()
        # global counters
        self.admitted_total = 0
        self.shed_total = 0
        # set by the owning QueryEngine; lets queued waiters hand off to
        # an open shared-scan group instead of draining serially
        self.sharedscan = None
        # fault injector (fault/) wired by the owning QueryEngine; None
        # unless sdot.fault.plan is set
        self.fault = None

    # -- configuration ---------------------------------------------------------
    @property
    def enabled(self) -> bool:
        from spark_druid_olap_tpu_torch.utils.config import WLM_ENABLED
        return bool(self._config.get(WLM_ENABLED))

    def _refresh_locked(self) -> None:
        from spark_druid_olap_tpu_torch.utils.config import (
            WLM_DEFAULT_LANE, WLM_LANES)
        src = str(self._config.get(WLM_LANES))
        if src != self._lanes_src:
            configs = parse_lanes(src)
            old = self._lanes
            self._lanes = {}
            for name, cfg in configs.items():
                lane = old.get(name)
                if lane is not None:
                    # keep live occupancy/counters across a re-config,
                    # just swap the limits
                    lane.config = cfg
                    self._lanes[name] = lane
                else:
                    self._lanes[name] = Lane(cfg)
            self._lanes_src = src
        self._default_lane = str(self._config.get(WLM_DEFAULT_LANE))
        if self._default_lane not in self._lanes:
            # config error containment: a bad default must not brick the
            # engine; fall back to any defined lane
            self._lanes.setdefault(
                self._default_lane,
                Lane(LaneConfig(self._default_lane)))
        self.quotas.configure(quotas_from_config(self._config))

    # -- request-context fallback (serving layer -> engine) --------------------
    def push_request(self, lane: Optional[str], tenant: Optional[str],
                     priority: Optional[int]) -> None:
        """Serving layers stash the request's lane/tenant/priority on
        this thread; specs that don't carry them in ``QueryContext``
        (host-tier subqueries, composite inner queries) inherit them."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append((lane, tenant, priority))

    def pop_request(self) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack:
            stack.pop()

    def _request_fallback(self) -> Tuple[Optional[str], Optional[str],
                                         Optional[int]]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else (None, None, None)

    # -- classification --------------------------------------------------------
    def _estimate_cost(self, engine, q) -> float:
        """Estimated single-chip cost units (the quota denomination and
        the demotion signal). Never raises: sys-shaped or odd specs cost
        the compile floor."""
        try:
            from spark_druid_olap_tpu_torch.parallel import cost as C
            return float(C.estimate(engine, q).single_cost)
        except Exception:  # noqa: BLE001 — estimate is advisory
            return 0.05

    def classify(self, engine, q) -> Tuple[str, float, bool, Optional[str],
                                           int]:
        """-> (lane_name, est_cost, demoted, tenant, priority)."""
        from spark_druid_olap_tpu_torch.utils.config import WLM_BATCH_COST
        ctxq = getattr(q, "context", None)
        fb_lane, fb_tenant, fb_priority = self._request_fallback()
        lane = getattr(ctxq, "lane", None) or fb_lane
        tenant = getattr(ctxq, "tenant", None) or fb_tenant
        priority = getattr(ctxq, "priority", None)
        if priority is None:
            priority = fb_priority
        est = None
        demoted = False
        if lane not in self._lanes:
            lane = self._default_lane
            threshold = float(self._config.get(WLM_BATCH_COST))
            if threshold > 0 and "batch" in self._lanes:
                est = self._estimate_cost(engine, q)
                if est >= threshold:
                    lane, demoted = "batch", True
        need_cost = any(st.bucket is not None
                        for st in self.quotas._tenants.values()) \
            or "default" in self.quotas._configured
        if est is None and tenant and need_cost:
            est = self._estimate_cost(engine, q)
        if est is None:
            est = 0.0
        if priority is None:
            priority = self._lanes[lane].config.priority
        return lane, est, demoted, tenant, int(priority)

    # -- admission -------------------------------------------------------------
    def admit(self, engine, q, t0: float,
              cancel_event: Optional[threading.Event] = None) -> Ticket:
        """Block until a lane slot is granted (or raise). ``t0`` is the
        engine's query start — queue wait counts against the deadline.
        Admission time (queue wait INCLUDED) lands in the per-query
        phase profile as ``wlm.admit``."""
        with PH.phase("wlm.admit"):
            return self._admit(engine, q, t0, cancel_event)

    def _admit(self, engine, q, t0: float,
               cancel_event: Optional[threading.Event] = None) -> Ticket:
        inj = self.fault
        if inj is not None:
            # chaos site (before the lock — a delay rule models slot
            # starvation, an error rule a queue-full shed)
            inj.fire("wlm.admit")
        with self._lock:
            self._refresh_locked()
            lane_name, est, demoted, tenant, priority = \
                self.classify(engine, q)
            lane = self._lanes[lane_name]
            cfg = lane.config
            ctxq = getattr(q, "context", None)
            timeout_ms = getattr(ctxq, "timeout_millis", None)
            if timeout_ms is None:
                timeout_ms = cfg.timeout_millis
            # quota before the queue: a tenant over budget must not
            # occupy queue depth others could use
            self.quotas.acquire(tenant, est)
            try:
                if lane.try_acquire():
                    lane.admitted += 1
                    if demoted:
                        lane.demoted_in += 1
                    self.admitted_total += 1
                    return Ticket(lane_name, tenant, priority, 0.0, est,
                                  demoted, timeout_ms, lane,
                                  time.perf_counter())
                if lane.queue_len() >= cfg.max_queue:
                    lane.shed += 1
                    self.shed_total += 1
                    raise LaneFullError(
                        f"lane {lane_name!r} full "
                        f"({cfg.slots} running, {lane.queue_len()} queued)",
                        retry_after_s=lane.retry_after_s())
                waiter = lane.enqueue(priority)
            except BaseException:
                self.quotas.release(tenant)
                raise
        # --- queued: wait outside the lock ---------------------------------
        unhooked = False    # quota + queue entry handed off or released
        try:
            enq = time.perf_counter()
            wait_deadline = enq + cfg.max_wait_ms / 1000.0 \
                if cfg.max_wait_ms > 0 else None
            query_deadline = t0 + timeout_ms / 1000.0 \
                if timeout_ms is not None else None
            while True:
                if waiter.event.wait(_POLL_S):
                    break
                now = time.perf_counter()
                coal = self.sharedscan
                if coal is not None and coal.should_try(q) \
                        and coal.open_group_hint(
                            getattr(q, "datasource", None)):
                    # shared-scan handoff: a compatible group is holding
                    # its micro-batch window — ride its fused dispatch
                    # instead of waiting for a serial slot. The query
                    # leaves the queue WITHOUT taking a slot (the group
                    # leader owns the lane occupancy for the dispatch).
                    # LOCK ORDER: note_handoff() takes the coalescer's
                    # group lock while self._lock is held — the global
                    # order is WorkloadManager._lock BEFORE
                    # SharedScanCoalescer._lock; the coalescer must never
                    # call back into admission under its lock.
                    with self._lock:
                        if not waiter.granted:
                            # note_handoff BEFORE remove: if the
                            # coalescer refuses (raises), the waiter is
                            # still queued and the error path below
                            # unhooks it cleanly
                            coal.note_handoff()
                            lane.remove(waiter)
                            unhooked = True   # ticket owns quota now
                            lane.admitted += 1
                            lane.coalesced_handoff += 1
                            self.admitted_total += 1
                            queued_ms = (now - enq) * 1000.0
                            lane.queued_ms_total += queued_ms
                            return Ticket(lane_name, tenant, priority,
                                          queued_ms, est, demoted,
                                          timeout_ms, lane,
                                          time.perf_counter(),
                                          coalesced=True)
                        # a grant raced the handoff: keep the slot
                        break
                if cancel_event is not None and cancel_event.is_set():
                    self._unhook(lane, waiter, tenant, "cancel")
                    unhooked = True
                    from spark_druid_olap_tpu_torch.parallel.executor import (
                        QueryCancelled)
                    qid = getattr(ctxq, "query_id", None)
                    raise QueryCancelled(
                        f"query {qid} cancelled while queued in lane "
                        f"{lane_name!r}")
                if wait_deadline is not None and now >= wait_deadline:
                    self._unhook(lane, waiter, tenant, "wait")
                    unhooked = True
                    raise LaneFullError(
                        f"lane {lane_name!r} queue-wait budget "
                        f"({cfg.max_wait_ms:.0f}ms) exceeded",
                        retry_after_s=lane.retry_after_s())
                if query_deadline is not None and now >= query_deadline:
                    self._unhook(lane, waiter, tenant, "deadline")
                    unhooked = True
                    from spark_druid_olap_tpu_torch.parallel.executor import (
                        QueryTimeout)
                    raise QueryTimeout(
                        f"query exceeded {timeout_ms}ms "
                        f"(queued in lane {lane_name!r})")
            queued_ms = (time.perf_counter() - enq) * 1000.0
            with self._lock:
                lane.admitted += 1
                if demoted:
                    lane.demoted_in += 1
                self.admitted_total += 1
                lane.queued_ms_total += queued_ms
            return Ticket(lane_name, tenant, priority, queued_ms, est,
                          demoted, timeout_ms, lane, time.perf_counter())
        except BaseException:
            # anything that escapes the wait (KeyboardInterrupt landing
            # in event.wait, a raising stats hook, ...) must give back
            # the queue entry — or the granted slot, if a grant raced —
            # and the tenant quota, or the lane wedges permanently
            if not unhooked:
                self._unhook(lane, waiter, tenant, "error")
            raise

    def _unhook(self, lane: Lane, waiter, tenant: Optional[str],
                why: str) -> None:
        """Remove a queued waiter. If a grant raced us, the slot is ours
        — hand it straight back so it is never leaked."""
        with self._lock:
            if waiter.granted:
                lane.release()
            else:
                lane.remove(waiter)
            if why == "cancel":
                lane.cancelled_queued += 1
            elif why == "wait":
                lane.timed_out += 1
                self.shed_total += 1
            self.quotas.release(tenant)

    def admit_ingest(self) -> Optional[Ticket]:
        """Lane admission for one stream-ingest batch (the write-side
        twin of :meth:`admit`). Routes through the ``ingest`` lane when
        the operator configured one in ``sdot.wlm.lanes`` — producers
        then share the same slot/queue/shed fabric as queries, so an
        ingest storm cannot starve dashboards (and vice versa: the
        lane's slot count caps concurrent local applies). Returns a
        Ticket for :meth:`release`, or None (no admission, no release)
        when WLM is off or no ``ingest`` lane exists — ingest is never
        throttled by default."""
        if not self.enabled:
            return None
        with self._lock:
            self._refresh_locked()
            if "ingest" not in self._lanes:
                return None
        return self.admit(None, _INGEST_SHIM, time.perf_counter())

    def release(self, ticket: Ticket) -> None:
        run_ms = (time.perf_counter() - ticket._started) * 1000.0
        with self._lock:
            if not ticket.coalesced:
                # coalesced handoffs never took a lane slot
                ticket._lane_obj.release(run_ms)
            self.quotas.release(ticket.tenant)

    # -- observability ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            self._refresh_locked()
            out = {"enabled": self.enabled,
                   "admitted": self.admitted_total,
                   "shed": self.shed_total,
                   "default_lane": self._default_lane,
                   "lanes": [ln.snapshot()
                             for _, ln in sorted(self._lanes.items())],
                   "tenants": self.quotas.snapshot()}
        if self.sharedscan is not None:
            out["sharedscan"] = self.sharedscan.stats()
        return out

    def lanes_view(self):
        """``sys_lanes`` — one row per configured lane."""
        import pandas as pd
        with self._lock:
            self._refresh_locked()
            rows = [ln.snapshot() for _, ln in sorted(self._lanes.items())]
        return pd.DataFrame(rows)
