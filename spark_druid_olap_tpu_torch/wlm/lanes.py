"""Named query lanes: configuration grammar and runtime state.

Port counterpart of ``spark_druid_olap_tpu/wlm/lanes.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

≈ Druid's laning strategies (`QueryScheduler` lanes: a total slot pool
carved into named lanes, each with its own concurrency limit). A lane
here additionally owns a bounded priority wait-queue, a max queue-wait
budget, and a default per-query timeout propagated into
``QueryContext`` when the client set none.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
from typing import Dict, List, Optional


class AdmissionRejected(RuntimeError):
    """Base of every load-shed rejection (lane full, wait budget blown,
    quota exhausted). ``retry_after_s`` is the server's backoff hint —
    surfaced as HTTP 429 + ``Retry-After`` by the serving layer."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = max(0.0, float(retry_after_s))


@dataclasses.dataclass(frozen=True)
class LaneConfig:
    name: str
    slots: int = 4              # concurrent queries executing in the lane
    max_queue: int = 32         # waiters beyond slots before shedding
    max_wait_ms: float = 0.0    # queue-wait budget; 0 = only the query's
    #                             own timeout bounds the wait
    timeout_millis: Optional[int] = None   # default QueryContext timeout
    priority: int = 0           # default admission priority (higher first)


_LANE_FIELDS = {"slots": int, "queue": int, "wait_ms": float,
                "timeout_ms": int, "priority": int}


def parse_lanes(spec: str) -> Dict[str, LaneConfig]:
    """Parse the ``sdot.wlm.lanes`` grammar:
    ``name:slots=N,queue=N,wait_ms=N,timeout_ms=N,priority=N;name2:...``
    Unknown options raise — a typo silently dropping a concurrency cap
    would defeat the whole subsystem."""
    out: Dict[str, LaneConfig] = {}
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, opts = part.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"lane with empty name in {spec!r}")
        kw = {}
        for opt in opts.split(","):
            opt = opt.strip()
            if not opt:
                continue
            k, _, v = opt.partition("=")
            k = k.strip()
            if k not in _LANE_FIELDS:
                raise ValueError(
                    f"unknown lane option {k!r} (lane {name!r}); "
                    f"known: {sorted(_LANE_FIELDS)}")
            kw[k] = _LANE_FIELDS[k](v.strip())
        out[name] = LaneConfig(
            name,
            slots=max(1, kw.get("slots", 4)),
            max_queue=max(0, kw.get("queue", 32)),
            max_wait_ms=float(kw.get("wait_ms", 0.0)),
            timeout_millis=kw.get("timeout_ms") or None,
            priority=kw.get("priority", 0))
    return out


class _Waiter:
    __slots__ = ("priority", "seq", "event", "granted", "removed")

    def __init__(self, priority: int, seq: int):
        self.priority = priority
        self.seq = seq
        self.event = threading.Event()
        self.granted = False
        self.removed = False

    def __lt__(self, other):     # heapq order: higher priority, then FIFO
        return (-self.priority, self.seq) < (-other.priority, other.seq)


class Lane:
    """Runtime state of one lane. All mutation happens under the owning
    WorkloadManager's lock — the lane itself holds no lock, so slot
    transfer (release -> grant) is a single atomic section."""

    def __init__(self, config: LaneConfig, seq=None):
        self.config = config
        self.active = 0
        self.max_active_seen = 0     # high-water mark: the tests' cap proof
        self._heap: List[_Waiter] = []
        self._seq = seq if seq is not None else itertools.count()
        # counters (monotone; surfaced by sys_lanes / GET /metadata/wlm)
        self.admitted = 0
        self.demoted_in = 0          # admissions arriving via cost demotion
        self.shed = 0                # queue-depth rejections
        self.timed_out = 0           # wait-budget rejections
        self.cancelled_queued = 0    # cancels honored while still queued
        self.coalesced_handoff = 0   # waiters bypassed into a shared-scan
        #                              group (counted in `admitted` too)
        self.queued_ms_total = 0.0
        self.run_ms_ewma = 0.0       # released-query runtime (retry hints)

    # -- under the manager lock -----------------------------------------------
    def queue_len(self) -> int:
        return sum(1 for w in self._heap if not w.removed)

    def try_acquire(self) -> bool:
        """Fast path: a free slot and nobody queued ahead."""
        if self.active < self.config.slots and self.queue_len() == 0:
            self.active += 1
            self.max_active_seen = max(self.max_active_seen, self.active)
            return True
        return False

    def enqueue(self, priority: int) -> _Waiter:
        w = _Waiter(priority, next(self._seq))
        heapq.heappush(self._heap, w)
        return w

    def remove(self, waiter: _Waiter) -> None:
        """Lazy delete: mark removed; the grant loop skips dead entries."""
        waiter.removed = True

    def grant_next(self) -> None:
        """Hand a free slot to the best waiter (priority, then FIFO)."""
        while self.active < self.config.slots and self._heap:
            w = heapq.heappop(self._heap)
            if w.removed:
                continue
            self.active += 1
            self.max_active_seen = max(self.max_active_seen, self.active)
            w.granted = True
            w.event.set()

    def release(self, run_ms: Optional[float] = None) -> None:
        self.active = max(0, self.active - 1)
        if run_ms is not None:
            a = 0.2
            self.run_ms_ewma = run_ms if self.run_ms_ewma == 0.0 \
                else (1 - a) * self.run_ms_ewma + a * run_ms
        self.grant_next()

    def retry_after_s(self) -> float:
        """Backoff hint: rough time for the backlog to drain one slot's
        worth of work (EWMA runtime), floored at 100ms."""
        est = self.run_ms_ewma or 1000.0
        backlog = self.queue_len() + 1
        return max(0.1, backlog * est / 1000.0 / max(1, self.config.slots))

    def snapshot(self) -> dict:
        c = self.config
        return {"lane": c.name, "slots": c.slots, "active": self.active,
                "queued": self.queue_len(), "max_queue": c.max_queue,
                "max_wait_ms": c.max_wait_ms,
                "default_timeout_ms": c.timeout_millis or 0,
                "priority": c.priority, "admitted": self.admitted,
                "demoted_in": self.demoted_in, "shed": self.shed,
                "timed_out": self.timed_out,
                "cancelled_queued": self.cancelled_queued,
                "coalesced_handoff": self.coalesced_handoff,
                "max_active_seen": self.max_active_seen,
                "queued_ms_total": round(self.queued_ms_total, 2),
                "run_ms_ewma": round(self.run_ms_ewma, 2)}
