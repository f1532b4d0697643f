"""Per-node circuit breakers for the broker's scatter path.

Port of ``spark_druid_olap_tpu/cluster/breaker.py``, copied whole.

One breaker per historical. State machine per node:

- **closed** — attempts flow; ``failures`` consecutive subquery
  failures open it.
- **open** — :meth:`before_attempt` returns ``None`` (the broker skips
  the node without an RPC) until ``cooldown_s`` elapses.
- **half-open** — after the cooldown, exactly ONE in-flight probe
  attempt is admitted; success closes the breaker, failure re-opens it
  (and restarts the cooldown).

Every admitted attempt is a claim token that MUST be settled
(``settle(tok, ok)``) — the sdlint leaks pass enforces the pair — so a
crashed attempt can't wedge a breaker half-open forever.

Lock order: ``BreakerBoard._lock`` is a LEAF lock — no other lock is
ever taken while it is held (``before_attempt``/``settle`` never call
out), and it nests safely under ``ClusterClient._lock`` (see
docs/LINT.md, lock-order registry).
"""

from __future__ import annotations

import threading
import time


class _Claim:
    """Token for one admitted attempt against one node."""

    __slots__ = ("node_id", "probe")

    def __init__(self, node_id, probe):
        self.node_id = node_id
        self.probe = probe


class _Breaker:
    __slots__ = ("consecutive", "open_since", "probing")

    def __init__(self):
        self.consecutive = 0      # consecutive failures while closed
        self.open_since = None    # monotonic timestamp, None = closed
        self.probing = False      # a half-open probe is in flight


class BreakerBoard:
    """Breaker state for all nodes of one broker."""

    def __init__(self, n_nodes, failures, cooldown_s):
        self.failures = int(failures)
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()   # LEAF — never calls out while held
        self._nodes = [_Breaker() for _ in range(n_nodes)]
        self.counters = {"opens": 0, "closes": 0, "skips": 0, "probes": 0}

    @property
    def enabled(self):
        return self.failures > 0

    def before_attempt(self, node_id):
        """Admit or refuse an attempt. Returns a claim token (settle it!)
        or ``None`` when the breaker is open and still cooling down."""
        if not self.enabled:
            return _Claim(node_id, False)
        with self._lock:
            b = self._nodes[node_id]
            if b.open_since is None:
                return _Claim(node_id, False)
            if b.probing or (time.monotonic() - b.open_since
                             < self.cooldown_s):
                self.counters["skips"] += 1
                return None
            b.probing = True
            self.counters["probes"] += 1
            return _Claim(node_id, True)

    def settle(self, tok, ok):
        """Record the outcome of an admitted attempt."""
        if tok is None or not self.enabled:
            return
        with self._lock:
            b = self._nodes[tok.node_id]
            if tok.probe:
                b.probing = False
            if ok:
                b.consecutive = 0
                if b.open_since is not None:
                    b.open_since = None
                    self.counters["closes"] += 1
            elif tok.probe:
                # a failed half-open probe re-opens (restart the cooldown)
                b.open_since = time.monotonic()
            else:
                b.consecutive += 1
                if (b.open_since is None
                        and b.consecutive >= self.failures):
                    b.open_since = time.monotonic()
                    self.counters["opens"] += 1

    def reset(self, node_id):
        """Forget one node's breaker state (close it, zero the failure
        count). Called when the node's *generation* changes — a
        historical that left and rejoined, or a restarted process
        reusing the slot — so the successor never inherits the
        predecessor's open circuit (a rejoin must start closed). Counter
        totals are preserved; only per-node state clears."""
        with self._lock:
            self._nodes[node_id] = _Breaker()

    def is_open(self, node_id):
        """True when attempts against the node are currently refused
        (used only to order replica chains, never to skip outright)."""
        if not self.enabled:
            return False
        with self._lock:
            return self._nodes[node_id].open_since is not None

    def snapshot(self):
        with self._lock:
            return {"enabled": self.enabled,
                    "states": ["open" if b.open_since is not None
                               else "closed" for b in self._nodes],
                    **self.counters}
