"""Autoscale hook: WLM queue depth -> spawn / retire historicals.

Port of ``spark_druid_olap_tpu/cluster/autoscale.py``, copied whole.

The broker already polls every historical for health; this hook rides
the same cadence and samples each node's WLM lane stats
(``GET /metadata/wlm``). When the fleet-mean queued-query depth sits
above ``sdot.cluster.autoscale.queue.high`` the hook signals
**scale-out**, below ``queue.low`` **scale-in** — with a cooldown
between decisions so one burst can't flap the fleet.

The hook decides; it does not provision. The ``spawn`` / ``retire``
callbacks are registered by whoever owns process lifecycle (the
loadtest harness forks a local historical; an operator wires
``scripts/start-sdot-cluster.sh add-node``; a k8s adapter would scale a
StatefulSet) and are expected to end in :func:`cluster.epoch.
publish_epoch` — the epoch machinery then runs the warm-before-ready /
drain-then-fence handover exactly as for a manual topology change.
With no callbacks registered, decisions only increment counters (dry
run), which is the safe default.

Deliberately clock-injectable and sampling-free so the decision logic
is unit-testable without a cluster: the broker supplies ``depths`` (one
int per live node) and the hook is a pure threshold/cooldown machine.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence


class AutoscaleHook:
    """Threshold + cooldown decision machine over fleet queue depths."""

    def __init__(self, queue_high: float, queue_low: float,
                 cooldown_s: float,
                 spawn: Optional[Callable[[], None]] = None,
                 retire: Optional[Callable[[], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if queue_low >= queue_high:
            raise ValueError(
                f"autoscale queue.low ({queue_low}) must be below "
                f"queue.high ({queue_high}) or the fleet flaps")
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.cooldown_s = float(cooldown_s)
        self.spawn = spawn
        self.retire = retire
        self._clock = clock
        self._last_decision: Optional[float] = None
        self.counters = {"samples": 0, "scale_out": 0, "scale_in": 0,
                         "suppressed_cooldown": 0, "callback_errors": 0}

    def observe(self, depths: Sequence[float],
                handover_in_progress: bool = False) -> Optional[str]:
        """Feed one sample of per-node queued depths; returns the
        decision ("out" / "in") or None. A pending epoch handover
        suppresses decisions — scaling while shards are mid-movement
        would stack epochs faster than nodes can warm."""
        self.counters["samples"] += 1
        if not depths or handover_in_progress:
            return None
        mean = sum(float(d) for d in depths) / len(depths)
        if mean > self.queue_high:
            want = "out"
        elif mean < self.queue_low and len(depths) > 1:
            # never retire the last historical
            want = "in"
        else:
            return None
        now = self._clock()
        if self._last_decision is not None \
                and now - self._last_decision < self.cooldown_s:
            self.counters["suppressed_cooldown"] += 1
            return None
        self._last_decision = now
        self.counters["scale_out" if want == "out" else "scale_in"] += 1
        cb = self.spawn if want == "out" else self.retire
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — provisioning is best-effort
                self.counters["callback_errors"] += 1
        return want

    def stats(self) -> dict:
        return {"queue_high": self.queue_high, "queue_low": self.queue_low,
                "cooldown_s": self.cooldown_s,
                "has_callbacks": self.spawn is not None
                or self.retire is not None,
                **self.counters}
