"""Per-query host-path phase profiler.

Port counterpart of ``spark_druid_olap_tpu/utils/phases.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

Every query pays a ~1.7 ms dispatch floor on the device; everything
else is host work spread across parsing, a recognizer cascade, caches,
binding and demux.  This module attributes that host time to *named
phases* with two monotonic-clock reads per phase, cheap enough to stay
always-on (< 1% of wall, enforced by tests/test_phases.py).

Usage::

    tok = PH.begin()                 # open a per-query accumulator
    with PH.phase("plan.build"):
        ...
    PH.add("dispatch", seconds)      # hot loops: pre-measured interval
    phases = PH.end(tok)             # {"plan.build": ms, ...}

Semantics:

- The accumulator is thread-local.  ``begin()`` returns ``None`` when
  an accumulator is already open (nested query execution, e.g. UNION
  branches re-entering the select path) — inner phases then merge into
  the outer accumulator and the inner ``end(None)`` is a no-op.
- ``phase()``/``add()`` outside any open accumulator are no-ops, so
  background threads (tier prefetcher) and non-query entry points can
  share the instrumented call sites for free.
- Phases are *inclusive*: a phase nested inside another counts in
  both, so the per-query sum may exceed wall time.  Readers should
  treat each entry as "time attributable to this stage", not as a
  partition of the wall clock.
- ``stash(name, seconds)`` records time measured *before* the
  accumulator could be opened (statement parse happens before the
  select path begins); the next ``begin()`` on the same thread folds
  the stash in.  ``clear_stash()`` drops leftovers so one statement's
  parse can never leak into the next.

The ``PHASES`` registry below is the single source of truth for phase
names; sdlint cross-checks every ``PH.phase("...")``/``PH.add("...")``
call site against it and against the docs/STATS.md phase table.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

# name -> one-line meaning (kept a pure literal: sdlint parses it)
PHASES = {
    "parse": "SQL text -> AST (memoized; counted when actually run)",
    "plan.memo": "planning-cascade memo lookup",
    "plan.window": "window-function extraction",
    "plan.resolve": "database/alias-scope/lookup resolution",
    "plan.rewrite": "derived-table merge, decorrelation, subquery inlining",
    "plan.build": "SELECT -> PlannedQuery spec build",
    "plan.rollup": "materialized-rollup rewrite match",
    "plan.star": "star-join collapse over the FROM list",
    "plan.join": "general-join recognition",
    "plan.composite": "composite (host-assist) plan build",
    "wlm.admit": "workload-manager admission",
    "cache.lookup": "result-cache probe",
    "compile": "program build + jit (per signature, first run only)",
    "tier.fault": "tiered-store faults on the demand path",
    "tier.decode": "encoded-chunk decode on the demand path",
    "bind": "host->device array binding",
    "dispatch": "device execution + result fetch",
    "demux": "shared-scan per-lane demux/decode",
    "epilogue": "window post-pass and result epilogue",
}

_tls = threading.local()


def _acc() -> Optional[Dict[str, float]]:
    return getattr(_tls, "acc", None)


def begin(enabled: bool = True) -> Optional[Dict[str, float]]:
    """Open a per-query accumulator; None if nested or disabled."""
    stash = getattr(_tls, "stash", None)
    _tls.stash = None
    if not enabled or getattr(_tls, "acc", None) is not None:
        return None
    acc: Dict[str, float] = {}
    if stash:
        for k, v in stash.items():
            acc[k] = acc.get(k, 0.0) + v
    _tls.acc = acc
    return acc


def end(tok: Optional[Dict[str, float]]) -> Optional[Dict[str, float]]:
    """Close the accumulator opened by begin(); returns {name: ms}.

    Idempotent and nested-safe: ``end(None)`` is a no-op returning
    None, and closing twice (finally blocks) is harmless.
    """
    if tok is None:
        return None
    if getattr(_tls, "acc", None) is tok:
        _tls.acc = None
    return {k: v * 1000.0 for k, v in tok.items()}


class _Phase:
    __slots__ = ("name", "acc", "t0")

    def __init__(self, name: str) -> None:
        self.name = name
        self.acc = None
        self.t0 = 0.0

    def __enter__(self) -> "_Phase":
        self.acc = _acc()
        if self.acc is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.acc is not None:
            dt = time.perf_counter() - self.t0
            self.acc[self.name] = self.acc.get(self.name, 0.0) + dt
            self.acc = None


def phase(name: str) -> _Phase:
    """Context manager timing one phase; no-op without an open acc."""
    return _Phase(name)


def add(name: str, seconds: float) -> None:
    """Fold a pre-measured interval into the open accumulator."""
    acc = _acc()
    if acc is not None:
        acc[name] = acc.get(name, 0.0) + seconds


def stash(name: str, seconds: float) -> None:
    """Record time measured before begin(); folded into the next one."""
    st = getattr(_tls, "stash", None)
    if st is None:
        st = {}
        _tls.stash = st
    st[name] = st.get(name, 0.0) + seconds


def clear_stash() -> None:
    """Drop any pending stash (statement boundary)."""
    _tls.stash = None
