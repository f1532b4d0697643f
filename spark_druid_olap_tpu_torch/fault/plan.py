"""Deterministic, seed-reproducible fault injection.

Port counterpart of ``spark_druid_olap_tpu/fault/plan.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.
``LaneFullError`` comes from the port's ``wlm/admit.py``. The port's
sites are the WAL's, the snapshot publish's, compaction's, WLM
admission's and the cold tier's (``tier.read`` before a cold load,
``tier.verify`` over the bytes a first fault checksums) and the
cluster's (``rpc.connect``, ``rpc.request``, ``rpc.response``,
``rpc.ingest``, ``hist.handle``, ``hist.ingest``, ``node.drain``,
``epoch.publish``).

A :class:`FaultPlan` is a seeded schedule of :class:`FaultRule`\\ s parsed
from the ``sdot.fault.plan`` config key (JSON). Each rule names an
injection *site* (a string the instrumented code passes at the call
point, e.g. ``"rpc.connect"``), an optional ``match`` substring applied
to the site's *key* (e.g. ``"node:1"``), and an *action*:

- ``error``  — raise an exception (``arg`` names the class; default
  :class:`FaultInjected`) at a ``fire()`` site
- ``delay``  — sleep ``arg`` seconds at a ``fire()`` or ``mutate()`` site
- ``truncate`` — drop the last ``arg`` bytes at a ``mutate()`` site
- ``flip``   — XOR one seeded-random byte at a ``mutate()`` site

Rules carry ``p`` (fire probability), ``count`` (max fires; ``null`` =
unlimited), ``after`` (matching evaluations to skip first), and an
optional ``scope`` name: scoped rules only fire while a matching
:meth:`FaultInjector.scope` is open, which lets one long-lived context
run several chaos legs from a single plan.

Determinism: every rule gets its own ``random.Random`` seeded from
``(plan seed, rule index)``, so ``count``/``after`` rules are exact and
``p`` rules replay statistically from the seed (thread interleaving can
reorder which *evaluation* draws which number, but the draw sequence per
rule is fixed). Injection sites are zero-cost no-ops when no plan is
configured — callers hold ``inj = <owner>.fault`` and guard on ``None``.

The full site catalog lives in ``docs/CHAOS.md``. The durability sites
deserve a note here because their *placement* is the contract:
``wal.group_commit`` fires in the group-commit leader after the batch's
writes but before the covering fsync (so an injected crash leaves every
frame in the batch un-acked — none may survive as committed);
``compact.publish`` fires before the compacted generation's snapshot is
written (an injected crash must leave the OLD generation fully readable
with the WAL untouched); ``hist.ingest`` / ``rpc.ingest`` sit on the
distributed-ingest push path, where the broker's local journal — not
the push — is the durability point, so injected failures may only
affect read-your-writes scatter eligibility, never ACKed data.
"""

from __future__ import annotations

import json
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

from ..utils.config import FAULT_PLAN

_ACTIONS = ("error", "delay", "truncate", "flip")


class FaultInjected(Exception):
    """Default exception raised by an ``error`` rule with no ``arg``."""


@dataclass(frozen=True)
class FaultRule:
    """One line of a fault schedule; see the module docstring."""
    site: str
    match: str = ""
    action: str = "error"
    arg: object = None
    p: float = 1.0
    count: int | None = None
    after: int = 0
    scope: str | None = None

    def __post_init__(self):
        if not self.site:
            raise ValueError("fault rule needs a non-empty 'site'")
        if self.action not in _ACTIONS:
            raise ValueError(
                f"fault rule action {self.action!r} not in {_ACTIONS}")
        if not (0.0 <= float(self.p) <= 1.0):
            raise ValueError(f"fault rule p={self.p} outside [0, 1]")


@dataclass(frozen=True)
class FaultPlan:
    """A seed plus an ordered tuple of rules."""
    seed: int
    rules: tuple

    @classmethod
    def parse(cls, text):
        """Parse the ``sdot.fault.plan`` JSON document."""
        doc = json.loads(text)
        if not isinstance(doc, dict):
            raise ValueError("fault plan must be a JSON object")
        known = {"site", "match", "action", "arg", "p", "count", "after",
                 "scope"}
        rules = []
        for i, r in enumerate(doc.get("rules", ())):
            extra = set(r) - known
            if extra:
                raise ValueError(
                    f"fault rule {i}: unknown fields {sorted(extra)}")
            rules.append(FaultRule(
                site=str(r.get("site", "")),
                match=str(r.get("match", "") or ""),
                action=str(r.get("action", "error")),
                arg=r.get("arg"),
                p=float(r.get("p", 1.0)),
                count=None if r.get("count") is None else int(r["count"]),
                after=int(r.get("after", 0)),
                scope=r.get("scope")))
        return cls(seed=int(doc.get("seed", 0)), rules=tuple(rules))


def _build_exc(name, site):
    """Map a rule's ``arg`` class name to an exception instance."""
    msg = f"fault-injected {name or 'FaultInjected'} at {site}"
    table = {
        None: FaultInjected,
        "FaultInjected": FaultInjected,
        "OSError": OSError,
        "ConnectionRefusedError": ConnectionRefusedError,
        "ConnectionResetError": ConnectionResetError,
        "TimeoutError": TimeoutError,
        "ValueError": ValueError,
    }
    if name == "LaneFullError":
        from ..wlm.admit import LaneFullError
        return LaneFullError(msg, retry_after_s=0.01)
    if name not in table:
        raise ValueError(f"fault rule arg {name!r} is not a known exception")
    return table[name](msg)


class FaultInjector:
    """Evaluates a :class:`FaultPlan` at named injection sites.

    Threaded through the stack as a ``.fault`` attribute (engine, broker,
    historical, WAL, tier store, WLM); every site guards on ``None`` so
    the un-injected hot path pays nothing.
    """

    def __init__(self, plan):
        self._lock = threading.Lock()   # leaf: never calls out while held
        self.plan = plan
        n = len(plan.rules)
        self._rngs = [random.Random((plan.seed << 16) ^ (i * 1000003 + 1))
                      for i in range(n)]
        self._evals = [0] * n
        self._fired = [0] * n
        self._scopes = {}               # scope name -> open depth

    # -- scope activation tokens (sdlint leaks pair: fault-scope) ---------
    def begin_scope(self, name):
        """Activate rules tagged ``scope: name``; returns a token for
        :meth:`end_scope`. Prefer the :meth:`scope` context manager."""
        with self._lock:
            self._scopes[name] = self._scopes.get(name, 0) + 1
        return name

    def end_scope(self, token):
        with self._lock:
            d = self._scopes.get(token, 0) - 1
            if d <= 0:
                self._scopes.pop(token, None)
            else:
                self._scopes[token] = d

    @contextmanager
    def scope(self, name):
        tok = self.begin_scope(name)
        try:
            yield tok
        finally:
            self.end_scope(tok)

    # -- evaluation -------------------------------------------------------
    def _decide(self, site, key):
        """Indices of rules that fire for this evaluation (under lock)."""
        hits = []
        with self._lock:
            for i, r in enumerate(self.plan.rules):
                if r.site != site:
                    continue
                if r.match and r.match not in (key or ""):
                    continue
                if r.scope is not None and not self._scopes.get(r.scope):
                    continue
                self._evals[i] += 1
                if self._evals[i] <= r.after:
                    continue
                if r.count is not None and self._fired[i] >= r.count:
                    continue
                if r.p < 1.0 and self._rngs[i].random() >= r.p:
                    continue
                self._fired[i] += 1
                hits.append(i)
        return hits

    def fire(self, site, key=None):
        """Evaluate ``fire``-style rules: ``delay`` sleeps, ``error``
        raises. Byte-mutation actions are ignored here."""
        for i in self._decide(site, key):
            r = self.plan.rules[i]
            if r.action == "delay":
                time.sleep(float(r.arg or 0.01))
            elif r.action == "error":
                raise _build_exc(r.arg, site)

    def mutate(self, site, data, key=None):
        """Evaluate ``mutate``-style rules against a byte payload;
        returns ``data`` itself (same object) when nothing fired."""
        for i in self._decide(site, key):
            r = self.plan.rules[i]
            if r.action == "truncate":
                data = data[:max(0, len(data) - int(r.arg or 1))]
            elif r.action == "flip":
                if len(data):
                    j = self._rngs[i].randrange(len(data))
                    data = data[:j] + bytes([data[j] ^ 0xFF]) + data[j + 1:]
            elif r.action == "delay":
                time.sleep(float(r.arg or 0.01))
        return data

    def stats(self):
        """Snapshot for ``last_stats["fault"]`` / chaos reports."""
        with self._lock:
            by_site = {}
            for i, r in enumerate(self.plan.rules):
                if self._fired[i]:
                    by_site[r.site] = by_site.get(r.site, 0) + self._fired[i]
            return {"seed": self.plan.seed, "rules": len(self.plan.rules),
                    "fired": sum(self._fired), "by_site": by_site,
                    "scopes": sorted(self._scopes)}

    @classmethod
    def from_config(cls, config):
        """Build from ``sdot.fault.plan``; ``None`` when unset."""
        text = str(config.get(FAULT_PLAN) or "").strip()
        if not text:
            return None
        return cls(FaultPlan.parse(text))
