"""Per-tenant quotas: concurrent-query caps and cost token buckets.

Port counterpart of ``spark_druid_olap_tpu/wlm/quota.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

≈ Druid's per-user `druid.query.scheduler` limits + the reference
deployment's per-BI-tool resource groups: a tenant (the serving layer's
``X-Sdot-Tenant`` header / ``context.tenant``) gets

- a **concurrent-query cap** — hard ceiling on in-flight queries, and
- a **token bucket denominated in estimated cost units** (the abstract
  units of ``parallel/cost.estimate``): each admission charges the
  query's estimated cost; the bucket refills at a configured rate, so a
  tenant can burst to its capacity but sustains only its refill rate.

Quotas are configured as ``sdot.wlm.quota.<tenant>`` config keys with a
``concurrent=N,budget=F,refill=F`` grammar; ``sdot.wlm.quota.default``
applies to tenants without an explicit entry. No configured quota (and
no default) = unlimited — the subsystem must cost nothing when unused.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from spark_druid_olap_tpu_torch.wlm.lanes import AdmissionRejected

QUOTA_PREFIX = "sdot.wlm.quota."


class QuotaExceededError(AdmissionRejected):
    """Tenant over its concurrent cap or out of budget tokens."""


class TokenBucket:
    """Classic token bucket over float cost units. ``now_fn`` is
    injectable so tests advance time deterministically."""

    def __init__(self, capacity: float, refill_per_s: float,
                 now_fn: Callable[[], float] = time.monotonic):
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._now = now_fn
        self._tokens = self.capacity
        self._last = self._now()

    def _refill(self) -> None:
        now = self._now()
        dt = max(0.0, now - self._last)
        self._last = now
        self._tokens = min(self.capacity,
                           self._tokens + dt * self.refill_per_s)

    def tokens(self) -> float:
        self._refill()
        return self._tokens

    def try_charge(self, cost: float) -> bool:
        self._refill()
        if self._tokens >= cost:
            self._tokens -= cost
            return True
        return False

    def seconds_until(self, cost: float) -> float:
        """Time until ``cost`` tokens are available (inf if the bucket
        can never hold that many)."""
        self._refill()
        if self._tokens >= cost:
            return 0.0
        if cost > self.capacity or self.refill_per_s <= 0:
            return float("inf")
        return (cost - self._tokens) / self.refill_per_s


class _TenantState:
    __slots__ = ("name", "max_concurrent", "bucket", "active", "admitted",
                 "rejected", "cost_charged")

    def __init__(self, name: str, max_concurrent: int,
                 bucket: Optional[TokenBucket]):
        self.name = name
        self.max_concurrent = max_concurrent   # 0 = unlimited
        self.bucket = bucket                   # None = no budget
        self.active = 0
        self.admitted = 0
        self.rejected = 0
        self.cost_charged = 0.0


def _parse_quota(tenant: str, spec: str):
    """``concurrent=N,budget=F,refill=F`` -> (max_concurrent, budget,
    refill). budget without refill never replenishes past the burst."""
    kw = {"concurrent": 0, "budget": 0.0, "refill": 0.0}
    for opt in str(spec).split(","):
        opt = opt.strip()
        if not opt:
            continue
        k, _, v = opt.partition("=")
        k = k.strip()
        if k not in kw:
            raise ValueError(f"unknown quota option {k!r} for tenant "
                             f"{tenant!r}; known: {sorted(kw)}")
        kw[k] = float(v) if k != "concurrent" else int(v)
    return kw["concurrent"], kw["budget"], kw["refill"]


class QuotaManager:
    """Tenant registry; all mutation under the WorkloadManager's lock
    (passed-in critical sections — this class holds no lock itself
    except bucket arithmetic, which is per-call and cheap)."""

    def __init__(self, now_fn: Callable[[], float] = time.monotonic):
        self._now = now_fn
        self._tenants: Dict[str, _TenantState] = {}
        self._configured: Dict[str, str] = {}

    def configure(self, quota_specs: Dict[str, str]) -> None:
        """(Re)build tenant states from ``{tenant: spec}``; live active
        counts survive a reconfigure, buckets reset (a changed budget
        starts full — the operator just asked for new limits)."""
        if quota_specs == self._configured:
            return
        self._configured = dict(quota_specs)
        old = self._tenants
        self._tenants = {}
        for tenant, spec in quota_specs.items():
            conc, budget, refill = _parse_quota(tenant, spec)
            bucket = TokenBucket(budget, refill, self._now) \
                if budget > 0 else None
            st = _TenantState(tenant, conc, bucket)
            prev = old.get(tenant)
            if prev is not None:
                st.active = prev.active
                st.admitted = prev.admitted
                st.rejected = prev.rejected
                st.cost_charged = prev.cost_charged
        # keep unconfigured-but-active tenants visible (pure observation)
            self._tenants[tenant] = st
        for name, prev in old.items():
            if name not in self._tenants and (prev.active or prev.admitted):
                self._tenants[name] = _TenantState(name, 0, None)
                self._tenants[name].active = prev.active
                self._tenants[name].admitted = prev.admitted

    def _state_for(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            # fall back to the 'default' template if configured
            tpl = self._configured.get("default")
            if tpl is not None:
                conc, budget, refill = _parse_quota(tenant, tpl)
                bucket = TokenBucket(budget, refill, self._now) \
                    if budget > 0 else None
                st = _TenantState(tenant, conc, bucket)
            else:
                st = _TenantState(tenant, 0, None)
            self._tenants[tenant] = st
        return st

    def acquire(self, tenant: Optional[str], cost: float) -> Optional[str]:
        """Admit one query for ``tenant`` (None = untracked). Raises
        :class:`QuotaExceededError` on cap/budget violation; returns the
        tenant key to pass back to :meth:`release`."""
        if not tenant:
            return None
        st = self._state_for(tenant)
        if st.max_concurrent > 0 and st.active >= st.max_concurrent:
            st.rejected += 1
            raise QuotaExceededError(
                f"tenant {tenant!r} at its concurrent-query cap "
                f"({st.max_concurrent})", retry_after_s=1.0)
        if st.bucket is not None and not st.bucket.try_charge(cost):
            st.rejected += 1
            wait = st.bucket.seconds_until(cost)
            raise QuotaExceededError(
                f"tenant {tenant!r} out of cost budget "
                f"(need {cost:.4g} units)",
                retry_after_s=min(wait if wait != float("inf") else 60.0,
                                  60.0))
        st.active += 1
        st.admitted += 1
        st.cost_charged += cost
        return tenant

    def release(self, tenant: Optional[str]) -> None:
        if not tenant:
            return
        st = self._tenants.get(tenant)
        if st is not None:
            st.active = max(0, st.active - 1)

    def snapshot(self) -> list:
        out = []
        for name in sorted(self._tenants):
            st = self._tenants[name]
            out.append({
                "tenant": name, "active": st.active,
                "max_concurrent": st.max_concurrent,
                "budget": st.bucket.capacity if st.bucket else 0.0,
                "tokens": round(st.bucket.tokens(), 4) if st.bucket else 0.0,
                "refill_per_s": st.bucket.refill_per_s if st.bucket else 0.0,
                "admitted": st.admitted, "rejected": st.rejected,
                "cost_charged": round(st.cost_charged, 4)})
        return out


def quotas_from_config(config) -> Dict[str, str]:
    """Extract ``sdot.wlm.quota.<tenant>`` entries from a session
    Config (unknown sdot.* keys are accepted by design, so quota specs
    ride the normal config channel)."""
    return {k[len(QUOTA_PREFIX):]: str(v)
            for k, v in config.prefixed(QUOTA_PREFIX).items()
            if k[len(QUOTA_PREFIX):]}
