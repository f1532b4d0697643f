"""Workload management — query lanes, admission control, tenant quotas.

Port counterpart of ``spark_druid_olap_tpu/wlm/__init__.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

≈ Druid's broker-tier *query laning and prioritization* (Druid docs
"query laning"; `QueryScheduler` + laning strategies), the piece that
lets the reference's serving tier survive concurrent BI traffic: every
query is classified into a named **lane** with bounded concurrency and
queue depth, expensive queries are demoted to a low-priority lane by the
cost model, and per-tenant **quotas** (concurrent-query caps + a
token-bucket budget denominated in estimated cost units) keep one tenant
from starving the rest. Overload sheds load with a retryable rejection
instead of melting every in-flight query at once.

Layout:

- :mod:`~spark_druid_olap_tpu_torch.wlm.lanes` — lane configuration and
  runtime state (slots, bounded priority queue, counters);
- :mod:`~spark_druid_olap_tpu_torch.wlm.admit` — :class:`WorkloadManager`:
  classification (explicit ``context.lane`` / cost-threshold demotion),
  priority-ordered FIFO admission, load shedding;
- :mod:`~spark_druid_olap_tpu_torch.wlm.quota` — per-tenant concurrent caps
  and token buckets.

Wired into ``QueryEngine.execute`` (the single funnel every front door
— HTTP, Flight, raw specs — drains into), so a shed query never reaches
the executor and queue wait counts against the query's deadline.
"""

from spark_druid_olap_tpu_torch.wlm.lanes import (AdmissionRejected, Lane,
                                                  LaneConfig, parse_lanes)
from spark_druid_olap_tpu_torch.wlm.admit import (LaneFullError, Ticket,
                                                  WorkloadManager)
from spark_druid_olap_tpu_torch.wlm.quota import (QuotaExceededError,
                                                  QuotaManager, TokenBucket)

__all__ = [
    "AdmissionRejected", "Lane", "LaneConfig", "parse_lanes",
    "LaneFullError", "Ticket", "WorkloadManager",
    "QuotaExceededError", "QuotaManager", "TokenBucket",
]
