"""Deterministic fault injection (chaos): a copy of
``spark_druid_olap_tpu/fault/`` (see ``docs/CHAOS.md``)."""

from .plan import FaultInjected, FaultInjector, FaultPlan, FaultRule

__all__ = ["FaultInjected", "FaultInjector", "FaultPlan", "FaultRule"]
