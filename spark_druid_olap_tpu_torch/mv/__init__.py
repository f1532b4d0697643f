"""Materialized rollup datasources (mv/).

Port counterpart of ``spark_druid_olap_tpu/mv/__init__.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

Pre-aggregated, segment-backed rollup datasources declared with
``CREATE ROLLUP``, built through the existing engine, and transparently
substituted for the base datasource by the planner when a query is
answerable from the rollup (mv/match.py). ≈ Druid rollup at ingest plus
Sparkline rewriting queries onto the rolled-up index.
"""

from spark_druid_olap_tpu_torch.mv.registry import (  # noqa: F401
    RollupDef, create_rollup, drop_rollup, refresh_rollup, rollups_view)
