"""Semantic query-result cache (≈ Druid's broker/historical result caches).

Port counterpart of ``spark_druid_olap_tpu/cache/__init__.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

``keys.py``     canonical cache keys from normalized QuerySpecs + the
                per-datasource ingest version (structural invalidation).
``result_cache.py``  byte-budgeted LRU over materialized host results and
                the engine-facing :class:`SemanticResultCache`.
``subsume.py``  derivability rules answering a query from a *superset*
                cached entry without touching the device.
"""
