"""Out-of-core tiered storage: persist/ snapshots as a first-class cold
tier behind a byte-budgeted hot set (port of ``spark_druid_olap_tpu/tier``:
``store``, ``handles`` and ``loader``; ``loader.slice_tiered`` serves the
cluster historical's tiered boot)."""
