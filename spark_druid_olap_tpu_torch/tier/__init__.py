"""Out-of-core tiered storage: persist/ snapshots as a first-class cold
tier behind a byte-budgeted hot set (port of ``spark_druid_olap_tpu/tier``:
``store``, ``handles`` and ``loader`` less ``slice_tiered``, whose caller is
the cluster's historical, ROADMAP A.9)."""
