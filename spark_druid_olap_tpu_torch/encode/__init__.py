"""Dictionary-predicate rewrites (port of ``spark_druid_olap_tpu/encode``;
only ``predicates`` is ported)."""
