"""General (non-star) join execution tiers.

Port of ``spark_druid_olap_tpu/join/__init__.py``. The star joins collapse
in ``planner/builder.py``; every other recognized two-table join runs here,
above ``ops/hash_join.py``:

- :mod:`spark_druid_olap_tpu_torch.join.broadcast`: broadcast hash join.
  The build side fits ``sdot.join.broadcast.max.bytes``; its hash table is
  built once on the host, moved to the device, and probed inside the
  engine's segment wave loop.

- :mod:`spark_druid_olap_tpu_torch.join.partitioned`: shard-aligned
  partitioned join. A broker re-shards both sides on the join key through
  the historicals (a hash-partition exchange over the SDW1 wire, its
  shuffle bytes counted exactly) and each node joins its aligned
  partitions on its own device.

``planner/joinplan.py`` recognizes join statements, picks the tier
through ``parallel/cost.py:join_estimate``, and applies the shared
epilogue.
"""

from spark_druid_olap_tpu_torch.ops.hash_join import JoinUnsupported  # noqa: F401
