"""Durable segment persistence: deep storage, ingest WAL, crash recovery.

Port counterpart of ``spark_druid_olap_tpu/persist/``: copies kept inside
the PyTorch package, which imports nothing of the JAX package. The bytes
on disk (snapshot manifests and blobs, WAL frames) are the JAX package's,
so a root written by either package recovers in the other.

- :mod:`spark_druid_olap_tpu_torch.persist.snapshot` — versioned on-disk
  snapshot format (per-column binary blobs, raw or encoded, + JSON
  manifest with schema, segment map, ingest version, per-file CRC32
  checksums), published via atomic temp-dir + rename.
- :mod:`spark_druid_olap_tpu_torch.persist.wal` — framed, checksummed
  write-ahead journal for ``stream_ingest`` appends (commit point =
  journal fsync, group commit), torn-tail tolerant replay.
- :mod:`spark_druid_olap_tpu_torch.persist.compact` — time-partitioned
  rebuild of a stream-appended tail, published as a new generation.
- :mod:`spark_druid_olap_tpu_torch.persist.manager` — checkpoint /
  recovery orchestration: background checkpointer and compactor,
  catalog + rollup-registry + ingest-version restore, corrupt-snapshot
  quarantine, history-driven warmup ordering.

Configured by the ``sdot.persist.*`` family (utils/config.py); disabled
entirely when ``sdot.persist.path`` is empty.
"""

from spark_druid_olap_tpu_torch.persist.manager import PersistManager  # noqa: F401
