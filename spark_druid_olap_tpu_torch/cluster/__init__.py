"""Distributed serving tier: broker + replicated historicals.

Port of ``spark_druid_olap_tpu/cluster/``: the modules are copies kept
inside the PyTorch package, which imports nothing of the JAX package,
with one device per node. Historicals answer through the port's ordinary
``QueryEngine.execute`` on their device, so every kernel path (B1 per
shard, B2 where a node coalesces a storm) runs there. Frames on the wire
are the JAX package's byte for byte, so a broker of either package can
scatter to historicals of the other. The partitioned join's exchange
routes (``/cluster/join/partition``, ``/cluster/join/exec``) serve
``join/partitioned.py``, whose probe runs on the node's device; the
broker counts them in ``join_scatters`` and ``join_shuffle_bytes``.

The reference system's L1/L2 plane — a broker that scatters per-segment
subqueries to historical servers (``DruidMetadataCache.assignHistoricalServers``)
and merges partials — realized as real processes over the engine:

- ``assign.py``    deterministic shard plan from deep-storage manifests
                   (no coordinator service: the persist/ root IS the
                   coordination substrate)
- ``historical.py``  a serving node: PersistManager recovery, slice to
                   owned shards, subquery RPC over the full QueryEngine
                   (WLM lanes, result cache, rollup rewrite, shared-scan
                   coalescing all apply per node)
- ``broker.py``    plans once, scatters per-shard subqueries, merges
                   partials (merge-closed aggs + HLL/theta register
                   merge), runs TopN/limit/ordering epilogues, fails a
                   shard over to replicas with decorrelated-jitter
                   backoff, probes node health
- ``wire.py``      pickle-free binary result encoding for the RPC
- ``merge.py``     host-side partial-merge kernels (exact int sums,
                   NaN-null floats, register max/min for sketches)

``python -m spark_druid_olap_tpu_torch.cluster`` launches either role.
"""

from spark_druid_olap_tpu_torch.cluster.assign import (  # noqa: F401
    ClusterPlan,
    DatasourcePlan,
    Shard,
    plan_cluster,
    shard_name,
)
