"""Deterministic segment-shard -> historical assignment.

Port of ``spark_druid_olap_tpu/cluster/assign.py``, copied whole; the
cut comes from the port's ``parallel/multihost.py``.

≈ ``DruidMetadataCache.assignHistoricalServers`` with deep storage as the
coordination substrate: the plan is a pure function of (published
manifests, node list, replication factor), so the broker and every
historical compute the IDENTICAL plan independently — no coordinator
process, no gossip. A topology change is a new *plan epoch*
(cluster/epoch.py): members converge on the new plan without a restart.

Sharding reuses the multi-host cut algorithm
(``parallel/multihost.py:assign_segments_to_hosts``): contiguous
time-blocks of segments balanced by row count. Contiguity keeps each
shard one time range, so the broker's interval pruning could skip whole
nodes the way Druid's time-chunk assignment does.

Owner placement is **stability-aware** (rendezvous / highest-random-
weight hashing over stable logical node ids, with bounded loads): each
(datasource, shard) ranks every node by a CRC-derived score and takes
the best-ranked nodes with remaining capacity (``ceil(k / n)`` per
copy position) as owners. Adding a node moves roughly ~R/(N+1) of the
assignments — those where the newcomer out-ranks the incumbent plus
the capacity rebalance tail; removing a node moves little beyond its
own assignments. ``plan_diff``
reports exactly which (shard, copy) pairs move between two plans —
the elasticity harness asserts measured movement against it, and
against the old modular rotation (``strategy="modular"``, kept as a
kill switch) whose every N→N±1 transition reshuffles nearly all owners.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Tuple

from spark_druid_olap_tpu_torch.parallel.multihost import assign_segments_to_hosts
from spark_druid_olap_tpu_torch.persist import snapshot as SNAP


def shard_name(datasource: str, index: int, n_shards: int) -> str:
    """Store name a historical registers shard ``index`` under. The
    full-name prefix keeps result-cache keys and WLM attribution legible
    per node; '::' cannot appear in SQL identifiers, so shard stores are
    unreachable from user queries."""
    return f"{datasource}::shard{index}of{n_shards}"


@dataclasses.dataclass(frozen=True)
class Shard:
    index: int
    segment_indexes: Tuple[int, ...]   # indexes into the manifest's segment list
    rows: int
    owners: Tuple[int, ...]            # node ids, primary first
    # time envelope over member segments ([min_ms, max_ms] inclusive);
    # empty shard keeps the (0, -1) sentinel, which no interval overlaps
    min_ms: int = 0
    max_ms: int = -1


@dataclasses.dataclass(frozen=True)
class DatasourcePlan:
    name: str
    snapshot_version: int
    ingest_version: int
    num_rows: int
    num_segments: int
    shards: Tuple[Shard, ...]

    @property
    def n_shards(self) -> int:
        return len(self.shards)


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    n_nodes: int
    replication: int
    datasources: Dict[str, DatasourcePlan]
    # stable logical node ids, parallel to node indexes (epoch record
    # ids; "n0".."nK" for the implicit bootstrap epoch). The owner
    # hash keys — NOT addresses (ports change per run) and NOT indexes
    # (they shift on removal).
    node_keys: Tuple[str, ...] = ()
    epoch: int = 0

    def shards_of(self, node_id: int) -> Dict[str, Tuple[Shard, ...]]:
        """datasource -> shards this node owns (primary or replica)."""
        out = {}
        for name, dp in self.datasources.items():
            owned = tuple(sh for sh in dp.shards if node_id in sh.owners)
            if owned:
                out[name] = owned
        return out


_M64 = (1 << 64) - 1


def _score(ds_name: str, shard_index: int, node_key: str) -> int:
    """Rendezvous weight of one node for one shard. CRC32 of the parts
    (stable across processes, unlike salted str hash) combined through a
    splitmix64-style finalizer — a plain CRC over the concatenation is
    affine in the shard digits, so rankings would barely vary per shard
    and whole datasources would pile onto one node."""
    h = (zlib.crc32(ds_name.encode("utf-8")) * 0x9E3779B1
         ^ (shard_index + 1) * 0x85EBCA77
         ^ zlib.crc32(node_key.encode("utf-8")) * 0xC2B2AE3D) & _M64
    h ^= h >> 30
    h = (h * 0xBF58476D1CE4E5B9) & _M64
    h ^= h >> 27
    h = (h * 0x94D049BB133111EB) & _M64
    return h ^ (h >> 31)


def _ranked(ds_name: str, shard_index: int,
            node_keys: Tuple[str, ...]) -> Tuple[int, ...]:
    """All nodes ordered by rendezvous score for one shard, best first.
    Determinism tiebreak on the logical key so equal scores can't
    reorder between processes."""
    return tuple(sorted(
        range(len(node_keys)),
        key=lambda j: (-_score(ds_name, shard_index, node_keys[j]),
                       node_keys[j])))


def _owners_balanced(ds_name: str, k: int, node_keys: Tuple[str, ...],
                     r: int) -> Tuple[Tuple[int, ...], ...]:
    """Bounded-load rendezvous for all ``k`` shards of one datasource.

    Pure rendezvous makes no balance promise at small shard counts — a
    2-shard datasource can land both primaries on one node, which
    starves the other node's WLM lanes and breaks every the-other-node-
    serves-something expectation. So each copy position (primary,
    first replica, …) caps per-node load at ``ceil(k / n)``: shards
    take their highest-ranked node with remaining capacity. Stability
    survives: a shard moves only when its ranked chain or the capacity
    frontier shifts, so an N→N+1 epoch still moves ~1/(N+1) of the
    assignments instead of the modular rotation's almost-all — and
    ``plan_diff`` reports the exact set either way."""
    n = len(node_keys)
    cap = -(-k // n)
    loads = [[0] * n for _ in range(r)]
    out = []
    for i in range(k):
        ranked = _ranked(ds_name, i, node_keys)
        owners: list = []
        for c in range(r):
            pick = next((j for j in ranked
                         if j not in owners and loads[c][j] < cap),
                        None)
            if pick is None:
                # capacity exhausted by the distinctness constraint
                # (only possible when r is close to n): relax the cap
                pick = next(j for j in ranked if j not in owners)
            owners.append(pick)
            loads[c][pick] += 1
        out.append(tuple(owners))
    return tuple(out)


def _plan_datasource(manifest: dict, n_nodes: int, replication: int,
                     n_shards: int, node_keys: Tuple[str, ...],
                     strategy: str) -> DatasourcePlan:
    name = manifest["datasource"]
    segs = manifest["segments"]            # [[id, start, end, min_ms, max_ms]]
    rows = [int(e[2]) - int(e[1]) for e in segs]
    want = n_shards if n_shards > 0 else n_nodes
    k = max(1, min(want, len(segs)))
    cut = assign_segments_to_hosts(rows, k)
    # modular fallback: primary rotation by datasource-name CRC (the
    # pre-epoch placement; nearly every owner moves on N -> N±1)
    base = zlib.crc32(name.encode("utf-8"))
    r = min(max(1, replication), n_nodes)
    stable = (_owners_balanced(name, k, node_keys, r)
              if strategy != "modular" else None)
    shards = []
    for i in range(k):
        members = tuple(int(j) for j in range(len(cut)) if int(cut[j]) == i)
        if strategy == "modular":
            primary = (base + i) % n_nodes
            owners = tuple((primary + c) % n_nodes for c in range(r))
        else:
            owners = stable[i]
        shards.append(Shard(index=i, segment_indexes=members,
                            rows=sum(rows[j] for j in members),
                            owners=owners,
                            min_ms=min((int(segs[j][3]) for j in members),
                                       default=0),
                            max_ms=max((int(segs[j][4]) for j in members),
                                       default=-1)))
    return DatasourcePlan(
        name=name,
        snapshot_version=int(manifest["snapshot_version"]),
        ingest_version=int(manifest["ingest_version"]),
        num_rows=int(manifest["num_rows"]),
        num_segments=len(segs),
        shards=tuple(shards))


def plan_cluster(persist_root: str, n_nodes: int, replication: int,
                 n_shards: int = 0,
                 manifests: Optional[Dict[str, dict]] = None,
                 node_keys: Optional[Tuple[str, ...]] = None,
                 epoch: int = 0,
                 strategy: str = "stable") -> ClusterPlan:
    """Compute the full cluster plan from deep storage.

    ``manifests`` injects a pre-scanned catalog (tests, or a broker that
    already holds one); otherwise the root is scanned fresh.
    ``node_keys`` are the epoch record's stable logical ids (defaults to
    the bootstrap ``n0..nK``). Determinism contract: identical
    (manifests, node_keys, replication, n_shards, strategy) -> identical
    plan, on any process, in any order of discovery."""
    if n_nodes < 1:
        raise ValueError("cluster plan needs at least one node")
    if node_keys is None:
        node_keys = tuple(f"n{i}" for i in range(n_nodes))
    if len(node_keys) != n_nodes:
        raise ValueError(f"{len(node_keys)} node keys for {n_nodes} nodes")
    if strategy not in ("stable", "modular"):
        raise ValueError(f"unknown assignment strategy {strategy!r}")
    if manifests is None:
        manifests = SNAP.datasource_manifests(persist_root)
    dss = {}
    for name in sorted(manifests):
        dss[name] = _plan_datasource(manifests[name], n_nodes,
                                     replication, n_shards,
                                     tuple(node_keys), strategy)
    return ClusterPlan(n_nodes=n_nodes,
                       replication=min(max(1, replication), n_nodes),
                       datasources=dss,
                       node_keys=tuple(node_keys),
                       epoch=int(epoch))


@dataclasses.dataclass(frozen=True)
class PlanDiff:
    """Exact assignment movement between two plans, keyed by logical
    node id (so epochs with shifted indexes compare correctly). One
    entry per (datasource, shard index, node key) ownership pair."""

    added: Tuple[Tuple[str, int, str], ...]    # pairs to warm
    removed: Tuple[Tuple[str, int, str], ...]  # pairs to retire
    total: int                                  # assignments in `new`
    unchanged: int

    @property
    def moved(self) -> int:
        return len(self.added)

    def summary(self) -> dict:
        return {"moved": self.moved, "removed": len(self.removed),
                "unchanged": self.unchanged, "total": self.total}


def _assignment_pairs(plan: ClusterPlan):
    pairs = set()
    for name, dp in plan.datasources.items():
        for sh in dp.shards:
            for nid in sh.owners:
                pairs.add((name, sh.index, plan.node_keys[nid]))
    return pairs


def plan_diff(old: ClusterPlan, new: ClusterPlan) -> PlanDiff:
    """Deterministic movement report: which (shard, copy) ownership
    pairs exist in ``new`` but not ``old`` (must be warmed) and vice
    versa (may be retired). When a datasource's shard count differs
    between the plans its composition changed, and every one of its new
    pairs counts as added — shard indexes only compare within an equal
    cut."""
    a = _assignment_pairs(old)
    b = _assignment_pairs(new)
    # shard counts must match per datasource for index-wise comparison
    recut = {name for name in new.datasources
             if name in old.datasources
             and old.datasources[name].n_shards
             != new.datasources[name].n_shards}
    if recut:
        a = {p for p in a if p[0] not in recut}
    added = tuple(sorted(b - a))
    removed = tuple(sorted(a - b))
    return PlanDiff(added=added, removed=removed, total=len(b),
                    unchanged=len(b) - len(added))


def plan_fully_warm(plan: ClusterPlan, adverts: Dict[int, set]) -> bool:
    """The epoch-handover gate, as a pure function both sides share:
    ``adverts`` maps node id (index into ``plan``'s node list) to the
    set of shard-store names that node advertises warm for this epoch
    (from the extended ``/readyz``). True when every (datasource,
    shard) of the plan has at least one owner advertising it — the
    broker swaps on this condition, and a leaving historical begins its
    drain on the same condition, so neither can observe "ready" before
    the other could."""
    for name, dp in plan.datasources.items():
        for sh in dp.shards:
            sname = shard_name(name, sh.index, dp.n_shards)
            if not any(sname in adverts.get(nid, ())
                       for nid in sh.owners):
                return False
    return True


def parse_nodes(spec: str) -> Tuple[Tuple[str, int], ...]:
    """'host:port,host:port' -> ((host, port), ...); index = node id."""
    out = []
    for part in (spec or "").replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad cluster node address {part!r} "
                             "(want host:port)")
        out.append((host, int(port)))
    return tuple(out)
