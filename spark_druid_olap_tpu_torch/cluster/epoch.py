"""Plan epochs: versioned active-node lists in deep storage.

Port of ``spark_druid_olap_tpu/cluster/epoch.py``, copied whole: the
records are the JAX package's, so members of both packages read one
root's epochs alike.

Elastic topology without a coordinator or a restart. The shard plan
stays a pure function (cluster/assign.py), but its node-list input is
now *versioned*: a small epoch record under ``<persist-root>/.cluster/``
(dot-prefixed, so the datasource catalog scan never mistakes it for a
datasource). Publishing a new record with one node added or removed IS
the whole membership protocol — the broker and every historical poll
the record and run the handover dance themselves:

1. a joining historical sees an epoch that includes it, warms its newly
   owned shards from the cold tier, and only then advertises the epoch
   on ``/readyz``;
2. the broker keeps scattering against the OLD epoch until every shard
   of the new plan has at least one owner advertising it warm, then
   swaps atomically (in-flight scatters finish on the captured old
   state);
3. a leaving historical watches the same readiness condition, then
   drains in-flight subqueries and fences.

Durability discipline is exactly the persist manifest protocol
(persist/snapshot.py): records are written tmp + fsync + ``os.replace``
into ``epoch-%010d.json``, then a ``CURRENT`` pointer flips atomically.
A crash between the record write and the CURRENT flip leaves an inert
orphan — readers stay on the old epoch, and the next publish allocates
past the orphan (numbers are never reused). The ``epoch.publish`` fault
site sits exactly in that window so the crash is testable.

Node identity: each member has a stable *logical id* (``n0``, ``n1``,
…) assigned at join and never reused. The stability-aware owner
assignment hashes logical ids, not list indexes or addresses, so a
node's shards survive an address change and a removal elsewhere in the
list — and a replayed harness run with fresh ports computes the
identical plan. ``generation`` bumps when an id rejoins after leaving,
which is what lets the broker reset that node's breaker state instead
of inheriting the predecessor's open circuit.

Concurrent publishers (two operators running ``add-node`` at once)
serialize on a lock file; the claim/release pair is registered with the
sdlint leaks pass, so a publish path that could exit holding the lock
is a lint finding, not a wedged cluster.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional, Sequence, Tuple

from spark_druid_olap_tpu_torch.persist.snapshot import fsync_dir

EPOCH_DIR = ".cluster"
CURRENT = "CURRENT"
LOCK = "publish.lock"
_FMT = "epoch-%010d.json"


class EpochBusy(RuntimeError):
    """Another publisher holds the epoch publish lock."""


class EpochCorrupt(RuntimeError):
    """No parseable epoch record behind a CURRENT pointer."""


@dataclasses.dataclass(frozen=True)
class EpochRecord:
    """One versioned membership snapshot.

    ``nodes`` are ``host:port`` strings (index order = node id within
    this epoch); ``ids`` are the parallel stable logical identifiers;
    ``generations`` maps logical id -> generation (bumped on rejoin).
    ``epoch`` 0 with ``path`` None is the implicit bootstrap record
    derived from ``sdot.cluster.nodes`` when deep storage holds no
    published record yet — byte-identical on every member because the
    config is."""

    epoch: int
    nodes: Tuple[str, ...]
    ids: Tuple[str, ...]
    generations: Dict[str, int]
    created_at: float = 0.0
    note: str = ""

    @property
    def addresses(self) -> Tuple[Tuple[str, int], ...]:
        out = []
        for part in self.nodes:
            host, _, port = part.rpartition(":")
            out.append((host, int(port)))
        return tuple(out)

    def id_of(self, address: str) -> Optional[str]:
        try:
            return self.ids[self.nodes.index(address)]
        except ValueError:
            return None

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "nodes": list(self.nodes),
                "ids": list(self.ids),
                "generations": dict(self.generations),
                "created_at": self.created_at, "note": self.note}

    @staticmethod
    def from_dict(d: dict) -> "EpochRecord":
        nodes = tuple(str(n) for n in d["nodes"])
        ids = tuple(str(i) for i in d.get("ids") or default_ids(len(nodes)))
        if len(ids) != len(nodes):
            raise ValueError("epoch record ids/nodes length mismatch")
        return EpochRecord(
            epoch=int(d["epoch"]), nodes=nodes, ids=ids,
            generations={str(k): int(v)
                         for k, v in (d.get("generations") or {}).items()},
            created_at=float(d.get("created_at", 0.0)),
            note=str(d.get("note", "")))


def default_ids(n: int) -> Tuple[str, ...]:
    return tuple(f"n{i}" for i in range(n))


def bootstrap_record(nodes: Sequence[str]) -> EpochRecord:
    """Implicit epoch 0 from the static config node list (never written
    to disk): the pre-elasticity behavior, and the base every published
    epoch diffs against."""
    nodes = tuple(nodes)
    ids = default_ids(len(nodes))
    return EpochRecord(epoch=0, nodes=nodes, ids=ids,
                       generations={i: 0 for i in ids})


def epoch_root(persist_root: str) -> str:
    return os.path.join(os.path.abspath(persist_root), EPOCH_DIR)


def _list_epochs(eroot: str):
    out = []
    try:
        entries = os.listdir(eroot)
    except OSError:
        return out
    for n in entries:
        if n.startswith("epoch-") and n.endswith(".json"):
            try:
                out.append(int(n[len("epoch-"):-len(".json")]))
            except ValueError:
                continue
    return sorted(out)


def read_epoch(persist_root: str) -> Optional[EpochRecord]:
    """Current published epoch record, or None when none was ever
    published (members fall back to the bootstrap record). CURRENT is
    authoritative: an orphan record past it (crash between the record
    write and the pointer flip) stays inert until republished."""
    eroot = epoch_root(persist_root)
    cur = os.path.join(eroot, CURRENT)
    try:
        with open(cur) as f:
            n = int(json.load(f)["epoch"])
    except (OSError, ValueError, KeyError):
        return None
    try:
        with open(os.path.join(eroot, _FMT % n)) as f:
            return EpochRecord.from_dict(json.load(f))
    except (OSError, ValueError, KeyError) as e:
        # the pointer exists but its record is gone/corrupt: fall back
        # to the newest older record rather than flapping to bootstrap
        # (which would look like a mass topology change)
        for v in reversed(_list_epochs(eroot)):
            if v >= n:
                continue
            try:
                with open(os.path.join(eroot, _FMT % v)) as f:
                    return EpochRecord.from_dict(json.load(f))
            except (OSError, ValueError, KeyError):
                continue
        raise EpochCorrupt(f"CURRENT points at epoch {n} but no "
                           f"parseable record exists: {e}") from e


def claim_publish(persist_root: str,
                  stale_after_s: float = 30.0) -> str:
    """Take the publish lock (O_CREAT|O_EXCL lock file). Returns the
    lock path as the claim token; MUST be released via
    :func:`release_publish` (sdlint leaks pair). A lock file older than
    ``stale_after_s`` is a crashed publisher and is broken."""
    eroot = epoch_root(persist_root)
    os.makedirs(eroot, exist_ok=True)
    path = os.path.join(eroot, LOCK)
    for _attempt in range(2):
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, str(os.getpid()).encode())
            os.close(fd)
            return path
        except FileExistsError:
            try:
                age = time.time() - os.path.getmtime(path)
            except OSError:
                continue        # released between the open and the stat
            if age > stale_after_s:
                try:
                    os.remove(path)
                except OSError:
                    pass
                continue
            raise EpochBusy(
                f"epoch publish in progress ({path}, {age:.1f}s old)")
    raise EpochBusy(f"epoch publish lock {path} could not be claimed")


def release_publish(token: str) -> None:
    try:
        os.remove(token)
    except OSError:
        pass


def next_record(prev: Optional[EpochRecord], nodes: Sequence[str],
                next_epoch: int, note: str = "") -> EpochRecord:
    """Build the successor record: surviving logical ids carry over
    (same id, same generation — their shards don't move), brand-new
    addresses get the next free id, and an address that left and came
    back keeps its id but bumps its generation (fresh breaker state,
    same shard affinity)."""
    nodes = tuple(nodes)
    if len(set(nodes)) != len(nodes):
        raise ValueError(f"duplicate addresses in node list: {nodes}")
    prev_map = {} if prev is None else dict(zip(prev.nodes, prev.ids))
    gens = {} if prev is None else dict(prev.generations)
    used = set(gens) | set(prev_map.values())
    ids = []
    for addr in nodes:
        nid = prev_map.get(addr)
        if nid is None:
            # an id is never reused by a different address; scan for the
            # lowest free one so bootstrap-compatible lists keep n0..nK
            i = 0
            while f"n{i}" in used:
                i += 1
            nid = f"n{i}"
            used.add(nid)
            gens[nid] = next_epoch
        ids.append(nid)
    # ids that left keep their generation entry: if the same id's
    # address ever rejoins it would be a *new* id, but an id explicitly
    # re-added via add-node after remove-node bumps below
    gens = {i: g for i, g in gens.items() if i in ids}
    return EpochRecord(epoch=next_epoch, nodes=nodes, ids=tuple(ids),
                       generations=gens, created_at=time.time(),
                       note=note)


def publish_epoch(persist_root: str, nodes: Sequence[str],
                  note: str = "", fault=None) -> EpochRecord:
    """Publish a new epoch record atomically and return it.

    Protocol (persist/snapshot.py discipline): allocate max+1 over the
    record FILES (not CURRENT — an orphan must never be overwritten),
    write tmp + fsync + os.replace + dir fsync, then flip CURRENT the
    same way. The ``epoch.publish`` fault site fires between the two
    steps: an error rule there models the publisher dying after the
    record landed but before the flip — readers keep the old epoch and
    a re-publish allocates past the orphan."""
    tok = claim_publish(persist_root)
    try:
        eroot = epoch_root(persist_root)
        prev = read_epoch(persist_root)
        have = _list_epochs(eroot)
        nxt = max([prev.epoch if prev else 0] + have) + 1
        rec = next_record(prev, nodes, nxt, note=note)
        tmp = os.path.join(eroot, f".tmp-{os.getpid()}-{nxt}.json")
        with open(tmp, "w") as f:
            json.dump(rec.to_dict(), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(eroot, _FMT % nxt))
        fsync_dir(eroot)
        if fault is not None:
            # crash window: the record exists, CURRENT still points at
            # the previous epoch
            fault.fire("epoch.publish", key=f"epoch:{nxt}")
        ctmp = os.path.join(eroot, CURRENT + ".tmp")
        with open(ctmp, "w") as f:
            json.dump({"epoch": nxt}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(ctmp, os.path.join(eroot, CURRENT))
        fsync_dir(eroot)
        return rec
    finally:
        release_publish(tok)
