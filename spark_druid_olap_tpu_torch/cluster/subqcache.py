"""Broker-side shard-level subquery result cache.

Port of ``spark_druid_olap_tpu/cluster/subqcache.py``, copied whole.

A dashboard storm re-sends the same small query family every few
seconds; interval pruning already skips shards whose time envelope
misses the filter, but every *surviving* shard still costs an RPC and a
historical-side execution. This cache short-circuits that: the partial
result of one (subquery shape, shard) pair is kept on the broker and
replayed on the next identical scatter.

Key discipline (the correctness core):

- ``body_key`` — SHA-256 of the UNPATCHED subquery body (canonical
  serialized spec, before the per-shard datasource rewrite), so one
  logical query maps to one key family across all shards;
- shard identity — ``(datasource, shard index, n_shards)``. NOT the
  node id and NOT the epoch: shard composition is a pure function of
  (manifests, shard count), so the same shard served by a different
  node after a topology change is byte-identical data and the entry
  stays valid across epochs (epoch-invariance, tested);
- ``ingest_version`` — any re-ingest bumps it, so staleness is
  structurally impossible rather than TTL-approximated.

Values are the decoded ``(columns, data, stats)`` partials — cheap to
merge, already materialized. Entries are LRU-evicted against a byte
budget; sizes are estimated from the encoded wire frame the broker just
received (or re-encoded for local fallbacks).

Thread safety: one leaf lock around the OrderedDict; get/put never call
out while holding it.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Tuple


def body_key(body: bytes) -> str:
    """Canonical key of one subquery shape (pre-patch body bytes)."""
    return hashlib.sha256(body).hexdigest()


class SubqueryCache:
    """LRU (subquery shape, shard, ingest version) -> partial result."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()   # LEAF — no calls out while held
        self._entries: "OrderedDict[tuple, Tuple[object, int]]" = \
            OrderedDict()
        self._bytes = 0
        self.counters = {"hits": 0, "misses": 0, "puts": 0,
                         "evictions": 0}

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    @staticmethod
    def key(bkey: str, datasource: str, shard_index: int, n_shards: int,
            ingest_version: int) -> tuple:
        return (bkey, datasource, int(shard_index), int(n_shards),
                int(ingest_version))

    def get(self, key: tuple) -> Optional[object]:
        if not self.enabled:
            return None
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.counters["misses"] += 1
                return None
            self._entries.move_to_end(key)
            self.counters["hits"] += 1
            return ent[0]

    def put(self, key: tuple, value: object, nbytes: int) -> None:
        if not self.enabled:
            return
        nbytes = max(1, int(nbytes))
        if nbytes > self.max_bytes:
            return                      # would evict everything for one entry
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            self.counters["puts"] += 1
            while self._bytes > self.max_bytes and self._entries:
                _, (_, sz) = self._entries.popitem(last=False)
                self._bytes -= sz
                self.counters["evictions"] += 1

    def invalidate_datasource(self, datasource: str) -> None:
        """Drop every shard entry of one datasource (defensive hook for
        explicit drops; normal staleness is handled by the
        ingest-version key term)."""
        with self._lock:
            dead = [k for k in self._entries if k[1] == datasource]
            for k in dead:
                self._bytes -= self._entries.pop(k)[1]

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "entries": len(self._entries),
                    "bytes": self._bytes, "max_bytes": self.max_bytes,
                    **self.counters}
