"""Byte-budgeted LRU + the engine-facing semantic result cache.

Port counterpart of ``spark_druid_olap_tpu/cache/result_cache.py``: a copy
kept inside the PyTorch package, which imports nothing of the JAX package.

:class:`ByteBudgetLRU` is generic infra: an ordered map with a byte
budget, thread-safe, counting hits / misses / evictions / resident bytes.

:class:`SemanticResultCache` sits in ``QueryEngine.execute`` around
``_execute_inner``. On lookup it tries an exact canonical-key hit, then —
when ``sdot.cache.subsumption`` is on — probes the generalized specs from
``subsume.candidates`` and derives the answer on the host. Entries are
snapshotted on put and copied again on get, so cached arrays can never be
mutated by callers. Keys fold in the per-datasource ingest version, so a
re-ingest or drop invalidates without any eager sweep.

An entry holds host numpy arrays only (``_snapshot`` copies each column
with ``np.array``), never a ``torch.Tensor``: a device tensor would pin
device memory past the bind cache's cap and tie the entry to a stream.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from spark_druid_olap_tpu_torch.cache import keys as K
from spark_druid_olap_tpu_torch.result import QueryResult
from spark_druid_olap_tpu_torch.utils import phases as PH


def nbytes_of(obj) -> int:
    """Approximate host bytes held by arrays / tuples of arrays."""
    if obj is None:
        return 0
    if isinstance(obj, np.ndarray):
        if obj.dtype == object:
            n = int(obj.size)
            if not n:
                return 0
            flat = obj.ravel()
            if n > 4096:
                # strided sample: exact counting is an O(n) Python loop,
                # minutes on multi-million-row gathered columns
                sample = flat[:: n // 4096 + 1]
                per = sum(len(str(x)) + 48 for x in sample) / len(sample)
                return int(per * n)
            return int(sum(len(str(x)) + 48 for x in flat))
        return int(obj.nbytes)
    if isinstance(obj, (tuple, list)):
        return sum(nbytes_of(x) for x in obj)
    if isinstance(obj, dict):
        return sum(nbytes_of(v) for v in obj.values())
    return 64


class ByteBudgetLRU:
    """Thread-safe LRU bounded by total payload bytes, not entry count."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[object, Tuple[object, int]]" = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key, count: bool = True):
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                if count:
                    self.misses += 1
                return None
            self._entries.move_to_end(key)
            if count:
                self.hits += 1
            return hit[0]

    def put(self, key, value, nbytes: Optional[int] = None) -> bool:
        nb = int(nbytes_of(value) if nbytes is None else nbytes)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old[1]
            if nb > self.max_bytes:
                # Oversized payloads would immediately evict everything
                # else; refuse them rather than thrash the budget.
                return False
            self._entries[key] = (value, nb)
            self.bytes += nb
            while self.bytes > self.max_bytes and self._entries:
                _, (_, enb) = self._entries.popitem(last=False)
                self.bytes -= enb
                self.evictions += 1
            return True

    def pop(self, key) -> None:
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old[1]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.bytes = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }


def _snapshot(result: QueryResult):
    """Immutable-by-convention copy of a QueryResult's payload."""
    cols = tuple(result.columns)
    data = {c: np.array(result.data[c], copy=True) for c in cols}
    return (cols, data)


def _materialize(q, entry) -> QueryResult:
    """Fresh QueryResult in the query's own column order, arrays copied."""
    cols, data = entry
    want = K.expected_columns(q)
    order = list(want) if set(want) == set(cols) else list(cols)
    return QueryResult(order, {c: np.array(data[c], copy=True) for c in order})


class SemanticResultCache:
    """Engine-level result cache with subsumption reuse.

    Config is read live on every call, so toggling ``sdot.cache.enabled``
    (or resizing ``sdot.cache.max_bytes``) in a running session takes
    effect immediately; resized budgets apply on the next put.
    """

    def __init__(self, config):
        self.config = config
        self.lru = ByteBudgetLRU(int(config.get("sdot.cache.max_bytes")))
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.subsumed = 0
        self.puts = 0

    # -- config -----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return bool(self.config.get("sdot.cache.enabled"))

    @property
    def subsumption(self) -> bool:
        return bool(self.config.get("sdot.cache.subsumption"))

    def cacheable(self, q) -> bool:
        return K.cacheable(q)

    # -- core -------------------------------------------------------------
    def _key(self, q, ds_version: int):
        return K.canonical_key(q, ds_version, self.config.fingerprint())

    def lookup(self, q, ds_version: int):
        """Return ``(QueryResult, 'hit'|'subsumed')`` or ``(None, 'miss')``.
        Probe time (subsumption derivation included) lands in the
        per-query phase profile as ``cache.lookup``."""
        with PH.phase("cache.lookup"):
            return self._lookup(q, ds_version)

    def _lookup(self, q, ds_version: int):
        entry = self.lru.get(self._key(q, ds_version), count=False)
        if entry is not None:
            with self._lock:
                self.hits += 1
            return _materialize(q, entry), "hit"
        if self.subsumption:
            from spark_druid_olap_tpu_torch.cache import subsume

            tz = str(self.config.get("sdot.timezone") or "UTC")
            utc = tz.upper() in ("UTC", "ETC/UTC", "Z")
            for gen, derive in subsume.candidates(q, utc=utc):
                gentry = self.lru.get(self._key(gen, ds_version), count=False)
                if gentry is None:
                    continue
                derived = derive(q, gentry)
                if derived is None:
                    continue
                with self._lock:
                    self.subsumed += 1
                return derived, "subsumed"
        with self._lock:
            self.misses += 1
        return None, "miss"

    def put(self, q, ds_version: int, result: QueryResult) -> None:
        entry = _snapshot(result)
        self.lru.max_bytes = int(self.config.get("sdot.cache.max_bytes"))
        if self.lru.put(self._key(q, ds_version), entry, nbytes_of(entry[1])):
            with self._lock:
                self.puts += 1

    def clear(self) -> None:
        self.lru.clear()

    def stats(self) -> Dict[str, int]:
        out = self.lru.stats()
        # The LRU's own hit/miss counters track raw probes (exact +
        # subsumption); report query-level semantics alongside.
        out.pop("hits", None)
        out.pop("misses", None)
        with self._lock:
            out.update(
                {
                    "enabled": self.enabled,
                    "subsumption": self.subsumption,
                    "hits": self.hits,
                    "misses": self.misses,
                    "subsumed": self.subsumed,
                    "puts": self.puts,
                }
            )
        return out
