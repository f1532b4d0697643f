"""Byte-budgeted hot set over memory-mapped snapshot blobs.

Port of ``spark_druid_olap_tpu/tier/store.py``: a copy kept inside the
PyTorch package, which imports nothing of the JAX package.

The cold tier IS deep storage (persist/ snapshot blobs): one
:class:`TieredColumnStore` per PersistManager demand-loads per-segment
column chunks through ``np.memmap`` into an explicit hot set bounded by
``sdot.tier.budget.bytes``. The design follows the reference's
historical tier (deep storage holds every segment; a node memory-maps
only what it serves), Sparkle's explicit memory-hierarchy management
(arxiv 1708.05746), and Theseus's overlap of data movement with compute
(arxiv 2508.05029).

Mechanics:

- **Fault unit** is one segment's rows of one column array (a
  :class:`BlobRef` element range into a blob file). The double-buffered
  wave loop faults exactly the segments it binds.
- **CRC verification is lazy**: a blob file is checksummed ONCE, on the
  first fault that touches it (``sdot.tier.verify.checksums``) — boot
  stays O(manifest), corruption still can't serve silently. A mismatch
  invokes the corruption callback (PersistManager quarantines the
  version and re-recovers per PERSIST semantics) and raises
  ``SnapshotCorrupt`` into the faulting query.
- **Eviction** is by query-history popularity (the same signal that
  drives recovery warmup order, metadata/history.py) with recency as
  the tiebreak; entries pinned by in-flight queries are never evicted,
  so peak residency is budget + pinned bytes, never a dangling array.
- **Pin protocol**: ``acquire_pins()`` pushes a token onto a
  thread-local stack; every fault on that thread registers its chunk
  into the open tokens; ``release_pins(token)`` drops the refcounts.
  The engine wraps query execution in acquire/release, the release on
  every exit (``parallel/executor.QueryEngine.execute``), so the chunks
  a statement faults stay pinned until it ends. One departure from the
  JAX package: the wave binder copies each chunk into its staging as it
  faults it, so it binds each wave inside :meth:`wave_pins`, a scope
  whose chunks are pinned only while the wave is built. A waved scan's
  residency is then bounded by budget + one wave's chunks, not by
  budget + the statement's.
- **Prefetcher**: daemon threads drain a queue of (column, ref) work;
  the wave loop enqueues wave i+2's chunks while wave i computes on
  device, so cold loads hide behind dispatch. Prefetched entries are
  flagged; a later demand fault that lands on one counts as prefetch
  overlap (``prefetch_hit_bytes``).
- **Decode-ahead** (``sdot.tier.decoded.cache.bytes`` > 0): the
  prefetch worker also DECODES encoded chunks into a separate
  LRU cache accounted at decoded size, so a hot repeated scan stops
  paying the per-serve decode on the demand path (the saving lands in
  ``decode_ms_saved``). Decoded copies are derived data: they evict
  before any encoded payload — their own LRU bounds steady state, and
  encoded-budget pressure flushes them entirely before the eviction
  loop touches a single compressed payload. A served decoded array
  stays alive with its query via numpy refcounting, so mid-query
  eviction is safe without pin integration.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import threading
import time
import zlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from spark_druid_olap_tpu_torch.persist.snapshot import SnapshotCorrupt
from spark_druid_olap_tpu_torch.utils import phases as PH


@dataclasses.dataclass(frozen=True)
class BlobRef:
    """One element range of a snapshot blob file (a 1-D column array):
    the unit the hot set faults, pins, and evicts.

    An ENCODED ref (``enc`` set) additionally carries the byte range of
    its compressed chunk and the chunk's codec header as a JSON string
    (strings keep the dataclass hashable). The hot set then holds the
    compressed payload and ``nbytes`` is the COMPRESSED size — the same
    byte budget keeps ratio× more segments resident — while ``dtype``/
    ``count`` still describe the logical rows a fault decodes to."""

    path: str          # absolute blob file path (inside a version dir)
    dtype: str         # numpy dtype str (manifest "dtype")
    start: int         # element offset into the blob (logical rows)
    count: int         # element count (logical rows)
    crc: int           # whole-file CRC32 from the manifest
    file_bytes: int    # whole-file size from the manifest
    enc: Optional[str] = None   # JSON codec header (encode/codecs.py)
    byte_start: int = 0         # chunk byte offset (encoded refs)
    byte_len: int = -1          # chunk byte length (encoded refs)

    @property
    def itemsize(self) -> int:
        return int(np.dtype(self.dtype).itemsize)

    @property
    def nbytes(self) -> int:
        """Hot-set residency cost: compressed bytes for encoded refs,
        logical bytes for raw ones."""
        if self.enc is not None:
            return max(0, int(self.byte_len))
        return int(self.count) * self.itemsize

    @property
    def decoded_nbytes(self) -> int:
        """Logical (decoded) size — what a query actually scans."""
        return int(self.count) * self.itemsize

    def header(self) -> Optional[dict]:
        """Parsed codec header (None for raw refs)."""
        if self.enc is None:
            return None
        import json
        return json.loads(self.enc)


class _Entry:
    __slots__ = ("arr", "nbytes", "tick", "column", "prefetched")

    def __init__(self, arr, nbytes, tick, column, prefetched):
        self.arr = arr
        self.nbytes = nbytes
        self.tick = tick
        self.column = column
        self.prefetched = prefetched


class _DecEntry:
    """One decode-ahead chunk: the decoded ndarray, its DECODED size
    (what the cache budget charges), the measured decode cost a future
    demand fault is spared, and whether the prefetcher produced it."""

    __slots__ = ("arr", "nbytes", "decode_ms", "prefetched")

    def __init__(self, arr, nbytes, decode_ms, prefetched):
        self.arr = arr
        self.nbytes = nbytes
        self.decode_ms = decode_ms
        self.prefetched = prefetched


class PinToken:
    """Per-query pin set: chunk key -> refcount contributed.
    ``devices`` records how many mesh devices the pinned wave feeds
    (1 = single-device) — a mesh-parallel fault pins ``n_dev``x more
    segments per wave, and eviction pressure accounting wants to see
    that multiplier, not infer it."""

    __slots__ = ("keys", "devices")

    def __init__(self, devices: int = 1):
        self.keys: Dict[tuple, int] = {}
        self.devices = max(1, int(devices))


class TieredColumnStore:
    """The hot set. One instance per process (PersistManager-owned);
    shared by every tiered datasource it loaded, including cluster
    historicals' shard slices — the budget is per NODE, which is what
    makes N-node memory truly bounded."""

    def __init__(self, budget_bytes: int, verify: bool = True,
                 popularity: Optional[Callable[[str, str], float]] = None,
                 on_corrupt: Optional[Callable[[str, str, str], None]] = None,
                 decoded_budget: int = 0):
        self.budget = max(1, int(budget_bytes))
        self.dec_budget = max(0, int(decoded_budget))   # 0 = decode-ahead off
        self.verify = bool(verify)
        self.popularity = popularity
        self.on_corrupt = on_corrupt
        # fault injector (fault/); named "chaos" because "fault"
        # is this store's demand-fault method
        self.chaos = None
        self._lock = threading.RLock()
        self._hot: Dict[tuple, _Entry] = {}
        self._pins: Dict[tuple, int] = {}
        self._mesh_pins: Dict[tuple, int] = {}   # pins from devices>1 scopes
        self._bytes = 0
        self._tick = 0
        self._verified = set()                 # blob paths CRC-checked OK
        self._loading: Dict[tuple, threading.Event] = {}
        self._tls = threading.local()
        self.counters = {
            "faults": 0, "hits": 0, "bytes_faulted": 0,
            "evictions": 0, "bytes_evicted": 0,
            "crc_verified_files": 0, "crc_failures": 0,
            "crc_verify_ms": 0.0,
            "pin_tokens": 0, "pin_tokens_mesh": 0,
            "prefetch_submitted": 0, "prefetch_loaded": 0,
            "prefetch_dropped": 0,
            "prefetch_hits": 0, "prefetch_hit_bytes": 0,
            "decode_ms_saved": 0.0, "decoded_evictions": 0,
        }
        self._dec: "OrderedDict[tuple, _DecEntry]" = OrderedDict()
        self._dec_bytes = 0
        self._pf_queue: Optional[queue.Queue] = None
        self._pf_threads: List[threading.Thread] = []
        self._pf_stop = threading.Event()

    # -- pins ------------------------------------------------------------------
    def _token_stack(self) -> list:
        s = getattr(self._tls, "tokens", None)
        if s is None:
            s = self._tls.tokens = []
        return s

    def acquire_pins(self, devices: int = 1) -> PinToken:
        """Open a pin scope on THIS thread: every chunk faulted until the
        matching release is held out of eviction's reach. ``devices`` > 1
        marks a mesh-parallel scope (the sharded bind and the sharded
        waves, ``parallel/executor.py``): the wave
        being pinned spans the whole device mesh, so its chunks are
        additionally tracked in the mesh-pin gauge the stats surface
        reports (eviction itself treats every pin identically)."""
        tok = PinToken(devices)
        self._token_stack().append(tok)
        with self._lock:
            self.counters["pin_tokens"] += 1
            if tok.devices > 1:
                self.counters["pin_tokens_mesh"] += 1
        return tok

    def release_pins(self, tok: PinToken) -> None:
        s = getattr(self._tls, "tokens", None)
        if s is not None and tok in s:
            s.remove(tok)
        with self._lock:
            for k, n in tok.keys.items():
                r = self._pins.get(k, 0) - n
                if r <= 0:
                    self._pins.pop(k, None)
                else:
                    self._pins[k] = r
                if tok.devices > 1:
                    rm = self._mesh_pins.get(k, 0) - n
                    if rm <= 0:
                        self._mesh_pins.pop(k, None)
                    else:
                        self._mesh_pins[k] = rm
            tok.keys.clear()
            self._evict_locked()   # deferred evictions land here

    @contextlib.contextmanager
    def wave_pins(self, devices: int = 1):
        """Pin scope of one wave's build on THIS thread: chunks faulted
        inside it register into this scope's token only, not into the
        statement's, and become evictable when the wave is built. For a
        caller that copies every chunk out before the scope ends (the
        wave binder's staging). ``devices`` > 1: a sharded wave, which
        the mesh-pin gauge tracks (:meth:`acquire_pins`)."""
        s = self._token_stack()
        outer = list(s)
        s.clear()
        tok = self.acquire_pins(devices)
        try:
            yield tok
        finally:
            self.release_pins(tok)
            s[:0] = outer

    def _pin_into_active_locked(self, key: tuple) -> None:
        for tok in getattr(self._tls, "tokens", ()):
            tok.keys[key] = tok.keys.get(key, 0) + 1
            self._pins[key] = self._pins.get(key, 0) + 1
            if tok.devices > 1:
                self._mesh_pins[key] = self._mesh_pins.get(key, 0) + 1

    def pinned_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for k, e in self._hot.items()
                       if self._pins.get(k))

    # -- faulting --------------------------------------------------------------
    def fault(self, ds_name: str, column: str, ref: BlobRef,
              prefetch: bool = False) -> np.ndarray:
        """The chunk's hot ndarray, loading it from the cold tier if
        needed. Demand faults (prefetch=False) pin into the calling
        thread's open tokens and count hit/prefetch-overlap stats.

        Encoded refs are held hot in COMPRESSED form and decoded
        OUTSIDE the store lock — the decode is per-segment numpy work
        and must not serialize concurrent faulting threads. With
        decode-ahead ON (``dec_budget`` > 0) the prefetch path decodes
        into the decoded-chunk cache so a later demand fault skips the
        decode entirely (served at decoded size, ``decode_ms_saved``
        credited); with it off, prefetch serves only warm bytes and the
        demand fault pays the decode, as before."""
        if ref.enc is None:
            if prefetch:
                return self._fault_stored(ds_name, column, ref, True)
            t0 = time.perf_counter()
            arr = self._fault_stored(ds_name, column, ref, False)
            PH.add("tier.fault", time.perf_counter() - t0)
            return arr
        key = (ds_name, ref.path, int(ref.start), int(ref.count))
        if prefetch:
            stored = self._fault_stored(ds_name, column, ref, True)
            if self.dec_budget > 0:
                self._decode_ahead(key, stored, ref)
            return stored
        if self.dec_budget > 0:
            hit = self._serve_decoded(key)
            if hit is not None:
                return hit
        t0 = time.perf_counter()
        stored = self._fault_stored(ds_name, column, ref, False)
        PH.add("tier.fault", time.perf_counter() - t0)
        from spark_druid_olap_tpu_torch.encode import codecs as EN
        t0 = time.perf_counter()
        arr = EN.decode_array(stored, ref.header())
        dms = (time.perf_counter() - t0) * 1000.0
        PH.add("tier.decode", dms / 1000.0)
        if self.dec_budget > 0:
            # demand-decoded chunks are cache-worthy too: the NEXT
            # repeat of this scan serves decoded even when the
            # prefetcher never saw the chunk (single-wave scans)
            self._dec_install(key, arr, ref, dms, prefetched=False)
        return arr

    def _serve_decoded(self, key: tuple) -> Optional[np.ndarray]:
        """Demand serve from the decode-ahead cache. Counts the serve
        as a hot hit, credits the spared decode, and — when the chunk
        was prefetcher-produced — counts prefetch overlap at DECODED
        size (that is what the demand path was spared end to end)."""
        with self._lock:
            d = self._dec.get(key)
            if d is None:
                return None
            self._dec.move_to_end(key)
            self._tick += 1
            self.counters["hits"] += 1
            self.counters["decode_ms_saved"] += d.decode_ms
            if d.prefetched:
                d.prefetched = False
                self.counters["prefetch_hits"] += 1
                self.counters["prefetch_hit_bytes"] += d.nbytes
                e = self._hot.get(key)
                if e is not None:
                    # the compressed twin was never demand-served; it
                    # must not claim the same overlap again later
                    e.prefetched = False
            self._pin_into_active_locked(key)
            return d.arr

    def _decode_ahead(self, key: tuple, stored: np.ndarray,
                      ref: BlobRef) -> None:
        """Prefetch-worker decode, outside the lock; first-wins."""
        with self._lock:
            if key in self._dec:
                return
        from spark_druid_olap_tpu_torch.encode import codecs as EN
        t0 = time.perf_counter()
        try:
            arr = EN.decode_array(stored, ref.header())
        except Exception:  # noqa: BLE001 — advisory; demand decode re-raises
            return
        dms = (time.perf_counter() - t0) * 1000.0
        self._dec_install(key, arr, ref, dms, prefetched=True)

    def _dec_install(self, key: tuple, arr: np.ndarray, ref: BlobRef,
                     decode_ms: float, prefetched: bool) -> None:
        nb = int(ref.decoded_nbytes)
        if nb > self.dec_budget:
            return   # a chunk larger than the whole budget never admits
        with self._lock:
            if key in self._dec:
                return
            self._dec[key] = _DecEntry(arr, nb, decode_ms, prefetched)
            self._dec_bytes += nb
            while self._dec_bytes > self.dec_budget and self._dec:
                _, old = self._dec.popitem(last=False)
                self._dec_bytes -= old.nbytes
                self.counters["decoded_evictions"] += 1

    def _fault_stored(self, ds_name: str, column: str, ref: BlobRef,
                      prefetch: bool) -> np.ndarray:
        key = (ds_name, ref.path, int(ref.start), int(ref.count))
        with self._lock:
            e = self._hot.get(key)
            if e is not None:
                return self._serve_locked(key, e, prefetch)
            ev = self._loading.get(key)
            if ev is None:
                ev = self._loading[key] = threading.Event()
                loader = True
            else:
                loader = False
        if not loader:
            # another thread (usually the prefetcher) is mid-load: wait
            # for it rather than reading the same bytes twice
            ev.wait(timeout=120.0)
            with self._lock:
                e = self._hot.get(key)
                if e is not None:
                    return self._serve_locked(key, e, prefetch)
                # loader failed or the entry was already evicted: take
                # over the load ourselves
                self._loading.setdefault(key, threading.Event())
        try:
            arr = self._load_cold(ds_name, ref)
        finally:
            with self._lock:
                done = self._loading.pop(key, None)
            if done is not None:
                done.set()
        with self._lock:
            e = self._hot.get(key)
            if e is None:
                self._tick += 1
                e = self._hot[key] = _Entry(arr, ref.nbytes, self._tick,
                                            column, prefetch)
                self._bytes += ref.nbytes
                self.counters["faults"] += 1
                self.counters["bytes_faulted"] += ref.nbytes
                if prefetch:
                    self.counters["prefetch_loaded"] += 1
                if not prefetch:
                    self._pin_into_active_locked(key)
                self._evict_locked()
                return e.arr
            return self._serve_locked(key, e, prefetch)

    def _serve_locked(self, key: tuple, e: _Entry,
                      prefetch: bool) -> np.ndarray:
        self._tick += 1
        e.tick = self._tick
        if not prefetch:
            self.counters["hits"] += 1
            if e.prefetched:
                e.prefetched = False
                self.counters["prefetch_hits"] += 1
                self.counters["prefetch_hit_bytes"] += e.nbytes
            self._pin_into_active_locked(key)
        return e.arr

    def _load_cold(self, ds_name: str, ref: BlobRef) -> np.ndarray:
        inj = self.chaos
        if inj is not None:
            # chaos site: delay = slow cold read, error = mmap I/O error
            inj.fire("tier.read", key=ref.path)
        self._verify_blob(ds_name, ref)
        if ref.enc is not None:
            # encoded chunk: the stored hot entry IS the compressed
            # payload (uint8); decode happens on serve, in fault()
            n = max(0, int(ref.byte_len))
            with open(ref.path, "rb") as f:
                f.seek(int(ref.byte_start))
                data = f.read(n)
            if len(data) != n:
                raise SnapshotCorrupt(
                    f"cold blob {os.path.basename(ref.path)}: short read "
                    f"({len(data)} of {n} bytes at {ref.byte_start})")
            return np.frombuffer(data, dtype=np.uint8)
        if ref.count == 0:
            return np.empty(0, dtype=np.dtype(ref.dtype))
        mm = np.memmap(ref.path, dtype=np.dtype(ref.dtype), mode="r",
                       offset=int(ref.start) * ref.itemsize,
                       shape=(int(ref.count),))
        try:
            # materialize the hot copy (writable; memmap pages release)
            return np.array(mm)
        finally:
            del mm

    def _verify_blob(self, ds_name: str, ref: BlobRef) -> None:
        """Whole-file CRC on the FIRST fault touching a blob — the lazy
        half of PERSIST's recovery-time verification."""
        if not self.verify:
            return
        with self._lock:
            if ref.path in self._verified:
                return
        t0 = time.perf_counter()
        try:
            with open(ref.path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise SnapshotCorrupt(f"missing blob {ref.path}: {e}") from e
        inj = self.chaos
        if inj is not None:
            # chaos site: a flip rule simulates cold-tier bit rot — the
            # CRC below catches it and triggers quarantine/re-recovery
            data = inj.mutate("tier.verify", data, key=ref.path)
        ok = len(data) == int(ref.file_bytes) \
            and zlib.crc32(data) == int(ref.crc)
        ms = (time.perf_counter() - t0) * 1000.0
        with self._lock:
            self.counters["crc_verify_ms"] += ms
            if ok:
                self._verified.add(ref.path)
                self.counters["crc_verified_files"] += 1
            else:
                self.counters["crc_failures"] += 1
        if ok:
            return
        reason = (f"cold blob {os.path.basename(ref.path)}: "
                  f"{len(data)} bytes crc {zlib.crc32(data)}, manifest "
                  f"says {ref.file_bytes} bytes crc {ref.crc}")
        cb = self.on_corrupt
        if cb is not None:
            # PersistManager: quarantine the version, re-recover this
            # datasource from an older snapshot + WAL tail
            cb(ds_name, os.path.dirname(ref.path), reason)
        raise SnapshotCorrupt(reason)

    # -- eviction --------------------------------------------------------------
    def _score(self, e: _Entry, ds_name: str) -> float:
        pop = self.popularity
        if pop is None:
            return 0.0
        try:
            return float(pop(ds_name, e.column))
        except Exception:  # noqa: BLE001 — scoring never breaks a fault
            return 0.0

    def _evict_locked(self) -> None:
        if self._bytes <= self.budget:
            return
        # decoded copies are DERIVED data (recreatable from the encoded
        # payloads below): under encoded-budget pressure they all go
        # before a single compressed payload is touched
        while self._dec:
            _, old = self._dec.popitem(last=False)
            self._dec_bytes -= old.nbytes
            self.counters["decoded_evictions"] += 1
        cand = [(self._score(e, k[0]), e.tick, k)
                for k, e in self._hot.items() if not self._pins.get(k)]
        cand.sort()
        for _, _, k in cand:
            if self._bytes <= self.budget:
                break
            e = self._hot.pop(k)
            self._bytes -= e.nbytes
            self.counters["evictions"] += 1
            self.counters["bytes_evicted"] += e.nbytes
        # if everything left is pinned we run over budget until the
        # pinning queries release — bounded by budget + in-flight bytes

    # -- lifecycle -------------------------------------------------------------
    def drop_datasource(self, name: str) -> None:
        """Forget a datasource's chunks (store drop, quarantine
        re-recovery). Pin refcounts for dropped keys die with them;
        release_pins tolerates the missing entries."""
        with self._lock:
            dead = [k for k in self._hot if k[0] == name]
            paths = set()
            for k in dead:
                e = self._hot.pop(k)
                self._bytes -= e.nbytes
                self._pins.pop(k, None)
                paths.add(k[1])
            for k in [k for k in self._dec if k[0] == name]:
                self._dec_bytes -= self._dec.pop(k).nbytes
            live_paths = {k[1] for k in self._hot}
            self._verified -= (paths - live_paths)

    def clear(self) -> None:
        with self._lock:
            self._hot.clear()
            self._pins.clear()
            self._verified.clear()
            self._bytes = 0
            self._dec.clear()
            self._dec_bytes = 0

    # -- prefetch --------------------------------------------------------------
    def start_prefetcher(self, threads: int = 2,
                         depth: int = 4096) -> None:
        if self._pf_queue is not None or threads <= 0:
            return
        self._pf_stop.clear()
        self._pf_queue = queue.Queue(maxsize=max(16, int(depth)))
        for i in range(int(threads)):
            t = threading.Thread(target=self._pf_loop,
                                 name=f"sdot-tier-prefetch-{i}",
                                 daemon=True)
            t.start()
            self._pf_threads.append(t)

    def prefetch(self, ds_name: str,
                 work: List[Tuple[str, BlobRef]]) -> None:
        """Enqueue cold chunks to load behind compute. Best-effort: a
        full queue drops work (the demand fault still serves it)."""
        q = self._pf_queue
        if q is None:
            return
        for column, ref in work:
            key = (ds_name, ref.path, int(ref.start), int(ref.count))
            with self._lock:
                if key in self._hot or key in self._loading:
                    continue
                self.counters["prefetch_submitted"] += 1
            try:
                q.put_nowait((ds_name, column, ref))
            except queue.Full:
                with self._lock:
                    self.counters["prefetch_dropped"] += 1

    def _pf_loop(self) -> None:
        while not self._pf_stop.is_set():
            try:
                item = self._pf_queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                break
            ds_name, column, ref = item
            try:
                self.fault(ds_name, column, ref, prefetch=True)
            except Exception:  # noqa: BLE001 — prefetch is advisory;
                pass           # the demand fault re-raises for real

    def stop(self) -> None:
        self._pf_stop.set()
        q = self._pf_queue
        if q is not None:
            for _ in self._pf_threads:
                try:
                    q.put_nowait(None)
                except queue.Full:
                    break
        for t in self._pf_threads:
            t.join(timeout=2.0)
        self._pf_threads = []
        self._pf_queue = None

    # -- observability ---------------------------------------------------------
    def stats_snapshot(self) -> dict:
        with self._lock:
            c = dict(self.counters)
            c["crc_verify_ms"] = round(c["crc_verify_ms"], 3)
            c["decode_ms_saved"] = round(c["decode_ms_saved"], 3)
            faulted = max(1, c["bytes_faulted"])
            return {
                "budget_bytes": self.budget,
                "hot_bytes": self._bytes,
                "hot_entries": len(self._hot),
                "decoded_budget_bytes": self.dec_budget,
                "decoded_cache_bytes": self._dec_bytes,
                "decoded_cache_entries": len(self._dec),
                "pinned_entries": sum(1 for k in self._hot
                                      if self._pins.get(k)),
                "mesh_pinned_entries": sum(1 for k in self._hot
                                           if self._mesh_pins.get(k)),
                "mesh_pinned_bytes": sum(e.nbytes
                                         for k, e in self._hot.items()
                                         if self._mesh_pins.get(k)),
                "prefetch_overlap_ratio": round(
                    c["prefetch_hit_bytes"] / faulted, 4),
                **c,
            }
