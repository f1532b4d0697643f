"""Checkpoint / recovery orchestration for the persist subsystem.

Port counterpart of ``spark_druid_olap_tpu/persist/manager.py``: a copy
kept inside the PyTorch package, which imports nothing of the JAX
package, with the original's tier branches (``sdot.tier.enabled``:
recovery into tiered datasources, ``tier/``).
Journaling is always fsynced and group-committed, and recovery always
runs at start: the original's switches for these
(``sdot.persist.wal.fsync``, ``wal.group.commit``, ``recover.on.start``,
``enabled``) are accepted only at their defaults, and its
one-fsync-per-append path is left out. An empty ``sdot.persist.path`` is
the only way to run volatile.

One :class:`PersistManager` per Context (created when
``sdot.persist.path`` is set). It owns:

- **Durable stream ingest**: ``Context.stream_ingest`` routes here; the
  new Datasource value is BUILT first (which fully validates the batch —
  a rejected batch is never journaled), then the batch is journaled (WAL
  append + fsync = commit point), then the store registers it, so a
  ``kill -9`` at any instant loses at most the batch whose commit was
  never acknowledged — and a rejected batch can never poison replay of
  the committed ones behind it.
- **Checkpoints**: fold a datasource's current in-memory state into a
  published snapshot (persist/snapshot.py) and truncate the WAL records
  the snapshot now covers. Explicit (``CHECKPOINT`` SQL /
  ``Context.checkpoint()``) or via the background checkpointer
  (``sdot.persist.checkpoint.interval.seconds`` cadence,
  ``sdot.persist.checkpoint.max.bytes`` per-pass byte budget).
- **Recovery**: at Context creation, reload snapshots in history-driven
  warmup order (most recently queried first), verify checksums
  (quarantining corrupt versions and falling back to older ones), replay
  each WAL tail, and restore the catalog:
  star schemas, lookups, rollup definitions, and — critically — the
  per-datasource *ingest-version counters*, so result-cache invalidation
  and rollup staleness semantics are exactly what they were before the
  crash (a rollup stale at kill time is still stale, and bypassed, after
  recovery).

Version-restore contract: ``SegmentStore.restore`` pins the recovered
datasource's ingest version to the manifest's value and advances the
global counter to at least it; WAL-replayed appends then bump versions
normally. Consequences: (a) a rollup whose ``built_version`` equals the
manifest version is fresh again after recovery iff no later append
exists; (b) any WAL tail on the base makes it stale — never served.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

import pandas as pd

from spark_druid_olap_tpu_torch.persist import snapshot as SNAP
from spark_druid_olap_tpu_torch.persist import wal as WAL

CATALOG_FILE = "catalog.json"


def _refuse_unported(cfg) -> None:
    """Raise, before anything touches the disk, on a durability switch
    away from its default."""
    from spark_druid_olap_tpu_torch.utils.config import (
        PERSIST_ENABLED,
        PERSIST_GROUP_COMMIT,
        PERSIST_RECOVER,
        PERSIST_WAL_FSYNC,
    )
    for entry in (PERSIST_ENABLED, PERSIST_RECOVER, PERSIST_WAL_FSYNC,
                  PERSIST_GROUP_COMMIT):
        if bool(cfg.get(entry)) != entry.default:
            raise ValueError(
                f"{entry.key}={cfg.get(entry)!r} is refused: the port "
                "journals every batch fsynced through group commit and "
                "recovers at start; leave sdot.persist.path empty to run "
                "volatile")


def _ds_bytes(ds) -> int:
    # footprint accessors, not raw .nbytes: sizing a TIERED datasource
    # through the array properties would fault every column hot
    total = 0
    if ds.time is not None:
        total += ds.time.footprint_nbytes()
    for d in ds.dims.values():
        total += d.footprint_nbytes()
    for m in ds.metrics.values():
        total += m.footprint_nbytes()
    return total


class PersistManager:
    def __init__(self, ctx, root: str):
        from spark_druid_olap_tpu_torch.utils.config import (
            ENCODE_ENABLED,
            PERSIST_CHECKPOINT_MAX_BYTES,
            PERSIST_CHECKPOINT_SECONDS,
            PERSIST_COMPACT_MIN_SEGMENTS,
            PERSIST_COMPACT_SECONDS,
            PERSIST_KEEP_SNAPSHOTS,
            PERSIST_VERIFY_CHECKSUMS,
        )
        cfg = ctx.config
        _refuse_unported(cfg)
        self.ctx = ctx
        self.root = os.path.abspath(root)
        # fault injector (fault/): threaded into every WAL, the snapshot
        # publish path, and the cold tier below
        self.fault = getattr(ctx.engine, "fault", None)
        os.makedirs(self.root, exist_ok=True)
        # LOCK ORDER: a per-datasource build lock (serializing the
        # order-preserving append chain) comes BEFORE this manager lock,
        # which comes BEFORE QueryHistory._lock (docs/LINT.md; checkpoint
        # paths read the session query history under this lock). History
        # code must never call into persist, and nothing may acquire a
        # ds build lock while holding this lock.
        self.lock = threading.RLock()
        self.keep = int(cfg.get(PERSIST_KEEP_SNAPSHOTS))
        self.verify = bool(cfg.get(PERSIST_VERIFY_CHECKSUMS))
        self.interval_s = float(cfg.get(PERSIST_CHECKPOINT_SECONDS))
        self.pass_budget = int(cfg.get(PERSIST_CHECKPOINT_MAX_BYTES))
        self.compact_interval_s = float(cfg.get(PERSIST_COMPACT_SECONDS))
        self.compact_min_segments = int(
            cfg.get(PERSIST_COMPACT_MIN_SEGMENTS))
        # checkpoint-time columnar encoding (sdot.encode.enabled),
        # resolved once here and threaded through every write_snapshot —
        # checkpoint and compaction publish with the same policy, WAL
        # tails stay raw rows by construction (the journal never goes
        # through the snapshot writer)
        self.encode = bool(cfg.get(ENCODE_ENABLED))
        self._wals: Dict[str, WAL.WriteAheadLog] = {}
        self._wal_seq: Dict[str, int] = {}      # last seq ASSIGNED, per ds
        self._reg_seq: Dict[str, int] = {}      # last seq REGISTERED, per ds
        # name -> newest built-but-not-yet-registered Datasource value:
        # the base the next concurrent producer's append builds on, so
        # the order-preserving chain survives the build lock being
        # released before the covering group fsync lands
        self._tail_ds: Dict[str, object] = {}
        # name -> in-flight build chain, seq order: every entry is a
        # built-but-unregistered batch ({seq, ds, df, kwargs, ticket}).
        # Kept so a frame that FAILS its commit (torn write, failed
        # covering fsync) can be excised and its successors' builds —
        # which chained on the rejected rows — rebuilt before any of
        # them registers: rows never become queryable unless their
        # journal record is durable (guarded by the ds build lock)
        self._tail_chain: Dict[str, list] = {}
        self._ds_locks: Dict[str, threading.RLock] = {}
        self._dirty = set()                     # names needing a checkpoint
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_compact = 0.0
        self.counters = {"checkpoints": 0, "checkpoint_bytes": 0,
                         "wal_appends": 0, "wal_replayed": 0,
                         "wal_repaired": 0, "wal_repaired_bytes": 0,
                         "compactions": 0, "compacted_segments": 0,
                         "quarantined": 0, "errors": 0}
        self.recovery_report: Optional[dict] = None
        # out-of-core tiered storage: when enabled, recovery hands back
        # TieredDatasources whose columns fault from the snapshot blobs
        # through this byte-budgeted hot set (tier/store.py)
        from spark_druid_olap_tpu_torch.utils.config import (
            TIER_BUDGET_BYTES, TIER_DECODED_CACHE_BYTES, TIER_ENABLED,
            TIER_PREFETCH_ENABLED, TIER_PREFETCH_THREADS,
            TIER_VERIFY_CHECKSUMS)
        self.tier = None
        if bool(cfg.get(TIER_ENABLED)):
            from spark_druid_olap_tpu_torch.tier.store import (
                TieredColumnStore)
            self.tier = TieredColumnStore(
                int(cfg.get(TIER_BUDGET_BYTES)),
                verify=bool(cfg.get(TIER_VERIFY_CHECKSUMS)),
                popularity=self._tier_popularity,
                on_corrupt=self._on_tier_corrupt,
                decoded_budget=int(cfg.get(TIER_DECODED_CACHE_BYTES)))
            # .fault on the tier store is the demand-fault METHOD, so
            # the injector rides a different name there
            self.tier.chaos = self.fault
            if bool(cfg.get(TIER_PREFETCH_ENABLED)):
                self.tier.start_prefetcher(
                    int(cfg.get(TIER_PREFETCH_THREADS)))
        ctx.store.add_listener(self._on_store_event)

    # -- paths ----------------------------------------------------------------
    def _ds_root(self, name: str) -> str:
        return os.path.join(self.root, SNAP.sanitize(name))

    def _wal_for(self, name: str) -> WAL.WriteAheadLog:
        with self.lock:
            w = self._wals.get(name)
            if w is None:
                w = self._wals[name] = WAL.WriteAheadLog(
                    os.path.join(self._ds_root(name), "wal.log"),
                    fault=self.fault)
            return w

    def _ds_lock(self, name: str) -> threading.RLock:
        """Per-datasource build lock (acquired BEFORE self.lock). It
        serializes the order-preserving append chain and the checkpoint/
        compact commit phases for one datasource without stalling
        producers on every other datasource."""
        with self.lock:
            lk = self._ds_locks.get(name)
            if lk is None:
                lk = self._ds_locks[name] = threading.RLock()
            return lk

    def _next_seq(self, name: str) -> int:
        seq = self._wal_seq.get(name)
        if seq is None:
            seq = self._wal_for(name).last_seq() or 0
            root = self._ds_root(name)
            cur = SNAP.current_version(root)
            if cur is not None:
                try:
                    seq = max(seq, int(SNAP.load_manifest(
                        root, cur).get("wal_seq", 0)))
                except (OSError, ValueError):
                    pass
            # everything journaled before this session's first append is
            # already folded into whatever state checkpoint would
            # snapshot — it is the registered watermark, NOT the
            # in-flight appends about to be assigned seqs past it
            self._reg_seq.setdefault(name, seq)
        seq += 1
        self._wal_seq[name] = seq
        return seq

    # -- store events ---------------------------------------------------------
    def _on_store_event(self, event: str, name: Optional[str]) -> None:
        # register (ingest / append / replay) marks dirty for the
        # background checkpointer; restore comes FROM disk and is clean
        if event == "register":
            self._dirty.add(name)
        elif event == "drop":
            self._dirty.discard(name)
            self._wal_seq.pop(name, None)
            self._reg_seq.pop(name, None)
            self._tail_ds.pop(name, None)
            self._tail_chain.pop(name, None)
            if self.tier is not None:
                self.tier.drop_datasource(name)
        elif event == "clear":
            self._dirty.clear()
            self._wal_seq.clear()
            self._reg_seq.clear()
            self._tail_ds.clear()
            self._tail_chain.clear()
            if self.tier is not None:
                self.tier.clear()

    # -- tier callbacks -------------------------------------------------------
    def _tier_popularity(self, ds_name: str, column: str) -> float:
        """Eviction score for one hot chunk's column: the session query
        history's per-column hit count (metadata/history.py). Called
        under the tier lock; QueryHistory never calls back into tier or
        persist, so the order tier.lock -> history.lock is safe."""
        hist = getattr(self.ctx, "history", None)
        if hist is None:
            return 0.0
        return hist.column_score(ds_name, column)

    def _on_tier_corrupt(self, ds_name: str, version_dir: str,
                         reason: str) -> None:
        """First-fault CRC mismatch on a cold blob: quarantine that
        snapshot version and re-recover the datasource from an older one
        (or the WAL alone) — the exact PERSIST recovery semantics, just
        triggered lazily. The faulting query still fails with
        SnapshotCorrupt; the NEXT query sees the fallback store. Invoked
        by the tier OUTSIDE its lock (lock order: PersistManager.lock
        before QueryHistory._lock; the tier lock is never held across
        this call)."""
        with self.lock:
            dirpath = os.path.dirname(os.path.abspath(version_dir))
            base = os.path.basename(version_dir)
            try:
                version = int(base.lstrip("v"))
            except ValueError:
                return
            qpath = SNAP.quarantine_version(dirpath, version)
            if qpath is None:
                return          # another fault already quarantined it
            self.counters["quarantined"] += 1
            if self.tier is not None:
                self.tier.drop_datasource(ds_name)
            # re-recover whichever datasource lives in that directory
            name = None
            for n, p in self._ds_dirs().items():
                if os.path.abspath(p) == dirpath:
                    name = n
                    break
            report = {"datasources": [], "quarantined": [
                {"datasource": name or ds_name, "version": version,
                 "reason": reason, "moved_to": qpath}], "errors": []}
            if name is not None:
                if self.tier is not None and name != ds_name:
                    self.tier.drop_datasource(name)
                info = self._recover_datasource(name, dirpath, report)
                recovery_info = dict(
                    getattr(self.ctx.store, "recovery_info", {}) or {})
                if info is not None:
                    recovery_info[name] = info
                self.ctx.store.recovery_info = recovery_info
            prev = self.recovery_report
            if prev is not None:
                prev.setdefault("quarantined", []).extend(
                    report["quarantined"])
                prev.setdefault("errors", []).extend(report["errors"])
            else:
                self.recovery_report = report

    # -- durable stream ingest ------------------------------------------------
    def stream_ingest(self, name: str, df: pd.DataFrame,
                      kwargs: dict):
        """Durable append, safe for concurrent producers.

        The per-datasource build lock is held only for the build + seq
        assignment + enqueue; the covering group fsync is awaited
        OUTSIDE it, so concurrent producers on one datasource share a
        single fsync (persist/wal.py group commit) instead of paying one
        each. Ordering survives the split: seqs are assigned and frames
        enqueued under the build lock (journal order == seq order), each
        build chains on the newest built tail (``_tail_chain``), and
        registration is monotone by seq — a later batch's Datasource is
        a superset of every earlier one's, so the highest-seq register
        wins and earlier producers just ACK.

        Failure resolution: a frame that fails its commit (torn write,
        failed covering fsync) is excised from the chain and every
        successor build — which chained on the rejected rows — is
        rebuilt from its surviving base before anything registers
        (``_excise_failed``). The WAL resolves tickets in enqueue
        order, so whichever producer reaches the lock first (the
        failed one's except path or a successor's ACK path) sees the
        failure and repairs the chain; no build containing un-durable
        rows can ever become queryable.
        """
        from spark_druid_olap_tpu_torch.segment.append import (
            append_dataframe, wal_kwargs_to_dict)
        from spark_druid_olap_tpu_torch.segment.ingest import ingest_dataframe
        store = self.ctx.store
        dslock = self._ds_lock(name)
        with dslock:
            existing = store._datasources.get(name)
            if existing is not None and len(df) == 0:
                return existing     # no-op: nothing to journal or apply
            base = self._tail_ds.get(name)
            if base is None:
                base = existing
                if base is None:
                    # new incarnation of this name: any on-disk state
                    # belongs to a previous one (dropped / cleared
                    # without PURGE) and recovery must never merge the
                    # two, so fence the old snapshot + WAL aside before
                    # journaling the create
                    self._fence_stale_state(name)
                elif SNAP.current_version(self._ds_root(name)) is None:
                    # first append to a datasource that was batch-
                    # ingested in memory only: a WAL replay needs a base
                    # to append onto, so publish one synchronously
                    # before journaling
                    self.checkpoint(name)
                if base is not None \
                        and getattr(base, "tier", None) is not None:
                    # appends mutate column arrays (dataclasses.replace
                    # + concatenate) — swap the tiered store for an
                    # eager copy first. Quiet swap: no version bump, no
                    # store events; the register below marks dirty as
                    # usual.
                    base = base.materialize()
                    store._datasources[name] = base
                    self.tier.drop_datasource(name)
            kind = "create" if base is None else "append"
            # Build the new Datasource value BEFORE journaling: the WAL
            # append is the commit point, and a batch the build rejects
            # (unknown column, missing time column, bad dtype) must never
            # be journaled — a journaled reject would deterministically
            # fail again on every replay, shadowing later committed
            # batches behind it.
            if base is None:
                new_ds = ingest_dataframe(name, df, **kwargs)
            else:
                new_ds = append_dataframe(
                    base, df,
                    target_rows=int(kwargs.get("target_rows")
                                    or (1 << 20)))
            seq = self._next_seq(name)
            header = {"seq": seq, "datasource": name, "kind": kind,
                      "kwargs": wal_kwargs_to_dict(kwargs)}
            body = WAL.encode_batch(df)
            wal = self._wal_for(name)
            entry = {"seq": seq, "ds": new_ds, "df": df,
                     "kwargs": dict(kwargs), "ticket": None}
            self._tail_chain.setdefault(name, []).append(entry)
            self._tail_ds[name] = new_ds
            # enqueue while still holding the build lock: journal
            # order == seq order, and ticket resolution order follows
            entry["ticket"] = wal.enqueue(header, body)
        # -- commit point: outside the build lock so the fsync can cover
        # every frame concurrent producers queued meanwhile ------------------
        try:
            wal.commit(entry["ticket"])
        except BaseException:
            with dslock:
                self._excise_failed(name)
            raise
        with dslock:
            with self.lock:
                self.counters["wal_appends"] += 1
            # my ACK implies every earlier-enqueued frame has resolved:
            # drop any that failed (rebuilding their successors) before
            # registering, so torn rows never become queryable
            self._excise_failed(name)
            return self._register_through(name, seq)

    def _set_chain(self, name: str, entries: list) -> None:
        """Install the in-flight build chain for ``name`` (build lock
        held), keeping the newest-tail shortcut in lockstep."""
        if entries:
            self._tail_chain[name] = entries
            self._tail_ds[name] = entries[-1]["ds"]
        else:
            self._tail_chain.pop(name, None)
            self._tail_ds.pop(name, None)

    def _register_through(self, name: str, seq: int):
        """Register the chain entry carrying ``seq`` and drop every
        entry it covers (build lock held). Absent entry = a later
        producer's ACK already registered a superset and removed it —
        the rows are servable and durable, nothing to do."""
        chain = self._tail_chain.get(name) or []
        mine = next((e for e in chain if e["seq"] == seq), None)
        if mine is None:
            return self.ctx.store._datasources.get(name)
        if seq > self._reg_seq.get(name, -1):
            self._reg_seq[name] = seq
            self.ctx.store.register(mine["ds"])
        self._set_chain(name,
                        [e for e in chain if e["seq"] > seq])
        return mine["ds"]

    def _excise_failed(self, name: str) -> None:
        """Drop every chain entry whose commit FAILED (ticket resolved
        with an error) and rebuild the builds downstream of the first
        casualty — they chained on the rejected rows (build lock held).
        Rebuilds replay the surviving entries' own DataFrames in seq
        order from the last intact base, exactly what WAL replay does
        at recovery, so the live state and the journal stay one."""
        from spark_druid_olap_tpu_torch.segment.append import append_dataframe
        from spark_druid_olap_tpu_torch.segment.ingest import ingest_dataframe
        chain = self._tail_chain.get(name) or []
        dead = {i for i, e in enumerate(chain)
                if e["ticket"] is not None and e["ticket"].event.is_set()
                and e["ticket"].error is not None}
        if not dead:
            return
        out, dirty = [], False
        cur = self.ctx.store._datasources.get(name)
        for i, e in enumerate(chain):
            if i in dead:
                dirty = True
                continue
            if not dirty:            # upstream of every failure: intact
                out.append(e)
                cur = e["ds"]
                continue
            if cur is None:
                # the journaled 'create' itself was rejected; replay
                # treats the first surviving append as the create
                # (segment/append.py apply_stream_ingest), so do the same
                e["ds"] = ingest_dataframe(name, e["df"], **e["kwargs"])
            else:
                e["ds"] = append_dataframe(
                    cur, e["df"],
                    target_rows=int(e["kwargs"].get("target_rows")
                                    or (1 << 20)))
            cur = e["ds"]
            out.append(e)
        self._set_chain(name, out)

    def _fence_stale_state(self, name: str) -> None:
        """Move a previous incarnation's on-disk snapshot/WAL aside
        (under a dotted name recovery ignores — kept, not deleted, so an
        operator can still inspect it). Without the fence, a re-created
        datasource's 'create' record lands in the OLD journal with a seq
        past the stale snapshot's watermark, and recovery appends the
        new data onto the dropped incarnation's rows."""
        p = self._ds_root(name)
        if not os.path.isdir(p):
            return
        w = self._wals.pop(name, None)
        if w is not None:
            w.close()
        self._wal_seq.pop(name, None)
        self._reg_seq.pop(name, None)
        self._tail_ds.pop(name, None)
        self._tail_chain.pop(name, None)
        base = os.path.join(
            self.root,
            f".dropped-{int(time.time())}-{os.path.basename(p)}")
        dst, i = base, 0
        while os.path.exists(dst):
            i += 1
            dst = f"{base}.{i}"
        try:
            os.replace(p, dst)
            # the fence must survive a crash: if the rename is lost,
            # recovery resurrects the dropped incarnation and the new
            # create lands in its journal
            SNAP.fsync_dir(self.root)
        except OSError:
            shutil.rmtree(p, ignore_errors=True)

    # -- checkpoint -----------------------------------------------------------
    def _covered_seq(self, name: str) -> int:
        """Highest WAL seq the REGISTERED state reflects — the watermark
        a snapshot of that state may truncate through. Never the
        allocation watermark (``_wal_seq``): a seq assigned to an
        in-flight producer whose frame/register hasn't landed yet is NOT
        covered, and truncating through it would drop an acked batch.
        Callers already hold ``self.lock``; taken again (RLock) so the
        watermark read-modify-write is guarded in its own right."""
        with self.lock:
            seq = self._reg_seq.get(name)
            if seq is not None:
                return seq
            if name in self._wal_seq:
                # seqs were assigned this session but none registered:
                # only the pre-session journal (folded in at _next_seq
                # init) is covered — and that init seeded _reg_seq, so
                # reaching here means nothing is
                return 0
            seq = self._wal_for(name).last_seq() or 0
            self._reg_seq[name] = seq
            return seq

    def checkpoint(self, name: str) -> dict:
        """Publish one datasource's current state; returns a summary."""
        with self._ds_lock(name):
            with self.lock:
                ds = self.ctx.store.get(name)
                ds.require_complete("checkpoint")
                iv = self.ctx.store.datasource_version(name)
                wal_seq = self._covered_seq(name)
                if self.fault is not None:
                    # chaos site: a publish-time I/O error (fsync
                    # failure, disk full). The WAL is untouched, so
                    # nothing is lost — the datasource just stays dirty
                    # for the next pass.
                    self.fault.fire("snapshot.write", key=name)
                manifest = SNAP.write_snapshot(
                    self._ds_root(name), ds, iv, wal_seq, keep=self.keep,
                    encode=self.encode)
                # snapshot covers every journaled record at or below the
                # registered watermark — drop them (in-flight frames
                # past it survive the rewrite)
                self._wal_for(name).truncate_through(wal_seq)
                self._dirty.discard(name)
                self.counters["checkpoints"] += 1
                self.counters["checkpoint_bytes"] += int(
                    manifest["bytes"])
                self._write_catalog()
                return {"datasource": name, "version": iv,
                        "rows": manifest["num_rows"],
                        "bytes": manifest["bytes"]}

    def checkpoint_all(self, only_dirty: bool = False,
                       byte_budget: Optional[int] = None) -> List[dict]:
        """Checkpoint every (or every dirty) complete datasource; with a
        byte budget, snapshot in ascending size order until the pass
        would exceed it (the rest stay dirty for the next pass). The
        manager lock is held only to size the candidates and then
        per-datasource inside :meth:`checkpoint` — a background pass
        over many datasources never stalls streaming ingest for the
        whole sweep."""
        with self.lock:
            store = self.ctx.store
            names = [n for n in store.names()
                     if not only_dirty or n in self._dirty]
            sized = []
            for n in names:
                try:
                    ds = store.get(n)
                except KeyError:
                    continue
                if ds.is_partial:
                    continue        # multi-host partials never checkpoint
                sized.append((_ds_bytes(ds), n))
        sized.sort()
        out = []
        spent = 0
        for nbytes, n in sized:
            if byte_budget and out and spent + nbytes > byte_budget:
                break               # always make progress on >= 1 ds
            try:
                out.append(self.checkpoint(n))
                spent += nbytes
            except KeyError:
                continue            # dropped between the listing and now
            except Exception:       # noqa: BLE001 — one bad ds can't
                with self.lock:     # starve the rest; counter increments
                    self.counters["errors"] += 1   # are read-modify-write
        return out

    # -- catalog (stars / rollups / lookups / warmup) -------------------------
    def _warmup_map(self) -> Dict[str, float]:
        """datasource -> last-queried unix time, merged over the previous
        catalog file and this session's query history (drives recovery
        load order: hot datasources first)."""
        warm: Dict[str, float] = {}
        old = self._read_catalog()
        for k, v in (old.get("warmup") or {}).items():
            warm[k] = float(v)
        hist = getattr(self.ctx, "history", None)
        if hist is not None:
            for rec in hist.entries():
                # raw engine queries carry the datasource on the record;
                # SQL statements carry it in the engine stats they copied
                ds = rec.datasource or (rec.stats or {}).get("datasource")
                if isinstance(ds, str):
                    warm[ds] = max(warm.get(ds, 0.0), float(rec.started_at))
        return warm

    def _write_catalog(self) -> None:
        from spark_druid_olap_tpu_torch.mv.registry import rollup_to_dict
        stars = [s.to_dict()
                 for s in self.ctx.catalog.star_schemas.values()]
        rollups = [rollup_to_dict(r)
                   for r in getattr(self.ctx, "rollups", {}).values()]
        doc = {"format": SNAP.FORMAT_VERSION,
               "stars": stars, "rollups": rollups,
               "lookups": dict(getattr(self.ctx, "lookups", {}) or {}),
               "warmup": self._warmup_map(),
               "written_at": time.time()}
        tmp = os.path.join(self.root, CATALOG_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, CATALOG_FILE))
        SNAP.fsync_dir(self.root)

    def _read_catalog(self) -> dict:
        try:
            with open(os.path.join(self.root, CATALOG_FILE)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    # -- recovery -------------------------------------------------------------
    def _ds_dirs(self) -> Dict[str, str]:
        """datasource name -> directory, discovered from manifests (and
        WAL headers for never-checkpointed datasources)."""
        out = {}
        try:
            entries = sorted(os.listdir(self.root))
        except OSError:
            return out
        for n in entries:
            p = os.path.join(self.root, n)
            if not os.path.isdir(p) or n.startswith("."):
                continue
            name = None
            cur = SNAP.current_version(p)
            if cur is not None:
                try:
                    name = SNAP.load_manifest(p, cur)["datasource"]
                except (OSError, ValueError, KeyError):
                    name = None
            if name is None:
                w = WAL.WriteAheadLog(os.path.join(p, "wal.log"))
                it = None
                try:
                    it = w.replay()
                    for h, _ in it:
                        name = h.get("datasource")
                        break
                finally:
                    # the break leaves the generator suspended inside
                    # its `with open(...)` — close it, or the read
                    # handle lives until GC (a real fd on every recovery
                    # scan, not just lint hygiene)
                    if it is not None:
                        it.close()
                    w.close()
            if name is not None:
                out[name] = p
        return out

    def _recover_datasource(self, name: str, dirpath: str,
                            report: dict) -> Optional[dict]:
        from spark_druid_olap_tpu_torch.segment.append import (
            apply_stream_ingest, wal_kwargs_from_dict)
        manifest = None
        verify_ms = 0.0
        loaded_version = None
        versions = SNAP.list_versions(dirpath)
        cur = SNAP.current_version(dirpath)
        candidates = ([cur] if cur is not None else []) \
            + [v for v in sorted(versions, reverse=True) if v != cur]
        for v in candidates:
            try:
                if self.tier is not None:
                    # cold-tier recovery: O(manifest) structural check,
                    # columns fault on demand; blob CRCs verify on first
                    # fault (tier/loader.py)
                    from spark_druid_olap_tpu_torch.tier.loader import (
                        load_tiered_snapshot)
                    ds, manifest, verify_ms = load_tiered_snapshot(
                        dirpath, v, self.tier, verify=self.verify)
                else:
                    ds, manifest, verify_ms = SNAP.load_snapshot(
                        dirpath, v, verify=self.verify)
                loaded_version = v
                break
            except SNAP.SnapshotCorrupt as e:
                qpath = SNAP.quarantine_version(dirpath, v)
                self.counters["quarantined"] += 1
                report["quarantined"].append(
                    {"datasource": name, "version": v,
                     "reason": str(e), "moved_to": qpath})
                manifest = None
        if manifest is not None:
            self.ctx.store.restore(ds, int(manifest["ingest_version"]))
        else:
            # WAL-only path: replay rebuilds from the journaled 'create'
            # record. An in-session RESTORE can reach here with the live
            # object still registered — drop it (directly, no store
            # events: the on-disk state must survive), or the create
            # batch would append on top of it, duplicating every row.
            self.ctx.store._datasources.pop(name, None)
        covered = int(manifest["wal_seq"]) if manifest is not None else 0
        replayed = 0
        wal = self._wal_for(name)
        # a crash mid-append leaves a torn tail; trim it NOW so live
        # appends after recovery land where replay can see them. The
        # self-heal is no longer silent: operators watching
        # the stats' counters see how often crashes tear the journal.
        repaired_bytes = wal.repair()
        if repaired_bytes > 0:
            self.counters["wal_repaired"] += 1
            self.counters["wal_repaired_bytes"] += int(repaired_bytes)
            report.setdefault("repaired", []).append(
                {"datasource": name, "bytes": int(repaired_bytes)})
        for header, body in wal.replay():
            seq = int(header.get("seq", 0))
            if seq <= covered:
                continue
            # advance the seq watermark even past a failing record so a
            # later live append can never reuse its sequence number
            self._wal_seq[name] = max(self._wal_seq.get(name, 0), seq)
            if self.tier is not None:
                live = self.ctx.store._datasources.get(name)
                if getattr(live, "tier", None) is not None:
                    # a WAL tail past the snapshot must append onto an
                    # eager store (the tail materializes this datasource
                    # in RAM; the next checkpoint re-publishes and it
                    # loads tiered again)
                    self.ctx.store._datasources[name] = live.materialize()
                    self.tier.drop_datasource(name)
            try:
                df = WAL.decode_batch(body)
                kwargs = wal_kwargs_from_dict(header.get("kwargs") or {})
                apply_stream_ingest(self.ctx, name, df, kwargs)
            except Exception as e:  # noqa: BLE001 — recovery must finish
                self.counters["errors"] += 1
                report["errors"].append(
                    {"datasource": name, "seq": seq, "reason": str(e)})
                continue            # one bad record must not shadow the
                                    # committed batches behind it
            replayed += 1
        self.counters["wal_replayed"] += replayed
        # the registered state now reflects everything replayed (and the
        # allocation watermark, advanced past failing records above) —
        # that is the watermark a later checkpoint may truncate through
        self._reg_seq[name] = max(self._wal_seq.get(name, 0), covered,
                                  self._reg_seq.get(name, 0))
        if manifest is None and replayed == 0:
            return None
        source = ("snapshot+wal" if manifest is not None and replayed
                  else "snapshot" if manifest is not None else "wal")
        info = {"source": source,
                "snapshot_version": loaded_version,
                "checksum_verify_ms": round(verify_ms, 3),
                "wal_records": replayed,
                "wal_repaired_bytes": int(repaired_bytes)}
        report["datasources"].append({"datasource": name, **info})
        return info

    def recover(self) -> dict:
        """Reload every persisted datasource + the catalog; returns (and
        stores) a recovery report."""
        t0 = time.perf_counter()
        with self.lock:
            report = {"datasources": [], "quarantined": [], "errors": [],
                      "order": []}
            catalog = self._read_catalog()
            warm = {k: float(v)
                    for k, v in (catalog.get("warmup") or {}).items()}
            dirs = self._ds_dirs()
            # history-driven warmup: most recently queried first, then
            # rollup backings (queries hit them via rewrite), then name
            order = sorted(
                dirs, key=lambda n: (-warm.get(n, 0.0), n))
            report["order"] = list(order)
            recovery_info = {}
            for name in order:
                info = self._recover_datasource(name, dirs[name], report)
                if info is not None:
                    recovery_info[name] = info
            # catalog: lookups, star schemas, rollup definitions
            for lname, table in (catalog.get("lookups") or {}).items():
                self.ctx.lookups.setdefault(lname, table)
            from spark_druid_olap_tpu_torch.metadata.star import StarSchema
            for sd in catalog.get("stars") or ():
                try:
                    star = StarSchema.from_dict(sd)
                    self.ctx.catalog.register_star_schema(star)
                except Exception as e:  # noqa: BLE001
                    report["errors"].append(
                        {"star": sd.get("factTable"), "reason": str(e)})
            from spark_druid_olap_tpu_torch.mv.registry import rollup_from_dict
            for rd in catalog.get("rollups") or ():
                try:
                    r = rollup_from_dict(rd)
                except Exception as e:  # noqa: BLE001
                    report["errors"].append(
                        {"rollup": rd.get("name"), "reason": str(e)})
                    continue
                if r.backing in self.ctx.store._datasources:
                    self.ctx.rollups[r.name] = r
            self.ctx.store.recovery_info = recovery_info
            report["total_ms"] = round(
                (time.perf_counter() - t0) * 1000, 2)
            self.recovery_report = report
            return report

    def restore(self, name: Optional[str] = None) -> dict:
        """In-session ``RESTORE``: rewind the in-memory state to the last
        published snapshot (+ committed WAL tail). Ingest-version
        counters rewind with it, so every derived cache must drop — the
        session layer clears the engine caches after calling this."""
        with self.lock:
            dirs = self._ds_dirs()
            if name is not None:
                if name not in dirs:
                    raise KeyError(
                        f"no snapshot or WAL on disk for {name!r} "
                        f"under {self.root}")
                dirs = {name: dirs[name]}
            report = {"datasources": [], "quarantined": [], "errors": [],
                      "order": sorted(dirs)}
            recovery_info = dict(
                getattr(self.ctx.store, "recovery_info", {}) or {})
            for n in sorted(dirs):
                info = self._recover_datasource(n, dirs[n], report)
                if info is not None:
                    recovery_info[n] = info
            self.ctx.store.recovery_info = recovery_info
            self.recovery_report = report
            return report

    # -- purge ----------------------------------------------------------------
    def purge(self, name: Optional[str] = None) -> int:
        """Delete on-disk snapshots/WALs (CLEAR METADATA ... PURGE).
        Returns the number of datasource directories removed."""
        with self.lock:
            removed = 0
            if name is not None:
                p = self._ds_root(name)
                w = self._wals.pop(name, None)
                if w is not None:
                    w.close()
                self._wal_seq.pop(name, None)
                self._reg_seq.pop(name, None)
                self._tail_ds.pop(name, None)
                self._tail_chain.pop(name, None)
                self._dirty.discard(name)
                if os.path.isdir(p):
                    shutil.rmtree(p, ignore_errors=True)
                    removed = 1
                return removed
            for n, p in self._ds_dirs().items():
                shutil.rmtree(p, ignore_errors=True)
                removed += 1
            # fenced previous incarnations (.dropped-*) go too: PURGE
            # means "nothing of this root survives a restart"
            try:
                for n in os.listdir(self.root):
                    if n.startswith(".dropped-"):
                        shutil.rmtree(os.path.join(self.root, n),
                                      ignore_errors=True)
            except OSError:
                pass
            try:
                os.remove(os.path.join(self.root, CATALOG_FILE))
            except OSError:
                pass
            for w in self._wals.values():
                w.close()
            self._wals.clear()
            self._wal_seq.clear()
            self._reg_seq.clear()
            self._tail_ds.clear()
            self._tail_chain.clear()
            self._dirty.clear()
            return removed

    # -- compaction -----------------------------------------------------------
    def compact(self, name: Optional[str] = None,
                target_rows: Optional[int] = None) -> List[dict]:
        """Roll stream-appended tails into time-partitioned segments
        (persist/compact.py). With a name: force-compact that datasource;
        without: sweep every datasource past the segment-count floor."""
        from spark_druid_olap_tpu_torch.persist.compact import (
            compact_datasource)
        out: List[dict] = []
        if name is not None:
            r = compact_datasource(self, name, target_rows=target_rows,
                                   force=True)
            return [r] if r else []
        for n in list(self.ctx.store.names()):
            try:
                r = compact_datasource(self, n, target_rows=target_rows)
            except Exception:  # noqa: BLE001 — one bad ds can't stop
                with self.lock:  # the sweep
                    self.counters["errors"] += 1
                continue
            if r:
                out.append(r)
        return out

    # -- background checkpointer / compactor ----------------------------------
    def start_background(self) -> None:
        periods = [p for p in (self.interval_s, self.compact_interval_s)
                   if p > 0]
        if not periods or self._thread is not None:
            return
        self._bg_period = min(periods)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._bg_loop, name="sdot-checkpointer", daemon=True)
        self._thread.start()

    def _bg_loop(self) -> None:
        last_ckpt = last_compact = time.monotonic()
        slack = self._bg_period * 0.05
        while not self._stop.wait(self._bg_period):
            now = time.monotonic()
            if self.interval_s > 0 \
                    and now - last_ckpt >= self.interval_s - slack:
                last_ckpt = now
                try:
                    self.checkpoint_all(
                        only_dirty=True,
                        byte_budget=self.pass_budget or None)
                except Exception:  # noqa: BLE001 — the loop must survive
                    with self.lock:
                        self.counters["errors"] += 1
            if self.compact_interval_s > 0 \
                    and now - last_compact >= self.compact_interval_s \
                    - slack:
                last_compact = now
                try:
                    self.compact()
                except Exception:  # noqa: BLE001 — the loop must survive
                    with self.lock:
                        self.counters["errors"] += 1

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        if self.tier is not None:
            self.tier.stop()
        with self.lock:
            for w in self._wals.values():
                w.close()

    # -- observability --------------------------------------------------------
    def snapshots_view(self) -> pd.DataFrame:
        """``sys_snapshots``: one row per published snapshot version plus
        one per quarantined version."""
        rows = []
        with self.lock:
            for name, dirpath in sorted(self._ds_dirs().items()):
                cur = SNAP.current_version(dirpath)
                wal_bytes = self._wal_for(name).size_bytes()
                for v in SNAP.list_versions(dirpath):
                    try:
                        m = SNAP.load_manifest(dirpath, v)
                    except (OSError, ValueError):
                        m = {}
                    rows.append({
                        "datasource": name, "version": v,
                        "state": "published",
                        "current": bool(v == cur),
                        "rows": int(m.get("num_rows", 0)),
                        "bytes": int(m.get("bytes", 0)),
                        "wal_seq": int(m.get("wal_seq", 0)),
                        "wal_bytes": int(wal_bytes),
                        "dirty": name in self._dirty,
                        "created_at": float(m.get("created_at", 0.0)),
                    })
                qdir = os.path.join(dirpath, SNAP.QUARANTINE_DIR)
                if os.path.isdir(qdir):
                    for q in sorted(os.listdir(qdir)):
                        rows.append({
                            "datasource": name, "version": -1,
                            "state": f"quarantined:{q}",
                            "current": False, "rows": 0, "bytes": 0,
                            "wal_seq": 0, "wal_bytes": int(wal_bytes),
                            "dirty": name in self._dirty,
                            "created_at": 0.0})
        cols = ["datasource", "version", "state", "current", "rows",
                "bytes", "wal_seq", "wal_bytes", "dirty", "created_at"]
        return pd.DataFrame(rows, columns=cols)

    def stats(self) -> dict:
        """Counters and per-datasource state (the JAX package serves
        this as ``GET /metadata/persist``)."""
        with self.lock:
            per_ds = {}
            for name, dirpath in self._ds_dirs().items():
                per_ds[name] = {
                    "currentVersion": SNAP.current_version(dirpath),
                    "versions": SNAP.list_versions(dirpath),
                    "walBytes": self._wal_for(name).size_bytes(),
                    "dirty": name in self._dirty,
                }
            return {
                "enabled": True,
                "path": self.root,
                "datasources": per_ds,
                "dirty": sorted(self._dirty),
                "counters": dict(self.counters),
                "groupCommit": {
                    "enabled": True,
                    "commits": sum(w.group_commits
                                   for w in self._wals.values()),
                    "frames": sum(w.group_frames
                                  for w in self._wals.values()),
                },
                "background": {
                    "intervalSeconds": self.interval_s,
                    "passByteBudget": self.pass_budget,
                    "compactIntervalSeconds": self.compact_interval_s,
                    "running": self._thread is not None
                    and self._thread.is_alive(),
                },
                "recovery": self.recovery_report,
                "tier": None if self.tier is None
                else self.tier.stats_snapshot(),
            }
