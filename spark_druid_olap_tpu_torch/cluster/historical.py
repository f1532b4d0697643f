"""Historical node: boot from deep storage, serve owned shards.

Port of ``spark_druid_olap_tpu/cluster/historical.py``: a copy kept
inside the PyTorch package, with one device per node.
``HistoricalNode(config, node_id, device=None)`` takes the device rule of
``Context``: ``cuda`` by default, and with no CUDA device the node raises
at construction instead of serving from the CPU (tests pass ``"cpu"``).
The partitioned join's exchange routes (``/cluster/join/partition``,
``/cluster/join/exec``) run ``join/partitioned.py``; the exec hop's probe
runs on the node's device.

Boot sequence (order matters for the health contract):

1. the HTTP server starts FIRST — ``/healthz`` answers immediately,
   ``/readyz`` answers 503 until boot completes, so orchestrators and
   the broker's prober can watch recovery progress;
2. a full ``Context`` is created over the shared persist root —
   ``PersistManager.recover()`` rebuilds every datasource from
   snapshots + WAL tails exactly as a single-process engine would;
3. the node computes the SAME shard plan as the broker (pure function
   of deep storage + the node list), slices each owned shard out of the
   recovered datasource with ``segment/store.py:slice_segments``,
   registers it under its shard name at the manifest's ingest version,
   and drops the full datasource — memory is bounded by owned rows;
4. ``ready`` flips True; ``/readyz`` goes 200 and the broker routes
   primary traffic here.

The subquery RPC wraps the ordinary ``QueryEngine.execute``: WLM lane
admission, the per-node result cache, and shared-scan coalescing all
apply to subqueries, so each historical absorbs its own slice of a
dashboard storm. ``partial_sketches`` makes sketch aggregates return
raw registers for the broker's exact register merge.

A datasource whose recovered state runs PAST the planned manifest (WAL
tail appended after the last checkpoint) is kept whole and unsliced:
the broker's matching ingest-version check already serves it locally,
and slicing would silently drop the WAL rows here.

Elastic topology (cluster/epoch.py): a watcher thread polls deep
storage for a newer plan epoch and runs this node's side of the
handover —

- still a member: **warm before advertise** — newly owned shards are
  re-recovered from the cold tier (``PersistManager.restore`` +
  ``slice_tiered``/``slice_segments``) while the node keeps serving the
  old epoch; only when every new shard is registered does the node
  advertise the epoch on the extended ``/readyz``, which is what the
  broker's swap gate reads. Old-epoch-only shard stores are retired
  lazily, once a request stamped with the new epoch proves the broker
  has swapped.
- dropped from the record: **drain then fence** — the node keeps
  serving until it observes the same every-shard-warm condition the
  broker gates on (``assign.plan_fully_warm``), waits a grace period
  for the broker's poll lag, fires the ``node.drain`` chaos site, stops
  admitting subqueries (503 ``Draining``), waits for in-flight ones to
  finish (bounded), and fences. The begin/end subquery pair is
  registered with the sdlint leaks pass: no path may leave drain
  holding an in-flight count.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional
from urllib.parse import urlparse

from spark_druid_olap_tpu_torch.cluster import epoch as EP
from spark_druid_olap_tpu_torch.cluster import wire as WIRE
from spark_druid_olap_tpu_torch.cluster.assign import (
    parse_nodes, plan_cluster, plan_fully_warm, shard_name)
from spark_druid_olap_tpu_torch.server.http import SqlServer
from spark_druid_olap_tpu_torch.utils.config import (
    CLUSTER_EPOCH_DRAIN_GRACE_SECONDS,
    CLUSTER_EPOCH_DRAIN_TIMEOUT_SECONDS,
    CLUSTER_EPOCH_POLL_SECONDS,
    CLUSTER_NODE_ID,
    CLUSTER_NODES,
    CLUSTER_REBALANCE_STRATEGY,
    CLUSTER_REPLICATION,
    CLUSTER_ROLE,
    CLUSTER_SHARDS,
    PERSIST_PATH,
)


class DrainGate:
    """In-flight subquery accounting for the leave protocol. Every
    admitted subquery holds a token from :meth:`begin_subquery` that
    MUST be returned via :meth:`end_subquery` (sdlint leaks pair);
    after :meth:`start_drain` no new tokens are issued and
    :meth:`wait_drained` blocks until the outstanding ones return."""

    def __init__(self):
        self._lock = threading.Lock()   # leaf — never calls out while held
        self._inflight = 0
        self._draining = False
        self._idle = threading.Event()
        self._idle.set()

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def inflight(self) -> int:
        return self._inflight

    def begin_subquery(self):
        """Admit one subquery; None once draining (caller fences)."""
        with self._lock:
            if self._draining:
                return None
            self._inflight += 1
            self._idle.clear()
            return True

    def end_subquery(self, tok) -> None:
        if tok is None:
            return
        with self._lock:
            self._inflight -= 1
            if self._inflight <= 0:
                self._idle.set()

    def start_drain(self) -> None:
        with self._lock:
            self._draining = True
            if self._inflight <= 0:
                self._idle.set()

    def wait_drained(self, timeout_s: float) -> bool:
        """True when every in-flight subquery finished in time."""
        return self._idle.wait(timeout_s)


class HistoricalServer(SqlServer):
    """SqlServer + the cluster subquery RPC. Everything else — /sql,
    /metadata/*, /healthz — is inherited, so a historical is also a
    directly-queryable engine over its shards (handy for debugging a
    single node's slice)."""

    def __init__(self, node: "HistoricalNode", host: str, port: int):
        super().__init__(None, host, port)   # ctx attaches after boot
        self.node = node
        self.ready_check = lambda: node.ready
        # extended readiness: per-epoch shard adverts (the broker's
        # handover gate), the boot generation (breaker reset on rejoin)
        # and the draining flag — all plain attribute reads, keeping
        # the lock-free /readyz contract
        self.ready_info = node.ready_info

    def _handle_post(self, h):
        path = urlparse(h.path).path
        if path == "/cluster/subquery":
            n = int(h.headers.get("Content-Length", "0"))
            raw = h.rfile.read(n) if n else b"{}"
            code, body, ctype = self.node.handle_subquery(raw)
            h._send(code, body, ctype)
            return
        if path == "/cluster/ingest":
            n = int(h.headers.get("Content-Length", "0"))
            raw = h.rfile.read(n) if n else b""
            code, body, ctype = self.node.handle_ingest(raw)
            h._send(code, body, ctype)
            return
        if path == "/cluster/join/partition":
            n = int(h.headers.get("Content-Length", "0"))
            raw = h.rfile.read(n) if n else b"{}"
            code, body, ctype = self.node.handle_join_partition(raw)
            h._send(code, body, ctype)
            return
        if path == "/cluster/join/exec":
            n = int(h.headers.get("Content-Length", "0"))
            raw = h.rfile.read(n) if n else b""
            code, body, ctype = self.node.handle_join_exec(raw)
            h._send(code, body, ctype)
            return
        super()._handle_post(h)


class HistoricalNode:
    """One serving process. ``overrides`` is the shared cluster config
    (persist path, node list, replication, shard count) — identical on
    every member, which is what makes the independently-computed plans
    identical."""

    def __init__(self, overrides: Optional[dict] = None,
                 node_id: Optional[int] = None, device=None):
        import torch

        from spark_druid_olap_tpu_torch.utils.config import Config
        # the device rule of Context: cuda unless asked, and no CPU
        # serving behind the caller's back when the card is missing
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "HistoricalNode: no CUDA device is available; pass "
                "device='cpu' to serve from the CPU")
        self.overrides = dict(overrides or {})
        self.overrides[CLUSTER_ROLE.key] = "historical"
        cfg = Config(self.overrides)
        self.addresses = parse_nodes(str(cfg.get(CLUSTER_NODES)))
        if not self.addresses:
            raise ValueError("HistoricalNode needs sdot.cluster.nodes")
        if node_id is None:
            node_id = int(cfg.get(CLUSTER_NODE_ID))
        self.node_id = int(node_id)
        self.overrides[CLUSTER_NODE_ID.key] = self.node_id
        if not 0 <= self.node_id < len(self.addresses):
            raise ValueError(
                f"node id {self.node_id} outside the node list "
                f"(n={len(self.addresses)})")
        # this process's identity is its ADDRESS; node_id is just its
        # index within the current epoch's node list and is recomputed
        # on every epoch change
        host, port = self.addresses[self.node_id]
        self.address = f"{host}:{port}"
        # fresh per process: a broker seeing this change behind the same
        # address resets that node's breaker (rejoin must not inherit
        # the predecessor's open circuit)
        self.boot_id = f"{os.getpid()}.{time.time_ns()}"
        self.ready = False
        self.ctx = None
        self.plan = None
        self.epoch_record: Optional[EP.EpochRecord] = None
        self.shards_loaded = 0
        self.shards_warmed = 0          # via epoch handover, post-boot
        self.epochs_joined = 0
        self.drain = DrainGate()
        self.fenced = False
        self._epochs: Dict[int, dict] = {}   # epoch -> readyz advert
        self._max_req_epoch = 0              # newest clusterEpoch seen
        # distributed ingest: pushed batches apply serially per node,
        # deduped on (broker boot generation, push counter) so a broker
        # retry after a lost ACK never double-applies rows
        self._ingest_lock = threading.Lock()
        # shard -> (src, watermark, pending ids > watermark): concurrent
        # producers race their pushes onto the wire, so batch ids arrive
        # OUT OF ORDER per shard — a high-watermark alone would swallow
        # a late-arriving earlier id as a duplicate (confirmed but never
        # applied, silently breaking scatter read-your-writes)
        self._applied_batches: Dict[str, tuple] = {}
        self.batches_applied = 0
        self.batch_rows_applied = 0
        self._watch_stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        self.server: Optional[HistoricalServer] = None

    # -- lifecycle ------------------------------------------------------------
    def start(self, background: bool = True) -> "HistoricalNode":
        host, port = self.addresses[self.node_id]
        self.server = HistoricalServer(self, host, port)
        self.server.start(background=True)
        self.boot()
        if not background:
            try:
                threading.Event().wait()
            except KeyboardInterrupt:
                pass
            finally:
                self.stop()
        return self

    def boot(self) -> None:
        import spark_druid_olap_tpu_torch as sdot
        self.ctx = sdot.Context(self.overrides, device=self.device)
        self.server.ctx = self.ctx
        # sketch aggregates ship raw registers to the broker (both the
        # solo and the fused shared-scan decode honor this flag)
        self.ctx.engine.partial_sketches = True
        cfg = self.ctx.config
        # a published epoch record supersedes the static config list;
        # with none, the implicit bootstrap epoch 0 reproduces the
        # pre-elasticity behavior byte for byte
        rec = EP.read_epoch(cfg.get(PERSIST_PATH))
        if rec is None:
            rec = EP.bootstrap_record(
                tuple(f"{h}:{p}" for h, p in self.addresses))
        self.epoch_record = rec
        my = rec.nodes.index(self.address) if self.address in rec.nodes \
            else None
        self.plan = plan_cluster(
            cfg.get(PERSIST_PATH), len(rec.nodes),
            int(cfg.get(CLUSTER_REPLICATION)),
            int(cfg.get(CLUSTER_SHARDS)),
            node_keys=rec.ids, epoch=rec.epoch,
            strategy=str(cfg.get(CLUSTER_REBALANCE_STRATEGY)))
        if my is not None:
            self.node_id = my
            self._load_shards()
            self._advertise(rec.epoch)
        # a node booted BEFORE the epoch that adds it: serve nothing,
        # stay process-ready, and let the watcher warm it on join
        self.ready = True
        poll = float(cfg.get(CLUSTER_EPOCH_POLL_SECONDS))
        if poll > 0:
            self._watcher = threading.Thread(
                target=self._watch_loop, args=(poll,),
                name="sdot-epoch-watch", daemon=True)
            self._watcher.start()

    def stop(self) -> None:
        self.ready = False
        self._watch_stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=2.0)
            self._watcher = None
        if self.server is not None:
            self.server.stop()
        if self.ctx is not None:
            self.ctx.close()

    def _load_shards(self) -> None:
        from spark_druid_olap_tpu_torch.segment.store import slice_segments
        store = self.ctx.store
        owned_by_ds = self.plan.shards_of(self.node_id)
        for name in store.names():
            dp = self.plan.datasources.get(name)
            if dp is None:
                # WAL-only datasource (no published manifest): not in
                # the plan, broker serves it locally — keep it whole
                continue
            if store.datasource_version(name) != dp.ingest_version \
                    or store.get(name).num_segments != dp.num_segments:
                # recovery replayed WAL past the planned snapshot;
                # slicing by manifest segment indexes would drop those
                # rows. Keep whole — the broker's version check routes
                # this datasource locally until the next checkpoint.
                continue
            full = store.get(name)
            tiered = getattr(full, "tier", None) is not None
            if tiered:
                from spark_druid_olap_tpu_torch.tier.loader import slice_tiered
            for sh in owned_by_ds.get(name, ()):
                sname = shard_name(name, sh.index, dp.n_shards)
                # tiered recovery: shards stay loadable handles, so the
                # node's hot set covers ONLY its owned segments' bytes
                # and boots without faulting the whole datasource
                shard = slice_tiered(full, sh.segment_indexes,
                                     name=sname) if tiered \
                    else slice_segments(full, sh.segment_indexes,
                                        name=sname)
                store.restore(shard, ingest_version=dp.ingest_version)
                self.shards_loaded += 1
            # serve ONLY owned shards: per-node memory is bounded by
            # assigned rows, the point of the tier
            store.drop(name)

    # -- epoch lifecycle -------------------------------------------------------
    def _advertise(self, epoch: int) -> None:
        """Publish this node's warm-shard set for ``epoch`` on the
        extended /readyz. Only fully-warmed epochs are ever advertised —
        the broker's swap gate reads exactly this."""
        owned = []
        for name, shs in self.plan.shards_of(self.node_id).items():
            dp = self.plan.datasources[name]
            owned += [shard_name(name, sh.index, dp.n_shards)
                      for sh in shs]
        self._epochs[epoch] = {"ready": True, "shards": sorted(owned)}
        for e in sorted(self._epochs)[:-2]:
            del self._epochs[e]     # older epochs can no longer swap in

    def ready_info(self) -> dict:
        """Extra /readyz fields (lock-free: attribute reads only)."""
        rec = self.epoch_record
        return {"node": self.node_id, "boot": self.boot_id,
                "epoch": rec.epoch if rec is not None else None,
                "draining": self.drain.draining,
                "epochs": dict(self._epochs)}

    def _watch_loop(self, poll_s: float) -> None:
        while not self._watch_stop.wait(poll_s):
            try:
                self.check_epoch()
            except Exception:  # noqa: BLE001 — a bad record must not kill the node
                pass
            if self.fenced:
                return

    def check_epoch(self) -> Optional[str]:
        """Run one step of this node's handover dance against the
        current deep-storage epoch record. Called from the watcher
        thread; tests with the watcher disabled call it directly.
        Returns "warmed" (joined / rebalanced into the new epoch),
        "left" (drained and fenced), or None (nothing newer)."""
        if self.ctx is None or self.fenced:
            return None
        cfg = self.ctx.config
        root = cfg.get(PERSIST_PATH)
        try:
            rec = EP.read_epoch(root)
        except EP.EpochCorrupt:
            return None             # stay on the running epoch
        cur = self.epoch_record
        if rec is None or (cur is not None and rec.epoch <= cur.epoch):
            self._retire_stale()
            return None
        new_plan = plan_cluster(
            root, len(rec.nodes),
            int(cfg.get(CLUSTER_REPLICATION)),
            int(cfg.get(CLUSTER_SHARDS)),
            node_keys=rec.ids, epoch=rec.epoch,
            strategy=str(cfg.get(CLUSTER_REBALANCE_STRATEGY)))
        if self.address in rec.nodes:
            self._warm_epoch(rec, new_plan)
            return "warmed"
        self._leave(rec, new_plan)
        return "left"

    def _warm_epoch(self, rec: EP.EpochRecord, new_plan) -> None:
        """Warm every newly owned shard from the cold tier, THEN flip
        to the new epoch and advertise. The node keeps serving the old
        epoch's shards throughout (both shard-store sets coexist until
        a new-epoch request proves the broker swapped)."""
        from spark_druid_olap_tpu_torch.segment.store import slice_segments
        my = rec.nodes.index(self.address)
        store = self.ctx.store
        for name, shs in new_plan.shards_of(my).items():
            dp = new_plan.datasources[name]
            have = set(store.names())
            need = [sh for sh in shs
                    if shard_name(name, sh.index, dp.n_shards) not in have]
            if not need:
                continue
            had_full = name in have
            if not had_full:
                # re-materialize the full datasource from deep storage
                # (tiered snapshots recover as loadable handles, so this
                # faults in only what slicing touches)
                self.ctx.persist.restore(name)
            full = store.get(name)
            if store.datasource_version(name) != dp.ingest_version \
                    or full.num_segments != dp.num_segments:
                # WAL past the manifest (see _load_shards): every broker
                # recovered the same tail and serves this datasource
                # locally, so its shards are vacuously warm
                if not had_full:
                    store.drop(name)
                continue
            tiered = getattr(full, "tier", None) is not None
            if tiered:
                from spark_druid_olap_tpu_torch.tier.loader import slice_tiered
            for sh in need:
                sname = shard_name(name, sh.index, dp.n_shards)
                shard = slice_tiered(full, sh.segment_indexes,
                                     name=sname) if tiered \
                    else slice_segments(full, sh.segment_indexes,
                                        name=sname)
                store.restore(shard, ingest_version=dp.ingest_version)
                # a freshly sliced shard holds only manifest rows:
                # pushed-batch history no longer applies to it
                with self._ingest_lock:
                    self._applied_batches.pop(sname, None)
                self.shards_warmed += 1
            if not had_full:
                store.drop(name)
        self.plan = new_plan
        self.node_id = my
        self.epoch_record = rec
        self.epochs_joined += 1
        self._advertise(rec.epoch)

    def _leave(self, rec: EP.EpochRecord, new_plan) -> None:
        """The new epoch dropped this node: keep serving until the new
        epoch can answer without us, then drain in-flight subqueries
        and fence."""
        cfg = self.ctx.config
        grace = float(cfg.get(CLUSTER_EPOCH_DRAIN_GRACE_SECONDS))
        timeout = float(cfg.get(CLUSTER_EPOCH_DRAIN_TIMEOUT_SECONDS))
        deadline = time.monotonic() + timeout
        # same pure gate the broker swaps on: neither side can observe
        # "ready" before the other could
        while (time.monotonic() < deadline
               and not self._watch_stop.is_set()
               and not plan_fully_warm(new_plan,
                                       self._gather_adverts(rec))):
            self._watch_stop.wait(0.05)
        # absorb the broker's poll lag: it may still scatter the OLD
        # epoch at us for one more probe interval after warm
        self._watch_stop.wait(grace)
        inj = getattr(self.ctx.engine, "fault", None)
        if inj is not None:
            from spark_druid_olap_tpu_torch.fault import FaultInjected
            try:
                # chaos site: an error rule models the node dying
                # mid-handover instead of draining gracefully
                inj.fire("node.drain", key=f"node:{self.node_id}")
            except FaultInjected:
                self.drain.start_drain()    # hard fence, no drain wait
                self._fence(rec, new_plan)
                return
        self.drain.start_drain()
        # bounded: a stuck query must not pin a retired node forever
        self.drain.wait_drained(timeout)
        self._fence(rec, new_plan)

    def _fence(self, rec: EP.EpochRecord, new_plan) -> None:
        self.fenced = True
        self.ready = False              # /readyz goes 503
        self.epoch_record = rec
        self.plan = new_plan
        self._epochs.clear()            # advertise nothing

    def _gather_adverts(self, rec: EP.EpochRecord) -> Dict[int, set]:
        """node id -> warm shard names advertised for ``rec``'s epoch
        (same shape the broker gathers; unreachable nodes advertise
        nothing)."""
        import http.client
        out: Dict[int, set] = {}
        want = str(rec.epoch)
        for nid, (host, port) in enumerate(rec.addresses):
            conn = http.client.HTTPConnection(host, port, timeout=2.0)
            try:
                conn.request("GET", "/readyz")
                resp = conn.getresponse()
                info = json.loads(resp.read().decode("utf-8"))
                ep = (info.get("epochs") or {}).get(want)
                if isinstance(ep, dict) and ep.get("ready"):
                    out[nid] = set(ep.get("shards") or ())
            except (OSError, ValueError):
                pass
            finally:
                conn.close()
        return out

    def _retire_stale(self) -> None:
        """Drop shard stores the current plan no longer assigns here —
        but only after a request stamped with the current (or a newer)
        epoch proves the requesting broker swapped; until then the old
        epoch's scatters still need them."""
        rec = self.epoch_record
        if rec is None or self.plan is None \
                or self._max_req_epoch < rec.epoch:
            return
        keep = set()
        for name, shs in self.plan.shards_of(self.node_id).items():
            dp = self.plan.datasources[name]
            keep |= {shard_name(name, sh.index, dp.n_shards)
                     for sh in shs}
        store = self.ctx.store
        for n in list(store.names()):
            if "::shard" in n and n not in keep:
                store.drop(n)

    # -- RPC ------------------------------------------------------------------
    def handle_subquery(self, raw: bytes):
        """-> (http status, payload, content type). 200 carries a wire-
        encoded partial result; everything else is a JSON error whose
        ``error`` kind the broker uses to pick retry-on-replica vs
        fall-back-to-local. Every admitted subquery holds a drain token
        for its whole execution — the leave protocol's fence waits on
        exactly these."""
        if not self.ready:
            return 503, WIRE.encode_error(
                "NotReady", "recovery / shard load in progress"), \
                "application/json"
        tok = self.drain.begin_subquery()
        try:
            if tok is None:
                # fencing mid-handover: retryable — the broker's replica
                # chain (or its local fallback) absorbs it
                return 503, WIRE.encode_error(
                    "Draining", "node draining for epoch handover"), \
                    "application/json"
            return self._subquery_admitted(raw)
        finally:
            self.drain.end_subquery(tok)

    def handle_join_partition(self, raw: bytes):
        """Partitioned-join hop 1: filter one owned shard, tag rows with
        their join-key partition id (join/partitioned.py). Same
        admission contract as subqueries: readiness gate + drain token,
        so epoch fences cover join exchanges too."""
        if not self.ready:
            return 503, WIRE.encode_error(
                "NotReady", "recovery / shard load in progress"), \
                "application/json"
        tok = self.drain.begin_subquery()
        try:
            if tok is None:
                return 503, WIRE.encode_error(
                    "Draining", "node draining for epoch handover"), \
                    "application/json"
            from spark_druid_olap_tpu_torch.join import partitioned as JP
            try:
                req = json.loads(raw.decode("utf-8"))
                if self.ctx.store._datasources.get(
                        str(req.get("store"))) is None:
                    return 404, WIRE.encode_error(
                        "UnknownShard",
                        f"shard {req.get('store')!r} not loaded"), \
                        "application/json"
                body = JP.partition_request(self.ctx, req)
            except (ValueError, KeyError, TypeError,
                    JP.JoinUnsupported) as e:
                return 400, WIRE.encode_error("BadJoin", str(e)), \
                    "application/json"
            return 200, body, "application/octet-stream"
        finally:
            self.drain.end_subquery(tok)

    def handle_join_exec(self, raw: bytes):
        """Partitioned-join hop 2: join one aligned partition pair on
        this node's device and return per-group partials
        (join/partitioned.py)."""
        if not self.ready:
            return 503, WIRE.encode_error(
                "NotReady", "recovery / shard load in progress"), \
                "application/json"
        tok = self.drain.begin_subquery()
        try:
            if tok is None:
                return 503, WIRE.encode_error(
                    "Draining", "node draining for epoch handover"), \
                    "application/json"
            from spark_druid_olap_tpu_torch.join import partitioned as JP
            try:
                body = JP.exec_request(self.ctx, raw)
            except (ValueError, KeyError, TypeError,
                    JP.JoinUnsupported) as e:
                return 400, WIRE.encode_error("BadJoin", str(e)), \
                    "application/json"
            return 200, body, "application/octet-stream"
        finally:
            self.drain.end_subquery(tok)

    def handle_ingest(self, raw: bytes):
        """Apply one pushed ingest batch to an owned shard store.

        -> (http status, payload, content type). The broker already
        journaled and acked the batch — this node holds NO durability
        responsibility; it only folds the rows into its in-memory shard
        so distributed scatters keep read-your-writes. Every error here
        is therefore safe: the broker just serves the datasource locally
        until the next checkpoint re-plans the shard.

        Applies are idempotent per (broker boot, push counter): a retry
        after a lost confirmation re-acks without re-appending."""
        if not self.ready:
            return 503, WIRE.encode_error(
                "NotReady", "recovery / shard load in progress"), \
                "application/json"
        tok = self.drain.begin_subquery()
        try:
            if tok is None:
                return 503, WIRE.encode_error(
                    "Draining", "node draining for epoch handover"), \
                    "application/json"
            return self._ingest_admitted(raw)
        finally:
            self.drain.end_subquery(tok)

    def _ingest_admitted(self, raw: bytes):
        from spark_druid_olap_tpu_torch.persist.wal import decode_batch
        from spark_druid_olap_tpu_torch.segment.append import append_dataframe
        inj = getattr(self.ctx.engine, "fault", None)
        if inj is not None:
            from spark_druid_olap_tpu_torch.fault import FaultInjected
            try:
                # chaos site: an owner that crashes applying a pushed
                # batch (retryable on a replica; never loses the batch —
                # the broker's journal is the durability point)
                inj.fire("hist.ingest", key=f"node:{self.node_id}")
            except FaultInjected as e:
                return 500, WIRE.encode_error("Injected", str(e)), \
                    "application/json"
        try:
            header, body = WIRE.decode_ingest(raw)
            sname = str(header["shard"])
            batch_key = (str(header.get("src") or ""),
                         int(header["batch"]))
        except (ValueError, KeyError, TypeError) as e:
            return 400, WIRE.encode_error("BadIngest", str(e)), \
                "application/json"
        store = self.ctx.store
        with self._ingest_lock:
            if store._datasources.get(sname) is None:
                # not an owned shard under the current plan: stale
                # broker plan or mid-rejoin — broker tries a replica
                return 404, WIRE.encode_error(
                    "UnknownShard", f"shard {sname!r} not loaded"), \
                    "application/json"
            src, bid = batch_key
            state = self._applied_batches.get(sname)
            if state is None or state[0] != src:
                state = (src, 0, set())     # new broker boot resets ids
            _, mark, pending = state
            if bid <= mark or bid in pending:
                return 200, json.dumps(
                    {"applied": False, "duplicate": True,
                     "shard": sname, "batch": bid}
                ).encode("utf-8"), "application/json"
            try:
                df = decode_batch(body)
                kwargs = header.get("kwargs") or {}
                new_ds = append_dataframe(
                    store._datasources[sname], df,
                    target_rows=int(kwargs.get("target_rows") or (1 << 20)))
                # register (not restore): the version bump invalidates
                # this node's result cache for the shard, exactly as a
                # local append would
                store.register(new_ds)
            except Exception as e:  # noqa: BLE001 — apply errors are retryable
                return 500, WIRE.encode_error(
                    "IngestFailed", f"{type(e).__name__}: {e}"), \
                    "application/json"
            pending.add(bid)
            while mark + 1 in pending:      # keep the pending set tiny:
                mark += 1                   # contiguous prefix collapses
                pending.discard(mark)       # into the watermark
            self._applied_batches[sname] = (src, mark, pending)
            self.batches_applied += 1
            self.batch_rows_applied += len(df)
        return 200, json.dumps(
            {"applied": True, "shard": sname, "batch": bid,
             "rows": len(df)}).encode("utf-8"), "application/json"

    def _subquery_admitted(self, raw: bytes):
        inj = getattr(self.ctx.engine, "fault", None)
        if inj is not None:
            from spark_druid_olap_tpu_torch.fault import FaultInjected
            try:
                # chaos site: a delay rule models a slow node, an error
                # rule a node-side 5xx crash (retryable on a replica)
                inj.fire("hist.handle", key=f"node:{self.node_id}")
            except FaultInjected as e:
                return 500, WIRE.encode_error("Injected", str(e)), \
                    "application/json"
        from spark_druid_olap_tpu_torch.ir.serde import query_from_dict
        from spark_druid_olap_tpu_torch.parallel.executor import (
            EngineFallback, QueryCancelled, QueryTimeout)
        from spark_druid_olap_tpu_torch.wlm.lanes import AdmissionRejected
        try:
            d, req_epoch = WIRE.split_subquery(raw)
            q = query_from_dict(d)
        except (ValueError, KeyError, TypeError) as e:
            return 400, WIRE.encode_error("BadQuery", str(e)), \
                "application/json"
        if req_epoch is not None and req_epoch > self._max_req_epoch:
            # a broker stamped a newer epoch: proof it swapped, so
            # old-epoch-only shard stores can be retired (done on the
            # watcher tick, not in the query path)
            self._max_req_epoch = req_epoch
        engine = self.ctx.engine
        try:
            r = engine.execute(q)
        except KeyError as e:
            # unknown shard store: stale plan or mid-rejoin — the
            # broker marks this node down and asks a replica
            return 404, WIRE.encode_error("UnknownDatasource", str(e)), \
                "application/json"
        except AdmissionRejected as e:
            return 429, WIRE.encode_error(
                "AdmissionRejected", str(e),
                retryAfterSeconds=float(getattr(e, "retry_after_s", 1.0))), \
                "application/json"
        except EngineFallback as e:
            # this node cannot answer the shape (e.g. sketch over the
            # hashed tier); no replica can either — broker runs it
            # locally through its own session-level host tier
            return 422, WIRE.encode_error("EngineFallback", str(e)), \
                "application/json"
        except (QueryCancelled, QueryTimeout) as e:
            return 504, WIRE.encode_error(type(e).__name__, str(e)), \
                "application/json"
        ls = engine.last_stats
        stats = {"node": self.node_id,
                 "cache": ls.get("cache"),
                 "sharedscan": ls.get("sharedscan"),
                 "total_ms": ls.get("total_ms")}
        return 200, WIRE.encode_result(r.columns, r.data, stats), \
            "application/octet-stream"
