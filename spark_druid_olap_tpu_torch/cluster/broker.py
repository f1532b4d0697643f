"""Broker: scatter per-shard subqueries, merge partials, survive nodes.

Port of ``spark_druid_olap_tpu/cluster/broker.py``: a copy kept inside
the PyTorch package. The partitioned join (``join/partitioned.py``) sends
its two hops through :meth:`ClusterClient._guarded_rpc` and counts them in
``join_scatters`` and ``join_shuffle_bytes``.

The client hangs off the broker engine's ``cluster`` attribute and is
consulted by ``QueryEngine._execute_admitted`` after the result-cache
lookup: a distributed answer populates the broker's own cache, so
dashboard storms are absorbed locally and only cold queries scatter.

Plan-once / scatter / merge (≈ the reference's broker merging historical
partials; Theseus's scatter–gather over partition-local operators):

1. ``should_distribute`` — spec shape + every agg merge-closed + the
   broker's in-memory ingest version matches the planned manifest
   (read-your-writes: a datasource ingested or appended after boot is
   served locally until the next checkpoint + restart).
2. ``execute`` — strips broker-side phases (post-aggs, HAVING, ORDER
   BY/LIMIT; TopN becomes a per-shard GroupBy), scatters one subquery
   per shard over a thread pool, each shard trying its replica chain
   with decorrelated-jitter backoff between passes; merges partials
   (cluster/merge.py) and runs the engine's own ``_agg_epilogue``.
3. Any non-retryable condition — serde gap, node-side EngineFallback,
   replicas exhausted — returns ``None``: the engine falls through to
   ordinary local execution (the broker holds a full recovered copy),
   so distribution is an accelerator, never a new failure mode.

Node health: RPC connection errors / timeouts mark the node down
reactively; a background prober (GET /readyz, decorrelated-jitter
interval) marks nodes down AND back up, so a restarted historical
resumes primary routing without operator action. On top of reactive
marks, graceful degradation (docs/CHAOS.md):

- per-node circuit breakers (cluster/breaker.py) skip a node without an
  RPC after K consecutive failures, with half-open probes after a
  cooldown;
- hedged scatter: a subquery that hasn't answered within the hedge
  delay (fixed, or a latency quantile of recent RPCs) races a duplicate
  to the next replica and takes the first answer;
- ``sdot.cluster.partial.results``: when every replica of a shard is
  unreachable, surviving shards still answer, annotated with
  ``degraded={missing_shards, coverage_rows}`` — never cached. Strict
  mode keeps the exact-or-ShardUnavailable contract.

Elastic topology (cluster/epoch.py): all routing state lives in an
immutable-per-epoch ``_EpochState`` (node list, plan, breaker board,
down map). The prober tick polls deep storage for a newer epoch record;
a newer one becomes the *pending* state, and the broker keeps
scattering against the ACTIVE state until every shard of the pending
plan has at least one owner advertising it warm on the extended
``/readyz`` (``assign.plan_fully_warm``) — then the swap is one
reference assignment, and in-flight scatters (which captured the old
state at entry) finish against nodes that are still draining, never
fenced. Each epoch gets a FRESH breaker board, and within an epoch a
node whose ``/readyz`` boot generation changes gets its breaker reset —
a rejoining process never inherits its predecessor's open circuit.

The shard-level subquery cache (cluster/subqcache.py) sits in front of
the scatter: partials are keyed by (subquery shape, shard identity,
ingest version) — node- and epoch-free — so a repeated dashboard storm
re-sends RPCs only for shards whose data could have changed, and a
topology change invalidates nothing.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import random as _random
import threading
import time as _time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from spark_druid_olap_tpu_torch.cluster import epoch as EP
from spark_druid_olap_tpu_torch.cluster import merge as MG
from spark_druid_olap_tpu_torch.cluster import subqcache as SQC
from spark_druid_olap_tpu_torch.cluster import wire as WIRE
from spark_druid_olap_tpu_torch.cluster.assign import (
    parse_nodes, plan_cluster, plan_diff, plan_fully_warm, shard_name)
from spark_druid_olap_tpu_torch.cluster.autoscale import AutoscaleHook
from spark_druid_olap_tpu_torch.cluster.breaker import BreakerBoard
from spark_druid_olap_tpu_torch.ir import serde as SERDE
from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.result import QueryResult
from spark_druid_olap_tpu_torch.utils.config import (
    CLUSTER_AUTOSCALE_COOLDOWN_SECONDS,
    CLUSTER_AUTOSCALE_ENABLED,
    CLUSTER_AUTOSCALE_QUEUE_HIGH,
    CLUSTER_AUTOSCALE_QUEUE_LOW,
    CLUSTER_BREAKER_COOLDOWN_SECONDS,
    CLUSTER_BREAKER_FAILURES,
    CLUSTER_HEDGE_AFTER_MS,
    CLUSTER_HEDGE_ENABLED,
    CLUSTER_HEDGE_MIN_MS,
    CLUSTER_HEDGE_QUANTILE,
    CLUSTER_INGEST_PUSH,
    CLUSTER_LOCAL_FALLBACK,
    CLUSTER_NODES,
    CLUSTER_PARTIAL_RESULTS,
    CLUSTER_PROBE_INTERVAL_SECONDS,
    CLUSTER_PROBE_JITTER,
    CLUSTER_REBALANCE_STRATEGY,
    CLUSTER_REPLICATION,
    CLUSTER_RETRY_BACKOFF_CAP_SECONDS,
    CLUSTER_RETRY_BACKOFF_START_SECONDS,
    CLUSTER_RETRY_TRIES,
    CLUSTER_RPC_TIMEOUT_SECONDS,
    CLUSTER_SCATTER_THREADS,
    CLUSTER_SHARDS,
    CLUSTER_SUBQ_CACHE_ENABLED,
    CLUSTER_SUBQ_CACHE_MAX_BYTES,
    PERSIST_PATH,
)
from spark_druid_olap_tpu_torch.utils.retry import backoff


class ClusterError(RuntimeError):
    """A shard stayed unreachable through every replica and retry pass,
    and local fallback is disabled."""


class ShardUnavailable(ClusterError):
    """Every replica of a shard stayed unreachable. In strict mode this
    propagates to the caller; in partial-results mode the broker catches
    it per shard and answers degraded from the survivors."""


class _BreakerOpen(Exception):
    """Internal: the node's circuit breaker refused the attempt."""

    def __init__(self, node_id: int):
        super().__init__(f"breaker open for node {node_id}")
        self.node_id = node_id


class _HedgeRace:
    """First-success race between a primary RPC leg and a delayed hedge
    leg. ``close()`` (sdlint leaks pair) cancels the race so a late
    loser can neither win nor leak into the next attempt."""

    def __init__(self, total: int):
        self._lock = threading.Lock()   # leaf — never calls out while held
        self.done = threading.Event()
        self.total = total
        self.finished = 0
        self.cancelled = False
        self.winner = None              # (status, body, node_id)
        self.errors: List[Tuple[int, Exception]] = []

    def settle(self, nid, out, err) -> None:
        """One leg finished (out), failed (err), or stood down (both
        None — a hedge whose primary answered inside the delay)."""
        with self._lock:
            self.finished += 1
            if err is not None:
                self.errors.append((nid, err))
            elif out is not None and self.winner is None \
                    and not self.cancelled:
                self.winner = out
            if self.winner is not None or self.finished >= self.total:
                self.done.set()

    def result(self):
        with self._lock:
            return self.winner, list(self.errors)

    def close(self) -> None:
        with self._lock:
            self.cancelled = True


class _LocalFallback(Exception):
    """Internal: this query must run on the broker's own engine."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class _EpochState:
    """Everything the scatter path reads about ONE topology epoch —
    captured once at query entry, so an epoch swap mid-scatter cannot
    mix node lists, plans, or breaker boards. ``down`` and ``boot_ids``
    are mutable (guarded by the client lock) but die with the state."""

    __slots__ = ("record", "nodes", "plan", "breakers", "down",
                 "boot_ids")

    def __init__(self, record, plan, breakers):
        self.record = record                # EpochRecord
        self.nodes = record.addresses       # ((host, port), ...)
        self.plan = plan
        self.breakers = breakers
        self.down: Dict[int, float] = {}    # node id -> down-since
        self.boot_ids: Dict[int, str] = {}  # node id -> last seen boot gen


class ClusterClient:
    def __init__(self, ctx):
        self.ctx = ctx
        self.engine = ctx.engine
        self.config = ctx.config
        boot_nodes = parse_nodes(self.config.get(CLUSTER_NODES))
        if not boot_nodes:
            raise ValueError("ClusterClient needs sdot.cluster.nodes")
        root = self.config.get(PERSIST_PATH)
        if not root:
            raise ValueError(
                "the cluster tier coordinates through deep storage; "
                "set sdot.persist.path on every member")
        self.root = root
        self.strategy = str(self.config.get(CLUSTER_REBALANCE_STRATEGY))
        self.rpc_timeout = float(
            self.config.get(CLUSTER_RPC_TIMEOUT_SECONDS))
        self.tries = max(1, int(self.config.get(CLUSTER_RETRY_TRIES)))
        self.backoff_start = float(
            self.config.get(CLUSTER_RETRY_BACKOFF_START_SECONDS))
        self.backoff_cap = float(
            self.config.get(CLUSTER_RETRY_BACKOFF_CAP_SECONDS))
        self.local_fallback = bool(self.config.get(CLUSTER_LOCAL_FALLBACK))
        self.fault = getattr(ctx.engine, "fault", None)
        # epoch 0 is implicit (the static config list) unless deep
        # storage already holds a published record — then that record,
        # not the config, is the fleet's truth
        rec = EP.read_epoch(root)
        if rec is None:
            rec = EP.bootstrap_record(
                tuple(f"{h}:{p}" for h, p in boot_nodes))
        self._active: _EpochState = self._mk_state(rec)
        self._pending: Optional[_EpochState] = None
        self.last_rebalance: Optional[dict] = None
        self.subq_cache = SQC.SubqueryCache(
            int(self.config.get(CLUSTER_SUBQ_CACHE_MAX_BYTES))
            if bool(self.config.get(CLUSTER_SUBQ_CACHE_ENABLED)) else 0)
        self.autoscale: Optional[AutoscaleHook] = None
        if bool(self.config.get(CLUSTER_AUTOSCALE_ENABLED)):
            self.autoscale = AutoscaleHook(
                float(self.config.get(CLUSTER_AUTOSCALE_QUEUE_HIGH)),
                float(self.config.get(CLUSTER_AUTOSCALE_QUEUE_LOW)),
                float(self.config.get(CLUSTER_AUTOSCALE_COOLDOWN_SECONDS)))
        self.hedge_enabled = bool(self.config.get(CLUSTER_HEDGE_ENABLED))
        self.hedge_after_ms = float(self.config.get(CLUSTER_HEDGE_AFTER_MS))
        self.hedge_quantile = float(self.config.get(CLUSTER_HEDGE_QUANTILE))
        self.hedge_min_ms = float(self.config.get(CLUSTER_HEDGE_MIN_MS))
        self.probe_jitter = bool(self.config.get(CLUSTER_PROBE_JITTER))
        self._latencies = deque(maxlen=512)     # recent subquery RPC seconds
        self._lock = threading.Lock()
        # distributed ingest (read-your-writes): per-datasource push
        # state — which owners confirmed which shards, and whether any
        # acked batch is still in flight to its owners. LOCK ORDER:
        # _lock before _ingest_lock (neither calls out while held).
        self.ingest_push_enabled = bool(
            self.config.get(CLUSTER_INGEST_PUSH))
        self._ingest_lock = threading.Lock()
        self._ingested: Dict[str, dict] = {}
        # per-shard-store batch ids, dense from 1: the historical's
        # out-of-order dedup collapses a contiguous prefix into its
        # watermark, which only works when ids have no per-shard gaps
        self._ingest_seq: Dict[str, int] = {}
        self._boot_id = f"{os.getpid()}.{_time.time_ns()}"
        self.counters = {"queries": 0, "scatters": 0, "subqueries": 0,
                         "retries": 0, "failovers": 0, "local_fallbacks": 0,
                         "shards_pruned": 0, "merge_ms": 0.0,
                         "probe_marks_down": 0, "probe_marks_up": 0,
                         "wire_corrupt": 0, "hedges_launched": 0,
                         "hedges_won": 0, "degraded_queries": 0,
                         "epoch_checks": 0, "epoch_swaps": 0,
                         "breaker_resets": 0,
                         "subq_cache_hits": 0, "subq_cache_misses": 0,
                         "ingest_pushes": 0, "ingest_push_failures": 0,
                         "ingest_rows_pushed": 0, "ryw_scatters": 0,
                         "join_scatters": 0, "join_shuffle_bytes": 0}
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(self.config.get(CLUSTER_SCATTER_THREADS))),
            thread_name_prefix="sdot-scatter")
        self._stop = threading.Event()
        self._prober: Optional[threading.Thread] = None
        interval = float(self.config.get(CLUSTER_PROBE_INTERVAL_SECONDS))
        if interval > 0:
            self._prober = threading.Thread(
                target=self._probe_loop, args=(interval,),
                name="sdot-cluster-prober", daemon=True)
            self._prober.start()

    def close(self) -> None:
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=2.0)
            self._prober = None
        self._pool.shutdown(wait=False)

    # -- epoch state -----------------------------------------------------------
    # back-compat views over the ACTIVE epoch: code and tests written
    # against the static-topology broker keep reading .nodes/.plan/
    # .breakers and transparently follow swaps
    @property
    def nodes(self):
        return self._active.nodes

    @property
    def plan(self):
        return self._active.plan

    @property
    def breakers(self):
        return self._active.breakers

    def _mk_state(self, record) -> _EpochState:
        plan = plan_cluster(
            self.root, len(record.nodes),
            int(self.config.get(CLUSTER_REPLICATION)),
            int(self.config.get(CLUSTER_SHARDS)),
            node_keys=record.ids, epoch=record.epoch,
            strategy=self.strategy)
        # a FRESH breaker board per epoch: node id i of epoch E+1 may be
        # a different machine than node id i of epoch E, and must not
        # inherit its circuit state (one board per epoch, by construction)
        breakers = BreakerBoard(
            len(record.nodes),
            int(self.config.get(CLUSTER_BREAKER_FAILURES)),
            float(self.config.get(CLUSTER_BREAKER_COOLDOWN_SECONDS)))
        return _EpochState(record, plan, breakers)

    def check_epoch(self) -> bool:
        """One step of the broker's handover dance: adopt a newer disk
        record as the *pending* state, and swap it active once every
        shard of its plan is advertised warm by at least one owner.
        Called from the prober tick; tests with the prober disabled call
        it directly. Returns True when the active epoch changed."""
        with self._lock:
            self.counters["epoch_checks"] += 1
        try:
            rec = EP.read_epoch(self.root)
        except EP.EpochCorrupt:
            return False        # stay on the running epoch; nothing sane on disk
        if rec is None:
            return False
        act = self._active
        pend = self._pending
        if rec.epoch > act.record.epoch and (
                pend is None or pend.record.epoch != rec.epoch):
            # a newer record supersedes any half-warmed pending epoch —
            # its nodes re-advertise under the newest epoch instead
            pend = self._mk_state(rec)
            with self._lock:
                self._pending = pend
        if pend is None:
            return False
        if not plan_fully_warm(pend.plan, self._gather_adverts(pend)):
            return False
        diff = plan_diff(act.plan, pend.plan)
        with self._lock:
            self._active = pend
            self._pending = None
            self.counters["epoch_swaps"] += 1
            self.last_rebalance = {
                "from_epoch": act.record.epoch,
                "to_epoch": pend.record.epoch,
                "strategy": self.strategy, **diff.summary()}
            # the new epoch's nodes re-slice shards from the MANIFEST:
            # pushed-but-uncheckpointed batches are not in their stores,
            # so every read-your-writes confirmation is void. Dropping
            # the state fails the version/confirmation gate and the
            # broker serves those datasources locally — acked batches
            # are its own journaled rows, so an epoch swap can never
            # drop one. In-flight pushes hold references to the OLD
            # state objects and land harmlessly there.
            with self._ingest_lock:
                self._ingested = {}
        return True

    def _gather_adverts(self, st: _EpochState) -> Dict[int, set]:
        """node id -> shard-store names that node advertises warm for
        ``st``'s epoch (extended /readyz). Unreachable nodes simply
        advertise nothing — the gate stays closed until they answer."""
        out: Dict[int, set] = {}
        want = str(st.record.epoch)
        for nid in range(len(st.nodes)):
            _ok, info = self._probe(st, nid)
            ep = ((info or {}).get("epochs") or {}).get(want)
            if isinstance(ep, dict) and ep.get("ready"):
                out[nid] = set(ep.get("shards") or ())
        return out

    # -- health ----------------------------------------------------------------
    def _mark_down(self, st: _EpochState, node_id: int,
                   probe: bool = False) -> None:
        with self._lock:
            if node_id not in st.down:
                st.down[node_id] = _time.time()
                if probe:
                    self.counters["probe_marks_down"] += 1

    def _mark_up(self, st: _EpochState, node_id: int,
                 probe: bool = False) -> None:
        with self._lock:
            if st.down.pop(node_id, None) is not None and probe:
                self.counters["probe_marks_up"] += 1

    def _is_down(self, st: _EpochState, node_id: int) -> bool:
        with self._lock:
            return node_id in st.down

    def _probe_loop(self, interval: float) -> None:
        # decorrelated jitter so N brokers probing the same rejoining
        # historical spread out instead of thundering in lockstep; each
        # tick lands in [interval/2, 1.5*interval]
        rng = _random.Random()
        delay = interval
        while not self._stop.wait(delay):
            try:
                self.check_epoch()
            except Exception:  # noqa: BLE001 — a bad record must not kill probes
                pass
            st = self._active
            depths = []
            for nid in range(len(st.nodes)):
                if self._stop.is_set():
                    return
                ok, info = self._probe(st, nid)
                if ok:
                    self._mark_up(st, nid, probe=True)
                else:
                    self._mark_down(st, nid, probe=True)
                boot = (info or {}).get("boot")
                if boot is not None:
                    prev = st.boot_ids.get(nid)
                    if prev is not None and prev != boot:
                        # same address, new process generation: the
                        # predecessor's circuit state is meaningless
                        st.breakers.reset(nid)
                        with self._lock:
                            self.counters["breaker_resets"] += 1
                    st.boot_ids[nid] = boot
                if ok and self.autoscale is not None:
                    d = self._wlm_depth(st, nid)
                    if d is not None:
                        depths.append(d)
            if self.autoscale is not None:
                self.autoscale.observe(
                    depths,
                    handover_in_progress=self._pending is not None)
            if self.probe_jitter:
                delay = backoff(interval * 0.5, interval * 1.5, 1,
                                prev=delay, rng=rng)
            else:
                delay = interval

    def _probe(self, st: _EpochState, node_id: int):
        """GET /readyz -> (ready, parsed body or None)."""
        host, port = st.nodes[node_id]
        conn = http.client.HTTPConnection(
            host, port, timeout=min(2.0, self.rpc_timeout))
        try:
            conn.request("GET", "/readyz")
            resp = conn.getresponse()
            body = resp.read()
            try:
                info = json.loads(body.decode("utf-8"))
            except ValueError:
                info = None
            return resp.status == 200, info
        except OSError:
            return False, None
        finally:
            conn.close()

    def _wlm_depth(self, st: _EpochState, node_id: int) -> Optional[float]:
        """One node's total queued-query depth (autoscale signal)."""
        host, port = st.nodes[node_id]
        conn = http.client.HTTPConnection(
            host, port, timeout=min(2.0, self.rpc_timeout))
        try:
            conn.request("GET", "/metadata/wlm")
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                return None
            lanes = json.loads(body.decode("utf-8")).get("lanes") or []
            return float(sum(ln.get("queued", 0) for ln in lanes))
        except (OSError, ValueError):
            return None
        finally:
            conn.close()

    # -- distributed ingest (read-your-writes) ---------------------------------
    def ingest_begin(self, name: str):
        """First half of a cluster write: called by Context.stream_ingest
        BEFORE the batch is journaled locally, so there is no instant at
        which a batch is acked but not accounted in-flight. Returns a
        token for :meth:`ingest_finish`, or None when the datasource is
        not in the active plan (push pointless — broker-local anyway)."""
        if not self.ingest_push_enabled:
            return None
        st = self._active
        if st.plan.datasources.get(name) is None:
            return None
        with self._ingest_lock:
            state = self._ingested.setdefault(name, {
                "epoch": st.record.epoch, "inflight": 0,
                "version": -1, "target": -1, "shards": {}})
            state["inflight"] += 1
        # the token pins the state OBJECT: an epoch swap mid-push
        # replaces self._ingested wholesale, and a finish landing on the
        # orphaned object can never corrupt the new epoch's accounting
        return (st, state)

    def ingest_finish(self, token, name: str, df, kwargs: dict) -> None:
        """Second half: push the (already locally durable and acked)
        batch to every owner of its time-matched shard, then settle the
        read-your-writes watermark. ``df=None`` means the local apply
        failed — nothing was acked, just release the in-flight slot.
        Never raises: a push failure only costs scatter eligibility."""
        st, state = token
        sh = None
        confirmed: set = set()
        try:
            dp = st.plan.datasources.get(name)
            if df is not None and len(df) and dp is not None:
                sh = self._target_shard(dp, name, df, kwargs)
                if sh is not None:
                    confirmed = self._push_to_owners(
                        st, dp, name, sh, df, kwargs)
        except Exception:  # noqa: BLE001 — ACK already happened; never re-raise
            with self._lock:
                self.counters["ingest_push_failures"] += 1
        finally:
            ver = self.engine.store.datasource_version(name)
            with self._ingest_lock:
                if sh is not None:
                    prior = state["shards"].get(sh.index)
                    if prior is None:
                        # first push to this shard: before it, every
                        # owner held exactly the manifest rows
                        prior = set(sh.owners)
                    state["shards"][sh.index] = prior & confirmed
                # ``target`` tracks the newest local version observed at
                # a settle — when the LAST in-flight push settles, every
                # acked batch has been offered to its owners, so target
                # is exactly the version whose content they confirm
                state["target"] = max(state["target"], ver)
                state["inflight"] -= 1
                if state["inflight"] <= 0:
                    state["inflight"] = 0
                    state["version"] = state["target"]

    def _target_shard(self, dp, name: str, df, kwargs: dict):
        """The shard whose time envelope best matches the batch (max
        overlap; for a batch past every envelope — the common streaming
        case — the nearest, i.e. newest, shard)."""
        shards = dp.shards
        if not shards:
            return None
        tc = kwargs.get("time_column")
        if not tc:
            ds = self.engine.store._datasources.get(name)
            t = getattr(ds, "time", None)
            tc = t.name if t is not None else None
        if not tc or tc not in df.columns:
            return shards[-1]
        from spark_druid_olap_tpu_torch.segment.ingest import _to_epoch_millis
        millis = _to_epoch_millis(df[tc])
        lo, hi = int(millis.min()), int(millis.max())
        best, best_ov = None, None
        for sh in shards:
            ov = min(hi, sh.max_ms) - max(lo, sh.min_ms)
            if best_ov is None or ov > best_ov:
                best, best_ov = sh, ov
        return best

    def _push_to_owners(self, st: _EpochState, dp, name: str, sh, df,
                        kwargs: dict) -> set:
        """Offer one batch to every owner of ``sh``; -> confirmed node
        ids. ALL replicas must apply for scatter read-your-writes to
        hold (a scatter may read any replica), so a down owner simply
        drops out of the confirmed set and the broker serves this
        datasource locally until a checkpoint + epoch re-plan."""
        from spark_druid_olap_tpu_torch.persist.wal import encode_batch
        from spark_druid_olap_tpu_torch.segment.append import wal_kwargs_to_dict
        body = encode_batch(df)
        sname = shard_name(name, sh.index, dp.n_shards)
        with self._ingest_lock:
            bid = self._ingest_seq.get(sname, 0) + 1
            self._ingest_seq[sname] = bid
        payload = WIRE.encode_ingest(name, sname, bid,
                                     wal_kwargs_to_dict(kwargs), body,
                                     src=self._boot_id)
        confirmed = set()
        for nid in sh.owners:
            for _attempt in range(2):       # one retry on connect error
                try:
                    status, _resp = self._ingest_rpc(st, nid, payload)
                except OSError:
                    self._mark_down(st, nid)
                    continue
                self._mark_up(st, nid)
                if status == 200:
                    confirmed.add(nid)
                break       # a coherent non-200 won't improve on retry
        with self._lock:
            self.counters["ingest_pushes"] += 1
            self.counters["ingest_rows_pushed"] += len(df)
            if confirmed != set(sh.owners):
                self.counters["ingest_push_failures"] += 1
        return confirmed

    def _ingest_rpc(self, st: _EpochState, node_id: int,
                    payload: bytes) -> Tuple[int, bytes]:
        inj = self.fault
        key = f"node:{node_id}"
        if inj is not None:
            # chaos site: the push leg dying on the wire (the batch is
            # already durable + acked on the broker; the only stake is
            # scatter eligibility)
            inj.fire("rpc.ingest", key)
        host, port = st.nodes[node_id]
        conn = http.client.HTTPConnection(host, port,
                                          timeout=self.rpc_timeout)
        try:
            conn.request("POST", "/cluster/ingest", payload,
                         {"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            body = resp.read()
        finally:
            conn.close()
        return resp.status, body

    def _ryw_state(self, name: str, ver: int) -> Optional[dict]:
        """The push state iff it proves every owner of every touched
        shard holds ALL acked batches for ``name`` at local version
        ``ver`` — i.e. scattering now preserves read-your-writes.
        None -> serve locally (always safe: the broker holds the rows)."""
        st = self._active
        with self._ingest_lock:
            state = self._ingested.get(name)
            if state is None \
                    or state.get("epoch") != st.record.epoch \
                    or state["inflight"] != 0 \
                    or state["version"] != ver:
                return None
            if not all(bool(s) for s in state["shards"].values()):
                return None     # some touched shard lost all its owners
            return {i: tuple(sorted(s))
                    for i, s in state["shards"].items()}

    # -- eligibility -----------------------------------------------------------
    def should_distribute(self, q) -> bool:
        if not isinstance(q, (S.GroupByQuerySpec, S.TimeseriesQuerySpec,
                              S.TopNQuerySpec, S.SelectQuerySpec,
                              S.SearchQuerySpec)):
            return False
        dp = self.plan.datasources.get(getattr(q, "datasource", None))
        if dp is None:
            return False
        # read-your-writes: post-boot ingest/appends bumped the broker's
        # in-memory version past the planned manifest — serve locally so
        # writes are immediately visible, UNLESS the ingest push path
        # proves every owner already applied every acked batch
        ver = self.engine.store.datasource_version(q.datasource)
        if ver != dp.ingest_version \
                and self._ryw_state(q.datasource, ver) is None:
            return False
        # Select/Search carry no aggregations: their merges (concat +
        # re-page, count sum + re-limit) are always closed
        for a in getattr(q, "aggregations", ()):
            if a.kind not in MG.MERGEABLE_KINDS:
                return False
        return True

    # -- scatter / merge -------------------------------------------------------
    def execute(self, q, t0: float) -> Optional[QueryResult]:
        """Distributed answer, or None to run locally (never raises for
        conditions local execution can absorb)."""
        self.counters["queries"] += 1
        # capture the epoch state ONCE: a swap mid-scatter must not mix
        # the old plan with the new node list (old-epoch nodes keep
        # serving through their drain grace precisely for us)
        st = self._active
        try:
            if isinstance(q, S.SelectQuerySpec):
                return self._execute_select(q, st, t0)
            if isinstance(q, S.SearchQuerySpec):
                return self._execute_search(q, st, t0)
            return self._execute_agg(q, st, t0)
        except _LocalFallback as e:
            return self._local(e.reason)

    def _scatter(self, q, sub, st: _EpochState, t0: float):
        """Scatter ``sub`` to every (interval-surviving) shard of the
        query's datasource and drain the replies. Returns
        ``(parts, meta)`` where ``parts`` is ``[(shard_index, data)]``
        in shard-index order (Select needs block order; agg merges are
        order-free) and ``meta`` carries the scatter accounting shared
        by every query shape. Raises :class:`_LocalFallback` whenever
        local execution must take over."""
        try:
            body = json.dumps(SERDE.query_to_dict(sub)).encode("utf-8")
        except (ValueError, TypeError) as e:
            raise _LocalFallback(f"serde: {e}") from e
        dp = st.plan.datasources.get(q.datasource)
        if dp is None:
            raise _LocalFallback("datasource not in the captured plan")
        # read-your-writes scatter: the local version ran past the
        # manifest but the push path confirmed every owner — scatter,
        # restricted to the confirmed replica sets. A version that fails
        # the proof (including races since should_distribute) serves
        # locally, which is always correct.
        ver = self.engine.store.datasource_version(q.datasource)
        ryw = None
        if ver != dp.ingest_version:
            ryw = self._ryw_state(q.datasource, ver)
            if ryw is None:
                raise _LocalFallback(
                    "post-manifest writes not confirmed on owners")
            self.counters["ryw_scatters"] += 1
        deadline = None
        tm = getattr(q.context, "timeout_millis", None)
        if tm:
            deadline = t0 + float(tm) / 1000.0
        # interval pruning: shards are contiguous time blocks, so a shard
        # whose [min_ms, max_ms] envelope cannot overlap any query
        # interval need not be scattered to at all (≈ Druid's time-chunk
        # pruning on the broker). Pushed appends grow a shard PAST its
        # planned envelope, so pruning is off in read-your-writes mode —
        # stale bounds must not prune the shard holding the new rows.
        shards = dp.shards
        pruned = 0
        if getattr(q, "intervals", None) and ryw is None:
            keep = tuple(
                sh for sh in shards
                if any(sh.max_ms >= lo and sh.min_ms < hi
                       for lo, hi in q.intervals))
            pruned = len(shards) - len(keep)
            shards = keep
        self.counters["shards_pruned"] += pruned
        if not shards:
            # every shard outside the interval: the empty answer is
            # cheaper (and shape-exact) on the broker's local engine
            raise _LocalFallback("all shards pruned by query interval")
        partial = bool(self.config.get(CLUSTER_PARTIAL_RESULTS))
        # shard-level cache in front of the scatter: a hit replays the
        # decoded partial (merge never mutates parts) with zero RPCs;
        # keys are (shape, shard, ingest version) — node- and
        # epoch-free, so entries survive topology changes
        bkey = SQC.body_key(body)
        cache = self.subq_cache
        futs = []
        parts, nodes_used = [], set()
        missing, covered_rows, total_rows = [], 0, 0
        cache_hits = 0
        for sh in shards:
            total_rows += sh.rows
            # cache under the broker's LOCAL version (== the manifest
            # version outside read-your-writes mode): every acked append
            # bumps it, so a partial computed over pushed rows can never
            # be replayed for a version that has since grown
            ck = cache.key(bkey, q.datasource, sh.index, dp.n_shards,
                           ver)
            data = cache.get(ck) if cache.enabled else None
            if data is not None:
                cache_hits += 1
                parts.append((sh.index, data))
                covered_rows += sh.rows
                continue
            name = shard_name(q.datasource, sh.index, dp.n_shards)
            owners = sh.owners if ryw is None \
                else ryw.get(sh.index, sh.owners)
            futs.append((sh, ck, self._pool.submit(
                self._run_shard, st, body, name, owners, deadline,
                partial)))
        self.counters["scatters"] += len(futs)
        if cache.enabled:
            self.counters["subq_cache_hits"] += cache_hits
            self.counters["subq_cache_misses"] += len(futs)
        err: Optional[Exception] = None
        for sh, ck, f in futs:
            try:
                data, nid, nbytes = f.result()
                parts.append((sh.index, data))
                nodes_used.add(nid)
                covered_rows += sh.rows
                cache.put(ck, data, nbytes)
            except ShardUnavailable as e:
                # degraded mode: answer from the survivors and say so
                if partial:
                    missing.append(sh.index)
                    continue
                if err is None:
                    err = e
            except Exception as e:  # noqa: BLE001 — every shard must drain
                if err is None:
                    err = e
        if err is not None:
            raise err
        degraded = None
        if missing:
            self.counters["degraded_queries"] += 1
            degraded = {"missing_shards": sorted(missing),
                        "coverage_rows": covered_rows,
                        "total_rows": total_rows}
        parts.sort(key=lambda t: t[0])
        meta = {"shards": len(futs) + cache_hits, "pruned": pruned,
                "nodes_used": nodes_used, "cache_hits": cache_hits,
                "cache_enabled": cache.enabled, "degraded": degraded,
                "epoch": st.record.epoch}
        return parts, meta

    def _finish(self, q, r: QueryResult, meta: dict, merge_ms: float,
                t0: float) -> QueryResult:
        """Shared result annotation for every distributed query shape."""
        self.counters["merge_ms"] += merge_ms
        r.degraded = meta["degraded"]
        cl_stats = {
            "mode": "scatter", "shards": meta["shards"],
            "shards_pruned": meta["pruned"],
            "nodes": sorted(meta["nodes_used"]),
            "epoch": meta["epoch"],
            "merge_ms": round(merge_ms, 3)}
        if meta["cache_enabled"]:
            cl_stats["subq_cache_hits"] = meta["cache_hits"]
        if meta["degraded"] is not None:
            cl_stats["degraded"] = meta["degraded"]
        self.engine.last_stats["cluster"] = cl_stats
        self.engine.last_stats["datasource"] = q.datasource
        self.engine.last_stats["total_ms"] = \
            (_time.perf_counter() - t0) * 1000
        return r

    def _execute_agg(self, q, st: _EpochState, t0: float) -> QueryResult:
        sub, posts, having, limit, key_cols, aggs = _strip(q)
        tagged, meta = self._scatter(q, sub, st, t0)
        parts = [d for _, d in tagged]
        # quantile finalization happens exactly once, here: name ->
        # fraction so the broker's merged KLL registers estimate at the
        # query's asked-for rank (engines shipped raw registers)
        fractions = {a.name: a.fraction for a in q.aggregations
                     if getattr(a, "fraction", None) is not None}
        t_m = _time.perf_counter()
        if parts:
            columns, data, n = MG.merge_partials(parts, key_cols, aggs,
                                                 fractions)
        else:
            # every shard missing (degraded): shape-exact empty answer
            columns, data, n = \
                list(key_cols) + [name for name, _ in aggs], {}, 0
        merge_ms = (_time.perf_counter() - t_m) * 1000
        names = list(columns)
        if n == 0:
            # match the engine's empty-scan shape (posts stay unevaluated)
            names += [p.name for p in posts]
            r = QueryResult.empty(names)
        else:
            data = self.engine._agg_epilogue(data, names, posts, having,
                                             limit)
            r = QueryResult(names, data)
        return self._finish(q, r, meta, merge_ms, t0)

    def _execute_select(self, q: S.SelectQuerySpec, st: _EpochState,
                        t0: float) -> QueryResult:
        """Distributed paged select: every shard answers an EXTENDED
        first page (offset + page_size rows — the broker cannot know
        how the global offset splits across shards), the broker concats
        the blocks in shard-index order (shards are contiguous time
        blocks), re-sorts by the time column when it is in the output
        (stable, so intra-shard row order survives), and re-pages."""
        sub = dataclasses.replace(q, page_size=q.page_offset + q.page_size,
                                  page_offset=0)
        tagged, meta = self._scatter(q, sub, st, t0)
        t_m = _time.perf_counter()
        ds = self.engine.store.get(q.datasource)
        cols = list(q.columns) or ds.column_names()
        blocks = [d for _, d in tagged if d and len(next(iter(d.values())))]
        if q.descending:
            blocks = blocks[::-1]
        if not blocks:
            r = QueryResult.empty(cols)
            return self._finish(
                q, r, meta, (_time.perf_counter() - t_m) * 1000, t0)
        data = {c: np.concatenate([b[c] for b in blocks]) for c in cols}
        tname = ds.time.name if ds.time is not None else None
        if tname is not None and tname in data:
            tv = np.asarray(data[tname])
            if tv.dtype.kind == "M":
                tv = tv.astype("datetime64[ms]").astype(np.int64)
            order = np.argsort(-tv if q.descending else tv, kind="stable")
            data = {c: v[order] for c, v in data.items()}
        page = slice(q.page_offset, q.page_offset + q.page_size)
        data = {c: v[page] for c, v in data.items()}
        r = QueryResult(cols, data)
        return self._finish(
            q, r, meta, (_time.perf_counter() - t_m) * 1000, t0)

    def _execute_search(self, q: S.SearchQuerySpec, st: _EpochState,
                        t0: float) -> QueryResult:
        """Distributed dimension-value search: per-(dimension, value)
        occurrence counts SUM across shards (each shard counted its own
        rows), rows re-sort to the single-engine order — dimensions in
        query order, values in ascending (global-dictionary) order —
        and the limit re-applies after the merge."""
        sub = dataclasses.replace(q, limit=None)
        tagged, meta = self._scatter(q, sub, st, t0)
        t_m = _time.perf_counter()
        value_shape = q.value_output is not None
        vcol = q.value_output if value_shape else "value"
        ccol = q.count_output if value_shape else "count"
        columns = [vcol, ccol] if value_shape \
            else ["dimension", vcol, ccol]
        counts: Dict[tuple, int] = {}
        for _, d in tagged:
            if not d:
                continue
            n = len(d[ccol])
            for i in range(n):
                key = (d[vcol][i],) if value_shape \
                    else (d["dimension"][i], d[vcol][i])
                counts[key] = counts.get(key, 0) + int(d[ccol][i])
        dim_pos = {name: i for i, name in enumerate(q.dimensions)}
        keys = sorted(counts,
                      key=(lambda k: k[0]) if value_shape
                      else (lambda k: (dim_pos.get(k[0], len(dim_pos)),
                                       k[1])))
        if q.limit is not None:
            keys = keys[: q.limit]
        data = {ccol: np.array([counts[k] for k in keys],
                               dtype=np.int64),
                vcol: np.array([k[-1] for k in keys], dtype=object)}
        if not value_shape:
            data["dimension"] = np.array([k[0] for k in keys],
                                         dtype=object)
        r = QueryResult(columns, data)
        return self._finish(
            q, r, meta, (_time.perf_counter() - t_m) * 1000, t0)

    def _local(self, reason: str) -> None:
        self.counters["local_fallbacks"] += 1
        self.engine.last_stats["cluster"] = {"mode": "local",
                                             "reason": reason[:200]}
        return None

    def _run_shard(self, st: _EpochState, body: bytes, shard_ds: str,
                   owners: Tuple[int, ...], deadline: Optional[float],
                   partial: bool = False):
        """One shard's replica chain against one captured epoch state.
        Returns (data dict, serving node, encoded frame bytes). Raises
        _LocalFallback for conditions remote retries cannot fix,
        ShardUnavailable when every replica stayed unreachable (caught
        per shard in partial mode; otherwise strict-mode contract, with
        whole-query local fallback when that is enabled)."""
        payload = WIRE.patch_subquery(body, shard_ds,
                                      epoch=st.record.epoch)
        delay = None
        attempt = 0
        last = "no attempt"
        for _pass in range(self.tries):
            # up-and-closed nodes first; downed / breaker-open replicas
            # are still tried last (the prober may lag a recovery, and a
            # cooled-down breaker admits a half-open probe)
            chain = sorted(owners, key=lambda n: (self._is_down(st, n),
                                                  st.breakers.is_open(n)))
            hedge_after = self._hedge_after_s() if _pass == 0 else None
            for pos, nid in enumerate(chain):
                if deadline is not None and _time.time() >= deadline:
                    raise _LocalFallback("deadline during scatter")
                self.counters["subqueries"] += 1
                if _pass or pos:
                    self.counters["retries"] += 1
                backup = chain[1] if (hedge_after is not None and pos == 0
                                      and len(chain) > 1) else None
                try:
                    status, resp, served = self._attempt(
                        st, nid, payload, deadline, backup, hedge_after)
                except _BreakerOpen as e:
                    last = f"node {e.node_id}: breaker open"
                    continue
                except OSError as e:
                    self.counters["failovers"] += 1
                    last = f"node {nid}: {type(e).__name__}"
                    continue
                if status == 200:
                    try:
                        _, data, _stats = WIRE.decode_result(resp)
                    except ValueError as e:
                        # corrupt / truncated frame: the bytes are bad,
                        # not the query — retryable on a replica
                        self.counters["wire_corrupt"] += 1
                        last = f"node {served}: {e}"
                        continue
                    return data, served, len(resp)
                info = WIRE.decode_error(resp)
                kind = info.get("error", "")
                if kind in ("EngineFallback", "Unsupported", "BadQuery"):
                    # the node cannot answer this query shape; neither
                    # will any replica — run the whole query locally
                    raise _LocalFallback(f"node {served}: {kind}: "
                                         f"{info.get('message', '')[:120]}")
                # AdmissionRejected (node shedding), unknown shard
                # (stale rejoin), Draining (mid-handover fence), or a
                # node-side crash: retryable on a replica / next pass
                last = f"node {served}: http {status} {kind}"
                if status == 404:
                    self._mark_down(st, served)
            delay = backoff(self.backoff_start, self.backoff_cap,
                            attempt, prev=delay)
            attempt += 1
            if self._stop.wait(delay):
                break
        if partial:
            # degraded mode supersedes whole-query local fallback: the
            # caller answers from the surviving shards
            raise ShardUnavailable(
                f"shard {shard_ds} unreachable on nodes {list(owners)} "
                f"after {self.tries} passes ({last})")
        if self.local_fallback:
            raise _LocalFallback(f"replicas exhausted for {shard_ds} "
                                 f"({last})")
        raise ShardUnavailable(
            f"shard {shard_ds} unreachable on nodes {list(owners)} "
            f"after {self.tries} passes ({last})")

    # -- one attempt: breakers + optional hedge --------------------------------
    def _hedge_after_s(self) -> Optional[float]:
        """Hedge delay in seconds, or None when hedging shouldn't run
        (disabled, or the auto quantile has too few samples)."""
        if not self.hedge_enabled:
            return None
        if self.hedge_after_ms > 0:
            return self.hedge_after_ms / 1000.0
        with self._lock:
            lat = sorted(self._latencies)
        if len(lat) < 32:
            return None
        q = lat[min(len(lat) - 1, int(len(lat) * self.hedge_quantile))]
        return max(q, self.hedge_min_ms / 1000.0)

    def _attempt(self, st: _EpochState, nid: int, payload: bytes,
                 deadline: Optional[float],
                 backup: Optional[int], hedge_after: Optional[float]):
        """One subquery attempt against ``nid``, optionally racing a
        hedge to ``backup`` after ``hedge_after`` seconds. Returns
        (status, body, serving node)."""
        if backup is None or hedge_after is None:
            status, resp = self._guarded_rpc(st, nid, payload, deadline)
            return status, resp, nid
        race = _HedgeRace(total=2)
        try:
            for leg_nid, leg_delay in ((nid, 0.0), (backup, hedge_after)):
                threading.Thread(
                    target=self._race_leg,
                    args=(race, st, leg_nid, payload, deadline, leg_delay),
                    name="sdot-hedge", daemon=True).start()
            race.done.wait(self.rpc_timeout + hedge_after + 5.0)
            win, errors = race.result()
        finally:
            race.close()
        if win is not None:
            status, resp, served = win
            if served != nid:
                with self._lock:
                    self.counters["hedges_won"] += 1
            return status, resp, served
        for err_nid, err in errors:     # prefer the primary's error
            if err_nid == nid:
                raise err
        if errors:
            raise errors[0][1]
        raise OSError(f"hedge race against nodes {nid}/{backup} timed out")

    def _race_leg(self, race: _HedgeRace, st: _EpochState, nid: int,
                  payload: bytes, deadline: Optional[float],
                  delay_s: float) -> None:
        out, err = None, None
        try:
            if delay_s > 0:
                if race.done.wait(delay_s) or race.cancelled:
                    return          # primary answered inside the delay
                with self._lock:
                    self.counters["hedges_launched"] += 1
            try:
                status, resp = self._guarded_rpc(st, nid, payload, deadline)
                out = (status, resp, nid)
            except (_BreakerOpen, OSError) as e:
                err = e
        finally:
            race.settle(nid, out, err)

    def _guarded_rpc(self, st: _EpochState, node_id: int, payload: bytes,
                     deadline: Optional[float],
                     path: str = "/cluster/subquery") -> Tuple[int, bytes]:
        """_rpc wrapped in the node's circuit breaker + health marks."""
        tok = st.breakers.before_attempt(node_id)
        ok = False
        try:
            if tok is None:
                raise _BreakerOpen(node_id)
            try:
                status, resp = self._rpc(st, node_id, payload, deadline,
                                         path=path)
            except OSError:
                self._mark_down(st, node_id)
                raise
            ok = status < 500       # any coherent reply = node is alive
        finally:
            if tok is not None:
                st.breakers.settle(tok, ok)
        self._mark_up(st, node_id)
        return status, resp

    def _rpc(self, st: _EpochState, node_id: int, payload: bytes,
             deadline: Optional[float],
             path: str = "/cluster/subquery") -> Tuple[int, bytes]:
        inj = self.fault
        key = f"node:{node_id}"
        if inj is not None:
            inj.fire("rpc.connect", key)
        host, port = st.nodes[node_id]
        timeout = self.rpc_timeout
        if deadline is not None:
            timeout = max(0.05, min(timeout, deadline - _time.time()))
        t0 = _time.perf_counter()
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            if inj is not None:
                inj.fire("rpc.request", key)
            ctype = "application/json" if path == "/cluster/subquery" \
                else "application/octet-stream"
            conn.request("POST", path, payload, {"Content-Type": ctype})
            resp = conn.getresponse()
            body = resp.read()
        finally:
            conn.close()
        with self._lock:
            self._latencies.append(_time.perf_counter() - t0)
        if inj is not None:
            body = inj.mutate("rpc.response", body, key)
        return resp.status, body

    # -- introspection ---------------------------------------------------------
    def stats(self) -> dict:
        st = self._active
        pend = self._pending
        with self._lock:
            down = {nid: round(_time.time() - t, 1)
                    for nid, t in st.down.items()}
            counters = dict(self.counters)
            rebalance = dict(self.last_rebalance) \
                if self.last_rebalance else None
        out = {
            "enabled": True,
            "nodes": [{"id": i, "host": h, "port": p,
                       "key": st.record.ids[i],
                       "state": "down" if i in down else "up",
                       "down_seconds": down.get(i)}
                      for i, (h, p) in enumerate(st.nodes)],
            "replication": st.plan.replication,
            "breakers": st.breakers.snapshot(),
            "datasources": {
                name: {"shards": dp.n_shards,
                       "segments": dp.num_segments,
                       "rows": dp.num_rows,
                       "ingest_version": dp.ingest_version,
                       "owners": {str(sh.index): list(sh.owners)
                                  for sh in dp.shards}}
                for name, dp in st.plan.datasources.items()},
            "counters": counters,
            "epoch": {"active": st.record.epoch,
                      "pending": pend.record.epoch
                      if pend is not None else None,
                      "strategy": self.strategy},
            "rebalance": rebalance,
            "subq_cache": self.subq_cache.stats(),
            "ingest": self._ingest_stats(),
        }
        if self.autoscale is not None:
            out["autoscale"] = self.autoscale.stats()
        return out

    def _ingest_stats(self) -> dict:
        with self._ingest_lock:
            return {
                "push_enabled": self.ingest_push_enabled,
                "datasources": {
                    name: {"version": state["version"],
                           "inflight": state["inflight"],
                           "shards": {str(i): sorted(s) for i, s in
                                      state["shards"].items()}}
                    for name, state in self._ingested.items()}}


def _strip(q):
    """(subquery, posts, having, limit, key_cols, aggs) — the subquery
    keeps scan phases (filter, granularity, intervals, aggregations);
    everything that must see ALL groups (post-aggs, HAVING, ORDER
    BY/LIMIT, TopN threshold) runs broker-side after the merge."""
    gran = getattr(q, "granularity", None)
    gran_kind = gran.kind if gran is not None else "all"
    if isinstance(q, S.TopNQuerySpec):
        sub = S.GroupByQuerySpec(
            datasource=q.datasource, dimensions=(q.dimension,),
            aggregations=q.aggregations, post_aggregations=(),
            filter=q.filter, having=None, limit=None,
            granularity=q.granularity, intervals=q.intervals,
            context=q.context)
        posts = q.post_aggregations
        having = None
        limit = S.topn_limit(q)
        dims = (q.dimension,)
    elif isinstance(q, S.GroupByQuerySpec):
        sub = dataclasses.replace(q, post_aggregations=(), having=None,
                                  limit=None)
        posts, having, limit = q.post_aggregations, q.having, q.limit
        dims = q.dimensions
    else:
        sub = dataclasses.replace(q, post_aggregations=())
        posts, having, limit = q.post_aggregations, None, None
        dims = ()
    key_cols = (["timestamp"] if gran_kind != "all" else []) \
        + [d.output_name for d in dims]
    aggs = [(a.name, a.kind) for a in q.aggregations]
    return sub, posts, having, limit, key_cols, aggs
