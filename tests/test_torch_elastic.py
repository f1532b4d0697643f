"""The port's elastic cluster topology (``cluster/epoch.py``) against the
JAX package's.

The cases of ``tests/test_elastic.py`` run over port historicals and a
port broker on the CPU: epoch publishing (a crash between the record and
the CURRENT flip leaves an inert orphan; the publish lock; stable
logical ids), stability-aware assignment (``plan_diff`` moves, the gate
``plan_fully_warm``), the join protocol (warm before advertise; the
broker scatters the old epoch until every new-plan shard is advertised),
the leave protocol (drain then fence; the ``node.drain`` fault fences at
once), differentials across scale-out and scale-in, breaker state reset
on rejoin and on an epoch swap, and the broker's shard-level subquery
cache across an epoch swap. Each broker answer is held against a single
port context over the same root (ints, dims and sketch registers exact,
floats rtol 1e-9 / atol 1e-9, the JAX test's tolerance). The epoch
records are the JAX package's: each package reads the other's, and both
compute the same plans and diffs. The autoscale hook (no JAX test) gives
the JAX hook's decisions on the same samples.

Every handover is stepped by hand (the watcher and the prober are off),
so each leg is a sequence of ``check_epoch()`` calls, not a sleep race.
Spare addresses are picked when the ring is made; a node that starts on
one later retries its bind until a deadline (``restart_on_same_port``).
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import json
import os
import shutil
import threading

import pytest

from spark_druid_olap_tpu.cluster import assign as JA
from spark_druid_olap_tpu.cluster import epoch as JEP

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.cluster import epoch as EP
from spark_druid_olap_tpu_torch.cluster.assign import (
    plan_cluster, plan_diff, plan_fully_warm)
from spark_druid_olap_tpu_torch.cluster.breaker import BreakerBoard
from spark_druid_olap_tpu_torch.fault import (
    FaultInjected, FaultInjector, FaultPlan)
from spark_druid_olap_tpu_torch.tools import ssb, tpch

from conftest import assert_frames_equal, make_sales_df
from test_torch_cluster import (free_port, http_get, restart_on_same_port,
                                wait_until)


def _fault_plan(*rules) -> str:
    return json.dumps({"seed": 7, "rules": list(rules)})


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """Deep storage seeded once per module; topology tests copy it so
    their epoch records never leak into each other."""
    root = str(tmp_path_factory.mktemp("elastic-golden"))
    seed = tsdot.Context({"sdot.persist.path": root}, device="cpu")
    seed.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                          target_rows=2048)
    seed.ingest_dataframe("tpch_flat", tpch.flatten(tpch.generate(sf=0.002)),
                          time_column="l_shipdate", target_rows=2048)
    seed.ingest_dataframe("ssb_flat", ssb.flatten(ssb.generate(sf=0.003)),
                          time_column="lo_orderdate", target_rows=2048)
    seed.checkpoint()
    seed.close()
    return root


@pytest.fixture
def root(golden, tmp_path):
    dst = str(tmp_path / "deep")
    shutil.copytree(golden, dst)
    return dst


class Ring:
    """A manually-stepped elastic cluster of port members: ``spare``
    extra addresses are picked for nodes that join later."""

    def __init__(self, root, n=2, spare=2, replication=2, shards=4,
                 extra=None):
        self.root = root
        self.addrs = [f"127.0.0.1:{free_port()}" for _ in range(n + spare)]
        self.common = {
            "sdot.persist.path": root,
            "sdot.cluster.nodes": ",".join(self.addrs[:n]),
            "sdot.cluster.replication": replication,
            # FIXED shard count: shard identity must not depend on the
            # node count, or every topology change is a full recut
            "sdot.cluster.shards": shards,
            "sdot.cluster.epoch.poll.seconds": 0,       # step by hand
            "sdot.cluster.probe.interval.seconds": 0,   # step by hand
            "sdot.cluster.retry.backoff.start.seconds": 0.01,
            "sdot.cluster.epoch.drain.grace.seconds": 0.0,
            "sdot.cluster.epoch.drain.timeout.seconds": 5.0,
            # the broker result cache would absorb the repeat queries
            # these tests use to exercise scatter + the subquery cache
            "sdot.cache.enabled": False,
            **(extra or {})}
        self.hist = {}
        self.broker = self.single = None
        try:
            for a in self.addrs[:n]:
                self.start(a)
            self.broker = tsdot.Context(
                {**self.common, "sdot.cluster.role": "broker"},
                device="cpu")
            self.single = tsdot.Context({"sdot.persist.path": root},
                                        device="cpu")
        except BaseException:
            self.close()
            raise

    def start(self, addr, nodes_csv=None, extra=None):
        """Boot a historical. A joiner passes the published epoch's node
        list so its config contains its own address."""
        csv = nodes_csv or self.common["sdot.cluster.nodes"]
        ov = {**self.common, "sdot.cluster.nodes": csv, **(extra or {})}
        h = restart_on_same_port("port", ov, csv.split(",").index(addr))
        self.hist[addr] = h
        return h

    def publish(self, addrs, note="", fault=None):
        return EP.publish_epoch(self.root, addrs, note=note, fault=fault)

    def step_all(self):
        """One check_epoch() step on every node — members first so a
        leaver's drain gate sees their new-epoch adverts."""
        rec = EP.read_epoch(self.root)
        members = [a for a in self.hist
                   if rec is not None and a in rec.nodes]
        leavers = [a for a in self.hist if a not in members]
        return {a: self.hist[a].check_epoch() for a in members + leavers}

    def swap_broker(self, max_steps=10):
        for _ in range(max_steps):
            if self.broker.cluster.check_epoch():
                return True
        return False

    def diff(self, query, rtol=1e-9):
        got = self.broker.sql(query).to_pandas()
        want = self.single.sql(query).to_pandas()
        if not got.equals(want):
            assert_frames_equal(got, want, rtol=rtol, atol=1e-9)
        return got

    def close(self):
        for h in self.hist.values():
            h.stop()
        for c in (self.broker, self.single):
            if c is not None:
                c.close()


@pytest.fixture
def ring(root):
    r = Ring(root)
    yield r
    r.close()


QUERIES = [
    "select region, sum(qty) as q, count(*) as c, sum(price) as rev "
    "from sales group by region order by region",
    "select region, approx_count_distinct(product) as dp "
    "from sales group by region order by region",
    "select l_returnflag, l_linestatus, count(*) as c, "
    "sum(l_extendedprice) as s from tpch_flat "
    "group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus",
    "select sum(lo_extendedprice) as s, count(*) as c, "
    "approx_count_distinct(lo_custkey) as nc from ssb_flat",
]


# -- epoch records -------------------------------------------------------------

def test_publish_crash_between_record_and_current(root):
    rec1 = EP.publish_epoch(root, ("127.0.0.1:1001", "127.0.0.1:1002"))
    assert rec1.epoch == 1
    assert EP.read_epoch(root).epoch == 1

    inj = FaultInjector(FaultPlan.parse(_fault_plan(
        {"site": "epoch.publish", "action": "error"})))
    with pytest.raises(FaultInjected):
        EP.publish_epoch(root, ("127.0.0.1:1001", "127.0.0.1:1002",
                                "127.0.0.1:1003"), fault=inj)
    # the orphan record landed but CURRENT never flipped: readers stay
    # on the old epoch
    eroot = EP.epoch_root(root)
    assert os.path.exists(os.path.join(eroot, "epoch-%010d.json" % 2))
    cur = EP.read_epoch(root)
    assert cur.epoch == 1 and cur.nodes == rec1.nodes

    # the crashed publisher released its lock; a re-publish allocates
    # PAST the orphan — epoch numbers are never reused
    rec3 = EP.publish_epoch(root, ("127.0.0.1:1001", "127.0.0.1:1002",
                                   "127.0.0.1:1003"))
    assert rec3.epoch == 3
    assert EP.read_epoch(root).epoch == 3
    # the JAX package reads the port's records as the port does, and the
    # reverse
    assert JEP.read_epoch(root).to_dict() == rec3.to_dict()
    rec4 = JEP.publish_epoch(root, ("127.0.0.1:1001",))
    assert EP.read_epoch(root).to_dict() == rec4.to_dict()
    assert rec4.epoch == 4


def test_publish_lock_excludes_concurrent_publishers(root):
    tok = EP.claim_publish(root)
    try:
        with pytest.raises(EP.EpochBusy):
            EP.publish_epoch(root, ("127.0.0.1:1001",))
        # the lock file is the JAX package's too
        with pytest.raises(JEP.EpochBusy):
            JEP.publish_epoch(root, ("127.0.0.1:1001",))
    finally:
        EP.release_publish(tok)
    assert EP.publish_epoch(root, ("127.0.0.1:1001",)).epoch == 1


def test_logical_ids_stable_across_membership_changes():
    b = EP.bootstrap_record(("a:1", "b:2"))
    assert b.ids == ("n0", "n1") and b.epoch == 0
    r1 = EP.next_record(b, ("a:1", "b:2", "c:3"), 1)
    assert r1.ids == ("n0", "n1", "n2")
    assert r1.generations == {"n0": 0, "n1": 0, "n2": 1}
    # b leaves: surviving ids keep their id AND generation
    r2 = EP.next_record(r1, ("a:1", "c:3"), 2)
    assert r2.ids == ("n0", "n2")
    # b rejoins: lowest free id again, but a NEW generation — the
    # broker uses exactly this to drop the predecessor's breaker state
    r3 = EP.next_record(r2, ("a:1", "c:3", "b:2"), 3)
    assert r3.ids == ("n0", "n2", "n1")
    assert r3.generations["n1"] == 3
    with pytest.raises(ValueError):
        EP.next_record(r3, ("a:1", "a:1"), 4)


# -- stability-aware assignment ------------------------------------------------

def test_plan_diff_minimal_movement_vs_naive(golden):
    for r in (1, 2):
        old_s = plan_cluster(golden, 2, r, n_shards=4)
        new_s = plan_cluster(golden, 3, r, n_shards=4)
        d_s = plan_diff(old_s, new_s)
        old_m = plan_cluster(golden, 2, r, n_shards=4, strategy="modular")
        new_m = plan_cluster(golden, 3, r, n_shards=4, strategy="modular")
        d_m = plan_diff(old_m, new_m)
        # accounting invariants
        assert d_s.moved + d_s.unchanged == d_s.total == d_m.total
        # the tentpole bound: stable placement moves a small fraction,
        # the modular rotation reshuffles most owners
        assert d_s.moved < d_m.moved
        assert d_s.moved <= d_s.total // 2
        # the JAX package moves exactly the same pairs
        jd = JA.plan_diff(JA.plan_cluster(golden, 2, r, n_shards=4),
                          JA.plan_cluster(golden, 3, r, n_shards=4))
        assert (d_s.added, d_s.removed, d_s.total) \
            == (jd.added, jd.removed, jd.total)
    # shrink: removal moves little beyond the removed node's pairs
    big = plan_cluster(golden, 3, 2, n_shards=4)
    small = plan_cluster(golden, 2, 2, n_shards=4)
    d = plan_diff(big, small)
    assert 0 < d.moved <= d.total // 2


def test_plan_fully_warm_gate(golden):
    plan = plan_cluster(golden, 2, 1, n_shards=4)
    full = {nid: set() for nid in range(2)}
    for name, dp in plan.datasources.items():
        for sh in dp.shards:
            full[sh.owners[0]].add(f"{name}::shard{sh.index}of{dp.n_shards}")
    assert plan_fully_warm(plan, full)
    # any missing shard closes the gate
    partial = {nid: set(v) for nid, v in full.items()}
    partial[0].pop()
    assert not plan_fully_warm(plan, partial)
    assert not plan_fully_warm(plan, {})


# -- join / leave protocol -----------------------------------------------------

def test_broker_scatters_old_epoch_until_new_fully_ready(root):
    ring = Ring(root, n=2, replication=1)
    try:
        rec = ring.publish(ring.addrs[:3], note="scale-out")
        # existing members adopt the new epoch...
        assert set(ring.step_all().values()) == {"warmed"}
        # ...but the joiner isn't up: its shards are unadvertised, the
        # swap gate stays closed, and the broker serves the OLD epoch
        assert ring.broker.cluster.check_epoch() is False
        st = ring.broker.cluster.stats()
        assert st["epoch"]["active"] == 0
        assert st["epoch"]["pending"] == rec.epoch
        for q in QUERIES[:2]:
            ring.diff(q)
        assert ring.broker.engine.last_stats["cluster"]["epoch"] == 0

        # the joiner boots, warms from the cold tier, advertises; the
        # gate opens and the broker swaps
        h2 = ring.start(ring.addrs[2], nodes_csv=",".join(rec.nodes))
        assert h2.shards_loaded > 0
        assert h2.ready_info()["epochs"][rec.epoch]["shards"]
        assert ring.swap_broker()
        st = ring.broker.cluster.stats()
        assert st["epoch"]["active"] == rec.epoch
        assert st["epoch"]["pending"] is None
        assert st["rebalance"]["to_epoch"] == rec.epoch
        assert st["rebalance"]["moved"] >= 1
        for q in QUERIES[:2]:
            ring.diff(q)
        assert ring.broker.engine.last_stats["cluster"]["epoch"] == rec.epoch
    finally:
        ring.close()


def test_join_advertises_only_after_warming(root):
    ring = Ring(root, n=2, replication=1)
    try:
        rec = ring.publish(ring.addrs[:3])
        ring.step_all()
        h2 = ring.start(ring.addrs[2], nodes_csv=",".join(rec.nodes))
        # the advert exists only because boot() warmed first: every
        # advertised shard store is actually resident
        advert = h2.ready_info()["epochs"][rec.epoch]
        assert advert["ready"] and advert["shards"]
        resident = set(h2.ctx.store.names())
        assert set(advert["shards"]) <= resident
        # and the extended /readyz carries the same advert over HTTP
        port = int(ring.addrs[2].rsplit(":", 1)[1])
        status, body = http_get(port, "/readyz")
        info = json.loads(body)
        assert status == 200 and info["ready"]
        assert info["epochs"][str(rec.epoch)]["shards"] == advert["shards"]
        assert info["boot"] == h2.boot_id
    finally:
        ring.close()


def test_leave_drains_inflight_then_fences(root):
    ring = Ring(root, n=3, spare=0, replication=2)
    try:
        leaver = ring.hist[ring.addrs[2]]
        ring.publish(ring.addrs[:2], note="scale-in")
        # a subquery is in flight on the leaver when the epoch drops it
        tok = leaver.drain.begin_subquery()
        assert tok is not None
        t = threading.Thread(target=leaver.check_epoch)
        t.start()
        # survivors adopt; the leaver's drain gate (same pure function
        # as the broker's swap gate) opens
        ring.hist[ring.addrs[0]].check_epoch()
        ring.hist[ring.addrs[1]].check_epoch()
        assert wait_until(lambda: leaver.drain.draining, 5.0)
        # draining, not fenced: the in-flight token pins it up, and new
        # subqueries are refused with a retryable 503
        assert not leaver.fenced and leaver.ready
        status, payload, _ = leaver.handle_subquery(b"{}")
        assert status == 503
        assert json.loads(payload)["error"] == "Draining"
        # the in-flight subquery finishes -> fence
        leaver.drain.end_subquery(tok)
        t.join(timeout=5.0)
        assert not t.is_alive()
        assert leaver.fenced and not leaver.ready
        assert leaver.ready_info()["epochs"] == {}
        # the broker swaps to the shrunken epoch and answers still match
        assert ring.swap_broker()
        for q in QUERIES[:2]:
            ring.diff(q)
    finally:
        ring.close()


def test_leave_drain_fault_hard_fences(root):
    """The ``node.drain`` chaos site: an error rule models the node
    dying mid-handover instead of draining gracefully — it must fence
    immediately (and the broker's replica chain absorbs the loss)."""
    ring = Ring(root, n=3, spare=0, replication=2)
    try:
        addr = ring.addrs[2]
        ring.hist[addr].stop()
        del ring.hist[addr]
        h2 = ring.start(addr, extra={"sdot.fault.plan": _fault_plan(
            {"site": "node.drain", "action": "error"})})
        ring.publish(ring.addrs[:2])
        ring.hist[ring.addrs[0]].check_epoch()
        ring.hist[ring.addrs[1]].check_epoch()
        assert h2.check_epoch() == "left"
        assert h2.fenced and not h2.ready
        assert ring.swap_broker()
        for q in QUERIES[:2]:
            ring.diff(q)
    finally:
        ring.close()


# -- differentials across rolling topology changes -----------------------------

def test_differentials_across_scale_out_and_in(root):
    """The acceptance leg: N -> N+2 -> N-1 with zero differential
    mismatches (sketch register merges included)."""
    ring = Ring(root, n=2, spare=2, replication=2)
    try:
        for q in QUERIES:
            ring.diff(q)

        # N -> N+2
        rec = ring.publish(ring.addrs[:4], note="scale-out")
        for a in ring.addrs[2:4]:
            ring.start(a, nodes_csv=",".join(rec.nodes))
        ring.step_all()
        assert ring.swap_broker()
        assert ring.broker.cluster.stats()["epoch"]["active"] == rec.epoch
        for q in QUERIES:
            ring.diff(q)

        # N+2 -> N-1: three nodes leave at once; the lone survivor
        # warms everything before the leavers fence
        rec2 = ring.publish(ring.addrs[:1], note="scale-in")
        res = ring.step_all()
        assert res[ring.addrs[0]] == "warmed"
        assert all(res[a] == "left" for a in ring.addrs[1:4])
        assert ring.swap_broker()
        st = ring.broker.cluster.stats()
        assert st["epoch"]["active"] == rec2.epoch
        assert ring.broker.cluster.counters["epoch_swaps"] == 2
        for q in QUERIES:
            ring.diff(q)
    finally:
        ring.close()


# -- breaker reset on rejoin ---------------------------------------------------

def test_breaker_reset_clears_open_circuit():
    b = BreakerBoard(2, failures=2, cooldown_s=60.0)
    for _ in range(2):
        tok = b.before_attempt(1)
        assert tok is not None
        b.settle(tok, False)
    assert b.before_attempt(1) is None        # open, cooling down
    b.reset(1)                                # new process generation
    tok = b.before_attempt(1)
    assert tok is not None                    # fresh closed breaker
    b.settle(tok, True)


def test_epoch_swap_discards_breaker_state(ring):
    cl = ring.broker.cluster
    st = cl._active
    for _ in range(10):
        tok = st.breakers.before_attempt(1)
        if tok is None:
            break
        st.breakers.settle(tok, False)
    assert st.breakers.before_attempt(1) is None   # wedged open
    # publish the SAME membership as a new epoch (a rolling bounce):
    # the swap installs a FRESH board — node 1's new process must not
    # inherit the predecessor's open circuit
    ring.publish(list(st.record.nodes))
    ring.step_all()
    assert ring.swap_broker()
    st2 = cl._active
    assert st2.breakers is not st.breakers
    tok = st2.breakers.before_attempt(1)
    assert tok is not None
    st2.breakers.settle(tok, True)


# -- broker-side subquery cache ------------------------------------------------

def test_subq_cache_hits_and_differential(root):
    ring = Ring(root, extra={"sdot.cluster.subq.cache.enabled": True})
    try:
        q = QUERIES[0]
        first = ring.diff(q)
        c = ring.broker.cluster.counters
        assert c["subq_cache_hits"] == 0 and c["subq_cache_misses"] > 0
        second = ring.diff(q)
        assert c["subq_cache_hits"] > 0
        assert second.equals(first)
        st = ring.broker.engine.last_stats["cluster"]
        assert st["subq_cache_hits"] > 0
        board = ring.broker.cluster.stats()["subq_cache"]
        assert board["hits"] > 0 and board["entries"] > 0

        # cache-on vs cache-off differential: a second broker with the
        # cache disabled answers identically
        plain = tsdot.Context({**ring.common, "sdot.cluster.role": "broker",
                               "sdot.cluster.subq.cache.enabled": False},
                              device="cpu")
        try:
            got = plain.sql(q).to_pandas()
            assert plain.cluster.counters["subq_cache_hits"] == 0
            if not got.equals(first):
                assert_frames_equal(got, first, rtol=1e-9, atol=1e-9)
        finally:
            plain.close()
    finally:
        ring.close()


def test_subq_cache_survives_epoch_swap(root):
    """Cache keys are (body, datasource, shard identity, ingest
    version) — NOT node identity — so a warmed cache keeps hitting
    after a topology change reassigns the shards."""
    ring = Ring(root, n=2, replication=2,
                extra={"sdot.cluster.subq.cache.enabled": True})
    try:
        q = QUERIES[0]
        want = ring.diff(q)
        ring.diff(q)
        c = ring.broker.cluster.counters
        warm_hits = c["subq_cache_hits"]
        assert warm_hits > 0

        rec = ring.publish(ring.addrs[:3])
        ring.start(ring.addrs[2], nodes_csv=",".join(rec.nodes))
        ring.step_all()
        assert ring.swap_broker()
        got = ring.broker.sql(q).to_pandas()
        if not got.equals(want):
            assert_frames_equal(got, want, rtol=1e-9, atol=1e-9)
        # same shard count, same ingest version -> same keys -> hits
        assert c["subq_cache_hits"] > warm_hits
    finally:
        ring.close()


# -- the autoscale hook --------------------------------------------------------

def test_autoscale_decisions_equal_jax():
    """The hook is a threshold / cooldown machine over fleet queue
    depths: the same samples on a fake clock give the JAX hook's
    decisions, counters and callback calls."""
    from spark_druid_olap_tpu.cluster.autoscale import AutoscaleHook as J
    from spark_druid_olap_tpu_torch.cluster.autoscale import AutoscaleHook
    samples = [([9, 10], False), ([9, 10], False), ([0, 0], False),
               ([20], True), ([0, 1], False), ([0], False),
               ([3, 3, 3], False), ([12, 0, 0], False), ([], False)]
    runs = []
    for cls in (AutoscaleHook, J):
        now, calls = [0.0], []
        hook = cls(8.0, 0.5, 30.0, spawn=lambda: calls.append("spawn"),
                   retire=lambda: calls.append("retire"),
                   clock=lambda: now[0])
        out = []
        for depths, handover in samples:
            out.append(hook.observe(depths, handover_in_progress=handover))
            now[0] += 20.0
        runs.append((out, calls, hook.stats()))
    assert runs[0] == runs[1]
    assert runs[0][0][:3] == ["out", None, "in"]
    with pytest.raises(ValueError):
        AutoscaleHook(1.0, 1.0, 0.0)
