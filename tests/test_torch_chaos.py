"""The port's fault injection (``fault/``) against the JAX package's.

The plan cases of ``tests/test_chaos.py`` (parsing, seeded determinism,
scopes, byte mutations), its WAL cases (torn appends never acked and
self-healing, a failed fsync rolled back, a torn tail repaired, a torn
batch never resurfacing through a context; written through
``append_group``, the port's only write path) and its WLM admission case
run through both packages on the same plans: the outcomes, the mutated bytes
and the injectors' stats are equal, and the journals both packages leave
are byte-identical. Its two cold-tier cases (a CRC flip injected at a
first fault quarantines the version and recovery falls back; a slowed
cold read still answers exactly) run in both packages, each over a root
written by a package. Its wire CRC and circuit-breaker cases run in both
packages (the frames byte for byte alike), and its cluster legs run over
two port historicals (replication 2, and 1 for the partial-results legs):
a corrupt frame, a refused connect, a slow replica, a node's 500s, an
open breaker and its half-open probe, a hedge, every replica down
(strict: ``ClusterError``; partial: a shape-exact degraded answer), a
degraded answer covering exactly the surviving shards and never cached;
every exact answer equal to a single port context's.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import json
import time

import pandas as pd
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu import fault as JF
from spark_druid_olap_tpu.persist.wal import WriteAheadLog as JWAL
from spark_druid_olap_tpu.wlm.lanes import AdmissionRejected as JRejected

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch import fault as TF
from spark_druid_olap_tpu_torch.persist import snapshot as TSNAP
from spark_druid_olap_tpu_torch.persist.wal import WriteAheadLog as TWAL
from spark_druid_olap_tpu_torch.wlm.lanes import (
    AdmissionRejected as TRejected)

from test_torch_sql import assert_answers_equal

F = {"jax": JF, "port": TF}
WAL = {"jax": JWAL, "port": TWAL}


def _plan(seed, *rules):
    return json.dumps({"seed": seed, "rules": list(rules)})


def _both(fn):
    """``fn(fault module)`` for both packages; the results must agree."""
    j, t = fn(JF), fn(TF)
    assert t == j
    return t


# -- (a) plan parsing + seeded determinism ------------------------------------

def test_plan_parse_validation():
    def parse(m):
        p = m.FaultPlan.parse(_plan(
            3, {"site": "rpc.connect", "match": "node:1", "action": "delay",
                "arg": 0.5, "p": 0.25, "count": 2, "after": 1,
                "scope": "leg"}))
        r = p.rules[0]
        d = m.FaultPlan.parse(_plan(0, {"site": "s"})).rules[0]
        return (p.seed, len(p.rules),
                (r.site, r.match, r.action, r.arg, r.p, r.count, r.after,
                 r.scope),
                (d.action, d.arg, d.p, d.count, d.after, d.scope))
    got = _both(parse)
    assert got == (3, 1, ("rpc.connect", "node:1", "delay", 0.5, 0.25, 2, 1,
                          "leg"), ("error", None, 1.0, None, 0, None))
    for bad in (_plan(0, {"site": "s", "action": "explode"}),
                _plan(0, {"site": "s", "frequency": 2}),
                _plan(0, {"action": "error"}),
                _plan(0, {"site": "s", "p": 1.5}),
                "[1, 2]"):
        with pytest.raises(ValueError):
            TF.FaultPlan.parse(bad)


def test_count_match_and_after_are_exact():
    def run(m):
        inj = m.FaultInjector(m.FaultPlan.parse(_plan(
            1, {"site": "rpc.connect", "match": "node:0", "action": "error",
                "arg": "ConnectionRefusedError", "count": 2, "after": 1})))
        outcomes = []
        for _ in range(5):
            try:
                inj.fire("rpc.connect", key="node:0")
                outcomes.append("ok")
            except ConnectionRefusedError:
                outcomes.append("boom")
        inj.fire("rpc.connect", key="node:1")
        inj.fire("rpc.request", key="node:0")
        return outcomes, inj.stats()
    outcomes, st = _both(run)
    assert outcomes == ["ok", "boom", "boom", "ok", "ok"]
    assert st["fired"] == 2 and st["by_site"] == {"rpc.connect": 2}


def test_scope_gating_is_refcounted():
    def run(m):
        inj = m.FaultInjector(m.FaultPlan.parse(_plan(
            2, {"site": "wlm.admit", "action": "error", "scope": "leg"})))
        inj.fire("wlm.admit")
        t1 = inj.begin_scope("leg")
        t2 = inj.begin_scope("leg")
        inj.end_scope(t2)
        with pytest.raises(m.FaultInjected):
            inj.fire("wlm.admit")
        inj.end_scope(t1)
        inj.fire("wlm.admit")
        with inj.scope("leg"):
            with pytest.raises(m.FaultInjected):
                inj.fire("wlm.admit")
        inj.fire("wlm.admit")
        return inj.stats()
    assert _both(run)["fired"] == 2


def test_mutations_replay_byte_identical_from_seed():
    def run(m, seed):
        inj = m.FaultInjector(m.FaultPlan.parse(_plan(
            seed,
            {"site": "wire", "action": "flip", "count": 3},
            {"site": "wal", "action": "truncate", "arg": 7, "count": 1})))
        out = [inj.mutate("wire", bytes(range(64))) for _ in range(3)]
        out.append(inj.mutate("wal", bytes(64)))
        return out
    a = _both(lambda m: run(m, 7))
    assert a == run(TF, 7)
    assert run(TF, 8) != a
    assert all(len(x) == 64 for x in a[:3])
    assert len(a[3]) == 57
    inj = TF.FaultInjector(TF.FaultPlan.parse(_plan(7, {"site": "x"})))
    data = b"payload"
    assert inj.mutate("wire", data) is data


def test_probability_rule_is_seed_reproducible():
    def pattern(m, seed):
        inj = m.FaultInjector(m.FaultPlan.parse(_plan(
            seed, {"site": "s", "action": "error", "p": 0.5})))
        out = []
        for _ in range(32):
            try:
                inj.fire("s")
                out.append(False)
            except m.FaultInjected:
                out.append(True)
        return out
    p = _both(lambda m: pattern(m, 11))
    assert p == pattern(TF, 11)
    assert 0 < sum(p) < 32


def test_unknown_exception_arg_rejected():
    inj = TF.FaultInjector(TF.FaultPlan.parse(_plan(
        0, {"site": "s", "action": "error", "arg": "SystemExit"})))
    with pytest.raises(ValueError):
        inj.fire("s")


def test_lane_full_error_is_the_ports():
    from spark_druid_olap_tpu_torch.wlm.admit import LaneFullError
    inj = TF.FaultInjector(TF.FaultPlan.parse(_plan(
        0, {"site": "s", "action": "error", "arg": "LaneFullError"})))
    with pytest.raises(LaneFullError):
        inj.fire("s")


def test_from_config_is_none_when_unset():
    from spark_druid_olap_tpu_torch.utils.config import Config
    assert TF.FaultInjector.from_config(Config({})) is None
    inj = TF.FaultInjector.from_config(Config(
        {"sdot.fault.plan": _plan(5, {"site": "s"})}))
    assert inj is not None and inj.plan.seed == 5
    assert tsdot.Context(device="cpu").engine.fault is None


# -- (d) WAL: torn appends are never acked and self-heal ----------------------

def _wal_pair(tmp_path, plan=None):
    out = {}
    for k in ("jax", "port"):
        inj = None if plan is None else \
            F[k].FaultInjector(F[k].FaultPlan.parse(plan))
        out[k] = WAL[k](str(tmp_path / f"{k}.log"), fault=inj)
    return out


def test_wal_torn_append_self_heals(tmp_path):
    wals = _wal_pair(tmp_path, _plan(
        4, {"site": "wal.append", "action": "truncate", "arg": 5,
            "after": 1, "count": 1}))
    for wal in wals.values():
        wal.append_group({"seq": 1}, b"one")
        size1 = wal.size_bytes()
        with pytest.raises(OSError):
            wal.append_group({"seq": 2}, b"two")
        assert wal.size_bytes() == size1
        wal.append_group({"seq": 3}, b"three")
        assert [(h["seq"], b) for h, b in wal.records()] \
            == [(1, b"one"), (3, b"three")]
        wal.close()
    assert open(wals["jax"].path, "rb").read() \
        == open(wals["port"].path, "rb").read()


def test_wal_fsync_fault_rolls_back(tmp_path):
    wals = _wal_pair(tmp_path, _plan(
        4, {"site": "wal.fsync", "action": "error", "arg": "OSError",
            "count": 1}))
    for wal in wals.values():
        with pytest.raises(OSError):
            wal.append_group({"seq": 1}, b"one")
        assert wal.size_bytes() == 0
        wal.append_group({"seq": 2}, b"two")
        assert [h["seq"] for h, _ in wal.records()] == [2]
        wal.close()


def test_wal_repair_trims_garbage_tail(tmp_path):
    for k, wal in _wal_pair(tmp_path).items():
        wal.append_group({"seq": 1}, b"one")
        wal.close()
        with open(wal.path, "ab") as f:
            f.write(b"SDWLgarbage-torn-frame")
        wal2 = WAL[k](wal.path)
        assert wal2.repair() > 0
        assert wal2.repair() == 0
        wal2.append_group({"seq": 2}, b"two")
        assert [h["seq"] for h, _ in wal2.records()] == [1, 2]
        wal2.close()


def test_ctx_torn_wal_durability(tmp_path):
    """Acked batches survive; a fault-torn batch is never acked and never
    resurfaces at recovery, in both packages alike."""
    plan = _plan(9, {"site": "wal.append", "action": "truncate", "arg": 9,
                     "scope": "torn"})

    def frame(lo, hi):
        return pd.DataFrame({"t": pd.to_datetime("2024-01-01"),
                             "k": ["a"] * (hi - lo),
                             "v": list(range(lo, hi))})

    def ctx(pkg, **cfg):
        cfg = {"sdot.persist.enabled": True,
               "sdot.persist.path": str(tmp_path / pkg), **cfg}
        return jsdot.Context(cfg) if pkg == "jax" \
            else tsdot.Context(cfg, device="cpu")

    got = {}
    for pkg in ("jax", "port"):
        c = ctx(pkg, **{"sdot.fault.plan": plan})
        inj = c.engine.fault
        c.stream_ingest("s", frame(0, 10), time_column="t")
        with inj.scope("torn"):
            with pytest.raises(OSError):
                c.stream_ingest("s", frame(10, 20), time_column="t")
        c.stream_ingest("s", frame(20, 30), time_column="t")
        n = c.sql("SELECT COUNT(*) AS n FROM s").data["n"][0]
        assert int(n) == 20
        assert c.engine.last_stats["fault"]["by_site"] == {"wal.append": 1}
        c.close()
        c2 = ctx(pkg)
        got[pkg] = sorted(int(v) for v in
                          c2.sql("SELECT v FROM s").data["v"].tolist())
        c2.close()
    assert got["port"] == got["jax"] \
        == list(range(0, 10)) + list(range(20, 30))


# -- (e) cold tier: CRC flip at first fault, slow cold read -------------------

_EQ = ("select country, sum(clicks) as c, count(*) as n from events "
       "group by country order by country")
_EINGEST = dict(time_column="ts", dimensions=["country"],
                metrics=["clicks"])


def _tier_ctx(pkg, root, plan):
    cfg = {"sdot.persist.path": str(root), "sdot.tier.enabled": True,
           "sdot.fault.plan": plan}
    return jsdot.Context(cfg) if pkg == "jax" \
        else tsdot.Context(cfg, device="cpu")


def _events_root(pkg, root, versions):
    """``versions`` checkpoints of the events store; the answer after the
    first and the current version."""
    from test_torch_persist import _events, open_ctx
    ctx = open_ctx(pkg, root)
    ctx.stream_ingest("events", _events(100), **_EINGEST)
    want = ctx.sql(_EQ).to_pandas()
    ctx.checkpoint("events")
    if versions > 1:
        ctx.stream_ingest("events", _events(10, seed=5), **_EINGEST)
        ctx.checkpoint("events")
    cur = TSNAP.current_version(ctx.persist._ds_root("events"))
    ctx.close()
    return want, cur


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_tier_crc_flip_quarantines_and_recovers(tmp_path, pkg):
    from spark_druid_olap_tpu.persist.snapshot import SnapshotCorrupt as JC
    corrupt = {"jax": JC, "port": TSNAP.SnapshotCorrupt}[pkg]
    # each package reads the root the other one wrote
    writer = "port" if pkg == "jax" else "jax"
    want, cur = _events_root(writer, tmp_path, 2)
    # no bytes touched on disk: the CRC flip is injected at verify time
    ctx2 = _tier_ctx(pkg, tmp_path, _plan(
        13, {"site": "tier.verify", "action": "flip", "count": 1}))
    assert not ctx2.persist.recovery_report["quarantined"]
    with pytest.raises(corrupt):
        ctx2.sql(_EQ)
    # the faulting query quarantined the flipped version and re-ran
    # recovery; the retry answers exactly from the older snapshot
    rep = ctx2.persist.recovery_report
    assert len(rep["quarantined"]) == 1
    assert rep["quarantined"][0]["version"] == cur
    assert_answers_equal(ctx2.sql(_EQ).to_pandas(), want, True)
    assert ctx2.persist.tier.counters["crc_failures"] == 1
    assert ctx2.persist.counters["quarantined"] == 1
    ctx2.close()


def test_tier_slow_cold_read_still_exact(tmp_path):
    got, stats = {}, {}
    for pkg in ("jax", "port"):
        want, _ = _events_root(pkg, tmp_path / pkg, 1)
        ctx2 = _tier_ctx(pkg, tmp_path / pkg, _plan(
            13, {"site": "tier.read", "action": "delay", "arg": 0.05,
                 "count": 2}))
        got[pkg] = ctx2.sql(_EQ).to_pandas()
        assert_answers_equal(got[pkg], want, True)
        stats[pkg] = ctx2.engine.last_stats["fault"]["by_site"]
        assert stats[pkg] == {"tier.read": 2}
        ctx2.close()
    assert_answers_equal(got["port"], got["jax"], True)


# -- (f) WLM admission: starvation + queue-full shed --------------------------

def test_wlm_admit_shed_and_starvation():
    plan = _plan(
        6,
        {"site": "wlm.admit", "action": "error", "arg": "LaneFullError",
         "scope": "shed"},
        {"site": "wlm.admit", "action": "delay", "arg": 0.15,
         "scope": "starve", "count": 1})
    q = "select k, sum(v) as s from t group by k order by k"
    for ctx, rejected in ((jsdot.Context({"sdot.fault.plan": plan}),
                           JRejected),
                          (tsdot.Context({"sdot.fault.plan": plan},
                                         device="cpu"), TRejected)):
        ctx.ingest_dataframe("t", pd.DataFrame({"k": ["a", "b"],
                                                "v": [1, 2]}))
        inj = ctx.engine.fault
        with inj.scope("shed"):
            with pytest.raises(rejected):
                ctx.sql(q)
        with inj.scope("starve"):
            t0 = time.perf_counter()
            got = ctx.sql(q).to_pandas()
            assert time.perf_counter() - t0 >= 0.14
        assert list(got["s"]) == [1, 2]
        st = ctx.engine.last_stats["fault"]
        assert st["by_site"] == {"wlm.admit": 2} and st["seed"] == 6
        ctx.close()


# -- the wire CRC, breakers and hedging (tests/test_chaos.py :167-:225,
# :539, :569) -----------------------------------------------------------------

def _wire(pkg):
    if pkg == "jax":
        from spark_druid_olap_tpu.cluster import wire
    else:
        from spark_druid_olap_tpu_torch.cluster import wire
    return wire


def _board(pkg):
    if pkg == "jax":
        from spark_druid_olap_tpu.cluster.breaker import BreakerBoard
    else:
        from spark_druid_olap_tpu_torch.cluster.breaker import BreakerBoard
    return BreakerBoard


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_wire_crc_rejects_corruption(pkg):
    import numpy as np
    WIRE = _wire(pkg)
    data = {"k": np.array(["a", "b"], dtype=object),
            "v": np.array([1, 2], dtype=np.int64)}
    payload = WIRE.encode_result(["k", "v"], data, {"node": 0})
    assert payload == _wire("jax").encode_result(["k", "v"], data,
                                                  {"node": 0})
    cols, out, stats = WIRE.decode_result(payload)
    assert cols == ["k", "v"] and stats == {"node": 0}
    # flip any single byte (header, body, or trailer): CRC must reject
    for j in (4, len(payload) // 2, len(payload) - 1):
        bad = payload[:j] + bytes([payload[j] ^ 0xFF]) + payload[j + 1:]
        with pytest.raises(ValueError):
            WIRE.decode_result(bad)
    # truncation (a torn frame) must reject too, at any cut point
    with pytest.raises(ValueError):
        WIRE.decode_result(payload[:-3])
    with pytest.raises(ValueError):
        WIRE.decode_result(payload[:8])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_breaker_state_machine(pkg):
    bb = _board(pkg)(2, failures=2, cooldown_s=30.0)
    assert bb.enabled
    # two consecutive failures open node 0
    for _ in range(2):
        tok = bb.before_attempt(0)
        assert tok is not None
        bb.settle(tok, False)
    assert bb.is_open(0) and not bb.is_open(1)
    assert bb.counters["opens"] == 1
    # open + cooling: attempts are refused without an RPC
    assert bb.before_attempt(0) is None
    assert bb.counters["skips"] == 1
    # a success on the OTHER node is independent state
    tok = bb.before_attempt(1)
    bb.settle(tok, True)
    assert not bb.is_open(1)
    assert bb.snapshot()["states"] == ["open", "closed"]
    bb.reset(0)
    assert not bb.is_open(0) and bb.counters["opens"] == 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_breaker_half_open_probe_closes_or_reopens(pkg):
    bb = _board(pkg)(1, failures=1, cooldown_s=0.0)
    tok = bb.before_attempt(0)
    bb.settle(tok, False)                       # -> open
    # cooldown 0: next attempt is the single half-open probe
    probe = bb.before_attempt(0)
    assert probe is not None and probe.probe
    # while the probe is in flight, everything else is refused
    assert bb.before_attempt(0) is None
    bb.settle(probe, False)                     # failed probe re-opens
    assert bb.is_open(0)
    probe = bb.before_attempt(0)
    bb.settle(probe, True)                      # successful probe closes
    assert not bb.is_open(0)
    assert bb.counters["closes"] == 1 and bb.counters["probes"] == 2


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_breaker_disabled_admits_everything(pkg):
    bb = _board(pkg)(1, failures=0, cooldown_s=1.0)
    assert not bb.enabled
    for _ in range(10):
        tok = bb.before_attempt(0)
        assert tok is not None
        bb.settle(tok, False)
    assert not bb.is_open(0)


_HIST_PLAN = _plan(5, {"site": "hist.handle", "action": "error",
                       "scope": "hist500"})

Q_SALES = ("select region, sum(qty) as q, count(*) as c from sales "
           "group by region order by region")


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    """Two port historicals (replication 2) over the sales frame, each
    with the ``hist500`` scoped rule, and a single port context over the
    same root."""
    from conftest import make_sales_df
    from test_torch_cluster import start_historicals
    root = str(tmp_path_factory.mktemp("chaos-deep-storage"))
    single = tsdot.Context({"sdot.persist.path": root}, device="cpu")
    single.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                            target_rows=2048)
    single.checkpoint()
    nodes_csv, hist = start_historicals(
        {"sdot.persist.path": root, "sdot.cluster.replication": 2,
         "sdot.fault.plan": _HIST_PLAN})
    yield root, nodes_csv, hist, single
    for h in hist:
        h.stop()
    single.close()


def _broker(chaos, plan=None, **over):
    from test_torch_cluster import port_broker
    root, nodes_csv, _, _ = chaos
    cfg = {
        "sdot.cluster.replication": 2,
        # deterministic: no background prober, fast retry backoff, and
        # no result cache (each sql() must actually scatter)
        "sdot.cluster.probe.interval.seconds": 0,
        "sdot.cluster.retry.backoff.start.seconds": 0.01,
        "sdot.cluster.retry.backoff.cap.seconds": 0.05,
        "sdot.cache.enabled": False,
    }
    if plan:
        cfg["sdot.fault.plan"] = plan
    cfg.update(over)
    return port_broker(root, nodes_csv, **cfg)


def _exact(got, want):
    from conftest import assert_frames_equal
    assert_frames_equal(got, want, rtol=1e-9, atol=1e-9)


def test_chaos_breaker_opens_then_half_open_probe_recovers(chaos):
    _, _, hist, single = chaos
    f0 = hist[0].ctx.engine.fault
    f1 = hist[1].ctx.engine.fault
    br = _broker(chaos, None, **{
        "sdot.cluster.breaker.failures": 2,
        "sdot.cluster.breaker.cooldown.seconds": 0.05})
    try:
        want = single.sql(Q_SALES).to_pandas()
        # node 0 answers every subquery 500: after 2 consecutive
        # failures its breaker opens — answers stay exact via node 1
        with f0.scope("hist500"):
            for _ in range(3):
                _exact(br.sql(Q_SALES).to_pandas(), want)
        snap = br.cluster.breakers.snapshot()
        assert snap["opens"] == 1 and snap["states"][0] == "open"
        # past the cooldown, failing node 1 forces the chain down to
        # node 0, whose single half-open probe succeeds and closes it
        time.sleep(0.08)
        with f1.scope("hist500"):
            _exact(br.sql(Q_SALES).to_pandas(), want)
        snap = br.cluster.breakers.snapshot()
        assert snap["states"][0] == "closed"
        assert snap["probes"] >= 1 and snap["closes"] >= 1
        assert br.cluster.stats()["breakers"]["states"][0] == "closed"
    finally:
        br.close()


def test_chaos_hedge_launches_once_and_wins(chaos):
    # one primary leg stalls well past the fixed hedge delay: exactly
    # one hedge launches, wins, and the answer is exact — deterministic
    # counters under the fixed plan
    _, _, _, single = chaos
    br = _broker(chaos, _plan(
        24, {"site": "rpc.request", "action": "delay", "arg": 0.8,
             "count": 1}),
        **{"sdot.cluster.hedge.enabled": True,
           "sdot.cluster.hedge.after.ms": 100})
    try:
        t0 = time.perf_counter()
        got = br.sql(Q_SALES).to_pandas()
        elapsed = time.perf_counter() - t0
        _exact(got, single.sql(Q_SALES).to_pandas())
        c = br.cluster.counters
        assert c["hedges_launched"] == 1
        assert c["hedges_won"] == 1
        # the hedge answered ~0.1s in; without it the stalled primary
        # would have pinned the query to >= 0.8s
        assert elapsed < 0.75
    finally:
        br.close()


# -- the other cluster legs of tests/test_chaos.py ----------------------------

@pytest.fixture(scope="module")
def chaos_r1(chaos):
    """Replication-1 port historicals over the same deep storage: each
    shard has exactly one owner, so losing a node loses exactly its
    shards."""
    from test_torch_cluster import start_historicals
    root, _, _, single = chaos
    nodes_csv, hist = start_historicals(
        {"sdot.persist.path": root, "sdot.cluster.replication": 1,
         "sdot.fault.plan": _HIST_PLAN})
    yield root, nodes_csv, hist, single
    for h in hist:
        h.stop()


def test_chaos_corrupt_frame_rejected_and_retried(chaos):
    _, _, _, single = chaos
    br = _broker(chaos, _plan(
        21, {"site": "rpc.response", "action": "flip", "count": 1}))
    try:
        _exact(br.sql(Q_SALES).to_pandas(), single.sql(Q_SALES).to_pandas())
        c = br.cluster.counters
        # exactly the planned single flip: one CRC reject, one retry
        assert c["wire_corrupt"] == 1
        assert c["retries"] >= 1
        assert br.engine.last_stats["fault"]["by_site"] \
            == {"rpc.response": 1}
    finally:
        br.close()


def test_chaos_connect_refused_fails_over(chaos):
    _, _, _, single = chaos
    br = _broker(chaos, _plan(
        22, {"site": "rpc.connect", "match": "node:0", "action": "error",
             "arg": "ConnectionRefusedError", "count": 2}))
    try:
        _exact(br.sql(Q_SALES).to_pandas(), single.sql(Q_SALES).to_pandas())
        assert br.cluster.counters["failovers"] >= 1
    finally:
        br.close()


def test_chaos_slow_replica_delay_still_exact(chaos):
    # a slow-reply delay on one node: the query rides it out (no hedge
    # configured) and stays exact
    _, _, _, single = chaos
    br = _broker(chaos, _plan(
        23, {"site": "rpc.request", "match": "node:1", "action": "delay",
             "arg": 0.1, "count": 1}))
    try:
        _exact(br.sql(Q_SALES).to_pandas(), single.sql(Q_SALES).to_pandas())
        assert br.engine.last_stats["fault"]["fired"] == 1
    finally:
        br.close()


def test_chaos_hist_500_retries_on_replica(chaos):
    _, _, hist, single = chaos
    f1 = hist[1].ctx.engine.fault
    br = _broker(chaos)
    try:
        want = single.sql(Q_SALES).to_pandas()
        with f1.scope("hist500"):
            got = br.sql(Q_SALES).to_pandas()
        _exact(got, want)
        assert br.cluster.counters["retries"] >= 1
    finally:
        br.close()


ALL_DOWN = {"site": "rpc.connect", "action": "error",
            "arg": "ConnectionRefusedError"}


def test_chaos_all_replicas_down_strict_raises(chaos):
    from spark_druid_olap_tpu_torch.cluster.broker import ClusterError
    br = _broker(chaos, _plan(25, ALL_DOWN), **{
        "sdot.cluster.local.fallback": False,
        "sdot.cluster.retry.tries": 2})
    try:
        # a shard unreachable over the network is not a device loss: it
        # raises as itself, never demoted to the host tier
        with pytest.raises(ClusterError):
            br.sql(Q_SALES)
    finally:
        br.close()


def test_chaos_all_replicas_down_partial_degrades(chaos):
    br = _broker(chaos, _plan(26, ALL_DOWN), **{
        "sdot.cluster.partial.results": True,
        "sdot.cluster.retry.tries": 1})
    try:
        r = br.sql(Q_SALES)
        n_shards = br.cluster.plan.datasources["sales"].n_shards
        total = br.cluster.plan.datasources["sales"].num_rows
        assert r.degraded == {"missing_shards": list(range(n_shards)),
                              "coverage_rows": 0, "total_rows": total}
        assert len(r.to_pandas()) == 0          # shape-exact empty answer
        st = br.engine.last_stats["cluster"]
        assert st["degraded"]["coverage_rows"] == 0
        assert br.cluster.counters["degraded_queries"] == 1
    finally:
        br.close()


def test_chaos_partial_covers_exactly_the_survivors(chaos_r1):
    # replication 1: killing node 1 loses exactly node 1's shards; the
    # degraded count(*) equals the surviving shards' row count
    br = _broker(chaos_r1, _plan(
        27, {"site": "rpc.connect", "match": "node:1", "action": "error",
             "arg": "ConnectionRefusedError"}),
        **{"sdot.cluster.replication": 1,
           "sdot.cluster.partial.results": True,
           "sdot.cluster.retry.tries": 1})
    try:
        r = br.sql("select count(*) as c from sales")
        dp = br.cluster.plan.datasources["sales"]
        lost = sorted(sh.index for sh in dp.shards if sh.owners == (1,))
        kept_rows = sum(sh.rows for sh in dp.shards if sh.owners != (1,))
        assert lost and kept_rows > 0           # both sides non-trivial
        assert r.degraded["missing_shards"] == lost
        assert r.degraded["coverage_rows"] == kept_rows
        assert r.degraded["total_rows"] == dp.num_rows
        assert int(r.data["c"][0]) == kept_rows
    finally:
        br.close()


def test_chaos_degraded_answers_never_cached(chaos_r1):
    _, _, _, single = chaos_r1
    br = _broker(chaos_r1, _plan(
        28, {"site": "rpc.connect", "match": "node:1", "action": "error",
             "arg": "ConnectionRefusedError", "scope": "down1"}),
        **{"sdot.cluster.replication": 1,
           "sdot.cluster.partial.results": True,
           "sdot.cluster.retry.tries": 1,
           "sdot.cache.enabled": True})
    try:
        want = single.sql(Q_SALES).to_pandas()
        inj = br.engine.fault
        with inj.scope("down1"):
            r1 = br.sql(Q_SALES)
        assert r1.degraded is not None
        assert not r1.to_pandas().equals(want)  # visibly partial
        # faults cleared: the SAME query must re-scatter, not serve the
        # degraded answer from the result cache
        r2 = br.sql(Q_SALES)
        assert r2.degraded is None
        _exact(r2.to_pandas(), want)
        # ...and the healthy answer IS cached: a third run doesn't scatter
        scatters = br.cluster.counters["queries"]
        r3 = br.sql(Q_SALES)
        assert r3.degraded is None
        assert br.cluster.counters["queries"] == scatters
        _exact(r3.to_pandas(), want)
    finally:
        br.close()
