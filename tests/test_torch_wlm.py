"""The port's workload management, in-flight registry and cancellation
against the JAX package's.

The non-HTTP cases of ``tests/test_wlm.py`` run in both packages: the
lane grammar, the token bucket, the lane cap under a storm, the shed, the
queue-wait budget, cancel while queued, the deadline, the lane's default
timeout, demotion to batch, priority order, the three quota cases,
``sys_lanes`` / ``sys_queries``, the in-flight states, disabled WLM and
the session keywords. So do ``tests/test_server.py::test_query_timeout``
and ``::test_query_cancel_flag``, and ``tests/test_sharedscan.py::
test_cancel_one_of_the_batch`` and ``::test_wlm_queue_hands_off_into_open_group``.
``parallel/cost.estimate``, the demotion signal, is held equal to the JAX
package's on the sales frame and the TPC-H statements, and so are the lane
decisions it drives. The HTTP cases (the 429 shed with ``Retry-After``,
the lane and tenant headers, ``/metadata/wlm``, stop and restart) run
through both packages' ``SqlServer``.

Tolerance: lane decisions, counters, states and errors exactly; the cost
estimate's rows, selectivity, groups and single-device cost exactly (the
same arithmetic on the same metadata); answers exact for dimensions,
integers and counts, rtol 1e-6 for float sums.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import dataclasses
import threading
import time

import numpy as np
import pandas as pd
import pytest

from conftest import make_sales_df

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu import wlm as JW
from spark_druid_olap_tpu.ir import spec as JS
from spark_druid_olap_tpu.parallel import cost as JC
from spark_druid_olap_tpu.parallel import executor as JX
from spark_druid_olap_tpu.result import QueryResult as JResult
from spark_druid_olap_tpu.tools import tpch as jtpch
from spark_druid_olap_tpu.wlm import quota as JQ

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch import wlm as TW
from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.parallel import cost as TC
from spark_druid_olap_tpu_torch.parallel import executor as TX
from spark_druid_olap_tpu_torch.result import QueryResult as TResult
from spark_druid_olap_tpu_torch.tools import tpch as ttpch
from spark_druid_olap_tpu_torch.wlm import quota as TQ

from test_torch_sharedscan import sales_batch
from test_torch_sql import MAIN, assert_answers_equal


class _Pkg:
    """One package's names, so a scenario is written once."""

    def __init__(self, name, mod, S, W, Q, X, C, result, tpch):
        self.name, self.mod, self.S, self.W, self.Q = name, mod, S, W, Q
        self.X, self.C, self.Result, self.tpch = X, C, result, tpch

    def context(self, **conf):
        if self.name == "jax":
            return self.mod.Context(config=conf)
        return self.mod.Context(config=conf, device="cpu")


PKGS = {"jax": _Pkg("jax", jsdot, JS, JW, JQ, JX, JC, JResult, jtpch),
        "torch": _Pkg("torch", tsdot, TS, TW, TQ, TX, TC, TResult, ttpch)}
BOTH = pytest.mark.parametrize("pkg", list(PKGS))


@pytest.fixture
def P(pkg):
    return PKGS[pkg]


def _ctx(P, lanes, **conf):
    ctx = P.context(**{"sdot.wlm.lanes": lanes, **conf})
    ctx.ingest_dataframe("sales", make_sales_df(2000), time_column="ts")
    return ctx


def _spec(P, ds="sales", qid=None, **ctx_kw):
    S = P.S
    return S.TimeseriesQuerySpec(
        datasource=ds, intervals=(), granularity=S.Granularity("all"),
        aggregations=(S.AggregationSpec("count", "c", None),),
        context=S.QueryContext(query_id=qid, **ctx_kw))


class _FakeExec:
    """Replaces QueryEngine._execute_admitted: counts concurrent entries
    (the cap proof), blocks on an optional gate, and proves shed queries
    never execute."""

    def __init__(self, P, gate=None, sleep_s=0.0):
        self.P = P
        self.gate = gate
        self.sleep_s = sleep_s
        self.lock = threading.Lock()
        self.active = 0
        self.max_active = 0
        self.calls = 0
        self.seen = []

    def __call__(self, q, t0):
        with self.lock:
            self.calls += 1
            self.active += 1
            self.max_active = max(self.max_active, self.active)
            self.seen.append(q)
        try:
            if self.gate is not None:
                assert self.gate.wait(10.0), "test gate never opened"
            if self.sleep_s:
                time.sleep(self.sleep_s)
            return self.P.Result(["c"], {"c": np.array([1])})
        finally:
            with self.lock:
                self.active -= 1


def _hold_slot(ctx, fake, **spec_kw):
    """Start a statement that holds the lane's slot on the fake's gate."""
    P = fake.P
    holder = threading.Thread(
        target=lambda: ctx.engine.execute(_spec(P, **spec_kw)))
    holder.start()
    for _ in range(200):
        if fake.active == 1:
            break
        time.sleep(0.005)
    return holder


def _lanes_idle(ctx):
    """After every scenario: no lane runs or queues anything."""
    for ln in ctx.engine.wlm.stats()["lanes"]:
        assert ln["active"] == 0 and ln["queued"] == 0, ln
    assert ctx.engine.inflight.snapshot() == []


# -- grammar / primitives ------------------------------------------------------

@BOTH
def test_parse_lanes_grammar(P):
    lanes = P.W.parse_lanes("a:slots=2,queue=4,wait_ms=50,timeout_ms=1000,"
                            "priority=9; b ; c:slots=1")
    assert lanes["a"].slots == 2 and lanes["a"].max_queue == 4
    assert lanes["a"].max_wait_ms == 50.0
    assert lanes["a"].timeout_millis == 1000 and lanes["a"].priority == 9
    assert lanes["b"].slots == 4          # defaults
    assert lanes["c"].slots == 1
    with pytest.raises(ValueError, match="unknown lane option"):
        P.W.parse_lanes("a:slotz=2")


def test_parse_lanes_equals_jax():
    spec = ("interactive:slots=8,queue=64;reporting:slots=4,queue=32,"
            "wait_ms=25;batch:slots=2,queue=16,timeout_ms=900,priority=-1")
    j, t = JW.parse_lanes(spec), TW.parse_lanes(spec)
    assert {k: dataclasses.asdict(v) for k, v in t.items()} == \
        {k: dataclasses.asdict(v) for k, v in j.items()}


@BOTH
def test_token_bucket_fake_clock(P):
    t = [0.0]
    b = P.W.TokenBucket(10.0, 2.0, now_fn=lambda: t[0])
    assert b.try_charge(8.0) and not b.try_charge(4.0)
    assert b.seconds_until(4.0) == pytest.approx(1.0)   # (4-2)/2
    t[0] = 4.0                                          # refills to cap
    assert b.tokens() == pytest.approx(10.0)
    assert b.seconds_until(12.0) == float("inf")        # > capacity


# -- concurrency cap -----------------------------------------------------------

@BOTH
def test_lane_cap_never_exceeded_under_storm(P):
    ctx = _ctx(P, "fast:slots=2,queue=64", **{"sdot.wlm.default.lane": "fast"})
    fake = _FakeExec(P, sleep_s=0.01)
    ctx.engine._execute_admitted = fake
    errs = []

    def worker():
        try:
            ctx.engine.execute(_spec(P))
        except Exception as e:      # noqa: BLE001 — collected for assert
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert not errs
    assert fake.calls == 16
    assert fake.max_active <= 2                       # the cap proof
    fast = next(ln for ln in ctx.engine.wlm.stats()["lanes"]
                if ln["lane"] == "fast")
    assert fast["max_active_seen"] <= 2
    assert fast["admitted"] == 16 and fast["active"] == 0
    _lanes_idle(ctx)


# -- shedding ------------------------------------------------------------------

@BOTH
def test_queue_depth_shed_never_reaches_executor(P):
    ctx = _ctx(P, "only:slots=1,queue=0", **{"sdot.wlm.default.lane": "only"})
    gate = threading.Event()
    fake = _FakeExec(P, gate=gate)
    ctx.engine._execute_admitted = fake
    holder = _hold_slot(ctx, fake)
    with pytest.raises(P.W.LaneFullError) as ei:
        ctx.engine.execute(_spec(P))
    assert ei.value.retry_after_s > 0
    gate.set()
    holder.join(10.0)
    assert fake.calls == 1                    # shed query never executed
    assert ctx.engine.wlm.stats()["shed"] == 1
    _lanes_idle(ctx)


@BOTH
def test_queue_wait_budget_shed(P):
    ctx = _ctx(P, "only:slots=1,queue=8,wait_ms=40",
               **{"sdot.wlm.default.lane": "only"})
    gate = threading.Event()
    fake = _FakeExec(P, gate=gate)
    ctx.engine._execute_admitted = fake
    holder = _hold_slot(ctx, fake)
    t0 = time.perf_counter()
    with pytest.raises(P.W.LaneFullError, match="queue-wait budget"):
        ctx.engine.execute(_spec(P))
    assert (time.perf_counter() - t0) < 5.0
    gate.set()
    holder.join(10.0)
    assert fake.calls == 1
    only = ctx.engine.wlm.stats()["lanes"][0]
    assert only["timed_out"] == 1 and only["active"] == 0
    _lanes_idle(ctx)


# -- cancel / timeout while queued ---------------------------------------------

@BOTH
def test_cancel_while_queued_releases_cleanly(P):
    ctx = _ctx(P, "only:slots=1,queue=8", **{"sdot.wlm.default.lane": "only"})
    gate = threading.Event()
    fake = _FakeExec(P, gate=gate)
    ctx.engine._execute_admitted = fake
    holder = _hold_slot(ctx, fake)
    got = []

    def queued():
        try:
            ctx.engine.execute(_spec(P, qid="q-queued"))
        except BaseException as e:  # noqa: BLE001
            got.append(e)

    qt = threading.Thread(target=queued)
    qt.start()
    for _ in range(200):                      # until q-queued is registered
        if "q-queued" in ctx.engine._cancel_flags:
            break
        time.sleep(0.005)
    assert ctx.engine.cancel("q-queued")
    qt.join(10.0)
    assert got and isinstance(got[0], P.X.QueryCancelled)
    gate.set()
    holder.join(10.0)
    assert fake.calls == 1                    # the cancelled one never ran
    only = ctx.engine.wlm.stats()["lanes"][0]
    assert only["cancelled_queued"] == 1 and only["active"] == 0
    # the lane still works: slot accounting survived the unhook
    assert ctx.engine.execute(_spec(P)) is not None and fake.calls == 2
    assert not ctx.engine.cancel("q-queued")  # released with its query
    _lanes_idle(ctx)


@BOTH
def test_queued_wait_counts_against_deadline(P):
    # the lane's default timeout (timeout_ms) applies while QUEUED too
    ctx = _ctx(P, "only:slots=1,queue=8,timeout_ms=60",
               **{"sdot.wlm.default.lane": "only"})
    gate = threading.Event()
    fake = _FakeExec(P, gate=gate)
    ctx.engine._execute_admitted = fake
    holder = _hold_slot(ctx, fake)
    with pytest.raises(P.X.QueryTimeout):
        ctx.engine.execute(_spec(P))
    gate.set()
    holder.join(10.0)
    assert fake.calls == 1
    _lanes_idle(ctx)


@BOTH
def test_lane_default_timeout_propagates_into_context(P):
    ctx = _ctx(P, "only:slots=4,queue=8,timeout_ms=120000",
               **{"sdot.wlm.default.lane": "only"})
    fake = _FakeExec(P)
    ctx.engine._execute_admitted = fake
    ctx.engine.execute(_spec(P))
    assert fake.seen[0].context.timeout_millis == 120000
    # an explicit client timeout wins over the lane default
    ctx.engine.execute(_spec(P, timeout_millis=5000))
    assert fake.seen[1].context.timeout_millis == 5000


# -- classification ------------------------------------------------------------

@BOTH
def test_cost_demotion_to_batch(P):
    ctx = _ctx(P, "interactive:slots=4;batch:slots=2,queue=8")
    fake = _FakeExec(P)
    ctx.engine._execute_admitted = fake
    ctx.engine.wlm._estimate_cost = lambda engine, q: 9.9   # expensive
    ctx.engine.execute(_spec(P))
    assert ctx.engine.last_stats["wlm"]["lane"] == "batch"
    assert ctx.engine.last_stats["wlm"]["demoted"] is True
    # explicit lane wins over demotion
    ctx.engine.execute(_spec(P, lane="interactive"))
    assert ctx.engine.last_stats["wlm"]["lane"] == "interactive"
    # cheap query stays interactive
    ctx.engine.wlm._estimate_cost = lambda engine, q: 1e-6
    ctx.engine.execute(_spec(P))
    assert ctx.engine.last_stats["wlm"]["lane"] == "interactive"
    batch = next(ln for ln in ctx.engine.wlm.stats()["lanes"]
                 if ln["lane"] == "batch")
    assert batch["demoted_in"] == 1


@BOTH
def test_priority_orders_the_queue(P):
    ctx = _ctx(P, "only:slots=1,queue=8", **{"sdot.wlm.default.lane": "only"})
    gate = threading.Event()
    fake = _FakeExec(P, gate=gate)
    ctx.engine._execute_admitted = fake
    order = []
    olock = threading.Lock()

    def run(prio):
        ctx.engine.execute(_spec(P, priority=prio))
        with olock:
            order.append(prio)

    holder = _hold_slot(ctx, fake)
    lo = threading.Thread(target=run, args=(1,))
    lo.start()
    time.sleep(0.1)                 # lo is queued first (FIFO seq smaller)
    hi = threading.Thread(target=run, args=(5,))
    hi.start()
    time.sleep(0.1)
    gate.set()                      # holder finishes; grants go by priority
    holder.join(10.0)
    lo.join(10.0)
    hi.join(10.0)
    assert order == [5, 1]          # higher priority granted first
    _lanes_idle(ctx)


# -- quotas --------------------------------------------------------------------

@BOTH
def test_quota_concurrent_cap(P):
    ctx = _ctx(P, "only:slots=8,queue=8", **{
        "sdot.wlm.default.lane": "only",
        "sdot.wlm.quota.acme": "concurrent=1"})
    gate = threading.Event()
    fake = _FakeExec(P, gate=gate)
    ctx.engine._execute_admitted = fake
    holder = _hold_slot(ctx, fake, tenant="acme")
    with pytest.raises(P.Q.QuotaExceededError, match="concurrent-query cap"):
        ctx.engine.execute(_spec(P, tenant="acme"))
    # other tenants are unaffected while acme still holds its slot
    fake.gate = None
    ctx.engine.execute(_spec(P, tenant="other"))
    gate.set()
    holder.join(10.0)
    # the cap recovers once the in-flight query releases
    ctx.engine.execute(_spec(P, tenant="acme"))
    assert fake.calls == 3
    _lanes_idle(ctx)
    assert all(t["active"] == 0 for t in ctx.engine.wlm.stats()["tenants"])


@BOTH
def test_quota_budget_exhaustion_recovers_after_refill(P):
    ctx = _ctx(P, "only:slots=8,queue=8", **{
        "sdot.wlm.default.lane": "only",
        "sdot.wlm.quota.acme": "budget=1.0,refill=0.5"})
    fake = _FakeExec(P)
    ctx.engine._execute_admitted = fake
    clock = [0.0]
    ctx.engine.wlm.quotas = P.Q.QuotaManager(now_fn=lambda: clock[0])
    ctx.engine.wlm._estimate_cost = lambda engine, q: 0.6
    ctx.engine.execute(_spec(P, tenant="acme"))            # 1.0 -> 0.4
    with pytest.raises(P.Q.QuotaExceededError) as ei:
        ctx.engine.execute(_spec(P, tenant="acme"))        # needs 0.6
    assert ei.value.retry_after_s == pytest.approx(0.4, abs=0.05)
    clock[0] = 2.0                                         # +1.0 refilled
    ctx.engine.execute(_spec(P, tenant="acme"))            # recovers
    assert fake.calls == 2
    snap = ctx.engine.wlm.stats()["tenants"][0]
    assert snap["tenant"] == "acme" and snap["rejected"] == 1
    assert snap["cost_charged"] == pytest.approx(1.2)
    _lanes_idle(ctx)


@BOTH
def test_quota_default_template_applies_to_unknown_tenants(P):
    ctx = _ctx(P, "only:slots=8,queue=8", **{
        "sdot.wlm.default.lane": "only",
        "sdot.wlm.quota.default": "concurrent=1"})
    gate = threading.Event()
    fake = _FakeExec(P, gate=gate)
    ctx.engine._execute_admitted = fake
    holder = _hold_slot(ctx, fake, tenant="anyone")
    with pytest.raises(P.Q.QuotaExceededError):
        ctx.engine.execute(_spec(P, tenant="anyone"))
    gate.set()
    holder.join(10.0)
    _lanes_idle(ctx)


def test_quota_keys_stay_out_of_the_fingerprint():
    """Tenant quotas shape admission only: both packages leave them out of
    the config fingerprint that cache keys fold in."""
    for P in PKGS.values():
        ctx = P.context(**{"sdot.wlm.quota.acme": "concurrent=1",
                           "sdot.engine.hll.log2m": 11})
        assert ctx.config.fingerprint() == \
            (("sdot.engine.hll.log2m", "11"),)
        assert ctx.config.prefixed("sdot.wlm.quota.") == \
            {"sdot.wlm.quota.acme": "concurrent=1"}


# -- observability -------------------------------------------------------------

@BOTH
def test_sys_lanes_and_sys_queries_views(P):
    ctx = _ctx(P, "interactive:slots=8;batch:slots=2")
    ctx.sql("SELECT COUNT(*) FROM sales")
    lanes = ctx.sql("SELECT lane, slots, active, admitted, max_active_seen "
                    "FROM sys_lanes").to_pandas()
    assert set(lanes["lane"]) == {"interactive", "batch"}
    inter = lanes[lanes["lane"] == "interactive"].iloc[0]
    assert inter["slots"] == 8 and inter["admitted"] >= 1
    q = ctx.sql("SELECT state, lane, queued_ms, wall_ms "
                "FROM sys_queries").to_pandas()
    assert len(q) >= 1
    assert (q["state"] == "completed").any()
    assert (q["queued_ms"] >= 0).all() and (q["wall_ms"] >= 0).all()


def test_sys_views_equal_jax():
    """The same statements leave the same sys_lanes counters and the same
    sys_queries rows (timings aside) in both packages."""
    out = {}
    for name, P in PKGS.items():
        ctx = _ctx(P, "interactive:slots=8;reporting:slots=2")
        ctx.sql("SELECT COUNT(*) FROM sales")
        ctx.sql("SELECT region, SUM(qty) q FROM sales GROUP BY region",
                lane="reporting", tenant="bi")
        lanes = ctx.sql("SELECT lane, slots, active, queued, admitted, "
                        "max_active_seen FROM sys_lanes").to_pandas()
        q = ctx.sql("SELECT state, lane, tenant FROM sys_queries") \
            .to_pandas()
        out[name] = (lanes, q)
    pd.testing.assert_frame_equal(out["torch"][0], out["jax"][0])
    pd.testing.assert_frame_equal(out["torch"][1], out["jax"][1])


@BOTH
def test_inflight_registry_states(P):
    ctx = _ctx(P, "only:slots=1,queue=8", **{"sdot.wlm.default.lane": "only"})
    gate = threading.Event()
    fake = _FakeExec(P, gate=gate)
    ctx.engine._execute_admitted = fake
    holder = _hold_slot(ctx, fake)
    queued = threading.Thread(target=lambda: ctx.engine.execute(_spec(P)))
    queued.start()
    states = set()
    for _ in range(200):
        states = {r["state"] for r in ctx.engine.inflight.snapshot()}
        if states == {"running", "queued"}:
            break
        time.sleep(0.005)
    assert states == {"running", "queued"}
    gate.set()
    holder.join(10.0)
    queued.join(10.0)
    assert ctx.engine.inflight.snapshot() == []
    _lanes_idle(ctx)


@BOTH
def test_wlm_disabled_is_transparent(P):
    ctx = _ctx(P, "only:slots=1,queue=0", **{
        "sdot.wlm.default.lane": "only", "sdot.wlm.enabled": False})
    fake = _FakeExec(P, sleep_s=0.01)
    ctx.engine._execute_admitted = fake
    threads = [threading.Thread(target=lambda: ctx.engine.execute(_spec(P)))
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert fake.calls == 6                    # nothing shed, nothing queued
    assert "wlm" not in ctx.engine.last_stats
    assert ctx.engine.wlm.stats()["admitted"] == 0


@BOTH
def test_session_lane_kwargs_flow_to_stats(P):
    ctx = _ctx(P, "interactive:slots=8;reporting:slots=2")
    ctx.sql("SELECT COUNT(*) FROM sales", lane="reporting", tenant="bi",
            priority=3)
    st = ctx.history.entries()[-1].stats["wlm"]
    assert st == {"lane": "reporting", "queued_ms": 0.0, "priority": 3,
                  "tenant": "bi"}
    rep = next(ln for ln in ctx.engine.wlm.stats()["lanes"]
               if ln["lane"] == "reporting")
    assert rep["admitted"] >= 1
    assert any(t["tenant"] == "bi"
               for t in ctx.engine.wlm.stats()["tenants"])


@BOTH
def test_session_query_id_is_cancellable(P):
    """``Context.sql(query_id=...)`` registers the id before planning and
    puts it into each spec: a cancel raised from inside the statement's
    first spec reaches it at the next boundary."""
    ctx = _ctx(P, "interactive:slots=8")
    real = ctx.engine._execute_admitted

    def cancel_then_run(q, t0):
        assert q.context.query_id == "dash-1"
        assert ctx.engine.cancel("dash-1")
        return real(q, t0)

    ctx.engine._execute_admitted = cancel_then_run
    with pytest.raises(P.X.QueryCancelled):
        ctx.sql("SELECT region, SUM(qty) q FROM sales GROUP BY region",
                query_id="dash-1")
    assert "dash-1" not in ctx.engine._cancel_flags    # released
    ctx.engine._execute_admitted = real
    assert len(ctx.sql("SELECT COUNT(*) FROM sales",
                       query_id="dash-1").to_pandas()) == 1
    _lanes_idle(ctx)


# -- timeout and cancel on the engine path ----------------------------------------

@BOTH
def test_query_timeout(P):
    ctx = P.context()
    ctx.ingest_dataframe("sales", make_sales_df(1000), time_column="ts")
    S = P.S
    q = S.TimeseriesQuerySpec(
        "sales", (S.AggregationSpec("count", "c"),),
        context=S.QueryContext(query_id="t1", timeout_millis=0))
    with pytest.raises(P.X.QueryTimeout):
        ctx.engine.execute(q)
    _lanes_idle(ctx)


@BOTH
def test_query_cancel_flag(P):
    ctx = P.context()
    ctx.ingest_dataframe("sales", make_sales_df(1000), time_column="ts")
    # pre-set the cancel flag, then execute: the first boundary raises
    ev = threading.Event()
    ev.set()
    ctx.engine._cancel_flags["c1"] = ev
    S = P.S
    q = S.TimeseriesQuerySpec(
        "sales", (S.AggregationSpec("count", "c"),),
        context=S.QueryContext(query_id="c1"))
    with pytest.raises(P.X.QueryCancelled):
        ctx.engine.execute(q)
    _lanes_idle(ctx)


def test_wave_boundary_cancel_leaves_the_engine_clean():
    """A cancel at a wave boundary of a multi-wave scan raises
    QueryCancelled, and the next statement on the same engine (waves and
    the bind cache both) answers as the JAX engine does."""
    ctxs = {name: P.context(**{"sdot.engine.wave.max.bytes": 1})
            for name, P in PKGS.items()}
    for ctx in ctxs.values():
        ctx.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                             target_rows=4096)
    P = PKGS["torch"]
    S, eng = P.S, ctxs["torch"].engine
    q = S.GroupByQuerySpec(
        "sales", (S.DimensionSpec("region", "region"),),
        (S.AggregationSpec("longsum", "q", field="qty"),),
        context=S.QueryContext(query_id="wave-victim"))
    real = P.X._WaveBinder.bind_wave
    n = [0]

    def bind_then_cancel(self, segs):
        n[0] += 1
        if n[0] == 3:           # wave 2 bound: cancel before its launch
            eng.cancel("wave-victim")
        return real(self, segs)

    P.X._WaveBinder.bind_wave = bind_then_cancel
    try:
        with pytest.raises(P.X.QueryCancelled):
            eng.execute(q)
    finally:
        P.X._WaveBinder.bind_wave = real
    assert n[0] == 3
    sql = "select region, sum(qty) q, count(*) n from sales group by region"
    got = ctxs["torch"].sql(sql).to_pandas()
    assert ctxs["torch"].history.entries()[-1].stats["waves"] > 1
    assert_answers_equal(got, ctxs["jax"].sql(sql).to_pandas(),
                         ordered=False)
    _lanes_idle(ctxs["torch"])


# -- the cost estimate behind demotion -------------------------------------------

def _estimates(ctx, C, run):
    """Every spec ``run`` executes on ``ctx``: (lane, demoted) from WLM,
    and the estimate's comparable fields."""
    seen = []
    wlm = ctx.engine.wlm
    real = wlm._estimate_cost

    def spy(engine, q):
        e = C.estimate(engine, q)
        seen.append((q.datasource, e.rows, e.selectivity, e.output_groups,
                     e.single_cost))
        return real(engine, q)

    wlm._estimate_cost = spy
    lanes = []
    real_exec = ctx.engine._execute_admitted

    def record(q, t0):
        lanes.append((ctx.engine.last_stats["wlm"]["lane"],
                      ctx.engine.last_stats["wlm"].get("demoted", False)))
        return real_exec(q, t0)

    ctx.engine._execute_admitted = record
    run(ctx)
    return seen, lanes


def test_estimate_and_demotion_equal_jax_on_sales():
    specs = lambda S: sales_batch(S) + [  # noqa: E731
        S.GroupByQuerySpec(
            "sales", (S.DimensionSpec("product", "product"),
                      S.DimensionSpec("region", "region")),
            (S.AggregationSpec("count", "n"),),
            filter=S.BoundFilter("qty", lower=40, numeric=True)),
        S.TimeseriesQuerySpec(
            "sales", (S.AggregationSpec("count", "n"),),
            granularity=S.Granularity("day"),
            filter=S.InFilter("flag", ("A", "R")))]
    out = {}
    for name, P in PKGS.items():
        ctx = P.context(**{"sdot.wlm.batch.cost.threshold": 1.5e-4})
        ctx.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                             target_rows=4096)
        out[name] = _estimates(
            ctx, P.C, lambda c, S=P.S: [c.execute(q) for q in specs(S)])
    assert out["torch"] == out["jax"]
    assert {d for _, d in out["torch"][1]} == {True, False}, out["torch"][1]


def test_estimate_and_demotion_equal_jax_on_tpch():
    """The statements phase ``sql`` runs on the card, at SF 0.01: the
    estimates and the lane each of their specs lands in."""
    out = {}
    for name, P in PKGS.items():
        ctx = P.context(**{"sdot.wlm.batch.cost.threshold": 5e-4})
        P.tpch.setup_context(ctx, sf=0.01, target_rows=16_384,
                             flat_only=True)
        out[name] = _estimates(
            ctx, P.C, lambda c, P=P: [c.sql(P.tpch.QUERIES[n])
                                      for n in MAIN])
    assert out["torch"] == out["jax"]
    assert {d for _, d in out["torch"][1]} == {True, False}, out["torch"][1]


# -- the shared-scan tier under cancel and WLM ---------------------------------

def _storm(eng, specs, cancel=None):
    """Fire ``specs`` at once; ``cancel`` (a query id) is cancelled well
    inside the hold window. Returns (frames, errors)."""
    n = len(specs)
    res, errs = [None] * n, [None] * n
    bar = threading.Barrier(n + 1)

    def worker(i):
        bar.wait()
        try:
            res[i] = eng.execute(specs[i]).to_pandas()
        except Exception as e:          # noqa: BLE001
            errs[i] = e

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    bar.wait()
    if cancel is not None:
        time.sleep(0.2)
        assert eng.cancel(cancel)
    for t in threads:
        t.join()
    return res, errs


def _storm_ctx(P, **conf):
    ctx = P.context(**{"sdot.sharedscan.enabled": True,
                       "sdot.wlm.batch.window.ms": 500.0,
                       "sdot.wlm.enabled": False,
                       "sdot.pallas.wave.enabled": P.name == "torch",
                       **conf})
    ctx.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                         target_rows=4096)
    return ctx


def test_cancel_one_of_the_batch():
    """Cancelling one constituent during the hold window drops only that
    member (QueryCancelled); the survivors' fused answers are unchanged."""
    out = {}
    for name, P in PKGS.items():
        S = P.S
        ctx = _storm_ctx(P, **{"sdot.wlm.batch.window.ms": 800.0})
        aggs = sales_batch(S)[0].aggregations
        victim = S.GroupByQuerySpec(
            "sales", (S.DimensionSpec("product", "product"),), aggs,
            context=S.QueryContext(query_id="sharedscan-victim"))
        survivors = [sales_batch(S)[0], sales_batch(S)[2]]
        ref_ctx = P.context()
        ref_ctx.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                                 target_rows=4096)
        ref = [ref_ctx.execute(q).to_pandas() for q in survivors]
        res, errs = _storm(ctx.engine, survivors + [victim],
                           cancel="sharedscan-victim")
        assert isinstance(errs[2], P.X.QueryCancelled), errs[2]
        for i, want in enumerate(ref):
            assert errs[i] is None, errs[i]
            assert_answers_equal(res[i], want, ordered=True)
        assert ctx.engine.sharedscan.stats()["queries_coalesced"] >= 2
        _lanes_idle(ctx)
        out[name] = res[:2]
    for t, j in zip(out["torch"], out["jax"]):
        assert_answers_equal(t, j, ordered=True)


def test_cancel_of_the_dispatching_member_runs_the_others_solo():
    """A cancel of the member whose checks the fused dispatch runs, at the
    dispatch boundary: that member raises, the others run solo with their
    own answers (the JAX package degrades the group the same way)."""
    P = PKGS["torch"]
    S = P.S
    ctx = _storm_ctx(P)
    eng = ctx.engine
    specs = [dataclasses.replace(q, context=S.QueryContext(query_id=f"m{i}"))
             for i, q in enumerate(sales_batch(S)[:3])]
    ref = P.context()
    ref.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                         target_rows=4096)
    want = [ref.execute(q).to_pandas() for q in specs]
    real = eng.sharedscan._dispatch
    victim = []

    def dispatch(*a):
        # the boundary check closes over the member it checks
        pilot = next(c.cell_contents for c in a[-1].__closure__
                     if type(c.cell_contents).__name__ == "_Member")
        victim.append(pilot.q.context.query_id)
        assert eng.cancel(victim[0])
        return real(*a)

    eng.sharedscan._dispatch = dispatch
    res, errs = _storm(eng, specs)
    assert len(victim) == 1
    for i, q in enumerate(specs):
        if q.context.query_id == victim[0]:
            assert isinstance(errs[i], P.X.QueryCancelled), errs[i]
        else:
            assert errs[i] is None, errs[i]
            assert_answers_equal(res[i], want[i], ordered=True)
    assert eng.sharedscan.stats()["fallbacks"] == 2
    _lanes_idle(ctx)


def test_wlm_queue_hands_off_into_open_group():
    """Queries queued behind a full lane are handed to an open coalesced
    group by the admission poll loop instead of waiting for a slot."""
    out = {}
    for name, P in PKGS.items():
        ctx = _storm_ctx(P, **{
            "sdot.wlm.enabled": True,
            "sdot.wlm.lanes": "interactive:slots=1,queue=16",
            "sdot.wlm.default.lane": "interactive",
            "sdot.wlm.batch.cost.threshold": 0})
        specs = sales_batch(P.S)[:4]
        ref_ctx = P.context()
        ref_ctx.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                                 target_rows=4096)
        ref = [ref_ctx.execute(q).to_pandas() for q in specs]
        res, errs = _storm(ctx.engine, specs)
        assert not any(errs), [e for e in errs if e]
        for got, want in zip(res, ref):
            assert_answers_equal(got, want, ordered=True)
        st = ctx.engine.wlm.stats()
        assert st["sharedscan"]["queries_coalesced"] >= 2
        assert st["sharedscan"]["wlm_handoffs"] >= 1, st
        lane = next(ln for ln in st["lanes"] if ln["lane"] == "interactive")
        assert lane["coalesced_handoff"] >= 1, lane
        assert lane["max_active_seen"] == 1
        _lanes_idle(ctx)
        out[name] = res
    for t, j in zip(out["torch"], out["jax"]):
        assert_answers_equal(t, j, ordered=True)


# -- the HTTP cases of tests/test_wlm.py --------------------------------------

def _http(P):
    """One package's HTTP server module."""
    if P.name == "jax":
        from spark_druid_olap_tpu.server import http
    else:
        from spark_druid_olap_tpu_torch.server import http
    return http


@pytest.fixture
def wlm_server(P):
    ctx = _ctx(P, "only:slots=1,queue=0", **{"sdot.wlm.default.lane": "only"})
    s = _http(P).SqlServer(ctx, "127.0.0.1", 0).start()
    yield s
    s.stop()


def _post(server, path, payload, headers=None):
    import json
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, dict(r.headers), json.loads(r.read().decode())


@BOTH
def test_http_shed_gets_429_with_retry_after(P, wlm_server):
    import json
    import urllib.error
    ctx = wlm_server.ctx
    gate = threading.Event()
    fake = _FakeExec(P, gate=gate)
    ctx.engine._execute_admitted = fake
    results = []

    def slow():
        results.append(_post(wlm_server, "/sql",
                             {"sql": "SELECT COUNT(*) FROM sales"}))

    holder = threading.Thread(target=slow)
    holder.start()
    deadline = time.monotonic() + 10
    while fake.active != 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert fake.active == 1
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(wlm_server, "/sql", {"sql": "SELECT COUNT(*) FROM sales"})
    assert ei.value.code == 429
    assert int(ei.value.headers["Retry-After"]) >= 1
    body = json.loads(ei.value.read().decode())
    assert body["error"] == "LaneFullError"
    assert body["retryAfterSeconds"] >= 1
    assert "queryId" in body
    gate.set()
    holder.join(10.0)
    assert results and results[0][0] == 200
    assert fake.calls == 1                    # shed request never executed
    _lanes_idle(ctx)


@BOTH
def test_http_lane_and_tenant_headers(P, wlm_server):
    ctx = wlm_server.ctx
    ctx.config.set("sdot.wlm.lanes", "only:slots=1,queue=0;vip:slots=4")
    code, headers, body = _post(
        wlm_server, "/sql", {"sql": "SELECT COUNT(*) FROM sales"},
        headers={"X-Sdot-Lane": "vip", "X-Sdot-Tenant": "acme"})
    assert code == 200
    vip = next(ln for ln in ctx.engine.wlm.stats()["lanes"]
               if ln["lane"] == "vip")
    assert vip["admitted"] >= 1
    assert any(t["tenant"] == "acme"
               for t in ctx.engine.wlm.stats()["tenants"])
    # the raw-query wire takes the lane from the spec's context
    code, _, body = _post(wlm_server, "/query", {
        "queryType": "timeseries", "dataSource": "sales",
        "aggregations": [{"type": "count", "name": "c"}],
        "context": {"lane": "vip", "tenant": "acme"}})
    assert code == 200 and body["rows"][0]["c"] == 2000
    vip2 = next(ln for ln in ctx.engine.wlm.stats()["lanes"]
                if ln["lane"] == "vip")
    assert vip2["admitted"] == vip["admitted"] + 1


def test_metadata_wlm_endpoint_equal_jax():
    import json
    import urllib.request
    docs = {}
    for name, P in PKGS.items():
        ctx = _ctx(P, "only:slots=1,queue=0",
                   **{"sdot.wlm.default.lane": "only"})
        s = _http(P).SqlServer(ctx, "127.0.0.1", 0).start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{s.port}/metadata/wlm") as r:
                docs[name] = json.loads(r.read().decode())
        finally:
            s.stop()
    for body in docs.values():
        assert body["enabled"] is True
        assert {ln["lane"] for ln in body["lanes"]} >= {"only"}
        assert {"slots", "active", "queued", "shed",
                "max_active_seen"} <= set(body["lanes"][0])
    assert docs["torch"]["lanes"] == docs["jax"]["lanes"]
    assert docs["torch"]["tenants"] == docs["jax"]["tenants"]
    assert set(docs["torch"]) == set(docs["jax"])


@BOTH
def test_server_stop_is_idempotent_and_restartable(P):
    import urllib.request
    ctx = _ctx(P, "only:slots=4")
    http = _http(P)
    for _ in range(3):
        s = http.SqlServer(ctx, "127.0.0.1", 0).start()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{s.port}/healthz") as r:
            assert r.status == 200
        code, _, body = _post(s, "/sql",
                              {"sql": "SELECT COUNT(*) FROM sales"})
        assert code == 200 and body["numRows"] == 1
        s.stop()
        s.stop()                              # second stop is a no-op
        assert s._httpd is None
