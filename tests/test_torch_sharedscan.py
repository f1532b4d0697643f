"""The port's shared-scan storm path against the JAX package.

Concurrent storms of QuerySpecs go through a port ``Context(device="cpu")``
with ``sdot.sharedscan.enabled`` (its wave program runs the wave kernel's
plain version on the CPU) and are held against the JAX engine's concurrent
storm (its jaxpr-fused program: on the CPU the Pallas wave kernel is not
eligible, and it is switched off here besides), the JAX package's
sequential solo answers and the port's own sequential solo answers. The
batches are those of ``tests/test_sharedscan.py`` (sales mixed batch,
shared-predicate storm, TPC-H mixed batch over the denormalized table),
written once and built with each package's ``ir`` modules.

Tolerance: dimensions, integers, counts and min/max exact; float sums
rtol 1e-6 (float metrics are stored f32 and the engines sum them in
different orders).
"""

import threading

import numpy as np
import pandas as pd
import pytest

from conftest import make_sales_df

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.ir import spec as JS
from spark_druid_olap_tpu.parallel.executor import QueryEngine as JQueryEngine
from spark_druid_olap_tpu.tools import tpch as jtpch
from spark_druid_olap_tpu.utils.config import Config as JConfig

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.ops import cuda_wave as CW
from spark_druid_olap_tpu_torch.parallel.executor import EngineFallback

FLOAT_RTOL = 1e-6
WINDOW_MS = 500.0
TARGET_ROWS = 4096


def _ms(day: str) -> int:
    return int(pd.Timestamp(day).value // 10**6)


# -- the batches (copied from tests/test_sharedscan.py) -----------------------

def _aggs(S):
    return (S.AggregationSpec("doublesum", "revenue", field="price"),
            S.AggregationSpec("longsum", "units", field="qty"),
            S.AggregationSpec("count", "n"))


def sales_batch(S):
    """Mixed shapes over one datasource: plain GroupBy, filtered GroupBy,
    monthly Timeseries, interval-restricted Timeseries, TopN."""
    aggs = _aggs(S)
    return [
        S.GroupByQuerySpec("sales", (S.DimensionSpec("region", "region"),),
                           aggs),
        S.GroupByQuerySpec("sales", (S.DimensionSpec("flag", "flag"),),
                           aggs, filter=S.SelectorFilter("status", "O")),
        S.TimeseriesQuerySpec("sales", aggs,
                              granularity=S.Granularity("month")),
        S.TimeseriesQuerySpec(
            "sales", aggs,
            intervals=((_ms("2015-03-01"), _ms("2016-02-01")),)),
        S.TopNQuerySpec("sales", S.DimensionSpec("product", "product"),
                        "revenue", 7, aggs),
    ]


def storm_batch(S):
    """Every lane carries the same selector conjunct plus a residual."""
    aggs = _aggs(S)
    shared = S.SelectorFilter("status", "O")
    return [
        S.GroupByQuerySpec("sales", (S.DimensionSpec("region", "region"),),
                           aggs, filter=shared),
        S.GroupByQuerySpec(
            "sales", (S.DimensionSpec("flag", "flag"),), aggs,
            filter=S.LogicalFilter("and", (
                shared, S.SelectorFilter("region", "east")))),
        S.TimeseriesQuerySpec(
            "sales", aggs, granularity=S.Granularity("month"),
            filter=S.LogicalFilter("and", (
                shared, S.BoundFilter("qty", lower=10, numeric=True)))),
        S.TopNQuerySpec("sales", S.DimensionSpec("product", "product"),
                        "revenue", 7, aggs, filter=shared),
    ]


def tpch_batch(S):
    aggs = (S.AggregationSpec("doublesum", "revenue",
                              field="l_extendedprice"),
            S.AggregationSpec("longsum", "qty", field="l_quantity"),
            S.AggregationSpec("count", "n"))
    return [
        S.GroupByQuerySpec("tpch_flat",
                           (S.DimensionSpec("l_returnflag", "l_returnflag"),
                            S.DimensionSpec("l_linestatus", "l_linestatus")),
                           aggs),
        S.GroupByQuerySpec("tpch_flat",
                           (S.DimensionSpec("c_mktsegment", "seg"),),
                           aggs, filter=S.SelectorFilter("l_returnflag", "R")),
        S.TimeseriesQuerySpec("tpch_flat", aggs,
                              granularity=S.Granularity("year")),
        S.TopNQuerySpec("tpch_flat", S.DimensionSpec("p_brand", "p_brand"),
                        "revenue", 5, aggs),
    ]


def sketch_batch(S):
    """The statements of tests/test_pallas_wave.py::
    test_wave_sketch_lanes_match: HLL and theta beside dense aggregates,
    on 4, 3 and 2-3 keys (every theta inside the kernel's stripe)."""
    saggs = (S.AggregationSpec("cardinality", "uprod", field="product"),
             S.AggregationSpec("thetasketch", "tprod", field="product"),
             S.AggregationSpec("longsum", "units", field="qty"),
             S.AggregationSpec("count", "n"))
    return [
        S.GroupByQuerySpec("sales", (S.DimensionSpec("region", "region"),),
                           saggs),
        S.GroupByQuerySpec("sales", (S.DimensionSpec("flag", "flag"),),
                           saggs, filter=S.SelectorFilter("status", "O")),
        S.TimeseriesQuerySpec("sales", saggs,
                              granularity=S.Granularity("year")),
    ]


def split_sketch_batch(S):
    """Theta on 4 keys (inside the kernel) and on 50 (the epilogue: 50 x 64
    slots pass the 256-row stripe cap), HLL over a DOUBLE, KLL under a
    filter, beside dense aggregates."""
    return [
        S.GroupByQuerySpec("sales", (S.DimensionSpec("region", "region"),),
                           (S.AggregationSpec("thetasketch", "t", field="qty"),
                            S.AggregationSpec("count", "n"))),
        S.GroupByQuerySpec("sales", (S.DimensionSpec("product", "product"),),
                           (S.AggregationSpec("thetasketch", "t",
                                              field="price"),
                            S.AggregationSpec("doublesum", "revenue",
                                              field="price"))),
        S.GroupByQuerySpec("sales", (S.DimensionSpec("flag", "flag"),),
                           (S.AggregationSpec("cardinality", "u",
                                              field="price"),
                            S.AggregationSpec("longmax", "m", field="qty"))),
        S.TimeseriesQuerySpec(
            "sales", (S.AggregationSpec("quantile", "p90", field="price",
                                        fraction=0.9),
                      S.AggregationSpec("count", "n")),
            granularity=S.Granularity("month"),
            filter=S.SelectorFilter("status", "F")),
    ]


# -- harness ------------------------------------------------------------------

def run_concurrent(execute, specs):
    """Fire every spec at once (barrier start); frames and errors."""
    n = len(specs)
    res, errs = [None] * n, [None] * n
    bar = threading.Barrier(n)

    def worker(i):
        bar.wait()
        try:
            res[i] = execute(specs[i]).to_pandas()
        except Exception as e:  # noqa: BLE001 — surfaced via errs
            errs[i] = e

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "a storm member never finished"
    return res, errs


def assert_frames_match(got, want, what=""):
    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want), what
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if w.dtype.kind == "f" and not np.array_equal(g, w, equal_nan=True):
            np.testing.assert_allclose(g.astype(np.float64), w, atol=0,
                                       rtol=FLOAT_RTOL, err_msg=f"{what} {c}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {c}")


class Pair:
    """One frame ingested into a JAX store and into port contexts."""

    def __init__(self, name, df, time_column):
        self.jctx = jsdot.Context()
        self.jctx.ingest_dataframe(name, df, time_column=time_column,
                                   target_rows=TARGET_ROWS)
        self.jstore = self.jctx.store
        self.jstorm = JQueryEngine(self.jstore, config=JConfig({
            "sdot.sharedscan.enabled": True,
            "sdot.wlm.batch.window.ms": WINDOW_MS,
            "sdot.wlm.enabled": False, "sdot.pallas.wave.enabled": False}))
        self.jsolo = JQueryEngine(self.jstore, config=JConfig({
            "sdot.sharedscan.enabled": False, "sdot.wlm.enabled": False}))
        self.solo = tsdot.Context(device="cpu")
        self.ds = self.solo.ingest_dataframe(name, df,
                                             time_column=time_column,
                                             target_rows=TARGET_ROWS)

    def storm_ctx(self, **overrides):
        cfg = {"sdot.sharedscan.enabled": True,
               "sdot.wlm.batch.window.ms": WINDOW_MS}
        cfg.update(overrides)
        ctx = tsdot.Context(cfg, device="cpu")
        ctx.store.register(self.ds)
        return ctx


@pytest.fixture(scope="module")
def sales():
    return Pair("sales", make_sales_df(), "ts")


@pytest.fixture(scope="module")
def tpch_flat():
    tables = jtpch.generate(0.002)
    cols = ["l_shipdate", "l_returnflag", "l_linestatus", "c_mktsegment",
            "p_brand", "l_extendedprice", "l_quantity"]
    return Pair("tpch_flat", jtpch.flatten(tables)[cols], "l_shipdate")


def _differential(pair, batch, min_coalesced):
    jspecs, tspecs = batch(JS), batch(TS)
    jsolo = [pair.jsolo.execute(q).to_pandas() for q in jspecs]
    j0 = pair.jstorm.sharedscan.stats()["queries_coalesced"]
    jstorm, jerrs = run_concurrent(pair.jstorm.execute, jspecs)
    assert not any(jerrs), jerrs
    assert pair.jstorm.sharedscan.stats()["queries_coalesced"] - j0 >= 2
    tsolo = [pair.solo.execute(q).to_pandas() for q in tspecs]
    ctx = pair.storm_ctx()
    co = ctx.engine.sharedscan
    tstorm, terrs = run_concurrent(ctx.execute, tspecs)
    assert not any(terrs), terrs
    for i, got in enumerate(tstorm):
        assert_frames_match(got, jstorm[i], f"q{i} vs JAX storm")
        assert_frames_match(got, jsolo[i], f"q{i} vs JAX solo")
        assert_frames_match(got, tsolo[i], f"q{i} vs port solo")
    st = co.stats()
    assert st["queries_coalesced"] >= min_coalesced, st
    assert st["wave_launches"] == 1 and st["wave_fallbacks"] == 0, st
    return st


def test_sales_batch_matches_jax(sales):
    _differential(sales, sales_batch, 4)


def test_storm_batch_matches_jax_and_shares_predicates(sales):
    st = _differential(sales, storm_batch, 4)
    f = st["fusion"]
    assert f["groups"] == 1 and f["plan_fallbacks"] == 0, f
    assert f["shared_predicates"] > 0 and f["predicate_evals_saved"] > 0, f


def test_tpch_batch_matches_jax(tpch_flat):
    _differential(tpch_flat, tpch_batch, 3)


@pytest.mark.parametrize("wave", [True, False])
def test_sketch_lanes_match_the_jax_solo_engine(sales, wave):
    """JAX's sketch-lane storm: estimates equal the JAX engine's solo
    answers exactly, on the wave kernel (its theta stripe) and lane by
    lane. (The JAX package's interpreted wave fails this test on its own
    side, so the JAX solo engine is the oracle.)"""
    specs = sketch_batch(TS)
    jsolo = [sales.jsolo.execute(q).to_pandas() for q in sketch_batch(JS)]
    ctx = sales.storm_ctx(**{"sdot.pallas.wave.enabled": wave})
    got, errs = run_concurrent(ctx.execute, specs)
    assert not any(errs), errs
    for i, (g, w) in enumerate(zip(got, jsolo)):
        assert_frames_match(g, w, f"q{i} vs JAX solo")
    st = ctx.engine.sharedscan.stats()
    assert st["queries_coalesced"] == 3 and st["wave_fallbacks"] == 0, st
    assert st["wave_launches"] == int(wave), st


def test_sketch_storm_splits_theta_between_stripe_and_epilogue(sales):
    """One launch: the 4-key theta in the kernel's stripe, the 50-key
    theta, HLL and KLL in the epilogue; answers equal the JAX engine's
    solo answers and its jaxpr-fused storm's."""
    jspecs, tspecs = split_sketch_batch(JS), split_sketch_batch(TS)
    jsolo = [sales.jsolo.execute(q).to_pandas() for q in jspecs]
    jstorm, jerrs = run_concurrent(sales.jstorm.execute, jspecs)
    assert not any(jerrs), jerrs
    ctx = sales.storm_ctx()
    stats = [None] * len(tspecs)

    def execute(i):
        r = ctx.execute(tspecs[i])
        stats[i] = dict(ctx.engine.last_stats)
        return r

    got, errs = run_concurrent(execute, list(range(len(tspecs))))
    assert not any(errs), errs
    for i, g in enumerate(got):
        assert_frames_match(g, jsolo[i], f"q{i} vs JAX solo")
        assert_frames_match(g, jstorm[i], f"q{i} vs JAX storm")
    st = ctx.engine.sharedscan.stats()
    assert st["queries_coalesced"] == 4 and st["wave_launches"] == 1, st
    assert st["wave_fallbacks"] == 0, st
    wave = stats[0]["sharedscan"]["wave"]
    assert wave["theta_inkernel"] == 1 and wave["sketch_epilogue"] == 3, wave


# -- port-side checks ---------------------------------------------------------

def test_counters_and_member_stats(sales):
    ctx = sales.storm_ctx()
    specs = storm_batch(TS)
    stats = [None] * len(specs)

    def execute(i):
        r = ctx.execute(specs[i])
        stats[i] = dict(ctx.engine.last_stats)
        return r

    _, errs = run_concurrent(lambda i: execute(i), list(range(len(specs))))
    assert not any(errs), errs
    st = ctx.engine.sharedscan.stats()
    assert st["groups_coalesced"] == 1 and st["queries_coalesced"] == 4
    assert st["wave_launches"] == 1 and st["fallbacks"] == 0
    assert st["binds_saved_bytes"] > 0 and st["dispatches_saved"] == 3
    assert {s["route"] for s in stats} == {"wave"}
    assert sorted(s["sharedscan"]["role"] for s in stats) == \
        ["follower"] * 3 + ["leader"]
    wave = stats[0]["sharedscan"]["wave"]
    assert wave["lanes"] == 4 and wave["launches"] == 1
    phases = stats[0]["sharedscan"]["phases_ms"]
    assert set(phases) == {"plan_ms", "program_ms", "dispatch_ms",
                           "demux_ms"}
    assert all(v >= 0 for v in phases.values())
    # a second identical storm reuses the built program
    _, errs = run_concurrent(ctx.execute, specs)
    assert not any(errs), errs
    assert len(ctx.engine._programs) == 1
    assert ctx.engine.sharedscan.stats()["wave_launches"] == 2


def test_wave_switched_off_gives_identical_answers(sales):
    specs = sales_batch(TS)
    on, errs = run_concurrent(sales.storm_ctx().execute, specs)
    assert not any(errs), errs
    ctx = sales.storm_ctx(**{"sdot.pallas.wave.enabled": False})
    off, errs = run_concurrent(ctx.execute, specs)
    assert not any(errs), errs
    for a, b in zip(on, off):
        assert_frames_match(a, b)
    st = ctx.engine.sharedscan.stats()
    assert st["queries_coalesced"] == 5
    assert st["wave_launches"] == 0 and st["wave_fallbacks"] == 0


def test_wave_decline_is_counted_with_its_reason(sales):
    ctx = sales.storm_ctx(**{"sdot.pallas.wave.max.lanes": 2})
    specs = sales_batch(TS)
    got, errs = run_concurrent(ctx.execute, specs)
    assert not any(errs), errs
    want = [sales.solo.execute(q).to_pandas() for q in specs]
    for a, b in zip(got, want):
        assert_frames_match(a, b)
    st = ctx.engine.sharedscan.stats()
    assert st["wave_launches"] == 0 and st["wave_fallbacks"] == 1
    assert list(st["wave_fallback_reasons"]) == \
        ["5 lanes exceed sdot.pallas.wave.max.lanes=2"]


def test_fused_path_error_reaches_every_member(sales, monkeypatch):
    def broken(program, layout, columns):
        raise RuntimeError("wave kernel launch failed: CUDA error 719")

    monkeypatch.setattr(CW, "wave_groupby", broken)
    ctx = sales.storm_ctx()
    specs = storm_batch(TS)
    res, errs = run_concurrent(ctx.execute, specs)
    assert all(r is None for r in res)
    assert all(isinstance(e, RuntimeError) and "CUDA error 719" in str(e)
               for e in errs), errs
    st = ctx.engine.sharedscan.stats()
    assert st["fallbacks"] == 0 and st["queries_coalesced"] == 0


@pytest.mark.parametrize("declined", ["sketch", "spatial_filter"])
def test_declined_member_runs_solo(declined, sales):
    """A sketch over a column kind it does not take (a quantile of a
    string dimension) or a spatial filter (not ported) does not lower: its
    member leaves the group at plan time and raises on its own thread, as
    it does solo; the others still coalesce."""
    ctx = sales.storm_ctx()
    aggs = (TS.AggregationSpec("quantile", "p", field="product"),) \
        if declined == "sketch" else _aggs(TS)
    filt = TS.SpatialFilter("qty_price", ("qty", "price"), (1.0, 10.0),
                            (20.0, 500.0)) \
        if declined == "spatial_filter" else None
    specs = sales_batch(TS)[:3] + [TS.TimeseriesQuerySpec(
        "sales", aggs, filter=filt)]
    res, errs = run_concurrent(ctx.execute, specs)
    assert all(e is None for e in errs[:3]), errs
    if declined == "sketch":
        assert isinstance(errs[3], EngineFallback)
        assert "quantile over" in str(errs[3])
    else:
        assert isinstance(errs[3], NotImplementedError)
        assert "not ported yet" in str(errs[3])
    for got, q in zip(res[:3], specs[:3]):
        assert_frames_match(got, sales.solo.execute(q).to_pandas())
    st = ctx.engine.sharedscan.stats()
    assert st["queries_coalesced"] == 3 and st["fallbacks"] == 1


def test_pattern_filter_member_rides_the_wave(sales):
    """A pattern filter lowers to compares over dictionary codes (a range
    chain), so its member joins the group and the wave kernel's lane
    program, and answers as it does solo."""
    ctx = sales.storm_ctx()
    specs = sales_batch(TS)[:3] + [TS.TimeseriesQuerySpec(
        "sales", _aggs(TS), filter=TS.PatternFilter("product", "like",
                                                    "p0%"))]
    res, errs = run_concurrent(ctx.execute, specs)
    assert not any(errs), errs
    for got, q in zip(res, specs):
        assert_frames_match(got, sales.solo.execute(q).to_pandas())
    st = ctx.engine.sharedscan.stats()
    assert st["queries_coalesced"] == 4 and st["fallbacks"] == 0
    assert st["wave_launches"] == 1 and st["wave_fallbacks"] == 0


def test_union_over_the_device_budget_is_not_ported(sales):
    """A column union over ``sdot.engine.device.cache.bytes`` is no longer
    refused: the key caps the bind cache, not a scan, so the group binds
    in one wave (the cache dropped first) and answers as the JAX solo
    engine does under the same setting."""
    ctx = sales.storm_ctx(**{"sdot.engine.device.cache.bytes": 1024})
    jsolo = JQueryEngine(sales.jstore, config=JConfig({
        "sdot.sharedscan.enabled": False, "sdot.wlm.enabled": False,
        "sdot.engine.device.cache.bytes": 1024}))
    specs = sales_batch(TS)[:2]
    got, errs = run_concurrent(ctx.execute, specs)
    assert not any(errs), errs
    for g, q in zip(got, sales_batch(JS)[:2]):
        assert_frames_match(g, jsolo.execute(q).to_pandas())
    st = ctx.engine.sharedscan.stats()
    assert st["queries_coalesced"] == 2 and st["wave_launches"] == 1, st
    assert len(ctx.engine._device_arrays) == 1
