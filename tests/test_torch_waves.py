"""Multi-wave binding in the port against the JAX package.

A scan whose bound arrays pass ``sdot.engine.wave.max.bytes`` runs as waves
of segments: one launch of the scan's program per wave, each wave padded to
the same segment count, the waves' finals merged on the host. The same
numpy-seeded frames go through a JAX ``Context`` and a port
``Context(device="cpu")`` under the budgets the JAX package's own tests set:
1 byte (one segment per wave; ``tests/test_cost.py``,
``tests/test_hash_groupby.py``) and 1 << 18 (``tests/test_compact.py``).
Checked: the wave planners (``plan_waves``, ``wave_budget_bytes``,
``plan_device_waves``) against the JAX functions on a grid; the dense route
(GroupBy, Timeseries, filtered and not), the sketches' registers, HAVING
and LIMIT on the host, wave-mode compaction and its overflow retry, the
hashed tier with its 4x retry, a tail wave that ``spw`` does not fill, and
the shared-scan storm with the wave kernel on and off: the same ``waves``
as the JAX engine, the same answers and mode.

Tolerance: dimensions, ints, counts, min/max and sketch registers exact;
float sums rtol 1e-6 against the JAX engine (float metrics are stored f32
and the engines sum in different orders), rtol 1e-9 against the port's own
single wave (the waves' float64 finals add in another order).
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.ir import spec as JS
from spark_druid_olap_tpu.parallel import cost as JC
from spark_druid_olap_tpu.parallel import executor as JX
from spark_druid_olap_tpu.parallel.executor import QueryEngine as JQueryEngine
from spark_druid_olap_tpu.planner import fusion as JFU
from spark_druid_olap_tpu.utils.config import Config as JConfig

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.parallel import cost as TC
from spark_druid_olap_tpu_torch.parallel import executor as TX
from spark_druid_olap_tpu_torch.planner import fusion as TFU
from spark_druid_olap_tpu_torch.utils.config import Config as TConfig

from conftest import make_sales_df
from test_torch_sharedscan import run_concurrent, sales_batch, \
    split_sketch_batch
from test_torch_sql import assert_answers_equal

SINGLE_RTOL = 1e-9
TARGET_ROWS = 4096
WAVE_BYTES = "sdot.engine.wave.max.bytes"


# -- the planners -------------------------------------------------------------

PLAN_GRID = [
    # (n_segments, n_dev, seg_bytes, budget, io_budget, io_seg_bytes)
    (0, 1, 100, 1000, None, None),
    (1, 1, 100, None, None, None),
    (58, 1, 1 << 20, None, None, None),
    (58, 1, 1 << 20, 8 << 20, None, None),
    (58, 1, 1 << 20, 1, None, None),
    (7, 1, 300, 1000, None, None),
    (7, 4, 300, 1000, None, None),
    (13, 8, 1 << 10, 5 << 10, None, None),
    (13, 2, 0, 1, None, None),
    (40, 1, 1 << 20, None, 5 << 20, None),
    (40, 4, 1 << 20, 16 << 20, 6 << 20, 1 << 18),
]


@pytest.mark.parametrize("case", PLAN_GRID)
def test_plan_waves_equals_jax(case):
    n, n_dev, seg_bytes, budget, io, io_seg = case
    want = JC.plan_waves(n, n_dev, seg_bytes, budget, JConfig(), 6, 3,
                         io_budget=io, io_seg_bytes=io_seg)
    got = TC.plan_waves(n, n_dev, seg_bytes, budget, TConfig(), 6, 3,
                        io_budget=io, io_seg_bytes=io_seg)
    assert got == want


@pytest.mark.parametrize("budget", [0, 1, 1 << 18, 123_456_789])
def test_wave_budget_bytes_equals_jax(budget):
    """The configured budget wins in both packages; unset, both read no
    budget on the CPU (one wave)."""
    want = JC.wave_budget_bytes(JConfig({WAVE_BYTES: budget}))
    got = TC.wave_budget_bytes(TConfig({WAVE_BYTES: budget}), "cpu")
    assert got == want == (budget or None)


def test_wave_budget_bytes_auto_on_cuda(monkeypatch):
    """Unset on a cuda device: a share of its memory that leaves room for
    two waves in flight beside the bind cache."""
    class Props:
        total_memory = 80 * (1 << 30)
    monkeypatch.setattr(TC.torch.cuda, "get_device_properties",
                        lambda dev: Props())
    got = TC.wave_budget_bytes(TConfig(), "cuda")
    assert got == int(Props.total_memory * TC.CUDA_WAVE_MEMORY_SHARE)
    assert 2 * got < Props.total_memory
    assert TC.wave_budget_bytes(TConfig({WAVE_BYTES: 77}), "cuda") == 77


DEVICE_WAVE_GRID = [
    # (n_segments, spw, n_dev, with row counts)
    (10, 3, 1, False), (10, 3, 1, True), (8, 8, 1, False),
    (12, 4, 2, True), (9, 4, 4, True), (9, 4, 4, False), (1, 2, 1, False),
]


@pytest.mark.parametrize("case", DEVICE_WAVE_GRID)
def test_plan_device_waves_equals_jax(case):
    n, spw, n_dev, with_rows = case
    rng = np.random.default_rng(n * 31 + spw)
    seg = np.sort(rng.choice(3 * n, n, replace=False))
    rows = {int(s): int(r) for s, r in
            zip(seg, rng.integers(0, 1 << 20, n))} if with_rows else None
    want = JFU.plan_device_waves(seg, spw, n_dev, rows)
    got = TFU.plan_device_waves(seg, spw, n_dev, rows)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_tier_hooks_are_off_on_in_memory_stores(tmp_path):
    ds = tsdot.Context(device="cpu").ingest_dataframe(
        "t", make_sales_df(n=100), time_column="ts")
    assert TC.tier_io_budget(ds, TConfig()) is None
    assert TC.tier_io_seg_bytes(ds, ["qty"]) is None
    # on a tiered datasource both hooks answer as the JAX package's do:
    # the configured per-wave I/O cap, and the hot-set bytes one segment
    # faults (compressed bytes on an encoded root)
    seg_bytes = {}
    for encoded in (False, True):
        root = tmp_path / f"enc{int(encoded)}"
        seed = tsdot.Context({"sdot.persist.path": str(root),
                              "sdot.encode.enabled": encoded}, device="cpu")
        seed.ingest_dataframe("t", make_sales_df(n=3000), time_column="ts",
                              target_rows=1024)
        seed.checkpoint()
        seed.close()
        cfg = {"sdot.persist.path": str(root), "sdot.tier.enabled": True,
               "sdot.tier.wave.io.bytes": 1 << 16}
        tctx = tsdot.Context(cfg, device="cpu")
        jctx = jsdot.Context(cfg)
        tds, jds = tctx.store.get("t"), jctx.store.get("t")
        assert TC.tier_io_budget(tds, tctx.config) \
            == JC.tier_io_budget(jds, jctx.config) == 1 << 16
        names = ["qty", "region", "__rows__"]
        got = seg_bytes[encoded] = TC.tier_io_seg_bytes(tds, names)
        assert got == JC.tier_io_seg_bytes(jds, names)
        assert 0 < got <= TC.bytes_per_segment(tds, names[:2])
        tctx.close()
        jctx.close()
    assert seg_bytes[True] < seg_bytes[False]


# -- the engine ---------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    df = make_sales_df()
    jctx, tctx = jsdot.Context(), tsdot.Context(device="cpu")
    for c in (jctx, tctx):
        c.ingest_dataframe("sales", df, time_column="ts",
                           target_rows=TARGET_ROWS)
    return jctx, tctx


def _stats(ctx):
    return dict(ctx.history.entries()[-1].stats)


def _sql(ctx, sql, config):
    old = {k: ctx.config.get(k) for k in config}
    for k, v in config.items():
        ctx.config.set(k, v)
    try:
        return ctx.sql(sql).to_pandas(), _stats(ctx)
    finally:
        for k, v in old.items():
            ctx.config.set(k, v)


def _ordered(sql):
    return "order by" in sql.lower()


def assert_single_wave_equal(got, want, ordered):
    """Multi-wave vs single-wave frames of the port: exact but for float
    columns (rtol 1e-9)."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    if not ordered:
        keys = [c for c in want.columns if want[c].dtype.kind != "f"]
        got = got.sort_values(keys, kind="mergesort").reset_index(drop=True)
        want = want.sort_values(keys, kind="mergesort") \
            .reset_index(drop=True)
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=SINGLE_RTOL, atol=0,
                                       err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


def _waves(pair, sql, **config):
    """The statement in both packages under ``config`` and in the port
    single-wave: ``(port frame, port stats, JAX stats)``; answers, modes
    and wave plans must agree."""
    jctx, tctx = pair
    want, jst = _sql(jctx, sql, config)
    got, tst = _sql(tctx, sql, config)
    single, sst = _sql(tctx, sql, {WAVE_BYTES: 0})
    assert tst["mode"] == jst["mode"], (tst["mode"], jst["mode"])
    assert tst.get("waves") == jst.get("waves"), (tst, jst)
    assert sst.get("waves", 1) == 1
    assert_answers_equal(got, want, _ordered(sql))
    assert_single_wave_equal(got, single, _ordered(sql))
    return got, tst, jst


DENSE = {
    "grouped": "select region, flag, sum(qty) as s, sum(price) as p, "
               "min(price) as mn, max(qty) as mx, count(*) as n "
               "from sales group by region, flag",
    "filtered": "select product, sum(qty) as s, avg(price) as a, "
                "count(*) as n from sales where status = 'O' and qty > 10 "
                "group by product",
    "global": "select sum(price * (1 - discount)) as rev, count(*) as n, "
              "max(price) as mx from sales",
    "global_filtered": "select sum(qty) as s, min(price) as mn, "
                       "count(*) as n from sales where region = 'east' "
                       "and price > 900",
    "monthly": "select month(ts) as m, sum(qty) as s, count(*) as n "
               "from sales where flag <> 'R' group by month(ts)",
    # a row filter no row passes (an expression: no segment is pruned)
    "empty": "select region, count(*) as n, sum(qty) as s from sales "
             "where qty * 2 = 7 group by region",
}


@pytest.mark.parametrize("name", list(DENSE))
def test_dense_waves_equal_the_jax_engine(pair, name):
    got, tst, jst = _waves(pair, DENSE[name], **{WAVE_BYTES: 1})
    assert tst["mode"] == "engine"
    n_seg = pair[1].store.get("sales").num_segments
    assert tst["waves"] == jst["waves"] == n_seg > 1
    assert tst["segments_per_wave"] == jst["segments_per_wave"] == 1
    assert len(tst["wave_steps"]) == n_seg


def _timeseries(S, gran, filt):
    return S.TimeseriesQuerySpec(
        "sales", (S.AggregationSpec("doublesum", "revenue", field="price"),
                  S.AggregationSpec("longsum", "units", field="qty"),
                  S.AggregationSpec("longmin", "lo", field="qty"),
                  S.AggregationSpec("count", "n")),
        granularity=S.Granularity(gran),
        filter=S.SelectorFilter("status", "O") if filt else None)


@pytest.mark.parametrize("gran,filt", [("all", False), ("month", False),
                                       ("week", True), ("all", True)])
def test_timeseries_waves_equal_the_jax_engine(pair, gran, filt):
    jctx, tctx = pair
    budget = {WAVE_BYTES: 1}
    jeng = JQueryEngine(jctx.store, config=JConfig(budget))
    teng = TX.QueryEngine(tctx.store, config=TConfig(budget), device="cpu")
    want = jeng.execute(_timeseries(JS, gran, filt)).to_pandas()
    got = teng.execute(_timeseries(TS, gran, filt)).to_pandas()
    single = tctx.execute(_timeseries(TS, gran, filt)).to_pandas()
    assert teng.last_stats["waves"] == jeng.last_stats["waves"] \
        == tctx.store.get("sales").num_segments
    assert_answers_equal(got, want, ordered=True)
    assert_single_wave_equal(got, single, ordered=True)


def test_tail_wave_that_spw_does_not_fill(pair):
    """Two segments per wave over five: the last wave holds one segment
    and four dead ones' worth of padding."""
    jctx, tctx = pair
    eng = tctx.engine
    ds = tctx.store.get("sales")
    sql = DENSE["grouped"]
    # the statement's bound arrays: region, flag, qty, price, rows
    spec = TS.GroupByQuerySpec(
        "sales", (TS.DimensionSpec("region", "region"),
                  TS.DimensionSpec("flag", "flag")),
        (TS.AggregationSpec("longsum", "s", field="qty"),
         TS.AggregationSpec("doublesum", "p", field="price")))
    seg = ds.prune_segments(None, None)
    names = eng._plan_agg(ds, seg, list(spec.dimensions), spec.aggregations,
                          None, None, None)[5]
    budget = 2 * TC.bytes_per_segment(ds, names)
    got, tst, jst = _waves(pair, sql, **{WAVE_BYTES: budget})
    assert ds.num_segments % 2 == 1
    assert tst["segments_per_wave"] == jst["segments_per_wave"] == 2
    assert tst["waves"] == jst["waves"] == (ds.num_segments + 1) // 2
    assert [s["segments"] for s in tst["wave_steps"]][-1] == 1


def test_wave_pads_with_dead_segments(pair):
    """A wave's arrays are ``spw`` segments: the selected ones, then zero
    segments whose rows are all dead."""
    ds = pair[1].store.get("sales")
    binder = TX._WaveBinder(ds, ["qty", "__rows__"], 3, "cpu")
    (arrays,), step = binder.bind_wave(np.array([4]))
    assert arrays["qty"].shape == (3, ds.padded_rows)
    assert np.array_equal(arrays["qty"][0].numpy(), ds.stacked("qty")[4])
    assert not arrays["__rows__"][1:].any() and not arrays["qty"][1:].any()
    assert step["segments"] == 1
    assert step["h2d_bytes"] == sum(a.numel() * a.element_size()
                                    for a in arrays.values())


SKETCHES = {
    "grouped": "select region, approx_count_distinct(product) as u, "
               "approx_count_distinct_theta(qty) as t, "
               "percentile_approx(price, 0.5) as p50, count(*) as n "
               "from sales group by region",
    "filtered": "select flag, approx_count_distinct(price) as u, "
                "approx_count_distinct_theta(price) as t, "
                "percentile_approx(qty, 0.9) as p90 from sales "
                "where status = 'F' group by flag",
    "global": "select approx_count_distinct(due) as u, "
              "percentile_approx(discount, 0.25) as p25, sum(qty) as s "
              "from sales",
}


@pytest.mark.parametrize("name", list(SKETCHES))
def test_sketch_answers_under_waves(pair, name):
    got, tst, _ = _waves(pair, SKETCHES[name], **{WAVE_BYTES: 1})
    assert tst["mode"] == "engine" and tst["waves"] > 1


def test_sketch_registers_bit_equal_under_waves(pair, monkeypatch):
    """The merged registers of every sketch equal the JAX engine's merged
    registers and the port's single-wave registers, bit for bit."""
    jctx, tctx = pair
    seen = {}

    def spy(pkg, cls):
        real = cls._run_waves

        def run(self, *a, **k):
            finals, over = real(self, *a, **k)
            seen[pkg] = finals
            return finals, over
        monkeypatch.setattr(cls, "_run_waves", run)

    spy("jax", JQueryEngine)
    spy("port", TX.QueryEngine)
    real_finals = TX._finals_from_out

    def single(*a, **k):
        seen["single"] = real_finals(*a, **k)
        return seen["single"]

    sql = ("select region, flag, approx_count_distinct(product) as u, "
           "approx_count_distinct_theta(price) as t, "
           "percentile_approx(qty, 0.5) as p from sales "
           "where qty > 3 group by region, flag")
    _sql(jctx, sql, {WAVE_BYTES: 1})
    _sql(tctx, sql, {WAVE_BYTES: 1})
    monkeypatch.setattr(TX, "_finals_from_out", single)
    _sql(tctx, sql, {WAVE_BYTES: 0})
    assert tctx.history.entries()[-1].stats.get("waves") == 1
    for name in ("u", "t", "p"):
        got = np.asarray(seen["port"][name])
        want = np.asarray(seen["jax"][name])
        one = np.asarray(seen["single"][name])
        if name == "t":
            want = want.astype(np.float32)
        assert got.shape == one.shape and got.ndim == 2, name
        assert np.array_equal(got.view(np.int32), want.reshape(got.shape)
                              .view(np.int32)), name
        assert np.array_equal(got.view(np.int32), one.view(np.int32)), name


HOST_EPILOGUE = {
    # an exact HAVING over a key space past the device-HAVING threshold
    "having": ("select product, region, count(*) as n, sum(qty) as s "
               "from sales group by product, region having count(*) > 100",
               {"sdot.engine.having.device.min.keys": 16}),
    # an ordered limit past the device top-k threshold
    "limit": ("select product, region, flag, sum(qty) as s, "
              "count(*) as n from sales group by product, region, flag "
              "order by s desc limit 7",
              {"sdot.engine.topn.device.min.keys": 16}),
    "having_limit": ("select product, sum(price) as p from sales "
                     "group by product having sum(qty) > 100 "
                     "order by p desc limit 5",
                     {"sdot.engine.having.device.min.keys": 16,
                      "sdot.engine.topn.device.min.keys": 16}),
}


@pytest.mark.parametrize("name", list(HOST_EPILOGUE))
def test_having_and_limit_stay_on_the_host_under_waves(pair, name):
    sql, config = HOST_EPILOGUE[name]
    # one wave: the device epilogue engages in both packages
    _, one, jone = _waves(pair, sql, **config)
    key = "topk_device" if name == "limit" else "having_device"
    assert one[key] == jone[key] > 0
    got, tst, jst = _waves(pair, sql, **config, **{WAVE_BYTES: 1})
    assert tst["waves"] > 1
    for k in ("having_device", "topk_device"):
        assert tst.get(k, 0) == jst.get(k, 0) == 0, k


# -- wave-mode late materialization (tests/test_compact.py's frame) -----------

def _compact_frame(n=60_000):
    rng = np.random.default_rng(13)
    return pd.DataFrame({
        "region": rng.choice(["east", "west", "north", "south"], n),
        "sku": rng.choice([f"sku{i:03d}" for i in range(50)], n),
        "qty": rng.integers(0, 100, n),
        "price": np.round(rng.random(n) * 50, 2),
    })


COMPACT_SQL = ("select region, sum(qty) as s, min(price) as mn, "
               "count(*) as n from wsales where sku = 'sku007' "
               "group by region order by region")


@pytest.fixture(scope="module")
def wave_pair():
    df = _compact_frame()
    out = []
    for pkg in (jsdot, tsdot):
        c = pkg.Context() if pkg is jsdot else pkg.Context(device="cpu")
        c.config.set("sdot.engine.scan.compact.min.rows", 0)
        c.config.set(WAVE_BYTES, 1 << 18)
        c.ingest_dataframe("wsales", df, target_rows=4096)
        out.append(c)
    return tuple(out)


def test_wave_mode_compaction(wave_pair):
    got, tst, jst = _waves(wave_pair, COMPACT_SQL)
    assert tst["waves"] == jst["waves"] > 1
    assert tst["compact_m"] == jst["compact_m"] > 0
    assert "compact_overflow" not in tst
    plain, _ = _sql(wave_pair[1], COMPACT_SQL,
                    {"sdot.engine.scan.compact": False})
    assert_single_wave_equal(got, plain, ordered=True)


def test_wave_mode_compaction_overflow_retries(wave_pair, monkeypatch):
    """A per-wave budget that lies (~0 survivors estimated) ends the
    compacted run at its first wave, re-runs the scan uncompacted and
    memoizes the shape (``aggw``)."""
    monkeypatch.setattr(JC, "_filter_selectivity", lambda f, ds: 1e-6)
    monkeypatch.setattr(TC, "_filter_selectivity", lambda f, ds: 1e-6)
    jctx, tctx = wave_pair
    got, tst, jst = _waves(wave_pair, COMPACT_SQL.replace("sku007",
                                                          "sku011"))
    assert tst["waves"] == jst["waves"] > 1
    assert tst["compact_overflow"] == jst["compact_overflow"] > 0
    assert "compact_m" not in tst
    assert any(m[0] == "aggw" for m in tctx.engine._compact_overflowed)


# -- the hashed tier ----------------------------------------------------------

HASHED = {"sdot.engine.groupby.dense.max.keys": 16}


@pytest.mark.parametrize("sorted_run", ["off", "on"])
def test_hashed_waves_equal_the_jax_engine(pair, sorted_run):
    sql = ("select product, region, sum(qty) as s, sum(price) as p, "
           "min(price) as mn, max(qty) as mx, count(*) as n from sales "
           "where status = 'O' group by product, region")
    got, tst, jst = _waves(pair, sql, **HASHED, **{
        WAVE_BYTES: 1, "sdot.engine.groupby.hash.sortedrun": sorted_run})
    assert tst["hashed"] and jst["hashed"]
    assert tst["waves"] == jst["waves"] > 1
    assert tst["hash_slots"] == jst["hash_slots"]


def test_hashed_waves_retry_at_four_times_the_slots(pair):
    """A table too small for a wave's groups retries the whole scan at 4x
    slots, in both engines."""
    sql = ("select product, region, flag, sum(qty) as s, count(*) as n "
           "from sales group by product, region, flag")
    got, tst, jst = _waves(pair, sql, **HASHED, **{
        WAVE_BYTES: 1, "sdot.engine.groupby.hash.slots": 64})
    assert tst["waves"] == jst["waves"] > 1
    assert tst["hash_slots"] == jst["hash_slots"] > 64


def test_hashed_waves_compact_their_tables(pair):
    """Each wave's table compacts on the device (two dispatches) before
    its partial travels; the ordered limit merges on the host."""
    sql = ("select product, region, flag, sum(qty) as s, count(*) as n "
           "from sales group by product, region, flag "
           "order by s desc limit 9")
    got, tst, jst = _waves(pair, sql, **HASHED, **{
        WAVE_BYTES: 1, "sdot.engine.groupby.hash.compact.min.slots": 16,
        "sdot.engine.topn.device.min.keys": 16})
    assert tst["waves"] == jst["waves"] > 1
    assert tst["hash_compact_k"] == jst["hash_compact_k"] > 0
    assert tst.get("topk_device", 0) == jst.get("topk_device", 0) == 0


def test_merge_hash_partials_equals_jax():
    """The key-wise merge against the JAX package's (``np.*.at`` over
    ``np.unique``) on seeded partials with repeated keys."""
    rng = np.random.default_rng(5)
    metas = [TX.G.AggInput("s", "sum", is_int=True),
             TX.G.AggInput("f", "sum"),
             TX.G.AggInput("lo", "min", is_int=True),
             TX.G.AggInput("hi", "max")]
    routes = TX.G.plan_routes(metas)
    parts = []
    for n in (40, 1, 17):
        keys = rng.choice(60, n, replace=False).astype(np.int64)
        parts.append((keys, {
            "s": rng.integers(-2**40, 2**40, n),
            "f": rng.standard_normal(n),
            "lo": rng.integers(-100, 100, n),
            "hi": rng.standard_normal(n)}))
    keys, merged = TX._merge_hash_partials(parts, routes)
    jkeys, jmerged = JX._merge_hash_partials(parts, routes)
    assert np.array_equal(keys, jkeys)
    for name in routes:
        if name == "f":
            np.testing.assert_allclose(merged[name], jmerged[name],
                                       rtol=1e-12)
        else:
            assert np.array_equal(merged[name], jmerged[name]), name


# -- the shared-scan storm ----------------------------------------------------

@pytest.fixture(scope="module")
def storm_pair():
    df = make_sales_df()
    jctx = jsdot.Context()
    jctx.ingest_dataframe("sales", df, time_column="ts",
                          target_rows=TARGET_ROWS)
    tsolo = tsdot.Context(device="cpu")
    ds = tsolo.ingest_dataframe("sales", df, time_column="ts",
                                target_rows=TARGET_ROWS)
    return jctx.store, ds


@pytest.mark.parametrize("wave_kernel", [True, False])
@pytest.mark.parametrize("batch", [sales_batch, split_sketch_batch])
def test_storm_under_waves_equals_the_jax_engine(storm_pair, batch,
                                                 wave_kernel):
    jstore, ds = storm_pair
    budget = {WAVE_BYTES: 1, "sdot.sharedscan.enabled": True,
              "sdot.wlm.batch.window.ms": 500.0}
    jstorm = JQueryEngine(jstore, config=JConfig(dict(
        budget, **{"sdot.wlm.enabled": False,
                   "sdot.pallas.wave.enabled": False})))
    jsolo = JQueryEngine(jstore, config=JConfig({
        WAVE_BYTES: 1, "sdot.sharedscan.enabled": False,
        "sdot.wlm.enabled": False}))
    storm = tsdot.Context(dict(budget, **{
        "sdot.pallas.wave.enabled": wave_kernel}), device="cpu")
    storm.store.register(ds)
    jspecs, tspecs = batch(JS), batch(TS)
    want = [jsolo.execute(q).to_pandas() for q in jspecs]
    jwaves = []

    def jrun(q):
        r = jstorm.execute(q)
        jwaves.append(jstorm.last_stats.get("waves"))
        return r

    _, jerrs = run_concurrent(jrun, jspecs)
    assert not any(jerrs), jerrs
    twaves = []

    def trun(q):
        r = storm.execute(q)
        twaves.append(storm.engine.last_stats.get("waves"))
        return r

    got, errs = run_concurrent(trun, tspecs)
    assert not any(errs), errs
    for i, (g, w) in enumerate(zip(got, want)):
        assert_answers_equal(g, w, ordered=True)
    st = storm.engine.sharedscan.stats()
    assert st["queries_coalesced"] == len(tspecs), st
    n_waves = ds.num_segments
    assert sorted(twaves) == sorted(jwaves) == [n_waves] * len(tspecs)
    if wave_kernel:
        assert st["wave_launches"] == n_waves and st["wave_fallbacks"] == 0
    else:
        assert st["wave_launches"] == 0
