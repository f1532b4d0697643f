"""The port's explain cost model and calibration against the JAX package's.

``parallel/cost.estimate`` (rows, selectivity, groups, the single-device
price, the one-device ``sharded(1)`` price, scan bytes and the wave plan),
``CostEstimate.table`` and ``explain_cost`` (with the late-materialization
line of ``_explain_scan_plan``) run over the same specs in both packages:
the sales frame and TPC-H SF 0.01's flat star (``tests/test_torch_sql.py``'s
fixture), each spec planned by its own package, with no wave budget, with
one that splits the scans into waves, and with compaction forced. The JAX
contexts run on one device with no mesh, so their cross-host and
interconnect terms are zero, as the port's are. Every field and every
line of text is equal, but one deliberate departure (ROADMAP §C): the
``waves=NxM`` that the port's explain prints is the executor's own plan,
over the arrays it binds, which the test holds against the executed
statements' waves; the JAX package prints its estimate's.

From JAX ``tests/test_cost.py``: the least-squares fit recovers known
constants and equals the JAX package's fit on the same samples, the
sharded terms included (``test_fit_recovers_known_constants``);
``calibrate`` on the CPU fits positive constants and applies them, with a
mesh context the sharded ones too. The sharded decision over a mesh (the
JAX engine's emulated 8 devices, the port's ``("cpu",) * 8``): the
estimate's fields and interconnect bytes equal JAX's; ``plan_waves``
keeps waves a multiple of the mesh; a sharded scan in waves answers as
one device. The mesh pricing of a fused group (``mesh_estimate``)
equals JAX's in every case of its tests.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import dataclasses
import re

import pandas as pd
import pytest

from spark_druid_olap_tpu.parallel import cost as JC
from spark_druid_olap_tpu.planner.plans import PlanUnsupported as JUnsup
from spark_druid_olap_tpu.tools import calibrate as JCAL
from spark_druid_olap_tpu.tools import tpch as jtpch

from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.parallel import cost as TC
from spark_druid_olap_tpu_torch.planner.plans import PlanUnsupported as TUnsup
from spark_druid_olap_tpu_torch.tools import calibrate as TCAL
from spark_druid_olap_tpu_torch.utils.config import (
    COST_PER_BYTE_TRANSPORT, COST_PER_ROW_MERGE, COST_PER_ROW_SCAN,
    COST_SHARD_EFFICIENCY)

from conftest import make_sales_df
from test_torch_sql import _jax_plan, _port_plan, flat_pair  # noqa: F401

FIELDS = ("rows", "selectivity", "output_groups", "single_cost",
          "sharded_cost", "n_devices", "recommend_sharded", "scan_bytes",
          "segments_per_wave", "n_waves")

# no wave budget (one wave on the CPU, as in the JAX package), a budget
# that splits every scan into waves, and compaction forced
SETTINGS = {
    "one_wave": {},
    "waves": {"sdot.engine.wave.max.bytes": 1 << 14},
    "compact": {"sdot.engine.scan.compact.min.rows": 0},
}

SALES_SQL = [
    "select region, sum(qty) as s, count(*) as n from sales group by region",
    "select product, sum(price) as rev from sales where status = 'O' "
    "group by product order by rev desc limit 7",
    "select flag, count(*) as n from sales where qty >= 25 and "
    "region in ('east', 'west') group by flag",
    "select year(ts) as y, sum(price) as p from sales "
    "where ts >= '2015-06-01' group by year(ts)",
]

TPCH = sorted(jtpch.QUERIES)


class _Configured:
    """Both contexts with ``cfg`` set, restored on exit."""

    def __init__(self, pair, cfg):
        self.pair, self.cfg = pair, cfg

    def __enter__(self):
        self.old = [{k: c.config.get(k) for k in self.cfg}
                    for c in self.pair]
        for c in self.pair:
            for k, v in self.cfg.items():
                c.config.set(k, v)
        return self.pair

    def __exit__(self, *exc):
        for c, old in zip(self.pair, self.old):
            for k, v in old.items():
                c.config.set(k, v)


def _specs(pair, sql):
    jctx, tctx = pair
    try:
        jpq = _jax_plan(jctx, sql)
    except JUnsup:
        jpq = None
    try:
        tpq = _port_plan(tctx, sql)
    except TUnsup:
        tpq = None
    assert (jpq is None) == (tpq is None), sql
    if jpq is None:
        return []
    assert len(jpq.specs) == len(tpq.specs)
    return list(zip(jpq.specs, tpq.specs))


def _check_specs(pair, sql):
    jctx, tctx = pair
    n = 0
    for jq, tq in _specs(pair, sql):
        je, te = JC.estimate(jctx, jq), TC.estimate(tctx, tq)
        for f in FIELDS:
            assert getattr(te, f) == getattr(je, f), (sql, f)
        assert te.table() == je.table(), sql
        # explain's wave plan is the executor's (ROADMAP §C); the rest of
        # its text is the JAX package's
        got, want = TC.explain_cost(tctx, tq), JC.explain_cost(jctx, jq)
        assert _no_waves(got) == _no_waves(want), sql
        n += 1
    return n


WAVES = re.compile(r"  waves=(\d+)x(\d+)seg")


def _no_waves(text):
    return WAVES.sub("", text)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_estimate_and_table_equal_the_jax_engine_sales(flat_pair, setting):
    with _Configured(flat_pair, SETTINGS[setting]) as pair:
        assert sum(_check_specs(pair, s) for s in SALES_SQL) \
            == len(SALES_SQL)
        if setting == "waves":
            est = TC.estimate(pair[1], _specs(pair, SALES_SQL[0])[0][1])
            assert est.n_waves > 1
            assert f"waves={est.n_waves}x{est.segments_per_wave}seg" \
                in est.table()


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_estimate_and_table_equal_the_jax_engine_tpch(flat_pair, setting):
    with _Configured(flat_pair, SETTINGS[setting]) as pair:
        n = sum(_check_specs(pair, jtpch.QUERIES[name]) for name in TPCH)
        assert n >= len(TPCH) // 2


EXPLAINED = ["q1", "q3", "q6", "q12", "q14", "q19"]


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("name", EXPLAINED)
def test_explain_text_equals_the_jax_text(flat_pair, setting, name):
    with _Configured(flat_pair, SETTINGS[setting]) as (jctx, tctx):
        sql = jtpch.QUERIES[name]
        got, want = tctx.explain(sql), jctx.explain(sql)
        if setting == "waves":
            # the wave plan is the executor's in the port (ROADMAP §C)
            got, want = _no_waves(got), _no_waves(want)
        assert got == want
        assert "single-chip cost=" in got and "sharded(1)=" in got
        if setting == "compact" and name in ("q6", "q12"):
            assert "scan: late-materialize to [" in got


@pytest.mark.parametrize("name", EXPLAINED + ["shipdate_range"])
def test_explain_waves_equal_the_executed_plan(flat_pair, name):
    """Under a wave budget, each spec's ``waves=NxM`` in the port's
    explain is the plan its execution takes; one wave prints none."""
    with _Configured(flat_pair, SETTINGS["waves"]) as (_, tctx):
        sql = jtpch.QUERIES[name]
        text = tctx.explain(sql)
        tctx.sql(sql)
        st = tctx.history.entries()[-1].stats
        if "waves" not in st:
            pytest.fail(f"{name}: no wave plan in the statement's stats")
        printed = [(int(a), int(b)) for a, b in WAVES.findall(text)]
        if st["waves"] > 1:
            assert (st["waves"], st["segments_per_wave"]) in printed, text
        else:
            assert not printed, text


def test_wave_plan_is_the_hashed_route_plan_too(flat_pair):
    """``QueryEngine.wave_plan`` is the plan execution takes on the
    hashed route as well (its waves price the first table, not the key
    space), and explain prints it."""
    cfg = {**SETTINGS["waves"], "sdot.engine.groupby.dense.max.keys": 4}
    with _Configured(flat_pair, cfg) as (_, tctx):
        sql = SALES_SQL[1]
        tq = _port_plan(tctx, sql).specs[0]
        plan = tctx.engine.wave_plan(tq)
        tctx.execute(tq)
        st = tctx.engine.last_stats
        assert st["waves"] > 1, st
        assert plan == (st["segments_per_wave"], st["waves"])
        assert f"waves={plan[1]}x{plan[0]}seg" in TC.explain_cost(tctx, tq)


def test_explain_shows_a_wave_plan_it_cannot_make(flat_pair, monkeypatch):
    """Where the engine cannot plan the scan, explain prints ``waves=?``
    and the error, not the estimate's plan."""
    _, tctx = flat_pair
    tq = _port_plan(tctx, SALES_SQL[0]).specs[0]

    def broken(self, q):
        raise KeyError("l_nothing")
    monkeypatch.setattr(type(tctx.engine), "wave_plan", broken)
    text = TC.explain_cost(tctx, tq)
    assert "waves=? (KeyError: 'l_nothing')" in text, text
    assert not WAVES.search(text)


def test_fit_recovers_known_constants():
    """The least-squares fit inverts the model: synthetic timings built
    FROM known constants fit back to those constants, in both packages
    alike, on one device (samples with sharded timings fit the same
    there: the fit reads them only for ``n_dev`` > 1) and over 8 slots,
    where the merge cost and the parallel efficiency come back too."""
    scan_c, byte_c, merge_c, eff, n_dev = 2e-9, 5e-10, 4e-8, 0.25, 8
    samples = []
    for rows, groups, naggs in ((6_000_000, 10, 2), (1_500_000, 5000, 3),
                                (9_000_000, 200, 1), (3_000_000, 40, 2)):
        single = rows * scan_c + groups * 16 * byte_c
        sharded = rows * scan_c / (n_dev * eff) \
            + groups * naggs * merge_c + groups * 16 * byte_c
        samples.append({"rows": rows, "groups": groups, "n_aggs": naggs,
                        "single_s": single, "sharded_s": sharded})
    single_only = [{k: v for k, v in s.items() if k != "sharded_s"}
                   for s in samples]
    got = TCAL.fit(single_only)
    assert got == JCAL.fit(single_only, 1) == TCAL.fit(samples, 1) \
        == JCAL.fit(samples, 1)
    assert abs(got[COST_PER_ROW_SCAN.key] - scan_c) / scan_c < 1e-6
    assert abs(got[COST_PER_BYTE_TRANSPORT.key] - byte_c) / byte_c < 1e-4
    assert set(got) == {
        COST_PER_ROW_SCAN.key, COST_PER_BYTE_TRANSPORT.key,
        "sdot.querycostmodel.compile.cost"}
    got8 = TCAL.fit(samples, n_dev)
    assert got8 == JCAL.fit(samples, n_dev)
    assert abs(got8[COST_PER_ROW_MERGE.key] - merge_c) / merge_c < 1e-4
    assert abs(got8[COST_SHARD_EFFICIENCY.key] - eff) / eff < 1e-4


def test_default_shapes_equal_the_jax_shapes(flat_pair):
    jctx, tctx = flat_pair
    for name in ("sales", "tpch_flat"):
        js = JCAL.default_shapes(name, jctx.store.get(name))
        ts = TCAL.default_shapes(name, tctx.store.get(name))
        assert [repr(dataclasses.asdict(s)) for s in ts] \
            == [repr(dataclasses.asdict(s)) for s in js]


def test_calibrate_fits_single_device_terms(flat_pair):
    _, tctx = flat_pair
    old = {k: tctx.config.get(k) for k in (
        COST_PER_ROW_SCAN.key, COST_PER_BYTE_TRANSPORT.key,
        "sdot.querycostmodel.compile.cost")}
    try:
        fitted = TCAL.calibrate(tctx, "sales", reps=1)
        assert fitted[COST_PER_ROW_SCAN.key] > 0
        assert fitted[COST_PER_BYTE_TRANSPORT.key] > 0
        for k, v in fitted.items():
            assert tctx.config.get(k) == v
        samples = TCAL.measure_samples(
            tctx.engine, None,
            TCAL.default_shapes("sales", tctx.store.get("sales")), reps=1)
        assert [s["rows"] for s in samples] == [20_000] * 3
        assert all(s["single_s"] > 0 for s in samples)
    finally:
        for k, v in old.items():
            tctx.config.set(k, v)
    # the sharded side: a mesh context's probes really shard (its cost
    # model is off while they run), and the sharded terms fit
    from spark_druid_olap_tpu_torch import Context
    from spark_druid_olap_tpu_torch.parallel.mesh import make_mesh
    mctx = Context(mesh=make_mesh(devices=("cpu",) * 8))
    mctx.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                          target_rows=2048)
    fitted = TCAL.calibrate(tctx, "sales", reps=1, mesh_ctx=mctx,
                            apply=False)
    assert fitted[COST_PER_ROW_MERGE.key] > 0
    assert 0.01 <= fitted[COST_SHARD_EFFICIENCY.key] <= 1.0
    assert mctx.config.get("sdot.querycostmodel.enabled") is True
    mctx.config.set("sdot.querycostmodel.enabled", False)
    samples = TCAL.measure_samples(
        tctx.engine, mctx.engine,
        TCAL.default_shapes("sales", tctx.store.get("sales")), reps=1)
    assert all(s["sharded_really"] and s["sharded_s"] > 0 for s in samples)


def test_estimate_of_a_spec_built_by_hand(flat_pair):
    """A QuerySpec through ``Context.execute``'s surface: the estimate
    reads its intervals, filter and aggregations as the JAX one does."""
    from spark_druid_olap_tpu.ir import spec as JS
    jctx, tctx = flat_pair

    def q(S):
        return S.GroupByQuerySpec(
            datasource="sales",
            dimensions=(S.DimensionSpec("region", "region"),),
            aggregations=(S.AggregationSpec("longsum", "s", field="qty"),
                          S.AggregationSpec("count", "n")),
            filter=S.BoundFilter("qty", lower="10", upper="60"),
            intervals=((1420070400000, 1451606400000),))
    je, te = JC.estimate(jctx, q(JS)), TC.estimate(tctx, q(TS))
    for f in FIELDS:
        assert getattr(te, f) == getattr(je, f), f
    assert te.rows < 20_000 and te.n_devices == 1
    assert not te.recommend_sharded


# -- the sharded decision and the mesh pricing ----------------------------------

def _mesh_pair():
    from spark_druid_olap_tpu.parallel.mesh import make_mesh as jmesh
    from spark_druid_olap_tpu.parallel.executor import QueryEngine as JQE
    from spark_druid_olap_tpu.segment.ingest import \
        ingest_dataframe as jingest
    from spark_druid_olap_tpu.segment.store import SegmentStore as JStore
    from spark_druid_olap_tpu.utils.config import Config as JConfig
    from spark_druid_olap_tpu_torch.parallel.executor import \
        QueryEngine as TQE
    from spark_druid_olap_tpu_torch.parallel.mesh import make_mesh
    from spark_druid_olap_tpu_torch.segment.ingest import \
        ingest_dataframe as tingest
    from spark_druid_olap_tpu_torch.segment.store import \
        SegmentStore as TStore
    from spark_druid_olap_tpu_torch.utils.config import Config as TConfig
    df = make_sales_df()
    js, ts = JStore(), TStore()
    js.register(jingest("sales", df, time_column="ts", target_rows=4096))
    ts.register(tingest("sales", df, time_column="ts", target_rows=4096))

    def engines(cfg):
        return (JQE(js, config=JConfig(dict(cfg)), mesh=jmesh()),
                TQE(ts, config=TConfig(dict(cfg)), device="cpu",
                    mesh=make_mesh(devices=("cpu",) * 8)))
    return engines


def _sales_q(S):
    return S.GroupByQuerySpec(
        datasource="sales",
        dimensions=(S.DimensionSpec("region", "region"),),
        aggregations=(S.AggregationSpec("longsum", "s", field="qty"),
                      S.AggregationSpec("count", "n")))


@pytest.mark.parametrize("cfg", [
    {}, {"sdot.querycostmodel.compile.cost": 0.0},
    {"sdot.querycostmodel.enabled": False}],
    ids=["small_scan_single", "steady_state_sharded", "model_off"])
def test_sharded_decision_equals_the_jax_engine(cfg):
    """Over a mesh the estimate prices the scan split, the merge and the
    interconnect bytes as JAX's does, and the decision is the same."""
    from spark_druid_olap_tpu.ir import spec as JS
    jeng, teng = _mesh_pair()(cfg)
    je, te = JC.estimate(jeng, _sales_q(JS)), TC.estimate(teng, _sales_q(TS))
    for f in FIELDS + ("ici_bytes", "xhost_bytes"):
        assert getattr(te, f) == getattr(je, f), f
    assert te.table() == je.table()
    assert te.n_devices == 8
    assert te.ici_bytes == te.output_groups * 2 * 8 * 7
    assert te.recommend_sharded == (cfg != {})
    # the engine takes the decision the estimate makes
    teng.execute(_sales_q(TS))
    st = teng.last_stats
    assert st["sharded"] is te.recommend_sharded
    verdict = "sharded" if te.recommend_sharded else "single"
    assert st["shard_decision"] == f"cost:{verdict}"


def test_plan_waves_multiple_of_mesh():
    from spark_druid_olap_tpu_torch.utils.config import Config as TConfig
    conf = TConfig()
    for args in ((16, 4, 1000, 2500), (9, 8, 1000, None),
                 (8, 1, 1000, 2500), (32, 1, 1000, 1_000_000)):
        got = TC.plan_waves(*args, conf, 100, 2)
        assert got == JC.plan_waves(*args, conf, 100, 2)
        assert got[0] % args[1] == 0
    assert TC.plan_waves(9, 8, 1000, None, conf, 100, 2) == (16, 1)


def test_wave_execution_sharded():
    """A sharded scan in waves (one segment per slot per wave) answers
    as one device; a wave is a multiple of the mesh."""
    from spark_druid_olap_tpu_torch.parallel.executor import \
        QueryEngine as TQE
    from spark_druid_olap_tpu_torch.parallel.mesh import make_mesh
    from spark_druid_olap_tpu_torch.segment.ingest import \
        ingest_dataframe as tingest
    from spark_druid_olap_tpu_torch.segment.store import \
        SegmentStore as TStore
    from spark_druid_olap_tpu_torch.utils.config import Config as TConfig
    st = TStore()
    st.register(tingest("sales", make_sales_df(), time_column="ts",
                        target_rows=512))
    assert st.get("sales").num_segments > 16
    engw = TQE(st, config=TConfig({"sdot.querycostmodel.enabled": False,
                                   "sdot.engine.wave.max.bytes": 1}),
               device="cpu", mesh=make_mesh(devices=("cpu",) * 8))
    got = engw.execute(_sales_q(TS)).to_pandas()
    assert engw.last_stats["sharded"] is True
    assert engw.last_stats["waves"] > 1
    assert engw.last_stats["segments_per_wave"] % 8 == 0
    want = TQE(st, device="cpu").execute(_sales_q(TS)).to_pandas()
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


MESH_ESTIMATES = [
    ({"sdot.querycostmodel.compile.cost": 0.0},
     dict(n_dev=8, rows=50_000_000, groups=64, n_aggs=4,
          merge_bytes=64 * 4 * 8 * 7)),
    ({}, dict(n_dev=8, rows=20_000, groups=8, n_aggs=2,
              merge_bytes=8 * 2 * 8 * 7)),
    ({"sdot.querycostmodel.compile.cost": 0.0},
     dict(n_dev=1, rows=50_000_000, groups=8, n_aggs=2, merge_bytes=0)),
    ({"sdot.querycostmodel.enabled": False},
     dict(n_dev=8, rows=100, groups=8, n_aggs=2, merge_bytes=1 << 20)),
]


@pytest.mark.parametrize("cfg,kw", MESH_ESTIMATES,
                         ids=["large_sharded", "small_single", "one_device",
                              "model_off"])
def test_mesh_estimate_equals_jax(cfg, kw):
    from spark_druid_olap_tpu.utils.config import Config as JConfig
    from spark_druid_olap_tpu_torch.utils.config import Config as TConfig
    got = TC.mesh_estimate(TConfig(dict(cfg)), **kw)
    want = JC.mesh_estimate(JConfig(dict(cfg)), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_mesh_estimate_interconnect_term_is_linear_and_can_flip():
    from spark_druid_olap_tpu_torch.utils.config import Config as TConfig
    cfg = TConfig({"sdot.querycostmodel.compile.cost": 0.0})
    icx = float(cfg.get("sdot.querycostmodel.interconnect.cost"))
    base = TC.mesh_estimate(cfg, n_dev=8, rows=1_000_000, groups=64,
                            n_aggs=2, merge_bytes=0)
    assert base.recommend_sharded
    extra = 2 * int((base.single_cost - base.sharded_cost) / icx)
    wide = TC.mesh_estimate(cfg, n_dev=8, rows=1_000_000, groups=64,
                            n_aggs=2, merge_bytes=extra)
    assert wide.sharded_cost == pytest.approx(base.sharded_cost + extra * icx)
    assert not wide.recommend_sharded
    assert wide.single_cost == base.single_cost


@pytest.mark.parametrize("devices,cards", [
    (("cpu",) * 8, 8), (("cuda:0", "cuda:0"), 1),
    (("cuda:0", "cuda:1"), 2), (("cuda:0", "cuda:1", "cuda:0", "cuda:1"), 2),
    (None, 1)],
    ids=["cpu_slots", "two_slots_one_card", "two_cards",
         "four_slots_two_cards", "no_mesh"])
def test_scan_devices_counts_cards(devices, cards):
    """A scan splits across distinct cards; a CPU slot counts as one
    device, as the JAX package's emulated host devices do."""
    import torch
    from spark_druid_olap_tpu_torch.parallel.mesh import scan_devices
    mesh = None if devices is None else tuple(map(torch.device, devices))
    assert scan_devices(mesh) == cards


def test_slots_sharing_one_card_never_price_below_one_device():
    """Two slots on one card split no scan: with the cost model on, the
    estimate never recommends them, however large the scan; on two cards
    the same scan shards, and with the model off both shard."""
    from spark_druid_olap_tpu_torch.utils.config import Config as TConfig
    kw = dict(n_dev=2, rows=500_000_000, groups=8, n_aggs=2,
              merge_bytes=8 * 2 * 8)
    cfg = TConfig({"sdot.querycostmodel.compile.cost": 0.0})
    one_card = TC.mesh_estimate(cfg, scan_devices=1, **kw)
    two_cards = TC.mesh_estimate(cfg, scan_devices=2, **kw)
    assert not one_card.recommend_sharded
    assert one_card.sharded_cost > one_card.single_cost
    assert two_cards.recommend_sharded
    assert two_cards == TC.mesh_estimate(cfg, **kw)
    off = TConfig({"sdot.querycostmodel.enabled": False})
    assert TC.mesh_estimate(off, scan_devices=1, **kw).recommend_sharded
