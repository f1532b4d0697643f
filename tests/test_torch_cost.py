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
constants and equals the JAX package's fit on the same samples
(``test_fit_recovers_known_constants``); ``calibrate`` on the CPU fits
positive single-device constants and applies them; its sharded side
(``mesh_ctx``) raises ROADMAP A.8. The JAX cases of the sharded decision
and of the mesh pricing wait for A.8.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import dataclasses
import re

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
    COST_PER_BYTE_TRANSPORT, COST_PER_ROW_SCAN)

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
    alike, on one device; samples with sharded timings fit the same there
    (the JAX fit reads them only for ``n_dev`` > 1), and the port's
    sharded fit raises ROADMAP A.8."""
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
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.8"):
        TCAL.fit(samples, n_dev)


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
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.8"):
        TCAL.calibrate(tctx, "sales", mesh_ctx=tctx)
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.8"):
        TCAL.measure_samples(tctx.engine, tctx.engine, [], reps=1)


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
