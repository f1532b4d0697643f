"""The port's materialized rollups against the JAX package's.

The cases of ``tests/test_rollup.py`` that need neither persistence nor
the HTTP server (nor the JAX package's multi-host and bench helpers): the
TPC-H and SSB suites with rollups declared, each statement run twice on
one context, with the rewrite off (the base scan) and on; staleness after
a re-ingest and REFRESH; DROP; CLEAR METADATA; the shapes that must stay
on the base; avg from a declared sum and count; granularity coarsening
and bucket-aligned intervals; the identity proof of a day rollup over
day-resolution data; DDL validation errors; the result cache's keys across
a rebuild; ``sys_rollups`` and EXPLAIN; the backing datasource as a
first-class table. Also the host tier's grouped frame (where the SSB
cube's build runs), whose ORDER BY helpers copy by reference.

Each package's rollup answer is held against its own base answer with
``conftest.assert_frames_equal`` at the JAX rollup tests' tolerance (rtol
1e-4, atol 1e-6: the rollup re-aggregates stored f64 partials in another
order); each leg's answer in the port against the JAX package's
(dimensions, integers and counts exact, float sums rtol 1e-6); the
serving status (``rollup:<name>`` / ``base``), the statement's mode,
``sys_rollups`` and the EXPLAIN rewrite line equal in both packages.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.tools import ssb as jssb
from spark_druid_olap_tpu.tools import tpch as jtpch

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.tools import ssb as tssb
from spark_druid_olap_tpu_torch.tools import tpch as ttpch

from conftest import assert_frames_equal, make_sales_df
from test_torch_sql import assert_answers_equal

REWRITE = "sdot.mv.rewrite.enabled"
NO_PLAN_CACHE = {"sdot.plan.cache.enabled": False}

TPCH_CUBE = (
    "create rollup tpch_cube on tpch_flat dimensions ("
    "l_returnflag, l_linestatus, l_shipmode, l_receiptdate, l_commitdate, "
    "o_orderpriority, o_orderdate, o_orderkey, o_shippriority, "
    "c_mktsegment, cn_name, sn_name, sr_name, cr_name, p_type) "
    "aggregations (sum(l_quantity), sum(l_extendedprice), sum(l_discount), "
    "sum(l_extendedprice * (1 - l_discount)), "
    "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)), "
    "sum(l_extendedprice * l_discount), count(*), "
    "sum(case when o_orderpriority = '1-URGENT' "
    "or o_orderpriority = '2-HIGH' then 1 else 0 end), "
    "sum(case when o_orderpriority <> '1-URGENT' "
    "and o_orderpriority <> '2-HIGH' then 1 else 0 end), "
    "sum(case when p_type like 'PROMO%' "
    "then l_extendedprice * (1 - l_discount) else 0 end), "
    "sum(case when sn_name = 'BRAZIL' "
    "then l_extendedprice * (1 - l_discount) else 0 end)"
    ") granularity day")

LI_CUBE = (
    "create rollup li_cube on lineitem dimensions ("
    "l_returnflag, l_linestatus, l_shipmode, l_discount, l_quantity) "
    "aggregations (sum(l_quantity), sum(l_extendedprice), sum(l_discount), "
    "sum(l_extendedprice * l_discount), "
    "sum(l_extendedprice * (1 - l_discount)), "
    "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)), "
    "count(*)) granularity day")

SSB_CUBE = (
    "create rollup ssb_cube on ssb_flat dimensions ("
    "d_year, d_yearmonthnum, d_weeknuminyear, d_yearmonth, "
    "c_city, c_nation, c_region, s_city, s_nation, s_region, "
    "p_mfgr, p_category, p_brand1, lo_discount, lo_quantity) "
    "aggregations (sum(lo_extendedprice * lo_discount), sum(lo_revenue), "
    "sum(lo_revenue - lo_supplycost), count(*))")

# which rollup each TPC-H statement is served from; the rest stay on the
# base scan (tests/test_rollup.py's table)
TPCH_EXPECT = {
    "q1": "li_cube", "shipdate_range": "li_cube", "q6": "li_cube",
    "filters_range": "tpch_cube", "q3": "tpch_cube", "q5": "tpch_cube",
    "q7": "tpch_cube", "q8": "tpch_cube", "q12": "tpch_cube",
    "q14": "tpch_cube",
}


def _new(pkg, **cfg):
    conf = {**NO_PLAN_CACHE, **cfg}
    return jsdot.Context(conf) if pkg == "jax" \
        else tsdot.Context(conf, device="cpu")


def _status(ctx):
    return ctx.history.entries()[-1].stats.get("rollup")


def _mode(ctx):
    return ctx.history.entries()[-1].stats.get("mode")


def _run_both(ctx, sql):
    """(base frame, rewrite-leg frame, rewrite-leg status, mode)."""
    ctx.config.set(REWRITE, False)
    try:
        base = ctx.sql(sql).to_pandas()
    finally:
        ctx.config.set(REWRITE, True)
    got = ctx.sql(sql).to_pandas()
    return base, got, _status(ctx), _mode(ctx)


def _differential(pair, sql, ordered):
    """Both legs in both packages: each rollup leg within the JAX rollup
    tests' tolerance of its base leg, each leg equal across the packages.
    Returns the (JAX, port) statuses."""
    runs = [_run_both(c, sql) for c in pair]
    for base, got, _, _ in runs:
        assert_frames_equal(got, base)
    (jb, jg, js, jm), (tb, tg, ts_, tm) = runs
    assert tm == jm
    assert_answers_equal(tb, jb, ordered)
    assert_answers_equal(tg, jg, ordered)
    return js, ts_


# -- suite differentials ------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_pair():
    pair = []
    for pkg, tp in (("jax", jtpch), ("torch", ttpch)):
        ctx = _new(pkg)
        tp.setup_context(ctx, sf=0.002, target_rows=4096)
        assert "created" in ctx.sql(TPCH_CUBE).to_pandas()["status"][0]
        assert "created" in ctx.sql(LI_CUBE).to_pandas()["status"][0]
        pair.append(ctx)
    return pair


@pytest.mark.parametrize("name", list(ttpch.QUERIES))
def test_tpch_rollup_differential(tpch_pair, name):
    sql = ttpch.QUERIES[name]
    js, ts_ = _differential(tpch_pair, sql, "order by" in sql.lower())
    want = f"rollup:{TPCH_EXPECT[name]}" if name in TPCH_EXPECT else "base"
    assert js == want, f"{name}: JAX served from {js}, want {want}"
    assert ts_ == js, f"{name}: port served from {ts_}, JAX from {js}"


@pytest.fixture(scope="module")
def ssb_pair():
    pair = []
    for pkg, sb in (("jax", jssb), ("torch", tssb)):
        ctx = _new(pkg)
        sb.setup_context(ctx, sf=0.003, target_rows=4096)
        assert "created" in ctx.sql(SSB_CUBE).to_pandas()["status"][0]
        pair.append(ctx)
    return pair


@pytest.mark.parametrize("name", list(tssb.QUERIES))
def test_ssb_rollup_differential(ssb_pair, name):
    sql = tssb.QUERIES[name]
    js, ts_ = _differential(ssb_pair, sql, ordered=False)
    # the SSB cube covers every dimension, filter and aggregate of all 13
    assert js == ts_ == "rollup:ssb_cube", (name, js, ts_)


# -- lifecycle: staleness, refresh, drop -------------------------------------

def _sales_pair(**cfg):
    df = make_sales_df(n=6000)
    pair = []
    for pkg in ("jax", "torch"):
        ctx = _new(pkg, **cfg)
        ctx.ingest_dataframe("sales", df, time_column="ts", target_rows=2048)
        pair.append(ctx)
    return pair


def _sql_both(pair, sql):
    """Run one statement in both packages: [(frame, status)] JAX first."""
    out = []
    for c in pair:
        out.append((c.sql(sql).to_pandas(), _status(c)))
    return out


def test_staleness_bypass_and_refresh():
    pair = _sales_pair()
    q = "select region, sum(price) as rev, count(*) as c from sales " \
        "group by region"
    df2 = make_sales_df(n=6000)
    df2["price"] = df2["price"] * 3
    for ctx in pair:
        ctx.sql("create rollup cube1 on sales dimensions (region, status) "
                "aggregations (sum(price), sum(qty), count(*)) "
                "granularity day")
    fresh = _sql_both(pair, q)
    for c in pair:
        # a base re-ingest bumps the datasource version: the rollup is
        # stale, never served, and the answer is the new data's
        c.ingest_dataframe("sales", df2, time_column="ts", target_rows=2048)
    stale = _sql_both(pair, q)
    views = [c.sql("select name, fresh from sys_rollups").to_pandas()
             for c in pair]
    for c in pair:
        c.sql("refresh rollup cube1")
    again = _sql_both(pair, q)
    views2 = [c.sql("select fresh from sys_rollups").to_pandas()
              for c in pair]
    for i in range(2):
        assert fresh[i][1] == "rollup:cube1"
        assert stale[i][1] == "base"
        assert not np.allclose(
            stale[i][0].sort_values("region")["rev"].to_numpy(),
            fresh[i][0].sort_values("region")["rev"].to_numpy())
        assert views[i]["fresh"].tolist() == [False]
        assert again[i][1] == "rollup:cube1"
        assert_frames_equal(again[i][0], stale[i][0])
        assert views2[i]["fresh"].tolist() == [True]
    for frames in (fresh, stale, again):
        assert_answers_equal(frames[1][0], frames[0][0], ordered=False)


def test_drop_rollup_removes_backing():
    q = "select region, sum(price) as rev from sales group by region"
    for ctx in _sales_pair():
        ctx.sql("create rollup cube1 on sales dimensions (region) "
                "aggregations (sum(price), count(*))")
        assert "__rollup_cube1" in ctx.store.names()
        ctx.sql(q)
        assert _status(ctx) == "rollup:cube1"
        ctx.sql("drop rollup cube1")
        assert "__rollup_cube1" not in ctx.store.names()
        assert ctx.sql("select count(*) as n from sys_rollups") \
            .to_pandas()["n"][0] == 0
        ctx.sql(q)
        assert _status(ctx) == "base"


def test_clear_metadata_forgets_rollups():
    for ctx in _sales_pair():
        ctx.sql("create rollup cube1 on sales dimensions (region) "
                "aggregations (count(*))")
        ctx.sql("clear metadata sales")
        assert ctx.rollups == {}
        assert "__rollup_cube1" not in ctx.store.names()


# -- eligibility boundaries ---------------------------------------------------

INELIGIBLE = [
    # filter on a column that is not a rollup dimension
    "select region, count(*) as c from sales where product = 'p001' "
    "group by region",
    # grouping dim not covered
    "select flag, count(*) as c from sales group by flag",
    # aggregate with no stored partial (sum(qty) was not declared)
    "select region, sum(qty) as s from sales group by region",
    # min over a sum-only rollup
    "select region, min(price) as m from sales group by region",
    # sketches are never merge-closed
    "select region, approx_count_distinct(product) as d from sales "
    "group by region",
]


def test_ineligible_shapes_stay_on_base():
    pair = _sales_pair()
    for ctx in pair:
        ctx.sql("create rollup cube1 on sales dimensions (region, status) "
                "aggregations (sum(price), count(*)) granularity day")
    for sql in INELIGIBLE:
        (want, js), (got, ts_) = _sql_both(pair, sql)
        assert js == ts_ == "base", sql
        assert_answers_equal(got, want, ordered=False)


def test_avg_derives_from_declared_sum_and_count():
    pair = _sales_pair()
    for ctx in pair:
        ctx.sql("create rollup cube1 on sales dimensions (region) "
                "aggregations (sum(price), count(*))")
    js, ts_ = _differential(
        pair, "select region, avg(price) as ap from sales group by region",
        ordered=False)
    assert js == ts_ == "rollup:cube1"


def test_granularity_coarsening_and_identity_intervals():
    # ms-resolution timestamps: bucketing is not the identity, so only
    # cleanly nesting extractions and bucket-aligned intervals rewrite
    df = make_sales_df(n=6000)
    df["ts"] = df["ts"] + pd.to_timedelta(
        np.random.default_rng(3).integers(0, 86_400_000, len(df)), unit="ms")
    pair = []
    for pkg in ("jax", "torch"):
        ctx = _new(pkg)
        ctx.ingest_dataframe("sales", df, time_column="ts", target_rows=2048)
        ctx.sql("create rollup cube1 on sales dimensions (region) "
                "aggregations (sum(price), count(*)) granularity day")
        assert not ctx.rollups["cube1"].time_identity
        pair.append(ctx)
    cases = [
        # day nests inside month and year
        ("select region, year(ts) as y, month(ts) as m, sum(price) as rev "
         "from sales group by region, year(ts), month(ts)", "rollup:cube1"),
        # day-aligned interval endpoints rewrite...
        ("select region, sum(price) as rev from sales "
         "where ts >= date '2015-03-01' and ts < date '2015-09-01' "
         "group by region", "rollup:cube1"),
        # ...an intraday endpoint splits a bucket and must not
        ("select region, sum(price) as rev from sales "
         "where ts >= timestamp '2015-03-01 12:00:00' group by region",
         "base"),
    ]
    for sql, want in cases:
        js, ts_ = _differential(pair, sql, ordered=False)
        assert js == ts_ == want, (sql, js, ts_)


def test_day_resolution_identity_serves_arbitrary_time_predicates():
    # day-resolution data + day granularity: the build proves identity
    # bucketing, so raw time-column predicates carry over verbatim
    pair = _sales_pair()
    for ctx in pair:
        ctx.sql("create rollup cube1 on sales dimensions (region) "
                "aggregations (sum(price), count(*)) granularity day")
        assert ctx.rollups["cube1"].time_identity
    js, ts_ = _differential(
        pair, "select region, sum(price) as rev from sales "
              "where ts <= date '2016-02-17' group by region",
        ordered=False)
    assert js == ts_ == "rollup:cube1"


DDL_ERRORS = [
    ("create rollup r on nosuch dimensions (x) aggregations (count(*))",
     "unknown datasource"),
    ("create rollup r on sales dimensions (nope) aggregations (count(*))",
     "not a column"),
    ("create rollup r on sales dimensions (ts) aggregations (count(*))",
     "time column"),
    ("create rollup r on sales dimensions (region) "
     "aggregations (avg(price))", "not merge-closed"),
    ("create rollup r on sales dimensions (region) "
     "aggregations (approx_count_distinct(product))", "not merge-closed"),
    ("create rollup r on sales dimensions (region) "
     "aggregations (count(*)) granularity hour", "granularity"),
    ("drop rollup nosuch", "unknown rollup"),
    ("refresh rollup nosuch", "unknown rollup"),
]


def test_ddl_validation_errors():
    for ctx in _sales_pair():
        for sql, frag in DDL_ERRORS:
            with pytest.raises(ValueError, match=frag):
                ctx.sql(sql)
        ctx.sql("create rollup r on sales dimensions (region) "
                "aggregations (count(*))")
        with pytest.raises(ValueError, match="already exists"):
            ctx.sql("create rollup r on sales dimensions (region) "
                    "aggregations (count(*))")


# -- result-cache interaction (key collision regression) ----------------------

def test_result_cache_keys_track_rollup_identity():
    pair = _sales_pair(**{"sdot.cache.enabled": True})
    q = "select region, sum(price) as rev from sales group by region"
    df2 = make_sales_df(n=6000)
    df2["price"] = df2["price"] * 5
    answers = []
    for ctx in pair:
        ctx.sql("create rollup cube1 on sales dimensions (region) "
                "aggregations (sum(price), count(*))")
        first = ctx.sql(q).to_pandas()
        assert _status(ctx) == "rollup:cube1"
        hits0 = ctx.engine.result_cache.stats()["hits"]
        again = ctx.sql(q).to_pandas()
        assert ctx.engine.result_cache.stats()["hits"] == hits0 + 1
        assert_frames_equal(again, first)
        # re-ingest the base with other values and rebuild the rollup
        # under the same name: the cached rollup-served entry must never
        # be replayed (the backing's ingest version is part of the key)
        ctx.ingest_dataframe("sales", df2, time_column="ts",
                             target_rows=2048)
        ctx.sql("refresh rollup cube1")
        fresh = ctx.sql(q).to_pandas()
        assert _status(ctx) == "rollup:cube1"
        assert not np.allclose(
            fresh.sort_values("region")["rev"].to_numpy(),
            first.sort_values("region")["rev"].to_numpy())
        # base-served and rollup-served answers of one statement coexist
        ctx.config.set(REWRITE, False)
        base = ctx.sql(q).to_pandas()
        ctx.config.set(REWRITE, True)
        assert_frames_equal(base, fresh)
        answers.append((first, fresh))
    for i in range(2):
        assert_answers_equal(answers[1][i], answers[0][i], ordered=False)


# -- surfacing: sys_rollups, EXPLAIN, history ---------------------------------

def test_sys_rollups_view_and_explain():
    pair = _sales_pair()
    q = "select region, sum(price) as rev from sales group by region"
    views = []
    for ctx in pair:
        ctx.sql("create rollup cube1 on sales dimensions (region, status) "
                "aggregations (sum(price), count(*)) granularity day")
        v = ctx.sql("select * from sys_rollups").to_pandas()
        assert v["name"].tolist() == ["cube1"]
        assert v["datasource"][0] == "__rollup_cube1"
        assert v["granularity"][0] == "day"
        assert bool(v["fresh"][0])
        assert v["rows"][0] == ctx.store.get("__rollup_cube1").num_rows
        views.append(v)
        text = ctx.explain(q)
        assert "rollup rewrite: cube1" in text
        assert "__rollup_cube1" in text
        # an ineligible statement explains with no rewrite line
        assert "rollup rewrite" not in ctx.explain(
            "select flag, count(*) as c from sales group by flag")
        # the serving status lands in the history's stats
        ctx.sql(q)
        assert ctx.history.entries()[-1].stats["rollup"] == "rollup:cube1"
    # the same rows, versions aside (each store counts its own registers)
    cols = [c for c in views[0].columns
            if c not in ("built_version", "base_version")]
    pd.testing.assert_frame_equal(views[1][cols], views[0][cols])
    lines = [[ln for ln in c.explain(q).split("\n")
              if ln.startswith("rollup rewrite")] for c in pair]
    assert lines[0] == lines[1]


def test_backing_datasource_is_first_class():
    pair = _sales_pair()
    for ctx in pair:
        ctx.sql("create rollup cube1 on sales dimensions (region, status) "
                "aggregations (sum(price), count(*))")
    (want, _), (got, _) = _sql_both(
        pair, "select region, status, agg_0, agg_1 from __rollup_cube1 "
              "order by region, status limit 3")
    assert len(got) == 3
    assert_answers_equal(got, want, ordered=True)


# -- the host tier's grouped frames (the SSB cube's build runs there) ---------

def test_host_grouped_frame_holds_order_helpers_by_reference():
    """A grouped frame of the host tier keeps what ORDER BY needs in
    ``attrs`` as one object that copies by reference (pandas deep-copies
    ``attrs`` at every column access); ORDER BY an aggregate that is not
    selected answers as the JAX package's host tier does."""
    from spark_druid_olap_tpu.planner import host_exec as JH
    from spark_druid_olap_tpu.sql.parser import parse_statement as jparse
    from spark_druid_olap_tpu_torch.planner import host_exec as TH
    from spark_druid_olap_tpu_torch.sql.parser import parse_statement
    jctx, tctx = _sales_pair()
    sql = ("select region, status, count(*) as n from sales "
           "group by region, status order by sum(qty) desc, region, status")
    want = JH.execute_select(jctx, jparse(sql))
    got = TH.execute_select(tctx, parse_statement(sql))
    assert_answers_equal(got, want, ordered=True)
    frame = TH.execute_select(tctx, parse_statement(
        "select region, status, count(*) as n from sales "
        "group by region, status"))
    helpers = frame.attrs["order_helpers"]
    assert frame["n"].attrs["order_helpers"] is helpers
    assert set(helpers.grp_cols) and set(helpers.agg_cols)
