"""JAX ``tests/test_missing_items.py`` bound to the port: round-2 gap
closures, SumOfLiteralRewrite, GroupBy->Search, theta sketch.

The port runs with ``device="cpu"`` against the JAX test's closed forms
and pandas oracles at its own tolerance; each statement's mode and each
plan's spec type and search fields are held equal to the JAX package's
on the same frames. ``test_theta_union_algebra`` feeds the port's
register op torch tensors (the JAX test feeds JAX arrays).

Original notes:

(Reference parity: DruidLogicalOptimizer.SumOfLiteralRewrite:245-302,
QuerySpecTransforms GroupBy->Search :225-277, thetaSketch columns in
DruidDataSource.scala:24-40.)
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pytest
import torch

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.planner import builder as JB
from spark_druid_olap_tpu.sql.parser import parse_select as jparse_select

import spark_druid_olap_tpu_torch as sdot
from spark_druid_olap_tpu_torch.planner import builder as B
from spark_druid_olap_tpu_torch.sql.parser import parse_select
from spark_druid_olap_tpu_torch.ir import spec as S

from conftest import make_sales_df
from torch_twin import sql_mode


@pytest.fixture(scope="module")
def ctx():
    c = sdot.Context(device="cpu")
    c.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                       target_rows=4096)
    return c


@pytest.fixture(scope="module")
def jctx():
    """The JAX package's context over the same frame."""
    c = jsdot.Context()
    c.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                       target_rows=4096)
    return c


def _plans(ctx, jctx, sql):
    """The port's and the JAX package's first planned spec."""
    return (B.build(ctx, parse_select(sql)).specs[0],
            JB.build(jctx, jparse_select(sql)).specs[0])


def _mode_as_jax(ctx, jctx, sql):
    assert ctx.history.entries()[-1].stats["mode"] == sql_mode(jctx, sql)


@pytest.fixture(scope="module")
def sales(ctx):
    from spark_druid_olap_tpu_torch.planner.host_exec import datasource_frame
    return datasource_frame(ctx, "sales")


# -- sum(literal) -> count * literal ------------------------------------------

def test_sum_of_literal_rewrite(ctx, jctx, sales):
    from spark_druid_olap_tpu.ir import spec as JS
    spec, jspec = _plans(ctx, jctx, "select region, sum(3) as s from sales "
                                    "group by region")
    aggs = S.query_aggregations(spec)
    assert all(a.kind == "count" for a in aggs)     # no sum agg planned
    assert [a.kind for a in aggs] == \
        [a.kind for a in JS.query_aggregations(jspec)]
    sql = ("select region, sum(3) as s, count(*) as n from sales "
           "group by region order by region")
    got = ctx.sql(sql).to_pandas()
    _mode_as_jax(ctx, jctx, sql)
    assert (got["s"] == 3 * got["n"]).all()


def test_sum_of_literal_zero_rows_is_null(ctx, sales):
    # SQL: SUM over zero rows is NULL, never 0 — the rewrite must not leak
    # count's 0 identity through the count*lit post-agg
    got = ctx.sql("select sum(3) as s from sales "
                  "where region = 'nosuch'").to_pandas()
    assert len(got) == 1
    v = got["s"][0]
    assert v is None or (isinstance(v, float) and np.isnan(v))


def test_sum_of_float_literal(ctx, sales):
    got = ctx.sql("select sum(0.5) as s, count(*) as n from sales") \
        .to_pandas()
    assert float(got["s"][0]) == 0.5 * int(got["n"][0])


# -- GroupBy -> Search rewrite ------------------------------------------------

def test_groupby_to_search_plan(ctx, jctx):
    spec, jspec = _plans(ctx, jctx, "select product, count(*) as n from "
                                    "sales where product like '%01%' "
                                    "group by product")
    assert isinstance(spec, S.SearchQuerySpec)
    assert type(spec).__name__ == type(jspec).__name__
    assert (spec.query, spec.value_output, spec.count_output) == \
        (jspec.query, jspec.value_output, jspec.count_output)


def test_groupby_to_search_differential(ctx, jctx, sales):
    sql = ("select product, count(*) as n from sales "
           "where product like '%01%' group by product order by product")
    got = ctx.sql(sql).to_pandas()
    _mode_as_jax(ctx, jctx, sql)
    want = sales[sales["product"].str.contains("01")] \
        .groupby("product").size()
    np.testing.assert_array_equal(got["product"].to_numpy().astype(str),
                                  want.index.to_numpy().astype(str))
    np.testing.assert_array_equal(got["n"].to_numpy(), want.to_numpy())


def test_groupby_with_other_aggs_not_rewritten(ctx, jctx):
    spec, jspec = _plans(ctx, jctx, "select product, sum(qty) as s from "
                                    "sales where product like '%01%' "
                                    "group by product")
    assert isinstance(spec, S.GroupByQuerySpec)
    assert type(spec).__name__ == type(jspec).__name__


def test_search_spec_serde_roundtrip():
    from spark_druid_olap_tpu_torch.ir import serde
    q = S.SearchQuerySpec("d", ("p",), "01", True, None, None, None,
                          S.QueryContext(), "p", "n")
    q2 = serde.query_from_json(serde.query_to_json(q))
    assert q2.value_output == "p" and q2.count_output == "n"


# -- theta sketch -------------------------------------------------------------

def test_theta_sketch_estimate(ctx, jctx, sales):
    sql = ("select region, approx_count_distinct_theta(product) as d "
           "from sales group by region order by region")
    got = ctx.sql(sql).to_pandas()
    _mode_as_jax(ctx, jctx, sql)
    want = sales.groupby("region")["product"].nunique().sort_index()
    err = np.abs(got["d"].to_numpy() - want.to_numpy()) / want.to_numpy()
    assert (err < 0.4).all(), (got["d"].tolist(), want.tolist())


def test_theta_union_algebra():
    # merging sketches elementwise-min == sketching the union
    from spark_druid_olap_tpu_torch.ops import theta as TH
    r = np.random.default_rng(0)
    a = r.integers(0, 1000, 5000).astype(np.int32)
    b = r.integers(500, 1500, 5000).astype(np.int32)
    key = torch.zeros(5000, dtype=torch.int32)
    mask = torch.ones(5000, dtype=torch.bool)
    ra = TH.theta_registers(key, mask, torch.from_numpy(a), 1).numpy()
    rb = TH.theta_registers(key, mask, torch.from_numpy(b), 1).numpy()
    merged = np.minimum(ra, rb)
    both = TH.theta_registers(
        torch.zeros(10000, dtype=torch.int32),
        torch.ones(10000, dtype=torch.bool),
        torch.from_numpy(np.concatenate([a, b])), 1).numpy()
    np.testing.assert_array_equal(merged, both)
    est = TH.estimate(merged)[0]
    exact = len(np.union1d(a, b))
    assert abs(est - exact) / exact < 0.4


def test_theta_empty_group_is_zero():
    from spark_druid_olap_tpu_torch.ops import theta as TH
    regs = np.full((1, TH.K_LANES), 2.0, np.float32)   # untouched sentinel
    assert TH.estimate(regs)[0] == 0.0


def test_search_rewrite_excludes_nulls_and_filtered_counts(ctx):
    import pandas as pd
    df = pd.DataFrame({
        "p": (["a01", "b01"] * 1000) + [None] * 500,
        "q": pd.array(([1, None] * 1000) + [2] * 500, dtype="Int64"),
    })
    ctx.ingest_dataframe("s2", df)
    # NULL rows (dictionary code 0) must not count toward dictionary[0]
    got = ctx.sql("select p, count(*) as n from s2 where p like '%01%' "
                  "group by p order by p").to_pandas()
    assert got.set_index("p")["n"].to_dict() == {"a01": 1000, "b01": 1000}
    # a FIELD count is not the row count: must NOT rewrite to search
    from spark_druid_olap_tpu_torch.planner import builder as B
    pq = B.build(ctx, parse_select(
        "select p, count(q) as n from s2 where p like '%01%' group by p"))
    assert isinstance(pq.specs[0], S.GroupByQuerySpec)
    got2 = ctx.sql("select p, count(q) as n from s2 where p like '%01%' "
                   "group by p order by p").to_pandas()
    assert got2.set_index("p")["n"].to_dict() == {"a01": 1000, "b01": 0}


def test_theta_empty_scan_returns_zero(ctx):
    got = ctx.sql("select approx_count_distinct_theta(product) as d "
                  "from sales where ts >= date '2031-01-01'").to_pandas()
    assert int(got["d"][0]) == 0
