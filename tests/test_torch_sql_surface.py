"""JAX ``tests/test_sql_surface.py`` bound to the port: WITH (CTEs),
UNION ALL, OFFSET.

The port runs with ``device="cpu"`` against the JAX test's pandas
oracles at its own tolerance; each statement's mode, the errors and their
messages and the EXPLAIN lines the JAX test reads are held equal to the
JAX package's on the same frame.

Original notes: SQL-surface parity with the Spark SQL
dialect the reference serves through its thriftserver (the reference
leaves these to Spark's parser/optimizer: CTESubstitution, Union planning,
CollectLimit; here they desugar onto the existing derived-table /
session machinery)."""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu_torch as sdot
from conftest import make_sales_df
from torch_twin import mirrored, mode_as_jax, same_error


@pytest.fixture(scope="module")
def sctx():
    c = mirrored(sdot.Context(device="cpu"))
    c.ingest_dataframe("sales", make_sales_df(20_000), time_column="ts",
                       target_rows=4096)
    c._df = make_sales_df(20_000)
    return c


def _mode(ctx):
    return ctx.history.entries()[-1].stats["mode"]


def test_cte_basic(sctx):
    got = sctx.sql(
        "with r as (select region, sum(qty) as s from sales "
        "           group by region) "
        "select region, s from r order by region").to_pandas()
    want = sctx._df.groupby("region", as_index=False).agg(s=("qty", "sum")) \
        .sort_values("region").reset_index(drop=True)
    np.testing.assert_array_equal(got["s"].to_numpy(), want["s"].to_numpy())


def test_cte_chained_and_joined(sctx):
    """A later CTE references an earlier one; the outer joins both."""
    got = sctx.sql(
        "with base as (select region, qty, price from sales), "
        "     agg as (select region, sum(qty) as s from base "
        "             group by region) "
        "select region, s from agg order by s desc").to_pandas()
    want = sctx._df.groupby("region", as_index=False).agg(s=("qty", "sum")) \
        .sort_values("s", ascending=False)
    np.testing.assert_array_equal(got["s"].to_numpy(), want["s"].to_numpy())


def test_cte_inside_subquery(sctx):
    got = sctx.sql(
        "with t as (select qty from sales) "
        "select count(*) as n from sales "
        "where qty > (select avg(qty) from t)").to_pandas()
    want = int((sctx._df.qty > sctx._df.qty.mean()).sum())
    assert int(got["n"][0]) == want


def test_union_all_top_level(sctx):
    sql = ("select region, sum(qty) as s from sales where status = 'O' "
           "group by region "
           "union all "
           "select region, sum(qty) as s from sales where status = 'F' "
           "group by region "
           "order by region, s")
    got = sctx.sql(sql).to_pandas()
    df = sctx._df
    a = df[df.status == "O"].groupby("region", as_index=False) \
        .agg(s=("qty", "sum"))
    b = df[df.status == "F"].groupby("region", as_index=False) \
        .agg(s=("qty", "sum"))
    want = pd.concat([a, b], ignore_index=True) \
        .sort_values(["region", "s"]).reset_index(drop=True)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got["s"].to_numpy(), want["s"].to_numpy())
    assert mode_as_jax(sctx, sql) == "union"


def test_union_all_as_derived_table(sctx):
    got = sctx.sql(
        "select region, count(*) as n from "
        "(select region from sales where status = 'O' "
        " union all "
        " select region from sales where status = 'F') u "
        "group by region order by region").to_pandas()
    df = sctx._df
    want = df[df.status.isin(["O", "F"])].groupby("region").size()
    np.testing.assert_array_equal(got["n"].to_numpy(), want.to_numpy())


def test_union_column_count_mismatch(sctx):
    sql = ("select region from sales union all "
           "select region, qty from sales")
    with pytest.raises(Exception):
        sctx.sql(sql)
    same_error(lambda: sctx.sql(sql), lambda: sctx.jax.sql(sql))


def test_offset_with_limit(sctx):
    full = sctx.sql("select product, sum(qty) as s from sales "
                    "group by product order by product").to_pandas()
    sql = ("select product, sum(qty) as s from sales "
           "group by product order by product limit 10 offset 20")
    page = sctx.sql(sql).to_pandas()
    np.testing.assert_array_equal(
        page["product"].to_numpy(),
        full["product"].to_numpy()[20:30])
    assert mode_as_jax(sctx, sql) == "engine"


def test_offset_without_limit(sctx):
    full = sctx.sql("select region, sum(qty) as s from sales "
                    "group by region order by region").to_pandas()
    tail = sctx.sql("select region, sum(qty) as s from sales "
                    "group by region order by region offset 2").to_pandas()
    np.testing.assert_array_equal(tail["s"].to_numpy(),
                                  full["s"].to_numpy()[2:])


def test_offset_in_derived_table(sctx):
    got = sctx.sql(
        "select count(*) as n from "
        "(select product from sales group by product "
        " order by product limit 10 offset 5) t").to_pandas()
    assert int(got["n"][0]) == 10


def test_union_with_limit_offset(sctx):
    got = sctx.sql(
        "select region from sales where status = 'O' group by region "
        "union all "
        "select region from sales where status = 'F' group by region "
        "order by region limit 3 offset 1").to_pandas()
    df = sctx._df
    a = sorted(set(df[df.status == "O"].region))
    b = sorted(set(df[df.status == "F"].region))
    want = sorted(a + b)[1:4]
    assert got["region"].tolist() == want


def test_offset_in_assisted_derived_table(sctx):
    """The engine-assist path must not silently drop a derived table's
    OFFSET (the builder refuses; the host tier applies it)."""
    got = sctx.sql(
        "select sum(p) as s from "
        "(select price as p from sales order by price desc "
        " limit 10 offset 5) d").to_pandas()
    want = sctx._df.price.sort_values(ascending=False) \
        .iloc[5:15].sum()
    np.testing.assert_allclose(float(got["s"][0]), want, rtol=1e-5)


def test_offset_survives_view_merge(sctx):
    got = sctx.sql("select count(*) as n from "
                   "(select qty from sales offset 5) d").to_pandas()
    assert int(got["n"][0]) == len(sctx._df) - 5


def test_union_parenthesized_branch_keeps_its_limit(sctx):
    # a NON-final branch carrying its own LIMIT must be parenthesized
    # (bare form is a syntax error since the ADVICE r2 fix)
    got = sctx.sql(
        "(select qty from sales where qty <= 2 limit 2) union all "
        "(select qty from sales order by qty desc limit 2)").to_pandas()
    assert len(got) == 4
    vals = got["qty"].tolist()
    assert vals[:2] == [v for v in vals[:2] if v <= 2]
    assert vals[2:] == [50, 50]


def test_union_order_by_ordinal_validation(sctx):
    got = sctx.sql("select region from sales group by region union all "
                   "select region from sales group by region "
                   "order by 1").to_pandas()
    assert got["region"].tolist() == sorted(got["region"].tolist())
    import pytest as _pt
    bad = ("select region from sales group by region union all "
           "select region from sales group by region order by 0")
    with _pt.raises(Exception, match="ordinal"):
        sctx.sql(bad)
    same_error(lambda: sctx.sql(bad), lambda: sctx.jax.sql(bad))


def test_cte_in_join_condition(sctx):
    got = sctx.sql(
        "with big as (select qty as bq from sales where qty >= 49) "
        "select count(*) as n from sales "
        "where qty in (select bq from big)").to_pandas()
    want = int(sctx._df.qty.isin(
        sctx._df.qty[sctx._df.qty >= 49]).sum())
    assert int(got["n"][0]) == want


def test_explain_union_and_with(sctx):
    q1 = "select qty from sales union all select qty from sales"
    q2 = ("with t as (select region, sum(qty) as s from sales "
          "group by region) select region, s from t")
    t1, t2 = sctx.explain(q1), sctx.explain(q2)
    assert "UNION ALL over 2 branches" in t1
    assert "pushdown" in t2

    def lines(text, word):
        return [ln for ln in text.splitlines() if word in ln]
    assert lines(t1, "UNION ALL") == lines(sctx.jax.explain(q1), "UNION ALL")
    assert lines(t2, "pushdown") == lines(sctx.jax.explain(q2), "pushdown")
