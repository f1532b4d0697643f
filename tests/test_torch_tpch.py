"""JAX ``tests/test_tpch.py`` bound to the port: TPC-H star-schema
differential tests.

The port runs with ``device="cpu"`` at the JAX test's scale (SF 0.002,
4,096 target rows), against the JAX test's hand-written pandas oracles at
its own tolerance (rtol 1e-4); each statement's mode and the refused
join's error are held equal to the JAX package's on the same star. Four
JAX cases are held case for case elsewhere and not copied:
``test_filters_range_runs_on_host`` by
``test_torch_sql.py::test_filters_range_same_answer_and_mode``,
``test_star_join_collapse_plan`` and ``test_fact_only_query_uses_flat``
by the cases of those names in ``test_torch_sql.py``, and
``test_pushdown_census`` by
``test_torch_tpch22.py::test_statement_equals_the_jax_package`` (every
statement's mode equal to the JAX package's).

Original notes:

≈ the reference's ``StarSchemaTpchQueriesCTest`` (TPC-H queries against the
Druid index vs the raw Spark tables) + ``JoinTest`` plan assertions: each
query must (a) push down to the engine via star-join collapse onto the flat
datasource, and (b) match a hand-written pandas oracle — a genuinely
INDEPENDENT implementation, never the project's own host executor (the
reference's cTest diffs against stock Spark, AbstractTest.scala:127-143;
diffing engine-vs-host_exec would let a shared planner bug pass both sides).
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu_torch as sdot
from spark_druid_olap_tpu_torch.planner import builder as B
from spark_druid_olap_tpu_torch.sql.parser import parse_select
from spark_druid_olap_tpu_torch.tools import tpch

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.planner import builder as JB
from spark_druid_olap_tpu.sql.parser import parse_select as jparse_select
from spark_druid_olap_tpu.tools import tpch as jtpch

from conftest import assert_frames_equal
from torch_twin import same_error, sql_mode


@pytest.fixture(scope="module")
def tenv():
    ctx = sdot.Context(device="cpu")
    tables, _flat = tpch.setup_context(ctx, sf=0.002, target_rows=4096)
    nr = tpch.nation_region_views(tables)
    return ctx, tables, nr


@pytest.fixture(scope="module")
def tctx(tenv):
    return tenv[0]


@pytest.fixture(scope="module")
def jctx():
    """The JAX package's star at the same scale."""
    ctx = jsdot.Context()
    jtpch.setup_context(ctx, sf=0.002, target_rows=4096)
    return ctx


def _rev(df):
    return df.l_extendedprice * (1 - df.l_discount)


def oracle_basic_agg(t, nr):
    df = (t["lineitem"]
          .merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
          .merge(t["partsupp"], left_on=["l_partkey", "l_suppkey"],
                 right_on=["ps_partkey", "ps_suppkey"]))
    res = df.groupby(["l_returnflag", "l_linestatus"], as_index=False).agg(
        count_order=("l_orderkey", "size"), s=("l_extendedprice", "sum"),
        m=("ps_supplycost", "max"), a=("ps_availqty", "mean"),
        od=("o_orderkey", "nunique"))
    return res


def oracle_shipdate_range(t, nr):
    li = t["lineitem"]
    li = li[(li.l_shipdate >= pd.Timestamp("1994-01-01"))
            & (li.l_shipdate <= pd.Timestamp("1997-01-01"))]
    return li.groupby(["l_returnflag", "l_linestatus"]) \
        .size().reset_index(name="count_order")


def oracle_q1(t, nr):
    li = t["lineitem"]
    li = li[li.l_shipdate <= pd.Timestamp("1998-12-01")
            - pd.Timedelta(days=90)]
    disc = _rev(li)
    charge = disc * (1 + li.l_tax)
    df = li.assign(disc_price=disc, charge=charge)
    res = df.groupby(["l_returnflag", "l_linestatus"], as_index=False).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"), sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"),
        avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"),
        count_order=("l_quantity", "size"))
    return res.sort_values(["l_returnflag", "l_linestatus"]) \
        .reset_index(drop=True)


def oracle_q3(t, nr):
    df = (t["customer"]
          .merge(t["orders"], left_on="c_custkey", right_on="o_custkey")
          .merge(t["lineitem"], left_on="o_orderkey",
                 right_on="l_orderkey"))
    df = df[(df.c_mktsegment == "BUILDING")
            & (df.o_orderdate < pd.Timestamp("1995-03-15"))
            & (df.l_shipdate > pd.Timestamp("1995-03-15"))]
    df = df.assign(revenue=_rev(df))
    res = df.groupby(["o_orderkey", "o_orderdate", "o_shippriority"],
                     as_index=False).revenue.sum()
    res = res.sort_values(["revenue", "o_orderdate"],
                          ascending=[False, True]).head(10)
    return res[["o_orderkey", "revenue", "o_orderdate",
                "o_shippriority"]].reset_index(drop=True)


def oracle_q5(t, nr):
    df = (t["customer"]
          .merge(t["orders"], left_on="c_custkey", right_on="o_custkey")
          .merge(t["lineitem"], left_on="o_orderkey",
                 right_on="l_orderkey")
          .merge(t["supplier"], left_on="l_suppkey", right_on="s_suppkey")
          .merge(nr["suppnation"], left_on="s_nationkey",
                 right_on="sn_nationkey")
          .merge(nr["suppregion"], left_on="sn_regionkey",
                 right_on="sr_regionkey"))
    df = df[(df.sr_name == "ASIA")
            & (df.o_orderdate >= pd.Timestamp("1994-01-01"))
            & (df.o_orderdate < pd.Timestamp("1995-01-01"))]
    df = df.assign(revenue=_rev(df))
    res = df.groupby("sn_name", as_index=False).revenue.sum()
    return res.sort_values("revenue", ascending=False) \
        .reset_index(drop=True)


def oracle_q6(t, nr):
    li = t["lineitem"]
    li = li[(li.l_shipdate >= pd.Timestamp("1994-01-01"))
            & (li.l_shipdate < pd.Timestamp("1995-01-01"))
            & (li.l_discount >= 0.05) & (li.l_discount <= 0.07)
            & (li.l_quantity < 24)]
    return pd.DataFrame(
        {"revenue": [(li.l_extendedprice * li.l_discount).sum()]})


def oracle_q7(t, nr):
    df = (t["supplier"]
          .merge(t["lineitem"], left_on="s_suppkey", right_on="l_suppkey")
          .merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
          .merge(t["customer"], left_on="o_custkey", right_on="c_custkey")
          .merge(nr["suppnation"], left_on="s_nationkey",
                 right_on="sn_nationkey")
          .merge(nr["custnation"], left_on="c_nationkey",
                 right_on="cn_nationkey"))
    df = df[(((df.sn_name == "FRANCE") & (df.cn_name == "GERMANY"))
             | ((df.sn_name == "GERMANY") & (df.cn_name == "FRANCE")))
            & (df.l_shipdate >= pd.Timestamp("1995-01-01"))
            & (df.l_shipdate <= pd.Timestamp("1996-12-31"))]
    df = df.assign(l_year=df.l_shipdate.dt.year, revenue=_rev(df))
    res = df.groupby(["sn_name", "cn_name", "l_year"],
                     as_index=False).revenue.sum()
    return res.sort_values(["sn_name", "cn_name", "l_year"]) \
        .reset_index(drop=True)


def oracle_q8(t, nr):
    df = (t["part"]
          .merge(t["lineitem"], left_on="p_partkey", right_on="l_partkey")
          .merge(t["supplier"], left_on="l_suppkey", right_on="s_suppkey")
          .merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
          .merge(t["customer"], left_on="o_custkey", right_on="c_custkey")
          .merge(nr["custnation"], left_on="c_nationkey",
                 right_on="cn_nationkey")
          .merge(nr["custregion"], left_on="cn_regionkey",
                 right_on="cr_regionkey")
          .merge(nr["suppnation"], left_on="s_nationkey",
                 right_on="sn_nationkey"))
    df = df[(df.cr_name == "AMERICA")
            & (df.o_orderdate >= pd.Timestamp("1995-01-01"))
            & (df.o_orderdate <= pd.Timestamp("1996-12-31"))
            & (df.p_type == "ECONOMY ANODIZED STEEL")]
    rev = _rev(df)
    df = df.assign(o_year=df.o_orderdate.dt.year, total_rev=rev,
                   brazil_rev=rev.where(df.sn_name == "BRAZIL", 0.0))
    res = df.groupby("o_year", as_index=False).agg(
        brazil_rev=("brazil_rev", "sum"), total_rev=("total_rev", "sum"))
    return res.sort_values("o_year").reset_index(drop=True)


def oracle_q10(t, nr):
    df = (t["customer"]
          .merge(t["orders"], left_on="c_custkey", right_on="o_custkey")
          .merge(t["lineitem"], left_on="o_orderkey",
                 right_on="l_orderkey")
          .merge(nr["custnation"], left_on="c_nationkey",
                 right_on="cn_nationkey"))
    df = df[(df.o_orderdate >= pd.Timestamp("1993-10-01"))
            & (df.o_orderdate < pd.Timestamp("1994-01-01"))
            & (df.l_returnflag == "R")]
    df = df.assign(revenue=_rev(df))
    res = df.groupby(["c_custkey", "c_name", "c_acctbal", "c_phone",
                      "cn_name"], as_index=False).revenue.sum()
    res = res.sort_values("revenue", ascending=False).head(20)
    return res[["c_custkey", "c_name", "revenue", "c_acctbal", "cn_name",
                "c_phone"]].reset_index(drop=True)


def oracle_q12(t, nr):
    df = t["orders"].merge(t["lineitem"], left_on="o_orderkey",
                           right_on="l_orderkey")
    df = df[df.l_shipmode.isin(["MAIL", "SHIP"])
            & (df.l_receiptdate >= pd.Timestamp("1994-01-01"))
            & (df.l_receiptdate < pd.Timestamp("1995-01-01"))]
    high = df.o_orderpriority.isin(["1-URGENT", "2-HIGH"])
    df = df.assign(high_line_count=high.astype(np.int64),
                   low_line_count=(~high).astype(np.int64))
    res = df.groupby("l_shipmode", as_index=False).agg(
        high_line_count=("high_line_count", "sum"),
        low_line_count=("low_line_count", "sum"))
    return res.sort_values("l_shipmode").reset_index(drop=True)


def oracle_q14(t, nr):
    df = t["lineitem"].merge(t["part"], left_on="l_partkey",
                             right_on="p_partkey")
    df = df[(df.l_shipdate >= pd.Timestamp("1995-09-01"))
            & (df.l_shipdate < pd.Timestamp("1995-10-01"))]
    rev = _rev(df)
    promo = rev.where(df.p_type.str.startswith("PROMO"), 0.0).sum()
    return pd.DataFrame({"promo_revenue": [100.0 * promo / rev.sum()]})


PUSHDOWN_ORACLES = {
    "basic_agg": oracle_basic_agg, "shipdate_range": oracle_shipdate_range,
    "q1": oracle_q1, "q3": oracle_q3, "q5": oracle_q5, "q6": oracle_q6,
    "q7": oracle_q7, "q8": oracle_q8, "q10": oracle_q10, "q12": oracle_q12,
    "q14": oracle_q14,
}
ORDERED = {"q1", "q3", "q5", "q7", "q8", "q10", "q12"}


@pytest.mark.parametrize("name", sorted(PUSHDOWN_ORACLES))
def test_tpch_query_differential(tenv, jctx, name):
    ctx, tables, nr = tenv
    sql = tpch.QUERIES[name]
    got = ctx.sql(sql).to_pandas()
    rec = ctx.history.entries()[-1]
    assert rec.stats["mode"] == sql_mode(jctx, sql), \
        f"{name} did not push down: {rec.stats['mode']}"
    want = PUSHDOWN_ORACLES[name](tables, nr)
    if name in ORDERED:
        assert_frames_equal(got, want, sort_by=[], rtol=1e-4)
    else:
        sort_by = [c for c in want.columns
                   if not np.issubdtype(want[c].to_numpy().dtype,
                                        np.floating)]
        assert_frames_equal(got, want, sort_by=sort_by, rtol=1e-4)


def test_invalid_join_not_collapsed(tctx, jctx):
    # joining part to customer directly is not an edge of the star
    sql = ("select p_type, count(*) from part p join customer c "
           "on p.p_partkey = c.c_custkey group by p_type")
    with pytest.raises(Exception):
        B.build(tctx, parse_select(sql))
    same_error(lambda: B.build(tctx, parse_select(sql)),
               lambda: JB.build(jctx, jparse_select(sql)))
