"""JAX ``tests/test_rewrites.py`` bound to the port: planner rewrite
passes, semi/anti-join decorrelation, view merging, FrozenIntSet
membership filters, composite plans.

The port runs with ``device="cpu"``; answers are held against the port's
engine-free host tier, as the JAX test holds the JAX engine against its
own; each statement's mode is held equal to the JAX package's over the
same frames, and each rewritten AST equal (``repr``) to the JAX pass's
output on the same statement.

Original notes: planner rewrite passes.

≈ the reference relying on Spark's RewritePredicateSubquery /
CollapseProject normalizations running before DruidStrategy; here the
equivalents are explicit planner passes.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu_torch as sdot
from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.planner.decorrelate import decorrelate_semijoins
from spark_druid_olap_tpu_torch.planner.viewmerge import merge_derived
from spark_druid_olap_tpu_torch.sql import ast as A
from spark_druid_olap_tpu_torch.sql.parser import parse_select

from spark_druid_olap_tpu.planner.decorrelate import \
    decorrelate_semijoins as jdecorrelate_semijoins
from spark_druid_olap_tpu.planner.viewmerge import merge_derived as jmerge_derived
from spark_druid_olap_tpu.sql.parser import parse_select as jparse_select

from conftest import assert_frames_equal, make_sales_df
from torch_twin import mirrored, mode_as_jax


@pytest.fixture(scope="module")
def ctx():
    c = mirrored(sdot.Context(device="cpu"))
    c.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                       target_rows=4096)
    rng = np.random.default_rng(3)
    c.ingest_dataframe("events", pd.DataFrame({
        "e_region": rng.choice(["east", "west", "north"], 500),
        "e_qty": rng.integers(1, 100, 500),
    }))
    return c


# -- FrozenIntSet -------------------------------------------------------------

def test_frozen_int_set_semantics():
    s = E.FrozenIntSet([5, 1, 5, 9])
    assert len(s) == 3 and 5 in s and 2 not in s
    assert list(s) == [1, 5, 9]
    assert s == E.FrozenIntSet(np.array([9, 1, 5]))
    assert s != E.FrozenIntSet([1, 5])
    assert "sha=" in repr(s) and len(repr(s)) < 60


def test_frozen_int_set_engine_filter_differential(ctx):
    from spark_druid_olap_tpu_torch.ir.spec import (
        AggregationSpec, GroupByQuerySpec, DimensionSpec, InFilter)
    from spark_druid_olap_tpu_torch.planner.host_exec import datasource_frame
    sales = datasource_frame(ctx, "sales")
    keep = E.FrozenIntSet(range(10, 40))
    q = GroupByQuerySpec(
        datasource="sales",
        dimensions=(DimensionSpec("region", "region"),),
        aggregations=(AggregationSpec("count", "n"),),
        filter=InFilter("qty", keep))
    got = ctx.engine.execute(q).to_pandas()
    want = sales[sales.qty.isin(list(keep))].groupby(
        "region", as_index=False).agg(n=("qty", "size"))
    assert_frames_equal(got, want, sort_by=["region"])


def test_frozen_int_set_serde_roundtrip():
    from spark_druid_olap_tpu_torch.ir import serde
    from spark_druid_olap_tpu_torch.ir.spec import (
        AggregationSpec, GroupByQuerySpec, InFilter)
    q = GroupByQuerySpec(
        datasource="d", dimensions=(),
        aggregations=(AggregationSpec("count", "n"),),
        filter=InFilter("k", E.FrozenIntSet([3, 1, 2])))
    q2 = serde.query_from_json(serde.query_to_json(q))
    assert isinstance(q2.filter.values, E.FrozenIntSet)
    assert q2.filter.values == q.filter.values


# -- semi/anti-join decorrelation --------------------------------------------

def _exists_sql(negated):
    return ("select region, count(*) as n from sales where "
            + ("not " if negated else "")
            + "exists (select 1 from events where e_region = region "
            "and e_qty > 90) group by region")


def _exists_stmt(negated):
    return parse_select(_exists_sql(negated))


def _as_jax(ctx, rewrite, jrewrite, sql):
    """The port's rewrite of ``sql``, its AST equal to the JAX pass's."""
    s2 = rewrite(ctx, parse_select(sql))
    assert repr(s2) == repr(jrewrite(ctx.jax, jparse_select(sql)))
    return s2


def test_decorrelate_exists_to_semijoin(ctx):
    s2 = _as_jax(ctx, decorrelate_semijoins, jdecorrelate_semijoins,
                 _exists_sql(False))
    ins = s2.where
    assert isinstance(ins, A.InSubquery) and not ins.negated
    assert ins.query.distinct
    assert isinstance(ins.child, E.Column)


def test_decorrelate_not_exists_needs_nonnull_probe(ctx):
    s2 = _as_jax(ctx, decorrelate_semijoins, jdecorrelate_semijoins,
                 _exists_sql(True))
    # region (a non-null dim of sales) qualifies -> anti join
    assert isinstance(s2.where, A.InSubquery) and s2.where.negated


def test_decorrelated_exists_differential(ctx):
    from spark_druid_olap_tpu_torch.planner import host_exec
    sql = ("select region, count(*) as n from sales where "
           "exists (select 1 from events where e_region = region "
           "and e_qty > 90) group by region order by region")
    got = ctx.sql(sql).to_pandas()
    assert mode_as_jax(ctx, sql) == "engine"
    ctx.host_engine_assist = False
    try:
        want = host_exec.execute_select(ctx, parse_select(sql))
    finally:
        ctx.host_engine_assist = True
    assert_frames_equal(got, want, sort_by=None)


# -- view merging -------------------------------------------------------------

def test_merge_derived_flattens(ctx):
    sql = (
        "select r, sum(qty) as s from "
        "(select upper(region) as r, qty from sales where qty > 5) t "
        "where r <> 'EAST' group by r")
    s2 = _as_jax(ctx, merge_derived, jmerge_derived, sql)
    assert isinstance(s2.relation, A.TableRef)
    assert s2.relation.name == "sales"
    # inner + outer predicates combined
    assert isinstance(s2.where, E.And)


def test_merge_derived_keeps_alias(ctx):
    sql = (
        "select r, count(*) as n from "
        "(select upper(region) as r from sales) t group by r")
    s2 = _as_jax(ctx, merge_derived, jmerge_derived, sql)
    assert s2.items[0].alias == "r"


def test_merge_derived_skips_aggregated_inner(ctx):
    sql = (
        "select mx from (select max(qty) as mx from sales group by region) t")
    s2 = _as_jax(ctx, merge_derived, jmerge_derived, sql)
    assert isinstance(s2.relation, A.SubqueryRef)   # unchanged


def test_merged_view_runs_on_engine(ctx):
    from spark_druid_olap_tpu_torch.planner import host_exec
    sql = ("select r, sum(qty) as s from "
           "(select upper(region) as r, qty from sales where qty > 5) t "
           "group by r order by r")
    got = ctx.sql(sql).to_pandas()
    assert mode_as_jax(ctx, sql) == "engine"
    ctx.host_engine_assist = False
    try:
        want = host_exec.execute_select(ctx, parse_select(sql))
    finally:
        ctx.host_engine_assist = True
    assert_frames_equal(got, want, sort_by=None)


# -- composite plans ----------------------------------------------------------

def test_composite_agg_derived_join(ctx):
    # supplier-style outer join over an engine-planned derived aggregate
    from spark_druid_olap_tpu_torch.planner import host_exec
    ctx.ingest_dataframe("regions", pd.DataFrame({
        "r_name": ["east", "west", "north", "south"],
        "r_zone": ["Z1", "Z1", "Z2", "Z2"]}))
    sql = ("select r_zone, rev from regions join "
           "(select region, sum(price) as rev from sales group by region) t "
           "on r_name = region order by r_zone, rev")
    got = ctx.sql(sql).to_pandas()
    assert mode_as_jax(ctx, sql) == "engine"
    ctx.host_engine_assist = False
    try:
        want = host_exec.execute_select(ctx, parse_select(sql))
    finally:
        ctx.host_engine_assist = True
    assert_frames_equal(got, want, sort_by=None)


# -- residual predicates above the device scan --------------------------------
# (≈ ProjectFilterTransfom.addUnpushedAttributes + the FilterExec the
# reference leaves above the Druid scan, DruidStrategy.scala:244-270)

def _host_oracle(ctx, sql):
    from spark_druid_olap_tpu_torch.planner import host_exec
    ctx.host_engine_assist = False
    try:
        return host_exec.execute_select(ctx, parse_select(sql))
    finally:
        ctx.host_engine_assist = True


@pytest.fixture()
def tag2(ctx):
    # two-arg module functions have no device compilation path, so filters
    # over them are genuinely unpushable (host residue material)
    ctx.functions["tag2"] = lambda s, suffix: str(s) + str(suffix)
    yield
    ctx.functions.pop("tag2", None)


def test_residual_predicate_on_grouped_dim(ctx, tag2):
    sql = ("select region, sum(qty) as s from sales "
           "where qty > 5 and tag2(region, '!') in ('east!', 'west!') "
           "group by region order by region")
    got = ctx.sql(sql).to_pandas()
    assert mode_as_jax(ctx, sql) == "engine"
    assert set(got["region"]) == {"east", "west"}
    assert_frames_equal(got, _host_oracle(ctx, sql), sort_by=None)


def test_residual_predicate_with_order_limit(ctx, tag2):
    sql = ("select region, sum(qty) as s from sales "
           "where tag2(region, '!') <> 'east!' "
           "group by region order by s desc limit 2")
    got = ctx.sql(sql).to_pandas()
    assert mode_as_jax(ctx, sql) == "engine"
    assert "east" not in set(got["region"]) and len(got) == 2
    assert_frames_equal(got, _host_oracle(ctx, sql), sort_by=None)


def test_residual_on_nongrouped_column_falls_back(ctx):
    # a row-level residue over a non-grouped column cannot be applied to
    # the aggregated result: whole query demotes (correctness > speed).
    # (two-arg module functions have no device compilation path)
    ctx.functions["fuzz2"] = lambda a, b: float(a) * 3 + float(b)
    try:
        sql = ("select region, count(*) as n from sales "
               "where fuzz2(qty, discount) > 100 "
               "group by region order by region")
        got = ctx.sql(sql).to_pandas()
        assert mode_as_jax(ctx, sql).startswith("host")
        assert_frames_equal(got, _host_oracle(ctx, sql), sort_by=None)
    finally:
        ctx.functions.pop("fuzz2", None)


def test_residual_select_path_hidden_column(ctx, tag2):
    # residue references qty, which is NOT selected: fetched hidden,
    # dropped from the output
    sql = ("select ts, region from sales "
           "where region = 'east' and tag2(qty, '') = '49' "
           "limit 7")
    got = ctx.sql(sql).to_pandas()
    assert mode_as_jax(ctx, sql) == "engine"
    assert list(got.columns) == ["ts", "region"]
    assert len(got) == 7
    want = _host_oracle(ctx, sql)
    assert len(want) == 7


def test_residual_select_path_differential(ctx, tag2):
    sql = ("select region, qty from sales "
           "where qty > 40 and tag2(region, '') = 'west' order by qty desc "
           "limit 20")
    got = ctx.sql(sql).to_pandas()
    assert mode_as_jax(ctx, sql) == "engine"
    want = _host_oracle(ctx, sql)
    assert_frames_equal(got.sort_values(["region", "qty"]).reset_index(drop=True),
                        want.sort_values(["region", "qty"]).reset_index(drop=True),
                        sort_by=None)


def test_merge_derived_skips_outer_star(ctx):
    got = ctx.sql("select * from (select region from sales) t limit 3") \
        .to_pandas()
    assert list(got.columns) == ["region"]


def test_leftjoin_agg_nonunique_key_falls_back(ctx):
    ctx.ingest_dataframe("dupkeys", pd.DataFrame({
        "k": ["east", "east", "west"], "tag": ["a", "b", "c"]}))
    sql = ("select k, n from (select k, count(qty) as n from dupkeys "
           "left outer join sales on k = region group by k) t order by k")
    got = ctx.sql(sql).to_pandas()
    assert mode_as_jax(ctx, sql).startswith("host")
    want = _host_oracle(ctx, sql)
    assert_frames_equal(got, want, sort_by=None)


def test_leftjoin_agg_inner_limit_falls_back(ctx):
    ctx.ingest_dataframe("ukeys", pd.DataFrame({
        "k": ["east", "west", "north", "south"]}))
    sql = ("select k, n from (select k, count(qty) as n from ukeys "
           "left outer join sales on k = region group by k "
           "order by n desc limit 2) t order by k")
    got = ctx.sql(sql).to_pandas()
    want = _host_oracle(ctx, sql)
    assert len(got) == 2
    assert_frames_equal(got, want, sort_by=None)


def test_leftjoin_agg_engine_differential(ctx):
    if "ukeys" not in ctx.store.names():
        ctx.ingest_dataframe("ukeys", pd.DataFrame({
            "k": ["east", "west", "north", "south"]}))
    sql = ("select k, n, s from (select k, count(qty) as n, "
           "sum(qty) as s from ukeys left outer join sales "
           "on k = region and qty > 25 group by k) t order by k")
    got = ctx.sql(sql).to_pandas()
    assert mode_as_jax(ctx, sql) == "engine"
    want = _host_oracle(ctx, sql)
    assert_frames_equal(got, want, sort_by=None)


def test_alias_collision_with_residue_column_falls_back(ctx, tag2):
    # 'qty AS region' + a residue needing the real 'region' column would
    # duplicate the label after renaming; host tier handles it
    sql = ("select qty as region from sales "
           "where tag2(region, '!') = 'east!' limit 5")
    got = ctx.sql(sql).to_pandas()
    assert list(got.columns) == ["region"]
    assert len(got) == 5
