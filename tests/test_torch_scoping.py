"""JAX ``tests/test_scoping.py`` bound to the port: alias-scope
resolution for correlated self-references (planner/scoping.py).

The port runs with ``device="cpu"``; answers are held against the JAX
test's own pandas oracles (exact: every answer is a count or a string),
and the engine's decisions (a statement's mode, the errors and their
messages) against the JAX package's on the same statement and data.

Original notes:

The engine binds columns by globally-unique bare names (the reference's
star-schema contract, StarSchemaInfo.scala:127-165); Spark's analyzer
resolves alias qualifiers before the rewrite layer ever runs, so
``where s2.region = s.region`` is unambiguous there. Our parser keeps
the qualifier as metadata and this pass performs the capture-avoiding
rename that the engine's bare-name model needs — previously such
queries silently computed a GLOBAL inner aggregate (wrong answer, no
error).
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu_torch as sdot
from spark_druid_olap_tpu_torch.sql.lexer import SqlSyntaxError

from torch_twin import jax_context, same_error, sql_mode


@pytest.fixture(scope="module")
def ctx():
    rng = np.random.default_rng(11)
    n = 20_000
    df = pd.DataFrame({
        "ts": (np.datetime64("2021-01-01")
               + rng.integers(0, 365, n).astype("timedelta64[D]"))
        .astype("datetime64[ns]"),
        "cust": rng.choice([f"c{i:04d}" for i in range(3000)], n),
        "region": rng.choice(["east", "west", "north", "south"], n),
        "qty": rng.integers(1, 100, n).astype(np.int64),
    })
    c = sdot.Context(device="cpu")
    c.ingest_dataframe("sales", df, time_column="ts")
    c._test_df = df
    return c


@pytest.fixture(scope="module")
def jctx(ctx):
    """The JAX package's context over the same frame."""
    return jax_context(frames=[("sales", ctx._test_df, {"time_column": "ts"})])


def test_scalar_self_correlation(ctx):
    """qty > (correlated per-region avg): both sides of the correlation
    name the same column of the same table — the rewrite must keep the
    outer reference free instead of collapsing to region = region."""
    df = ctx._test_df
    got = ctx.sql(
        "select region, count(*) as n from sales s "
        "where qty > (select avg(qty) from sales s2 "
        "             where s2.region = s.region) "
        "group by region order by region").to_pandas()
    m = df.groupby("region")["qty"].mean()
    want = df[df.qty > df.region.map(m)].groupby("region").size()
    assert got["n"].tolist() == want.tolist()


def test_exists_self_correlation_string_residual(ctx):
    """EXISTS with an equality + '<>' residual, both self-referencing:
    previously 'region <> region' was constant-false and EXISTS dropped
    every row."""
    df = ctx._test_df
    got = ctx.sql(
        "select count(*) as n from sales s where exists "
        "(select 1 from sales s2 where s2.cust = s.cust "
        " and s2.qty > 90 and s2.region <> s.region)").to_pandas()
    hi = df[df.qty > 90]
    by = hi.groupby("cust")["region"].agg(set).to_dict()
    want = sum(1 for _, row in df.iterrows()
               if by.get(row.cust, set()) - {row.region})
    assert int(got["n"].iloc[0]) == want


def test_engine_string_minmax(ctx, jctx):
    """min/max over a non-numeric string dim: lexicographic via the
    sorted global dictionary's codes, decoded at output (previously the
    numeric-coercion LUT produced all-NaN)."""
    df = ctx._test_df
    sql = ("select cust, min(region) as mn, max(region) as mx "
           "from sales group by cust order by cust")
    got = ctx.sql(sql).to_pandas()
    assert ctx.history.entries()[-1].stats["mode"] == sql_mode(jctx, sql)
    want = df.groupby("cust").agg(mn=("region", "min"),
                                  mx=("region", "max")).reset_index()
    assert got["mn"].tolist() == want["mn"].tolist()
    assert got["mx"].tolist() == want["mx"].tolist()


def test_numeric_parsed_dim_minmax_unchanged(ctx):
    """A dim whose every dictionary entry parses numeric keeps Druid's
    numeric-coercion semantics (reference DruidDataSource coercion)."""
    rng = np.random.default_rng(3)
    n = 5_000
    df = pd.DataFrame({
        "ts": np.repeat(np.datetime64("2021-01-01"), n)
        .astype("datetime64[ns]"),
        "k": rng.choice(["a", "b"], n),
        "numstr": rng.choice(["1.5", "2.5", "10.0"], n).astype(object),
    })
    c = sdot.Context(device="cpu")
    c.ingest_dataframe("t", df, time_column="ts")
    got = c.sql("select k, min(numstr) as mn, max(numstr) as mx "
                "from t group by k order by k").to_pandas()
    # numeric coercion: 2.5 < 10.0 (lexicographic would say '10.0' < '2.5')
    assert got["mn"].tolist() == [1.5, 1.5]
    assert got["mx"].tolist() == [10.0, 10.0]


def test_published_tpch_q21_text():
    """The published TPC-H q21 (aliased lineitem self-joins in EXISTS)
    runs verbatim and matches the repo's manually-renamed variant."""
    from spark_druid_olap_tpu_torch.tools import tpch
    ctx = sdot.Context(device="cpu")
    tpch.setup_context(ctx, sf=0.002, target_rows=2048)
    q21_published = """
        select s_name, count(*) as numwait
        from supplier s join lineitem l1 on s.s_suppkey = l1.l_suppkey
             join orders o on o.o_orderkey = l1.l_orderkey
             join suppnation n on s.s_nationkey = n.sn_nationkey
        where o_orderstatus = 'F'
              and l1.l_receiptdate > l1.l_commitdate
              and sn_name = 'SAUDI ARABIA'
              and exists (select 1 from lineitem l2
                          where l2.l_orderkey = l1.l_orderkey
                                and l2.l_suppkey <> l1.l_suppkey)
              and not exists (select 1 from lineitem l3
                              where l3.l_orderkey = l1.l_orderkey
                                    and l3.l_suppkey <> l1.l_suppkey
                                    and l3.l_receiptdate > l3.l_commitdate)
        group by s_name order by numwait desc, s_name limit 100
    """
    got = ctx.sql(q21_published).to_pandas()
    want = ctx.sql(tpch.QUERIES["q21"]).to_pandas()
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True))


def test_table_name_hidden_by_inner_alias(ctx):
    """'from sales s2' HIDES the name 'sales' inside the subquery, so
    'sales.region' binds the OUTER scope (code-review r3 finding: it was
    silently bound to the aliased inner table, losing the correlation)."""
    df = ctx._test_df
    got = ctx.sql(
        "select region, count(*) as n from sales "
        "where qty > (select avg(qty) from sales s2 "
        "             where s2.region = sales.region) "
        "group by region order by region").to_pandas()
    m = df.groupby("region")["qty"].mean()
    want = df[df.qty > df.region.map(m)].groupby("region").size()
    assert got["n"].tolist() == want.tolist()


def test_inner_alias_shadows_outer(ctx):
    """Same alias reused inside the subquery: the inner binding wins
    (standard SQL scoping) — no rename, correlation stays inner-only."""
    df = ctx._test_df
    got = ctx.sql(
        "select count(*) as n from sales s where qty > "
        "(select avg(qty) from sales s where s.qty < 50)").to_pandas()
    want = (df.qty > df[df.qty < 50].qty.mean()).sum()
    assert int(got["n"].iloc[0]) == want


def test_correlated_ref_in_join_on_condition(ctx):
    """A shadowed correlated reference inside a nested JOIN ON condition
    is renamed too, and the host tier exposes enclosing-row scalars to
    ON-condition evaluation."""
    df = ctx._test_df
    aux = pd.DataFrame({
        "ts": np.repeat(np.datetime64("2021-01-01"), 10)
        .astype("datetime64[ns]"),
        "k": [f"k{i}" for i in range(10)], "v": range(10)})
    ctx.ingest_dataframe("aux_on", aux, time_column="ts")
    got = ctx.sql(
        "select count(*) as n from sales s where qty > "
        "(select avg(qty) from sales s2 where s2.region = s.region and "
        " exists (select 1 from aux_on a1 join aux_on a2 "
        "         on a1.k = a2.k and s2.region >= 'a'))").to_pandas()
    m = df.groupby("region")["qty"].mean()
    want = int((df.qty > df.region.map(m)).sum())  # EXISTS is always true
    assert int(got["n"].iloc[0]) == want


def test_shadowed_nonsimple_from_raises(ctx, jctx):
    """Shadowed self-reference whose subquery FROM is a join cannot be
    auto-renamed: a clear error beats a silently-global aggregate."""
    sql = ("select count(*) as n from sales s where qty > "
           "(select avg(s2.qty) from sales s2 join sales s3 "
           " on s2.cust = s3.cust where s2.region = s.region)")
    with pytest.raises(SqlSyntaxError, match="shadow"):
        ctx.sql(sql)
    same_error(lambda: ctx.sql(sql), lambda: jctx.sql(sql))


def test_exists_select_star_with_shadowing(ctx):
    """Official TPC-H q21 phrasing uses 'exists (select * ...)': EXISTS
    ignores its select list, so the shadow rename must accept it."""
    df = ctx._test_df
    got = ctx.sql(
        "select count(*) as n from sales where exists "
        "(select * from sales s2 where s2.region = sales.region "
        " and s2.qty > 90)").to_pandas()
    hot = set(df[df.qty > 90].region)
    want = int(df.region.isin(hot).sum())
    assert int(got["n"].iloc[0]) == want


def test_union_derived_inside_shadowed_subquery(ctx):
    """A union-bodied derived table nested in a shadow-renamed scope must
    not crash the reference scan."""
    df = ctx._test_df
    got = ctx.sql(
        "select count(*) as n from sales where qty > "
        "(select avg(qty) from sales s2 where s2.region = sales.region "
        " and exists (select 1 from (select qty as q2 from sales "
        "             union all select qty as q2 from sales) u "
        "             where u.q2 = s2.qty))").to_pandas()
    m = df.groupby("region")["qty"].mean()
    want = int((df.qty > df.region.map(m)).sum())  # exists always true
    assert int(got["n"].iloc[0]) == want


# -- same-scope self-joins (duplicate-column disambiguation) ------------------

def test_selfjoin_nonequi_condition(ctx):
    """t a join t b with a NON-equi qualified condition: without the
    duplicate rename both sides would collapse to the same bare name
    (x < x). The b-side duplicates rename through a derived wrap."""
    df = ctx._test_df
    got = ctx.sql(
        "select count(*) as c from sales a join sales b "
        "on a.cust = b.cust and a.qty < b.qty "
        "where a.region = b.region").to_pandas()
    m = df.merge(df, on="cust", suffixes=("_a", "_b"))
    want = int(((m.qty_a < m.qty_b)
                & (m.region_a == m.region_b)).sum())
    assert int(got["c"].iloc[0]) == want


def test_selfjoin_projects_both_sides(ctx):
    """Qualified projections from BOTH sides of a self-join survive the
    rename and group correctly."""
    df = ctx._test_df
    got = ctx.sql(
        "select a.region as ra, b.region as rb, count(*) as c "
        "from sales a join sales b on a.cust = b.cust "
        "and a.qty < b.qty group by a.region, b.region "
        "order by c desc limit 5").to_pandas()
    m = df.merge(df, on="cust", suffixes=("_a", "_b"))
    m = m[m.qty_a < m.qty_b]
    w = m.groupby(["region_a", "region_b"]).size() \
        .reset_index(name="c").sort_values("c", ascending=False).head(5)
    assert got["c"].tolist() == w["c"].tolist()


def test_selfjoin_without_distinct_aliases_raises(ctx, jctx):
    from spark_druid_olap_tpu_torch.sql.lexer import SqlSyntaxError
    sql = ("select count(*) as c from sales join sales "
           "on sales.qty < sales.qty")
    with pytest.raises(SqlSyntaxError, match="DISTINCT aliases"):
        ctx.sql(sql)
    same_error(lambda: ctx.sql(sql), lambda: jctx.sql(sql))


def test_star_convention_duplicates_untouched(ctx):
    """Bare references to columns duplicated across joined relations
    keep the legacy global-name bind (the star-schema convention — the
    flat index shares its dimension columns); only qualifier-
    distinguished duplicates rewrite."""
    df = ctx._test_df
    summary = df.groupby("region", as_index=False)["qty"].sum() \
        .rename(columns={"qty": "rq"})
    ctx.ingest_dataframe("regionsum",
                         summary.assign(region=summary.region))
    got = ctx.sql(
        "select region, count(*) as c from sales "
        "join regionsum on sales.region = regionsum.region "
        "group by region order by region").to_pandas()
    w = df.groupby("region").size()
    assert got["c"].tolist() == w.tolist()


def test_selfjoin_three_way_first_owner_exposure(ctx):
    """A wrapped middle leaf must keep exposing duplicated columns it
    FIRST-owns (a later leaf shares them): hiding them would unbind the
    first-owner reference (review-found 3-way case)."""
    import numpy as np
    import pandas as pd
    rng = np.random.default_rng(3)
    ctx.ingest_dataframe("jt1", pd.DataFrame({
        "x": rng.integers(0, 50, 500)}))
    ctx.ingest_dataframe("jt2", pd.DataFrame({
        "x": rng.integers(0, 50, 400), "z": rng.integers(0, 30, 400)}))
    ctx.ingest_dataframe("jt3", pd.DataFrame({
        "z": rng.integers(0, 30, 300)}))
    r = ctx.sql(
        "select a.x as ax, b.x as bx, b.z as bz, count(*) as n "
        "from jt1 a join jt2 b on a.x = b.x "
        "join jt3 c on b.z = c.z "
        "group by a.x, b.x, b.z order by ax, bx, bz limit 5").to_pandas()
    t1 = pd.DataFrame({"ax": np.asarray(
        ctx.store.get("jt1").metrics["x"].values)})
    # oracle via pandas on the same frames
    m = t1.merge(
        pd.DataFrame({
            "bx": np.asarray(ctx.store.get("jt2").metrics["x"].values),
            "bz": np.asarray(ctx.store.get("jt2").metrics["z"].values)}),
        left_on="ax", right_on="bx")
    m = m.merge(pd.DataFrame({
        "z": np.asarray(ctx.store.get("jt3").metrics["z"].values)}),
        left_on="bz", right_on="z")
    w = m.groupby(["ax", "bx", "bz"]).size().reset_index(name="n") \
        .sort_values(["ax", "bx", "bz"]).head(5)
    assert r.values.tolist() == w.values.tolist()
