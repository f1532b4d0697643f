"""JAX ``tests/test_correlated.py`` bound to the port: correlated-subquery
inlining, KeyedLookup broadcast joins.

The port runs with ``device="cpu"`` against the JAX test's pandas oracles
at its own tolerance; each statement's mode and the EXPLAIN text are held
equal to the JAX package's on the same frame. The JAX file's two mesh
cases (``test_correlated_sharded_matches_single``,
``test_correlated_two_key_sharded``) are in ``test_torch_sharded.py``.

Original notes:

Reference parity: Spark's RewriteCorrelatedScalarSubquery +
RewritePredicateSubquery give the reference engine-pushable plans for
TPC-H q2/q17/q21-shaped correlated predicates
(the reference leaves subqueries to Spark — SURVEY.md §2.3); here the
decorrelated per-key aggregate becomes a device gather
(``E.KeyedLookup``), keeping the OUTER query on the engine.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu_torch as sdot
from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.utils import host_eval

from torch_twin import jax_context, sql_mode


N = 30_000
N_PART = 400
N_SUPP = 50


@pytest.fixture(scope="module")
def cctx():
    rng = np.random.default_rng(31)
    ts = (np.datetime64("2019-01-01")
          + rng.integers(0, 365, N).astype("timedelta64[D]"))
    df = pd.DataFrame({
        "ts": ts.astype("datetime64[ns]"),
        "partkey": rng.integers(1, N_PART + 1, N),
        "suppkey": rng.integers(1, N_SUPP + 1, N),
        "qty": rng.integers(1, 51, N).astype(np.int64),
        "price": np.round(rng.uniform(1, 100, N), 2),
    })
    c = sdot.Context(device="cpu")
    c.ingest_dataframe("fact", df, time_column="ts", target_rows=4096)
    c._test_df = df
    return c


@pytest.fixture(scope="module")
def jctx(cctx):
    """The JAX package's context over the same frame."""
    return jax_context(frames=[("fact", cctx._test_df,
                                {"time_column": "ts", "target_rows": 4096})])


def _mode(ctx):
    return ctx.history.entries()[-1].stats["mode"]


def _run(cctx, jctx, sql):
    """The statement on the port, its mode equal to the JAX package's."""
    got = cctx.sql(sql)
    assert _mode(cctx) == sql_mode(jctx, sql), sql
    return got


def test_correlated_scalar_avg_pushes(cctx, jctx):
    """TPC-H q17 shape: qty < 0.5*avg(qty per part) runs mode=engine."""
    df = cctx._test_df
    got = _run(cctx, jctx,
        "select sum(price) as s from fact "
        "where qty < (select 0.5 * avg(f2_qty) from "
        "  (select partkey as f2_partkey, qty as f2_qty from fact) f2 "
        "             where f2_partkey = partkey)").to_pandas()
    thr = df.groupby("partkey")["qty"].mean() * 0.5
    want = df[df.qty < df.partkey.map(thr)]["price"].sum()
    np.testing.assert_allclose(float(got["s"][0]), want, rtol=1e-5)


def test_correlated_scalar_min_eq(cctx, jctx):
    """TPC-H q2 shape: price = (select min(price) per part)."""
    df = cctx._test_df
    got = _run(cctx, jctx,
        "select count(*) as n from fact "
        "where price = (select min(f2_price) from "
        "  (select partkey as f2_partkey, price as f2_price from fact) f2 "
        "               where f2_partkey = partkey)").to_pandas()
    mn = df.groupby("partkey")["price"].min()
    want = int((df.price == df.partkey.map(mn)).sum())
    assert int(got["n"][0]) == want


def test_exists_neq_minmax(cctx, jctx):
    """TPC-H q21 shape: EXISTS(same part, different supplier)."""
    df = cctx._test_df
    got = _run(cctx, jctx,
        "select count(*) as n from fact where qty > 40 and exists "
        "(select 1 from (select partkey as f2_partkey, suppkey as f2_suppkey "
        "  from fact) f2 where f2_partkey = partkey "
        " and f2_suppkey <> suppkey)").to_pandas()
    g = df.groupby("partkey")["suppkey"].agg(["min", "max"])
    sub = df[df.qty > 40]
    mnv = sub.partkey.map(g["min"])
    mxv = sub.partkey.map(g["max"])
    want = int(((mnv != sub.suppkey) | (mxv != sub.suppkey)).sum())
    assert int(got["n"][0]) == want


def test_not_exists_ordered_minmax(cctx, jctx):
    """NOT EXISTS with an ordered residual (f2.qty > qty)."""
    df = cctx._test_df
    got = _run(cctx, jctx,
        "select count(*) as n from fact where not exists "
        "(select 1 from (select partkey as f2_partkey, qty as f2_qty "
        "  from fact) f2 where f2_partkey = partkey "
        " and f2_qty > qty)").to_pandas()
    mx = df.groupby("partkey")["qty"].max()
    want = int((~(df.partkey.map(mx) > df.qty)).sum())
    assert int(got["n"][0]) == want


def test_correlated_scalar_missing_key_is_null(cctx, jctx):
    """Rows whose key has no inner group see NULL (comparison false)."""
    df = cctx._test_df
    got = _run(cctx, jctx,
        "select count(*) as n from fact "
        "where qty < (select avg(f2_qty) from "
        "  (select partkey as f2_partkey, qty as f2_qty from fact) f2 "
        "             where f2_partkey = partkey and f2_qty > 49)") \
        .to_pandas()
    thr = df[df.qty > 49].groupby("partkey")["qty"].mean()
    mapped = df.partkey.map(thr)
    want = int((df.qty < mapped).sum())    # NaN compares false
    assert int(got["n"][0]) == want


def test_correlated_count_empty_group_is_zero(cctx, jctx):
    """COUNT over an empty correlation group is 0, not NULL: rows whose
    key has no qualifying inner rows must still pass 'count < 5'."""
    df = cctx._test_df
    got = _run(cctx, jctx,
        "select count(*) as n from fact "
        "where 5 > (select count(*) from "
        "  (select partkey as f2_partkey, qty as f2_qty from fact) f2 "
        "           where f2_partkey = partkey and f2_qty > 50)") \
        .to_pandas()
    cnt = df[df.qty > 50].groupby("partkey").size()
    mapped = df.partkey.map(cnt).fillna(0)
    want = int((mapped < 5).sum())
    assert int(got["n"][0]) == want


def test_correlated_neq_not_inlined(cctx):
    """'<>' against a scalar subquery: NaN-coded NULL would evaluate
    True under IEEE !=, so the walker must NOT inline — the host tier
    answers with exact 3VL semantics."""
    df = cctx._test_df
    got = cctx.sql(
        "select count(*) as n from fact "
        "where qty <> (select max(f2_qty) from "
        "  (select partkey as f2_partkey, qty as f2_qty from fact) f2 "
        "              where f2_partkey = partkey and f2_qty > 50)") \
        .to_pandas()
    # no qualifying inner rows anywhere -> subquery NULL -> UNKNOWN ->
    # every row dropped
    assert int(got["n"][0]) == 0


def test_correlated_not_comparison_not_inlined(cctx):
    """NOT (x > sub): a NaN miss under NOT would flip into a spurious
    keep; the polarity walker must leave it to the host tier."""
    df = cctx._test_df
    got = cctx.sql(
        "select count(*) as n from fact "
        "where not (qty > (select min(f2_qty) from "
        "  (select partkey as f2_partkey, qty as f2_qty from fact) f2 "
        "                  where f2_partkey = partkey and f2_qty > 50))") \
        .to_pandas()
    # subquery NULL everywhere -> NOT UNKNOWN = UNKNOWN -> all dropped
    assert int(got["n"][0]) == 0


def test_keyed_lookup_null_keys_miss():
    """NULL keys (NaN on host) take the miss value, never key 0's
    group."""
    tab = E.FrozenKeyedTable(np.array([0, 1]), np.array([99., 10.]))
    e = E.KeyedLookup(E.Column("k"), tab)
    out = host_eval.eval_expr(
        e, {"k": np.array([0.0, np.nan, 1.0])})
    np.testing.assert_array_equal(out[[0, 2]], [99., 10.])
    assert np.isnan(out[1])
    e0 = E.KeyedLookup(E.Column("k"), tab, default=0.0)
    out0 = host_eval.eval_expr(
        e0, {"k": np.array([np.nan, 5.0])})
    np.testing.assert_array_equal(out0, [0.0, 0.0])



def test_nullable_outer_column_guarded():
    """A comparison over a NULLABLE outer column must not read the
    zero-filled device payload: NULL rows drop (SQL UNKNOWN), matching
    pandas."""
    rng = np.random.default_rng(7)
    n = 20_000
    qty = rng.integers(1, 50, n).astype(float)
    qty[rng.random(n) < 0.2] = np.nan          # nullable
    df = pd.DataFrame({
        "ts": (np.datetime64("2019-01-01")
               + rng.integers(0, 365, n).astype("timedelta64[D]"))
        .astype("datetime64[ns]"),
        "partkey": rng.integers(1, 200, n),
        "qty": qty,
    })
    c = sdot.Context(device="cpu")
    c.ingest_dataframe("fact", df, time_column="ts", target_rows=4096)
    got = c.sql(
        "select count(*) as n from fact "
        "where qty < (select avg(f2_qty) from "
        "  (select partkey as f2_partkey, qty as f2_qty from fact) f2 "
        "             where f2_partkey = partkey)").to_pandas()
    thr = df.groupby("partkey")["qty"].mean()
    want = int((df.qty < df.partkey.map(thr)).sum())   # NaN -> False
    assert int(got["n"][0]) == want
    # NOT EXISTS with a nullable outer probe
    got2 = c.sql(
        "select count(*) as n from fact where not exists "
        "(select 1 from (select partkey as f2_partkey, qty as f2_qty "
        "  from fact) f2 where f2_partkey = partkey "
        " and f2_qty > qty)").to_pandas()
    mx = df.groupby("partkey")["qty"].max()
    want2 = int((~(df.partkey.map(mx) > df.qty)).sum())
    assert int(got2["n"][0]) == want2


def test_correlated_two_key_scalar(cctx, jctx):
    """TPC-H q20 shape: the scalar subquery correlates on TWO keys —
    composite-key broadcast join (KeyedLookup2, pair binary search on
    device)."""
    df = cctx._test_df
    got = _run(cctx, jctx,
        "select count(*) as n from fact "
        "where qty > (select 0.5 * avg(f2_qty) from "
        "  (select partkey as f2_pk, suppkey as f2_sk, qty as f2_qty "
        "   from fact) f2 "
        "  where f2_pk = partkey and f2_sk = suppkey)").to_pandas()
    thr = df.groupby(["partkey", "suppkey"])["qty"].mean() * 0.5
    mapped = pd.MultiIndex.from_arrays([df.partkey, df.suppkey]) \
        .map(thr)
    want = int((df.qty.to_numpy() > np.asarray(mapped)).sum())
    assert int(got["n"][0]) == want



def test_explain_correlated_never_executes(cctx, jctx):
    """EXPLAIN on a correlated query reports the deferred inlining and
    dispatches NO engine queries (no history pollution)."""
    sql = ("explain rewrite select count(*) from fact "
           "where qty < (select avg(f2_qty) from "
           "  (select partkey as f2_partkey, qty as f2_qty from fact) f2 "
           "             where f2_partkey = partkey)")
    before = len(cctx.history.entries())
    out = cctx.sql(sql).to_pandas()
    text = "\n".join(str(v) for v in out.iloc[:, 0])
    assert "DEFERRED" in text and "KeyedLookup" in text
    assert len(cctx.history.entries()) == before
    jout = jctx.sql(sql).to_pandas()
    assert text == "\n".join(str(v) for v in jout.iloc[:, 0])


def test_keyed_lookup_host_eval():
    tab = E.FrozenKeyedTable(np.array([3, 1, 7]), np.array([30., 10., 70.]))
    e = E.KeyedLookup(E.Column("k"), tab)
    out = host_eval.eval_expr(e, {"k": np.array([1, 2, 3, 7, -5])})
    np.testing.assert_array_equal(np.isnan(out), [False, True, False,
                                                  False, True])
    np.testing.assert_array_equal(out[[0, 2, 3]], [10., 30., 70.])


def test_keyed_lookup_repr_is_o1():
    tab = E.FrozenKeyedTable(np.arange(1_000_000),
                             np.arange(1_000_000, dtype=np.float64))
    r = repr(E.KeyedLookup(E.Column("k"), tab))
    assert len(r) < 200
    tab2 = E.FrozenKeyedTable(np.arange(1_000_000),
                              np.arange(1_000_000, dtype=np.float64))
    assert tab == tab2 and hash(tab) == hash(tab2)


def test_subquery_cache_invalidated_by_ingest(cctx):
    """Cached inner results key on store.version: re-ingest must not
    serve stale subquery results."""
    import spark_druid_olap_tpu_torch as sdot
    rng = np.random.default_rng(3)
    n = 5_000

    def mk(scale):
        return pd.DataFrame({
            "ts": (np.datetime64("2019-01-01")
                   + rng.integers(0, 100, n).astype("timedelta64[D]"))
            .astype("datetime64[ns]"),
            "k": rng.integers(1, 50, n),
            "q": (rng.integers(1, 10, n) * scale).astype(np.int64),
        })
    c = sdot.Context(device="cpu")
    c.ingest_dataframe("f", mk(1), time_column="ts", target_rows=1024)
    sql = ("select count(*) as n from f "
           "where q > (select avg(i_q) from "
           "  (select k as i_k, q as i_q from f) i where i_k = k)")
    first = int(c.sql(sql).to_pandas()["n"][0])
    assert first == int(c.sql(sql).to_pandas()["n"][0])   # warm hit
    # re-ingest constant data -> the answer must be exactly recomputed
    d = pd.DataFrame({
        "ts": pd.to_datetime(["2019-01-01"] * 4),
        "k": [1, 1, 2, 2], "q": [1, 3, 5, 5]})
    c.ingest_dataframe("f", d, time_column="ts", target_rows=1024)
    out = int(c.sql(sql).to_pandas()["n"][0])
    # per-key avgs: k1 -> 2 (q=3 passes), k2 -> 5 (none pass)
    assert out == 1


def test_subquery_cache_invalidated_by_config():
    """The cache folds in the session config fingerprint: a timezone
    change must never serve inner results computed under the old tz."""
    import spark_druid_olap_tpu_torch as sdot
    ts = pd.to_datetime(["2019-01-01 20:00"] * 2 + ["2019-01-02 20:00"] * 2)
    df = pd.DataFrame({"ts": ts, "k": [1, 1, 1, 1],
                       "q": [1, 1, 2, 2]})
    c = sdot.Context(device="cpu")
    c.ingest_dataframe("f", df, time_column="ts", target_rows=1024)
    sql = ("select count(*) as n from f "
           "where q <= (select max(day(i_ts)) from "
           "  (select k as i_k, ts as i_ts from f) i where i_k = k)")
    utc = int(c.sql(sql).to_pandas()["n"][0])     # max day = 2 (UTC)
    assert utc == 4
    c.config.set("sdot.timezone", "Asia/Kolkata")  # 20:00 UTC -> next day
    local = int(c.sql(sql).to_pandas()["n"][0])    # max day = 3
    assert local == 4
    # sharper: threshold sits between the two answers
    sql2 = ("select count(*) as n from f "
            "where 3 <= (select max(day(i_ts)) from "
            "  (select k as i_k, ts as i_ts from f) i where i_k = k)")
    c2 = sdot.Context(device="cpu")
    c2.ingest_dataframe("f", df, time_column="ts", target_rows=1024)
    assert int(c2.sql(sql2).to_pandas()["n"][0]) == 0   # UTC: max day 2
    c2.config.set("sdot.timezone", "Asia/Kolkata")
    assert int(c2.sql(sql2).to_pandas()["n"][0]) == 4   # local: max day 3
