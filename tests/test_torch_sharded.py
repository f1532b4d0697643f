"""Sharded statements of the port against the JAX package's sharded ones
and the port's single-device ones.

From JAX ``tests/test_sharded.py`` (the dry-run suite of
``__graft_entry__.DRYRUN_SUITE`` over TPC-H's flat index, sharded and
wave-bounded; exact count distinct; a semijoin membership filter; UNION
ALL and CTE branches; session-timezone bucketing),
``test_topn.py::test_topk_sharded``,
``test_compact.py::test_sharded_compaction_matches``,
``test_sorted_groupby.py::test_sorted_run_sharded_matches``,
``test_advice_r2.py::test_sharded_exchange_min_near_sentinel`` and
``test_correlated.py``'s two sharded cases. The port's mesh is
``("cpu",) * 8`` (``parallel/mesh.py``), JAX's its emulated 8-device CPU
mesh; the cost model is off on both, so every statement shards (the
stats say ``sharded``).

Tolerance: dimensions, integers, counts, min / max and sketch estimates
exact; float sums rtol 1e-9 against the port's single device (both sum
float64) and rtol 1e-5 against the JAX package, the JAX test's own.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import dataclasses

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.parallel.mesh import make_mesh as jmake_mesh
from spark_druid_olap_tpu.tools import tpch as jtpch

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.parallel.executor import QueryEngine as TEngine
from spark_druid_olap_tpu_torch.parallel.mesh import make_mesh
from spark_druid_olap_tpu_torch.planner import builder as TB
from spark_druid_olap_tpu_torch.segment.ingest import \
    ingest_dataframe as tingest
from spark_druid_olap_tpu_torch.segment.store import SegmentStore as TStore
from spark_druid_olap_tpu_torch.sql.parser import parse_select as tparse
from spark_druid_olap_tpu_torch.tools import tpch as ttpch
from spark_druid_olap_tpu_torch.utils.config import Config as TConfig

from __graft_entry__ import DRYRUN_SUITE
from conftest import make_sales_df

CPU_MESH = ("cpu",) * 8
SINGLE_RTOL = 1e-9
JAX_RTOL = 1e-5
OFF = {"sdot.querycostmodel.enabled": False}


def _mesh():
    return make_mesh(devices=CPU_MESH)


def _conf(extra=None):
    base = {**OFF, "sdot.engine.groupby.dense.max.keys": 1024}
    base.update(extra or {})
    return base


def assert_answers(got: pd.DataFrame, want: pd.DataFrame, ordered,
                   rtol, metric=None):
    """Same columns and rows; floats within ``rtol``, everything else
    exact. Unordered answers sort by every column first; ``metric``: an
    ordered limit whose ties may pick other rows, compared by the
    metric's sorted values."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    if metric is not None:
        np.testing.assert_allclose(
            np.sort(got[metric].to_numpy().astype(np.float64)),
            np.sort(want[metric].to_numpy().astype(np.float64)), rtol=rtol)
        return
    if not ordered:
        cols = list(want.columns)
        got = got.sort_values(cols, kind="mergesort", na_position="last") \
            .reset_index(drop=True)
        want = want.sort_values(cols, kind="mergesort",
                                na_position="last").reset_index(drop=True)
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if w.dtype.kind == "f" or g.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), rtol=rtol,
                                       err_msg=c)
        elif w.dtype.kind == "O":
            # None and NaN both spell SQL NULL in object columns
            np.testing.assert_array_equal(
                pd.Series(g).fillna("<null>").to_numpy(),
                pd.Series(w).fillna("<null>").to_numpy(), err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


def _stats(ctx):
    return ctx.history.entries()[-1].stats


# -- the dry-run suite over TPC-H's flat index ---------------------------------

@pytest.fixture(scope="module")
def trio():
    """(port mesh, port single device, JAX mesh) over TPC-H SF 0.002."""
    tm = tsdot.Context(config=_conf(), mesh=_mesh())
    ts = tsdot.Context(config=_conf({"sdot.querycostmodel.enabled": True}),
                       device="cpu")
    jm = jsdot.Context(config=_conf(), mesh=jmake_mesh())
    for c, t in ((tm, ttpch), (ts, ttpch), (jm, jtpch)):
        t.setup_context(c, sf=0.002, target_rows=1024, flat_only=True)
    return tm, ts, jm


@pytest.mark.parametrize("name", sorted(DRYRUN_SUITE))
def test_sharded_matches_single_device_and_jax(trio, name):
    tm, ts, jm = trio
    sql = DRYRUN_SUITE[name]
    got = tm.sql(sql).to_pandas()
    st = _stats(tm)
    assert st["mode"] == "engine", (name, st["mode"])
    assert st.get("sharded") is True, (name, st)
    if name == "hashed_highcard":
        assert st.get("hashed") is True
    ordered = "order by" in sql.lower()
    metric = "s" if name == "topn" else None
    assert_answers(got, ts.sql(sql).to_pandas(), ordered, SINGLE_RTOL,
                   metric)
    want = jm.sql(sql).to_pandas()
    assert _stats(jm).get("sharded") is True
    assert_answers(got, want, ordered, JAX_RTOL, metric)


def test_sharded_waves_match_single_device(trio):
    """Sharded AND wave-bounded: each wave's merge over the slots
    composes with the merge across the waves on the host."""
    tm, ts, jm = trio
    tm.config.set("sdot.engine.wave.max.bytes", 1)
    try:
        sql = DRYRUN_SUITE["q1_dense"]
        got = tm.sql(sql).to_pandas()
        st = _stats(tm)
        assert st.get("sharded") is True and st["waves"] > 1
        assert st["segments_per_wave"] % 8 == 0
        assert_answers(got, ts.sql(sql).to_pandas(), False, SINGLE_RTOL)
        assert_answers(got, jm.sql(sql).to_pandas(), False, JAX_RTOL)
    finally:
        tm.config.set("sdot.engine.wave.max.bytes", 0)
        tm.engine.clear_caches()


@pytest.mark.parametrize("sql", [
    "select l_returnflag, count(distinct c_custkey) as dc "
    "from tpch_flat group by l_returnflag order by l_returnflag",
    # decorrelated EXISTS -> FrozenIntSet membership filter on the mesh
    "select l_returnflag, count(*) as n from tpch_flat "
    "where exists (select 1 from tpch_flat f2 "
    "where f2.o_orderkey = o_orderkey and l_quantity > 45) "
    "group by l_returnflag order by l_returnflag"],
    ids=["count_distinct", "semijoin"])
def test_sharded_statements_of_the_flat_index(trio, sql):
    tm, ts, jm = trio
    got = tm.sql(sql).to_pandas()
    assert _stats(tm)["mode"] == "engine"
    assert_answers(got, ts.sql(sql).to_pandas(), True, SINGLE_RTOL)
    assert_answers(got, jm.sql(sql).to_pandas(), True, JAX_RTOL)


def test_sharded_union_and_cte():
    """UNION ALL and CTE branches plan on their own over the mesh."""
    df = make_sales_df(12_000)
    sql = ("with o as (select region, sum(qty) as s from sales "
           "           where status = 'O' group by region) "
           "select region, s from o "
           "union all "
           "select region, sum(qty) as s from sales where status = 'F' "
           "group by region order by region, s")
    m = tsdot.Context(OFF, mesh=_mesh())
    j = jsdot.Context(OFF, mesh=jmake_mesh())
    for c in (m, j):
        c.ingest_dataframe("sales", df, time_column="ts", target_rows=2048)
    got = m.sql(sql).to_pandas()
    a = df[df.status == "O"].groupby("region")["qty"].sum()
    b = df[df.status == "F"].groupby("region")["qty"].sum()
    np.testing.assert_array_equal(np.sort(got["s"].to_numpy()),
                                  np.sort(pd.concat([a, b]).to_numpy()))
    assert_answers(got, j.sql(sql).to_pandas(), True, JAX_RTOL)


def test_sharded_timezone_bucketing():
    """A session timezone shifts granularity buckets alike on the mesh."""
    rng = np.random.default_rng(9)
    n = 8_000
    ts = (np.datetime64("2021-03-10T00:00")
          + rng.integers(0, 96, n) * np.timedelta64(1, "h"))
    df = pd.DataFrame({"ts": ts.astype("datetime64[ns]"),
                       "v": rng.integers(1, 10, n)})
    cfg = {"sdot.timezone": "America/New_York", **OFF}
    single = tsdot.Context(dict(cfg), device="cpu")
    mesh = tsdot.Context(dict(cfg), mesh=_mesh())
    jmesh = jsdot.Context(dict(cfg), mesh=jmake_mesh())
    for c in (single, mesh, jmesh):
        c.ingest_dataframe("t", df, time_column="ts", target_rows=1024)
    q = ("select year(ts) as y, month(ts) as m, day(ts) as d, "
         "sum(v) as s from t group by year(ts), month(ts), day(ts) "
         "order by y, m, d")
    got = mesh.sql(q).to_pandas()
    assert _stats(mesh).get("sharded") is True
    pd.testing.assert_frame_equal(single.sql(q).to_pandas(), got,
                                  check_dtype=False)
    assert_answers(got, jmesh.sql(q).to_pandas(), True, JAX_RTOL)


# -- device top-k, compaction, the sorted run, the exchange ---------------------

def test_topk_sharded():
    """Dense device top-k after the merge over the slots (JAX
    ``test_topn.py``'s frame: 12,000 keys, sums past 2^24)."""
    rng = np.random.default_rng(23)
    n = 60_000
    df = pd.DataFrame({
        "ts": (np.datetime64("2020-01-01")
               + rng.integers(0, 365, n).astype("timedelta64[D]"))
        .astype("datetime64[ns]"),
        "cust": rng.choice([f"c{i:05d}" for i in range(12_000)], n),
        "qty": rng.integers(1, 100, n).astype(np.int64),
        "big": rng.integers(2**25, 2**40, n),
        "price": np.round(rng.uniform(1, 500, n), 2)})
    store = TStore()
    store.register(tingest("fact", df, time_column="ts", target_rows=8192))
    aggs = (TS.AggregationSpec("longsum", "s_qty", field="qty"),
            TS.AggregationSpec("longsum", "s_big", field="big"),
            TS.AggregationSpec("longmax", "mx_big", field="big"),
            TS.AggregationSpec("doublesum", "s_price", field="price"),
            TS.AggregationSpec("count", "n"))
    q = TS.GroupByQuerySpec(
        "fact", (TS.DimensionSpec("cust", "cust"),), aggs,
        limit=TS.LimitSpec((TS.OrderByColumn("s_big", ascending=False),),
                           10))
    eng = TEngine(store, config=TConfig(OFF), device="cpu", mesh=_mesh())
    got = eng.execute(q).to_pandas()
    assert eng.last_stats["topk_device"] > 0
    assert eng.last_stats["sharded"] is True
    want = df.groupby("cust", as_index=False).agg(
        s_qty=("qty", "sum"), s_big=("big", "sum"), mx_big=("big", "max"),
        s_price=("price", "sum"), n=("qty", "size")) \
        .sort_values("s_big", ascending=False, kind="stable").head(10)
    np.testing.assert_array_equal(got["s_big"].to_numpy(),
                                  want["s_big"].to_numpy())
    single = TEngine(store, device="cpu").execute(q).to_pandas()
    assert_answers(got, single, True, SINGLE_RTOL)


def test_sharded_compaction_matches():
    """Late materialization in every slot, its budget the slot's share:
    the same answer as one device without compaction."""
    rng = np.random.default_rng(7)
    n = 12_000
    df = pd.DataFrame({
        "ts": pd.Timestamp("2020-01-01")
        + pd.to_timedelta(rng.integers(0, 90, n), unit="D"),
        "region": rng.choice(["east", "west", "north", "south"], n),
        "sku": rng.choice([f"sku{i:03d}" for i in range(50)], n),
        "qty": rng.integers(0, 100, n),
        "price": np.round(rng.random(n) * 50, 2)})
    mesh_ctx = tsdot.Context(mesh=_mesh())
    mesh_ctx.config.set("sdot.engine.scan.compact.min.rows", 0)
    plain = tsdot.Context(device="cpu")
    plain.config.set("sdot.engine.scan.compact", False)
    for c in (mesh_ctx, plain):
        c.ingest_dataframe("sales", df, time_column="ts", target_rows=1024)
    sql = ("select region, sum(qty) as s, count(*) as n from sales "
           "where sku = 'sku007' group by region order by region")
    # the query context forces the sharded path (the cost model is on)
    q = TB.build(mesh_ctx, tparse(sql)).specs[0]
    q = dataclasses.replace(q, context=dataclasses.replace(
        q.context or TS.QueryContext(), prefer_sharded=True))
    r = mesh_ctx.engine.execute(q).to_pandas()
    st = dict(mesh_ctx.engine.last_stats)
    assert st["sharded"] is True and st["shard_decision"] == "context"
    assert st.get("compact_m")
    want = plain.sql(sql).to_pandas()
    got = r.sort_values("region").reset_index(drop=True)[want.columns]
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


def test_sorted_run_sharded_matches():
    """The sorted-run hashed tier in every slot; the slots' tables merge
    by key on the host."""
    rng = np.random.default_rng(4)
    n = 40_000
    df = pd.DataFrame({
        "k": rng.integers(0, 8000, n).astype(str),
        "q": rng.integers(0, 50, n),
        "wide": rng.integers(-10**9, 10**9, n),
        "price": rng.normal(100, 30, n).round(4),
        "nul": np.where(rng.random(n) < 0.15, np.nan,
                        rng.normal(5, 2, n)),
        "flag": rng.choice(["a", "b"], n)})
    conf = {"sdot.engine.groupby.dense.max.keys": 512,
            "sdot.engine.groupby.hash.sortedrun": "on"}
    sql = ("select k, sum(q) as s, sum(wide) as w, sum(price) as p, "
           "min(nul) as mn, max(nul) as mx, count(*) as c, "
           "sum(case when flag = 'a' then q else 0 end) as fq "
           "from t group by k order by k")
    m = tsdot.Context(config={**conf, **OFF}, mesh=_mesh())
    s = tsdot.Context(config=conf, device="cpu")
    j = jsdot.Context(config={**conf, **OFF}, mesh=jmake_mesh())
    for c in (m, s, j):
        c.ingest_dataframe("t", df, target_rows=4096)
    got = m.sql(sql).to_pandas()
    st = _stats(m)
    assert st.get("hashed") and st.get("sharded") and st["route"] \
        == "sorted", st
    assert_answers(got, s.sql(sql).to_pandas(), True, SINGLE_RTOL)
    assert_answers(got, j.sql(sql).to_pandas(), True, JAX_RTOL)


def test_sharded_exchange_min_near_sentinel():
    """A key whose min lies within one float64 ulp of the int64 NULL
    sentinel is a real extremum: the exchange ranks it by value (the
    NULL test reads the raw values), not as a NULL group."""
    rng = np.random.default_rng(5)
    n = 6_000
    df = pd.DataFrame({
        "ts": (np.datetime64("2020-01-01")
               + rng.integers(0, 64, n).astype("timedelta64[D]"))
        .astype("datetime64[ns]"),
        "k": rng.choice([f"g{i:04d}" for i in range(2_000)], n),
        "v": rng.integers(2 ** 40, 2 ** 50, n)})
    hot = pd.DataFrame({
        "ts": [np.datetime64("2020-01-05", "ns")],
        "k": ["hotkey"], "v": np.array([2 ** 63 - 600], dtype=np.int64)})
    df = pd.concat([hot, df], ignore_index=True)
    conf = {**OFF, "sdot.engine.groupby.dense.max.keys": 64}
    sql = ("select k, min(v) as mn from t group by k "
           "order by mn desc limit 3")
    m = tsdot.Context(conf, mesh=_mesh())
    j = jsdot.Context(conf, mesh=jmake_mesh())
    for c in (m, j):
        c.ingest_dataframe("t", df, time_column="ts", target_rows=1024)
    got = m.sql(sql).to_pandas()
    st = _stats(m)
    assert st["mode"] == "engine" and st.get("topk_exchange") is True, st
    assert got["k"].iloc[0] == "hotkey"
    assert int(got["mn"].iloc[0]) == 2 ** 63 - 600
    want = j.sql(sql).to_pandas()
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


# -- correlated subqueries on the mesh -----------------------------------------

@pytest.fixture(scope="module")
def cframe():
    rng = np.random.default_rng(31)
    n = 30_000
    ts = (np.datetime64("2019-01-01")
          + rng.integers(0, 365, n).astype("timedelta64[D]"))
    return pd.DataFrame({
        "ts": ts.astype("datetime64[ns]"),
        "partkey": rng.integers(1, 401, n),
        "suppkey": rng.integers(1, 51, n),
        "qty": rng.integers(1, 51, n).astype(np.int64),
        "price": np.round(rng.uniform(1, 100, n), 2)})


CORRELATED = {
    "one_key": ("select sum(price) as s, count(*) as n from fact "
                "where qty < (select 0.5 * avg(f2_qty) from "
                "  (select partkey as f2_partkey, qty as f2_qty "
                "   from fact) f2 where f2_partkey = partkey)"),
    "two_key": ("select count(*) as n from fact "
                "where qty > (select 0.5 * avg(f2_qty) from "
                "  (select partkey as f2_pk, suppkey as f2_sk, "
                "   qty as f2_qty from fact) f2 "
                "  where f2_pk = partkey and f2_sk = suppkey)"),
}


@pytest.mark.parametrize("name", sorted(CORRELATED))
def test_correlated_sharded_matches_single(cframe, name):
    """The keyed-lookup filters of a decorrelated subquery compile in
    every slot; the sharded answer is the single device's."""
    sql = CORRELATED[name]
    m = tsdot.Context(OFF, mesh=_mesh())
    s = tsdot.Context(device="cpu")
    j = jsdot.Context(OFF, mesh=jmake_mesh())
    for c in (m, s, j):
        c.ingest_dataframe("fact", cframe, time_column="ts",
                           target_rows=4096)
    got = m.sql(sql).to_pandas()
    st = _stats(m)
    assert st["mode"] == "engine" and st.get("sharded") is True, st
    assert_answers(got, s.sql(sql).to_pandas(), True, SINGLE_RTOL)
    assert_answers(got, j.sql(sql).to_pandas(), True, JAX_RTOL)
