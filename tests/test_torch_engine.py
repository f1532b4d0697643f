"""The port's whole slice against the JAX package: ingest -> QuerySpec ->
dense group-by -> QueryResult.

Every query is built twice from one description, once with each package's
``ir`` modules, and run through a JAX ``Context`` and a port
``Context(device="cpu")`` over the same seeded TPC-H lineitem frame — once
ingested by each package, and once with the JAX store carried into the port
by ``segment.store.datasource_from_arrays``, so that both engines query
identical stores. The q1 shape also runs on the JAX side with
``SDOT_PALLAS=interpret`` (its fused Pallas kernel).

Tolerance: dimensions, integers, counts and min/max exact; float sums
rtol 1e-6 (float metric columns are stored f32; the JAX routes and the port
sum them in different orders).
"""

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.ir import expr as JE
from spark_druid_olap_tpu.ir import spec as JS
from spark_druid_olap_tpu.tools.tpch import generate as jax_generate

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ir import expr as TE
from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.segment.store import datasource_from_arrays

FLOAT_RTOL = 1e-6
TARGET_ROWS = 16_384            # several segments, so pruning has work


def _ms(day: str) -> int:
    return int(np.datetime64(day, "ms").astype(np.int64))


def q1(S, E):
    C, L = E.Column, E.Literal
    disc = E.BinaryOp("*", C("l_extendedprice"),
                      E.BinaryOp("-", L(1), C("l_discount")))
    return S.GroupByQuerySpec(
        "lineitem",
        (S.DimensionSpec("l_returnflag", "l_returnflag"),
         S.DimensionSpec("l_linestatus", "l_linestatus")),
        (S.AggregationSpec("longsum", "sum_qty", field="l_quantity"),
         S.AggregationSpec("doublesum", "sum_base_price",
                           field="l_extendedprice"),
         S.AggregationSpec("doublesum", "sum_disc_price", expr=disc),
         S.AggregationSpec("doublesum", "sum_charge", expr=E.BinaryOp(
             "*", disc, E.BinaryOp("+", L(1), C("l_tax")))),
         S.AggregationSpec("doublesum", "sum_disc", field="l_discount"),
         S.AggregationSpec("count", "count_order"),
         S.AggregationSpec("longmin", "min_qty", field="l_quantity"),
         S.AggregationSpec("doublemax", "max_price",
                           field="l_extendedprice")),
        post_aggregations=tuple(
            S.PostAggregationSpec(n, E.BinaryOp("/", C(s), C("count_order")))
            for n, s in (("avg_qty", "sum_qty"),
                         ("avg_price", "sum_base_price"),
                         ("avg_disc", "sum_disc"))),
        limit=S.LimitSpec((S.OrderByColumn("l_returnflag"),
                           S.OrderByColumn("l_linestatus"))),
        intervals=((_ms("1900-01-01"), _ms("1998-09-03")),))


def q6(S, E):
    C = E.Column
    return S.TimeseriesQuerySpec(
        "lineitem",
        (S.AggregationSpec("doublesum", "revenue", expr=E.BinaryOp(
            "*", C("l_extendedprice"), C("l_discount"))),),
        filter=S.LogicalFilter("and", (
            S.BoundFilter("l_discount", lower=0.05, upper=0.07,
                          numeric=True),
            S.BoundFilter("l_quantity", upper=24, upper_strict=True,
                          numeric=True))),
        intervals=((_ms("1994-01-01"), _ms("1995-01-01")),))


def monthly(S, E):
    """Time-granularity GroupBy: month buckets x ship mode."""
    return S.GroupByQuerySpec(
        "lineitem", (S.DimensionSpec("l_shipmode", "l_shipmode"),),
        (S.AggregationSpec("longsum", "qty", field="l_quantity"),
         S.AggregationSpec("count", "n")),
        granularity=S.Granularity("month"),
        intervals=((_ms("1995-01-01"), _ms("1996-07-01")),))


def topn(S, E):
    return S.TopNQuerySpec(
        "lineitem", S.DimensionSpec("l_shipinstruct", "l_shipinstruct"),
        metric="qty", threshold=3,
        aggregations=(S.AggregationSpec("longsum", "qty",
                                        field="l_quantity"),
                      S.AggregationSpec("doublesum", "price",
                                        field="l_extendedprice")))


def filtered_agg(S, E):
    """Filtered aggregations (per-aggregate masks) and a HAVING."""
    C, L = E.Column, E.Literal
    return S.GroupByQuerySpec(
        "lineitem", (S.DimensionSpec("l_shipmode", "l_shipmode"),),
        (S.AggregationSpec("count", "n"),
         S.AggregationSpec("count", "n_rail", filter=S.SelectorFilter(
             "l_shipinstruct", "NONE")),
         S.AggregationSpec("doublesum", "price_cheap",
                           field="l_extendedprice",
                           filter=S.BoundFilter("l_quantity", upper=10,
                                                numeric=True)),
         S.AggregationSpec("longmax", "max_qty_r", field="l_quantity",
                           filter=S.InFilter("l_returnflag", ("R", "A")))),
        filter=S.InFilter("l_shipmode", ("AIR", "MAIL", "SHIP", "TRUCK")),
        having=S.HavingSpec(E.Comparison(">", C("n"), L(10))),
        limit=S.LimitSpec((S.OrderByColumn("n", ascending=False),), 3))


def pruned_empty(S, E):
    """An interval past the data: every segment is pruned."""
    return S.GroupByQuerySpec(
        "lineitem", (S.DimensionSpec("l_returnflag", "l_returnflag"),),
        (S.AggregationSpec("count", "n"),),
        intervals=((_ms("2030-01-01"), _ms("2031-01-01")),))


def empty_global(S, E):
    """A global aggregate whose filter matches no row: one identity row."""
    return S.TimeseriesQuerySpec(
        "lineitem",
        (S.AggregationSpec("count", "n"),
         S.AggregationSpec("longsum", "qty", field="l_quantity"),
         S.AggregationSpec("doublemin", "lo", field="l_extendedprice")),
        filter=S.SelectorFilter("l_returnflag", "no-such-flag"))


def wide(S, E):
    """Q1's grouping with 17 aggregates, more than one launch of the port's
    kernel takes."""
    C, L = E.Column, E.Literal
    aggs = [S.AggregationSpec("count", "n")]
    for col, typ in (("l_quantity", "long"), ("l_extendedprice", "double"),
                     ("l_discount", "double"), ("l_tax", "double")):
        aggs += [S.AggregationSpec(typ + fn, f"{fn}_{col}", field=col)
                 for fn in ("sum", "min", "max")]
    aggs += [
        S.AggregationSpec("count", "n_air", filter=S.InFilter(
            "l_shipmode", ("AIR", "MAIL"))),
        S.AggregationSpec("doublesum", "price_small",
                          field="l_extendedprice",
                          filter=S.BoundFilter("l_quantity", upper=10,
                                               numeric=True)),
        S.AggregationSpec("longmax", "max_qty_none", field="l_quantity",
                          filter=S.SelectorFilter("l_shipinstruct", "NONE")),
        S.AggregationSpec("doublesum", "sum_disc_price", expr=E.BinaryOp(
            "*", C("l_extendedprice"),
            E.BinaryOp("-", L(1), C("l_discount"))))]
    return S.GroupByQuerySpec(
        "lineitem",
        (S.DimensionSpec("l_returnflag", "l_returnflag"),
         S.DimensionSpec("l_linestatus", "l_linestatus")),
        tuple(aggs),
        limit=S.LimitSpec((S.OrderByColumn("l_returnflag"),
                           S.OrderByColumn("l_linestatus"))))


QUERIES = [q1, q6, monthly, topn, filtered_agg, pruned_empty, empty_global,
           wide]


@pytest.fixture(scope="module")
def lineitem():
    return jax_generate(0.01)["lineitem"]


@pytest.fixture(scope="module")
def jax_ctx(lineitem):
    ctx = jsdot.Context()
    ctx.ingest_dataframe("lineitem", lineitem, time_column="l_shipdate",
                         target_rows=TARGET_ROWS)
    return ctx


@pytest.fixture(scope="module")
def port_ctx(lineitem):
    ctx = tsdot.Context(device="cpu")
    ctx.ingest_dataframe("lineitem", lineitem, time_column="l_shipdate",
                         target_rows=TARGET_ROWS)
    return ctx


def jax_store_arrays(ds) -> dict:
    """A JAX Datasource in the port's documented plain-numpy layout."""
    cols = {n: {"kind": "dimension", "values": d.codes,
                "validity": d.validity, "dictionary": list(d.dictionary)}
            for n, d in ds.dims.items()}
    cols.update({n: {"kind": m.kind.value, "values": m.values,
                     "validity": m.validity}
                 for n, m in ds.metrics.items()})
    return {"time": {"name": ds.time.name, "millis": ds.time.millis},
            "segments": [(s.start_row, s.end_row) for s in ds.segments],
            "columns": cols}


@pytest.fixture(scope="module")
def carried_ctx(jax_ctx):
    ctx = tsdot.Context(device="cpu")
    ctx.store.register(datasource_from_arrays(
        "lineitem", jax_store_arrays(jax_ctx.store.get("lineitem"))))
    return ctx


def assert_results_equal(got, want):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if w.dtype.kind == "f" and not np.array_equal(g, w, equal_nan=True):
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=FLOAT_RTOL,
                                       atol=0, err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


@pytest.mark.parametrize("build", QUERIES, ids=lambda f: f.__name__)
def test_port_ingest_matches_jax(build, jax_ctx, port_ctx):
    want = jax_ctx.execute(build(JS, JE)).to_pandas()
    got = port_ctx.execute(build(TS, TE)).to_pandas()
    assert_results_equal(got, want)


@pytest.mark.parametrize("build", QUERIES, ids=lambda f: f.__name__)
def test_carried_store_matches_jax(build, jax_ctx, carried_ctx):
    want = jax_ctx.execute(build(JS, JE)).to_pandas()
    got = carried_ctx.execute(build(TS, TE)).to_pandas()
    assert_results_equal(got, want)


def test_q1_matches_jax_pallas_kernel(monkeypatch, lineitem, port_ctx):
    monkeypatch.setenv("SDOT_PALLAS", "interpret")
    ctx = jsdot.Context()          # fresh: routes differ under interpret
    ctx.ingest_dataframe("lineitem", lineitem, time_column="l_shipdate",
                         target_rows=TARGET_ROWS)
    want = ctx.execute(q1(JS, JE)).to_pandas()
    got = port_ctx.execute(q1(TS, TE)).to_pandas()
    assert_results_equal(got, want)
    assert port_ctx.engine.last_stats["route"] == "kernel"


def test_port_ingest_builds_the_jax_store(jax_ctx, port_ctx):
    """Dictionaries, codes, values, validity and segment bounds agree."""
    j, t = jax_ctx.store.get("lineitem"), port_ctx.store.get("lineitem")
    assert [(s.start_row, s.end_row, s.min_millis, s.max_millis)
            for s in j.segments] == \
        [(s.start_row, s.end_row, s.min_millis, s.max_millis)
         for s in t.segments]
    np.testing.assert_array_equal(j.time.millis, t.time.millis)
    assert list(j.dims) == list(t.dims)
    assert list(j.metrics) == list(t.metrics)
    for n, d in j.dims.items():
        assert list(d.dictionary) == list(t.dims[n].dictionary), n
        np.testing.assert_array_equal(d.codes, t.dims[n].codes, err_msg=n)
        assert d.codes.dtype == t.dims[n].codes.dtype, n
    for n, m in j.metrics.items():
        assert m.kind.value == t.metrics[n].kind.value, n
        np.testing.assert_array_equal(m.values, t.metrics[n].values,
                                      err_msg=n)
        assert m.values.dtype == t.metrics[n].values.dtype, n


def test_q1_and_q6_against_pandas(lineitem, port_ctx):
    """The port alone against a pandas oracle on the frame (the oracle
    ``chip_smoke.py`` applies at SF1)."""
    df = lineitem
    f32 = {c: df[c].astype(np.float32)
           for c in ("l_extendedprice", "l_discount", "l_tax")}
    got = port_ctx.execute(q1(TS, TE)).to_pandas()
    sel = df["l_shipdate"] < np.datetime64("1998-09-03")
    disc = f32["l_extendedprice"] * (np.float32(1) - f32["l_discount"])
    want = pd.DataFrame({
        "l_returnflag": df["l_returnflag"], "l_linestatus":
        df["l_linestatus"], "q": df["l_quantity"],
        "d": disc.astype(np.float64)})[sel] \
        .groupby(["l_returnflag", "l_linestatus"]) \
        .agg(q=("q", "sum"), d=("d", "sum"), n=("q", "size")).reset_index()
    np.testing.assert_array_equal(got["sum_qty"], want["q"])
    np.testing.assert_array_equal(got["count_order"], want["n"])
    np.testing.assert_allclose(got["sum_disc_price"], want["d"],
                               rtol=FLOAT_RTOL)
    got6 = port_ctx.execute(q6(TS, TE)).to_pandas()
    m = ((df["l_shipdate"] >= np.datetime64("1994-01-01"))
         & (df["l_shipdate"] < np.datetime64("1995-01-01"))
         & (f32["l_discount"] >= np.float32(0.05))
         & (f32["l_discount"] <= np.float32(0.07))
         & (df["l_quantity"] < 24))
    rev = (f32["l_extendedprice"] * f32["l_discount"])[m] \
        .astype(np.float64).sum()
    np.testing.assert_allclose(got6["revenue"], [rev], rtol=FLOAT_RTOL)


def _slice_spec(S, E, spec):
    """The select and the device-HAVING query that the earlier slices
    refused (ROADMAP A.5 and A.4), now answered."""
    if spec == "select":
        return S.SelectQuerySpec(
            "lineitem", ("l_shipdate", "l_quantity", "l_returnflag"),
            filter=S.BoundFilter("l_quantity", lower=48), page_size=500)
    # an integer HAVING over 2,000 parts x 100 suppliers: filtered on the
    # device, only the passing groups travel
    return S.GroupByQuerySpec(
        "lineitem", (S.DimensionSpec("l_partkey", "l_partkey"),
                     S.DimensionSpec("l_suppkey", "l_suppkey")),
        (S.AggregationSpec("count", "n"),),
        having=S.HavingSpec(E.Comparison(">", E.Column("n"),
                                         E.Literal(1))))


@pytest.mark.parametrize("spec", ["select", "device_having"])
def test_paths_of_the_slice_answer(spec, jax_ctx, port_ctx):
    want = jax_ctx.execute(_slice_spec(JS, JE, spec)).to_pandas()
    got = port_ctx.execute(_slice_spec(TS, TE, spec)).to_pandas()
    assert len(got) > 0
    assert_results_equal(got, want)
    key = "select_filter" if spec == "select" else "having_device"
    assert port_ctx.engine.last_stats[key] \
        == jax_ctx.engine.last_stats[key]
    if spec == "device_having":
        assert port_ctx.engine.last_stats[key] > 0


def _cache_spec(S, spec):
    return S.TimeseriesQuerySpec("lineitem", (S.AggregationSpec(
        "cardinality", "u", field="l_partkey")
        if spec == "sketch" else S.AggregationSpec(
            "longsum", "s", field="l_quantity"),))


@pytest.mark.parametrize("spec", ["sketch", "multi_wave", "partial_select",
                                  "partial_search"])
def test_paths_outside_the_slice_raise(spec, jax_ctx, port_ctx,
                                       monkeypatch):
    """A multi-host partial store (ROADMAP A.8) raises. A scan whose bound
    columns pass ``sdot.engine.device.cache.bytes`` (cases ``sketch`` and
    ``multi_wave``) is no longer refused: the key caps the bind cache, not
    a scan, so the cache is dropped, the scan binds in one wave and
    answers as the JAX engine does under the same setting."""
    if spec in ("sketch", "multi_wave"):
        for ctx in (jax_ctx, port_ctx):
            monkeypatch.setitem(ctx.config._values,
                                "sdot.engine.device.cache.bytes", 1)
        want = jax_ctx.execute(_cache_spec(JS, spec)).to_pandas()
        port_ctx.engine.clear_caches()       # every array uploads
        got = port_ctx.execute(_cache_spec(TS, spec)).to_pandas()
        assert_results_equal(got, want)
        assert port_ctx.engine.last_stats["waves"] \
            == jax_ctx.engine.last_stats["waves"] == 1
        # the cache holds at most the scan's last array
        assert len(port_ctx.engine._device_arrays) == 1
        return
    # a multi-host partial store: its rows live in other processes
    monkeypatch.setattr(port_ctx.store.get("lineitem"), "is_partial", True)
    q = TS.SelectQuerySpec("lineitem", ("l_quantity",)) \
        if spec == "partial_select" else TS.SearchQuerySpec(
            "lineitem", ("l_returnflag",), "R")
    with pytest.raises(NotImplementedError,
                       match="not ported yet \\(ROADMAP A.8\\)"):
        port_ctx.execute(q)
