"""The port's JSON serde for query specs against the JAX package's.

The cases of ``tests/test_serde.py`` build the same spec in both packages
(the IR classes are copies), round-trip it through each package's
``ir/serde.py`` and require the two JSON texts to be equal, so a spec
written by one package loads in the other and equals that package's own
spec. Executable round-tripped specs then answer through both engines on
the same ``conftest.make_sales_df`` frame (the port on the CPU): dimensions,
integers and counts exact, float sums rtol 1e-6.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import json

import numpy as np
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.ir import expr as JE
from spark_druid_olap_tpu.ir import serde as JSER
from spark_druid_olap_tpu.ir import spec as JS

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ir import expr as TE
from spark_druid_olap_tpu_torch.ir import serde as TSER
from spark_druid_olap_tpu_torch.ir import spec as TS

from conftest import make_sales_df
from test_torch_sql import assert_answers_equal

PACKAGES = {"jax": (JE, JS, JSER), "torch": (TE, TS, TSER)}


def _filter(E, S, spatial=True):
    parts = (
        S.SelectorFilter("region", "east"),
        S.BoundFilter("qty", lower=5, upper=40, upper_strict=True,
                      numeric=True),
        S.InFilter("flag", ("A", "N")),
        S.PatternFilter("product", "like", "p0%"),
        S.LogicalFilter("not", (S.NullFilter("status"),)),
        S.ExprFilter(E.Comparison(">", E.BinaryOp(
            "*", E.Column("price"), E.Literal(2)), E.Literal(10))),
    )
    if spatial:
        parts += (S.SpatialFilter("pickup", ("lat", "lon"), (1.0, 2.0),
                                  (3.0, 4.0)),)
    return S.LogicalFilter("and", parts)


def _aggs(E, S):
    return (
        S.AggregationSpec("count", "c"),
        S.AggregationSpec("doublesum", "s", field="price"),
        S.AggregationSpec("longmin", "mn", field="qty"),
        S.AggregationSpec("doublemax", "mx", field="price",
                          filter=S.SelectorFilter("flag", "A")),
        S.AggregationSpec("cardinality", "np", field="product"),
        S.AggregationSpec("doublesum", "expr_s", expr=E.BinaryOp(
            "*", E.Column("price"), E.BinaryOp("-", E.Literal(1),
                                               E.Column("discount")))),
    )


def _posts(E, S):
    return (S.PostAggregationSpec("ratio", E.BinaryOp(
        "/", E.Column("s"), E.Column("c"))),)


def groupby(E, S):
    return S.GroupByQuerySpec(
        datasource="sales",
        dimensions=(S.DimensionSpec("region", "region"),
                    S.DimensionSpec("ts", "month",
                                    S.TimeExtraction("month")),
                    S.DimensionSpec("product", "pid",
                                    S.RegexExtraction("p(\\d+)", 1, True)),
                    S.DimensionSpec("region", "zone", S.LookupExtraction(
                        (("east", "atlantic"), ("west", None)),
                        retain_missing=True))),
        aggregations=_aggs(E, S), post_aggregations=_posts(E, S),
        filter=_filter(E, S),
        having=S.HavingSpec(E.Comparison(">", E.Column("s"),
                                         E.Literal(100))),
        limit=S.LimitSpec((S.OrderByColumn("s", ascending=False),), 10),
        granularity=S.Granularity("month"),
        intervals=((1000, 2000), (3000, 4000)),
        context=S.QueryContext(query_id="q-1", timeout_millis=5000))


def timeseries(E, S):
    return S.TimeseriesQuerySpec(
        datasource="sales", aggregations=_aggs(E, S)[:2],
        post_aggregations=_posts(E, S),
        granularity=S.Granularity("duration", duration_millis=3600_000),
        filter=S.SelectorFilter("flag", None),
        intervals=((0, 10_000),))


def topn(E, S):
    return S.TopNQuerySpec(
        datasource="sales", dimension=S.DimensionSpec("product", "product"),
        metric="s", threshold=25, aggregations=_aggs(E, S)[:3],
        filter=S.BoundFilter("region", lower="a", upper="m"))


def select(E, S):
    return S.SelectQuerySpec(
        datasource="sales", columns=("ts", "region", "price"),
        filter=S.InFilter("region", ("east",)),
        intervals=((5, 50),), page_size=500, page_offset=1500,
        descending=True)


def search(E, S):
    return S.SearchQuerySpec(
        datasource="sales", dimensions=("region", "product"),
        query="ast", case_sensitive=True, limit=7)


def case_expr(E, S):
    e = E.Case(((E.Comparison("=", E.Column("a"), E.Literal("x")),
                 E.Literal(1)),), E.Literal(0))
    return S.GroupByQuerySpec(
        datasource="t", dimensions=(S.DimensionSpec("a", "a"),),
        aggregations=(S.AggregationSpec("doublesum", "s", expr=e),))


def keyed_lookup(E, S):
    tab = E.FrozenKeyedTable(np.array([5, 2, 9]),
                             np.array([1.5, np.nan, -3.0]))
    e = E.Comparison("<", E.Column("qty"),
                     E.KeyedLookup(E.Column("k"), tab, 0.0))
    return S.GroupByQuerySpec(
        datasource="t", dimensions=(S.DimensionSpec("a", "a"),),
        aggregations=(S.AggregationSpec("count", "n"),),
        filter=S.ExprFilter(e))


def keyed_lookup2(E, S):
    tab = E.FrozenKeyedTable2(np.array([5, 2, 2]), np.array([1, 9, 3]),
                              np.array([1.5, np.nan, -3.0]))
    e = E.Comparison(">", E.Column("qty"),
                     E.KeyedLookup2(E.Column("a"), E.Column("b"), tab))
    return S.GroupByQuerySpec(
        datasource="t", dimensions=(S.DimensionSpec("a", "a"),),
        aggregations=(S.AggregationSpec("count", "n"),),
        filter=S.ExprFilter(e))


SPECS = {"groupby": groupby, "timeseries": timeseries, "topn": topn,
         "select": select, "search": search, "case_expr": case_expr,
         "keyed_lookup": keyed_lookup, "keyed_lookup2": keyed_lookup2}


@pytest.mark.parametrize("name", list(SPECS))
def test_roundtrip_and_cross_load(name):
    """Each package round-trips its own spec; both write the same JSON;
    each package loads the other's JSON into a spec equal to its own."""
    built = {pkg: SPECS[name](E, S) for pkg, (E, S, _) in PACKAGES.items()}
    text = {}
    for pkg, (_, _, SER) in PACKAGES.items():
        text[pkg] = SER.query_to_json(built[pkg])
        assert SER.query_from_json(text[pkg]) == built[pkg]
    assert json.loads(text["torch"]) == json.loads(text["jax"])
    assert TSER.query_from_json(text["jax"]) == built["torch"]
    assert JSER.query_from_json(text["torch"]) == built["jax"]


def test_default_datasource_applies():
    body = ('{"queryType": "timeseries", "aggregations": '
            '[{"type": "count", "name": "c"}]}')
    for _, _, SER in PACKAGES.values():
        assert SER.query_from_json(body, default_ds="sales").datasource \
            == "sales"


def test_unknown_query_type_raises():
    for _, _, SER in PACKAGES.values():
        with pytest.raises(ValueError):
            SER.query_from_json('{"queryType": "mystery"}')


# -- round-tripped specs answer through both engines --------------------------

@pytest.fixture(scope="module")
def pair():
    df = make_sales_df(6000)
    jctx, tctx = jsdot.Context(), tsdot.Context(device="cpu")
    for c in (jctx, tctx):
        c.ingest_dataframe("sales", df, time_column="ts", target_rows=2048)
    return jctx, tctx


def _executable(E, S):
    """Wire specs over the sales frame: a filtered group-by with a
    post-aggregation and a month extraction, a timeseries, a topN."""
    flt = S.LogicalFilter("and", (
        S.BoundFilter("qty", lower=5, upper=40, upper_strict=True,
                      numeric=True),
        S.InFilter("flag", ("A", "N")),
        S.ExprFilter(E.Comparison(">", E.BinaryOp(
            "*", E.Column("price"), E.Literal(2)), E.Literal(10)))))
    aggs = (S.AggregationSpec("count", "c"),
            S.AggregationSpec("doublesum", "s", field="price"),
            S.AggregationSpec("longmin", "mn", field="qty"),
            S.AggregationSpec("doublemax", "mx", field="price",
                              filter=S.SelectorFilter("flag", "A")))
    return {
        "groupby": S.GroupByQuerySpec(
            datasource="sales",
            dimensions=(S.DimensionSpec("region", "region"),
                        S.DimensionSpec("ts", "month",
                                        S.TimeExtraction("month"))),
            aggregations=aggs, post_aggregations=_posts(E, S), filter=flt),
        "timeseries": S.TimeseriesQuerySpec(
            datasource="sales", aggregations=aggs[:2],
            granularity=S.Granularity("month"), filter=flt),
        "topn": S.TopNQuerySpec(
            datasource="sales",
            dimension=S.DimensionSpec("product", "product"), metric="s",
            threshold=5, aggregations=aggs[:3],
            filter=S.BoundFilter("region", lower="a", upper="m")),
    }


@pytest.mark.parametrize("name", ["groupby", "timeseries", "topn"])
def test_cross_loaded_specs_answer_equal(pair, name):
    """The JAX package's JSON, loaded by the port, answers on the port as
    the JAX spec answers on the JAX engine."""
    jctx, tctx = pair
    jq = _executable(JE, JS)[name]
    tq = TSER.query_from_json(JSER.query_to_json(jq))
    assert tq == _executable(TE, TS)[name]
    want = jctx.execute(jq).to_pandas()
    got = tctx.execute(tq).to_pandas()
    assert_answers_equal(got, want, ordered=name == "topn")
