"""JAX ``tests/test_topn.py`` bound to the port: device top-k epilogue
tests.

The port's engine runs with ``device="cpu"`` against the JAX test's
pandas oracles with its exact assertions; each run's ``topk_device``
(whether and how wide the device selection ran) is held equal to the JAX
engine's on the same spec and store. Not copied: ``test_topk_sharded``,
held by ``test_torch_sharded.py`` (the port's 8-slot CPU mesh against
JAX's), and the two ``no_x64`` cases (``test_topk_tpu_dtypes_exact``,
``test_topk_tpu_dtypes_sharded``): f32 scores over the TPU-only
``ff`` / ``lanes`` / ``limbs`` routes, which the port does not emit.

Original notes: device top-k epilogue tests (reference: Druid's topN engine — the data
node answers ordered-limit queries with per-key-space top-k instead of
shipping the full groupBy result to the broker; rewrite gate
``QuerySpecTransforms.scala`` topN + ``DruidQueryCostModel`` topN
threshold).

The TPU analog selects ``k_sel`` candidate keys ON DEVICE by an f32 score
over the merged partials (``ops.groupby.route_score`` + ``lax.top_k``) and
transfers only those rows; the final ordering of candidates uses the exact
host combine. Differential against pandas with EXACT assertions — the
slack (k_sel >= 2*limit) makes selection exact for these distributions.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

from spark_druid_olap_tpu_torch.ir.spec import (
    AggregationSpec, DimensionSpec, GroupByQuerySpec, LimitSpec,
    OrderByColumn, SelectorFilter, TopNQuerySpec,
)
from spark_druid_olap_tpu_torch.parallel.executor import QueryEngine
from spark_druid_olap_tpu_torch.segment.ingest import ingest_dataframe
from spark_druid_olap_tpu_torch.segment.store import SegmentStore
from spark_druid_olap_tpu_torch.utils.config import Config

from torch_twin import jax_stats, jax_store

N = 60_000
N_CUST = 12_000          # above sdot.engine.topn.device.min.keys (8192)


def _df():
    rng = np.random.default_rng(23)
    return pd.DataFrame({
        "ts": (np.datetime64("2020-01-01")
               + rng.integers(0, 365, N).astype("timedelta64[D]"))
        .astype("datetime64[ns]"),
        "cust": rng.choice([f"c{i:05d}" for i in range(N_CUST)], N),
        "region": rng.choice(["east", "west", "north", "south"], N),
        "qty": rng.integers(1, 100, N).astype(np.int64),
        # straddles 2^24 so an f32 value round-trip would be caught
        "big": rng.integers(2**25, 2**40, N),
        "price": np.round(rng.uniform(1, 500, N), 2),
    })


@pytest.fixture(scope="module")
def tdf():
    return _df()


@pytest.fixture(scope="module")
def tstore(tdf):
    st = SegmentStore()
    st.register(ingest_dataframe("fact", tdf, time_column="ts",
                                 target_rows=8192))
    return st


@pytest.fixture(scope="module")
def jstore(tdf):
    """The JAX package's store over the same frame."""
    return jax_store(("fact", tdf, {"time_column": "ts",
                                    "target_rows": 8192}))


OFF = {"sdot.engine.topn.device.min.keys": 1 << 30}


def _run(eng, q, jstore, config=None):
    """The port's answer; its ``topk_device`` equal to the JAX engine's
    under the same config."""
    got = eng.execute(q).to_pandas()
    assert eng.last_stats["topk_device"] == \
        jax_stats(jstore, q, config)["topk_device"]
    return got


AGGS = (
    AggregationSpec("longsum", "s_qty", field="qty"),
    AggregationSpec("longsum", "s_big", field="big"),
    AggregationSpec("longmax", "mx_big", field="big"),
    AggregationSpec("doublesum", "s_price", field="price"),
    AggregationSpec("count", "n"),
)


def _q(metric, limit, ascending=False, dims=("cust",), having=None):
    return GroupByQuerySpec(
        datasource="fact",
        dimensions=tuple(DimensionSpec(d, d) for d in dims),
        aggregations=AGGS,
        limit=LimitSpec((OrderByColumn(metric, ascending=ascending),),
                        limit),
        having=having)


def _want(df, metric, limit, ascending=False, dims=("cust",)):
    g = df.groupby(list(dims), as_index=False).agg(
        s_qty=("qty", "sum"), s_big=("big", "sum"), mx_big=("big", "max"),
        s_price=("price", "sum"), n=("qty", "size"))
    return g.sort_values(metric, ascending=ascending,
                         kind="stable").head(limit)


def _check(got, want, metric, int_exact=("s_qty", "s_big", "mx_big", "n")):
    assert len(got) == len(want)
    # compare the metric COLUMN as an ordered multiset (ties at equal
    # metric values may legitimately pick different dims rows)
    np.testing.assert_allclose(
        np.sort(got[metric].to_numpy().astype(np.float64)),
        np.sort(want[metric].to_numpy().astype(np.float64)), rtol=1e-6)
    gs = got.sort_values(list(got.columns)).reset_index(drop=True)
    ws = want.sort_values(list(got.columns)).reset_index(drop=True)
    tie_free = len(set(want[metric])) == len(want)
    if tie_free:
        for c in int_exact:
            np.testing.assert_array_equal(
                gs[c].to_numpy().astype(np.int64), ws[c].to_numpy(),
                err_msg=f"{c} must be exact")


def test_topk_device_engaged(jstore, tstore, tdf):
    eng = QueryEngine(tstore, device="cpu")
    got = _run(eng, _q("s_big", 10), jstore)
    _check(got, _want(tdf, "s_big", 10), "s_big")


def test_topk_ascending(jstore, tstore, tdf):
    eng = QueryEngine(tstore, device="cpu")
    got = _run(eng, _q("s_qty", 15, ascending=True), jstore)
    _check(got, _want(tdf, "s_qty", 15, ascending=True), "s_qty")


def test_topk_max_metric(jstore, tstore, tdf):
    eng = QueryEngine(tstore, device="cpu")
    got = _run(eng, _q("mx_big", 12), jstore)
    _check(got, _want(tdf, "mx_big", 12), "mx_big")


def test_topk_double_metric(jstore, tstore, tdf):
    eng = QueryEngine(tstore, device="cpu")
    got = _run(eng, _q("s_price", 10), jstore)
    _check(got, _want(tdf, "s_price", 10), "s_price")


def test_topk_matches_full_sort(jstore, tstore):
    """The device-selected result must equal the same query with the
    device epilogue disabled (full [K] transfer + host sort)."""
    q = _q("s_big", 25)
    eng = QueryEngine(tstore, device="cpu")
    got = _run(eng, q, jstore)
    off = QueryEngine(tstore, config=Config(OFF), device="cpu")
    want = _run(off, q, jstore, OFF)
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True))


def test_topk_small_k_skips_device(jstore, tstore, tdf):
    # limit so large that k_sel*4 >= n_keys — device selection is skipped
    eng = QueryEngine(tstore, device="cpu")
    got = _run(eng, _q("s_qty", N_CUST), jstore)
    assert len(got) == len(set(tdf["cust"]))


def test_topk_having_skips_device(jstore, tstore, tdf):
    from spark_druid_olap_tpu_torch.ir import expr as E
    from spark_druid_olap_tpu_torch.ir.spec import HavingSpec
    having_expr = E.Comparison(">", E.Column("s_qty"), E.Literal(100))
    q = GroupByQuerySpec(
        datasource="fact",
        dimensions=(DimensionSpec("cust", "cust"),),
        aggregations=AGGS,
        limit=LimitSpec((OrderByColumn("s_qty", ascending=False),), 10),
        having=HavingSpec(having_expr))
    eng = QueryEngine(tstore, device="cpu")
    got = _run(eng, q, jstore)
    g = tdf.groupby("cust", as_index=False).agg(s_qty=("qty", "sum"))
    want = g[g.s_qty > 100].sort_values("s_qty", ascending=False).head(10)
    np.testing.assert_allclose(
        np.sort(got["s_qty"].to_numpy().astype(np.int64)),
        np.sort(want["s_qty"].to_numpy()))


def test_topn_query_spec(jstore, tstore, tdf):
    """TopNQuerySpec routes through the same device epilogue."""
    q = TopNQuerySpec(datasource="fact",
                      dimension=DimensionSpec("cust", "cust"),
                      metric="s_big", threshold=10, aggregations=AGGS[:4])
    eng = QueryEngine(tstore, device="cpu")
    got = _run(eng, q, jstore)
    _check(got, _want(tdf, "s_big", 10), "s_big",
           int_exact=("s_qty", "s_big", "mx_big"))


def test_topk_filtered_rows(jstore, tstore, tdf):
    q = GroupByQuerySpec(
        datasource="fact",
        dimensions=(DimensionSpec("cust", "cust"),),
        aggregations=AGGS,
        filter=SelectorFilter("region", "east"),
        limit=LimitSpec((OrderByColumn("s_qty", ascending=False),), 10))
    eng = QueryEngine(tstore, device="cpu")
    got = _run(eng, q, jstore)
    _check(got, _want(tdf[tdf.region == "east"], "s_qty", 10), "s_qty")


def test_topk_secondary_order_columns(jstore, tstore, tdf):
    """Multi-column ORDER BY (TPC-H q3/q18 shape): selection runs on the
    primary metric with 4x slack; secondary columns reorder ties exactly
    in the host epilogue."""
    q = GroupByQuerySpec(
        datasource="fact",
        dimensions=(DimensionSpec("cust", "cust"),),
        aggregations=AGGS,
        limit=LimitSpec((OrderByColumn("s_big", ascending=False),
                         OrderByColumn("cust", ascending=True)), 10))
    eng = QueryEngine(tstore, device="cpu")
    got = _run(eng, q, jstore)
    off = QueryEngine(tstore, config=Config(OFF), device="cpu")
    want = _run(off, q, jstore, OFF)
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True))


def test_topk_null_metric_groups_rank_last(jstore, tstore, tdf):
    """Groups whose min/max metric is NULL (all rows masked by the per-agg
    filter) must rank AFTER every real score — under ascending order the
    raw sentinel would otherwise rank first and displace the true top-k."""
    filt = SelectorFilter("region", "east")
    aggs = (
        AggregationSpec("longmax", "mx_east",
                        field="qty", filter=filt),
        AggregationSpec("longmin", "mn_east",
                        field="qty", filter=filt),
        AggregationSpec("count", "n"),
    )
    sub = tdf[tdf.region == "east"]
    for metric, ascending in (("mx_east", True), ("mn_east", False)):
        q = GroupByQuerySpec(
            datasource="fact",
            dimensions=(DimensionSpec("cust", "cust"),),
            aggregations=aggs,
            limit=LimitSpec((OrderByColumn(metric, ascending=ascending),),
                            10))
        eng = QueryEngine(tstore, device="cpu")
        got = _run(eng, q, jstore)
        agg_fn = "max" if metric == "mx_east" else "min"
        want = sub.groupby("cust")["qty"].agg(agg_fn).sort_values(
            ascending=ascending, kind="stable").head(10)
        assert len(got) == 10
        vals = got[metric].to_numpy()
        assert not any(v is None for v in vals), \
            f"{metric} NULL groups displaced real candidates"
        np.testing.assert_array_equal(
            np.sort(vals.astype(np.int64)), np.sort(want.to_numpy()))
