"""JAX ``tests/test_engine_edge.py`` bound to the port: edge-case
regression tests (from code-review findings): null groups, absolute hour
buckets, minute-of-hour extraction, OR-with-all-true, empty-group min/max
sentinels.

The port's engine runs with ``device="cpu"`` against the JAX test's own
closed forms and pandas oracles (exact: counts, keys and stored values);
the file reads no engine decision beyond them."""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ir.spec import (
    AggregationSpec, DimensionSpec, Granularity, GroupByQuerySpec,
    LogicalFilter, SelectorFilter, TimeseriesQuerySpec, TimeExtraction,
)
from spark_druid_olap_tpu_torch.segment.ingest import ingest_dataframe
from spark_druid_olap_tpu_torch.segment.store import SegmentStore
from spark_druid_olap_tpu_torch.parallel.executor import QueryEngine


@pytest.fixture(scope="module")
def nullable_engine():
    df = pd.DataFrame({
        "t": pd.to_datetime(["2020-01-01 05:30:10", "2020-01-02 05:45:00",
                             "2020-01-01 06:15:00", "2020-01-02 23:59:59",
                             "2020-01-01 05:00:00"]),
        "cat": pd.array(["a", None, "b", "a", None], dtype=object),
        "v": [1.0, 2.0, 3.0, 4.0, 5.0],
    })
    ds = ingest_dataframe("nulls", df, time_column="t")
    st = SegmentStore()
    st.register(ds)
    return QueryEngine(st, device="cpu"), df


def test_null_dimension_group(nullable_engine):
    eng, df = nullable_engine
    q = GroupByQuerySpec("nulls", (DimensionSpec("cat", "cat"),),
                         (AggregationSpec("doublesum", "sv", field="v"),
                          AggregationSpec("count", "c")))
    r = eng.execute(q)
    by = {c: (sv, n) for c, sv, n in zip(r["cat"], r["sv"], r["c"])}
    assert by["a"] == (5.0, 2)
    assert by["b"] == (3.0, 1)
    assert None in by and by[None] == (7.0, 2)


def test_hour_granularity_absolute_buckets(nullable_engine):
    eng, df = nullable_engine
    q = TimeseriesQuerySpec("nulls", (AggregationSpec("count", "c"),),
                            granularity=Granularity("hour"))
    r = eng.execute(q).to_pandas()
    # 05:xx on Jan 1 and 05:xx on Jan 2 must be DIFFERENT buckets
    want = df.assign(timestamp=df.t.dt.floor("h")).groupby(
        "timestamp", as_index=False).size().rename(columns={"size": "c"})
    got = r.sort_values("timestamp").reset_index(drop=True)
    want = want.sort_values("timestamp").reset_index(drop=True)
    assert len(got) == len(want) == 4
    np.testing.assert_array_equal(got["c"], want["c"])
    np.testing.assert_array_equal(got["timestamp"].to_numpy("datetime64[ms]"),
                                  want["timestamp"].to_numpy("datetime64[ms]"))


def test_minute_extraction_is_minute_of_hour(nullable_engine):
    eng, df = nullable_engine
    q = GroupByQuerySpec("nulls", (DimensionSpec("t", "mi",
                                                 TimeExtraction("minute")),),
                         (AggregationSpec("count", "c"),))
    r = eng.execute(q).to_pandas()
    want = df.groupby(df.t.dt.minute).size()
    got = dict(zip(r["mi"], r["c"]))
    assert got == dict(want)


def test_or_with_all_true_operand(nullable_engine):
    eng, df = nullable_engine
    from spark_druid_olap_tpu_torch.ir.spec import TrueFilter
    q = TimeseriesQuerySpec(
        "nulls", (AggregationSpec("count", "c"),),
        filter=LogicalFilter("or", (TrueFilter,
                                    SelectorFilter("cat", "a"))))
    r = eng.execute(q).to_pandas()
    assert int(r["c"][0]) == len(df)


def test_filtered_minmax_empty_group_is_null(nullable_engine):
    eng, df = nullable_engine
    q = GroupByQuerySpec(
        "nulls", (DimensionSpec("cat", "cat"),),
        (AggregationSpec("doublemin", "mn", field="v",
                         filter=SelectorFilter("cat", "b")),
         AggregationSpec("count", "c")))
    r = eng.execute(q).to_pandas()
    by = {row["cat"]: row for row in r.to_dict("records")}
    assert by["b"]["mn"] == 3.0
    assert np.isnan(by["a"]["mn"])


def test_device_cache_reused(nullable_engine):
    eng, _ = nullable_engine
    q = TimeseriesQuerySpec("nulls", (AggregationSpec("count", "c"),))
    eng.execute(q)
    n1 = len(eng._device_arrays)
    eng.execute(q)
    assert len(eng._device_arrays) == n1  # no re-upload entries


def test_bitmap_membership_matches_searchsorted(monkeypatch):
    """Dense-span FrozenIntSet filters lower to a packed-bitmap gather;
    wide-span sets keep the binary search — both must agree with numpy
    membership, and the dense query must ACTUALLY take the bitmap path
    (the shared lowering serves both the filter and expression tiers)."""
    import numpy as np
    import pandas as pd
    import spark_druid_olap_tpu_torch as sdot
    from spark_druid_olap_tpu_torch.ops import expr_compile as EC
    spans = []
    orig = EC.int_set_membership

    def spy(arr, vals):
        spans.append(int(vals[-1]) - int(vals[0]) + 1)
        return orig(arr, vals)

    monkeypatch.setattr(EC, "int_set_membership", spy)
    rng = np.random.default_rng(12)
    n = 50_000
    keys = rng.integers(0, 3_000_000, n)
    df = pd.DataFrame({
        "ts": np.repeat(np.datetime64("2021-01-01"), n)
        .astype("datetime64[ns]"),
        "k": keys.astype(np.int64),
        "q": rng.integers(1, 10, n).astype(np.int64),
    })
    ctx = sdot.Context(device="cpu")
    ctx.ingest_dataframe("t", df, time_column="ts")
    # dense span via semijoin-shaped EXISTS -> bitmap branch
    got = ctx.sql(
        "select count(*) as n from t where exists "
        "(select 1 from t t2 where t2.k = t.k and t2.q >= 9)").to_pandas()
    hot = set(df[df.q >= 9].k)
    assert int(got["n"].iloc[0]) == int(df.k.isin(hot).sum())
    assert spans and any(s <= (1 << 26) for s in spans), \
        "dense EXISTS set never reached the shared membership lowering"
    # wide span (> 2^26): binary-search fallback stays correct
    spans.clear()
    w = df.assign(k=df.k * 1_000)     # span ~3e9
    ctx.ingest_dataframe("w", w, time_column="ts")
    got = ctx.sql(
        "select count(*) as n from w where exists "
        "(select 1 from w w2 where w2.k = w.k and w2.q >= 9)").to_pandas()
    hotw = set(w[w.q >= 9].k)
    assert int(got["n"].iloc[0]) == int(w.k.isin(hotw).sum())
    assert spans and any(s > (1 << 26) for s in spans), \
        "wide EXISTS set never reached the shared membership lowering"
