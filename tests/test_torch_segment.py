"""JAX ``tests/test_segment.py`` bound to the port: segment store /
ingest unit tests (≈ reference DataSourceTest / StarSchemaMetadataTest
tier).

The port's ingest runs on the JAX test's frames; the closed forms are the
JAX test's, and every ingest decision it reads (segment counts and time
bounds, column kinds, padded rows, pruned segments, metadata fields, the
narrow storage dtypes, a statement's mode) is held equal to the JAX
package's on the same frame. ``sales_ds`` is conftest's fixture ingested
by the port (``jsales_ds`` the JAX one).
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

from spark_druid_olap_tpu.segment.ingest import \
    ingest_dataframe as jingest_dataframe
from spark_druid_olap_tpu_torch.segment.column import (
    ColumnKind, build_dim_column, encode_time_millis,
)
from spark_druid_olap_tpu_torch.segment.ingest import ingest_dataframe

from torch_twin import last_mode_as_jax, mirrored


@pytest.fixture(scope="module")
def sales_ds(sales_df):
    return ingest_dataframe("sales", sales_df, time_column="ts",
                            target_rows=4096)


@pytest.fixture(scope="module")
def jsales_ds(sales_df):
    return jingest_dataframe("sales", sales_df, time_column="ts",
                             target_rows=4096)


def test_dim_column_sorted_dictionary():
    col = build_dim_column("c", np.array(["b", "a", "c", "a", "b"], dtype=object))
    assert list(col.dictionary) == ["a", "b", "c"]
    assert list(col.codes) == [1, 0, 2, 0, 1]
    assert col.validity is None
    assert col.code_of("b") == 1
    assert col.code_of("zz") == -1
    # bound -> code range (half open)
    assert col.code_range(lower="a", upper="b") == (0, 2)
    assert col.code_range(lower="a", lower_strict=True) == (1, 3)


def test_dim_column_nulls():
    col = build_dim_column("c", np.array(["x", None, "y"], dtype=object))
    assert col.validity is not None
    assert list(col.validity) == [True, False, True]


def test_time_split_roundtrip():
    ms = np.array([0, 86_400_000 + 123, 5 * 86_400_000 + 999], dtype=np.int64)
    days, rem = encode_time_millis(ms)
    assert list(days) == [0, 1, 5]
    assert list(rem) == [0, 123, 999]


def test_ingest_segments_time_sorted(sales_df):
    ds = ingest_dataframe("s", sales_df, time_column="ts", target_rows=4096)
    jds = jingest_dataframe("s", sales_df, time_column="ts",
                            target_rows=4096)
    assert ds.num_segments == jds.num_segments
    for a, b in zip(ds.segment_time_bounds(), jds.segment_time_bounds()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for c in sales_df.columns:
        assert ds.column_kind(c).name == jds.column_kind(c).name
    assert ds.num_rows == len(sales_df)
    assert ds.num_segments >= 2
    # time-contiguity: segment bounds must be non-decreasing
    mins, maxs = ds.segment_time_bounds()
    assert all(mins[i] <= mins[i + 1] for i in range(len(mins) - 1))
    assert all(m0 <= m1 for m0, m1 in zip(mins, maxs))
    # column kinds inferred
    assert ds.column_kind("region") == ColumnKind.DIM
    assert ds.column_kind("qty") == ColumnKind.LONG
    assert ds.column_kind("price") == ColumnKind.DOUBLE
    assert ds.column_kind("due") == ColumnKind.DATE
    assert ds.column_kind("ts") == ColumnKind.TIME


def test_stacked_shapes(sales_ds, jsales_ds):
    assert (sales_ds.num_segments, sales_ds.padded_rows) == \
        (jsales_ds.num_segments, jsales_ds.padded_rows)
    s = sales_ds.stacked("region")
    assert s.shape == (sales_ds.num_segments, sales_ds.padded_rows)
    rv = sales_ds.stacked_row_validity()
    assert rv.sum() == sales_ds.num_rows


def test_interval_pruning(sales_ds, jsales_ds):
    lo, hi = sales_ds.interval()
    assert (lo, hi) == tuple(jsales_ds.interval())
    mid = (lo + hi) // 2
    idx = sales_ds.prune_segments([(lo, mid)])
    np.testing.assert_array_equal(
        np.asarray(idx), np.asarray(jsales_ds.prune_segments([(lo, mid)])))
    assert 0 < len(idx) < sales_ds.num_segments
    all_idx = sales_ds.prune_segments(None)
    assert len(all_idx) == sales_ds.num_segments
    none_idx = sales_ds.prune_segments([(hi + 10_000_000, hi + 20_000_000)])
    assert len(none_idx) == 0


def test_metadata_summary(sales_ds, jsales_ds):
    md = sales_ds.metadata()
    jmd = jsales_ds.metadata()
    assert md["numRows"] == jmd["numRows"]
    assert {c: (v["type"], v.get("cardinality"))
            for c, v in md["columns"].items()} == \
        {c: (v["type"], v.get("cardinality"))
         for c, v in jmd["columns"].items()}
    assert md["numRows"] == sales_ds.num_rows
    assert md["columns"]["region"]["cardinality"] == 4
    assert md["columns"]["price"]["type"] == "DOUBLE"


def test_session_segment_target_rows_config():
    """sdot.segment.target.rows drives ingest segment sizing when the
    caller doesn't pass target_rows."""
    import spark_druid_olap_tpu_torch as sdot
    from conftest import make_sales_df
    import spark_druid_olap_tpu as jsdot
    c = sdot.Context({"sdot.segment.target.rows": 2048}, device="cpu")
    ds = c.ingest_dataframe("s", make_sales_df(10_000), time_column="ts")
    jc = jsdot.Context({"sdot.segment.target.rows": 2048})
    assert ds.num_segments == jc.ingest_dataframe(
        "s", make_sales_df(10_000), time_column="ts").num_segments
    assert ds.num_segments >= 4
    c2 = sdot.Context({"sdot.segment.target.rows": 2048}, device="cpu")
    ds2 = c2.ingest_dataframe("s", make_sales_df(10_000), time_column="ts",
                              target_rows=1 << 20)
    assert ds2.num_segments == 1


def test_narrow_dtype_storage():
    """Dictionary codes and in-range LONGs store at the narrowest signed
    int their cardinality/min-max allows (SF100 budget, docs/SF100.md);
    compute reads widen to i32 so results stay exact."""
    import numpy as np
    import pandas as pd
    import spark_druid_olap_tpu_torch as sdot
    rng = np.random.default_rng(4)
    n = 30_000
    df = pd.DataFrame({
        "ts": np.repeat(np.datetime64("2021-01-01"), n)
        .astype("datetime64[ns]"),
        "tiny": rng.choice(["a", "b", "c"], n),              # card 3 -> i8
        "mid": rng.choice([f"m{i:04d}" for i in range(900)], n),  # i16
        "small_int": rng.integers(0, 100, n).astype(np.int64),   # i8
        "mid_int": rng.integers(-30_000, 30_000, n),             # i16
        "wide_int": rng.integers(0, 2**40, n),                   # i64
    })
    ctx = mirrored(sdot.Context(device="cpu"))
    ctx.ingest_dataframe("t", df, time_column="ts")
    ds = ctx.store.get("t")
    jds = ctx.jax.store.get("t")
    for c in ("tiny", "mid"):
        assert ds.dims[c].codes.dtype == jds.dims[c].codes.dtype
    for c in ("small_int", "mid_int", "wide_int"):
        assert ds.metrics[c].values.dtype == jds.metrics[c].values.dtype
    from spark_druid_olap_tpu_torch.segment.column import narrow_int_dtype
    assert ds.dims["tiny"].codes.dtype == np.int8
    assert ds.dims["mid"].codes.dtype == np.int16
    assert narrow_int_dtype(0, 40_000) == np.int32       # past i16
    assert narrow_int_dtype(-2**40, 2**40) == np.int64
    assert ds.metrics["small_int"].values.dtype == np.int8
    assert ds.metrics["mid_int"].values.dtype == np.int16
    assert ds.metrics["wide_int"].values.dtype == np.int64
    got = ctx.sql("select tiny, sum(small_int) as s, min(mid_int) as mn, "
                  "count(*) as n from t group by tiny order by tiny") \
        .to_pandas()
    assert last_mode_as_jax(ctx) == "engine"
    want = df.groupby("tiny").agg(s=("small_int", "sum"),
                                  mn=("mid_int", "min"),
                                  n=("tiny", "size")).reset_index()
    assert got["s"].tolist() == want["s"].tolist()
    assert got["mn"].tolist() == want["mn"].tolist()
    assert got["n"].tolist() == want["n"].tolist()
