"""The port's file ingest against the JAX package's.

``tests/test_stream_ingest.py``'s cases through both packages: a store
streamed from Parquet row groups (``ingest_parquet_stream``) is held bit
for bit against the JAX package's streamed store (segments, time,
dictionaries, codes, validity, metric dtypes and values), and its answers
against the port's in-memory ingest of the same frame and against the JAX
engine's (dimensions, integers and counts exact, float sums rtol 1e-6;
rtol 1e-5 against the in-memory store, whose segments sum in another
order, as the JAX test allows). Also the wide-int, no-time-column and
nullable-int files, the streaming path's bounded peak memory, the chunked
star flatten, and ``Context.ingest_parquet`` / ``ingest_csv`` against the
JAX package's. Every file is written to the test's temporary directory.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import json
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.segment.stream_ingest import (
    ingest_parquet_stream as jstream)

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.segment.column import ColumnKind
from spark_druid_olap_tpu_torch.segment.stream_ingest import (
    flatten_join_stream,
    ingest_parquet_stream as tstream,
)

from conftest import assert_frames_equal, make_sales_df
from test_torch_append import assert_same_store
from test_torch_sql import assert_answers_equal

N = 50_000


@pytest.fixture(scope="module")
def sales_parquet(tmp_path_factory):
    df = make_sales_df(N)
    # nullable columns exercise validity handling
    df.loc[df.index[::97], "product"] = None
    df["maybe"] = df["price"].where(df.index % 13 != 0)
    p = tmp_path_factory.mktemp("ing") / "sales.parquet"
    df.to_parquet(p)
    return str(p), df


def _streamed_pair(path, name, **kw):
    """Both packages' streamed stores of one file, held bit for bit."""
    jds, tds = jstream(name, path, **kw), tstream(name, path, **kw)
    assert_same_store(jds, tds)
    jctx, tctx = jsdot.Context(), tsdot.Context(device="cpu")
    jctx.store.register(jds)
    tctx.store.register(tds)
    return jctx, tctx


@pytest.fixture(scope="module")
def contexts(sales_parquet):
    path, df = sales_parquet
    jctx, tctx = _streamed_pair(path, "sales", time_column="ts",
                                target_rows=4096, batch_rows=8192)
    mem = tsdot.Context(device="cpu")
    mem.ingest_dataframe("sales", df, time_column="ts", target_rows=4096)
    return jctx, tctx, mem


QUERIES = [
    "select region, sum(qty) as s, count(*) as n from sales group by region",
    "select product, min(price) as mn, max(price) as mx from sales "
    "group by product",
    "select region, sum(maybe) as sm, count(maybe) as cm from sales "
    "group by region",
    "select count(*) as n from sales where product is null",
    "select year(ts) as y, count(*) as n from sales group by year(ts)",
    "select count(*) as n from sales "
    "where ts >= date '2015-06-01' and ts < date '2016-01-01'",
]


@pytest.mark.parametrize("sql", QUERIES)
def test_stream_matches_inmemory_and_jax(contexts, sql):
    jctx, tctx, mem = contexts
    got = tctx.sql(sql).to_pandas()
    assert tctx.history.entries()[-1].stats["mode"] == "engine"
    want = mem.sql(sql).to_pandas()
    assert_frames_equal(got, want, sort_by=list(want.columns), rtol=1e-5)
    assert_answers_equal(got, jctx.sql(sql).to_pandas(), ordered=False)


def test_stream_segment_time_bounds(contexts):
    ds = contexts[1].store.get("sales")
    assert ds.num_rows == N
    assert ds.num_segments > 4
    mins, maxs = ds.segment_time_bounds()
    # segments partition the day axis: bounds are ordered, non-overlapping
    assert all(maxs[i] < mins[i + 1] + 86_400_000
               for i in range(len(mins) - 1))
    for s in ds.segments:
        assert s.min_millis <= s.max_millis


def test_stream_wide_int_column(tmp_path):
    df = pd.DataFrame({
        "ts": pd.to_datetime(["2020-01-01"] * 5),
        "g": ["a", "a", "b", "b", "b"],
        "w": np.array([2**40, 2**41, 5, 2**42, 7], dtype=np.int64),
    })
    p = tmp_path / "wide.parquet"
    df.to_parquet(p)
    pair = _streamed_pair(str(p), "wf", time_column="ts")
    assert pair[1].store.get("wf").metrics["w"].values.dtype == np.int64
    sql = "select g, sum(w) as s from wf group by g order by g"
    got = pair[1].sql(sql).to_pandas()
    assert_answers_equal(got, pair[0].sql(sql).to_pandas(), ordered=True)
    np.testing.assert_array_equal(got["s"].to_numpy().astype(np.int64),
                                  df.groupby("g")["w"].sum().to_numpy())


def test_stream_no_time_column(tmp_path):
    df = pd.DataFrame({"k": ["x", "y"] * 2500,
                       "v": np.arange(5000, dtype=np.int64)})
    p = tmp_path / "plain.parquet"
    df.to_parquet(p)
    pair = _streamed_pair(str(p), "plain", target_rows=1000,
                          batch_rows=768)
    ds = pair[1].store.get("plain")
    assert ds.num_rows == 5000 and ds.num_segments == 5
    sql = "select k, sum(v) as s from plain group by k order by k"
    got = pair[1].sql(sql).to_pandas()
    assert_answers_equal(got, pair[0].sql(sql).to_pandas(), ordered=True)
    np.testing.assert_array_equal(got["s"].to_numpy(),
                                  df.groupby("k")["v"].sum().to_numpy())


def test_stream_peak_memory_bounded(tmp_path):
    """The streaming path holds no whole-dataset intermediates: its peak
    traced allocation stays well under the in-memory path's (measured in
    a subprocess, as the JAX test does, with the port's modules)."""
    n = 200_000
    r = np.random.default_rng(0)
    df = pd.DataFrame({
        "ts": (np.datetime64("2019-01-01")
               + r.integers(0, 400, n).astype("timedelta64[D]"))
        .astype("datetime64[ns]"),
        "k": r.choice([f"k{i:03d}" for i in range(300)], n),
        "a": r.integers(0, 1 << 30, n),
        "b": r.uniform(0, 1e6, n),
        "c": r.integers(0, 100, n),
    })
    p = tmp_path / "big.parquet"
    df.to_parquet(p)
    del df
    code = f"""
import json, tracemalloc
import pandas as pd
from spark_druid_olap_tpu_torch.segment.stream_ingest import (
    ingest_parquet_stream)
from spark_druid_olap_tpu_torch.segment.ingest import ingest_dataframe
p = {str(p)!r}
tracemalloc.start()
ds = ingest_parquet_stream("m", p, time_column="ts",
                           target_rows=1 << 16, batch_rows=1 << 14)
_, peak_stream = tracemalloc.get_traced_memory()
tracemalloc.stop()
store_bytes = sum(c.values.nbytes for c in ds.metrics.values()) \\
    + sum(c.codes.nbytes for c in ds.dims.values()) \\
    + ds.time.days.nbytes + ds.time.ms_in_day.nbytes
df = pd.read_parquet(p)
tracemalloc.start()
ingest_dataframe("m2", df, time_column="ts", target_rows=1 << 16)
_, peak_mem = tracemalloc.get_traced_memory()
tracemalloc.stop()
print(json.dumps({{"peak_stream": peak_stream, "store": store_bytes,
                   "peak_mem": peak_mem}}))
"""
    r2 = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, timeout=300)
    assert r2.returncode == 0, r2.stderr[-2000:]
    m = json.loads(r2.stdout.strip().splitlines()[-1])
    # overhead beyond the final store: a few 16k-row batches, not O(n)
    overhead = m["peak_stream"] - m["store"]
    assert overhead < 6 * (1 << 14) * 8 * 5 + (1 << 23), m
    assert m["peak_stream"] < m["peak_mem"] * 0.7, m


def test_flatten_join_stream(tmp_path):
    fact = pd.DataFrame({
        "fk": np.arange(10_000) % 100,
        "v": np.arange(10_000, dtype=np.int64),
    })
    dim = pd.DataFrame({"dk": np.arange(100),
                        "label": [f"L{i}" for i in range(100)]})
    fp = tmp_path / "fact.parquet"
    fact.to_parquet(fp)
    out = tmp_path / "flat.parquet"
    n = flatten_join_stream(str(fp), str(out), joins=[(dim, "fk", "dk")],
                            batch_rows=1024, drop_columns=["dk"])
    assert n == 10_000
    flat = pd.read_parquet(out)
    assert list(flat.columns) == ["fk", "v", "label"]
    want = fact.merge(dim, left_on="fk", right_on="dk").drop(columns=["dk"])
    pd.testing.assert_frame_equal(
        flat.sort_values("v").reset_index(drop=True),
        want.sort_values("v").reset_index(drop=True))


def test_stream_nullable_int_across_batches(tmp_path):
    # nulls in one batch only: rows of null-free batches stay valid, and
    # the column kind comes from the schema (LONG), not from whichever
    # batch's pandas dtype happened to be float
    n = 4000
    df = pd.DataFrame({
        "k": ["a", "b"] * (n // 2),
        "v": pd.array([None if i < 11 else i for i in range(n)],
                      dtype="Int64"),
    })
    p = tmp_path / "nullable.parquet"
    df.to_parquet(p)
    pair = _streamed_pair(str(p), "nb", batch_rows=1000)
    ds = pair[1].store.get("nb")
    assert ds.metrics["v"].kind == ColumnKind.LONG
    assert int(ds.metrics["v"].validity.sum()) == n - 11
    sql = "select count(v) as c, sum(v) as s from nb"
    got = pair[1].sql(sql).to_pandas()
    assert_answers_equal(got, pair[0].sql(sql).to_pandas(), ordered=True)
    assert int(got["c"][0]) == n - 11
    assert int(got["s"][0]) == sum(i for i in range(11, n))


def test_stream_multi_host_is_refused(sales_parquet):
    """The multi-host streamed ingest, once refused, now builds host 0's
    partial store: only its segments' rows, global metadata."""
    ds = tstream("sales", sales_parquet[0], time_column="ts", n_hosts=2,
                 host_id=0)
    full = tstream("sales", sales_parquet[0], time_column="ts")
    assert ds.is_partial and ds.num_rows == full.num_rows
    assert len(ds.metrics["qty"].values) == ds.local_num_rows < ds.num_rows


@pytest.mark.parametrize("fmt", ["parquet", "csv", "parquet_stream"])
def test_context_file_ingest_matches_jax(tmp_path, fmt):
    """``Context.ingest_parquet`` / ``ingest_csv`` /
    ``ingest_parquet_stream``: the same store and answers as the JAX
    package's same entry point on the same file."""
    df = make_sales_df(5000)
    path = tmp_path / f"sales.{'csv' if fmt == 'csv' else 'parquet'}"
    if fmt == "csv":
        df.to_csv(path, index=False)
    else:
        df.to_parquet(path)
    pair = [jsdot.Context(), tsdot.Context(device="cpu")]
    ds = [getattr(c, f"ingest_{fmt}")("sales", str(path), time_column="ts",
                                      target_rows=2048) for c in pair]
    assert_same_store(*ds)
    sql = ("select region, product, sum(qty) as q, sum(price) as p, "
           "count(*) as n from sales group by region, product")
    got = pair[1].sql(sql).to_pandas()
    assert pair[1].history.entries()[-1].stats["mode"] == "engine"
    assert_answers_equal(got, pair[0].sql(sql).to_pandas(), ordered=False)
