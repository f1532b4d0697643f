"""JAX ``tests/test_datatypes.py`` bound to the port: data-type coverage
(reference: DataTypesTest).

Every ingestible dtype travels ingest -> scan -> decode intact, with
NULLs, across filters, group-bys and min/max, on the port with
``device="cpu"``, against the JAX test's pandas oracles at its own
tolerances; each statement's mode is held equal to the JAX package's on
a twin context over the same frame."""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu_torch as sdot

from torch_twin import last_mode_as_jax, mirrored


N = 12_000


@pytest.fixture(scope="module")
def dctx():
    rng = np.random.default_rng(77)
    f32 = np.round(rng.uniform(-1e4, 1e4, N), 3).astype(np.float32)
    f64 = rng.uniform(-1e9, 1e9, N)
    i8 = rng.integers(-100, 100, N).astype(np.int8)
    i16 = rng.integers(-30000, 30000, N).astype(np.int16)
    i32 = rng.integers(-(2**30), 2**30, N).astype(np.int32)
    i64small = rng.integers(-(2**30), 2**30, N).astype(np.int64)
    u32 = rng.integers(0, 2**30, N).astype(np.uint32)
    b = rng.random(N) < 0.4
    s = rng.choice(["", "a", "Ünïcødé", "x" * 40, "tab\tchar"], N)
    nullable = rng.uniform(0, 100, N)
    nullable[rng.random(N) < 0.15] = np.nan
    d = (np.datetime64("2020-01-01")
         + rng.integers(0, 500, N).astype("timedelta64[D]"))
    ts = (np.datetime64("2020-01-01T00:00:00")
          + rng.integers(0, 500 * 86_400, N).astype("timedelta64[s]"))
    df = pd.DataFrame({
        "ts": ts.astype("datetime64[ns]"),
        "d": d.astype("datetime64[ns]"),
        "s": s, "b": b, "i8": i8, "i16": i16, "i32": i32,
        "i64": i64small, "u32": u32.astype(np.int64),
        "f32": f32.astype(np.float64), "f64": f64, "nul": nullable,
        "g": rng.choice(["p", "q", "r"], N),
    })
    c = mirrored(sdot.Context(device="cpu"))
    c.ingest_dataframe("t", df, time_column="ts", target_rows=2048)
    c._df = df
    return c


def _mode(ctx):
    return last_mode_as_jax(ctx)


def test_integer_widths_roundtrip(dctx):
    df = dctx._df
    got = dctx.sql(
        "select g, sum(i8) as s8, sum(i16) as s16, sum(i32) as s32, "
        "sum(i64) as s64, sum(u32) as su, min(i32) as mn, max(i64) as mx "
        "from t group by g order by g").to_pandas()
    assert _mode(dctx) == "engine"
    want = df.groupby("g").agg(
        s8=("i8", "sum"), s16=("i16", "sum"), s32=("i32", "sum"),
        s64=("i64", "sum"), su=("u32", "sum"), mn=("i32", "min"),
        mx=("i64", "max")).reset_index()
    for c in ("s8", "s16", "s32", "s64", "su", "mn", "mx"):
        np.testing.assert_array_equal(
            got[c].to_numpy().astype(np.int64), want[c].to_numpy(),
            err_msg=c)


def test_floats_and_bools(dctx):
    df = dctx._df
    got = dctx.sql(
        "select g, sum(f32) as sf32, sum(f64) as sf64, "
        "sum(case when b then 1 else 0 end) as nb "
        "from t group by g order by g").to_pandas()
    assert _mode(dctx) == "engine"
    want = df.groupby("g").agg(
        sf32=("f32", "sum"), sf64=("f64", "sum")).reset_index()
    nb = df.groupby("g")["b"].sum().reset_index()
    # DOUBLE storage is f32 (design): ingest rounds values, so sums
    # carry ~1e-7-relative error vs the f64 pandas oracle
    np.testing.assert_allclose(got["sf32"], want["sf32"], rtol=1e-6)
    np.testing.assert_allclose(got["sf64"], want["sf64"], rtol=1e-6)
    np.testing.assert_array_equal(got["nb"].to_numpy().astype(np.int64),
                                  nb["b"].to_numpy())


def test_strings_empty_unicode_specials(dctx):
    df = dctx._df
    got = dctx.sql("select s, count(*) as n from t group by s "
                   "order by s").to_pandas()
    assert _mode(dctx) == "engine"
    want = df.groupby("s").size().sort_index()
    assert got["s"].tolist() == list(want.index)
    np.testing.assert_array_equal(got["n"].to_numpy().astype(np.int64),
                                  want.to_numpy())
    eq = dctx.sql("select count(*) as n from t where s = 'Ünïcødé'") \
        .to_pandas()
    assert int(eq["n"][0]) == int((df.s == "Ünïcødé").sum())
    empty = dctx.sql("select count(*) as n from t where s = ''").to_pandas()
    assert int(empty["n"][0]) == int((df.s == "").sum())


def test_nullable_float_aggregates(dctx):
    df = dctx._df
    got = dctx.sql(
        "select g, sum(nul) as s, count(nul) as n, count(*) as all_n "
        "from t group by g order by g").to_pandas()
    want = df.groupby("g").agg(s=("nul", "sum"),
                               n=("nul", "count"),
                               all_n=("nul", "size")).reset_index()
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-6)
    np.testing.assert_array_equal(got["n"].to_numpy().astype(np.int64),
                                  want["n"].to_numpy())
    np.testing.assert_array_equal(got["all_n"].to_numpy().astype(np.int64),
                                  want["all_n"].to_numpy())
    nn = dctx.sql("select count(*) as n from t where nul is null") \
        .to_pandas()
    assert int(nn["n"][0]) == int(df.nul.isna().sum())


def test_date_and_timestamp_semantics(dctx):
    df = dctx._df
    got = dctx.sql(
        "select year(d) as y, month(d) as m, count(*) as n "
        "from t group by year(d), month(d) order by y, m").to_pandas()
    assert _mode(dctx) == "engine"
    want = df.groupby([df.d.dt.year, df.d.dt.month]).size()
    np.testing.assert_array_equal(got["n"].to_numpy().astype(np.int64),
                                  want.to_numpy())
    rng_q = dctx.sql("select count(*) as n from t "
                     "where ts >= timestamp '2020-06-01 12:00:00'") \
        .to_pandas()
    want_n = int((df.ts >= pd.Timestamp("2020-06-01 12:00:00")).sum())
    assert int(rng_q["n"][0]) == want_n


def test_min_max_on_every_numeric(dctx):
    df = dctx._df
    cols = ["i8", "i16", "i32", "i64", "u32", "f64"]
    sel = ", ".join(f"min({c}) as mn_{c}, max({c}) as mx_{c}"
                    for c in cols)
    got = dctx.sql(f"select {sel} from t").to_pandas()
    for c in cols:
        rel = 1e-6 if c == "f64" else 0     # f32 storage for DOUBLE
        assert float(got[f"mn_{c}"][0]) == pytest.approx(
            float(df[c].min()), rel=rel, abs=0 if rel else None), c
        assert float(got[f"mx_{c}"][0]) == pytest.approx(
            float(df[c].max()), rel=rel, abs=0 if rel else None), c


def test_zoned_timestamp_literal_not_double_shifted():
    """A tz-offset literal is an absolute instant: the session timezone
    must not shift it again."""
    ts = pd.to_datetime(["2020-06-01 09:00", "2020-06-01 11:00",
                         "2020-06-01 13:00"])
    df = pd.DataFrame({"ts": ts, "v": [1, 2, 3]})
    c = sdot.Context({"sdot.timezone": "Europe/Paris"}, device="cpu")
    c.ingest_dataframe("z", df, time_column="ts", target_rows=1024)
    # 12:00+02:00 == 10:00Z -> rows at 11:00Z and 13:00Z qualify
    got = c.sql("select count(*) as n from z "
                "where ts >= timestamp '2020-06-01T12:00:00+02:00'") \
        .to_pandas()
    assert int(got["n"][0]) == 2
    # naive literal means Paris wall clock: 12:00 local == 10:00Z -> same
    got2 = c.sql("select count(*) as n from z "
                 "where ts >= timestamp '2020-06-01 12:00:00'").to_pandas()
    assert int(got2["n"][0]) == 2
    # and in UTC sessions the naive literal is UTC: only 13:00Z qualifies
    c2 = sdot.Context(device="cpu")
    c2.ingest_dataframe("z", df, time_column="ts", target_rows=1024)
    got3 = c2.sql("select count(*) as n from z "
                  "where ts >= timestamp '2020-06-01 12:00:00'").to_pandas()
    assert int(got3["n"][0]) == 1
