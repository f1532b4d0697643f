"""JAX ``tests/test_timezone.py`` bound to the port: session timezone
tests.

The port runs with ``device="cpu"`` against the JAX test's pandas
timezone oracle (exact: every answer is a count or a calendar field);
each statement's mode is held equal to the JAX package's on a twin
context with the same timezone and frame.

Original notes: session timezone tests (reference: spark.sparklinedata.tz.id driving time
bucketing/extraction — DruidPlanner.scala:73-76, DateTimeExtractor.scala).

Differential engine-vs-pandas-tz oracle over a dataset whose timestamps
cross local-day boundaries: a fixed-offset zone (+05:30, Asia/Kolkata — no
DST, exact everywhere) and UTC-unchanged sanity. Date literals in WHERE
mean LOCAL midnight.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu_torch as sdot

from torch_twin import last_mode_as_jax, mirrored

TZ = "Asia/Kolkata"          # +05:30, no DST: the LUT is exact everywhere


def _df(n=20_000, seed=9):
    r = np.random.default_rng(seed)
    base = np.datetime64("2019-01-01T00:00:00")
    ts = base + r.integers(0, 86_400 * 400, n).astype("timedelta64[s]")
    return pd.DataFrame({
        "ts": ts.astype("datetime64[ns]"),
        "g": r.choice(["a", "b", "c"], n),
        "v": r.integers(1, 100, n),
    })


@pytest.fixture(scope="module")
def tz_ctx():
    ctx = mirrored(sdot.Context(config={"sdot.timezone": TZ}, device="cpu"),
                   {"sdot.timezone": TZ})
    ctx.ingest_dataframe("ev", _df(), time_column="ts", target_rows=4096)
    return ctx


@pytest.fixture(scope="module")
def local(tz_ctx):
    df = _df()
    lt = df.ts.dt.tz_localize("UTC").dt.tz_convert(TZ)
    return df.assign(lts=lt.dt.tz_localize(None))


def test_year_extraction_local(tz_ctx, local):
    got = tz_ctx.sql("select year(ts) as y, count(*) as n from ev "
                     "group by year(ts) order by y").to_pandas()
    assert last_mode_as_jax(tz_ctx) == "engine"
    want = local.groupby(local.lts.dt.year).size()
    np.testing.assert_array_equal(got["y"].to_numpy(), want.index.to_numpy())
    np.testing.assert_array_equal(got["n"].to_numpy(), want.to_numpy())


def test_month_counts_differ_from_utc(tz_ctx, local):
    # rows after 18:30 UTC on a month's last day belong to the NEXT local
    # month: the local histogram must differ from the UTC one
    got = tz_ctx.sql("select month(ts) as m, count(*) as n from ev "
                     "group by month(ts) order by m").to_pandas()
    want = local.groupby(local.lts.dt.month).size()
    np.testing.assert_array_equal(got["n"].to_numpy(), want.to_numpy())
    utc = local.groupby(local.ts.dt.month).size()
    assert not np.array_equal(want.to_numpy(), utc.to_numpy())


def test_day_granularity_buckets_local(tz_ctx, local):
    got = tz_ctx.sql("select date_trunc('day', ts) as d, count(*) as n "
                     "from ev group by date_trunc('day', ts) order by d") \
        .to_pandas()
    assert last_mode_as_jax(tz_ctx) == "engine"
    want = local.groupby(local.lts.dt.floor("D")).size()
    np.testing.assert_array_equal(
        got["d"].to_numpy().astype("datetime64[D]"),
        want.index.to_numpy().astype("datetime64[D]"))
    np.testing.assert_array_equal(got["n"].to_numpy(), want.to_numpy())


def test_hour_extraction_local(tz_ctx, local):
    # +05:30 shifts hour AND minute phase: hour(ts) must be the local hour
    got = tz_ctx.sql("select hour(ts) as h, count(*) as n from ev "
                     "group by hour(ts) order by h").to_pandas()
    assert last_mode_as_jax(tz_ctx) == "engine"
    want = local.groupby(local.lts.dt.hour).size()
    np.testing.assert_array_equal(got["h"].to_numpy(), want.index.to_numpy())
    np.testing.assert_array_equal(got["n"].to_numpy(), want.to_numpy())


def test_interval_literal_is_local_midnight(tz_ctx, local):
    got = tz_ctx.sql("select count(*) as n from ev "
                     "where ts >= date '2019-06-01' "
                     "and ts < date '2019-07-01'").to_pandas()
    assert last_mode_as_jax(tz_ctx) == "engine"
    sel = (local.lts >= pd.Timestamp("2019-06-01")) \
        & (local.lts < pd.Timestamp("2019-07-01"))
    assert int(got["n"][0]) == int(sel.sum())


def test_host_tier_uses_same_tz(tz_ctx, local):
    # a host-evaluated statement must agree with the engine on local fields
    from spark_druid_olap_tpu_torch.planner import host_exec
    from spark_druid_olap_tpu_torch.sql.parser import parse_select
    from spark_druid_olap_tpu_torch.utils import host_eval
    sql = ("select year(ts) as y, count(*) as n from ev "
           "group by year(ts) order by y")
    got = tz_ctx.sql(sql).to_pandas()
    tok = host_eval.SESSION_TZ.set(TZ)
    try:
        tz_ctx.host_engine_assist = False
        want = host_exec.execute_select(tz_ctx, parse_select(sql))
    finally:
        tz_ctx.host_engine_assist = True
        host_eval.SESSION_TZ.reset(tok)
    np.testing.assert_array_equal(got["y"].to_numpy(),
                                  want["y"].to_numpy())
    np.testing.assert_array_equal(got["n"].to_numpy(),
                                  want["n"].to_numpy())


def test_utc_default_unchanged():
    ctx = sdot.Context(device="cpu")
    df = _df(3000)
    ctx.ingest_dataframe("ev", df, time_column="ts", target_rows=2048)
    got = ctx.sql("select year(ts) as y, count(*) as n from ev "
                  "group by year(ts) order by y").to_pandas()
    want = df.groupby(df.ts.dt.year).size()
    np.testing.assert_array_equal(got["n"].to_numpy(), want.to_numpy())


def test_fixed_offset_spelling():
    ctx = sdot.Context(config={"sdot.timezone": "+05:30"}, device="cpu")
    df = _df(3000)
    ctx.ingest_dataframe("ev", df, time_column="ts", target_rows=2048)
    got = ctx.sql("select day(ts) as d, count(*) as n from ev "
                  "group by day(ts) order by d").to_pandas()
    lt = df.ts.dt.tz_localize("UTC").dt.tz_convert("Asia/Kolkata")
    want = df.groupby(lt.dt.day).size()
    np.testing.assert_array_equal(got["n"].to_numpy(), want.to_numpy())


def test_where_expression_uses_local_time(tz_ctx, local):
    # the device EXPRESSION path (WHERE month(ts) = 6) must agree with the
    # GROUP BY dimension path on local time
    got = tz_ctx.sql("select count(*) as n from ev "
                     "where month(ts) = 6").to_pandas()
    assert last_mode_as_jax(tz_ctx) == "engine"
    grouped = tz_ctx.sql("select month(ts) as m, count(*) as n from ev "
                         "group by month(ts)").to_pandas()
    want = int(grouped.set_index("m").loc[6, "n"])
    assert int(got["n"][0]) == want
    assert want == int((local.lts.dt.month == 6).sum())


def test_between_matches_comparison_forms(tz_ctx, local):
    # BETWEEN (native bound filter) and >=/<= (interval path) must agree on
    # local-midnight literal semantics even inside an OR
    a = int(tz_ctx.sql("select count(*) as n from ev where "
                       "ts between date '2019-06-01' and date '2019-06-30' "
                       "or g = 'zz'").to_pandas().n[0])
    b = int(tz_ctx.sql("select count(*) as n from ev where "
                       "(ts >= date '2019-06-01' and "
                       " ts <= date '2019-06-30') or g = 'zz'")
            .to_pandas().n[0])
    assert a == b
    want = int(((local.lts >= pd.Timestamp("2019-06-01"))
                & (local.lts <= pd.Timestamp("2019-06-30"))).sum())
    assert a == want


def test_time_equality_selector_uses_session_tz():
    """ts = timestamp '...' equality follows the same literal policy as
    range bounds (naive literal = session-local wall clock)."""
    import spark_druid_olap_tpu_torch as sdot
    ts = pd.to_datetime(["2020-06-01 10:00", "2020-06-01 12:00"])
    df = pd.DataFrame({"ts": ts, "v": [1, 2]})
    c = sdot.Context({"sdot.timezone": "Europe/Paris"}, device="cpu")
    c.ingest_dataframe("z", df, time_column="ts", target_rows=1024)
    # Paris 12:00 local == 10:00Z -> matches the first row
    got = c.sql("select count(*) as n from z "
                "where ts = timestamp '2020-06-01 12:00:00'").to_pandas()
    assert int(got["n"][0]) == 1
    got2 = c.sql("select v from z "
                 "where ts = timestamp '2020-06-01T12:00:00+02:00'") \
        .to_pandas()
    assert got2["v"].tolist() == [1]
