"""JAX ``tests/test_numerics.py`` bound to the port: integer exactness.

The port's engine runs with ``device="cpu"`` and emits x64 routes only
(i64 / f64 on every backend; ROADMAP A.2), so the JAX file's ``no_x64``
fixture, which switches the JAX backend to i32 / f32, has no object here:
its cases run on the port's one dtype environment with the JAX test's
exact oracles, and the sharded ones on the port's ``("cpu",) * 8`` mesh,
each ``sharded`` flag held equal to the JAX engine's on its emulated
8-device mesh. Four cases test TPU-only routes and are not copied:
``test_limb_kernel_unit`` (the 16-bit limb kernel),
``test_wide_long_falls_back_on_32bit_backend`` and
``test_wide_long_sql_host_fallback_is_exact`` (a 32-bit backend), and
``test_i32_scatter_sum_route_planned`` (the ``i32`` / ``limbs`` route
tags).

Original notes: TPU-dtype exactness tests.

These run with x64 DISABLED, which makes the CPU backend canonicalize to
i32/f32 — the same dtype environment as a real TPU (where f64 is unsupported
and i64 emulated). Every integer aggregate must then be EXACT via the lane /
limb / i32 routes (groupby.plan_route), not merely float-close: Druid's
aggregators are exact longs (reference ``DruidQuerySpec.scala:283-377``).

Covers the round-1 verdict's failure cases: int columns with values > 2^24
(min/max/anyvalue would round in f32), sums > 2^32 (overflow i32, round in
f32), on both the MXU one-hot-matmul path and the scatter path, single-chip
and sharded over the virtual 8-device mesh (limb psum + per-chip ff host
combine).
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

from spark_druid_olap_tpu.parallel.mesh import make_mesh as jmake_mesh

from spark_druid_olap_tpu_torch.segment.ingest import ingest_dataframe
from spark_druid_olap_tpu_torch.segment.store import SegmentStore
from spark_druid_olap_tpu_torch.parallel.executor import QueryEngine
from spark_druid_olap_tpu_torch.parallel.mesh import make_mesh
from spark_druid_olap_tpu_torch.utils.config import Config

from torch_twin import jax_stats, jax_store
from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ir.spec import (
    AggregationSpec,
    DimensionSpec,
    GroupByQuerySpec,
)

N_ROWS = 60_000
CPU_MESH = ("cpu",) * 8


@pytest.fixture(scope="module")
def big_df():
    r = np.random.default_rng(11)
    ts = (np.datetime64("2019-01-01")
          + r.integers(0, 365, N_ROWS).astype("timedelta64[D]"))
    return pd.DataFrame({
        "ts": ts.astype("datetime64[ns]"),
        "g": r.choice(["a", "b", "c", "d"], N_ROWS),
        # values straddling 2^24 (f32 integer-exactness cliff) and
        # well past 2^20 so the 60k-row sums exceed 2^32
        "big": (r.integers(0, 1 << 30, N_ROWS)
                + (1 << 24)).astype(np.int64),
        "sgn": r.integers(-(1 << 26), 1 << 26, N_ROWS).astype(np.int64),
        "small": r.integers(0, 100, N_ROWS).astype(np.int64),
        "price": np.round(r.uniform(1e3, 1e5, N_ROWS), 2),
    })


@pytest.fixture(scope="module")
def big_store(big_df):
    ds = ingest_dataframe("big", big_df, time_column="ts",
                          target_rows=8192)
    st = SegmentStore()
    st.register(ds)
    return st


def _spec(**kw):
    base = dict(
        datasource="big",
        dimensions=(DimensionSpec("g", "g"),),
        aggregations=(
            AggregationSpec("longsum", "s_big", field="big"),
            AggregationSpec("longsum", "s_sgn", field="sgn"),
            AggregationSpec("longsum", "s_small", field="small"),
            AggregationSpec("longmin", "mn_big", field="big"),
            AggregationSpec("longmax", "mx_big", field="big"),
            AggregationSpec("longmin", "mn_sgn", field="sgn"),
            AggregationSpec("count", "n"),
            AggregationSpec("doublesum", "s_price", field="price"),
        ))
    base.update(kw)
    return GroupByQuerySpec(**base)


def _oracle(df):
    g = df.groupby("g")
    return pd.DataFrame({
        "s_big": g["big"].sum(),
        "s_sgn": g["sgn"].sum(),
        "s_small": g["small"].sum(),
        "mn_big": g["big"].min(),
        "mx_big": g["big"].max(),
        "mn_sgn": g["sgn"].min(),
        "n": g.size(),
        "s_price": g["price"].sum(),
    }).reset_index()


def _check_exact(r, big_df):
    got = r.to_pandas().sort_values("g").reset_index(drop=True)
    want = _oracle(big_df).sort_values("g").reset_index(drop=True)
    for c in ("s_big", "s_sgn", "s_small", "mn_big", "mx_big", "mn_sgn",
              "n"):
        np.testing.assert_array_equal(
            got[c].to_numpy().astype(np.int64), want[c].to_numpy(),
            err_msg=f"column {c} must be EXACT under TPU dtypes")
    # float sums: storage is f32 so ingest already rounds values; compare
    # against the f32-rounded oracle with the compensated-sum tolerance
    want_f32 = big_df.assign(price=big_df.price.astype(np.float32)
                             .astype(np.float64)) \
        .groupby("g")["price"].sum().reset_index(drop=True)
    np.testing.assert_allclose(got["s_price"].to_numpy(),
                               want_f32.to_numpy(), rtol=1e-6)


def test_matmul_path_exact_ints(big_store, big_df):
    eng = QueryEngine(big_store, device="cpu")
    _check_exact(eng.execute(_spec()), big_df)


def test_scatter_path_exact_ints(big_store, big_df):
    cfg = Config({"sdot.engine.groupby.matmul.max.keys": 1})
    eng = QueryEngine(big_store, config=cfg, device="cpu")
    _check_exact(eng.execute(_spec()), big_df)


def test_sharded_exact_ints(big_store, big_df):
    off = {"sdot.querycostmodel.enabled": False}
    eng = QueryEngine(big_store, mesh=make_mesh(devices=CPU_MESH),
                      config=Config(off), device="cpu")
    _check_exact(eng.execute(_spec()), big_df)
    jstore = jax_store(("big", big_df, {"time_column": "ts",
                                        "target_rows": 8192}))
    assert eng.last_stats["sharded"] == \
        jax_stats(jstore, _spec(), off, jmake_mesh())["sharded"]


def test_sharded_scatter_exact_ints(big_store, big_df):
    cfg = Config({"sdot.engine.groupby.matmul.max.keys": 1,
                  "sdot.querycostmodel.enabled": False})
    eng = QueryEngine(big_store, mesh=make_mesh(devices=CPU_MESH),
                      config=cfg, device="cpu")
    _check_exact(eng.execute(_spec()), big_df)


def test_global_aggregate_exact(big_store, big_df):
    eng = QueryEngine(big_store, device="cpu")
    r = eng.execute(_spec(dimensions=()))
    got = r.to_pandas()
    assert int(got["s_big"][0]) == int(big_df["big"].sum())
    assert int(got["s_sgn"][0]) == int(big_df["sgn"].sum())
    assert int(got["n"][0]) == len(big_df)
    assert int(got["mn_big"][0]) == int(big_df["big"].min())
    assert int(got["mx_big"][0]) == int(big_df["big"].max())


def test_filtered_agg_exact(big_store, big_df):
    from spark_druid_olap_tpu_torch.ir.spec import SelectorFilter
    eng = QueryEngine(big_store, device="cpu")
    r = eng.execute(_spec(aggregations=(
        AggregationSpec("longsum", "s_big", field="big",
                        filter=SelectorFilter("g", "a")),
        AggregationSpec("count", "n"),
    ), dimensions=()))
    got = r.to_pandas()
    want = int(big_df.loc[big_df.g == "a", "big"].sum())
    assert int(got["s_big"][0]) == want


def test_open_interval_no_i32_overflow(big_store, big_df):
    """An open-ended time interval carries a +-2^63-scale ms bound whose
    day number overflows i32 lanes unless interval_mask clamps it to the
    scan's day range (TPU SF1 q3 regression: 'l_shipdate > date X' =>
    interval (X, +inf))."""
    lo = int(np.datetime64("2019-03-01").astype("datetime64[ms]")
             .astype(np.int64))
    for hi in (2**62, 2**63 - 1):
        eng = QueryEngine(big_store, device="cpu")
        r = eng.execute(_spec(intervals=((lo, hi),)))
        got = r.to_pandas()
        sub = big_df[big_df.ts >= np.datetime64("2019-03-01")]
        want = _oracle(sub)
        got = got.sort_values("g").reset_index(drop=True)
        np.testing.assert_array_equal(
            got["s_big"].to_numpy().astype(np.int64),
            want.sort_values("g")["s_big"].to_numpy())
    # empty interval entirely above the data
    eng = QueryEngine(big_store, device="cpu")
    r = eng.execute(_spec(intervals=((2**62, 2**62 + 1),)))
    assert len(r.to_pandas()) == 0


def test_case_expression_sum_exact(big_store, big_df):
    # sum(case when g='a' then big else 0 end): _expr_bounds must mark the
    # expression integer-exact so the lanes route fires
    eng = QueryEngine(big_store, device="cpu")
    case = E.Case(((E.Comparison("=", E.Column("g"), E.Literal("a")),
                    E.Column("big")),), E.Literal(0))
    r = eng.execute(_spec(aggregations=(
        AggregationSpec("longsum", "s", expr=case),
        AggregationSpec("count", "n"),
    ), dimensions=()))
    want = int(big_df.loc[big_df.g == "a", "big"].sum())
    assert int(r.to_pandas()["s"][0]) == want


# -----------------------------------------------------------------------------
# wide (beyond-int32) LONG columns
# -----------------------------------------------------------------------------

def test_wide_long_column_keeps_int64_storage():
    from spark_druid_olap_tpu_torch.segment.column import (
        ColumnKind, build_metric_column)
    wide = build_metric_column(
        "w", np.array([1, 2**35, -5], dtype=np.int64), ColumnKind.LONG)
    assert wide.values.dtype == np.int64
    narrow = build_metric_column(
        "n", np.array([1, 2**30, -5], dtype=np.int64), ColumnKind.LONG)
    assert narrow.values.dtype == np.int32


def _wide_df():
    r = np.random.default_rng(5)
    n = 8_000
    return pd.DataFrame({
        "ts": (np.datetime64("2020-01-01")
               + r.integers(0, 100, n).astype("timedelta64[D]"))
        .astype("datetime64[ns]"),
        "g": r.choice(["a", "b", "c"], n),
        "w": r.integers(2**33, 2**45, n),     # values far beyond int32
    })


def test_wide_long_exact_on_x64_engine():
    # x64 backend carries wide values in native i64 routes: exact at any
    # magnitude
    _wide_long_exact_check()


def _wide_long_exact_check():
    df = _wide_df()
    st = SegmentStore()
    st.register(ingest_dataframe("wfact", df, time_column="ts",
                                 target_rows=2048))
    eng = QueryEngine(st, device="cpu")
    q = GroupByQuerySpec(
        datasource="wfact", dimensions=(DimensionSpec("g", "g"),),
        aggregations=(AggregationSpec("longsum", "s", field="w"),
                      AggregationSpec("longmin", "mn", field="w"),
                      AggregationSpec("longmax", "mx", field="w")))
    got = eng.execute(q).to_pandas().sort_values("g").reset_index(drop=True)
    want = df.groupby("g", as_index=False).agg(
        s=("w", "sum"), mn=("w", "min"), mx=("w", "max"))
    for c in ("s", "mn", "mx"):
        np.testing.assert_array_equal(
            got[c].to_numpy().astype(np.int64), want[c].to_numpy(),
            err_msg=f"{c} must be exact for wide longs")


def test_wide_long_min_with_empty_groups_stays_exact():
    # filtered longmin leaving some groups empty must not round the
    # non-empty groups' wide values through f64
    from spark_druid_olap_tpu_torch.ir.spec import SelectorFilter
    df = pd.DataFrame({
        "ts": pd.to_datetime(["2020-01-01"] * 4),
        "g": ["a", "a", "b", "b"],
        "f": ["y", "y", "n", "n"],
        "w": np.array([2**60 + 1, 2**60 + 3, 2**61 + 7, 2**61 + 9],
                      dtype=np.int64),
    })
    st = SegmentStore()
    st.register(ingest_dataframe("wmin", df, time_column="ts"))
    q = GroupByQuerySpec(
        datasource="wmin", dimensions=(DimensionSpec("g", "g"),),
        aggregations=(AggregationSpec(
            "longmin", "mn", field="w",
            filter=SelectorFilter("f", "y")),))
    got = QueryEngine(st, device="cpu").execute(q).to_pandas() \
        .sort_values("g").reset_index(drop=True)
    assert got.loc[0, "mn"] == 2**60 + 1      # exact, not f64-rounded
    assert got.loc[1, "mn"] is None           # empty group -> null
