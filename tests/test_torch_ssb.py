"""The port's SSB workload against the JAX package's.

The port's copy of ``tools/ssb.py`` gives the JAX generator's frames
(``generate``, ``flatten``, and ``generate_stream`` / ``flatten_stream``
through Parquet files in the test's temporary directory). Then the cases
of ``tests/test_ssb.py`` run against both engines at SF 0.003: all 13
statements push down in both packages with equal answers (dimensions,
integers and counts exact, float sums rtol 1e-6), and the pandas oracles
of q1.1, q2.1, q3.1, q4.1 and q3.4 hold on the port.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.tools import ssb as jssb

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.tools import ssb as tssb

from test_torch_sql import assert_answers_equal

SF = 0.003
TABLES = ["lineorder", "date", "customer", "supplier", "part"]


@pytest.fixture(scope="module")
def both_generated():
    return jssb.generate(0.01), tssb.generate(0.01)


@pytest.mark.parametrize("table", TABLES)
def test_ssb_generator_matches_jax(table, both_generated):
    jax_tables, port_tables = both_generated
    pd.testing.assert_frame_equal(port_tables[table], jax_tables[table])


def test_ssb_flatten_matches_jax(both_generated):
    jax_tables, port_tables = both_generated
    pd.testing.assert_frame_equal(tssb.flatten(port_tables),
                                  jssb.flatten(jax_tables))


def test_ssb_stream_generator_matches_jax(tmp_path):
    out = {}
    for pkg, mod in (("jax", jssb), ("torch", tssb)):
        lo = tmp_path / f"{pkg}_lineorder.parquet"
        flat = tmp_path / f"{pkg}_flat.parquet"
        dims, n = mod.generate_stream(0.005, str(lo), batch_rows=7000)
        rows = mod.flatten_stream(dims, str(lo), str(flat), batch_rows=5000)
        out[pkg] = (dims, n, rows, pd.read_parquet(lo),
                    pd.read_parquet(flat))
    (jd, jn, jr, jlo, jflat), (td, tn, tr, tlo, tflat) = \
        out["jax"], out["torch"]
    assert tn == jn == 30_000 and tr == jr == tn
    for name in jd:
        pd.testing.assert_frame_equal(td[name], jd[name])
    pd.testing.assert_frame_equal(tlo, jlo)
    pd.testing.assert_frame_equal(tflat, jflat)


@pytest.fixture(scope="module")
def env():
    jctx, tctx = jsdot.Context(), tsdot.Context(device="cpu")
    jssb.setup_context(jctx, sf=SF, target_rows=4096)
    _, flat = tssb.setup_context(tctx, sf=SF, target_rows=4096)
    return jctx, tctx, flat


def run(ctx, name):
    r = ctx.sql(tssb.QUERIES[name]).to_pandas()
    return r, ctx.history.entries()[-1].stats["mode"]


@pytest.mark.parametrize("name", list(tssb.QUERIES))
def test_all_13_push_down_and_answer_as_jax(env, name):
    jctx, tctx, _ = env
    got, mode = run(tctx, name)
    want, jmode = run(jctx, name)
    assert mode == jmode == "engine", (name, mode, jmode)
    assert_answers_equal(got, want,
                         ordered="order by" in tssb.QUERIES[name].lower())


def test_q1_1_oracle(env):
    _, ctx, flat = env
    got, _ = run(ctx, "q1.1")
    m = (flat.d_year == 1993) & flat.lo_discount.between(1, 3) & \
        (flat.lo_quantity < 25)
    want = (flat.lo_extendedprice[m] * flat.lo_discount[m]).sum()
    np.testing.assert_allclose(float(got["revenue"][0]), want, rtol=1e-6)


def test_q2_1_oracle(env):
    _, ctx, flat = env
    got, _ = run(ctx, "q2.1")
    m = (flat.p_category == "MFGR#12") & (flat.s_region == "AMERICA")
    want = flat[m].groupby(["d_year", "p_brand1"]).lo_revenue.sum() \
        .reset_index().sort_values(["d_year", "p_brand1"]) \
        .reset_index(drop=True)
    assert list(got["d_year"]) == list(want["d_year"])
    assert list(got["p_brand1"]) == list(want["p_brand1"])
    np.testing.assert_allclose(got["lo_revenue"], want["lo_revenue"],
                               rtol=1e-6)


def test_q3_1_oracle(env):
    _, ctx, flat = env
    got, _ = run(ctx, "q3.1")
    m = (flat.c_region == "ASIA") & (flat.s_region == "ASIA") & \
        flat.d_year.between(1992, 1997)
    want = flat[m].groupby(["c_nation", "s_nation", "d_year"]) \
        .lo_revenue.sum().reset_index()
    assert len(got) == len(want)
    gm = got.set_index(["c_nation", "s_nation", "d_year"]).lo_revenue
    for _, row in want.iterrows():
        np.testing.assert_allclose(
            gm[(row.c_nation, row.s_nation, row.d_year)], row.lo_revenue,
            rtol=1e-6)


def test_q4_1_oracle(env):
    _, ctx, flat = env
    got, _ = run(ctx, "q4.1")
    m = (flat.c_region == "AMERICA") & (flat.s_region == "AMERICA") & \
        flat.p_mfgr.isin(["MFGR#1", "MFGR#2"])
    want = flat[m].assign(pf=flat.lo_revenue - flat.lo_supplycost) \
        .groupby(["d_year", "c_nation"]).pf.sum().reset_index() \
        .sort_values(["d_year", "c_nation"]).reset_index(drop=True)
    assert list(got["d_year"]) == list(want["d_year"])
    assert list(got["c_nation"]) == list(want["c_nation"])
    np.testing.assert_allclose(got["profit"], want["pf"], rtol=1e-6)


def test_q3_4_empty_or_small(env):
    _, ctx, flat = env
    got, _ = run(ctx, "q3.4")
    m = (flat.c_city.isin(["UNITED KI1", "UNITED KI5"])
         & flat.s_city.isin(["UNITED KI1", "UNITED KI5"])
         & (flat.d_yearmonth == "Dec1997"))
    assert len(got) == len(
        flat[m].groupby(["c_city", "s_city", "d_year"]).size())
