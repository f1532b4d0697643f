"""The port's sketch aggregations (HLL, theta, KLL) against the JAX package.

Two levels, on the CPU:

- the register ops (``ops/hll.py``, ``ops/theta.py``, ``ops/kll.py``): the
  same numpy-seeded keys, masks and values through the JAX function and its
  port; registers must be equal bit for bit (HLL int32 rho maxima, theta
  float32 lane minima, KLL int32 ``(t, v, counts)``), and so must the
  estimates. Values cover int32 codes, negative int64s, float32 bits and,
  for KLL, float32 values with NaNs and integer values; keys include a
  group no row reaches and a group whose rows are all masked out.
- the engine: ``Context.sql`` on both packages over one seeded frame,
  answer- and mode-equal: grouped and global, filtered, compacted (late
  materialization forced), beside device top-k and device HAVING, ordered
  by a sketch (no device top-k then), and forced onto the hashed tier
  (host mode on both). The dense route's registers themselves are held
  bit for bit against the JAX engine's scan program (``build_core``).

Tolerance: registers, estimates, counts and dimensions exact; float sums
rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.ir import spec as JS
from spark_druid_olap_tpu.ops import hll as JHLL
from spark_druid_olap_tpu.ops import kll as JKLL
from spark_druid_olap_tpu.ops import theta as JTH

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.ops import hll as THLL
from spark_druid_olap_tpu_torch.ops import kll as TKLL
from spark_druid_olap_tpu_torch.ops import theta as TTH
from spark_druid_olap_tpu_torch.parallel.executor import SKETCH_KINDS

from conftest import make_sales_df
from test_torch_sql import assert_answers_equal

N = 6000
N_KEYS = 9
EMPTY_KEY, MASKED_KEY = 3, 6


# -- the register ops ---------------------------------------------------------

def _keys_mask(seed):
    r = np.random.default_rng(seed)
    key = r.integers(0, N_KEYS, N).astype(np.int32)
    key[key == EMPTY_KEY] = EMPTY_KEY + 1      # a group no row reaches
    mask = r.random(N) < 0.85
    mask[key == MASKED_KEY] = False            # a group whose rows are masked
    return key, mask


def _values(kind, seed):
    r = np.random.default_rng(seed + 100)
    if kind == "int32_codes":
        return r.integers(0, 5000, N).astype(np.int32)
    if kind == "int32_full":
        return r.integers(-2**31, 2**31, N).astype(np.int32)
    if kind == "int64_negative":
        return r.integers(-2**62, 2**40, N).astype(np.int64)
    if kind == "f32_bits":
        return r.normal(0.0, 1e3, N).astype(np.float32).view(np.int32)
    if kind == "f32_nan":
        v = r.normal(0.0, 1e3, N).astype(np.float32)
        v[r.random(N) < 0.05] = np.nan
        return v
    return r.integers(-10**6, 10**6, N).astype(np.int64)


HASHED = ["int32_codes", "int32_full", "int64_negative", "f32_bits"]


def _both_args(key, mask, vals):
    return ((jnp.asarray(key), jnp.asarray(mask), jnp.asarray(vals)),
            (torch.from_numpy(key), torch.from_numpy(mask),
             torch.from_numpy(vals)))


@pytest.mark.parametrize("values", HASHED)
@pytest.mark.parametrize("log2m", [11, 6])
def test_hll_registers_bit_exact(values, log2m):
    key, mask = _keys_mask(1)
    j, t = _both_args(key, mask, _values(values, 1))
    want = np.asarray(JHLL.hll_registers(*j, N_KEYS, log2m))
    got = THLL.hll_registers(*t, N_KEYS, log2m).numpy()
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert not got[EMPTY_KEY].any() and not got[MASKED_KEY].any()
    assert np.array_equal(THLL.estimate(got), JHLL.estimate(want))


@pytest.mark.parametrize("values", HASHED)
def test_theta_registers_bit_exact(values):
    key, mask = _keys_mask(2)
    j, t = _both_args(key, mask, _values(values, 2))
    want = np.asarray(JTH.theta_registers(*j, N_KEYS)).astype(np.float32)
    got = TTH.theta_registers(*t, N_KEYS).numpy()
    assert got.dtype == np.float32 and got.shape == (N_KEYS, TTH.K_LANES)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.isinf(got[EMPTY_KEY]).all() and np.isinf(got[MASKED_KEY]).all()
    assert np.array_equal(TTH.estimate(got), JTH.estimate(want))


def test_theta_hash_bit_exact():
    v = _values("int64_negative", 3)
    for j in (0, 1, 31, 63):
        want = np.asarray(JTH._hash01(jnp.asarray(v), j))
        got = TTH._hash01(torch.from_numpy(v), j).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), j


@pytest.mark.parametrize("values,times", [("f32_nan", True),
                                          ("int64", True),
                                          ("f32_nan", False)])
@pytest.mark.parametrize("lanes", [256, 16])
def test_kll_registers_bit_exact(values, times, lanes):
    key, mask = _keys_mask(4)
    vals = _values(values, 4)
    tm = np.random.default_rng(5).integers(8000, 12000, N).astype(np.int32)
    j, t = _both_args(key, mask, vals)
    want = np.asarray(JKLL.kll_registers(
        *j, jnp.asarray(tm) if times else None, N_KEYS, lanes))
    got = TKLL.kll_registers(
        *t, torch.from_numpy(tm) if times else None, N_KEYS, lanes).numpy()
    assert got.dtype == want.dtype == np.int32
    assert got.shape == (N_KEYS, TKLL.width(lanes))
    assert np.array_equal(got, want)
    assert np.array_equal(got[EMPTY_KEY], TKLL.identity_registers(
        TKLL.width(lanes)))
    for q in (0.05, 0.5, 0.99):
        assert np.array_equal(TKLL.estimate(got, q), JKLL.estimate(want, q),
                              equal_nan=True)
    half = TKLL.kll_registers(t[0][: N // 2], t[1][: N // 2],
                              t[2][: N // 2],
                              torch.from_numpy(tm[: N // 2]) if times
                              else None, N_KEYS, lanes).numpy()
    rest = TKLL.kll_registers(t[0][N // 2:], t[1][N // 2:], t[2][N // 2:],
                              torch.from_numpy(tm[N // 2:]) if times
                              else None, N_KEYS, lanes).numpy()
    assert np.array_equal(TKLL.merge(half, rest), JKLL.merge(half, rest))
    assert np.array_equal(TKLL.merge(half, rest), got)


def test_kll_constants_and_rank_bound():
    from spark_druid_olap_tpu.utils.config import Config as JConfig
    from spark_druid_olap_tpu_torch.utils.config import Config as TConfig
    assert (TKLL.N_LEVELS, TKLL.K_LANES, TKLL.EMPTY) == \
        (JKLL.N_LEVELS, JKLL.K_LANES, JKLL.EMPTY)
    for lanes in (16, 256):
        assert TKLL.width(lanes) == JKLL.width(lanes)
        assert TKLL.lanes_of(TKLL.width(lanes)) == lanes
    assert TKLL.rank_bound(TConfig()) == JKLL.rank_bound(JConfig()) == 0.05


# -- the engine ---------------------------------------------------------------

def _frame():
    df = make_sales_df(n=20_000, seed=17)
    r = np.random.default_rng(17)
    # a nullable long: its validity joins the sketches' masks
    df["opt"] = pd.array(np.where(r.random(len(df)) < 0.3, None,
                                  r.integers(-2**40, 2**40, len(df))),
                         dtype="Int64")
    return df


@pytest.fixture(scope="module")
def pair():
    df = _frame()
    jctx, tctx = jsdot.Context(), tsdot.Context(device="cpu")
    for c in (jctx, tctx):
        c.ingest_dataframe("sales", df, time_column="ts", target_rows=4096)
    return jctx, tctx


def _mode(ctx):
    return ctx.history.entries()[-1].stats


def _run(pair, sql, **config):
    """Both packages' frames and statement stats under ``config``."""
    out = []
    for c in pair:
        old = {k: c.config.get(k) for k in config}
        for k, v in config.items():
            c.config.set(k, v)
        try:
            out += [c.sql(sql).to_pandas(), dict(_mode(c))]
        finally:
            for k, v in old.items():
                c.config.set(k, v)
    want, jst, got, tst = out
    assert tst["mode"] == jst["mode"], (tst["mode"], jst["mode"])
    assert_answers_equal(got, want, ordered="order by" in sql.lower())
    return got, tst, jst


SKETCHES = ("approx_count_distinct(product) as u_prod, "
            "approx_count_distinct_theta(qty) as t_qty, "
            "percentile_approx(price, 0.5) as p50")

STATEMENTS = {
    "grouped": f"select region, count(*) as n, {SKETCHES} from sales "
               "group by region",
    "global": f"select {SKETCHES}, sum(qty) as q from sales",
    "filtered": f"select flag, {SKETCHES} from sales where status = 'O' "
                "and qty > 10 group by flag",
    "double_and_long": "select flag, approx_count_distinct(price) as u_p, "
                       "approx_count_distinct_theta(price) as t_p, "
                       "approx_count_distinct(opt) as u_o, "
                       "approx_count_distinct_theta(opt) as t_o, "
                       "percentile_approx(opt, 0.9) as p90 from sales "
                       "group by flag",
    "two_keys": "select region, flag, approx_count_distinct(due) as u_due, "
                "percentile_approx(qty, 0.25) as p25 from sales "
                "group by region, flag",
    "monthly": "select month(ts) as m, approx_count_distinct(product) as u, "
               "percentile_approx(discount, 0.75) as p from sales "
               "group by month(ts)",
    "empty_filter": f"select {SKETCHES} from sales where qty > 1000",
}


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_sql_answers_equal_the_jax_engine(pair, name):
    got, tst, _ = _run(pair, STATEMENTS[name])
    assert tst["mode"] == "engine"
    assert len(got) > 0


def test_sql_compacted(pair):
    sql = (f"select flag, {SKETCHES}, count(*) as n from sales "
           "where status = 'O' and qty > 46 group by flag")
    _, tst, jst = _run(pair, sql,
                       **{"sdot.engine.scan.compact.min.rows": 0})
    assert tst["mode"] == "engine"
    assert tst.get("compact_m") == jst.get("compact_m")
    assert tst["compact_m"] > 0


def test_sql_device_topk_by_a_dense_metric_beside_a_sketch(pair):
    sql = ("select product, region, flag, count(*) as n, "
           "approx_count_distinct(qty) as u, "
           "percentile_approx(price, 0.5) as p from sales "
           "group by product, region, flag order by n desc limit 7")
    _, tst, jst = _run(pair, sql, **{"sdot.engine.topn.device.min.keys": 16})
    assert tst["mode"] == "engine"
    assert tst["topk_device"] == jst["topk_device"] > 0


def test_sql_device_having_beside_a_sketch(pair):
    sql = ("select product, region, count(*) as n, "
           "approx_count_distinct_theta(qty) as t, "
           "approx_count_distinct(price) as u from sales "
           "group by product, region having count(*) > 108")
    got, tst, jst = _run(pair, sql,
                         **{"sdot.engine.having.device.min.keys": 16})
    assert tst["mode"] == "engine"
    assert tst["having_device"] == jst["having_device"] > 0
    assert 0 < len(got) < 200


def test_sql_order_by_a_sketch_keeps_device_topk_off(pair):
    """A sketch's registers are no score: the ordered limit selects on the
    host, as in the JAX engine."""
    sql = ("select product, region, flag, approx_count_distinct(qty) as u, "
           "count(*) as n from sales group by product, region, flag "
           "order by u desc limit 5")
    _, tst, jst = _run(pair, sql, **{"sdot.engine.topn.device.min.keys": 16})
    assert tst["mode"] == "engine"
    assert tst.get("topk_device", 0) == jst.get("topk_device", 0) == 0


def test_sql_sketch_over_the_hashed_tier_goes_to_the_host(pair):
    sql = STATEMENTS["two_keys"]
    _, tst, jst = _run(pair, sql,
                       **{"sdot.engine.groupby.dense.max.keys": 4})
    assert tst["mode"].startswith("host")
    assert "sketch aggregation over hashed group-by" in tst["mode"]


def test_sql_medium_k_reroute_skips_a_sketch(pair):
    """Above the medium-K threshold with the sorted-run tier forced on, a
    statement with a sketch stays on the dense route in both engines."""
    _, tst, jst = _run(pair, STATEMENTS["two_keys"], **{
        "sdot.engine.groupby.sorted.min.keys": 2,
        "sdot.engine.groupby.hash.sortedrun": "on"})
    assert tst["mode"] == "engine" and not tst.get("hashed")
    assert not jst.get("hashed")


def _core_registers(jctx, tctx, spec_of):
    """The dense route's outputs of one GroupBy in both engines."""
    jfn, jarrays = jctx.engine.build_core(spec_of(JS))
    jout = jfn(jarrays)
    eng = tctx.engine
    q = spec_of(TS)
    ds = eng.store.get("sales")
    seg = ds.prune_segments(q.intervals, q.filter)
    dims, aggs, lo, hi, n_keys, names, routes = eng._plan_agg(
        ds, seg, list(q.dimensions), q.aggregations, q.granularity,
        q.filter, q.intervals)
    tout = eng._make_core(ds, dims, aggs, q.filter, q.intervals, lo, hi,
                          n_keys, routes)(eng._bind_arrays(ds, names, seg))
    return jout, tout, [p for p in aggs if p.kind in SKETCH_KINDS]


def test_engine_registers_bit_exact(pair):
    def spec_of(S):
        return S.GroupByQuerySpec(
            "sales", (S.DimensionSpec("region", "region"),
                      S.DimensionSpec("flag", "flag")),
            (S.AggregationSpec("cardinality", "u", field="product"),
             S.AggregationSpec("thetasketch", "t", field="price"),
             S.AggregationSpec("quantile", "p", field="qty", fraction=0.5),
             S.AggregationSpec("cardinality", "uo", field="opt",
                               filter=S.SelectorFilter("status", "F")),
             S.AggregationSpec("count", "n")),
            filter=S.BoundFilter("qty", lower=5, numeric=True))

    jout, tout, sketches = _core_registers(*pair, spec_of)
    assert {p.kind for p in sketches} == set(SKETCH_KINDS)
    for p in sketches:
        want = np.asarray(jout[p.spec.name])
        got = tout[p.spec.name].numpy()
        if p.kind == "theta":
            want = want.astype(np.float32)
        assert got.dtype == want.dtype, p.spec.name
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
            p.spec.name
