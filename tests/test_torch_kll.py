"""JAX ``tests/test_kll.py`` bound to the port: the KLL quantile sketch's
merge algebra, rank-error bound, serde and the rollup-derivability
rejection.

The port's register op (``ops/kll.py``) takes torch tensors on the CPU;
the algebra, the rank bound and the serde are the JAX test's closed
forms (registers exact, estimates within the rank bound); the registry
entry and each statement's rollup decision are held equal to the JAX
package's.

Original notes: KLL quantile sketch: merge algebra, rank-error bound, serde, and the
rollup-derivability rejection.

The sketch's whole distributed contract rests on the register merge
being a pure elementwise algebra (lex-min on (tiebreak, value) + count
sum): associative, commutative, identity-preserving, and — because the
sampling is content-seeded, never order-seeded — independent of how rows
are sharded or in what order shards fold. These tests check each leg of
that contract directly on registers, then the estimator's rank-error
bound against numpy's exact order statistics, and finally that the
rollup rewriter refuses to serve percentile_approx from a rollup (the
registry declares ``reagg=None``: stored sum/count partials cannot
reproduce a quantile).
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pytest
import torch

import spark_druid_olap_tpu_torch as sdot
from spark_druid_olap_tpu_torch.ops import kll as KLL

from conftest import make_sales_df
from torch_twin import mirrored

LANES = 32          # small registers keep the algebra tests fast


def _regs(values, n_keys=1, key=None, lanes=LANES):
    v = np.asarray(values, dtype=np.float64)
    k = np.zeros(len(v), np.int32) if key is None \
        else np.asarray(key, np.int32)
    out = KLL.kll_registers(torch.from_numpy(k),
                            torch.ones(len(v), dtype=torch.bool),
                            torch.from_numpy(v), None, n_keys, lanes=lanes)
    return out.numpy()


@pytest.fixture(scope="module")
def shards(rng):
    vals = rng.normal(50.0, 12.0, 9000)
    return [vals[:2000], vals[2000:5500], vals[5500:]]


def test_merge_is_associative_and_commutative(shards):
    a, b, c = (_regs(s) for s in shards)
    ab_c = KLL.merge(KLL.merge(a, b), c)
    a_bc = KLL.merge(a, KLL.merge(b, c))
    np.testing.assert_array_equal(ab_c, a_bc)
    np.testing.assert_array_equal(KLL.merge(a, b), KLL.merge(b, a))
    np.testing.assert_array_equal(KLL.merge(b, c), KLL.merge(c, b))


def test_merge_identity_and_idempotent_fold(shards):
    a = _regs(shards[0])
    ident = KLL.identity_registers(KLL.width(LANES))[None, :]
    np.testing.assert_array_equal(KLL.merge(a, ident), a)
    np.testing.assert_array_equal(KLL.merge(ident, a), a)
    # folding the same registers twice must not double the sample set's
    # lanes (min is idempotent); only counts add
    aa = KLL.merge(a, a)
    lk = KLL.N_LEVELS * LANES
    np.testing.assert_array_equal(aa[:, :2 * lk], a[:, :2 * lk])
    np.testing.assert_array_equal(aa[:, 2 * lk:], 2 * a[:, 2 * lk:])


def test_sharding_and_scan_order_cannot_change_registers(shards, rng):
    """merge(shard regs) == regs(concatenated) == regs(shuffled):
    the broker fold, the single engine, and any scan order all land on
    byte-identical registers — the distributed-estimate guarantee."""
    full = np.concatenate(shards)
    merged = _regs(shards[0])
    for s in shards[1:]:
        merged = KLL.merge(merged, _regs(s))
    np.testing.assert_array_equal(merged, _regs(full))
    np.testing.assert_array_equal(_regs(rng.permutation(full)),
                                  _regs(full))
    # a different 2-way split folds to the same registers too
    np.testing.assert_array_equal(
        KLL.merge(_regs(full[:1234]), _regs(full[1234:])), _regs(full))


def test_grouped_registers_match_per_group_registers(rng):
    vals = rng.uniform(0.0, 100.0, 4000)
    key = rng.integers(0, 3, 4000).astype(np.int32)
    grouped = _regs(vals, n_keys=3, key=key)
    for g in range(3):
        np.testing.assert_array_equal(grouped[g], _regs(vals[key == g])[0])


@pytest.mark.parametrize("dist", ["uniform", "normal", "lognormal"])
def test_estimate_within_rank_error_bound(rng, dist):
    n = 50_000
    vals = {"uniform": rng.uniform(0.0, 1000.0, n),
            "normal": rng.normal(100.0, 25.0, n),
            "lognormal": rng.lognormal(3.0, 1.0, n)}[dist]
    regs = _regs(vals, lanes=KLL.K_LANES)      # production lane count
    eps = 0.05                                  # default rank bound
    srt = np.sort(vals.astype(np.float32).astype(np.float64))
    for q in (0.1, 0.5, 0.9, 0.95, 0.99):
        est = float(KLL.estimate(regs, q)[0])
        lo = srt[max(int(np.floor((q - eps) * n)), 0)]
        hi = srt[min(int(np.ceil((q + eps) * n)), n - 1)]
        assert lo <= est <= hi, \
            f"{dist} q{q}: {est} outside [{lo}, {hi}]"


def test_estimate_returns_sampled_value_and_nan_on_empty():
    vals = np.array([3.0, 1.0, 2.0, 9.0, 5.5])
    regs = _regs(vals)
    est = float(KLL.estimate(regs, 0.5)[0])
    assert est in set(vals.astype(np.float32).astype(np.float64))
    ident = KLL.identity_registers(KLL.width(LANES))
    assert np.isnan(KLL.estimate(ident, 0.5)[0])


def test_serde_round_trip(shards):
    regs = _regs(np.concatenate(shards))
    w = KLL.width(LANES)
    back = KLL.from_bytes(KLL.to_bytes(regs), w)
    np.testing.assert_array_equal(back, regs)
    assert KLL.lanes_of(w) == LANES


def test_registry_declares_unreaggable_quantile():
    from spark_druid_olap_tpu_torch.ops.agg_registry import AGG_CLOSURE
    from spark_druid_olap_tpu.ops.agg_registry import AGG_CLOSURE as JAGG
    ent = AGG_CLOSURE["quantile"]
    assert ent == JAGG["quantile"]
    assert ent["reagg"] is None        # rollups cannot derive a quantile
    assert ent["sketch"] == "kll" and ent["merge"] == "minsum"


def test_rollup_rewrite_rejects_percentile(tmp_path):
    """A rollup that serves plain aggregates over the same dimensions
    must NOT serve percentile_approx (reagg=None): the query stays on
    the base scan and still answers within the rank bound."""
    ctx = mirrored(sdot.Context(device="cpu"))

    def rollup_as_jax(sql):
        ctx.jax.sql(sql)
        got = ctx.history.entries()[-1].stats.get("rollup")
        assert got == ctx.jax.history.entries()[-1].stats.get("rollup")
        return got
    try:
        ctx.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                             target_rows=4096)
        ddl = ("create rollup sales_cube on sales dimensions (region) "
               "aggregations (sum(price), count(*))")
        ctx.sql(ddl)
        ctx.jax.sql(ddl)
        rev = "select region, sum(price) as rev from sales group by region"
        served = ctx.sql(rev)
        # the rollup IS otherwise eligible
        assert rollup_as_jax(rev) == "rollup:sales_cube"
        assert len(served) == 4
        pct = ("select region, percentile_approx(price, 0.5) as p "
               "from sales group by region")
        got = ctx.sql(pct).to_pandas()
        assert rollup_as_jax(pct) == "base"
        df = make_sales_df()
        for _, row in got.iterrows():
            vals = np.sort(df.loc[df["region"] == row["region"], "price"]
                           .to_numpy())
            lo = vals[int(np.floor(0.45 * len(vals)))]
            hi = vals[int(np.ceil(0.55 * len(vals)))]
            assert lo <= row["p"] <= hi
    finally:
        ctx.close()
