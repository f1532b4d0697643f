"""The port's window post-pass against the JAX package's.

The single-context cases of ``tests/test_window.py`` through both
packages: the same seeded frame (``wsales``) goes into a JAX ``Context``
and a port ``Context(device="cpu")``, each windowed statement runs on both,
and the answers must agree: ranks, row numbers, lag / lead, counts,
integer sums and min / max bit for bit, float sums and averages rtol 1e-6
(the segmented scans associate differently: JAX's ``associative_scan``
against the port's doubling scan, and a bounded sum subtracts prefix sums
in both). The history entry's ``mode`` (``engine+window``) and
``stats["window"]`` (``n_windows``, ``fns``) must agree too.

Below the statements, the device functions (``_rank_kernel``,
``_offset_kernel``, ``_agg_kernel``) run on the same codes in both
packages, with many tied order keys, NULL arguments and every frame
shape.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.window import exec as JW
from spark_druid_olap_tpu.window.plan import \
    WindowUnsupported as JWindowUnsupported

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.window import exec as TW
from spark_druid_olap_tpu_torch.window.plan import \
    WindowUnsupported as TWindowUnsupported

from test_torch_sql import assert_answers_equal
from test_window import WDF


@pytest.fixture(scope="module")
def pair():
    jctx, tctx = jsdot.Context(), tsdot.Context(device="cpu")
    for c in (jctx, tctx):
        c.ingest_dataframe("wsales", WDF, time_column="ts",
                           target_rows=4096)
    yield jctx, tctx
    jctx.close()


def _both(pair, sql, ordered=False):
    jctx, tctx = pair
    want = jctx.sql(sql).to_pandas()
    got = tctx.sql(sql).to_pandas()
    assert_answers_equal(got, want, ordered)
    js, ts = (c.history.entries()[-1].stats for c in pair)
    assert ts["mode"] == js["mode"] == "engine+window"
    for k in ("n_windows", "fns"):
        assert ts["window"][k] == js["window"][k]
    return got


CASES = {
    "rank_dense_rank_over_groupby": (
        "select region, product, sum(qty) as units, "
        "rank() over (partition by region order by sum(qty) desc) as r, "
        "dense_rank() over (partition by region order by sum(qty) desc) "
        "as dr from wsales group by region, product", False),
    "moving_sum_frame_over_scan": (
        "select id, region, qty, sum(qty) over (partition by region "
        "order by id rows between 3 preceding and current row) as mv "
        "from wsales where qty > 25", False),
    "lag_lead_with_default": (
        "select id, region, price, "
        "lag(price, 1) over (partition by region order by id) as prev, "
        "lead(price, 2, -1.0) over (partition by region order by id) "
        "as nxt from wsales where id < 3000", False),
    "cumulative_avg_and_row_number": (
        "select id, region, "
        "avg(price) over (partition by region order by id) as cavg, "
        "row_number() over (partition by region order by id) as rn "
        "from wsales where id < 3000", False),
    "bounded_min_max_and_partition_count": (
        "select id, region, "
        "min(price) over (partition by region order by id "
        "rows between 2 preceding and current row) as mn, "
        "max(price) over (partition by region order by id "
        "rows between 2 preceding and current row) as mx, "
        "count(*) over (partition by region) as n "
        "from wsales where id < 3000", False),
    "null_arguments_skip_in_frames": (
        "select id, region, "
        "avg(mprice) over (partition by region order by id "
        "rows between 2 preceding and current row) as av, "
        "lag(mprice, 1) over (partition by region order by id) as prev "
        "from wsales where id < 3000", False),
    "deferred_order_by_and_limit": (
        "select region, product, sum(qty) as units, "
        "rank() over (partition by region order by sum(qty) desc) as r "
        "from wsales group by region, product "
        "order by r, region, product limit 10", True),
    "stats_contract": (
        "select region, row_number() over (order by sum(qty)) as rn "
        "from wsales group by region", False),
    # tied order keys: row_number follows lexsort's row order in both
    "row_number_over_tied_keys": (
        "select id, flag, qty, row_number() over (partition by flag "
        "order by qty) as rn, rank() over (order by qty desc) as r "
        "from wsales where id < 4000", False),
    "following_frames_and_string_extremes": (
        "select id, region, "
        "sum(price) over (partition by region order by id rows between "
        "current row and 3 following) as fwd, "
        "max(product) over (partition by region order by id rows between "
        "1 preceding and 2 following) as mxp, "
        "min(qty) over (partition by flag, region order by id desc) as cm "
        "from wsales where id < 2500", False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_answers_equal_the_jax_package(pair, name):
    sql, ordered = CASES[name]
    got = _both(pair, sql, ordered)
    assert len(got) > 0


def test_stats_window_ms(pair):
    _both(pair, CASES["stats_contract"][0])
    st = pair[1].history.entries()[-1].stats
    assert st["window"]["n_windows"] == 1
    assert st["window"]["fns"] == ["row_number"]
    assert st["window"]["window_ms"] >= 0


@pytest.mark.parametrize("sql,match", [
    ("select distinct region, rank() over (order by sum(qty)) from wsales "
     "group by region", "DISTINCT"),
    ("select id from wsales where row_number() over (order by id) > 5",
     "WHERE"),
    ("select id, sum(qty) over (order by id rows between 600 preceding and "
     "600 following) as s from wsales where id < 100", "max.frame"),
])
def test_unsupported_shapes_raise_in_both(pair, sql, match):
    with pytest.raises(JWindowUnsupported, match=match):
        pair[0].sql(sql)
    with pytest.raises(TWindowUnsupported, match=match):
        pair[1].sql(sql)


def test_disabled_window_tier_raises_in_both(pair):
    sql = "select id, row_number() over (order by id) as rn from wsales"
    for c in pair:
        c.config.set("sdot.window.enabled", False)
    try:
        with pytest.raises(JWindowUnsupported, match="disabled"):
            pair[0].sql(sql)
        with pytest.raises(TWindowUnsupported, match="disabled"):
            pair[1].sql(sql)
    finally:
        for c in pair:
            c.config.set("sdot.window.enabled", True)


# -- the device functions on the same codes -----------------------------------

def _codes(seed, n=3000):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, 7, n).astype(np.int64)
    # few distinct order values: many ties inside every partition
    k0 = rng.integers(0, 5, n).astype(np.int64)
    k1 = -rng.integers(0, 3, n).astype(np.int64)
    fv = np.round(rng.normal(0, 100, n), 3)
    iv = rng.integers(-2**40, 2**40, n).astype(np.int64)
    vm = rng.random(n) < 0.8
    return pid, (k0, k1), fv, iv, vm


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("fn", ["row_number", "rank", "dense_rank"])
@pytest.mark.parametrize("nk", [1, 2])
def test_rank_kernel_bit_equal(fn, nk):
    pid, keys, *_ = _codes(1)
    keys = keys[:nk]
    want = JW._rank_kernel(_j(pid), tuple(_j(k) for k in keys), fn=fn,
                           n_keys=nk)
    got = TW._rank_kernel(_t(pid), tuple(_t(k) for k in keys), fn)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 2, -1, -3, 0, 5000])
def test_offset_kernel_bit_equal(k):
    pid, keys, fv, _, vm = _codes(2)
    want = JW._offset_kernel(_j(pid), tuple(map(_j, keys)), _j(fv), _j(vm),
                             k=k)
    got = TW._offset_kernel(_t(pid), tuple(map(_t, keys)), _t(fv), _t(vm),
                            k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


FRAMES = [(None, None), (None, 0), (None, 3), (2, None), (0, None),
          (3, 0), (2, 2), (0, 4)]


@pytest.mark.parametrize("frame", FRAMES, ids=str)
@pytest.mark.parametrize("fn", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("kind", ["float", "int"])
def test_agg_kernel_equal_the_jax_package(frame, fn, kind):
    """Counts, min / max and integer sums bit for bit; float sums rtol
    1e-6 (the scans associate differently, and a bounded sum subtracts
    prefix sums; ``count``'s accumulator is such a sum too)."""
    pid, keys, fv, iv, vm = _codes(3)
    vals = fv if kind == "float" else iv
    wa, wc = JW._agg_kernel(_j(pid), tuple(map(_j, keys)), _j(vals), _j(vm),
                            fn=fn, frame=frame)
    ga, gc = TW._agg_kernel(_t(pid), tuple(map(_t, keys)), _t(vals), _t(vm),
                            fn, frame)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    if kind == "float" and fn in ("sum", "count"):
        np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-6,
                                   atol=1e-9)
    else:
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))


def test_segscan_never_mixes_partitions():
    """A huge value in one partition leaves the next partition's float sum
    exact: the doubling scan resets at every boundary."""
    pid = _t(np.repeat(np.arange(4), 1000))
    vals = np.full(4000, 0.1)
    vals[:1000] = 1e18
    b = torch.cat([torch.ones(1, dtype=torch.bool), pid[1:] != pid[:-1]])
    out = TW._segscan(torch.add, _t(vals), b).numpy()
    np.testing.assert_allclose(out[1000:2000], np.cumsum(vals[1000:2000]),
                               rtol=1e-12)
    assert out[999] == pytest.approx(1e21)
