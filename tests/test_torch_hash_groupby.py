"""The port's wide-key aggregation path against the JAX package: the hashed
tier (slot sort, then the sorted-run or the scatter aggregation), table
compaction, the overflow retry, device top-k on the hashed and the dense
tier, and the medium-K reroute onto the sorted-run tier.

Ops: the same numpy-seeded inputs go through the JAX functions
(``ops/hash_groupby.py``, ``ops/sorted_groupby.py``, with x64 on the CPU)
and their port counterparts on CPU tensors. Engine: one seeded frame is
ingested into a JAX ``Context`` and a port ``Context(device="cpu")`` under
the same config, and the same QuerySpec (built from each package's ``ir``)
runs through both.

Tolerance: key tables, slot ids, dimensions, integers, counts and min/max
exact; float sums rtol 1e-9 where both sides sum float64 values of the
same rows (ops), rtol 1e-6 through the engines (float metrics are stored
f32 and the tiers sum them in different orders).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.ir import spec as JS
from spark_druid_olap_tpu.ops import groupby as JG
from spark_druid_olap_tpu.ops import hash_groupby as JH
from spark_druid_olap_tpu.ops import sorted_groupby as JSG
from spark_druid_olap_tpu.parallel.executor import \
    EngineFallback as JEngineFallback

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.ops import groupby as TG
from spark_druid_olap_tpu_torch.ops import hash_groupby as TH
from spark_druid_olap_tpu_torch.ops import sorted_groupby as TSG
from spark_druid_olap_tpu_torch.parallel import executor as TX

OPS_RTOL = 1e-9
ENGINE_RTOL = 1e-6


# -- ops: keys ----------------------------------------------------------------

CARDS = [[5], [2**20, 3000], [2**28, 2**28, 4, 4], [3_000_001, 1001, 5],
         [2**31], [2**30, 2**30, 2**30]]


@pytest.mark.parametrize("cards", CARDS, ids=str)
def test_split_parts_matches_jax(cards):
    try:
        want = JH.split_parts(cards)
    except JH.KeySpaceTooWide:
        with pytest.raises(TH.KeySpaceTooWide):
            TH.split_parts(cards)
        return
    assert TH.split_parts(cards) == want


def test_fuse_unfuse_and_pack_match_jax():
    rng = np.random.default_rng(3)
    cards = [3_000_001, 1001, 5]
    codes = [rng.integers(0, c, 5000).astype(np.int32) for c in cards]
    parts = TH.split_parts(cards)
    fused = []
    for idxs in parts:
        want = np.asarray(JH.fuse_part([jnp.asarray(c) for c in codes],
                                       cards, idxs))
        got = TH.fuse_part([torch.from_numpy(c) for c in codes], cards,
                           idxs).numpy()
        np.testing.assert_array_equal(got, want)
        for g, w in zip(TH.unfuse_part(got, cards, idxs),
                        JH.unfuse_part(want, cards, idxs)):
            np.testing.assert_array_equal(g, w)
        fused.append(got)
    packed = TH.pack_key(*fused)
    np.testing.assert_array_equal(packed, JH.pack_key(*fused))
    for g, w in zip(TH.unpack_key(packed), JH.unpack_key(packed)):
        np.testing.assert_array_equal(g, w)
    for est in (0, 1, 5000, 1 << 14, (1 << 14) + 1, 9_000_000):
        assert TH.initial_slots(est) == JH.initial_slots(est)


def _keys(case, rng, n=20_000):
    khi = rng.integers(0, 300, n).astype(np.int32)
    klo = rng.integers(0, 40, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    if case == "all_invalid":
        valid[:] = False
    T = 1 << 9 if case == "overflow" else 1 << 14
    return khi, klo, valid, T


@pytest.mark.parametrize("case", ["random", "all_invalid", "overflow"])
def test_build_slots_bit_exact(case):
    khi, klo, valid, T = _keys(case, np.random.default_rng(5))
    want = JH.build_slots(jnp.asarray(khi), jnp.asarray(klo),
                          jnp.asarray(valid), T)
    got = TH.build_slots(torch.from_numpy(khi), torch.from_numpy(klo),
                         torch.from_numpy(valid), T)
    for g, w, what in zip(got, want, ("slot", "tk_hi", "tk_lo", "unres")):
        w = np.asarray(w)
        g = g.numpy()
        if what == "slot":
            # slots of unresolved rows are untrustworthy by contract
            keep = np.asarray(want[0]) < T
            g, w = g[keep], w[keep]
        assert g.dtype == w.dtype or what == "unres", what
        np.testing.assert_array_equal(g, w, err_msg=what)
    if case == "overflow":
        assert int(got[3]) > 0
    if case == "all_invalid":
        assert (got[1].numpy() == TH.EMPTY).all() and int(got[3]) == 0


@pytest.mark.parametrize("kg", [64, 4096])
def test_compaction_prefix_is_jax_top_k_of_occupancy(kg):
    """The port copies the occupied slots as the table's prefix; the JAX
    package finds them with ``lax.top_k`` over an occupancy flag."""
    khi, klo, valid, T = _keys("random", np.random.default_rng(6))
    _, tk_hi, _, _ = TH.build_slots(torch.from_numpy(khi),
                                    torch.from_numpy(klo),
                                    torch.from_numpy(valid), T)
    occ = (tk_hi.numpy() != TH.EMPTY)
    assert occ.sum() > 64 and not occ[occ.sum():].any()
    _, idx = jax.lax.top_k(jnp.asarray(occ.astype(np.float32)), kg)
    np.testing.assert_array_equal(np.asarray(idx), np.arange(kg))


# -- ops: the sorted-run tier ------------------------------------------------

KINDS = [("count", True), ("sum", True), ("sum", False), ("min", True),
         ("min", False), ("max", True), ("max", False)]


def _agg_inputs(rng, n, kind, is_int):
    if is_int:
        v = rng.integers(-2**40, 2**40, n).astype(np.int64)
    else:
        v = rng.normal(0, 1e3, n)
        v[rng.random(n) < 0.002] = np.nan
    m = rng.random(n) < 0.7
    return (None if kind == "count" else v), m


@pytest.mark.parametrize("kind,is_int", KINDS)
def test_sorted_hash_groupby_matches_jax_and_scatter(kind, is_int):
    rng = np.random.default_rng(7)
    khi, klo, valid, T = _keys("random", rng)
    n = len(khi)
    vals, mask = _agg_inputs(rng, n, kind, is_int)
    name = "a"
    tin = [TG.AggInput(name, kind, None if vals is None
                       else torch.from_numpy(vals), torch.from_numpy(mask),
                       is_int=is_int)]
    jin = [JG.AggInput(name, kind, None if vals is None
                       else jnp.asarray(vals), jnp.asarray(mask),
                       is_int=is_int)]
    troutes = TSG.plan_sorted_routes(tin)
    jroutes = JSG.plan_sorted_routes(jin)
    assert troutes[name].tag == jroutes[name].tag
    tk = (torch.from_numpy(khi), torch.from_numpy(klo),
          torch.from_numpy(valid))
    got = TSG.sorted_hash_groupby(*tk, T, tin, troutes)
    want = JSG.sorted_hash_groupby(jnp.asarray(khi), jnp.asarray(klo),
                                   jnp.asarray(valid), T, jin, jroutes)
    slot, tk_hi, tk_lo, unres = TH.build_slots(*tk, T)
    scat = TG.dense_groupby(slot, tk[2], T, tin, troutes, 0)
    for k in ("__tkhi__", "__tklo__", "__unres__"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(got["__tkhi__"].numpy(), tk_hi.numpy())
    np.testing.assert_array_equal(got["__tklo__"].numpy(), tk_lo.numpy())
    g = got[name].numpy()
    for other, what in ((np.asarray(want[name]), "jax"),
                        (scat[name].numpy(), "scatter")):
        if is_int or kind == "count":
            np.testing.assert_array_equal(g, other, err_msg=what)
        else:
            np.testing.assert_allclose(g, other, rtol=OPS_RTOL,
                                       equal_nan=True, err_msg=what)
    if not is_int:
        assert np.isnan(g).any()              # NaN groups propagate


def test_float_sums_small_groups_after_large_prefix():
    """Small groups after a huge first group keep their own precision: a
    float64 prefix difference would lose them entirely (4e18 has an ulp
    of 512), a segmented reduction does not."""
    n_big, n_small = 4000, 1000
    rng = np.random.default_rng(2)
    vals = np.concatenate([np.full(n_big, 1.0e15),
                           rng.normal(1e-3, 1e-4, n_small)])
    keys = np.concatenate([np.zeros(n_big, np.int32),
                           np.arange(1, n_small + 1, dtype=np.int32)])
    valid = np.ones(len(keys), bool)
    T = 1 << 11
    tin = [TG.AggInput("v", "sum", torch.from_numpy(vals))]
    got = TSG.sorted_hash_groupby(
        torch.from_numpy(keys), torch.zeros(len(keys), dtype=torch.int32),
        torch.from_numpy(valid), T, tin, TSG.plan_sorted_routes(tin))
    jin = [JG.AggInput("v", "sum", jnp.asarray(vals))]
    want = JSG.sorted_hash_groupby(
        jnp.asarray(keys), jnp.zeros(len(keys), jnp.int32),
        jnp.asarray(valid), T, jin, JSG.plan_sorted_routes(jin))
    occ = got["__tkhi__"].numpy() != TH.EMPTY
    exact = np.concatenate([[vals[:n_big].sum()], vals[n_big:]])
    np.testing.assert_allclose(got["v"].numpy()[occ], exact, rtol=1e-5)
    np.testing.assert_allclose(got["v"].numpy()[occ],
                               np.asarray(want["v"])[occ], rtol=1e-5)


@pytest.mark.parametrize("kind,is_int", KINDS)
def test_scatter_tier_drops_rows_of_no_group_once(kind, is_int):
    """Most rows filtered out (their key is ``n_keys``) or keyed outside
    the table: the scatter tier drops them before it scatters and gives
    the JAX package's ``_scatter_groupby`` answer."""
    rng = np.random.default_rng(5)
    n, K = 20_000, 700
    key = rng.integers(-50, K + 50, n).astype(np.int32)
    mask = rng.random(n) < 0.1
    vals, amask = _agg_inputs(rng, n, kind, is_int)
    tin = [TG.AggInput("a", kind, None if vals is None
                       else torch.from_numpy(vals), torch.from_numpy(amask),
                       is_int=is_int)]
    jin = [JG.AggInput("a", kind, None if vals is None
                       else jnp.asarray(vals), jnp.asarray(amask),
                       is_int=is_int)]
    got = TG.dense_groupby(torch.from_numpy(key), torch.from_numpy(mask), K,
                           tin, TG.plan_routes(tin), 0)["a"].numpy()
    jkey = np.where(mask & (key >= 0) & (key < K), key, K)
    want = np.asarray(JG._scatter_groupby(
        jnp.asarray(jkey), jnp.asarray(mask), K, jin,
        JSG.plan_sorted_routes(jin))["a"])
    assert got.shape == (K,)
    if is_int or kind == "count":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=OPS_RTOL, equal_nan=True)


@pytest.mark.parametrize("case", ["some", "none"])
def test_live_rows_keeps_the_valid_rows_in_order(case):
    rng = np.random.default_rng(3)
    valid = rng.random((3, 50)) < (0.3 if case == "some" else 0.0)
    vals = rng.normal(size=(3, 50))
    v, (a, b, c) = TH.live_rows(torch.from_numpy(valid),
                                [torch.from_numpy(vals), None,
                                 torch.tensor(2.5)])
    assert b is None
    if case == "some":
        assert v.all() and len(v) == valid.sum()
        np.testing.assert_array_equal(a.numpy(), vals[valid])
        np.testing.assert_array_equal(c.numpy(), np.full(valid.sum(), 2.5))
    else:
        assert v.tolist() == [False] and len(a) == 1 and len(c) == 1


def test_unit_cost_curve_is_read_between_its_points():
    from spark_druid_olap_tpu_torch.parallel import cost
    curve = cost._CUDA_SCATTER_CURVE
    for (x, y) in curve:
        assert cost._on_curve(curve, x) == pytest.approx(y, rel=1e-12)
    for (x0, y0), (x1, y1) in zip(curve, curve[1:]):
        mid = cost._on_curve(curve, (x0 * x1) ** 0.5)
        assert min(y0, y1) <= mid <= max(y0, y1)
    assert cost._on_curve(curve, 0.0) == curve[0][1]
    assert cost._on_curve(curve, 1e12) == curve[-1][1]


# (segment-pruned rows, key space, auto's pick on the card): Q1 forced
# hashed, q7, q3 over the flat star and basic_agg at SF1
GATE_CASES = [(6_001_465, 6, True), (3_001_344, 4_375, False),
              (4_001_792, 3_600_000_000, False),
              (6_001_465, 9_000_000, False), (0, 5_000, False)]


@pytest.mark.parametrize("rows,key_space,card_sorted", GATE_CASES)
def test_auto_gate_reads_rows_per_group(rows, key_space, card_sorted):
    """On a cuda device ``auto`` reads the scatter's cost at the query's
    rows per group; on the CPU it takes the JAX package's choice there;
    an explicitly set unit cost wins on both."""
    ctx = tsdot.Context(device="cpu")
    eng = ctx.engine
    jeng = jsdot.Context().engine
    assert eng._sorted_run_wanted(rows, key_space) \
        == jeng._sorted_run_wanted() is False
    eng.device = torch.device("cuda")
    try:
        assert eng._sorted_run_wanted(rows, key_space) is card_sorted
        ctx.config.set("sdot.querycostmodel.scatter.seconds.per.update", 1.0)
        assert eng._sorted_run_wanted(rows, key_space) is True
        ctx.config.set("sdot.engine.groupby.hash.sortedrun", "off")
        assert eng._sorted_run_wanted(rows, key_space) is False
    finally:
        eng.device = torch.device("cpu")


def test_to_host_keeps_each_width_in_one_buffer():
    rng = np.random.default_rng(9)
    out = {"i32": torch.from_numpy(rng.integers(-9, 9, 7).astype(np.int32)),
           "i64": torch.from_numpy(rng.integers(-2**62, 2**62, 5)),
           "b": torch.from_numpy(rng.random(3) < 0.5),
           "f64": torch.from_numpy(rng.normal(size=9)),
           "f32": torch.from_numpy(rng.normal(size=5).astype(np.float32)),
           "one": torch.tensor([4], dtype=torch.int64),
           "strided": torch.arange(4, dtype=torch.float64)[1::2][:1],
           "empty": torch.zeros(0, dtype=torch.int32)}
    assert out["strided"].stride() == (2,)
    host = TX._to_host(out)
    assert list(host) == list(out)
    for k, t in out.items():
        assert host[k].dtype == t.numpy().dtype, k
        np.testing.assert_array_equal(host[k], t.numpy(), err_msg=k)


# -- the engines ------------------------------------------------------------

N = 40_000


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 3_000_000, 9_000)           # sparse, wide range
    return pd.DataFrame({
        "ts": (np.datetime64("2018-01-01")
               + rng.integers(0, 365, N).astype("timedelta64[D]"))
        .astype("datetime64[ns]"),
        "cust": rng.choice(ids, N),
        "product": rng.choice([f"p{i:04d}" for i in range(1000)], N),
        "region": rng.choice(["east", "west", "north", "south"], N),
        "k3": rng.integers(0, 3000, N).astype(str),
        "qty": rng.integers(1, 100, N).astype(np.int64),
        "big": rng.integers(2**25, 2**40, N),
        "price": np.round(rng.uniform(1, 500, N), 2),
        "nul": np.where(rng.random(N) < 0.3, np.nan,
                        np.round(rng.normal(5, 2, N), 3)),
    })


def _pair(frame, conf):
    jctx = jsdot.Context(config=dict(conf))
    tctx = tsdot.Context(config=dict(conf), device="cpu")
    for c in (jctx, tctx):
        c.ingest_dataframe("fact", frame, time_column="ts",
                           target_rows=4096)
    return jctx, tctx


def _spec(S, dims, limit=None, filter=None):
    return S.GroupByQuerySpec(
        "fact", tuple(S.DimensionSpec(d, d) for d in dims),
        (S.AggregationSpec("longsum", "s_qty", field="qty"),
         S.AggregationSpec("longsum", "s_big", field="big"),
         S.AggregationSpec("longmin", "mn_big", field="big"),
         S.AggregationSpec("longmax", "mx_big", field="big"),
         S.AggregationSpec("doublesum", "s_price", field="price"),
         S.AggregationSpec("doublemin", "mn_nul", field="nul"),
         S.AggregationSpec("doublemax", "mx_nul", field="nul"),
         S.AggregationSpec("count", "n")),
        filter=filter, limit=limit)


STATS = ("hashed", "hash_slots", "hash_compact_k", "topk_device", "groups")


def _frames_equal(got, want, ordered):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    if not ordered:
        keys = [c for c in want.columns if want[c].dtype.kind in "OiuM"
                and c in ("cust", "product", "region", "k3")]
        got = got.sort_values(keys).reset_index(drop=True)
        want = want.sort_values(keys).reset_index(drop=True)
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        assert g.dtype.kind == w.dtype.kind, (c, g.dtype, w.dtype)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=ENGINE_RTOL,
                                       equal_nan=True, err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


def _both(frame, conf, make, ordered=False):
    """Run ``make(S)`` through both engines under ``conf``: the port's
    frame and stats, after checking them against the JAX engine's."""
    jctx, tctx = _pair(frame, conf)
    want = jctx.execute(make(JS)).to_pandas()
    got = tctx.execute(make(TS)).to_pandas()
    jst, tst = jctx.engine.last_stats, tctx.engine.last_stats
    for k in STATS:
        assert jst.get(k) == tst.get(k), (k, jst, tst)
    _frames_equal(got, want, ordered)
    return got, tst


HASHED = {"sdot.engine.groupby.dense.max.keys": 4096}
TIERS = ["on", "off"]


@pytest.mark.parametrize("sortedrun", TIERS)
def test_hashed_tier_matches_jax(frame, sortedrun):
    got, st = _both(frame, {**HASHED, "sdot.engine.groupby.hash.sortedrun":
                            sortedrun}, lambda S: _spec(S, ["cust"]))
    assert st["hashed"] and st["route"] == ("sorted" if sortedrun == "on"
                                            else "scatter")
    assert st["groups"] == frame.cust.nunique()


@pytest.mark.parametrize("sortedrun", TIERS)
def test_hashed_tier_with_no_matching_row_matches_jax(frame, sortedrun):
    got, st = _both(frame, {**HASHED, "sdot.engine.groupby.hash.sortedrun":
                            sortedrun}, lambda S: _spec(
        S, ["cust"], filter=S.SelectorFilter("region", "nowhere")))
    assert st["hashed"] and len(got) == 0


@pytest.mark.parametrize("sortedrun", TIERS)
def test_two_part_keys_match_jax(frame, sortedrun):
    dims = ["cust", "product", "region"]
    got, st = _both(frame, {**HASHED, "sdot.engine.groupby.hash.sortedrun":
                            sortedrun}, lambda S: _spec(S, dims))
    assert len(TH.split_parts([frame.cust.max() - frame.cust.min() + 1,
                               1000, 4])) == 2
    assert st["hashed"] and len(got) == len(frame.groupby(dims))


def test_answers_do_not_depend_on_the_tier(frame):
    """The sorted-run tier, the hashed scatter tier and the dense tier
    give one answer."""
    spec = _spec(TS, ["k3", "region"])
    frames = []
    for conf in ({**HASHED, "sdot.engine.groupby.hash.sortedrun": "on"},
                 {**HASHED, "sdot.engine.groupby.hash.sortedrun": "off"},
                 {"sdot.engine.groupby.hash.sortedrun": "off"}):
        ctx = tsdot.Context(config=conf, device="cpu")
        ctx.ingest_dataframe("fact", frame, time_column="ts",
                             target_rows=4096)
        frames.append(ctx.execute(spec).to_pandas())
        assert bool(ctx.engine.last_stats.get("hashed")) == \
            ("dense.max.keys" in str(conf))
    for f in frames[1:]:
        _frames_equal(f, frames[0], ordered=False)


@pytest.mark.parametrize("sortedrun", TIERS)
def test_overflow_retries_at_four_times_the_slots(frame, sortedrun):
    got, st = _both(frame, {**HASHED, "sdot.engine.groupby.hash.slots": 4096,
                            "sdot.engine.groupby.hash.sortedrun": sortedrun},
                    lambda S: _spec(S, ["cust"]))
    assert st["hash_slots"] == 4 * 4096


@pytest.mark.parametrize("sortedrun", TIERS)
def test_cap_exceeded_falls_back_in_both(frame, sortedrun):
    conf = {**HASHED, "sdot.engine.groupby.hash.slots": 4096,
            "sdot.engine.groupby.hash.max.slots": 4096,
            "sdot.engine.groupby.hash.sortedrun": sortedrun}
    jctx, tctx = _pair(frame, conf)
    with pytest.raises(JEngineFallback):
        jctx.execute(_spec(JS, ["cust"]))
    with pytest.raises(TX.EngineFallback, match="4096 table slots"):
        tctx.execute(_spec(TS, ["cust"]))


@pytest.mark.parametrize("sortedrun", TIERS)
def test_compaction_copies_only_occupied_slots(frame, sortedrun):
    got, st = _both(frame, {
        **HASHED, "sdot.engine.groupby.hash.compact.min.slots": 1,
        "sdot.engine.groupby.hash.slots": 1 << 16,
        "sdot.engine.groupby.hash.sortedrun": sortedrun},
        lambda S: _spec(S, ["cust"]))
    assert 0 < st["hash_compact_k"] < (1 << 16)
    assert st["hash_compact_k"] >= st["groups"]


TOPK = [("s_qty", False, 7), ("s_qty", True, 9), ("mn_nul", True, 12),
        ("mx_big", False, 5)]


@pytest.mark.parametrize("sortedrun", TIERS)
@pytest.mark.parametrize("metric,ascending,limit", TOPK)
def test_hashed_device_topk_matches_jax(frame, metric, ascending, limit,
                                        sortedrun):
    def make(S):
        return _spec(S, ["cust"], limit=S.LimitSpec(
            (S.OrderByColumn(metric, ascending=ascending),), limit))
    got, st = _both(frame, {**HASHED,
                            "sdot.engine.groupby.hash.slots": 1 << 14,
                            "sdot.engine.groupby.hash.sortedrun": sortedrun},
                    make, ordered=True)
    assert st["hashed"] and st["topk_device"] > 0 and len(got) == limit


@pytest.mark.parametrize("hashed", [True, False])
def test_topk_exactness_failure_reruns_without_it(frame, monkeypatch,
                                                  hashed):
    """Counts of 1 tie far past the candidate slack: with a second order
    column the proof fails and both engines re-run without device top-k
    (hashed tier, and the dense tier's dense key space)."""
    runs = []
    for name in ("_run_agg_hashed", "_run_agg"):
        real = getattr(TX.QueryEngine, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            runs.append((_name, kw.get("no_topk", False)))
            return _real(self, *a, **kw)
        monkeypatch.setattr(TX.QueryEngine, name, spy)

    def make(S):
        return S.GroupByQuerySpec(
            "fact", (S.DimensionSpec("cust", "cust"),),
            (S.AggregationSpec("count", "n"),),
            limit=S.LimitSpec((S.OrderByColumn("n", ascending=True),
                               S.OrderByColumn("cust")), 10))
    conf = HASHED if hashed else {}
    got, st = _both(frame, conf, make, ordered=True)
    assert (got["n"] == 1).all() and st["topk_device"] == 0
    assert bool(st.get("hashed")) == hashed
    site = "_run_agg_hashed" if hashed else "_run_agg"
    assert [r for r in runs if r[0] == site][-2:] == [(site, False),
                                                      (site, True)]


def test_dense_device_topk_matches_jax(frame):
    def make(S):
        return _spec(S, ["k3", "region"], limit=S.LimitSpec(
            (S.OrderByColumn("s_price", ascending=False),
             S.OrderByColumn("k3")), 15))
    got, st = _both(frame, {}, make, ordered=True)
    assert not st.get("hashed") and st["topk_device"] > 0


MEDIUM_K = {"sdot.engine.groupby.sorted.min.keys": 1024,
            "sdot.engine.groupby.hash.sortedrun": "on"}


def test_medium_k_reroutes_to_the_sorted_run_tier(frame):
    got, st = _both(frame, MEDIUM_K, lambda S: _spec(S, ["k3"]))
    assert st["hashed"] and st["route"] == "sorted"
    dense = tsdot.Context(config={"sdot.engine.groupby.sorted.min.keys": 0},
                          device="cpu")
    dense.ingest_dataframe("fact", frame, time_column="ts",
                           target_rows=4096)
    want = dense.execute(_spec(TS, ["k3"])).to_pandas()
    assert not dense.engine.last_stats.get("hashed")
    _frames_equal(got, want, ordered=False)


def test_medium_k_member_of_a_storm_runs_solo(frame):
    """Under shared scan a medium-K member that the reroute takes leaves
    the group at plan time in both packages; the others coalesce."""
    conf = {**MEDIUM_K, "sdot.sharedscan.enabled": True,
            "sdot.wlm.batch.window.ms": 500.0, "sdot.wlm.enabled": False,
            "sdot.pallas.wave.enabled": False}

    def batch(S):
        small = [S.GroupByQuerySpec(
            "fact", (S.DimensionSpec("region", "region"),),
            (S.AggregationSpec("longsum", f"s{i}", field="qty"),))
            for i in range(3)]
        return small + [_spec(S, ["k3"])]
    jctx, tctx = _pair(frame, conf)
    solo = {}
    for ctx, S, key in ((jctx, JS, "jax"), (tctx, TS, "port")):
        specs = batch(S)
        before = ctx.engine.sharedscan.stats()
        res, errs = [None] * 4, [None] * 4
        bar = threading.Barrier(4)

        def worker(i, ctx=ctx, specs=specs, res=res, errs=errs, bar=bar):
            bar.wait()
            try:
                res[i] = ctx.execute(specs[i]).to_pandas()
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs[i] = e
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(errs), errs
        after = ctx.engine.sharedscan.stats()
        assert after["queries_coalesced"] - before["queries_coalesced"] == 3
        assert after["fallbacks"] - before["fallbacks"] == 1
        solo[key] = res
    for g, w in zip(solo["port"], solo["jax"]):
        _frames_equal(g, w, ordered=False)
