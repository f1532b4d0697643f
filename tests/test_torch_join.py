"""The port's broadcast join tier against the JAX package's.

The single-context cases of ``tests/test_join.py`` through both packages:
the same seeded frames (fact, users, events, promos) go into a JAX
``Context`` and a port ``Context(device="cpu")``, and each statement runs
on both with the join tier on. Answers must agree (dimensions, counts,
integer sums and min / max exact; float sums rtol 1e-6), and so must
``last_stats["join"]``'s decisions: tier, build rows, table slots, match
width, waves and groups. Each port answer is also held against the port's
host tier (``sdot.join.enabled`` false), as the JAX tests do.

Below the statements, the kernel layer: ``build_table`` / ``probe`` /
``expand`` slot ids and match lists bit-equal to the JAX functions' on the
same keys (a key of -1, keys near 2^31), ``canonical_key`` and the Kleene
predicate lowering against JAX's on NULL-bearing inputs, and a probe in 3
waves. The JAX context runs with ``sdot.mesh.enabled`` false, so both
packages plan one device and the same waves.

The mesh branch: the port on a ``("cpu",) * n`` mesh against the JAX
package on its emulated n-device mesh, both with ``sdot.mesh.enabled``,
and against the port on one device, in one wave (8 slots) and in waves
(2 slots, ``sdot.engine.wave.max.bytes`` 1); the same tolerance.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

import jax.numpy as jnp

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.ops import hash_join as JHJ
from spark_druid_olap_tpu.parallel.mesh import make_mesh as jmake_mesh

import torch

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ops import hash_join as THJ
from spark_druid_olap_tpu_torch.parallel.mesh import make_mesh

from conftest import assert_frames_equal
from test_join import _events_df, _fact_df, _promos_df, _users_df
from test_torch_sql import assert_answers_equal

JS_KEYS = ("mode", "build_rows", "table_slots", "match_width", "waves",
           "segments_per_wave", "groups")


def _ingest(ctx):
    ctx.ingest_dataframe("fact", _fact_df(), time_column="ts",
                         target_rows=1024)
    ctx.ingest_dataframe("users", _users_df(), time_column="ts",
                         target_rows=64)
    ctx.ingest_dataframe("events", _events_df(), time_column="ts",
                         target_rows=1024)
    ctx.ingest_dataframe("promos", _promos_df(), time_column="ts",
                         target_rows=64)


@pytest.fixture(scope="module")
def pair():
    jctx = jsdot.Context({"sdot.mesh.enabled": False})
    tctx = tsdot.Context(device="cpu")
    _ingest(jctx)
    _ingest(tctx)
    yield jctx, tctx
    jctx.close()


def _set(pair, key, value):
    for c in pair:
        c.config.set(key, value)


def _both(pair, sql, expect_mode="broadcast", ordered=False):
    """Run ``sql`` through both packages' join tiers and against the
    port's host tier; returns (port frame, port join stats)."""
    jctx, tctx = pair
    want = jctx.sql(sql).to_pandas()
    jjs = jctx.engine.last_stats.get("join")
    got = tctx.sql(sql).to_pandas()
    tjs = tctx.engine.last_stats.get("join")
    assert_answers_equal(got, want, ordered)
    assert tctx.history.entries()[-1].stats["mode"] \
        == jctx.history.entries()[-1].stats["mode"]
    if expect_mode is None:
        assert jjs is None and tjs is None, (jjs, tjs)
    else:
        assert jjs["mode"] == expect_mode, jjs
        for k in JS_KEYS:
            assert tjs[k] == jjs[k], (k, tjs, jjs)
        assert tjs["estimate"] == jjs["estimate"]
    tctx.config.set("sdot.join.enabled", False)
    try:
        host = tctx.sql(sql).to_pandas()
        assert tctx.engine.last_stats.get("join") is None
    finally:
        tctx.config.set("sdot.join.enabled", True)
    # the host tier types an integer min / max as float where the join
    # tier keeps int64 (both packages): compare values, not dtypes
    assert_frames_equal(got, host, sort_by=[] if ordered else None,
                        rtol=1e-6)
    return got, tjs


EQUI = """
    SELECT u.segment_name AS seg, count(*) AS n,
           sum(f.amount) AS amt, avg(f.qty) AS q
    FROM fact f JOIN users u ON f.user_id = u.user_id
    GROUP BY u.segment_name ORDER BY seg"""

CASES = {
    "equi_groupby": (EQUI, True),
    "global_aggregate": ("""
        SELECT count(*) AS n, min(f.amount) AS lo, max(f.amount) AS hi
        FROM fact f JOIN users u ON f.user_id = u.user_id""", False),
    "non_equi_residual": ("""
        SELECT u.segment_name AS seg, count(*) AS n, sum(f.qty) AS tq
        FROM fact f JOIN users u
          ON f.user_id = u.user_id AND f.amount > u.credit
        GROUP BY u.segment_name ORDER BY seg""", True),
    "side_filters": ("""
        SELECT f.channel AS c, count(*) AS n, sum(f.amount) AS amt
        FROM fact f JOIN users u ON f.user_id = u.user_id
        WHERE u.segment_name = 'gold' AND f.qty > 5
        GROUP BY f.channel ORDER BY c""", True),
    "dim_string_key": ("""
        SELECT u.segment_name AS seg, count(*) AS n
        FROM events e JOIN users u ON e.country = u.country
        GROUP BY u.segment_name ORDER BY seg""", True),
    "null_join_keys": ("""
        SELECT count(*) AS n
        FROM events e JOIN users u ON e.country = u.country""", False),
    "self_join_funnel": ("""
        SELECT a.channel AS c, count(*) AS n
        FROM fact a JOIN fact b
          ON a.user_id = b.user_id AND a.amount < b.amount
        GROUP BY a.channel ORDER BY c""", True),
    "having_order_limit": ("""
        SELECT u.segment_name AS seg, count(*) AS n
        FROM fact f JOIN users u ON f.user_id = u.user_id
        GROUP BY u.segment_name HAVING count(*) > 10
        ORDER BY n DESC LIMIT 2""", True),
    "build_group_with_int_minmax": ("""
        SELECT u.segment_name AS seg, min(f.qty) AS lo, max(u.credit) AS hi,
               sum(f.qty * u.credit) AS w
        FROM fact f JOIN users u ON f.user_id = u.user_id
        WHERE f.amount / u.credit > 1.0
        GROUP BY u.segment_name""", False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_join_answers_and_decisions_equal_the_jax_package(pair, name):
    sql, ordered = CASES[name]
    got, js = _both(pair, sql, ordered=ordered)
    assert js["devices"] == 1 and js["build_ledger"]["outstanding_bytes"] == 0


def test_empty_build_side(pair):
    grouped, js = _both(pair, """
        SELECT u.segment_name AS seg, count(*) AS n
        FROM fact f JOIN users u ON f.user_id = u.user_id
        WHERE u.credit > 1000000 GROUP BY u.segment_name""")
    assert len(grouped) == 0 and js["mesh"] == "empty-build"
    one, _ = _both(pair, """
        SELECT count(*) AS n
        FROM fact f JOIN users u ON f.user_id = u.user_id
        WHERE u.credit > 1000000""")
    assert len(one) == 1 and one["n"][0] == 0


def test_hot_key_past_max_matches_declines_to_the_host(pair):
    q = """
        SELECT count(*) AS n, sum(e.value) AS v
        FROM events e JOIN promos p ON e.hot_id = p.pid"""
    got, _ = _both(pair, q, expect_mode=None)
    assert pair[1].history.entries()[-1].stats["mode"].startswith("host")
    _set(pair, "sdot.join.max.matches", 4096)
    try:
        wide, js = _both(pair, q)
    finally:
        _set(pair, "sdot.join.max.matches", 64)
    assert js["match_width"] > 64
    assert_answers_equal(wide, got, ordered=False)


def test_disabled_tier_still_answers(pair):
    _set(pair, "sdot.join.enabled", False)
    try:
        sql = ("SELECT count(*) AS n FROM fact f JOIN users u "
               "ON f.user_id = u.user_id")
        got = [c.sql(sql).to_pandas() for c in pair]
        assert all(c.engine.last_stats.get("join") is None for c in pair)
    finally:
        _set(pair, "sdot.join.enabled", True)
    assert_answers_equal(got[1], got[0], ordered=False)
    assert got[1]["n"][0] > 0


def test_stats_surface(pair):
    _, tctx = pair
    tctx.sql("SELECT count(*) AS n FROM fact f JOIN users u "
             "ON f.user_id = u.user_id")
    js = tctx.engine.last_stats["join"]
    for key in ("mode", "build_rows", "build_bytes", "shuffle_bytes",
                "estimate"):
        assert key in js, (key, js)
    assert js["shuffle_bytes"] == 0
    led = js["build_ledger"]
    assert led["outstanding_bytes"] == 0
    assert led["peak_bytes"] >= js["build_bytes"]
    assert tctx.history.entries()[-1].stats["join"]["mode"] == "broadcast"


def test_forced_partitioned_without_a_cluster_runs_broadcast(pair):
    _set(pair, "sdot.join.mode", "partitioned")
    try:
        _, js = _both(pair, EQUI, ordered=True)
    finally:
        _set(pair, "sdot.join.mode", "auto")
    assert js["estimate"]["mode"] == "partitioned"


def test_probe_in_three_waves(pair):
    """A wave budget of three fact segments' arrays: the probe streams in
    3 waves on both packages, and answers as in one wave."""
    one, js1 = _both(pair, EQUI, ordered=True)
    assert js1["waves"] == 1
    ds = pair[1].store.get("fact")
    from spark_druid_olap_tpu_torch.ops.scan import array_names
    from spark_druid_olap_tpu_torch.parallel import cost as C
    names = array_names(ds, ["amount", "qty", "user_id"],
                        need_time_ms=False)
    budget = 3 * C.bytes_per_segment(ds, names)
    _set(pair, "sdot.engine.wave.max.bytes", budget)
    try:
        waved, js = _both(pair, EQUI, ordered=True)
    finally:
        _set(pair, "sdot.engine.wave.max.bytes", 0)
    assert js["waves"] == 3 and js["segments_per_wave"] == 3
    assert_answers_equal(waved, one, ordered=True)


# -- the mesh branch --------------------------------------------------------------

MESH_CASES = ("equi_groupby", "global_aggregate", "non_equi_residual",
              "side_filters", "build_group_with_int_minmax")


@pytest.fixture(scope="module")
def mesh_contexts():
    """Per slot count (8, 2): (JAX on its emulated mesh, the port on a
    mesh of CPU slots), both with ``sdot.mesh.enabled``; and the port on
    one device."""
    on = {"sdot.mesh.enabled": True}
    meshes = {n: (jsdot.Context(on, mesh=jmake_mesh(n)),
                  tsdot.Context(on, mesh=make_mesh(devices=("cpu",) * n)))
              for n in (8, 2)}
    one = tsdot.Context(device="cpu")
    for c in [one] + [c for m in meshes.values() for c in m]:
        _ingest(c)
    yield meshes, one
    for jctx, _ in meshes.values():
        jctx.close()


@pytest.mark.parametrize("slots,waved", [(8, False), (2, True)],
                         ids=["8_slots_one_wave", "2_slots_waves"])
@pytest.mark.parametrize("name", MESH_CASES)
def test_mesh_join_equals_jax_mesh_and_one_device(mesh_contexts, name,
                                                  slots, waved):
    """Each slot probes its share of the fact segments against the table
    on its device, and the slots' partials merge: the answer and the
    join's decisions equal the JAX package's mesh branch, and the answer
    equals the port's one device."""
    meshes, one = mesh_contexts
    jctx, tctx = meshes[slots]
    sql, ordered = CASES[name]
    if waved:
        for c in (jctx, tctx):
            c.config.set("sdot.engine.wave.max.bytes", 1)
    try:
        want = jctx.sql(sql).to_pandas()
        jjs = jctx.engine.last_stats["join"]
        got = tctx.sql(sql).to_pandas()
        tjs = tctx.engine.last_stats["join"]
    finally:
        for c in (jctx, tctx):
            c.config.set("sdot.engine.wave.max.bytes", 0)
    assert tjs["mesh"] == jjs["mesh"] == "sharded", (tjs, jjs)
    assert tjs["devices"] == jjs["devices"] == slots
    for k in JS_KEYS:
        assert tjs[k] == jjs[k], (k, tjs, jjs)
    assert (tjs["waves"] > 1) == waved, tjs
    assert tjs["segments_per_wave"] % slots == 0
    assert tjs["build_ledger"]["outstanding_bytes"] == 0
    assert_answers_equal(got, want, ordered)
    assert_answers_equal(got, one.sql(sql).to_pandas(), ordered)


def test_mesh_join_with_fewer_segments_than_slots_runs_one_device(
        mesh_contexts):
    """events has 6 segments: on 8 slots both packages decline the mesh
    (``few-segments``) and probe on one device."""
    meshes, one = mesh_contexts
    jctx, tctx = meshes[8]
    sql, ordered = CASES["dim_string_key"]
    want = jctx.sql(sql).to_pandas()
    got = tctx.sql(sql).to_pandas()
    tjs, jjs = (c.engine.last_stats["join"] for c in (tctx, jctx))
    assert tjs["mesh"] == jjs["mesh"] == "few-segments"
    assert tjs["devices"] == jjs["devices"] == 1
    assert_answers_equal(got, want, ordered)
    assert_answers_equal(got, one.sql(sql).to_pandas(), ordered)


# -- cold-tier pins (a broadcast join over tiered sides) ------------------------

TIER_CFG = {"sdot.tier.enabled": True, "sdot.tier.budget.bytes": 4096,
            "sdot.tier.prefetch.enabled": False}
EVICTOR = "SELECT sum(amount) AS a, sum(value) AS v FROM fact, events"


@pytest.fixture(scope="module")
def tier_root(tmp_path_factory):
    """fact, users and events checkpointed raw by the port."""
    root = str(tmp_path_factory.mktemp("join-tier-root"))
    seed = tsdot.Context({"sdot.persist.path": root}, device="cpu")
    _ingest(seed)
    seed.checkpoint()
    seed.close()
    return root


def _tiered(root, **extra):
    ctx = tsdot.Context({"sdot.persist.path": root, **TIER_CFG, **extra},
                        device="cpu")
    assert getattr(ctx.store.get("fact"), "tier", None) is not None
    return ctx


class _FaultSpy:
    """Wraps a hot set's stored-chunk fault: per fault on the join's
    thread, the chunk's key, whether it is pinned as it returns, and the
    bytes pinned then; ``at`` runs once, on the join's thread, at the
    ``n``-th fault of a chunk of ``ds``."""

    def __init__(self, tier, ds=None, n=0, at=None):
        import threading
        self.tier, self.real = tier, tier._fault_stored
        self.thread = threading.get_ident()
        self.ds, self.n, self.at = ds, n, at
        self.faults = []
        tier._fault_stored = self

    def __call__(self, ds_name, column, ref, prefetch):
        import threading
        arr = self.real(ds_name, column, ref, prefetch)
        if threading.get_ident() != self.thread:
            return arr
        key = (ds_name, ref.path, int(ref.start), int(ref.count))
        t = self.tier
        with t._lock:
            self.faults.append((key, bool(t._pins.get(key)), sum(
                e.nbytes for k, e in t._hot.items() if t._pins.get(k))))
        if self.at is not None and ds_name == self.ds \
                and sum(f[0][0] == self.ds for f in self.faults) == self.n:
            at, self.at = self.at, None
            at()
        return arr

    def undo(self):
        del self.tier._fault_stored


def _evict_from_another_thread(ctx, tier, held):
    """Run ``EVICTOR`` on another thread of the same context and wait for
    it: under the 4 KiB budget it evicts every chunk no pin holds. Every
    chunk ``held`` names must still be hot after it."""
    import threading
    out, ev0 = {}, tier.counters["evictions"]
    th = threading.Thread(target=lambda: out.setdefault(
        "df", ctx.sql(EVICTOR).to_pandas()))
    th.start()
    th.join(60)
    assert not th.is_alive() and "df" in out
    with tier._lock:
        assert tier.counters["evictions"] > ev0
        assert held and all(k in tier._hot for k in held)


@pytest.mark.parametrize("side", ["build", "probe"])
def test_tier_pins_hold_while_another_statement_evicts(pair, tier_root,
                                                        side):
    """Mid-join, a statement on another thread evicts under a 4 KiB
    budget: every chunk the join faulted on its side so far was pinned as
    it returned and is still hot after the eviction; the answer equals
    the eager context's, and no pin is left when the join returns."""
    ctx = _tiered(tier_root)
    tier = ctx.store.get("fact").tier
    ds = "users" if side == "build" else "fact"

    def evict():
        held = {f[0] for f in spy.faults if f[0][0] == ds}
        _evict_from_another_thread(ctx, tier, held)

    spy = _FaultSpy(tier, ds=ds, n=2, at=evict)
    try:
        got = ctx.sql(EQUI).to_pandas()
    finally:
        spy.undo()
    js = ctx.engine.last_stats["join"]
    assert js["mode"] == "broadcast" and js["waves"] == 1
    assert spy.at is None, "the eviction never ran mid-join"
    mine = [f for f in spy.faults if f[0][0] in ("fact", "users")]
    assert mine and all(pinned for _, pinned, _ in mine)
    assert_answers_equal(got, pair[1].sql(EQUI).to_pandas(), ordered=True)
    st = tier.stats_snapshot()
    assert st["pinned_entries"] == 0 and not tier._pins
    ctx.close()


def test_waved_tiered_join_pins_one_wave(pair, tier_root):
    """A probe in waves over a tiered side pins one wave's chunks at a
    time (the binder's ``wave_pins``): the peak of the probe's pinned
    bytes stays within one wave's arrays, while the probe faults more
    than that in all; the answer equals the eager one-wave answer."""
    from spark_druid_olap_tpu_torch.ops.scan import array_names
    from spark_druid_olap_tpu_torch.parallel import cost as C
    eager = pair[1].store.get("fact")
    names = array_names(eager, ["amount", "qty", "user_id"],
                        need_time_ms=False)
    seg = C.bytes_per_segment(eager, names)
    ctx = _tiered(tier_root, **{"sdot.engine.wave.max.bytes": 3 * seg})
    tier = ctx.store.get("fact").tier
    spy = _FaultSpy(tier)
    try:
        got = ctx.sql(EQUI).to_pandas()
    finally:
        spy.undo()
    js = ctx.engine.last_stats["join"]
    assert js["mode"] == "broadcast" and js["waves"] == 3
    wave = js["segments_per_wave"] * seg
    probe = [f for f in spy.faults if f[0][0] == "fact"]
    assert probe and all(pinned for _, pinned, _ in probe)
    assert max(b for _, _, b in probe) <= wave
    assert tier.stats_snapshot()["bytes_faulted"] > wave
    assert_answers_equal(got, pair[1].sql(EQUI).to_pandas(), ordered=True)
    assert tier.stats_snapshot()["pinned_entries"] == 0 and not tier._pins
    ctx.close()


# -- the kernel layer ---------------------------------------------------------

def _tdev(table):
    return {k: torch.from_numpy(v) for k, v in table.device_tree().items()}


def _jdev(table):
    return {k: jnp.asarray(v) for k, v in table.device_tree().items()}


@pytest.mark.parametrize("seed,n,dup", [(0, 500, 3), (1, 4000, 1),
                                        (2, 64, 40)])
def test_build_probe_expand_bit_equal(seed, n, dup):
    rng = np.random.default_rng(seed)
    uniq = rng.choice(np.arange(0, 2**31 - 1, 7919), size=n, replace=False)
    uniq[:3] = [0, 2**31 - 2, 2**31 - 9]
    build = np.repeat(uniq, rng.integers(1, dup + 1, n))
    rng.shuffle(build)
    jt = JHJ.build_table(build, 64)
    tt = THJ.build_table(build, 64)
    for k, v in jt.device_tree().items():
        np.testing.assert_array_equal(tt.device_tree()[k], v, err_msg=k)
    assert (tt.n_slots, tt.shift, tt.max_disp, tt.max_count) \
        == (jt.n_slots, jt.shift, jt.max_disp, jt.max_count)
    probe = np.concatenate([
        rng.choice(uniq, 3000), rng.integers(0, 2**31 - 1, 1000),
        [-1, -1, 2**31 - 1, 2**31 - 2, 2**31 - 9, 0]]).astype(np.int64)
    valid = rng.random(len(probe)) < 0.9
    valid[-6:] = True
    kw = dict(n_slots=jt.n_slots, shift=jt.shift, max_disp=jt.max_disp)
    js_, jc = JHJ.probe(_jdev(jt), jnp.asarray(probe, jnp.int32),
                        jnp.asarray(valid), **kw)
    ts_, tc = THJ.probe(_tdev(tt), torch.from_numpy(probe).to(torch.int32),
                        torch.from_numpy(valid), **kw)
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.numpy()[-6:-4].tolist() == [0, 0]          # -1 misses
    jb, jm = JHJ.expand(_jdev(jt), js_, jc, width=jt.max_count,
                        n_build=jt.n_build)
    tb, tm = THJ.expand(_tdev(tt), ts_, tc, width=tt.max_count,
                        n_build=tt.n_build)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # every expanded match carries the probe key
    hit = tm.numpy()
    np.testing.assert_array_equal(
        build[tb.numpy()][hit],
        np.broadcast_to(probe[:, None], hit.shape)[hit])


def test_hot_build_key_raises_in_both():
    keys = np.array([5] * 70 + [1, 2, 3])
    for m in (JHJ, THJ):
        with pytest.raises(m.JoinUnsupported, match="max.matches=64"):
            m.build_table(keys, 64)


def test_canonical_key_equal_the_jax_package():
    rng = np.random.default_rng(5)
    uniq_s = np.array(["a", "c", "d", "zz"], dtype=object)
    dictionary = np.array(["a", "b", "c", "d", "e"], dtype=object)
    km_d_j = JHJ.dim_keymap(dictionary, uniq_s)
    km_d_t = THJ.dim_keymap(dictionary, uniq_s)
    np.testing.assert_array_equal(km_d_t.lut, km_d_j.lut)
    uniq_n = np.array([-7, 0, 3, 2**31 - 2], dtype=np.int64)
    km_n_j = JHJ.numeric_keymap(uniq_n, np.int64)
    km_n_t = THJ.numeric_keymap(uniq_n, np.int64)
    codes = rng.integers(0, 5, 300).astype(np.int32)
    vals = rng.choice(np.array([-7, 0, 1, 3, 2**31 - 2, 9]), 300)
    ok = rng.random(300) < 0.8
    jk, jv = JHJ.canonical_key(
        [km_d_j, km_n_j],
        [{k: jnp.asarray(v) for k, v in km_d_j.device_tree().items()},
         {k: jnp.asarray(v) for k, v in km_n_j.device_tree().items()}],
        [jnp.asarray(codes), jnp.asarray(vals)],
        [jnp.asarray(ok), jnp.asarray(ok)])
    tk, tv = THJ.canonical_key(
        [km_d_t, km_n_t],
        [{k: torch.from_numpy(v) for k, v in km_d_t.device_tree().items()},
         {k: torch.from_numpy(v) for k, v in km_n_t.device_tree().items()}],
        [torch.from_numpy(codes), torch.from_numpy(vals)],
        [torch.from_numpy(ok), torch.from_numpy(ok)])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


PREDS = [
    "a > b * 2", "a / b >= 1.5", "not (a < 3 or b is null)",
    "a between 2 and 7 and b <> 4", "a in (1, 3, 5) or b > 2.5",
    "cast(a as double) = b and not (b is not null)",
    "i / 3 > 1.0 or i * 2.5 < a",
]


@pytest.mark.parametrize("pred", PREDS)
def test_kleene_lowering_equal_the_jax_package(pred):
    from spark_druid_olap_tpu.sql.parser import parse_statement as jparse
    from spark_druid_olap_tpu_torch.sql.parser import \
        parse_statement as tparse
    rng = np.random.default_rng(9)
    n = 400
    cols = {"a": rng.integers(0, 9, n).astype(np.float32),
            "b": rng.integers(0, 9, n).astype(np.int64),
            "i": rng.integers(-2**40, 2**40, n).astype(np.int64)}
    valid = {k: rng.random(n) < 0.85 for k in cols}
    sql = f"select x from t where {pred}"
    je, te = jparse(sql).where, tparse(sql).where

    def jget(name):
        return jnp.asarray(cols[name]), jnp.asarray(valid[name])

    def tget(name):
        return torch.from_numpy(cols[name]), torch.from_numpy(valid[name])
    jt, ju = JHJ.lower_pred(je, jget)
    tt, tu = THJ.lower_pred(te, tget)
    np.testing.assert_array_equal(
        np.broadcast_to(tt.numpy(), (n,)), np.broadcast_to(np.asarray(jt),
                                                            (n,)))
    np.testing.assert_array_equal(
        np.broadcast_to(tu.numpy(), (n,)), np.broadcast_to(np.asarray(ju),
                                                            (n,)))
