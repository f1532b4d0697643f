"""The port's single-process device mesh against the JAX package's.

From JAX ``tests/test_mesh_smoke.py`` and ``tests/test_meshexec.py``: the
mesh helpers (``parallel/mesh.py``), the merge algebra (the port's fold in
slot order against JAX's ``psum`` / ``pmin`` / ``pmax`` inside
``shard_map`` over its emulated 8-device CPU mesh: sums, extrema, HLL
maxima, theta minima, KLL lex-minima), the fused tier's mesh decision
(``parallel/meshexec.decide``: every row of the fallback matrix gives
JAX's reason), ``sig_fields``, the partial ledger, the device-aware wave
partition, the tier's mesh pin gauge, and sharded storms.

The port's mesh is ``("cpu",) * 8``: eight slots on the one CPU, the
counterpart of JAX's emulated eight devices. A sharded storm is held
against the port's single-device storm and against JAX's jaxpr-fused
sharded storm with the Pallas wave off (JAX's interpreted wave kernel
fails its own storms). With ``partial_sketches`` set on both engines
the sketch columns are the raw registers, compared bit for bit.

Tolerance: ints, counts, min / max, dimensions and registers exact; float
sums rtol 1e-9 against the port's single device (both sum float64 in
slot and wave order) and rtol 1e-5 against the JAX package (the JAX
test's own), whose float metrics and sums run another order.

Two cases have no JAX counterpart: two slots on one device split its
wave budget, so two resident waves of both stay within the device's
share; and 5 segments over 8 slots (3 slots only padding) answer with
the registers of one device.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import threading
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from spark_druid_olap_tpu.ir import spec as JS
from spark_druid_olap_tpu.ops import groupby as JG
from spark_druid_olap_tpu.ops import hll as JHLL
from spark_druid_olap_tpu.ops import kll as JKLL
from spark_druid_olap_tpu.ops import theta as JTH
from spark_druid_olap_tpu.parallel import mesh as JM
from spark_druid_olap_tpu.parallel import meshexec as JMX
from spark_druid_olap_tpu.parallel import multihost as JMH
from spark_druid_olap_tpu.parallel.executor import QueryEngine as JEngine
from spark_druid_olap_tpu.planner.fusion import \
    plan_device_waves as j_plan_device_waves
from spark_druid_olap_tpu.segment.ingest import ingest_dataframe as jingest
from spark_druid_olap_tpu.segment.store import SegmentStore as JStore
from spark_druid_olap_tpu.utils.config import Config as JConfig

from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.ops import groupby as TG
from spark_druid_olap_tpu_torch.ops import hll as THLL
from spark_druid_olap_tpu_torch.ops import kll as TKLL
from spark_druid_olap_tpu_torch.ops import theta as TTH
from spark_druid_olap_tpu_torch.parallel import cost as TC
from spark_druid_olap_tpu_torch.parallel import mesh as TM
from spark_druid_olap_tpu_torch.parallel import meshexec as TMX
from spark_druid_olap_tpu_torch.parallel import multihost as TMH
from spark_druid_olap_tpu_torch.parallel.executor import QueryEngine as TEngine
from spark_druid_olap_tpu_torch.planner.fusion import plan_device_waves
from spark_druid_olap_tpu_torch.segment.ingest import \
    ingest_dataframe as tingest
from spark_druid_olap_tpu_torch.segment.store import SegmentStore as TStore
from spark_druid_olap_tpu_torch.utils.config import Config as TConfig

from conftest import make_sales_df

CPU_MESH = ("cpu",) * 8
SINGLE_RTOL = 1e-9
JAX_RTOL = 1e-5


def _cpu_mesh():
    return TM.make_mesh(devices=CPU_MESH)


def _shard_map(body, n_out=1):
    mesh = JM.make_mesh()
    return JM.shard_map(body, mesh=mesh, in_specs=(P(JM.SEGMENT_AXIS),),
                        out_specs=P() if n_out == 1 else (P(),) * n_out)


# -- mesh helpers ---------------------------------------------------------------

def test_mesh_topology():
    mesh = _cpu_mesh()
    assert TM.SEGMENT_AXIS == JM.SEGMENT_AXIS
    assert TM.mesh_size(mesh) == JM.mesh_size(JM.make_mesh()) == 8
    assert TM.mesh_size(TM.make_mesh(n_devices=2, devices=CPU_MESH)) == 2
    assert TM.mesh_size(None) == JM.mesh_size(None) == 1
    assert TM.mesh_size(TM.mesh_subset(mesh, 3)) == 3
    assert TM.mesh_subset(mesh, 99) == mesh
    assert TM.slots_on(mesh, "cpu") == 8 and TM.slots_on(None, "cpu") == 1
    two = TM.make_mesh(devices=("cpu", "cpu"))
    assert all(isinstance(d, torch.device) for d in two)


# -- the merge algebra ------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.int64])
def test_merge_operators_match_jax_collectives(dtype):
    x = (np.arange(8 * 4).reshape(8, 4) * 3 - 5).astype(dtype)
    x[3, 1] = -1000
    x[6, 2] = 7000
    s, lo, hi = _shard_map(
        lambda b: (jax.lax.psum(b[0], JM.SEGMENT_AXIS),
                   jax.lax.pmin(b[0], JM.SEGMENT_AXIS),
                   jax.lax.pmax(b[0], JM.SEGMENT_AXIS)), 3)(jnp.asarray(x))
    routes = {"s": TG.Route("s", "sum", "i64"),
              "lo": TG.Route("lo", "min", "i64"),
              "hi": TG.Route("hi", "max", "i64")}
    parts = [{k: torch.from_numpy(x[i]) for k in routes} for i in range(8)]
    got = TG.merge_partials(parts, routes)
    for name, want in (("s", s), ("lo", lo), ("hi", hi)):
        if dtype == np.float64 and name == "s":
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want),
                                       rtol=1e-7)
        else:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want))


def test_hll_registers_merge_as_elementwise_max():
    rng = np.random.default_rng(7)
    regs = rng.integers(0, 22, size=(8, 64)).astype(np.int32)
    want = _shard_map(lambda b: JHLL.merge_registers(
        b[0], JM.SEGMENT_AXIS))(jnp.asarray(regs))
    got = THLL.merge_registers([torch.from_numpy(r) for r in regs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_theta_registers_merge_as_elementwise_min():
    rng = np.random.default_rng(11)
    # lane minima in [0, 1); 2.0 is the wave stripe's empty value and
    # +inf theta_registers' (a slot that no row of the group reached)
    regs = rng.random(size=(8, 32)).astype(np.float32)
    regs[0, :4] = 2.0
    regs[:, 5] = np.inf
    regs[2:, 6] = 2.0
    regs[:2, 6] = np.inf
    want = _shard_map(lambda b: JTH.merge_registers(
        b[0], JM.SEGMENT_AXIS))(jnp.asarray(regs))
    got = TTH.merge_registers([torch.from_numpy(r) for r in regs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # an empty lane estimates as 1.0 whichever empty value it keeps
    np.testing.assert_array_equal(
        TTH.estimate(np.full((1, 64), 2.0, np.float32)),
        TTH.estimate(np.full((1, 64), np.inf, np.float32)))


def test_kll_registers_merge_as_lex_min_and_count_sum():
    rng = np.random.default_rng(13)
    lanes = 4
    w = TKLL.width(lanes)
    lk = (w - TKLL.N_LEVELS) // 2
    regs = np.empty((8, 3, w), np.int32)
    # few tiebreak values: equal t on several slots must break by v
    regs[..., :lk] = rng.integers(0, 3, (8, 3, lk))
    regs[..., lk:2 * lk] = rng.integers(-50, 50, (8, 3, lk))
    regs[..., 2 * lk:] = rng.integers(0, 1000, (8, 3, TKLL.N_LEVELS))
    regs[1, 0, :lk] = TKLL.EMPTY
    want = _shard_map(lambda b: JKLL.merge_registers(
        b[0], JM.SEGMENT_AXIS))(jnp.asarray(regs))
    got = TKLL.merge_registers([torch.from_numpy(r) for r in regs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    folded = regs[0]
    for r in regs[1:]:
        folded = TKLL.merge(folded, r)
    np.testing.assert_array_equal(got.numpy(), folded)


def test_merge_lane_partials_matches_jax():
    rng = np.random.default_rng(17)
    n_keys = 6
    out = {"s": rng.normal(size=(8, n_keys)),
           "c": rng.integers(0, 100, (8, n_keys)),
           "mn": rng.integers(-9, 9, (8, n_keys)),
           "h": rng.integers(0, 20, (8, n_keys, 16)).astype(np.int32),
           "t": rng.random((8, n_keys, 64)).astype(np.float32)}
    kinds = {"h": "hll", "t": "theta"}
    jroutes = JG.plan_routes([JG.AggInput("s", "sum"),
                              JG.AggInput("c", "count", is_int=True),
                              JG.AggInput("mn", "min", is_int=True)],
                             n_keys, 4096)
    troutes = TG.plan_routes([TG.AggInput("s", "sum"),
                              TG.AggInput("c", "count", is_int=True),
                              TG.AggInput("mn", "min", is_int=True)])
    mesh = JM.make_mesh()
    want = JM.shard_map(
        lambda d: JG.merge_lane_partials({k: v[0] for k, v in d.items()},
                                         jroutes, kinds, JM.SEGMENT_AXIS),
        mesh=mesh, in_specs=({k: P(JM.SEGMENT_AXIS) for k in out},),
        out_specs={k: P() for k in out})(
            {k: jnp.asarray(v) for k, v in out.items()})
    got = TG.merge_lane_partials(
        [{k: torch.from_numpy(np.ascontiguousarray(v[i]))
          for k, v in out.items()} for i in range(8)], troutes, kinds)
    np.testing.assert_allclose(got["s"].numpy(), np.asarray(want["s"]),
                               rtol=1e-7)
    for k in ("c", "mn", "h", "t"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# -- decision, accounting, wave partition ---------------------------------------

def test_decide_sig_fields():
    assert TMX.SINGLE.sig_fields() == JMX.SINGLE.sig_fields() == (False, 1)
    assert TMX.SINGLE.reason == JMX.SINGLE.reason == "no-mesh"
    assert TMX.MeshDecision(True, 8, "cost-sharded").sig_fields() \
        == (True, 8)


def _lane(pkg, n_keys=64):
    agg = types.SimpleNamespace(kind="sum", spec=types.SimpleNamespace(
        name="s"))
    if pkg == "jax":
        routes = JG.plan_routes([JG.AggInput("s", "sum", is_int=True),
                                 JG.AggInput("__rows__", "count",
                                             is_int=True)], n_keys, 4096)
    else:
        routes = TG.plan_routes([TG.AggInput("s", "sum", is_int=True),
                                 TG.AggInput("__rows__", "count",
                                             is_int=True)])
    return types.SimpleNamespace(n_keys=n_keys, agg_plans=[agg],
                                 routes=routes)


# the fallback matrix: (row, config, datasource rows, segments, patch)
MATRIX = [
    ("no-mesh", {}, 50_000_000, 8, "no-mesh"),
    ("disabled", {"sdot.mesh.enabled": False}, 50_000_000, 8, None),
    ("multihost", {}, 50_000_000, 8, "multihost"),
    ("partial-store", {}, 50_000_000, 8, "partial"),
    ("few-segments", {}, 50_000_000, 1, None),
    ("few-segments", {"sdot.mesh.min.segments": 9}, 50_000_000, 8, None),
    ("cost-single", {}, 20_000, 8, None),
    ("cost-sharded", {"sdot.querycostmodel.compile.cost": 0.0},
     50_000_000, 8, None),
    ("sharded", {"sdot.querycostmodel.enabled": False}, 100, 8, None),
]


@pytest.mark.parametrize("reason,cfg,rows,n_seg,patch", MATRIX,
                         ids=[f"{m[0]}-{i}" for i, m in enumerate(MATRIX)])
def test_decide_gives_the_jax_reason(reason, cfg, rows, n_seg, patch,
                                     monkeypatch):
    if patch == "multihost":
        monkeypatch.setattr(JMH, "is_multihost", lambda: True)
        monkeypatch.setattr(TMH, "is_multihost", lambda: True)
    got = {}
    for pkg in ("jax", "port"):
        mesh = None if patch == "no-mesh" else \
            (JM.make_mesh() if pkg == "jax" else _cpu_mesh())
        eng = types.SimpleNamespace(
            mesh=mesh, config=(JConfig if pkg == "jax" else TConfig)(cfg))
        ds = types.SimpleNamespace(num_rows=rows,
                                   is_partial=patch == "partial")
        d = (JMX if pkg == "jax" else TMX).decide(eng, ds, [_lane(pkg)],
                                                  n_seg)
        got[pkg] = (d.sharded, d.n_dev, d.reason)
    assert got["port"] == got["jax"]
    assert got["port"][2] == reason


def test_collective_bytes_of_dense_lanes_equal_jax():
    eng = types.SimpleNamespace(config=TConfig())
    jeng = types.SimpleNamespace(config=JConfig())
    assert TMX.merged_payload_bytes(eng, [_lane("port")]) \
        == JMX.merged_payload_bytes(jeng, [_lane("jax")]) == 64 * 2 * 8
    assert TMX.collective_bytes(eng, [_lane("port")], 8) \
        == JMX.collective_bytes(jeng, [_lane("jax")], 8)


def test_partial_ledger_lifecycle():
    led = TMX.PartialLedger()
    t1 = led.acquire_partials(1000)
    t2 = led.acquire_partials(500)
    assert led.stats()["outstanding_bytes"] == 1500
    assert led.stats()["peak_bytes"] == 1500
    led.release_partials(t1)
    led.release_partials(t1)            # double release is a no-op
    assert led.stats()["outstanding_bytes"] == 500
    led.release_partials(t2)
    st = led.stats()
    assert st["outstanding_bytes"] == 0
    assert st["peak_bytes"] == 1500 and st["acquires"] == 2


@pytest.mark.parametrize("case", ["passthrough", "cover", "balance"])
def test_plan_device_waves_equal_jax(case):
    if case == "passthrough":
        args = (np.arange(10), 4, 1, {i: 1 for i in range(10)})
    elif case == "cover":
        args = (np.arange(20), 8, 8, {i: (i + 1) * 100 for i in range(20)})
    else:
        rows = {0: 10_000, 7: 10_000}
        rows.update({i: 1 for i in range(1, 7)})
        args = (np.arange(8), 8, 4, rows)
    got = plan_device_waves(*args)
    want = j_plan_device_waves(*args)
    assert [list(w) for w in got] == [list(w) for w in want]
    assert sorted(int(s) for w in got for s in w) == list(range(len(args[0])))
    if case == "balance":
        buckets = [set(int(s) for s in got[0][i * 2:(i + 1) * 2])
                   for i in range(4)]
        assert len([b for b in buckets if 0 in b or 7 in b]) == 2


def test_tier_pin_token_mesh_accounting(tmp_path):
    from spark_druid_olap_tpu_torch.tier.store import (BlobRef,
                                                       TieredColumnStore)
    arr = np.arange(256, dtype=np.int32)
    p = str(tmp_path / "a.bin")
    arr.tofile(p)
    ref = BlobRef(path=p, dtype="int32", start=0, count=256,
                  crc=zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
                  file_bytes=arr.nbytes)
    tier = TieredColumnStore(budget_bytes=1 << 20)
    tok = tier.acquire_pins(devices=8)
    assert tier.counters["pin_tokens_mesh"] == 1
    np.testing.assert_array_equal(tier.fault("ds", "a", ref), arr)
    st = tier.stats_snapshot()
    assert st["mesh_pinned_entries"] == 1
    assert st["mesh_pinned_bytes"] == arr.nbytes
    tier.release_pins(tok)
    st = tier.stats_snapshot()
    assert st["mesh_pinned_entries"] == 0 and st["mesh_pinned_bytes"] == 0
    tok2 = tier.acquire_pins()
    assert tier.counters["pin_tokens_mesh"] == 1
    tier.release_pins(tok2)
    # a sharded wave's build scope counts as a mesh scope too
    with tier.wave_pins(devices=4):
        pass
    assert tier.counters["pin_tokens_mesh"] == 2
    tier.stop()


# -- storms: the fused tier over the mesh ---------------------------------------

WINDOW_MS = 500.0


def _aggs(S):
    return (S.AggregationSpec("doublesum", "revenue", field="price"),
            S.AggregationSpec("longsum", "units", field="qty"),
            S.AggregationSpec("count", "n"),
            S.AggregationSpec("doublemin", "lo", field="price"),
            S.AggregationSpec("doublemax", "hi", field="price"),
            S.AggregationSpec("cardinality", "uprod", field="product"),
            S.AggregationSpec("thetasketch", "tprod", field="product"),
            # a filtered theta: groups with rows but none that pass keep
            # an empty sketch (+inf lanes off the kernel, 2.0 in its
            # stripe)
            S.AggregationSpec("thetasketch", "tprod_o", field="product",
                              filter=S.SelectorFilter("status", "O")))


def _sales_batch(S):
    aggs = _aggs(S)
    return [
        S.GroupByQuerySpec("sales", (S.DimensionSpec("region", "region"),),
                           aggs),
        S.GroupByQuerySpec("sales", (S.DimensionSpec("flag", "flag"),),
                           aggs, filter=S.SelectorFilter("status", "O")),
        S.TimeseriesQuerySpec("sales", aggs,
                              granularity=S.Granularity("month")),
    ]


def _slim_batch(S):
    aggs = (S.AggregationSpec("doublesum", "revenue", field="price"),
            S.AggregationSpec("count", "n"))
    return [
        S.GroupByQuerySpec("sales", (S.DimensionSpec("region", "region"),),
                           aggs),
        S.GroupByQuerySpec("sales", (S.DimensionSpec("flag", "flag"),),
                           aggs, filter=S.SelectorFilter("status", "O")),
    ]


def _storm_cfg(**over):
    cfg = {"sdot.sharedscan.enabled": True,
           "sdot.wlm.batch.window.ms": WINDOW_MS,
           "sdot.wlm.enabled": False,
           "sdot.querycostmodel.enabled": False}
    cfg.update(over)
    return cfg


def _stores(target_rows=4096, n=20_000):
    df = make_sales_df(n)
    js, ts = JStore(), TStore()
    js.register(jingest("sales", df, time_column="ts",
                        target_rows=target_rows))
    ts.register(tingest("sales", df, time_column="ts",
                        target_rows=target_rows))
    return js, ts


@pytest.fixture(scope="module")
def stores():
    return _stores()


def _run_concurrent(eng, specs):
    n = len(specs)
    res, errs, stats = [None] * n, [None] * n, [None] * n
    bar = threading.Barrier(n)

    def worker(i):
        bar.wait()
        try:
            res[i] = eng.execute(specs[i])
            stats[i] = dict(eng.last_stats)
        except Exception as e:          # noqa: BLE001 - surfaced via errs
            errs[i] = e

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not any(errs), [e for e in errs if e]
    return res, stats


def _port_engine(store, mesh=True, **over):
    eng = TEngine(store, config=TConfig(_storm_cfg(**over)), device="cpu",
                  mesh=_cpu_mesh() if mesh else None)
    eng.partial_sketches = True
    return eng


def _port_ref(store, **over):
    eng = TEngine(store, config=TConfig({"sdot.sharedscan.enabled": False,
                                         "sdot.wlm.enabled": False,
                                         **over}), device="cpu")
    eng.partial_sketches = True
    return eng


def _assert_frames(got, want, rtol):
    """Two QueryResults, rows in the same order (both engines order by
    key): every column exact but float sums; the raw register blocks of
    the sketch columns bit for bit."""
    assert list(got.columns) == list(want.columns)
    for c in want.columns:
        g, w = np.asarray(got.data[c]), np.asarray(want.data[c])
        assert g.shape == w.shape, c
        if w.dtype.kind == "f" and w.ndim == 1:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


def _storm_diff(jstore, tstore, jspecs, tspecs, *, with_jax=True,
                expect_sharded=True, **over):
    """The port's sharded storm against its single-device answers (and
    JAX's sharded storm): returns (coalescer stats, member stats)."""
    ref = _port_ref(tstore)
    want = [ref.execute(q) for q in tspecs]
    eng = _port_engine(tstore, **over)
    got, stats = _run_concurrent(eng, tspecs)
    for g, w in zip(got, want):
        _assert_frames(g, w, SINGLE_RTOL)
    st = eng.sharedscan.stats()
    if expect_sharded:
        assert st["mesh"]["groups"] >= 1, st["mesh"]
        assert st["mesh"]["collective_bytes"] > 0, st["mesh"]
        assert all(s.get("sharded") for s in stats), stats
    assert st["mesh"]["partials"]["outstanding_bytes"] == 0, st["mesh"]
    if with_jax:
        jeng = JEngine(jstore, config=JConfig(_storm_cfg(
            **{"sdot.pallas.wave.enabled": False, **over})),
            mesh=JM.make_mesh())
        jeng.partial_sketches = True
        jgot, jstats = _run_concurrent(jeng, jspecs)
        assert all(s.get("sharded") for s in jstats) == expect_sharded
        for g, w in zip(got, jgot):
            _assert_frames(g, w, JAX_RTOL)
    return st, stats


@pytest.mark.parametrize("wave", [True, False], ids=["wave", "lanes"])
def test_sales_storm_matches_single_device_and_jax(stores, wave):
    """Every register class, on the wave kernel's route (its plain
    version on the CPU, once per slot) and lane by lane; the registers
    against JAX's jaxpr-fused sharded storm on the lanes route (its theta
    lanes keep +inf where a group holds no row, the wave stripe 2.0), the
    estimates on both."""
    jstore, tstore = stores
    st, stats = _storm_diff(jstore, tstore, _sales_batch(JS),
                            _sales_batch(TS), with_jax=not wave,
                            **{"sdot.pallas.wave.enabled": wave})
    assert st["mesh"]["devices"] == 8 and st["mesh"]["dispatches"] >= 1
    mem = stats[0]["mesh"]
    assert mem["devices"] == 8 and mem["decision"] == "sharded"
    assert mem["collective_bytes"] > 0
    if wave:
        # one launch per slot per wave
        assert st["wave_launches"] == 8 * st["mesh"]["dispatches"]
        assert stats[0]["route"] == "wave"
        # the estimates (not the registers: a group the filtered theta
        # never reaches keeps 2.0 in the stripe, +inf off the kernel)
        # equal JAX's sharded storm's
        eng = _port_engine(tstore, **{"sdot.pallas.wave.enabled": True})
        jeng = JEngine(jstore, config=JConfig(_storm_cfg(
            **{"sdot.pallas.wave.enabled": False})), mesh=JM.make_mesh())
        eng.partial_sketches = jeng.partial_sketches = False
        got, _ = _run_concurrent(eng, _sales_batch(TS))
        want, _ = _run_concurrent(jeng, _sales_batch(JS))
        for g, w in zip(got, want):
            _assert_frames(g, w, JAX_RTOL)


def test_multiwave_mesh_matches_single_device():
    jstore, tstore = _stores(target_rows=512)
    assert tstore.get("sales").num_segments > 16
    st, stats = _storm_diff(jstore, tstore, _slim_batch(JS),
                            _slim_batch(TS),
                            **{"sdot.engine.wave.max.bytes": 200_000})
    assert stats[0]["waves"] > 1 and stats[0]["segments_per_wave"] % 8 == 0


def test_fallback_no_mesh(stores):
    _, tstore = stores
    st, stats = _storm_diff(None, tstore, None, _slim_batch(TS),
                            with_jax=False, expect_sharded=False,
                            mesh=False)
    assert st["mesh"]["fallbacks"].get("no-mesh", 0) >= 1, st["mesh"]
    assert st["mesh"]["dispatches"] == 0
    assert stats[0]["mesh"] == {"devices": 1, "decision": "no-mesh",
                                "collective_bytes": 0}


@pytest.mark.parametrize("reason,over", [
    ("disabled", {"sdot.mesh.enabled": False}),
    ("cost-single", {"sdot.querycostmodel.enabled": True}),
    ("few-segments", {"sdot.mesh.min.segments": 99})])
def test_fallback_matrix_keeps_answers(stores, reason, over):
    _, tstore = stores
    st, stats = _storm_diff(None, tstore, None, _slim_batch(TS),
                            with_jax=False, expect_sharded=False, **over)
    assert st["mesh"]["fallbacks"].get(reason, 0) >= 1, st["mesh"]
    assert not any(s.get("sharded") for s in stats)
    assert stats[0]["mesh"]["decision"] == reason


def test_mesh_decision_folds_into_the_program_signature(stores):
    """A flip of the mesh decision re-keys the fused program: it never
    reuses a program built for another layout."""
    _, tstore = stores
    eng = _port_engine(tstore)
    _run_concurrent(eng, _slim_batch(TS))
    n_progs = len(eng._programs)
    eng.config.set("sdot.mesh.enabled", False)
    got, stats = _run_concurrent(eng, _slim_batch(TS))
    assert len(eng._programs) > n_progs
    ref = _port_ref(tstore)
    for g, q in zip(got, _slim_batch(TS)):
        _assert_frames(g, ref.execute(q), SINGLE_RTOL)


# -- no JAX counterpart ---------------------------------------------------------

def test_slots_sharing_a_device_split_its_wave_budget(monkeypatch):
    """Two slots on one card: each slot's wave budget is half the card's,
    so two resident waves of both slots hold what two waves of one device
    hold, within twice the card's share (30% each)."""
    total = 80 * 10 ** 9
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(total_memory=total))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    conf = TConfig()
    card = TC.wave_budget_bytes(conf, "cuda:0")
    mesh = ("cuda:0", "cuda:0")
    slot = TC.wave_budget_bytes(conf, "cuda:0", [torch.device(d)
                                                  for d in mesh])
    assert card == int(total * TC.CUDA_WAVE_MEMORY_SHARE)
    assert slot * 2 <= card
    # two waves resident on every slot: within the card's two shares
    assert 2 * 2 * slot <= 2 * TC.CUDA_WAVE_MEMORY_SHARE * total
    # the configured budget is the card's too
    conf.set("sdot.engine.wave.max.bytes", 1000)
    assert TC.wave_budget_bytes(conf, "cuda:0", [torch.device(d)
                                                  for d in mesh]) == 500
    assert TC.wave_budget_bytes(conf, "cuda", [torch.device("cuda:0")] * 4) \
        == 250
    # a plan under the per-slot budget: every slot's share of a wave fits
    seg = 10 ** 9
    spw, waves = TC.plan_waves(6, 2, seg, slot, conf, 100, 2)
    assert spw % 2 == 0 and (spw // 2) * seg <= slot


def test_five_segments_over_eight_slots_equal_one_device():
    """5 segments on 8 slots: the bind pads 3 slots with empty segments,
    which add no rows, registers or survivors; B1's fold tier sees slots
    with no valid row. Answers and sketch registers equal one device's."""
    df = make_sales_df(5 * 1000, seed=3)
    store = TStore()
    store.register(tingest("sales", df, time_column="ts", target_rows=1024))
    assert store.get("sales").num_segments == 5
    cfg = {"sdot.querycostmodel.enabled": False, "sdot.wlm.enabled": False}
    mesh = TEngine(store, config=TConfig(cfg), device="cpu",
                   mesh=_cpu_mesh())
    one = TEngine(store, config=TConfig(cfg), device="cpu")
    for e in (mesh, one):
        e.partial_sketches = True
    aggs = _aggs(TS) + (
        TS.AggregationSpec("quantile", "p50", field="price", fraction=0.5),)
    specs = [TS.GroupByQuerySpec("sales", (TS.DimensionSpec("flag", "flag"),),
                                 aggs),
             TS.TimeseriesQuerySpec("sales", aggs[:5],
                                    filter=TS.SelectorFilter("region",
                                                             "east"))]
    for q in specs:
        got = mesh.execute(q)
        assert mesh.last_stats["sharded"] is True
        assert mesh.last_stats["devices"] == 8
        _assert_frames(got, one.execute(q), SINGLE_RTOL)
    # compaction on the slots: each slot's budget over its share
    mesh.config.set("sdot.engine.scan.compact.min.rows", 0)
    one.config.set("sdot.engine.scan.compact.min.rows", 0)
    q = TS.GroupByQuerySpec("sales", (TS.DimensionSpec("region", "region"),),
                            aggs[:5], filter=TS.SelectorFilter("product",
                                                               "p007"))
    got = mesh.execute(q)
    assert mesh.last_stats.get("compact_m")
    _assert_frames(got, one.execute(q), SINGLE_RTOL)
