"""The port's cold tier (``tier/``) against the JAX package's.

The single-process cases of ``tests/test_tier.py`` run through both
packages on the CPU over persist roots that each package wrote, crossed
both ways: a root the JAX package checkpointed recovers tiered in the port
and in the JAX package, and so does a root the port checkpointed. Each
tiered context answers as the writer's eager context did (dimensions,
integers and counts exact, float sums rtol 1e-6, as
``tests/test_torch_sql.py`` holds them; a tiered scan in the eager scan's
one wave is held bit for bit against the port's eager answer), under a
budget far below the column bytes, with eviction never touching a pinned
chunk, a corrupt cold blob quarantined at its first fault with recovery
falling back to the older snapshot, and the prefetcher's counters
advancing on a multi-wave cold scan. The hot set's own cases (pins,
popularity) drive both packages' ``TieredColumnStore`` with the same calls
and hold their stats equal.

Beyond the JAX cases: the wave binder's fault straight into its staging
rows (``ops/scan.build_wave_array`` over a tiered datasource, into a
reused buffer) equals, wave by wave, ``build_wave_array`` over the eager
store, on a raw and an encoded root; ``build_array`` too.

The JAX case of a cluster historical booting its owned shards tiered
(``test_historical_boots_owned_shards_within_budget``) waits for the
cluster (ROADMAP A.9).
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import os
import shutil
import zlib

import numpy as np
import pytest

from spark_druid_olap_tpu.tier.store import TieredColumnStore as JTier

from spark_druid_olap_tpu_torch.ops import scan as TSCAN
from spark_druid_olap_tpu_torch.persist import snapshot as TSNAP
from spark_druid_olap_tpu_torch.planner import fusion as TFU
from spark_druid_olap_tpu_torch.tier.handles import TieredDatasource
from spark_druid_olap_tpu_torch.tier.store import (
    BlobRef, TieredColumnStore as TTier)

from conftest import make_sales_df
from test_torch_persist import INGEST, Q, _events, open_ctx
from test_torch_sql import assert_answers_equal

PKGS = ("jax", "port")
TIER = {"jax": JTier, "port": TTier}

SALES_Q = ("select region, sum(qty) as q, sum(price) as p, count(*) as n "
           "from sales group by region order by region")


def _copy(root, tmp_path, name):
    """A private copy of a written root for one reader, so no reader
    sees another's recovery side effects."""
    dst = tmp_path / name
    shutil.copytree(root, dst)
    return dst


@pytest.fixture(scope="module")
def sales_roots(tmp_path_factory):
    """The sales store checkpointed by each package into its own root,
    and each writer's eager answer (the two equal each other)."""
    roots, want = {}, {}
    for pkg in PKGS:
        root = tmp_path_factory.mktemp(f"tier-sales-{pkg}")
        seed = open_ctx(pkg, root)
        seed.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                              target_rows=2048)
        want[pkg] = seed.sql(SALES_Q).to_pandas()
        seed.checkpoint()
        seed.close()
        roots[pkg] = root
    assert_answers_equal(want["port"], want["jax"], True)
    return roots, want


def _tiered(pkg, root, **extra):
    return open_ctx(pkg, root, **{"sdot.tier.enabled": True, **extra})


# -- (a) differential exactness under a tiny byte budget ----------------------

@pytest.mark.parametrize("writer", PKGS)
def test_tiny_budget_differential(sales_roots, tmp_path, writer):
    roots, want = sales_roots
    got = {}
    for reader in PKGS:
        ctx = _tiered(reader, _copy(roots[writer], tmp_path, reader),
                      **{"sdot.tier.budget.bytes": 4096})
        ds = ctx.store.get("sales")
        assert getattr(ds, "tier", None) is not None
        got[reader] = ctx.sql(SALES_Q).to_pandas()
        st = ctx.engine.last_stats["tier"]
        # the working set exceeds the budget many times over: the query
        # faulted cold bytes and the pin-release eviction restored the
        # budget invariant (budget + pinned only WHILE pinned)
        assert st["bytes_faulted"] > st["budget_bytes"]
        assert st["evictions"] > 0
        assert st["hot_bytes"] <= st["budget_bytes"]
        assert st["pinned_entries"] == 0
        # a repeat query still answers exactly through re-faults
        assert_answers_equal(ctx.sql(SALES_Q).to_pandas(), got[reader],
                             True)
        ctx.close()
    assert isinstance(_port_ds(roots[writer], tmp_path), TieredDatasource)
    assert_answers_equal(got["port"], got["jax"], True)
    assert_answers_equal(got["port"], want[writer], True)
    # one wave, as the eager scan: bit for bit with the port's eager answer
    assert got["port"].equals(want["port"])


def _port_ds(root, tmp_path):
    ctx = _tiered("port", _copy(root, tmp_path, "probe"))
    try:
        return ctx.store.get("sales")
    finally:
        ctx.close()


@pytest.mark.parametrize("writer", PKGS)
def test_unbudgeted_second_query_hits_hot_set(sales_roots, tmp_path,
                                              writer):
    roots, want = sales_roots
    for reader in PKGS:
        ctx = _tiered(reader, _copy(roots[writer], tmp_path, reader))
        assert_answers_equal(ctx.sql(SALES_Q).to_pandas(), want[writer],
                             True)
        ctx.engine.clear_caches()   # force a re-bind, not a cache hit
        faults0 = ctx.persist.tier.counters["faults"]
        assert_answers_equal(ctx.sql(SALES_Q).to_pandas(), want[writer],
                             True)
        st = ctx.engine.last_stats["tier"]
        assert st["faults"] == faults0, \
            f"{reader}: warm re-bind faulted cold chunks"
        assert st["hits"] > 0
        ctx.close()


# -- (b) eviction honors pins and popularity ----------------------------------

def _blob(tmp_path, name, n):
    arr = (np.arange(n, dtype=np.int32) + len(name)).astype(np.int32)
    p = str(tmp_path / name)
    arr.tofile(p)
    return arr, dict(path=p, dtype="int32", start=0, count=n,
                     crc=zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
                     file_bytes=arr.nbytes)


def _ref(pkg, kw):
    if pkg == "jax":
        from spark_druid_olap_tpu.tier.store import BlobRef as JBlobRef
        return JBlobRef(**kw)
    return BlobRef(**kw)


def _stable(st):
    return {k: v for k, v in st.items() if k != "crc_verify_ms"}


def test_eviction_honors_pins(tmp_path):
    a, ka = _blob(tmp_path, "a.bin", 256)
    b, kb = _blob(tmp_path, "b.bin", 256)
    c, kc = _blob(tmp_path, "c.bin", 256)
    seen = {}
    for pkg in PKGS:
        ra, rb, rc = (_ref(pkg, k) for k in (ka, kb, kc))
        tier = TIER[pkg](budget_bytes=2 * ra.nbytes)
        tok = tier.acquire_pins()
        np.testing.assert_array_equal(tier.fault("ds", "a", ra), a)
        np.testing.assert_array_equal(tier.fault("ds", "b", rb), b)
        # the third chunk overflows the budget, but every resident chunk
        # is pinned by the open token: nothing may be evicted yet
        np.testing.assert_array_equal(tier.fault("ds", "c", rc), c)
        st = tier.stats_snapshot()
        assert st["hot_bytes"] == 3 * ra.nbytes > st["budget_bytes"]
        assert st["evictions"] == 0
        assert st["pinned_entries"] == 3
        pinned = _stable(st)
        # release runs the deferred eviction and restores the invariant
        tier.release_pins(tok)
        st = tier.stats_snapshot()
        assert st["hot_bytes"] <= st["budget_bytes"]
        assert st["evictions"] >= 1
        assert st["pinned_entries"] == 0
        seen[pkg] = (pinned, _stable(st))
        tier.stop()
    assert seen["port"] == seen["jax"]


def test_eviction_prefers_unpopular_columns(tmp_path):
    _, ka = _blob(tmp_path, "a.bin", 256)
    _, kb = _blob(tmp_path, "b.bin", 256)
    scores = {("ds", "hotcol"): 9.0, ("ds", "coldcol"): 0.0}
    seen = {}
    for pkg in PKGS:
        ra, rb = _ref(pkg, ka), _ref(pkg, kb)
        tier = TIER[pkg](
            budget_bytes=ra.nbytes,   # room for exactly one chunk
            popularity=lambda ds, col: scores[(ds, col)])
        tier.fault("ds", "coldcol", ra)
        tier.fault("ds", "hotcol", rb)
        st = tier.stats_snapshot()
        assert st["hot_entries"] == 1 and st["evictions"] == 1
        # the popular column survived; the cold one re-faults
        assert tier.counters["faults"] == 2
        tier.fault("ds", "hotcol", rb)
        assert tier.counters["hits"] == 1
        seen[pkg] = _stable(tier.stats_snapshot())
        tier.stop()
    assert seen["port"] == seen["jax"]


# -- (c) CRC failure at fault time: quarantine + PERSIST fallback -------------

def _corrupt_events_root(pkg, root):
    """Two checkpoints of the events store, then 4 bytes of one blob of
    the newer version flipped on disk; ``(eager answer, newer version)``."""
    ctx = open_ctx(pkg, root)
    ctx.stream_ingest("events", _events(100), **INGEST)
    want = ctx.sql(Q).to_pandas()
    ctx.checkpoint("events")
    ctx.stream_ingest("events", _events(10, seed=5), **INGEST)
    ctx.checkpoint("events")
    ds_root = ctx.persist._ds_root("events")
    cur = TSNAP.current_version(ds_root)
    vdir = os.path.join(ds_root, TSNAP.version_dirname(cur))
    blob = next(p for p in sorted(os.listdir(vdir)) if p.endswith(".bin"))
    with open(os.path.join(vdir, blob), "r+b") as f:
        f.seek(0)
        f.write(b"\xde\xad\xbe\xef")
    ctx.close()
    return want, cur


@pytest.mark.parametrize("writer", PKGS)
@pytest.mark.parametrize("reader", PKGS)
def test_cold_crc_failure_quarantines_and_falls_back(tmp_path, writer,
                                                     reader):
    from spark_druid_olap_tpu.persist.snapshot import (
        SnapshotCorrupt as JCorrupt)
    corrupt = {"jax": JCorrupt, "port": TSNAP.SnapshotCorrupt}[reader]
    want, cur = _corrupt_events_root(writer, tmp_path)
    # tiered boot only checks structure (existence, sizes); the flipped
    # bytes surface at the FIRST FAULT, not at recovery
    ctx = _tiered(reader, tmp_path)
    assert not ctx.persist.recovery_report["quarantined"]
    with pytest.raises(corrupt):
        ctx.sql(Q)
    # the faulting query quarantined the version and re-ran recovery:
    # the next query answers from the older intact snapshot
    rep = ctx.persist.recovery_report
    assert len(rep["quarantined"]) == 1
    assert rep["quarantined"][0]["version"] == cur
    assert_answers_equal(ctx.sql(Q).to_pandas(), want, True)
    assert ctx.persist.tier.counters["crc_failures"] == 1
    snaps = ctx.sql("select state from sys_snapshots").to_pandas()
    assert any(s.startswith("quarantined:") for s in snaps["state"])
    ctx.close()


# -- (d) prefetch on a multi-wave cold scan -----------------------------------

# a per-wave I/O cap of about one segment's bytes: every wave's chunks
# are enqueued a whole wave ahead of their bind
WAVE_IO = {"sdot.tier.wave.io.bytes": 16 * 1024}


@pytest.mark.parametrize("writer", PKGS)
def test_prefetch_overlap_counters_advance(sales_roots, tmp_path, writer):
    roots, want = sales_roots
    got = {}
    for reader in PKGS:
        ctx = _tiered(reader, _copy(roots[writer], tmp_path, reader),
                      **WAVE_IO)
        got[reader] = ctx.sql(SALES_Q).to_pandas()
        st = ctx.engine.last_stats
        assert st["waves"] > 2, "scan did not split into waves"
        t = st["tier"]
        # waves past the first were enqueued behind the running compute,
        # so demand binds find prefetched chunks hot
        assert t["prefetch_submitted"] > 0
        assert t["prefetch_loaded"] > 0
        assert t["prefetch_hits"] > 0
        assert t["prefetch_overlap_ratio"] > 0.0
        got[reader + "_waves"] = st["waves"]
        ctx.close()
    assert got["port_waves"] == got["jax_waves"]
    assert_answers_equal(got["port"], got["jax"], True)
    assert_answers_equal(got["port"], want[writer], True)


def test_waved_scan_pins_one_wave_at_a_time(sales_roots, tmp_path):
    """The port's binder copies each chunk into its staging as it faults
    it, so it pins a wave's chunks only while it builds the wave: over a
    waved cold scan the pinned bytes never exceed one wave's staging, the
    hot set never exceeds budget + that, and the statement's faults come
    to more than both (a statement-long pin would have held them all)."""
    roots, want = sales_roots
    ctx = _tiered("port", _copy(roots["port"], tmp_path, "port"),
                  **{"sdot.tier.budget.bytes": 4096,
                     "sdot.tier.prefetch.enabled": False, **WAVE_IO})
    tier = ctx.store.get("sales").tier
    seen = []
    fault = tier._fault_stored

    def spy(*a, **k):
        arr = fault(*a, **k)
        with tier._lock:
            seen.append((tier._bytes, sum(
                e.nbytes for key, e in tier._hot.items()
                if tier._pins.get(key))))
        return arr

    tier._fault_stored = spy
    assert_answers_equal(ctx.sql(SALES_Q).to_pandas(), want["port"], True)
    st = ctx.engine.last_stats
    assert st["waves"] > 2
    wave = max(w["h2d_bytes"] for w in st["wave_steps"])
    assert seen and max(p for _, p in seen) <= wave
    assert max(h for h, _ in seen) <= tier.budget + wave
    assert st["tier"]["bytes_faulted"] > tier.budget + wave
    assert st["tier"]["pinned_entries"] == 0
    ctx.close()


@pytest.mark.parametrize("writer", PKGS)
def test_prefetch_disabled_still_exact(sales_roots, tmp_path, writer):
    roots, want = sales_roots
    for reader in PKGS:
        ctx = _tiered(reader, _copy(roots[writer], tmp_path, reader),
                      **{"sdot.tier.prefetch.enabled": False, **WAVE_IO})
        assert_answers_equal(ctx.sql(SALES_Q).to_pandas(), want[writer],
                             True)
        t = ctx.engine.last_stats["tier"]
        assert t["prefetch_loaded"] == 0 and t["faults"] > 0
        assert ctx.engine.last_stats["waves"] > 2
        ctx.close()


# -- the wave binder's fault straight into staging ----------------------------

@pytest.mark.parametrize("encoded", [False, True])
def test_wave_fault_into_staging_equals_eager(tmp_path, encoded):
    df = make_sales_df(6000)
    seed = open_ctx("port", tmp_path, **{"sdot.encode.enabled": encoded})
    eager = seed.ingest_dataframe("sales", df, time_column="ts",
                                  target_rows=1024)
    seed.checkpoint()
    seed.close()
    ctx = _tiered("port", tmp_path, **{"sdot.tier.budget.bytes": 1 << 14})
    ds = ctx.store.get("sales")
    assert isinstance(ds, TieredDatasource)
    assert ds.num_segments == eager.num_segments > 3
    names = TSCAN.array_names(eager, eager.column_names(), True)
    spw = 2
    waves = TFU.plan_device_waves(np.arange(ds.num_segments), spw, 1)
    assert len(waves[-1]) < spw or ds.num_segments % spw == 0
    for k in names:
        dt = TSCAN.array_dtype(eager, k)
        got = np.full((spw, ds.padded_rows), 7, dtype=dt)  # a dirty buffer
        want = np.empty((spw, eager.padded_rows), dtype=dt)
        for segs in waves + waves[::-1]:
            tok = ds.tier.acquire_pins()
            try:
                TSCAN.build_wave_array(ds, k, segs, got)
            finally:
                ds.tier.release_pins(tok)
            TSCAN.build_wave_array(eager, k, segs, want)
            np.testing.assert_array_equal(got, want, err_msg=k)
        np.testing.assert_array_equal(
            TSCAN.build_array(ds, k, np.array([3, 1])),
            TSCAN.build_array(eager, k, np.array([3, 1])), err_msg=k)
        np.testing.assert_array_equal(TSCAN.build_array(ds, k),
                                      TSCAN.build_array(eager, k),
                                      err_msg=k)
    st = ds.tier.stats_snapshot()
    assert st["faults"] > 0 and st["pinned_entries"] == 0
    ctx.close()
