"""The port's durable persistence against the JAX package's.

The cases of ``tests/test_persist.py`` but its HTTP endpoint run through
both packages' ``Context`` on the same numpy-seeded batches (the port on
the CPU), each package over its own persist root: after every step that
changes a store, the two stores are held column by column, bit for bit
(``test_torch_append.assert_same_store``), with equal ingest versions, and
answers are held as ``tests/test_torch_sql.py`` holds them (dimensions,
integers and counts exact, float sums rtol 1e-6). "Crash" is simulated as
there: a context abandoned without a checkpoint, a torn WAL tail, a
flipped snapshot byte.

Beyond the JAX cases: roots cross packages both ways (a root the JAX
package checkpointed with a journaled tail recovers in the port with the
same store, versions and answers, and the reverse), both packages write
byte-identical snapshot blobs for one store (raw and encoded; only the
manifest's ``created_at`` differs), the branches the port leaves out
(a cluster's tiered shard slices, the cluster push) raise
``NotImplementedError`` naming ROADMAP A.9, and the JAX package's
switches that turn off persistence, recovery, fsync or group commit are
refused at any value but their default. The JAX package's
background-checkpointer test polls with sleeps and fails now and then; here
the wait is on an event the checkpoint sets, with a deadline.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import filecmp
import json
import os
import struct
import threading

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.persist import snapshot as JSNAP
from spark_druid_olap_tpu.persist import wal as JWAL

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.persist import snapshot as TSNAP
from spark_druid_olap_tpu_torch.persist import wal as TWAL

from test_torch_append import assert_same_store
from test_torch_sql import assert_answers_equal


def _events(n=200, seed=3):
    r = np.random.default_rng(seed)
    start = np.datetime64("2024-01-01")
    return pd.DataFrame({
        "ts": (start + r.integers(0, 90, n).astype("timedelta64[D]")
               ).astype("datetime64[ns]"),
        "country": r.choice(["US", "DE", "FR", "JP"], n),
        "clicks": r.integers(0, 100, n),
        "price": np.round(r.uniform(0, 50, n), 2),
    })


INGEST = dict(time_column="ts", dimensions=["country"],
              metrics=["clicks", "price"])

Q = ("select country, sum(clicks) as c, count(*) as n from events "
     "group by country order by country")

SNAP = {"jax": JSNAP, "port": TSNAP}
WAL = {"jax": JWAL, "port": TWAL}


def open_ctx(pkg, root, **extra):
    """One package's context over ``root`` (the port's on the CPU)."""
    cfg = {"sdot.persist.path": str(root), **extra}
    if pkg == "jax":
        return jsdot.Context(cfg)
    return tsdot.Context(cfg, device="cpu")


class Pair:
    """The JAX package's and the port's contexts, each over its own root
    (``roots``), driven step by step with the same calls. Every broadcast
    call returns ``(jax result, port result)``."""

    PKGS = ("jax", "port")

    def __init__(self, tmp_path, **cfg):
        self.roots = {p: tmp_path / p for p in self.PKGS}
        self.cfg = cfg
        self.ctx = {}
        self.open()

    def open(self, **extra):
        self.ctx = {p: open_ctx(p, self.roots[p], **self.cfg, **extra)
                    for p in self.PKGS}
        return self

    @property
    def j(self):
        return self.ctx["jax"]

    @property
    def t(self):
        return self.ctx["port"]

    def each(self, fn):
        return fn(self.j), fn(self.t)

    def each_pkg(self, fn):
        """``fn(pkg, ctx)`` for both packages."""
        return fn("jax", self.j), fn("port", self.t)

    def stream(self, name, df, **kw):
        out = self.each(lambda c: c.stream_ingest(name, df, **kw))
        self.same_store(name)
        return out

    def sql(self, q, ordered=True):
        j, t = self.each(lambda c: c.sql(q).to_pandas())
        assert_answers_equal(t, j, ordered)
        return t

    def raises(self, exc, fn, match=None):
        for c in (self.j, self.t):
            with pytest.raises(exc, match=match):
                fn(c)

    def same_store(self, *names):
        names = names or tuple(self.j.store.names())
        assert self.t.store.names() == self.j.store.names()
        for n in names:
            assert_same_store(self.j.store.get(n), self.t.store.get(n))
            assert self.t.store.datasource_version(n) \
                == self.j.store.datasource_version(n), n

    def stats(self, key):
        a, b = self.each(lambda c: c.engine.last_stats.get(key))
        return a, b

    def close(self):
        self.each(lambda c: c.close())

    def restart(self, **extra):
        """Abandon the contexts (no checkpoint) and recover both roots."""
        self.close()
        return self.open(**extra)


def _report(ctx):
    """A recovery report without its timings and paths."""
    rep = ctx.persist.recovery_report
    return {"datasources": [{k: v for k, v in d.items()
                             if k != "checksum_verify_ms"}
                            for d in rep["datasources"]],
            "quarantined": [q["version"] for q in rep["quarantined"]],
            "errors": [{k: v for k, v in e.items() if k != "reason"}
                       for e in rep["errors"]],
            "order": rep.get("order")}


def _same_reports(p):
    assert _report(p.t) == _report(p.j)


def _persist_info(p):
    j, t = p.stats("persist")
    drop = ("checksum_verify_ms",)
    assert {k: v for k, v in t.items() if k not in drop} \
        == {k: v for k, v in j.items() if k not in drop}
    assert t["checksum_verify_ms"] >= 0
    return t


# -- the cases of tests/test_persist.py ---------------------------------------

def test_checkpoint_restart_roundtrip(tmp_path):
    p = Pair(tmp_path)
    p.stream("events", _events(), **INGEST)
    want = p.sql(Q)
    sj, st = p.each(lambda c: c.checkpoint("events")[0])
    assert st == sj and st["rows"] == 200 and st["version"] >= 1
    v0 = p.t.store.datasource_version("events")
    p.restart()
    assert_answers_equal(p.sql(Q), want, True)
    p.same_store("events")
    assert p.t.store.datasource_version("events") == v0
    assert _persist_info(p)["source"] == "snapshot"
    p.close()


def test_wal_tail_replayed_after_unclean_shutdown(tmp_path):
    p = Pair(tmp_path)
    p.stream("events", _events(150), **INGEST)
    p.each(lambda c: c.checkpoint("events"))
    p.stream("events", _events(40, seed=11), **INGEST)
    p.stream("events", _events(25, seed=12), **INGEST)
    want = p.sql(Q)
    v_want = p.t.store.datasource_version("events")
    p.open()            # no close, no checkpoint: the WAL tail survives
    assert_answers_equal(p.sql(Q), want, True)
    p.same_store("events")
    assert p.t.store.datasource_version("events") == v_want
    info = _persist_info(p)
    assert info["source"] == "snapshot+wal" and info["wal_records"] == 2
    p.close()


def test_wal_only_recovery_without_snapshot(tmp_path):
    p = Pair(tmp_path)
    p.stream("events", _events(60), **INGEST)
    want = p.sql(Q)
    p.open()
    assert_answers_equal(p.sql(Q), want, True)
    p.same_store("events")
    assert _persist_info(p)["source"] == "wal"
    p.close()


def test_torn_wal_tail_is_tolerated(tmp_path):
    p = Pair(tmp_path)
    p.stream("events", _events(80), **INGEST)
    p.stream("events", _events(20, seed=9), **INGEST)
    want = p.sql(Q)
    paths = {k: os.path.join(c.persist._ds_root("events"), "wal.log")
             for k, c in p.ctx.items()}
    for k, path in paths.items():
        with open(path, "ab") as f:
            f.write(WAL[k]._MAGIC + struct.pack("<I", 40) + b"\x00" * 7)
    p.open()
    assert_answers_equal(p.sql(Q), want, True)
    p.same_store("events")
    _same_reports(p)
    p.close()
    for path in paths.values():
        with open(path, "rb") as f:
            raw = bytearray(f.read())
        raw[-3] ^= 0xFF
        with open(path, "wb") as f:
            f.write(raw)
    p.open()
    got = p.sql(Q)
    assert int(got["n"].sum()) >= 80
    p.same_store("events")
    p.close()


def test_corrupt_snapshot_quarantined_engine_starts(tmp_path):
    p = Pair(tmp_path)
    p.stream("events", _events(100), **INGEST)
    want = p.sql(Q)
    p.each(lambda c: c.checkpoint("events"))
    p.stream("events", _events(10, seed=5), **INGEST)
    p.each(lambda c: c.checkpoint("events"))
    curs = {}
    for k, c in p.ctx.items():
        ds_root = c.persist._ds_root("events")
        cur = curs[k] = SNAP[k].current_version(ds_root)
        vdir = os.path.join(ds_root, SNAP[k].version_dirname(cur))
        blob = next(n for n in sorted(os.listdir(vdir))
                    if n.endswith(".bin"))
        with open(os.path.join(vdir, blob), "r+b") as f:
            f.seek(0)
            f.write(b"\xde\xad\xbe\xef")
    p.close()
    p.open()
    _same_reports(p)
    assert _report(p.t)["quarantined"] == [curs["port"]]
    assert_answers_equal(p.sql(Q), want, True)
    p.same_store("events")
    snaps = p.t.sql("select state from sys_snapshots").to_pandas()
    assert any(s.startswith("quarantined:") for s in snaps["state"])
    qdir = os.path.join(p.t.persist._ds_root("events"), TSNAP.QUARANTINE_DIR)
    assert os.path.isdir(qdir) and len(os.listdir(qdir)) == 1
    p.close()


def _rollup_status(ctx):
    return ctx.history.entries()[-1].stats.get("rollup")


def test_stale_rollup_still_bypassed_after_recovery(tmp_path):
    p = Pair(tmp_path)
    p.stream("events", _events(120), **INGEST)
    p.sql("create rollup ev_cc on events dimensions (country) "
          "aggregations (sum(clicks))")
    p.each(lambda c: c.checkpoint())
    p.stream("events", _events(30, seed=21), **INGEST)
    want = p.sql(Q)
    rv = p.sql("select name, fresh from sys_rollups")
    assert bool(rv.loc[rv["name"] == "ev_cc", "fresh"].iloc[0]) is False
    p.open()
    p.same_store()
    rv = p.sql("select name, fresh from sys_rollups")
    assert bool(rv.loc[rv["name"] == "ev_cc", "fresh"].iloc[0]) is False
    r = p.sql("select country, sum(clicks) as c from events "
              "group by country order by country")
    assert p.each(_rollup_status) == ("base", "base")
    assert_answers_equal(r, want[["country", "c"]], True)
    p.close()


def test_fresh_rollup_recovers_fresh_and_rewrites(tmp_path):
    p = Pair(tmp_path)
    p.stream("events", _events(120), **INGEST)
    p.sql("create rollup ev_cc on events dimensions (country) "
          "aggregations (sum(clicks))")
    p.each(lambda c: c.checkpoint())
    p.restart()
    p.same_store()
    rv = p.sql("select name, fresh from sys_rollups")
    assert bool(rv.loc[rv["name"] == "ev_cc", "fresh"].iloc[0]) is True
    p.sql("select country, sum(clicks) as c from events "
          "group by country order by country")
    assert p.each(_rollup_status) == ("rollup:ev_cc", "rollup:ev_cc")
    p.close()


def test_result_cache_versions_coherent_after_recovery(tmp_path):
    p = Pair(tmp_path, **{"sdot.cache.enabled": True})
    p.stream("events", _events(100), **INGEST)
    p.each(lambda c: c.checkpoint("events"))
    want = p.sql(Q)
    p.restart()
    assert_answers_equal(p.sql(Q), want, True)
    assert_answers_equal(p.sql(Q), want, True)      # the cache hit path
    assert p.stats("cache") == ("hit", "hit")
    p.stream("events", _events(10, seed=30), **INGEST)
    assert int(p.sql(Q)["n"].sum()) == 110
    p.close()


def test_checkpoint_restore_sql_and_purge(tmp_path):
    p = Pair(tmp_path)
    p.stream("events", _events(50), **INGEST)
    st = p.sql("checkpoint events")
    assert "checkpointed events" in st["status"][0]
    want = p.sql(Q)
    p.each(lambda c: c.store.drop("events"))
    st = p.sql("restore events")
    assert "restored events" in st["status"][0]
    assert_answers_equal(p.sql(Q), want, True)
    p.same_store("events")
    p.sql("clear metadata")
    for r in p.roots.values():
        assert os.path.isdir(os.path.join(r, "events"))
    p.sql("restore")
    assert_answers_equal(p.sql(Q), want, True)
    p.same_store("events")
    p.sql("clear metadata purge")
    for r in p.roots.values():
        assert not os.path.isdir(os.path.join(r, "events"))
    p.raises(KeyError, lambda c: c.sql("restore events"))
    p.close()


def test_rejected_batch_never_poisons_wal(tmp_path):
    p = Pair(tmp_path)
    p.stream("events", _events(100), **INGEST)
    bad = _events(10, seed=7)
    bad["surprise"] = 1
    p.raises(ValueError, lambda c: c.stream_ingest("events", bad, **INGEST),
             match="surprise")
    p.stream("events", _events(50, seed=8), **INGEST)
    want = p.sql(Q)
    assert int(want["n"].sum()) == 150
    p.restart()
    got = p.sql(Q)
    assert int(got["n"].sum()) == 150
    assert_answers_equal(got, want, True)
    p.same_store("events")
    assert p.t.persist.recovery_report["errors"] == []
    p.close()


def test_replay_skips_poisoned_record(tmp_path):
    p = Pair(tmp_path)
    p.stream("events", _events(80), **INGEST)
    p.stream("events", _events(20, seed=6), **INGEST)
    paths = {k: os.path.join(c.persist._ds_root("events"), "wal.log")
             for k, c in p.ctx.items()}
    p.close()
    bad = _events(10, seed=7)
    bad["surprise"] = 1
    for k, path in paths.items():
        w = WAL[k].WriteAheadLog(path)
        w.append_group({"seq": 3, "datasource": "events",
                        "kind": "append", "kwargs": {}},
                       WAL[k].encode_batch(bad))
        w.append_group({"seq": 4, "datasource": "events",
                        "kind": "append", "kwargs": {}},
                       WAL[k].encode_batch(_events(15, seed=8)))
        w.close()
    assert filecmp.cmp(paths["jax"], paths["port"], shallow=False)
    p.open()
    got = p.sql(Q)
    assert int(got["n"].sum()) == 80 + 20 + 15
    p.same_store("events")
    _same_reports(p)
    assert any(e.get("seq") == 3
               for e in p.t.persist.recovery_report["errors"])
    p.close()


def test_restore_wal_only_does_not_duplicate(tmp_path):
    p = Pair(tmp_path)
    p.stream("events", _events(60), **INGEST)
    want = p.sql(Q)
    assert int(want["n"].sum()) == 60
    p.sql("restore events")
    got = p.sql(Q)
    assert int(got["n"].sum()) == 60
    assert_answers_equal(got, want, True)
    p.same_store("events")
    p.stream("events", _events(10, seed=13), **INGEST)
    assert int(p.sql(Q)["n"].sum()) == 70
    p.close()


def test_recreate_after_clear_fences_old_state(tmp_path):
    p = Pair(tmp_path)
    p.stream("events", _events(100), **INGEST)
    p.each(lambda c: c.checkpoint("events"))
    p.sql("clear metadata events")
    p.stream("events", _events(30, seed=9), **INGEST)
    want = p.sql(Q)
    assert int(want["n"].sum()) == 30
    p.restart()
    got = p.sql(Q)
    assert int(got["n"].sum()) == 30
    assert_answers_equal(got, want, True)
    p.same_store("events")
    for r in p.roots.values():
        assert len([n for n in os.listdir(r)
                    if n.startswith(".dropped-")]) == 1
    p.sql("clear metadata purge")
    for r in p.roots.values():
        assert [n for n in os.listdir(r) if n.startswith(".dropped-")] == []
    p.close()


def test_republish_never_replaces_version_dir(tmp_path):
    p = Pair(tmp_path, **{"sdot.persist.keep.snapshots": 4})
    p.stream("events", _events(40), **INGEST)
    for k, c in p.ctx.items():
        c.checkpoint("events")
        root = c.persist._ds_root("events")
        v1 = SNAP[k].current_version(root)
        c.checkpoint("events")
        v2 = SNAP[k].current_version(root)
        assert v2 == v1 + 1
        assert SNAP[k].list_versions(root) == [v1, v2]
        assert (SNAP[k].load_manifest(root, v2)["ingest_version"]
                == SNAP[k].load_manifest(root, v1)["ingest_version"])
    p.close()


def test_persist_disabled_statements_error():
    for ctx in (jsdot.Context(), tsdot.Context(device="cpu")):
        ctx.ingest_dataframe("events", _events(20), **INGEST)
        with pytest.raises(RuntimeError, match="sdot.persist.path"):
            ctx.sql("checkpoint events")
        with pytest.raises(RuntimeError, match="sdot.persist.path"):
            ctx.sql("restore")
        with pytest.raises(RuntimeError, match="sdot.persist.path"):
            ctx.checkpoint()
        snaps = ctx.sql("select * from sys_snapshots").to_pandas()
        assert len(snaps) == 0
        assert ctx.persist is None
        ctx.close()
        ctx.close()          # idempotent


def test_snapshot_pruning_keeps_n(tmp_path):
    p = Pair(tmp_path, **{"sdot.persist.keep.snapshots": 2})
    p.stream("events", _events(30), **INGEST)
    for s in (41, 42, 43):
        p.each(lambda c: c.checkpoint("events"))
        p.stream("events", _events(5, seed=s), **INGEST)
    p.each(lambda c: c.checkpoint("events"))
    for k, c in p.ctx.items():
        assert len(SNAP[k].list_versions(c.persist._ds_root("events"))) == 2
    p.close()


def test_catalog_restores_stars_and_lookups(tmp_path):
    from spark_druid_olap_tpu.metadata import star as JST
    from spark_druid_olap_tpu_torch.metadata import star as TST
    p = Pair(tmp_path)
    p.stream("events", _events(40), **INGEST)
    for k, c in p.ctx.items():
        st = JST if k == "jax" else TST
        c.register_lookup("cc", {"US": "United States", "DE": "Germany"})
        c.register_star_schema(st.StarSchema(
            "fact", "events",
            [st.StarRelation("fact", "dim_c", (("country", "c_key"),))]))
    p.each(lambda c: c.checkpoint())
    cats = [json.load(open(os.path.join(r, "catalog.json")))
            for r in p.roots.values()]
    for c in cats:
        c.pop("warmup"), c.pop("written_at")
    assert cats[0] == cats[1]
    p.restart()
    for c in (p.j, p.t):
        assert c.lookups["cc"]["DE"] == "Germany"
        star = c.catalog.star_schemas["fact"]
        assert star.flat_datasource == "events"
        assert star.relations[0].join_columns == (("country", "c_key"),)
    p.close()


def test_background_checkpointer_runs(tmp_path):
    """The background pass checkpoints a dirty datasource: waited for on
    an event that the checkpoint sets when it returns (the datasource is
    clean by then), with a deadline, in both packages."""
    p = Pair(tmp_path, **{"sdot.persist.checkpoint.interval.seconds": 0.05})
    done = {}
    for k, c in p.ctx.items():
        ev = done[k] = threading.Event()
        real = c.persist.checkpoint

        def checkpoint(name, real=real, ev=ev):
            out = real(name)
            if name == "events":
                ev.set()
            return out
        c.persist.checkpoint = checkpoint
    p.stream("events", _events(30), **INGEST)
    for k, c in p.ctx.items():
        assert done[k].wait(timeout=30.0), f"{k}: no background checkpoint"
        assert SNAP[k].current_version(c.persist._ds_root("events")) >= 1
        assert "events" not in c.persist._dirty
        assert c.persist.stats()["background"]["running"]
    p.close()
    for c in (p.j, p.t):
        assert not c.persist.stats()["background"]["running"]


def test_warmup_order_hot_datasource_first(tmp_path):
    p = Pair(tmp_path)
    p.stream("aaa", _events(20, seed=1), **INGEST)
    p.stream("zzz", _events(20, seed=2), **INGEST)
    p.sql("select count(*) from zzz")
    p.each(lambda c: c.checkpoint())
    p.restart()
    order = p.t.persist.recovery_report["order"]
    assert order == p.j.persist.recovery_report["order"]
    assert order.index("zzz") < order.index("aaa")
    p.same_store()
    p.close()


# -- roots across packages ----------------------------------------------------

def _journaled_root(pkg, root, encode):
    """A checkpointed store with a journaled tail past the snapshot and a
    rollup in the catalog; returns its answers and versions."""
    ctx = open_ctx(pkg, root, **{"sdot.encode.enabled": encode})
    ctx.stream_ingest("events", _events(300), **INGEST)
    ctx.stream_ingest("events", _events(80, seed=4), **INGEST)
    ctx.sql("create rollup ev_cc on events dimensions (country) "
            "aggregations (sum(clicks))")
    ctx.checkpoint()
    ctx.stream_ingest("events", _events(40, seed=5), **INGEST)
    ctx.stream_ingest("events", _events(25, seed=6), **INGEST)
    out = (ctx.sql(Q).to_pandas(),
           {n: ctx.store.datasource_version(n) for n in ctx.store.names()})
    ctx.close()
    return out


@pytest.mark.parametrize("encode", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_root_recovers_in_the_other_package(tmp_path, writer, encode):
    """A root written by one package (snapshot, WAL tail, catalog)
    recovers in both with the same store, versions, rollups and answers."""
    want, versions = _journaled_root(writer, tmp_path, encode)
    j, t = open_ctx("jax", tmp_path), open_ctx("port", tmp_path)
    try:
        for c in (j, t):
            assert c.store.names() == sorted(versions)
            assert {n: c.store.datasource_version(n)
                    for n in c.store.names()} == versions
        for n in versions:
            assert_same_store(j.store.get(n), t.store.get(n))
        assert t.store.recovery_info["events"]["source"] == "snapshot+wal"
        assert sorted(t.rollups) == sorted(j.rollups) == ["ev_cc"]
        assert_answers_equal(t.sql(Q).to_pandas(), want, True)
        assert_answers_equal(j.sql(Q).to_pandas(), want, True)
        rj, rt = (c.sql("select name, fresh from sys_rollups").to_pandas()
                  for c in (j, t))
        assert_answers_equal(rt, rj, True)
    finally:
        j.close()
        t.close()


@pytest.mark.parametrize("encode", [False, True])
def test_snapshot_blobs_byte_identical(tmp_path, encode):
    """For one store, both packages publish the same blob bytes and the
    same manifest but its ``created_at``."""
    from conftest import make_sales_df
    p = Pair(tmp_path, **{"sdot.encode.enabled": encode})
    df = make_sales_df(6000)
    p.each(lambda c: c.ingest_dataframe("sales", df, time_column="ts",
                                        target_rows=2048))
    p.stream("sales", make_sales_df(900, seed=3), time_column="ts")
    p.each(lambda c: c.checkpoint("sales"))
    mans, vdirs = {}, {}
    for k, c in p.ctx.items():
        root = c.persist._ds_root("sales")
        v = SNAP[k].current_version(root)
        mans[k] = SNAP[k].load_manifest(root, v)
        vdirs[k] = os.path.join(root, SNAP[k].version_dirname(v))
    for m in mans.values():
        m.pop("created_at")
    assert mans["port"] == mans["jax"]
    assert ("encoding" in mans["port"]) == encode
    files = sorted(mans["port"]["files"])
    assert sorted(os.listdir(vdirs["port"])) \
        == sorted(files + ["manifest.json"])
    match, mismatch, errors = filecmp.cmpfiles(
        vdirs["jax"], vdirs["port"], files, shallow=False)
    assert mismatch == [] and errors == [] and match == files
    p.close()


# -- what the port leaves out -------------------------------------------------

def test_unported_branches_raise_a9(tmp_path):
    """The tiered store (with a persist path) recovers tiered
    datasources and ``tier_io_budget`` reads ``sdot.tier.wave.io.bytes``
    over them, as in the JAX package; a tiered shard slice (a cluster
    historical's boot) and the cluster push still raise, naming ROADMAP
    A.9."""
    from spark_druid_olap_tpu.parallel import cost as jcost
    from spark_druid_olap_tpu_torch.parallel import cost
    from spark_druid_olap_tpu_torch.tier.handles import TieredDatasource
    from spark_druid_olap_tpu_torch.tier.loader import slice_tiered
    seed = open_ctx("port", tmp_path / "tiered")
    seed.stream_ingest("events", _events(50), **INGEST)
    seed.checkpoint()
    seed.close()
    tiered = {pkg: open_ctx(pkg, tmp_path / "tiered",
                            **{"sdot.tier.enabled": True})
              for pkg in ("jax", "port")}
    ds = tiered["port"].store.get("events")
    assert isinstance(ds, TieredDatasource)
    mod = {"jax": jcost, "port": cost}
    for io in (None, 0, 4096):
        got = {}
        for pkg, c in tiered.items():
            if io is not None:
                c.config.set("sdot.tier.wave.io.bytes", io)
            got[pkg] = mod[pkg].tier_io_budget(
                c.store.get("events"), c.config)
        assert got["port"] == got["jax"] \
            == {None: 256 << 20, 0: None, 4096: 4096}[io]
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.9"):
        slice_tiered(ds, [0])
    for c in tiered.values():
        c.close()
    ctx = open_ctx("port", tmp_path, **{"sdot.cluster.nodes": "localhost:1"})
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.9"):
        ctx.stream_ingest("events", _events(10), **INGEST)
    ctx.close()


@pytest.mark.parametrize("key", [
    "sdot.persist.enabled", "sdot.persist.recover.on.start",
    "sdot.persist.wal.fsync", "sdot.persist.wal.group.commit"])
@pytest.mark.parametrize("off", [False, "false"])
def test_durability_switches_refused_off(tmp_path, key, off):
    """The port persists whenever ``sdot.persist.path`` is set, recovers
    at start and fsyncs every batch through group commit: each switch is
    accepted at its default and refused at any other value, before the
    persist root is made."""
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        open_ctx("port", tmp_path / "off", **{key: off})
    assert not (tmp_path / "off").exists()
    ctx = open_ctx("port", tmp_path / "on", **{key: True})
    ctx.stream_ingest("events", _events(10), **INGEST)
    assert ctx.persist.stats()["groupCommit"] == {
        "enabled": True, "commits": 1, "frames": 1}
    ctx.close()
    again = open_ctx("port", tmp_path / "on")
    assert again.store.get("events").num_rows == 10
    again.close()
