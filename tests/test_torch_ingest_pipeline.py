"""The port's crash-safe ingest pipeline against the JAX package's.

Cases :46, :106, :170 and :217 of ``tests/test_ingest_pipeline.py``: a
group-committed WAL under torn frames and failed covering fsyncs,
compaction racing live stream ingest, rollup staleness across a
generation swap, and a port broker's stream ingest across an epoch swap
to a third port historical. The bar is the reference's: the
served rows are exactly the acknowledged batches, live and after recovery
— an acked batch is never lost, an un-acked one never surfaces.

One departure is checked here rather than against the JAX package's
counter: the port's WAL counts a group commit only when a frame of it was
written, so ``commits <= frames`` always holds. The JAX test reaches a
group whose only frame tore through thread timing, and then fails its
``commits <= frames`` now and then; the port's copy forces that group with
a scoped ``count`` rule on one producer.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import json
import threading

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.fault import FaultInjected

from conftest import assert_frames_equal
from test_torch_persist import Pair, open_ctx
from test_torch_sql import assert_answers_equal


def _batch(key: str, n=40, day="2024-01-01") -> pd.DataFrame:
    return pd.DataFrame({
        "t": pd.to_datetime(day),
        "k": [key] * n,
        "v": np.arange(n, dtype=np.int64)})


def _keys(ctx, name="ev"):
    return sorted(set(ctx.sql(f"select k from {name}").data["k"].tolist()))


def _count(ctx, name="ev"):
    return int(ctx.sql(f"select count(*) as n from {name}").data["n"][0])


def _group(ctx):
    return ctx.persist.stats()["groupCommit"]


# -- (a) torn group commit: exactly the acked prefix survives -----------------

def test_torn_alone_group_counts_no_commit(tmp_path):
    """A group whose only frame tears (forced: one producer, a scoped
    ``count`` rule) writes nothing: the port counts no commit for it. A
    failed covering fsync un-acks its whole group and counts none either.
    Both packages serve, live and after recovery, exactly the acked
    batches."""
    plan = json.dumps({"seed": 3, "rules": [
        {"site": "wal.append", "action": "truncate", "arg": 9,
         "count": 1, "scope": "torn"},
        {"site": "wal.group_commit", "action": "error", "count": 1,
         "scope": "fsync"}]})
    p = Pair(tmp_path, **{"sdot.fault.plan": plan})
    p.stream("ev", _batch("a"), time_column="t")
    before = _group(p.t)
    assert before == {"enabled": True, "commits": 1, "frames": 1}
    for scope, exc in (("torn", "OSError"), ("fsync", "FaultInjected")):
        for c in (p.j, p.t):
            with c.engine.fault.scope(scope):
                with pytest.raises(Exception, match="fault-injected") as e:
                    c.stream_ingest("ev", _batch(f"x-{scope}"),
                                    time_column="t")
            assert type(e.value).__name__ == exc
        assert _group(p.t) == before, scope
    p.stream("ev", _batch("b"), time_column="t")
    gc = _group(p.t)
    assert gc["commits"] == gc["frames"] == 2
    for c in (p.j, p.t):
        assert _keys(c) == ["a", "b"] and _count(c) == 80
    p.restart()
    p.same_store("ev")
    for c in (p.j, p.t):
        assert _keys(c) == ["a", "b"] and _count(c) == 80
    p.close()


def test_torn_group_commit_recovers_exactly_acked(tmp_path):
    """Four producers share covering fsyncs; injected covering-fsync
    failures un-ack whole batches and a torn write un-acks one frame.
    Live state and recovery (in both packages) serve exactly the acked
    set, and the port's counters keep ``1 <= commits <= frames``."""
    root = tmp_path / "port"
    ctx = open_ctx("port", root, **{
        "sdot.persist.enabled": True,
        "sdot.fault.plan": json.dumps({"seed": 7, "rules": [
            {"site": "wal.group_commit", "action": "error",
             "count": 2, "after": 1, "scope": "gc"},
            {"site": "wal.append", "action": "truncate", "arg": 9,
             "count": 1, "after": 4, "scope": "gc"}]})})
    acked, lock = set(), threading.Lock()

    def producer(tid):
        for b in range(6):
            key = f"p{tid}b{b}"
            try:
                ctx.stream_ingest("ev", _batch(key), time_column="t")
                with lock:
                    acked.add(key)
            except (FaultInjected, OSError):
                pass

    with ctx.engine.fault.scope("gc"):
        ths = [threading.Thread(target=producer, args=(i,))
               for i in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
    fired = ctx.engine.fault.stats()["by_site"]
    assert fired.get("wal.group_commit") == 2
    assert fired.get("wal.append") == 1
    assert 0 < len(acked) < 24
    assert _keys(ctx) == sorted(acked)
    assert _count(ctx) == 40 * len(acked)
    gc = _group(ctx)
    assert gc["enabled"] and gc["frames"] == len(acked)
    assert 1 <= gc["commits"] <= gc["frames"]
    ctx.close()
    for pkg in ("jax", "port"):
        again = open_ctx(pkg, root)
        try:
            assert _keys(again) == sorted(acked)
            assert _count(again) == 40 * len(acked)
        finally:
            again.close()


# -- (b) compaction racing live stream ingest ---------------------------------

def test_compaction_races_live_ingest_differential(tmp_path):
    """Producers stream batches while the compactor repeatedly rolls the
    tail into time-partitioned generations, in each package. Every row
    survives with identical aggregates, live and after recovery, and the
    swaps never move the ingest version."""
    q = "select k, sum(v) as s, count(*) as n from ev group by k order by k"
    want = pd.DataFrame({
        "k": sorted(f"p{t}b{b}" for t in range(3) for b in range(8)),
        "s": np.int64(np.arange(40).sum()),
        "n": np.int64(40)})
    got = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        ctx = open_ctx(pkg, root, **{"sdot.persist.enabled": True,
                                     "sdot.cache.enabled": False})
        stop = threading.Event()
        compactions = []

        def producer(tid, ctx=ctx):
            for b in range(8):
                ctx.stream_ingest(
                    "ev", _batch(f"p{tid}b{b}", day=f"2024-01-{28 - b:02d}"),
                    time_column="t", target_rows=64)

        def compactor(ctx=ctx, stop=stop, compactions=compactions):
            while not stop.is_set():
                compactions.extend(ctx.persist.compact("ev"))

        ths = [threading.Thread(target=producer, args=(i,))
               for i in range(3)]
        ct = threading.Thread(target=compactor)
        ct.start()
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        stop.set()
        ct.join()
        ver = ctx.store.datasource_version("ev")
        compactions.extend(ctx.persist.compact("ev"))
        assert compactions, f"{pkg}: forced compaction never engaged"
        assert ctx.store.datasource_version("ev") == ver
        got[pkg] = ctx.sql(q).to_pandas()
        assert_frames_equal(got[pkg], want)
        ds = ctx.store.get("ev")
        assert len(ds.segments) < 24
        millis = (ds.time.days.astype(np.int64) * 86_400_000
                  + ds.time.ms_in_day.astype(np.int64))
        assert bool(np.all(np.diff(millis) >= 0))
        ctx.close()
        again = open_ctx(pkg, root, **{"sdot.cache.enabled": False})
        assert_frames_equal(again.sql(q).to_pandas(), want)
        again.close()
    assert_answers_equal(got["port"], got["jax"], True)


# -- (c) rollup staleness across a generation swap ----------------------------

def test_rollup_staleness_survives_generation_swap(tmp_path):
    """A compaction swap registers no ingest event: a fresh rollup stays
    fresh (and serves the rewrite), a stale one stays stale, in both
    packages alike, with the same stores after every step."""
    p = Pair(tmp_path, **{"sdot.persist.enabled": True,
                          "sdot.cache.enabled": False})
    for b in range(6):
        p.stream("ev", _batch(f"b{b}", day=f"2024-01-{b + 1:02d}"),
                 time_column="t", target_rows=64)
    p.sql("create rollup kcube on ev dimensions (k) "
          "aggregations (sum(v), count(*)) granularity day")
    q = "select k, sum(v) as s from ev group by k order by k"

    def status():
        a, b = p.each(lambda c: c.history.entries()[-1].stats.get("rollup"))
        assert a == b
        return b

    fresh = p.sql(q)
    assert status() == "rollup:kcube"
    rj, rt = p.each(lambda c: c.persist.compact("ev"))
    assert rt and rt == rj
    p.same_store()
    assert_answers_equal(p.sql(q), fresh, True)
    assert status() == "rollup:kcube"
    p.stream("ev", _batch("b6", day="2024-01-07"), time_column="t",
             target_rows=64)
    after = p.sql(q)
    assert status() == "base"
    assert len(after) == len(fresh) + 1
    for _ in range(3):
        p.stream("ev", _batch("b6", day="2024-01-07"), time_column="t",
                 target_rows=64)
    rj, rt = p.each(lambda c: c.persist.compact("ev"))
    assert rt and rt == rj
    p.same_store()
    got = p.sql(q)
    assert status() == "base"
    assert_frames_equal(got[got["k"] != "b6"].reset_index(drop=True), fresh)
    p.close()


def test_compaction_padded_rows_drop(tmp_path):
    """Appended batches are padded to the largest segment; compaction
    rewrites them into full segments: fewer padded rows, the same rows."""
    ctx = tsdot.Context({"sdot.persist.path": str(tmp_path)}, device="cpu")
    ctx.stream_ingest("ev", _batch("base", n=4000), time_column="t",
                      target_rows=4096)
    for b in range(6):
        ctx.stream_ingest("ev", _batch(f"a{b}", n=300,
                                       day=f"2024-01-{b + 2:02d}"),
                          time_column="t", target_rows=4096)
    ds = ctx.store.get("ev")
    before = ds.num_segments * ds.padded_rows
    (r,) = ctx.persist.compact("ev", target_rows=4096)
    ds2 = ctx.store.get("ev")
    assert r["segments_before"] == 7 and r["segments_after"] == 2
    assert ds2.num_rows == ds.num_rows == 5800
    assert ds2.num_segments * ds2.padded_rows < before
    assert _count(ctx) == 5800
    ctx.close()


# -- (d) cluster ingest across an epoch swap mid-write ------------------------

def test_cluster_ingest_survives_epoch_swap(tmp_path):
    """Broker-side stream ingest keeps acking while the topology rolls to
    a new epoch; every acked batch is servable afterwards (the swap voids
    owner confirmations, never the broker's own journal). Port members
    throughout. The JAX case waits on sleeps and fails now and then;
    here nothing waits on time: the watcher and the prober are off, the
    test runs every member's ``check_epoch`` itself, and every wait is a
    poll of a condition with a deadline."""
    import time

    from spark_druid_olap_tpu_torch.cluster import epoch as EPO
    from test_torch_cluster import (free_port, port_broker,
                                    restart_on_same_port, start_historicals,
                                    wait_until)

    root = str(tmp_path / "p")
    seed = open_ctx("port", root)
    for b in range(4):
        seed.stream_ingest("ev", _batch(f"seed{b}",
                                        day=f"2024-01-{b + 1:02d}"),
                           time_column="t", target_rows=32)
    seed.checkpoint()
    seed.close()

    common = {"sdot.persist.path": root,
              "sdot.cluster.replication": 2,
              "sdot.cluster.shards": 2,
              "sdot.cluster.epoch.poll.seconds": 0,
              "sdot.cluster.epoch.drain.grace.seconds": 0.05,
              "sdot.cluster.retry.backoff.start.seconds": 0.01,
              "sdot.cache.enabled": False}
    csv2, hists = start_historicals(common, n=2, list_size=2)
    broker = None
    try:
        broker = port_broker(root, csv2, **{
            **common, "sdot.cluster.probe.interval.seconds": 0})
        # the third member's address is picked now; it starts once the
        # epoch that adds it is published
        addr3 = f"127.0.0.1:{free_port()}"

        acked, lock = [], threading.Lock()
        stop = threading.Event()
        errors = []

        def producer():
            b = 0
            try:
                while (not stop.is_set() or b < 6) and b < 40:
                    key = f"live{b}"
                    broker.stream_ingest(
                        "ev", _batch(key,
                                     day=f"2024-02-{(b % 27) + 1:02d}"),
                        time_column="t", target_rows=32)
                    with lock:
                        acked.append(key)
                    b += 1
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        th = threading.Thread(target=producer)
        th.start()
        try:
            # a few pre-swap batches land (and get pushed to owners)
            assert wait_until(lambda: len(acked) >= 3, 30.0)
            rec = EPO.publish_epoch(root, csv2.split(",") + [addr3],
                                    note="scale-out")
            hists.append(restart_on_same_port(
                "port", {**common, "sdot.cluster.nodes": ",".join(
                    rec.nodes)}, 2))

            def swapped():
                for h in hists:
                    h.check_epoch()
                broker.cluster.check_epoch()
                return broker.cluster.stats()["epoch"]["active"] \
                    == rec.epoch
            assert wait_until(swapped, 30.0)
            # batches keep landing after the swap too
            n_swap = len(acked)
            assert wait_until(lambda: len(acked) >= n_swap + 2 or
                              not th.is_alive(), 30.0)
        finally:
            stop.set()
            th.join(60)
        assert not errors, errors[:1]
        assert not th.is_alive()

        # every acked batch — before, during, and after the swap — is
        # servable with exact aggregates
        q = ("select k, sum(v) as s, count(*) as n from ev "
             "group by k order by k")
        keys = sorted([f"seed{b}" for b in range(4)] + sorted(set(acked)))
        want = pd.DataFrame({
            "k": keys,
            "s": np.int64(np.arange(40).sum()),
            "n": np.int64(40)})
        assert_frames_equal(broker.sql(q).to_pandas(), want)
        st = broker.engine.last_stats.get("cluster") or {}
        assert st.get("mode") in ("scatter", "local"), st
        ing = broker.cluster.stats()["ingest"]
        assert ing["push_enabled"]
        assert broker.cluster.counters["ingest_pushes"] >= 1
        assert broker.cluster.counters["epoch_swaps"] == 1
    finally:
        for h in hists:
            h.stop()
        if broker is not None:
            broker.close()
