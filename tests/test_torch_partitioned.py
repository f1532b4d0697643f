"""The port's partitioned join tier (``join/partitioned.py``) against the
JAX package's.

The exchange's functions through both packages on the same inputs, made
from seeds with numpy: ``partition_ids`` over every key dtype (int32,
int64, float32, float64, strings, ``None`` and NaN) for 1, 2, 3 and 7
partitions; ``partition_request`` on the same shard of a port historical
and of a JAX historical, byte for byte; ``exec_request`` on the SDJ1
frames a port broker sent (grouped, ungrouped, a residual, avg, null keys,
an empty side), byte for byte where the partials hold no float sum. A
partial float sum is the one deliberate departure (ROADMAP §C): the port
accumulates it in float64, the JAX package in float32, so those cells are
held at rtol 1e-6 against the JAX package's and at rtol 1e-12 against a
float64 pandas merge of the frame's two sides. ``join_estimate`` gives the
JAX package's mode, reason, costs and bytes for 0-3 cluster nodes, under
and over the broadcast cap, in every forced mode.

Above them the cluster: JAX ``tests/test_join.py``'s three partitioned
tests over a port broker and two port historicals on the CPU, on JAX's own
frames; a port broker over JAX historicals and a JAX broker over port
historicals answer JAX's four parity statements in mode ``partitioned``
as the single context's broadcast does (dimensions and integers exact,
floats rtol 1e-6: a JAX node's partials sum float32); the exec hop probes
on the node's device; and with one historical stopped the broker falls
back to its local broadcast join, with the same answer and the fallback in
its stats. Clusters are module fixtures; historicals start again on
``EADDRINUSE`` (``test_torch_cluster.start_historicals``).
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import json

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.cluster import wire as JWIRE
from spark_druid_olap_tpu.join import partitioned as JPT
from spark_druid_olap_tpu.parallel import cost as JC

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.cluster import wire as WIRE
from spark_druid_olap_tpu_torch.cluster.assign import shard_name
from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ir import serde as SERDE
from spark_druid_olap_tpu_torch.join import partitioned as TPT
from spark_druid_olap_tpu_torch.ops import hash_join as THJ
from spark_druid_olap_tpu_torch.parallel import cost as TC

from conftest import assert_frames_equal
from test_join import _PARITY_QUERIES, _events_df, _fact_df, _users_df
from test_torch_cluster import restart_on_same_port, start_historicals, \
    wait_until

PART = {"sdot.join.mode": "partitioned"}


# -- the partition hash --------------------------------------------------------

def _keys(kind: str, n: int = 500, seed: int = 3):
    r = np.random.default_rng(seed)
    ints = r.integers(-50, 2000, n)
    if kind in ("int32", "int64"):
        return ints.astype(kind)
    if kind in ("float32", "float64"):
        v = (ints / 4).astype(kind)
        v[r.random(n) < 0.1] = np.nan
        return v
    words = np.array(["US", "DE", "JP", "BR", "IN", "Zürich", ""])
    v = r.choice(words, n).astype(object)
    if kind == "str_none":
        v[r.random(n) < 0.1] = None
    return v


KINDS = ["int32", "int64", "float32", "float64", "str", "str_none"]


@pytest.mark.parametrize("n_parts", [1, 2, 3, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_partition_ids_equal_the_jax_package(kind, n_parts):
    k = _keys(kind)
    got = TPT.partition_ids([k], n_parts)
    np.testing.assert_array_equal(got, JPT.partition_ids([k], n_parts))
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < n_parts
    two = [k, _keys("int64", seed=4)]
    np.testing.assert_array_equal(TPT.partition_ids(two, n_parts),
                                  JPT.partition_ids(two, n_parts))


@pytest.mark.parametrize("n_parts", [2, 3, 7])
def test_equal_keys_meet_across_dtypes(n_parts):
    """An int32 probe key, an int64 and a float64 build key of equal value
    land in one partition (the hash goes through float64)."""
    k = _keys("int32")
    want = TPT.partition_ids([k], n_parts)
    for other in (k.astype(np.int64), k.astype(np.float64),
                  k.astype(np.float32)):
        np.testing.assert_array_equal(TPT.partition_ids([other], n_parts),
                                      want)


# -- the cost model ------------------------------------------------------------

@pytest.fixture(scope="module")
def estimate_sides():
    out = {}
    for pkg, mod in (("jax", jsdot), ("port", tsdot)):
        ctx = mod.Context() if pkg == "jax" else mod.Context(device="cpu")
        ctx.ingest_dataframe("fact", _fact_df(), time_column="ts",
                             target_rows=1024)
        ctx.ingest_dataframe("users", _users_df(), time_column="ts",
                             target_rows=64)
        out[pkg] = ctx
    return out


@pytest.mark.parametrize("mode", ["auto", "broadcast", "partitioned", "host"])
@pytest.mark.parametrize("cap", [1 << 20, 512])
@pytest.mark.parametrize("nodes", [0, 1, 2, 3])
def test_join_estimate_equals_the_jax_package(estimate_sides, nodes, cap,
                                              mode):
    got = {}
    for pkg, mod in (("jax", JC), ("port", TC)):
        ctx = estimate_sides[pkg]
        conf = ctx.config.__class__({"sdot.join.broadcast.max.bytes": cap,
                                     "sdot.join.mode": mode})
        got[pkg] = mod.join_estimate(
            conf, probe_ds=ctx.store.get("fact"),
            build_ds=ctx.store.get("users"),
            probe_cols=["amount", "qty", "user_id"],
            build_cols=["segment_name", "user_id"], cluster_nodes=nodes)
    t, j = got["port"], got["jax"]
    for f in ("mode", "reason", "probe_bytes", "build_bytes",
              "shuffle_bytes", "broadcast_cost", "partitioned_cost"):
        assert getattr(t, f) == getattr(j, f), (f, t, j)
    assert t.table() == j.table()
    if mode == "auto":
        assert t.mode == ("partitioned" if cap == 512 and nodes > 1 else
                          "host" if cap == 512 else "broadcast"), t


# -- an in-process cluster of each package over one root -----------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("partitioned-deep-storage"))
    seed = tsdot.Context({"sdot.persist.path": path}, device="cpu")
    seed.ingest_dataframe("fact", _fact_df(), time_column="ts",
                          target_rows=1024)
    seed.ingest_dataframe("users", _users_df(), time_column="ts",
                          target_rows=64)
    seed.ingest_dataframe("events", _events_df(), time_column="ts",
                          target_rows=1024)
    seed.checkpoint()
    seed.close()
    return path


@pytest.fixture(scope="module")
def clusters(root):
    """Two port historicals and two JAX historicals over ``root``; a port
    broker over each set and a JAX broker over the port set, all forced
    partitioned; the port's single context over the same root."""
    common = {"sdot.persist.path": root}
    tcsv, thist = start_historicals(common, n=2, pkg="port")
    jcsv, jhist = start_historicals(common, n=2, pkg="jax")

    def port_broker(csv):
        return tsdot.Context({**common, **PART, "sdot.cluster.nodes": csv,
                              "sdot.cluster.role": "broker"}, device="cpu")
    out = {
        "thist": thist, "jhist": jhist, "tcsv": tcsv,
        "broker": port_broker(tcsv),
        "port_over_jax": port_broker(jcsv),
        "jax_over_port": jsdot.Context({
            **common, **PART, "sdot.cluster.nodes": tcsv,
            "sdot.cluster.role": "broker"}),
        "single": tsdot.Context(common, device="cpu"),
    }
    for h in thist + jhist:
        assert wait_until(lambda h=h: h.ready, 30.0), "historical not ready"
    yield out
    for h in thist + jhist:
        h.stop()
    for k in ("broker", "port_over_jax", "jax_over_port", "single"):
        out[k].close()


def same_answer(got, want, rtol, ordered=True):
    """Two answers to one statement: columns and rows alike, dimensions
    and integers exact, floats within ``rtol``. An integer sum is int64
    on the partitioned tier and float64 on the broadcast tier in both
    packages, so an int column against a float one compares exactly as
    numbers."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    if not ordered:
        keys = [c for c in want.columns if want[c].dtype.kind in "OUSb"]
        got = got.sort_values(keys).reset_index(drop=True)
        want = want.sort_values(keys).reset_index(drop=True)
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        kinds = {g.dtype.kind, w.dtype.kind}
        if kinds <= set("iuf") and "f" in kinds and kinds != {"f"}:
            np.testing.assert_array_equal(g.astype(np.float64),
                                          w.astype(np.float64), err_msg=c)
        elif "f" in kinds:
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), rtol=rtol,
                                       atol=0, err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


def _run(ctx, sql):
    return ctx.sql(sql).to_pandas(), ctx.engine.last_stats.get("join")


def _host(ctx, sql):
    ctx.config.set("sdot.join.enabled", False)
    try:
        return ctx.sql(sql).to_pandas()
    finally:
        ctx.config.set("sdot.join.enabled", True)


# JAX tests/test_join.py:336-370, over the port's cluster

def test_partitioned_matches_broadcast_and_host(clusters):
    broker, single = clusters["broker"], clusters["single"]
    for q in _PARITY_QUERIES:
        part, pjs = _run(broker, q)
        assert pjs is not None and pjs["mode"] == "partitioned", (q, pjs)
        assert pjs["shuffle_bytes"] > 0
        assert pjs["partitions"] == 2 and pjs["nodes"] == 2
        bc, bjs = _run(single, q)
        assert bjs is not None and bjs["mode"] == "broadcast", (q, bjs)
        assert_frames_equal(part, bc)
        same_answer(part, bc, 1e-9)
        host = _host(single, q)
        assert_frames_equal(part, host)


def test_partitioned_counters_accumulate(clusters):
    broker = clusters["broker"]
    with broker.cluster._lock:
        before = dict(broker.cluster.counters)
    broker.sql(_PARITY_QUERIES[0])
    with broker.cluster._lock:
        after = dict(broker.cluster.counters)
    assert after["join_scatters"] > before.get("join_scatters", 0)
    assert after["join_shuffle_bytes"] > before.get(
        "join_shuffle_bytes", 0)


def test_broker_falls_back_to_broadcast_in_auto(clusters):
    # auto mode on a tiny build side: the estimate picks broadcast even
    # with a cluster attached (the broker holds the full store)
    broker, single = clusters["broker"], clusters["single"]
    broker.config.set("sdot.join.mode", "auto")
    try:
        q = _PARITY_QUERIES[0]
        got, js = _run(broker, q)
        assert js is not None and js["mode"] == "broadcast", js
        assert js["estimate"]["mode"] == "broadcast"
        assert_frames_equal(got, single.sql(q).to_pandas())
    finally:
        broker.config.set("sdot.join.mode", "partitioned")


def test_auto_mode_past_the_cap_goes_partitioned(clusters):
    """A build side over ``sdot.join.broadcast.max.bytes`` in auto mode:
    the estimate prices the exchange and the cluster answers."""
    broker, single = clusters["broker"], clusters["single"]
    broker.config.set("sdot.join.mode", "auto")
    broker.config.set("sdot.join.broadcast.max.bytes", 256)
    try:
        q = _PARITY_QUERIES[0]
        got, js = _run(broker, q)
        assert js["mode"] == "partitioned", js
        assert js["estimate"]["mode"] == "partitioned"
        assert js["estimate"]["reason"] == "build exceeds broadcast cap"
        same_answer(got, single.sql(q).to_pandas(), 1e-9)
    finally:
        broker.config.set("sdot.join.mode", "partitioned")
        broker.config.set("sdot.join.broadcast.max.bytes", 64 << 20)


@pytest.mark.parametrize("n_parts", [1, 3, 7])
def test_partition_counts_answer_alike(clusters, n_parts):
    """``sdot.join.partitions`` partitions over two nodes (0: one each):
    7 leaves partitions of the build side empty on some nodes."""
    broker, single = clusters["broker"], clusters["single"]
    broker.config.set("sdot.join.partitions", n_parts)
    try:
        for q in (_PARITY_QUERIES[0], _PARITY_QUERIES[2]):
            got, js = _run(broker, q)
            assert js["mode"] == "partitioned" \
                and js["partitions"] == n_parts, js
            same_answer(got, single.sql(q).to_pandas(), 1e-9)
    finally:
        broker.config.set("sdot.join.partitions", 0)


EMPTY_BUILD = ("SELECT count(*) AS n, sum(f.qty) AS tq FROM fact f "
               "JOIN users u ON f.user_id = u.user_id WHERE u.credit > 1000")


def test_empty_build_side(clusters):
    broker, single = clusters["broker"], clusters["single"]
    got, js = _run(broker, EMPTY_BUILD)
    assert js["mode"] == "partitioned", js
    assert got["n"].tolist() == [0] and np.isnan(got["tq"][0])
    assert_frames_equal(got, single.sql(EMPTY_BUILD).to_pandas())


@pytest.mark.parametrize("broker_key", ["port_over_jax", "jax_over_port"])
def test_mixed_cluster_answers_partitioned(clusters, broker_key):
    broker, single = clusters[broker_key], clusters["single"]
    for q in _PARITY_QUERIES:
        got, js = _run(broker, q)
        assert js is not None and js["mode"] == "partitioned", (q, js)
        assert js["shuffle_bytes"] > 0
        same_answer(got, single.sql(q).to_pandas(), 1e-6)


def test_exec_hop_probes_on_the_node_device(clusters, monkeypatch):
    """Every probe of the exec hop runs on the tensors of the historical's
    device (the CPU here: the nodes were built with ``device="cpu"``)."""
    seen = []
    real = THJ.probe

    def spy(tdev, key, valid, **kw):
        seen.append((key.device, tdev["slot_key"].device))
        return real(tdev, key, valid, **kw)
    monkeypatch.setattr(THJ, "probe", spy)
    broker = clusters["broker"]
    _, js = _run(broker, _PARITY_QUERIES[0])
    assert js["mode"] == "partitioned"
    devs = {h.ctx.device for h in clusters["thist"]}
    assert len(seen) == js["partitions"] and devs == {
        d for pair in seen for d in pair}


def test_local_join_needs_a_device():
    spec = {"keys": [["k", "k"]], "colside": {}, "group_by": [],
            "aggs": [{"out": "n", "fn": "count", "arg": None}],
            "residual": None}
    side = (["k"], {"k": np.arange(3, dtype=np.int64)})
    with pytest.raises(ValueError, match="device"):
        TPT.local_join(spec, side, side)
    cols, data = TPT.local_join(spec, side, side, device="cpu")
    assert cols == ["n"] and data["n"].tolist() == [3]


# -- hop 1 and hop 2 byte for byte ---------------------------------------------

PARTITION_REQUESTS = {
    "probe": ("fact", {"keys": ["user_id"], "ship": ["amount", "user_id"],
                       "read": ["amount", "user_id"], "filter": None}),
    "probe_filtered": ("fact", {
        "keys": ["user_id"], "ship": ["qty", "user_id"],
        "read": ["amount", "qty", "user_id"],
        "filter": SERDE.expr_to_dict(
            E.Comparison(">", E.Column("amount"), E.Literal(50.0)))}),
    "build_strings": ("users", {"keys": ["user_id"],
                                "ship": ["segment_name", "user_id"],
                                "read": ["segment_name", "user_id"],
                                "filter": None}),
    "null_keys": ("events", {"keys": ["country"], "ship": ["country"],
                             "read": ["country"], "filter": None}),
    "two_keys": ("fact", {"keys": ["user_id", "country"],
                          "ship": ["country", "qty", "user_id"],
                          "read": ["country", "qty", "user_id"],
                          "filter": None}),
}


@pytest.mark.parametrize("n_parts", [1, 3])
@pytest.mark.parametrize("case", sorted(PARTITION_REQUESTS))
def test_partition_request_bytes_equal_the_jax_package(clusters, case,
                                                       n_parts):
    ds, req = PARTITION_REQUESTS[case]
    plan = clusters["broker"].cluster.plan.datasources[ds]
    tnode, jnode = clusters["thist"][0], clusters["jhist"][0]
    for sh in plan.shards:
        name = shard_name(ds, sh.index, plan.n_shards)
        r = {**req, "store": name, "npartitions": n_parts}
        got = TPT.partition_request(tnode.ctx, json.loads(json.dumps(r)))
        want = JPT.partition_request(jnode.ctx, json.loads(json.dumps(r)))
        assert got == want, (case, name)
        cols, data, st = WIRE.decode_result(got)
        assert cols[-1] == "__part__" and st["rows"] == len(data["__part__"])
        for k in req["keys"]:
            assert not pd.isna(data[k]).any()


EXEC_CASES = {
    "grouped_float_sum_avg": _PARITY_QUERIES[0],
    "residual": _PARITY_QUERIES[1],
    "ungrouped": _PARITY_QUERIES[2],
    "null_keys": _PARITY_QUERIES[3],
    "avg_float": ("SELECT f.country AS c, avg(f.amount) AS a, count(*) AS n "
                  "FROM fact f JOIN users u ON f.user_id = u.user_id "
                  "GROUP BY f.country"),
    "empty_build": EMPTY_BUILD,
}


def _exec_frames(broker, sql):
    """The SDJ1 frames ``broker`` sends for ``sql``'s exec hop."""
    cl = broker.cluster
    frames, real = [], cl._guarded_rpc

    def spy(st, nid, payload, deadline, path="/cluster/subquery"):
        if path == "/cluster/join/exec":
            frames.append(payload)
        return real(st, nid, payload, deadline, path=path)
    cl._guarded_rpc = spy
    try:
        _, js = _run(broker, sql)
    finally:
        del cl._guarded_rpc
    assert js["mode"] == "partitioned" and len(frames) == js["partitions"]
    return frames


def _float_sum_outs(spec, sides):
    """Output names of the sums / avgs over a float argument."""
    from spark_druid_olap_tpu_torch.utils import host_eval
    out = []
    for a in spec["aggs"]:
        if a["fn"] not in ("sum", "avg") or a["arg"] is None:
            continue
        env = {q: np.asarray(sides[s][1][c])[:1]
               for q, (s, c) in spec["colside"].items()}
        v = np.asarray(host_eval.eval_expr(SERDE.expr_from_dict(a["arg"]),
                                           env))
        if v.dtype.kind == "f":
            out.append(a["out"])
    return out


def _f64_oracle(spec, sides, out: str) -> dict:
    """Group -> the float64 sum of ``out``'s argument over the frame's
    matched pairs (a pandas merge of its two sides)."""
    pcols, pdata = sides["probe"]
    bcols, bdata = sides["build"]
    p = pd.DataFrame({f"p.{c}": pdata[c] for c in pcols})
    b = pd.DataFrame({f"b.{c}": bdata[c] for c in bcols})
    (pk, bk), = spec["keys"]
    m = p.merge(b, left_on=f"p.{pk}", right_on=f"b.{bk}")
    agg = next(a for a in spec["aggs"] if a["out"] == out)
    col = agg["arg"]["name"]
    side, phys = spec["colside"][col]
    vals = m[("p." if side == "probe" else "b.") + phys].astype(np.float64)
    if spec["group_by"]:
        g = spec["group_by"][0]
        gs, gp = spec["colside"][g]
        keys = m[("p." if gs == "probe" else "b.") + gp]
        return vals.groupby(keys).sum().to_dict()
    return {(): vals.sum()}


@pytest.mark.parametrize("case", sorted(EXEC_CASES))
def test_exec_request_bytes_equal_the_jax_package(clusters, case):
    frames = _exec_frames(clusters["broker"], EXEC_CASES[case])
    node = clusters["thist"][0]
    for raw in frames:
        got = TPT.exec_request(node.ctx, raw)
        want = JPT.exec_request(None, raw)
        spec, sides = WIRE.decode_join_exec(raw)
        floats = _float_sum_outs(spec, sides)
        if case in ("grouped_float_sum_avg", "avg_float"):
            assert floats
        if not floats:
            assert got == want, case
            continue
        tcols, tdata, tst = WIRE.decode_result(got)
        jcols, jdata, jst = JWIRE.decode_result(want)
        assert tcols == jcols and tst == jst
        for c in tcols:
            if c in floats:
                t = np.array([np.nan if v is None else v for v in tdata[c]],
                             dtype=np.float64)
                j = np.array([np.nan if v is None else v for v in jdata[c]],
                             dtype=np.float64)
                np.testing.assert_allclose(t, j, rtol=1e-6)
                want64 = _f64_oracle(spec, sides, c)
                gk = spec["group_by"]
                for i, v in enumerate(t):
                    key = tdata[gk[0]][i] if gk else ()
                    np.testing.assert_allclose(v, want64[key], rtol=1e-12)
            else:
                np.testing.assert_array_equal(tdata[c], jdata[c], err_msg=c)


def test_empty_partition_frame(clusters):
    """A partition with no probe rows (or no build rows) returns the
    empty partials, and the ungrouped statement's global row stays."""
    node = clusters["thist"][0]
    frames = _exec_frames(clusters["broker"], _PARITY_QUERIES[0])
    spec, sides = WIRE.decode_join_exec(frames[0])
    for empty in ("probe", "build"):
        cols, _ = sides[empty]
        cut = dict(sides)
        cut[empty] = (cols, {c: np.zeros(0, dtype=object) for c in cols})
        raw = WIRE.encode_join_exec(spec, cut)
        got = TPT.exec_request(node.ctx, raw)
        assert got == JPT.exec_request(None, raw)
        tcols, tdata, st = WIRE.decode_result(got)
        assert st["rows"] == 0 and all(len(tdata[c]) == 0 for c in tcols)


# -- a stopped node: the broker's broadcast fallback (runs last) ---------------

def test_stopped_historical_falls_back_to_broadcast(clusters):
    broker, single = clusters["broker"], clusters["single"]
    victim = clusters["thist"][1]
    overrides = dict(victim.overrides)
    victim.stop()
    try:
        for q in _PARITY_QUERIES:
            got, js = _run(broker, q)
            # the exec hop to the stopped node fails: the answer is the
            # broker's own broadcast join, and the stats say so
            assert js["mode"] == "broadcast", js
            assert js["estimate"]["mode"] == "partitioned"
            same_answer(got, single.sql(q).to_pandas(), 1e-9)
    finally:
        node = restart_on_same_port("port", overrides, 1)
        clusters["thist"][1] = node
    assert wait_until(lambda: node.ready, 30.0)
    cl = broker.cluster
    assert wait_until(lambda: cl.stats()["nodes"][1]["state"] == "up", 30.0)
    _, js = _run(broker, _PARITY_QUERIES[0])
    assert js["mode"] == "partitioned", js
