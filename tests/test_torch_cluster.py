"""The port's distributed serving tier (``cluster/``) against the JAX
package's.

Every case of ``tests/test_cluster.py`` runs over the port on the CPU: a
port broker scattering to two in-process port historicals over one deep
storage root (TPC-H SF 0.002, SSB SF 0.003 and the sales frame, 2,048-row
segments, as there) answers as a single-process port ``Context`` over the
same root does: dimensions, integers, counts and sketch estimates exact,
floats rtol 1e-9 / atol 1e-9 (the broker re-associates float sums), the
JAX test's tolerance. The shard plans equal the JAX package's plans over
the same root.

Beyond the JAX cases, the packages cross: a port broker scatters to JAX
historicals and a JAX broker to port historicals, each answering exactly
(statements without float sums) as its own package's single context; one
subquery answered by a port historical and by a JAX historical gives the
same partial (integers, dimensions and raw sketch registers exact); and
the SDW1 frames, ingest frames, error bodies and patched subqueries that
both packages' ``cluster/wire.py`` write for the same input are byte for
byte the same. Historicals and the cluster entry point refuse to start
without a CUDA device unless the CPU is asked for.

Ports: a historical serves on the address the node list names, so the
fixtures pick free ports and start the whole set again on
``EADDRINUSE`` (:func:`start_historicals`), which another test process
can cause between picking a port and binding it.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import errno
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.cluster import assign as JA
from spark_druid_olap_tpu.cluster import merge as JMG
from spark_druid_olap_tpu.cluster import wire as JWIRE
from spark_druid_olap_tpu.cluster.historical import (
    HistoricalNode as JHistoricalNode)

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.cluster import merge as MG
from spark_druid_olap_tpu_torch.cluster import wire as WIRE
from spark_druid_olap_tpu_torch.cluster.assign import (
    parse_nodes, plan_cluster, shard_name)
from spark_druid_olap_tpu_torch.cluster.historical import (
    HistoricalNode, HistoricalServer)
from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.tools import ssb, tpch

from conftest import assert_frames_equal, make_sales_df
from test_torch_sql import assert_answers_equal

RTOL = ATOL = 1e-9


# -- helpers shared with the other port test files ----------------------------

def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def http_get(port: int, path: str, timeout=5.0):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def make_node(pkg, overrides, node_id):
    """One package's historical (the port's on the CPU)."""
    if pkg == "jax":
        return JHistoricalNode(dict(overrides), node_id=node_id)
    return HistoricalNode(dict(overrides), node_id=node_id, device="cpu")


def start_historicals(common, n=2, pkg="port", tries=8, list_size=None):
    """Start historicals 0..n-1 of a ``list_size``-node list (``n`` by
    default) of one package on free loopback ports -> (nodes csv, nodes).
    The whole set starts again on fresh ports when a bind meets
    ``EADDRINUSE``."""
    for attempt in range(tries):
        csv = ",".join(f"127.0.0.1:{free_port()}"
                       for _ in range(list_size or n))
        started = []
        try:
            for i in range(n):
                node = make_node(pkg, {**common, "sdot.cluster.nodes": csv},
                                 i)
                started.append(node)
                node.start()
            return csv, started
        except OSError as e:
            for node in started:
                node.stop()
            if e.errno != errno.EADDRINUSE or attempt == tries - 1:
                raise
    raise AssertionError("unreachable")


def restart_on_same_port(pkg, overrides, node_id, deadline_s=15.0):
    """Start a historical again on the address it had, retrying the bind
    until the deadline (its old socket may still be closing)."""
    end = time.monotonic() + deadline_s
    while True:
        node = make_node(pkg, overrides, node_id)
        try:
            return node.start()
        except OSError as e:
            node.stop()
            if e.errno != errno.EADDRINUSE or time.monotonic() > end:
                raise
            time.sleep(0.05)


def wait_until(pred, deadline_s=15.0, step=0.05):
    """Poll ``pred`` until it holds or the deadline passes -> its value."""
    end = time.monotonic() + deadline_s
    while True:
        v = pred()
        if v or time.monotonic() > end:
            return v
        time.sleep(step)


def port_broker(root, nodes_csv, **over):
    cfg = {"sdot.persist.path": root, "sdot.cluster.nodes": nodes_csv,
           "sdot.cluster.role": "broker", **over}
    return tsdot.Context(cfg, device="cpu")


# -- the cluster --------------------------------------------------------------

class Env:
    def __init__(self, root, nodes_csv, hist, broker, single):
        self.root = root
        self.nodes_csv = nodes_csv
        self.hist = hist
        self.broker = broker
        self.single = single


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cluster-deep-storage"))
    # seed deep storage: TPC-H flat + SSB flat + a synthetic fact, all
    # with small segments so every datasource splits into real shards
    seed = tsdot.Context({"sdot.persist.path": root}, device="cpu")
    seed.ingest_dataframe("tpch_flat", tpch.flatten(tpch.generate(sf=0.002)),
                          time_column="l_shipdate", target_rows=2048)
    seed.ingest_dataframe("ssb_flat", ssb.flatten(ssb.generate(sf=0.003)),
                          time_column="lo_orderdate", target_rows=2048)
    seed.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                          target_rows=2048)
    seed.checkpoint()
    seed.close()

    nodes_csv, hist = start_historicals({"sdot.persist.path": root})
    broker = port_broker(root, nodes_csv, **{
        # fast probe so the rejoin test converges quickly
        "sdot.cluster.probe.interval.seconds": 0.2,
        "sdot.cluster.retry.backoff.start.seconds": 0.01})
    single = tsdot.Context({"sdot.persist.path": root}, device="cpu")
    for ctx in (broker, single):
        ctx.register_star_schema(tpch.star_schema("tpch_flat"))
        ctx.register_star_schema(ssb.star_schema("ssb_flat"))
    e = Env(root, nodes_csv, hist, broker, single)
    yield e
    for h in e.hist:
        h.stop()
    broker.close()
    single.close()


def _diff_sql(env, query, expect_mode="scatter"):
    got = env.broker.sql(query).to_pandas()
    st = env.broker.engine.last_stats.get("cluster") or {}
    want = env.single.sql(query).to_pandas()
    if not got.equals(want):
        assert_frames_equal(got, want, rtol=RTOL, atol=ATOL)
    if expect_mode is not None:
        assert st.get("mode") == expect_mode, st
    return got


# -- assignment determinism + replication invariants --------------------------

def test_plan_is_deterministic(env):
    p1 = plan_cluster(env.root, 2, 2)
    p2 = plan_cluster(env.root, 2, 2)
    assert p1 == p2
    # independently-computed node plans equal the broker's
    assert env.broker.cluster.plan == env.hist[0].plan == env.hist[1].plan


def _plan_fields(plan):
    return (plan.n_nodes, plan.replication, plan.node_keys, plan.epoch,
            {n: (dp.snapshot_version, dp.ingest_version, dp.num_rows,
                 dp.num_segments,
                 [(sh.index, sh.segment_indexes, sh.rows, sh.owners,
                   sh.min_ms, sh.max_ms) for sh in dp.shards])
             for n, dp in plan.datasources.items()})


def test_replication_and_partition_invariants(env):
    for n_nodes in (1, 2, 3, 5):
        for repl in (1, 2, 3):
            plan = plan_cluster(env.root, n_nodes, repl)
            # the JAX package plans the same root identically
            assert _plan_fields(plan) == _plan_fields(
                JA.plan_cluster(env.root, n_nodes, repl))
            assert plan.replication == min(max(1, repl), n_nodes)
            for dp in plan.datasources.values():
                seen = []
                for sh in dp.shards:
                    # every shard has exactly min(R, N) DISTINCT owners
                    assert len(sh.owners) == len(set(sh.owners)) \
                        == min(repl, n_nodes)
                    assert all(0 <= o < n_nodes for o in sh.owners)
                    assert sh.rows > 0
                    seen.extend(sh.segment_indexes)
                # shards partition the manifest's segments exactly once,
                # in contiguous time order
                assert sorted(seen) == list(range(dp.num_segments))
                assert sum(sh.rows for sh in dp.shards) == dp.num_rows


def test_shard_names_unreachable_from_sql(env):
    name = shard_name("sales", 0, 2)
    assert "::" in name
    with pytest.raises(Exception):
        env.broker.sql(f'select count(*) from "{name}"')


def test_parse_nodes():
    assert parse_nodes("a:1, b:2;c:3") == (("a", 1), ("b", 2), ("c", 3))
    with pytest.raises(ValueError):
        parse_nodes("nope")


def test_historicals_hold_only_owned_shards(env):
    for h in env.hist:
        names = h.ctx.store.names()
        assert names, "historical serves nothing"
        assert all("::shard" in n for n in names)
        owned = h.plan.shards_of(h.node_id)
        want = {shard_name(ds, sh.index, h.plan.datasources[ds].n_shards)
                for ds, shards in owned.items() for sh in shards}
        assert set(names) == want
        assert h.ctx.engine.partial_sketches is True
        assert h.ctx.engine.device.type == "cpu"


# -- differential: TPC-H + SSB + spec-level shapes ----------------------------

TPCH_QUERIES = ["basic_agg", "q1", "q6", "q12", "q14"]


@pytest.mark.parametrize("name", TPCH_QUERIES)
def test_tpch_differential(env, name):
    _diff_sql(env, tpch.QUERIES[name], expect_mode=None)


SSB_QUERIES = ["q1.1", "q2.1", "q3.1", "q4.1"]


@pytest.mark.parametrize("name", SSB_QUERIES)
def test_ssb_differential(env, name):
    _diff_sql(env, ssb.QUERIES[name], expect_mode=None)


def test_groupby_scatters_and_matches(env):
    _diff_sql(env, "select region, sum(qty) as q, count(*) as c, "
                   "min(price) as mn, max(price) as mx from sales "
                   "group by region order by region")


def test_topn_order_limit(env):
    _diff_sql(env, "select product, sum(price) as rev from sales "
                   "group by product order by rev desc limit 7")


def test_having_and_post_aggregation(env):
    _diff_sql(env, "select region, sum(price) as rev, "
                   "sum(price)/sum(qty) as unit from sales "
                   "group by region having sum(qty) > 10 order by region")


def test_global_rollup(env):
    _diff_sql(env, "select count(*) as c, sum(qty) as q from sales")


def test_sketch_register_merge_is_exact(env):
    # APPROX_COUNT_DISTINCT must be EXACTLY the single-engine estimate:
    # historicals ship raw registers, the broker merges and finalizes
    # once — same registers, same estimate, not merely "close"
    for q in ("select region, approx_count_distinct(product) as dp "
              "from sales group by region order by region",
              "select region, approx_count_distinct_theta(product) as dp "
              "from sales group by region order by region",
              "select region, percentile_approx(qty, 0.5) as pq "
              "from sales group by region order by region"):
        got = env.broker.sql(q).to_pandas()
        assert (env.broker.engine.last_stats.get("cluster") or {}) \
            .get("mode") == "scatter"
        want = env.single.sql(q).to_pandas()
        assert got.equals(want), q


def test_granular_timeseries_spec(env):
    q = S.TimeseriesQuerySpec(
        datasource="sales",
        aggregations=(S.AggregationSpec("longsum", "q", field="qty"),
                      S.AggregationSpec("count", "c")),
        granularity=S.Granularity("month"))
    got = env.broker.execute(q).to_pandas()
    st = env.broker.engine.last_stats.get("cluster") or {}
    assert st.get("mode") == "scatter", st
    want = env.single.execute(q).to_pandas()
    if not got.equals(want):
        assert_frames_equal(got, want, rtol=RTOL, atol=ATOL)


def test_topn_spec_threshold(env):
    q = S.TopNQuerySpec(
        datasource="sales",
        dimension=S.DimensionSpec("product", "product"),
        metric="q", threshold=5,
        aggregations=(S.AggregationSpec("longsum", "q", field="qty"),))
    got = env.broker.execute(q).to_pandas()
    assert (env.broker.engine.last_stats.get("cluster") or {}) \
        .get("mode") == "scatter"
    want = env.single.execute(q).to_pandas()
    assert got.equals(want)
    assert len(got) == 5


# -- eligibility: what must NOT distribute ------------------------------------

def test_unmergeable_agg_runs_locally(env):
    q = S.GroupByQuerySpec(
        datasource="sales",
        dimensions=(S.DimensionSpec("region", "region"),),
        aggregations=(S.AggregationSpec("anyvalue", "p", field="price"),))
    got = env.broker.execute(q).to_pandas()
    # eligibility declines BEFORE scatter: no cluster stat at all
    st = env.broker.engine.last_stats.get("cluster") or {}
    assert st.get("mode") != "scatter", st
    assert len(got) == 4


def test_post_boot_ingest_served_locally(env):
    # read-your-writes: a datasource ingested AFTER the plan was computed
    # is invisible to the cluster and must be answered by the broker
    env.broker.ingest_dataframe(
        "fresh", pd.DataFrame({"k": ["a", "b", "a"], "v": [1, 2, 3]}))
    got = env.broker.sql(
        "select k, sum(v) as s from fresh group by k order by k"
    ).to_pandas()
    st = env.broker.engine.last_stats.get("cluster")
    assert st is None or st.get("mode") != "scatter"
    assert list(got["s"]) == [4, 2]


# -- liveness + introspection -------------------------------------------------

def test_healthz_and_readyz_lifecycle(env):
    # a server started BEFORE boot: alive immediately, not ready; the
    # server binds port 0 and the node list names the port it took
    node = HistoricalNode(
        {"sdot.persist.path": env.root,
         "sdot.cluster.nodes": "127.0.0.1:1"}, node_id=0, device="cpu")
    node.server = HistoricalServer(node, "127.0.0.1", 0)
    node.server.start(background=True)
    port = node.server.port
    node.overrides["sdot.cluster.nodes"] = f"127.0.0.1:{port}"
    node.addresses = ((("127.0.0.1", port)),)
    node.address = f"127.0.0.1:{port}"
    try:
        code, body = http_get(port, "/healthz")
        assert code == 200 and json.loads(body)["status"] == "alive"
        code, body = http_get(port, "/readyz")
        assert code == 503 and json.loads(body)["ready"] is False
        node.boot()
        code, body = http_get(port, "/readyz")
        info = json.loads(body)
        assert code == 200 and info["ready"] is True
        assert {"node", "boot", "epoch", "draining", "epochs"} <= set(info)
    finally:
        node.stop()


def test_cluster_metadata_route(env):
    from spark_druid_olap_tpu_torch.server.http import SqlServer
    srv = SqlServer(env.broker, "127.0.0.1", 0)
    srv.start(background=True)
    try:
        code, body = http_get(srv.port, "/metadata/cluster")
        assert code == 200
        st = json.loads(body)
        assert st["enabled"] and len(st["nodes"]) == 2
        assert "sales" in st["datasources"]
        code, body = http_get(srv.port, "/metadata/cluster")
        assert code == 200
    finally:
        srv.stop()


def test_broker_stats_shape(env):
    st = env.broker.cluster.stats()
    assert st["replication"] == 2
    for dp in st["datasources"].values():
        assert set(dp) == {"shards", "segments", "rows", "ingest_version",
                           "owners"}
    assert st["counters"]["queries"] >= 1


# -- wire + merge units -------------------------------------------------------

def _wire_inputs():
    r = np.random.default_rng(11)
    return [
        {"i": np.array([1, 2, 3], dtype=np.int64),
         "f": np.array([1.5, np.nan, -2.0]),
         "t": np.array(["2024-01-01", "2024-06-01", "NaT"],
                       dtype="datetime64[ms]"),
         "s": np.array(["a", None, "c"], dtype=object),
         "wide": np.array([2**70, -5, None], dtype=object),
         "regs": np.arange(12, dtype=np.int64).reshape(3, 4)},
        # long runs ship RLE'd; random ints and floats stay raw
        {"bucket": np.repeat(np.arange(8, dtype=np.int64), 500),
         "code": np.repeat(np.arange(4, dtype=np.int32), 1000),
         "rev": r.uniform(size=4000),
         "rand": r.integers(0, 1 << 60, 4000),
         "hll": r.integers(0, 30, (4000, 16)).astype(np.int32)},
        {"k": np.array([], dtype=object),
         "v": np.array([], dtype=np.int64)},
    ]


def test_wire_roundtrip():
    data = _wire_inputs()[0]
    payload = WIRE.encode_result(list(data), data, stats={"node": 1})
    cols, out, stats = WIRE.decode_result(payload)
    assert cols == list(data) and stats == {"node": 1}
    np.testing.assert_array_equal(out["i"], data["i"])
    np.testing.assert_array_equal(out["f"], data["f"])
    np.testing.assert_array_equal(out["t"], data["t"])
    assert list(out["s"]) == ["a", None, "c"]
    assert list(out["wide"]) == [2**70, -5, None]
    np.testing.assert_array_equal(out["regs"], data["regs"])

    err = WIRE.encode_error("AdmissionRejected", "lane full",
                            retryAfterSeconds=0.5)
    info = WIRE.decode_error(err)
    assert info["error"] == "AdmissionRejected"
    assert info["retryAfterSeconds"] == 0.5


@pytest.mark.parametrize("case", range(3))
def test_wire_frames_equal_jax_bytes(case):
    data = _wire_inputs()[case]
    stats = {"node": case, "total_ms": 1.25}
    frame = WIRE.encode_result(list(data), data, stats)
    assert frame == JWIRE.encode_result(list(data), data, stats)
    # each package decodes the other's frame to the same arrays
    for dec in (WIRE.decode_result, JWIRE.decode_result):
        cols, out, st = dec(frame)
        assert cols == list(data) and st == stats
        for k, v in data.items():
            if v.dtype == object:
                assert list(out[k]) == list(v)
            else:
                assert out[k].dtype == v.dtype
                np.testing.assert_array_equal(out[k], v)


def test_wire_envelopes_equal_jax_bytes():
    body = json.dumps({"queryType": "timeseries", "dataSource": "sales",
                       "aggregations": [{"type": "count", "name": "c"}]}
                      ).encode()
    for ep in (None, 3):
        assert WIRE.patch_subquery(body, "sales::shard0of2", ep) \
            == JWIRE.patch_subquery(body, "sales::shard0of2", ep)
    raw = WIRE.patch_subquery(body, "s::shard1of2", 7)
    assert WIRE.split_subquery(raw) == JWIRE.split_subquery(raw)
    args = ("ev", "ev::shard1of2", 4, {"time_column": "t"}, b"\x00abc",
            "123.456")
    frame = WIRE.encode_ingest(*args)
    assert frame == JWIRE.encode_ingest(*args)
    assert WIRE.decode_ingest(frame) == JWIRE.decode_ingest(frame)
    assert WIRE.encode_error("Draining", "m", x=1) \
        == JWIRE.encode_error("Draining", "m", x=1)
    sides = {"probe": (["k"], {"k": np.arange(5, dtype=np.int64)}),
             "build": (["k", "s"], {"k": np.arange(3, dtype=np.int64),
                                    "s": np.array(["a", "b", None],
                                                  dtype=object)})}
    spec = {"keys": ["k"], "aggs": []}
    jframe = WIRE.encode_join_exec(spec, sides)
    assert jframe == JWIRE.encode_join_exec(spec, sides)
    got_spec, got = WIRE.decode_join_exec(jframe)
    assert got_spec == spec and set(got) == {"probe", "build"}
    for bad in (frame[:-1], b"SDW1" + frame[4:]):
        with pytest.raises(ValueError):
            WIRE.decode_ingest(bad)


def test_merge_partials_sums_exact():
    a = {"k": np.array(["x", "y"], dtype=object),
         "c": np.array([2, 3], dtype=np.int64),
         "s": np.array([10, 2**62], dtype=np.int64)}
    b = {"k": np.array(["y", "z"], dtype=object),
         "c": np.array([5, 7], dtype=np.int64),
         "s": np.array([3 * 2**61, -1], dtype=np.int64)}
    cols, data, n = MG.merge_partials(
        [a, b], ["k"], [("c", "count"), ("s", "longsum")])
    assert n == 3 and cols == ["k", "c", "s"]
    assert list(data["k"]) == ["x", "y", "z"]
    assert list(data["c"]) == [2, 8, 7]
    # 2**62 + 3*2**61 overflows int64: must widen, not wrap
    assert list(data["s"]) == [10, 2**62 + 3 * 2**61, -1]
    assert data["s"].dtype == object


def test_merge_partials_hll_registers():
    regs_a = np.array([[3, 0, 1, 0]], dtype=np.int64)
    regs_b = np.array([[1, 2, 0, 0]], dtype=np.int64)
    from spark_druid_olap_tpu_torch.ops import hll
    cols, data, n = MG.merge_partials(
        [{"k": np.array(["g"], dtype=object), "d": regs_a},
         {"k": np.array(["g"], dtype=object), "d": regs_b}],
        ["k"], [("d", "cardinality")])
    assert n == 1
    want = np.round(hll.estimate(
        np.maximum(regs_a, regs_b).astype(np.int32))).astype(np.int64)
    np.testing.assert_array_equal(data["d"], want)


def test_merge_null_keys_collapse():
    a = {"k": np.array([np.nan, 1.0]), "v": np.array([1, 2], dtype=np.int64)}
    b = {"k": np.array([np.nan]), "v": np.array([10], dtype=np.int64)}
    cols, data, n = MG.merge_partials([a, b], ["k"], [("v", "longsum")])
    # NaN keys from different shards are ONE group (nulls-first order)
    assert n == 2
    assert list(data["v"]) == [11, 2]


def test_merge_partials_equal_jax():
    """Both packages' merges of the same partials: every scalar kind,
    null keys, wide sums and each sketch's register algebra (HLL max,
    theta min, KLL minsum) finalized at a quantile fraction."""
    from spark_druid_olap_tpu_torch.ops import kll
    r = np.random.default_rng(5)
    w = kll.width()
    parts = []
    for p in range(3):
        n = 6
        kll_regs = np.stack([kll.identity_registers(w)] * n)
        kll_regs[:, : w // 2] = r.integers(0, 1 << 20, (n, w // 2))
        parts.append({
            "k": np.array(["a", "b", None, "c", "a", "d"][:n], dtype=object),
            "c": r.integers(0, 9, n).astype(np.int64),
            "s": np.array([2**62] * n, dtype=np.int64),
            "f": r.uniform(size=n),
            "mn": r.integers(-5, 5, n).astype(np.int64),
            "mx": r.uniform(size=n),
            "h": r.integers(0, 20, (n, 8)).astype(np.int32),
            "t": r.uniform(size=(n, 8)),
            "q": kll_regs.astype(np.int32)})
    aggs = [("c", "count"), ("s", "longsum"), ("f", "doublesum"),
            ("mn", "longmin"), ("mx", "doublemax"), ("h", "cardinality"),
            ("t", "thetasketch"), ("q", "quantile")]
    got = MG.merge_partials(parts, ["k"], aggs, {"q": 0.9})
    want = JMG.merge_partials(parts, ["k"], aggs, {"q": 0.9})
    assert got[0] == want[0] and got[2] == want[2]
    for c in got[0]:
        g, x = got[1][c], want[1][c]
        assert g.dtype == x.dtype, c
        if g.dtype == object:
            assert list(g) == list(x), c
        else:
            np.testing.assert_array_equal(g, x, err_msg=c)
    assert MG.MERGEABLE_KINDS == JMG.MERGEABLE_KINDS
    assert MG.MERGE_OP == JMG.MERGE_OP


# -- per-node shared-scan coalescing ------------------------------------------

def test_per_node_coalescing_storm_is_exact(env):
    """The tier's designed serving config: historicals with shared-scan
    on and single-slot lanes, so concurrent subqueries per node fuse
    into one scan (queued waiters hand off into the open group). A
    concurrent storm — sketch aggregates included, which ride the fused
    path as raw registers — must still match the single engine exactly,
    and the nodes must actually coalesce."""
    coalescing = {
        "sdot.persist.path": env.root,
        "sdot.sharedscan.enabled": True,
        "sdot.wlm.batch.window.ms": 25.0,
        "sdot.wlm.lanes": ("interactive:slots=1,queue=256;"
                           "reporting:slots=1,queue=64;"
                           "batch:slots=1,queue=32"),
    }
    nodes_csv, hist = start_historicals(coalescing)
    broker = port_broker(env.root, nodes_csv, **{
        "sdot.cluster.retry.backoff.start.seconds": 0.01})
    try:
        queries = [
            "select region, sum(price) as rev from sales "
            "group by region order by region",
            "select product, sum(qty) as q from sales "
            "group by product order by q desc limit 5",
            "select approx_count_distinct(product) as np from sales",
            "select status, count(*) as c from sales group by status "
            "order by status",
        ]
        want = [env.single.sql(q).to_pandas() for q in queries]
        mismatches, errors = [], []

        def storm(worker):
            for i in range(8):
                k = (worker + i) % len(queries)
                try:
                    got = broker.sql(queries[k]).to_pandas()
                except Exception as e:  # noqa: BLE001 — asserted below
                    errors.append(e)
                    return
                if not got.equals(want[k]):
                    try:
                        assert_frames_equal(got, want[k],
                                            rtol=RTOL, atol=ATOL)
                    except AssertionError as e:
                        mismatches.append((queries[k], str(e)))

        threads = [threading.Thread(target=storm, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        assert not errors, errors[:1]
        assert mismatches == [], mismatches[:2]
        coalesced = sum(
            h.ctx.engine.sharedscan.stats()["queries_coalesced"]
            for h in hist)
        assert coalesced >= 2, [
            h.ctx.engine.sharedscan.stats() for h in hist]
        # the nodes' engines trace their lanes in one process: make_fx's
        # process-wide tracer state is held by one trace at a time
        reasons = [r for h in hist for r in
                   h.ctx.engine.sharedscan.stats()["wave_fallback_reasons"]]
        assert not [r for r in reasons if "trace failed" in r], reasons
    finally:
        for h in hist:
            h.stop()
        broker.close()


# -- across packages ----------------------------------------------------------

# statements without float sums: every column is exact in both packages
EXACT_QUERIES = [
    "select region, sum(qty) as q, count(*) as c, min(qty) as mn, "
    "max(qty) as mx from sales group by region order by region",
    "select product, sum(qty) as q from sales group by product "
    "order by q desc limit 5",
    "select region, approx_count_distinct(product) as dp from sales "
    "group by region order by region",
    "select count(*) as c from sales",
]


@pytest.fixture(scope="module")
def jax_hist(env):
    csv, hist = start_historicals({"sdot.persist.path": env.root},
                                  pkg="jax")
    yield csv, hist
    for h in hist:
        h.stop()


def test_port_broker_over_jax_historicals(env, jax_hist):
    csv, _ = jax_hist
    broker = port_broker(env.root, csv, **{
        "sdot.cluster.probe.interval.seconds": 0})
    try:
        for q in EXACT_QUERIES:
            got = broker.sql(q).to_pandas()
            assert (broker.engine.last_stats.get("cluster") or {}) \
                .get("mode") == "scatter", q
            assert got.equals(env.single.sql(q).to_pandas()), q
    finally:
        broker.close()


def test_jax_broker_over_port_historicals(env):
    broker = jsdot.Context({
        "sdot.persist.path": env.root, "sdot.cluster.nodes": env.nodes_csv,
        "sdot.cluster.role": "broker",
        "sdot.cluster.probe.interval.seconds": 0})
    single = jsdot.Context({"sdot.persist.path": env.root})
    try:
        for q in EXACT_QUERIES:
            got = broker.sql(q).to_pandas()
            assert (broker.engine.last_stats.get("cluster") or {}) \
                .get("mode") == "scatter", q
            assert got.equals(single.sql(q).to_pandas()), q
            # and the JAX broker's answer is the port broker's
            assert_answers_equal(env.broker.sql(q).to_pandas(), got,
                                 ordered=True)
    finally:
        broker.close()
        single.close()


def test_historical_partials_equal_jax(env, jax_hist):
    """One subquery per shard answered by a port historical and by a JAX
    historical: the same partial, integers, dimensions and raw sketch
    registers exact."""
    _, jhist = jax_hist
    sub = S.GroupByQuerySpec(
        datasource="sales",
        dimensions=(S.DimensionSpec("region", "region"),),
        aggregations=(S.AggregationSpec("count", "c"),
                      S.AggregationSpec("longsum", "q", field="qty"),
                      S.AggregationSpec("cardinality", "d",
                                        field="product")))
    from spark_druid_olap_tpu_torch.ir import serde
    body = json.dumps(serde.query_to_dict(sub)).encode()
    dp = env.hist[0].plan.datasources["sales"]
    for sh in dp.shards:
        nid = sh.owners[0]
        raw = WIRE.patch_subquery(body, shard_name("sales", sh.index,
                                                   dp.n_shards))
        pc, pb, _ = env.hist[nid].handle_subquery(raw)
        jc, jb, _ = jhist[nid].handle_subquery(raw)
        assert pc == jc == 200
        pcols, pdata, _ = WIRE.decode_result(pb)
        jcols, jdata, _ = JWIRE.decode_result(jb)
        assert pcols == jcols
        for c in pcols:
            assert pdata[c].shape == jdata[c].shape, c
            if pdata[c].dtype == object:
                assert list(pdata[c]) == list(jdata[c]), c
            else:
                np.testing.assert_array_equal(pdata[c], jdata[c], err_msg=c)
        assert pdata["d"].ndim == 2          # raw registers, not estimates


# -- the device rule ----------------------------------------------------------

def test_historical_and_entry_point_refuse_without_cuda(env, monkeypatch):
    from spark_druid_olap_tpu_torch.cluster import __main__ as CM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    common = {"sdot.persist.path": env.root,
              "sdot.cluster.nodes": "127.0.0.1:1"}
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HistoricalNode(dict(common), node_id=0, device=dev)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CM.main(["historical", "--persist", env.root,
                 "--nodes", "127.0.0.1:1", "--node-id", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CM.main(["broker", "--persist", env.root,
                 "--nodes", "127.0.0.1:1", "--port", "0"])
    assert HistoricalNode(dict(common), node_id=0,
                          device="cpu").device.type == "cpu"


# -- failover + rejoin (mutating: keep these last) ----------------------------

def test_failover_mid_storm_zero_mismatches(env):
    queries = [
        "select region, sum(qty) as q, count(*) as c from sales "
        "group by region order by region",
        "select product, sum(price) as rev from sales "
        "group by product order by rev desc limit 5",
        "select status, count(*) as c from sales group by status "
        "order by status",
    ]
    want = [env.single.sql(q).to_pandas() for q in queries]
    mismatches, errors = [], []
    started = threading.Event()

    def storm(worker):
        for i in range(12):
            q = queries[(worker + i) % len(queries)]
            try:
                got = env.broker.sql(q).to_pandas()
            except Exception as e:  # noqa: BLE001 — collected + asserted
                errors.append(e)
                return
            started.set()
            ref = want[(worker + i) % len(queries)]
            if not got.equals(ref):
                try:
                    assert_frames_equal(got, ref, rtol=RTOL, atol=ATOL)
                except AssertionError as e:
                    mismatches.append((q, str(e)))

    before = env.broker.cluster.counters["failovers"]
    threads = [threading.Thread(target=storm, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    # kill node 1 while the storm is in flight (after its first answer)
    assert started.wait(60)
    env.hist[1].ready = False
    env.hist[1].server.stop(join_timeout_s=0.2)
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors[:1]
    assert mismatches == [], mismatches[:2]
    # the broker noticed: reactive failover and/or the prober marked it
    assert wait_until(lambda: env.broker.cluster.stats()["nodes"][1]
                      ["state"] == "down", 5.0)
    assert env.broker.cluster.counters["failovers"] >= before


def test_dead_replica_still_answers_exactly(env):
    # node 1 is down from the previous test: every shard it owned must
    # be served by its replica on node 0, with identical answers
    _diff_sql(env, "select region, sum(price) as rev from sales "
                   "group by region order by region")


def test_stale_node_rejoin(env):
    # restart node 1 on the same port; the prober must mark it up and
    # scatter must resume using it — no operator action, no broker restart
    env.hist[1].stop()
    node = restart_on_same_port(
        "port", {"sdot.persist.path": env.root,
                 "sdot.cluster.nodes": env.nodes_csv}, 1)
    env.hist[1] = node
    assert wait_until(lambda: env.broker.cluster.stats()["nodes"][1]
                      ["state"] == "up", 15.0)
    got = _diff_sql(env, "select flag, sum(qty) as q from sales "
                         "group by flag order by flag")
    assert len(got) == 3
