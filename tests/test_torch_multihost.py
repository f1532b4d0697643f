"""The multi-process mesh of the port against the JAX package.

From JAX ``tests/test_multihost.py`` (host assignment, host-blocked
layouts, partial stores, the streamed per-host ingest, two real
processes), ``tests/test_result_cache.py``'s wave-layout budget cases and
``tests/test_rollup.py``'s paged gather. The units run in this process;
the integration runs two real processes of the port
(``spark_druid_olap_tpu_torch/tools/multihost_worker.py``) over
``torch.distributed`` with gloo on the CPU, each holding only its own
segments' rows, and holds their answers against the JAX package's
single-process answers on its emulated 8-device mesh (JAX's own
two-process test skips here: its CPU build has no cross-process
collectives) and against the port's single process.

Tolerance: dimensions, integers, counts, min / max, search counts, select
pages and sketch estimates exact; float sums rtol 1e-6 (float metric
columns are stored f32, and the packages sum in different orders). The
two ranks' answers are byte for byte the same (their digests).
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest
import torch

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.ir import spec as JS
from spark_druid_olap_tpu.parallel import multihost as JMH
from spark_druid_olap_tpu.parallel.mesh import make_mesh as jmake_mesh
from spark_druid_olap_tpu.segment.ingest import \
    ingest_dataframe as jingest
from spark_druid_olap_tpu.segment.stream_ingest import \
    ingest_parquet_stream as jstream

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.ops.scan import (
    ROW_VALID_KEY,
    build_array,
    build_array_blocks,
)
from spark_druid_olap_tpu_torch.parallel import multihost as TMH
from spark_druid_olap_tpu_torch.parallel.executor import _host_column_values
from spark_druid_olap_tpu_torch.parallel.mesh import make_mesh
from spark_druid_olap_tpu_torch.segment.ingest import \
    ingest_dataframe as tingest
from spark_druid_olap_tpu_torch.segment.store import (
    datasource_from_arrays,
    restrict_to_host,
)
from spark_druid_olap_tpu_torch.segment.stream_ingest import \
    ingest_parquet_stream as tstream
from spark_druid_olap_tpu_torch.tools import multihost_worker as W

from conftest import make_sales_df

RTOL = 1e-6


# -- host assignment and layouts ------------------------------------------------

ASSIGN_CASES = {
    "balanced": (np.full(40, 1000), 4),
    "one_big_leading": (np.array([10_000] + [100] * 30), 2),
    "more_hosts_than_segments": (np.array([5, 5]), 4),
    "seeded": (np.random.default_rng(3).integers(1, 5000, 57), 3),
    "one_host": (np.full(9, 10), 1),
}


@pytest.mark.parametrize("case", list(ASSIGN_CASES))
def test_assignment_matches_jax(case):
    rows, n = ASSIGN_CASES[case]
    got = TMH.assign_segments_to_hosts(rows, n)
    np.testing.assert_array_equal(got, JMH.assign_segments_to_hosts(rows, n))
    assert got.tolist() == sorted(got.tolist())      # contiguous blocks


LAYOUT_CASES = {
    "aligned": (np.array([0, 0, 0, 1, 1, 1]), np.array([0, 2, 3, 5]), 2, 2),
    "skewed": (np.array([0, 0, 0, 0, 1]), np.arange(5), 2, 2),
    "empty_host": (np.array([0, 0, 1, 1]), np.array([0, 1]), 2, 4),
    "seeded": (np.repeat(np.arange(3), 7), np.sort(
        np.random.default_rng(5).choice(21, 13, replace=False)), 3, 2),
}


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_layout_segments_matches_jax(case):
    a, seg, n_hosts, dph = LAYOUT_CASES[case]
    got, per = TMH.layout_segments(a, seg, n_hosts, dph)
    want, jper = JMH.layout_segments(a, seg, n_hosts, dph)
    np.testing.assert_array_equal(got, want)
    assert per == jper and per % dph == 0
    for h in range(n_hosts):           # each host's block holds its own
        blk = got[h * per:(h + 1) * per]
        assert (a[blk[blk >= 0]] == h).all()
    assert sorted(got[got >= 0].tolist()) == sorted(seg.tolist())


WAVE_CASES = {
    # (assignment, seg_idx, n_hosts, dph, n_waves, seg_bytes, budget)
    "balanced": (np.repeat([0, 1], 8), np.arange(16), 2, 2, 3, 0, 0),
    "pruned": (np.repeat([0, 1, 2], 5), np.array([1, 2, 6, 7, 8, 14]),
               3, 1, 2, 0, 0),
    # JAX test_result_cache.py: every segment on host 0 of 2, 2 waves
    # planned for a balanced split, a budget of one segment per device
    "budget_caps_skewed_host": (np.zeros(10, np.int64), np.arange(10),
                                2, 2, 2, 100, 150),
    "unbudgeted_skew": (np.zeros(10, np.int64), np.arange(10), 2, 2, 2,
                        0, 0),
}


@pytest.mark.parametrize("case", list(WAVE_CASES))
def test_layout_segments_waves_matches_jax(case):
    a, seg, n_hosts, dph, n_waves, sb, budget = WAVE_CASES[case]
    got, spw = TMH.layout_segments_waves(a, seg, n_hosts, dph, n_waves,
                                         seg_bytes=sb, wave_budget=budget)
    want, jspw = JMH.layout_segments_waves(a, seg, n_hosts, dph, n_waves,
                                           seg_bytes=sb, wave_budget=budget)
    np.testing.assert_array_equal(got, want)
    assert spw == jspw
    assert sorted(got[got >= 0].tolist()) == sorted(seg.tolist())
    if budget:
        phw = spw // n_hosts
        assert phw == 2
        for w in range(len(got) // spw):
            for h in range(n_hosts):
                blk = got[w * spw + h * phw: w * spw + (h + 1) * phw]
                assert (blk >= 0).sum() / dph * sb <= budget


def test_host_blocks_of_one_process_match_jax():
    assert TMH.host_blocks(make_mesh(devices=("cpu",) * 8)) \
        == JMH.host_blocks(jmake_mesh()) == (1, 8)
    assert TMH.host_blocks(None) == (1, 1)
    assert TMH.process_count() == 1 and TMH.process_index() == 0
    assert not TMH.is_multihost()


def test_initialize_chooses_no_backend():
    with pytest.raises(RuntimeError, match="nccl.*not available"):
        TMH.initialize("tcp://127.0.0.1:1", 1, 0, "nccl", timeout=5)
    with pytest.raises(ValueError, match="backend"):
        TMH.initialize("tcp://127.0.0.1:1", 1, 0, "auto", timeout=5)
    assert not TMH.is_multihost()


# -- the partial store ----------------------------------------------------------

def _frame(n=4000, seed=11):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "ts": pd.Timestamp("2022-01-01")
        + pd.to_timedelta(rng.integers(0, 90, n), unit="D"),
        "k": rng.choice(list("abcdef"), n),
        "v": rng.normal(size=n).round(3),
        "q": rng.integers(0, 100, n),
        "nv": np.where(np.arange(n) % 7 == 0, np.nan,
                       rng.normal(size=n)),
    })


def _arrays(ds):
    """Every stored array of a datasource, by name."""
    out = {"__days__": ds.time.days, "__ms__": ds.time.ms_in_day}
    for n, d in ds.dims.items():
        out[f"{n}.codes"] = d.codes
        out[f"{n}.dict"] = np.asarray(d.dictionary, dtype=object)
        if d.validity is not None:
            out[f"{n}.valid"] = d.validity
    for n, m in ds.metrics.items():
        out[f"{n}.values"] = m.values
        if m.validity is not None:
            out[f"{n}.valid"] = m.validity
    return out


def _same_store(got, want):
    ga, wa = _arrays(got), _arrays(want)
    assert ga.keys() == wa.keys()
    for k in wa:
        assert ga[k].dtype == wa[k].dtype, k
        np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)
    assert [(s.start_row, s.end_row, s.min_millis, s.max_millis)
            for s in got.segments] == \
        [(s.start_row, s.end_row, s.min_millis, s.max_millis)
         for s in want.segments]
    np.testing.assert_array_equal(got.host_assignment, want.host_assignment)
    np.testing.assert_array_equal(got.local_seg_ids, want.local_seg_ids)
    for n, m in want.metrics.items():
        assert got.metrics[n].min == m.min and got.metrics[n].max == m.max
    assert got.padded_rows == want.padded_rows


@pytest.fixture(scope="module")
def partials():
    df = _frame()
    full = tingest("t", df, time_column="ts", target_rows=512)
    parts = [tingest("t", df, time_column="ts", target_rows=512,
                     n_hosts=2, host_id=h) for h in (0, 1)]
    jparts = [jingest("t", df, time_column="ts", target_rows=512,
                      n_hosts=2, host_id=h) for h in (0, 1)]
    return full, parts, jparts


@pytest.mark.parametrize("host", [0, 1])
def test_partial_ingest_equals_jax_restrict(partials, host):
    full, parts, jparts = partials
    p = parts[host]
    assert p.is_partial and jparts[host].is_partial
    _same_store(p, jparts[host])
    # each host holds only its own rows
    assert len(p.metrics["v"].values) == p.local_num_rows < p.num_rows
    assert p.local_num_rows == jparts[host].local_num_rows
    # the JAX partial store carried across array for array is the same
    j = jparts[host]
    carried = datasource_from_arrays("t", {
        "time": {"name": "ts", "millis": j.time.millis},
        "segments": [(s.start_row, s.end_row) for s in j.segments],
        "segment_millis": [(s.min_millis, s.max_millis)
                           for s in j.segments],
        "host_assignment": j.host_assignment, "host_id": j.host_id,
        "metric_bounds": {n: (m.min, m.max) for n, m in j.metrics.items()},
        "columns": {**{n: {"kind": "dimension", "values": d.codes,
                           "validity": d.validity,
                           "dictionary": list(d.dictionary)}
                       for n, d in j.dims.items()},
                    **{n: {"kind": m.kind.value, "values": m.values,
                           "validity": m.validity}
                       for n, m in j.metrics.items()}}})
    _same_store(carried, p)


def test_partial_blocks_reassemble_to_full(partials):
    full, parts, _ = partials
    for key in ("k", "v", "q", "nv", "__nulls__nv", ROW_VALID_KEY):
        whole = build_array(full, key)
        for p in parts:
            got = build_array_blocks(p, key, p.local_seg_ids)
            np.testing.assert_array_equal(got, whole[p.local_seg_ids])
            np.testing.assert_array_equal(build_array(p, key), got)
    ids0 = set(parts[0].local_seg_ids.tolist())
    ids1 = set(parts[1].local_seg_ids.tolist())
    assert ids0.isdisjoint(ids1)
    assert ids0 | ids1 == set(range(full.num_segments))


def test_partial_padding_slots_are_empty(partials):
    _, parts, _ = partials
    p = parts[0]
    ids = np.concatenate([p.local_seg_ids[:1], [-1, -1]])
    rv = build_array_blocks(p, ROW_VALID_KEY, ids)
    assert rv[1:].sum() == 0 and rv[0].sum() > 0
    assert (build_array_blocks(p, "q", ids)[1:] == 0).all()


def test_partial_rejects_remote_segments(partials):
    _, (p0, p1), _ = partials
    with pytest.raises(RuntimeError, match="non-local"):
        build_array_blocks(p0, "k", p1.local_seg_ids[:1])


def test_partial_guards_host_paths_and_keeps_metadata_global(partials):
    full, parts, _ = partials
    p = parts[0]
    assert p.num_rows == full.num_rows
    assert p.interval() == full.interval()
    assert p.metrics["v"].min == full.metrics["v"].min
    with pytest.raises(RuntimeError, match="partial store"):
        _host_column_values(p, "k", None)
    with pytest.raises(RuntimeError, match="partial store"):
        p.segment_metric_bounds("v")
    with pytest.raises(RuntimeError, match="partial store"):
        p.complete(columns={"v"})       # one process: no peer to gather
    # time pruning reads metadata; zone maps are skipped
    iv = full.interval()
    mid = (iv[0] + iv[1]) // 2
    assert 0 < len(p.prune_segments([(mid, iv[1])])) < p.num_segments
    bound = TS.BoundFilter("q", lower=200.0, numeric=True)
    assert len(full.prune_segments(None, bound)) == 0
    assert len(p.prune_segments(None, bound)) == p.num_segments
    # global row ids round-trip through the local offsets
    g = p.local_to_global_rows()
    np.testing.assert_array_equal(p.global_to_local_rows(g),
                                  np.arange(p.local_num_rows))
    assert (p.owner_of_rows(g) == 0).all()


@pytest.mark.parametrize("kind", ["select", "search", "aggregate"])
def test_single_process_partial_store_raises(partials, kind):
    """A partial store in one process has no peers: select and search
    raise ``require_complete``'s error (as in the JAX package), and so
    does an aggregation."""
    ctx = tsdot.Context(device="cpu")
    ctx.store.register(partials[1][0])
    q = {"select": TS.SelectQuerySpec("t", ("k", "v")),
         "search": TS.SearchQuerySpec("t", ("k",), "a"),
         "aggregate": TS.TimeseriesQuerySpec("t", (TS.AggregationSpec(
             "longsum", "s", field="q"),))}[kind]
    with pytest.raises(RuntimeError, match="requires the complete "
                                           "datasource"):
        ctx.execute(q)


# -- the streamed per-host ingest -----------------------------------------------

@pytest.mark.parametrize("host", [0, 1])
def test_stream_partial_matches_jax(tmp_path, host):
    df = _frame(n=6000, seed=5)
    path = str(tmp_path / "t.parquet")
    df.to_parquet(path)
    kw = dict(time_column="ts", target_rows=512, batch_rows=777)
    got = tstream("t", path, n_hosts=2, host_id=host, **kw)
    want = jstream("t", path, n_hosts=2, host_id=host, **kw)
    assert got.is_partial
    _same_store(got, want)
    # this host allocated only its own rows
    assert len(got.metrics["v"].values) == got.local_num_rows < got.num_rows
    full = tstream("t", path, **kw)
    for key in ("k", "v", "q", "nv", "__nulls__nv"):
        np.testing.assert_array_equal(
            build_array_blocks(got, key, got.local_seg_ids),
            build_array(full, key)[got.local_seg_ids], err_msg=key)


# -- the host tier's paged gather ---------------------------------------------

def test_complete_paged_gather_respects_page_bytes(monkeypatch):
    """JAX tests/test_rollup.py's paged gather, with a fake exchange: a
    host owning every segment reassembles the column, in strictly more,
    byte-bounded exchanges under a small page budget."""
    ds = tingest("sales", make_sales_df(n=6000), time_column="ts",
                 target_rows=1024)
    assignment = np.zeros(ds.num_segments, dtype=np.int32)
    calls = []

    def fake_exchange(block):
        calls.append(np.asarray(block).nbytes)
        return [np.asarray(block)]

    monkeypatch.setattr(TMH, "is_multihost", lambda: True)
    monkeypatch.setattr(TMH, "exchange_block", fake_exchange)
    full = restrict_to_host(ds, assignment, 0).complete(
        columns={"qty"}, page_bytes=1 << 30)
    np.testing.assert_array_equal(full.metrics["qty"].values,
                                  ds.metrics["qty"].values)
    np.testing.assert_array_equal(full.time.days, ds.time.days)
    one_page_calls = len(calls)
    calls.clear()
    full2 = restrict_to_host(ds, assignment, 0).complete(
        columns={"qty"}, page_bytes=1 << 10)
    np.testing.assert_array_equal(full2.metrics["qty"].values,
                                  ds.metrics["qty"].values)
    assert len(calls) > one_page_calls
    assert max(calls) <= 1 << 10


# -- two real processes over gloo ------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mh") / "basic")
    return W.spawn(2, out, "basic", device="cpu", backend="gloo",
                   timeout_s=240)


@pytest.fixture(scope="module")
def jax_single():
    """The JAX package's answers over the complete store on its emulated
    8-device mesh."""
    ctx = jsdot.Context(mesh=jmake_mesh())
    ctx.ingest_dataframe("sales", W.make_frame(), time_column="ts",
                         target_rows=4096)
    return W.run_basic(ctx, JS)


@pytest.fixture(scope="module")
def port_single():
    """The port's answers over the complete store in one process (an
    8-slot CPU mesh)."""
    ctx = tsdot.Context({"sdot.cache.enabled": False}, device="cpu",
                        mesh=make_mesh(devices=("cpu",) * 8))
    ctx.ingest_dataframe("sales", W.make_frame(), time_column="ts",
                         target_rows=4096)
    return W.run_basic(ctx)


STATEMENTS = list(W.QUERIES) + [f"waved_{n}" for n in W.WAVED] \
    + ["select_page", "search", "host_gather"]


def _rows_equal(name, g, r):
    assert g["columns"] == r["columns"], name
    assert len(g["rows"]) == len(r["rows"]), name
    for grow, rrow in zip(g["rows"], r["rows"]):
        for gv, rv in zip(grow, rrow):
            if isinstance(rv, float) or isinstance(gv, float):
                assert gv == pytest.approx(rv, rel=RTOL, abs=1e-9), \
                    (name, grow, rrow)
            else:
                assert gv == rv, (name, grow, rrow)


@pytest.mark.parametrize("name", STATEMENTS)
def test_two_processes_match_jax_single_process(ranks, jax_single, name):
    g, r = ranks[0][name], jax_single[name]
    _rows_equal(name, g, r)
    if name in W.QUERIES or name.startswith("waved_"):
        assert g["mode"] == "engine", (name, g["mode"])
        assert g["sharded"] or not r["sharded"], name
        assert g["multihost"]["ranks"] == 2
        assert g["multihost"]["collectives"] > 0


@pytest.mark.parametrize("name", STATEMENTS + ["storm"])
def test_two_processes_match_port_single_process(ranks, port_single, name):
    if name == "storm":
        for g, r in zip(ranks[0]["storm"]["answers"],
                        port_single["storm"]["answers"]):
            _rows_equal(name, g, r)
        return
    _rows_equal(name, ranks[0][name], port_single[name])


def test_ranks_answer_byte_for_byte_alike(ranks):
    def digests(res):
        out = {n: v["digest"] for n, v in res.items()
               if isinstance(v, dict) and "digest" in v}
        out["storm"] = [a["digest"] for a in res["storm"]["answers"]]
        return out
    assert digests(ranks[0]) == digests(ranks[1])
    assert len(digests(ranks[0])) == len(STATEMENTS) + 1


def test_two_process_paths(ranks):
    r0 = ranks[0]
    # forced waves compose with the host-blocked layout
    assert r0["waved_dense"]["waves"] > 1
    assert r0["waved_hashed"]["waves"] > 1
    # the host tier gathered the partial store instead of raising
    assert r0["host_gather"]["mode"].startswith("host")
    assert r0["select_page"]["select_filter"] == "host-local"
    # the coalescer declined the partial store: each ran solo
    assert r0["storm"]["coalesced"] == 0
    for res in ranks:
        st = res["_store"]
        assert st["partial"]
        assert 0 < st["local_segments"] < st["segments"]
        assert st["local_rows"] < st["rows"]
        assert set(st["column_rows"].values()) == {st["local_rows"]}
    assert sum(r["_store"]["local_rows"] for r in ranks) \
        == ranks[0]["_store"]["rows"]


def test_explain_on_one_rank_issues_no_collective(ranks):
    """EXPLAIN over the partial store, on rank 0 alone and before any
    statement, plans through the host-blocked layout without issuing a
    collective (the other rank never joins one); the statements that
    follow on both ranks still agree (the tests above)."""
    ex = ranks[0]["explain"]
    assert ex["collectives"] == 0, ex
    assert "xhost_bytes=" in ex["text"], ex["text"]
    assert "unavailable" not in ex["text"] and "waves=?" not in ex["text"]
    assert "explain" not in ranks[1]


def test_initialize_refuses_ranks_of_unequal_slots(tmp_path):
    """Every rank must drive as many slots (the host-homogeneous pod):
    ``initialize`` checks it once, so that planning needs no collective."""
    with pytest.raises(RuntimeError, match="slots each"):
        W.spawn(2, str(tmp_path / "uneven"), "probe", device="cpu;cpu,cpu",
                backend="gloo", timeout_s=120)


def test_spawn_names_no_default_device(tmp_path):
    """``spawn`` has no default device: a call that does not name one
    raises before any rank starts, so no entry point of the port falls
    back to the CPU unasked."""
    with pytest.raises(TypeError, match="device"):
        W.spawn(2, str(tmp_path / "nodev"), "probe", backend="gloo",
                timeout_s=5)
    assert not list(tmp_path.iterdir())


def test_gather_partials_packs_views_and_dtypes(monkeypatch):
    """The device merge's packing: every tensor of a partial (views with
    odd strides, a one-element view, bool, float32, int64) travels as
    bytes and comes back as it was, once per rank in rank order."""
    calls = []

    def fake_all_gather(buf, group):
        calls.append(buf.numel())
        return torch.stack([buf, buf])          # two ranks, the same bytes

    monkeypatch.setattr(TMH, "process_count", lambda: 2)
    monkeypatch.setattr(TMH, "_all_gather_bytes", fake_all_gather)
    base = torch.arange(12, dtype=torch.int64).reshape(6, 2)
    part = {"one": base[:1, 1], "col": base[:, 1],
            "mask": torch.tensor([True, False, True]),
            "f32": torch.linspace(0, 1, 5, dtype=torch.float32),
            "reg": torch.arange(8, dtype=torch.int32).reshape(2, 4)}
    got = TMH.gather_partials([part])
    assert len(got) == 2 and len(calls) == 1
    for rank in got:
        for k, v in part.items():
            assert rank[0][k].dtype == v.dtype and torch.equal(rank[0][k], v)


def test_threads_take_turns_the_ranks_agree_on(tmp_path, port_single):
    """Ten statements at once from threads on each rank, submitted in a
    different order on each, under a short switch interval: each answer
    equals the single process's, on both ranks byte for byte (the
    statement sequencer orders their collectives)."""
    got = W.spawn(2, str(tmp_path / "threads"), "threads", device="cpu",
                  backend="gloo", timeout_s=240)
    assert got[0]["_order"] != got[1]["_order"]
    for name, sql in W.QUERIES.items():
        assert got[0][name]["digest"] == got[1][name]["digest"], name
        _rows_equal(name, got[0][name], port_single[name])
    for i in range(len(W.STORM)):
        assert got[0][f"storm{i}"]["digest"] == got[1][f"storm{i}"]["digest"]
        _rows_equal(f"storm{i}", got[0][f"storm{i}"],
                    port_single["storm"]["answers"][i])


def test_estimate_prices_the_host_gather_of_a_partial_store(partials):
    """``cost.estimate`` over a partial store: the host tier's gather of
    the statement's columns (``host_xhost_bytes``) as the JAX package
    prices it, shown on explain's line; no cross-process term in one
    process."""
    from spark_druid_olap_tpu.parallel.cost import estimate as jestimate
    from spark_druid_olap_tpu_torch.parallel.cost import estimate
    _, parts, jparts = partials
    specs = [S.GroupByQuerySpec("t", (S.DimensionSpec("k", "k"),),
                                (S.AggregationSpec("doublesum", "s",
                                                   field="v"),))
             for S in (TS, JS)]
    tctx, jctx = tsdot.Context(device="cpu"), jsdot.Context()
    tctx.store.register(parts[0])
    jctx.store.register(jparts[0])
    got, want = estimate(tctx, specs[0]), jestimate(jctx, specs[1])
    assert got.host_xhost_bytes == want.host_xhost_bytes > 0
    assert got.xhost_bytes == want.xhost_bytes == 0
    assert f"host_xhost_bytes={got.host_xhost_bytes:,}" in got.table()
