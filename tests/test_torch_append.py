"""The port's streaming append against the JAX package's.

The cases of ``tests/test_stream_append.py`` that need neither the
write-ahead log nor checkpoints (10 of 12) run through both packages'
``Context.stream_ingest`` on the same numpy-seeded batches (the port on the
CPU). After every append the store is held bit for bit against the JAX
package's: segments (ids, rows, time bounds), time columns, each
dimension's dictionary, codes and validity, each metric's dtype, values
and validity. Answers are equal to the JAX engine's (dimensions, integers
and counts exact, float sums rtol 1e-6) and, for the differential against
one batch ingest, to ``conftest.assert_frames_equal``.

The two WAL cases run through both packages with ``sdot.persist.path``
set (an empty batch journals nothing; appends racing checkpoints recover
to the live store, equal across packages), beside a journaled append that
recovers in a fresh context and the port's one column build (a thread
pool above a batch-row floor) held equal to both of the JAX package's
builds, parallel and serial.

Beyond the JAX cases: a scan of a pruned segment selection after two
appends with ``id`` forced to collide across datasource versions (the bind
cache and the program cache once keyed on ``id(ds)``; the answer is held
against pandas, ROADMAP §C), multi-wave scans and a shared-scan storm over
appended segments that break global time order, the storm's first run
after a metric widening, the ``ingest`` WLM lane, the branches the port
leaves out, and the port's dictionary merge against the JAX package's
formulation on random dictionaries.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import builtins
import threading

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.segment.append import (
    append_dataframe as jappend)

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.parallel import executor as TEX
from spark_druid_olap_tpu_torch.parallel import sharedscan as TSS
from spark_druid_olap_tpu_torch.segment.append import (
    append_dataframe as tappend)
from spark_druid_olap_tpu_torch.segment.store import Datasource as TDatasource

from conftest import assert_frames_equal
from test_torch_sql import assert_answers_equal


def _batch(n, seed, null_product_rate=0.0):
    r = np.random.default_rng(seed)
    start = np.datetime64("2023-06-01")
    df = pd.DataFrame({
        "ts": (start + r.integers(0, 60, n).astype("timedelta64[D]")
               ).astype("datetime64[ns]"),
        "region": r.choice(["east", "west", "north"], n),
        "product": r.choice([f"p{i}" for i in range(8)], n),
        "qty": r.integers(0, 50, n),
        "price": np.round(r.uniform(1, 9, n), 2),
    })
    if null_product_rate:
        df.loc[df.sample(frac=null_product_rate,
                         random_state=seed).index, "product"] = None
    return df


INGEST = dict(time_column="ts", dimensions=["region", "product"],
              metrics=["qty", "price"])

QS = [
    "select region, sum(qty) as q, count(*) as n from sales "
    "group by region order by region",
    "select product, sum(price) as p from sales "
    "where region = 'east' group by product order by product",
    "select count(*) as n from sales where product is null",
]


def _pair(**cfg):
    return jsdot.Context(cfg or None), tsdot.Context(cfg or None,
                                                     device="cpu")


def _arr_equal(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def assert_same_store(j, t):
    """Two datasources bit for bit: segments, time, dims, metrics."""
    assert [(s.id, s.start_row, s.end_row, s.min_millis, s.max_millis)
            for s in t.segments] == \
        [(s.id, s.start_row, s.end_row, s.min_millis, s.max_millis)
         for s in j.segments]
    assert (t.time is None) == (j.time is None)
    if j.time is not None:
        _arr_equal(t.time.days, j.time.days, "time days")
        _arr_equal(t.time.ms_in_day, j.time.ms_in_day, "time ms")
    assert list(t.dims) == list(j.dims)
    for k in j.dims:
        assert list(t.dims[k].dictionary) == list(j.dims[k].dictionary), k
        _arr_equal(t.dims[k].codes, j.dims[k].codes, f"{k} codes")
        _arr_equal(t.dims[k].validity, j.dims[k].validity, f"{k} validity")
    assert list(t.metrics) == list(j.metrics)
    for k in j.metrics:
        assert t.metrics[k].kind.value == j.metrics[k].kind.value, k
        _arr_equal(t.metrics[k].values, j.metrics[k].values, f"{k} values")
        _arr_equal(t.metrics[k].validity, j.metrics[k].validity,
                   f"{k} validity")


def _ingest_both(pair, name, df, **kw):
    out = [c.stream_ingest(name, df, **kw) for c in pair]
    assert_same_store(*out)
    return out


def _sql_both(pair, sql, ordered=True):
    want, got = (c.sql(sql).to_pandas() for c in pair)
    assert_answers_equal(got, want, ordered)
    return got


def test_append_differential_vs_batch_ingest():
    batches = [_batch(500, 1), _batch(300, 2, 0.1), _batch(200, 3)]
    pair = _pair()
    for b in batches:
        _ingest_both(pair, "sales", b, **INGEST)
    whole = tsdot.Context(device="cpu")
    whole.ingest_dataframe("sales", pd.concat(batches, ignore_index=True),
                           **INGEST)
    for q in QS:
        got = _sql_both(pair, q)
        assert_frames_equal(got, whole.sql(q).to_pandas())


def test_empty_batch_is_noop():
    for ctx in _pair():
        ds0 = ctx.stream_ingest("sales", _batch(100, 4), **INGEST)
        v0 = ctx.store.datasource_version("sales")
        ds1 = ctx.stream_ingest("sales", _batch(0, 5).iloc[0:0], **INGEST)
        assert ds1 is ds0                   # same object: nothing changed
        assert ctx.store.datasource_version("sales") == v0


def test_all_null_dim_column_append():
    pair = _pair()
    _ingest_both(pair, "sales", _batch(60, 8), **INGEST)
    nb = _batch(40, 9)
    nb["product"] = None
    _ingest_both(pair, "sales", nb, **INGEST)
    got = _sql_both(pair, "select count(*) as n from sales "
                          "where product is null")
    assert int(got["n"][0]) == 40
    # and the reverse: a base whose dim starts all-null gains values
    pair = _pair()
    b0 = _batch(30, 10)
    b0["product"] = None
    _ingest_both(pair, "t", b0, **INGEST)
    _ingest_both(pair, "t", _batch(20, 11), **INGEST)
    got = _sql_both(pair, "select count(*) as n from t "
                          "where product is not null")
    assert int(got["n"][0]) == 20


def test_all_null_metric_column_append():
    pair = _pair()
    _ingest_both(pair, "sales", _batch(50, 12), **INGEST)
    nb = _batch(25, 13)
    nb["qty"] = None
    _ingest_both(pair, "sales", nb, **INGEST)
    got = _sql_both(pair, "select count(qty) as n, count(*) as m "
                          "from sales")
    assert int(got["n"][0]) == 50 and int(got["m"][0]) == 75


def test_missing_column_appends_as_null():
    pair = _pair()
    _ingest_both(pair, "sales", _batch(40, 14), **INGEST)
    _ingest_both(pair, "sales", _batch(10, 15).drop(columns=["price"]),
                 **INGEST)
    got = _sql_both(pair, "select count(price) as n, count(*) as m "
                          "from sales")
    assert int(got["n"][0]) == 40 and int(got["m"][0]) == 50


def test_unknown_column_rejected():
    pair = _pair()
    ds = _ingest_both(pair, "sales", _batch(20, 16), **INGEST)
    bad = _batch(5, 17)
    bad["surprise"] = 1
    for append, d in ((jappend, ds[0]), (tappend, ds[1])):
        with pytest.raises(ValueError, match="surprise"):
            append(d, bad)


def test_dictionary_merge_remaps_old_codes():
    pair = _pair()
    b1 = _batch(50, 18)
    b1["region"] = np.random.default_rng(18).choice(["m", "z"], 50)
    _ingest_both(pair, "sales", b1, **INGEST)
    b2 = _batch(50, 19)
    b2["region"] = np.random.default_rng(19).choice(["a", "q"], 50)
    _ingest_both(pair, "sales", b2, **INGEST)
    d = pair[1].store.get("sales").dims["region"]
    assert list(d.dictionary) == sorted(d.dictionary)   # stays sorted
    # order-preserving codes: range pushdown is still right
    got = _sql_both(pair, "select count(*) as n from sales "
                          "where region > 'l'")
    assert int(got["n"][0]) == int((pd.concat([b1, b2])["region"]
                                    > "l").sum())


def test_metric_dtype_widens_on_append():
    pair = _pair()
    b1 = _batch(30, 20)
    b1["qty"] = np.arange(30, dtype=np.int64)           # narrow
    _ingest_both(pair, "sales", b1, **INGEST)
    assert pair[1].store.get("sales").metrics["qty"].values.dtype \
        .itemsize <= 2
    b2 = _batch(10, 21)
    b2["qty"] = np.int64(3_000_000_000) + np.arange(10)  # needs int64
    _ingest_both(pair, "sales", b2, **INGEST)
    assert pair[1].store.get("sales").metrics["qty"].values.dtype \
        == np.int64
    got = _sql_both(pair, "select max(qty) as m, sum(qty) as s from sales")
    assert int(got["m"][0]) == 3_000_000_009


def test_append_bumps_version_and_marks_rollup_stale():
    pair = _pair()
    _ingest_both(pair, "sales", _batch(80, 22), **INGEST)
    for ctx in pair:
        ctx.sql("create rollup s_r on sales dimensions (region) "
                "aggregations (sum(qty))")
    v0 = [c.store.datasource_version("sales") for c in pair]
    _ingest_both(pair, "sales", _batch(20, 23), **INGEST)
    for c, v in zip(pair, v0):
        assert c.store.datasource_version("sales") > v
        rv = c.sql("select fresh from sys_rollups").to_pandas()
        assert bool(rv["fresh"][0]) is False


def test_append_without_time_column():
    pair = _pair()
    df1 = pd.DataFrame({"k": ["a", "b"], "v": [1, 2]})
    _ingest_both(pair, "kv", df1, dimensions=["k"], metrics=["v"])
    _ingest_both(pair, "kv", pd.DataFrame({"k": ["c"], "v": [9]}),
                 dimensions=["k"], metrics=["v"])
    got = _sql_both(pair, "select k, sum(v) as v from kv "
                          "group by k order by k")
    assert list(got["k"]) == ["a", "b", "c"]
    assert list(got["v"]) == [1, 2, 9]


# -- beyond the JAX cases -----------------------------------------------------

def _regions_batch(n, seed, regions, start):
    r = np.random.default_rng(seed)
    return pd.DataFrame({
        "ts": pd.Timestamp(start)
        + pd.to_timedelta(r.integers(0, 30, n), unit="D"),
        "region": r.choice(regions, n),
        "qty": r.integers(0, 50, n).astype(np.int64)})


def test_colliding_datasource_ids_bind_fresh_codes(monkeypatch):
    """Every datasource version gets the same ``id``: the worst case of a
    freed datasource's id being reused by its successor. A scan pruned to
    the same segment selection before and after two appends whose new
    dictionary values remap the old codes must bind the new codes. The
    answer is held against pandas; with the same forced ``id`` the JAX
    engine answers with the old codes (ROADMAP §C)."""
    real_id = builtins.id

    def colliding_id(o):
        return 12345 if isinstance(o, TDatasource) else real_id(o)
    for mod in (TEX, TSS):
        monkeypatch.setattr(mod, "id", colliding_id, raising=False)
    ctx = tsdot.Context(device="cpu")
    b0 = _regions_batch(3000, 1, ["m", "q", "z"], "2023-01-01")
    ctx.stream_ingest("sales", b0, time_column="ts", target_rows=1024)
    sql = ("select region, count(*) as n, sum(qty) as q from sales "
           "where ts < timestamp '2023-01-08' group by region "
           "order by region")
    first = ctx.sql(sql).to_pandas()
    frames = [b0]
    for i, regs in enumerate([["a", "n"], ["b", "r"]]):
        b = _regions_batch(2000, 10 + i, regs, "2023-03-01")
        ctx.stream_ingest("sales", b, time_column="ts", target_rows=1024)
        frames.append(b)
    assert list(ctx.store.get("sales").dims["region"].dictionary) == \
        ["a", "b", "m", "n", "q", "r", "z"]
    got = ctx.sql(sql).to_pandas()
    assert ctx.history.entries()[-1].stats["mode"] == "engine"
    rows = pd.concat(frames)
    rows = rows[rows.ts < pd.Timestamp("2023-01-08")]
    want = rows.groupby("region").agg(n=("qty", "size"), q=("qty", "sum")) \
        .reset_index()
    assert list(got["region"]) == list(want["region"]) == \
        list(first["region"])
    assert list(got["n"]) == list(want["n"])
    assert list(got["q"]) == list(want["q"])


def _appended_pair(**cfg):
    """Both packages, three batches whose times interleave: the appended
    segments break the datasource's global time order."""
    pair = _pair(**cfg)
    for seed, start in ((31, "2023-03-01"), (32, "2023-01-01"),
                        (33, "2023-02-01")):
        b = _regions_batch(3000, seed, ["east", "west", "north", "x" +
                                        str(seed)], start)
        b["price"] = np.round(np.random.default_rng(seed)
                              .uniform(1, 9, len(b)), 2)
        _ingest_both(pair, "sales", b, time_column="ts", target_rows=1024)
    return pair


def test_waves_over_out_of_order_segments():
    """One segment per wave over appended segments out of time order:
    the same answers as one wave and as the JAX engine."""
    pair = _appended_pair()
    sql = ("select region, count(*) as n, sum(qty) as q, "
           "sum(price) as p from sales where ts >= timestamp '2023-01-20' "
           "group by region order by region")
    one = pair[1].sql(sql).to_pandas()
    for c in pair:
        c.config.set("sdot.engine.wave.max.bytes", 1)
    got = _sql_both(pair, sql)
    assert pair[1].history.entries()[-1].stats["waves"] > 1
    assert_answers_equal(got, one, ordered=True)


def _storm_specs(S):
    return [
        S.GroupByQuerySpec("sales", (S.DimensionSpec("region", "region"),),
                           (S.AggregationSpec("longsum", "q", field="qty"),
                            S.AggregationSpec("count", "n"))),
        S.TimeseriesQuerySpec("sales", (
            S.AggregationSpec("doublesum", "p", field="price"),
            S.AggregationSpec("longmax", "mx", field="qty"))),
        S.GroupByQuerySpec("sales", (S.DimensionSpec("region", "region"),),
                           (S.AggregationSpec("longmin", "mn",
                                              field="qty"),),
                           filter=S.SelectorFilter("region", "east")),
    ]


STORM = {"sdot.sharedscan.enabled": True, "sdot.wlm.batch.window.ms": 200.0}


def _storm(ctx, specs):
    out = [None] * len(specs)

    def run(i):
        out[i] = ctx.execute(specs[i]).to_pandas()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(specs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_storm_after_appends_and_a_widening():
    """A storm over appended segments, then an append that widens qty to
    int64: the next storm's fused program reads the wide column (its
    answers equal the solo answers and pandas)."""
    pair = _appended_pair()
    ctx = tsdot.Context(STORM, device="cpu")
    ctx.store.register(pair[1].store.get("sales"))
    specs = _storm_specs(TS)
    for round_ in range(2):
        before = ctx.engine.sharedscan.stats()["queries_coalesced"]
        got = _storm(ctx, specs)
        assert ctx.engine.sharedscan.stats()["queries_coalesced"] \
            - before == len(specs)
        solo = tsdot.Context(device="cpu")
        solo.store.register(ctx.store.get("sales"))
        for g, q in zip(got, specs):
            assert_answers_equal(g, solo.execute(q).to_pandas(),
                                 ordered=False)
        if round_ == 0:
            wide = _regions_batch(500, 40, ["east"], "2023-04-01")
            wide["qty"] = np.int64(5_000_000_000) + np.arange(500)
            wide["price"] = 1.5
            ctx.stream_ingest("sales", wide, time_column="ts",
                              target_rows=1024)
            assert ctx.store.get("sales").metrics["qty"].values.dtype \
                == np.int64
    assert int(got[1]["mx"][0]) == 5_000_000_499


def test_ingest_lane_admits_each_batch():
    """With an ``ingest`` lane configured each batch takes a slot of it
    (the JAX package's ``admit_ingest``); without one, none."""
    for cfg, lanes in (({"sdot.wlm.lanes": "interactive:slots=4;"
                                          "ingest:slots=1"}, 2), ({}, 0)):
        for ctx in _pair(**cfg):
            ctx.stream_ingest("sales", _batch(50, 50), **INGEST)
            ctx.stream_ingest("sales", _batch(50, 51), **INGEST)
            rows = {ln["lane"]: ln for ln in ctx.engine.wlm.stats()["lanes"]}
            admitted = rows["ingest"]["admitted"] if "ingest" in rows else 0
            assert admitted == lanes
            assert all(ln["active"] == 0 for ln in rows.values())


@pytest.mark.parametrize("key,value", [
    ("sdot.cluster.nodes", "localhost:1")])
def test_unported_stream_ingest_branches_raise(key, value):
    ctx = tsdot.Context({key: value}, device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.9"):
        ctx.stream_ingest("sales", _batch(10, 60), **INGEST)


def test_journaled_stream_ingest_answers_and_recovers(tmp_path):
    """With ``sdot.persist.path`` set, ``stream_ingest`` journals each
    batch before it answers, and a fresh context over the root recovers
    every batch, in both packages alike."""
    roots = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    pair = (jsdot.Context({"sdot.persist.path": str(roots["jax"])}),
            tsdot.Context({"sdot.persist.path": str(roots["port"])},
                          device="cpu"))
    _ingest_both(pair, "sales", _batch(80, 61), **INGEST)
    _ingest_both(pair, "sales", _batch(30, 62), **INGEST)
    want = _sql_both(pair, QS[0])
    for c in pair:
        assert c.persist.counters["wal_appends"] == 2
        c.close()
    again = (jsdot.Context({"sdot.persist.path": str(roots["jax"])}),
             tsdot.Context({"sdot.persist.path": str(roots["port"])},
                           device="cpu"))
    assert_same_store(*(c.store.get("sales") for c in again))
    assert_answers_equal(_sql_both(again, QS[0]), want, ordered=True)
    # the first append onto the journaled create publishes a snapshot
    # first (a replay needs a base), so one record stays in the journal
    for c in again:
        info = c.store.recovery_info["sales"]
        assert (info["source"], info["wal_records"]) == ("snapshot+wal", 1)
    for c in again:
        c.close()


def test_empty_batch_writes_no_wal_record(tmp_path):
    for pkg, ctx in (("jax", jsdot.Context(
            {"sdot.persist.path": str(tmp_path / "jax")})),
            ("port", tsdot.Context(
                {"sdot.persist.path": str(tmp_path / "port")},
                device="cpu"))):
        ds0 = ctx.stream_ingest("sales", _batch(50, 6), **INGEST)
        appends0 = ctx.persist.counters["wal_appends"]
        ds1 = ctx.stream_ingest("sales", _batch(10, 7).iloc[0:0], **INGEST)
        assert ds1 is ds0, pkg
        assert ctx.persist.counters["wal_appends"] == appends0, pkg
        ctx.close()


def test_append_racing_checkpoint(tmp_path):
    """Concurrent appends and checkpoints serialize: every committed batch
    lands exactly once, the final on-disk state recovers to the final
    in-memory state, and the two packages end with the same store."""
    q = ("select region, sum(qty) as q, count(*) as n "
         "from sales group by region order by region")
    got = {}
    for pkg, make in (
            ("jax", lambda cfg: jsdot.Context(cfg)),
            ("port", lambda cfg: tsdot.Context(cfg, device="cpu"))):
        cfg = {"sdot.persist.path": str(tmp_path / pkg)}
        ctx = make(cfg)
        ctx.stream_ingest("sales", _batch(100, 24), **INGEST)
        errors, stop = [], threading.Event()

        def checkpoints(ctx=ctx, stop=stop, errors=errors):
            while not stop.is_set():
                try:
                    ctx.checkpoint("sales")
                except Exception as e:  # noqa: BLE001 — surfaced below
                    errors.append(e)

        t = threading.Thread(target=checkpoints)
        t.start()
        try:
            for i in range(10):
                ctx.stream_ingest("sales", _batch(20, 100 + i), **INGEST)
        finally:
            stop.set()
            t.join()
        assert not errors, errors
        want = ctx.sql(q).to_pandas()
        assert int(want["n"].sum()) == 300
        ctx.close()
        again = make(cfg)
        assert_frames_equal(again.sql(q).to_pandas(), want)
        got[pkg] = (again.store.get("sales"), want)
        again.close()
    assert_same_store(got["jax"][0], got["port"][0])
    assert_answers_equal(got["port"][1], got["jax"][1], ordered=True)


@pytest.mark.parametrize("null_rate", [0.0, 0.2])
def test_parallel_append_equals_serial(null_rate, monkeypatch):
    """The port's one column build (a thread pool from
    ``_PARALLEL_MIN_ROWS`` batch rows up, serial below) builds the same
    store as both of the JAX package's builds, its ``parallel=True``
    thread pool and its serial comprehension."""
    from spark_druid_olap_tpu_torch.segment import append as TA
    pools = []

    class Pool(TA.ThreadPoolExecutor):
        def __init__(self, *a, **kw):
            pools.append(kw.get("max_workers"))
            super().__init__(*a, **kw)
    monkeypatch.setattr(TA, "ThreadPoolExecutor", Pool)
    base = _batch(3000, 70)
    batch = _batch(5000, 71, null_product_rate=null_rate)
    batch.loc[::7, "region"] = "south"          # a new dictionary value
    batch.loc[3, "qty"] = 3_000_000_000         # a widened metric
    small = batch.iloc[:TA._PARALLEL_MIN_ROWS - 1]
    tctx = tsdot.Context(device="cpu")
    ds = tctx.stream_ingest("sales", base, **INGEST)
    par = tappend(ds, batch, target_rows=2048)
    assert len(pools) == 1 and pools[0] >= 2
    serial = tappend(ds, small, target_rows=2048)
    assert len(pools) == 1
    jctx = jsdot.Context()
    jds = jctx.stream_ingest("sales", base, **INGEST)
    for parallel in (True, False):
        assert_same_store(
            jappend(jds, batch, target_rows=2048, parallel=parallel), par)
        assert_same_store(
            jappend(jds, small, target_rows=2048, parallel=parallel),
            serial)


@pytest.mark.parametrize("seed", range(6))
def test_dictionary_merge_equals_the_jax_formulation(seed):
    """The port's merge (binary search, insert, shifted positions) against
    the JAX package's ``setdiff1d`` + ``sort`` + ``searchsorted`` on random
    sorted dictionaries: empty sides, new values before, between and
    after the old ones, and none new."""
    from spark_druid_olap_tpu_torch.segment.append import _merge_dictionary
    r = np.random.default_rng(seed)
    words = np.array([f"w{i:04d}" for i in range(400)], dtype=object)
    for n_old, n_fresh in ((0, 5), (5, 0), (40, 40), (200, 3), (3, 200)):
        old = np.sort(r.choice(words, n_old, replace=False))
        fresh = np.sort(r.choice(words, n_fresh, replace=False))
        dictionary, remap = _merge_dictionary(old, fresh)
        extra = np.setdiff1d(fresh, old)
        if not len(extra):
            assert dictionary is None and remap is None
            continue
        want = np.sort(np.concatenate([old, extra]))
        assert dictionary.dtype == want.dtype
        assert list(dictionary) == list(want)
        np.testing.assert_array_equal(remap, np.searchsorted(want, old))
