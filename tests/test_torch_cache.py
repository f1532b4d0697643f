"""The port's semantic result cache against the JAX package's.

The single-context cases of ``tests/test_result_cache.py`` run through
both packages' ``Context`` (the port with ``device="cpu"``) on the same
numpy-seeded data: the TPC-H statements cached against uncached,
invalidation after a re-ingest, the six subsumption cases, eviction,
oversized results, LRU order and bytes, CLEAR METADATA, the disabled
cache, immunity to caller mutation and the history's cache status; and
``tests/test_sharedscan.py::test_constituents_populate_cache_under_own_keys``.
Both packages' test suites pin the cache off by default, so every context
here turns it back on.

Tolerance: within one package a hit, a subsumed answer and a miss are bit
for bit the uncached answer; the cache statuses (``hit``, ``miss``,
``subsumed``) and the cache's counters equal the JAX package's exactly;
answers across the packages are exact for dimensions, integers, counts
and min/max, and rtol 1e-6 for float sums (float metrics are stored f32).
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import threading

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.cache.result_cache import ByteBudgetLRU as JLRU
from spark_druid_olap_tpu.ir import spec as JS
from spark_druid_olap_tpu.tools import ssb as jssb
from spark_druid_olap_tpu.tools import tpch as jtpch

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.cache.result_cache import ByteBudgetLRU as TLRU
from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.tools import ssb as tssb
from spark_druid_olap_tpu_torch.tools import tpch as ttpch

from test_torch_sql import assert_answers_equal

PACKAGES = {"jax": (jsdot, JS), "torch": (tsdot, TS)}


def _new_ctx(pkg, **conf):
    mod, _ = PACKAGES[pkg]
    ctx = mod.Context(config=conf) if pkg == "jax" \
        else mod.Context(config=conf, device="cpu")
    ctx.config.set("sdot.cache.enabled", True)   # the suites pin it off
    return ctx


def _sales_frame(n=6000, seed=7):
    """tests/test_result_cache.py's sales frame."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "ts": pd.to_datetime("2024-01-01")
        + pd.to_timedelta(rng.integers(0, 180, n), unit="D"),
        "region": rng.choice(["east", "west", "north", "south"], n),
        "product": rng.choice([f"p{i}" for i in range(20)], n),
        "units": rng.integers(1, 100, n).astype(np.int64),
        "price": (rng.random(n) * 50).round(4),
    })


def _sales_ctx(pkg, n=6000, **conf):
    ctx = _new_ctx(pkg, **conf)
    df = _sales_frame(n)
    ctx.ingest_dataframe("sales", df, time_column="ts")
    return ctx, df


def _aggs(S):
    return (S.AggregationSpec("longsum", "u", field="units"),
            S.AggregationSpec("count", "c"))


def _ts(S, gran, **kw):
    return S.TimeseriesQuerySpec("sales", _aggs(S),
                                 granularity=S.Granularity(gran), **kw)


def _by_product(S, **kw):
    return S.GroupByQuerySpec(
        "sales", (S.DimensionSpec("product", "product"),), _aggs(S), **kw)


def _status(ctx):
    return ctx.history.entries()[-1].stats.get("cache")


def _both(run):
    """``run(pkg)`` in both packages: ``{pkg: result}``."""
    return {pkg: run(pkg) for pkg in PACKAGES}


# -- TPC-H: cached and uncached answers bit for bit ---------------------------

@pytest.fixture(scope="module")
def tpch_pair():
    ctxs = {pkg: _new_ctx(pkg) for pkg in PACKAGES}
    jtpch.setup_context(ctxs["jax"], sf=0.002, target_rows=4096)
    ttpch.setup_context(ctxs["torch"], sf=0.002, target_rows=4096)
    return ctxs


@pytest.mark.parametrize("name", list(ttpch.QUERIES))
def test_tpch_cached_equals_uncached(tpch_pair, name):
    """Uncached reference, then the cold (miss) and warm runs with the
    cache on: bit for bit in the port, the warm run's status equal to the
    JAX package's, the answer equal to the JAX package's."""
    sql = ttpch.QUERIES[name]
    got, status = {}, {}
    for pkg, ctx in tpch_pair.items():
        ctx.config.set("sdot.cache.enabled", False)
        ref = ctx.sql(sql).to_pandas()
        ctx.config.set("sdot.cache.enabled", True)
        cold = ctx.sql(sql).to_pandas()
        warm = ctx.sql(sql).to_pandas()
        pd.testing.assert_frame_equal(ref, cold, check_exact=True,
                                      obj=f"{pkg} {name} cold")
        pd.testing.assert_frame_equal(ref, warm, check_exact=True,
                                      obj=f"{pkg} {name} warm")
        got[pkg], status[pkg] = ref, _status(ctx)
    assert status["torch"] == status["jax"], status
    assert_answers_equal(got["torch"], got["jax"],
                         ordered="order by" in sql.lower())


def test_tpch_warm_statements_are_served_from_the_cache(tpch_pair):
    """The pushdown statements hit on their warm run (JAX: at least 5)."""
    hits = {}
    for pkg, ctx in tpch_pair.items():
        n = 0
        for sql in list(ttpch.QUERIES.values())[:8]:
            ctx.sql(sql)
            ctx.sql(sql)
            st = ctx.history.entries()[-1].stats
            if st.get("cache") in ("hit", "subsumed"):
                assert st.get("served_from") == "result_cache"
                n += 1
        hits[pkg] = n
    assert hits["torch"] == hits["jax"] and hits["torch"] >= 5, hits


# -- SSB: cached and uncached answers bit for bit -----------------------------

def test_ssb_cached_equals_uncached():
    """``tests/test_result_cache.py``'s SSB case: each of the 13
    statements uncached, cold and warm, bit for bit in each package; the
    warm statuses equal the JAX package's, and every statement (all push
    down) is served from the cache at least 10 times out of 13."""
    ctxs = {pkg: _new_ctx(pkg) for pkg in PACKAGES}
    jssb.setup_context(ctxs["jax"], sf=0.003, target_rows=4096)
    tssb.setup_context(ctxs["torch"], sf=0.003, target_rows=4096)
    hits = {pkg: 0 for pkg in PACKAGES}
    for name, sql in tssb.QUERIES.items():
        got, status = {}, {}
        for pkg, ctx in ctxs.items():
            ctx.config.set("sdot.cache.enabled", False)
            ref = ctx.sql(sql).to_pandas()
            ctx.config.set("sdot.cache.enabled", True)
            cold = ctx.sql(sql).to_pandas()
            warm = ctx.sql(sql).to_pandas()
            pd.testing.assert_frame_equal(ref, cold, check_exact=True,
                                          obj=f"{pkg} {name} cold")
            pd.testing.assert_frame_equal(ref, warm, check_exact=True,
                                          obj=f"{pkg} {name} warm")
            got[pkg], status[pkg] = ref, _status(ctx)
            hits[pkg] += status[pkg] in ("hit", "subsumed")
        assert status["torch"] == status["jax"], (name, status)
        assert_answers_equal(got["torch"], got["jax"],
                             ordered="order by" in sql.lower())
    assert hits["torch"] == hits["jax"] and hits["torch"] >= 10, hits
    assert ctxs["torch"].engine.result_cache.stats()["hits"] > 0


# -- invalidation -------------------------------------------------------------

def test_invalidation_after_stream_append(tmp_path):
    """``tests/test_result_cache.py``'s stream case: a streamed Parquet
    datasource, its count cached, then the doubled file streamed in under
    the same name: a miss with twice the count, in both packages; then a
    ``stream_ingest`` append: a miss again with the appended rows."""
    sql = "select count(*) c from streamed"

    def run(pkg):
        ctx, df = _sales_ctx(pkg, n=2000)
        p = tmp_path / f"{pkg}_sales.parquet"
        df.to_parquet(p)
        ctx.ingest_parquet_stream("streamed", str(p), time_column="ts")
        a = ctx.sql(sql).to_pandas()
        ctx.sql(sql)
        s1 = _status(ctx)
        pd.concat([df, df]).to_parquet(p)
        ctx.ingest_parquet_stream("streamed", str(p), time_column="ts")
        b = ctx.sql(sql).to_pandas()
        s2 = _status(ctx)
        assert int(b["c"][0]) == 2 * int(a["c"][0])
        ctx.sql(sql)
        s3 = _status(ctx)
        ctx.stream_ingest("streamed", df.iloc[:300], time_column="ts")
        c = ctx.sql(sql).to_pandas()
        assert int(c["c"][0]) == 2 * int(a["c"][0]) + 300
        return (s1, s2, s3, _status(ctx)), c

    out = _both(run)
    assert out["torch"][0] == out["jax"][0] == ("hit", "miss", "hit", "miss")
    assert_answers_equal(out["torch"][1], out["jax"][1], ordered=True)


def test_invalidation_after_reingest():
    sql = ("select region, sum(units) u from sales group by region "
           "order by region")

    def run(pkg):
        ctx, df = _sales_ctx(pkg)
        a = ctx.sql(sql).to_pandas()
        s1 = _status(ctx)
        b = ctx.sql(sql).to_pandas()
        s2 = _status(ctx)
        pd.testing.assert_frame_equal(a, b, check_exact=True)
        v0 = ctx.store.datasource_version("sales")
        df2 = df.copy()
        df2["units"] = df2["units"] * 2
        ctx.ingest_dataframe("sales", df2, time_column="ts")
        c = ctx.sql(sql).to_pandas()
        assert (c["u"].to_numpy() == 2 * a["u"].to_numpy()).all()
        return (s1, s2, _status(ctx),
                ctx.store.datasource_version("sales") - v0), c

    out = _both(run)
    assert out["torch"][0] == out["jax"][0] == ("miss", "hit", "miss", 1)
    assert_answers_equal(out["torch"][1], out["jax"][1], ordered=True)


def test_store_versions_and_listeners_match_jax():
    """Per-datasource ingest versions move as the JAX store's do, and the
    listeners see the same events."""

    def run(pkg):
        ctx = _new_ctx(pkg)
        events = []
        ctx.store.add_listener(lambda ev, name: events.append((ev, name)))
        ctx.store.add_listener(lambda ev, name: 1 / 0)  # never breaks it
        df = _sales_frame(200)
        vs = []
        for name in ("a", "b", "a"):
            ctx.ingest_dataframe(name, df, time_column="ts")
            vs.append((ctx.store.datasource_version("a"),
                       ctx.store.datasource_version("b")))
        ctx.store.drop("b")
        vs.append((ctx.store.datasource_version("a"),
                   ctx.store.datasource_version("b")))
        ctx.store.clear()
        vs.append((ctx.store.datasource_version("a"),
                   ctx.store.datasource_version("b"), ctx.store.names()))
        return vs, events

    out = _both(run)
    assert out["torch"] == out["jax"]
    assert out["torch"][1][-1] == ("clear", None)


# -- subsumption --------------------------------------------------------------

def _subsume_case(case, S, ctx):
    """One of tests/test_result_cache.py's six subsumption cases: returns
    ``[(answer, uncached answer, status)]``."""

    def uncached(q):
        ctx.config.set("sdot.cache.enabled", False)
        ref = ctx.execute(q).to_pandas()
        ctx.config.set("sdot.cache.enabled", True)
        return ref

    def derive(populate, q):
        ref = uncached(q)
        ctx.execute(populate)
        return ctx.execute(q).to_pandas(), ref, \
            ctx.engine.last_stats.get("cache")

    if case == "granularity_rollup":
        refs = {g: uncached(_ts(S, g))
                for g in ("month", "week", "all", "quarter")}
        ctx.execute(_ts(S, "day"))
        out = []
        for g, ref in refs.items():
            got = ctx.execute(_ts(S, g)).to_pandas()
            out.append((got, ref, ctx.engine.last_stats.get("cache")))
        return out
    if case == "week_never_rolls_to_month":
        ctx.execute(_ts(S, "week"))
        ref = uncached(_ts(S, "month"))
        got = ctx.execute(_ts(S, "month")).to_pandas()
        return [(got, ref, ctx.engine.last_stats.get("cache"))]
    if case == "topn_from_groupby":
        topn = S.TopNQuerySpec("sales", S.DimensionSpec("product", "product"),
                               "u", 5, _aggs(S))
        return [derive(_by_product(S), topn)]
    if case == "filtered_groupby":
        return [derive(_by_product(S), _by_product(
            S, filter=S.InFilter("product", ("p3", "p7"))))]
    if case == "limit_reeval":
        return [derive(_by_product(S), _by_product(
            S, limit=S.LimitSpec((S.OrderByColumn("u", ascending=False),),
                                 3)))]
    assert case == "gran_all_identity_row_not_derived"
    nothing = S.SelectorFilter("region", "no-such-region")
    return [derive(_ts(S, "day", filter=nothing),
                   _ts(S, "all", filter=nothing))]


SUBSUME_CASES = {
    "granularity_rollup": ["subsumed"] * 4,
    "week_never_rolls_to_month": ["miss"],
    "topn_from_groupby": ["subsumed"],
    "filtered_groupby": ["subsumed"],
    "limit_reeval": ["subsumed"],
    "gran_all_identity_row_not_derived": ["miss"],
}


@pytest.mark.parametrize("case", list(SUBSUME_CASES))
def test_subsumption(case):
    out = _both(lambda pkg: _subsume_case(
        case, PACKAGES[pkg][1], _sales_ctx(pkg)[0]))
    for pkg, rows in out.items():
        for got, ref, _ in rows:
            pd.testing.assert_frame_equal(got, ref, check_exact=True,
                                          obj=f"{pkg} {case}")
    assert [st for _, _, st in out["torch"]] == SUBSUME_CASES[case]
    assert [st for _, _, st in out["jax"]] == SUBSUME_CASES[case]
    for (tg, _, _), (jg, _, _) in zip(out["torch"], out["jax"]):
        assert_answers_equal(tg, jg, ordered=True)


# -- eviction, bytes, flush, isolation ----------------------------------------

def test_eviction_under_tiny_budget():
    def run(pkg):
        ctx, _ = _sales_ctx(pkg)
        ctx.config.set("sdot.cache.max_bytes", 512)
        for i in range(8):
            ctx.sql(f"select region, sum(units) u{i} from sales "
                    f"group by region")
        return ctx.engine.result_cache.stats()

    st = _both(run)
    assert st["torch"]["evictions"] > 0 and st["torch"]["bytes"] <= 512
    assert st["torch"] == st["jax"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_oversized_result_never_admitted(pkg):
    lru = {"jax": JLRU, "torch": TLRU}[pkg](100)
    assert not lru.put("k", "v", 101)
    assert lru.get("k") is None
    assert lru.bytes == 0


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_lru_eviction_order_and_bytes(pkg):
    lru = {"jax": JLRU, "torch": TLRU}[pkg](100)
    lru.put("a", 1, 40)
    lru.put("b", 2, 40)
    assert lru.get("a") == 1          # refresh a: b is now LRU
    lru.put("c", 3, 40)               # evicts b
    assert lru.get("b") is None
    assert lru.get("a") == 1 and lru.get("c") == 3
    assert lru.bytes == 80 and lru.evictions == 1
    assert lru.stats() == {"entries": 2, "bytes": 80, "max_bytes": 100,
                           "hits": 3, "misses": 1, "evictions": 1}


def test_clear_metadata_flushes_cache():
    sql = "select region, sum(units) u from sales group by region"

    def run(pkg):
        out = []
        for clear in ("CLEAR METADATA sales", "CLEAR METADATA"):
            ctx, _ = _sales_ctx(pkg)
            ctx.sql(sql)
            ctx.sql(sql)
            out.append(ctx.engine.result_cache.stats()["entries"])
            ctx.sql(clear)
            out.append(ctx.engine.result_cache.stats()["entries"])
        return out

    out = _both(run)
    assert out["torch"] == out["jax"] == [1, 0, 1, 0]


def test_disabled_cache_is_inert():
    sql = "select region, sum(units) u from sales group by region"

    def run(pkg):
        ctx, _ = _sales_ctx(pkg)
        ctx.config.set("sdot.cache.enabled", False)
        ctx.sql(sql)
        ctx.sql(sql)
        st = ctx.engine.result_cache.stats()
        return (st["entries"], st["hits"], st["misses"],
                "cache" in ctx.history.entries()[-1].stats)

    out = _both(run)
    assert out["torch"] == out["jax"] == (0, 0, 0, False)


def test_cached_entries_immune_to_caller_mutation():
    def run(pkg):
        S = PACKAGES[pkg][1]
        ctx, _ = _sales_ctx(pkg)
        q = S.GroupByQuerySpec(
            "sales", (S.DimensionSpec("region", "region"),), _aggs(S))
        first = ctx.execute(q)
        want = first.to_pandas()
        first.data["u"][:] = -1           # vandalize the returned arrays
        second = ctx.execute(q)
        second.data["c"][:] = -1
        third = ctx.execute(q).to_pandas()
        pd.testing.assert_frame_equal(third, want, check_exact=True)
        return ctx.engine.last_stats.get("cache"), ctx, third

    out = _both(run)
    assert out["torch"][0] == out["jax"][0] == "hit"
    # a port entry holds host numpy arrays only, never a tensor
    for (cols, data), _ in out["torch"][1].engine.result_cache.lru \
            ._entries.values():
        assert all(type(v) is np.ndarray for v in data.values())
    assert_answers_equal(out["torch"][2], out["jax"][2], ordered=False)


def test_history_and_metadata_report_cache_status():
    sql = "select region, sum(units) u from sales group by region"

    def run(pkg):
        ctx, _ = _sales_ctx(pkg)
        ctx.sql(sql)
        first = _status(ctx)
        ctx.sql(sql)
        st = ctx.engine.result_cache.stats()
        return first, _status(ctx), \
            ctx.history.entries()[-1].stats.get("served_from"), st

    out = _both(run)
    assert out["torch"][:3] == out["jax"][:3] == \
        ("miss", "hit", "result_cache")
    assert out["torch"][3] == out["jax"][3]
    for k in ("hits", "misses", "subsumed", "evictions", "bytes",
              "entries", "enabled", "subsumption"):
        assert k in out["torch"][3]


# -- the shared-scan tier under the cache -------------------------------------

def test_constituents_populate_cache_under_own_keys():
    """Each coalesced constituent lands in the cache under its own key: a
    later solo re-run of every member hits and returns the same frame."""
    from test_torch_sharedscan import sales_batch
    from conftest import make_sales_df

    def run(pkg):
        S = PACKAGES[pkg][1]
        ctx = _new_ctx(pkg, **{"sdot.sharedscan.enabled": True,
                               "sdot.wlm.batch.window.ms": 500.0,
                               "sdot.wlm.enabled": False,
                               "sdot.pallas.wave.enabled": pkg == "torch"})
        ctx.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                             target_rows=4096)
        eng = ctx.engine
        specs = sales_batch(S)[:4]
        res, stats = [None] * 4, [None] * 4
        bar = threading.Barrier(4)

        def worker(i):
            bar.wait()
            res[i] = eng.execute(specs[i]).to_pandas()
            stats[i] = dict(eng.last_stats)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(s.get("cache") == "miss" for s in stats), stats
        assert eng.sharedscan.stats()["queries_coalesced"] >= 3
        for q, fused in zip(specs, res):
            again = eng.execute(q).to_pandas()
            assert eng.last_stats.get("cache") == "hit"
            pd.testing.assert_frame_equal(again, fused, check_exact=True)
        return res

    out = _both(run)
    for t, j in zip(out["torch"], out["jax"]):
        assert_answers_equal(t, j, ordered=False)
