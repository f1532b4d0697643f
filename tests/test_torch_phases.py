"""JAX ``tests/test_phases.py`` bound to the port: phase profiler +
planning-cascade memo + decode-ahead tier tests.

The port runs with ``device="cpu"``. The profiler's unit semantics and
the tier's counters are the JAX test's closed forms; every statement of
layers 2 and 3 also runs on a JAX twin context over the same frames and
config changes, and its memo outcome (``plan_memo``), mode and rollup
annotation are held equal to the JAX package's.

Original notes: phase profiler + planning-cascade memo + decode-ahead
tier tests.

Four layers:

1. **Profiler unit semantics** (utils/phases.py): begin/end exactness,
   nested-begin merge, no-op outside an accumulator, stash folding, and
   the always-on overhead micro-budget (< 1% of wall enforced as a
   per-timing ceiling far below the ~1.7 ms dispatch floor).
2. **Stats contract** — every executed statement carries
   ``stats["phases"]`` whose names all come from the PHASES registry,
   and the key disappears when ``sdot.phases.enabled`` is off.
3. **Memo behavior** — a warm repeat of the identical statement (plan
   cache OFF, memo ON) skips the planning phases entirely and reports
   ``plan_memo == {"hit": True}``; any ingest, semantic config flip,
   CLEAR METADATA, or rollup DDL invalidates the memo (store-version /
   fingerprint keyed, exactly like the plan caches).
4. **Decode-ahead differential** — over an encoded tiered store the
   second pass serves decoded chunks from the decoded-side cache
   (``decode_ms_saved > 0``) with bit-identical answers.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import time

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu_torch as sdot
from spark_druid_olap_tpu_torch.utils import phases as PH

from torch_twin import mirrored


# -- 1. profiler unit semantics ----------------------------------------------

def _drain():
    """Make sure a failed test can't leak an open accumulator/stash."""
    PH.end(PH._acc())
    PH.clear_stash()


@pytest.fixture(autouse=True)
def _clean_profiler():
    _drain()
    yield
    _drain()


def test_begin_end_exactness():
    tok = PH.begin()
    assert tok is not None
    with PH.phase("plan.build"):
        time.sleep(0.01)
    PH.add("dispatch", 0.5)
    PH.add("dispatch", 0.25)
    out = PH.end(tok)
    assert set(out) == {"plan.build", "dispatch"}
    assert out["dispatch"] == pytest.approx(750.0)      # ms conversion
    assert out["plan.build"] >= 9.0                     # sleep floor


def test_nested_begin_merges_into_outer():
    tok = PH.begin()
    inner = PH.begin()                  # nested query (union branch)
    assert inner is None
    with PH.phase("bind"):
        pass
    assert PH.end(inner) is None        # inner close is a no-op
    out = PH.end(tok)
    assert "bind" in out                # inner phase merged into outer


def test_phase_and_add_are_noops_without_accumulator():
    with PH.phase("bind"):              # no begin(): background thread
        pass
    PH.add("dispatch", 1.0)
    tok = PH.begin()
    assert PH.end(tok) == {}            # nothing leaked in


def test_inclusive_nesting_counts_both():
    tok = PH.begin()
    with PH.phase("plan.build"):
        with PH.phase("plan.rollup"):
            time.sleep(0.005)
    out = PH.end(tok)
    assert out["plan.build"] >= out["plan.rollup"] >= 4.0


def test_stash_folds_into_next_begin_and_clears():
    PH.stash("parse", 0.2)
    tok = PH.begin()
    out = PH.end(tok)
    assert out["parse"] == pytest.approx(200.0)
    PH.stash("parse", 0.2)
    PH.clear_stash()                    # statement boundary drops it
    tok = PH.begin()
    assert PH.end(tok) == {}


def test_end_is_idempotent():
    tok = PH.begin()
    first = PH.end(tok)
    assert PH.end(tok) == first         # finally-block double close
    tok2 = PH.begin()                   # and a fresh begin still works
    assert tok2 is not None
    PH.end(tok2)


def test_disabled_begin_returns_none():
    tok = PH.begin(enabled=False)
    assert tok is None
    PH.add("dispatch", 1.0)
    assert PH.end(tok) is None


def test_overhead_micro_budget():
    """Always-on budget: one phase timing is two perf_counter reads plus
    a dict update. 50 us per timing is ~40x observed cost and keeps the
    ~15 timings of a real query under 1 ms — far below 1% of the
    multi-ms host path it instruments."""
    n = 10_000
    tok = PH.begin()
    t0 = time.perf_counter()
    for _ in range(n):
        with PH.phase("bind"):
            pass
    per = (time.perf_counter() - t0) / n
    PH.end(tok)
    assert per < 50e-6, f"{per * 1e6:.1f}us per phase timing"


# -- 2/3. session stats contract + memo --------------------------------------

def _sales_df(n=2000):
    r = np.random.default_rng(7)
    return pd.DataFrame({
        "ts": pd.date_range("2024-01-01", periods=n, freq="min"),
        "region": r.choice(["east", "west", "north"], n),
        "qty": r.integers(1, 50, n),
        "price": r.uniform(1.0, 9.0, n),
    })


Q = ("SELECT region, SUM(qty) AS total FROM sales "
     "GROUP BY region ORDER BY region")


@pytest.fixture()
def ctx():
    cfg = {"sdot.cache.enabled": False, "sdot.plan.cache.enabled": False}
    c = mirrored(sdot.Context(cfg, device="cpu"), cfg)
    c.ingest_dataframe("sales", _sales_df(), time_column="ts")
    try:
        yield c
    finally:
        c.close()


def _last_stats(c):
    return c.history.entries()[-1].stats


def _run(c, sql):
    """``sql`` on the port context and its JAX twin: the memo outcome,
    the mode and the rollup annotation equal; the port's result."""
    r = c.sql(sql)
    st = _last_stats(c)
    c.jax.sql(sql)
    jst = _last_stats(c.jax)
    for k in ("plan_memo", "mode", "rollup"):
        assert st.get(k) == jst.get(k), (k, st.get(k), jst.get(k))
    return r


def _set(c, key, value):
    c.config.set(key, value)
    c.jax.config.set(key, value)


def test_stats_phases_contract(ctx):
    _run(ctx, Q)
    st = _last_stats(ctx)
    ph = st["phases"]
    assert set(ph) <= set(PH.PHASES), set(ph) - set(PH.PHASES)
    # the cold cascade must actually show up, end to end (cache.lookup
    # is absent here — the fixture runs with the result cache off)
    for name in ("plan.memo", "plan.window", "plan.resolve", "plan.build",
                 "wlm.admit", "bind", "dispatch"):
        assert name in ph, (name, ph)
    assert all(v >= 0.0 for v in ph.values())
    assert st["plan_memo"] == {"hit": False}
    _set(ctx, "sdot.cache.enabled", True)
    _run(ctx, Q)
    assert "cache.lookup" in _last_stats(ctx)["phases"]


def test_phases_disabled_by_config(ctx):
    _set(ctx, "sdot.phases.enabled", False)
    _run(ctx, Q)
    assert "phases" not in _last_stats(ctx)


def test_memo_hit_skips_planning_phases(ctx):
    # a test-unique statement: the parse memo is process-global (keyed
    # on SQL text), so Q parsed by another test would hide the cold
    # "parse" phase this test pins down
    q = Q.replace("AS total", "AS total_memo")
    r1 = _run(ctx, q)
    cold = _last_stats(ctx)
    r2 = _run(ctx, q)
    warm = _last_stats(ctx)
    assert cold["plan_memo"] == {"hit": False}
    assert warm["plan_memo"] == {"hit": True}
    # plan cache is OFF — the skips below are the memo's own doing
    for name in ("plan.window", "plan.resolve", "plan.rewrite",
                 "plan.build"):
        assert name in cold["phases"], name
        assert name not in warm["phases"], (name, warm["phases"])
    # parse is memoized too: the warm rep never re-runs the parser
    assert "parse" in cold["phases"]
    assert "parse" not in warm["phases"]
    # execution still happened (memo serves plans, not results)
    assert "dispatch" in warm["phases"]
    np.testing.assert_array_equal(r1.data["total_memo"],
                                  r2.data["total_memo"])


def test_memo_disabled_replans_every_time(ctx):
    _set(ctx, "sdot.plan.memo.enabled", False)
    _run(ctx, Q)
    _run(ctx, Q)
    st = _last_stats(ctx)
    assert "plan_memo" not in st
    assert "plan.build" in st["phases"]      # cascade re-ran


def test_memo_invalidated_by_ingest(ctx):
    _run(ctx, Q)
    _run(ctx, Q)
    assert _last_stats(ctx)["plan_memo"] == {"hit": True}
    ctx.ingest_dataframe("sales", _sales_df(500), time_column="ts")
    _run(ctx, Q)
    assert _last_stats(ctx)["plan_memo"] == {"hit": False}


def test_memo_invalidated_by_semantic_config_flip(ctx):
    _run(ctx, Q)
    _run(ctx, Q)
    assert _last_stats(ctx)["plan_memo"] == {"hit": True}
    # sdot.join.enabled is semantic (in the config fingerprint); the
    # flip changes no answer for this single-table aggregate
    _set(ctx, "sdot.join.enabled", False)
    _run(ctx, Q)
    assert _last_stats(ctx)["plan_memo"] == {"hit": False}
    # an operational (semantic=False) flip must NOT invalidate
    _run(ctx, Q)
    assert _last_stats(ctx)["plan_memo"] == {"hit": True}
    _set(ctx, "sdot.phases.enabled", True)
    _run(ctx, Q)
    assert _last_stats(ctx)["plan_memo"] == {"hit": True}


def test_memo_invalidated_by_clear_metadata(ctx):
    other = _sales_df(100)
    ctx.ingest_dataframe("other", other, time_column="ts")
    _run(ctx, Q)
    _run(ctx, Q)
    assert _last_stats(ctx)["plan_memo"] == {"hit": True}
    # dropping ANY datasource bumps the store version the memo key folds
    _run(ctx, "CLEAR METADATA other")
    _run(ctx, Q)
    assert _last_stats(ctx)["plan_memo"] == {"hit": False}


def test_memo_invalidated_by_rollup_ddl(ctx):
    _run(ctx, Q)
    _run(ctx, Q)
    assert _last_stats(ctx)["plan_memo"] == {"hit": True}
    _run(ctx, "CREATE ROLLUP sales_cube ON sales DIMENSIONS (region) "
            "AGGREGATIONS (sum(qty), count(*)) GRANULARITY day")
    _run(ctx, Q)
    st = _last_stats(ctx)
    assert st["plan_memo"] == {"hit": False}
    # the re-plan is what lets the fresh rollup engage at all
    assert str(st.get("rollup", "")).startswith("rollup:")


def test_negative_outcomes_are_memoized(ctx):
    """A statement the builder rejects (host fallback) must also plan
    only once: the second run replays the negative outcome from the
    memo without re-running the rewrite/build phases."""
    neg = ("SELECT region, SUM(qty) / (SELECT MAX(price) FROM sales "
           "WHERE region = s.region) AS odd FROM sales s "
           "GROUP BY region, qty, price ORDER BY region LIMIT 3")
    r1 = _run(ctx, neg)
    cold = _last_stats(ctx)
    r2 = _run(ctx, neg)
    warm = _last_stats(ctx)
    assert warm["plan_memo"] == {"hit": True}
    if str(cold["mode"]).startswith("host"):
        assert str(warm["mode"]).startswith("host")
    assert "plan.build" not in warm["phases"]
    np.testing.assert_array_equal(r1.data["odd"], r2.data["odd"])


# -- 4. decode-ahead tiered serves --------------------------------------------

QUERIES = (Q,
           "SELECT region, COUNT(*) AS n, SUM(price) AS rev FROM sales "
           "GROUP BY region ORDER BY region")


def test_decode_ahead_saves_decode_time_bit_identical(tmp_path):
    root = str(tmp_path / "enc")
    seed = sdot.Context({"sdot.persist.path": root,
                         "sdot.encode.enabled": True}, device="cpu")
    seed.ingest_dataframe("sales", _sales_df(20_000), time_column="ts",
                          target_rows=4096)
    seed.checkpoint("sales")
    seed.close()

    eager = sdot.Context({"sdot.persist.path": root}, device="cpu")
    want = [eager.sql(q) for q in QUERIES]
    eager.close()

    # device-array cache off: every pass re-binds from the tier, so the
    # second pass actually exercises the demand-serve path under test
    ctx = sdot.Context({"sdot.persist.path": root,
                        "sdot.cache.enabled": False,
                        "sdot.plan.cache.enabled": False,
                        "sdot.engine.device.cache.bytes": 0,
                        "sdot.tier.enabled": True,
                        "sdot.tier.budget.bytes": 1 << 20,
                        "sdot.tier.wave.io.bytes": 1 << 18}, device="cpu")
    try:
        for _ in range(2):
            got = [ctx.sql(q) for q in QUERIES]
            for w, g in zip(want, got):
                assert list(w.columns) == list(g.columns)
                for c in w.columns:
                    np.testing.assert_array_equal(w.data[c], g.data[c])
        st = ctx.persist.tier.stats_snapshot()
        assert st["decoded_budget_bytes"] > 0
        # the second pass served already-decoded chunks: the demand path
        # skipped real decode work, and the saving is measured
        assert st["decode_ms_saved"] > 0.0, st
        assert st["decoded_cache_bytes"] <= st["decoded_budget_bytes"]
        # decoded-side accounting never pollutes the encoded hot set
        assert st["hot_bytes"] <= st["budget_bytes"]
    finally:
        ctx.close()


def test_decoded_cache_disabled_by_zero_budget(tmp_path):
    root = str(tmp_path / "enc0")
    seed = sdot.Context({"sdot.persist.path": root,
                         "sdot.encode.enabled": True}, device="cpu")
    seed.ingest_dataframe("sales", _sales_df(8_000), time_column="ts",
                          target_rows=4096)
    seed.checkpoint("sales")
    seed.close()
    ctx = sdot.Context({"sdot.persist.path": root,
                        "sdot.cache.enabled": False,
                        "sdot.tier.enabled": True,
                        "sdot.tier.budget.bytes": 1 << 20,
                        "sdot.tier.decoded.cache.bytes": 0}, device="cpu")
    try:
        for _ in range(2):
            ctx.sql(Q)
        st = ctx.persist.tier.stats_snapshot()
        assert st["decoded_budget_bytes"] == 0
        assert st["decode_ms_saved"] == 0.0
        assert st["decoded_cache_entries"] == 0
    finally:
        ctx.close()
