"""JAX ``tests/test_dispatch_stats.py``'s contract on the port's counters.

The JAX engine counts program dispatches and host-to-device transfers per
thread (``dispatch_counts``) and its session writes their per-statement
difference into the history's stats (``n_dispatch``, ``n_transfer``).
The port has no dispatch counter (ROADMAP §C): each kernel wrapper counts
its own launches (``cuda_groupby.launches``, ``cuda_wave.launches``,
added only where a CUDA launch happens) and the engine keeps its device
column cache (``engine._device_arrays``). So the contract is copied onto
those: per statement recorded in ``ctx.history``, the calls of the B1 and
B2 wrappers (the launches on the card; on the CPU each call takes the
plain version) and the columns uploaded. A first aggregate statement
calls B1 and uploads its columns; the same statement warm calls B1 again
and uploads nothing; a statement with a subquery calls B1 for both; the
launch counters never go down; a result-cache hit calls no kernel and
uploads nothing. Each statement's mode is held equal to the JAX
package's; its ``n_dispatch >= 1`` stands beside the port's B1 calls.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import threading

import pytest

import spark_druid_olap_tpu as jsdot

import spark_druid_olap_tpu_torch as sdot
from spark_druid_olap_tpu_torch.ops import cuda_groupby as CG
from spark_druid_olap_tpu_torch.ops import cuda_wave as CW

from conftest import make_sales_df


@pytest.fixture(scope="module")
def ctx():
    c = sdot.Context(device="cpu")
    c.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                       target_rows=4096)
    return c


@pytest.fixture(scope="module")
def jctx():
    c = jsdot.Context()
    c.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                       target_rows=4096)
    return c


@pytest.fixture()
def calls(monkeypatch):
    """Counts the B1 and B2 wrapper calls made while a test runs."""
    n = {"b1": 0, "b2": 0}
    real1, real2 = CG.dense_groupby_kernel, CW.wave_groupby

    def b1(*a, **k):
        n["b1"] += 1
        return real1(*a, **k)

    def b2(*a, **k):
        n["b2"] += 1
        return real2(*a, **k)
    monkeypatch.setattr(CG, "dense_groupby_kernel", b1)
    monkeypatch.setattr(CW, "wave_groupby", b2)
    return n


def _statement(ctx, jctx, calls, sql):
    """Runs ``sql`` on both packages; the port's history entry, its B1 /
    B2 calls and the columns it uploaded, and the JAX entry's stats."""
    before, cols = dict(calls), len(ctx.engine._device_arrays)
    ctx.sql(sql)
    st = ctx.history.entries()[-1].stats
    jctx.sql(sql)
    jst = jctx.history.entries()[-1].stats
    assert st["mode"] == jst["mode"], sql
    return st, {"b1": calls["b1"] - before["b1"],
                "b2": calls["b2"] - before["b2"],
                "uploads": len(ctx.engine._device_arrays) - cols}, jst


def test_agg_query_counts_dispatches(ctx, jctx, calls):
    _, n, jst = _statement(ctx, jctx, calls, "select region, sum(qty) as s "
                                             "from sales group by region")
    assert n["b1"] >= 1 and jst["n_dispatch"] >= 1
    # first run uploads the scan columns
    assert n["uploads"] >= 1 and jst["n_transfer"] >= 1


def test_warm_query_reuses_device_arrays(ctx, jctx, calls):
    q = "select region, sum(qty) as s2 from sales group by region"
    _statement(ctx, jctx, calls, q)
    _, n, jst = _statement(ctx, jctx, calls, q)
    # same columns already resident: no new uploads, the kernel again
    assert n["uploads"] == 0 and jst["n_transfer"] == 0
    assert n["b1"] >= 1 and jst["n_dispatch"] >= 1


def test_counts_accumulate_across_subqueries(ctx, jctx, calls):
    _, n, jst = _statement(ctx, jctx, calls,
                           "select region, sum(qty) as s from sales "
                           "where qty > (select avg(qty) from sales) "
                           "group by region")
    # subquery + outer each call the kernel (the outer's filter holds the
    # subquery's scalar)
    assert n["b1"] >= 2 and jst["n_dispatch"] >= 1


def test_counters_are_monotone_and_thread_local(ctx, calls):
    """The port's launch counters are process-wide (the JAX engine's are
    per thread): a statement on another thread adds to them too."""
    c0 = (CG.launches, CW.launches, calls["b1"])

    def other():
        ctx.sql("select flag, count(*) as n from sales group by flag")
    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=60)
    ctx.sql("select count(*) as n from sales")
    c1 = (CG.launches, CW.launches, calls["b1"])
    assert all(b >= a for a, b in zip(c0, c1))
    assert c1[2] >= c0[2] + 2


def test_cache_hit_launches_nothing(calls):
    """A semantic result-cache hit answers without the engine: no B1 or
    B2 call, no upload."""
    c = sdot.Context({"sdot.cache.enabled": True}, device="cpu")
    c.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                       target_rows=4096)
    q = "select region, sum(qty) as s from sales group by region"
    first = c.sql(q).to_pandas()
    before, cols = dict(calls), len(c.engine._device_arrays)
    again = c.sql(q).to_pandas()
    assert c.engine.result_cache.stats()["hits"] >= 1
    assert calls == before and len(c.engine._device_arrays) == cols
    assert again.equals(first)


def test_cached_program_concurrent_failure_recovery(ctx):
    """If a compile owner raises, a waiter claims ownership and retries
    (per-signature compile events must not deadlock or cache garbage)."""
    eng = ctx.engine
    sig = ("test-prog", "failure-recovery")
    n = {"n": 0}
    lock = threading.Lock()

    def flaky_build():
        with lock:
            n["n"] += 1
            mine = n["n"]
        if mine == 1:
            raise RuntimeError("first build fails")
        return "compiled"

    results, errors = [], []

    def worker():
        try:
            results.append(eng._cached_program(sig, flaky_build))
        except RuntimeError as e:
            errors.append(e)

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts), "deadlocked"
    # exactly one failure propagated to the first owner; everyone else
    # got the successfully-built program
    assert len(errors) == 1
    assert results == ["compiled"] * 3
    assert eng._programs.get(sig) == "compiled"
    eng._programs.pop(sig, None)
