"""The port's late materialization (compact, then aggregate) against the
JAX package's.

The single-device cases of ``tests/test_compact.py``: one seeded frame is
ingested into a JAX ``Context`` and a port ``Context(device="cpu")`` under
the same config, and the same SQL runs through both. The compaction is
forced at test scale with ``sdot.engine.scan.compact.min.rows`` 0, as
there. Every case holds the port's answer to the JAX package's and the
decisions both engines record (``compact_m``, ``compact_overflow``,
``hashed``) equal; the port's compacted answer is also held to its own
uncompacted one. ``compact_keep``, the row order of the compacted prefix,
is held to the JAX package's ``lax.sort`` bit for bit.

Tolerance: dimensions, integers, counts and min/max exact; float sums
rtol 1e-6 (float metrics are stored f32, and the engines sum them in
different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.ir import spec as JS
from spark_druid_olap_tpu.parallel import cost as JC
from spark_druid_olap_tpu.parallel.executor import QueryEngine as JQE

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.ops.scan import compact_keep
from spark_druid_olap_tpu_torch.parallel import cost as TC
from spark_druid_olap_tpu_torch.parallel.executor import QueryEngine as TQE

from test_torch_sql import assert_answers_equal


def _df(n=6000, seed=7):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "ts": pd.Timestamp("2020-01-01")
        + pd.to_timedelta(rng.integers(0, 90, n), unit="D"),
        "region": rng.choice(["east", "west", "north", "south"], n),
        "sku": rng.choice([f"sku{i:03d}" for i in range(50)], n),
        "qty": rng.integers(0, 100, n),
        "price": np.round(rng.random(n) * 50, 2),
    })


def _ctx(pkg, compact, config=None):
    c = jsdot.Context() if pkg == "jax" else tsdot.Context(device="cpu")
    c.config.set("sdot.engine.scan.compact", compact)
    if compact:
        c.config.set("sdot.engine.scan.compact.min.rows", 0)
    for k, v in (config or {}).items():
        c.config.set(k, v)
    c.ingest_dataframe("sales", _df(), time_column="ts", target_rows=1024)
    return c


@pytest.fixture(scope="module")
def ctxs():
    """(jax, port) compacted and the port uncompacted, shared by the
    read-only cases."""
    return {"jax": _ctx("jax", True), "port": _ctx("port", True),
            "port_plain": _ctx("port", False)}


def _stats(ctx):
    return ctx.history.entries()[-1].stats


def _run(pair, sql):
    """Both engines' answers and stats."""
    out = []
    for c in pair:
        out.append((c.sql(sql).to_pandas(), dict(_stats(c))))
    (got, tst), (want, jst) = out[1], out[0]
    return got, want, tst, jst


DECISIONS = ("mode", "compact_m", "compact_overflow", "hashed",
             "topk_device", "having_device")


def _same_decisions(tst, jst):
    for k in DECISIONS:
        assert tst.get(k) == jst.get(k), (k, tst.get(k), jst.get(k))


QUERIES = [
    # selective selector filter -> small-K dense groupby
    "select region, sum(qty) as s, count(*) as n from sales "
    "where sku = 'sku007' group by region order by region",
    # IN filter + expression agg
    "select region, sum(qty * 2) as s2 from sales "
    "where sku in ('sku001','sku002','sku003') group by region "
    "order by region",
    # filtered global aggregate incl. min/max/avg
    "select min(qty) as mn, max(qty) as mx, avg(price) as ap, "
    "count(*) as n from sales where sku = 'sku042'",
    # time-bucketed groupby under a selective filter
    "select date_trunc('month', ts) as m, sum(qty) as s from sales "
    "where region = 'east' and sku = 'sku010' group by 1 order by 1",
    # ordered limit (device top-k epilogue) under compaction
    "select sku, sum(qty) as s from sales where region = 'west' "
    "group by sku order by s desc limit 5",
]


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_compacted_matches_jax_and_uncompacted(ctxs, qi):
    sql = QUERIES[qi]
    got, want, tst, jst = _run((ctxs["jax"], ctxs["port"]), sql)
    _same_decisions(tst, jst)
    assert tst["mode"] == "engine"
    assert_answers_equal(got, want, ordered=True)
    plain = ctxs["port_plain"].sql(sql).to_pandas()
    assert "compact_m" not in _stats(ctxs["port_plain"])
    assert_answers_equal(got, plain, ordered=True)


def test_compaction_engaged_with_the_jax_budget(ctxs):
    got, want, tst, jst = _run(
        (ctxs["jax"], ctxs["port"]),
        "select region, sum(qty) as s from sales where sku = 'sku007' "
        "group by region")
    assert tst["mode"] == "engine"
    assert tst.get("compact_m", 0) > 0
    _same_decisions(tst, jst)
    assert_answers_equal(got, want, ordered=False)


def test_overflow_retries_uncompacted(monkeypatch):
    """A wildly optimistic selectivity estimate (monkeypatched into both
    packages) must not change the answer: '__over__' forces the
    uncompacted retry, with the same overflow count."""
    monkeypatch.setattr(JC, "_filter_selectivity", lambda f, ds: 1e-5)
    monkeypatch.setattr(TC, "_filter_selectivity", lambda f, ds: 1e-5)
    pair = (_ctx("jax", True), _ctx("port", True))
    sql = ("select region, count(*) as n from sales where qty >= 0 "
           "group by region order by region")
    got, want, tst, jst = _run(pair, sql)
    assert tst.get("compact_overflow", 0) > 0
    _same_decisions(tst, jst)
    assert_answers_equal(got, want, ordered=True)
    # the memo: the warm run goes straight to the uncompacted program
    got2, _, tst2, jst2 = _run(pair, sql)
    assert "compact_overflow" not in tst2 and "compact_m" not in tst2
    _same_decisions(tst2, jst2)
    assert_answers_equal(got2, want, ordered=True)
    pair[1].engine.clear_caches()
    pair[1].sql(sql)
    assert _stats(pair[1]).get("compact_overflow", 0) > 0


KEYS60 = sorted(np.random.default_rng(11).choice(5000, 60, replace=False)
                .tolist())


def _staged_filters(S, E):
    """Filters whose top-level conjuncts split differently: a 60-value
    set over a 5,000 span probes (staged), ten consecutive values lower
    to one compare (cheap), a keyed set inside an expression probes."""
    big = S.InFilter("qty", E.FrozenIntSet(KEYS60))
    chain = S.InFilter("qty", E.FrozenIntSet(range(10)))
    expr = S.ExprFilter(E.InList(E.Column("qty"), E.FrozenIntSet(KEYS60)))
    sel = S.SelectorFilter("sku", "sku007")
    return [None, sel, S.LogicalFilter("and", (sel, chain)),
            S.LogicalFilter("and", (sel, big)),
            S.LogicalFilter("and", (sel, chain, S.LogicalFilter(
                "not", (big,)))),
            S.LogicalFilter("and", (sel, expr)), big]


@pytest.mark.parametrize("i", range(7))
def test_split_filter_staged_matches_jax(i):
    """The cheap / staged split of each filter equals the JAX engine's
    (each built by its own package's ``ir``)."""
    from spark_druid_olap_tpu.ir import expr as JE
    from spark_druid_olap_tpu_torch.ir import expr as TE
    want = JQE._split_filter_staged(_staged_filters(JS, JE)[i])
    got = TQE._split_filter_staged(_staged_filters(TS, TE)[i])
    assert repr(got) == repr(want)
    assert (got[1] is None) == (i in (0, 1, 2))


@pytest.mark.parametrize("i", [3, 4, 5])
def test_staged_expensive_membership_matches(ctxs, i):
    """A large integer membership set (a probe, not a compare chain) is
    staged after compaction in both engines: same budget, same answer as
    the JAX engine and as the port's uncompacted run."""
    from spark_druid_olap_tpu.ir import expr as JE
    from spark_druid_olap_tpu_torch.ir import expr as TE

    def q(S, E):
        return S.GroupByQuerySpec(
            "sales", (S.DimensionSpec("region", "region"),),
            (S.AggregationSpec("count", "n"),
             S.AggregationSpec("longsum", "s", field="qty")),
            filter=_staged_filters(S, E)[i])
    want = ctxs["jax"].execute(q(JS, JE)).to_pandas()
    jst = dict(ctxs["jax"].engine.last_stats)
    got = ctxs["port"].execute(q(TS, TE)).to_pandas()
    tst = dict(ctxs["port"].engine.last_stats)
    assert tst.get("compact_m", 0) > 0
    _same_decisions(tst, jst)
    assert_answers_equal(got, want, ordered=False)
    plain = ctxs["port_plain"].execute(q(TS, TE)).to_pandas()
    assert_answers_equal(got, plain, ordered=False)


def test_hashed_tier_compaction_matches():
    """High-cardinality (hashed-tier) group-by under a selective filter:
    late materialization engages in both engines and the answers match
    each other and the port's uncompacted run."""
    cfg = {"sdot.engine.groupby.dense.max.keys": 8}
    pair = (_ctx("jax", True, cfg), _ctx("port", True, cfg))
    sql = ("select sku, sum(qty) as s, count(*) as n from sales "
           "where region = 'east' and qty = 7 "
           "group by sku order by sku limit 30")
    got, want, tst, jst = _run(pair, sql)
    assert tst.get("hashed")
    assert tst.get("compact_m", 0) > 0 or tst.get("compact_overflow", 0) > 0
    _same_decisions(tst, jst)
    for k in ("hash_slots", "groups"):
        assert tst.get(k) == jst.get(k), k
    assert_answers_equal(got, want, ordered=True)
    plain = _ctx("port", False, cfg).sql(sql).to_pandas()
    assert_answers_equal(got, plain, ordered=True)


def test_hashed_overflow_retries_at_the_same_table(monkeypatch):
    """On the hashed tier the budget's overflow folds into the table's
    unresolved count: the first retry turns compaction off at the same
    table size, in both engines."""
    monkeypatch.setattr(JC, "_filter_selectivity", lambda f, ds: 1e-5)
    monkeypatch.setattr(TC, "_filter_selectivity", lambda f, ds: 1e-5)
    cfg = {"sdot.engine.groupby.dense.max.keys": 8}
    pair = (_ctx("jax", True, cfg), _ctx("port", True, cfg))
    sql = ("select sku, count(*) as n, max(price) as mx from sales "
           "where qty >= 0 group by sku order by sku")
    got, want, tst, jst = _run(pair, sql)
    assert tst.get("hashed") and tst.get("compact_overflow", 0) > 0
    _same_decisions(tst, jst)
    assert tst["hash_slots"] == jst["hash_slots"]
    assert_answers_equal(got, want, ordered=True)


def test_compaction_all_rows_filtered_out(ctxs):
    """A filter matching no row under compaction: an empty result, or
    the global identity row, in both engines."""
    got, want, tst, jst = _run(
        (ctxs["jax"], ctxs["port"]),
        "select region, sum(qty) as s from sales "
        "where sku = 'sku001' and qty > 1000000 group by region")
    assert len(got) == len(want) == 0
    _same_decisions(tst, jst)
    got, want, tst, jst = _run(
        (ctxs["jax"], ctxs["port"]),
        "select count(*) as n, sum(qty) as s from sales "
        "where sku = 'sku001' and qty > 1000000")
    assert int(got["n"][0]) == 0
    _same_decisions(tst, jst)
    assert_answers_equal(got, want, ordered=True)


def test_gate_keeps_small_scans_uncompacted():
    """Under the cost test (``min.rows`` 1, the cpu unit costs) neither
    engine compacts the test-scale scan: the partition costs more than
    the scatter updates it saves."""
    cfg = {"sdot.engine.scan.compact.min.rows": 1}
    pair = (_ctx("jax", True, cfg), _ctx("port", True, cfg))
    for sql in QUERIES[:2]:
        got, want, tst, jst = _run(pair, sql)
        _same_decisions(tst, jst)
        assert "compact_m" not in tst
        assert_answers_equal(got, want, ordered=True)


@pytest.mark.parametrize("n,live,m", [(1, 1.0, 1), (4096, 0.01, 64),
                                      (4096, 0.3, 1024),
                                      (10_000, 0.5, 4096),
                                      (3000, 0.0, 64), (3000, 1.0, 2048)])
def test_keep_equals_the_jax_sort(n, live, m):
    """The compacted prefix's row order: the JAX engine's
    ``lax.sort((valid ? 0 : 1, row), num_keys=1)`` cut to M, and its
    live-row count."""
    valid = np.random.default_rng(n).random(n) < live
    okey = jnp.where(jnp.asarray(valid), jnp.int32(0), jnp.int32(1))
    _, sidx = jax.lax.sort((okey, jnp.arange(n, dtype=jnp.int32)),
                           num_keys=1)
    keep, n_live = compact_keep(torch.from_numpy(valid), m)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(sidx)[:m])
    assert int(n_live) == int(valid.sum())
