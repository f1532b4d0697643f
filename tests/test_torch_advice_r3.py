"""JAX ``tests/test_advice_r3.py`` bound to the port: round-3 advisor
findings, regression-locked (ADVICE.md r3).

The port runs with ``device="cpu"``; its decisions (the staged-filter
split, the chain-lowering predicate, the pattern cache's bound, EXPLAIN's
late-materialization line, a statement's mode) are held equal to the JAX
package's on the same input. The membership lowering is checked on the
port's traced graph (``make_fx``) instead of JAX's HLO: no gather, no
``searchsorted``, no indexing. Not copied: the two ``tailprobe`` cases
(``test_tailprobe_channel_is_private``,
``test_tailprobe_rejects_foreign_dir``) test ``tools/tailprobe.py`` at the
repo root, which is not part of either package.

Original notes:

1. low — tailprobe's command channel lives in a private 0700 dir, not a
   fixed world-writable /tmp path (local-user code-exec hazard).
2. low — EXPLAIN's late-materialization line is labelled an estimate
   (the execution-time decision additionally sees routes/sharding).
3. low — the staged-filter split and int_set_membership share ONE
   "lowers to a compare chain?" predicate: large near-contiguous sets
   are NOT staged; small scattered sets ARE.
4. low — the per-datasource pattern-selectivity cache is a bounded LRU.
5. low — negative plan-cache entries are a dedicated type, never a
   structural tuple sentinel.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu_torch as sdot
from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.ops import expr_compile as EC
from spark_druid_olap_tpu_torch.parallel import cost as C
from spark_druid_olap_tpu_torch.parallel.executor import QueryEngine

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.ir import expr as JE
from spark_druid_olap_tpu.ir import spec as JS
from spark_druid_olap_tpu.ops import expr_compile as JEC
from spark_druid_olap_tpu.parallel import cost as JC
from spark_druid_olap_tpu.parallel.executor import QueryEngine as JQueryEngine


# -- 3. shared chain-lowering predicate --------------------------------------

def _staged(vals) -> bool:
    f = S.InFilter("x", E.FrozenIntSet(np.asarray(sorted(vals), np.int64)))
    cheap, exp = QueryEngine._split_filter_staged(f)
    jf = JS.InFilter("x", JE.FrozenIntSet(np.asarray(sorted(vals),
                                                      np.int64)))
    assert (exp is not None) == \
        (JQueryEngine._split_filter_staged(jf)[1] is not None)
    return exp is not None


def _chain(vals) -> bool:
    a = np.asarray(vals, np.int64)
    assert EC.int_set_lowers_to_chain(a) == JEC.int_set_lowers_to_chain(a)
    return EC.int_set_lowers_to_chain(a)


def test_staged_split_matches_chain_lowering():
    # large but near-contiguous: one run -> compare chain -> NOT staged
    contiguous = list(range(1000, 1200))
    assert _chain(contiguous)
    assert not _staged(contiguous)
    # small but scattered (30 singleton runs > _CHAIN_MAX_RANGES, span
    # 30x the count): lowers as a gather -> IS staged
    scattered = [i * 1000 for i in range(30)]
    assert not _chain(scattered)
    assert _staged(scattered)
    # tiny scattered set (<= 24 runs): chain again -> NOT staged
    tiny = [i * 1000 for i in range(20)]
    assert _chain(tiny)
    assert not _staged(tiny)


def test_chain_predicate_agrees_with_membership_lowering():
    """int_set_runs is the single source of truth: when it yields runs,
    membership compiles without any gather (verified by tracing the
    port's function with ``make_fx`` and asserting no gather, search or
    indexing op appears; a scattered set's trace has the search)."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    vals = np.asarray(list(range(100, 400)), np.int64)  # one dense run
    assert _chain(vals)

    def ops_of(v):
        g = make_fx(lambda x: EC.int_set_membership(x, v))(
            torch.zeros(128, dtype=torch.int32))
        return {str(n.target) for n in g.graph.nodes
                if n.op == "call_function"}

    probes = ("gather", "searchsorted", "index")
    assert not any(p in t for t in ops_of(vals) for p in probes)
    scattered = np.asarray([i * 1000 for i in range(30)], np.int64)
    assert any("searchsorted" in t for t in ops_of(scattered))


# -- 2 + 4. pattern cache bound / explain estimate label ---------------------

def test_pattern_frac_cache_is_bounded():
    df = pd.DataFrame({
        "d": pd.Series(["apple", "banana", "cherry", "date"] * 4,
                       dtype="object"),
        "m": np.arange(16.0),
    })
    ctx = sdot.Context(device="cpu")
    ds = ctx.ingest_dataframe("pat", df)
    for i in range(C._PATTERN_FRAC_BOUND + 50):
        f = S.PatternFilter("d", "contains", f"pfx{i}")
        C._pattern_fraction(f, ds)
    assert C._PATTERN_FRAC_BOUND == JC._PATTERN_FRAC_BOUND
    assert len(ds._pattern_frac_cache) <= C._PATTERN_FRAC_BOUND
    # hot entries survive: re-touch one, insert more, it stays
    f0 = S.PatternFilter("d", "contains", "apple")
    C._pattern_fraction(f0, ds)
    for i in range(C._PATTERN_FRAC_BOUND - 1):
        C._pattern_fraction(S.PatternFilter("d", "contains", f"z{i}"), ds)
    assert ("d", "contains", "apple") in ds._pattern_frac_cache


def test_explain_compaction_line_is_estimate():
    rng = np.random.default_rng(0)
    n = 40_000
    df = pd.DataFrame({
        "k": rng.integers(0, 50, n).astype(str),
        "sel": rng.integers(0, 100, n),
        "v": rng.normal(size=n),
    })
    cfg = {"sdot.engine.scan.compact.min.rows": 0}
    sql = "select k, sum(v) from exp_est where sel < 3 group by k"
    ctx = sdot.Context(config=cfg, device="cpu")
    ctx.ingest_dataframe("exp_est", df)
    txt = ctx.explain(sql)
    jctx = jsdot.Context(config=cfg)
    jctx.ingest_dataframe("exp_est", df)
    jtxt = jctx.explain(sql)
    line = [ln for ln in txt.splitlines() if "late-materialize" in ln]
    assert line == [ln for ln in jtxt.splitlines()
                    if "late-materialize" in ln]
    if "late-materialize" in txt:
        assert "(estimate)" in txt


# -- 5. negative plan-cache entries are a dedicated type ---------------------

def test_negative_plan_entry_not_tuple_sentinel():
    from spark_druid_olap_tpu_torch.planner import host_exec
    from spark_druid_olap_tpu_torch.sql.session import _NegativePlan

    df = pd.DataFrame({"k": ["a", "b"], "v": [1.0, 2.0]})
    ctx = sdot.Context(device="cpu")
    ctx.ingest_dataframe("neg", df)
    # a statement the builder deterministically rejects: a session
    # Python UDF has no device compilation path (a plain equi self-join
    # now runs ENGINE mode via the round-5 disambiguation + composite
    # pushdown, so it no longer demotes)
    ctx.functions["negfn"] = lambda a, b: float(a) + float(b)
    sql = ("select k, count(*) as n from neg where negfn(v, v) > 0 "
           "group by k order by k")
    r1 = ctx.sql(sql)
    jctx = jsdot.Context()
    jctx.ingest_dataframe("neg", df)
    jctx.functions["negfn"] = ctx.functions["negfn"]
    jctx.sql(sql)
    assert ctx.history.entries()[-1].stats["mode"] == \
        jctx.history.entries()[-1].stats["mode"]
    assert ctx.history.entries()[-1].stats["mode"].startswith("host")
    plan_cache = getattr(ctx, "_result_cache", {}).get("plan", {})
    negs = [v for v in plan_cache.values() if isinstance(v, _NegativePlan)]
    tuples = [v for v in plan_cache.values() if isinstance(v, tuple)]
    assert negs, "expected a negative plan-cache entry"
    assert not tuples, "bare-tuple sentinel must be gone"
    # second run hits the negative entry and still answers identically
    r2 = ctx.sql(sql)
    assert r1.to_pandas().equals(r2.to_pandas())
