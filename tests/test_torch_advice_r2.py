"""JAX ``tests/test_advice_r2.py`` bound to the port: round-2 advisor
findings, regression-locked (ADVICE.md r2).

The port runs with ``device="cpu"`` against the JAX test's closed forms
and pandas oracles; the device top-k decision (``topk_device``) and the
syntax errors with their messages are held equal to the JAX package's on
the same input. Not copied: ``test_topk_exact_groupby_f32_tie_reruns``
(its ``no_x64`` fixture puts the JAX engine on f32 scores, a TPU-only
route the port does not emit) and ``test_sharded_exchange_min_near_sentinel``,
held by the case of that name in ``test_torch_sharded.py``.

Original notes: round-2 advisor findings.

1. medium — exact-contract GroupBy ordered-limit must not silently trust
   the f32-approximate device candidate selection when keys tie at the
   cutoff: it proves the boundary clears the cutoff or re-runs exact.
2. low — datetime64 NaT is NULL under 3VL predicate masks.
3. low — the candidate-exchange null mask is computed on raw per-chip
   values BEFORE the float cast (near-sentinel extrema are not NULL).
4. low — session result caches are per-kind bounded LRUs.
5. low — ORDER BY/LIMIT on a non-final bare UNION ALL branch is a syntax
   error (standard SQL binds trailing clauses to the whole union).
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu_torch as sdot
from spark_druid_olap_tpu_torch.ir.spec import (
    AggregationSpec, DimensionSpec, GroupByQuerySpec, LimitSpec,
    OrderByColumn,
)
from spark_druid_olap_tpu_torch.parallel.executor import QueryEngine
from spark_druid_olap_tpu_torch.segment.ingest import ingest_dataframe
from spark_druid_olap_tpu_torch.segment.store import SegmentStore
from spark_druid_olap_tpu_torch.sql.lexer import SqlSyntaxError
from spark_druid_olap_tpu_torch.sql.parser import parse_statement
from spark_druid_olap_tpu_torch.utils import host_eval

from spark_druid_olap_tpu.sql.parser import parse_statement as jparse_statement

from torch_twin import jax_stats, jax_store, same_error


# -- 1. exact-contract device top-k ------------------------------------------

N_TIE = 12_000          # above sdot.engine.topn.device.min.keys


def _tie_store():
    """One row per key; 200 keys at 2^25+1 and 200 at 2^25 — f32 cannot
    distinguish them (ulp at 2^25 is 4), and 400 ties far exceed the
    selection slack for LIMIT 10."""
    vals = (np.arange(N_TIE, dtype=np.int64) % 1000) + 1
    vals[:200] = 2 ** 25 + 1
    vals[200:400] = 2 ** 25
    df = pd.DataFrame({
        "ts": np.repeat(np.datetime64("2020-01-01"), N_TIE)
        .astype("datetime64[ns]"),
        "cust": [f"c{i:05d}" for i in range(N_TIE)],
        "v": vals,
    })
    st = SegmentStore()
    st.register(ingest_dataframe("tie", df, time_column="ts",
                                 target_rows=4096))
    st.jax = jax_store(("tie", df, {"time_column": "ts",
                                    "target_rows": 4096}))
    return st


def _tie_query():
    return GroupByQuerySpec(
        datasource="tie",
        dimensions=(DimensionSpec("cust", "cust"),),
        aggregations=(AggregationSpec("longsum", "s", field="v"),),
        limit=LimitSpec((OrderByColumn("s", ascending=False),), 10))


def test_topk_exact_groupby_x64_exact_scores_stay_on_device():
    """With exact scores the same distribution needs no re-run: every
    candidate ties at 2^25+1 and boundary ties on the single order
    column are provably interchangeable."""
    st = _tie_store()
    eng = QueryEngine(st, device="cpu")
    got = eng.execute(_tie_query()).to_pandas()
    assert eng.last_stats["topk_device"] > 0, \
        "provably-exact boundary tie must keep the device epilogue"
    assert eng.last_stats["topk_device"] == \
        jax_stats(st.jax, _tie_query())["topk_device"]
    np.testing.assert_array_equal(
        got["s"].to_numpy().astype(np.int64), np.full(10, 2 ** 25 + 1))


# -- 2. NaT is NULL under 3VL -------------------------------------------------

def test_map_null_recognizes_nat():
    v = np.array(["2020-01-01", "NaT", "2021-06-01"],
                 dtype="datetime64[ns]")
    assert host_eval._map_null(v).tolist() == [False, True, False]
    d = v - np.datetime64("2020-01-01")
    assert host_eval._map_null(d).tolist() == [False, True, False]


def test_pred3_not_on_nat_comparison_drops_row():
    """NOT (ts > x) over a NaT timestamp is UNKNOWN, not TRUE — SQL 3VL
    drops the row (previously NaT compared definite-FALSE and survived
    the NOT)."""
    from spark_druid_olap_tpu_torch.ir import expr as E
    env = {"ts": np.array(["2020-06-01", "NaT", "2019-01-01"],
                          dtype="datetime64[ns]")}
    cmp_gt = E.Comparison(">", E.Column("ts"),
                          E.Literal(np.datetime64("2020-01-01")))
    keep = host_eval.eval_pred3(E.Not(cmp_gt), env)
    assert keep.tolist() == [False, False, True]


# -- 4. per-kind LRU result caches --------------------------------------------

def test_result_cache_per_kind_lru():
    from conftest import make_sales_df
    from spark_druid_olap_tpu_torch.planner.host_exec import (result_cache,
                                                        result_cache_put)
    ctx = sdot.Context(device="cpu")
    ctx.ingest_dataframe("sales", make_sales_df(2_000), time_column="ts")
    keys = []
    for i in range(70):
        cache, key = result_cache(ctx, "assist", f"stmt{i}")
        result_cache_put(cache, key, i)
        keys.append(key)
    sub_cache, sub_key = result_cache(ctx, "subquery", "sub0")
    result_cache_put(sub_cache, sub_key, "x")
    assert len(cache) == 64                  # bounded AFTER insert
    assert keys[0] not in cache and keys[-1] in cache   # LRU, not clear()
    assert sub_cache[sub_key] == "x" and len(sub_cache) == 1
    assert cache is not sub_cache            # kinds never evict each other


# -- 5. union branch clause binding -------------------------------------------

def test_union_nonfinal_bare_branch_clauses_rejected():
    for bad in ("select a from t limit 2 union all select a from t",
                "select a from t order by a union all select a from t "
                "union all select a from t"):
        with pytest.raises(SqlSyntaxError, match="UNION ALL"):
            parse_statement(bad)
        same_error(lambda: parse_statement(bad),
                   lambda: jparse_statement(bad))
    # parenthesized branches keep their clauses; the last bare branch's
    # trailing clauses bind to the whole union
    parse_statement("(select a from t limit 2) union all select a from t")
    parse_statement("select a from t union all select a from t order by a limit 3")


# -- 6. Kleene 3VL over NULL-bearing membership and negated filters ----------
# (round-3 probe findings: NOT IN over a NULL-bearing subquery list was
# TRUE for every row, and the device lowering's NOT inverted the null
# guard so negated predicates KEPT null rows)

def test_not_in_null_bearing_subquery_and_negated_filters():
    rng = np.random.default_rng(42)
    n = 40_000
    df = pd.DataFrame({
        "ts": (np.datetime64("2020-06-01")
               + rng.integers(0, 400, n).astype("timedelta64[D]"))
        .astype("datetime64[ns]"),
        "cat": rng.choice(["x", "y", "z"], n),
        "subc": rng.choice([f"s{i}" for i in range(50)], n),
    })
    df.loc[rng.choice(n, 500, replace=False), "subc"] = None
    ctx = sdot.Context(device="cpu")
    ctx.ingest_dataframe("t3v", df, time_column="ts")

    def n_of(sql):
        return int(ctx.sql(sql).to_pandas()["n"].iloc[0])

    nn = df.subc.notna()
    cases = [
        # NOT IN over any NULL-bearing list can never be TRUE
        ("select count(*) as n from t3v where cat not in "
         "(select subc from t3v where subc is null)", 0),
        ("select count(*) as n from t3v where cat not in "
         "(select subc from t3v where subc = 's1' or subc is null)", 0),
        ("select count(*) as n from t3v where not (cat in "
         "(select subc from t3v where subc is null))", 0),
        ("select count(*) as n from t3v where not (subc in "
         "(select subc from t3v where subc = 's1' or subc is null))", 0),
        # IN keeps its match semantics
        ("select count(*) as n from t3v where subc in "
         "(select subc from t3v where subc = 's1' or subc is null)",
         int((df.subc == "s1").sum())),
        # negated predicates over a nullable dim DROP its null rows
        ("select count(*) as n from t3v where subc not in "
         "(select subc from t3v where subc = 's1')",
         int(((df.subc != "s1") & nn).sum())),
        ("select count(*) as n from t3v where subc not in ('s1', 's2')",
         int((~df.subc.isin(["s1", "s2"]) & nn).sum())),
        ("select count(*) as n from t3v where subc <> 's1'",
         int(((df.subc != "s1") & nn).sum())),
        ("select count(*) as n from t3v where subc not like 's1%'",
         int((~df.subc.fillna("s1").str.startswith("s1") & nn).sum())),
        ("select count(*) as n from t3v where not "
         "(subc = 's1' or subc = 's2')",
         int((~df.subc.isin(["s1", "s2"]) & nn).sum())),
    ]
    for sql, want in cases:
        assert n_of(sql) == want, sql
