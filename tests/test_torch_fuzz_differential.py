"""JAX ``tests/test_fuzz_differential.py`` bound to the port, plus its
first 40 shapes as shared-scan storms.

Randomly-shaped aggregate statements (the JAX test's ``_gen_query``,
seeds 1000 + i, and its ordered-limit + HAVING shapes, seeds 5000 + i)
run through a port ``Context(device="cpu")`` with late materialization
forced on, against the JAX test's own pandas oracle at its own tolerance
(rtol 1e-5, atol 1e-6).

The storms: the first 40 statements as 5 storms of 8 threads under
``sdot.sharedscan.enabled`` (compaction at its default), each answer
equal to the port's solo answer (ints exact, floats rtol 1e-6) and to
pandas; each member's plan (whether it rode the group, the group's
members and lanes, the fusion planner's counters) equal to the JAX
package's on the same statements, and each storm's plan equal to
``chip_smoke.FUZZ_STORM_PLAN``, which phase ``fuzz`` of ``chip_smoke.py``
checks on the card. The phase's own storm function runs here too, at
2^14 rows, on the plain versions.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import functools
import threading
import types

import numpy as np
import pandas as pd
import pytest
import torch

import spark_druid_olap_tpu as jsdot

import spark_druid_olap_tpu_torch as sdot
from spark_druid_olap_tpu_torch.ops import cuda_groupby as CG
from spark_druid_olap_tpu_torch.ops import cuda_wave as CW

import chip_smoke

N = 4000
DIMS = ["region", "sku", "tier"]
METRICS = ["qty", "price"]
STORM_RTOL = 1e-6
STORM_ROWS = 1 << 14
# the phase's storm settings; a group closes as soon as its 8th statement
# joins, so the longer window only guards a loaded test host's planning
STORM_CONFIG = {**chip_smoke.FUZZ_STORM_CONFIG,
                "sdot.wlm.batch.window.ms": 30_000.0}


def _df():
    rng = np.random.default_rng(99)
    df = pd.DataFrame({
        "ts": pd.Timestamp("2022-01-01")
        + pd.to_timedelta(rng.integers(0, 120, N), unit="D"),
        "region": rng.choice(["ne", "nw", "se", "sw", "c"], N),
        "sku": rng.choice([f"k{i:03d}" for i in range(40)], N),
        "tier": rng.choice(["gold", "silver", "bronze"], N),
        "qty": rng.integers(0, 200, N),
        "price": np.round(rng.random(N) * 30, 2),
    })
    return df


@pytest.fixture(scope="module")
def env():
    df = _df()
    c = sdot.Context(device="cpu")
    c.config.set("sdot.engine.scan.compact.min.rows", 0)
    c.ingest_dataframe("t", df, time_column="ts", target_rows=1024)
    return c, df


def _gen_query(rng, df):
    """(sql, oracle_fn) for a random groupby/filter/agg shape."""
    dims = list(rng.choice(DIMS, size=rng.integers(0, 3), replace=False))
    aggs = []
    for i in range(rng.integers(1, 4)):
        m = str(rng.choice(METRICS))
        kind = str(rng.choice(["sum", "min", "max", "count", "avg"]))
        aggs.append((f"a{i}", kind, m))
    conds = []
    mask = pd.Series(True, index=df.index)
    if rng.random() < 0.8:
        d = str(rng.choice(DIMS))
        vals = sorted(set(str(v) for v in rng.choice(
            df[d].unique(), size=rng.integers(1, 3), replace=True)))
        conds.append(f"{d} in ({', '.join(repr(v) for v in vals)})")
        mask &= df[d].isin(vals)
    if rng.random() < 0.6:
        lo = int(rng.integers(0, 150))
        conds.append(f"qty >= {lo}")
        mask &= df["qty"] >= lo
    if rng.random() < 0.3:
        day = pd.Timestamp("2022-01-01") + pd.Timedelta(
            days=int(rng.integers(20, 100)))
        conds.append(f"ts < date '{day.date()}'")
        mask &= df["ts"] < day

    sel = []
    sel += dims
    for name, kind, m in aggs:
        expr = {"sum": f"sum({m})", "min": f"min({m})",
                "max": f"max({m})", "count": "count(*)",
                "avg": f"avg({m})"}[kind]
        sel.append(f"{expr} as {name}")
    sql = "select " + ", ".join(sel) + " from t"
    if conds:
        sql += " where " + " and ".join(conds)
    if dims:
        sql += " group by " + ", ".join(dims)
        sql += " order by " + ", ".join(dims)

    def oracle():
        d = df[mask]
        def agg_frame(g):
            out = {}
            for name, kind, m in aggs:
                if kind == "count":
                    out[name] = g[m].size if hasattr(g[m], "size") else len(g)
                elif kind == "avg":
                    out[name] = g[m].mean()
                else:
                    out[name] = getattr(g[m], kind)()
            return out
        if dims:
            if len(d) == 0:
                return pd.DataFrame(columns=dims + [a[0] for a in aggs])
            rows = []
            for key, g in d.groupby(dims, sort=True):
                key = key if isinstance(key, tuple) else (key,)
                rows.append({**dict(zip(dims, key)), **agg_frame(g)})
            return pd.DataFrame(rows)
        row = {}
        for name, kind, m in aggs:
            if kind == "count":
                row[name] = len(d)
            elif len(d) == 0:
                row[name] = np.nan
            elif kind == "avg":
                row[name] = d[m].mean()
            else:
                row[name] = getattr(d[m], kind)()
        return pd.DataFrame([row])

    return sql, oracle


@pytest.mark.parametrize("i", range(40))
def test_random_query_matches_pandas(env, i):
    ctx, df = env
    rng = np.random.default_rng(1000 + i)
    sql, oracle = _gen_query(rng, df)
    got = ctx.sql(sql).to_pandas()
    want = oracle()
    if len(want) == 0:
        assert len(got) == 0, sql
        return
    got = got.reset_index(drop=True)
    want = want[got.columns].reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want, check_dtype=False,
                                  rtol=1e-5, atol=1e-6), sql


@pytest.mark.parametrize("i", range(20))
def test_random_having_limit_matches_pandas(env, i):
    """Ordered-limit + HAVING shapes (device top-k epilogue + having
    path under compaction)."""
    ctx, df = env
    rng = np.random.default_rng(5000 + i)
    dim = str(rng.choice(DIMS))
    m = str(rng.choice(METRICS))
    thresh = int(rng.integers(100, 4000))
    k = int(rng.integers(1, 8))
    like = rng.random() < 0.4
    cond = "sku like 'k01%'" if like else \
        f"region in ('ne','se')"
    sql = (f"select {dim}, sum({m}) as s, count(*) as n from t "
           f"where {cond} and qty >= 10 "
           f"group by {dim} having count(*) > {thresh // 100} "
           f"order by s desc, {dim} limit {k}")
    got = ctx.sql(sql).to_pandas().reset_index(drop=True)

    d = df[(df["sku"].str.startswith("k01") if like
            else df["region"].isin(["ne", "se"])) & (df["qty"] >= 10)]
    rows = []
    for key, g in d.groupby(dim):
        if len(g) > thresh // 100:
            rows.append({dim: key, "s": g[m].sum(), "n": len(g)})
    want = pd.DataFrame(rows, columns=[dim, "s", "n"])
    if len(want):
        want = want.sort_values(["s", dim],
                                ascending=[False, True]).head(k) \
            .reset_index(drop=True)
    assert len(got) == len(want), sql
    if len(want):
        pd.testing.assert_frame_equal(got, want, check_dtype=False,
                                      rtol=1e-5), sql


# -- the storms ---------------------------------------------------------------

def _storm(execute, sqls):
    """Every statement at once from its own thread (barrier start); the
    frames and each member's ``last_stats``."""
    n = len(sqls)
    res, errs, stats = [None] * n, [None] * n, [None] * n
    bar = threading.Barrier(n)

    def worker(i):
        bar.wait()
        try:
            res[i] = execute(i).to_pandas()
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs[i] = e

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "a storm member never finished"
    assert not any(errs), errs
    return res


def _member(stats):
    """A member's plan: solo, or (members, lanes, the fusion counters)."""
    ss = stats.get("sharedscan") or {}
    if "group" not in ss:
        return ("solo",)
    return ("rode", ss["queries"], ss["lanes"],
            tuple(sorted((ss.get("fusion") or {}).items())))


def _run_storm(ctx, sqls):
    stats = [None] * len(sqls)

    def execute(i):
        r = ctx.sql(sqls[i])
        stats[i] = dict(ctx.engine.last_stats)
        return r
    return _storm(execute, sqls), stats


@pytest.fixture(scope="module")
def storm_pair():
    """The test's frame in a JAX storm context (its wave kernel off: not
    eligible on the CPU), a port storm context (``FUZZ_STORM_CONFIG``) and
    a port solo context, all at compaction's default."""
    df = _df()
    jctx = jsdot.Context({**STORM_CONFIG,
                          "sdot.pallas.wave.enabled": False})
    jctx.ingest_dataframe("t", df, time_column="ts", target_rows=1024)
    solo = sdot.Context(device="cpu")
    ds = solo.ingest_dataframe("t", df, time_column="ts", target_rows=1024)
    storm = sdot.Context(STORM_CONFIG, device="cpu")
    storm.store.register(ds)
    return jctx, storm, solo, df


@pytest.mark.parametrize("s", range(chip_smoke.FUZZ_STORMS))
def test_storm_matches_solo_pandas_and_the_jax_plan(storm_pair, s):
    jctx, ctx, solo, df = storm_pair
    size = chip_smoke.FUZZ_STORM_SIZE
    queries = [_gen_query(np.random.default_rng(1000 + i), df)
               for i in range(s * size, (s + 1) * size)]
    sqls = [q for q, _ in queries]
    co = ctx.engine.sharedscan
    before = co.stats()
    got, stats = _run_storm(ctx, sqls)
    after = co.stats()
    _, jstats = _run_storm(jctx, sqls)
    for i, ((sql, oracle), g) in enumerate(zip(queries, got)):
        want = solo.sql(sql).to_pandas()
        assert list(g.columns) == list(want.columns), sql
        chip_smoke.check_frame(f"storm {s}[{i}] vs solo", g, want, None,
                               STORM_RTOL)
        ref = oracle()
        assert len(g) == len(ref), sql
        if len(ref):
            pd.testing.assert_frame_equal(
                g.reset_index(drop=True),
                ref[g.columns].reset_index(drop=True),
                check_dtype=False, rtol=1e-5, atol=1e-6)
    # which members ride, in groups of how many lanes, fused how: as the
    # JAX package's coalescer and fusion planner decide
    assert [_member(st) for st in stats] == [_member(st) for st in jstats]
    reasons = {k: v - before["wave_fallback_reasons"].get(k, 0)
               for k, v in after["wave_fallback_reasons"].items()
               if v != before["wave_fallback_reasons"].get(k, 0)}
    delta = {k: after[k] - before[k] for k in ("fallbacks", "wave_launches")}
    plan = chip_smoke.storm_plan(stats, dict(delta,
                                             wave_fallback_reasons=reasons))
    assert plan == chip_smoke.FUZZ_STORM_PLAN[s]
    assert delta["wave_launches"] == (not reasons)


def test_chip_statements_are_the_tests():
    """Phase ``fuzz`` runs exactly this file's 60 statements, and its
    vectorised oracle gives this file's answers on the test's frame."""
    df = _df()
    stmts = chip_smoke.fuzz_statements()
    assert len(stmts) == 60
    for i, (sql, shape) in enumerate(stmts[:40]):
        want_sql, oracle = _gen_query(np.random.default_rng(1000 + i), df)
        assert sql == want_sql
        want, got = oracle(), chip_smoke.fuzz_oracle(df, shape)
        assert len(got) == len(want), sql
        if len(want):
            pd.testing.assert_frame_equal(
                got.reset_index(drop=True),
                want[got.columns].reset_index(drop=True),
                check_dtype=False, rtol=1e-12)
    for i, (sql, shape) in enumerate(stmts[40:]):
        rng = np.random.default_rng(5000 + i)
        dim, m = str(rng.choice(DIMS)), str(rng.choice(METRICS))
        assert sql.startswith(f"select {dim}, sum({m}) as s, ")
        assert len(chip_smoke.fuzz_oracle(df, shape)) <= shape["having"][3]
    assert chip_smoke.fuzz_frame(N).equals(df)


def test_phase_storm_plan_on_the_plain_versions(monkeypatch):
    """Phase ``fuzz``'s own storm function at 2^14 rows on the CPU: every
    storm's plan is ``FUZZ_STORM_PLAN``, as the card's run checks; each
    storm captured its B2 call(s) and each answer equals its solo one."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    ns = types.SimpleNamespace(
        Context=functools.partial(sdot.Context, device="cpu"))
    df = chip_smoke.fuzz_frame(STORM_ROWS)
    solo_ctx = ns.Context(chip_smoke.FUZZ_SOLO_CONFIG)
    ds = solo_ctx.ingest_dataframe("t", df, time_column="ts",
                                   target_rows=STORM_ROWS // 4)
    statements = chip_smoke.fuzz_statements()[
        :chip_smoke.FUZZ_STORMS * chip_smoke.FUZZ_STORM_SIZE]
    solo = []
    for sql, shape in statements:
        got = solo_ctx.sql(sql).to_pandas()
        chip_smoke.fuzz_check(sql, got, chip_smoke.fuzz_oracle(df, shape))
        solo.append(got)
    ctx = ns.Context(STORM_CONFIG)
    ctx.store.register(ds)
    spies = chip_smoke.KernelSpies(CG, CW)
    storms = chip_smoke.fuzz_storms(ctx, statements, solo, spies)
    assert [st["plan"] for st in storms] == list(chip_smoke.FUZZ_STORM_PLAN)
    assert all(len(st["launches"]) == 1 for st in storms)
    progs = chip_smoke.fuzz_programs(CW, spies.b2)
    assert progs["programs"] == chip_smoke.FUZZ_STORMS
    assert progs["lanes"] == [chip_smoke.FUZZ_STORM_SIZE] * \
        chip_smoke.FUZZ_STORMS
