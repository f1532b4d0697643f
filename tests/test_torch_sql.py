"""The port's SQL front end against the JAX package's.

The same SQL text runs through both packages' ``Context.sql`` /
``explain`` / parser / planner, over the same data: TPC-H SF 0.01 from each
package's ``tools/tpch.setup_context`` (the port's generator is held equal
to the JAX one by ``test_torch_isolation.py``), and ``conftest.make_sales_df``
ingested into both. The port runs with ``device="cpu"``, where its kernel
wrappers take their plain PyTorch versions.

Tolerances: ASTs and plans are compared field by field and exactly, except
the float values of decorrelated subquery tables inlined into a plan
(computed by each engine; rtol 1e-6). Answers: dimensions, integers,
counts and min/max exact; float sums rtol 1e-6 (float metrics are stored
f32 and the engines sum them in different orders).
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import ast
import dataclasses
import math
import pathlib
import re
import threading

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.planner import builder as JB
from spark_druid_olap_tpu.planner import decorrelate as JD
from spark_druid_olap_tpu.planner import scoping as JSC
from spark_druid_olap_tpu.planner import viewmerge as JV
from spark_druid_olap_tpu.planner.plans import PlanUnsupported as JPlanUnsupported
from spark_druid_olap_tpu.sql import session as JSESS
from spark_druid_olap_tpu.sql.parser import parse_statement as jparse
from spark_druid_olap_tpu.tools import tpch as jtpch

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.planner import builder as TB
from spark_druid_olap_tpu_torch.planner import decorrelate as TD
from spark_druid_olap_tpu_torch.planner import scoping as TSC
from spark_druid_olap_tpu_torch.planner import viewmerge as TV
from spark_druid_olap_tpu_torch.planner.plans import PlanUnsupported
from spark_druid_olap_tpu_torch.sql import session as TSESS
from spark_druid_olap_tpu_torch.sql.parser import parse_statement as tparse
from spark_druid_olap_tpu_torch.tools import tpch as ttpch

from conftest import make_sales_df

SF = 0.01
TARGET_ROWS = 16_384            # several segments per datasource
FLOAT_RTOL = 1e-6
TEST_SQL = pathlib.Path(__file__).with_name("test_sql.py")

# the statements the slice runs on the card (chip_smoke.py phase "sql")
MAIN = ["shipdate_range", "q1", "q5", "q6", "q7", "q8", "q12", "q14"]


def _sql_strings():
    """Every SQL statement string in tests/test_sql.py, in file order."""
    out = []
    for n in ast.walk(ast.parse(TEST_SQL.read_text())):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) and \
                n.value.strip().lower().startswith(
                    ("select", "clear", "explain", "on datasource")):
            out.append(n.value)
    return list(dict.fromkeys(out))


def _ctest_strings():
    """The SQL that tests/test_sql.py checks with ``ctest``."""
    out = []
    for n in ast.walk(ast.parse(TEST_SQL.read_text())):
        if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "ctest":
            out.append(n.args[2].value)
    return out


SQL_STRINGS = _sql_strings()
CTEST_STRINGS = _ctest_strings()
STATEMENTS = dict(jtpch.QUERIES, **{f"test_sql[{i}]": s
                                    for i, s in enumerate(SQL_STRINGS)})


# -- comparison ---------------------------------------------------------------

def assert_same(a, b, path="", rtol=0.0):
    """Recursive field-by-field equality of two packages' dataclass trees:
    class names compared, module names ignored."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, (path, a, b)
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}", rtol)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]", rtol)
    elif isinstance(a, dict):
        assert list(a) == list(b), (path, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]", rtol)
    elif type(a).__name__ == "FrozenIntSet":
        assert type(b).__name__ == "FrozenIntSet", (path, b)
        np.testing.assert_array_equal(a.array, b.array, err_msg=path)
    elif type(a).__name__ in ("FrozenKeyedTable", "FrozenKeyedTable2"):
        assert type(b).__name__ == type(a).__name__, (path, b)
        for s in a.__slots__:
            x, y = getattr(a, s), getattr(b, s)
            if s == "values":
                np.testing.assert_allclose(y, x, rtol=rtol, err_msg=path)
            elif s != "_digest":
                np.testing.assert_array_equal(x, y, err_msg=path)
    elif isinstance(a, float) and isinstance(b, float):
        assert (math.isnan(a) and math.isnan(b)) or \
            math.isclose(a, b, rel_tol=rtol, abs_tol=0.0), (path, a, b)
    else:
        assert type(a).__name__ == type(b).__name__ and a == b, (path, a, b)


def assert_answers_equal(got: pd.DataFrame, want: pd.DataFrame, ordered):
    """Port frame vs JAX frame: same columns and dtypes kinds; exact for
    everything but floats (rtol 1e-6)."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    if not ordered:
        keys = [c for c in want.columns if want[c].dtype.kind != "f"]
        if keys:
            got = got.sort_values(keys, kind="mergesort") \
                .reset_index(drop=True)
            want = want.sort_values(keys, kind="mergesort") \
                .reset_index(drop=True)
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        assert g.dtype.kind == w.dtype.kind, (c, g.dtype, w.dtype)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=0,
                                       err_msg=c)
        elif w.dtype.kind == "O":
            # None and NaN both spell SQL NULL in object columns
            np.testing.assert_array_equal(
                pd.Series(g).fillna("<null>").to_numpy(),
                pd.Series(w).fillna("<null>").to_numpy(), err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


def _mode(ctx):
    # a raw query (ON DATASOURCE ... EXECUTE QUERY) records the engine's
    # stats, which carry no session mode, in both packages
    return ctx.history.entries()[-1].stats.get("mode")


# -- fixtures -----------------------------------------------------------------

def _contexts(flat_only):
    jctx, tctx = jsdot.Context(), tsdot.Context(device="cpu")
    jtpch.setup_context(jctx, sf=SF, target_rows=TARGET_ROWS,
                        flat_only=flat_only)
    ttpch.setup_context(tctx, sf=SF, target_rows=TARGET_ROWS,
                        flat_only=flat_only)
    for c in (jctx, tctx):
        c.ingest_dataframe("sales", make_sales_df(), time_column="ts",
                           target_rows=4096)
    return jctx, tctx


@pytest.fixture(scope="module")
def flat_pair():
    """The chip's setup: the flat TPC-H star only (``flat_only=True``)."""
    return _contexts(flat_only=True)


@pytest.fixture(scope="module")
def full_pair():
    """Every TPC-H base table, both flat stars and the sales frame."""
    return _contexts(flat_only=False)


# -- parser -------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STATEMENTS))
def test_parser_gives_the_jax_ast(name):
    sql = STATEMENTS[name]
    assert_same(jparse(sql), tparse(sql))


# -- planner ------------------------------------------------------------------

def _jax_plan(ctx, sql):
    s = jparse(sql)
    s = JSESS.resolve_lookups(ctx, JSC.resolve_alias_scopes(
        ctx, JSC.resolve_databases(ctx, s)))
    s = JD.inline_subqueries(ctx, JD.inline_correlated_scalars(
        ctx, JD.decorrelate_semijoins(ctx, JV.merge_derived(ctx, s))))
    return JB.build(ctx, s)


def _port_plan(ctx, sql):
    s = tparse(sql)
    s = TSESS.resolve_lookups(ctx, TSC.resolve_alias_scopes(
        ctx, TSC.resolve_databases(ctx, s)))
    s = TD.inline_subqueries(ctx, TD.inline_correlated_scalars(
        ctx, TD.decorrelate_semijoins(ctx, TV.merge_derived(ctx, s))))
    return TB.build(ctx, s)


# statements whose rewrite runs an inner query on a path the port has not
# ported; empty since the select path landed (q16's and q20's inner
# selects run, and q20's outer join is refused by both composite tiers)
PLAN_REFUSED = {}


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_planner_gives_the_jax_plan(full_pair, name):
    """The whole pre-execution pipeline (scoping, view merge,
    decorrelation and inlining, then the builder): the same PlannedQuery
    field by field, or the same rejection."""
    jctx, tctx = full_pair
    sql = STATEMENTS[name]
    if name in PLAN_REFUSED:
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP {PLAN_REFUSED[name]}"):
            _port_plan(tctx, sql)
        return
    try:
        want = _jax_plan(jctx, sql)
    except JPlanUnsupported as e:
        with pytest.raises(PlanUnsupported) as got:
            _port_plan(tctx, sql)
        assert str(got.value) == str(e)
        return
    except Exception as e:  # noqa: BLE001 — commands are not selects
        with pytest.raises(Exception) as got:
            _port_plan(tctx, sql)
        assert type(got.value).__name__ == type(e).__name__
        return
    assert_same(want, _port_plan(tctx, sql), rtol=FLOAT_RTOL)


def test_star_join_collapse_plan(flat_pair):
    _, tctx = flat_pair
    pq = TB.build(tctx, tparse(ttpch.QUERIES["q5"]))
    assert pq.datasource == "tpch_flat"
    assert len(pq.specs) == 1


def test_fact_only_query_uses_flat(flat_pair, full_pair):
    sql = "select l_returnflag, count(*) from lineitem group by l_returnflag"
    # with the raw table registered it is used directly; without it the
    # fact table's star collapses the statement onto the flat datasource
    assert TB.build(full_pair[1], tparse(sql)).datasource == "lineitem"
    assert TB.build(flat_pair[1], tparse(sql)).datasource == "tpch_flat"


def test_trial_lowering_runs_on_cpu_and_lets_unported_paths_through(
        flat_pair):
    """Builder._spec_pushable lowers on CPU tensors; a lowering the
    port has not ported propagates instead of becoming host residue."""
    _, tctx = flat_pair
    ds = tctx.store.get("tpch_flat")
    b = TB.Builder(tctx, tparse("select count(*) from tpch_flat"))
    b.ds = ds
    from spark_druid_olap_tpu_torch.ir import spec as S
    spatial = S.SpatialFilter("loc", ("l_quantity", "l_tax"),
                              (0.0, 0.0), (1.0, 1.0))
    # the spatial filter lowers since the port has it (A.1's remnant)
    assert b._spec_pushable(S.LogicalFilter("and", (spatial,)))
    from spark_druid_olap_tpu_torch.ir import expr as E
    # a CASE producing strings is Unsupported in both compilers: residue
    assert not b._spec_pushable(S.ExprFilter(E.Comparison(
        "=", E.Case(((E.Literal(True), E.Column("l_shipmode")),),
                    E.Column("l_shipmode")), E.Literal("MAIL"))))
    assert b._spec_pushable(S.ExprFilter(E.Comparison(
        ">", E.Func("year", (E.Column("l_shipdate"),)), E.Literal(1995))))


# -- answers ------------------------------------------------------------------

def _both(pair, sql):
    jctx, tctx = pair
    want = jctx.sql(sql).to_pandas()
    got = tctx.sql(sql).to_pandas()
    return got, want, _mode(tctx), _mode(jctx)


@pytest.mark.parametrize("name", MAIN)
def test_tpch_answers_equal_the_jax_engine(flat_pair, name):
    sql = ttpch.QUERIES[name]
    got, want, tmode, jmode = _both(flat_pair, sql)
    assert tmode == jmode == "engine"
    assert_answers_equal(got, want, ordered="order by" in sql.lower())


def test_filters_range_same_answer_and_mode(flat_pair):
    got, want, tmode, jmode = _both(flat_pair,
                                    ttpch.QUERIES["filters_range"])
    assert tmode == jmode
    assert_answers_equal(got, want, ordered=False)


SALES = {f"ctest[{i}]": s for i, s in enumerate(CTEST_STRINGS)}
SALES.update({
    "count_distinct_exact": "select region, count(distinct product) as np "
                            "from sales group by region order by region",
    "grouping_sets": "select flag, status, sum(qty) as q from sales "
                     "group by grouping sets ((flag, status), (flag), ())",
    "uncorrelated_subquery": "select region, count(*) as cnt from sales "
                             "where qty > (select avg(qty) from sales) "
                             "group by region order by region",
    "select_distinct": "select distinct region from sales order by region",
    "derived_table": "select region, total from (select region, "
                     "sum(price) as total from sales group by region) t "
                     "where total > 0 order by region",
    "like_in_aggregate": "select status, sum(case when product like 'p01%' "
                         "then qty else 0 end) as q from sales "
                         "group by status order by status",
    "date_trunc_dim": "select date_trunc('month', ts) as m, count(*) as c "
                      "from sales group by date_trunc('month', ts) "
                      "order by m",
    "string_fn_dim": "select upper(region) as r, sum(qty) as q from sales "
                     "group by upper(region) order by r",
    "lookup_dim": "select lookup(region, 'compass') as r, count(*) as c "
                  "from sales group by lookup(region, 'compass') order by r",
    "regex_dim": "select regexp_extract(product, 'p(0[0-2])', 1) as p, "
                 "count(*) as c from sales group by "
                 "regexp_extract(product, 'p(0[0-2])', 1)",
    "date_math_filter": "select count(*) as c from sales where "
                        "datediff(due, ts) > 30 and month(ts) in (1, 2)",
    "bare_and_aliased": "select region, region as r from sales limit 5",
})


@pytest.mark.parametrize("name", list(SALES))
def test_sales_answers_equal_the_jax_engine(flat_pair, name):
    for c in flat_pair:
        c.register_lookup("compass", {"east": "E", "west": "W"})
    sql = SALES[name]
    got, want, tmode, jmode = _both(flat_pair, sql)
    assert tmode == jmode
    assert_answers_equal(got, want, ordered="order by" in sql.lower())


def test_correlated_subquery_runs_on_the_host_tier_in_both(full_pair):
    for c in full_pair:
        c.ingest_dataframe("regiondim", pd.DataFrame({
            "region_name": ["east", "west", "north", "south"],
            "min_qty": [10, 20, 30, 40]}))
    got, want, tmode, jmode = _both(
        full_pair, "select region_name from regiondim where "
        "(select count(*) from sales where region = region_name "
        " and qty >= min_qty) > 1000 order by region_name")
    assert tmode.startswith("host") and jmode.startswith("host")
    assert_answers_equal(got, want, ordered=True)


ASSISTED = ["uncorrelated_subquery", "derived_table"]


@pytest.mark.parametrize("name", list(SALES)[:len(CTEST_STRINGS)] + ASSISTED)
def test_engine_free_host_oracle(flat_pair, monkeypatch, name):
    """``host_engine_assist = False`` keeps the host tier off the engine,
    as tests/test_sql.py's ``ctest`` oracle needs: the port's host answer
    then equals the JAX package's engine-free host answer and the port's
    engine answer. With the assist on, a sub-statement that pushes down
    enters the engine."""
    from spark_druid_olap_tpu.planner import host_exec as JH
    from spark_druid_olap_tpu.sql.parser import parse_select as jselect
    from spark_druid_olap_tpu_torch.planner import host_exec as TH
    from spark_druid_olap_tpu_torch.sql.parser import parse_select as tselect
    jctx, tctx = flat_pair
    sql = SALES[name]
    engine = tctx.sql(sql).to_pandas()
    entered = []
    real = tctx.engine.execute
    monkeypatch.setattr(tctx.engine, "execute",
                        lambda q: entered.append(q) or real(q))
    monkeypatch.setattr(tctx, "_result_cache", {}, raising=False)
    ordered = "order by" in sql.lower()
    for c in flat_pair:
        c.host_engine_assist = False
    try:
        got = TH.execute_select(tctx, tselect(sql))
        want = JH.execute_select(jctx, jselect(sql))
    finally:
        for c in flat_pair:
            c.host_engine_assist = True
    assert entered == []
    assert_answers_equal(got, want, ordered)
    assert_answers_equal(engine, got, ordered)
    if name in ASSISTED:
        TH.execute_select(tctx, tselect(sql))
        assert entered


# -- what the port refuses ----------------------------------------------------

# window statements (A.7): refused until the window tier was ported, now
# held equal to the JAX engine's answers
WINDOWED = [
    "select region, qty, sum(qty) over (partition by region) "
    "as t from sales",
    "select region, qty, rank() over (order by qty) as r from sales",
]


@pytest.mark.parametrize("sql", WINDOWED)
def test_window_statements_answer_as_the_jax_engine(full_pair, sql):
    got, want, tmode, jmode = _both(full_pair, sql)
    assert tmode == jmode == "engine+window"
    assert_answers_equal(got, want, ordered=False)


REFUSED = [
    # (fixture, statement, ROADMAP item)
    # a multi-host partial store (A.8): select and search exchange rows
    ("full", "select ts, region, qty from sales where region = 'north' "
             "limit 20", "A.8"),
    ("full", "select product, count(*) as n from sales "
             "where product like '%02%' group by product", "A.8"),
]


def _partial_store(ctx, restrict, monkeypatch):
    """Host 0's partial store of two in place of ``sales``: its other rows
    live in a process this one has no group with."""
    ds = ctx.store.get("sales")
    part = restrict(ds, np.arange(ds.num_segments) % 2, 0)
    monkeypatch.setitem(ctx.store._datasources, "sales", part)


@pytest.mark.parametrize("where,sql,item", REFUSED)
def test_port_refuses_what_it_has_not_ported(flat_pair, full_pair, where,
                                             sql, item, monkeypatch):
    """What is refused: the A.8 statements over a partial store in ONE
    process, in both packages with ``require_complete``'s error (the
    multi-process mesh answers them, ``tests/test_torch_multihost.py``);
    over the complete store the JAX engine answers them."""
    from spark_druid_olap_tpu.segment.store import \
        restrict_to_host as jrestrict
    from spark_druid_olap_tpu_torch.segment.store import restrict_to_host
    jctx, tctx = flat_pair if where == "flat" else full_pair
    jctx.sql(sql)                      # the JAX engine answers it
    for ctx, restrict in ((jctx, jrestrict), (tctx, restrict_to_host)):
        _partial_store(ctx, restrict, monkeypatch)
        with pytest.raises(RuntimeError,
                           match="requires the complete datasource"):
            ctx.sql(sql)


# what earlier slices refused (device HAVING, A.4; the select path behind
# q2, q16, q20 and a raw select, A.5; the sketches, A.3; bound columns over
# sdot.engine.device.cache.bytes, A.5; the raw-query wire, A.9), now
# answered as the JAX engine does
ANSWERED = [
    ("full", "ON DATASOURCE sales EXECUTE QUERY '{\"queryType\": "
             "\"timeseries\", \"aggregations\": [{\"type\": \"count\", "
             "\"name\": \"c\"}]}'"),
    ("full", "select approx_count_distinct(product) as np from sales"),
    ("full", "select region, approx_count_distinct_theta(product) as d "
             "from sales group by region"),
    ("full", "select region, product, due, count(*) as c from sales "
             "group by region, product, due having count(*) > 1"),
    ("full", jtpch.QUERIES["q2"]),
    ("full", jtpch.QUERIES["q16"]),
    ("full", jtpch.QUERIES["q20"]),
    ("full", "select ts, region, qty from sales where region = 'east' "
             "limit 50"),
    # bound columns above the device cache's cap: the cache is dropped and
    # the scan binds in one wave
    ("full", "select flag, sum(qty) as s from sales group by flag"),
]


def _tiny_device_budget(pair, monkeypatch):
    for c in pair:
        monkeypatch.setitem(c.config._values,
                            "sdot.engine.device.cache.bytes", 1)


# what an answer needs on both sides
ANSWERED_SETUP = {
    "select flag, sum(qty) as s from sales group by flag":
        _tiny_device_budget}


@pytest.mark.parametrize("where,sql", ANSWERED)
def test_port_answers_what_it_refused(flat_pair, full_pair, where, sql,
                                      monkeypatch):
    pair = flat_pair if where == "flat" else full_pair
    if sql in ANSWERED_SETUP:
        ANSWERED_SETUP[sql](pair, monkeypatch)
    got, want, tmode, jmode = _both(pair, sql)
    assert tmode == jmode
    stats = [c.history.entries()[-1].stats for c in pair]
    for k in ("having_device", "select_filter"):
        assert stats[1].get(k) == stats[0].get(k), (k, stats)
    assert_answers_equal(got, want, ordered="order by" in sql.lower())
    if "having" in sql and "sales" in sql:
        assert stats[1]["having_device"] > 0


# ordered limits with device top-k: q3 over the flat star groups 36M keys
# on the hashed tier; over the full star the functional-dependency graph
# folds o_orderdate and o_shippriority into o_orderkey and q3 goes dense;
# q18's inner HAVING stays on the host at this scale (under 65,536 keys)
TOPK = [("flat", "q3", True), ("full", "q3", False),
        ("full", "q18", False)]


@pytest.mark.parametrize("where,name,hashed", TOPK)
def test_device_topk_answers_equal_the_jax_engine(flat_pair, full_pair,
                                                  where, name, hashed):
    pair = flat_pair if where == "flat" else full_pair
    got, want, tmode, jmode = _both(pair, jtpch.QUERIES[name])
    assert tmode == jmode == "engine"
    stats = [c.history.entries()[-1].stats for c in pair]
    for k in ("hashed", "hash_slots", "topk_device", "groups"):
        assert stats[0].get(k) == stats[1].get(k), (k, stats)
    assert bool(stats[1].get("hashed")) == hashed
    assert stats[1]["topk_device"] > 0
    assert_answers_equal(got, want, ordered=True)


def test_recognized_device_join_is_refused_not_answered_on_host(full_pair):
    """A two-table join the JAX engine runs on its device join tier runs
    on the port's broadcast tier too (ROADMAP A.7, ported): the same
    answer, mode and join decisions, and the same answer as both hosts
    with the tier switched off."""
    jctx, tctx = full_pair
    sql = ("select o_orderpriority, count(*) as c from orders o join "
           "customer c on o.o_custkey = c.c_custkey "
           "group by o_orderpriority")
    got, want, tmode, jmode = _both(full_pair, sql)
    assert tmode == jmode == "engine"
    assert_answers_equal(got, want, ordered=False)
    tjs, jjs = (c.engine.last_stats["join"] for c in (tctx, jctx))
    assert tjs["mode"] == jjs["mode"] == "broadcast"
    for k in ("build_rows", "table_slots", "match_width", "waves",
              "groups"):
        assert tjs[k] == jjs[k], k
    tctx.config.set("sdot.join.enabled", False)
    jctx.config.set("sdot.join.enabled", False)
    try:
        hgot, hwant, tmode, jmode = _both(full_pair, sql)
    finally:
        tctx.config.set("sdot.join.enabled", True)
        jctx.config.set("sdot.join.enabled", True)
    assert tmode == jmode and tmode.startswith("host")
    assert_answers_equal(hgot, hwant, ordered=False)
    assert_answers_equal(got, hgot, ordered=False)


# the join and window statements chip_smoke.py runs at SF1 (phases join and
# window): at SF 0.01 the JAX package puts each join on its broadcast tier,
# and both packages answer every one alike
@pytest.mark.parametrize("name", ["J1", "J2", "J3"])
def test_chip_smoke_joins_run_broadcast_in_both(full_pair, name):
    import chip_smoke
    got, want, tmode, jmode = _both(full_pair, chip_smoke.JOIN_SQL[name])
    assert tmode == jmode == "engine"
    assert_answers_equal(got, want, ordered=False)
    tjs, jjs = (c.engine.last_stats["join"] for c in reversed(full_pair))
    assert tjs["mode"] == jjs["mode"] == "broadcast"
    for k in ("build_rows", "table_slots", "match_width", "waves",
              "groups"):
        assert tjs[k] == jjs[k], k


@pytest.mark.parametrize("name", ["W1", "W2", "W3"])
def test_chip_smoke_windows_equal_the_jax_engine(full_pair, name):
    import chip_smoke
    got, want, tmode, jmode = _both(full_pair, chip_smoke.WINDOW_SQL[name])
    assert tmode == jmode == "engine+window"
    assert_answers_equal(got, want, ordered=False)


# -- explain ------------------------------------------------------------------

EXPLAIN = ["SELECT region, sum(price) FROM sales GROUP BY region",
           "SELECT region FROM sales WHERE qty > (SELECT avg(qty) FROM sales)",
           "SELECT nosuchcol FROM sales GROUP BY nosuchcol",
           jtpch.QUERIES["q5"], jtpch.QUERIES["q13"],
           "select region from sales union all select flag from sales",
           "EXPLAIN REWRITE " + jtpch.QUERIES["q12"]]


@pytest.mark.parametrize("i", range(len(EXPLAIN)))
def test_explain_text_equals_the_jax_text(full_pair, i):
    jctx, tctx = full_pair
    want, got = jctx.explain(EXPLAIN[i]), tctx.explain(EXPLAIN[i])
    assert got.split("\n") == want.split("\n")
    # each spec's cost table (parallel/cost.explain_cost) under its line
    n_specs = len(re.findall(r"^ *\[\d+\] ", got, re.M))
    assert len(re.findall(r"^ +single-chip cost=.* sharded\(1\)=", got,
                          re.M)) == n_specs


# -- concurrency --------------------------------------------------------------

STORM = ["q1", "q6", "shipdate_range", "q12"]


def test_concurrent_statements_coalesce_and_equal_solo_answers(flat_pair):
    """Four threads fire SQL at once with shared scan on: the statements
    coalesce in the shared-scan tier and each answer equals its solo
    answer (exact; floats rtol 1e-6)."""
    tctx = flat_pair[1]
    solo = {n: tctx.sql(ttpch.QUERIES[n]).to_pandas() for n in STORM}
    tctx.config.set("sdot.sharedscan.enabled", True)
    tctx.config.set("sdot.wlm.batch.window.ms", 200.0)
    res, errs = {}, {}
    bar = threading.Barrier(len(STORM))

    def worker(n):
        bar.wait()
        try:
            res[n] = tctx.sql(ttpch.QUERIES[n]).to_pandas()
            assert _mode(tctx) == "engine"
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs[n] = e

    try:
        threads = [threading.Thread(target=worker, args=(n,))
                   for n in STORM]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        tctx.config.set("sdot.sharedscan.enabled", False)
    assert not errs, errs
    assert tctx.engine.sharedscan.stats()["queries_coalesced"] > 0
    for n in STORM:
        assert_answers_equal(res[n], solo[n], ordered=True)


# -- plan cache ---------------------------------------------------------------

def test_plan_cache_is_invalidated_by_ingest_and_config_change():
    ctx = tsdot.Context(device="cpu")
    ctx.ingest_dataframe("sales", make_sales_df(2000), time_column="ts")
    sql = "select region, sum(qty) as q from sales group by region"

    def memo_hit():
        ctx.sql(sql)
        return ctx.history.entries()[-1].stats["plan_memo"]["hit"]

    assert memo_hit() is False
    assert memo_hit() is True
    v = ctx.store.version
    ctx.ingest_dataframe("other", make_sales_df(100), time_column="ts")
    assert ctx.store.version == v + 1
    assert memo_hit() is False
    assert memo_hit() is True
    fp = ctx.config.fingerprint()
    ctx.config.set("sdot.querycostmodel.topn.threshold", 10)
    assert ctx.config.fingerprint() != fp
    assert memo_hit() is False
    # operational keys stay out of the fingerprint
    ctx.config.set("sdot.plan.memo.entries", 64)
    assert memo_hit() is True
