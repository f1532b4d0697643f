"""JAX ``tests/test_fusion.py`` bound to the port: the cross-lane fusion
planner (planner/fusion.py).

The planner's keys and counters are the JAX test's closed forms, each
also held equal to the JAX planner's on the same filters (built in each
package's IR through the shared serde); the solo-path differential runs
on a port store over conftest's sales frame, its CSE counters equal to
the JAX engine's on the same spec. The port's solo path lowers eagerly
and caches no program, so ``test_solo_cse_toggle_recompiles_under_new_key``
holds the toggle's contract on what the port has: the flip takes effect
on the next statement (the counters stop, the answers stay identical,
no solo program is cached to go stale), as the JAX engine's counters do
across the same flip.

Original notes: cross-lane fusion planner (planner/fusion.py).

Host-side unit coverage for the canonicalizer and plan analysis —
canonical keys unify commuted AND/OR, the memoized-traversal counters
are exact and arrival-order independent, the node budget raises — plus
the solo-path differential: one query whose own tree repeats a
sub-predicate (OR-of-bounds over a shared selector) must return
identical answers with the CSE cache on and off, while the engine's
``solo_evals_saved`` counter proves the repeated subtree lowered once.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import pytest

from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.parallel.executor import QueryEngine
from spark_druid_olap_tpu_torch.planner import fusion as FU
from spark_druid_olap_tpu_torch.utils.config import Config

from spark_druid_olap_tpu.ir import serde as JSER
from spark_druid_olap_tpu.planner import fusion as JFU
from spark_druid_olap_tpu_torch.ir import serde as TSER

from conftest import assert_frames_equal, make_sales_df
from torch_twin import jax_engine, jax_spec, jax_store


@pytest.fixture(scope="module")
def store():
    """conftest's ``store`` (the sales frame, 4,096 target rows) in the
    port."""
    from spark_druid_olap_tpu_torch.segment.ingest import ingest_dataframe
    from spark_druid_olap_tpu_torch.segment.store import SegmentStore
    st = SegmentStore()
    st.register(ingest_dataframe("sales", make_sales_df(), time_column="ts",
                                 target_rows=4096))
    return st


def _jf(f):
    """The port's filter in the JAX package's IR."""
    return JSER.filter_from_dict(TSER.filter_to_dict(f))


def _jlanes(lanes):
    return [(_jf(f), iv, tuple(_jf(a) for a in af)) for f, iv, af in lanes]


@pytest.fixture(scope="module")
def jstore():
    return jax_store(("sales", make_sales_df(),
                      {"time_column": "ts", "target_rows": 4096}))


SEL = S.SelectorFilter("status", "O")
B_LO = S.BoundFilter("qty", upper=5, numeric=True)
B_HI = S.BoundFilter("qty", lower=40, numeric=True)


# -- canonical keys -----------------------------------------------------------

def test_canon_key_commuted_and_or_unify():
    ab = S.LogicalFilter("and", (SEL, B_LO))
    ba = S.LogicalFilter("and", (B_LO, SEL))
    assert FU.canon_key(ab) == FU.canon_key(ba)
    o_ab = S.LogicalFilter("or", (SEL, B_LO))
    o_ba = S.LogicalFilter("or", (B_LO, SEL))
    assert FU.canon_key(o_ab) == FU.canon_key(o_ba)
    # AND and OR over the same operands must NOT collide
    assert FU.canon_key(ab) != FU.canon_key(o_ab)


def test_canon_key_not_is_structural():
    n1 = S.LogicalFilter("not", (SEL,))
    n2 = S.LogicalFilter("not", (B_LO,))
    assert FU.canon_key(n1) != FU.canon_key(n2)
    assert FU.canon_key(n1) == FU.canon_key(
        S.LogicalFilter("not", (S.SelectorFilter("status", "O"),)))


def test_canon_key_none_never_collides():
    assert FU.canon_key(None) == FU.canon_key(None)
    assert FU.canon_key(None) != FU.canon_key(SEL)


def test_interval_key_roundtrip():
    assert FU.interval_key(None) is None
    assert FU.interval_key(()) is None
    iv = ((100, 200),)
    assert FU.interval_key(iv) == FU.interval_key(list(iv))
    assert FU.interval_key(iv) != FU.interval_key(((100, 201),))


# -- analysis counters --------------------------------------------------------

def test_analyze_query_counts_repeats():
    # or(and(SEL, B_LO), and(SEL, B_HI)): 7 memoized requests (SEL's
    # second occurrence is a cache hit), 6 distinct sub-predicates
    f = S.LogicalFilter("or", (S.LogicalFilter("and", (SEL, B_LO)),
                               S.LogicalFilter("and", (SEL, B_HI))))
    total, distinct = FU.analyze_query(f, None, [])
    assert (total, distinct) == JFU.analyze_query(_jf(f), None, [])
    assert total == 7
    assert distinct == 6
    # no repetition -> nothing to save
    total, distinct = FU.analyze_query(SEL, None, [])
    assert total == distinct == 1
    # an interval pseudo-node and agg filters join the surface
    total, distinct = FU.analyze_query(SEL, ((0, 10),), [SEL, B_LO])
    assert total == 4 and distinct == 3


def test_plan_lanes_counts_cross_lane_sharing():
    lanes = [
        (SEL, None, ()),
        (S.LogicalFilter("and", (SEL, B_LO)), None, ()),
        (S.LogicalFilter("and", (B_LO, SEL)), None, ()),   # commuted
    ]
    plan = FU.plan_lanes(lanes, per_lane_cols=[3, 4, 4], union_cols=5)
    jplan = JFU.plan_lanes(_jlanes(lanes), per_lane_cols=[3, 4, 4],
                           union_cols=5)
    assert plan.counters() == jplan.counters()
    assert plan.n_lanes == 3
    assert plan.shared_predicates >= 2          # SEL and the AND itself
    assert plan.predicate_evals_saved == plan.n_nodes - plan.n_distinct
    assert plan.predicate_evals_saved > 0
    assert plan.column_streams_saved == 3 + 4 + 4 - 5
    # representatives surface so the builder can prelower shared masks
    keys = {FU.canon_key(n) for n in plan.shared_nodes}
    assert FU.canon_key(SEL) in keys


def test_plan_lanes_token_is_arrival_order_independent():
    lanes = [
        (S.LogicalFilter("and", (SEL, B_LO)), ((0, 50),), (B_HI,)),
        (SEL, ((0, 50),), ()),
        (B_HI, None, (SEL,)),
    ]
    cols = [4, 3, 2]
    base = FU.plan_lanes(lanes, cols, union_cols=5)
    perm = FU.plan_lanes([lanes[2], lanes[0], lanes[1]],
                         [cols[2], cols[0], cols[1]], union_cols=5)
    assert base.token() == perm.token()
    assert base.counters() == perm.counters()
    assert base.counters() == JFU.plan_lanes(_jlanes(lanes), cols,
                                             union_cols=5).counters()


def test_plan_lanes_node_budget_raises():
    lanes = [(S.LogicalFilter("and", (SEL, B_LO, B_HI)), None, ())] * 4
    with pytest.raises(ValueError):
        FU.plan_lanes(lanes, [2] * 4, union_cols=2, max_nodes=3)
    with pytest.raises(ValueError):
        JFU.plan_lanes(_jlanes(lanes), [2] * 4, union_cols=2, max_nodes=3)
    # uncapped (0) never raises
    FU.plan_lanes(lanes, [2] * 4, union_cols=2, max_nodes=0)


# -- solo-path CSE differential ----------------------------------------------

def _solo_engine(store, fused):
    return QueryEngine(store, config=Config({
        "sdot.sharedscan.fusion.enabled": fused,
        "sdot.wlm.enabled": False}), device="cpu")


def _jax_fusion(jstore, q, fused):
    eng = jax_engine(jstore, {"sdot.sharedscan.fusion.enabled": fused,
                              "sdot.wlm.enabled": False})
    eng.execute(jax_spec(q)).to_pandas()
    return eng.sharedscan.stats()["fusion"]


_SOLO_KEYS = ("solo_evals_saved", "solo_evals_total", "cse_hit_rate")


def test_solo_or_of_bounds_cse_differential(store, jstore):
    """A single query repeating a sub-predicate (shared selector under
    both OR branches) returns identical answers with CSE on and off, and
    the on-engine's counters prove the repeat lowered once."""
    q = S.GroupByQuerySpec(
        "sales", (S.DimensionSpec("region", "region"),),
        (S.AggregationSpec("doublesum", "revenue", field="price"),
         S.AggregationSpec("count", "n")),
        filter=S.LogicalFilter("or", (
            S.LogicalFilter("and", (SEL, B_LO)),
            S.LogicalFilter("and", (SEL, B_HI)))))
    eng_on = _solo_engine(store, True)
    eng_off = _solo_engine(store, False)
    got = eng_on.execute(q).to_pandas()
    want = eng_off.execute(q).to_pandas()
    assert_frames_equal(got, want)
    st = eng_on.sharedscan.stats()["fusion"]
    assert st["solo_evals_saved"] > 0, st
    assert st["solo_evals_total"] > st["solo_evals_saved"], st
    assert eng_off.sharedscan.stats()["fusion"]["solo_evals_saved"] == 0
    jst = _jax_fusion(jstore, q, True)
    assert {k: st[k] for k in _SOLO_KEYS} == {k: jst[k] for k in _SOLO_KEYS}


def test_solo_cse_toggle_recompiles_under_new_key(store, jstore):
    """sdot.sharedscan.fusion.enabled takes effect on the next solo
    statement: no CSE'd lowering is reused after the flip (the port caches
    no solo program; its counters stop ticking, as the JAX engine's do
    across its recompile) and answers stay identical."""
    q = S.TimeseriesQuerySpec(
        "sales", (S.AggregationSpec("longsum", "units", field="qty"),),
        filter=S.LogicalFilter("or", (SEL, B_HI)))
    eng = _solo_engine(store, True)
    jeng = jax_engine(jstore, {"sdot.sharedscan.fusion.enabled": True,
                               "sdot.wlm.enabled": False})
    a = eng.execute(q).to_pandas()
    jeng.execute(jax_spec(q)).to_pandas()
    on = eng.sharedscan.stats()["fusion"]["solo_evals_total"]
    assert on > 0
    eng.config.set("sdot.sharedscan.fusion.enabled", False)
    jeng.config.set("sdot.sharedscan.fusion.enabled", False)
    b = eng.execute(q).to_pandas()
    jeng.execute(jax_spec(q)).to_pandas()
    assert_frames_equal(a, b)
    assert eng.sharedscan.stats()["fusion"]["solo_evals_total"] == on
    assert {k: eng.sharedscan.stats()["fusion"][k] for k in _SOLO_KEYS} \
        == {k: jeng.sharedscan.stats()["fusion"][k] for k in _SOLO_KEYS}
    assert not eng._programs
