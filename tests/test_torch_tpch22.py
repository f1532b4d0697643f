"""Every TPC-H statement through the port's ``Context.sql`` against the JAX
package's, at ``tests/test_tpch22.py``'s scale.

Both packages' ``tools/tpch.setup_context`` build the same star (SF 0.002,
4,096 target rows per segment: the port's generator is held equal to the
JAX one by ``test_torch_isolation.py``); each statement of
``tpch.QUERIES`` (the 22 queries and the three benchmark alterations),
and q18 at threshold 150 (the standard 300 passes no order at this
scale), runs through both. Each answer must equal the JAX package's, in
the same mode (``engine`` or the host tier).

Tolerance: dimensions, integers, counts and min/max exact; float sums
rtol 1e-6 (float metrics are stored f32; the engines sum in different
orders).
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.tools import tpch as jtpch

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.tools import tpch as ttpch

from test_torch_sql import assert_answers_equal

SF = 0.002


@pytest.fixture(scope="module")
def pair():
    jctx, tctx = jsdot.Context(), tsdot.Context(device="cpu")
    jtpch.setup_context(jctx, sf=SF, target_rows=4096)
    ttpch.setup_context(tctx, sf=SF, target_rows=4096)
    return jctx, tctx


def _mode(ctx):
    return ctx.history.entries()[-1].stats["mode"]


def _equal(pair, sql):
    jctx, tctx = pair
    want = jctx.sql(sql).to_pandas()
    got = tctx.sql(sql).to_pandas()
    assert _mode(tctx) == _mode(jctx), (_mode(tctx), _mode(jctx))
    assert_answers_equal(got, want, ordered="order by" in sql.lower())
    return got


@pytest.mark.parametrize("name", list(ttpch.QUERIES))
def test_statement_equals_the_jax_package(pair, name):
    assert ttpch.QUERIES[name] == jtpch.QUERIES[name]
    _equal(pair, ttpch.QUERIES[name])


def test_q18_lower_threshold(pair):
    sql = ttpch.QUERIES["q18"].replace("> 300", "> 150")
    assert len(_equal(pair, sql)) > 0, "threshold 150 passes no order"
