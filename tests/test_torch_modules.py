"""The port's extension modules against the JAX package's.

The cases of ``tests/test_modules.py`` through both packages'
``Context``: a module's scalar function (on the host, and on the device
through the dictionary path, grouped on and filtered by), its spec rule
(a topN threshold clamp), its statement handler, loading from
``sdot.modules`` and a bad module name. ``load_module`` checks each
package's own ``Module`` class, so there is one module class per package
with the same functions. The same ``conftest.make_sales_df`` frame goes
into both (the port on the CPU); answers and modes must be equal:
dimensions, integers and counts exact, float sums rtol 1e-6.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import dataclasses

import numpy as np
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.ir import spec as JS
from spark_druid_olap_tpu.result import QueryResult as JResult
from spark_druid_olap_tpu.utils.modules import Module as JModule

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.planner.host_exec import datasource_frame
from spark_druid_olap_tpu_torch.result import QueryResult as TResult
from spark_druid_olap_tpu_torch.utils.modules import Module as TModule

from conftest import make_sales_df
from test_torch_sql import assert_answers_equal


def _shout(s):
    return s.upper() + "!"


def _rules(S):
    def force_small_threshold(q, conf):
        # demo rule: clamp any topN threshold to 3
        if isinstance(q, S.TopNQuerySpec) and q.threshold > 3:
            return dataclasses.replace(q, threshold=3)
        return None
    return [force_small_threshold]


def _handlers(Result):
    def ping(ctx, sql):
        if sql.strip().upper() == "PING":
            return Result(["pong"], {"pong": np.array([1], dtype=np.int64)})
        return None
    return [ping]


class JaxSampleModule(JModule):
    def functions(self):
        return {"shout": _shout}

    def spec_rules(self):
        return _rules(JS)

    def statement_handlers(self):
        return _handlers(JResult)


class PortSampleModule(TModule):
    def functions(self):
        return {"shout": _shout}

    def spec_rules(self):
        return _rules(TS)

    def statement_handlers(self):
        return _handlers(TResult)


def _new(pkg, config=None):
    return jsdot.Context(config) if pkg == "jax" \
        else tsdot.Context(config, device="cpu")


@pytest.fixture()
def pair():
    df = make_sales_df()
    ctxs = []
    for pkg, mod in (("jax", JaxSampleModule), ("torch", PortSampleModule)):
        c = _new(pkg)
        c.ingest_dataframe("sales", df, time_column="ts", target_rows=4096)
        c.install_module(mod())
        ctxs.append(c)
    yield ctxs
    for c in ctxs:
        c.functions.pop("shout", None)   # process-wide registry hygiene


def _both(pair, sql):
    out = []
    for c in pair:
        out.append((c.sql(sql).to_pandas(),
                    c.history.entries()[-1].stats.get("mode")))
    return out


def test_module_command(pair):
    for c in pair:
        r = c.sql("PING").to_pandas()
        assert int(r["pong"][0]) == 1


def test_module_function_host_and_device(pair):
    sql = ("select shout(region) as r, count(*) as c from sales "
           "group by shout(region) order by r")
    (want, jmode), (got, tmode) = _both(pair, sql)
    # a single-string-argument function pushes down through the
    # dictionary path in both packages
    assert jmode == tmode == "engine"
    assert_answers_equal(got, want, ordered=True)
    sales = datasource_frame(pair[1], "sales")
    counts = (sales.region.str.upper() + "!").value_counts().sort_index()
    assert list(got["r"]) == list(counts.index)
    assert list(got["c"]) == list(counts.values)


def test_module_function_in_filter(pair):
    sql = "select count(*) as c from sales where shout(region) = 'EAST!'"
    (want, jmode), (got, tmode) = _both(pair, sql)
    assert jmode == tmode
    assert_answers_equal(got, want, ordered=True)
    sales = datasource_frame(pair[1], "sales")
    assert int(got["c"][0]) == int((sales.region == "east").sum())


def test_module_spec_rule(pair):
    sql = ("select product, sum(price) as rev from sales "
           "group by product order by rev desc limit 10")
    (want, jmode), (got, tmode) = _both(pair, sql)
    assert len(got) == len(want) == 3   # the rule clamped the threshold
    assert jmode == tmode
    assert_answers_equal(got, want, ordered=True)


def test_module_load_from_config():
    for pkg, cls in (("jax", "JaxSampleModule"),
                     ("torch", "PortSampleModule")):
        c = _new(pkg, {"sdot.modules": f"test_torch_modules:{cls}"})
        try:
            assert len(c.modules) == 1
            c.ingest_dataframe("t", make_sales_df(1000), time_column="ts")
            assert int(c.sql("PING").to_pandas()["pong"][0]) == 1
        finally:
            c.functions.pop("shout", None)


def test_module_of_the_other_package_is_refused():
    # load_module holds the class against the loading package's Module
    with pytest.raises(TypeError, match="not a Module"):
        _new("torch", {"sdot.modules": "test_torch_modules:JaxSampleModule"})


def test_bad_module_spec():
    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError):
            _new(pkg, {"sdot.modules": "no_colon_here"})


def test_module_function_numeric_string_result(pair):
    # a module function returning numeric-looking strings is not cast to
    # float on the host path
    for c in pair:
        c.functions["qtycode"] = lambda q: str(int(q))
    try:
        sql = ("select qtycode(qty) as qc, count(*) as c from sales "
               "group by qtycode(qty) order by qc limit 3")
        (want, jmode), (got, tmode) = _both(pair, sql)
        assert jmode == tmode
        assert all(isinstance(v, str) for v in got["qc"])
        assert_answers_equal(got, want, ordered=True)
    finally:
        for c in pair:
            c.functions.pop("qtycode", None)
