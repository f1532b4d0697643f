"""JAX ``tests/test_plan_cache.py`` bound to the port: the statement plan
cache. Warm statements skip the rewrite/build passes; ingest and config
changes invalidate (key folds store.version + config fingerprint — same
contract as the subquery result caches).

Every statement also runs on a JAX twin context over the same frames and
config changes; its ``plan_cached`` flag and mode are held equal to the
JAX package's, its answers to the JAX test's closed forms."""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd

import spark_druid_olap_tpu_torch as sdot

from torch_twin import mirrored


def _ctx():
    c = mirrored(sdot.Context(device="cpu"))
    rng = np.random.default_rng(3)
    df = pd.DataFrame({
        "ts": pd.Timestamp("2021-01-01")
        + pd.to_timedelta(rng.integers(0, 30, 800), unit="D"),
        "region": rng.choice(["a", "b", "c"], 800),
        "qty": rng.integers(0, 50, 800),
    })
    c.ingest_dataframe("sales", df, time_column="ts", target_rows=512)
    return c


Q = "select region, sum(qty) as s from sales group by region order by region"


def _sql(c, sql):
    """``sql`` on the port context and its JAX twin: ``plan_cached`` and
    the mode equal; the port's result."""
    r = c.sql(sql)
    c.jax.sql(sql)
    st = c.history.entries()[-1].stats
    jst = c.jax.history.entries()[-1].stats
    assert bool(st.get("plan_cached")) == bool(jst.get("plan_cached"))
    assert st["mode"] == jst["mode"]
    return r


def test_warm_statement_hits_plan_cache():
    c = _ctx()
    _sql(c, Q)
    assert not c.history.entries()[-1].stats.get("plan_cached")
    r = _sql(c, Q)
    st = c.history.entries()[-1].stats
    assert st.get("plan_cached") is True
    assert st["mode"] == "engine"
    assert len(r) == 3


def test_ingest_invalidates_plan_cache():
    c = _ctx()
    base = _sql(c, Q).to_pandas()
    _sql(c, Q)                                   # warm the plan cache
    assert c.history.entries()[-1].stats.get("plan_cached") is True
    df2 = pd.DataFrame({
        "ts": [pd.Timestamp("2021-02-15")] * 5,
        "region": ["a"] * 5,
        "qty": [100] * 5,
    })
    c.ingest_dataframe("extra", df2, time_column="ts", target_rows=512)
    r = _sql(c, Q)                               # store.version bumped
    st = c.history.entries()[-1].stats
    assert not st.get("plan_cached")
    pd.testing.assert_frame_equal(r.to_pandas(), base, check_dtype=False)


def test_config_change_invalidates_plan_cache():
    c = _ctx()
    _sql(c, Q)
    _sql(c, Q)
    assert c.history.entries()[-1].stats.get("plan_cached") is True
    c.config.set("sdot.timezone", "America/New_York")
    c.jax.config.set("sdot.timezone", "America/New_York")
    _sql(c, Q)
    assert not c.history.entries()[-1].stats.get("plan_cached")
