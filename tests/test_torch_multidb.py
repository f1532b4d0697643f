"""JAX ``tests/test_multidb.py`` bound to the port: multi-database
namespaces. The port runs with ``device="cpu"`` against the JAX test's
closed forms and pandas counts; each statement's mode and the unresolved
name's error are held equal to the JAX package's on a twin context over
the same frames and default database.

Original notes: multi-database namespaces (VERDICT r2 missing item 2; reference:
MultiDBTest.scala — operation across non-default Hive databases).

Databases are dotted name prefixes in the one store: 'db.table' in FROM
addresses explicitly; with `sdot.database.default` set, unqualified
names resolve to the default database when only the qualified form is
registered (registered bare names always win)."""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu_torch as sdot

from torch_twin import last_mode_as_jax, mirrored, same_error


def _df(vals, seed=0):
    rng = np.random.default_rng(seed)
    n = 5_000
    return pd.DataFrame({
        "ts": np.repeat(np.datetime64("2021-01-01"), n)
        .astype("datetime64[ns]"),
        "region": rng.choice(vals, n),
        "qty": rng.integers(1, 100, n).astype(np.int64),
    })


@pytest.fixture()
def ctx():
    c = mirrored(sdot.Context(device="cpu"))
    c.ingest_dataframe("mart.sales", _df(["east", "west"]),
                       time_column="ts")
    c.ingest_dataframe("staging.sales", _df(["north", "south"], seed=1),
                       time_column="ts")
    return c


def test_qualified_names_address_explicitly(ctx):
    a = ctx.sql("select count(*) as n from mart.sales "
                "where region = 'east'").to_pandas()
    b = ctx.sql("select count(*) as n from staging.sales "
                "where region = 'north'").to_pandas()
    assert int(a["n"].iloc[0]) > 0 and int(b["n"].iloc[0]) > 0
    assert last_mode_as_jax(ctx) == "engine"


def test_default_database_resolution(ctx):
    bare = "select count(*) as n from sales"
    with pytest.raises(KeyError):
        ctx.sql(bare)
    same_error(lambda: ctx.sql(bare), lambda: ctx.jax.sql(bare))
    ctx.config.set("sdot.database.default", "mart")
    got = ctx.sql("select region, sum(qty) as s from sales "
                  "group by region order by region").to_pandas()
    assert got["region"].tolist() == ["east", "west"]
    ctx.config.set("sdot.database.default", "staging")
    got = ctx.sql("select region, sum(qty) as s from sales "
                  "group by region order by region").to_pandas()
    assert got["region"].tolist() == ["north", "south"]


def test_registered_bare_name_wins(ctx):
    ctx.ingest_dataframe("sales", _df(["bare"], seed=2), time_column="ts")
    ctx.config.set("sdot.database.default", "mart")
    got = ctx.sql("select region from sales group by region").to_pandas()
    assert got["region"].tolist() == ["bare"]


def test_default_db_in_subqueries_and_joins(ctx):
    ctx.config.set("sdot.database.default", "mart")
    got = ctx.sql(
        "select count(*) as n from sales s where qty > "
        "(select avg(qty) from staging.sales)").to_pandas()
    assert int(got["n"].iloc[0]) > 0


def test_default_db_in_join_on_subquery(ctx):
    aux = pd.DataFrame({"aregion": ["east", "west"], "aval": [1, 2]})
    ctx.ingest_dataframe("mart.aux", aux)
    ctx.config.set("sdot.database.default", "mart")
    got = ctx.sql(
        "select count(*) as n from mart.sales s join mart.aux b "
        "on s.region = b.aregion and s.qty in "
        "(select qty from sales where qty > 95)").to_pandas()
    want = ctx._len_hiqty = int(
        (_df(["east", "west"]).qty > 95).sum())
    assert int(got["n"].iloc[0]) == want   # resolves; no KeyError
