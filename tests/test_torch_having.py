"""The port's device HAVING against the JAX package's.

The cases of ``tests/test_having_device.py`` that run on one device: one
seeded frame (47,537 customers, above ``having.device.min.keys`` as the
engines are configured here) goes into a JAX and a port store, and the
same QuerySpec (built from each package's ``ir``) runs through a JAX
``QueryEngine`` and a port ``QueryEngine(device="cpu")``. Covered: the six
comparison operators, the device path against the host epilogue, integer
sums near ±2^40, a float64 metric, a NULL min metric, and both ways the
passing groups travel (a selection of the few that pass, or the whole
table in key order when most pass). ``having_device`` (the rows that
travelled) must equal the JAX engine's in every case.

Tolerance: dimensions, integers and counts exact; float sums rtol 1e-6.
"""

import numpy as np
import pandas as pd
import pytest

from spark_druid_olap_tpu.ir import expr as JE
from spark_druid_olap_tpu.ir import spec as JS
from spark_druid_olap_tpu.parallel.executor import QueryEngine as JQE
from spark_druid_olap_tpu.segment.ingest import ingest_dataframe as jingest
from spark_druid_olap_tpu.segment.store import SegmentStore as JStore
from spark_druid_olap_tpu.utils.config import Config as JConfig

from spark_druid_olap_tpu_torch.ir import expr as TE
from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.parallel.executor import QueryEngine as TQE
from spark_druid_olap_tpu_torch.segment.ingest import \
    ingest_dataframe as tingest
from spark_druid_olap_tpu_torch.segment.store import SegmentStore as TStore
from spark_druid_olap_tpu_torch.utils.config import Config as TConfig

from test_torch_sql import assert_answers_equal

N = 80_000
N_CUST = 70_000          # 47,537 of them drawn: the key space
DEVICE = {"sdot.engine.having.device.min.keys": 1024}
HOST = {"sdot.engine.having.device.min.keys": 1 << 30}


def _df():
    rng = np.random.default_rng(41)
    opt = rng.integers(1, 100, N).astype(np.int64)
    return pd.DataFrame({
        "ts": (np.datetime64("2022-01-01")
               + rng.integers(0, 365, N).astype("timedelta64[D]"))
        .astype("datetime64[ns]"),
        "cust": rng.choice([f"c{i:05d}" for i in range(N_CUST)], N),
        "qty": rng.integers(1, 100, N).astype(np.int64),
        # per-group sums near +-2^40: an exact comparison in int64
        "wide": rng.integers(-2**40, 2**40, N).astype(np.int64),
        "price": np.round(rng.uniform(1, 500, N), 2),
        # half the rows NULL: many groups' min is NULL
        "opt": pd.array(np.where(rng.random(N) < 0.5, None, opt),
                        dtype="Int64"),
    })


@pytest.fixture(scope="module")
def stores():
    df = _df()
    js, ts = JStore(), TStore()
    js.register(jingest("fact", df, time_column="ts", target_rows=1 << 14))
    ts.register(tingest("fact", df, time_column="ts", target_rows=1 << 14))
    return df, js, ts


AGGS = (("longsum", "s_qty", "qty"), ("doublesum", "s_price", "price"),
        ("count", "n", None))


def _q(S, E, metric, op, lit, aggs=AGGS):
    return S.GroupByQuerySpec(
        datasource="fact",
        dimensions=(S.DimensionSpec("cust", "cust"),),
        aggregations=tuple(S.AggregationSpec(k, n, field=f)
                           for k, n, f in aggs),
        having=S.HavingSpec(E.Comparison(op, E.Column(metric),
                                         E.Literal(lit))))


def _both(stores, config, *args, **kw):
    """(port frame, JAX frame, port stats, JAX stats)."""
    _, js, ts = stores
    jeng = JQE(js, config=JConfig(dict(config)))
    teng = TQE(ts, config=TConfig(dict(config)), device="cpu")
    want = jeng.execute(_q(JS, JE, *args, **kw)).to_pandas()
    got = teng.execute(_q(TS, TE, *args, **kw)).to_pandas()
    return got, want, dict(teng.last_stats), dict(jeng.last_stats)


OPS = [(">", 200), (">=", 200), ("<", 40), ("<=", 40), ("=", 100),
       ("!=", 100)]


@pytest.mark.parametrize("op,lit", OPS)
def test_having_device_ops(stores, op, lit):
    got, want, tst, jst = _both(stores, DEVICE, "s_qty", op, lit)
    assert tst["having_device"] == jst["having_device"] > 0
    assert_answers_equal(got, want, ordered=False)
    df = stores[0]
    g = df.groupby("cust").qty.sum()
    cmp = {">": g > lit, ">=": g >= lit, "<": g < lit, "<=": g <= lit,
           "=": g == lit, "!=": g != lit}[op]
    assert len(got) == int(cmp.sum())


def test_having_device_matches_host_path(stores):
    got, want, tst, jst = _both(stores, DEVICE, "n", ">", 2)
    assert tst["having_device"] == jst["having_device"] > 0
    host, hwant, hst, hjst = _both(stores, HOST, "n", ">", 2)
    assert hst["having_device"] == hjst["having_device"] == 0
    assert_answers_equal(got, want, ordered=False)
    assert_answers_equal(got, host, ordered=False)
    assert_answers_equal(host, hwant, ordered=False)


def test_having_device_wide_sums(stores):
    """Per-group sums near +-2^40 compare exactly on the i64 route."""
    df = stores[0]
    lit = int(df.groupby("cust")["wide"].sum().median())
    aggs = (("longsum", "s_wide", "wide"), ("count", "n", None))
    for op in (">", "<="):
        got, want, tst, jst = _both(stores, DEVICE, "s_wide", op, lit,
                                    aggs=aggs)
        assert tst["having_device"] == jst["having_device"] > 0
        assert_answers_equal(got, want, ordered=False)
    g = df.groupby("cust")["wide"].sum()
    assert len(got) == int((g <= lit).sum())


def test_having_device_float_metric(stores):
    """A float64 sum is exact on the f64 route: HAVING runs on the
    device against an integer literal."""
    got, want, tst, jst = _both(stores, DEVICE, "s_price", ">", 700)
    assert tst["having_device"] == jst["having_device"] > 0
    assert_answers_equal(got, want, ordered=False)


def test_having_device_null_metric(stores):
    """A group whose min is NULL fails the comparison (SQL UNKNOWN), on
    the device as in the host epilogue."""
    aggs = (("longmin", "mn", "opt"), ("count", "n", None))
    got, want, tst, jst = _both(stores, DEVICE, "mn", ">", 50, aggs=aggs)
    assert tst["having_device"] == jst["having_device"] > 0
    assert_answers_equal(got, want, ordered=False)
    host = _both(stores, HOST, "mn", ">", 50, aggs=aggs)[0]
    assert_answers_equal(got, host, ordered=False)
    assert got["mn"].notna().all()


@pytest.mark.parametrize("lit,full", [(250, False), (0, True)])
def test_having_device_gather_modes(stores, lit, full):
    """Few groups pass: a selection of them travels (``having_device``
    below the key space); most pass: the whole table travels in key order
    with the failing groups' occupancy zeroed (``having_device`` = the
    key space). Rows come out in the JAX engine's order either way."""
    got, want, tst, jst = _both(stores, DEVICE, "s_qty", ">", lit)
    assert tst["having_device"] == jst["having_device"]
    n_keys = stores[0]["cust"].nunique()        # the dictionary's size
    assert (tst["having_device"] == n_keys) == full
    assert_answers_equal(got, want, ordered=True)
