"""The port's select and search paths against the JAX package's.

One seeded sales frame (20,011 rows: not a multiple of 32, so the last
mask word of a segment is part padding; NULLs in a string and a long
column) goes into a JAX and a port store, and the same Select / Search
QuerySpec (built from each package's ``ir``) runs through a JAX
``QueryEngine`` and a port ``QueryEngine(device="cpu")``. A select runs
with its filter on the device (``sdot.select.device.min.rows`` 0: one mask
pass, 32 rows to a transferred word) and on the host (2^40), and every
page must equal the JAX engine's under the same setting, with the same
``select_filter`` decision. Covered: filters, intervals, paging,
``descending``, NULLs; search case-sensitive and not, NULL rows, ``limit``,
and the group-by to search rewrite of a ``like '%x%'`` count through
``Context.sql``.

Tolerance: exact (select returns stored values; search counts rows).
"""

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.ir import spec as JS
from spark_druid_olap_tpu.parallel.executor import QueryEngine as JQE
from spark_druid_olap_tpu.segment.ingest import ingest_dataframe as jingest
from spark_druid_olap_tpu.segment.store import SegmentStore as JStore
from spark_druid_olap_tpu.utils.config import Config as JConfig

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ir import spec as TS
from spark_druid_olap_tpu_torch.parallel import executor as TX
from spark_druid_olap_tpu_torch.parallel.executor import QueryEngine as TQE
from spark_druid_olap_tpu_torch.segment.ingest import \
    ingest_dataframe as tingest
from spark_druid_olap_tpu_torch.segment.store import SegmentStore as TStore
from spark_druid_olap_tpu_torch.utils.config import Config as TConfig

from conftest import make_sales_df
from test_torch_sql import assert_answers_equal

N = 20_011
DEVICE = {"sdot.select.device.min.rows": 0}
HOST = {"sdot.select.device.min.rows": 1 << 40}


def _df():
    df = make_sales_df(n=N, seed=19)
    rng = np.random.default_rng(19)
    df["note"] = np.where(rng.random(N) < 0.2, None,
                          rng.choice(["Red fox", "blue Fox", "green"], N))
    df["opt"] = pd.array(np.where(rng.random(N) < 0.3, None,
                                  rng.integers(0, 50, N)), dtype="Int64")
    return df


@pytest.fixture(scope="module")
def stores():
    df = _df()
    js, ts = JStore(), TStore()
    js.register(jingest("sales", df, time_column="ts", target_rows=4096))
    ts.register(tingest("sales", df, time_column="ts", target_rows=4096))
    return df, js, ts


def _ms(day):
    return int(np.datetime64(day, "ms").astype(np.int64))


def _filter(S, case):
    east = S.SelectorFilter("region", "east")
    if case == "none":
        return None
    if case == "and":
        return S.LogicalFilter("and", (east, S.BoundFilter("qty", lower=5)))
    if case == "or_null":
        return S.LogicalFilter("or", (S.NullFilter("note"),
                                      S.BoundFilter("opt", upper=3)))
    if case == "like":
        return S.PatternFilter("note", "like", "%ox%")
    return S.LogicalFilter("not", (east,))


INTERVALS = ((_ms("2015-06-01"), _ms("2016-06-01")),)
COLUMNS = ("ts", "region", "qty", "price", "note", "opt")
CASES = [("and", {}), ("and", {"descending": True}),
         ("and", {"page_offset": 37}), ("and", {"intervals": INTERVALS}),
         ("or_null", {}), ("like", {"page_size": 10 ** 9}),
         ("not", {"descending": True, "page_offset": 5000}),
         ("none", {"intervals": INTERVALS, "page_size": 50})]


def _select(S, case, kw):
    kw = dict({"page_size": 200}, **kw)
    return S.SelectQuerySpec(datasource="sales", columns=COLUMNS,
                             filter=_filter(S, case), **kw)


def _both(stores, config, q):
    _, js, ts = stores
    jeng = JQE(js, config=JConfig(dict(config)))
    teng = TQE(ts, config=TConfig(dict(config)), device="cpu")
    want = jeng.execute(q(JS)).to_pandas()
    got = teng.execute(q(TS)).to_pandas()
    return got, want, dict(teng.last_stats), dict(jeng.last_stats)


@pytest.mark.parametrize("where", ["device", "host"])
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_select_page_equals_the_jax_engine(stores, ci, where):
    case, kw = CASES[ci]
    config = DEVICE if where == "device" else HOST
    got, want, tst, jst = _both(stores, config,
                                lambda S: _select(S, case, kw))
    assert tst.get("select_filter") == jst.get("select_filter")
    if case != "none":
        assert tst["select_filter"] == where
    assert tst["rows"] == jst["rows"] == len(want)
    assert tst.get("bytes_scanned") == jst.get("bytes_scanned")
    assert list(got.columns) == list(COLUMNS)
    assert_answers_equal(got, want, ordered=True)


def test_device_mask_equals_host_mask(stores):
    """The device mask (packed 32 rows a word, unpacked on the host,
    each segment's padding cut off) equals the host mask row for row."""
    df, _, ts = stores
    eng = TQE(ts, config=TConfig(dict(DEVICE)), device="cpu")
    ds = ts.get("sales")
    for case in ("and", "or_null", "like", "not"):
        f = _filter(TS, case)
        seg_idx = ds.prune_segments(INTERVALS, f)
        dev = eng._device_mask(ds, f, INTERVALS, seg_idx)
        host = eng._host_mask(ds, f, INTERVALS)
        assert dev.shape == (N,) and dev.sum() > 0
        np.testing.assert_array_equal(dev, host, err_msg=case)


def test_pack_rows_bit_order():
    import torch
    rng = np.random.default_rng(3)
    bits = rng.random((3, 128)) < 0.5
    words = TX._pack_rows(torch.from_numpy(bits)).numpy()
    assert words.dtype == np.int32 and words.shape == (3, 4)
    want = (bits.reshape(3, 4, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(-1)
    np.testing.assert_array_equal(words.view(np.uint32), want)


def test_repeated_select_reuses_resident_columns(stores):
    """A second page binds no column again: the mask's columns stay in
    the engine's device array cache."""
    _, _, ts = stores
    eng = TQE(ts, config=TConfig(dict(DEVICE)), device="cpu")
    eng.execute(_select(TS, "and", {}))
    held = dict(eng._device_arrays)
    eng.execute(_select(TS, "and", {"page_offset": 200}))
    assert eng._device_arrays.keys() == held.keys()
    assert all(eng._device_arrays[k] is held[k] for k in held)


SEARCHES = [("product", "p01", True, None), ("note", "fox", False, None),
            ("note", "Fox", True, None), ("note", "o", False, 1),
            ("region", "zz", True, None)]


@pytest.mark.parametrize("si", range(len(SEARCHES)))
def test_search_equals_the_jax_engine(stores, si):
    dim, needle, cs, limit = SEARCHES[si]

    def q(S):
        return S.SearchQuerySpec(
            datasource="sales", dimensions=(dim, "region"), query=needle,
            case_sensitive=cs, filter=S.BoundFilter("qty", lower=10),
            intervals=INTERVALS, limit=limit)
    got, want, tst, jst = _both(stores, {}, q)
    assert tst["search_values"] == jst["search_values"] == len(want)
    assert_answers_equal(got, want, ordered=True)
    if dim == "note" and not cs and limit is None:
        df = stores[0]
        m = (df.qty >= 10) & (df.ts >= "2015-06-01") & (df.ts < "2016-06-01")
        want_n = df[m & df.note.notna()].note.value_counts()
        assert dict(zip(got["value"], got["count"])) == {
            k: int(v) for k, v in want_n.items() if "fox" in k.lower()}


@pytest.fixture(scope="module")
def ctx_pair():
    df = _df()
    out = (jsdot.Context(), tsdot.Context(device="cpu"))
    for c in out:
        c.ingest_dataframe("sales", df, time_column="ts", target_rows=4096)
    return out


SQL = [
    # a one-dimension count under like '%x%' (no ORDER BY: the rewrite
    # takes no limit) becomes a dictionary search in both
    ("search", "select product, count(*) as n from sales "
               "where product like '%01%' group by product"),
    ("search", "select note, count(*) as n from sales "
               "where note like '%ox%' group by note"),
    ("select", "select ts, region, qty, note from sales "
               "where region = 'west' and qty > 45 limit 25")]


@pytest.mark.parametrize("path,sql", SQL)
def test_sql_search_and_select_equal_the_jax_engine(ctx_pair, path, sql):
    """The rewrite of a one-dimension count under ``like '%x%'`` into a
    search, and a raw select, through ``Context.sql`` in both."""
    jctx, tctx = ctx_pair
    want = jctx.sql(sql).to_pandas()
    got = tctx.sql(sql).to_pandas()
    stats = [c.history.entries()[-1].stats for c in ctx_pair]
    assert stats[0]["mode"] == stats[1]["mode"] == "engine"
    key = "search_values" if path == "search" else "select_filter"
    assert stats[1].get(key) == stats[0].get(key) is not None
    assert len(got) > 0
    assert_answers_equal(got, want, ordered=True)
