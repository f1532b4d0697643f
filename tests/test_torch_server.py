"""The port's HTTP SQL server (``server/http.py``) against the JAX
package's.

Both packages' ``SqlServer`` serve contexts over the same data (the sales
frame, TPC-H SF 0.002 flattened with its star, SSB SF 0.003 flattened with
its star; the port on the CPU), on loopback port 0. The same statements go
to both over ``POST /sql``: the decoded JSON rows and the Arrow tables are
equal, dimensions, integers, counts and sketch estimates exactly, float
sums rtol 1e-6 (``tests/test_server.py``'s tolerance); ``POST /query``
(the raw spec wire) likewise. ``/status``, ``/metadata/*`` and
``/history`` answer with the same keys and shapes, and the JSON row
encoder (``segment/native.encode_json_rows``, and the Python path where it
declines) writes the JAX encoder's bytes for the same frame.

The cases of ``tests/test_server.py`` that need the server run on the
port alone: status, SQL as JSON and as Arrow, the raw query, explain,
metadata and history, the syntax error, the query-history page, query
ids, cancel (an unknown id, and one mid-flight over a 1-byte wave budget),
a fast statement finishing beside a slow one, and an 8-thread hammer.
``serve`` and ``python -m spark_druid_olap_tpu_torch.server`` refuse to
start without a CUDA device unless the CPU is asked for.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import spark_druid_olap_tpu as jsdot
from spark_druid_olap_tpu.segment import native as JNATIVE
from spark_druid_olap_tpu.server import http as JHTTP
from spark_druid_olap_tpu.tools import ssb as jssb
from spark_druid_olap_tpu.tools import tpch as jtpch

import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.segment import native as TNATIVE
from spark_druid_olap_tpu_torch.server import http as THTTP
from spark_druid_olap_tpu_torch.tools import ssb as tssb
from spark_druid_olap_tpu_torch.tools import tpch as ttpch

from conftest import make_sales_df
from test_torch_sql import assert_answers_equal

FLOAT_RTOL = 1e-6
PKGS = ("jax", "port")


def _url(server, path):
    return f"http://127.0.0.1:{server.port}{path}"


def _get(server, path):
    with urllib.request.urlopen(_url(server, path), timeout=60) as r:
        return r.status, json.loads(r.read().decode())


def _post(server, path, payload, raw=False, headers=None):
    req = urllib.request.Request(
        _url(server, path), data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        body = r.read()
        return r.status, body if raw else json.loads(body.decode())


def _post_arrow(server, sql):
    req = urllib.request.Request(
        _url(server, "/sql"),
        data=json.dumps({"sql": sql, "format": "arrow"}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        ctype = r.headers["Content-Type"]
        body = r.read()
    return ctype, pa.ipc.open_stream(io.BytesIO(body)).read_all()


# -- both packages' servers over the same data --------------------------------

def _load(ctx, pkg):
    tpch = jtpch if pkg == "jax" else ttpch
    ssb = jssb if pkg == "jax" else tssb
    ctx.ingest_dataframe("sales", make_sales_df(2000), time_column="ts")
    ctx.ingest_dataframe("tpch_flat", tpch.flatten(tpch.generate(sf=0.002)),
                         time_column="l_shipdate", target_rows=2048)
    ctx.register_star_schema(tpch.star_schema("tpch_flat"))
    ctx.ingest_dataframe("ssb_flat", ssb.flatten(ssb.generate(sf=0.003)),
                         time_column="lo_orderdate", target_rows=2048)
    ctx.register_star_schema(ssb.star_schema("ssb_flat"))


@pytest.fixture(scope="module")
def servers():
    out = {}
    for pkg in PKGS:
        ctx = jsdot.Context() if pkg == "jax" \
            else tsdot.Context(device="cpu")
        _load(ctx, pkg)
        http = JHTTP if pkg == "jax" else THTTP
        out[pkg] = http.SqlServer(ctx, "127.0.0.1", 0).start()
    yield out
    for s in out.values():
        s.stop()


@pytest.fixture(scope="module")
def server(servers):
    return servers["port"]


STATEMENTS = {
    "sales_groupby": ("select region, sum(price) as rev, sum(qty) as q, "
                      "count(*) as c, min(qty) as mn from sales "
                      "group by region order by region", True),
    "sales_topn": ("select product, sum(qty) as q from sales "
                   "group by product order by q desc limit 5", True),
    "sales_sketch": ("select region, approx_count_distinct(product) as dp "
                     "from sales group by region order by region", True),
    "sales_time": ("select ts, region, qty from sales where qty > 45 "
                   "order by ts, region limit 20", True),
    "tpch_q1": (jtpch.QUERIES["q1"], True),
    "tpch_q6": (jtpch.QUERIES["q6"], False),
    "tpch_basic_agg": (jtpch.QUERIES["basic_agg"], False),
    "ssb_q1.1": (jssb.QUERIES["q1.1"], False),
    "ssb_q2.1": (jssb.QUERIES["q2.1"], True),
}


def _assert_json_rows_equal(got, want):
    assert got["columns"] == want["columns"]
    assert got["numRows"] == want["numRows"]
    for g, w in zip(got["rows"], want["rows"]):
        assert list(g) == list(w)
        for c in w:
            if isinstance(w[c], float) and w[c] is not None:
                assert isinstance(g[c], (int, float)), (c, g[c], w[c])
                np.testing.assert_allclose(g[c], w[c], rtol=FLOAT_RTOL,
                                           err_msg=c)
            else:
                assert g[c] == w[c], (c, g[c], w[c])


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_sql_json_rows_equal_jax(servers, name):
    sql, ordered = STATEMENTS[name]
    bodies = {}
    for pkg in PKGS:
        code, body = _post(servers[pkg], "/sql", {"sql": sql})
        assert code == 200
        body.pop("queryId")
        bodies[pkg] = body
    if not ordered:
        for b in bodies.values():
            b["rows"].sort(key=lambda r: json.dumps(
                [v for v in r.values() if not isinstance(v, float)]))
    _assert_json_rows_equal(bodies["port"], bodies["jax"])


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_sql_arrow_tables_equal_jax(servers, name):
    sql, ordered = STATEMENTS[name]
    tables = {}
    for pkg in PKGS:
        ctype, tables[pkg] = _post_arrow(servers[pkg], sql)
        assert ctype == "application/vnd.apache.arrow.stream"
    assert tables["port"].schema == tables["jax"].schema
    assert_answers_equal(tables["port"].to_pandas(),
                         tables["jax"].to_pandas(), ordered)


def test_raw_query_equal_jax(servers):
    spec = {"queryType": "groupBy", "dataSource": "sales",
            "dimensions": [{"dimension": "region", "outputName": "region"}],
            "aggregations": [
                {"type": "longsum", "name": "q", "fieldName": "qty"},
                {"type": "count", "name": "c"}],
            "limitSpec": {"columns": [{"dimension": "region"}]}}
    got = {pkg: _post(servers[pkg], "/query", spec)[1] for pkg in PKGS}
    _assert_json_rows_equal(got["port"], got["jax"])


# per-engine counters the two engines keep apart (the JAX engine's XLA
# dispatch and Pallas counters, the port's kernel route and wave
# counters): every other key is common, the mesh tier's included
ENGINE_ONLY = {
    "sharedscan": ({"pallas"},
                   {"wave_launches", "wave_fallbacks",
                    "wave_fallback_reasons", "wave_smem_bytes_peak"}),
    "history": ({"bytes_scanned", "kernel_launches", "n_dispatch",
                 "n_transfer", "sharded"}, {"cache", "route", "devices"}),
}


def _shape(v):
    """A JSON value's keys and types, recursively (values dropped)."""
    if isinstance(v, dict):
        return {k: _shape(x) for k, x in v.items()}
    if isinstance(v, list):
        return ["list", _shape(v[0]) if v else None]
    if isinstance(v, bool) or v is None:
        return type(v).__name__
    if isinstance(v, (int, float)):
        return "number"
    return type(v).__name__


@pytest.mark.parametrize("path", [
    "/status", "/metadata/datasources", "/metadata/segments",
    "/metadata/columns", "/metadata/rollups", "/metadata/wlm",
    "/metadata/cache", "/metadata/persist", "/metadata/cluster",
    "/metadata/sharedscan"])
def test_metadata_and_status_shapes_equal_jax(servers, path):
    got = {pkg: _get(servers[pkg], path) for pkg in PKGS}
    assert got["port"][0] == got["jax"][0] == 200
    port, jax = got["port"][1], got["jax"][1]
    if "rows" in jax:
        # a catalog view: same columns, same rows (values included)
        assert port["columns"] == jax["columns"]
        assert port["numRows"] == jax["numRows"]
        assert sorted(map(json.dumps, port["rows"])) == \
            sorted(map(json.dumps, jax["rows"]))
    else:
        if path in ("/metadata/sharedscan", "/metadata/wlm"):
            # the coalescer's counters: the common ones by name (their
            # nested plan counters are each engine's own)
            pss = port if path == "/metadata/sharedscan" \
                else port.pop("sharedscan")
            jss = jax if path == "/metadata/sharedscan" \
                else jax.pop("sharedscan")
            jax_only, port_only = ENGINE_ONLY["sharedscan"]
            assert set(jss) - set(pss) == jax_only
            assert set(pss) - set(jss) == port_only
            if path == "/metadata/sharedscan":
                return
        assert set(port) == set(jax)
        if path != "/status":
            assert _shape(port) == _shape(jax)
    if path == "/status":
        assert port["status"] == "ok" and port["backend"] == "cpu"
        assert port["datasources"] == jax["datasources"]


def test_history_shape_equal_jax(servers):
    for pkg in PKGS:
        _post(servers[pkg], "/sql", {"sql": "select count(*) as c "
                                            "from sales"})
    got = {pkg: _get(servers[pkg], "/history")[1] for pkg in PKGS}
    assert set(got["port"]) == set(got["jax"]) == {"history"}
    port, jax = got["port"]["history"][-1], got["jax"]["history"][-1]
    jax_only, port_only = ENGINE_ONLY["history"]
    assert set(jax) - set(port) <= jax_only
    assert set(port) - set(jax) <= port_only
    record = {"startedAt", "queryType", "datasource", "sql", "mode",
              "total_ms", "rows_scanned", "segments", "groups"}
    assert record <= set(port) & set(jax)
    assert _shape({k: port[k] for k in record}) \
        == _shape({k: jax[k] for k in record})


def _encoder_frame():
    r = np.random.default_rng(4)
    n = 50
    return pd.DataFrame({
        "s": r.choice(["a", "b\"q", "ü", "x\ny"], n).astype(object),
        "s_null": pd.Series(r.choice(["p", None], n), dtype=object),
        "i": r.integers(-5, 5, n).astype(np.int64),
        "i32": r.integers(0, 100, n).astype(np.int32),
        "u": r.integers(0, 100, n).astype(np.uint64),
        "f": np.where(r.uniform(size=n) < 0.1, np.nan,
                      r.normal(size=n) * 1e6),
        "b": r.uniform(size=n) < 0.5,
        "t": pd.Series(pd.to_datetime("2024-01-01")
                       + pd.to_timedelta(r.integers(0, 1 << 30, n), "ms")),
        "t_nat": pd.Series(pd.to_datetime(
            np.where(r.uniform(size=n) < 0.2, np.datetime64("NaT"),
                     np.datetime64("2023-05-06T07:08:09.123")))),
    })


def test_encode_json_rows_bytes_equal_jax():
    df = _encoder_frame()
    port = TNATIVE.encode_json_rows(df)
    assert port is not None, "the native row encoder declined"
    assert port == JNATIVE.encode_json_rows(df)
    # the envelope the server writes around them
    assert THTTP._df_to_json_rows(df) == JHTTP._df_to_json_rows(df)
    json.loads(THTTP._df_to_json_rows(df).decode())


def test_python_row_encoder_equal_jax(monkeypatch):
    """Where the native encoder declines (a categorical column here),
    both packages' Python encoders write the same bytes."""
    df = _encoder_frame()
    df["cat"] = pd.Categorical(df["s"])
    assert TNATIVE.encode_json_rows(df) is None
    assert THTTP._df_to_json_rows(df) == JHTTP._df_to_json_rows(df)


# -- the cases of tests/test_server.py, on the port ---------------------------

def test_status(server):
    code, body = _get(server, "/status")
    assert code == 200 and body["status"] == "ok"
    assert "sales" in body["datasources"]
    assert body["devices"] == ["cpu"]


def test_sql_endpoint(server):
    code, body = _post(server, "/sql", {
        "sql": "select region, sum(price) as rev from sales "
               "group by region order by region"})
    assert code == 200
    assert body["columns"] == ["region", "rev"]
    assert body["numRows"] == 4
    assert server.ctx.history.entries()[-1].stats["mode"] == "engine"


def test_sql_arrow_format(server):
    ctype, table = _post_arrow(server, "select count(*) as c from sales")
    assert ctype == "application/vnd.apache.arrow.stream"
    assert table.num_rows == 1
    assert table.column("c")[0].as_py() == 2000


def test_raw_query_endpoint(server):
    code, body = _post(server, "/query", {
        "queryType": "topN", "dataSource": "sales",
        "dimension": {"dimension": "region", "outputName": "region"},
        "metric": "rev", "threshold": 2,
        "aggregations": [{"type": "doublesum", "name": "rev",
                          "fieldName": "price"}]})
    assert code == 200 and body["numRows"] == 2


def test_explain_endpoint(server):
    code, body = _get(server, "/explain?sql=select%20count(*)%20from%20sales")
    assert code == 200
    assert any("pushdown: YES" in line for line in body["plan"])


def test_metadata_and_history(server):
    code, body = _get(server, "/metadata/datasources")
    assert code == 200 and "sales" in [r["name"] for r in body["rows"]]
    code, body = _get(server, "/metadata/columns")
    assert any(r["column"] == "region" for r in body["rows"])
    code, body = _get(server, "/history")
    assert code == 200 and len(body["history"]) >= 1
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server, "/metadata/nope")
    assert ei.value.code == 404


def test_sql_error_handling(server):
    req = urllib.request.Request(
        _url(server, "/sql"), data=json.dumps({"sql": "SELEC nope"}).encode(),
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req)
    assert ei.value.code == 400
    body = json.loads(ei.value.read().decode())
    assert body["error"] == "SqlSyntaxError"
    for payload, code in (({}, 400), ({"sql": "select 1",
                                       "queryId": "bad id!"}, 400),
                          ({"sql": "select count(*) from nope"}, 404)):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server, "/sql", payload)
        assert ei.value.code == code, payload


def test_ui_page(server):
    _post(server, "/sql", {"sql": "select count(*) as c from sales"})
    with urllib.request.urlopen(_url(server, "/ui")) as r:
        assert r.status == 200
        assert "text/html" in r.headers["Content-Type"]
        body = r.read().decode()
    assert "Engine queries" in body
    assert "select count(*) as c from sales" in body
    assert "sales" in body


def test_sql_returns_query_id(server):
    code, body = _post(server, "/sql", {
        "sql": "select count(*) as n from sales", "queryId": "my-query-1"})
    assert code == 200 and body["queryId"] == "my-query-1"
    code, body = _post(server, "/sql", {
        "sql": "select count(*) as n from sales"})
    assert code == 200 and len(body["queryId"]) >= 16   # minted


def test_cancel_unknown_id(server):
    code, body = _post(server, "/sql/cancel", {"queryId": "nope"})
    assert code == 200 and body["cancelled"] is False


SLOW_SQL = ("select region, product, sum(price) as rev, min(qty) as mn, "
            "max(qty) as mx, count(*) as n from sales "
            "group by region, product")


@pytest.fixture(scope="module")
def slow_server():
    """Server over a many-segment store with a 1-byte wave budget: engine
    queries run hundreds of waves with a stage-boundary check per wave,
    giving cancellation a real mid-flight window."""
    ctx = tsdot.Context(config={"sdot.engine.wave.max.bytes": 1},
                        device="cpu")
    ctx.ingest_dataframe("sales", make_sales_df(150_000), time_column="ts",
                         target_rows=256)
    s = THTTP.SqlServer(ctx, "127.0.0.1", 0).start()
    _post(s, "/sql", {"sql": SLOW_SQL})
    _post(s, "/sql", {
        "sql": "select count(*) as n from sales where region = 'east'"})
    yield s
    s.stop()


def test_sql_cancel_mid_flight(slow_server):
    qid = "cancel-me-1"
    result = {}

    def run():
        req = urllib.request.Request(
            _url(slow_server, "/sql"),
            data=json.dumps({"sql": SLOW_SQL, "queryId": qid}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as r:
                result["status"] = r.status
                result["body"] = json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            result["status"] = e.code
            result["body"] = json.loads(e.read().decode())

    t = threading.Thread(target=run)
    t.start()
    # wait until the query is registered, then cancel it mid-flight
    deadline = time.time() + 30
    cancelled = False
    while time.time() < deadline:
        code, body = _post(slow_server, "/sql/cancel", {"queryId": qid})
        if body.get("cancelled"):
            cancelled = True
            break
        time.sleep(0.002)
    t.join(timeout=60)
    assert cancelled, "query id never became cancellable"
    assert result.get("status") == 499, result
    assert result["body"]["error"] == "QueryCancelled"
    assert result["body"]["queryId"] == qid


def test_concurrent_queries_overlap(slow_server):
    """A fast query completes while a slow one is still executing: the
    server does not serialize queries behind one lock."""
    order = []
    entered = threading.Event()

    def slow():
        entered.set()
        _post(slow_server, "/sql", {"sql": SLOW_SQL})
        order.append("slow")

    def fast():
        entered.wait(10)
        time.sleep(0.02)   # let the slow query enter execution first
        _post(slow_server, "/sql", {
            "sql": "select count(*) as n from sales where region = 'east'"})
        order.append("fast")

    ts = [threading.Thread(target=slow), threading.Thread(target=fast)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert order and order[0] == "fast", order


def test_concurrent_correctness_hammer(slow_server):
    """8 threads x mixed queries against one engine: every response equals
    the single-threaded result."""
    queries = [
        "select region, sum(qty) as s from sales group by region",
        "select product, count(*) as n from sales group by product",
        "select count(*) as n from sales where qty > 25",
        "select region, min(price) as mn, max(price) as mx from sales "
        "group by region",
    ]
    want = {}
    for q in queries:
        _, want[q] = _post(slow_server, "/sql", {"sql": q})
    errors = []

    def worker(i):
        q = queries[i % len(queries)]
        try:
            _, body = _post(slow_server, "/sql", {"sql": q})
            b = dict(body)
            w = dict(want[q])
            b.pop("queryId", None)
            w.pop("queryId", None)

            def srt(d):
                return sorted(map(str, d["rows"]))
            if srt(b) != srt(w):
                errors.append((q, "mismatch"))
        except Exception as e:  # noqa: BLE001
            errors.append((q, repr(e)))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errors, errors


# -- the device rule ----------------------------------------------------------

def test_serve_and_main_refuse_without_cuda(monkeypatch):
    from spark_druid_olap_tpu_torch.server import __main__ as SM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        THTTP.serve(host="127.0.0.1", port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        THTTP.serve(host="127.0.0.1", port=0, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SM.main(["--host", "127.0.0.1", "--port", "0"])

    started = threading.Event()

    def setup(ctx):
        assert ctx.device.type == "cpu"
        started.set()
        raise KeyboardInterrupt   # leave before serve_forever blocks

    with pytest.raises(KeyboardInterrupt):
        THTTP.serve(host="127.0.0.1", port=0, setup=setup, device="cpu")
    assert started.is_set()
