"""The port's Arrow Flight (SQL) endpoint (``server/flight.py``) against
the JAX package's.

The cases of ``tests/test_flight.py`` run on the port's endpoint over a
port context on the CPU: a plain-SQL ticket, ``get_flight_info`` then
``do_get``, the Flight SQL command envelope, the health action and twelve
concurrent statements, each table held against the port's in-process
``Context.sql`` answer on the same statement, bit for bit. The command
codec writes the JAX package's envelope bytes and each package decodes the
other's. The same statements through the JAX package's endpoint over the
same frame give the same tables (integers and dimensions exact, float
sums rtol 1e-6). The ADBC driver case of the JAX file needs a driver that
is not installed here and is not ported.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import concurrent.futures as cf

import numpy as np
import pandas as pd
import pytest

flight = pytest.importorskip("pyarrow.flight")

import spark_druid_olap_tpu as jsdot  # noqa: E402
from spark_druid_olap_tpu.server import flight as JF  # noqa: E402

import spark_druid_olap_tpu_torch as tsdot  # noqa: E402
from spark_druid_olap_tpu_torch.server.flight import (  # noqa: E402
    SdotFlightServer, decode_sql_command, encode_statement_query)

from test_torch_sql import assert_answers_equal  # noqa: E402


def _frame():
    rng = np.random.default_rng(6)
    n = 10_000
    return pd.DataFrame({
        "ts": np.repeat(np.datetime64("2021-01-01"), n)
        .astype("datetime64[ns]"),
        "region": rng.choice(["east", "west"], n),
        "qty": rng.integers(1, 100, n).astype(np.int64),
        "price": rng.uniform(0, 10, n),
    })


@pytest.fixture(scope="module")
def served():
    df = _frame()
    ctx = tsdot.Context(device="cpu")
    ctx.ingest_dataframe("sales", df, time_column="ts")
    server = SdotFlightServer(ctx, "grpc://127.0.0.1:0")  # ephemeral port
    client = flight.connect(f"grpc://127.0.0.1:{server.port}")
    yield ctx, df, server, client
    client.close()
    server.shutdown()


SQL = "select region, sum(qty) as s from sales group by region order by region"
STATEMENTS = [
    SQL,
    "select region, sum(price) as p, count(*) as c, min(qty) as mn "
    "from sales group by region order by region",
    "select count(*) as c, max(qty) as mx from sales where qty > 50",
]


def _same_as_sql(ctx, sql, table):
    want = ctx.sql(sql).to_pandas()
    got = table.to_pandas()
    assert list(got.columns) == list(want.columns)
    assert got.equals(want), (got, want)


def test_plain_sql_ticket(served):
    ctx, df, server, client = served
    table = client.do_get(flight.Ticket(SQL.encode())).read_all()
    want = df.groupby("region")["qty"].sum()
    assert table.column("s").to_pylist() == want.tolist()
    assert ctx.history.entries()[-1].stats["mode"] == "engine"
    _same_as_sql(ctx, SQL, table)


def test_get_flight_info_roundtrip(served):
    ctx, df, server, client = served
    info = client.get_flight_info(
        flight.FlightDescriptor.for_command(SQL.encode()))
    table = client.do_get(info.endpoints[0].ticket).read_all()
    assert table.num_rows == 2
    _same_as_sql(ctx, SQL, table)


def test_flightsql_command_envelope(served):
    """A FlightSQL client's Any-wrapped CommandStatementQuery executes
    (the wire shape ADBC / Flight-SQL JDBC drivers emit)."""
    ctx, df, server, client = served
    cmd = encode_statement_query(SQL)
    assert decode_sql_command(cmd) == SQL
    info = client.get_flight_info(flight.FlightDescriptor.for_command(cmd))
    table = client.do_get(info.endpoints[0].ticket).read_all()
    want = df.groupby("region")["qty"].sum()
    assert table.column("s").to_pylist() == want.tolist()
    _same_as_sql(ctx, SQL, table)


@pytest.mark.parametrize("sql", STATEMENTS + ["", "select 'ü' as x"])
def test_command_codec_equals_jax(sql):
    cmd = encode_statement_query(sql)
    assert cmd == JF.encode_statement_query(sql)
    assert decode_sql_command(cmd) == JF.decode_sql_command(cmd) == sql
    # plain SQL bytes and foreign envelopes are not statements
    for raw in (sql.encode(), b"\x0a\x03abc"):
        assert decode_sql_command(raw) == JF.decode_sql_command(raw)


def test_healthcheck_action(served):
    _, _, server, client = served
    (res,) = list(client.do_action(flight.Action("healthcheck", b"")))
    assert res.body.to_pybytes() == b"ok"


def test_concurrent_flight_statements(served):
    """gRPC serves on a thread pool; concurrent statements on the shared
    Context all return correct results."""
    _, df, server, client0 = served
    want = df.groupby("region")["qty"].sum().tolist()

    def one(_):
        c = flight.connect(f"grpc://127.0.0.1:{server.port}")
        try:
            t = c.do_get(flight.Ticket(SQL.encode())).read_all()
            return t.column("s").to_pylist()
        finally:
            c.close()

    with cf.ThreadPoolExecutor(max_workers=6) as ex:
        results = list(ex.map(one, range(12)))
    assert all(r == want for r in results)


def test_tables_equal_jax_endpoint(served):
    """The JAX package's endpoint over the same frame gives the same
    tables."""
    _, df, server, client = served
    jctx = jsdot.Context()
    jctx.ingest_dataframe("sales", df, time_column="ts")
    jserver = JF.SdotFlightServer(jctx, "grpc://127.0.0.1:0")
    jclient = flight.connect(f"grpc://127.0.0.1:{jserver.port}")
    try:
        for sql in STATEMENTS:
            cmd = encode_statement_query(sql)
            got = client.do_get(flight.Ticket(cmd)).read_all()
            want = jclient.do_get(flight.Ticket(cmd)).read_all()
            assert got.schema == want.schema
            assert_answers_equal(got.to_pandas(), want.to_pandas(),
                                 ordered=True)
    finally:
        jclient.close()
        jserver.shutdown()
