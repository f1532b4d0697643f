"""Arrow Flight (SQL) facade — BI-tool wire compatibility.

Port of ``spark_druid_olap_tpu/server/flight.py``: a copy kept inside the
PyTorch package, which imports nothing of the JAX package. Run as a
module it serves a ``Context`` on the card (``--device cpu`` for the
CPU; without a CUDA device it raises, as ``Context`` does).

The reference's L7 is a HiveServer2 thrift endpoint so JDBC/ODBC tools
connect out of the box (HiveThriftServer2.scala:55-79). The TPU build's
native seam is HTTP+Arrow (server/http.py); this module adds the
columnar wire protocol BI tools standardize on today: an Arrow Flight
server that understands BOTH

- plain-SQL flight descriptors/tickets (``descriptor.for_command(sql)``
  → ``do_get`` streams the result), the generic Flight convention, and
- the Flight SQL command envelope (``CommandStatementQuery`` /
  ``TicketStatementQuery`` wrapped in ``google.protobuf.Any``) that
  ADBC / JDBC-Flight-SQL drivers emit for statement execution.

The envelope is decoded with a ~40-line wire-format reader rather than
a protobuf dependency: both messages are a single length-delimited
string field (field 1 = query / statement_handle), and ``Any`` is
field 1 type_url + field 2 value.
"""

from __future__ import annotations

from typing import Optional

import pyarrow as pa

try:
    import pyarrow.flight as flight
    _FLIGHT_OK = True
except Exception:  # noqa: BLE001 — keep importable without flight
    flight = None
    _FLIGHT_OK = False


# -- minimal protobuf wire helpers -------------------------------------------

def _read_varint(buf: bytes, i: int):
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) for a protobuf message;
    only varint(0) and length-delimited(2) appear in the Flight SQL
    envelope messages."""
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i: i + ln]
            i += ln
        elif wt == 5:
            v = buf[i: i + 4]
            i += 4
        elif wt == 1:
            v = buf[i: i + 8]
            i += 8
        else:
            raise ValueError(f"wire type {wt}")
        yield fno, wt, v


def _emit_field(fno: int, value: bytes) -> bytes:
    out = bytearray()
    tag = (fno << 3) | 2
    while True:
        b = tag & 0x7F
        tag >>= 7
        out.append(b | (0x80 if tag else 0))
        if not tag:
            break
    ln = len(value)
    while True:
        b = ln & 0x7F
        ln >>= 7
        out.append(b | (0x80 if ln else 0))
        if not ln:
            break
    return bytes(out) + value


_SQL_TYPE_PREFIX = b"type.googleapis.com/arrow.flight.protocol.sql."


def decode_sql_command(cmd: bytes) -> Optional[str]:
    """SQL text from a Flight SQL ``Any``-wrapped command (or None when
    the bytes are not such an envelope — plain-SQL descriptors decode
    as raw UTF-8 by the caller)."""
    try:
        type_url = value = None
        for fno, wt, v in _fields(cmd):
            if fno == 1 and wt == 2:
                type_url = v
            elif fno == 2 and wt == 2:
                value = v
        if type_url is None or value is None \
                or not type_url.startswith(_SQL_TYPE_PREFIX):
            return None
        kind = type_url[len(_SQL_TYPE_PREFIX):].decode()
        if kind not in ("CommandStatementQuery", "TicketStatementQuery"):
            return None
        for fno, wt, v in _fields(value):
            if fno == 1 and wt == 2:
                return v.decode("utf-8")
        return ""
    except Exception:  # noqa: BLE001 — not an envelope
        return None


def encode_statement_query(sql: str) -> bytes:
    """The ``Any``-wrapped ``CommandStatementQuery`` a Flight SQL client
    would send (used by tests to prove wire-shape compatibility)."""
    inner = _emit_field(1, sql.encode("utf-8"))
    return _emit_field(1, _SQL_TYPE_PREFIX + b"CommandStatementQuery") \
        + _emit_field(2, inner)


# -- server -------------------------------------------------------------------

if _FLIGHT_OK:
    class SdotFlightServer(flight.FlightServerBase):
        """≈ the thriftserver wrapper: every statement runs through the
        full session path (planner, engine, history)."""

        def __init__(self, ctx, location: str = "grpc://0.0.0.0:8083"):
            super().__init__(location)
            # concurrent statements are safe on one Context: the session
            # layer keeps per-thread state (thread-local stats/temp
            # frames, double-checked compile locking — hammer-tested by
            # tests/test_server.py), so gRPC's thread pool needs no
            # serialization here
            self.ctx = ctx
            self.location = location

        # -- helpers ---------------------------------------------------------
        def _sql_of(self, raw: bytes) -> str:
            sql = decode_sql_command(raw)
            if sql is None:
                try:
                    sql = raw.decode("utf-8")
                except UnicodeDecodeError:
                    raise flight.FlightServerError(
                        "descriptor/ticket is neither a Flight SQL "
                        "command envelope nor UTF-8 SQL text")
            return sql

        def _execute(self, sql: str) -> pa.Table:
            from spark_druid_olap_tpu_torch.wlm.lanes import AdmissionRejected
            try:
                df = self.ctx.sql(sql).to_pandas()
            except AdmissionRejected as e:
                # gRPC's RESOURCE_EXHAUSTED is the 429 analog; the retry
                # hint rides the message (Flight carries no headers here)
                raise flight.FlightServerError(
                    f"admission rejected (retry after "
                    f"{e.retry_after_s:.1f}s): {e}") from e
            return pa.Table.from_pandas(df, preserve_index=False)

        # -- Flight handlers -------------------------------------------------
        def get_flight_info(self, context, descriptor):
            # executing here just for the schema would double-run big
            # results: return an empty-schema info whose ticket echoes
            # the command. EMPTY locations = "fetch from the service you
            # contacted" (the Flight convention — advertising the bind
            # address would hand clients an unroutable 0.0.0.0)
            ticket = flight.Ticket(descriptor.command)
            endpoint = flight.FlightEndpoint(ticket, [])
            return flight.FlightInfo(pa.schema([]), descriptor,
                                     [endpoint], -1, -1)

        def do_get(self, context, ticket):
            sql = self._sql_of(ticket.ticket)
            table = self._execute(sql)
            return flight.RecordBatchStream(table)

        def do_action(self, context, action):
            if action.type == "healthcheck":
                yield flight.Result(b"ok")
            else:
                raise KeyError(f"unknown action {action.type!r}")
else:                                       # pragma: no cover
    SdotFlightServer = None


def serve_flight(ctx, host: str = "0.0.0.0", port: int = 8083):
    """Blocking entry point
    (``python -m spark_druid_olap_tpu_torch.server.flight``)."""
    if not _FLIGHT_OK:
        raise RuntimeError("pyarrow.flight is not available")
    server = SdotFlightServer(ctx, f"grpc://{host}:{port}")
    print(f"sdot Arrow Flight SQL endpoint on grpc://{host}:{port}")
    server.serve()


if __name__ == "__main__":               # pragma: no cover
    import argparse

    import spark_druid_olap_tpu_torch as sdot
    _ap = argparse.ArgumentParser()
    _ap.add_argument("--host", default="0.0.0.0")
    _ap.add_argument("--port", type=int, default=8083)
    _ap.add_argument("--device", default="cuda")
    _args = _ap.parse_args()
    serve_flight(sdot.Context(device=_args.device), _args.host, _args.port)
