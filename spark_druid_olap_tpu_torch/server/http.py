"""HTTP serving layer — the thriftserver equivalent.

Port of ``spark_druid_olap_tpu/server/http.py``: a copy kept inside the
PyTorch package, which imports nothing of the JAX package. Two
departures: ``GET /status`` reports the context's torch device (its
``backend`` is the device type, ``devices`` the card's name), and
:func:`serve` takes the device, ``cuda`` unless the caller asks for the
CPU, and raises without a CUDA device as ``Context`` does.

≈ the reference's L7: ``HiveThriftServer2.scala`` fronts the engine for BI
tools over JDBC/ODBC, with a query-history UI tab and SQL-visible metadata
views. Here the endpoint is HTTP:

- ``POST /sql``           {"sql": "...", "format": "json"|"arrow"} -> rows
- ``POST /query``         raw engine query-spec JSON (≈ ON DATASOURCE ...
                          EXECUTE QUERY) with {"dataSource": ...}
- ``POST /sql/cancel``    {"queryId": "..."} -> cooperative cancel
- ``GET  /explain?sql=``  rewrite + cost explanation (≈ EXPLAIN REWRITE)
- ``GET  /status``        liveness + device inventory
- ``GET  /metadata/datasources|segments|columns``  catalog views
- ``GET  /metadata/wlm``  workload-management state (lanes, tenants)
- ``GET  /metadata/persist``  deep-storage state (snapshots, WAL,
                          checkpointer counters, last recovery report)
- ``GET  /history``       query history (≈ the Druid-queries UI tab)

Workload management (wlm/) fronts every query: the request's lane /
tenant / priority come from the JSON body (``lane``/``tenant``/
``priority``) or the ``X-Sdot-Lane`` / ``X-Sdot-Tenant`` /
``X-Sdot-Priority`` headers, and a load-shed admission rejection maps
to **429 Too Many Requests** with a ``Retry-After`` hint (≈ Druid's
QueryCapacityExceededException → 429 at the broker).

The Arrow IPC-stream response format is the binary wire analog of the
reference's Jackson **Smile** protocol (``SmileJson4sScalaModule.scala``):
same role — compact columnar results for programmatic clients — chosen
because Arrow is the TPU-era lingua franca for columnar interchange.
"""

from __future__ import annotations

import json
import threading
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import pandas as pd


def _df_to_json_rows(df: pd.DataFrame) -> bytes:
    # native C++ row encoder (GIL-released) when available/eligible
    from spark_druid_olap_tpu_torch.segment.native import encode_json_rows
    rows_b = encode_json_rows(df)
    if rows_b is not None:
        head = json.dumps({"columns": list(df.columns)})[:-1].encode()
        return (head + b', "rows": ' + rows_b +
                b', "numRows": %d}' % len(df))

    def conv(v):
        if isinstance(v, (np.integer,)):
            return int(v)
        if isinstance(v, (np.floating,)):
            f = float(v)
            return None if f != f else f
        if isinstance(v, (np.datetime64, pd.Timestamp)):
            return pd.Timestamp(v).isoformat()
        if v is None or v is pd.NaT:
            return None
        return v

    rows = [{c: conv(v) for c, v in zip(df.columns, row)}
            for row in df.itertuples(index=False, name=None)]
    return json.dumps({"columns": list(df.columns), "rows": rows,
                       "numRows": len(df)}).encode()


def _df_to_arrow(df: pd.DataFrame) -> bytes:
    import io
    import pyarrow as pa
    table = pa.Table.from_pandas(df, preserve_index=False)
    buf = io.BytesIO()
    with pa.ipc.new_stream(buf, table.schema) as w:
        w.write_table(table)
    return buf.getvalue()


class SqlServer:
    """Embeds a Context behind a threading HTTP server."""

    def __init__(self, ctx, host: str = "127.0.0.1", port: int = 8082):
        self.ctx = ctx
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._handler_threads: set = set()
        # readiness predicate for GET /readyz: None = ready once the
        # server accepts (plain single-process serving). A cluster
        # historical points this at its boot flag (recovery complete +
        # assigned shards loaded). MUST be lock-free and engine-free:
        # health answers may not queue behind long queries.
        self.ready_check = None
        # optional () -> dict merged into the /readyz body (same
        # lock-free contract): a cluster historical advertises its
        # epoch, boot generation, draining flag and per-epoch warm
        # shard lists here so the broker can gate an epoch handover
        # on actual shard readiness instead of process liveness
        self.ready_info = None
        # queries run CONCURRENTLY (one thread per request, like the
        # reference thriftserver's pooled sessions, DruidClient.scala:46-74);
        # the engine serializes only compile-cache population internally,
        # and per-query state (stats, temp frames) is thread-local

    # -- lifecycle ------------------------------------------------------------
    def start(self, background: bool = True):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def handle(self):
                # track live handler threads so stop() can join them with
                # a bound instead of leaking sockets (daemon_threads alone
                # abandons in-flight connections at interpreter exit)
                t = threading.current_thread()
                server._handler_threads.add(t)
                try:
                    super().handle()
                finally:
                    server._handler_threads.discard(t)

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, exc: BaseException):
                body = json.dumps({
                    "error": type(exc).__name__,
                    "message": str(exc)}).encode()
                self._send(code, body)

            def do_GET(self):
                # liveness/readiness FIRST, touching no context, engine
                # or lock: a long query can hold every other handler
                # thread (and the engine's compile lock), and the
                # broker's health prober must never be judged by query
                # latency — only by whether this process accepts and
                # answers
                path = self.path.split("?", 1)[0]
                if path in ("/healthz", "/readyz"):
                    try:
                        server._handle_health(self, path)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                    return
                try:
                    server._handle_get(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    self._error(500, e)

            def do_POST(self):
                try:
                    server._handle_post(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    self._error(500, e)

        class _Httpd(ThreadingHTTPServer):
            # under a dashboard storm every handler thread can sit
            # inside the engine; a deeper accept backlog keeps health
            # probes and new clients out of connection-refused while
            # the accept loop catches up
            request_queue_size = 128

        self._httpd = _Httpd((self.host, self.port), Handler)
        # handler threads must not pin the process (tests start/stop many
        # servers; a hung client connection would otherwise block exit),
        # and server_close() must not join them unboundedly either —
        # stop() does its own bounded join over the tracked set
        self._httpd.daemon_threads = True
        self._httpd.block_on_close = False
        self.port = self._httpd.server_address[1]
        if background:
            self._thread = threading.Thread(target=self._httpd.serve_forever,
                                            daemon=True)
            self._thread.start()
        else:
            self._httpd.serve_forever()
        return self

    def stop(self, join_timeout_s: float = 5.0):
        """Idempotent shutdown that cannot leak the listen socket:
        stop accepting, close the socket, then give in-flight handler
        threads and the serve loop a bounded join."""
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()           # stop the serve_forever loop
        httpd.server_close()       # release the listen socket NOW
        deadline = __import__("time").monotonic() + join_timeout_s
        for t in list(self._handler_threads):
            remaining = deadline - __import__("time").monotonic()
            if remaining <= 0:
                break
            t.join(remaining)      # daemons: a hung one won't pin exit
        if self._thread is not None:
            self._thread.join(max(0.0, deadline
                                  - __import__("time").monotonic()))
            self._thread = None

    # -- handlers -------------------------------------------------------------
    def _handle_health(self, h, path: str):
        """GET /healthz (liveness) and /readyz (readiness). Reads one
        attribute and calls one user predicate — no context, engine, or
        lock access, so it answers even while long queries hold every
        other handler thread."""
        if path == "/healthz":
            h._send(200, b'{"status": "alive"}')
            return
        chk = self.ready_check
        try:
            ok = True if chk is None else bool(chk())
        except Exception:  # noqa: BLE001 — a broken predicate is "not ready"
            ok = False
        body = {"ready": ok}
        info = self.ready_info
        if info is not None:
            try:
                body.update(info())
            except Exception:  # noqa: BLE001 — advert failure ≠ unhealthy
                pass
        h._send(200 if ok else 503, json.dumps(body).encode())

    def _handle_get(self, h):
        url = urlparse(h.path)
        qs = parse_qs(url.query)
        if url.path == "/status":
            body = json.dumps({
                "status": "ok",
                "backend": self.ctx.device.type,
                "devices": _device_names(self.ctx.device),
                "datasources": self.ctx.store.names(),
            }).encode()
            h._send(200, body)
            return
        if url.path == "/explain":
            sql = qs.get("sql", [""])[0]
            text = self.ctx.explain(sql)
            h._send(200, json.dumps({"plan": text.split("\n")}).encode())
            return
        if url.path.startswith("/metadata/"):
            kind = url.path[len("/metadata/"):]
            if kind == "cache":
                # semantic result cache counters (hit/miss/subsumed/
                # evictions/bytes) — ≈ Druid's cache metrics endpoint
                h._send(200, json.dumps(
                    self.ctx.engine.result_cache.stats()).encode())
                return
            if kind == "wlm":
                # lanes (occupancy, sheds, high-water marks) + tenant
                # quota state — ≈ Druid's query-scheduler lane metrics
                h._send(200, json.dumps(
                    self.ctx.engine.wlm.stats()).encode())
                return
            if kind == "cluster":
                # distributed serving tier: shard plan, node health,
                # scatter/merge counters (broker), or role stub
                cl = getattr(self.ctx, "cluster", None)
                if cl is None:
                    h._send(200, b'{"enabled": false}')
                    return
                h._send(200, json.dumps(cl.stats()).encode())
                return
            if kind == "sharedscan":
                # shared-scan coalescer counters; the cluster loadtest
                # polls this per historical for per-node coalesce rate
                h._send(200, json.dumps(
                    self.ctx.engine.sharedscan.stats()).encode())
                return
            if kind == "persist":
                # deep-storage state: per-ds snapshot versions, WAL
                # bytes, checkpointer counters, last recovery report
                if self.ctx.persist is None:
                    h._send(200, b'{"enabled": false}')
                    return
                h._send(200, json.dumps(
                    self.ctx.persist.stats()).encode())
                return
            from spark_druid_olap_tpu_torch.mv.registry import rollups_view
            views = {"datasources": self.ctx.catalog.datasources_view,
                     "segments": self.ctx.catalog.segments_view,
                     "columns": self.ctx.catalog.columns_view,
                     "rollups": lambda: rollups_view(self.ctx)}
            if kind not in views:
                h._send(404, b'{"error": "unknown metadata view"}')
                return
            h._send(200, _df_to_json_rows(views[kind]()))
            return
        if url.path == "/history":
            rows = [r.to_dict() for r in self.ctx.history.entries()]
            h._send(200, json.dumps({"history": rows},
                                    default=str).encode())
            return
        if url.path in ("/ui", "/ui/"):
            h._send(200, self._ui_page(), "text/html; charset=utf-8")
            return
        h._send(404, b'{"error": "not found"}')

    def _ui_page(self) -> bytes:
        """Engine-queries page (≈ the reference's Druid-queries web-UI tab,
        ui/DruidQueriesPage.scala): query history newest-first with mode,
        datasource, segments, groups, timing, and the SQL text."""
        import html as _html
        import time as _time
        rows = []
        for r in reversed(self.ctx.history.entries()):
            st = r.stats
            ts = _time.strftime("%Y-%m-%d %H:%M:%S",
                                _time.gmtime(r.started_at))
            rows.append(
                "<tr><td>{}</td><td>{}</td><td>{}</td><td>{}</td>"
                "<td>{}</td><td>{}</td><td>{:.1f}</td>"
                "<td class=sql>{}</td></tr>".format(
                    ts, _html.escape(str(r.query_type or "")),
                    _html.escape(str(r.datasource or "")),
                    _html.escape(str(st.get("mode", ""))),
                    st.get("segments", ""), st.get("groups", ""),
                    float(st.get("total_ms", 0.0)),
                    _html.escape((r.sql or "")[:500])))
        page = (
            "<!doctype html><html><head><title>sdot queries</title><style>"
            "body{font-family:sans-serif;margin:1em}"
            "table{border-collapse:collapse;width:100%}"
            "td,th{border:1px solid #ccc;padding:4px 8px;font-size:13px;"
            "text-align:left}th{background:#eee}"
            ".sql{font-family:monospace;max-width:40em;overflow-wrap:"
            "anywhere}</style></head><body>"
            "<h2>Engine queries</h2>"
            f"<p>{len(rows)} recorded; datasources: "
            f"{', '.join(self.ctx.store.names()) or '(none)'}</p>"
            "<table><tr><th>started (UTC)</th><th>type</th>"
            "<th>datasource</th><th>mode</th><th>segments</th>"
            "<th>groups</th><th>total ms</th><th>sql</th></tr>"
            + "".join(rows) + "</table></body></html>")
        return page.encode()

    def _read_json(self, h) -> dict:
        n = int(h.headers.get("Content-Length", "0"))
        raw = h.rfile.read(n) if n else b"{}"
        return json.loads(raw.decode())

    @staticmethod
    def _wlm_request(h, req: dict):
        """Lane / tenant / priority for admission: JSON body fields win,
        ``X-Sdot-*`` headers cover clients that can't touch the body
        (BI-tool gateways tagging traffic per tool/user)."""
        lane = req.get("lane") or h.headers.get("X-Sdot-Lane")
        tenant = req.get("tenant") or h.headers.get("X-Sdot-Tenant")
        prio = req.get("priority")
        if prio is None:
            prio = h.headers.get("X-Sdot-Priority")
        try:
            prio = int(prio) if prio is not None else None
        except (TypeError, ValueError):
            prio = None
        return lane, tenant, prio

    @staticmethod
    def _send_shed(h, e, qid=None):
        """AdmissionRejected -> 429 + Retry-After (≈ Druid's
        QueryCapacityExceededException at the broker)."""
        retry_after = max(1, int(-(-e.retry_after_s // 1)))  # ceil, >= 1s
        body = {"error": type(e).__name__, "message": str(e),
                "retryAfterSeconds": retry_after}
        if qid is not None:
            body["queryId"] = qid
        payload = json.dumps(body).encode()
        h.send_response(429)
        h.send_header("Content-Type", "application/json")
        h.send_header("Retry-After", str(retry_after))
        h.send_header("Content-Length", str(len(payload)))
        h.end_headers()
        h.wfile.write(payload)

    def _handle_post(self, h):
        url = urlparse(h.path)
        if url.path == "/sql":
            req = self._read_json(h)
            sql = req.get("sql")
            if not sql:
                h._send(400, b'{"error": "missing \'sql\'"}')
                return
            fmt = req.get("format", "json")
            # the client supplies (or we mint) a query id; supplying one is
            # what makes POST /sql/cancel reachable mid-flight (≈ Druid's
            # client-set queryId in QuerySpecContext). Restricted charset:
            # the id is echoed into the JSON envelope and a response header
            qid = str(req.get("queryId") or uuid.uuid4().hex)
            import re as _re
            if not _re.fullmatch(r"[A-Za-z0-9_.:\-]{1,128}", qid):
                h._send(400, b'{"error": "invalid queryId"}')
                return
            from spark_druid_olap_tpu_torch.sql.lexer import SqlSyntaxError
            from spark_druid_olap_tpu_torch.parallel.executor import (
                QueryCancelled, QueryTimeout)
            from spark_druid_olap_tpu_torch.wlm.lanes import AdmissionRejected
            lane, tenant, prio = self._wlm_request(h, req)
            try:
                r = self.ctx.sql(sql, query_id=qid, lane=lane,
                                 tenant=tenant, priority=prio)
            except SqlSyntaxError as e:
                h._error(400, e)
                return
            except KeyError as e:
                h._error(404, e)
                return
            except AdmissionRejected as e:
                self._send_shed(h, e, qid)
                return
            except (QueryCancelled, QueryTimeout) as e:
                body = json.dumps({"error": type(e).__name__,
                                   "message": str(e),
                                   "queryId": qid}).encode()
                h._send(499 if isinstance(e, QueryCancelled) else 504, body)
                return
            df = r.to_pandas()
            if fmt == "arrow":
                body = _df_to_arrow(df)   # serialize BEFORE the status line
                h.send_response(200)
                h.send_header("Content-Type",
                              "application/vnd.apache.arrow.stream")
                h.send_header("Content-Length", str(len(body)))
                h.send_header("X-Query-Id", qid)
                h.end_headers()
                h.wfile.write(body)
            else:
                body = _df_to_json_rows(df)
                # splice the id into the JSON envelope
                body = body[:-1] + b', "queryId": "%s"}' % qid.encode()
                h._send(200, body)
            return
        if url.path == "/query":
            req = self._read_json(h)
            from spark_druid_olap_tpu_torch.ir.serde import query_from_dict
            from spark_druid_olap_tpu_torch.wlm.lanes import AdmissionRejected
            q = query_from_dict(req)
            lane, tenant, prio = self._wlm_request(h, req.get("context")
                                                   or {})
            if lane or tenant or prio is not None:
                self.ctx.engine.wlm.push_request(lane, tenant, prio)
            try:
                r = self.ctx.execute(q)
            except AdmissionRejected as e:
                self._send_shed(h, e)
                return
            finally:
                if lane or tenant or prio is not None:
                    self.ctx.engine.wlm.pop_request()
            h._send(200, _df_to_json_rows(r.to_pandas()))
            return
        if url.path == "/sql/cancel":
            req = self._read_json(h)
            qid = req.get("queryId", "")
            ok = self.ctx.engine.cancel(qid)
            h._send(200, json.dumps({"cancelled": bool(ok)}).encode())
            return
        h._send(404, b'{"error": "not found"}')


def _device_names(device) -> list:
    """The serving device as ``/status`` lists it: the card's name on
    ``cuda``, the device string otherwise."""
    if device.type == "cuda":
        import torch
        return [torch.cuda.get_device_name(device)]
    return [str(device)]


def serve(ctx=None, host="0.0.0.0", port=8082, setup=None, device="cuda"):
    """Blocking entry point (``python -m spark_druid_olap_tpu_torch.server``).
    Without ``ctx`` it builds a ``Context`` on ``device`` (``cuda`` by
    default; raises when no CUDA device is available)."""
    if ctx is None:
        import spark_druid_olap_tpu_torch as sdot
        ctx = sdot.Context(device=device)
    if setup:
        setup(ctx)
    print(f"sdot SQL server listening on http://{host}:{port}")
    SqlServer(ctx, host, port).start(background=False)
