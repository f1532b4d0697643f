"""Bounded in-memory query history.

Port counterpart of ``spark_druid_olap_tpu/metadata/history.py``: a copy
kept inside the PyTorch package, which imports nothing of the JAX package.

≈ ``DruidQueryHistory`` (reference ``DruidQueryHistory.scala:39-76``: bounded
queue of 500 executed Druid queries with timings, surfaced in a web-UI tab and
SQL-queryable metadata views)."""

from __future__ import annotations

import collections
import threading
import time
from typing import List, Optional


class QueryExecutionRecord:
    __slots__ = ("started_at", "query_type", "datasource", "sql", "stats")

    def __init__(self, query_type, datasource, stats, sql=None):
        self.started_at = time.time()
        self.query_type = query_type
        self.datasource = datasource
        self.stats = dict(stats)
        self.sql = sql

    def to_dict(self):
        return {"startedAt": self.started_at, "queryType": self.query_type,
                "datasource": self.datasource, "sql": self.sql,
                **self.stats}


class InflightRegistry:
    """Live queries by admission state (``queued`` → ``running``),
    surfaced by ``sys_queries`` next to the completed-history rows so
    in-flight load is observable while it is happening (≈ Druid's
    broker `sys.queries` / running-query endpoint)."""

    __slots__ = ("_lock", "_rows", "_next")

    def __init__(self):
        self._lock = threading.Lock()
        self._rows = {}
        self._next = 0

    def begin(self, query_id, datasource, query_type) -> int:
        with self._lock:
            tok = self._next
            self._next += 1
            self._rows[tok] = {
                "query_id": query_id, "datasource": datasource,
                "query_type": query_type, "state": "queued",
                "lane": None, "tenant": None,
                "started_at": time.time(), "t0": time.perf_counter(),
                "queued_ms": 0.0}
            return tok

    def running(self, tok: int, lane=None, tenant=None,
                queued_ms: float = 0.0) -> None:
        with self._lock:
            row = self._rows.get(tok)
            if row is not None:
                row["state"] = "running"
                row["lane"] = lane
                row["tenant"] = tenant
                row["queued_ms"] = queued_ms

    def annotate(self, tok, **fields) -> None:
        """Attach extra columns to a live row (e.g. the shared-scan
        coalesced-group id); snapshot() copies rows, so annotations flow
        into ``sys_queries`` without schema changes here."""
        if tok is None:
            return
        with self._lock:
            row = self._rows.get(tok)
            if row is not None:
                row.update(fields)

    def done(self, tok: int) -> None:
        with self._lock:
            self._rows.pop(tok, None)

    def snapshot(self) -> List[dict]:
        now = time.perf_counter()
        with self._lock:
            out = []
            for row in self._rows.values():
                d = dict(row)
                d["wall_ms"] = (now - d.pop("t0")) * 1000.0
                if d["state"] == "queued":
                    # still accruing; report the live wait
                    d["queued_ms"] = d["wall_ms"]
                out.append(d)
            return out


def _filter_columns(f, out: set) -> None:
    """Column names a filter tree touches (duck-typed over the spec
    classes: logical nodes carry ``fields``, leaf filters ``dimension``,
    spatial filters ``axes``)."""
    if f is None:
        return
    for sub in getattr(f, "fields", ()) or ():
        _filter_columns(sub, out)
    d = getattr(f, "dimension", None)
    if isinstance(d, str):
        out.add(d)
    for ax in getattr(f, "axes", ()) or ():
        if isinstance(ax, str):
            out.add(ax)


def referenced_columns(query) -> set:
    """Column names one query spec reads (dimensions, aggregation
    inputs, filter columns) — the popularity signal."""
    cols: set = set()
    try:
        from spark_druid_olap_tpu_torch.ir import spec as S
        for d in S.query_dimensions(query):
            name = getattr(d, "dimension", None)
            if isinstance(name, str):
                cols.add(name)
        for a in S.query_aggregations(query):
            f = getattr(a, "field", None)
            if isinstance(f, str):
                cols.add(f)
            _filter_columns(getattr(a, "filter", None), cols)
        _filter_columns(getattr(query, "filter", None), cols)
    except Exception:  # noqa: BLE001 — scoring must never break record()
        pass
    return cols


# distinct (datasource, column) scores retained; above this the lowest
# half is dropped (ad-hoc fuzzers emit unbounded distinct columns)
_COL_SCORE_BOUND = 4096


class QueryHistory:
    def __init__(self, max_size: int = 500):
        self._q = collections.deque(maxlen=max_size)
        self._lock = threading.Lock()
        # (datasource, column) -> hit count. The same access signal that
        # orders recovery warmup (persist/manager.py) also ranks the
        # tiered hot set's eviction order (tier/store.py): a column the
        # dashboard mix keeps touching survives budget pressure.
        self._col_scores = {}

    def record(self, query, stats, sql: Optional[str] = None):
        rec = QueryExecutionRecord(type(query).__name__,
                                   getattr(query, "datasource", None),
                                   stats, sql)
        ds = rec.datasource
        cols = referenced_columns(query) if ds is not None else ()
        with self._lock:
            self._q.append(rec)
            for c in cols:
                k = (ds, c)
                self._col_scores[k] = self._col_scores.get(k, 0) + 1
            if len(self._col_scores) > _COL_SCORE_BOUND:
                keep = sorted(self._col_scores.items(),
                              key=lambda kv: -kv[1])[:_COL_SCORE_BOUND // 2]
                self._col_scores = dict(keep)
        return rec

    def column_score(self, datasource: str, column: str) -> float:
        """Popularity of one column (0.0 = never seen)."""
        with self._lock:
            return float(self._col_scores.get((datasource, column), 0))

    def entries(self) -> List[QueryExecutionRecord]:
        with self._lock:
            return list(self._q)

    def clear(self):
        with self._lock:
            self._q.clear()
            self._col_scores.clear()
