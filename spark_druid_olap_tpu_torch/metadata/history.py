"""Bounded in-memory query history.

Port counterpart of ``spark_druid_olap_tpu/metadata/history.py``: a copy
kept inside the PyTorch package, which imports nothing of the JAX package,
less the in-flight registry of the JAX engine's workload manager (not
ported, ROADMAP A.9).

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
