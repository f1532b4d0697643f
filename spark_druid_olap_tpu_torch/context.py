"""Session context — the port's entry point.

Port of ``spark_druid_olap_tpu/context.py``: ``Context(config, device)``
wires the SQL front end (``sql``, ``explain``), the planner's catalog of
star schemas, the query history, the named lookups and the engine over the
segment store. The device is explicit and passed down to the engine: the
default is ``"cuda"``, and with no CUDA device the constructor raises
instead of running on the CPU. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.metadata.catalog import Catalog
from spark_druid_olap_tpu_torch.metadata.history import QueryHistory
from spark_druid_olap_tpu_torch.parallel.executor import QueryEngine
from spark_druid_olap_tpu_torch.result import QueryResult
from spark_druid_olap_tpu_torch.segment.ingest import ingest_dataframe
from spark_druid_olap_tpu_torch.segment.store import SegmentStore
from spark_druid_olap_tpu_torch.utils.config import (
    Config,
    QUERY_HISTORY,
    QUERY_HISTORY_SIZE,
    SEGMENT_ROWS,
)


class Context:
    def __init__(self, config: Optional[Dict] = None, device=None):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "spark_druid_olap_tpu_torch.Context: no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        self.device = device
        self.config = Config(config)
        self.store = SegmentStore()
        self.engine = QueryEngine(self.store, self.config, device)
        self.catalog = Catalog(self.store)
        # disabled history keeps the registry but records nothing
        self.history = QueryHistory(
            self.config.get(QUERY_HISTORY_SIZE)
            if self.config.get(QUERY_HISTORY) else 0)
        # named lookup tables for the SQL LOOKUP(col, 'name') function
        self.lookups: Dict[str, Dict[str, Optional[str]]] = {}
        # the host tier runs uncorrelated sub-statements through the
        # engine when they push down (planner/host_exec.try_engine);
        # differential oracles turn it off to stay engine-free
        self.host_engine_assist = True

    # -- ingest / registration ------------------------------------------------
    def ingest_dataframe(self, name, df, **kwargs):
        """Ingest a DataFrame; segment sizing defaults to
        ``sdot.segment.target.rows``."""
        kwargs.setdefault("target_rows", self.config.get(SEGMENT_ROWS))
        ds = ingest_dataframe(name, df, **kwargs)
        self.store.register(ds)
        return ds

    def register_star_schema(self, star_schema) -> None:
        """Declare a star schema (``metadata/star.py``): joins over its
        tables collapse onto its flat datasource."""
        self.catalog.register_star_schema(star_schema)

    def register_lookup(self, name: str, mapping: Dict) -> None:
        """Register a named value-translation map usable as
        ``LOOKUP(col, 'name')`` in SQL (≈ Druid lookup registration)."""
        self.lookups[name] = {str(k): (None if v is None else str(v))
                              for k, v in mapping.items()}

    # -- query ----------------------------------------------------------------
    def execute(self, q: S.QuerySpec) -> QueryResult:
        """Execute a raw engine QuerySpec (≈ ``ON DRUIDDATASOURCE ...
        EXECUTE QUERY`` in the reference)."""
        r = self.engine.execute(q)
        self.history.record(q, dict(self.engine.last_stats))
        return r

    def sql(self, query: str) -> QueryResult:
        """Parse, plan and run one SQL statement (``sql/session.py``)."""
        from spark_druid_olap_tpu_torch.sql.session import run_sql
        return run_sql(self, query)

    def explain(self, query: str) -> str:
        """The pushdown plan of one statement, without running it."""
        from spark_druid_olap_tpu_torch.sql.session import explain_sql
        return explain_sql(self, query)
