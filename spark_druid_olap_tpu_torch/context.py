"""Session context — the port's entry point.

Port of ``spark_druid_olap_tpu/context.py``: ``Context(config, device)``
with ``ingest_dataframe``, ``execute`` and the ``engine`` it wires to the
segment store. The device is explicit and passed down to the engine: the
default is ``"cuda"``, and with no CUDA device the constructor raises
instead of running on the CPU. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.parallel.executor import QueryEngine
from spark_druid_olap_tpu_torch.result import QueryResult
from spark_druid_olap_tpu_torch.segment.ingest import ingest_dataframe
from spark_druid_olap_tpu_torch.segment.store import SegmentStore
from spark_druid_olap_tpu_torch.utils.config import Config, SEGMENT_ROWS


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

    # -- ingest / registration ------------------------------------------------
    def ingest_dataframe(self, name, df, **kwargs):
        """Ingest a DataFrame; segment sizing defaults to
        ``sdot.segment.target.rows``."""
        kwargs.setdefault("target_rows", self.config.get(SEGMENT_ROWS))
        ds = ingest_dataframe(name, df, **kwargs)
        self.store.register(ds)
        return ds

    # -- query ----------------------------------------------------------------
    def execute(self, q: S.QuerySpec) -> QueryResult:
        """Execute a raw engine QuerySpec (≈ ``ON DRUIDDATASOURCE ...
        EXECUTE QUERY <json>`` in the reference)."""
        return self.engine.execute(q)
