"""Query result: ordered named numpy columns.

Port counterpart of ``spark_druid_olap_tpu/result.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

≈ the rows the reference materializes from Druid result iterators into Spark
``GenericInternalRow``s (``DruidRDD.scala:235-241``) — here the engine output
is already columnar, so the result *stays* columnar.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import pandas as pd


class QueryResult:
    # Set by the broker in partial-results mode when shards were
    # unreachable: {"missing_shards": [...], "coverage_rows": int,
    # "total_rows": int}. None = exact full answer (degraded results
    # never enter the result cache).
    degraded = None

    def __init__(self, columns: List[str], data: Dict[str, np.ndarray]):
        self.columns = list(columns)
        self.data = data
        n = {len(v) for v in data.values()}
        assert len(n) <= 1, f"ragged result: { {k: len(v) for k, v in data.items()} }"

    def __len__(self) -> int:
        if not self.data:
            return 0
        return len(next(iter(self.data.values())))

    def __getitem__(self, name: str) -> np.ndarray:
        return self.data[name]

    def to_pandas(self) -> pd.DataFrame:
        return pd.DataFrame({c: self.data[c] for c in self.columns})

    def to_rows(self) -> List[dict]:
        df = self.to_pandas()
        return df.to_dict(orient="records")

    def __repr__(self) -> str:
        return f"QueryResult({len(self)} rows x {self.columns})"

    @staticmethod
    def empty(columns: List[str]) -> "QueryResult":
        return QueryResult(columns, {c: np.array([]) for c in columns})
