"""Catalog: datasource registry views + star-schema bindings.

Port counterpart of ``spark_druid_olap_tpu/metadata/catalog.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

≈ the reference metadata layer: ``DruidMetadataCache`` (datasource schemas),
``DruidRelationInfo`` (table ↔ datasource binding), ``DruidMetadataViews``
(SQL-queryable virtual tables). Star-schema specifics live in
``metadata/star.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pandas as pd

from spark_druid_olap_tpu_torch.segment.store import SegmentStore


class Catalog:
    def __init__(self, store: SegmentStore):
        self.store = store
        self.star_schemas: Dict[str, object] = {}   # fact table -> StarSchema
        self._table_to_stars: Dict[str, list] = {}

    def register_star_schema(self, star) -> None:
        prev = self.star_schemas.get(star.fact_table)
        self.star_schemas[star.fact_table] = star
        if prev is not None:
            # drop the superseded star everywhere, including tables the new
            # version no longer declares
            for lst in self._table_to_stars.values():
                if prev in lst:
                    lst.remove(prev)
        for t in star.tables():
            self._table_to_stars.setdefault(t, []).append(star)
        if hasattr(self, "_fd_cache"):
            self._fd_cache.pop(star.fact_table, None)

    def star_schema_of(self, table: str):
        lst = self._table_to_stars.get(table)
        return lst[0] if lst else None

    def star_schemas_of(self, table: str) -> list:
        """All stars a table participates in — shared dimension tables
        (e.g. supplier in both a lineitem star and a partsupp star) make
        this a list; the planner picks the candidate whose fact anchors
        the query's join tree."""
        return list(self._table_to_stars.get(table, ()))

    def fd_graph_for(self, ds_name: str, store=None):
        """FD graph applicable to a datasource (its star schema's, matched by
        flat-datasource or member-table name); None when no star declared."""
        store = store or self.store
        for star in self.star_schemas.values():
            if star.flat_datasource == ds_name or ds_name in star.tables():
                key = star.fact_table
                if not hasattr(self, "_fd_cache"):
                    self._fd_cache = {}
                if key not in self._fd_cache:
                    from spark_druid_olap_tpu_torch.metadata.fd import build_fd_graph
                    self._fd_cache[key] = build_fd_graph(star, store)
                return self._fd_cache[key]
        return None

    # -- metadata views (≈ DruidMetadataViews.metadataDFs) --------------------
    def datasources_view(self) -> pd.DataFrame:
        rows = []
        for name in self.store.names():
            ds = self.store.get(name)
            lo, hi = ds.interval()
            rows.append({"name": name, "numRows": ds.num_rows,
                         "numSegments": ds.num_segments,
                         "intervalStart": np.datetime64(int(lo), "ms"),
                         "intervalEnd": np.datetime64(int(hi), "ms"),
                         "timeColumn": ds.time_column})
        return pd.DataFrame(rows)

    def segments_view(self) -> pd.DataFrame:
        rows = []
        for name in self.store.names():
            ds = self.store.get(name)
            for s in ds.segments:
                rows.append({"datasource": name, "segment": s.id,
                             "rows": s.num_rows,
                             "start": np.datetime64(s.min_millis, "ms"),
                             "end": np.datetime64(s.max_millis, "ms")})
        return pd.DataFrame(rows)

    def columns_view(self) -> pd.DataFrame:
        rows = []
        for name in self.store.names():
            md = self.store.get(name).metadata()
            for col, info in md["columns"].items():
                rows.append({"datasource": name, "column": col, **info})
        return pd.DataFrame(rows)
