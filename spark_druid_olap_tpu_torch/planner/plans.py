"""Physical plan descriptions produced by the pushdown builder.

Port counterpart of ``spark_druid_olap_tpu/planner/plans.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from spark_druid_olap_tpu_torch.ir import spec as S


class PlanUnsupported(Exception):
    """The device planner can't push this query; the session falls back to
    host execution (≈ a DruidTransform returning Nil so Spark plans the
    query itself)."""


@dataclasses.dataclass
class DistinctPhase2:
    """Exact count-distinct via two phases: phase 1 groups by
    (dims + distinct arg) on device; phase 2 re-aggregates on host.
    ≈ the reference's SPLRewriteDistinctAggregates Expand form, collapsed to
    two physical stages."""
    group_cols: List[str]
    distinct_out: str           # output column name of the distinct count
    distinct_dim: str           # phase-1 dim column holding the arg values
    other_aggs: Dict[str, str]  # phase-1 agg col -> re-agg fn (sum|min|max)


@dataclasses.dataclass
class PlannedQuery:
    datasource: str
    specs: List[S.QuerySpec]
    spec_dims: List[List[str]]            # dim output names present per spec
    all_dims: List[str]                   # union of dim names (output order)
    output_columns: List[str]             # final projection (ordered)
    order_by: List[Tuple[str, bool]] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    order_applied_in_spec: bool = False
    distinct_phase2: Optional[DistinctPhase2] = None
    select_path: bool = False             # non-agg raw select
    # source column -> output alias renames (select path)
    select_renames: Dict[str, str] = dataclasses.field(default_factory=dict)
    # post-aggregations deferred past phase 2 (only with distinct_phase2)
    deferred_posts: List[S.PostAggregationSpec] = \
        dataclasses.field(default_factory=list)
    # unpushable WHERE conjuncts evaluated on the (small) engine result —
    # over dim OUTPUT names (agg path) or source columns (select path);
    # ≈ the Spark FilterExec the reference leaves above the Druid scan
    residual: Optional[object] = None
    # name of the materialized rollup the specs were rewritten onto
    # (mv/match.py); None = specs scan the base datasource
    rollup: Optional[str] = None
