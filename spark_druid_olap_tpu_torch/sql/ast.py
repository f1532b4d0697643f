"""SQL AST.

Port counterpart of ``spark_druid_olap_tpu/sql/ast.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

≈ the parsed-plan surface the reference gets from Spark's SQL parser plus its
own front parser (``SparklineDataParser.scala``). Expressions reuse
``ir.expr`` nodes directly (one expression currency end-to-end); this module
adds the relational shell: select statements, table refs, joins, subqueries,
grouping sets, and the command statements the reference's parser adds
(``CLEAR METADATA``, ``EXPLAIN REWRITE``, ``ON DATASOURCE ... EXECUTE
QUERY``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from spark_druid_olap_tpu_torch.ir import expr as E


# -- relations ----------------------------------------------------------------

class Relation:
    pass


@dataclasses.dataclass(frozen=True)
class TableRef(Relation):
    name: str
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SubqueryRef(Relation):
    query: "SelectStmt"
    alias: str


@dataclasses.dataclass(frozen=True)
class Join(Relation):
    left: Relation
    right: Relation
    kind: str                      # 'inner' | 'left' | 'cross'
    condition: Optional[E.Expr]    # None for cross/comma joins


# -- subquery-bearing expressions ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScalarSubquery(E.Expr):
    query: "SelectStmt"


@dataclasses.dataclass(frozen=True)
class InSubquery(E.Expr):
    child: E.Expr
    query: "SelectStmt"
    negated: bool = False

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Exists(E.Expr):
    query: "SelectStmt"
    negated: bool = False


# -- select -------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SelectItem:
    expr: Union[E.Expr, str]       # '*' for star
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class OrderItem:
    expr: E.Expr
    ascending: bool = True


@dataclasses.dataclass(frozen=True)
class GroupingSets:
    """GROUP BY GROUPING SETS / CUBE / ROLLUP (reference rewrites these via
    Spark's Expand; see AggregateTransform grouping-set handling)."""
    sets: Tuple[Tuple[E.Expr, ...], ...]


@dataclasses.dataclass(frozen=True)
class SelectStmt:
    items: Tuple[SelectItem, ...]
    relation: Optional[Relation]
    where: Optional[E.Expr] = None
    group_by: Optional[Union[Tuple[E.Expr, ...], GroupingSets]] = None
    having: Optional[E.Expr] = None
    order_by: Tuple[OrderItem, ...] = ()
    limit: Optional[int] = None
    distinct: bool = False
    offset: int = 0


@dataclasses.dataclass(frozen=True)
class UnionAll:
    """``<select> UNION ALL <select> [...] [ORDER BY ..] [LIMIT n]
    [OFFSET m]`` — each branch plans independently (engine pushdown per
    branch, like Spark planning each child of a Union), rows concatenate
    positionally under the FIRST branch's column names, then the trailing
    ordering applies."""
    parts: Tuple[SelectStmt, ...]
    order_by: Tuple[OrderItem, ...] = ()
    limit: Optional[int] = None
    offset: int = 0


# -- commands (≈ SparklineDataParser commands) --------------------------------

@dataclasses.dataclass(frozen=True)
class ExplainRewrite:
    query: SelectStmt
    sql: str


@dataclasses.dataclass(frozen=True)
class ClearMetadata:
    datasource: Optional[str] = None
    # PURGE: also delete the on-disk snapshots/WAL (deep storage) — a
    # plain clear drops only the in-memory store, and recovery would
    # resurrect persisted datasources on the next start
    purge: bool = False


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    """``CHECKPOINT [<datasource>]`` — publish snapshot(s) to deep
    storage (persist/); no datasource = every complete one."""
    datasource: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Restore:
    """``RESTORE [<datasource>]`` — rewind in-memory state to the last
    published snapshot + committed WAL tail."""
    datasource: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ExecuteRawQuery:
    datasource: str
    query_json: str
    use_sharded: bool = False


# -- materialized rollup DDL (mv/) --------------------------------------------

@dataclasses.dataclass(frozen=True)
class CreateRollup:
    """``CREATE ROLLUP <name> ON <datasource> DIMENSIONS (..) AGGREGATIONS
    (..) [GRANULARITY <g>]`` — aggregations are parsed aggregate-call
    expressions (merge-closed kinds only; validated at build time)."""
    name: str
    base: str
    dimensions: Tuple[str, ...]
    aggregations: Tuple[E.Expr, ...]
    granularity: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DropRollup:
    name: str


@dataclasses.dataclass(frozen=True)
class RefreshRollup:
    name: str


Statement = Union[SelectStmt, UnionAll, ExplainRewrite, ClearMetadata,
                  ExecuteRawQuery, CreateRollup, DropRollup, RefreshRollup,
                  Checkpoint, Restore]
