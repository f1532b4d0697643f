"""Star-schema metadata and join validation.

Port counterpart of ``spark_druid_olap_tpu/metadata/star.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

≈ ``StarSchemaInfo.scala``: the user declares the star-join graph — fact
table plus n-1 / 1-1 relations to dimension tables — and the planner
validates that a query's join tree is a connected subgraph of it before
collapsing the join onto the flat (denormalized) datasource
(``StarSchema.isStarJoin:215-275``). Column names must be globally unique
across the schema (reference doc :127-165) — that constraint is what lets the
collapse be a pure name-mapping (the flat index carries every column under
its original name).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple


@dataclasses.dataclass(frozen=True)
class StarRelation:
    """An edge of the star graph: ``left`` joins ``right`` (its dimension)
    on pairwise-equal columns. ≈ ``StarRelationInfo``."""
    left_table: str
    right_table: str
    join_columns: Tuple[Tuple[str, str], ...]   # (left_col, right_col)
    relation_type: str = "n-1"                  # 'n-1' | '1-1'


class StarSchemaError(Exception):
    pass


class StarSchema:
    def __init__(self, fact_table: str, flat_datasource: str,
                 relations: Sequence[StarRelation]):
        self.fact_table = fact_table
        self.flat_datasource = flat_datasource
        self.relations = list(relations)
        self._validate()

    def _validate(self):
        # single parent per dim table, graph connected from the fact
        parents: Dict[str, str] = {}
        for r in self.relations:
            if r.right_table in parents:
                raise StarSchemaError(
                    f"table {r.right_table!r} joined from multiple parents "
                    f"({parents[r.right_table]!r} and {r.left_table!r}); "
                    "the star graph must give each table a unique join path")
            parents[r.right_table] = r.left_table
        reachable = {self.fact_table}
        pending = list(self.relations)
        progress = True
        while pending and progress:
            progress = False
            for r in list(pending):
                if r.left_table in reachable:
                    reachable.add(r.right_table)
                    pending.remove(r)
                    progress = True
        if pending:
            bad = [r.right_table for r in pending]
            raise StarSchemaError(
                f"tables not reachable from fact {self.fact_table!r}: {bad}")

    # -- persistence (persist/manager.py catalog.json) -------------------------
    def to_dict(self) -> dict:
        return {
            "factTable": self.fact_table,
            "flatDatasource": self.flat_datasource,
            "relations": [
                {"leftTable": r.left_table, "rightTable": r.right_table,
                 "joinColumns": [list(p) for p in r.join_columns],
                 "relationType": r.relation_type}
                for r in self.relations],
        }

    @staticmethod
    def from_dict(d: dict) -> "StarSchema":
        rels = [StarRelation(
            left_table=r["leftTable"], right_table=r["rightTable"],
            join_columns=tuple((p[0], p[1]) for p in r["joinColumns"]),
            relation_type=r.get("relationType", "n-1"))
            for r in d.get("relations", ())]
        return StarSchema(d["factTable"], d["flatDatasource"], rels)

    def tables(self) -> Set[str]:
        out = {self.fact_table}
        for r in self.relations:
            out.add(r.left_table)
            out.add(r.right_table)
        return out

    def _pair_index(self) -> Dict[frozenset, StarRelation]:
        idx = {}
        for r in self.relations:
            for lc, rc in r.join_columns:
                idx[frozenset((lc, rc))] = r
        return idx

    def is_star_join(self, tables: Set[str],
                     eq_pairs: Sequence[Tuple[str, str]]) -> bool:
        """Validate a query join: every equi-pair is a declared star edge and
        the joined tables form a connected subgraph containing each pair's
        endpoints (≈ ``isStarJoin``). Requires every edge between joined
        tables to be fully specified."""
        if not tables <= self.tables():
            return False
        idx = self._pair_index()
        used_rels = set()
        for a, b in eq_pairs:
            r = idx.get(frozenset((a, b)))
            if r is None:
                return False
            if not (r.left_table in tables and r.right_table in tables):
                return False
            used_rels.add(id(r))
        # each relation whose two tables are both in the query must have ALL
        # its join columns present
        needed = {}
        for a, b in eq_pairs:
            r = idx[frozenset((a, b))]
            needed.setdefault(id(r), set()).add(frozenset((a, b)))
        for r in self.relations:
            if r.left_table in tables and r.right_table in tables:
                want = {frozenset(p) for p in r.join_columns}
                if needed.get(id(r), set()) != want:
                    return False
        # connectivity over the used edges
        adj: Dict[str, Set[str]] = {t: set() for t in tables}
        for r in self.relations:
            if id(r) in needed and r.left_table in tables \
                    and r.right_table in tables:
                adj[r.left_table].add(r.right_table)
                adj[r.right_table].add(r.left_table)
        if not tables:
            return False
        start = next(iter(tables))
        seen = {start}
        stack = [start]
        while stack:
            t = stack.pop()
            for u in adj[t]:
                if u not in seen:
                    seen.add(u)
                    stack.append(u)
        return seen == tables
