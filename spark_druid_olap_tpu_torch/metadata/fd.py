"""Functional-dependency graph over star-schema columns.

Port counterpart of ``spark_druid_olap_tpu/metadata/fd.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

≈ ``FunctionalDependency.scala``: a 1-1 / n-1 column dependency graph with
transitive closure (reference uses Floyd-Warshall :176-185) used to estimate
GROUP BY cardinality. Here it additionally powers a *rewrite*: a grouping
column functionally determined by another grouping column is demoted from the
fused group key to an ``anyvalue`` aggregation — which is what keeps dense
group keys dense (TPC-H Q3/Q10 group by an order/customer key plus columns
that key determines; without FDs the fused key space multiplies out).

Derivation: for every star relation, the dimension-side join key determines
every column of the dimension table; join-column pairs are equivalences.
"""

from __future__ import annotations

from typing import Dict, Set

from spark_druid_olap_tpu_torch.metadata.star import StarSchema


class FDGraph:
    def __init__(self):
        self._edges: Dict[str, Set[str]] = {}
        # join-key equality edges only — a strictly stronger relation than
        # mutual determination (two keys of one table determine each other
        # but hold different VALUES)
        self._equiv: Dict[str, Set[str]] = {}

    def add(self, a: str, b: str):
        self._edges.setdefault(a, set()).add(b)

    def add_equiv(self, a: str, b: str):
        self.add(a, b)
        self.add(b, a)
        self._equiv.setdefault(a, set()).add(b)
        self._equiv.setdefault(b, set()).add(a)

    def equivalents(self, a: str) -> Set[str]:
        """Columns guaranteed value-equal to ``a`` on the flat datasource:
        the transitive closure of join-key equalities (includes ``a``)."""
        seen = {a}
        stack = [a]
        while stack:
            x = stack.pop()
            for y in self._equiv.get(x, ()):
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        return seen

    def determines(self, a: str, b: str) -> bool:
        """True if column ``a`` functionally determines ``b``."""
        if a == b:
            return True
        seen = {a}
        stack = [a]
        while stack:
            x = stack.pop()
            for y in self._edges.get(x, ()):
                if y == b:
                    return True
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        return False


def build_fd_graph(star: StarSchema, store) -> FDGraph:
    g = FDGraph()
    for r in star.relations:
        for lc, rc in r.join_columns:
            g.add_equiv(lc, rc)
        if len(r.join_columns) == 1:
            # single-column key of the dim table determines all its columns
            _, key = r.join_columns[0]
            try:
                cols = store.get(r.right_table).column_names()
            except KeyError:
                continue
            for c in cols:
                if c != key:
                    g.add(key, c)
            if r.relation_type == "1-1":
                lkey = r.join_columns[0][0]
                try:
                    lcols = store.get(r.left_table).column_names()
                except KeyError:
                    continue
                for c in lcols:
                    if c != lkey:
                        g.add(lkey, c)
    return g
