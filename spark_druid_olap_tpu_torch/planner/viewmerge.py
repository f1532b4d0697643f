"""Derived-table view merging.

Port counterpart of ``spark_druid_olap_tpu/planner/viewmerge.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

``SELECT ... FROM (SELECT <projection> FROM R WHERE P) t WHERE Q`` collapses
to ``SELECT ...[substituted] FROM R WHERE P AND Q[substituted]`` when the
inner block is a plain projection/filter (no aggregation, DISTINCT, LIMIT or
HAVING). Spark's optimizer (CollapseProject / PushDownPredicate) does this
before the reference's rewrite rules run, which is why TPC-H q22-shaped
queries still reach DruidStrategy anchored at a relation leaf — this pass
reproduces that normalization for the pushdown builder.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.sql import ast as A


def _and(parts):
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    return parts[0] if len(parts) == 1 else E.And(tuple(parts))


def _mapping(inner: A.SelectStmt) -> Optional[Dict[str, E.Expr]]:
    """Output-name -> source-expression map of the inner projection; None
    when an item is unmappable. '*' items pass unselected names through
    untouched (identity)."""
    out: Dict[str, E.Expr] = {}
    for it in inner.items:
        if it.expr == "*" or (isinstance(it.expr, E.Column)
                              and it.expr.name == "*"):
            continue
        if it.alias:
            out[it.alias] = it.expr
        elif isinstance(it.expr, E.Column):
            out[it.expr.name] = it.expr
        else:
            return None     # unaliased computed item: no stable name
    return out


def merge_derived(ctx, stmt: A.SelectStmt) -> A.SelectStmt:
    """Iteratively merge a top-level single derived table into the outer
    statement."""
    while isinstance(stmt.relation, A.SubqueryRef):
        inner = stmt.relation.query
        if not isinstance(inner, A.SelectStmt) or inner.relation is None:
            break
        if inner.group_by is not None or inner.having is not None \
                or inner.limit is not None or inner.distinct \
                or inner.order_by or inner.offset:
            break
        if any(it.expr == "*" or (isinstance(it.expr, E.Column)
                                  and it.expr.name == "*")
               for it in stmt.items):
            # outer '*' means "the derived table's columns"; merging would
            # widen it to every base-table column
            break
        mapping = _mapping(inner)
        if mapping is None:
            break
        nontrivial = {k for k, v in mapping.items()
                      if not (isinstance(v, E.Column) and v.name == k)}

        def subst(e):
            if e is None or e == "*":
                return e

            def rep(n):
                if isinstance(n, E.Column) and n.name in mapping:
                    return mapping[n.name]
                return n
            return E.transform(e, rep)

        # expression substitution cannot reach inside nested subquery
        # blocks; bail if one references a non-identity-mapped name
        from spark_druid_olap_tpu_torch.planner.host_exec import (
            _free_columns, _subquery_nodes)
        safe = True
        for e in [it.expr for it in stmt.items if it.expr != "*"] \
                + [stmt.where, stmt.having] \
                + [o.expr for o in stmt.order_by]:
            if e is None:
                continue
            for node in _subquery_nodes(e):
                try:
                    if _free_columns(ctx, node.query) & nontrivial:
                        safe = False
                except Exception:  # noqa: BLE001
                    safe = False
        if not safe:
            break

        gb = stmt.group_by
        if isinstance(gb, A.GroupingSets):
            gb = A.GroupingSets(tuple(tuple(subst(g) for g in s)
                                      for s in gb.sets))
        elif gb is not None:
            gb = tuple(subst(g) for g in gb)
        def merge_item(it):
            # a bare reference to a computed derived column keeps its name:
            # SELECT cntrycode FROM (SELECT substr(...) AS cntrycode ...)
            alias = it.alias
            if alias is None and isinstance(it.expr, E.Column) \
                    and it.expr.name in nontrivial:
                alias = it.expr.name
            return dataclasses.replace(it, expr=subst(it.expr), alias=alias)

        stmt = dataclasses.replace(
            stmt,
            items=tuple(merge_item(it) for it in stmt.items),
            relation=inner.relation,
            where=_and([inner.where, subst(stmt.where)]),
            group_by=gb,
            having=subst(stmt.having),
            order_by=tuple(dataclasses.replace(o, expr=subst(o.expr))
                           for o in stmt.order_by))
    return stmt
