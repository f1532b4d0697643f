"""Alias-scope resolution for correlated subqueries.

Port counterpart of ``spark_druid_olap_tpu/planner/scoping.py``: a copy kept
inside the PyTorch package, which imports nothing of the JAX package.

The engine binds columns by GLOBALLY-UNIQUE bare names, mirroring the
reference's star-schema contract (StarSchemaInfo.scala:127-165 requires
globally-unique column names; Spark's analyzer then resolves alias
qualifiers before the rewrite ever sees the plan). The parser therefore
stores ``s2.region`` as bare ``region`` — which silently mis-scopes a
correlated SELF-reference: in

    select .. from sales s
    where qty > (select avg(qty) from sales s2 where s2.region = s.region)

both sides collapse to ``region = region``, the subquery loses its free
variable, and the "correlation" becomes an always-true inner conjunct
(the subquery then computes ONE global aggregate — a wrong answer, not
an error).

This pass runs right after parsing, while :class:`ir.expr.Column` still
carries the written qualifier as non-comparing metadata. For every
subquery scope it detects outer-qualified references whose bare name
collides with a column of the subquery's own relation ("shadowed"), and
rewrites the scope capture-avoidingly: the inner relation is wrapped in
a derived table that RENAMES the shadowed columns, every inner-bound
reference follows the rename, and the outer reference keeps its bare
name — now genuinely free, so the existing decorrelation machinery
(planner/decorrelate.py, host_exec._execute_sub_decorrelated) applies
unchanged. This is exactly the manual workaround TPC-H q21 needed
before; published q21 text now parses and runs verbatim.

Scopes compose: each level renames only collisions with ITS own
relation; deeper scopes handle their own when the pass recurses.
Derived tables and CTE bodies are self-contained scopes (no LATERAL).
After resolution every qualifier is stripped, so downstream planning,
caching, and serde see exactly the bare-name trees they always did.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.sql import ast as A
from spark_druid_olap_tpu_torch.sql.lexer import SqlSyntaxError

_SUBQ = (A.ScalarSubquery, A.InSubquery, A.Exists)


def _rebuild_subqueries(e, on_query):
    """E.transform over ``e`` rebuilding each subquery node with
    ``on_query`` applied to its statement (InSubquery children recurse
    with the same rewriter) — the shared traversal of the strip and
    database-resolution passes."""
    def fn(n):
        if isinstance(n, A.ScalarSubquery):
            return A.ScalarSubquery(on_query(n.query))
        if isinstance(n, A.Exists):
            return A.Exists(on_query(n.query), n.negated)
        if isinstance(n, A.InSubquery):
            return A.InSubquery(_rebuild_subqueries(n.child, on_query),
                                on_query(n.query), n.negated)
        return n
    return E.transform(e, fn)


def resolve_alias_scopes(ctx, stmt):
    """Entry point: resolve qualifiers in a parsed statement tree and
    strip them. Idempotent; the qualifier-free common case returns the
    SAME object (one cheap walk, no rebuild) — this runs on the hot
    path of every statement."""
    if not _has_quals(stmt):
        return stmt
    if isinstance(stmt, A.UnionAll):
        return dataclasses.replace(
            stmt, parts=tuple(resolve_alias_scopes(ctx, p)
                              for p in stmt.parts),
            order_by=tuple(_strip_order(o) for o in stmt.order_by))
    if not isinstance(stmt, A.SelectStmt):
        return stmt
    out = _resolve_scope(ctx, stmt, outer=())
    return _strip_stmt(out)


def _has_quals(stmt) -> bool:
    if isinstance(stmt, A.UnionAll):
        return any(_has_quals(p) for p in stmt.parts) \
            or any(_expr_has_quals(o.expr) for o in stmt.order_by)
    if not isinstance(stmt, A.SelectStmt):
        return False
    for e in _iter_stmt_exprs(stmt):
        if _expr_has_quals(e):
            return True
    rel = stmt.relation
    stack = [rel]
    while stack:
        r = stack.pop()
        if isinstance(r, A.SubqueryRef) and _has_quals(r.query):
            return True
        if isinstance(r, A.Join):
            stack.extend((r.left, r.right))
    return False


def _expr_has_quals(e) -> bool:
    for n in E.walk(e):
        if isinstance(n, E.Column) and n.qual is not None:
            return True
        if isinstance(n, _SUBQ) and _has_quals(n.query):
            return True
    return False


# -- scope walk ---------------------------------------------------------------

def _relation_aliases(rel) -> frozenset:
    if rel is None:
        return frozenset()
    if isinstance(rel, A.TableRef):
        # an alias HIDES the table name (SQL scoping): 'from sales s2'
        # makes 'sales.region' an OUTER reference inside a subquery
        return frozenset({rel.alias or rel.name})
    if isinstance(rel, A.SubqueryRef):
        return frozenset({rel.alias})
    if isinstance(rel, A.Join):
        return _relation_aliases(rel.left) | _relation_aliases(rel.right)
    return frozenset()


def _try_columns(ctx, rel) -> Optional[frozenset]:
    from spark_druid_olap_tpu_torch.planner.host_exec import relation_columns
    try:
        return frozenset(relation_columns(ctx, rel))
    except Exception:  # noqa: BLE001 — unknown tables: resolve leniently
        return None


def _map_stmt_exprs(q: A.SelectStmt, f) -> A.SelectStmt:
    """Rebuild ``q`` with ``f`` applied to every top-level expression."""
    items = tuple(it if it.expr == "*"
                  else A.SelectItem(f(it.expr), it.alias) for it in q.items)
    where = None if q.where is None else f(q.where)
    having = None if q.having is None else f(q.having)
    gb = q.group_by
    if isinstance(gb, A.GroupingSets):
        gb = A.GroupingSets(tuple(tuple(f(e) for e in s) for s in gb.sets))
    elif gb is not None:
        gb = tuple(f(e) for e in gb)
    ob = tuple(A.OrderItem(f(o.expr), o.ascending) for o in q.order_by)
    return dataclasses.replace(q, items=items, where=where, group_by=gb,
                               having=having, order_by=ob)


def _map_relation(rel, f_query, f_expr=None):
    """Rebuild a relation tree: derived-table bodies through ``f_query``,
    Join ON conditions (expressions of the ENCLOSING scope) through
    ``f_expr``."""
    if isinstance(rel, A.SubqueryRef):
        return A.SubqueryRef(f_query(rel.query), rel.alias)
    if isinstance(rel, A.Join):
        cond = rel.condition
        if cond is not None and f_expr is not None:
            cond = f_expr(cond)
        return A.Join(_map_relation(rel.left, f_query, f_expr),
                      _map_relation(rel.right, f_query, f_expr),
                      rel.kind, cond)
    return rel


def _iter_relation_conditions(rel):
    """Join ON conditions in a relation tree (derived-table bodies are
    separate scopes and are NOT entered)."""
    if isinstance(rel, A.Join):
        if rel.condition is not None:
            yield rel.condition
        yield from _iter_relation_conditions(rel.left)
        yield from _iter_relation_conditions(rel.right)


def _equi_key_refs(rel):
    """(qualifier, column) pairs the JOIN LAYER binds by itself: the
    qualified columns of top-level AND-ed ``a.x = b.y`` equality keys in
    ON conditions. The downstream merge resolves these by qualifier and
    collapses the key pair into one output column, so for
    different-table joins they must not trigger a scope rename (and must
    stay exposed under their bare names)."""
    out = set()

    def eq_terms(c):
        if isinstance(c, E.And):
            for p in c.parts:
                eq_terms(p)
        elif (isinstance(c, E.Comparison) and c.op == "="
              and isinstance(c.left, E.Column)
              and isinstance(c.right, E.Column)
              and c.left.qual and c.right.qual):
            out.add((c.left.qual, c.left.name))
            out.add((c.right.qual, c.right.name))

    for cond in _iter_relation_conditions(rel):
        eq_terms(cond)
    return out


def _disambiguate_join_duplicates(ctx, q):
    """Same-scope duplicate-column joins (self-joins): columns bind by
    bare name, so ``t a join t b`` exposes every column of ``t`` twice
    and ``a.x < b.x`` would collapse to ``x < x`` (an unbound-column
    error at best, a silently-degenerate predicate at worst). Every
    duplicated TableRef leaf AFTER a column's first owner is wrapped in
    a derived table that RENAMES the duplicated columns REFERENCED
    THROUGH ITS QUALIFIER (pruned to the referenced set); those
    references follow the rename — nested subquery scopes that rebind
    the alias are left alone. Unqualified references keep the legacy
    bind-by-global-name behavior: the star-schema convention
    deliberately duplicates dimension columns between the flat index
    and its members (StarSchemaInfo's globally-unique-name contract),
    so ONLY qualifier-distinguished duplicates are rewritten. ≈ Spark's
    analyzer deduplicating attribute ids on self-join, which the
    reference's planner relies on upstream of its rewrites."""
    rel = q.relation
    if not isinstance(rel, A.Join):
        return q

    leaves = []

    def collect(r):
        if isinstance(r, A.Join):
            collect(r.left)
            collect(r.right)
        else:
            leaves.append(r)
    collect(rel)
    cols_of = [_try_columns(ctx, lf) or frozenset() for lf in leaves]
    from collections import Counter
    cnt = Counter()
    for cols in cols_of:
        cnt.update(cols)
    dup = {c for c, k in cnt.items() if k > 1}
    if not dup:
        return q
    # TRUE self-joins: the SAME base table appearing twice. Two
    # DIFFERENT tables sharing column names (t1 a join t2 b on a.id =
    # b.id) are the star-schema convention — their equi-join keys bind
    # by qualifier at the join layer (the merge collapses them), so ON
    # key references must neither rename nor star-raise there; only
    # duplicated columns referenced OUTSIDE the ON keys (a.x, b.x in
    # the select list) still need the rename to survive the merge's
    # bare-name suffixing.
    base_cnt = Counter(lf.name for lf in leaves
                       if isinstance(lf, A.TableRef))
    self_joined = {t for t, k in base_cnt.items() if k > 1}
    on_keys = _equi_key_refs(rel)

    # every referenced name in this scope (subquery expressions
    # included — they may reference our aliases); derived-table bodies
    # are separate scopes and contribute nothing
    refs: set = set()
    quals_used: set = set()

    def scan(e, nested=()):
        for n in E.walk(e):
            if isinstance(n, E.Column) and n.name != "*":
                refs.add(n.name)
                # a qualifier REBOUND by a nested FROM belongs to that
                # scope: 'exists (select 1 from u b where b.x ...)' must
                # not mark OUR leaf b's x as qualifier-referenced (the
                # same guard fix()/_fix_nested apply on the rewrite side)
                if n.qual and not any(n.qual in na for na in nested):
                    quals_used.add((n.qual, n.name))
            elif isinstance(n, _SUBQ):
                _scan_nested(n.query, nested)

    def _scan_nested(q2, nested):
        if isinstance(q2, A.UnionAll):
            for p in q2.parts:
                _scan_nested(p, nested)
            return
        if not isinstance(q2, A.SelectStmt):
            return
        nested2 = nested + (_relation_aliases(q2.relation),)
        for e2 in _iter_stmt_exprs(q2):
            scan(e2, nested2)
    for e in _iter_stmt_exprs(q):
        scan(e)                 # includes the join ON conditions

    alias_of = [lf.alias or getattr(lf, "name", None) for lf in leaves]
    seen: set = set()
    renmaps = []           # per leaf: {bare: renamed} (empty = unwrapped)
    owned_elsewhere = []   # per leaf: dup columns an EARLIER leaf owns
    for i, (lf, cols) in enumerate(zip(leaves, cols_of)):
        ren = {}
        if isinstance(lf, A.TableRef):
            if lf.name in self_joined:
                # a self-join duplicates EVERY column: any qualified
                # reference (ON keys included) needs the rename
                ren = {c: f"__sj{i}_{c}"
                       for c in sorted(cols & dup & seen)
                       if (alias_of[i], c) in quals_used}
            else:
                ren = {c: f"__sj{i}_{c}"
                       for c in sorted(cols & dup & seen)
                       if (alias_of[i], c) in quals_used
                       and (alias_of[i], c) not in on_keys}
        owned_elsewhere.append(cols & dup & seen)
        seen |= cols
        renmaps.append(ren)
    if not any(renmaps):
        return q
    for i, ren in enumerate(renmaps):
        if ren and alias_of.count(alias_of[i]) > 1:
            raise SqlSyntaxError(
                f"self-join of {alias_of[i]!r} needs DISTINCT aliases to "
                f"disambiguate its duplicated columns")

    star = any(it.expr == "*" or (isinstance(it.expr, E.Column)
                                  and it.expr.name == "*")
               for it in q.items)
    if star and any(ren and leaves[i].name in self_joined
                    for i, ren in enumerate(renmaps)):
        # SELECT * over a qualifier-disambiguated SELF-join is
        # ill-defined (the duplicated columns have no bare names to
        # expose) — require an explicit list, like the shadow rename.
        # Different-table joins never hit this: their renamed leaves
        # keep full exposure under star below.
        raise SqlSyntaxError(
            f"select * cannot combine with a self-join of "
            f"{sorted(self_joined)} that disambiguates duplicated "
            f"columns via aliases: list the needed columns explicitly "
            f"(qualified)")

    wrapped = {}
    for i, (lf, cols, ren) in enumerate(zip(leaves, cols_of, renmaps)):
        if not ren:
            continue
        # expose bare: referenced columns this leaf FIRST-owns (incl.
        # duplicated ones a LATER leaf shares — hiding those would
        # unbind a first-owner reference); plus the renamed duplicates
        # and the leaf's ON equi-keys (exposed bare so the merge can
        # collapse them). Duplicated columns an EARLIER leaf owns stay
        # unexposed unless renamed, so the bare copy binds that first
        # owner without a merge collision. Under star the leaf keeps
        # full exposure (pruning would silently shrink the star).
        on_i = {c for (al, c) in on_keys
                if al == alias_of[i] and c in cols}
        if star:
            used = sorted(cols)
        else:
            used = sorted(((refs & cols) - owned_elsewhere[i])
                          | set(ren) | on_i) or sorted(cols)[:1]
        body = A.SelectStmt(
            items=tuple(A.SelectItem(E.Column(c), ren.get(c, c))
                        for c in used),
            relation=A.TableRef(lf.name))
        wrapped[id(lf)] = A.SubqueryRef(body, alias=alias_of[i])
    ren_by_alias = {alias_of[i]: renmaps[i]
                    for i in range(len(leaves)) if renmaps[i]}

    def rebuild(r):
        if isinstance(r, A.Join):
            cond = r.condition
            if cond is not None:
                cond = fix(cond)
            return A.Join(rebuild(r.left), rebuild(r.right), r.kind,
                          cond)
        return wrapped.get(id(r), r)

    def fix(e, nested=()):
        def fn(n):
            if isinstance(n, A.ScalarSubquery):
                return A.ScalarSubquery(_fix_nested(n.query, nested))
            if isinstance(n, A.Exists):
                return A.Exists(_fix_nested(n.query, nested), n.negated)
            if isinstance(n, A.InSubquery):
                return A.InSubquery(fix(n.child, nested),
                                    _fix_nested(n.query, nested),
                                    n.negated)
            if isinstance(n, E.Column) and n.qual \
                    and n.qual in ren_by_alias \
                    and not any(n.qual in na for na in nested):
                new = ren_by_alias[n.qual].get(n.name)
                if new is not None:
                    return E.Column(new)
            return n
        return E.transform(e, fn)

    def _fix_nested(q2, nested):
        if isinstance(q2, A.UnionAll):
            return dataclasses.replace(
                q2, parts=tuple(_fix_nested(p, nested)
                                for p in q2.parts))
        if not isinstance(q2, A.SelectStmt):
            return q2
        nested2 = nested + (_relation_aliases(q2.relation),)
        f = lambda e: fix(e, nested2)   # noqa: E731
        rel2 = _map_relation(q2.relation, lambda s: s, f)
        if rel2 is not q2.relation:
            q2 = dataclasses.replace(q2, relation=rel2)
        return _map_stmt_exprs(q2, f)

    q = dataclasses.replace(q, relation=rebuild(rel))
    # unaliased projections keep the name the user WROTE: 'select
    # b.region' must come back as column 'region', not '__sj1_region'
    items = []
    for it in q.items:
        alias = it.alias
        if alias is None and isinstance(it.expr, E.Column) \
                and it.expr.qual in ren_by_alias \
                and it.expr.name in ren_by_alias[it.expr.qual]:
            alias = it.expr.name
        items.append(A.SelectItem(it.expr, alias))
    q = dataclasses.replace(q, items=tuple(items))
    return _map_stmt_exprs(q, fix)


def _resolve_scope(ctx, q, outer: Tuple[frozenset, ...]):
    """Resolve a SELECT scope: derived tables are fresh self-contained
    scopes; subquery expressions are nested scopes that see this one."""
    if isinstance(q, A.UnionAll):          # union-bodied derived table/CTE
        return dataclasses.replace(
            q, parts=tuple(_resolve_scope(ctx, p, outer)
                           for p in q.parts))
    q = _disambiguate_join_duplicates(ctx, q)
    aliases = _relation_aliases(q.relation)
    inner = outer + (aliases,)

    def fix(e):
        def fn(n):
            if isinstance(n, A.ScalarSubquery):
                return A.ScalarSubquery(_resolve_subscope(ctx, n.query,
                                                          inner))
            if isinstance(n, A.Exists):
                # EXISTS ignores its select list, so 'select *' in its
                # body is compatible with the shadow rename
                return A.Exists(_resolve_subscope(ctx, n.query, inner,
                                                  allow_star=True),
                                n.negated)
            if isinstance(n, A.InSubquery):
                return A.InSubquery(fix(n.child),
                                    _resolve_subscope(ctx, n.query, inner),
                                    n.negated)
            return n
        return E.transform(e, fn)

    rel = _map_relation(q.relation,
                        lambda sub: _resolve_scope(ctx, sub, ()), fix)
    if rel is not q.relation:
        q = dataclasses.replace(q, relation=rel)
    return _map_stmt_exprs(q, fix)


def _resolve_subscope(ctx, q, outer: Tuple[frozenset, ...],
                      allow_star: bool = False):
    """Resolve one correlated-capable subquery scope: rename shadowed
    self-references, then recurse."""
    if not isinstance(q, A.SelectStmt):
        return _resolve_scope(ctx, q, outer)
    aliases = _relation_aliases(q.relation)
    outer_names = frozenset().union(*outer) if outer else frozenset()
    inner_cols = _try_columns(ctx, q.relation)
    shadowed = _shadowed_names(ctx, q, aliases, inner_cols,
                               outer_names - aliases)
    if shadowed:
        q = _rename_shadowed(ctx, q, aliases, inner_cols, shadowed,
                             allow_star=allow_star)
    return _resolve_scope(ctx, q, outer)


def _shadowed_names(ctx, q, aliases, inner_cols, outer_names) -> frozenset:
    """Bare names referenced with a strictly-outer alias qualifier that
    collide with this scope's own relation columns."""
    if not inner_cols or not outer_names:
        return frozenset()
    out = set()

    def scan_stmt(q2, nested_aliases):
        for e in _iter_stmt_exprs(q2):
            scan_expr(e, nested_aliases)

    def scan_expr(e, nested_aliases):
        for n in E.walk(e):
            if isinstance(n, _SUBQ):
                scan_stmt(n.query, nested_aliases
                          | _relation_aliases(n.query.relation))
            elif isinstance(n, E.Column) and n.qual:
                if n.qual in nested_aliases or n.qual in aliases:
                    continue
                if n.qual in outer_names and n.name in inner_cols:
                    out.add(n.name)

    scan_stmt(q, frozenset())
    return frozenset(out)


def _iter_stmt_exprs(q: A.SelectStmt):
    for it in q.items:
        if it.expr != "*":
            yield it.expr
    if q.where is not None:
        yield q.where
    gb = q.group_by
    if isinstance(gb, A.GroupingSets):
        for s in gb.sets:
            yield from s
    elif gb is not None:
        yield from gb
    if q.having is not None:
        yield q.having
    for o in q.order_by:
        yield o.expr
    # Join ON conditions belong to THIS scope; derived-table bodies are
    # separate scopes and are not ours
    yield from _iter_relation_conditions(q.relation)


def _referenced_names(q) -> set:
    """Every column name mentioned anywhere in a statement, including
    nested subquery scopes (an over-approximation is safe: it only
    widens the pruned derived table)."""
    out = set()

    star = [False]

    def scan_stmt(q2, root=False):
        if isinstance(q2, A.UnionAll):       # union-bodied derived table
            for p in q2.parts:
                scan_stmt(p, root)
            return
        # SQL '*' never binds an OUTER scope: only the ROOT scope's own
        # star expands the relation being renamed; deeper scopes' stars
        # expand THEIR relations and are irrelevant here
        if root and any(it.expr == "*" for it in q2.items):
            star[0] = True
        for e in _iter_stmt_exprs(q2):
            scan_expr(e, root)
        rel = q2.relation
        stack = [rel]
        while stack:
            r = stack.pop()
            if isinstance(r, A.SubqueryRef):
                scan_stmt(r.query)
            elif isinstance(r, A.Join):
                stack.extend((r.left, r.right))

    def scan_expr(e, root):
        for n in E.walk(e):
            if isinstance(n, E.Column):
                if n.name == "*":
                    if root:
                        star[0] = True
                else:
                    out.add(n.name)
            elif isinstance(n, _SUBQ):
                scan_stmt(n.query)

    scan_stmt(q, root=True)
    return None if star[0] else out


def _rename_shadowed(ctx, q, aliases, inner_cols, shadowed,
                     allow_star: bool = False):
    """Capture-avoiding rewrite: wrap the inner relation in a derived
    table renaming the shadowed columns, redirect every inner-bound
    reference, and leave outer-qualified references bare (now free)."""
    if not isinstance(q.relation, A.TableRef):
        raise SqlSyntaxError(
            f"correlated reference to outer column(s) "
            f"{sorted(shadowed)} shadowed by the subquery's own FROM "
            f"(non-simple relation): rename the inner columns via a "
            f"derived table, e.g. (select c as c2 ... ) x")
    ren = {c: f"__sc_{c}" for c in sorted(shadowed)}
    t = q.relation
    # prune: expose only the inner columns the subquery actually
    # references (plus every shadowed one) — materializing the full
    # table width per correlated execution is the q21 hot path
    refs = _referenced_names(q)
    if refs is None:
        if not allow_star:
            # SELECT * in a value-producing scope would re-expose
            # renamed columns
            raise SqlSyntaxError(
                f"correlated reference to outer column(s) "
                f"{sorted(shadowed)} shadowed by the subquery's own FROM "
                f"cannot combine with SELECT *: list the needed columns "
                f"explicitly")
        # EXISTS body: its select list is semantically irrelevant —
        # expose every inner column (shadowed ones renamed)
        used = frozenset(inner_cols)
    else:
        used = (refs & inner_cols) | shadowed
    body = A.SelectStmt(
        items=tuple(A.SelectItem(E.Column(c), ren.get(c, c))
                    for c in sorted(used)),
        relation=A.TableRef(t.name))
    new_rel = A.SubqueryRef(body, alias=t.alias or t.name)

    def rename_stmt(q2, nested):
        # nested: ((aliases, cols-or-None), ...) for scopes between the
        # expression and this one
        f = lambda e: rename_expr(e, nested)  # noqa: E731
        rel2 = _map_relation(q2.relation, lambda s: s, f)
        if rel2 is not q2.relation:
            q2 = dataclasses.replace(q2, relation=rel2)
        return _map_stmt_exprs(q2, f)

    def rename_expr(e, nested):
        def fn(n):
            if isinstance(n, A.ScalarSubquery):
                return A.ScalarSubquery(rec(n.query, nested))
            if isinstance(n, A.Exists):
                return A.Exists(rec(n.query, nested), n.negated)
            if isinstance(n, A.InSubquery):
                return A.InSubquery(rename_expr(n.child, nested),
                                    rec(n.query, nested), n.negated)
            if not isinstance(n, E.Column) or n.name not in ren:
                return n
            if n.qual:
                if any(n.qual in na for na, _ in nested):
                    return n                      # binds a nested scope
                if n.qual in aliases:
                    return E.Column(ren[n.name])  # explicit inner ref
                return n                          # outer/unknown: free
            # unqualified: binds the nearest enclosing scope holding the
            # column — a nested scope that has it wins over ours
            for _, nc in nested:
                if nc is not None and n.name in nc:
                    return n
            return E.Column(ren[n.name])
        return E.transform(e, fn)

    def rec(q2, nested):
        na = _relation_aliases(q2.relation)
        nc = _try_columns(ctx, q2.relation)
        return rename_stmt(q2, nested + ((na, nc),))

    return dataclasses.replace(rename_stmt(q, ()), relation=new_rel)


# -- database-namespace resolution --------------------------------------------

def resolve_databases(ctx, stmt):
    """Rewrite unqualified table names to '<default_db>.<name>' when only
    the qualified form is registered (reference: multi-DB operation,
    MultiDBTest.scala — Hive database resolution ahead of the rewrite).
    Explicit 'db.table' names pass through; registered bare names win."""
    from spark_druid_olap_tpu_torch.utils.config import DATABASE_DEFAULT
    db = ctx.config.get(DATABASE_DEFAULT)
    if not db:
        return stmt
    known = set(ctx.store.names())

    def fix_rel(rel):
        if isinstance(rel, A.TableRef):
            if rel.name not in known and f"{db}.{rel.name}" in known:
                return A.TableRef(f"{db}.{rel.name}",
                                  rel.alias or rel.name)
            return rel
        if isinstance(rel, A.SubqueryRef):
            return A.SubqueryRef(fix_stmt(rel.query), rel.alias)
        if isinstance(rel, A.Join):
            cond = None if rel.condition is None \
                else fix_expr(rel.condition)   # ON may hold subqueries
            return A.Join(fix_rel(rel.left), fix_rel(rel.right),
                          rel.kind, cond)
        return rel

    def fix_expr(e):
        return _rebuild_subqueries(e, fix_stmt)

    def fix_stmt(q):
        if isinstance(q, A.UnionAll):
            return dataclasses.replace(
                q, parts=tuple(fix_stmt(p) for p in q.parts))
        if not isinstance(q, A.SelectStmt):
            return q
        if q.relation is not None:
            q = dataclasses.replace(q, relation=fix_rel(q.relation))
        return _map_stmt_exprs(q, fix_expr)

    return fix_stmt(stmt)


# -- qualifier strip ----------------------------------------------------------

def _strip_order(o: A.OrderItem) -> A.OrderItem:
    return A.OrderItem(_strip_expr(o.expr), o.ascending)


def _strip_expr(e):
    def fn(n):
        if isinstance(n, E.Column) and n.qual is not None:
            return E.Column(n.name)
        return n
    return E.transform(_rebuild_subqueries(e, _strip_stmt), fn)


def _strip_stmt(q):
    if isinstance(q, A.UnionAll):
        return dataclasses.replace(
            q, parts=tuple(_strip_stmt(p) for p in q.parts),
            order_by=tuple(_strip_order(o) for o in q.order_by))
    rel = _map_relation(q.relation, _strip_stmt, _strip_expr)
    if rel is not q.relation:
        q = dataclasses.replace(q, relation=rel)
    return _map_stmt_exprs(q, _strip_expr)
