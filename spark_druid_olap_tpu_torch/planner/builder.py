"""Pushdown builder: SelectStmt -> engine QuerySpec(s).

Port of ``spark_druid_olap_tpu/planner/builder.py``. Two places differ
from the JAX builder: the trial lowering that decides whether a filter
conjunct is pushed down (:meth:`Builder._spec_pushable`) runs the port's
lowering on zero CPU tensors instead of a JAX shape trace, and the
materialized-rollup rewrite raises (ROADMAP A.9) when rollups are
registered, since the port has no ``mv/`` yet.

The rewrite heart of the framework — merges the reference's planner stack:

- ``DruidPlanner.plan`` + transform pipeline (``DruidPlanner.scala:39-48``)
- project/filter translation (``ProjectFilterTransfom.scala``: native
  comparisons -> Selector/Bound, In -> InFilter, Like -> PatternFilter,
  fallback to compiled-expression filters ≈ the JS filter tier)
- time predicates -> query intervals (``DateTimeExtractor`` +
  ``QueryIntervals``)
- aggregate translation (``AggregateTransform.scala``: grouping exprs ->
  dimension specs with time/expr extractions, avg -> sum+count (+ post-agg
  division), count-distinct -> HLL ``cardinality`` (approx) or a two-phase
  exact rewrite ≈ ``SPLRewriteDistinctAggregates``)
- star-join collapse (``JoinTransform.scala``: validate the join tree against
  the declared star schema, then fold everything onto the flat datasource)
- sort/limit -> LimitSpec / TopN (``LimitTransfom`` + QuerySpecTransforms)

Raises :class:`PlanUnsupported` when the query can't push; the session then
runs the host path (≈ Spark executing the un-rewritten plan).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.ir import transforms as QT
from spark_druid_olap_tpu_torch.ir.intervals import IntervalAccumulator
from spark_druid_olap_tpu_torch.metadata.star import StarSchema
from spark_druid_olap_tpu_torch.planner.plans import (
    DistinctPhase2,
    PlannedQuery,
    PlanUnsupported,
)
from spark_druid_olap_tpu_torch.segment.column import ColumnKind
from spark_druid_olap_tpu_torch.sql import ast as A
from spark_druid_olap_tpu_torch.utils import phases as PH
from spark_druid_olap_tpu_torch.utils.config import NON_AGG_PUSHDOWN

_TIME_FIELD_FUNCS = {"year", "month", "quarter", "day", "week", "dow", "doy",
                     "hour", "minute", "second"}


def _has_subquery(e) -> bool:
    if e is None or isinstance(e, str):
        return False
    for n in E.walk(e):
        if isinstance(n, (A.ScalarSubquery, A.InSubquery, A.Exists)):
            return True
    return False


def _stmt_has_subquery(stmt: A.SelectStmt) -> bool:
    for item in stmt.items:
        if item.expr != "*" and _has_subquery(item.expr):
            return True
    if _has_subquery(stmt.where) or _has_subquery(stmt.having):
        return True
    gb = stmt.group_by
    groups = []
    if isinstance(gb, tuple):
        groups = list(gb)
    elif isinstance(gb, A.GroupingSets):
        groups = [g for s in gb.sets for g in s]
    for g in groups:
        if _has_subquery(g):
            return True
    for o in stmt.order_by:
        if _has_subquery(o.expr):
            return True
    return False


def _split_conjuncts(e: Optional[E.Expr]) -> List[E.Expr]:
    if e is None:
        return []
    if isinstance(e, E.And):
        out = []
        for p in e.parts:
            out.extend(_split_conjuncts(p))
        return out
    return [e]


class Builder:
    def __init__(self, ctx, stmt: A.SelectStmt):
        self.ctx = ctx
        self.stmt = stmt
        self.ds = None                      # Datasource
        self.hidden: Set[str] = set()
        self._aggs: Dict[str, S.AggregationSpec] = {}   # by output name
        self._agg_by_call: Dict[str, str] = {}          # AggCall sql -> name
        self._post: Dict[str, S.PostAggregationSpec] = {}
        self._dim_specs: List[S.DimensionSpec] = []
        self._dim_by_expr: Dict[str, str] = {}          # expr sql -> out name
        self._n = 0
        self.distinct2: Optional[DistinctPhase2] = None

    def fresh(self, prefix: str) -> str:
        self._n += 1
        return f"__{prefix}{self._n}"

    # =========================================================================
    # relation resolution / star-join collapse
    # =========================================================================
    def resolve_relation(self) -> Tuple[str, List[E.Expr]]:
        """Returns (datasource name, join equi-conjunct predicates consumed
        from WHERE)."""
        rel = self.stmt.relation
        if rel is None:
            raise PlanUnsupported("no FROM clause")
        tables: List[str] = []
        join_conds: List[E.Expr] = []

        def walk(r):
            if isinstance(r, A.TableRef):
                tables.append(r.name)
            elif isinstance(r, A.Join):
                if r.kind not in ("inner", "cross"):
                    raise PlanUnsupported(f"{r.kind} join")
                walk(r.left)
                walk(r.right)
                if r.condition is not None:
                    join_conds.extend(_split_conjuncts(r.condition))
            else:
                raise PlanUnsupported("derived table in FROM")

        walk(rel)
        store = self.ctx.store
        if len(tables) == 1:
            t = tables[0]
            star = self.ctx.catalog.star_schema_of(t)
            if t in store.names():
                return t, []
            if star is not None and star.flat_datasource in store.names():
                return star.flat_datasource, []
            raise PlanUnsupported(f"unknown table {t!r}")

        # multi-table: must be a star join against SOME registered star
        # (shared dim tables can belong to several stars — e.g. supplier in
        # both the lineitem and partsupp stars; try each candidate and keep
        # the one whose fact anchors this join tree)
        with PH.phase("plan.star"):
            cands: List[StarSchema] = []
            for t in tables:
                for s in self.ctx.catalog.star_schemas_of(t):
                    if s not in cands:
                        cands.append(s)
            if not cands:
                raise PlanUnsupported("join without a registered star schema")
            where_conjs = _split_conjuncts(self.stmt.where)
            errors: List[str] = []
            for star in cands:
                r = self._try_star(star, tables, join_conds, where_conjs,
                                   store)
                if isinstance(r, tuple):
                    return r
                errors.append(r)
            raise PlanUnsupported("; ".join(dict.fromkeys(errors)))

    def _try_star(self, star: StarSchema, tables, join_conds, where_conjs,
                  store):
        """Validate the join tree against one candidate star; returns
        (flat_datasource, consumed_predicates) or an error string."""
        eq_pairs: List[Tuple[str, str]] = []
        consumed: List[E.Expr] = []
        star_cols = self._star_key_columns(star)
        for c in join_conds + where_conjs:
            if (isinstance(c, E.Comparison) and c.op == "=" and
                    isinstance(c.left, E.Column) and
                    isinstance(c.right, E.Column)):
                pair = (c.left.name, c.right.name)
                if frozenset(pair) in star_cols:
                    eq_pairs.append(pair)
                    consumed.append(c)
                    continue
            if c in join_conds:
                return f"non-star join condition ({E.to_sql(c)})"
        if star.fact_table not in tables:
            # a dim-only join has dim-table grain; folding it onto the flat
            # fact would change row multiplicity (the reference likewise
            # anchors every rewrite at the fact DruidRelation leaf,
            # JoinTransform.scala:305-385)
            return "join does not include the fact table"
        if not star.is_star_join(set(tables), eq_pairs):
            return "join tree is not a sub-star of the declared star schema"
        if star.flat_datasource not in store.names():
            return "star schema flat datasource not ingested"
        return star.flat_datasource, consumed

    @staticmethod
    def _star_key_columns(star: StarSchema) -> Set[frozenset]:
        out = set()
        for r in star.relations:
            for lc, rc in r.join_columns:
                out.add(frozenset((lc, rc)))
        return out

    # =========================================================================
    # filters
    # =========================================================================
    def build_filter(self, conjuncts: List[E.Expr]):
        """conjuncts -> (intervals, FilterSpec, residue).

        Pushable conjuncts become intervals / native filters / compiled
        expression filters; a conjunct whose compiled form the device
        compiler rejects (checked by a shape-only trial trace of the REAL
        lowering) is returned as host residue instead of failing the whole
        plan — ≈ the reference recording unpushed predicates and leaving a
        Spark FilterExec above the Druid scan
        (ProjectFilterTransfom.addUnpushedAttributes:36-50,
        DruidStrategy.scala:244-270).
        """
        from spark_druid_olap_tpu_torch.utils.config import TZ_ID
        acc = IntervalAccumulator(tz=self.ctx.config.get(TZ_ID))
        specs: List[S.FilterSpec] = []
        residue: List[E.Expr] = []
        tcol = self.ds.time.name if self.ds.time is not None else None
        for c in conjuncts:
            if isinstance(c, E.Literal):
                if c.value is True:
                    continue  # inlined EXISTS etc. — constant true
                specs.append(S.ExprFilter(E.Literal(False)))
                continue
            if not E.columns_in(c):
                # column-free conjunct (e.g. the Kleene NULL-list
                # encoding fully folded): 3VL constant-fold at plan
                # time — it must act at SCAN level, never as a
                # post-aggregation residual (which would drop the
                # global identity row)
                from spark_druid_olap_tpu_torch.utils import host_eval as HEv
                try:
                    keep = bool(HEv.eval_pred3(c, {}).all())
                except Exception:  # noqa: BLE001 — leave to lowering
                    keep = None
                if keep is True:
                    continue
                if keep is False:
                    specs.append(S.ExprFilter(E.Literal(False)))
                    continue
            if tcol is not None and self._try_interval(c, tcol, acc):
                continue
            try:
                spec = self.to_filter(c)
            except PlanUnsupported:
                residue.append(c)
                continue
            if self._has_expr_filter(spec) and \
                    not self._spec_pushable(spec):
                residue.append(c)
                continue
            specs.append(spec)
        if acc.empty:
            # contradiction: empty interval (executor prunes everything)
            return ((0, 0),), S.filter_and(specs), residue
        return acc.to_intervals(), S.filter_and(specs), residue

    @staticmethod
    def _has_expr_filter(spec: S.FilterSpec) -> bool:
        if isinstance(spec, S.ExprFilter):
            return True
        if isinstance(spec, S.LogicalFilter):
            return any(Builder._has_expr_filter(x) for x in spec.fields)
        return False

    def _spec_pushable(self, spec: S.FilterSpec) -> bool:
        """Trial of the real filter lowering on ``(1, 8)`` zero tensors
        on the CPU, with the scan's dtypes: it launches nothing on the
        card and moves no data. The rejections the JAX lowering also
        gives (``Unsupported``, ``EngineFallback``, an unknown column, a
        dtype or shape error) make the conjunct host residue; a
        ``NotImplementedError`` (a lowering the port has not ported)
        propagates, so an unported path is never hidden as residue."""
        import numpy as np
        import torch
        from spark_druid_olap_tpu_torch.ops import expr_compile as EC
        from spark_druid_olap_tpu_torch.ops import filters as F
        from spark_druid_olap_tpu_torch.ops.scan import (
            ScanContext, array_dtype, array_names)
        from spark_druid_olap_tpu_torch.parallel.executor import (
            EngineFallback)
        ds = self.ds
        try:
            cols = sorted(c for c in F.columns_of_filter(spec)
                          if c in ds.dims or c in ds.metrics
                          or (ds.time is not None and c == ds.time.name))
            names = array_names(ds, cols, ds.time is not None)
            arrays = {k: torch.from_numpy(
                np.zeros((1, 8), dtype=array_dtype(ds, k))) for k in names}
            F.lower_filter(spec, ScanContext(ds, arrays, 0, 0))
            return True
        except NotImplementedError:
            raise
        except (EC.Unsupported, EngineFallback, KeyError, TypeError,
                ValueError, IndexError, RuntimeError):
            return False

    def _try_interval(self, c: E.Expr, tcol: str,
                      acc: IntervalAccumulator) -> bool:
        def lit_of(e):
            if isinstance(e, E.Literal) and not isinstance(e.value, bool):
                return e.value
            return None

        if isinstance(c, E.Comparison):
            l, r = c.left, c.right
            if isinstance(l, E.Column) and l.name == tcol and \
                    lit_of(r) is not None:
                v = lit_of(r)
                op = c.op
            elif isinstance(r, E.Column) and r.name == tcol and \
                    lit_of(l) is not None:
                v = lit_of(l)
                op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(c.op,
                                                                     c.op)
            else:
                return False
            try:
                if op == ">=":
                    acc.ge(v)
                elif op == ">":
                    acc.gt(v)
                elif op == "<=":
                    acc.le(v)
                elif op == "<":
                    acc.lt(v)
                elif op == "=":
                    acc.eq(v)
                else:
                    return False
            except (ValueError, TypeError):
                return False
            return True
        if isinstance(c, E.Between) and not c.negated and \
                isinstance(c.child, E.Column) and c.child.name == tcol:
            lo, hi = lit_of(c.low), lit_of(c.high)
            if lo is None or hi is None:
                return False
            acc.ge(lo)
            acc.le(hi)
            return True
        return False

    def to_filter(self, e: E.Expr) -> S.FilterSpec:
        """Expr -> FilterSpec, preferring native filters, falling back to
        compiled-expression filters (≈ the JS filter tier)."""
        if isinstance(e, E.Comparison):
            f = self._native_comparison(e)
            if f is not None:
                return f
            return S.ExprFilter(e)
        if isinstance(e, E.And):
            return S.LogicalFilter(
                "and", tuple(self.to_filter(p) for p in e.parts))
        if isinstance(e, E.Or):
            return S.LogicalFilter(
                "or", tuple(self.to_filter(p) for p in e.parts))
        if isinstance(e, E.Not):
            return self._kleene_not(self.to_filter(e.child), e.child)
        if isinstance(e, E.IsNull):
            if isinstance(e.child, E.Column):
                return S.NullFilter(e.child.name, negated=e.negated)
            return S.ExprFilter(e)
        if isinstance(e, E.InList) and isinstance(e.child, E.Column):
            kind = self._col_kind(e.child.name)
            if isinstance(e.values, E.FrozenIntSet):
                if kind not in (ColumnKind.LONG, ColumnKind.DATE):
                    raise PlanUnsupported(
                        "large integer IN set over non-integer column")
                f = S.InFilter(e.child.name, e.values)
            elif kind == ColumnKind.DIM:
                f = S.InFilter(e.child.name,
                               tuple(str(v) for v in e.values))
            else:
                f = S.InFilter(e.child.name, tuple(e.values))
            return self._kleene_not(f, e) if e.negated else f
        if isinstance(e, E.Between) and isinstance(e.child, E.Column):
            kind = self._col_kind(e.child.name)
            lo = e.low.value if isinstance(e.low, E.Literal) else None
            hi = e.high.value if isinstance(e.high, E.Literal) else None
            if lo is not None and hi is not None:
                f = S.BoundFilter(e.child.name, lower=lo, upper=hi,
                                  numeric=kind in (ColumnKind.LONG,
                                                   ColumnKind.DOUBLE))
                return self._kleene_not(f, e) if e.negated else f
            return S.ExprFilter(e)
        if isinstance(e, E.Like) and isinstance(e.child, E.Column) and \
                self._col_kind(e.child.name) == ColumnKind.DIM:
            f = S.PatternFilter(e.child.name, "like", e.pattern)
            return self._kleene_not(f, e) if e.negated else f
        return S.ExprFilter(e)

    def _kleene_not(self, inner: S.FilterSpec, negated_expr: E.Expr):
        """SQL NOT with Kleene null semantics: a NULL operand keeps the
        predicate UNKNOWN (never TRUE), so the negation carries IS NOT
        NULL guards for every NULLABLE column it negates over — columns
        under IS [NOT] NULL or KeyedLookup subtrees excepted (those
        predicates are never UNKNOWN / handle their own misses).
        Planner-generated negations are BOOLEAN by construction: the
        decorrelation pass only inlines lookups under polarity-checked
        positions (its generated predicates are False on miss/NULL), so
        any lookup under the negation means the 3VL analysis already
        happened — plain boolean not there.

        The guard equivalence 'NOT(P) is UNKNOWN iff a referenced
        column is NULL' is EXACT only for a single column-vs-literal
        predicate; for compound children (NOT(U AND F) is TRUE, but a
        blanket guard would drop the row) the conjunct goes to the host
        tier when nullable columns are involved (eval_pred3 is a full
        Kleene evaluator)."""
        if any(isinstance(n, (E.KeyedLookup, E.KeyedLookup2))
               for n in E.walk(negated_expr)):
            return S.LogicalFilter("not", (inner,))
        nullable = sorted(
            c for c in self._cols_outside_isnull(negated_expr)
            if (col := self.ds.dims.get(c) or self.ds.metrics.get(c))
            is not None and col.validity is not None)
        if not nullable:
            return S.LogicalFilter("not", (inner,))
        if not self._simple_negatable(negated_expr):
            raise PlanUnsupported(
                "NOT over a compound predicate with nullable columns "
                "(Kleene semantics need the host evaluator)")
        return S.LogicalFilter(
            "and", (S.LogicalFilter("not", (inner,)),)
            + tuple(S.NullFilter(c, negated=True) for c in nullable))

    @staticmethod
    def _cols_outside_isnull(e: E.Expr) -> Set[str]:
        out: Set[str] = set()

        def rec(n):
            if isinstance(n, E.IsNull):
                return
            if isinstance(n, E.Column):
                out.add(n.name)
            for ch in n.children():
                rec(ch)

        rec(e)
        return out

    @staticmethod
    def _simple_negatable(e: E.Expr) -> bool:
        """One column-vs-literal predicate: its UNKNOWN-ness is exactly
        'the column is NULL', so the IS NOT NULL guard is lossless."""
        def col_or_lit(x):
            return isinstance(x, (E.Column, E.Literal))

        if isinstance(e, E.Comparison):
            return col_or_lit(e.left) and col_or_lit(e.right)
        if isinstance(e, (E.InList, E.Like)):
            return isinstance(e.child, E.Column)
        if isinstance(e, E.Between):
            return isinstance(e.child, E.Column) \
                and col_or_lit(e.low) and col_or_lit(e.high)
        return False

    def _col_kind(self, name: str) -> Optional[ColumnKind]:
        try:
            return self.ds.column_kind(name)
        except KeyError:
            raise PlanUnsupported(f"unknown column {name!r}")

    def _native_comparison(self, c: E.Comparison) -> Optional[S.FilterSpec]:
        l, r = c.left, c.right
        op = c.op
        if isinstance(r, E.Column) and isinstance(l, E.Literal):
            l, r = r, l
            op = E.FLIP_CMP.get(op, op)
        if not (isinstance(l, E.Column) and isinstance(r, E.Literal)):
            return None
        kind = self._col_kind(l.name)
        v = r.value
        if v is None and op != "=":
            # NULL comparison is three-valued-unknown -> matches nothing
            return S.ExprFilter(E.Literal(False))
        if kind == ColumnKind.TIME:
            return None  # handled via intervals or ExprFilter
        numeric = kind in (ColumnKind.LONG, ColumnKind.DOUBLE)
        if op == "=":
            return S.SelectorFilter(l.name, None if v is None else str(v)) \
                if kind == ColumnKind.DIM else \
                S.BoundFilter(l.name, lower=v, upper=v, numeric=numeric)
        if op == "!=":
            inner = self._native_comparison(E.Comparison("=", l, r))
            nn = S.NullFilter(l.name, negated=True)
            return S.LogicalFilter("and",
                                   (S.LogicalFilter("not", (inner,)), nn))
        if op in ("<", "<=", ">", ">="):
            if op in (">", ">="):
                return S.BoundFilter(l.name, lower=v,
                                     lower_strict=(op == ">"),
                                     numeric=numeric)
            return S.BoundFilter(l.name, upper=v,
                                 upper_strict=(op == "<"), numeric=numeric)
        return None

    # =========================================================================
    # dimensions
    # =========================================================================
    def to_dimension(self, e: E.Expr, name: str) -> S.DimensionSpec:
        if isinstance(e, E.Column):
            kind = self._col_kind(e.name)
            if kind == ColumnKind.TIME:
                raise PlanUnsupported("group by raw timestamp")
            return S.DimensionSpec(e.name, name)
        if isinstance(e, E.Func) and e.name.lower() in _TIME_FIELD_FUNCS \
                and len(e.args) == 1 and isinstance(e.args[0], E.Column):
            return S.DimensionSpec(e.args[0].name, name,
                                   S.TimeExtraction(e.name.lower()))
        if isinstance(e, E.Func) and e.name.lower() in ("date_trunc", "trunc") \
                and isinstance(e.args[0], E.Literal) \
                and isinstance(e.args[1], E.Column):
            grain = str(e.args[0].value).lower()
            if grain in ("year", "quarter", "month", "week", "day"):
                return S.DimensionSpec(e.args[1].name, name,
                                       S.TimeExtraction("trunc_" + grain))
        if isinstance(e, E.Func) and e.name == "__lookup_pairs" \
                and isinstance(e.args[0], E.Column) \
                and isinstance(e.args[1], E.Literal):
            return S.DimensionSpec(e.args[0].name, name,
                                   S.LookupExtraction(tuple(e.args[1].value)))
        if isinstance(e, E.Func) and e.name.lower() == "regexp_extract" \
                and isinstance(e.args[0], E.Column) \
                and all(isinstance(a, E.Literal) for a in e.args[1:]):
            idx = int(e.args[2].value) if len(e.args) > 2 else 1
            return S.DimensionSpec(
                e.args[0].name, name,
                S.RegexExtraction(str(e.args[1].value), idx,
                                  replace_missing=True))
        return S.DimensionSpec(self._expr_dim_source(e), name,
                               S.ExprExtraction(e))

    def _expr_dim_source(self, e: E.Expr) -> str:
        cols = sorted(E.columns_in(e))
        if not cols:
            raise PlanUnsupported(f"constant group expression {E.to_sql(e)}")
        return cols[0]

    # =========================================================================
    # aggregations
    # =========================================================================
    def agg_for_call(self, call: E.AggCall) -> str:
        """Register an AggregationSpec (or avg/distinct decomposition) for an
        AggCall; returns the output column name carrying its value."""
        key = E.to_sql(call)
        if key in self._agg_by_call:
            return self._agg_by_call[key]
        name = self._agg_output_name(call)
        if call.fn == "sum" and isinstance(call.arg, E.Literal) \
                and isinstance(call.arg.value, (int, float)) \
                and not isinstance(call.arg.value, bool) \
                and not call.distinct:
            # sum(lit) == count(*) * lit (≈ SumOfLiteralRewrite,
            # DruidLogicalOptimizer.scala:245-302); over zero rows SQL's
            # SUM is NULL, not 0, so guard on the count
            c = self.fresh("cnt")
            self._register_agg(E.AggCall("count", None), c)
            self._post[name] = S.PostAggregationSpec(
                name, E.Case(
                    ((E.Comparison("=", E.Column(c), E.Literal(0)),
                      E.Literal(float("nan"))),),
                    E.BinaryOp("*", E.Column(c), call.arg)))
            self.hidden.add(c)
            self._agg_by_call[key] = name
            return name
        if call.fn == "avg":
            s = self.fresh("sum")
            c = self.fresh("cnt")
            self._register_agg(E.AggCall("sum", call.arg), s)
            self._register_agg(E.AggCall("count", call.arg), c)
            self._post[name] = S.PostAggregationSpec(
                name, E.BinaryOp("/", E.Column(s), E.Column(c)))
            self.hidden.add(s)
            self.hidden.add(c)
            self._agg_by_call[key] = name
            return name
        if call.distinct and call.fn == "count":
            if call.approx:
                self._register_cardinality(call, name)
                self._agg_by_call[key] = name
                return name
            self._plan_exact_distinct(call, name)
            self._agg_by_call[key] = name
            return name
        if call.fn == "theta":
            if not isinstance(call.arg, E.Column):
                raise PlanUnsupported("theta sketch over expression")
            self._aggs[name] = S.AggregationSpec("thetasketch", name,
                                                 field=call.arg.name)
            self._agg_by_call[key] = name
            return name
        if call.fn == "percentile":
            if not isinstance(call.arg, E.Column):
                raise PlanUnsupported("percentile_approx over expression")
            kind = self._col_kind(call.arg.name)
            if kind not in (ColumnKind.LONG, ColumnKind.DOUBLE):
                raise PlanUnsupported(
                    "percentile_approx over non-numeric column")
            self._aggs[name] = S.AggregationSpec(
                "quantile", name, field=call.arg.name,
                fraction=call.fraction)
            self._agg_by_call[key] = name
            return name
        if call.distinct:
            raise PlanUnsupported(f"distinct {call.fn}")
        self._register_agg(call, name)
        self._agg_by_call[key] = name
        return name

    def _agg_output_name(self, call: E.AggCall) -> str:
        # prefer the select alias when the item is exactly this agg
        for item in self.stmt.items:
            if item.expr == call and item.alias:
                return item.alias
        return self.fresh(call.fn)

    def _register_agg(self, call: E.AggCall, name: str):
        arg = call.arg
        filt = None
        if call.fn == "count":
            if arg is None:
                self._aggs[name] = S.AggregationSpec("count", name)
                return
            if isinstance(arg, E.Column):
                col = self.ds.dims.get(arg.name) or \
                    self.ds.metrics.get(arg.name)
                if col is not None and col.validity is not None:
                    filt = S.NullFilter(arg.name, negated=True)
                self._aggs[name] = S.AggregationSpec("count", name,
                                                     filter=filt)
                return
            self._aggs[name] = S.AggregationSpec("count", name)
            return
        if call.fn not in ("sum", "min", "max"):
            raise PlanUnsupported(f"aggregate {call.fn}")
        if isinstance(arg, E.Column):
            kind = self._col_kind(arg.name)
            if kind == ColumnKind.DIM:
                k = "doublesum" if call.fn == "sum" else f"double{call.fn}"
                self._aggs[name] = S.AggregationSpec(k, name, field=arg.name)
                return
            if kind == ColumnKind.DATE and call.fn in ("min", "max"):
                raise PlanUnsupported("min/max over date column")
            prefix = "long" if kind in (ColumnKind.LONG,) else "double"
            self._aggs[name] = S.AggregationSpec(f"{prefix}{call.fn}", name,
                                                 field=arg.name)
            return
        # computed input
        self._aggs[name] = S.AggregationSpec(
            "doublesum" if call.fn == "sum" else f"double{call.fn}",
            name, expr=arg)

    def _plan_exact_distinct(self, call: E.AggCall, name: str):
        if self.distinct2 is not None:
            raise PlanUnsupported("multiple exact count-distincts")
        if not isinstance(call.arg, E.Column):
            raise PlanUnsupported("count(distinct <expr>)")
        dimname = self.fresh("dd")
        self._dim_specs.append(self.to_dimension(call.arg, dimname))
        self._dim_by_expr[E.to_sql(call.arg)] = self._dim_by_expr.get(
            E.to_sql(call.arg), dimname)
        self.distinct2 = DistinctPhase2(
            group_cols=[], distinct_out=name, distinct_dim=dimname,
            other_aggs={})

    # cardinality agg for approx distinct
    def _register_cardinality(self, call: E.AggCall, name: str):
        if not isinstance(call.arg, E.Column):
            raise PlanUnsupported("approx_count_distinct(<expr>)")
        self._aggs[name] = S.AggregationSpec("cardinality", name,
                                             field=call.arg.name)

    # =========================================================================
    # the main build
    # =========================================================================
    def build(self) -> PlannedQuery:
        stmt = self.stmt
        if _stmt_has_subquery(stmt):
            raise PlanUnsupported("subquery")
        # the session's window post-pass strips WindowCalls before
        # planning; one surviving here (derived table / assisted subtree)
        # can't be pushed
        for item in stmt.items:
            if item.expr != "*" and any(
                    isinstance(n, E.WindowCall) for n in E.walk(item.expr)):
                raise PlanUnsupported("window function in a subtree")
        ds_name, consumed = self.resolve_relation()
        self.ds = self.ctx.store.get(ds_name)

        # WHERE minus consumed join conjuncts
        conjs = [c for c in _split_conjuncts(stmt.where)
                 if not any(c is k for k in consumed)]
        intervals, filter_spec, residue = self.build_filter(conjs)
        filter_spec = QT.merge_spatial_bounds(filter_spec, self.ds)
        self._residue = residue

        # resolve group-by expressions
        alias_map = {item.alias: item.expr for item in stmt.items
                     if item.alias and item.expr != "*"}
        if isinstance(stmt.group_by, A.GroupingSets):
            raw_sets = [list(s) for s in stmt.group_by.sets]
        elif stmt.group_by is None:
            raw_sets = [[]]
        else:
            raw_sets = [list(stmt.group_by)]

        def resolve_g(g):
            if isinstance(g, E.Literal) and isinstance(g.value, int):
                it = stmt.items[g.value - 1]
                if it.expr == "*":
                    raise PlanUnsupported("GROUP BY ordinal of *")
                return it.expr
            if isinstance(g, E.Column) and g.name in alias_map:
                return alias_map[g.name]
            return g

        resolved_sets = [[resolve_g(g) for g in s] for s in raw_sets]

        is_agg = stmt.group_by is not None or any(
            item.expr != "*" and E.agg_calls_in(item.expr)
            for item in stmt.items)
        if stmt.having is not None:
            is_agg = True

        if not is_agg:
            return self._build_select_path(ds_name, intervals, filter_spec,
                                           residue)

        # dims for the union of group exprs
        for s_ in resolved_sets:
            for g in s_:
                k = E.to_sql(g)
                if k in self._dim_by_expr:
                    continue
                name = None
                for item in stmt.items:
                    if item.expr == g:
                        name = item.alias or (
                            g.name if isinstance(g, E.Column) else None)
                        break
                if name is None and isinstance(g, E.Column):
                    name = g.name
                if name is None:
                    name = self.fresh("g")
                self._dim_by_expr[k] = name
                self._dim_specs.append(self.to_dimension(g, name))

        # FD demotion: a plain grouping column functionally determined by
        # another grouping column leaves the fused key and becomes an
        # 'anyvalue' aggregation (≈ FunctionalDependencies keeping the group
        # key small; critical for TPC-H Q3/Q10-style keys+attributes groups)
        if len(resolved_sets) == 1 and len(self._dim_specs) > 1:
            g = self.ctx.catalog.fd_graph_for(ds_name, self.ctx.store)
            if g is not None:
                plain = [d for d in self._dim_specs if d.extraction is None]

                def demoted(d, i):
                    # any OTHER plain dim determines d -> d leaves the key;
                    # mutually-determining pairs (1-1) keep the earlier one
                    for j, k in enumerate(plain):
                        if k is d or not g.determines(k.dimension,
                                                     d.dimension):
                            continue
                        if g.determines(d.dimension, k.dimension) and \
                                plain.index(d) < j:
                            continue
                        return True
                    return False

                kept: List[S.DimensionSpec] = []
                attached: List[S.DimensionSpec] = []
                for i, d in enumerate(self._dim_specs):
                    if d.extraction is None and demoted(d, i):
                        attached.append(d)
                    else:
                        kept.append(d)
                for d in attached:
                    self._aggs[d.output_name] = S.AggregationSpec(
                        "anyvalue", d.output_name, field=d.dimension)
                self._dim_specs = kept

        # WHERE residue over an aggregate: sound only when every residue
        # column is a grouping column present in EVERY grouping set (then
        # filtering result groups == filtering source rows); map source
        # names onto dim output names for the host-side evaluation
        residual_expr = None
        if self._residue:
            out_of = {}
            for c in set().union(*(E.columns_in(r) for r in self._residue)):
                k = E.to_sql(E.Column(c))
                if k not in self._dim_by_expr:
                    raise PlanUnsupported(
                        f"unpushable predicate over non-grouped column {c}")
                out_of[c] = self._dim_by_expr[k]
                for s_ in resolved_sets:
                    if not any(E.to_sql(g) == k for g in s_):
                        raise PlanUnsupported(
                            "unpushable predicate over a column absent "
                            "from one grouping set")
            combined = self._residue[0] if len(self._residue) == 1 \
                else E.And(tuple(self._residue))

            def ren(n):
                if isinstance(n, E.Column) and n.name in out_of:
                    return E.Column(out_of[n.name])
                return n
            residual_expr = E.transform(combined, ren)

        # select outputs
        output_columns: List[str] = []
        for i, item in enumerate(stmt.items):
            if item.expr == "*":
                raise PlanUnsupported("SELECT * in aggregate query")
            out = self._plan_output_item(item, i)
            output_columns.append(out)

        # HAVING
        having_spec = None
        if stmt.having is not None:
            h = self._replace_aggs_and_dims(stmt.having)
            having_spec = S.HavingSpec(h)

        # ORDER BY / LIMIT
        order_by: List[Tuple[str, bool]] = []
        for o in stmt.order_by:
            order_by.append((self._order_col(o, output_columns), o.ascending))

        multi_set = len(resolved_sets) > 1
        limit_spec = None
        order_in_spec = False
        if not multi_set and self.distinct2 is None \
                and residual_expr is None and (order_by or stmt.limit):
            # an in-spec limit would truncate before the host residue runs
            limit_spec = S.LimitSpec(
                tuple(S.OrderByColumn(n, asc) for n, asc in order_by),
                stmt.limit)
            order_in_spec = True

        if stmt.distinct:
            raise PlanUnsupported("SELECT DISTINCT with aggregation")

        # assemble one spec per grouping set
        specs = []
        spec_dims = []
        aggs = tuple(self._aggs.values())
        posts = tuple(self._post.values())
        deferred_posts = []
        if self.distinct2 is not None:
            if having_spec is not None:
                raise PlanUnsupported("HAVING with exact count-distinct")
            # post-aggs must evaluate after the phase-2 merge
            deferred_posts = list(posts)
            posts = ()
        rollup_used = None
        for s_ in resolved_sets:
            set_dim_names = [self._dim_by_expr[E.to_sql(g)] for g in s_]
            dimlist = [d for d in self._dim_specs
                       if d.output_name in set_dim_names
                       or d.output_name == (self.distinct2.distinct_dim
                                            if self.distinct2 else None)]
            q = S.GroupByQuerySpec(
                datasource=ds_name, dimensions=tuple(dimlist),
                aggregations=aggs, post_aggregations=posts,
                filter=filter_spec, having=having_spec,
                limit=limit_spec if not multi_set else None,
                intervals=intervals)
            # materialized-rollup rewrite, BEFORE spec transforms so a
            # rewritten GroupBy can still become timeseries/topN/search
            if getattr(self.ctx, "rollups", None):
                raise NotImplementedError(
                    "materialized rollup rewrite not ported yet "
                    "(ROADMAP A.9)")
            q = QT.transform(q, self.ctx.config,
                             getattr(self.ctx, "spec_rules", ()))
            specs.append(q)
            spec_dims.append(set_dim_names)

        all_dims = [d.output_name for d in self._dim_specs
                    if not (self.distinct2 and
                            d.output_name == self.distinct2.distinct_dim)]
        if self.distinct2 is not None:
            self.distinct2.group_cols = all_dims
            for aname, aspec in self._aggs.items():
                if aspec.kind in ("longsum", "doublesum", "count"):
                    self.distinct2.other_aggs[aname] = "sum"
                elif aspec.kind.endswith("min"):
                    self.distinct2.other_aggs[aname] = "min"
                elif aspec.kind.endswith("max") or aspec.kind == "anyvalue":
                    self.distinct2.other_aggs[aname] = "max"
                elif aspec.kind == "cardinality":
                    raise PlanUnsupported(
                        "mixing exact and approx count-distinct")

        return PlannedQuery(
            datasource=ds_name, specs=specs, spec_dims=spec_dims,
            all_dims=all_dims, output_columns=output_columns,
            order_by=order_by, limit=stmt.limit,
            order_applied_in_spec=order_in_spec,
            distinct_phase2=self.distinct2,
            deferred_posts=deferred_posts,
            residual=residual_expr,
            rollup=rollup_used)

    def _plan_output_item(self, item: A.SelectItem, idx: int) -> str:
        e = item.expr
        k = E.to_sql(e)
        # exactly a group expr?
        if k in self._dim_by_expr:
            return self._dim_by_expr[k]
        calls = E.agg_calls_in(e)
        if isinstance(e, E.AggCall):
            name = self.agg_for_call(e)
            if item.alias and item.alias != name:
                # alias differs from generated (e.g. repeated agg): post-agg
                self._post[item.alias] = S.PostAggregationSpec(
                    item.alias, E.Column(name))
                return item.alias
            return name
        if calls or not E.columns_in(e):
            name = item.alias or f"_c{idx}"
            expr2 = self._replace_aggs_and_dims(e)
            self._post[name] = S.PostAggregationSpec(name, expr2)
            return name
        # expression over group dims only
        expr2 = self._replace_aggs_and_dims(e)
        leftover = E.columns_in(expr2) - set(self._dim_by_expr.values()) \
            - set(self._aggs) - set(self._post)
        if leftover:
            raise PlanUnsupported(
                f"select item {E.to_sql(e)} not derivable from GROUP BY")
        name = item.alias or f"_c{idx}"
        self._post[name] = S.PostAggregationSpec(name, expr2)
        return name

    def _replace_aggs_and_dims(self, e: E.Expr) -> E.Expr:
        dimmap = self._dim_by_expr

        def rep(n):
            if isinstance(n, E.AggCall):
                return E.Column(self.agg_for_call(n))
            k = E.to_sql(n)
            if k in dimmap and not isinstance(n, (E.Literal, E.Column)):
                return E.Column(dimmap[k])
            if isinstance(n, E.Column) and k in dimmap:
                return E.Column(dimmap[k])
            return n

        return E.transform(e, rep)

    def _order_col(self, o: A.OrderItem, output_columns: List[str]) -> str:
        e = o.expr
        if isinstance(e, E.Literal) and isinstance(e.value, int):
            return output_columns[e.value - 1]
        k = E.to_sql(e)
        if k in self._dim_by_expr:
            return self._dim_by_expr[k]
        if isinstance(e, E.Column):
            if e.name in output_columns or e.name in self._aggs \
                    or e.name in self._post:
                return e.name
        if isinstance(e, E.AggCall):
            return self.agg_for_call(e)
        # expression over aggs/dims -> hidden post-agg
        expr2 = self._replace_aggs_and_dims(e)
        name = self.fresh("ord")
        self._post[name] = S.PostAggregationSpec(name, expr2)
        self.hidden.add(name)
        return name

    # =========================================================================
    # non-aggregate (select) path
    # =========================================================================
    def _build_select_path(self, ds_name, intervals, filter_spec,
                           residue=None):
        mode = self.ctx.config.get(NON_AGG_PUSHDOWN)
        if mode == "push_none":
            raise PlanUnsupported("non-aggregate pushdown disabled")
        stmt = self.stmt
        residual_expr = None
        residue_cols: List[str] = []
        if residue:
            residual_expr = residue[0] if len(residue) == 1 \
                else E.And(tuple(residue))
            residue_cols = sorted(E.columns_in(residual_expr))
            for c in residue_cols:
                if c not in self.ds.column_names():
                    raise PlanUnsupported(
                        f"unpushable predicate over unknown column {c}")
        cols: List[str] = []
        renames: Dict[str, str] = {}
        for item in stmt.items:
            if item.expr == "*" or (isinstance(item.expr, E.Column)
                                    and item.expr.name == "*"):
                cols.extend(self.ds.column_names())
                continue
            if not isinstance(item.expr, E.Column):
                raise PlanUnsupported("computed select item on select path")
            if item.alias and item.alias != item.expr.name:
                if item.expr.name in renames:
                    raise PlanUnsupported(
                        "column selected twice with different aliases")
                renames[item.expr.name] = item.alias
            cols.append(item.expr.name)
        for src in renames:
            if cols.count(src) > 1:
                # SELECT region, region AS r would apply the rename to every
                # occurrence; let the host tier keep both output columns.
                raise PlanUnsupported(
                    "column selected both bare and aliased")
        out_cols = [renames.get(c, c) for c in cols]
        for src, tgt in renames.items():
            if tgt != src and (tgt in cols or tgt in residue_cols):
                # SELECT qty AS region ... with 'region' also fetched
                # (selected or needed by the residue) would duplicate the
                # label after renaming
                raise PlanUnsupported(
                    f"alias {tgt!r} collides with a fetched column")
        if stmt.distinct:
            if residual_expr is not None:
                raise PlanUnsupported(
                    "unpushable predicate with SELECT DISTINCT")
            # SELECT DISTINCT dims -> group-by rewrite
            dims = tuple(S.DimensionSpec(c, c) for c in cols)
            q = S.GroupByQuerySpec(
                datasource=ds_name, dimensions=dims,
                aggregations=(S.AggregationSpec("count", "__count__"),),
                filter=filter_spec, intervals=intervals)
            order_by = [(self._select_order_col(o, cols), o.ascending)
                        for o in stmt.order_by]
            return PlannedQuery(
                datasource=ds_name, specs=[q], spec_dims=[list(cols)],
                all_dims=list(cols), output_columns=out_cols,
                order_by=order_by, limit=stmt.limit,
                select_renames=renames)
        order_by = [(self._select_order_col(o, cols), o.ascending)
                    for o in stmt.order_by]
        fetch = list(cols)
        for c in residue_cols:           # hidden columns the residue needs
            if c not in fetch:
                fetch.append(c)
        q = S.SelectQuerySpec(
            datasource=ds_name, columns=tuple(fetch), filter=filter_spec,
            intervals=intervals,
            page_size=(stmt.limit
                       if stmt.limit is not None and not order_by
                       and residual_expr is None
                       else 1 << 31))
        return PlannedQuery(
            datasource=ds_name, specs=[q], spec_dims=[[]], all_dims=[],
            output_columns=out_cols, order_by=order_by, limit=stmt.limit,
            select_path=True, select_renames=renames,
            residual=residual_expr)

    def _select_order_col(self, o: A.OrderItem, cols: List[str]) -> str:
        e = o.expr
        if isinstance(e, E.Literal) and isinstance(e.value, int):
            return cols[e.value - 1]
        if isinstance(e, E.Column) and e.name in cols:
            return e.name
        raise PlanUnsupported("ORDER BY expression on select path")


def build(ctx, stmt: A.SelectStmt) -> PlannedQuery:
    if isinstance(stmt, A.UnionAll):
        raise PlanUnsupported("UNION ALL (session plans each branch)")
    if getattr(stmt, "offset", 0):
        # the top-level session strips OFFSET before building; an
        # offset-bearing stmt here is a derived table / assisted subtree,
        # where the host tier must apply it
        raise PlanUnsupported("OFFSET in a derived table (host tier)")
    return Builder(ctx, stmt).build()
