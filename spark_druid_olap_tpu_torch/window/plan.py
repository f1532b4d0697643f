"""Window post-pass planning: strip ``OVER (...)`` calls from a SELECT.

Port counterpart of ``spark_druid_olap_tpu/window/plan.py``: a copy kept
inside the PyTorch package (over its own ``ir/expr`` and ``sql/ast``), which
imports nothing of the JAX package.

The session calls :func:`extract` before anything else touches the
statement. When the statement carries window calls, the result is a
``(base_stmt, WindowPlan)`` pair:

- ``base_stmt`` is the statement with every window call removed and with
  auxiliary aliased items (``__w_p0``, ``__w_o0``, ``__w_a0``, ...)
  appended so the base execution — engine pushdown, cluster scatter,
  mesh, composite or host, whichever tier wins — materializes every
  partition key, order key and argument the window pass needs. The
  outer ORDER BY / LIMIT / OFFSET are stripped too: SQL evaluates
  window functions over the FULL result set, so the ordering epilogue
  must run after the post-pass, not inside the base query.
- ``WindowPlan`` records the window calls (deduplicated), how each
  output item rebuilds from base + window columns, and the deferred
  ordering epilogue.

This mirrors how the reference planner splits a windowed Spark plan
into a Druid-pushed aggregate plus a Spark ``Window`` operator on top —
except here the "operator on top" runs as device functions
(``window/exec.py``) instead of a host sort-and-loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.sql import ast as A

#: window functions the post-pass lowers; anything else raises.
RANKING_FNS = ("rank", "dense_rank", "row_number")
OFFSET_FNS = ("lag", "lead")
AGG_FNS = ("sum", "min", "max", "avg", "count")
SUPPORTED_FNS = RANKING_FNS + OFFSET_FNS + AGG_FNS


class WindowUnsupported(ValueError):
    """A window shape the post-pass cannot lower. There is no fallback
    tier for window functions (the host evaluator rejects them too), so
    this surfaces to the caller as the statement's error."""


@dataclasses.dataclass(frozen=True)
class WindowCol:
    """One window call lowered to one computed column ``__w<i>``."""
    slot: str                       # output column name (__w0, __w1, ...)
    fn: str
    call: E.WindowCall              # original (for diagnostics / stats)
    part_cols: Tuple[str, ...]      # aux column names in the base frame
    order_cols: Tuple[Tuple[str, bool], ...]   # (aux name, ascending)
    arg_cols: Tuple[str, ...]       # aux column names for fn args
    offset: int = 1                 # lag/lead row offset
    default: Optional[object] = None   # lag/lead default literal
    frame: Optional[Tuple[Optional[int], Optional[int]]] = None


@dataclasses.dataclass(frozen=True)
class OutItem:
    """One output column of the windowed statement."""
    name: str
    expr: object                    # E.Expr over base + __w columns, or
    #                                 the string '*' (star passthrough)


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    windows: Tuple[WindowCol, ...]
    items: Tuple[OutItem, ...]
    # deferred ordering epilogue (applied AFTER the window columns):
    order_by: Tuple[Tuple[object, bool], ...]   # (expr, ascending)
    limit: Optional[int]
    offset: int
    aux_cols: Tuple[str, ...]       # every __w_* helper added to base


def _has_window(e) -> bool:
    if e is None or isinstance(e, str):
        return False
    return any(isinstance(n, E.WindowCall) for n in E.walk(e))


def extract(ctx, stmt) -> Optional[Tuple[A.SelectStmt, WindowPlan]]:
    """Return ``(base_stmt, plan)`` when ``stmt`` has window calls, else
    ``None``. Raises :class:`WindowUnsupported` for shapes the pass
    cannot honor (window calls outside the SELECT list, DISTINCT, ...).
    """
    if not isinstance(stmt, A.SelectStmt):
        return None
    gb_exprs = () if stmt.group_by is None \
        or isinstance(stmt.group_by, A.GroupingSets) else tuple(stmt.group_by)
    # detect windows ANYWHERE — a window in WHERE/HAVING/GROUP BY must
    # reach the rejection below, not fall through to a host tier that
    # has no window evaluator at all
    if not any(_has_window(it.expr) for it in stmt.items) \
            and not any(_has_window(o.expr) for o in stmt.order_by) \
            and not _has_window(stmt.where) \
            and not _has_window(stmt.having) \
            and not any(_has_window(g) for g in gb_exprs):
        return None
    from spark_druid_olap_tpu_torch.utils.config import WINDOW_ENABLED
    if not ctx.config.get(WINDOW_ENABLED):
        raise WindowUnsupported(
            "window functions are disabled (sdot.window.enabled=false)")
    for label, e in (("WHERE", stmt.where), ("HAVING", stmt.having)):
        if _has_window(e):
            raise WindowUnsupported(
                f"window functions are not allowed in {label}")
    gb = stmt.group_by
    if gb is not None and not isinstance(gb, A.GroupingSets):
        if any(_has_window(g) for g in gb):
            raise WindowUnsupported(
                "window functions are not allowed in GROUP BY")
    if stmt.distinct:
        raise WindowUnsupported(
            "SELECT DISTINCT with window functions is not supported")

    # output name per select item (the normal tiers' naming rule)
    named: List[Tuple[A.SelectItem, Optional[str], bool]] = []
    for i, it in enumerate(stmt.items):
        if it.expr == "*" or (isinstance(it.expr, E.Column)
                              and it.expr.name == "*"):
            named.append((it, None, False))
            continue
        if it.alias:
            name = it.alias
        elif isinstance(it.expr, E.Column):
            name = it.expr.name
        else:
            name = f"_c{i}"
        named.append((it, name, _has_window(it.expr)))

    # window inputs reuse matching output columns when the statement
    # already selects the same expression; bare columns are aliased to
    # their own name (the engine names plain dimension outputs by the
    # underlying column, so a synthetic alias would not survive the
    # pushdown tier); everything else gets a __w_* helper column
    aux: Dict[E.Expr, str] = {
        it.expr: nm for it, nm, hw in named
        if nm is not None and not hw}
    aux_order: List[Tuple[str, E.Expr]] = []
    counters = {"p": 0, "o": 0, "a": 0}

    def aux_col(e: E.Expr, kind: str) -> str:
        if _has_window(e):
            raise WindowUnsupported("nested window functions")
        name = aux.get(e)
        if name is None:
            if isinstance(e, E.Column):
                name = e.name
            else:
                name = f"__w_{kind}{counters[kind]}"
                counters[kind] += 1
            aux[e] = name
            aux_order.append((name, e))
        return name

    windows: List[WindowCol] = []
    by_call: Dict[E.WindowCall, str] = {}

    def lower_call(c: E.WindowCall) -> str:
        slot = by_call.get(c)
        if slot is not None:
            return slot
        if c.fn not in SUPPORTED_FNS:
            raise WindowUnsupported(f"window function {c.fn}()")
        if c.fn in RANKING_FNS + OFFSET_FNS and not c.order_by:
            raise WindowUnsupported(f"{c.fn}() requires ORDER BY")
        part = tuple(aux_col(p, "p") for p in c.partition_by)
        order = tuple((aux_col(o, "o"), asc) for o, asc in c.order_by)
        offset, default = 1, None
        args = c.args
        if c.fn in OFFSET_FNS:
            if not args:
                raise WindowUnsupported(f"{c.fn}() needs an argument")
            if len(args) >= 2:
                if not isinstance(args[1], E.Literal) \
                        or not isinstance(args[1].value, int):
                    raise WindowUnsupported(
                        f"{c.fn}() offset must be an integer literal")
                offset = args[1].value
            if len(args) >= 3:
                if not isinstance(args[2], E.Literal):
                    raise WindowUnsupported(
                        f"{c.fn}() default must be a literal")
                default = args[2].value
            args = args[:1]
        if c.fn in RANKING_FNS and args:
            raise WindowUnsupported(f"{c.fn}() takes no arguments")
        if c.fn == "count" and args \
                and isinstance(args[0], E.Column) and args[0].name == "*":
            args = ()
        arg_cols = tuple(aux_col(a, "a") for a in args)
        if c.fn in ("sum", "min", "max", "avg") and not arg_cols:
            raise WindowUnsupported(f"window {c.fn}() needs an argument")
        if c.frame is not None and c.fn not in AGG_FNS:
            raise WindowUnsupported(
                f"{c.fn}() does not accept a ROWS frame")
        slot = f"__w{len(windows)}"
        by_call[c] = slot
        windows.append(WindowCol(
            slot=slot, fn=c.fn, call=c, part_cols=part,
            order_cols=order, arg_cols=arg_cols,
            offset=offset, default=default, frame=c.frame))
        return slot

    def strip(e):
        """Replace every WindowCall in ``e`` with its slot column."""
        return E.transform(
            e, lambda n: E.Column(lower_call(n))
            if isinstance(n, E.WindowCall) else n)

    items: List[OutItem] = []
    base_items: List[A.SelectItem] = []
    for it, name, has_win in named:
        if name is None:                       # star passthrough
            base_items.append(it)
            items.append(OutItem(name="*", expr="*"))
            continue
        if has_win:
            items.append(OutItem(name=name, expr=strip(it.expr)))
        else:
            base_items.append(it if it.alias else
                              dataclasses.replace(it, alias=name))
            items.append(OutItem(name=name, expr=E.Column(name)))

    # deferred ordering: expressions referencing window outputs resolve
    # against the post-pass frame (output aliases are in scope, matching
    # the engine's ORDER BY alias resolution)
    order_by = tuple((strip(o.expr), o.ascending) for o in stmt.order_by)

    base_items.extend(A.SelectItem(expr=e, alias=n) for n, e in aux_order)
    base_stmt = dataclasses.replace(
        stmt, items=tuple(base_items), order_by=(), limit=None, offset=0)
    plan = WindowPlan(
        windows=tuple(windows), items=tuple(items),
        order_by=order_by, limit=stmt.limit, offset=stmt.offset,
        aux_cols=tuple(n for n, _ in aux_order))
    return base_stmt, plan
