"""Per-function control-flow graphs with exception edges.

Port of the JAX package's ``tools/sdlint/cfg.py``, unchanged.

The dataflow passes (``leaks``, ``ordering``) need one question answered
precisely: *is there any path from A to B that avoids every node in S?*
— where paths include the exceptional exits a ``raise`` or a failing
call introduces. This module builds a statement-level CFG per function:

- ``entry`` / ``exit`` / ``raise_exit`` are synthetic nodes; ``exit``
  is reached by falling off the end or ``return``; ``raise_exit`` by an
  exception no handler in the function absorbs.
- Normal edges follow statement order, branches, and loops.
- Exception edges go from every may-raise statement to the innermost
  enclosing handler chain (``except`` entries, then ``finally``), or to
  ``raise_exit`` when nothing encloses it. ``finally`` bodies are laid
  out once with both a normal and an exceptional continuation — an
  over-approximation of CPython's block duplication that is conservative
  in the right direction: a release placed in the ``finally`` still
  blocks every path through it.
- ``with`` statements are modeled like ``try/finally`` around the body:
  the context manager's ``__exit__`` runs on all paths, represented by a
  synthetic ``WithExit`` node carrying the original ``ast.With``.

May-raise is deliberately coarse (any statement containing a call,
``raise``, ``assert``, subscript store, or ``for`` iteration): the
passes built on top require ``finally``/context-manager discipline, so
over-approximating raise sites only strengthens the check they already
make. Statements that are pure name/constant/attribute assignments are
the one carve-out — without it, ``x = acquired`` between an acquire and
its ``try`` would count as a leak path.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Union

#: synthetic node payloads
ENTRY = "<entry>"
EXIT = "<exit>"
RAISE_EXIT = "<raise-exit>"


@dataclasses.dataclass
class WithExit:
    """Synthetic node: the ``__exit__`` of a ``with`` statement (runs on
    both the normal and the exceptional way out of the body)."""
    stmt: ast.With


NodePayload = Union[str, ast.stmt, WithExit]


class CFG:
    def __init__(self, func: ast.AST):
        self.func = func
        self.nodes: List[NodePayload] = []
        self.succ: Dict[int, Set[int]] = {}    # normal control flow
        self.esucc: Dict[int, Set[int]] = {}   # this node raised
        self.entry = self._new(ENTRY)
        self.exit = self._new(EXIT)
        self.raise_exit = self._new(RAISE_EXIT)

    def _new(self, payload: NodePayload) -> int:
        nid = len(self.nodes)
        self.nodes.append(payload)
        self.succ[nid] = set()
        self.esucc[nid] = set()
        return nid

    def edge(self, a: int, b: int) -> None:
        self.succ[a].add(b)

    def eedge(self, a: int, b: int) -> None:
        self.esucc[a].add(b)

    # -- queries ---------------------------------------------------------------
    def stmt_nodes(self) -> List[int]:
        return [i for i, p in enumerate(self.nodes)
                if not isinstance(p, str)]

    def reachable_avoiding(self, start: int, goals: Set[int],
                           avoid: Set[int],
                           skip_start_raise: bool = False,
                           normal_only: bool = False
                           ) -> Optional[List[int]]:
        """BFS witness path start -> any goal that never enters ``avoid``
        (start itself is exempt); None when every path is blocked. With
        ``skip_start_raise`` the start node's own exception edges are
        ignored — "the acquire call itself failed" is not a leak. With
        ``normal_only`` exception edges are ignored entirely (ordering
        checks: an exception unwinding past a publish is not a missing
        post-publish step)."""
        if start in goals:
            return [start]
        seen = {start}
        frontier = [[start]]
        first = True
        while frontier:
            nxt = []
            for path in frontier:
                tail = path[-1]
                succs = set(self.succ[tail])
                if not normal_only and \
                        not (first and skip_start_raise and tail == start):
                    succs |= self.esucc[tail]
                for s in succs:
                    if s in seen or s in avoid:
                        continue
                    if s in goals:
                        return path + [s]
                    seen.add(s)
                    nxt.append(path + [s])
            frontier = nxt
            first = False
        return None


_SAFE_CTX = (ast.Name, ast.Constant, ast.Attribute)


def may_raise(stmt: ast.stmt) -> bool:
    """Coarse: anything that calls, raises, asserts, subscripts, or
    iterates may raise; plain name/constant/attribute moves may not."""
    if isinstance(stmt, (ast.Raise, ast.Assert, ast.For, ast.AsyncFor,
                         ast.With, ast.AsyncWith)):
        return True
    if isinstance(stmt, (ast.Pass, ast.Break, ast.Continue, ast.Global,
                         ast.Nonlocal, ast.Import, ast.ImportFrom,
                         ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return False
    header = stmt
    if isinstance(stmt, (ast.If, ast.While)):
        header = stmt.test
    elif isinstance(stmt, ast.Return):
        if stmt.value is None:
            return False
        header = stmt.value
    elif isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                           ast.Expr)):
        pass                      # inspect the whole statement below
    for node in ast.walk(header):
        if isinstance(node, (ast.Call, ast.Subscript, ast.Await,
                             ast.Yield, ast.YieldFrom, ast.BinOp,
                             ast.Compare, ast.ListComp, ast.SetComp,
                             ast.DictComp, ast.GeneratorExp)):
            return True
    return False


class _Builder:
    """Lays one function body out into a CFG. ``handlers`` is the stack
    of (exception-landing node, finally-landing node) scopes."""

    def __init__(self, func: ast.AST):
        self.g = CFG(func)
        # stack of targets an exception propagates to, innermost last
        self.exc_stack: List[int] = []
        # loop stack: (continue-target, break-target)
        self.loop_stack: List[tuple] = []
        # where a normal `return` routes (through enclosing finallys)
        self.return_stack: List[int] = []

    def build(self) -> CFG:
        body = getattr(self.g.func, "body", [])
        last = self._body(body, self.g.entry)
        if last is not None:
            self.g.edge(last, self.g.exit)
        return self.g

    # -- helpers ---------------------------------------------------------------
    def _exc_target(self) -> int:
        return self.exc_stack[-1] if self.exc_stack else self.g.raise_exit

    def _return_target(self) -> int:
        return self.return_stack[-1] if self.return_stack else self.g.exit

    def _body(self, stmts: Sequence[ast.stmt],
              pred: Optional[int]) -> Optional[int]:
        """Wire ``stmts`` after ``pred``; returns the fall-through node
        (None when control never falls through)."""
        cur = pred
        for s in stmts:
            if cur is None:
                break             # unreachable tail; don't model
            cur = self._stmt(s, cur)
        return cur

    def _stmt(self, s: ast.stmt, pred: int) -> Optional[int]:
        g = self.g
        if isinstance(s, (ast.If,)):
            n = g._new(s)
            g.edge(pred, n)
            if may_raise(s):
                g.eedge(n, self._exc_target())
            t_end = self._body(s.body, n)
            e_end = self._body(s.orelse, n) if s.orelse else n
            join = None
            for end in (t_end, e_end):
                if end is None:
                    continue
                if join is None:
                    join = g._new(ast.Pass())
                g.edge(end, join)
            return join
        if isinstance(s, (ast.While, ast.For, ast.AsyncFor)):
            head = g._new(s)
            g.edge(pred, head)
            if may_raise(s):
                g.eedge(head, self._exc_target())
            after = g._new(ast.Pass())
            g.edge(head, after)           # zero iterations / loop exit
            self.loop_stack.append((head, after))
            body_end = self._body(s.body, head)
            self.loop_stack.pop()
            if body_end is not None:
                g.edge(body_end, head)
            if s.orelse:
                after = self._body(s.orelse, after)
            return after
        if isinstance(s, (ast.With, ast.AsyncWith)):
            head = g._new(s)              # item exprs evaluate here
            g.edge(pred, head)
            g.eedge(head, self._exc_target())
            # three __exit__ copies so the normal / exceptional / return
            # continuations never merge (a merged node would fabricate
            # "body raised, then fell through normally" paths)
            wexit_n = g._new(WithExit(s))
            wexit_e = g._new(WithExit(s))
            wexit_r = g._new(WithExit(s))
            self.exc_stack.append(wexit_e)
            self.return_stack.append(wexit_r)
            body_end = self._body(s.body, head)
            self.return_stack.pop()
            self.exc_stack.pop()
            if body_end is not None:
                g.edge(body_end, wexit_n)
            g.edge(wexit_e, self._exc_target())
            g.edge(wexit_r, self._return_target())
            after = g._new(ast.Pass())
            g.edge(wexit_n, after)
            return after
        if isinstance(s, ast.Try):
            return self._try(s, pred)
        if isinstance(s, ast.Return):
            n = g._new(s)
            g.edge(pred, n)
            if may_raise(s):
                g.eedge(n, self._exc_target())
            g.edge(n, self._return_target())
            return None
        if isinstance(s, ast.Raise):
            n = g._new(s)
            g.edge(pred, n)
            g.eedge(n, self._exc_target())
            return None
        if isinstance(s, ast.Break):
            n = g._new(s)
            g.edge(pred, n)
            if self.loop_stack:
                g.edge(n, self.loop_stack[-1][1])
            return None
        if isinstance(s, ast.Continue):
            n = g._new(s)
            g.edge(pred, n)
            if self.loop_stack:
                g.edge(n, self.loop_stack[-1][0])
            return None
        # plain statement (incl. nested def/class: opaque)
        n = g._new(s)
        g.edge(pred, n)
        if may_raise(s):
            g.eedge(n, self._exc_target())
        return n

    def _try(self, s: ast.Try, pred: int) -> Optional[int]:
        g = self.g
        head = g._new(ast.Pass())
        g.edge(pred, head)
        after = g._new(ast.Pass())

        # the finally body is laid out once per continuation (normal /
        # exceptional / return), mirroring CPython's block duplication —
        # a single shared copy would merge the paths and fabricate
        # "raised, ran finally, then fell through normally" routes
        fin_norm = fin_exc = fin_ret = None
        if s.finalbody:
            fin_norm = g._new(ast.Pass())
            out = self._body(s.finalbody, fin_norm)
            if out is not None:
                g.edge(out, after)
            fin_exc = g._new(ast.Pass())
            out = self._body(s.finalbody, fin_exc)
            if out is not None:
                g.edge(out, self._exc_target())
            fin_ret = g._new(ast.Pass())
            out = self._body(s.finalbody, fin_ret)
            if out is not None:
                g.edge(out, self._return_target())

        exc_out = fin_exc if fin_exc is not None else self._exc_target()
        norm_out = fin_norm if fin_norm is not None else after

        # exception landing: each handler entry; unmatched -> finally/outer
        handler_entries = []
        exc_landing = g._new(ast.Pass())
        for h in s.handlers:
            hn = g._new(h)        # the `except X as e:` header
            g.edge(exc_landing, hn)
            handler_entries.append(hn)
        catch_all = any(
            h.type is None or (isinstance(h.type, ast.Name)
                               and h.type.id == "BaseException")
            for h in s.handlers)
        if not catch_all:
            # no handler matches / none at all (a bare `except:` /
            # `except BaseException:` matches everything — keeping the
            # fall-past edge there would fabricate leak paths around
            # handlers that exist precisely to release on error)
            g.edge(exc_landing, exc_out)

        self.exc_stack.append(exc_landing)
        if fin_ret is not None:
            self.return_stack.append(fin_ret)
        body_end = self._body(s.body, head)
        if s.orelse and body_end is not None:
            body_end = self._body(s.orelse, body_end)
        if fin_ret is not None:
            self.return_stack.pop()
        self.exc_stack.pop()

        # handler bodies: exceptions inside them go to finally/outer
        self.exc_stack.append(exc_out)
        if fin_ret is not None:
            self.return_stack.append(fin_ret)
        for hn, h in zip(handler_entries, s.handlers):
            h_end = self._body(h.body, hn)
            if h_end is not None:
                g.edge(h_end, norm_out)
        if fin_ret is not None:
            self.return_stack.pop()
        self.exc_stack.pop()

        if body_end is not None:
            g.edge(body_end, norm_out)
        return after


def build(func: ast.AST) -> CFG:
    """CFG for one ``FunctionDef`` / ``AsyncFunctionDef``."""
    return _Builder(func).build()
