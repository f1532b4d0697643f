"""Lock-order / race pass.

Port of the JAX package's ``tools/sdlint/locks.py``, unchanged.

Builds the interprocedural lock-acquisition graph over every
``threading.Lock/RLock/Condition`` attribute in the project:

- **deadlock-cycle** — two locks acquired in opposite orders on any pair
  of (resolved) call paths form a cycle in the acquired-while-holding
  graph. Self-edges through an ``RLock`` are reentrancy, not deadlock,
  and are skipped.
- **unguarded-write** — an attribute of a lock-owning class that is
  mutated under the class's lock on some paths (so it is evidently
  shared state) but is also mutated with **no** lock held in a function
  reachable from a thread entrypoint (``Thread(target=...)``, HTTP
  ``do_GET/do_POST`` handlers, Flight ``do_get/do_action``, the
  background checkpointer). ``__init__`` writes are construction
  (happens-before publication) and never count.

The analysis is conservative where resolution fails: an unresolved call
drops its edges, so every reported cycle is grounded in resolved code
paths (read the edge sites in the finding message).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from spark_druid_olap_tpu_torch.tools.sdlint.astutil import (FuncId, Index,
                                                       _threading_factory)
from spark_druid_olap_tpu_torch.tools.sdlint.core import Finding, Project

# container-mutator method names: self.attr.<m>(...) counts as a write
_MUTATORS = {"append", "add", "update", "pop", "popitem", "clear",
             "discard", "remove", "extend", "insert", "setdefault",
             "appendleft"}

_HTTP_ENTRYPOINTS = {"do_GET", "do_POST", "do_PUT", "do_DELETE"}
_FLIGHT_ENTRYPOINTS = {"do_get", "do_put", "do_action", "do_exchange",
                       "get_flight_info", "list_flights"}


def _is_thread_ctor(call: ast.Call) -> bool:
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == "Thread"):
        return isinstance(f, ast.Name) and f.id == "Thread"
    base = f.value
    if isinstance(base, ast.Name) and base.id == "threading":
        return True
    return (isinstance(base, ast.Call)
            and isinstance(base.func, ast.Name)
            and base.func.id == "__import__" and base.args
            and isinstance(base.args[0], ast.Constant)
            and base.args[0].value == "threading")


@dataclasses.dataclass
class _Summary:
    fid: FuncId
    # (lock_id, kind, held-at-acquire tuple, line)
    acquires: List[Tuple[str, str, Tuple[str, ...], int]] = \
        dataclasses.field(default_factory=list)
    # (callee fid, held tuple, line)
    calls: List[Tuple[FuncId, Tuple[str, ...], int]] = \
        dataclasses.field(default_factory=list)
    # (class ref string, attr, any-own-lock-held, line)
    writes: List[Tuple[str, str, bool, int]] = \
        dataclasses.field(default_factory=list)
    thread_targets: List[Tuple[FuncId, int]] = \
        dataclasses.field(default_factory=list)


class LockAnalysis:
    """Holds the graph for findings AND for the regression tests / docs
    (tests assert on ``edges`` and ``cycles`` directly)."""

    def __init__(self, project: Project):
        self.project = project
        self.index = project.index()   # shared: parsed/typed once for all passes
        self.lock_kinds: Dict[str, str] = {}
        self.summaries: Dict[FuncId, _Summary] = {}
        for mi in self.index.modules.values():
            for name, kind in mi.module_locks.items():
                self.lock_kinds[f"{mi.mod.name}.{name}"] = kind
            for ci in set(mi.classes.values()):
                for attr, kind in ci.lock_attrs.items():
                    self.lock_kinds[f"{ci.module}.{ci.qual}.{attr}"] = kind
        for fid, fn in self.index.functions.items():
            self.summaries[fid] = self._summarize(fid, fn)
        self.may_acquire = self._fixpoint_acquires()
        # (held, acquired) -> [(path, line, via)] witness sites
        self.edges: Dict[Tuple[str, str], List[Tuple[str, int, str]]] = {}
        self._build_edges()
        self.entrypoints = self._entrypoints()
        self.reachable = self._reachable(self.entrypoints)
        self.lockfree_entry = self._lockfree_entry()
        self.cycles = self._cycles()

    # -- per-function summaries ------------------------------------------------
    def _summarize(self, fid: FuncId, fn: ast.FunctionDef) -> _Summary:
        idx = self.index
        mi = idx.modules[fid[0]]
        ci = idx.func_class[fid]
        local = idx.local_types(mi, ci, fn)
        s = _Summary(fid)
        own_locks = set()
        if ci is not None:
            own_locks = {f"{ci.module}.{ci.qual}.{a}"
                         for a in ci.lock_attrs}

        def scan_expr(node: ast.expr, held: Tuple[str, ...]) -> None:
            """Record calls/acquires in an expression, skipping deferred
            bodies (lambdas, nested defs run later, not under ``held``)."""
            if isinstance(node, (ast.Lambda, ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.ClassDef)):
                return
            if isinstance(node, ast.Call):
                self._scan_call(s, mi, ci, fid, node, held, local)
            for child in ast.iter_child_nodes(node):
                scan_expr(child, held)

        def note_write(target: ast.expr, held: Tuple[str, ...],
                       line: int) -> None:
            if ci is None:
                return
            # self.attr = / self.attr[k] = / self.attr += ...
            t = target
            if isinstance(t, ast.Subscript):
                t = t.value
            if isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                held_own = any(h in own_locks for h in held)
                s.writes.append((f"{ci.module}.{ci.qual}", t.attr,
                                 held_own, line))

        def walk(stmts: Sequence[ast.stmt],
                 held: Tuple[str, ...]) -> None:
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                    continue        # separate summaries
                if isinstance(st, (ast.With, ast.AsyncWith)):
                    new = list(held)
                    for item in st.items:
                        lk = idx.resolve_lock(mi, ci, item.context_expr,
                                              local)
                        if lk is not None:
                            lid, kind = lk
                            s.acquires.append((lid, kind, tuple(new),
                                               st.lineno))
                            new.append(lid)
                        else:
                            scan_expr(item.context_expr, tuple(new))
                    walk(st.body, tuple(new))
                    continue
                if isinstance(st, (ast.Assign, ast.AugAssign)):
                    targets = st.targets if isinstance(st, ast.Assign) \
                        else [st.target]
                    for t in targets:
                        note_write(t, held, st.lineno)
                    scan_expr(st.value, held)
                    continue
                # compound statements: scan own expressions, recurse
                for field in ("test", "iter", "value", "exc", "msg",
                              "subject"):
                    sub = getattr(st, field, None)
                    if isinstance(sub, ast.expr):
                        scan_expr(sub, held)
                if isinstance(st, ast.Expr):
                    # self.attr.append(...) style container mutation
                    if isinstance(st.value, ast.Call) \
                            and isinstance(st.value.func, ast.Attribute) \
                            and st.value.func.attr in _MUTATORS:
                        note_write(st.value.func.value, held, st.lineno)
                    scan_expr(st.value, held)
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(st, field, None)
                    if isinstance(sub, list):
                        walk(sub, held)
                for h in getattr(st, "handlers", ()):
                    walk(h.body, held)

        walk(fn.body, ())
        return s

    def _scan_call(self, s: _Summary, mi, ci, fid: FuncId, call: ast.Call,
                   held: Tuple[str, ...], local) -> None:
        idx = self.index
        # Thread(target=X): X runs on a fresh thread holding nothing
        if _is_thread_ctor(call):
            for kw in call.keywords:
                if kw.arg == "target":
                    ref = idx.resolve_func_ref(mi, ci, kw.value, local,
                                               enclosing_qual=fid[1])
                    if ref is not None:
                        s.thread_targets.append((ref, call.lineno))
            return
        # bare lock.acquire() outside a with-statement
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr == "acquire":
            lk = idx.resolve_lock(mi, ci, call.func.value, local)
            if lk is not None:
                s.acquires.append((lk[0], lk[1], held, call.lineno))
                return
        for callee in idx.resolve_call(mi, ci, call, local,
                                       enclosing_qual=fid[1],
                                       unique_fallback=True):
            s.calls.append((callee, held, call.lineno))

    # -- interprocedural propagation -------------------------------------------
    def _fixpoint_acquires(self) -> Dict[FuncId, Set[str]]:
        acq = {fid: {a[0] for a in s.acquires}
               for fid, s in self.summaries.items()}
        changed = True
        while changed:
            changed = False
            for fid, s in self.summaries.items():
                cur = acq[fid]
                before = len(cur)
                for callee, _, _ in s.calls:
                    cur |= acq.get(callee, set())
                for callee, _ in s.thread_targets:
                    # a spawned thread acquires on its own stack, not
                    # under the spawner's held set — no propagation
                    pass
                if len(cur) != before:
                    changed = True
        return acq

    def _build_edges(self) -> None:
        def add(a: str, b: str, path: str, line: int, via: str) -> None:
            if a == b:
                return              # handled as self-cycle separately
            self.edges.setdefault((a, b), []).append((path, line, via))

        for fid, s in self.summaries.items():
            path = self.index.modules[fid[0]].mod.relpath
            for lid, _, held, line in s.acquires:
                for h in held:
                    add(h, lid, path, line, f"{fid[1]} acquires directly")
            for callee, held, line in s.calls:
                if not held:
                    continue
                for lid in self.may_acquire.get(callee, ()):
                    for h in held:
                        add(h, lid, path, line,
                            f"{fid[1]} -> {callee[1]}()")

    def _entrypoints(self) -> Set[FuncId]:
        out: Set[FuncId] = set()
        for fid, s in self.summaries.items():
            for ref, _ in s.thread_targets:
                out.add(ref)
            name = fid[1].rsplit(".", 1)[-1]
            if name in _HTTP_ENTRYPOINTS or name in _FLIGHT_ENTRYPOINTS:
                out.add(fid)
        return out

    def _reachable(self, roots: Set[FuncId]) -> Set[FuncId]:
        seen = set(roots)
        stack = list(roots)
        while stack:
            fid = stack.pop()
            s = self.summaries.get(fid)
            if s is None:
                continue
            for callee, _, _ in s.calls:
                if callee not in seen:
                    seen.add(callee)
                    stack.append(callee)
            for callee, _ in s.thread_targets:
                if callee not in seen:
                    seen.add(callee)
                    stack.append(callee)
        return seen

    def _lockfree_entry(self) -> Set[FuncId]:
        """Functions that can be ENTERED from a thread entrypoint with no
        lock held: the entrypoints themselves, plus the closure over call
        events whose held-set is empty. A helper only ever called under
        ``with self.lock`` never appears here, so its lock-free writes
        are correctly treated as guarded by the caller."""
        lf = {e for e in self.entrypoints if e in self.summaries}
        stack = list(lf)
        while stack:
            fid = stack.pop()
            s = self.summaries.get(fid)
            if s is None:
                continue
            for callee, held, _ in s.calls:
                if not held and callee not in lf \
                        and callee in self.summaries:
                    lf.add(callee)
                    stack.append(callee)
            for callee, _ in s.thread_targets:
                if callee not in lf and callee in self.summaries:
                    lf.add(callee)
                    stack.append(callee)
        return lf

    # -- cycles ----------------------------------------------------------------
    def _cycles(self) -> List[List[str]]:
        """Elementary cycles in the lock graph (DFS with a canonical
        smallest-first rotation; the graph has a handful of nodes)."""
        adj: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, set()).add(b)
        cycles: Set[Tuple[str, ...]] = set()

        def dfs(start: str, node: str, path: List[str],
                on_path: Set[str]) -> None:
            for nxt in sorted(adj.get(node, ())):
                if nxt == start and len(path) > 1:
                    rot = min(range(len(path)),
                              key=lambda i: path[i])
                    cycles.add(tuple(path[rot:] + path[:rot]))
                elif nxt not in on_path and nxt > start:
                    # only explore nodes > start: each cycle found once,
                    # from its smallest node
                    dfs(start, nxt, path + [nxt], on_path | {nxt})

        for start in sorted(adj):
            dfs(start, start, [start], {start})
        # self-cycles: holding A while (transitively) re-acquiring A is a
        # guaranteed deadlock for a plain Lock
        self.self_cycle_sites: Dict[str, Tuple[str, int, str]] = {}
        for fid, s in self.summaries.items():
            path = self.index.modules[fid[0]].mod.relpath
            for lid, kind, held, line in s.acquires:
                if lid in held and self.lock_kinds.get(lid) == "Lock":
                    cycles.add((lid,))
                    self.self_cycle_sites.setdefault(
                        lid, (path, line, f"{fid[1]} re-acquires"))
            for callee, held, line in s.calls:
                for lid in self.may_acquire.get(callee, ()):
                    if lid in held and self.lock_kinds.get(lid) == "Lock":
                        cycles.add((lid,))
                        self.self_cycle_sites.setdefault(
                            lid, (path, line,
                                  f"{fid[1]} -> {callee[1]}() re-acquires"))
        return [list(c) for c in sorted(cycles)]

    # -- findings --------------------------------------------------------------
    def findings(self) -> List[Finding]:
        out: List[Finding] = []
        for cyc in self.cycles:
            if len(cyc) == 1:
                a = cyc[0]
                label = f"{a} -> {a}"
                path, line, via = self.self_cycle_sites.get(
                    a, (self._lock_path(a), 1, "?"))
                wits = f"{path}:{line} ({via})"
            else:
                a, b = cyc[0], cyc[1]
                label = " -> ".join(cyc + [cyc[0]])
                sites = self.edges.get((a, b),
                                       [(self._lock_path(a), 1, "?")])
                path, line, via = sites[0]
                wits = "; ".join(
                    f"{p}:{ln} ({v})"
                    for (x, y) in zip(cyc, cyc[1:] + cyc[:1])
                    for (p, ln, v) in self.edges.get((x, y), [])[:1])
            out.append(Finding(
                "locks", "deadlock-cycle", path, line, label,
                f"lock-order cycle: {label}; witness edges: {wits}"))
        out.extend(self._race_findings())
        return out

    def _lock_path(self, lock_id: str) -> str:
        best = ""
        path = "?"
        for mi in self.index.modules.values():
            pre = mi.mod.name + "."
            if lock_id.startswith(pre) and len(pre) > len(best):
                best, path = pre, mi.mod.relpath
        return path

    def _race_findings(self) -> List[Finding]:
        guarded: Set[Tuple[str, str]] = set()
        writes: Dict[Tuple[str, str], List[Tuple[FuncId, bool, int]]] = {}
        for fid, s in self.summaries.items():
            in_init = fid[1].endswith("__init__")
            for cls, attr, held, line in s.writes:
                if in_init:
                    continue
                writes.setdefault((cls, attr), []).append(
                    (fid, held, line))
                if held:
                    guarded.add((cls, attr))
        out = []
        for (cls, attr), sites in sorted(writes.items()):
            if (cls, attr) not in guarded:
                continue            # never lock-guarded: not shared state
                #                     by this pass's evidence standard
            for fid, held, line in sites:
                if held or fid not in self.lockfree_entry:
                    continue
                path = self.index.modules[fid[0]].mod.relpath
                out.append(Finding(
                    "locks", "unguarded-write", path, line,
                    f"{cls}.{attr}@{fid[1]}",
                    f"{cls}.{attr} is mutated under its class lock "
                    f"elsewhere, but {fid[1]} (reachable from a thread "
                    f"entrypoint) writes it with no lock held"))
        return out


def run(project: Project) -> List[Finding]:
    return LockAnalysis(project).findings()
