"""Mesh-merge pass, over the port's slot and rank merges.

The port of the JAX package's ``tools/sdlint/mesh.py``. JAX runs one
traced program replicated across chips under ``shard_map`` and merges
with ``psum`` / ``pmin`` / ``pmax``; the port runs the same program once
per mesh slot (``parallel/mesh.run_slots``) and folds the slots'
partials on the root device (``ops/groupby.merge_partials`` /
``merge_lane_partials``, each sketch's ``ops/<sketch>.py:
merge_registers``), and across processes gathers every rank's partial
over ``torch.distributed`` (``parallel/multihost.py``) before the same
fold. Three properties keep those merges right, all checkable without a
card or a second process:

- **sketch-merge-mismatch** — register-valued aggregates merge by
  *register algebra*, not addition: HLL rho registers are maxima,
  theta k-min registers are minima, KLL survivor lanes lex-minima with
  exact level-count sums. The algebra is declared per sketch in
  ``ops/agg_registry.py:AGG_CLOSURE`` (``merge`` field);
  ``ops/<sketch>.py:merge_registers`` (and the closures it defines)
  must fold with the matching operators only — ``torch.maximum`` /
  ``amax`` for ``max``, ``torch.minimum`` / ``amin`` for ``min``, and
  for ``minsum`` those minima plus ``+`` / ``add`` / ``sum``. A sum over
  HLL or theta registers corrupts every merged estimate silently.
- **merge-op-mismatch** — in any branch on an aggregate ``kind ==
  "min"`` / ``"max"`` (a bare compare or one conjunct of an ``and``),
  the fold operator must be the matching extremum; a sum or the other
  extremum there returns garbage whenever more than one slot holds the
  group.
- **collective-outside-turn** — every rank must issue the same
  collectives in the same order, so a statement's collectives run inside
  its ``multihost.SEQUENCER`` turn (the ranks agree on whose turn is
  next). A call of a collective of ``parallel/multihost.py``
  (``exchange_block``, ``gather_partials`` and the helpers under them:
  every function there that reaches a ``torch.distributed`` collective)
  or of a ``torch.distributed`` collective elsewhere must sit lexically
  inside ``with ...SEQUENCER.turn(...)``, inside the single-process
  branch of an ``is_multihost()`` / ``_over_ranks()`` test (where the
  collective returns at once), or in a function all of whose resolved
  callers are so covered. ``initialize`` (the join) and the
  ``Sequencer`` itself (which gathers the waiting keys to grant a turn)
  are the protocol and exempt. A nested function no resolved call
  reaches (a program closure a factory returns) counts as covered: the
  pass cannot see who calls it, and it only misses findings, never
  invents them.

The JAX rules ``unknown-axis-name``, ``host-call-in-shard`` and
``host-state-write-in-shard`` have no object in the port: its mesh is a
tuple of devices with no named axes, and a slot program is plain Python
run once per slot on the host, not a body traced once and replicated
(``docs/LINT.md``). Anchors resolve by path suffix; a missing anchor
skips its checks.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from spark_druid_olap_tpu_torch.tools.sdlint.astutil import (FuncId,
                                                             call_chain,
                                                             walk_shallow)
from spark_druid_olap_tpu_torch.tools.sdlint.core import (Finding, Module,
                                                          Project)

_REGISTRY_SUFFIX = "ops/agg_registry.py"
_MULTIHOST_SUFFIX = "parallel/multihost.py"

#: register algebra per sketch when the registry predates the
#: ``merge`` field; the registry declaration wins when present
_SKETCH_MERGE_DEFAULT = {"hll": "max", "theta": "min", "kll": "minsum"}
#: merge algebra -> the operator classes its fold may use
_ALGEBRA_OPS = {"sum": {"sum"}, "max": {"max"}, "min": {"min"},
                "minsum": {"min", "sum"}}
#: fold-operator vocabulary (call or reference leaf) -> operator class;
#: torch, numpy and the JAX collectives' names alike
_OP_CLASS = {
    "maximum": "max", "amax": "max", "fmax": "max", "pmax": "max",
    "minimum": "min", "amin": "min", "fmin": "min", "pmin": "min",
    "add": "sum", "sum": "sum", "nansum": "sum", "psum": "sum",
    "index_add": "sum", "index_add_": "sum",
}
#: ``scatter_reduce`` / ``index_reduce`` reduce strings -> class
_REDUCE_CLASS = {"amax": "max", "amin": "min", "sum": "sum"}

#: ``torch.distributed`` calls that move data between the ranks
_DIST_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_to_all", "all_to_all_single", "broadcast",
    "broadcast_object_list", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "gather", "gather_object", "scatter",
    "scatter_object_list", "send", "recv", "isend", "irecv", "barrier",
    "monitored_barrier"})
#: the multihost protocol's own functions, exempt from the turn rule
_PROTOCOL = frozenset({"initialize", "shutdown"})
#: predicates whose false branch is the single-process path
_SINGLE_PROCESS_TESTS = frozenset({"is_multihost", "_over_ranks"})


def _registry(mod: Module) -> Optional[Dict[str, dict]]:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "AGG_CLOSURE":
            try:
                v = ast.literal_eval(node.value)
            except ValueError:
                return None
            return v if isinstance(v, dict) else None
    return None


def _fold_ops(node: ast.AST) -> List[Tuple[str, str, int]]:
    """``(operator class, spelling, line)`` of every fold operator in
    ``node``: calls and references whose leaf is in the vocabulary
    (``torch.maximum`` passed to a fold counts), ``scatter_reduce``
    reduce strings, and ``+`` between two non-constant operands outside a
    subscript (index arithmetic is not a merge)."""
    out: List[Tuple[str, str, int]] = []
    in_slice: Set[int] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Subscript):
            in_slice |= {id(x) for x in ast.walk(n.slice)}
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in _OP_CLASS:
            out.append((_OP_CLASS[n.attr], n.attr, n.lineno))
        elif isinstance(n, ast.Name) and n.id in _OP_CLASS:
            out.append((_OP_CLASS[n.id], n.id, n.lineno))
        elif isinstance(n, ast.Call) \
                and call_chain(n.func)[-1:] in (["scatter_reduce"],
                                                ["scatter_reduce_"],
                                                ["index_reduce_"]):
            for a in list(n.args) + [k.value for k in n.keywords]:
                if isinstance(a, ast.Constant) \
                        and a.value in _REDUCE_CLASS:
                    out.append((_REDUCE_CLASS[a.value], repr(a.value),
                                n.lineno))
        elif isinstance(n, ast.BinOp) and isinstance(n.op, ast.Add) \
                and id(n) not in in_slice \
                and not isinstance(n.left, ast.Constant) \
                and not isinstance(n.right, ast.Constant):
            out.append(("sum", "+", n.lineno))
    return out


def _kind_branch(test: ast.expr) -> Optional[str]:
    """``<x>.kind == "min"`` / ``kind == "max"`` — bare, or as one
    conjunct of an ``and`` (``r is not None and r.kind == "min"``) —
    -> the literal, else None."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        for v in test.values:
            k = _kind_branch(v)
            if k is not None:
                return k
        return None
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)):
        return None
    left, right = test.left, test.comparators[0]
    for a, b in ((left, right), (right, left)):
        named = (isinstance(a, ast.Attribute) and a.attr == "kind") \
            or (isinstance(a, ast.Name) and a.id == "kind")
        if named and isinstance(b, ast.Constant) \
                and b.value in ("min", "max"):
            return b.value
    return None


def _is_turn(expr: ast.expr) -> bool:
    """``MH.SEQUENCER.turn(...)`` / ``SEQUENCER.turn(...)``."""
    if not isinstance(expr, ast.Call):
        return False
    chain = call_chain(expr.func)
    return chain[-1:] == ["turn"] and "SEQUENCER" in chain


def _single_process_branch(test: ast.expr) -> Optional[str]:
    """Which branch of an ``if`` on a multihost predicate is the
    single-process one: "body" for ``if not is_multihost()``, "orelse"
    for ``if is_multihost()``, else None."""
    neg = isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
    inner = test.operand if neg else test
    if isinstance(inner, ast.Call) \
            and call_chain(inner.func)[-1:] \
            and call_chain(inner.func)[-1] in _SINGLE_PROCESS_TESTS:
        return "body" if neg else "orelse"
    return None


def _is_dist_collective(call: ast.Call) -> bool:
    chain = call_chain(call.func)
    return len(chain) >= 2 and chain[-1] in _DIST_COLLECTIVES \
        and chain[-2] in ("dist", "distributed")


class _Mesh:
    def __init__(self, project: Project):
        self.project = project
        self.index = project.index()

    # -- sketch-merge-mismatch -------------------------------------------------
    def sketch_findings(self) -> List[Finding]:
        reg_mod = self.project.by_suffix(_REGISTRY_SUFFIX)
        if reg_mod is None:
            return []
        registry = _registry(reg_mod)
        if not registry:
            return []
        out: List[Finding] = []
        seen: Set[str] = set()
        for kind in sorted(registry):
            entry = registry[kind]
            sketch = entry.get("sketch") if isinstance(entry, dict) \
                else None
            if not sketch or sketch in seen:
                continue
            seen.add(sketch)
            merge = entry.get("merge") or _SKETCH_MERGE_DEFAULT.get(sketch)
            allowed = _ALGEBRA_OPS.get(merge)
            if allowed is None:
                continue
            smod = self.project.by_suffix(f"ops/{sketch}.py")
            if smod is None:
                continue
            fn = self.index.functions.get((smod.name, "merge_registers"))
            if fn is None:
                continue
            for cls, spelling, line in _fold_ops(fn):
                if cls in allowed:
                    continue
                out.append(Finding(
                    "mesh", "sketch-merge-mismatch", smod.relpath, line,
                    f"{sketch}.merge_registers",
                    f"{sketch} registers merge via {spelling} (a {cls} "
                    f"fold) but AGG_CLOSURE declares the {merge!r} "
                    f"register algebra; folding registers with the wrong "
                    f"operator corrupts every merged estimate silently"))
        return out

    # -- merge-op-mismatch -----------------------------------------------------
    def merge_op_findings(self) -> List[Finding]:
        out: List[Finding] = []
        for fid, fn in sorted(self.index.functions.items()):
            mi = self.index.modules[fid[0]]
            for node in walk_shallow(fn):
                if not isinstance(node, ast.If):
                    continue
                kind = _kind_branch(node.test)
                if kind is None:
                    continue
                for stmt in node.body:
                    for cls, spelling, line in _fold_ops(stmt):
                        if cls == kind:
                            continue
                        out.append(Finding(
                            "mesh", "merge-op-mismatch", mi.mod.relpath,
                            line, f"{fid[1]}:{kind}",
                            f"{fid[1]} merges kind == {kind!r} partials "
                            f"with {spelling} (a {cls} fold); extrema "
                            f"merge with the matching {kind} — anything "
                            f"else returns garbage whenever more than one "
                            f"slot or rank holds the group"))
        return out

    # -- collective-outside-turn -----------------------------------------------
    def _collectives(self, mh: Module) -> Set[FuncId]:
        """Functions of the multihost module that reach a
        ``torch.distributed`` collective (directly or through another
        such function of the module)."""
        idx = self.index
        mi = idx.modules[mh.name]
        fns = {fid: fn for fid, fn in idx.functions.items()
               if fid[0] == mh.name}
        coll = {fid for fid, fn in fns.items()
                if any(isinstance(n, ast.Call) and _is_dist_collective(n)
                       for n in walk_shallow(fn))}
        changed = True
        while changed:
            changed = False
            for fid, fn in fns.items():
                if fid in coll:
                    continue
                local = idx.local_types(mi, idx.func_class[fid], fn)
                for n in walk_shallow(fn):
                    if isinstance(n, ast.Call) and any(
                            c in coll for c in idx.resolve_call(
                                mi, idx.func_class[fid], n, local,
                                enclosing_qual=fid[1])):
                        coll.add(fid)
                        changed = True
                        break
        return coll

    def _protocol(self, mh: Module) -> Set[FuncId]:
        """``initialize`` / ``shutdown`` and every method of the class
        whose instance is the module's ``SEQUENCER``."""
        seq_cls = None
        for node in mh.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "SEQUENCER" \
                    and isinstance(node.value, ast.Call):
                seq_cls = call_chain(node.value.func)[-1:]
        out = set()
        for fid in self.index.functions:
            if fid[0] != mh.name:
                continue
            head = fid[1].split(".")[0]
            if fid[1] in _PROTOCOL or (seq_cls and head == seq_cls[0]):
                out.add(fid)
        return out

    def _sites(self):
        """``(edges, direct)``: ``(caller, callee, line, ok)`` for every
        resolved call in the project, and ``(caller, name, line, ok)`` for
        every direct ``torch.distributed`` collective; ``ok`` when the
        site holds a SEQUENCER turn or sits in a single-process branch."""
        idx = self.index
        edges: List[Tuple[FuncId, FuncId, int, bool]] = []
        direct: List[Tuple[FuncId, str, int, bool]] = []
        for fid, fn in idx.functions.items():
            mi = idx.modules[fid[0]]
            ci = idx.func_class[fid]
            local = idx.local_types(mi, ci, fn)

            def scan(node, ok):
                for n in walk_shallow(node):
                    if not isinstance(n, ast.Call):
                        continue
                    if _is_dist_collective(n):
                        direct.append((fid, ".".join(call_chain(n.func)),
                                       n.lineno, ok))
                    for c in idx.resolve_call(mi, ci, n, local,
                                              enclosing_qual=fid[1]):
                        edges.append((fid, c, n.lineno, ok))

            def walk(stmts, ok):
                for st in stmts:
                    if isinstance(st, (ast.FunctionDef,
                                       ast.AsyncFunctionDef,
                                       ast.ClassDef)):
                        continue
                    if isinstance(st, (ast.With, ast.AsyncWith)):
                        turn = ok or any(_is_turn(i.context_expr)
                                         for i in st.items)
                        for i in st.items:
                            scan(i.context_expr, ok)
                        walk(st.body, turn)
                        continue
                    if isinstance(st, ast.If):
                        branch = _single_process_branch(st.test)
                        scan(st.test, ok)
                        walk(st.body, ok or branch == "body")
                        walk(st.orelse, ok or branch == "orelse")
                        continue
                    if isinstance(st, (ast.For, ast.AsyncFor, ast.While,
                                       ast.Try)):
                        for field in ("iter", "test"):
                            sub = getattr(st, field, None)
                            if sub is not None:
                                scan(sub, ok)
                        walk(st.body, ok)
                        walk(st.orelse, ok)
                        walk(getattr(st, "finalbody", ()), ok)
                        for h in getattr(st, "handlers", ()):
                            walk(h.body, ok)
                        continue
                    scan(st, ok)

            walk(fn.body, False)
        return edges, direct

    def turn_findings(self) -> List[Finding]:
        mh = self.project.by_suffix(_MULTIHOST_SUFFIX)
        if mh is None:
            return []
        idx = self.index
        protocol = self._protocol(mh)
        # joining (initialize) is not a statement's collective
        coll = self._collectives(mh) - protocol
        exempt = coll | protocol
        edges, direct = self._sites()
        callers: Dict[FuncId, List[Tuple[FuncId, bool]]] = {}
        for a, b, _, ok in edges:
            callers.setdefault(b, []).append((a, ok))
        # greatest fixpoint: a function is covered when every resolved
        # caller site holds a turn or lies in a covered / exempt function;
        # an entry (no resolved caller) is not, unless it is a nested def
        covered = {fid for fid in idx.functions
                   if fid in callers
                   or (fid[0], fid[1].rpartition(".")[0]) in idx.functions}
        changed = True
        while changed:
            changed = False
            for fid in list(covered):
                if any(not ok and a not in covered and a not in exempt
                       for a, ok in callers.get(fid, ())):
                    covered.discard(fid)
                    changed = True
        out: List[Finding] = []
        seen: Set[Tuple[FuncId, str]] = set()
        sites = [(a, b[1], line, ok) for a, b, line, ok in edges
                 if b in coll] + list(direct)
        for caller, callee, line, ok in sorted(sites):
            if ok or caller in exempt or caller in covered \
                    or (caller, callee) in seen:
                continue
            seen.add((caller, callee))
            out.append(Finding(
                "mesh", "collective-outside-turn",
                idx.modules[caller[0]].mod.relpath, line,
                f"{caller[1]}:{callee}",
                f"{caller[1]} issues the collective {callee} outside a "
                f"multihost.SEQUENCER turn, and not every path into it "
                f"holds one: ranks running statements on several threads "
                f"can issue their collectives in different orders and "
                f"deadlock"))
        return out


def run(project: Project) -> List[Finding]:
    m = _Mesh(project)
    return m.sketch_findings() + m.merge_op_findings() + m.turn_findings()
