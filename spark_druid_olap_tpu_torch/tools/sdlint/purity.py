"""Tracer-purity pass, over the port's ``make_fx`` traces.

The port of the JAX package's ``tools/sdlint/purity.py``. The JAX pass
roots at ``jax.jit`` / ``shard_map`` / ``pallas_call``; the port has no
jit: the one function it traces is the wave kernel's lane ``probe``,
which ``ops/cuda_wave.compile_wave`` runs once under
``make_fx(probe, tracing_mode="fake")`` to lower every lane of a fused
group to the kernel's instructions. Functions reachable from a
``make_fx`` (or ``torch.fx.symbolic_trace`` / ``torch.jit.trace``) site
run over fake tensors that hold no values. Three rules, with JAX's
names:

- **host-call** — a traced function calls a host-only API
  (``time.*``, ``random.*``, ``np.random.*``, ``threading.*``,
  ``logging.*``, ``os.*``, ``open``/``print``/``input``, sockets,
  subprocess) or takes a lock: it runs once at trace time and its
  effect is missing from the compiled program.
- **traced-branch** — ``if``/``while`` on a value derived from a
  ``torch.*`` result or from the traced function's own tensor
  arguments: a fake tensor has no value to branch on, so the trace
  raises.
- **concretize** — ``float()/int()/bool()/np.asarray()/np.array()`` or
  ``.item()/.tolist()/.numpy()`` on such a value: raises under fake
  tracing.

Why it matters: ``compile_wave`` turns any raise inside the trace into
``WaveFallback("lane trace failed: ...")``, and the storm quietly
leaves the wave kernel (B2) for the lane-by-lane program, so a purity
fault shows as a slower storm, never as an error.

Root discovery keeps the JAX pass's idioms: a function that passes one
of its own parameters into a tracer marks the argument at every call
site as a root; factory calls and ``functools.partial`` in function
position resolve to the def they denote. Reachability follows calls
that resolve by import, ``self`` / local type or a project-unique
method name (the lane plans' ``build`` / ``build_values`` /
``build_mask`` and the scan context's ``col`` are reached that way).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from spark_druid_olap_tpu_torch.tools.sdlint.astutil import (FuncId, Index,
                                                       dotted_name,
                                                       resolve_kernel_refs)
from spark_druid_olap_tpu_torch.tools.sdlint.core import Finding, Project

# dotted names of calls that trace their function-valued first argument
_JIT_LIKE = {"make_fx", "proxy_tensor.make_fx",
             "torch.fx.experimental.proxy_tensor.make_fx",
             "symbolic_trace", "fx.symbolic_trace",
             "torch.fx.symbolic_trace", "torch.jit.trace"}

_HOST_PREFIXES = ("time.", "random.", "np.random.", "numpy.random.",
                  "threading.", "logging.", "os.", "socket.",
                  "subprocess.", "requests.", "shutil.", "pathlib.")
_HOST_CALLS = {"open", "print", "input", "time", "sleep"}
_CONCRETIZE_FUNCS = {"float", "int", "bool", "np.asarray", "np.array",
                     "numpy.asarray", "numpy.array", "np.frombuffer"}
_CONCRETIZE_METHODS = {"item", "tolist", "numpy"}
# attribute reads that stay static even on a fake tensor: tensor
# metadata plus the engine's own plan/route metadata vocabulary
# (AggInput.is_int, Route.kind/tag, AggregationSpec.name, ... — python
# values computed at plan time, carried on objects that also hold
# traced tensors)
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_floating_point",
                 "numel", "dim", "size", "is_cuda", "is_float", "is_int",
                 "kind", "card", "merged", "tag", "maxabs", "spec",
                 "name", "n_lanes"}
# tensor-producing namespace
_TAINT_PREFIXES = ("torch.",)
# torch.* calls whose results are host values, not tensors
_STATIC_TORCH = ("torch.device", "torch.iinfo", "torch.finfo",
                 "torch.is_tensor", "torch.is_floating_point",
                 "torch.get_default_dtype", "torch.promote_types",
                 "torch.result_type", "torch.Size", "torch.cuda.",
                 "torch.backends.", "torch.distributed.")


def _expr_tainted(expr: ast.expr, tainted: Set[str]) -> bool:
    """May ``expr`` evaluate to a tracer? Attribute reads in
    ``_STATIC_ATTRS`` cut taint (metadata, not arrays); ``x is None``
    comparisons are static control flow even on tracers; comprehension
    variables inherit taint from their iterable."""
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, ast.Attribute):
        if expr.attr in _STATIC_ATTRS:
            return False
        return _expr_tainted(expr.value, tainted)
    if isinstance(expr, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return False
        return any(_expr_tainted(e, tainted)
                   for e in [expr.left] + expr.comparators)
    if isinstance(expr, ast.Call):
        name = dotted_name(expr.func)
        if name in ("isinstance", "issubclass", "len", "type", "hasattr",
                    "callable", "id", "repr", "str"):
            return False            # static predicates even on tracers
        if name and name.startswith(_TAINT_PREFIXES) \
                and not name.startswith(_STATIC_TORCH):
            return True
        parts = ([] if name else [expr.func]) + list(expr.args) \
            + [kw.value for kw in expr.keywords]
        if name and isinstance(expr.func, ast.Attribute):
            parts.append(expr.func.value)   # x.sum() on a tracer
        return any(_expr_tainted(e, tainted) for e in parts)
    if isinstance(expr, (ast.GeneratorExp, ast.ListComp, ast.SetComp,
                         ast.DictComp)):
        inner = set(tainted)
        for gen in expr.generators:
            if _expr_tainted(gen.iter, tainted):
                for n in ast.walk(gen.target):
                    if isinstance(n, ast.Name):
                        inner.add(n.id)
        elts = [expr.key, expr.value] if isinstance(expr, ast.DictComp) \
            else [expr.elt]
        return any(_expr_tainted(e, inner) for e in elts)
    if isinstance(expr, (ast.Lambda, ast.FunctionDef)):
        return False
    return any(_expr_tainted(e, tainted)
               for e in ast.iter_child_nodes(expr)
               if isinstance(e, ast.expr))


# method names of tensors and arrays (and the lane plans' closures named
# ``build``): never resolved through the project-unique-name fallback,
# which would bind ``day.max()`` to the one project class defining max
_TENSOR_METHODS = frozenset({
    "build", "min", "max", "sum", "any", "all", "mean", "where", "view",
    "reshape", "to", "flatten", "clone", "long", "int", "float", "bool",
    "contiguous", "expand", "gather", "scatter", "index_select",
    "masked_fill", "clamp", "abs", "neg", "round", "floor", "ceil",
    "searchsorted", "cumsum"})


def _annotated_params(idx: Index, mi, fn) -> Dict[str, tuple]:
    """Parameters typed by their annotation (``ctx: ScanContext``,
    ``cse: Optional[FU.CSECache]``): the lane builders take the scan
    context and the CSE cache as parameters, so this is how the trace's
    calls on them resolve."""
    out: Dict[str, tuple] = {}
    for a in fn.args.args + fn.args.kwonlyargs:
        ann = a.annotation
        if isinstance(ann, ast.Subscript) \
                and dotted_name(ann.value) in ("Optional",
                                               "typing.Optional"):
            ann = ann.slice
        tr = None
        if isinstance(ann, ast.Name):
            tr = idx._class_named(mi, ann.id)
        elif isinstance(ann, ast.Attribute):
            tr = idx._type_of_construction(
                mi, ast.Call(func=ann, args=[], keywords=[]))
        if tr is not None:
            out[a.arg] = tr
    return out


def _is_tracer(name: str) -> bool:
    return name in _JIT_LIKE or name.split(".")[-1] == "make_fx"


class _Purity:
    def __init__(self, project: Project):
        self.project = project
        self.index = project.index()   # shared: parsed/typed once for all passes
        # param positions (by name) of each function that get traced
        self.wrapper_params: Dict[FuncId, Set[str]] = {}
        self._find_wrapper_params()
        self.roots: Dict[FuncId, Tuple[str, int]] = {}   # fid -> site
        self._find_roots()
        self.reachable = self._reach()

    # -- roots -----------------------------------------------------------------
    def _find_wrapper_params(self) -> None:
        for fid, fn in self.index.functions.items():
            params = {a.arg for a in fn.args.args}
            traced: Set[str] = set()
            aliases: Dict[str, str] = {}    # local alias -> param
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id in params:
                    aliases[node.targets[0].id] = node.value.id
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if name is None or not _is_tracer(name):
                    continue
                for a in node.args[:1]:
                    if isinstance(a, ast.Name):
                        p = a.id if a.id in params else aliases.get(a.id)
                        if p:
                            traced.add(p)
            if traced:
                self.wrapper_params[fid] = traced

    def _add_root_expr(self, mi, ci, expr: ast.expr, local,
                       enclosing_qual: str, site: Tuple[str, int]) -> None:
        idx = self.index
        if isinstance(expr, ast.Lambda):
            # the lambda body is one expression: follow the calls it makes
            for node in ast.walk(expr.body):
                if isinstance(node, ast.Call):
                    for callee in idx.resolve_call(
                            mi, ci, node, local,
                            enclosing_qual=enclosing_qual):
                        self.roots.setdefault(callee, site)
            return
        # direct refs, factory-returned functions (``make_fx(
        # _make_probe(...))``), ``functools.partial``-wrapped ones, and
        # factories-returning-factories all resolve through the shared
        # helper — the factory call runs untraced, but the function it
        # ultimately denotes is what traces
        for ref in resolve_kernel_refs(idx, mi, ci, expr, local,
                                       enclosing_qual=enclosing_qual):
            self.roots.setdefault(ref, site)

    def _find_roots(self) -> None:
        idx = self.index
        for fid, fn in self.index.functions.items():
            mi = idx.modules[fid[0]]
            ci = idx.func_class[fid]
            local = idx.local_types(mi, ci, fn)
            site = (mi.mod.relpath, fn.lineno)
            # decorators: @torch.jit.trace-style / @partial(tracer, ...)
            for dec in fn.decorator_list:
                name = dotted_name(dec if not isinstance(dec, ast.Call)
                                   else dec.func)
                if name and _is_tracer(name):
                    self.roots.setdefault(fid, site)
                elif name in ("partial", "functools.partial") \
                        and isinstance(dec, ast.Call) and dec.args:
                    inner = dotted_name(dec.args[0])
                    if inner and _is_tracer(inner):
                        self.roots.setdefault(fid, site)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if name is not None and _is_tracer(name):
                    for a in node.args[:1]:
                        self._add_root_expr(mi, ci, a, local, fid[1],
                                            (mi.mod.relpath, node.lineno))
                    continue
                # wrapper call sites: self._shard_wrap(core, ...)
                for callee in idx.resolve_call(mi, ci, node, local,
                                               enclosing_qual=fid[1],
                                               unique_fallback=True):
                    traced = self.wrapper_params.get(callee)
                    if not traced:
                        continue
                    cfn = idx.functions[callee]
                    pnames = [a.arg for a in cfn.args.args]
                    if pnames and pnames[0] == "self":
                        pnames = pnames[1:]
                    for i, a in enumerate(node.args):
                        if i < len(pnames) and pnames[i] in traced:
                            self._add_root_expr(
                                mi, ci, a, local, fid[1],
                                (mi.mod.relpath, node.lineno))
                    for kw in node.keywords:
                        if kw.arg in traced:
                            self._add_root_expr(
                                mi, ci, kw.value, local, fid[1],
                                (mi.mod.relpath, node.lineno))

    def _reach(self) -> Set[FuncId]:
        idx = self.index
        seen = set(self.roots)
        stack = list(self.roots)
        while stack:
            fid = stack.pop()
            fn = idx.functions.get(fid)
            if fn is None:
                continue
            mi = idx.modules[fid[0]]
            ci = idx.func_class[fid]
            local = idx.local_types(mi, ci, fn)
            local.update(_annotated_params(idx, mi, fn))
            for node in self._own_nodes(fn):
                if isinstance(node, ast.Call):
                    unique = isinstance(node.func, ast.Attribute) \
                        and node.func.attr not in _TENSOR_METHODS
                    for callee in idx.resolve_call(mi, ci, node, local,
                                                   enclosing_qual=fid[1],
                                                   unique_fallback=unique):
                        if callee not in seen:
                            seen.add(callee)
                            stack.append(callee)
        return seen

    @staticmethod
    def _own_nodes(fn: ast.FunctionDef):
        """Walk a function's body without descending into nested defs or
        lambdas (they are traced only if themselves reachable)."""
        stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    # -- per-function violation scan -------------------------------------------
    def _taints(self, fid: FuncId, fn: ast.FunctionDef) -> Set[str]:
        """Names bound (anywhere in the function) to torch expressions —
        a fixpoint over-approximation of 'is a fake tensor'. A root's
        own positional parameters are tensors too: a tracer calls the
        root with the example tensors only."""
        tainted: Set[str] = set()
        if fid in self.roots:
            tainted |= {a.arg for a in fn.args.args if a.arg != "self"}
            if fn.args.vararg is not None:
                tainted.add(fn.args.vararg.arg)

        def target_names(t: ast.expr):
            """Names BOUND by an assignment target — the base of a
            subscript/attribute, not names appearing in its slice."""
            if isinstance(t, ast.Name):
                yield t.id
            elif isinstance(t, (ast.Subscript, ast.Attribute,
                                ast.Starred)):
                base = t.value if not isinstance(t, ast.Starred) else t.value
                yield from target_names(base)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    yield from target_names(e)

        changed = True
        while changed:
            changed = False
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    if _expr_tainted(node.value, tainted):
                        for t in node.targets:
                            for nid in target_names(t):
                                if nid not in tainted:
                                    tainted.add(nid)
                                    changed = True
                elif isinstance(node, ast.AugAssign):
                    if _expr_tainted(node.value, tainted) \
                            and isinstance(node.target, ast.Name) \
                            and node.target.id not in tainted:
                        tainted.add(node.target.id)
                        changed = True
        return tainted

    def scan(self, fid: FuncId) -> List[Finding]:
        idx = self.index
        fn = idx.functions.get(fid)
        if fn is None:
            return []
        mi = idx.modules[fid[0]]
        ci = idx.func_class[fid]
        local = idx.local_types(mi, ci, fn)
        local.update(_annotated_params(idx, mi, fn))
        path = mi.mod.relpath
        tainted = self._taints(fid, fn)
        out: List[Finding] = []

        def is_tainted(expr: ast.expr) -> bool:
            return _expr_tainted(expr, tainted)

        for node in self._own_nodes(fn):
            if isinstance(node, (ast.If, ast.While)) \
                    and is_tainted(node.test):
                out.append(Finding(
                    "purity", "traced-branch", path, node.lineno,
                    f"{fid[1]}:{'while' if isinstance(node, ast.While) else 'if'}",
                    f"{fid[1]} is traced under make_fx but branches on a "
                    f"value derived from tensor ops: a fake tensor has "
                    f"no value, so the trace raises; use torch.where or "
                    f"hoist the decision to plan time"))
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lk = idx.resolve_lock(mi, ci, item.context_expr, local)
                    if lk is not None:
                        out.append(Finding(
                            "purity", "host-call", path, node.lineno,
                            f"{fid[1]}:lock", f"{fid[1]} is traced under "
                            f"make_fx but acquires lock {lk[0]}; the acquire "
                            f"runs once at trace time, not per call"))
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name is not None:
                if any(name.startswith(p) for p in _HOST_PREFIXES) \
                        or name in _HOST_CALLS:
                    out.append(Finding(
                        "purity", "host-call", path, node.lineno,
                        f"{fid[1]}:{name}",
                        f"{fid[1]} is traced under make_fx but calls "
                        f"host-only API {name}(); its value freezes at "
                        f"trace time"))
                    continue
                if name in _CONCRETIZE_FUNCS and node.args \
                        and is_tainted(node.args[0]):
                    out.append(Finding(
                        "purity", "concretize", path, node.lineno,
                        f"{fid[1]}:{name}",
                        f"{fid[1]} concretizes a traced value via "
                        f"{name}(); this raises under fake tracing"))
                    continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _CONCRETIZE_METHODS \
                    and is_tainted(node.func.value):
                out.append(Finding(
                    "purity", "concretize", path, node.lineno,
                    f"{fid[1]}:.{node.func.attr}",
                    f"{fid[1]} calls .{node.func.attr}() on a traced "
                    f"value; this raises under fake tracing"))
        return out


def run(project: Project) -> List[Finding]:
    p = _Purity(project)
    out: List[Finding] = []
    for fid in sorted(p.reachable):
        out.extend(p.scan(fid))
    return out
