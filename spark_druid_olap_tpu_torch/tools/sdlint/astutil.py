"""Best-effort call-graph and type resolution over a :class:`Project`.

Port of the JAX package's ``tools/sdlint/astutil.py``, unchanged.

The resolution here is deliberately approximate (no execution, no
imports): names resolve through ``import`` statements, ``self.x``
through recorded attribute assignments, constructor parameters through
the types observed at the class's instantiation sites, and — as a last
resort — method calls through a project-unique method name. Anything
unresolvable is silently dropped: the passes built on top are designed
so an unresolved call can only *miss* a finding, never invent one.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from spark_druid_olap_tpu_torch.tools.sdlint.core import Module, Project

# (module_name, qualname) — qualname is "func", "Class.method",
# "outer.inner" for nested defs, "Cls.meth.Nested.meth" for nested classes
FuncId = Tuple[str, str]
# (module_name, class_qualname)
TypeRef = Tuple[str, str]

_LOCK_FACTORIES = ("Lock", "RLock", "Condition")

# method names that collide with builtin container / io / threading
# protocols: never resolved through the unique-name fallback, because
# `self._entries.pop(...)` on an untyped dict would otherwise bind to
# the project's one class that happens to define `pop`
_FALLBACK_EXCLUDE = frozenset({
    "get", "set", "pop", "popitem", "update", "clear", "append", "add",
    "remove", "discard", "extend", "insert", "setdefault", "items",
    "keys", "values", "copy", "index", "count", "sort", "split", "join",
    "strip", "read", "write", "close", "open", "flush", "seek",
    "acquire", "release", "wait", "notify", "notify_all", "put",
    "start", "stop", "run", "join", "send", "recv", "encode", "decode",
})


def _threading_factory(call: ast.expr) -> Optional[str]:
    """'Lock'/'RLock'/'Condition' when ``call`` constructs one, handling
    both ``threading.Lock()`` and ``__import__("threading").Lock()``."""
    if not (isinstance(call, ast.Call)
            and isinstance(call.func, ast.Attribute)
            and call.func.attr in _LOCK_FACTORIES):
        return None
    base = call.func.value
    if isinstance(base, ast.Name) and base.id == "threading":
        return call.func.attr
    if (isinstance(base, ast.Call) and isinstance(base.func, ast.Name)
            and base.func.id == "__import__" and base.args
            and isinstance(base.args[0], ast.Constant)
            and base.args[0].value == "threading"):
        return call.func.attr
    return None


class ClassInfo:
    def __init__(self, module: str, qual: str, node: ast.ClassDef):
        self.module = module
        self.qual = qual            # dotted position, e.g. "SqlServer.start.Handler"
        self.node = node
        self.methods: Dict[str, ast.FunctionDef] = {}
        self.attr_types: Dict[str, TypeRef] = {}
        self.lock_attrs: Dict[str, str] = {}   # attr -> Lock/RLock/Condition
        # attr -> __init__ parameter name it was assigned from (resolved
        # against instantiation-site argument types in a second round)
        self.attr_from_param: Dict[str, str] = {}

    @property
    def ref(self) -> TypeRef:
        return (self.module, self.qual)


class ModuleInfo:
    def __init__(self, mod: Module):
        self.mod = mod
        # alias -> ("module", dotted) | ("symbol", dotted_module, symbol)
        self.imports: Dict[str, tuple] = {}
        self.functions: Dict[str, ast.FunctionDef] = {}   # top-level only
        self.classes: Dict[str, ClassInfo] = {}           # by qual AND bare name
        self.module_locks: Dict[str, str] = {}


class Index:
    """Project-wide symbol/type index + call resolution."""

    def __init__(self, project: Project):
        self.project = project
        self.modules: Dict[str, ModuleInfo] = {}
        # every function (incl. methods and nested defs), by FuncId
        self.functions: Dict[FuncId, ast.FunctionDef] = {}
        self.func_class: Dict[FuncId, Optional[ClassInfo]] = {}
        # method name -> FuncIds across all classes (fallback resolution)
        self.method_index: Dict[str, List[FuncId]] = {}
        for mod in project.modules.values():
            self._index_module(mod)
        # attr/type recording second: it resolves imports across modules,
        # so every module must be indexed first
        for mi in self.modules.values():
            for ci in set(mi.classes.values()):
                self._record_attrs(mi, ci)
        self._infer_ctor_param_types()

    # -- construction ----------------------------------------------------------
    def _index_module(self, mod: Module) -> None:
        mi = ModuleInfo(mod)
        self.modules[mod.name] = mi
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mi.imports[a.asname or a.name.split(".")[0]] = \
                        ("module", a.name)
            elif isinstance(node, ast.ImportFrom) and node.module:
                base = node.module
                if node.level:      # relative: anchor inside the package
                    parts = mod.name.split(".")
                    parts = parts[: len(parts) - node.level]
                    base = ".".join(parts + [node.module])
                for a in node.names:
                    target = self.project.module_for_import(
                        f"{base}.{a.name}")
                    if target is not None:
                        mi.imports[a.asname or a.name] = \
                            ("module", f"{base}.{a.name}")
                    else:
                        mi.imports[a.asname or a.name] = \
                            ("symbol", base, a.name)
        self._index_body(mi, mod.tree.body, "", None, top=True)

    def _index_body(self, mi: ModuleInfo, body, prefix: str,
                    ci: Optional[ClassInfo], top: bool) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = prefix + stmt.name
                fid = (mi.mod.name, qual)
                self.functions[fid] = stmt
                self.func_class[fid] = ci
                if ci is None and not prefix:
                    mi.functions.setdefault(stmt.name, stmt)
                direct_method = ci is not None and prefix == ci.qual + "."
                if direct_method and stmt.name not in ci.methods:
                    ci.methods[stmt.name] = stmt
                    self.method_index.setdefault(stmt.name, []).append(fid)
                # nested defs/classes live inside, with this fn's scope
                self._index_body(mi, stmt.body, qual + ".", ci, top=False)
            elif isinstance(stmt, ast.ClassDef):
                qual = prefix + stmt.name
                sub = ClassInfo(mi.mod.name, qual, stmt)
                mi.classes[qual] = sub
                mi.classes.setdefault(stmt.name, sub)
                self._index_body(mi, stmt.body, qual + ".", sub, top=False)
            elif top and isinstance(stmt, ast.Assign) \
                    and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                kind = _threading_factory(stmt.value)
                if kind is not None:
                    mi.module_locks[stmt.targets[0].id] = kind
            elif isinstance(stmt, (ast.If, ast.Try, ast.While, ast.For,
                                   ast.AsyncFor, ast.With, ast.AsyncWith)):
                # defs under guards/loops/with (e.g. `if pa is not None:`
                # fallbacks, a build closure inside a retry loop) are
                # still defs of the enclosing scope
                self._index_body(mi, stmt.body, prefix, ci, top)
                for h in getattr(stmt, "handlers", ()):
                    self._index_body(mi, h.body, prefix, ci, top)
                self._index_body(mi, getattr(stmt, "orelse", ()), prefix,
                                 ci, top)
                self._index_body(mi, getattr(stmt, "finalbody", ()),
                                 prefix, ci, top)

    def _record_attrs(self, mi: ModuleInfo, ci: ClassInfo) -> None:
        """``self.x = ...`` sites: lock factories, known-class
        constructions, and parameter pass-throughs."""
        for meth in set(ci.methods.values()):
            params = [a.arg for a in meth.args.args[1:]]
            for node in ast.walk(meth):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1):
                    continue
                t = node.targets[0]
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                kind = _threading_factory(node.value)
                if kind is not None:
                    ci.lock_attrs[t.attr] = kind
                    continue
                tr = self._type_of_construction(mi, node.value)
                if tr is not None:
                    ci.attr_types.setdefault(t.attr, tr)
                elif (meth.name == "__init__"
                      and isinstance(node.value, ast.Name)
                      and node.value.id in params):
                    ci.attr_from_param.setdefault(t.attr, node.value.id)

    def _type_of_construction(self, mi: ModuleInfo,
                              value: ast.expr) -> Optional[TypeRef]:
        """``ClassName(...)`` / ``alias.ClassName(...)`` -> TypeRef."""
        if not isinstance(value, ast.Call):
            return None
        f = value.func
        if isinstance(f, ast.Name):
            return self._class_named(mi, f.id)
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            imp = mi.imports.get(f.value.id)
            if imp and imp[0] == "module":
                tm = self.project.module_for_import(imp[1])
                if tm is not None:
                    tci = self.modules[tm.name].classes.get(f.attr)
                    if tci is not None:
                        return tci.ref
        return None

    def _class_named(self, mi: ModuleInfo, name: str) -> Optional[TypeRef]:
        ci = mi.classes.get(name)
        if ci is not None:
            return ci.ref
        imp = mi.imports.get(name)
        if imp and imp[0] == "symbol":
            tm = self.project.module_for_import(imp[1])
            if tm is not None:
                tci = self.modules[tm.name].classes.get(imp[2])
                if tci is not None:
                    return tci.ref
        return None

    def _infer_ctor_param_types(self) -> None:
        """Round 2: for ``self.engine = engine`` style pass-throughs,
        look at every ``Cls(...)`` instantiation in the project and, when
        all sites agree on the argument's type, adopt it."""
        wanted: Dict[TypeRef, Dict[str, str]] = {}
        for mi in self.modules.values():
            for ci in set(mi.classes.values()):
                if ci.attr_from_param:
                    wanted[ci.ref] = ci.attr_from_param
        if not wanted:
            return
        observed: Dict[Tuple[TypeRef, str], Set[TypeRef]] = {}
        for fid, fn in self.functions.items():
            mi = self.modules[fid[0]]
            ci = self.func_class[fid]
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                tr = self._type_of_construction(mi, node)
                if tr is None or tr not in wanted:
                    continue
                init = self.class_info(tr).methods.get("__init__")
                if init is None:
                    continue
                pnames = [a.arg for a in init.args.args[1:]]
                bound: Dict[str, ast.expr] = {}
                for i, a in enumerate(node.args):
                    if i < len(pnames):
                        bound[pnames[i]] = a
                for kw in node.keywords:
                    if kw.arg:
                        bound[kw.arg] = kw.value
                for attr, pname in wanted[tr].items():
                    a = bound.get(pname)
                    if a is None:
                        continue
                    at = self._static_expr_type(mi, ci, a)
                    if at is not None:
                        observed.setdefault((tr, attr), set()).add(at)
        for (tr, attr), types in observed.items():
            if len(types) == 1:
                self.class_info(tr).attr_types.setdefault(
                    attr, next(iter(types)))

    def _static_expr_type(self, mi: ModuleInfo, ci: Optional[ClassInfo],
                          expr: ast.expr) -> Optional[TypeRef]:
        if isinstance(expr, ast.Name) and expr.id == "self" \
                and ci is not None:
            return ci.ref
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and ci is not None:
            return ci.attr_types.get(expr.attr)
        return self._type_of_construction(mi, expr)

    # -- lookups ---------------------------------------------------------------
    def class_info(self, ref: TypeRef) -> ClassInfo:
        return self.modules[ref[0]].classes[ref[1]]

    def func_node(self, fid: FuncId) -> Optional[ast.FunctionDef]:
        return self.functions.get(fid)

    # -- expression typing inside a function body ------------------------------
    def local_types(self, mi: ModuleInfo, ci: Optional[ClassInfo],
                    fn: ast.FunctionDef) -> Dict[str, TypeRef]:
        """Locals with inferable types: ``eng = self.engine``,
        ``x = Cls(...)``; single forward pass, last assignment wins."""
        out: Dict[str, TypeRef] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tr = self._expr_type(mi, ci, node.value, out)
                if tr is not None:
                    out[node.targets[0].id] = tr
        return out

    def _expr_type(self, mi: ModuleInfo, ci: Optional[ClassInfo],
                   expr: ast.expr,
                   local: Dict[str, TypeRef]) -> Optional[TypeRef]:
        if isinstance(expr, ast.Name):
            if expr.id == "self" and ci is not None:
                return ci.ref
            return local.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = self._expr_type(mi, ci, expr.value, local)
            if base is not None:
                return self.class_info(base).attr_types.get(expr.attr)
            return None
        return self._type_of_construction(mi, expr)

    # -- call resolution -------------------------------------------------------
    def resolve_call(self, mi: ModuleInfo, ci: Optional[ClassInfo],
                     call: ast.Call, local: Dict[str, TypeRef],
                     enclosing_qual: str = "",
                     unique_fallback: bool = False) -> List[FuncId]:
        """Call expression -> candidate FuncIds (empty when external)."""
        f = call.func
        if isinstance(f, ast.Name):
            nested = self._nested_def(mi, enclosing_qual, f.id)
            if nested is not None:
                return [nested]
            if f.id in mi.functions:
                return [(mi.mod.name, f.id)]
            tr = self._class_named(mi, f.id)
            if tr is not None:
                tci = self.class_info(tr)
                if "__init__" in tci.methods:
                    return [(tr[0], f"{tr[1]}.__init__")]
                return []
            imp = mi.imports.get(f.id)
            if imp and imp[0] == "symbol":
                tm = self.project.module_for_import(imp[1])
                if tm is not None \
                        and imp[2] in self.modules[tm.name].functions:
                    return [(tm.name, imp[2])]
            return []
        if not isinstance(f, ast.Attribute):
            return []
        # alias.func / alias.Class(...) / ClassName.method(obj, ...)
        if isinstance(f.value, ast.Name):
            imp = mi.imports.get(f.value.id)
            if imp and imp[0] == "module":
                tm = self.project.module_for_import(imp[1])
                if tm is not None:
                    tmi = self.modules[tm.name]
                    if f.attr in tmi.functions:
                        return [(tm.name, f.attr)]
                    tci = tmi.classes.get(f.attr)
                    if tci is not None and "__init__" in tci.methods:
                        return [(tm.name, f"{tci.qual}.__init__")]
                    return []
            tr = self._class_named(mi, f.value.id)
            if tr is not None:
                tci = self.class_info(tr)
                if f.attr in tci.methods:
                    return [(tr[0], f"{tr[1]}.{f.attr}")]
                return []
        # obj.method() through typed expressions (self, self.attr, locals)
        base = self._expr_type(mi, ci, f.value, local)
        if base is not None:
            tci = self.class_info(base)
            if f.attr in tci.methods:
                return [(base[0], f"{base[1]}.{f.attr}")]
            return []
        if unique_fallback and f.attr not in _FALLBACK_EXCLUDE:
            cands = self.method_index.get(f.attr, [])
            if len(cands) == 1:
                return list(cands)
        return []

    def _nested_def(self, mi: ModuleInfo, enclosing_qual: str,
                    name: str) -> Optional[FuncId]:
        """Resolve a bare Name to a def nested in the enclosing function
        (or any enclosing scope up the qualname chain)."""
        parts = enclosing_qual.split(".") if enclosing_qual else []
        while parts:
            fid = (mi.mod.name, ".".join(parts + [name]))
            if fid in self.functions:
                return fid
            parts.pop()
        return None

    def resolve_func_ref(self, mi: ModuleInfo, ci: Optional[ClassInfo],
                         expr: ast.expr, local: Dict[str, TypeRef],
                         enclosing_qual: str = "") -> Optional[FuncId]:
        """A *reference* to a function (``Thread(target=here)``)."""
        if isinstance(expr, ast.Name):
            nested = self._nested_def(mi, enclosing_qual, expr.id)
            if nested is not None:
                return nested
            if expr.id in mi.functions:
                return (mi.mod.name, expr.id)
            return None
        if isinstance(expr, ast.Attribute):
            base = self._expr_type(mi, ci, expr.value, local)
            if base is not None:
                tci = self.class_info(base)
                if expr.attr in tci.methods:
                    return (base[0], f"{base[1]}.{expr.attr}")
            if expr.attr not in _FALLBACK_EXCLUDE:
                cands = self.method_index.get(expr.attr, [])
                if len(cands) == 1:
                    return cands[0]
        return None

    # -- lock expression resolution --------------------------------------------
    def resolve_lock(self, mi: ModuleInfo, ci: Optional[ClassInfo],
                     expr: ast.expr,
                     local: Dict[str, TypeRef]) -> Optional[Tuple[str, str]]:
        """Lock identity ("<mod>.<Cls>.<attr>" / "<mod>.<name>") + kind,
        or None when ``expr`` is not a recognizable lock."""
        if isinstance(expr, ast.Name):
            kind = mi.module_locks.get(expr.id)
            if kind is not None:
                return (f"{mi.mod.name}.{expr.id}", kind)
            return None
        if not isinstance(expr, ast.Attribute):
            return None
        base = self._expr_type(mi, ci, expr.value, local)
        if base is not None:
            bci = self.class_info(base)
            kind = bci.lock_attrs.get(expr.attr)
            if kind is not None:
                return (f"{base[0]}.{base[1]}.{expr.attr}", kind)
        if isinstance(expr.value, ast.Name):
            imp = mi.imports.get(expr.value.id)
            if imp and imp[0] == "module":
                tm = self.project.module_for_import(imp[1])
                if tm is not None:
                    kind = self.modules[tm.name].module_locks.get(expr.attr)
                    if kind is not None:
                        return (f"{tm.name}.{expr.attr}", kind)
        return None


def resolve_kernel_refs(idx: Index, mi: ModuleInfo,
                        ci: Optional[ClassInfo], expr: ast.expr,
                        local: Dict[str, TypeRef],
                        enclosing_qual: str = "",
                        depth: int = 4) -> List[FuncId]:
    """Every function a kernel-position expression may denote.

    Handles the three spellings a tracer's call site may use:

    - a direct reference (``make_fx(probe, ...)``),
    - ``functools.partial(kernel, n)`` — unwraps to ``kernel``,
    - a *factory call* (``make_fx(_make_probe(...), ...)``) —
      resolves to whatever the factory's ``return`` statements denote,
      recursively, so factories that return partials or call further
      inner factories still root the innermost def.

    ``depth`` bounds the factory recursion (cycles in pathological
    trees); unresolvable expressions drop silently, as everywhere else.
    """
    out: List[FuncId] = []
    if depth < 0:
        return out
    if isinstance(expr, ast.Call):
        chain = call_chain(expr.func)
        if chain and chain[-1] == "partial":
            if expr.args:
                out.extend(resolve_kernel_refs(
                    idx, mi, ci, expr.args[0], local,
                    enclosing_qual=enclosing_qual, depth=depth))
            return out
        for factory in idx.resolve_call(mi, ci, expr, local,
                                        enclosing_qual=enclosing_qual):
            ffn = idx.functions.get(factory)
            if ffn is None:
                continue
            fmi = idx.modules[factory[0]]
            fci = idx.func_class[factory]
            flocal = idx.local_types(fmi, fci, ffn)
            for node in ast.walk(ffn):
                if isinstance(node, ast.Return) and node.value is not None:
                    out.extend(resolve_kernel_refs(
                        idx, fmi, fci, node.value, flocal,
                        enclosing_qual=factory[1], depth=depth - 1))
        return out
    ref = idx.resolve_func_ref(mi, ci, expr, local,
                               enclosing_qual=enclosing_qual)
    if ref is not None:
        out.append(ref)
    return out


def dotted_name(expr: ast.expr) -> Optional[str]:
    """'a.b.c' for a pure attribute chain, else None."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return None


def call_chain(expr: ast.expr) -> List[str]:
    """Best-effort segment chain of a call target, descending through
    intermediate calls and subscripts: ``self._wal_for(name).append``
    -> ``['self', '_wal_for', 'append']``; empty when nothing named."""
    parts: List[str] = []
    while True:
        if isinstance(expr, ast.Attribute):
            parts.append(expr.attr)
            expr = expr.value
        elif isinstance(expr, ast.Call):
            expr = expr.func
        elif isinstance(expr, ast.Subscript):
            expr = expr.value
        elif isinstance(expr, ast.Name):
            parts.append(expr.id)
            break
        else:
            break
    return list(reversed(parts))


def walk_shallow(node: ast.AST):
    """``ast.walk`` that does not descend into nested function / class /
    lambda bodies — the statements of *this* frame only. (A call inside
    a nested ``def`` runs when the closure runs, not here.)"""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            stack.append(child)
