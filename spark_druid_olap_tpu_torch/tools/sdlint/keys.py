"""keys pass: cache keys must cover exactly the result-affecting state.

Port of the JAX package's ``tools/sdlint/keys.py``, unchanged: its
anchors (``cache/keys.py``, ``Config.fingerprint``, every
``_cached_program`` site) have the same shape in the port.

Four cross-checks, all pure AST over the shared index:

- **K1 compile-sig-missing-config** — every ``self._cached_program(sig,
  build)`` site: config keys read anywhere in the build closure
  (transitively, depth ≤ 4 through resolvable calls) must appear as
  ``config.get(...)`` terms of the signature expression. A key read
  during program build but absent from the sig means an operator ``SET``
  keeps serving the previously compiled program — stale results that
  only show up after a mid-session config change.
- **K2 key-missing-field** — fields that ``cache/keys.py:normalize_spec``
  *strips* (replaces with a constant not derived from ``q``) but that
  planner//parallel code actually reads while planning/executing. A
  stripped-but-read field aliases two queries with different answers to
  one cache entry (poisoning). ``KEY_EXEMPT_FIELDS`` in cache/keys.py
  declares the audited exceptions (execution-only knobs).
- **K3 key-field-never-read** — spec fields the canonical key keeps but
  nothing in the engine ever reads: needless churn, every variation
  fragments the cache.
- **K4 fingerprint-(missing-key|churn-key|unfiltered)** —
  ``Config.fingerprint()`` feeds every canonical key, so the registry's
  ``semantic=`` classification is cross-checked against where each key
  is read: a ``semantic=False`` key read by result-defining code
  (planner//ops//ir//mv//cache-keys) is poisoning; a default-semantic
  key read only by operational subsystems (wlm//persist//http//cache
  internals//utils) churns every cache on unrelated tuning; and the
  fingerprint body itself must reference the semantic filter at all.
  Reads from ambiguous layers (parallel//sql//segment) are never flagged
  either way — a human classifies those via ``semantic=``.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from spark_druid_olap_tpu_torch.tools.sdlint.astutil import call_chain
from spark_druid_olap_tpu_torch.tools.sdlint.core import Finding, Project
from spark_druid_olap_tpu_torch.tools.sdlint.leaks import _suffix

#: spec fields K3 tolerates unread (forward/compat fields); keep empty —
#: grow only with a justification comment
K3_EXEMPT: frozenset = frozenset()

#: receiver names treated as "the query spec" when scanning reads
SPEC_RECEIVERS = frozenset({"q", "spec", "query", "qs", "sub"})


def _key_const(arg: ast.expr) -> Optional[str]:
    """``config.get(TZ_ID)`` / ``config.get(C.TZ_ID)`` -> "TZ_ID"."""
    if isinstance(arg, ast.Name):
        return arg.id
    if isinstance(arg, ast.Attribute):
        return arg.attr
    return None


def _is_config_get(chain: Sequence[str]) -> bool:
    # receiver spellings in the tree: self.config / eng.config / conf /
    # cfg — a bare `conf.get(KEY)` read is still a config read
    return len(chain) >= 2 and chain[-1] == "get" \
        and ("config" in chain[-2].lower()
             or chain[-2].lower() in ("conf", "cfg"))


def _config_reads(node: ast.AST) -> List[Tuple[str, int]]:
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and n.args \
                and _is_config_get(call_chain(n.func)):
            k = _key_const(n.args[0])
            if k is not None:
                out.append((k, n.lineno))
    return out


# -- registry (utils/config.py) -----------------------------------------------

class _Registry:
    def __init__(self) -> None:
        self.entries: Dict[str, Tuple[str, bool, int]] = {}  # NAME->(key,sem,line)

    @classmethod
    def parse(cls, project: Project) -> "_Registry":
        reg = cls()
        mod = project.by_suffix("utils/config.py")
        if mod is None:
            return reg
        reg.relpath = mod.relpath
        for stmt in mod.tree.body:
            if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Call)):
                continue
            ch = call_chain(stmt.value.func)
            if not ch or ch[-1] != "_entry" or not stmt.value.args:
                continue
            a0 = stmt.value.args[0]
            if not (isinstance(a0, ast.Constant)
                    and isinstance(a0.value, str)):
                continue
            semantic = True
            for kw in stmt.value.keywords:
                if kw.arg == "semantic" \
                        and isinstance(kw.value, ast.Constant):
                    semantic = bool(kw.value.value)
            reg.entries[stmt.targets[0].id] = (a0.value, semantic,
                                               stmt.lineno)
        return reg

    relpath: str = "utils/config.py"


# -- K1: compile signatures ---------------------------------------------------

def _sig_keys(fn: ast.AST, sig_expr: ast.expr) -> Set[str]:
    """Config-key constants appearing in the sig expression, following
    Name bindings within the function (``sigA = ("aggtable", base_sig,
    ...)`` nests one sig in another)."""
    bindings: Dict[str, List[ast.expr]] = {}
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name):
            bindings.setdefault(n.targets[0].id, []).append(n.value)
    keys: Set[str] = set()
    frontier, seen_names = [sig_expr], set()
    for _ in range(4):
        nxt: List[ast.expr] = []
        for e in frontier:
            keys.update(k for k, _ in _config_reads(e))
            for n in ast.walk(e):
                if isinstance(n, ast.Name) and n.id not in seen_names:
                    seen_names.add(n.id)
                    nxt.extend(bindings.get(n.id, ()))
        frontier = nxt
        if not frontier:
            break
    return keys


def _build_roots(idx, mi, ci, fn, fid, build_expr: ast.expr) -> List[tuple]:
    """FuncIds the build closure calls into (or is)."""
    local = idx.local_types(mi, ci, fn)
    roots: List[tuple] = []
    if isinstance(build_expr, ast.Lambda):
        for n in ast.walk(build_expr.body):
            if isinstance(n, ast.Call):
                roots.extend(idx.resolve_call(mi, ci, n, local, fid[1],
                                              unique_fallback=True))
    else:
        r = idx.resolve_func_ref(mi, ci, build_expr, local, fid[1])
        if r is not None:
            roots.append(r)
    return roots


def _closure_reads(idx, roots: Sequence[tuple],
                   depth: int = 4) -> Dict[str, Tuple[str, str, int]]:
    """key-name -> (module, qual, line) of one read site, BFS over
    resolvable calls from the build roots."""
    reads: Dict[str, Tuple[str, str, int]] = {}
    seen: Set[tuple] = set()
    frontier = list(roots)
    for _ in range(depth):
        nxt: List[tuple] = []
        for fid in frontier:
            if fid in seen:
                continue
            seen.add(fid)
            fn = idx.functions.get(fid)
            if fn is None:
                continue
            mi = idx.modules[fid[0]]
            ci = idx.func_class[fid]
            local = idx.local_types(mi, ci, fn)
            for k, line in _config_reads(fn):
                reads.setdefault(k, (fid[0], fid[1], line))
            for n in ast.walk(fn):
                if isinstance(n, ast.Call):
                    # no unique_fallback here: a name-only match deep in
                    # the walk drags in unrelated subsystems' reads
                    nxt.extend(idx.resolve_call(mi, ci, n, local, fid[1]))
        frontier = nxt
    return reads


def _k1(project: Project, reg: _Registry) -> List[Finding]:
    idx = project.index()
    out: List[Finding] = []
    for fid, fn in sorted(idx.functions.items()):
        mi = idx.modules[fid[0]]
        mod = project.modules[fid[0]]
        ci = idx.func_class[fid]
        for n in ast.walk(fn):
            if not (isinstance(n, ast.Call) and len(n.args) >= 2):
                continue
            if not _suffix(call_chain(n.func), ("_cached_program",)):
                continue
            sig_keys = _sig_keys(fn, n.args[0])
            roots = _build_roots(idx, mi, ci, fn, fid, n.args[1])
            for key, (rm, rq, rl) in sorted(
                    _closure_reads(idx, roots).items()):
                if key in sig_keys:
                    continue
                out.append(Finding(
                    "keys", "compile-sig-missing-config", mod.relpath,
                    n.lineno, f"{fid[1]}:{key}",
                    f"program build reads config {key} (in {rq}, "
                    f"{rm.replace('.', '/')}.py:{rl}) but the compile "
                    f"signature never folds it in — a SET of that key "
                    f"keeps serving the stale compiled program"))
    return out


# -- K2/K3: canonical key fields ----------------------------------------------

def _spec_fields(project: Project, keysmod) -> Set[str]:
    """Union of dataclass fields across CACHEABLE_TYPES."""
    wanted: Set[str] = set()
    for stmt in keysmod.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and stmt.targets[0].id == "CACHEABLE_TYPES":
            for n in ast.walk(stmt.value):
                if isinstance(n, ast.Attribute):
                    wanted.add(n.attr)
                elif isinstance(n, ast.Name):
                    wanted.add(n.id)
    fields: Set[str] = set()
    for mod in project.modules.values():
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and node.name in wanted:
                for s in node.body:
                    if isinstance(s, ast.AnnAssign) \
                            and isinstance(s.target, ast.Name):
                        fields.add(s.target.id)
    return fields


def _stripped_fields(keysmod) -> Dict[str, int]:
    """Fields normalize_spec replaces with values NOT derived from the
    spec parameter — i.e. excluded from the canonical key."""
    fn = None
    for stmt in keysmod.tree.body:
        if isinstance(stmt, ast.FunctionDef) \
                and stmt.name == "normalize_spec":
            fn = stmt
    if fn is None or not fn.args.args:
        return {}
    param = fn.args.args[0].arg
    stripped: Dict[str, int] = {}
    for n in ast.walk(fn):
        if not isinstance(n, ast.Call):
            continue
        ch = call_chain(n.func)
        if not (ch and (ch[-1] == "dict" or ch[-1] == "replace")):
            continue
        for kw in n.keywords:
            if kw.arg is None:
                continue
            refs_param = any(isinstance(x, ast.Name) and x.id == param
                             for x in ast.walk(kw.value))
            if not refs_param:
                stripped[kw.arg] = kw.value.lineno
    return stripped


def _exempt_fields(keysmod) -> Set[str]:
    for stmt in keysmod.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and stmt.targets[0].id == "KEY_EXEMPT_FIELDS":
            return {n.value for n in ast.walk(stmt.value)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str)}
    return set()


def _field_reads(project: Project, fields: Set[str],
                 dirs: Tuple[str, ...]) -> Set[str]:
    """Spec fields read as ``q.<field>`` / ``getattr(q, "<field>")`` in
    the given subtrees."""
    read: Set[str] = set()
    for mod in project.modules.values():
        top = mod.relpath.split(os.sep)[0]
        if dirs and top not in dirs:
            continue
        for n in ast.walk(mod.tree):
            if isinstance(n, ast.Attribute) \
                    and isinstance(n.value, ast.Name) \
                    and n.value.id in SPEC_RECEIVERS \
                    and n.attr in fields:
                read.add(n.attr)
            elif isinstance(n, ast.Call) and call_chain(n.func) \
                    == ["getattr"] and len(n.args) >= 2 \
                    and isinstance(n.args[0], ast.Name) \
                    and n.args[0].id in SPEC_RECEIVERS \
                    and isinstance(n.args[1], ast.Constant) \
                    and n.args[1].value in fields:
                read.add(n.args[1].value)
    return read


def _k23(project: Project) -> List[Finding]:
    keysmod = project.by_suffix("cache/keys.py")
    if keysmod is None:
        return []
    fields = _spec_fields(project, keysmod)
    if not fields:
        return []
    stripped = _stripped_fields(keysmod)
    exempt = _exempt_fields(keysmod)
    planner_reads = _field_reads(project, fields, ("planner", "parallel"))
    any_reads = _field_reads(project, fields, ())
    out: List[Finding] = []
    for f in sorted(set(stripped) & planner_reads - exempt):
        out.append(Finding(
            "keys", "key-missing-field", keysmod.relpath, stripped[f],
            f"normalize_spec:{f}",
            f"normalize_spec strips spec field {f!r} from the canonical "
            f"key but planner//parallel reads it — two queries differing "
            f"only in {f!r} alias to one cache entry (poisoning); key it "
            f"or declare it in KEY_EXEMPT_FIELDS with a justification"))
    kept = fields - set(stripped) - exempt - K3_EXEMPT
    for f in sorted(kept - any_reads):
        out.append(Finding(
            "keys", "key-field-never-read", keysmod.relpath, 1,
            f"normalize_spec:{f}",
            f"spec field {f!r} is serialized into every canonical key "
            f"but nothing in the engine reads it — pure cache churn"))
    return out


# -- K4: Config.fingerprint semantic classification ---------------------------

_SEM_DIRS = ("planner", "ops", "ir", "mv")
_SEM_FILES = ("cache/keys.py", "cache/subsume.py")
_OPS_DIRS = ("wlm", "persist", "http", "utils", "cache", "tools")


def _k4(project: Project, reg: _Registry) -> List[Finding]:
    if not reg.entries:
        return []
    out: List[Finding] = []
    reads: Dict[str, Set[str]] = {name: set() for name in reg.entries}
    for mod in project.modules.values():
        if mod.relpath.endswith(os.path.join("utils", "config.py")):
            continue
        for k, _ in _config_reads(mod.tree):
            if k in reads:
                reads[k].add(mod.relpath)
    sem_files = tuple(p.replace("/", os.sep) for p in _SEM_FILES)
    for name, (key, semantic, line) in sorted(reg.entries.items()):
        sites = reads[name]
        if not sites:
            continue
        in_sem = [p for p in sites
                  if p.split(os.sep)[0] in _SEM_DIRS or p in sem_files]
        in_ops_only = all(p.split(os.sep)[0] in _OPS_DIRS
                          and p not in sem_files for p in sites)
        if not semantic and in_sem:
            out.append(Finding(
                "keys", "fingerprint-missing-key", reg.relpath, line,
                f"config:{name}",
                f"{key} is declared semantic=False (excluded from "
                f"Config.fingerprint) but result-defining code reads it "
                f"({in_sem[0]}) — cached results go stale when it "
                f"changes"))
        elif semantic and in_ops_only:
            out.append(Finding(
                "keys", "fingerprint-churn-key", reg.relpath, line,
                f"config:{name}",
                f"{key} is folded into Config.fingerprint but only "
                f"operational code reads it ({sorted(sites)[0]}) — "
                f"every tuning change invalidates all result/plan "
                f"caches; declare semantic=False"))
    # the fingerprint body must actually apply the classification
    cfgmod = project.by_suffix("utils/config.py")
    if cfgmod is not None:
        for node in ast.walk(cfgmod.tree):
            if isinstance(node, ast.FunctionDef) \
                    and node.name == "fingerprint":
                names = {n.id for n in ast.walk(node)
                         if isinstance(n, ast.Name)}
                names |= {n.attr for n in ast.walk(node)
                          if isinstance(n, ast.Attribute)}
                if not any("semantic" in x.lower() for x in names):
                    out.append(Finding(
                        "keys", "fingerprint-unfiltered", cfgmod.relpath,
                        node.lineno, "Config.fingerprint",
                        "fingerprint() folds the raw override map "
                        "without consulting the semantic classification "
                        "— operational tuning (quotas, cadence, cache "
                        "sizing) invalidates every result/plan cache"))
    return out


def run(project: Project) -> List[Finding]:
    reg = _Registry.parse(project)
    return _k1(project, reg) + _k23(project) + _k4(project, reg)
