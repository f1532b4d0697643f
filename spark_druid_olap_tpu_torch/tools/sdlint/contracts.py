"""Contract-registry pass.

Port of the JAX package's ``tools/sdlint/contracts.py``. The stats
contract is the port's own ``docs/STATS.md`` inside the scanned package,
never the JAX package's doc beside it.

Two string-keyed contracts hold the engine together and have historically
drifted one PR at a time:

- **config keys** — every ``sdot.*`` key passed to ``.get() / .set() /
  .is_set()`` anywhere in the package must be declared with a default in
  ``utils/config.py`` (``_entry(...)``), and every declared key must be
  read somewhere. Genuinely dynamic families (``sdot.wlm.quota.<tenant>``,
  ``sdot.datasource.option.<ds>.<opt>``) are allowlisted via
  ``DYNAMIC_KEY_PREFIXES`` in ``utils/config.py`` — the allowlist itself
  lives next to the registry so it is part of the declared contract.
- **stats keys** — every key written into the engine's observability
  surface (``last_stats[...] = ``, ``last_stats.update({...})``,
  ``m.stats = {...}``) must be documented in ``docs/STATS.md``, and every
  documented key must still be emitted somewhere.

A third contract rides the same doc: **phase names** — every name timed
via ``PH.phase("...")`` / ``PH.add("...")`` / ``PH.stash("...")`` must be
registered in the ``PHASES`` literal of ``utils/phases.py``, and the
registry must match the marker-delimited phase table in ``docs/STATS.md``
(``<!-- phases:begin -->`` .. ``<!-- phases:end -->``) in both
directions. The marker region is excluded from the stats-key scan — phase
names are not stats keys.

Rules: ``undeclared-key``, ``unread-key``, ``undocumented-stats-key``,
``stale-stats-doc``, ``unregistered-phase``, ``undocumented-phase``,
``stale-phase-doc``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from spark_druid_olap_tpu_torch.tools.sdlint.astutil import dotted_name
from spark_druid_olap_tpu_torch.tools.sdlint.core import Finding, Module, Project

_CONFIG_SUFFIX = "utils/config.py"
_READ_METHODS = {"get", "set", "is_set"}
_STATS_BASES = ("stats", "last_stats")
_DOC_KEY_RE = re.compile(r"`([a-z_][a-z0-9_.]*)`")


def _declared(config_mod: Module) \
        -> Tuple[Dict[str, int], List[str], Dict[str, str]]:
    """(declared key -> _entry line, dynamic prefixes,
    entry-constant name -> key). Keys are consumed both as string
    literals (``cfg.get("sdot.x")``) and through the module-level entry
    constants (``NAME = _entry("sdot.x", ...)`` then
    ``cfg.get(C.NAME)``), so both spellings must count as reads."""
    keys: Dict[str, int] = {}
    prefixes: List[str] = []
    names: Dict[str, str] = {}
    for node in ast.walk(config_mod.tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "_entry" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            keys[node.args[0].value] = node.lineno
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            tname = node.targets[0].id
            if tname in ("DYNAMIC_KEY_PREFIXES",
                         "DATASOURCE_OVERRIDE_PREFIX"):
                try:
                    v = ast.literal_eval(node.value)
                except ValueError:
                    continue
                if isinstance(v, str):
                    prefixes.append(v)
                else:
                    prefixes.extend(x for x in v if isinstance(x, str))
            elif isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Name) \
                    and node.value.func.id == "_entry" \
                    and node.value.args \
                    and isinstance(node.value.args[0], ast.Constant):
                names[tname] = node.value.args[0].value
    return keys, prefixes, names


def _entry_references(project: Project, config_mod: Module,
                      names: Dict[str, str]) -> Set[str]:
    """Keys whose entry constant is referenced anywhere — any module's
    Name/Attribute use, or a use inside a config.py function body (its
    own module-level ``NAME = _entry(...)`` assignment doesn't count)."""
    read: Set[str] = set()
    for mod in project.modules.values():
        if mod is config_mod:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Name) and node.id in names:
                read.add(names[node.id])
            elif isinstance(node, ast.Attribute) and node.attr in names:
                read.add(names[node.attr])
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    if a.name in names:
                        read.add(names[a.name])
    for node in ast.walk(config_mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for n in ast.walk(node):
                if isinstance(n, ast.Name) and n.id in names:
                    read.add(names[n.id])
                elif isinstance(n, ast.Attribute) and n.attr in names:
                    read.add(names[n.attr])
    return read


def _config_reads(project: Project) -> List[Tuple[str, str, int, str]]:
    """(key, relpath, line, method) for every constant-keyed config
    access; ``prefixed("sdot.x.")`` reads count as reading every
    declared key under that prefix (returned with method='prefixed')."""
    out = []
    for mod in project.modules.values():
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            meth = node.func.attr
            if meth not in _READ_METHODS and meth != "prefixed":
                continue
            if not (node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            key = node.args[0].value
            if not key.startswith("sdot."):
                continue
            out.append((key, mod.relpath, node.lineno, meth))
    return out


_PHASES_BEGIN = "<!-- phases:begin -->"
_PHASES_END = "<!-- phases:end -->"


def _stats_md_path(project: Project) -> Optional[str]:
    """The scanned tree's own ``docs/STATS.md`` (the port keeps its doc
    inside the package; the directory beside it belongs to the JAX
    package and is never read)."""
    cand = os.path.join(project.root, "docs", "STATS.md")
    return cand if os.path.exists(cand) else None


def _stats_doc(project: Project) -> Tuple[Optional[str], Dict[str, int]]:
    """docs/STATS.md keys (backticked tokens in table rows). The
    marker-delimited phase table is excluded — phase names (``plan.build``
    etc.) document profiler phases, not stats keys, and are cross-checked
    separately against the ``PHASES`` registry."""
    cand = _stats_md_path(project)
    if cand is None:
        return None, {}
    keys: Dict[str, int] = {}
    in_phases = False
    with open(cand, encoding="utf-8") as f:
        for i, ln in enumerate(f, start=1):
            if _PHASES_BEGIN in ln:
                in_phases = True
                continue
            if _PHASES_END in ln:
                in_phases = False
                continue
            if in_phases or not ln.lstrip().startswith("|"):
                continue
            for m in _DOC_KEY_RE.finditer(ln):
                keys.setdefault(m.group(1), i)
    rel = os.path.relpath(os.path.abspath(cand),
                          os.path.dirname(project.root))
    return rel, keys


def _phases_doc(project: Project) -> Tuple[Optional[str], Dict[str, int]]:
    """Phase names documented in STATS.md's marker-delimited table."""
    cand = _stats_md_path(project)
    if cand is None:
        return None, {}
    names: Dict[str, int] = {}
    in_phases = False
    with open(cand, encoding="utf-8") as f:
        for i, ln in enumerate(f, start=1):
            if _PHASES_BEGIN in ln:
                in_phases = True
                continue
            if _PHASES_END in ln:
                in_phases = False
                continue
            if not in_phases or not ln.lstrip().startswith("|"):
                continue
            for m in _DOC_KEY_RE.finditer(ln):
                names.setdefault(m.group(1), i)
    rel = os.path.relpath(os.path.abspath(cand),
                          os.path.dirname(project.root))
    return rel, names


def _phases_registry(project: Project) \
        -> Tuple[Optional[Module], Dict[str, int]]:
    """The ``PHASES = {...}`` literal in utils/phases.py (name -> line).
    Absent module (lint fixture projects) disables the phase contract."""
    mod = project.by_suffix("utils/phases.py")
    if mod is None:
        return None, {}
    names: Dict[str, int] = {}
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and stmt.targets[0].id == "PHASES" \
                and isinstance(stmt.value, ast.Dict):
            for k in stmt.value.keys:
                if isinstance(k, ast.Constant) \
                        and isinstance(k.value, str):
                    names.setdefault(k.value, k.lineno)
    return mod, names


_PHASE_METHODS = {"phase", "add", "stash"}
_PHASE_RECEIVERS = {"PH", "phases"}


def _phase_call_sites(project: Project) -> List[Tuple[str, str, int]]:
    """(name, relpath, line) for every literal-named timer call —
    ``PH.phase("x")`` / ``PH.add("x", dt)`` / ``PH.stash("x", dt)``."""
    out = []
    for mod in project.modules.values():
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _PHASE_METHODS):
                continue
            recv = dotted_name(node.func.value)
            if recv is None \
                    or recv.split(".")[-1] not in _PHASE_RECEIVERS:
                continue
            if not (node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            out.append((node.args[0].value, mod.relpath, node.lineno))
    return out


def _is_stats_base(expr: ast.expr) -> bool:
    name = dotted_name(expr)
    if name is None:
        return False
    leaf = name.split(".")[-1]
    return leaf in _STATS_BASES


def _stats_emissions(project: Project) -> List[Tuple[str, str, int]]:
    """(key, relpath, line) for every statically-visible stats write."""
    out = []
    for mod in project.modules.values():
        # aliases: `st = self.last_stats` makes `st[...]` a stats write
        aliases = {n.targets[0].id for n in ast.walk(mod.tree)
                   if isinstance(n, ast.Assign) and len(n.targets) == 1
                   and isinstance(n.targets[0], ast.Name)
                   and _is_stats_base(n.value)}

        def _base(expr: ast.expr) -> bool:
            if _is_stats_base(expr):
                return True
            return isinstance(expr, ast.Name) and expr.id in aliases

        for node in ast.walk(mod.tree):
            # stats["k"] = v / self.last_stats["k"] = v
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) \
                            and _base(t.value) \
                            and isinstance(t.slice, ast.Constant) \
                            and isinstance(t.slice.value, str):
                        out.append((t.slice.value, mod.relpath,
                                    node.lineno))
                # m.stats = {...} dict literal
                if len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Attribute) \
                        and node.targets[0].attr in _STATS_BASES \
                        and isinstance(node.value, ast.Dict):
                    for k in node.value.keys:
                        if isinstance(k, ast.Constant) \
                                and isinstance(k.value, str):
                            out.append((k.value, mod.relpath,
                                        node.lineno))
            # last_stats.update({...})
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "update" \
                    and _base(node.func.value) \
                    and node.args and isinstance(node.args[0], ast.Dict):
                for k in node.args[0].keys:
                    if isinstance(k, ast.Constant) \
                            and isinstance(k.value, str):
                        out.append((k.value, mod.relpath, node.lineno))
    return out


def run(project: Project) -> List[Finding]:
    out: List[Finding] = []
    config_mod = project.by_suffix(_CONFIG_SUFFIX)
    if config_mod is not None:
        declared, prefixes, names = _declared(config_mod)
        reads = _config_reads(project)
        read_keys: Set[str] = _entry_references(project, config_mod,
                                                names)
        for key, path, line, meth in reads:
            if meth == "prefixed":
                read_keys.update(k for k in declared
                                 if k.startswith(key))
                continue
            read_keys.add(key)
            if key in declared:
                continue
            if any(key.startswith(p) for p in prefixes):
                continue
            out.append(Finding(
                "contracts", "undeclared-key", path, line, key,
                f"config key {key!r} is read here but never declared "
                f"with a default in utils/config.py (_entry) and matches "
                f"no DYNAMIC_KEY_PREFIXES pattern"))
        for key, line in sorted(declared.items()):
            if key not in read_keys:
                out.append(Finding(
                    "contracts", "unread-key", config_mod.relpath, line,
                    key,
                    f"config key {key!r} is declared in utils/config.py "
                    f"but no code reads it (dead contract surface)"))
    doc_path, documented = _stats_doc(project)
    if doc_path is not None:
        emitted: Dict[str, Tuple[str, int]] = {}
        for key, path, line in _stats_emissions(project):
            emitted.setdefault(key, (path, line))
        for key, (path, line) in sorted(emitted.items()):
            if key not in documented:
                out.append(Finding(
                    "contracts", "undocumented-stats-key", path, line,
                    key,
                    f"stats key {key!r} is emitted here but not "
                    f"documented in docs/STATS.md"))
        for key, line in sorted(documented.items()):
            if key not in emitted:
                out.append(Finding(
                    "contracts", "stale-stats-doc", doc_path, line, key,
                    f"docs/STATS.md documents stats key {key!r} but "
                    f"nothing emits it"))
    phases_mod, registry = _phases_registry(project)
    if phases_mod is not None and registry:
        for name, path, line in sorted(_phase_call_sites(project)):
            if name not in registry:
                out.append(Finding(
                    "contracts", "unregistered-phase", path, line, name,
                    f"phase {name!r} is timed here but not registered in "
                    f"the PHASES literal of utils/phases.py — it would "
                    f"surface in stats['phases'] undocumented"))
        ph_doc_path, ph_documented = _phases_doc(project)
        if ph_doc_path is not None:
            for name, line in sorted(registry.items()):
                if name not in ph_documented:
                    out.append(Finding(
                        "contracts", "undocumented-phase",
                        phases_mod.relpath, line, name,
                        f"phase {name!r} is registered in utils/phases.py "
                        f"but missing from the phases:begin/phases:end "
                        f"table in docs/STATS.md"))
            for name, line in sorted(ph_documented.items()):
                if name not in registry:
                    out.append(Finding(
                        "contracts", "stale-phase-doc", ph_doc_path, line,
                        name,
                        f"docs/STATS.md phase table documents {name!r} "
                        f"but utils/phases.py does not register it"))
    return out
