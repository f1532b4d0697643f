"""Merge-closure pass.

Port of the JAX package's ``tools/sdlint/mergeclosure.py``; the
``demux-gap`` rule follows the port's generic sketch dispatch.

Cross-checks ``ops/agg_registry.py:AGG_CLOSURE`` (the declared closure)
against the four sites that must each handle every aggregate:

- ``unregistered-agg`` — a kind in ``parallel/executor.py:_AGG_KIND``
  missing from ``AGG_CLOSURE``.
- ``stale-registry``   — an ``AGG_CLOSURE`` kind the executor no longer
  registers.
- ``route-mismatch``   — registry route/dtype disagrees with the
  executor's ``_AGG_KIND`` tuple.
- ``unmergeable-agg``  — a non-sketch route kind
  ``ops/groupby.py:merge_partials`` has no branch for (``sum``/``count``
  ride the ``psum`` default; ``min``/``max`` must appear literally).
- ``rollup-gap``       — a declared ``reagg`` kind ``mv/match.py`` never
  mentions (neither in ``_REAGG_KINDS`` nor as a special-case literal).
- ``demux-gap``        — a sketch family the shared-scan fused program
  / demux cannot dispatch: the port's ``parallel/sharedscan.py`` handles
  every sketch generically through ``ops/sketch.py`` (``SKETCH_KINDS``,
  ``sketch_registers``), so the gap is a family missing from
  ``SKETCH_KINDS``, or a shared scan that does not dispatch on it.
- ``undeclared-sketch-merge`` — a sketch-valued kind whose registry
  entry has no ``merge`` field: the register algebra (``max``/``min``/
  ``minsum``) is what every cross-chip and broker merge must agree on,
  so a sketch without a declared algebra is unmergeable by contract.
- ``sketch-merge-drift`` — the declared ``merge`` disagrees with (or is
  missing from) the runtime merge table
  ``ops/groupby.py:SKETCH_MERGE_OPS`` that the device merge dispatches
  on.

Anchors are found by path suffix, so fixture trees carrying only the
anchors their seeded violation needs still exercise the pass; a missing
anchor skips its checks rather than failing.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from spark_druid_olap_tpu_torch.tools.sdlint.core import Finding, Module, Project

_REGISTRY_SUFFIX = "ops/agg_registry.py"
_EXECUTOR_SUFFIX = "parallel/executor.py"
_GROUPBY_SUFFIX = "ops/groupby.py"
_MATCH_SUFFIX = "mv/match.py"
_SHAREDSCAN_SUFFIX = "parallel/sharedscan.py"
_SKETCH_SUFFIX = "ops/sketch.py"
# psum is merge_partials' fallthrough: additive routes need no literal
_PSUM_ROUTES = {"sum", "count"}


def _dict_literal(mod: Module, name: str) -> Optional[Dict]:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name:
            try:
                v = ast.literal_eval(node.value)
            except ValueError:
                return None
            return v if isinstance(v, dict) else None
    return None


def _registry(mod: Module) -> Optional[Dict[str, dict]]:
    return _dict_literal(mod, "AGG_CLOSURE")


def _agg_kind_literal(mod: Module) -> Dict[str, tuple]:
    """executor's ``_AGG_KIND`` dict literal -> {kind: (route, dtype)};
    dtype read off the ``np.<dtype>`` attribute name."""
    out: Dict[str, tuple] = {}
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_AGG_KIND"
                and isinstance(node.value, ast.Dict)):
            continue
        for k, v in zip(node.value.keys, node.value.values):
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                continue
            route = dtype = None
            if isinstance(v, ast.Tuple) and len(v.elts) == 2:
                if isinstance(v.elts[0], ast.Constant):
                    route = v.elts[0].value
                if isinstance(v.elts[1], ast.Attribute):
                    dtype = v.elts[1].attr
            out[k.value] = (route, dtype, node.lineno)
    return out


def _function_literals(mod: Module, name: str) -> Set[str]:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return {n.value for n in ast.walk(node)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str)}
    return set()


def _module_literals(mod: Module) -> Set[str]:
    return {n.value for n in ast.walk(mod.tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def run(project: Project) -> List[Finding]:
    reg_mod = project.by_suffix(_REGISTRY_SUFFIX)
    if reg_mod is None:
        return []
    registry = _registry(reg_mod)
    if registry is None:
        return []
    out: List[Finding] = []

    exec_mod = project.by_suffix(_EXECUTOR_SUFFIX)
    if exec_mod is not None:
        agg_kind = _agg_kind_literal(exec_mod)
        for kind, (route, dtype, line) in sorted(agg_kind.items()):
            if kind not in registry:
                out.append(Finding(
                    "mergeclosure", "unregistered-agg", exec_mod.relpath,
                    line, kind,
                    f"aggregate kind {kind!r} is registered in "
                    f"executor._AGG_KIND but missing from "
                    f"ops/agg_registry.py:AGG_CLOSURE — declare its "
                    f"merge closure there first"))
            else:
                ent = registry[kind]
                if route != ent.get("route") or dtype != ent.get("dtype"):
                    out.append(Finding(
                        "mergeclosure", "route-mismatch",
                        exec_mod.relpath, line, kind,
                        f"executor._AGG_KIND maps {kind!r} to "
                        f"({route!r}, {dtype}) but AGG_CLOSURE declares "
                        f"({ent.get('route')!r}, {ent.get('dtype')})"))
        for kind in sorted(set(registry) - set(agg_kind)):
            out.append(Finding(
                "mergeclosure", "stale-registry", reg_mod.relpath, 1,
                kind,
                f"AGG_CLOSURE declares {kind!r} but executor._AGG_KIND "
                f"no longer registers it"))

    # sketch entries must DECLARE their register algebra, and the
    # declaration must match the runtime dispatch table the device
    # merge actually folds with
    for kind, ent in sorted(registry.items()):
        sketch = ent.get("sketch")
        if sketch is not None and not ent.get("merge"):
            out.append(Finding(
                "mergeclosure", "undeclared-sketch-merge",
                reg_mod.relpath, 1, kind,
                f"sketch aggregate {kind!r} ({sketch}) declares no "
                f"'merge' register algebra in AGG_CLOSURE — cross-chip "
                f"and broker merges have nothing to check against, and "
                f"a psum over {sketch} registers corrupts silently"))

    gb_mod = project.by_suffix(_GROUPBY_SUFFIX)
    if gb_mod is not None:
        runtime_ops = _dict_literal(gb_mod, "SKETCH_MERGE_OPS")
        if runtime_ops is not None:
            for kind, ent in sorted(registry.items()):
                sketch, merge = ent.get("sketch"), ent.get("merge")
                if sketch is None or not merge:
                    continue
                got = runtime_ops.get(sketch)
                if got != merge:
                    out.append(Finding(
                        "mergeclosure", "sketch-merge-drift",
                        gb_mod.relpath, 1, kind,
                        f"AGG_CLOSURE declares {sketch} merges via "
                        f"{merge!r} but ops/groupby.py:SKETCH_MERGE_OPS "
                        f"{'has no entry for it' if got is None else f'dispatches {got!r}'}"
                        f" — the device fold and the declared closure "
                        f"disagree"))
        handled = _function_literals(gb_mod, "merge_partials")
        for kind, ent in sorted(registry.items()):
            route = ent.get("route")
            if ent.get("sketch") or route in _PSUM_ROUTES:
                continue
            if route not in handled:
                out.append(Finding(
                    "mergeclosure", "unmergeable-agg", gb_mod.relpath, 1,
                    kind,
                    f"aggregate {kind!r} routes as {route!r} but "
                    f"ops/groupby.py:merge_partials has no branch for "
                    f"{route!r}: cross-chip merge would psum it"))

    match_mod = project.by_suffix(_MATCH_SUFFIX)
    if match_mod is not None:
        mentioned = _module_literals(match_mod)
        for kind, ent in sorted(registry.items()):
            reagg = ent.get("reagg")
            if reagg is not None and reagg not in mentioned:
                out.append(Finding(
                    "mergeclosure", "rollup-gap", match_mod.relpath, 1,
                    kind,
                    f"aggregate {kind!r} declares reagg kind {reagg!r} "
                    f"but mv/match.py never handles it: rollup rewrites "
                    f"would silently reject (or mis-merge) it"))

    ss_mod = project.by_suffix(_SHAREDSCAN_SUFFIX)
    sk_mod = project.by_suffix(_SKETCH_SUFFIX)
    if ss_mod is not None and sk_mod is not None:
        kinds = _tuple_literal(sk_mod, "SKETCH_KINDS")
        generic = any(isinstance(n, (ast.Name, ast.alias))
                      and getattr(n, "id", getattr(n, "name", None))
                      == "SKETCH_KINDS" for n in ast.walk(ss_mod.tree))
        for kind, ent in sorted(registry.items()):
            sketch = ent.get("sketch")
            if sketch is None or (generic and sketch in kinds):
                continue
            out.append(Finding(
                "mergeclosure", "demux-gap", ss_mod.relpath, 1, kind,
                f"sketch aggregate {kind!r} ({sketch}) is "
                + ("missing from ops/sketch.py:SKETCH_KINDS"
                   if generic else
                   "not dispatched: the shared scan never consults "
                   "ops/sketch.py:SKETCH_KINDS")
                + ": coalesced execution would decode its registers as "
                "plain columns"))
    return out


def _tuple_literal(mod: Module, name: str) -> tuple:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name:
            try:
                v = ast.literal_eval(node.value)
            except ValueError:
                return ()
            return tuple(v) if isinstance(v, (tuple, list)) else ()
    return ()
