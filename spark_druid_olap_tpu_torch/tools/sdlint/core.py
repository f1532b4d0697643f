"""sdlint core: project model, findings, suppression, baseline, reporters.

Port of the JAX package's ``tools/sdlint/core.py``; ``Project`` scans
``spark_druid_olap_tpu_torch`` by default.

Everything is pure ``ast`` — no module under analysis is ever imported,
so the linter runs identically with or without torch/pandas installed and
fixture modules with seeded violations stay import-free.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# `# sdlint: disable=locks` or `# sdlint: disable=locks,purity` or
# `# sdlint: disable=all` — applies to that line, or to a whole function
# when placed anywhere on its def header (decorators and multi-line
# signatures included). `# sdlint: disable-file=<pass>` within the
# first 10 lines silences a pass for the whole module.
_SUPPRESS_RE = re.compile(r"#\s*sdlint:\s*disable=([a-z,]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*sdlint:\s*disable-file=([a-z,]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_name: str     # one of sdlint.PASSES
    rule: str          # stable rule slug within the pass
    path: str          # path relative to the scanned root
    line: int
    symbol: str        # stable anchor (qualified function, key, ...)
    message: str

    def key(self) -> Tuple[str, str, str, str]:
        """Baseline identity: line numbers churn, symbols don't."""
        return (self.pass_name, self.rule, self.path, self.symbol)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.pass_name}/{self.rule}] "
                f"{self.symbol}: {self.message}")


class Module:
    """One parsed source file: AST + per-line suppressions + def spans."""

    def __init__(self, root: str, relpath: str, source: str):
        self.relpath = relpath
        self.name = relpath[:-3].replace(os.sep, ".")
        if self.name.endswith(".__init__"):
            self.name = self.name[: -len(".__init__")]
        self.source = source
        self.tree = ast.parse(source, filename=os.path.join(root, relpath))
        self.suppress: Dict[int, set] = {}
        self.suppress_file: set = set()
        for i, ln in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(ln)
            if m:
                self.suppress[i] = set(m.group(1).split(","))
            if i <= 10:
                m = _SUPPRESS_FILE_RE.search(ln)
                if m:
                    self.suppress_file |= set(m.group(1).split(","))
        # innermost-enclosing-def lookup for def-header suppressions.
        # The span starts at the FIRST DECORATOR, and the whole header
        # (def line through the closing paren of a multi-line signature)
        # counts as "the def line" for suppression comments.
        self._def_spans: List[Tuple[int, int, Tuple[int, ...]]] = []
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                end = getattr(node, "end_lineno", node.lineno)
                start = min([node.lineno]
                            + [d.lineno for d in node.decorator_list])
                # header ends where the first body statement starts
                hdr_end = node.body[0].lineno - 1 if node.body \
                    else node.lineno
                header = tuple(range(start, max(hdr_end,
                                                node.lineno) + 1))
                self._def_spans.append((start, end, header))
        self._def_spans.sort()

    def suppressed(self, pass_name: str, line: int) -> bool:
        if pass_name in self.suppress_file or "all" in self.suppress_file:
            return True
        for at in (line,) + self._enclosing_def_header(line):
            s = self.suppress.get(at)
            if s and (pass_name in s or "all" in s):
                return True
        return False

    def _enclosing_def_header(self, line: int) -> Tuple[int, ...]:
        best: Tuple[int, ...] = ()
        for start, end, header in self._def_spans:
            if start <= line <= end:
                best = header       # spans sorted by start: innermost last
        return best


class Project:
    """The scanned tree. ``root`` is the package directory itself (e.g.
    ``.../spark_druid_olap_tpu_torch``) or any directory of fixture modules;
    ``package`` is the dotted import name that prefix maps onto ``root``
    (used to resolve intra-package imports)."""

    def __init__(self, root: str, package: str = "spark_druid_olap_tpu_torch",
                 skip: Sequence[str] = ("tools/sdlint",),
                 only: Optional[Sequence[str]] = None):
        self.root = os.path.abspath(root)
        self.package = package
        self.modules: Dict[str, Module] = {}
        self._index = None          # shared astutil.Index, built once
        self._cfgs: Dict[object, object] = {}   # fn node -> cfg.CFG
        only_rel = None if only is None else {
            o.replace("/", os.sep) for o in only}
        skip = tuple(s.replace("/", os.sep) for s in skip)
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d != "__pycache__"]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                if any(rel == s or rel.startswith(s + os.sep)
                       for s in skip):
                    continue
                if only_rel is not None and rel not in only_rel:
                    continue
                with open(os.path.join(dirpath, fn),
                          encoding="utf-8") as f:
                    src = f.read()
                try:
                    mod = Module(self.root, rel, src)
                except SyntaxError:
                    continue        # not this linter's business
                self.modules[mod.name] = mod

    def module_for_import(self, dotted: str) -> Optional[Module]:
        """Resolve an absolute import like ``<package>.ops.groupby`` (or a
        bare ``ops.groupby`` in fixture trees) to a scanned module."""
        if dotted.startswith(self.package + "."):
            dotted = dotted[len(self.package) + 1:]
        elif dotted == self.package:
            dotted = ""
        return self.modules.get(dotted)

    def index(self):
        """The one shared :class:`astutil.Index` — every pass resolves
        through the same parse (v1 re-built it per pass)."""
        if self._index is None:
            from spark_druid_olap_tpu_torch.tools.sdlint.astutil import Index
            self._index = Index(self)
        return self._index

    def cfg(self, fn):
        """Memoized per-function CFG (leaks + ordering share them)."""
        c = self._cfgs.get(fn)
        if c is None:
            from spark_druid_olap_tpu_torch.tools.sdlint import cfg as _cfg
            c = self._cfgs[fn] = _cfg.build(fn)
        return c

    def by_suffix(self, suffix: str) -> Optional[Module]:
        """Find the one module whose relpath ends with ``suffix`` (anchor
        files like ``parallel/executor.py``); None when absent (fixture
        trees carry only the anchors their seeded violation needs)."""
        suffix = suffix.replace("/", os.sep)
        hits = [m for m in self.modules.values()
                if m.relpath == suffix
                or m.relpath.endswith(os.sep + suffix)]
        return hits[0] if len(hits) == 1 else None


class Baseline:
    """Checked-in known findings. Every entry must carry a one-line
    ``justification``; matching is on Finding.key() (no line numbers, so
    unrelated edits don't churn the file)."""

    def __init__(self, entries: Iterable[dict] = ()):
        self.entries = list(entries)
        self._keys = {}
        for e in self.entries:
            k = (e.get("pass"), e.get("rule"), e.get("path"),
                 e.get("symbol"))
            self._keys[k] = e

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        return cls(doc.get("findings", []))

    def matches(self, f: Finding) -> bool:
        return f.key() in self._keys

    def unmatched(self, findings: Sequence[Finding]) -> List[dict]:
        """Baseline entries no current finding hits — stale, should be
        deleted (surfaced by the CLI as a warning, not a failure)."""
        seen = {f.key() for f in findings}
        return [e for k, e in self._keys.items() if k not in seen]

    def missing_justifications(self) -> List[dict]:
        return [e for e in self.entries
                if not str(e.get("justification", "")).strip()]


def run_passes(project: Project,
               passes: Sequence[str] = ("locks", "purity", "contracts",
                                        "mergeclosure", "keys", "leaks",
                                        "ordering", "kernels", "mesh"),
               timing: Optional[Dict[str, float]] = None) -> List[Finding]:
    """Run the named passes; returns suppression-filtered findings.
    With ``timing`` a dict, per-pass wall seconds are written into it
    (plus ``"index"`` for the shared parse/index build)."""
    import time as _time
    from spark_druid_olap_tpu_torch.tools.sdlint import (contracts, kernels, keys,
                                                   leaks, locks, mergeclosure,
                                                   mesh, ordering, purity)
    impl = {"locks": locks.run, "purity": purity.run,
            "contracts": contracts.run, "mergeclosure": mergeclosure.run,
            "keys": keys.run, "leaks": leaks.run, "ordering": ordering.run,
            "kernels": kernels.run, "mesh": mesh.run}
    if timing is not None:
        t0 = _time.perf_counter()
        project.index()
        timing["index"] = _time.perf_counter() - t0
    out: List[Finding] = []
    for name in passes:
        t0 = _time.perf_counter()
        found = impl[name](project)
        if timing is not None:
            timing[name] = _time.perf_counter() - t0
        for f in found:
            mod = project.modules.get(
                f.path[:-3].replace(os.sep, ".")) if f.path.endswith(".py") \
                else None
            if mod is None:
                for m in project.modules.values():
                    if m.relpath == f.path:
                        mod = m
                        break
            if mod is not None and mod.suppressed(f.pass_name, f.line):
                continue
            out.append(f)
    out.sort(key=lambda f: (f.pass_name, f.path, f.line, f.rule, f.symbol))
    return out


# -- reporters ----------------------------------------------------------------

def report_human(findings: Sequence[Finding], baseline: Baseline,
                 write=print) -> int:
    """Human report; returns the count of NON-baselined findings."""
    new = [f for f in findings if not baseline.matches(f)]
    known = [f for f in findings if baseline.matches(f)]
    for f in new:
        write(f.render())
    if known:
        write(f"sdlint: {len(known)} baselined finding(s) suppressed "
              f"(tools/sdlint/baseline.json)")
    stale = baseline.unmatched(findings)
    if stale:
        write(f"sdlint: warning: {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} no longer fire(s): "
              + ", ".join(sorted(str(e.get("symbol")) for e in stale)))
    write(f"sdlint: {len(new)} finding(s), {len(known)} baselined")
    return len(new)


#: bump ONLY on a breaking change to the JSON document shape — CI diffs
#: and downstream tooling key on this (golden-tested in tests/test_lint.py)
JSON_SCHEMA_VERSION = 2


def report_json(findings: Sequence[Finding], baseline: Baseline) -> str:
    """Stable machine output: findings sorted by (pass, path, rule,
    symbol, line), keys sorted, schema versioned."""
    ordered = sorted(findings, key=lambda f: (f.pass_name, f.path, f.rule,
                                              f.symbol, f.line))
    doc = {"schema_version": JSON_SCHEMA_VERSION,
           "findings": [dict(sorted((dataclasses.asdict(f) | {
               "baselined": baseline.matches(f)}).items()))
               for f in ordered],
           "new": sum(1 for f in findings if not baseline.matches(f)),
           "baselined": sum(1 for f in findings if baseline.matches(f)),
           "stale_baseline": sorted(
               baseline.unmatched(findings),
               key=lambda e: (str(e.get("pass")), str(e.get("rule")),
                              str(e.get("symbol"))))}
    return json.dumps(doc, indent=2, sort_keys=True)
