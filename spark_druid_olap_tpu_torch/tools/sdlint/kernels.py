"""CUDA kernel-contract pass.

The port of the JAX package's ``tools/sdlint/kernels.py``. JAX checks
its Pallas kernels' VMEM tiling; the port's kernels are hand-written
CUDA (``csrc/*.cu``) bound through ``ctypes`` by Python wrappers
(``ops/cuda_groupby.py``, ``ops/cuda_wave.py``), and the contract
between the two halves is written in ``docs/KERNELS.md``. The wrappers
hold it only when a library loads on a card (``library()`` compares a
few exported constants); this pass checks it statically, chip-free,
reading the CUDA sources as text:

- **mirror-mismatch** — each Python mirror of a kernel constant equals
  its ``constexpr`` in the CUDA source (:data:`MIRRORS`): the launch
  geometry and the lane-program caps the wrappers plan with must be the
  ones the kernel was compiled with.
- **smem-budget** — ``SMEM_LIMIT`` (``ops/cuda_groupby.py``) is at most
  Hopper's opt-in shared memory per block (227 KB), and the default of
  ``sdot.cuda.wave.scratch.bytes`` is at most ``SMEM_LIMIT``: a plan
  inside a larger budget fails at launch, on the card only.
- **theta-cap-mismatch** — ``THETA_KERNEL_MAX_ROWS``
  (``ops/cuda_wave.py``) equals the reference stripe's cap, 256 (the
  JAX wave kernel's ``THETA_KERNEL_MAX_ROWS``): the in-kernel / epilogue
  split of theta sketches must be the reference's.
- **unbound-symbol** — every ``lib.sdot_*`` symbol a wrapper binds
  (attribute or ``getattr`` string) is defined in an ``extern "C"``
  block of a ``csrc/*.cu``: a missing one raises ``AttributeError`` on
  the card only.
- **fallback-hides-card** — no ``except`` around a kernel launch runs
  the plain version (a ``*_reference`` function): a launch that fails
  on the card must raise, not answer from the plain version while the
  kernel is broken.
- **plain-not-cpu-gated** — outside the plain versions themselves, a
  plain version is called only in the CPU branch of a device test
  (``if t.device.type != "cuda": return ..._reference(...)``), so a
  CUDA tensor always reaches its kernel.

Kernel launches are calls of a ctypes symbol (``sdot_*``) or of a
wrapper: a function that calls ``library()`` or a ``sdot_*`` symbol
itself. Anchors resolve by path suffix; a missing anchor skips its
checks, so fixture trees carry only what their seeded violation needs.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from spark_druid_olap_tpu_torch.tools.sdlint.astutil import (call_chain,
                                                             walk_shallow)
from spark_druid_olap_tpu_torch.tools.sdlint.core import (Finding, Module,
                                                          Project)

#: (wrapper module suffix, Python constant, CUDA constexpr)
MIRRORS: Tuple[Tuple[str, str, str], ...] = (
    ("ops/cuda_groupby.py", "MAX_AGGS", "kMaxAggs"),
    ("ops/cuda_groupby.py", "THREADS", "kThreads"),
    ("ops/cuda_wave.py", "MAX_INSTRS", "kMaxInstrs"),
    ("ops/cuda_wave.py", "MAX_REGS", "kMaxRegs"),
    ("ops/cuda_wave.py", "MAX_COLS", "kMaxCols"),
    ("ops/cuda_wave.py", "NONE", "kNone"),
    ("ops/cuda_wave.py", "IMM", "kImm"),
    ("ops/theta.py", "K_LANES", "kThetaLanes"),
)
_GROUPBY_SUFFIX = "ops/cuda_groupby.py"
_WAVE_SUFFIX = "ops/cuda_wave.py"
_CONFIG_SUFFIX = "utils/config.py"
_SCRATCH_KEY = "sdot.cuda.wave.scratch.bytes"
#: Hopper's opt-in shared memory per block (sm_90: 227 KB)
HOPPER_SMEM_OPTIN = 227 * 1024
#: the reference wave kernel's in-kernel theta stripe cap
THETA_STRIPE_CAP = 256

_CONSTEXPR_RE = re.compile(
    r"\bconstexpr\s+(?:unsigned\s+|long\s+|int\s+|short\s+)*"
    r"(?:int|long|unsigned|size_t|int\d+_t|uint\d+_t)?\s*"
    r"(k[A-Z]\w*)\s*=\s*([^;]+);")
_DEF_RE = re.compile(
    r"^[ \t]*(?:[A-Za-z_]\w*[ \t\*]+)+(sdot_\w+)\s*\(", re.M)
_SYMBOL_RE = re.compile(r"^sdot_\w+$")


# -- the CUDA sources, read as text -------------------------------------------

def _sources(project: Project) -> Dict[str, str]:
    """relpath -> text of every ``csrc/*.cu`` / ``*.cuh``."""
    d = os.path.join(project.root, "csrc")
    out: Dict[str, str] = {}
    if not os.path.isdir(d):
        return out
    for fn in sorted(os.listdir(d)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(d, fn), encoding="utf-8") as f:
                out[os.path.join("csrc", fn)] = f.read()
    return out


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", lambda m: "\n" * m.group(0).count("\n"),
                  text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _c_value(expr: str, known: Dict[str, int]) -> Optional[int]:
    """An integer constant expression of the CUDA source (literals with
    ``u`` / ``l`` suffixes, ``+ - * / << >>``, earlier constexprs)."""
    expr = re.sub(r"\b(0x[0-9a-fA-F]+|\d+)[uUlL]+\b", r"\1", expr.strip())
    try:
        tree = ast.parse(expr.replace("/", "//"), mode="eval")
    except SyntaxError:
        return None
    for n in ast.walk(tree):
        if isinstance(n, ast.Name) and n.id not in known:
            return None
        if not isinstance(n, (ast.Expression, ast.BinOp, ast.UnaryOp,
                              ast.Constant, ast.Name, ast.operator,
                              ast.unaryop, ast.Load)):
            return None
    try:
        v = eval(compile(tree, "<constexpr>", "eval"),  # noqa: S307
                 {"__builtins__": {}}, dict(known))
    except (ArithmeticError, TypeError, ValueError):
        return None
    return v if isinstance(v, int) else None


def _constexprs(sources: Dict[str, str]) -> Dict[str, Tuple[int, str, int]]:
    """``kName`` -> (value, relpath, line) of every integer
    ``constexpr`` at namespace scope."""
    out: Dict[str, Tuple[int, str, int]] = {}
    known: Dict[str, int] = {}
    for rel, text in sources.items():
        clean = _strip_comments(text)
        for m in _CONSTEXPR_RE.finditer(clean):
            v = _c_value(m.group(2), known)
            if v is None:
                continue
            known[m.group(1)] = v
            out.setdefault(m.group(1), (v, rel,
                                        clean.count("\n", 0, m.start()) + 1))
    return out


def _extern_c_symbols(sources: Dict[str, str]) -> Set[str]:
    """Every ``sdot_*`` function defined inside an ``extern "C" { }``
    block of a ``.cu`` source (braces matched on comment-free text)."""
    out: Set[str] = set()
    for rel, text in sources.items():
        if not rel.endswith(".cu"):
            continue
        clean = _strip_comments(text)
        for m in re.finditer(r'extern\s+"C"\s*\{', clean):
            depth, i = 1, m.end()
            while i < len(clean) and depth:
                depth += {"{": 1, "}": -1}.get(clean[i], 0)
                i += 1
            block = clean[m.end():i]
            out |= {d.group(1) for d in _DEF_RE.finditer(block)
                    if _opens_body(block, d.end() - 1)}
    return out


def _opens_body(text: str, paren: int) -> bool:
    """Whether the parameter list opening at ``text[paren]`` is followed
    by a function body (a definition, not a call or a declaration)."""
    depth, i = 0, paren
    while i < len(text):
        depth += {"(": 1, ")": -1}.get(text[i], 0)
        i += 1
        if depth == 0:
            break
    return text[i:].lstrip().startswith("{")


# -- module-level Python constants --------------------------------------------

def _const(expr: ast.expr) -> Optional[int]:
    """Compile-time integer of a Python expression (literals, + - * //
    ** << >>, unary minus); None when dynamic."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, int) \
            and not isinstance(expr.value, bool):
        return expr.value
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.USub):
        v = _const(expr.operand)
        return None if v is None else -v
    if isinstance(expr, ast.BinOp):
        a, b = _const(expr.left), _const(expr.right)
        if a is None or b is None:
            return None
        ops = {ast.Add: lambda: a + b, ast.Sub: lambda: a - b,
               ast.Mult: lambda: a * b, ast.FloorDiv: lambda: a // b,
               ast.Pow: lambda: a ** b, ast.LShift: lambda: a << b,
               ast.RShift: lambda: a >> b}
        f = ops.get(type(expr.op))
        try:
            return f() if f is not None else None
        except (ArithmeticError, ValueError):
            return None
    return None


def _module_consts(mod: Module) -> Dict[str, Tuple[int, int]]:
    """Top-level ``NAME = <int const-expr>``: name -> (value, line)."""
    out: Dict[str, Tuple[int, int]] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            v = _const(node.value)
            if v is not None:
                out[node.targets[0].id] = (v, node.lineno)
    return out


def _entry_default(mod: Module, key: str) -> Optional[Tuple[int, int]]:
    """``(default, line)`` of ``_entry("<key>", default, ...)``."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and len(node.args) >= 2 \
                and call_chain(node.func)[-1:] == ["_entry"] \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == key:
            v = _const(node.args[1])
            return None if v is None else (v, node.lineno)
    return None


# -- the rules ----------------------------------------------------------------

def _mirror_findings(project: Project,
                     cexpr: Dict[str, Tuple[int, str, int]]) -> List[Finding]:
    out: List[Finding] = []
    if not cexpr:
        return out
    for suffix, py_name, c_name in MIRRORS:
        mod = project.by_suffix(suffix)
        if mod is None:
            continue
        py = _module_consts(mod).get(py_name)
        if py is None:
            continue
        c = cexpr.get(c_name)
        if c is not None and c[0] == py[0]:
            continue
        what = f"{c_name} = {c[0]} ({c[1]}:{c[2]})" if c is not None \
            else f"no constexpr {c_name} in csrc/"
        out.append(Finding(
            "kernels", "mirror-mismatch", mod.relpath, py[1], py_name,
            f"{py_name} = {py[0]} mirrors the kernel's {c_name}, but the "
            f"CUDA source has {what}: the wrapper plans launches the "
            f"compiled kernel does not take"))
    return out


def _smem_findings(project: Project) -> List[Finding]:
    out: List[Finding] = []
    gb = project.by_suffix(_GROUPBY_SUFFIX)
    limit = _module_consts(gb).get("SMEM_LIMIT") if gb is not None \
        else None
    if limit is not None and limit[0] > HOPPER_SMEM_OPTIN:
        out.append(Finding(
            "kernels", "smem-budget", gb.relpath, limit[1], "SMEM_LIMIT",
            f"SMEM_LIMIT = {limit[0]} bytes passes Hopper's opt-in shared "
            f"memory per block ({HOPPER_SMEM_OPTIN}): every launch planned "
            f"up to it fails on the card"))
    cfg = project.by_suffix(_CONFIG_SUFFIX)
    scratch = _entry_default(cfg, _SCRATCH_KEY) if cfg is not None \
        else None
    if scratch is not None and limit is not None \
            and scratch[0] > limit[0]:
        out.append(Finding(
            "kernels", "smem-budget", cfg.relpath, scratch[1],
            _SCRATCH_KEY,
            f"{_SCRATCH_KEY} defaults to {scratch[0]} bytes, over "
            f"ops/cuda_groupby.SMEM_LIMIT ({limit[0]}): the wave planner "
            f"would accept storms the kernel cannot launch"))
    return out


def _theta_findings(project: Project) -> List[Finding]:
    wave = project.by_suffix(_WAVE_SUFFIX)
    if wave is None:
        return []
    cap = _module_consts(wave).get("THETA_KERNEL_MAX_ROWS")
    if cap is None or cap[0] == THETA_STRIPE_CAP:
        return []
    return [Finding(
        "kernels", "theta-cap-mismatch", wave.relpath, cap[1],
        "THETA_KERNEL_MAX_ROWS",
        f"THETA_KERNEL_MAX_ROWS = {cap[0]}, but the reference stripe's "
        f"cap is {THETA_STRIPE_CAP}: thetas split between the kernel and "
        f"the epilogue unlike the reference")]


def _bound_symbols(mod: Module) -> List[Tuple[str, int]]:
    """``sdot_*`` names a ctypes wrapper binds: ``<x>.sdot_name``
    attributes and ``"sdot_name"`` strings (``getattr(lib, name)``)."""
    out: List[Tuple[str, int]] = []
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.Attribute) and _SYMBOL_RE.match(n.attr):
            out.append((n.attr, n.lineno))
        elif isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and _SYMBOL_RE.match(n.value):
            out.append((n.value, n.lineno))
    return out


def _symbol_findings(project: Project,
                     sources: Dict[str, str]) -> List[Finding]:
    if not sources:
        return []
    defined = _extern_c_symbols(sources)
    out: List[Finding] = []
    for mod in sorted(project.modules.values(), key=lambda m: m.relpath):
        if "ctypes" not in mod.source:
            continue
        seen: Set[str] = set()
        for sym, line in _bound_symbols(mod):
            if sym in defined or sym in seen:
                continue
            seen.add(sym)
            out.append(Finding(
                "kernels", "unbound-symbol", mod.relpath, line, sym,
                f"{mod.relpath} binds {sym}, which no extern \"C\" block "
                f"of csrc/*.cu defines: the lookup raises on the card "
                f"only"))
    return out


def _is_plain(name: str) -> bool:
    return name == "reference" or name.endswith("_reference")


def _wrappers(project: Project) -> Set[str]:
    """Names of the functions that launch a kernel themselves: they call
    ``library()`` or a ctypes ``sdot_*`` symbol."""
    idx = project.index()
    out: Set[str] = set()
    for fid, fn in idx.functions.items():
        leaf = fid[1].split(".")[-1]
        if _is_plain(leaf) or leaf == "library":
            continue
        for n in walk_shallow(fn):
            if isinstance(n, ast.Call):
                ch = call_chain(n.func)
                if ch[-1:] == ["library"] \
                        or (ch and _SYMBOL_RE.match(ch[-1])):
                    out.add(leaf)
                    break
    return out


def _cpu_branch(test: ast.expr) -> Optional[str]:
    """Which branch of ``if`` is the CPU one: "body" for ``<x>.device.type
    != "cuda"`` / ``== "cpu"`` / ``not <x>.is_cuda`` (alone or as one
    disjunct of an ``or``), "orelse" for the converse, else None."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
        for v in test.values:
            b = _cpu_branch(v)
            if b == "body":
                return b
        return None
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = _cpu_branch(test.operand)
        return {"body": "orelse", "orelse": "body"}.get(inner)
    if isinstance(test, ast.Attribute) and test.attr == "is_cuda":
        return "orelse"
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        left, right = test.left, test.comparators[0]
        for a, b in ((left, right), (right, left)):
            if isinstance(a, ast.Attribute) and a.attr == "type" \
                    and isinstance(b, ast.Constant) \
                    and b.value in ("cuda", "cpu"):
                eq = isinstance(test.ops[0], (ast.Eq, ast.Is))
                cuda = b.value == "cuda"
                return "orelse" if eq == cuda else "body"
    return None


def _fallback_findings(project: Project) -> List[Finding]:
    idx = project.index()
    wrappers = _wrappers(project)
    out: List[Finding] = []

    def launches(node: ast.AST) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                ch = call_chain(n.func)
                if ch and (ch[-1] in wrappers or _SYMBOL_RE.match(ch[-1])):
                    return True
        return False

    def plain_calls(node: ast.AST) -> List[ast.Call]:
        return [n for n in ast.walk(node) if isinstance(n, ast.Call)
                and call_chain(n.func)[-1:]
                and _is_plain(call_chain(n.func)[-1])]

    for fid, fn in sorted(idx.functions.items()):
        if _is_plain(fid[1].split(".")[-1]):
            continue            # a plain version may compose others
        path = idx.modules[fid[0]].mod.relpath
        in_handler: Set[int] = set()
        for node in walk_shallow(fn):
            if isinstance(node, ast.Try) and any(
                    launches(s) for s in node.body):
                for h in node.handlers:
                    for c in plain_calls(h):
                        in_handler.add(id(c))
                        name = call_chain(c.func)[-1]
                        out.append(Finding(
                            "kernels", "fallback-hides-card", path,
                            c.lineno, f"{fid[1]}:{name}",
                            f"{fid[1]} answers from the plain version "
                            f"{name} when the kernel launch raises: a "
                            f"broken kernel on the card would go unseen"))
        gated: Set[int] = set()

        def mark(stmts):
            for st in stmts:
                if isinstance(st, ast.If):
                    br = _cpu_branch(st.test)
                    if br is not None:
                        for s in getattr(st, br):
                            gated.update(id(c) for c in plain_calls(s))
                    mark(st.body)
                    mark(st.orelse)
                else:
                    for field in ("body", "orelse", "finalbody"):
                        mark(getattr(st, field, ()) or ())
                    for h in getattr(st, "handlers", ()):
                        mark(h.body)

        mark(fn.body)
        for node in walk_shallow(fn):
            if isinstance(node, ast.Call) and id(node) not in gated \
                    and id(node) not in in_handler \
                    and call_chain(node.func)[-1:] \
                    and _is_plain(call_chain(node.func)[-1]):
                name = call_chain(node.func)[-1]
                out.append(Finding(
                    "kernels", "plain-not-cpu-gated", path, node.lineno,
                    f"{fid[1]}:{name}",
                    f"{fid[1]} calls the plain version {name} outside the "
                    f"CPU branch of a device test: a CUDA tensor could "
                    f"take it instead of its kernel"))
    return out


def run(project: Project) -> List[Finding]:
    sources = _sources(project)
    cexpr = _constexprs(sources)
    return (_mirror_findings(project, cexpr) + _smem_findings(project)
            + _theta_findings(project) + _symbol_findings(project, sources)
            + _fallback_findings(project))
