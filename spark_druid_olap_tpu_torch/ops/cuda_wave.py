"""Wave kernel: one launch of a hand-written Hopper kernel per fused
shared-scan wave.

Port of ``spark_druid_olap_tpu/ops/pallas_wave.py``, whose Pallas TPU
kernel (``build_wave_fn``'s inner ``kernel``) becomes the CUDA C++ kernel
``csrc/wave.cu``. As there, the kernel re-schedules the engine's lowering
and never re-implements query semantics: each lane's parts — ``base =
row_valid & filter & interval``, the fused group key and every dense
aggregate's values and mask (:func:`_lane_parts`) — are built by the
engine's own builders over a ``ScanContext``, with the fusion plan's
``CSECache`` so shared predicates lower once.

Where the TPU kernel traced those builders inside its body, the port
traces them once on the host: ``make_fx`` over fake ``[1, 8]`` probe
tiles records the aten ops they run, and :func:`compile_wave` translates
that graph into a flat register program (opcode, dtype, destination,
operands, immediate), deduplicated, pruned and register-allocated. The
counterpart of the JAX package's ``make_jaxpr`` + ``_check_jaxpr`` and its
``_SAFE_PRIMS`` whitelist: comparisons, boolean and bitwise ops, ``where``,
add / sub / mul / div / remainder / floor division, neg / abs / floor /
ceil / round / trunc, minimum / maximum / clamp, casts, 0-d constants and
shape no-ops on a row. Anything else — a gather or LUT (``take1d``), a
non-UTC timezone's day-offset table, a non-scalar tensor constant, a
trace that needs data (``.item()``) — raises :class:`WaveFallback` naming
the op, and so does a program over the kernel's instruction, register or
column caps or a scratch over its shared-memory budget. The caller then
runs the group lane by lane (``parallel/sharedscan.py``); a WaveFallback
is only ever raised at build time.

Every thread of ``csrc/wave.cu`` runs the program over two rows at once,
with registers typed as traced in a file sized by the program (4-byte words
when no register is wider, :func:`register_width`), in shared memory where
it fits, else over one row from local memory (:func:`register_file`). Each
instruction carries a specialised
handler where its (op, dtype) has one (:func:`fast_code`), and constants
become immediate operands. Then every lane's aggregates fold with the
warp-parallel tier of the fused dense group-by kernel's deterministic fold.
The plain version,
:func:`wave_reference`, interprets the same program with one PyTorch op
per instruction and runs each lane through
``cuda_groupby.dense_groupby_reference``. :func:`wave_groupby` takes that
plain version for CPU tensors only; on CUDA tensors it launches the kernel
or raises. A lane's dense count / sum / min / max aggregates must ride the
fused kernel's tier.

Sketch lanes split as the TPU kernel splits them: a theta aggregate whose
stripe of ``n_keys * 64`` min slots is at most ``THETA_KERNEL_MAX_ROWS``
(256) runs inside the kernel (the stripe of ``pallas_wave.py`` :403-414:
per key and hash lane, the minimum of ``_hash01(value, lane)`` over the
rows that count, 2.0 where none does; the hash is ``csrc/sketch_hash.cuh``);
HLL, KLL and wider theta run after the launch as the engine's register ops
(``ops/sketch.py``) over the wave's bind — the epilogue of
``pallas_wave.py`` :450-498.

Accumulators are int64 / float64 slots (B1's identities, no Neumaier
pairs, no f32 sentinels): per lane and key one slot per dense aggregate
plus the lane's ``__rows__`` count, in the route's type, then the lane's
theta stripes (float64 slots of float32 hashes, min).
"""

from __future__ import annotations

import ctypes
import dataclasses
import heapq
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from spark_druid_olap_tpu_torch.ops import cuda_build as CB
from spark_druid_olap_tpu_torch.ops import cuda_groupby as CG
from spark_druid_olap_tpu_torch.ops import filters as F
from spark_druid_olap_tpu_torch.ops import groupby as G
from spark_druid_olap_tpu_torch.ops import theta as TH
from spark_druid_olap_tpu_torch.ops.scan import ScanContext, array_dtype
from spark_druid_olap_tpu_torch.ops.sketch import (
    SKETCH_KINDS,
    sketch_registers,
)
from spark_druid_olap_tpu_torch.planner import fusion as FU

SOURCE = CB.CSRC / "wave.cu"

# the kernel's caps (kMaxInstrs, kMaxRegs, kMaxCols in csrc/wave.cu)
MAX_INSTRS = 1024
MAX_REGS = 128
MAX_COLS = 64
NONE = 255
IMM = 254                          # operand b is the instruction's immediate
THREADS = CG.THREADS
WARPS = CG.WARPS
SMEM_LIMIT = CG.SMEM_LIMIT         # opt-in shared memory, less the static part
#: the kernel's register-file layouts: (rows each thread runs the program
#: over at once, file in shared memory); the local-memory file takes no
#: shared memory and serves where the shared one does not fit
FILE_LAYOUTS = ((2, True), (1, False))
PROBE_SHAPE = (1, 8)
#: the in-kernel theta cap: a stripe of n_keys * 64 slots runs in the kernel
#: up to this many, past it in the epilogue (pallas_wave.py's rule)
THETA_KERNEL_MAX_ROWS = 256

#: register dtypes, by code (``DType`` in csrc/wave.cu)
DTYPES = (torch.bool, torch.int8, torch.int16, torch.int32, torch.int64,
          torch.uint8, torch.float32, torch.float64)
DT = {d: i for i, d in enumerate(DTYPES)}
#: opcodes, by code (``Op`` in csrc/wave.cu)
OPS = ("load", "const", "cast", "add", "sub", "mul", "div", "floordiv",
       "truncdiv", "rem", "neg", "abs", "floor", "ceil", "round", "trunc",
       "minimum", "maximum", "eq", "ne", "lt", "le", "gt", "ge", "and", "or",
       "xor", "not", "where")
OP = {n: i for i, n in enumerate(OPS)}
_UNARY = ("neg", "abs", "floor", "ceil", "round", "trunc", "not")
_CMP = ("eq", "ne", "lt", "le", "gt", "ge")
# binary ops whose constant operand may become an immediate; the second map
# swaps a constant first operand to second (a + c == c + a bit for bit, and
# c < a is a > c)
_IMM_OPS = frozenset(("add", "sub", "mul", "div", "floordiv", "truncdiv",
                      "rem", "minimum", "maximum", "and", "or", "xor")
                     + _CMP)
_SWAP = {"add": "add", "mul": "mul", "and": "and", "or": "or", "xor": "xor",
         "eq": "eq", "ne": "ne", "lt": "gt", "gt": "lt", "le": "ge",
         "ge": "le"}

INSTR = np.dtype([("op", "u1"), ("dt", "u1"), ("src", "u1"), ("dst", "u1"),
                  ("a", "u1"), ("b", "u1"), ("c", "u1"), ("fast", "u1"),
                  ("imm", "<i8")])
#: the kernel's specialised handlers, by code (``Fast`` in
#: csrc/wave_program.cuh); :func:`fast_code` picks one per instruction
FAST = ("generic", "const_int", "load_bool", "load_i8", "load_u8",
        "load_i16", "load_i32", "load_f32", "add_i32", "sub_i32", "mul_i32",
        "floordiv_i32", "eq_int", "ne_int", "lt_int", "le_int", "gt_int",
        "ge_int", "eq_f32", "ne_f32", "lt_f32", "le_f32", "gt_f32", "ge_f32",
        "add_f32", "sub_f32", "mul_f32", "div_f32", "and_int", "or_int",
        "xor_int", "not_bool", "where", "cast_i32", "cast_f32")
_INT_DTYPES = (torch.bool, torch.int8, torch.int16, torch.int32, torch.int64,
               torch.uint8)
_LOAD_FAST = {torch.bool: "load_bool", torch.int8: "load_i8",
              torch.uint8: "load_u8", torch.int16: "load_i16",
              torch.int32: "load_i32", torch.float32: "load_f32"}
LANE = np.dtype([("base_reg", "<i4"), ("key_reg", "<i4"),
                 ("n_keys", "<i4"), ("n_aggs", "<i4"),
                 ("agg_start", "<i4"), ("slot_off", "<i4"),
                 ("n_theta", "<i4"), ("pad", "<i4")])
AGG = np.dtype([("kind", "u1"), ("flt", "u1"), ("val_reg", "u1"),
                ("val_dt", "u1"), ("mask_reg", "u1"), ("pad", "u1", (3,))])

#: kernel launches made by :func:`wave_groupby` (each the partials kernel
#: plus its block fold)
launches = 0
#: what the last build did: {"seconds": float, "log": str, "cached": bool}
build_info: Dict[str, object] = {}

_lib = None
_lib_lock = threading.Lock()
# one lane trace at a time in the process (see ``compile_wave``)
_trace_lock = threading.Lock()


class WaveFallback(Exception):
    """Raised at build time when a fused group cannot run as one wave
    kernel; the caller runs the group lane by lane."""


# =============================================================================
# eligibility
# =============================================================================

def wave_decline(lanes, max_lanes: int, max_keys: int) -> Optional[str]:
    """Why a fused group does not take the wave kernel, from plan metadata
    alone, or None when it does. The counterpart of the JAX package's
    ``wave_eligible``: there every sum / count route had to be ``ffl``
    (the Pallas group-by's tier); here every lane's dense aggregates must
    ride the fused group-by kernel's tier (``ops/groupby.use_kernel``:
    ``0 < n_keys <= sdot.engine.groupby.pallas.max.keys``, kinds in
    ``cuda_groupby.KINDS``), and the group must be within the lane cap.
    Sketch aggregates never decline: they run in the kernel's theta stripe
    or in the epilogue."""
    if max_lanes <= 0 or len(lanes) > max_lanes:
        return (f"{len(lanes)} lanes exceed sdot.pallas.wave.max.lanes="
                f"{max_lanes}")
    for lp in lanes:
        dense = [p for p in lp.agg_plans if p.kind not in SKETCH_KINDS]
        if not G.use_kernel(lp.n_keys, dense, max_keys):
            return (f"a lane with {lp.n_keys} keys and kinds "
                    f"{sorted({p.kind for p in dense})} is outside "
                    f"the fused group-by tier (sdot.engine.groupby.pallas."
                    f"max.keys={max_keys})")
    return None


def wave_eligible(lanes, max_lanes: int, max_keys: int) -> bool:
    """Static precheck, callable on every fused execution (warm program
    cache included), so the program signature and the dispatch agree."""
    return wave_decline(lanes, max_lanes, max_keys) is None


def theta_inkernel(lp) -> List[str]:
    """The lane's theta aggregates whose stripe runs inside the kernel
    (``n_keys * 64 <= THETA_KERNEL_MAX_ROWS``); its other sketches run in
    the epilogue."""
    if lp.n_keys * TH.K_LANES > THETA_KERNEL_MAX_ROWS:
        return []
    return [p.spec.name for p in lp.agg_plans if p.kind == "theta"]


def _lane_parts(lp, ctx: ScanContext, cse: Optional[FU.CSECache],
                dense: bool = True, sketches=()):
    """One lane's parts over ``ctx`` — the engine's own builders, as the
    lane-by-lane program (``parallel/sharedscan.py``) composes them:
    ``(base, key, dense, sketch)``. ``dense`` lists ``(kind, name, values,
    mask)`` of the dense aggregates, values already in their route's
    dtype, ending with the lane's ``__rows__`` count (empty when ``dense``
    is False); ``sketch`` lists ``(name, values, mask)`` of the sketch
    aggregates named in ``sketches``, a DOUBLE column's values as float32
    (the kernel hashes their bits)."""
    base = ctx.row_valid()
    fm = cse.lower(lp.q.filter) if cse is not None \
        else F.lower_filter(lp.q.filter, ctx)
    if fm is not None:
        base = base & fm
    im = cse.interval(lp.q.intervals) if cse is not None \
        else F.interval_mask(lp.q.intervals, ctx)
    if im is not None:
        base = base & im
    if lp.dim_plans:
        codes = [p.build(ctx) for p in lp.dim_plans]
        key, _ = G.fuse_keys(codes, [p.card for p in lp.dim_plans])
    else:
        key = torch.zeros_like(base, dtype=torch.int32)
    parts, sketch = [], []
    for p in lp.agg_plans:
        name = p.spec.name
        if p.kind in SKETCH_KINDS:
            if name in sketches:
                sketch.append((name, p.build_values(ctx, bits=False),
                               p.build_mask(ctx, cse=cse)))
            continue
        if not dense:
            continue
        vals = None
        if p.kind != "count":
            vals = p.build_values(ctx)
            vals = vals.to(G._value_dtype(lp.routes[name], vals))
        parts.append((p.kind, name, vals, p.build_mask(ctx, cse=cse)))
    if dense:
        parts.append(("count", "__rows__", None, None))
    return base, key, parts, sketch


# =============================================================================
# the lane-program compiler
# =============================================================================

@dataclasses.dataclass
class LaneProgram:
    """A register program. ``instrs`` rows are ``(op, dt, src, dst, a, b,
    c, imm)`` (codes of :data:`OPS` / :data:`DTYPES`; ``imm`` is a column
    index for ``load``, the value for ``const`` — an int, or a float already
    rounded to ``dt`` — and for a binary op whose ``b`` is :data:`IMM`, its
    constant second operand). ``columns`` are the union arrays the loads
    read;
    ``outputs`` the registers holding the traced outputs after the last
    instruction."""

    instrs: List[tuple]
    columns: List[str]
    column_dtypes: List[torch.dtype]
    outputs: List[int]
    output_dtypes: List[torch.dtype]
    n_regs: int
    _blobs: Dict[object, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)


@dataclasses.dataclass
class LaneSlots:
    """One lane's part of the wave: its program outputs and its slots."""

    n_keys: int
    base: int                       # output index of the lane's bool base
    key: int                        # output index of its int32 key
    # (name, kind, flt, values output index or None, mask output or None)
    aggs: List[tuple]
    slot_off: int
    # the in-kernel theta aggregates: (name, values output, mask or None);
    # their stripes follow the dense slots, n_keys * 64 slots each
    thetas: List[tuple] = dataclasses.field(default_factory=list)

    @property
    def n_aggs(self) -> int:
        return len(self.aggs)

    @property
    def theta_off(self) -> int:
        return self.slot_off + self.n_keys * self.n_aggs

    @property
    def n_slots(self) -> int:
        return self.n_keys * (self.n_aggs + len(self.thetas) * TH.K_LANES)


@dataclasses.dataclass
class WaveLayout:
    lanes: List[LaneSlots]
    n_slots: int
    #: the kernel's register-file layout (an entry of FILE_LAYOUTS), chosen
    #: by :func:`register_file` when the wave is built
    file: Optional[tuple] = None


class _Val:
    """A traced value: virtual register, dtype, 0-d (for promotion)."""
    __slots__ = ("v", "dt", "scalar")

    def __init__(self, v: int, dt: torch.dtype, scalar: bool):
        self.v, self.dt, self.scalar = v, dt, scalar


class _Big:
    """A non-scalar tensor constant (a LUT): refused where it is used."""
    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = tuple(shape)


_SHAPE_OPS = frozenset({"view", "_unsafe_view", "reshape", "expand",
                        "squeeze", "unsqueeze", "flatten", "clone", "alias",
                        "detach", "lift_fresh_copy", "contiguous"})
_FILL_OPS = frozenset({"zeros_like", "ones_like", "full_like",
                       "scalar_tensor"})
# the aten op packets the compiler translates (the wave kernel's whitelist)
_KNOWN = _SHAPE_OPS | _FILL_OPS | frozenset(_CMP) | frozenset({
    "add", "sub", "mul", "rsub", "div", "floor_divide", "remainder",
    "minimum", "maximum", "clamp", "clamp_min", "clamp_max", "bitwise_and",
    "bitwise_or", "bitwise_xor", "logical_and", "logical_or", "logical_xor",
    "bitwise_not", "logical_not", "neg", "abs", "floor", "ceil", "round",
    "trunc", "where", "_to_copy"})


def _const_imm(value, dt: torch.dtype) -> int:
    if dt.is_floating_point:
        v = np.float32(value) if dt == torch.float32 else np.float64(value)
        return int(np.float64(v).view(np.int64))
    if dt == torch.bool:
        return int(bool(value))
    v = int(value)
    info = torch.iinfo(dt)
    if not info.min <= v <= info.max:
        raise WaveFallback(f"constant {value!r} outside {dt}")
    return v


def _imm_value(imm: int, dt: torch.dtype):
    if dt.is_floating_point:
        return float(np.int64(imm).view(np.float64))
    return bool(imm) if dt == torch.bool else int(imm)


class _Compiler:
    """Translates one ``make_fx`` graph into a deduplicated instruction
    list over virtual registers."""

    def __init__(self, gm, n_rows: int):
        self.gm = gm
        self.n_rows = n_rows
        self.code: List[list] = []
        self.memo: Dict[tuple, int] = {}

    def emit(self, op: str, dt: torch.dtype, a=NONE, b=NONE, c=NONE,
             src=0, imm=0) -> int:
        key = (OP[op], DT[dt], src, a, b, c, imm)
        v = self.memo.get(key)
        if v is None:
            v = len(self.code)
            self.code.append([OP[op], DT[dt], src, v, a, b, c, imm])
            self.memo[key] = v
        return v

    def const(self, value, dt: torch.dtype, scalar=True) -> _Val:
        return _Val(self.emit("const", dt, imm=_const_imm(value, dt)), dt,
                    scalar)

    def as_dt(self, x, dt: torch.dtype) -> int:
        if not isinstance(x, _Val):
            return self.const(x, dt).v
        if x.dt == dt:
            return x.v
        return self.emit("cast", dt, a=x.v, src=DT[x.dt])

    @staticmethod
    def _example(x):
        if isinstance(x, _Val):
            return torch.empty(() if x.scalar else (1,), dtype=x.dt)
        return x

    def promote(self, a, b) -> torch.dtype:
        return torch.result_type(self._example(a), self._example(b))

    @staticmethod
    def _agree(node, dt, out_dt):
        """The dtype the kernel computes in must be the one the trace
        recorded: a promotion rule the compiler got wrong declines the
        wave instead of computing in the wrong type."""
        if dt != out_dt:
            raise WaveFallback(f"{node.target}: computes in {dt}, the trace "
                               f"gives {out_dt}")

    def binary(self, node, op, a, b, dt, out_dt, scalar):
        self._agree(node, torch.bool if op in _CMP else dt, out_dt)
        return _Val(self.emit(op, dt, self.as_dt(a, dt), self.as_dt(b, dt)),
                    out_dt, scalar)

    def translate(self, node, args, kwargs):
        name = node.target.overloadpacket.__name__
        if name not in _KNOWN:
            raise WaveFallback(f"lane lowering traces {node.target}, which "
                               f"is not an elementwise op the wave kernel "
                               f"runs")
        if name in _SHAPE_OPS and isinstance(args[0], _Big):
            return _Big(node.meta["val"].shape)   # refused where it is used
        out = node.meta.get("val")
        if not isinstance(out, torch.Tensor):
            raise WaveFallback(f"{node.target} gives no tensor")
        odt, scalar = out.dtype, out.dim() == 0
        if odt not in DT:
            raise WaveFallback(f"{node.target} gives dtype {odt}")
        vals = [x for x in list(args) + list(kwargs.values())
                if isinstance(x, (_Val, _Big))]
        for x in vals:
            if isinstance(x, _Big):
                raise WaveFallback(f"{node.target} uses a non-scalar tensor "
                                   f"constant of shape {x.shape}")
        if out.numel() == 1 and any(not x.scalar for x in vals) \
                and name not in _SHAPE_OPS:
            raise WaveFallback(f"{node.target} reduces rows")
        if out.numel() not in (1, self.n_rows):
            raise WaveFallback(f"{node.target} changes the row count")
        if name in ("add", "sub", "mul", "rsub"):
            if kwargs.get("alpha", 1) != 1:
                raise WaveFallback(f"{node.target} with alpha")
            a, b = args[0], args[1]
            if name == "rsub":
                a, b, name = b, a, "sub"
            dt = self.promote(a, b)
            return self.binary(node, name, a, b, dt, odt, scalar)
        if name in ("div", "floor_divide", "remainder"):
            a, b = args[0], args[1]
            dt = self.promote(a, b)
            mode = kwargs.get("rounding_mode", args[2] if len(args) > 2
                              else None) if name == "div" else name
            if mode is None:
                if not dt.is_floating_point:
                    dt = torch.get_default_dtype()
                return self.binary(node, "div", a, b, dt, odt, scalar)
            op = {"floor": "floordiv", "floor_divide": "floordiv",
                  "trunc": "truncdiv", "remainder": "rem"}[mode]
            return self.binary(node, op, a, b, dt, odt, scalar)
        if name in ("minimum", "maximum"):
            return self.binary(node, name, args[0], args[1],
                               self.promote(args[0], args[1]), odt, scalar)
        if name in ("clamp", "clamp_min", "clamp_max"):
            x = args[0]
            lo = kwargs.get("min", args[1] if len(args) > 1 else None)
            hi = kwargs.get("max", args[2] if len(args) > 2 else None)
            if name == "clamp_max":
                lo, hi = None, lo
            v = _Val(self.as_dt(x, odt), odt, scalar)
            if lo is not None:
                v = self.binary(node, "maximum", v, lo, odt, odt, scalar)
            if hi is not None:
                v = self.binary(node, "minimum", v, hi, odt, odt, scalar)
            return v
        if name in _CMP:
            return self.binary(node, name, args[0], args[1],
                               self.promote(args[0], args[1]), odt, scalar)
        if name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
            dt = self.promote(args[0], args[1])
            if dt.is_floating_point:
                raise WaveFallback(f"{node.target} on floats")
            return self.binary(node, name[len("bitwise_"):], args[0],
                               args[1], dt, odt, scalar)
        if name in ("logical_and", "logical_or", "logical_xor"):
            return self.binary(node, name[len("logical_"):], args[0],
                               args[1], torch.bool, odt, scalar)
        if name in ("bitwise_not", "logical_not"):
            x = args[0]
            dt = torch.bool if name == "logical_not" else x.dt
            if dt.is_floating_point:
                raise WaveFallback(f"{node.target} on floats")
            self._agree(node, dt, odt)
            return _Val(self.emit("not", dt, self.as_dt(x, dt)), odt,
                        scalar)
        if name in ("neg", "abs", "floor", "ceil", "round", "trunc"):
            x = args[0]
            if len(args) > 1 or kwargs:
                raise WaveFallback(f"{node.target} with arguments")
            self._agree(node, x.dt, odt)
            if not x.dt.is_floating_point and name not in ("neg", "abs"):
                return x                  # rounding an integer is a copy
            return _Val(self.emit(name, x.dt, x.v), odt, scalar)
        if name == "where":
            cond, a, b = args[0], args[1], args[2]
            dt = self.promote(a, b)
            self._agree(node, dt, odt)
            return _Val(self.emit("where", dt, self.as_dt(cond, torch.bool),
                                  self.as_dt(a, dt), self.as_dt(b, dt)),
                        odt, scalar)
        if name == "_to_copy":
            x = args[0]
            return _Val(self.as_dt(x, odt), odt, scalar)
        if name in _SHAPE_OPS:
            x = args[0]
            if not isinstance(x, _Val):
                raise WaveFallback(f"{node.target} of a non-tensor")
            src = node.args[0].meta["val"]
            if src.numel() != out.numel() and src.numel() != 1:
                raise WaveFallback(f"{node.target} changes the row count")
            return _Val(x.v, x.dt, scalar)
        if name in _FILL_OPS:
            fill = {"zeros_like": 0, "ones_like": 1,
                    "full_like": args[1] if len(args) > 1 else None,
                    "scalar_tensor": args[0]}[name]
            if isinstance(fill, (_Val, _Big)):
                raise WaveFallback(f"{node.target} of a tensor")
            return self.const(fill, odt, scalar)
        raise AssertionError(name)

    def run(self, n_inputs: int):
        env = {}
        placeholders = 0
        outputs = None

        def arg(x):
            if isinstance(x, torch.fx.Node):
                return env[x]
            if isinstance(x, (list, tuple)):
                return type(x)(arg(y) for y in x)
            return x

        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                t = node.meta["val"]
                if t.dtype not in DT:
                    raise WaveFallback(f"column dtype {t.dtype}")
                env[node] = _Val(self.emit("load", t.dtype,
                                           imm=placeholders), t.dtype, False)
                placeholders += 1
            elif node.op == "get_attr":
                t = getattr(self.gm, node.target)
                if t.numel() == 1 and t.dtype in DT:
                    env[node] = self.const(t.item(), t.dtype, t.dim() == 0)
                else:
                    env[node] = _Big(t.shape)
            elif node.op == "call_function":
                if not hasattr(node.target, "overloadpacket"):
                    raise WaveFallback(f"lane lowering traces {node.target}")
                env[node] = self.translate(node, arg(node.args),
                                           arg(node.kwargs))
            elif node.op == "output":
                outputs = [env[x] for x in node.args[0]]
            else:
                raise WaveFallback(f"trace node {node.op}")
        assert placeholders == n_inputs
        for o in outputs:
            if not isinstance(o, _Val):
                raise WaveFallback("a lane output is a tensor constant")
        return outputs


def _operands(ins) -> tuple:
    op = OPS[ins[0]]
    if op in ("load", "const"):
        return ()
    if op == "where":
        return (ins[4], ins[5], ins[6])
    if op == "cast" or op in _UNARY or ins[5] == IMM:
        return (ins[4],)
    return (ins[4], ins[5])


def _immediates(code: List[list]) -> None:
    """A binary op whose second operand is a constant of its dtype takes the
    constant as an immediate (operand b = :data:`IMM`, the value in imm); a
    constant first operand of a commutative op or a comparison is swapped
    to second first. The constants no op reads any more die with the next
    dead-code pass."""
    consts = {ins[3]: ins for ins in code if ins[0] == OP["const"]}

    def const_of(v, dt):
        c = consts.get(v)
        return c if c is not None and c[1] == dt else None

    for ins in code:
        name = OPS[ins[0]]
        if name not in _IMM_OPS:
            continue
        if const_of(ins[5], ins[1]) is None and name in _SWAP \
                and const_of(ins[4], ins[1]) is not None:
            ins[0] = OP[_SWAP[name]]
            ins[4], ins[5] = ins[5], ins[4]
        c = const_of(ins[5], ins[1])
        if c is not None and const_of(ins[4], ins[1]) is None:
            ins[5], ins[7] = IMM, c[7]


def _finish(code: List[list], outs: List[_Val], names, dtypes
            ) -> LaneProgram:
    """Dead-code elimination, immediates, column compaction and register
    allocation (linear scan, lowest free register first; outputs stay live
    to the end)."""
    out_vregs = [o.v for o in outs]
    live = set(out_vregs)
    keep = []
    for ins in reversed(code):
        if ins[3] in live:
            keep.append(list(ins))
            live.update(_operands(ins))
    keep.reverse()
    _immediates(keep)
    live = set(out_vregs)
    for ins in reversed(keep):
        if ins[3] in live:
            live.update(_operands(ins))
    keep = [ins for ins in keep if ins[3] in live]
    cols: List[int] = []
    for ins in keep:
        if ins[0] == OP["load"]:
            if ins[7] not in cols:
                cols.append(ins[7])
            ins[7] = cols.index(ins[7])
    last: Dict[int, float] = {}
    for i, ins in enumerate(keep):
        for o in _operands(ins):
            last[o] = i
    for o in out_vregs:
        last[o] = float("inf")
    phys: Dict[int, int] = {}
    free: List[int] = []
    n_regs = 0
    for i, ins in enumerate(keep):
        ops = _operands(ins)
        for o in set(ops):
            if last[o] == i:
                heapq.heappush(free, phys[o])
        if free:
            r = heapq.heappop(free)
        else:
            r = n_regs
            n_regs += 1
        for j, o in zip((4, 5, 6), ops):
            ins[j] = phys[o]
        phys[ins[3]] = r
        ins[3] = r
    if len(keep) > MAX_INSTRS:
        raise WaveFallback(f"lane program of {len(keep)} instructions "
                           f"exceeds the kernel's {MAX_INSTRS}")
    if n_regs > MAX_REGS:
        raise WaveFallback(f"lane program needs {n_regs} registers, over "
                           f"the kernel's {MAX_REGS}")
    if len(cols) > MAX_COLS:
        raise WaveFallback(f"lane program reads {len(cols)} columns, over "
                           f"the kernel's {MAX_COLS}")
    return LaneProgram([tuple(i) for i in keep], [names[c] for c in cols],
                       [dtypes[c] for c in cols],
                       [phys[o] for o in out_vregs], [o.dt for o in outs],
                       n_regs)


def _column_dtype(ds, name: str) -> torch.dtype:
    dt = np.dtype(array_dtype(ds, name))
    return torch.bool if dt == np.bool_ else getattr(torch, dt.name)


def compile_wave(ds, lanes, min_day: int, max_day: int, fplan, *,
                 union_names, tz: str):
    """Trace every lane of a fused group over probe tiles and compile the
    trace into ``(LaneProgram, WaveLayout)``: each lane's base, key, dense
    aggregates and in-kernel theta aggregates (:func:`theta_inkernel`).
    Raises :class:`WaveFallback` with the reason when a lane does not
    lower to the kernel's ops."""
    from torch.fx.experimental.proxy_tensor import make_fx
    names = list(union_names)
    dtypes = [_column_dtype(ds, k) for k in names]
    structure: List[tuple] = []

    def probe(*tiles):
        ctx = ScanContext(ds, dict(zip(names, tiles)), min_day, max_day,
                          tz=tz)
        cse = FU.CSECache(ctx)
        if fplan is not None:
            cse.prelower(fplan)
        outs = []
        structure.clear()

        def put(t):
            if t is None:
                return None
            outs.append(t)
            return len(outs) - 1

        for lp in lanes:
            base, key, dense, theta = _lane_parts(
                lp, ctx, cse, sketches=theta_inkernel(lp))
            structure.append((put(base), put(key),
                              [(kind, name, put(v), put(m))
                               for kind, name, v, m in dense],
                              [(name, put(v), put(m))
                               for name, v, m in theta]))
        return outs

    tiles = [torch.zeros(PROBE_SHAPE, dtype=d) for d in dtypes]
    try:
        # make_fx patches process-wide tracer state (torch.fx's current
        # patcher): two engines of one process (a cluster's in-process
        # historicals) tracing at once would corrupt each other's trace
        with _trace_lock:
            gm = make_fx(probe, tracing_mode="fake")(*tiles)
    except WaveFallback:
        raise
    except Exception as e:  # noqa: BLE001 — the reason names what failed
        raise WaveFallback(f"lane trace failed: {type(e).__name__}: "
                           f"{e}") from e
    comp = _Compiler(gm, int(np.prod(PROBE_SHAPE)))
    outs = comp.run(len(names))
    for lp, (b, k, dense, theta) in zip(lanes, structure):
        if outs[b].dt != torch.bool or outs[k].dt != torch.int32:
            raise WaveFallback("a lane's base is not bool or its key not "
                               "int32")
    program = _finish(comp.code, outs, names, dtypes)

    slot = 0
    slots = []
    for lp, (b, k, dense, theta) in zip(lanes, structure):
        aggs = [(name, kind, lp.routes[name].tag == "f64", v, m)
                for kind, name, v, m in dense]
        slots.append(LaneSlots(lp.n_keys, b, k, aggs, slot, theta))
        slot += slots[-1].n_slots
    layout = WaveLayout(slots, slot)
    for ls in slots:
        for name, kind, flt, v, m in ls.aggs:
            if v is not None:
                vdt = outs[v].dt
                if vdt.is_floating_point != flt:
                    raise WaveFallback(f"{name}: values of {vdt} on a "
                                       f"{'f64' if flt else 'i64'} route")
            if m is not None and outs[m].dt != torch.bool:
                raise WaveFallback(f"{name}: mask of {outs[m].dt}")
        for name, v, m in ls.thetas:
            if outs[v].dt == torch.float64:
                raise WaveFallback(f"{name}: theta over float64 values")
            if m is not None and outs[m].dt != torch.bool:
                raise WaveFallback(f"{name}: mask of {outs[m].dt}")
    return program, layout


# =============================================================================
# the plain version
# =============================================================================

_TORCH_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "floordiv": lambda a, b: torch.div(a, b, rounding_mode="floor"),
    "truncdiv": lambda a, b: torch.div(a, b, rounding_mode="trunc"),
    "rem": torch.remainder, "minimum": torch.minimum,
    "maximum": torch.maximum, "eq": torch.eq, "ne": torch.ne,
    "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
    "and": torch.bitwise_and, "or": torch.bitwise_or,
    "xor": torch.bitwise_xor}
_TORCH_UNARY = {"neg": torch.neg, "abs": torch.abs, "floor": torch.floor,
                "ceil": torch.ceil, "round": torch.round,
                "trunc": torch.trunc, "not": torch.bitwise_not}


def run_program(program: LaneProgram, columns: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """Interpret ``program`` over flat ``columns`` with one PyTorch op per
    instruction; returns the output registers (a 0-d tensor where an
    output is constant)."""
    dev = columns[0].device if columns else torch.device("cpu")
    regs: List[Optional[torch.Tensor]] = [None] * program.n_regs
    for op, dt, src, dst, a, b, c, imm in program.instrs:
        name, t = OPS[op], DTYPES[dt]
        if name == "load":
            r = columns[imm].reshape(-1)
        elif name == "const":
            r = torch.tensor(_imm_value(imm, t), dtype=t, device=dev)
        elif name == "cast":
            r = regs[a].to(t)
        elif name == "where":
            r = torch.where(regs[a], regs[b], regs[c])
        elif name in _TORCH_UNARY:
            r = _TORCH_UNARY[name](regs[a])
        else:
            rhs = torch.tensor(_imm_value(imm, t), dtype=t, device=dev) \
                if b == IMM else regs[b]
            r = _TORCH_BINARY[name](regs[a], rhs)
        regs[dst] = r
    return [regs[o] for o in program.outputs]


def _flat(t: torch.Tensor, n: int) -> torch.Tensor:
    return torch.broadcast_to(t.reshape(-1), (n,)).contiguous() \
        if t.numel() == 1 else t.reshape(-1)


def wave_reference(program: LaneProgram, columns: Sequence[torch.Tensor],
                   layout: WaveLayout) -> List[Dict[str, torch.Tensor]]:
    """Plain PyTorch version of the kernel (same inputs, same outputs): the
    program through :func:`run_program`, then per lane the fused group-by's
    plain version over ``where(base, key, n_keys)`` and each in-kernel
    theta's stripe through ``ops/theta.theta_registers`` (2.0 where no row
    counts). Returns one dict per lane: aggregate name (and ``__rows__``)
    -> ``[n_keys]`` int64 or float64 tensor, as
    ``ops/groupby.dense_groupby`` returns, and theta name -> ``[n_keys,
    64]`` float32 registers."""
    outs = run_program(program, columns)
    n = columns[0].numel()
    res = []
    for ls in layout.lanes:
        base = _flat(outs[ls.base], n)
        key = torch.where(base, _flat(outs[ls.key], n), ls.n_keys)
        inputs = [G.AggInput(name, kind,
                             None if v is None else _flat(outs[v], n),
                             None if m is None else _flat(outs[m], n))
                  for name, kind, flt, v, m in ls.aggs]
        out = CG.dense_groupby_reference(key, ls.n_keys, inputs)
        for name, v, m in ls.thetas:
            ok = base if m is None else base & _flat(outs[m], n)
            out[name] = TH.theta_registers(key, ok, _flat(outs[v], n),
                                           ls.n_keys,
                                           empty=float(TH._SENTINEL))
        res.append(out)
    return res


# =============================================================================
# the kernel
# =============================================================================

def fast_code(op: int, dt: int, src: int) -> int:
    """The kernel's specialised handler for one instruction (an index of
    :data:`FAST`; 0 = its generic path). A handler computes exactly what the
    generic path computes for its (op, dtype): comparisons and bitwise ops
    of any integer dtype act on the sign-extended 64-bit values, int32
    arithmetic wraps to int32, float32 arithmetic is one rounded op."""
    name, t = OPS[op], DTYPES[dt]
    key = None
    if name == "const" and not t.is_floating_point:
        key = "const_int"
    elif name == "load":
        key = _LOAD_FAST.get(t)
    elif name in ("add", "sub", "mul", "floordiv") and t == torch.int32:
        key = f"{name}_i32"
    elif name in _CMP and t in _INT_DTYPES:
        key = f"{name}_int"
    elif name in _CMP + ("add", "sub", "mul", "div") and t == torch.float32:
        key = f"{name}_f32"
    elif name in ("and", "or", "xor") and t in _INT_DTYPES:
        key = f"{name}_int"
    elif name == "not" and t == torch.bool:
        key = "not_bool"
    elif name == "where":
        key = "where"
    elif name == "cast" and DTYPES[src] in _INT_DTYPES:
        key = {torch.int32: "cast_i32", torch.float32: "cast_f32"}.get(t)
    return FAST.index(key) if key else 0


def _pad8(b: bytes) -> bytes:
    return b + bytes(-len(b) % 8)


def _n_descs(layout: WaveLayout) -> int:
    """Aggregate descriptors of the blob: every lane's dense aggregates,
    then its in-kernel thetas."""
    return sum(ls.n_aggs + len(ls.thetas) for ls in layout.lanes)


def blob_bytes(program: LaneProgram, layout: WaveLayout) -> bytes:
    """The kernel's program blob: instructions, lane and aggregate
    descriptors and slot kinds, each section padded to 8 bytes. A lane's
    theta descriptors follow its dense ones (``LaneDesc.n_theta`` of
    them): kind min over float64 slots, the hashed values' register and
    dtype, the mask."""
    ins = np.zeros(len(program.instrs), INSTR)
    for i, (op, dt, src, dst, a, b, c, imm) in enumerate(program.instrs):
        ins[i] = (op, dt, src, dst, a, b, c, fast_code(op, dt, src), imm)
    lanes = np.zeros(len(layout.lanes), LANE)
    aggs = np.zeros(_n_descs(layout), AGG)
    kinds = np.zeros(layout.n_slots, np.uint8)
    reg = program.outputs
    j = 0
    for li, ls in enumerate(layout.lanes):
        lanes[li] = (reg[ls.base], reg[ls.key], ls.n_keys, ls.n_aggs, j,
                     ls.slot_off, len(ls.thetas), 0)
        for m, (name, kind, flt, v, mk) in enumerate(ls.aggs):
            code = CG._KIND_CODE[kind]
            aggs[j] = (code, int(flt), NONE if v is None else reg[v],
                       0 if v is None else DT[program.output_dtypes[v]],
                       NONE if mk is None else reg[mk], (0, 0, 0))
            j += 1
            for k in range(ls.n_keys):
                kinds[ls.slot_off + k * ls.n_aggs + m] = code | int(flt) << 2
        theta_code = CG._KIND_CODE["min"] | 1 << 2
        for name, v, mk in ls.thetas:
            aggs[j] = (CG._KIND_CODE["min"], 1, reg[v],
                       DT[program.output_dtypes[v]],
                       NONE if mk is None else reg[mk], (0, 0, 0))
            j += 1
        kinds[ls.theta_off: ls.slot_off + ls.n_slots] = theta_code
    return b"".join(_pad8(x.tobytes()) for x in (ins, lanes, aggs, kinds))


def _blob_len(n_instr: int, n_lanes: int, n_aggs: int, n_slots: int) -> int:
    pad = lambda b: -(-b // 8) * 8
    return pad(INSTR.itemsize * n_instr) + pad(LANE.itemsize * n_lanes) \
        + pad(AGG.itemsize * n_aggs) + pad(n_slots)


def register_width(program: LaneProgram) -> int:
    """Bytes per register word: 4 when no instruction computes in a 64-bit
    dtype (every register then holds 32 bits or fewer, and the kernel keeps
    them in 4-byte words), else 8."""
    wide = (DT[torch.int64], DT[torch.float64])
    return 8 if any(ins[1] in wide for ins in program.instrs) else 4


def _smem(n_instr: int, n_lanes: int, n_aggs: int, n_slots: int,
          n_regs: int, rows: int, width: int, shared: bool) -> int:
    """Dynamic shared memory of the kernel's first pass (mirrors
    ``sdot_wave_smem_bytes``): the per-warp partials, the program blob and,
    in shared memory, the register file (``n_regs`` x ``rows`` x
    :data:`THREADS` words of ``width`` bytes)."""
    return 8 * WARPS * n_slots \
        + (n_regs * rows * THREADS * width if shared else 0) \
        + _blob_len(n_instr, n_lanes, n_aggs, n_slots)


def smem_bytes(program: LaneProgram, layout: WaveLayout, file) -> int:
    """Shared memory of one launch with register-file layout ``file``
    (an entry of :data:`FILE_LAYOUTS`)."""
    rows, shared = file
    return _smem(len(program.instrs), len(layout.lanes), _n_descs(layout),
                 layout.n_slots, program.n_regs, rows,
                 register_width(program), shared)


def register_file(program: LaneProgram, layout: WaveLayout,
                  limit: int = SMEM_LIMIT) -> Optional[tuple]:
    """The kernel's register-file layout for this wave: the first of
    :data:`FILE_LAYOUTS` whose shared memory fits ``limit`` (two rows from
    shared memory, else one row from local memory); None when not even the
    partials and the program fit."""
    for file in FILE_LAYOUTS:
        if smem_bytes(program, layout, file) <= limit:
            return file
    return None


def library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, info = CB.build(SOURCE, ["-fmad=false"])
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sdot_wave.argtypes = [vp, i, i, i, i, i, i, i, i,
                                  ctypes.POINTER(ctypes.c_ulonglong), i, ll,
                                  ll, i, vp, vp, vp]
        lib.sdot_wave.restype = i
        lib.sdot_wave_smem_bytes.argtypes = [i, i, i, i, i, i, i, i]
        lib.sdot_wave_smem_bytes.restype = ll
        lib.sdot_wave_blob_bytes.argtypes = [i, i, i, i]
        lib.sdot_wave_blob_bytes.restype = ll
        for fn, want in (("sdot_wave_max_instrs", MAX_INSTRS),
                         ("sdot_wave_max_regs", MAX_REGS),
                         ("sdot_wave_max_cols", MAX_COLS),
                         ("sdot_wave_fast_handlers", len(FAST)),
                         ("sdot_wave_record_bytes",
                          INSTR.itemsize * 10000 + LANE.itemsize * 100
                          + AGG.itemsize)):
            getattr(lib, fn).restype = i
            if getattr(lib, fn)() != want:
                raise RuntimeError(f"csrc/wave.cu disagrees with "
                                   f"ops/cuda_wave.py on {fn}")
        if any(lib.sdot_wave_smem_bytes(3, 2, 5, 17, 7, 2, 4, shared)
               != _smem(3, 2, 5, 17, 7, 2, 4, bool(shared))
               for shared in (0, 1)):
            raise RuntimeError("csrc/wave.cu disagrees with "
                               "ops/cuda_wave.py on shared memory")
        build_info.update(info)
        _lib = lib
        return lib


def _check(program: LaneProgram, columns: Sequence[torch.Tensor]) -> None:
    if len(columns) != len(program.columns):
        raise ValueError(f"wave: {len(columns)} columns for a program "
                         f"that reads {len(program.columns)}")
    dev, n = columns[0].device, columns[0].numel()
    for name, want, t in zip(program.columns, program.column_dtypes,
                             columns):
        if t.device != dev or t.dtype != want or t.numel() != n \
                or not t.is_contiguous():
            raise ValueError(
                f"wave: column {name} must be a contiguous {want} tensor of "
                f"{n} rows on {dev}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")


def _split(layout: WaveLayout, words: torch.Tensor
           ) -> List[Dict[str, torch.Tensor]]:
    """The kernel's output words -> one dict per lane. A stripe slot that
    no row reached holds the fold's +inf identity and reads as 2.0, the
    TPU stripe's initial value (every hash is at most 1 + 1e-7)."""
    res = []
    for ls in layout.lanes:
        block = words[ls.slot_off: ls.theta_off].view(ls.n_keys, ls.n_aggs)
        as_f64 = block.view(torch.float64)
        out = {name: (as_f64 if flt else block)[:, m]
               for m, (name, kind, flt, v, mk) in enumerate(ls.aggs)}
        stripe = ls.n_keys * TH.K_LANES
        for t, (name, v, mk) in enumerate(ls.thetas):
            lo = ls.theta_off + t * stripe
            out[name] = words[lo: lo + stripe].view(torch.float64) \
                .clamp(max=float(TH._SENTINEL)).to(torch.float32) \
                .view(ls.n_keys, TH.K_LANES)
        res.append(out)
    return res


def wave_groupby(program: LaneProgram, layout: WaveLayout,
                 columns: Sequence[torch.Tensor], file: Optional[tuple] = None
                 ) -> List[Dict[str, torch.Tensor]]:
    """Run one wave: ``columns`` are the program's columns, flat or
    ``[S, R]``. CPU tensors take :func:`wave_reference`; CUDA tensors
    launch the kernel once or raise — there is no fallback. ``file`` is the
    register-file layout (default the one the layout was built with)."""
    global launches
    if not columns or columns[0].device.type != "cuda":
        return wave_reference(program, columns, layout)
    columns = [c.reshape(-1) for c in columns]
    _check(program, columns)
    if file is None:
        file = layout.file
    if file not in FILE_LAYOUTS \
            or smem_bytes(program, layout, file) > SMEM_LIMIT:
        raise ValueError(f"wave: register file {file} is not one of the "
                         f"kernel's layouts within its shared memory")
    rows, shared = file
    lib = library()
    dev = columns[0].device
    blob = program._blobs.get(dev)
    if blob is None:
        raw = blob_bytes(program, layout)
        blob = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)
        program._blobs[dev] = blob
    n = columns[0].numel()
    rows_per_block, n_blocks = CG.launch_geometry(n)
    scratch = torch.empty(layout.n_slots * n_blocks, dtype=torch.int64,
                          device=dev)
    out = torch.empty(layout.n_slots, dtype=torch.int64, device=dev)
    ptrs = (ctypes.c_ulonglong * max(1, len(columns)))(
        *[c.data_ptr() for c in columns])
    n_aggs = _n_descs(layout)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sdot_wave(blob.data_ptr(), len(program.instrs),
                            len(layout.lanes), n_aggs, layout.n_slots,
                            program.n_regs, rows, register_width(program),
                            int(shared), ptrs, len(columns), n,
                            rows_per_block, n_blocks,
                            scratch.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"wave kernel launch failed: CUDA error {err}")
    launches += 1
    return _split(layout, out)


# =============================================================================
# program build
# =============================================================================

def build_wave_fn(ds, lanes, min_day: int, max_day: int, fplan, *,
                  union_names, tz: str, n_rows: int, max_lanes: int,
                  scratch_bytes: int = SMEM_LIMIT, log2m: int = 11,
                  kll_lanes: int = 256):
    """Lower a fused group to the wave kernel.

    Returns ``(wave_fn, info)``: ``wave_fn(arrays)`` maps the wave's bind
    (union name -> ``[S, R]`` tensor) to one route-conformant output dict
    per lane, exactly what the lane-by-lane program's ``dense_groupby``
    calls and sketch stage give, so ``_finals_from_out`` and the decode
    downstream are untouched: one launch, then the epilogue's sketches
    (HLL, KLL, theta past the in-kernel cap) through ``ops/sketch.py``
    over a ``ScanContext`` and ``CSECache`` of the same bind. ``info``
    carries the launch accounting (blocks for the wave's ``n_rows``,
    scratch slots, program length, registers, shared memory,
    register-file layout, ``theta_inkernel`` and ``sketch_epilogue``
    counts). Raises :class:`WaveFallback` when the group cannot lower.
    """
    if max_lanes <= 0 or len(lanes) > max_lanes:
        raise WaveFallback(f"{len(lanes)} lanes exceed "
                           f"sdot.pallas.wave.max.lanes={max_lanes}")
    program, layout = compile_wave(ds, lanes, min_day, max_day, fplan,
                                   union_names=union_names, tz=tz)
    limit = min(int(scratch_bytes), SMEM_LIMIT)
    file = layout.file = register_file(program, layout, limit)
    if file is None:
        raise WaveFallback(f"wave scratch of {layout.n_slots} slots needs "
                           f"{smem_bytes(program, layout, FILE_LAYOUTS[-1])}"
                           f" B of shared memory, over "
                           f"sdot.cuda.wave.scratch.bytes ({limit} B)")
    smem = smem_bytes(program, layout, file)
    inkernel = [set(theta_inkernel(lp)) for lp in lanes]
    epilogue = [[p for p in lp.agg_plans
                 if p.kind in SKETCH_KINDS and p.spec.name not in ink]
                for lp, ink in zip(lanes, inkernel)]

    def wave_fn(arrays):
        res = wave_groupby(program, layout,
                           [arrays[k] for k in program.columns])
        if any(epilogue):
            ctx = ScanContext(ds, arrays, min_day, max_day, tz=tz)
            cse = FU.CSECache(ctx)
            if fplan is not None:
                cse.prelower(fplan)
            for lp, eps, out in zip(lanes, epilogue, res):
                if not eps:
                    continue
                base, key, _, _ = _lane_parts(lp, ctx, cse, dense=False)
                for p in eps:
                    out[p.spec.name] = sketch_registers(
                        p, ctx, cse, base, key, lp.n_keys, log2m=log2m,
                        kll_lanes=kll_lanes)
        return res

    rows_per_block, blocks = CG.launch_geometry(n_rows)
    info = {"blocks": blocks, "rows_per_block": rows_per_block,
            "scratch_slots": layout.n_slots,
            "program_length": len(program.instrs),
            "registers": program.n_regs, "columns": len(program.columns),
            "register_bytes": register_width(program),
            "rows_per_thread": file[0], "register_file_shared": file[1],
            "smem_bytes": smem,
            "lanes": len(lanes),
            "theta_inkernel": sum(len(ink) for ink in inkernel),
            "sketch_epilogue": sum(len(eps) for eps in epilogue)}
    return wave_fn, info
