"""Fused small-K dense group-by: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``spark_druid_olap_tpu/ops/pallas_groupby.py``, whose Pallas TPU
kernel (``_make_kernel``, launched by ``pallas_dense_groupby``) becomes the
hand-written Hopper kernel in ``csrc/dense_groupby.cu``. The TPU kernel
kept per-lane f32 Neumaier pairs and needed exactness gates
(``maxabs * block_rows < 2^24``); Hopper has native int64 and float64, so
the kernel emits the x64 routes directly: counts and integer sums in
int64, float sums in float64, min / max in the value's own 64-bit type
with ``INT64_MAX`` / ``INT64_MIN`` / +-inf empty-group sentinels. No gate
remains.

:func:`dense_groupby_kernel` launches the kernel for CUDA tensors, once per
group of at most :data:`MAX_AGGS` aggregates, and raises on anything the
kernel does not take; for CPU tensors it computes the same function with
:func:`dense_groupby_reference`, the plain version that the tests and
``chip_smoke.py`` hold the kernel against (the engine's scatter tier for
more keys than the kernel takes is ``ops/groupby.scatter_groupby``). The
kernel is built with ``nvcc`` at first use into
``build/torch_ext/`` and bound with ``ctypes`` (``ops/cuda_build.py``: no
PyTorch headers, so the build takes seconds); its fold is
``csrc/groupby_fold.cuh``, shared with the wave kernel. The fold has two
tiers, and :func:`fold_tier` picks one per launch on the host: the
thread-private tier while two blocks of a ``[slot][thread]`` array of the
launch's slots fit on an SM, the warp-parallel tier above that.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence

import torch

from spark_druid_olap_tpu_torch.ops import cuda_build as CB

KINDS = ("count", "sum", "min", "max")
MAX_AGGS = 16                      # kMaxAggs in the CUDA source
THREADS = 256                      # kThreads in csrc/groupby_fold.cuh
WARPS = THREADS // 32
#: fold tiers, by code (``Tier`` in csrc/groupby_fold.cuh)
TIERS = ("threads", "warps")
MAX_BLOCKS = 1024                  # fixed cap: results never depend on the card
MIN_ROWS_PER_BLOCK = 4096
SMEM_LIMIT = 227 * 1024 - 1024     # opt-in shared memory, less the static part
SM_SMEM_BYTES = 228 * 1024         # shared memory of one H100 SM
BLOCK_SMEM_RESERVED = 1024         # what the card keeps per resident block
I64_MAX = 2**63 - 1
I64_MIN = -(2**63)

SOURCE = CB.CSRC / "dense_groupby.cu"

_KIND_CODE = {"count": 0, "sum": 1, "min": 2, "max": 3}
_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
               torch.float64: 3}

#: kernel launches made by :func:`dense_groupby_kernel`: one per group of
#: at most :data:`MAX_AGGS` aggregates, each the partials kernel plus its
#: block fold
launches = 0
#: what the last build did: {"seconds": float, "log": str, "cached": bool}
build_info: Dict[str, object] = {}

_lib = None
_lib_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, info = CB.build(SOURCE)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.sdot_dense_groupby.argtypes = [
            vp, ll, i, i, ctypes.POINTER(i), ctypes.POINTER(i),
            ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.POINTER(ctypes.c_ulonglong), ll, i, i, vp, vp, vp]
        lib.sdot_dense_groupby.restype = i
        lib.sdot_dense_groupby_smem_bytes.argtypes = [i, i, i]
        lib.sdot_dense_groupby_smem_bytes.restype = ll
        lib.sdot_dense_groupby_max_aggs.restype = i
        lib.sdot_dense_groupby_threads.restype = i
        if lib.sdot_dense_groupby_max_aggs() != MAX_AGGS \
                or lib.sdot_dense_groupby_threads() != THREADS:
            raise RuntimeError("csrc/dense_groupby.cu disagrees on MAX_AGGS "
                               "or THREADS")
        for t, tier in enumerate(TIERS):
            if lib.sdot_dense_groupby_smem_bytes(7, 3, t) != \
                    smem_bytes(21, tier):
                raise RuntimeError("csrc/dense_groupby.cu disagrees on the "
                                   f"{tier} tier's shared memory")
        build_info.update(info)
        _lib = lib
        return lib


def _is_float(values) -> bool:
    return values is not None and values.dtype.is_floating_point


def dense_groupby_reference(key: torch.Tensor, n_keys: int,
                            inputs: Sequence) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the kernel (same inputs, same outputs):
    one scatter per aggregate into an overflow-slotted ``[n_keys + 1]``
    accumulator.

    ``key``: int [N], rows outside ``[0, n_keys)`` (the filtered-out
    sentinel ``n_keys``) match no group. ``inputs``: objects with ``name``,
    ``kind`` in :data:`KINDS`, ``values`` ([N] int32/int64/float32/float64,
    None for count) and ``mask`` ([N] bool/uint8 or None). Returns name ->
    [n_keys] tensor: int64 counts and integer aggregates, float64 float
    aggregates, min/max empty groups at ``INT64_MAX``/``INT64_MIN``/+-inf;
    a NaN value makes its group's float min, max and sum NaN.
    """
    key = key.reshape(-1).long()
    live = (key >= 0) & (key < n_keys)
    out = {}
    for a in inputs:
        eff = live if a.mask is None else live & (a.mask.reshape(-1) != 0)
        k = torch.where(eff, key, n_keys)
        if a.kind == "count":
            acc = torch.zeros(n_keys + 1, dtype=torch.int64,
                              device=key.device)
            acc.index_add_(0, k, eff.long())
        else:
            flt = _is_float(a.values)
            v = a.values.reshape(-1).to(torch.float64 if flt
                                        else torch.int64)
            if a.kind == "sum":
                acc = torch.zeros(n_keys + 1, dtype=v.dtype,
                                  device=key.device)
                acc.index_add_(0, k, torch.where(eff, v, 0))
            else:
                if flt:
                    sent = float("inf") if a.kind == "min" \
                        else float("-inf")
                else:
                    sent = I64_MAX if a.kind == "min" else I64_MIN
                acc = torch.full((n_keys + 1,), sent, dtype=v.dtype,
                                 device=key.device)
                acc.scatter_reduce_(0, k, torch.where(eff, v, sent),
                                    "amin" if a.kind == "min" else "amax")
        out[a.name] = acc[:n_keys]
    return out


def _check(key: torch.Tensor, n_keys: int, inputs: Sequence,
           max_keys: int) -> None:
    if key.dtype != torch.int32 or key.dim() != 1 \
            or not key.is_contiguous():
        raise ValueError("dense_groupby: key must be a contiguous 1-D int32 "
                         "tensor")
    if not 1 <= n_keys <= max_keys:
        raise ValueError(f"dense_groupby: {n_keys} keys outside [1, "
                         f"{max_keys}] (sdot.engine.groupby.pallas.max.keys)")
    if not inputs:
        raise ValueError("dense_groupby: no aggregates")
    n = key.numel()
    for a in inputs:
        if a.kind not in KINDS:
            raise ValueError(f"dense_groupby: aggregate kind {a.kind!r}")
        for what, t, ok in (("values", a.values, tuple(_DTYPE_CODE)),
                            ("mask", a.mask, (torch.bool, torch.uint8))):
            if t is None:
                if what == "values" and a.kind != "count":
                    raise ValueError(f"dense_groupby: {a.name} has no values")
                continue
            if t.device != key.device or t.dtype not in ok \
                    or t.dim() != 1 or t.numel() != n \
                    or not t.is_contiguous():
                raise ValueError(
                    f"dense_groupby: {a.name} {what} must be a contiguous "
                    f"[{n}] tensor on {key.device} with dtype in {ok}, got "
                    f"{tuple(t.shape)} {t.dtype} on {t.device}")


def smem_bytes(n_slots: int, tier: str) -> int:
    """Dynamic shared memory of the partials pass (mirrors
    ``sdot_dense_groupby_smem_bytes``): a ``[slot][thread]`` array in the
    thread-private tier, ``[warp][slot]`` in the warp-parallel tier, of
    8-byte words."""
    return 8 * n_slots * (THREADS if tier == "threads" else WARPS)


def blocks_per_sm(smem: int) -> int:
    """Blocks of :data:`THREADS` threads that one SM holds at ``smem``
    bytes of dynamic shared memory each (at most 8: 2048 threads)."""
    return max(0, min(8, SM_SMEM_BYTES // (smem + BLOCK_SMEM_RESERVED)))


def fold_tier(n_slots: int, smem_limit: int = SMEM_LIMIT) -> Optional[str]:
    """The fold tier for a launch of ``n_slots`` (key, aggregate) slots:
    ``"threads"`` while two blocks of its ``[slot][thread]`` array fit on
    an SM (each thread then folds its own rows with no warp-level step; at
    one block per SM it waits on memory too long), ``"warps"`` while one
    partial per warp fits, else None."""
    threads = smem_bytes(n_slots, "threads")
    if threads <= smem_limit and blocks_per_sm(threads) >= 2:
        return "threads"
    if smem_bytes(n_slots, "warps") <= smem_limit:
        return "warps"
    return None


def plan_launches(n_keys: int, n_aggs: int, smem_limit: int = SMEM_LIMIT):
    """``(aggregates per launch, tier of a full launch)``: as many
    aggregates as one launch takes (at most :data:`MAX_AGGS`) whose slots
    some tier holds; a last, smaller launch takes its own
    :func:`fold_tier`. Raises ``ValueError`` when not even one aggregate
    fits."""
    for per_launch in range(min(MAX_AGGS, n_aggs), 0, -1):
        tier = fold_tier(n_keys * per_launch, smem_limit)
        if tier is not None:
            return per_launch, tier
    raise ValueError(f"dense_groupby: {n_keys} keys need "
                     f"{smem_bytes(n_keys, TIERS[-1])} B of shared memory "
                     f"per aggregate (limit {smem_limit})")


def _launch(lib, key: torch.Tensor, n_keys: int, inputs: Sequence,
            rows_per_block: int, n_blocks: int, tier: str,
            scratch: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One launch of the kernel over at most :data:`MAX_AGGS` aggregates."""
    global launches
    m = len(inputs)
    out = torch.empty((n_keys, m), dtype=torch.int64, device=key.device)
    ints = ctypes.c_int * m
    ptrs = ctypes.c_ulonglong * m
    kinds = ints(*[_KIND_CODE[a.kind] for a in inputs])
    dtypes = ints(*[_DTYPE_CODE[a.values.dtype] if a.values is not None
                    else _DTYPE_CODE[torch.int64] for a in inputs])
    vals = ptrs(*[a.values.data_ptr() if a.values is not None else 0
                  for a in inputs])
    masks = ptrs(*[a.mask.data_ptr() if a.mask is not None else 0
                   for a in inputs])
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream(key.device).cuda_stream
        err = lib.sdot_dense_groupby(
            key.data_ptr(), key.numel(), n_keys, m, kinds, dtypes, vals,
            masks, rows_per_block, n_blocks, TIERS.index(tier),
            scratch.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dense_groupby kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    as_f64 = out.view(torch.float64)
    return {a.name: (as_f64 if _is_float(a.values) else out)[:, j]
            for j, a in enumerate(inputs)}


def launch_geometry(n: int):
    """(rows per block, blocks) for ``n`` rows: fixed contiguous ranges of
    whole warps, at most :data:`MAX_BLOCKS` blocks. It depends on ``n``
    alone, so a float sum's fold order never depends on the card. The wave
    kernel (``ops/cuda_wave.py``) cuts its rows the same way."""
    n_blocks = max(1, min(MAX_BLOCKS, -(-n // MIN_ROWS_PER_BLOCK)))
    per_block = -(-max(n, 1) // n_blocks)
    rows_per_block = -(-per_block // 32) * 32        # whole warps
    return rows_per_block, max(1, -(-n // rows_per_block))


def dense_groupby_kernel(key: torch.Tensor, n_keys: int, inputs: Sequence,
                         max_keys: int, tier: Optional[str] = None
                         ) -> Dict[str, torch.Tensor]:
    """Fused dense group-by over every aggregate in ``inputs``.

    Same contract as :func:`dense_groupby_reference`. A CPU ``key`` is
    computed by that plain version; a CUDA ``key`` launches the kernel or
    raises — there is no fallback. Each launch reads the key once and takes
    as many aggregates as :func:`plan_launches` gives it, at most
    :data:`MAX_AGGS`, in the tier :func:`fold_tier` picks for its slots;
    ``tier`` forces one of :data:`TIERS` on every launch instead (both give
    the same answers; ``chip_smoke.py`` holds each against the plain
    version).
    """
    if key.device.type != "cuda":
        return dense_groupby_reference(key, n_keys, inputs)
    _check(key, n_keys, inputs, max_keys)
    lib = library()
    per_launch, _ = plan_launches(n_keys, len(inputs))
    if tier is not None and (tier not in TIERS or smem_bytes(
            n_keys * per_launch, tier) > SMEM_LIMIT):
        raise ValueError(f"dense_groupby: tier {tier!r} does not hold "
                         f"{n_keys * per_launch} slots")
    rows_per_block, n_blocks = launch_geometry(key.numel())
    # one scratch for every launch: they run in order on one stream
    scratch = torch.empty(n_blocks * n_keys * per_launch, dtype=torch.int64,
                          device=key.device)
    out: Dict[str, torch.Tensor] = {}
    for lo in range(0, len(inputs), per_launch):
        group = inputs[lo:lo + per_launch]
        out.update(_launch(lib, key, n_keys, group, rows_per_block, n_blocks,
                           tier or fold_tier(n_keys * len(group)), scratch))
    return out
