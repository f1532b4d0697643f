"""Theta-sketch-class approximate distinct counting: a k-mins sketch.

Port of ``spark_druid_olap_tpu/ops/theta.py``. Per group, the sketch keeps
the MINIMUM of k independent uniform hashes of the value ("k-mins"), the
update / merge algebra of Druid's KMV theta sketch:

- update   = per-lane scatter with ``amin`` into a dense ``[n_keys, k]``
  float32 table
- merge    = elementwise min
- estimate = ``n_hat = k / sum(min_j) - 1`` (an empty group, every lane at
  the 1.0 clip, estimates 0 exactly)

Relative error ~ 1/sqrt(k) (k = 64 -> ~12.5%). Registers equal the JAX
package's bit for bit: the uint32 hash runs on int64 tensors as in
``ops/hll.py``, and its float part is one float32 multiply by 2^-24 (exact)
and one float32 add. The wave kernel hashes with the same function,
``csrc/sketch_hash.cuh``.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_druid_olap_tpu_torch.ops.groupby import _fold
from spark_druid_olap_tpu_torch.ops.hll import mul_u32, u32

K_LANES = 64
_SENTINEL = np.float32(2.0)     # > any hash; the wave stripe's empty value
_ROWS_X_LANES = 1 << 25         # elements of one lane chunk's intermediates


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = mul_u32(h ^ (h >> 16), 0x85EBCA6B)
    h = mul_u32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def _seed_const(seed):
    return (0x85EBCA6B * (2 * seed + 1)) & 0xFFFFFFFF


def _f32(x: float, device) -> torch.Tensor:
    """A 0-d float32 operand (a float32 op then rounds in float32)."""
    return torch.full((), float(np.float32(x)), dtype=torch.float32,
                      device=device)


def _to_unit(h: torch.Tensor) -> torch.Tensor:
    """uint32 hash -> (0, 1] float32: ``float(h >> 8) * 2^-24 + 1e-7``,
    each step in float32."""
    f = (h >> 8).to(torch.float32) * _f32(1.0 / (1 << 24), h.device)
    return f + _f32(1e-7, h.device)


def _hash01(v: torch.Tensor, seed: int) -> torch.Tensor:
    """Integer value -> uniform (0, 1] float32, per-lane independent."""
    return _to_unit(_mix(mul_u32(u32(v), 0x9E3779B1) ^ _seed_const(seed)))


def _bits(v: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits as int32 (what the engine hashes for a
    DOUBLE column); any other tensor as it is."""
    return v.view(torch.int32) if v.dtype == torch.float32 else v


def theta_registers(key, mask, values, n_keys: int, k: int = K_LANES,
                    empty: float = float("inf")):
    """Per-group k-mins registers: ``[n_keys, k]`` float32 lane minima.

    Masked rows go to the dropped key ``n_keys``. A group no row reaches
    keeps ``empty``: JAX's ``segment_min`` leaves +inf there; the wave
    kernel's in-kernel stripe starts at 2.0 (``_SENTINEL``). Float32
    values hash by their bits (the engine passes a DOUBLE column already
    viewed as int32; the wave kernel passes it raw).
    """
    v = _bits(values.reshape(-1))
    k_eff = torch.where(mask.reshape(-1), key.reshape(-1).to(torch.int64),
                        n_keys)
    h0 = mul_u32(u32(v), 0x9E3779B1)
    # every hash and both empty values are positive floats, whose int32
    # bit patterns order as the floats do: the minimum runs on the bits
    # (an integer atomic min on the card, no compare-and-swap loop)
    regs = torch.full(((n_keys + 1) * k,), empty, dtype=torch.float32,
                      device=v.device).view(torch.int32)
    n = max(int(v.numel()), 1)
    chunk = max(1, min(k, _ROWS_X_LANES // n))
    for j0 in range(0, k, chunk):
        js = torch.arange(j0, min(k, j0 + chunk), device=v.device)
        seeds = (0x85EBCA6B * (2 * js + 1)) & 0xFFFFFFFF
        hv = _to_unit(_mix(h0[:, None] ^ seeds[None, :]))
        idx = k_eff[:, None] * k + js[None, :]
        regs.scatter_reduce_(0, idx.reshape(-1),
                             hv.view(torch.int32).reshape(-1), "amin")
    return regs[: n_keys * k].view(torch.float32).reshape(n_keys, k)


def merge_registers(parts):
    """Merge of per-slot ``[K, k]`` lane minima (the JAX package's
    ``merge_registers``, a ``pmin`` over the mesh): the elementwise
    minimum, folded in slot order. A lane no row reached keeps its empty
    value (+inf from :func:`theta_registers`, 2.0 from the wave kernel's
    stripe); both estimate as 1.0 after the clip."""
    return _fold(parts, torch.minimum)


def estimate(regs: np.ndarray) -> np.ndarray:
    """[n_keys, k] lane minima -> per-group distinct estimates."""
    r = np.minimum(np.asarray(regs, np.float64), 1.0)
    k = r.shape[1]
    s = r.sum(axis=1)
    return np.maximum(k / np.maximum(s, 1e-12) - 1.0, 0.0)
