"""HyperLogLog approximate count-distinct, grouped, on the device.

Port of ``spark_druid_olap_tpu/ops/hll.py``:

- hash: the murmur3 finalizer over int32 dictionary codes / values;
- register index = the low ``p`` bits, rho = the leading-zero count of the
  remaining bits + 1;
- grouped register maxima through one scatter with ``amax`` over the fused
  ``group_key * m + register`` space — ``[K, m]`` registers in one pass;
- the host-side harmonic-mean estimate with the standard small / large
  range corrections (Druid's default 2^11 registers), copied verbatim.

Registers equal the JAX package's bit for bit (``cluster/merge.py`` merges
raw registers). PyTorch's ``uint32`` arithmetic is barely there on CUDA, so
the hash runs on int64 tensors that hold the uint32 value in their low 32
bits: every product splits its constant into 16-bit halves and stays below
2^63 (:func:`mul_u32`). ``lax.clz`` becomes ``frexp``'s exponent, exact for
``0 < w < 2^32``.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(uint32)`` of an integer tensor (its low 32 bits, so a
    negative int32 or any int64 wraps as there), held in int64."""
    return x.to(torch.int64) & M32


def mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for ``x`` from :func:`u32` and a constant ``c <
    2^32``: the low half's product is below 2^48, and only the low 16 bits
    of the high half's product reach the result."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _murmur_fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer — avalanches int32 values (uint32 wraparound);
    ``x`` is an integer tensor, the result int64 in [0, 2^32)."""
    x = u32(x)
    x = x ^ (x >> 16)
    x = mul_u32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul_u32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def hll_registers(key, mask, values, n_keys: int, log2m: int = 11):
    """Per-group HLL register maxima.

    key: int32 dense group key; mask: bool, rows that count; values:
    integer (dictionary codes or integer-viewed values), all of one shape.
    Returns int32 ``[n_keys, m]`` (rho values, 0 = empty). Masked rows go
    to the dropped key ``n_keys``, and every register starts at 0, which
    is JAX's ``segment_max`` + ``maximum(·, 0)``.
    """
    m = 1 << log2m
    h = _murmur_fmix32(values.reshape(-1))
    reg = h & (m - 1)
    w = h >> log2m                       # (32 - p) significant bits
    # rho = position of the first 1-bit of w within (32 - p) bits, 1-based;
    # w == 0 -> (32 - p) + 1. For 0 < w < 2^32, clz(w) = 32 - frexp's
    # exponent (w = f * 2^e, 0.5 <= f < 1)
    clz = 32 - torch.frexp(w.to(torch.float64)).exponent.to(torch.int64)
    rho = torch.where(w == 0, 32 - log2m + 1, clz - log2m + 1)
    k_eff = torch.where(mask.reshape(-1), key.reshape(-1).to(torch.int64),
                        n_keys)
    regs = torch.zeros((n_keys + 1) * m, dtype=torch.int32,
                       device=h.device)
    regs.scatter_reduce_(0, k_eff * m + reg, rho.to(torch.int32), "amax")
    return regs[: n_keys * m].reshape(n_keys, m)


def estimate(regs: np.ndarray) -> np.ndarray:
    """Host-side HLL estimate per group from [K, m] registers."""
    regs = np.asarray(regs)
    k, m = regs.shape
    if m >= 128:
        alpha = 0.7213 / (1 + 1.079 / m)
    elif m == 64:
        alpha = 0.709
    elif m == 32:
        alpha = 0.697
    else:
        alpha = 0.673
    z = np.sum(np.power(2.0, -regs.astype(np.float64)), axis=1)
    e = alpha * m * m / z
    zeros = np.sum(regs == 0, axis=1)
    small = (e <= 2.5 * m) & (zeros > 0)
    with np.errstate(divide="ignore"):
        lin = m * np.log(m / np.maximum(zeros, 1).astype(np.float64))
    e = np.where(small, lin, e)
    big = e > (1 << 32) / 30.0
    e = np.where(big, -(1 << 32) * np.log1p(-e / (1 << 32)), e)
    return e
