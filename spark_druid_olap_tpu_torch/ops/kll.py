"""KLL-class mergeable quantile sketch, grouped, on the device.

Port of ``spark_druid_olap_tpu/ops/kll.py`` (``percentile_approx``): a
fixed-width register sketch whose merge is a pure elementwise algebra, so
any merge order replays to the same registers.

Layout (int32, width ``W = 2*L*K + L`` with L levels and K lanes):

- ``[0 : L*K]``        tiebreak hashes ``t`` (``EMPTY`` = unoccupied lane)
- ``[L*K : 2*L*K]``    sampled-value payload (float32 bits viewed int32)
- ``[2*L*K : W]``      per-level exact row counts

Update: each row hashes its CONTENT (value bits + timestamp bits) to one
lane, a capped-geometric level and a tiebreak ``t``; the lane keeps the
lexicographically smallest ``(t, v)`` pair seen, and the level counts every
routed row exactly. On the device: two scatters with ``amin`` (the second
over the rows whose ``t`` won their lane) and one integer count.

Registers equal the JAX package's bit for bit; the uint32 hash runs on
int64 tensors as in ``ops/hll.py``. ``merge``, ``identity_registers``,
``estimate``, ``to_bytes`` / ``from_bytes`` (the cluster's SDW1 register
wire) and ``rank_bound`` are copied (numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from spark_druid_olap_tpu_torch.ops.hll import mul_u32, u32

N_LEVELS = 4                    # fixed; lane count K is the size knob
K_LANES = 256                   # default lanes per level (sdot.quantile.lanes)
EMPTY = np.int32(2 ** 31 - 1)   # unoccupied-lane sentinel (= int32 max)


def width(lanes: int = K_LANES) -> int:
    """Register row width for a lane count: t block + v block + counts."""
    return 2 * N_LEVELS * lanes + N_LEVELS


def lanes_of(w: int) -> int:
    """Invert :func:`width` (levels are a module constant)."""
    return (w - N_LEVELS) // (2 * N_LEVELS)


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = mul_u32(h ^ (h >> 16), 0x85EBCA6B)
    h = mul_u32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def kll_registers(key, mask, values, times, n_keys: int,
                  lanes: int = K_LANES):
    """Per-group KLL registers: ``[n_keys, width(lanes)]`` int32.

    key: int32 dense group key; values: numeric (the quantile domain,
    canonicalized to float32 so every tier sees the same bits); times:
    integer timestamps or None — hashed with the value bits as the content
    salt. NaN values are nulls and do not contribute.
    """
    key = key.reshape(-1)
    v32 = values.reshape(-1).to(torch.float32)
    mask = mask.reshape(-1) & ~torch.isnan(v32)
    v_bits = v32.view(torch.int32)
    h = mul_u32(u32(v_bits), 0x9E3779B1)
    if times is not None:
        h = h ^ mul_u32(u32(times.reshape(-1).to(torch.int32)), 0x85EBCA6B)
    h = _mix(h)
    lane = h % lanes
    # capped-geometric level: P(>= l) = 2^-l, the top level takes the tail
    u = _mix(h ^ 0xC2B2AE35)
    level = torch.zeros_like(lane)
    for i in range(1, N_LEVELS):
        level = level + (u < (1 << (32 - i))).to(torch.int64)
    tie = torch.clamp(_mix(h ^ 0x27D4EB2F) >> 1, max=int(EMPTY) - 1) \
        .to(torch.int32)

    k_eff = torch.where(mask, key.to(torch.int64), n_keys)
    sid = (k_eff * N_LEVELS + level) * lanes + lane
    nseg = (n_keys + 1) * N_LEVELS * lanes
    empty = torch.full((), int(EMPTY), dtype=torch.int32, device=h.device)
    t_regs = torch.full((nseg,), int(EMPTY), dtype=torch.int32,
                        device=h.device)
    t_regs.scatter_reduce_(0, sid, torch.where(mask, tie, empty), "amin")
    # second pass: the value whose tiebreak won the lane (ties on t break
    # by the smaller value bits -> a deterministic total order)
    cand = torch.where(mask & (tie == t_regs[sid]), v_bits, empty)
    v_regs = torch.full((nseg,), int(EMPTY), dtype=torch.int32,
                        device=h.device)
    v_regs.scatter_reduce_(0, sid, cand, "amin")
    # rows past the mask count toward the dropped key n_keys
    c_regs = torch.zeros((n_keys + 1) * N_LEVELS, dtype=torch.int32,
                         device=h.device)
    c_regs.scatter_add_(0, k_eff * N_LEVELS + level,
                        torch.ones_like(sid, dtype=torch.int32))
    lk = N_LEVELS * lanes
    return torch.cat([
        t_regs[: n_keys * lk].reshape(n_keys, lk),
        v_regs[: n_keys * lk].reshape(n_keys, lk),
        c_regs[: n_keys * N_LEVELS].reshape(n_keys, N_LEVELS)], dim=1)


def merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host-side register fold (lex-min on (t, v), sum of counts)."""
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    w = a.shape[-1]
    lk = (w - N_LEVELS) // 2
    ta, va, ca = a[..., :lk], a[..., lk:2 * lk], a[..., 2 * lk:]
    tb, vb, cb = b[..., :lk], b[..., lk:2 * lk], b[..., 2 * lk:]
    t = np.minimum(ta, tb)
    v = np.where(ta < tb, va, np.where(tb < ta, vb, np.minimum(va, vb)))
    return np.concatenate([t, v, ca + cb], axis=-1)


def identity_registers(w: int) -> np.ndarray:
    """The merge identity: every lane empty, every count zero."""
    lk = (w - N_LEVELS) // 2
    out = np.full(w, EMPTY, dtype=np.int32)
    out[2 * lk:] = 0
    return out


def estimate(regs: np.ndarray, fraction: float) -> np.ndarray:
    """[n_keys, W] registers -> per-group quantile estimates (float64).

    Finalized ONCE (at the broker for distributed queries), so the
    clustered estimate is byte-identical to the single-engine estimate.
    Empty groups (zero rows) estimate NaN (SQL NULL).
    """
    regs = np.asarray(regs, dtype=np.int32)
    if regs.ndim == 1:
        regs = regs[None, :]
    g, w = regs.shape
    lk = (w - N_LEVELS) // 2
    lanes = lk // N_LEVELS
    t = regs[:, :lk].reshape(g, N_LEVELS, lanes)
    v_bits = regs[:, lk:2 * lk].reshape(g, N_LEVELS, lanes)
    counts = regs[:, 2 * lk:].astype(np.float64)           # [g, L]
    occ = (t != EMPTY)
    n_occ = np.maximum(occ.sum(axis=2), 1).astype(np.float64)   # [g, L]
    weights = np.where(occ, (counts / n_occ)[:, :, None], 0.0)
    vals = v_bits.view(np.float32).astype(np.float64)
    vals = np.where(occ, vals, np.inf).reshape(g, lk)
    weights = weights.reshape(g, lk)
    order = np.argsort(vals, axis=1, kind="stable")
    vals_s = np.take_along_axis(vals, order, axis=1)
    w_s = np.take_along_axis(weights, order, axis=1)
    cum = np.cumsum(w_s, axis=1)
    total = counts.sum(axis=1)                             # [g]
    target = np.asarray(fraction, dtype=np.float64) * total
    # first sampled value whose cumulative weight reaches the target rank
    idx = np.minimum((cum < target[:, None] - 1e-9).sum(axis=1),
                     max(lk - 1, 0))
    out = np.take_along_axis(vals_s, idx[:, None], axis=1)[:, 0]
    return np.where(total > 0, out, np.nan)


def to_bytes(regs: np.ndarray) -> bytes:
    """Serialize registers (little-endian int32) for the SDW1 wire."""
    return np.ascontiguousarray(
        np.asarray(regs, dtype="<i4")).tobytes()


def from_bytes(buf: bytes, w: int) -> np.ndarray:
    """Inverse of :func:`to_bytes`; reshapes to ``[-1, w]``."""
    return np.frombuffer(buf, dtype="<i4").reshape(-1, w).astype(np.int32)


def rank_bound(config) -> float:
    """The configured acceptable rank error (``sdot.quantile.rank_bound``):
    an estimate for fraction q must sit between the exact q-eps and q+eps
    quantiles of the data."""
    from spark_druid_olap_tpu_torch.utils.config import QUANTILE_RANK_BOUND
    return float(config.get(QUANTILE_RANK_BOUND))
