"""Device-side hash-join primitives (the join tier's kernel layer).

Port of ``spark_druid_olap_tpu/ops/hash_join.py``. The build side is
canonicalized and hashed on the host in numpy, as there (it is
broadcast-sized by definition, ``sdot.join.broadcast.max.bytes``); the
probe, the match expansion, the Kleene predicate lowering and the probe-key
canonicalization are torch functions on the caller's device.

Layout contract (unchanged from the JAX package):

- **Key canonicalization**: every join-key column pair maps onto the build
  side's sorted-unique value domain, so a composite key becomes one dense
  mixed-radix ``int32``. Dictionary-coded probe dims map through a
  host-built ``[cardinality]`` LUT (probe code -> build component, -1
  miss); numeric probe columns map by ``searchsorted`` against the build's
  unique values.
- **Open addressing**: the table is linear-probed with a fixed
  multiplicative hash; the host build records the exact maximum
  displacement D, so the probe is a static ``D+1``-wide gather.
- **Match expansion**: duplicate build keys group into CSR rows
  (``slot_start`` / ``slot_count`` into ``row_idx``); the probe expands
  each row to a static width C, the widest duplicate group, bounded by
  ``sdot.join.max.matches`` (a hotter build key declines to the host tier).
- **Residual predicates** lower through :func:`lower_pred`, a Kleene
  three-valued evaluator shared with the probe-side filter.

The hash is ``(key as uint32 * GOLD32 mod 2^32) >> shift`` on both sides.
PyTorch has no usable uint32 multiply on the card, so the probe computes it
in int64 with the 16-bit split multiply of ``ops/hll.py``: its slot ids
equal the host build's bit for bit. JAX's scalar literals are weakly typed
and its default float is float64; PyTorch's default float is float32, so
an integer tensor meeting a float literal is widened to float64 first
(:func:`_lit_promote`), and an integer division runs in float64.

``JoinUnsupported`` is the single decline signal: the planner catches it and
routes the statement to the next tier (host).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ops.hll import mul_u32, u32

#: Fibonacci-hash multiplier (2^32 / phi, odd); identical on the host
#: build and the device probe, both in wrapping uint32 arithmetic
GOLD32 = np.uint32(0x9E3779B1)

#: fused canonical keys must stay strictly inside int32
MAX_KEY_DOMAIN = 1 << 31

#: linear-probe displacement ceiling: past this the build doubles the
#: table instead of widening the probe
MAX_DISPLACEMENT = 64


class JoinUnsupported(Exception):
    """This statement / table shape declines the device join tier."""


# =============================================================================
# key canonicalization (host)
# =============================================================================

def _as_key_values(vals: np.ndarray) -> np.ndarray:
    """One build key column as a sortable numpy array (object arrays of
    str stay object; numerics pass through)."""
    vals = np.asarray(vals)
    if vals.dtype == object:
        return np.asarray([None if v is None else str(v) for v in vals],
                          dtype=object)
    return vals


def build_key_components(build_keys: Sequence[np.ndarray],
                         build_valid: Sequence[np.ndarray]):
    """Canonicalize the build side's key columns.

    Returns ``(uniques, comps, row_keep)``: per-column sorted unique value
    arrays (null rows dropped: inner equi-join semantics), the per-column
    component codes of the KEPT build rows, and the keep mask over the
    original build rows.
    """
    keep = np.ones(len(build_keys[0]) if build_keys else 0, dtype=bool)
    for v, ok in zip(build_keys, build_valid):
        keep &= np.asarray(ok, dtype=bool)
    uniques, comps = [], []
    for v in build_keys:
        v = _as_key_values(v)[keep]
        if v.dtype == object:
            uniq = np.unique(v.astype(str)) if len(v) else \
                np.empty(0, dtype=object)
            comp = np.searchsorted(uniq, v.astype(str)) if len(v) else \
                np.empty(0, dtype=np.int64)
        else:
            uniq = np.unique(v)
            comp = np.searchsorted(uniq, v)
        uniques.append(uniq)
        comps.append(comp.astype(np.int64))
    return uniques, comps, keep


def fuse_components(comps: Sequence[np.ndarray],
                    cards: Sequence[int]) -> np.ndarray:
    """Host mixed-radix fuse of component codes -> one int key array."""
    key = np.zeros(len(comps[0]) if comps else 0, dtype=np.int64)
    for comp, card in zip(comps, cards):
        key = key * np.int64(max(1, card)) + comp
    return key


def key_domain(cards: Sequence[int]) -> int:
    total = 1
    for c in cards:
        total *= max(1, int(c))
    return total


# =============================================================================
# open-addressing table (host build, device probe)
# =============================================================================

@dataclasses.dataclass
class HashTable:
    """Open-addressing join table over CSR duplicate groups. All arrays
    are host numpy; the executor moves them to its device once."""

    slot_key: np.ndarray     # int32 [T], -1 = empty
    slot_start: np.ndarray   # int32 [T] -> first row_idx of the group
    slot_count: np.ndarray   # int32 [T] duplicate-group size
    row_idx: np.ndarray      # int32 [n_build] build rows grouped by key
    n_slots: int             # T (power of two)
    shift: int               # 32 - log2(T): the multiplicative hash shift
    max_disp: int            # exact max linear-probe displacement D
    max_count: int           # widest duplicate group C
    n_build: int             # kept build rows

    def nbytes(self) -> int:
        return int(self.slot_key.nbytes + self.slot_start.nbytes
                   + self.slot_count.nbytes + self.row_idx.nbytes)

    def device_tree(self) -> Dict[str, np.ndarray]:
        return {"slot_key": self.slot_key, "slot_start": self.slot_start,
                "slot_count": self.slot_count, "row_idx": self.row_idx}


def _hash32(keys: np.ndarray, shift: int) -> np.ndarray:
    h = keys.astype(np.uint32) * GOLD32
    return (h >> np.uint32(shift)).astype(np.int64)


def build_table(fused_keys: np.ndarray, max_matches: int) -> HashTable:
    """Build the open-addressing table over host ``fused_keys`` (already
    canonical, null rows dropped). The exact displacement and duplicate
    bookkeeping happens here, so the device probe is fully static."""
    n = len(fused_keys)
    keys = np.asarray(fused_keys, dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    uniq, starts, counts = (np.empty(0, dtype=np.int64),) * 3
    if n:
        uniq, starts, counts = np.unique(skeys, return_index=True,
                                         return_counts=True)
    max_count = int(counts.max()) if n else 0
    if max_count > int(max_matches):
        raise JoinUnsupported(
            f"hot build key: widest duplicate group {max_count} exceeds "
            f"sdot.join.max.matches={int(max_matches)}")
    bits = max(3, int(np.ceil(np.log2(max(2 * len(uniq), 8)))))
    while True:
        T = 1 << bits
        shift = 32 - bits
        slot_key = np.full(T, -1, dtype=np.int64)
        slot_start = np.zeros(T, dtype=np.int32)
        slot_count = np.zeros(T, dtype=np.int32)
        max_disp = 0
        ok = True
        for k, st, ct in zip(uniq, starts, counts):
            s = int(_hash32(np.asarray([k]), shift)[0])
            d = 0
            while slot_key[s] != -1:
                s = (s + 1) & (T - 1)
                d += 1
            max_disp = max(max_disp, d)
            if max_disp > MAX_DISPLACEMENT and bits < 28:
                ok = False
                break
            slot_key[s] = k
            slot_start[s] = st
            slot_count[s] = ct
        if ok:
            break
        bits += 1           # too clustered: double the table, retry
    return HashTable(
        slot_key=slot_key.astype(np.int32),
        slot_start=slot_start, slot_count=slot_count,
        row_idx=order.astype(np.int32), n_slots=T, shift=shift,
        max_disp=max_disp, max_count=max_count, n_build=n)


def probe(tdev: Dict[str, torch.Tensor], key, valid, *, n_slots: int,
          shift: int, max_disp: int):
    """Canonical ``key`` [N] + ``valid`` [N] -> ``(start, count)`` int32
    [N] into the CSR ``row_idx``. A miss or an invalid (null / filtered)
    probe row gets count 0. The D+1-wide slot gather is static; the first
    hit wins (``argmax`` over the hit mask as int, the first maximal
    index, as ``jnp.argmax`` over bools)."""
    key = key.to(torch.int32)
    h = mul_u32(u32(key), int(GOLD32)) >> shift
    offs = torch.arange(max_disp + 1, dtype=torch.int64, device=key.device)
    slots = (h[..., None] + offs) & (n_slots - 1)              # [N, D+1]
    sk = tdev["slot_key"][slots]
    hit = (sk == key[..., None]) & valid[..., None]
    anyhit = hit.any(dim=-1)
    first = torch.argmax(hit.to(torch.int32), dim=-1)
    slot = torch.gather(slots, -1, first[..., None])[..., 0]
    start = tdev["slot_start"][slot]
    count = torch.where(anyhit, tdev["slot_count"][slot], 0)
    return start.to(torch.int32), count.to(torch.int32)


def expand(tdev: Dict[str, torch.Tensor], start, count, *, width: int,
           n_build: int):
    """CSR match expansion: -> ``(bidx, mvalid)`` each [N, C]. ``bidx``
    indexes build payload rows (clipped; ``mvalid`` masks the tail of
    groups narrower than C)."""
    C = max(1, int(width))
    lane = torch.arange(C, dtype=torch.int32, device=start.device)
    mvalid = lane[None, :] < count[:, None]
    pos = (start[:, None] + lane[None, :]).clamp(0, max(0, n_build - 1))
    bidx = tdev["row_idx"][pos.long()] if n_build else torch.zeros_like(pos)
    return bidx, mvalid


# =============================================================================
# expression lowering (probe filters + residual predicates)
# =============================================================================
#
# ``get`` is the environment callback: name -> (value, valid) tensors of
# one broadcastable shape. ``dim`` optionally maps a dimension name to its
# DimColumn (sorted dictionary), so string comparisons against literals
# lower to integer code compares. Predicates evaluate with Kleene
# three-valued logic as (true, unknown) mask pairs, mirroring
# utils/host_eval._pred3; the root folds UNKNOWN to drop. Literals are 0-d
# tensors on ``device``.

Env = Callable[[str], Tuple[torch.Tensor, torch.Tensor]]


def _lit_promote(a, b):
    """JAX promotes an integer array against a weakly typed float scalar
    to its default float (float64 here); PyTorch would take float32. Widen
    the integer side of such a pair to float64."""
    def widen(x, other):
        if not x.is_floating_point() and x.dtype != torch.bool \
                and other.dim() == 0 and other.is_floating_point() \
                and x.dim() > 0:
            return x.to(torch.float64)
        return x
    return widen(a, b), widen(b, a)


def _num(e: E.Expr, get: Env, dim=None, device="cpu"):
    """Numeric (value, valid) lowering. Raises JoinUnsupported on any node
    outside the supported surface, including dimension columns, whose
    device form is dictionary codes (:func:`_dim_cmp` handles those)."""
    if isinstance(e, E.Column):
        if dim is not None and dim(e.name) is not None:
            raise JoinUnsupported(
                f"dimension column {e.name!r} in a numeric join "
                f"expression (codes are not values)")
        return get(e.name)
    if isinstance(e, E.Literal):
        if e.value is None:
            return (torch.tensor(0.0, dtype=torch.float32, device=device),
                    torch.zeros((), dtype=torch.bool, device=device))
        if isinstance(e.value, (int, float, np.integer, np.floating)) \
                and not isinstance(e.value, bool):
            return (torch.tensor(e.value, device=device,
                                 dtype=torch.float64 if isinstance(
                                     e.value, (float, np.floating))
                                 else torch.int64),
                    torch.ones((), dtype=torch.bool, device=device))
        raise JoinUnsupported(f"non-numeric literal {e.value!r} in a "
                              f"device join expression")
    if isinstance(e, E.BinaryOp):
        a, va = _num(e.left, get, dim, device)
        b, vb = _num(e.right, get, dim, device)
        v = va & vb
        a, b = _lit_promote(a, b)
        if e.op == "+":
            return a + b, v
        if e.op == "-":
            return a - b, v
        if e.op == "*":
            return a * b, v
        if e.op == "/":
            # SQL x/0 -> NULL here (the residual only needs the row
            # dropped, which invalid achieves)
            if not a.is_floating_point() and not b.is_floating_point():
                a = a.to(torch.float64)
            z = b == 0
            return a / torch.where(z, torch.ones_like(b), b), v & ~z
        raise JoinUnsupported(f"operator {e.op!r} in a device join "
                              f"expression")
    if isinstance(e, E.Cast) and e.to in ("long", "double"):
        v, ok = _num(e.child, get, dim, device)
        return v.to(torch.int64 if e.to == "long" else torch.float64), ok
    raise JoinUnsupported(f"unsupported expression node "
                          f"{type(e).__name__} in a device join")


def _dim_cmp(e: E.Comparison, get: Env, dim):
    """Comparison(dim column, string literal) -> (t, u) via code compares
    on the sorted dictionary (code_of / searchsorted bounds)."""
    col, lit, op = e.left, e.right, e.op
    if isinstance(col, E.Literal):
        col, lit = lit, col
        op = E.FLIP_CMP.get(op, op)
    d = dim(col.name)
    code, valid = get(col.name)
    val = str(lit.value)
    if op in ("=", "!=", "<>"):
        c = d.code_of(val)
        t = (code == c) if c >= 0 else torch.zeros(
            code.shape, dtype=torch.bool, device=code.device)
        t = valid & t if op == "=" else valid & ~t
        return t, ~valid
    if op in ("<", "<="):
        hi = int(np.searchsorted(d.dictionary, val,
                                 side="right" if op == "<=" else "left"))
        return valid & (code < hi), ~valid
    if op in (">", ">="):
        lo = int(np.searchsorted(d.dictionary, val,
                                 side="left" if op == ">=" else "right"))
        return valid & (code >= lo), ~valid
    raise JoinUnsupported(f"operator {op!r} on a dimension column")


def _is_dim(e: E.Expr, dim) -> bool:
    return isinstance(e, E.Column) and dim is not None \
        and dim(e.name) is not None


def _cmp(op: str, a, b):
    a, b = _lit_promote(a, b)
    if op == "=":
        return a == b
    if op in ("!=", "<>"):
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    raise JoinUnsupported(f"comparison {op!r}")


def lower_pred(e: E.Expr, get: Env, dim=None, device="cpu"):
    """Kleene (true, unknown) lowering of a predicate tree."""
    AND, OR, NOT = torch.logical_and, torch.logical_or, torch.logical_not
    if isinstance(e, E.And):
        ts, us = zip(*(lower_pred(p, get, dim, device) for p in e.parts))
        t = ts[0]
        for x in ts[1:]:
            t = AND(t, x)
        nf = ts[0] | us[0]
        anyu = us[0]
        for x, u in zip(ts[1:], us[1:]):
            nf = AND(nf, x | u)
            anyu = OR(anyu, u)
        return t, AND(nf, anyu) & NOT(t)
    if isinstance(e, E.Or):
        ts, us = zip(*(lower_pred(p, get, dim, device) for p in e.parts))
        t = ts[0]
        anyu = us[0]
        for x, u in zip(ts[1:], us[1:]):
            t = OR(t, x)
            anyu = OR(anyu, u)
        return t, AND(NOT(t), anyu)
    if isinstance(e, E.Not):
        t, u = lower_pred(e.child, get, dim, device)
        return AND(NOT(t), NOT(u)), u
    if isinstance(e, E.IsNull):
        _, valid = (get(e.child.name) if isinstance(e.child, E.Column)
                    else _num(e.child, get, dim, device))
        t = ~valid if not e.negated else valid
        return t, torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    if isinstance(e, E.Between):
        lo = E.Comparison(">=", e.child, e.low)
        hi = E.Comparison("<=", e.child, e.high)
        t, u = lower_pred(E.And((lo, hi)), get, dim, device)
        if e.negated:
            return AND(NOT(t), NOT(u)), u
        return t, u
    if isinstance(e, E.InList):
        parts = tuple(E.Comparison("=", e.child, E.Literal(v))
                      for v in e.values)
        if parts:
            t, u = lower_pred(E.Or(parts), get, dim, device)
        else:
            t = u = torch.zeros((), dtype=torch.bool, device=device)
        if e.negated:
            return AND(NOT(t), NOT(u)), u
        return t, u
    if isinstance(e, E.Comparison):
        if dim is not None and (
                (_is_dim(e.left, dim) and isinstance(e.right, E.Literal)
                 and isinstance(e.right.value, str))
                or (_is_dim(e.right, dim)
                    and isinstance(e.left, E.Literal)
                    and isinstance(e.left.value, str))):
            return _dim_cmp(e, get, dim)
        a, va = _num(e.left, get, dim, device)
        b, vb = _num(e.right, get, dim, device)
        v = va & vb
        return AND(_cmp(e.op, a, b), v), NOT(v)
    raise JoinUnsupported(f"unsupported predicate node "
                          f"{type(e).__name__} in a device join")


def pred_mask(e: Optional[E.Expr], get: Env, dim=None, device="cpu"):
    """Root predicate -> keep mask (UNKNOWN drops, SQL WHERE)."""
    if e is None:
        return None
    t, u = lower_pred(e, get, dim, device)
    return torch.logical_and(t, torch.logical_not(u))


# =============================================================================
# probe-key canonicalization plans
# =============================================================================

@dataclasses.dataclass
class KeyMap:
    """How ONE probe key column maps onto its build component domain.

    - ``lut`` (dictionary-coded probe dims): host ``[cardinality]`` int32,
      probe code -> build component or -1; a device gather.
    - ``uniq`` (numeric probe columns): the build side's sorted unique
      values; a device searchsorted + equality check.
    """

    card: int
    lut: Optional[np.ndarray] = None
    uniq: Optional[np.ndarray] = None

    def device_tree(self):
        out = {}
        if self.lut is not None:
            out["lut"] = self.lut
        if self.uniq is not None:
            out["uniq"] = self.uniq
        return out


def dim_keymap(dictionary: np.ndarray, uniq: np.ndarray) -> KeyMap:
    """LUT for a dictionary-coded probe dim: dictionary value -> position
    in the build's unique set (-1 when absent)."""
    if len(dictionary) == 0 or len(uniq) == 0:
        return KeyMap(card=len(uniq),
                      lut=np.full(max(1, len(dictionary)), -1,
                                  dtype=np.int32))
    pos = np.searchsorted(uniq, dictionary.astype(str))
    pos_c = np.clip(pos, 0, len(uniq) - 1)
    hit = uniq[pos_c].astype(str) == dictionary.astype(str)
    lut = np.where(hit, pos_c, -1).astype(np.int32)
    return KeyMap(card=len(uniq), lut=lut)


def numeric_keymap(uniq: np.ndarray, probe_dtype) -> KeyMap:
    """searchsorted map for a numeric probe column. The uniques are cast
    to the probe array's stored dtype: both sides come from the same
    stored precision, so the cast keeps their values."""
    return KeyMap(card=len(uniq),
                  uniq=np.asarray(uniq).astype(probe_dtype))


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float64 if t.is_floating_point() else torch.int64)


def canonical_key(keymaps: Sequence[KeyMap], kdevs: Sequence[Dict],
                  probe_vals: Sequence[torch.Tensor],
                  probe_valid: Sequence[torch.Tensor]):
    """Composite-key canonicalization: per-column component codes (LUT
    gather or searchsorted), mixed-radix fuse. Returns ``(key int32, valid
    bool)`` in the probe tensors' shape. The searchsorted runs over both
    sides widened to int64 / float64, which keeps every stored value."""
    comps, valid = [], None
    for km, kd, v, ok in zip(keymaps, kdevs, probe_vals, probe_valid):
        if km.lut is not None:
            comp = kd["lut"][v.long()]
        elif len(km.uniq) == 0:
            comp = torch.full(v.shape, -1, dtype=torch.int32,
                              device=v.device)
        else:
            uniq, wv = _wide(kd["uniq"]), _wide(v)
            idx = torch.searchsorted(uniq, wv.contiguous())
            idx_c = idx.clamp(0, len(km.uniq) - 1)
            comp = torch.where(uniq[idx_c] == wv, idx_c, -1) \
                .to(torch.int32)
        ok = torch.logical_and(ok, comp >= 0)
        valid = ok if valid is None else torch.logical_and(valid, ok)
        comps.append(comp)
    key = comps[0].to(torch.int32)
    for comp, km in zip(comps[1:], keymaps[1:]):
        key = key * max(1, km.card) + comp
    return torch.where(valid, key, 0), valid
