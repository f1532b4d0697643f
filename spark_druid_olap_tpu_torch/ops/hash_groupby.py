"""Hashed high-cardinality group-by: sort-assigned dense group ids in a
fixed-size table.

Port of ``spark_druid_olap_tpu/ops/hash_groupby.py``. When the fused key
space is above the dense ceiling (``sdot.engine.groupby.dense.max.keys``)
the engine stops materializing the key space and aggregates into a table
of ``T`` slots sized by the number of groups the scan can hold.

- **One sort, no probe loop.** The two int32 key parts pack into one int64
  (``khi << 31 | klo``: both parts are below 2^31, so the packed order is
  the pair's lexicographic order, and the EMPTY pair packs to the
  largest value). ``torch.sort(stable=True)`` of that key orders equal
  keys by row index, which is the order of the JAX package's
  ``lax.sort`` over ``(khi, klo, row index)``; run starts become dense
  group ids by a cumulative sum. Slot ids therefore depend on key order
  only, and the key tables equal the JAX package's bit for bit.
- **Occupied slots are the prefix** ``[0, G)`` of the table, in ascending
  key order; EMPTY pads the rest.
- **Overflow** is a count the host reads (``n_unresolved``): valid rows
  whose group id is ``>= T``. The host retries with a larger table.
- **Live rows only.** The engine drops the rows its filter rejects once
  (:func:`live_rows`) before the slot sort, so neither the sort nor the
  aggregation pays for them. The JAX package sorts them last as an EMPTY
  pseudo-group, which the answer drops too.
- **62-bit keys**: the fused key splits into two parts, each a product of
  dimension cardinalities below 2^31 (:func:`split_parts`).

- **Lookups** (:func:`probe_slots`): the sharded top-k exchange looks
  candidate keys up in each slot's table; the table is sorted, so one
  ``torch.searchsorted`` over the packed keys finds them (the JAX
  package's pair binary search).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

EMPTY = 2**31 - 1                 # empty-slot sentinel; valid codes >= 0
PART_LIMIT = 2**31 - 1            # max product of cardinalities per key part
EMPTY_PACKED = (EMPTY << 31) | EMPTY


class KeySpaceTooWide(Exception):
    """Key space cannot be packed into two int32 parts (> ~2^62)."""


def split_parts(cards: Sequence[int]) -> List[List[int]]:
    """Split dim indices into <=2 groups whose cardinality product stays
    below 2^31-1 each (first-fit-decreasing two-bin packing — a contiguous
    greedy split would reject e.g. [2^28, 2^28, 4, 4], which fits as
    ([0,2], [1,3])). Raises KeySpaceTooWide when no 2-part packing exists."""
    sized = []
    for i, c in enumerate(cards):
        c = max(1, int(c))
        if c >= PART_LIMIT:
            raise KeySpaceTooWide(f"dimension cardinality {c} >= 2^31")
        sized.append((c, i))
    sized.sort(reverse=True)
    bins: List[List[int]] = [[], []]
    prods = [1, 1]
    for c, i in sized:
        # place into the fuller bin that still fits (keeps slack for the
        # remaining, smaller cards); fall back to the other bin
        order = (0, 1) if prods[0] >= prods[1] else (1, 0)
        for b in order:
            if prods[b] * c < PART_LIMIT:
                bins[b].append(i)
                prods[b] *= c
                break
        else:
            raise KeySpaceTooWide(
                f"key space {cards} does not pack into two int32 parts")
    return [sorted(b) for b in bins if b]


def fuse_part(codes: Sequence[torch.Tensor], cards: Sequence[int],
              idxs: Sequence[int]) -> torch.Tensor:
    """Fuse the codes of one part's dims into a single int32 key."""
    k = codes[idxs[0]].to(torch.int32)
    for i in idxs[1:]:
        k = k * int(cards[i]) + codes[i].to(torch.int32)
    return k


def unfuse_part(vals: np.ndarray, cards: Sequence[int],
                idxs: Sequence[int]) -> List[np.ndarray]:
    """Host inverse of fuse_part: part value -> per-dim codes (idxs order)."""
    out = []
    rem = np.asarray(vals, np.int64)
    for i in reversed(list(idxs)):
        c = int(cards[i])
        out.append(rem % c)
        rem = rem // c
    return list(reversed(out))


def live_rows(valid, columns):
    """``(valid rows, columns)`` restricted to the rows where ``valid`` holds:
    ``columns`` are tensors of ``valid``'s shape, 0-d tensors (broadcast)
    or None, each returned flat. The returned validity is all true, or
    one false row when no row is valid (both tiers need a row)."""
    v = valid.reshape(-1)
    idx = torch.nonzero(v).squeeze(1)
    n = idx.numel()
    if n == 0:
        idx = idx.new_zeros(1)
    out = [None if c is None else
           torch.broadcast_to(c, valid.shape).reshape(-1)[idx]
           for c in columns]
    return torch.full((idx.numel(),), n > 0, dtype=torch.bool,
                      device=v.device), out


def sorted_keys(khi, klo, valid):
    """The one sort of both hashed tiers: ``(packed sorted keys [N] int64,
    the sort's row order [N] int64, run-start flags [N] bool, group ids
    [N] int32)``. Invalid rows pack to EMPTY_PACKED and sort last, where
    they form a trailing pseudo-group."""
    v = valid.reshape(-1)
    hi = torch.where(v, khi.reshape(-1).to(torch.int64), EMPTY)
    lo = torch.where(v, klo.reshape(-1).to(torch.int64), EMPTY)
    sk, order = torch.sort((hi << 31) | lo, stable=True)
    new = torch.ones_like(sk, dtype=torch.bool)
    new[1:] = sk[1:] != sk[:-1]
    gid = torch.cumsum(new, 0, dtype=torch.int32) - 1
    return sk, order, new, gid


def build_slots(khi, klo, valid, n_slots: int):
    """Assign one dense table slot per distinct valid (khi, klo) key.

    Returns ``(slot, table_khi, table_klo, n_unresolved)``: ``slot`` has
    the input shape (assigned slot per row; untrustworthy where unresolved
    or ~valid — callers must mask), tables are the per-slot key parts
    ([n_slots] int32, EMPTY where unoccupied, sorted ascending over the
    occupied prefix), ``n_unresolved`` a 0-d int64 tensor counting valid
    rows whose group did not fit in ``n_slots`` (the host retries with a
    bigger table)."""
    T = int(n_slots)
    sk, order, _, gid = sorted_keys(khi, klo, valid)
    slot = torch.empty_like(gid)
    slot[order] = gid
    occupied = sk != EMPTY_PACKED
    # every row of a run writes the same key, so the scatter's order does
    # not matter; rows past the table land in the dropped slot T
    to = torch.where(gid < T, gid, T).to(torch.int64)
    key = torch.where(occupied, sk, EMPTY_PACKED)
    table = torch.full((T + 1,), EMPTY_PACKED, dtype=torch.int64,
                       device=sk.device).scatter_(0, to, key)[:T]
    unresolved = (occupied & (gid >= T)).sum()
    return (slot.reshape(khi.shape), (table >> 31).to(torch.int32),
            (table & EMPTY).to(torch.int32), unresolved)


def probe_slots(tk_hi, tk_lo, khi_q, klo_q):
    """Look query keys up in a built table: ``(slot, found)``, ``slot``
    0 where not found. The whole table is sorted by packed key (EMPTY
    pads the end), so the lower bound of each query's packed key is its
    slot when the key is there. A key absent from the table never
    matches (both parts must), and an EMPTY query key (the padding of an
    underfull candidate list) is a miss."""
    T = int(tk_hi.shape[0])
    table = (tk_hi.to(torch.int64) << 31) | tk_lo.to(torch.int64)
    kh = khi_q.to(torch.int64)
    kl = klo_q.to(torch.int64)
    idx = torch.searchsorted(table, (kh << 31) | kl).clamp_(max=T - 1)
    found = (tk_hi[idx] == kh) & (tk_lo[idx] == kl) & (kh != EMPTY)
    return torch.where(found, idx, 0), found


def pack_key(khi: np.ndarray, klo: np.ndarray) -> np.ndarray:
    """Host: pack two int32 parts into one comparable int64 (parts < 2^31)."""
    return (np.asarray(khi, np.int64) << np.int64(31)) \
        | np.asarray(klo, np.int64)


def unpack_key(packed: np.ndarray):
    return (packed >> np.int64(31)).astype(np.int64), \
        (packed & np.int64(2**31 - 1)).astype(np.int64)


def initial_slots(est_groups: int, lo: int = 1 << 14,
                  hi: int = 1 << 23) -> int:
    """Power-of-two table size for ``est_groups``. Sort-assigned slots
    need no load-factor headroom (slot k = k-th smallest key), and the
    caller's estimate — min(key-space, scanned rows) — is already an
    upper bound on the group count, so the next power of two above it
    always fits; the 4x-retry path only engages when a config override
    undersizes the table."""
    t = lo
    while t < min(max(1, est_groups) + 1, hi):
        t <<= 1
    return min(t, hi)
