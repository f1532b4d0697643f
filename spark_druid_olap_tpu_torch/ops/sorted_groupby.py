"""Sorted-run aggregation for the hashed group-by tier.

Port of ``spark_druid_olap_tpu/ops/sorted_groupby.py`` for a 64-bit
device (x64 routes only: ``i64`` / ``f64``). The slot sort of the hashed
tier (``hash_groupby.sorted_keys``) already orders the rows by key; here
every aggregate's values ride that sort as payloads (gathered through
the sort's row order), so each group's rows form one contiguous run and
no sum or count scatters:

- **Run ends**: ``torch.searchsorted`` of the first ``T`` group ids over
  the nondecreasing group-id vector, the function the JAX package's
  ``_end_positions`` computes with a hand-rolled binary search.
- **Counts and integer sums**: int64 prefix sum, difference at the run
  boundaries. Two's-complement wrap-around cancels in the difference, so
  every group total that fits int64 is exact.
- **Float sums**: a segmented reduction over the runs,
  ``torch.segment_reduce(..., "sum", lengths=run lengths)``, where the JAX
  package runs a segmented scan. A prefix-sum difference would carry a
  large earlier group's magnitude into the rounding of small later groups
  (``tests/test_sorted_groupby.py``'s small-groups-after-a-large-prefix
  case), and a segmented reduction never mixes runs.
- **min / max**: ``scatter_reduce_`` (``amin`` / ``amax``) over the group
  ids into sentinel-filled slots (``torch.segment_reduce`` takes no int64
  on the CPU): ``INT64_MAX`` / ``INT64_MIN`` / +-inf for empty groups,
  and a NaN value makes its group's float result NaN, as the scatter
  tier gives them.

Outputs keep the hashed tier's contract: route outputs ``[T]`` plus
``__tkhi__`` / ``__tklo__`` (equal to ``build_slots``'s tables) and
``__unres__``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from spark_druid_olap_tpu_torch.ops import hash_groupby as H
from spark_druid_olap_tpu_torch.ops.groupby import (
    AggInput,
    Route,
    flat_values,
    sentinel,
)

SUPPORTED_KINDS = ("count", "sum", "min", "max")


def plan_sorted_routes(inputs: List[AggInput]) -> Optional[Dict[str, Route]]:
    """Routes for the sorted-run core, or None when some aggregation kind
    is outside its reach (the caller keeps the scatter path)."""
    out: Dict[str, Route] = {}
    for a in inputs:
        if a.kind not in SUPPORTED_KINDS:
            return None
        out[a.name] = Route(a.name, a.kind, "i64" if (
            a.is_int or a.kind == "count") else "f64")
    return out


def sorted_hash_groupby(khi, klo, valid, T: int, inputs: List[AggInput],
                        routes: Dict[str, Route]) -> Dict[str, torch.Tensor]:
    """One-sort hashed group-by: the same output dict that
    ``build_slots`` + the scatter tier produce."""
    base = valid.reshape(-1)
    n = base.numel()
    dev = base.device
    sk, order, new, gid = H.sorted_keys(khi, klo, valid)
    unresolved = ((sk != H.EMPTY_PACKED) & (gid >= T)).sum()

    q = torch.arange(T, dtype=torch.int32, device=dev)
    first_after = torch.searchsorted(gid, q, right=True)      # [T] int64
    end_pos = (first_after - 1).clamp(0, max(n - 1, 0))
    prev_after = torch.cat([first_after.new_zeros(1), first_after[:-1]])
    lengths = first_after - prev_after
    end_key = sk[end_pos]
    g_occ = (lengths > 0) & (end_key != H.EMPTY_PACKED)
    tk = torch.where(g_occ, end_key, H.EMPTY_PACKED)
    # rows of groups past the table (and the invalid pseudo-group when it
    # lies past it) form one trailing segment, dropped below
    seg_lengths = torch.cat([lengths, (n - first_after[-1:])])
    slot = torch.where(gid < T, gid, T).to(torch.int64)

    out: Dict[str, torch.Tensor] = {}
    for a in inputs:
        r = routes[a.name]
        am = base if a.mask is None else base & flat_values(a.mask, base)
        am = am[order]
        if a.kind == "count":
            v = am.to(torch.int64)
        else:
            v = flat_values(a.values, base)[order].to(
                torch.int64 if r.tag == "i64" else torch.float64)
        if a.kind in ("min", "max"):
            sent = sentinel(r)
            acc = torch.full((T + 1,), sent, dtype=v.dtype, device=dev)
            acc.scatter_reduce_(0, slot, torch.where(am, v, sent),
                                "amin" if a.kind == "min" else "amax")
            out[r.name] = torch.where(g_occ, acc[:T], sent)
        elif r.tag == "i64":
            c = torch.cumsum(torch.where(am, v, 0), 0)
            at_end = c[end_pos]
            before = torch.where(prev_after > 0, c[(prev_after - 1)
                                                    .clamp(min=0)], 0)
            out[r.name] = torch.where(g_occ, at_end - before, 0)
        else:
            tot = torch.segment_reduce(torch.where(am, v, 0.0), "sum",
                                       lengths=seg_lengths, unsafe=True)
            out[r.name] = torch.where(g_occ, tot[:T], 0.0)
    out["__tkhi__"] = (tk >> 31).to(torch.int32)
    out["__tklo__"] = (tk & H.EMPTY).to(torch.int32)
    out["__unres__"] = unresolved.reshape(1)
    return out
