"""Dense group-by aggregation over fused dictionary-code keys.

Port of ``spark_druid_olap_tpu/ops/groupby.py`` for a 64-bit device: only
the x64 route family (``i64`` / ``f64``), which the JAX package itself
takes on a 64-bit backend (its ``_x64`` / ``plan_route``). The TPU-only
``ff`` / ``ffl`` / ``lanes`` / ``limbs`` routes exist there to stay exact
in f32 and i32 arithmetic; the card has native int64 and float64, so they
are not ported.

- Group keys are **fused dictionary codes**: ``key = ((c0*card1)+c1)*card2+...``
  — dense in ``[0, K)`` because dictionaries are global and sorted.
- Filtered-out rows get the sentinel key ``K``, which matches no group.
- ``K <= sdot.engine.groupby.pallas.max.keys``: the fused kernel
  (``ops/cuda_groupby.py``), one pass over the key and every aggregate —
  the counterpart of the JAX package's Pallas tier.
- Larger ``K``: per-aggregate scatter (``index_add_`` / ``scatter_reduce_``),
  the counterpart of the JAX package's ``_scatter_groupby`` (an XLA op
  there, PyTorch ops here). It is the kernel's plain version,
  ``cuda_groupby.dense_groupby_reference``, which computes the same
  function.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from spark_druid_olap_tpu_torch.ops import cuda_groupby as CG

I64_MAX = np.int64(2**63 - 1)
I64_MIN = np.int64(-(2**63))


@dataclasses.dataclass
class AggInput:
    """One lowered aggregation: kind in {'count','sum','min','max'};
    ``values`` is the [S, R] input (None for count); ``mask`` an optional
    per-agg filter mask (filtered aggregations). ``is_int`` is static
    metadata from column kinds; the route choice reads it."""

    name: str
    kind: str
    values: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    is_int: bool = False


@dataclasses.dataclass(frozen=True)
class Route:
    """Static numeric route for one aggregation: ``i64`` (counts, integer
    sums and extrema) or ``f64`` (float sums and extrema)."""

    name: str
    kind: str                 # count|sum|min|max
    tag: str                  # i64|f64


def plan_route(name: str, kind: str, is_int: bool) -> Route:
    """The numeric route of one aggregation (static, plan time)."""
    return Route(name, kind, "i64" if (is_int or kind == "count") else "f64")


def plan_routes(inputs: Sequence[AggInput]) -> Dict[str, Route]:
    return {a.name: plan_route(a.name, a.kind, a.is_int) for a in inputs}


def use_kernel(n_keys: int, inputs: Sequence[AggInput],
               pallas_max: int) -> bool:
    """Whether the fused kernel takes this group-by: small dense K and
    plain aggregate kinds (the counterpart of ``pallas_groupby.eligible``,
    minus its f32 exactness gates, which int64/float64 accumulation makes
    unnecessary)."""
    return 0 < n_keys <= pallas_max \
        and all(a.kind in CG.KINDS for a in inputs)


def fuse_keys(code_arrays: Sequence[torch.Tensor], cards: Sequence[int]):
    """Fuse per-dim codes into one dense int32 key in [0, prod(cards))."""
    assert len(code_arrays) == len(cards) and len(cards) > 0
    key = code_arrays[0].to(torch.int32)
    for codes, card in zip(code_arrays[1:], cards[1:]):
        key = key * int(card) + codes.to(torch.int32)
    total = 1
    for c in cards:
        total *= int(c)
    return key, total


def unfuse_key(indices, cards: Sequence[int]):
    """Host-side inverse of fuse_keys: group index -> per-dim codes."""
    out = []
    rem = np.asarray(indices, dtype=np.int64)
    for card in reversed(list(cards)):
        out.append(rem % card)
        rem = rem // card
    return list(reversed(out))


def combine_route(route: Route, out: Dict[str, np.ndarray],
                  n_keys: int) -> np.ndarray:
    """Route outputs -> one exact [n_keys] int64/float64 array (min/max
    sentinels preserved; the caller maps them to null)."""
    if route.tag == "f64":
        return np.asarray(out[route.name], np.float64)
    if route.tag == "i64":
        return np.asarray(out[route.name], np.int64)
    raise ValueError(f"route {route.tag}")


def dense_groupby(key: torch.Tensor, mask: torch.Tensor, n_keys: int,
                  inputs: List[AggInput], routes: Dict[str, Route],
                  pallas_max: int) -> Dict[str, torch.Tensor]:
    """Aggregate ``inputs`` grouped by dense ``key`` under ``mask``.

    key: int32 [S, R]; mask: bool [S, R] (row validity & query filter
    already folded in). Returns output_name -> [n_keys] tensor per each
    route's ``outputs`` contract. Callers include a '__rows__' count
    input (used to drop empty groups).
    """
    key = torch.where(mask, key, n_keys).reshape(-1).contiguous()
    flat = [dataclasses.replace(
        a,
        values=None if a.values is None
        else _flat(a.values, key).to(_value_dtype(routes[a.name], a.values)),
        mask=None if a.mask is None else _flat(a.mask, key))
        for a in inputs]
    if use_kernel(n_keys, flat, pallas_max):
        return CG.dense_groupby_kernel(key, n_keys, flat, pallas_max)
    return CG.dense_groupby_reference(key, n_keys, flat)


def _flat(t: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    return torch.broadcast_to(t, key.shape).contiguous() if t.dim() == 0 \
        else t.reshape(-1).contiguous()


def _value_dtype(route: Route, values: torch.Tensor) -> torch.dtype:
    """The dtype a route reads its values in: integer routes never see a
    float; float routes keep f32/f64 values as they are (the kernel widens
    them to f64 as it loads them)."""
    if route.tag == "i64":
        return values.dtype if values.dtype in (torch.int32, torch.int64) \
            else torch.int64
    return values.dtype if values.dtype.is_floating_point \
        else torch.float64

