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
- Larger ``K``: :func:`scatter_groupby`, one scatter per aggregate
  (``index_add_`` / ``scatter_reduce_``) over the rows of some group,
  the counterpart of the JAX package's ``_scatter_groupby`` (XLA segment
  ops there). The hashed tier (``ops/hash_groupby.py``) runs it too, with
  the assigned slot as the key.
- :func:`route_score` / :func:`route_null_mask` read a route's outputs on
  the device for the top-k epilogues.
- :func:`merge_partials` / :func:`merge_lane_partials` merge the per-slot
  partials of a sharded program (``parallel/meshexec.py``) on the mesh's
  first device, in slot order: what the JAX package's ``psum`` / ``pmin``
  / ``pmax`` over the mesh axis compute.
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
        else flat_values(a.values, key).to(
            _value_dtype(routes[a.name], a.values)),
        mask=None if a.mask is None else flat_values(a.mask, key))
        for a in inputs]
    if use_kernel(n_keys, flat, pallas_max):
        return CG.dense_groupby_kernel(key, n_keys, flat, pallas_max)
    return scatter_groupby(key, n_keys, flat, routes)


def scatter_groupby(key: torch.Tensor, n_keys: int, inputs: List[AggInput],
                    routes: Dict[str, Route]) -> Dict[str, torch.Tensor]:
    """The scatter tier: one scatter per aggregate into an ``[n_keys]``
    table (flat ``key``, flat inputs). Rows whose key lies outside
    ``[0, n_keys)`` match no group and are dropped once, before the
    scatters (XLA's segment ops drop them in the JAX package): scattered
    into one spare slot instead, they would serialize on its atomics.
    Counts and integer aggregates in int64, float ones in float64; empty
    min/max groups keep ``INT64_MAX`` / ``INT64_MIN`` / +-inf, and a NaN
    value makes its group's float sum, min and max NaN. On the card the
    float ``index_add_`` is atomic, so its summation order varies from
    run to run."""
    k = key.reshape(-1).long()
    idx = torch.nonzero((k >= 0) & (k < n_keys)).squeeze(1)
    every = idx.numel() == k.numel()

    def live(t):
        return t if every else t[idx]
    k = live(k)
    out = {}
    for a in inputs:
        r = routes[a.name]
        m = None if a.mask is None else live(a.mask) != 0
        if a.kind == "count":
            v = torch.ones_like(k) if m is None else m.long()
        else:
            v = live(a.values).to(torch.int64 if r.tag == "i64"
                                  else torch.float64)
        if a.kind in ("min", "max"):
            sent = sentinel(r)
            if m is not None:
                v = torch.where(m, v, sent)
            acc = torch.full((n_keys,), sent, dtype=v.dtype,
                             device=k.device)
            acc.scatter_reduce_(0, k, v,
                                "amin" if a.kind == "min" else "amax")
        else:
            if m is not None and a.kind == "sum":
                v = torch.where(m, v, 0)
            acc = torch.zeros(n_keys, dtype=v.dtype, device=k.device)
            acc.index_add_(0, k, v)
        out[a.name] = acc
    return out


def _fold(parts, op):
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p)
    return acc


def merge_partials(parts: Sequence[Dict[str, torch.Tensor]],
                   routes: Dict[str, Route]) -> Dict[str, torch.Tensor]:
    """Merge per-slot partials (each on the same device): a ``min`` route
    takes the elementwise minimum, a ``max`` route the maximum, every
    other output, counts and sums and the outputs of no route (an
    overflow count), the sum; folded in slot order, so two runs are bit
    for bit the same. Every port route is exact on one slot (int64 /
    float64), so every output merges here; the JAX package's unmerged
    ``ff`` / ``lanes`` pairs have no counterpart."""
    out = {}
    for name in parts[0]:
        r = routes.get(name.split(".")[0])
        vals = [p[name] for p in parts]
        if r is not None and r.kind == "min":
            out[name] = _fold(vals, torch.minimum)
        elif r is not None and r.kind == "max":
            out[name] = _fold(vals, torch.maximum)
        else:
            out[name] = _fold(vals, torch.add)
    return out


# the register algebra of each sketch family's merge
SKETCH_MERGE_OPS = {"hll": "max", "theta": "min", "kll": "minsum"}


def merge_lane_partials(parts: Sequence[Dict[str, torch.Tensor]],
                        routes: Dict[str, Route],
                        sketch_kinds: Dict[str, str]
                        ) -> Dict[str, torch.Tensor]:
    """Merge of ONE lane's per-slot output dicts, the layout every sharded
    program folds with (solo cores and the fused tier alike): dense
    routes through :func:`merge_partials`, sketch registers through their
    own algebra (``ops/hll``, ``ops/theta``, ``ops/kll``
    ``merge_registers``), never plain addition. ``sketch_kinds`` maps an
    output name to ``hll`` / ``theta`` / ``kll``."""
    from spark_druid_olap_tpu_torch.ops import hll as _hll
    from spark_druid_olap_tpu_torch.ops import kll as _kll
    from spark_druid_olap_tpu_torch.ops import theta as _theta
    folds = {"hll": _hll.merge_registers, "theta": _theta.merge_registers,
             "kll": _kll.merge_registers}
    dense = [{k: v for k, v in p.items() if k not in sketch_kinds}
             for p in parts]
    merged = merge_partials(dense, routes)
    for name, kind in sketch_kinds.items():
        merged[name] = folds[kind]([p[name] for p in parts])
    return merged


def route_score(route: Route, out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-key value of one aggregation from its route output, as float64:
    the selection score of the top-k epilogues (exact for ``f64``, and for
    ``i64`` below 2^53; the exactness proof handles the rest)."""
    return out[route.name].to(torch.float64)


def route_null_mask(route: Route, out: Dict[str, torch.Tensor]):
    """Bool mask of keys whose min/max metric is NULL (the empty-group
    sentinel survived); None for sum and count routes, whose NULL identity
    is 0."""
    if route.kind not in ("min", "max"):
        return None
    return out[route.name] == sentinel(route)


def sentinel(route: Route):
    """The empty-group value of a min / max route: ``INT64_MAX`` /
    ``INT64_MIN`` for ``i64``, +-inf for ``f64``."""
    if route.tag == "i64":
        return int(I64_MAX if route.kind == "min" else I64_MIN)
    return float("inf") if route.kind == "min" else float("-inf")


def flat_values(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` flattened to ``like``'s row count (a 0-d value broadcasts)."""
    return torch.broadcast_to(t, like.shape).contiguous() if t.dim() == 0 \
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


def run_weighted_partials(run_values, run_lengths, n_keys: int,
                          run_sums=None) -> Dict[str, np.ndarray]:
    """RLE-aware host partials (the JAX package's
    ``ops/groupby.run_weighted_partials``, copied): aggregate
    run-at-a-time instead of row-at-a-time. A run of length L with key k
    contributes L to count[k] in one add — the count partial IS the run
    length — and a pre-reduced per-run metric sum lands in sum[k] the same
    way, so a group-by over an RLE-encoded dimension touches O(runs)
    values (``encode/exec.rle_groupby`` drives this over encoded chunks;
    keys outside [0, n_keys) — filtered sentinels — drop, matching the
    kernels' overflow-slot semantics). Exact: counts accumulate in int64,
    sums in f64."""
    counts = np.zeros(n_keys, dtype=np.int64)
    out = {"count": counts}
    run_values = np.asarray(run_values)
    run_lengths = np.asarray(run_lengths, dtype=np.int64)
    if len(run_lengths) == 0:
        if run_sums is not None:
            out["sum"] = np.zeros(n_keys, dtype=np.float64)
        return out
    keep = (run_values >= 0) & (run_values < n_keys)
    v = run_values[keep].astype(np.int64)
    np.add.at(counts, v, run_lengths[keep])
    if run_sums is not None:
        sums = np.zeros(n_keys, dtype=np.float64)
        np.add.at(sums, v, np.asarray(run_sums, dtype=np.float64)[keep])
        out["sum"] = sums
    return out
