"""The single-process device mesh: run a program on every slot, merge.

Port of ``spark_druid_olap_tpu/parallel/meshexec.py``. The JAX package
wraps a per-lane program in ``shard_map`` over the 1-D segment axis and
merges the lanes' partials with ``psum`` / ``pmin`` / ``pmax`` inside the
body. Here a sharded program is the unchanged single-device program run
once per mesh slot (``parallel/mesh.py``) over that slot's
``[S / n, R]`` share of the segments, then a merge on the mesh's first
device:

1. :func:`run_slots` runs each slot's program; on CUDA each slot runs
   on its own stream, which first waits for the work already enqueued on
   its device's current stream (the bind).
2. Each slot's stream then records an event, and the current stream of
   every slot's device waits on it: the merge waits on every slot.
3. :func:`to_root` copies each slot's partial to the mesh's first device
   (``tensor.to(root)``: a peer copy between cards, nothing on one card).
4. ``ops/groupby.merge_lane_partials`` reduces the partials in slot
   order: sums add, ``min`` / ``max`` routes take the minimum / maximum,
   HLL registers the maximum, theta minima the minimum, KLL survivors
   the lexicographic minimum with exact level counts. Two runs are bit
   for bit the same. The result stays on the root device, which the one
   process reads; JAX's replicated ``P()`` has no other reader here.

Within a process no NCCL: ``torch.cuda.nccl`` cannot take one device
twice. Over the multi-process mesh (``parallel/multihost.py``) a solo
program's merged partial then travels once more: every rank's is
gathered (``multihost.gather_partials``: NCCL on the cards, or gloo
through a host copy) and folded in rank order with the same
``merge_lane_partials``, so every rank holds the same bytes; no
``all_reduce``, whose float sums depend on the transport's order. Each
slot launches the same hand-written kernel as one device does (B1
through ``ops/groupby.dense_groupby``, B2 through ``ops/cuda_wave``), and
its wrapper raises on failure as it does there.

- :func:`decide` is the fused tier's static precheck: every
  disqualifying condition falls back to one device with a named reason.
- :func:`merged_payload_bytes` / :func:`collective_bytes` account the
  merge's bytes from route metadata.
- :class:`PartialLedger` tracks the per-slot partial buffers a wave loop
  holds on the devices (``acquire_partials`` / ``release_partials``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from spark_druid_olap_tpu_torch.ops import groupby as G
from spark_druid_olap_tpu_torch.ops import kll as KLL
from spark_druid_olap_tpu_torch.ops import theta as TH
from spark_druid_olap_tpu_torch.ops.sketch import SKETCH_KINDS
from spark_druid_olap_tpu_torch.parallel import cost as C
from spark_druid_olap_tpu_torch.parallel import mesh as M
from spark_druid_olap_tpu_torch.parallel import multihost as MH
from spark_druid_olap_tpu_torch.utils.config import (
    COST_MODEL_ENABLED,
    HLL_LOG2M,
    MESH_ENABLED,
    MESH_MIN_SEGMENTS,
    QUANTILE_LANES,
)


@dataclasses.dataclass(frozen=True)
class MeshDecision:
    """Outcome of the static precheck: ``reason`` is one of the fallback
    matrix's rows (``no-mesh``, ``disabled``, ``multihost``,
    ``partial-store``, ``few-segments``, ``cost-single``) or ``sharded``
    / ``cost-sharded`` when the group shards."""
    sharded: bool
    n_dev: int
    reason: str

    def sig_fields(self) -> Tuple:
        """The fields that shape the program: part of every program and
        bind cache key, so a flip of ``sdot.mesh.*`` or a new mesh size
        re-keys them."""
        return (self.sharded, self.n_dev)


SINGLE = MeshDecision(False, 1, "no-mesh")


@dataclasses.dataclass
class Lane:
    """What a merge needs of one program output: its routes, its
    aggregations (for the sketch registers) and its key count; a solo
    core's stand-in for a fused group's lane plan."""
    routes: dict
    agg_plans: list
    n_keys: int


def decide(eng, ds, lanes, n_segments: int) -> MeshDecision:
    """Static mesh eligibility of one fused group. One device on any
    disqualifying condition; the fused tier never fails because of the
    mesh. Reasons:

    - ``no-mesh``       the engine has no mesh, or one slot
    - ``disabled``      ``sdot.mesh.enabled`` is false (kill switch)
    - ``multihost``     ``torch.distributed`` runs more than one process:
                        the fused tier stays in one process, as in the
                        JAX package
    - ``partial-store`` the datasource's rows live across processes (the
                        coalescer declines it before this check, and each
                        statement runs solo over the multi-process mesh)
    - ``few-segments``  fewer selected segments than
                        ``sdot.mesh.min.segments`` (at least 2)
    - ``cost-single``   the cost model priced the merge above the scan
                        split (``parallel/cost.mesh_estimate``)
    """
    n = M.mesh_size(eng.mesh)
    if n <= 1:
        return SINGLE
    if not bool(eng.config.get(MESH_ENABLED)):
        return MeshDecision(False, 1, "disabled")
    if MH.is_multihost():
        return MeshDecision(False, 1, "multihost")
    if getattr(ds, "is_partial", False):
        return MeshDecision(False, 1, "partial-store")
    if n_segments < max(2, int(eng.config.get(MESH_MIN_SEGMENTS))):
        return MeshDecision(False, 1, "few-segments")
    if not bool(eng.config.get(COST_MODEL_ENABLED)):
        return MeshDecision(True, n, "sharded")
    try:
        est = C.mesh_estimate(
            eng.config, n_dev=n, rows=int(ds.num_rows),
            groups=max(lp.n_keys for lp in lanes),
            n_aggs=sum(len(lp.agg_plans) for lp in lanes),
            merge_bytes=collective_bytes(eng, lanes, n),
            scan_devices=M.scan_devices(eng.mesh))
    except Exception:   # noqa: BLE001 — cost must never fail a query
        return MeshDecision(True, n, "sharded")
    if not est.recommend_sharded:
        return MeshDecision(False, 1, "cost-single")
    return MeshDecision(True, n, "cost-sharded")


def sketch_kinds(agg_plans) -> Dict[str, str]:
    """Output name -> sketch family of a lane's register aggregations."""
    return {p.spec.name: p.kind for p in agg_plans
            if p.kind in SKETCH_KINDS}


# -- static interconnect accounting -------------------------------------------

def merged_payload_bytes(eng, lanes) -> int:
    """Bytes of one slot's partials in one dispatch, from route metadata:
    one int64 / float64 ``[K]`` output per route, and the sketch register
    blocks at their device width (int32 HLL and KLL registers, float32
    theta minima; the JAX package packs every element in 8 bytes)."""
    widths = {"hll": 1 << int(eng.config.get(HLL_LOG2M)),
              "theta": TH.K_LANES,
              "kll": KLL.width(int(eng.config.get(QUANTILE_LANES)))}
    nbytes = 0
    for lp in lanes:
        sketch = sketch_kinds(lp.agg_plans)
        for name in lp.routes:
            if name not in sketch:
                nbytes += lp.n_keys * 8
        for kind in sketch.values():
            nbytes += lp.n_keys * widths[kind] * 4
    return nbytes


def collective_bytes(eng, lanes, n_dev: int) -> int:
    """The merge's bytes between the slots of one sharded dispatch: every
    slot's partial but the root's travels once (``payload x (n_dev -
    1)``, the convention ``parallel/cost.py`` prices)."""
    return merged_payload_bytes(eng, lanes) * max(0, int(n_dev) - 1)


# -- running the slots ---------------------------------------------------------

_streams: Dict[Tuple[int, int], torch.cuda.Stream] = {}
_streams_lock = threading.Lock()


def _slot_stream(device: torch.device, slot: int):
    """The stream of mesh slot ``slot`` on ``device``, made once."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), slot)
    with _streams_lock:
        s = _streams.get(key)
        if s is None:
            s = _streams[key] = torch.cuda.Stream(device)
        return s


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def run_slots(mesh, fn: Callable, slot_inputs: Sequence) -> List:
    """``fn(slot_inputs[i])`` for every slot ``i``; the outputs are ready
    for work enqueued afterwards on the current stream of their slot's
    device. On CUDA each slot runs on its own stream, which first waits
    for its device's current stream; then the current stream waits on the
    slot's event. Each input and output tensor is recorded on the streams
    that read it, so the allocator never hands its memory out early. On
    the CPU the slots run one after another."""
    if len(slot_inputs) != len(mesh):
        raise ValueError(f"{len(slot_inputs)} slot inputs for a mesh of "
                         f"{len(mesh)} slots")
    if mesh[0].type != "cuda":
        return [fn(x) for x in slot_inputs]
    outs, events = [], []
    for i, (dev, x) in enumerate(zip(mesh, slot_inputs)):
        s = _slot_stream(dev, i)
        s.wait_stream(torch.cuda.current_stream(dev))
        for t in _tensors(x):
            t.record_stream(s)
        with torch.cuda.stream(s):
            outs.append(fn(x))
        ev = torch.cuda.Event()
        ev.record(s)
        events.append(ev)
    for dev, ev, out in zip(mesh, events, outs):
        cs = torch.cuda.current_stream(dev)
        cs.wait_event(ev)
        for t in _tensors(out):
            t.record_stream(cs)
    return outs


def to_root(mesh, obj):
    """``obj``'s tensors on the mesh's first device (a peer copy from
    another card, the tensor itself on the root's)."""
    root = mesh[0]
    if isinstance(obj, torch.Tensor):
        return obj.to(root)
    if isinstance(obj, dict):
        return {k: to_root(mesh, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_root(mesh, v) for v in obj)
    return obj


def build_sharded_program(eng, lane_outs_fn: Callable, lanes,
                          ranks: bool = False):
    """Wrap ``lane_outs_fn`` (one slot's arrays -> one route-conformant
    output dict per lane: the fused lane program, the wave kernel's
    ``wave_fn`` or a solo core) for the engine's mesh (its one device
    without one). The returned callable takes the per-slot arrays (the
    sharded bind: one dict per slot) and returns the lanes' merged
    outputs on the root device, the same dicts the single-device program
    returns, so the copy to the host and the decode are shared. ``ranks``:
    the merged outputs are then every rank's of the multi-process mesh,
    gathered and folded in rank order."""
    mesh = eng.mesh or (eng.device,)
    kinds = [sketch_kinds(lp.agg_plans) for lp in lanes]

    def fold(parts):
        return [G.merge_lane_partials([o[i] for o in parts], lp.routes,
                                      kinds[i])
                for i, lp in enumerate(lanes)]

    def run(slot_arrays):
        merged = fold(to_root(mesh, run_slots(mesh, lane_outs_fn,
                                              slot_arrays)))
        return fold(MH.gather_partials(merged)) if ranks else merged

    return run


# -- device-resident partial-buffer ledger ------------------------------------

class _PartialToken:
    __slots__ = ("nbytes", "released")

    def __init__(self, nbytes: int):
        self.nbytes = int(nbytes)
        self.released = False


class PartialLedger:
    """The per-slot partial buffers a wave loop holds on the devices
    between dispatch and merge: every ``acquire_partials`` is released on
    every path, so a failed wave loop leaves no phantom bytes."""

    def __init__(self):
        self._lock = threading.Lock()
        self.outstanding_bytes = 0
        self.peak_bytes = 0
        self.acquires = 0

    def acquire_partials(self, nbytes: int) -> _PartialToken:
        tok = _PartialToken(nbytes)
        with self._lock:
            self.acquires += 1
            self.outstanding_bytes += tok.nbytes
            self.peak_bytes = max(self.peak_bytes, self.outstanding_bytes)
        return tok

    def release_partials(self, tok: _PartialToken) -> None:
        with self._lock:
            if not tok.released:
                tok.released = True
                self.outstanding_bytes -= tok.nbytes

    def stats(self) -> dict:
        with self._lock:
            return {"outstanding_bytes": self.outstanding_bytes,
                    "peak_bytes": self.peak_bytes,
                    "acquires": self.acquires}


#: process-wide gauge (``wlm.stats()["sharedscan"]["mesh"]["partials"]``)
LEDGER = PartialLedger()
