"""Device mesh helpers.

Port of ``spark_druid_olap_tpu/parallel/mesh.py``. A mesh is a 1-D tuple
of ``torch.device``s on the segment-scan axis ``SEGMENT_AXIS``; one entry
is one slot, and a tuple may repeat a device:

- ``("cpu",) * 8`` in the tests, the counterpart of the JAX package's
  emulated 8-device CPU mesh;
- ``("cuda:0",) * 2`` on a machine with one card: two slots share it;
- ``cuda:0 ... cuda:N-1`` on a host with N cards, the default of
  :func:`make_mesh`.

Over the multi-process mesh (``parallel/multihost.py``) a process's mesh
is its own slots, and a scan splits into ``process_count() x slots``
shards.

A sharded array is a list of per-slot ``[S / n, R]`` tensors, each on its
slot's device (``parallel/executor.py``'s sharded bind); nothing is laid
out across devices behind the caller's back. JAX's ``shard_map``,
``NamedSharding`` and ``PartitionSpec`` have no counterpart: the per-slot
list takes their place, and ``parallel/meshexec.py`` runs and merges the
slots.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

SEGMENT_AXIS = "shards"

Mesh = Tuple[torch.device, ...]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``devices`` (default every visible card,
    ``torch.cuda.device_count()``), cut to the first ``n_devices``."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=(...) for a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return devs


def mesh_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else len(mesh)


def mesh_subset(mesh: Mesh, n_devices: int) -> Mesh:
    """The mesh over its first ``n_devices`` slots: A-B legs scale one
    device order down (1, 2, 4, ...) instead of building new meshes."""
    n = max(1, min(int(n_devices), len(mesh)))
    return tuple(mesh[:n])


def scan_devices(mesh: Optional[Mesh]) -> int:
    """The devices a scan over ``mesh`` splits across, as the cost model
    prices it: its distinct cards, since slots that share a card share
    its memory bandwidth and scan no faster than one; every CPU slot
    counts as one device, as the JAX package's emulated host devices do
    (the tests' ``("cpu",) * 8`` prices like its 8-device CPU mesh)."""
    if mesh is None:
        return 1
    cards = {_indexed(d) for d in mesh if torch.device(d).type == "cuda"}
    others = sum(1 for d in mesh if torch.device(d).type != "cuda")
    return max(1, len(cards) + others)


def _indexed(d) -> torch.device:
    """``d`` with the current card's index where a cuda device has none."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def slots_on(mesh: Optional[Mesh], device) -> int:
    """How many of the mesh's slots share ``device`` (at least 1)."""
    if mesh is None:
        return 1
    d = _indexed(device)
    return max(1, sum(1 for s in mesh if _indexed(s) == d))
