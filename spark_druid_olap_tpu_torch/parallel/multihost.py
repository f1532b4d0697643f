"""The multi-process mesh: one process per host, merged over
``torch.distributed``.

Port of ``spark_druid_olap_tpu/parallel/multihost.py`` (≈ the reference's
distributed plane: segments are assigned to historical servers by
priority and least-load, ``DruidMetadataCache.assignHistoricalServers``,
and a scan fans out one partition per server x segment group,
``DruidRDD.getPartitions:244-277``). The JAX package joins every host's
process into one runtime whose mesh spans every chip, binds each host's
shards through ``jax.make_array_from_callback`` and merges with psum /
all_gather inside ``shard_map``. Here:

- :func:`initialize` joins the process to a ``torch.distributed`` group
  whose device backend the caller names: ``"nccl"`` when every rank
  drives cards of its own, ``"gloo"`` on the CPU or when ranks share a
  card (NCCL refuses two ranks on one card). A second group, always
  gloo, carries the host-data exchanges. Nothing falls back: a backend
  that cannot start raises.
- A process's mesh is its own slots (``parallel/mesh.py``); the global
  shard count is ``process_count() x local slots``;
  :func:`initialize` checks that every rank has as many slots.
- **Host-level segment ownership** (:func:`assign_segments_to_hosts`):
  contiguous time-blocks balanced by rows. Each process holds only its
  own segments' rows (``segment/store.Datasource.local_seg_ids``, a
  *partial store*); global metadata (segment bounds, dictionaries, metric
  bounds) is the same everywhere, so every planning decision is the same
  on every rank.
- :func:`layout_segments` / :func:`layout_segments_waves` fix the
  segment -> slot order so each host's slots scan exactly that host's
  segments (numpy only, the JAX package's bit for bit). A process binds
  its own block through ``ops/scan.build_array_blocks``; the JAX
  package's ``put_sharded_blocks`` has no counterpart (ROADMAP §C).
- :func:`gather_partials` is the device merge's collective: every rank's
  merged partial, in rank order, which each rank then folds the same way
  (``ops/groupby.merge_lane_partials``), so every rank holds the same
  bytes. :func:`exchange_block` is the variable-length host exchange
  under select paging, search counts and the host tier's gather.
- :data:`SEQUENCER` orders statements over a partial store: every rank
  must issue the same collectives in the same order, so concurrent
  statements take their turns in an order the ranks agree on
  (:class:`Sequencer`).

Every *planning* decision (pruning, slot sizing, wave split, compaction
budgets, the hashed table size) reads metadata that is identical on
every process: a divergent decision deadlocks the collectives, so
zone-map pruning (which reads per-host column data) is off on a partial
store (``segment/store.Datasource.prune_segments``).
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import socket
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# the process's groups and the card census initialize() takes
_STATE = {"backend": None, "host_group": None, "ranks_per_card": 1,
          "card_bytes": 0, "slots": 1}
_STATS_LOCK = threading.Lock()
# collectives this process issued, their bytes (sent + received) and ms
COUNTERS = {"collectives": 0, "bytes": 0, "ms": 0.0}


def initialize(init_method: str, world_size: int, rank: int, backend: str,
               timeout: float = 120.0, devices: Optional[Sequence] = None,
               slots: int = 1) -> None:
    """Join this process into the multi-process mesh
    (``torch.distributed.init_process_group``; the JAX package's
    ``jax.distributed.initialize``). ``init_method`` is an address such
    as ``tcp://localhost:<port>``; ``backend`` is ``"nccl"`` or
    ``"gloo"``, chosen by the caller; ``timeout`` (seconds) bounds every
    collective, so a mismatch fails instead of hanging. ``devices`` are
    the cards this rank drives (default: the current card, none on the
    CPU): ranks that share a card split its wave budget
    (``parallel/cost.wave_budget_bytes``), and NCCL over a shared card
    raises here. ``slots`` is the number of mesh slots this rank drives:
    every rank must drive as many (the host-homogeneous pod the JAX
    package requires), checked here once, so that :func:`host_blocks`
    issues no collective. A CUDA rank sets its current card before it
    calls."""
    import torch.distributed as dist
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("backend 'nccl' is not available in this torch "
                           "build; pass backend='gloo'")
    td = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank),
                            timeout=td)
    host = dist.new_group(backend="gloo", timeout=td) \
        if backend == "nccl" else None
    _STATE.update(backend=backend, host_group=host, slots=int(slots))
    if devices is None:
        devices = [torch.cuda.current_device()] \
            if torch.cuda.is_available() and torch.cuda.is_initialized() \
            else []
    cards = []
    for d in devices:
        d = torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
        if d.type == "cuda":
            idx = d.index if d.index is not None \
                else torch.cuda.current_device()
            cards.append((socket.gethostname(), idx,
                          int(torch.cuda.get_device_properties(idx)
                              .total_memory)))
    census: List = [None] * int(world_size)
    dist.all_gather_object(census, (int(slots), sorted(set(cards))),
                           group=host)
    got = sorted({n for n, _ in census})
    if got != [int(slots)]:
        shutdown()
        raise ValueError(f"ranks drive {got} slots each: the multi-process "
                         f"mesh needs the same number on every rank")
    census = [rank_cards for _, rank_cards in census]
    users = {}
    for rank_cards in census:
        for host_name, idx, _ in rank_cards:
            users[(host_name, idx)] = users.get((host_name, idx), 0) + 1
    mems = [m for rank_cards in census for _, _, m in rank_cards]
    _STATE["ranks_per_card"] = max(users.values(), default=1)
    _STATE["card_bytes"] = min(mems, default=0)
    if backend == "nccl" and _STATE["ranks_per_card"] > 1:
        shutdown()
        raise RuntimeError("backend 'nccl' with two ranks on one card: NCCL "
                           "refuses it; pass backend='gloo'")


def shutdown() -> None:
    """Leave the process group (a no-op when none is initialized)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(backend=None, host_group=None, ranks_per_card=1,
                  card_bytes=0, slots=1)


def is_multihost() -> bool:
    """Whether this process is one of several of an initialized
    ``torch.distributed`` group (the JAX package's
    ``jax.process_count() > 1``)."""
    return process_count() > 1


def process_count() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def ranks_per_card() -> int:
    """The most ranks that drive one card (1 without a group, or on the
    CPU): they split the card's wave budget."""
    return int(_STATE["ranks_per_card"])


def card_bytes() -> int:
    """The smallest card memory over every rank's cards (0 without a
    card): the wave budget every rank plans with, so that every rank
    plans the same waves."""
    return int(_STATE["card_bytes"])


def assign_segments_to_hosts(row_counts: np.ndarray,
                             n_hosts: int) -> np.ndarray:
    """[S] -> host id. Contiguous time-blocks balanced by rows.

    Segments are time-ordered, so contiguous blocks keep a host's data one
    time range (interval pruning then prunes whole hosts, the way Druid's
    time-chunk assignment does); the row-balance objective is the
    least-load term of ``assignHistoricalServers``. Greedy split at the
    ideal cumulative boundaries — deterministic, metadata-only (every
    process computes the identical assignment)."""
    rows = np.asarray(row_counts, dtype=np.int64)
    s = len(rows)
    if n_hosts <= 1 or s == 0:
        return np.zeros(s, dtype=np.int32)
    cum = np.cumsum(rows)
    total = int(cum[-1])
    out = np.zeros(s, dtype=np.int32)
    # boundary h sits where cumulative rows pass h/n of the total
    targets = total * np.arange(1, n_hosts) / n_hosts
    cuts = np.searchsorted(cum - rows / 2.0, targets)
    prev = 0
    for h, c in enumerate(np.clip(cuts, 0, s)):
        out[prev:c] = h
        prev = max(prev, int(c))
    out[prev:] = n_hosts - 1
    return out


def host_blocks(mesh) -> Tuple[int, int]:
    """``(world size, local slots)`` of this process's mesh (``mesh``: its
    slots; one slot when None), the JAX package's ``host_blocks``. It
    issues no collective, so planning (EXPLAIN's included) runs outside a
    statement's turn: :func:`initialize` checked that every rank drives
    its ``slots``, and a mesh of another size raises here."""
    n_local = 1 if mesh is None else len(mesh)
    n_proc = process_count()
    if n_proc > 1 and n_local != _STATE["slots"]:
        raise ValueError(f"a mesh of {n_local} slots on a rank that joined "
                         f"the multi-process mesh with {_STATE['slots']}")
    return n_proc, n_local


def layout_segments(assignment: np.ndarray, seg_idx: np.ndarray,
                    n_hosts: int, devs_per_host: int):
    """Fix the segment→device order for a (pruned) selection so each
    host's devices scan exactly that host's segments.

    Returns ``(ordered, s_pad)``: ``ordered`` is a [n_hosts * per_host]
    int64 array of global segment ids with ``-1`` padding slots (empty,
    row-validity False), ``per_host`` padded to a common multiple of
    ``devs_per_host`` so the global segment axis divides evenly. Every
    process computes this identically from global metadata — it is the
    multi-host replacement for the executor's contiguous ``_pad_segments``
    split."""
    seg_idx = np.asarray(seg_idx, dtype=np.int64)
    per_host_lists = [seg_idx[assignment[seg_idx] == h]
                      for h in range(n_hosts)]
    longest = max((len(x) for x in per_host_lists), default=0)
    longest = max(longest, 1)
    per_host = -(-longest // devs_per_host) * devs_per_host
    ordered = np.full(n_hosts * per_host, -1, dtype=np.int64)
    for h, lst in enumerate(per_host_lists):
        ordered[h * per_host: h * per_host + len(lst)] = lst
    return ordered, per_host


def layout_segments_waves(assignment: np.ndarray, seg_idx: np.ndarray,
                          n_hosts: int, devs_per_host: int, n_waves: int,
                          seg_bytes: int = 0, wave_budget: int = 0):
    """Wave-mode variant of ``layout_segments``: waves must compose with
    multi-host (the overflow valve of a scan larger than the devices).

    Each WAVE is itself a host-blocked layout: wave ``w`` holds the
    ``w``-th chunk of every host's pruned segment list, padded to a common
    per-host-per-wave count that divides ``devs_per_host``. Returns
    ``(ordered, spw)``: ``ordered`` is [n_waves_eff * spw] with ``-1``
    padding; contiguous ``spw``-slices of it are exactly the per-wave
    layouts the executor's wave loop slices. Every process computes this
    identically from global metadata."""
    seg_idx = np.asarray(seg_idx, dtype=np.int64)
    per_host_lists = [seg_idx[assignment[seg_idx] == h]
                      for h in range(n_hosts)]
    longest = max((len(x) for x in per_host_lists), default=0)
    longest = max(longest, 1)
    n_waves = max(1, min(int(n_waves), longest))
    phw = -(-longest // n_waves)                   # per host per wave
    phw = -(-phw // devs_per_host) * devs_per_host
    if seg_bytes and wave_budget:
        # cap per-host-per-wave from the byte budget DIRECTLY: the
        # caller's n_waves assumed a balanced assignment, so a host
        # owning more than its share would bind phw/devs_per_host
        # segments past the per-device budget (the memory-overflow valve)
        phw_budget = max(1, int(wave_budget) // int(seg_bytes)) \
            * devs_per_host
        phw = min(phw, max(phw_budget, devs_per_host))
    n_waves_eff = -(-longest // phw)
    spw = n_hosts * phw
    ordered = np.full(n_waves_eff * spw, -1, dtype=np.int64)
    for h, lst in enumerate(per_host_lists):
        for w in range(n_waves_eff):
            blk = lst[w * phw: (w + 1) * phw]
            base = w * spw + h * phw
            ordered[base: base + len(blk)] = blk
    return ordered, spw


# -- collectives ---------------------------------------------------------------

def _count(nbytes: int, t0: float) -> None:
    with _STATS_LOCK:
        COUNTERS["collectives"] += 1
        COUNTERS["bytes"] += int(nbytes)
        COUNTERS["ms"] += (time.perf_counter() - t0) * 1e3


def stats_snapshot() -> dict:
    with _STATS_LOCK:
        return dict(COUNTERS)


def _all_gather_bytes(buf: torch.Tensor, group) -> torch.Tensor:
    """[world, n] of every rank's ``buf`` ([n] uint8), in rank order."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    n_proc = process_count()
    out = torch.empty((n_proc * buf.numel(),), dtype=torch.uint8,
                      device=buf.device)
    dist.all_gather_into_tensor(out, buf, group=group)
    _count(out.numel(), t0)
    return out.reshape(n_proc, -1)


def exchange_block(local: np.ndarray) -> List[np.ndarray]:
    """All-gather a VARIABLE-LENGTH per-process numpy array; returns one
    array per process (ascending rank). The cross-process host-data
    exchange under select paging, search counts and the host tier's
    gather of a partial store (≈ the reference's Spark-side fallback scan
    pulling rows off historicals, ``DruidRDD.getPartitions:244-277``).
    Sizes travel first; every array travels as its raw bytes over the
    gloo group (a bool array as uint8), so any fixed-width dtype
    survives. Dimensions travel as dictionary codes and decode against
    the replicated global dictionary."""
    local = np.ascontiguousarray(local)
    n_proc = process_count()
    if n_proc <= 1:
        return [local]
    if local.dtype == object:
        raise TypeError("exchange_block moves fixed-width arrays only")
    group = _STATE["host_group"]
    trailing, dtype = local.shape[1:], local.dtype
    row_bytes = int(dtype.itemsize * np.prod(trailing, dtype=np.int64))
    sizes = _all_gather_bytes(
        torch.tensor([local.shape[0]], dtype=torch.int64).view(torch.uint8),
        group).view(torch.int64).reshape(-1).numpy()
    m = int(sizes.max()) if sizes.size else 0
    if m == 0 or row_bytes == 0:
        return [np.empty((int(s),) + trailing, dtype) for s in sizes]
    raw = np.zeros(m * row_bytes, np.uint8)
    raw[: local.nbytes] = local.reshape(-1).view(np.uint8)
    out = _all_gather_bytes(torch.from_numpy(raw), group).numpy()
    return [out[p, : int(s) * row_bytes].view(dtype).reshape(
        (int(s),) + trailing).copy() for p, s in enumerate(sizes)]


def _flat(obj) -> List[torch.Tensor]:
    """The tensors of a dict / list / tensor in a deterministic order
    (dict keys sorted), for packing."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in _flat(obj[k])]
    return [t for v in obj for t in _flat(v)]


def _rebuild(obj, it):
    if isinstance(obj, torch.Tensor):
        return next(it)
    if isinstance(obj, dict):
        vals = {k: _rebuild(obj[k], it) for k in sorted(obj)}
        return {k: vals[k] for k in obj}
    return type(obj)(_rebuild(v, it) for v in obj)


def gather_partials(obj) -> list:
    """Every rank's ``obj`` (a tensor, or a dict / list of tensors of the
    same shapes and dtypes on every rank), in rank order: the collective
    of the device merge, which each rank then folds in rank order. The
    tensors pack into one byte buffer: with NCCL and tensors on a card it
    is one ``all_gather`` on the device, else (gloo, or host tensors) one
    over the gloo group through a host copy, since gloo has no CUDA
    all_gather. Each rank's copy comes back on the devices of ``obj``'s
    tensors."""
    tensors = _flat(obj)
    n_proc = process_count()
    if n_proc <= 1:
        return [obj]
    meta, parts = [], []
    for t in tensors:
        t = t.reshape(-1)
        if t.numel() and t.stride(0) != 1:
            # a one-element view may keep another stride and still count
            # as contiguous; a byte view needs stride 1
            t = t.clone(memory_format=torch.contiguous_format)
        b = t.view(torch.uint8)
        meta.append((t.dtype, t.numel(), t.device, b.numel()))
        # each part padded to 8 bytes, so every view back is aligned
        pad = -b.numel() % 8
        parts += [b, b.new_zeros(pad)] if pad else [b]
    dev = tensors[0].device if tensors else torch.device("cpu")
    on_card = _STATE["backend"] == "nccl" and dev.type == "cuda"
    buf = torch.cat([p.to(dev) for p in parts]) if parts \
        else torch.zeros(0, dtype=torch.uint8)
    if not on_card:
        buf = buf.cpu()
    out = _all_gather_bytes(buf, None if on_card else _STATE["host_group"])
    ranks = []
    for p in range(n_proc):
        row, off, ts = out[p], 0, []
        for dtype, numel, device, nb in meta:
            ts.append(row[off: off + nb].view(dtype).to(device))
            off += nb + (-nb % 8)
        ranks.append(ts)
    shapes = [t.shape for t in tensors]
    return [_rebuild(obj, iter(t.reshape(s) for t, s in zip(ts, shapes)))
            for ts in ranks]


# -- statement order across the ranks -------------------------------------------

def statement_key(text: str) -> int:
    """The int64 key of a statement's canonical text: the same statement
    has the same key on every rank."""
    return int.from_bytes(hashlib.blake2b(text.encode(), digest_size=8)
                          .digest(), "little", signed=True)


class _Ticket:
    __slots__ = ("key", "granted")

    def __init__(self, key: int):
        self.key = key
        self.granted = False


class Sequencer:
    """The order in which statements over a partial store issue their
    collectives. Every rank must issue the same collectives in the same
    order, but a process may run statements from several threads (a
    storm, a server). A statement takes a turn (:meth:`turn`) keyed by its
    canonical text; the process runs one turn at a time, and the ranks
    agree on the next one: while no turn runs, one waiting thread of each
    rank gathers every rank's waiting keys (:func:`exchange_block`) and
    grants the smallest key that every rank waits for; if none is common
    yet, they gather again. Every rank sees the same gathered keys, so
    every rank grants the same statement. A process with no peers runs
    its turns at once."""

    POLL_S = 0.002

    def __init__(self):
        self._cv = threading.Condition()
        self._pending: List[_Ticket] = []
        self._busy = False             # a turn runs or a gather is open

    @contextlib.contextmanager
    def turn(self, key: int):
        if not is_multihost():
            yield
            return
        t = _Ticket(int(key))
        with self._cv:
            self._pending.append(t)
        self._wait(t)
        try:
            yield
        finally:
            with self._cv:
                self._busy = False
                self._cv.notify_all()

    def _wait(self, t: _Ticket) -> None:
        while True:
            with self._cv:
                while not t.granted and self._busy:
                    self._cv.wait()
                if t.granted:
                    return
                self._busy = True          # this thread gathers
                snap = list(self._pending)
            try:
                keys = exchange_block(np.array([x.key for x in snap],
                                               np.int64))
            except BaseException:
                with self._cv:
                    self._busy = False
                    self._pending.remove(t)
                    self._cv.notify_all()
                raise
            common = set(keys[0].tolist())
            for k in keys[1:]:
                common &= set(k.tolist())
            with self._cv:
                if common:
                    pick = min(common)
                    win = next(x for x in snap if x.key == pick)
                    self._pending.remove(win)
                    win.granted = True     # the turn runs: still busy
                else:
                    self._busy = False
                self._cv.notify_all()
                if t.granted:
                    return
            if not common:
                time.sleep(self.POLL_S)


#: the process's statement order over partial stores
SEQUENCER = Sequencer()
