"""Per-device unit costs of the group-by tiers.

Port of ``unit_cost`` from ``spark_druid_olap_tpu/parallel/cost.py`` (the
rest of that cost model is ROADMAP A.9). A unit cost is the configured
value when the key is set explicitly; otherwise the measured table of the
engine's device type. The JAX package's entry defaults are TPU
measurements and are used for neither device.

- ``cpu``: the JAX package's CPU-measured table (copied), so the port on
  the CPU takes the tiers the JAX package takes there.
- ``cuda``: measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
  by :func:`measure_unit_costs` (``scripts/torch_unit_costs.py``; phase
  ``hashed`` of ``chip_smoke.py`` measures it again and reports both).
  ``sort.payload`` is the time one more float64 sum adds per row on the
  sorted-run tier (its gather and segmented sum). The scatter's time per
  update depends on how many rows share a slot: the card's atomics
  serialize on one address, so a few groups over many rows cost far more
  per update than spread keys. It is kept as a curve over rows per slot
  and read at the gate's estimate (rows selected by the segment pruning
  over the groups they can form). The two costs cross between 1,465 and
  5,861 rows per slot: below, ``auto`` keeps the scatter tier; above, it
  takes the sorted-run tier.
"""

from __future__ import annotations

import math

import torch

_CPU_MEASURED = {
    "sdot.querycostmodel.sort.seconds.per.row": 3.0e-7,
    "sdot.querycostmodel.sort.payload.seconds.per.row": 1.0e-7,
    "sdot.querycostmodel.scatter.seconds.per.update": 4.0e-9,
    "sdot.querycostmodel.scatter.big.seconds.per.update": 1.5e-7,
    "sdot.querycostmodel.gather.seconds.per.probe": 2.0e-9,
}

# (rows per slot, seconds per update) of one float64 ``index_add_`` over
# 6,001,465 uniform keys into 4,194,304 ... 4 slots, rows per slot
# ascending (H100 80GB HBM3, 700.00 W; to 4 significant digits)
_CUDA_SCATTER_CURVE = (
    (1.431, 3.197e-11), (22.89, 1.647e-11), (366.3, 1.932e-11),
    (1465.0, 1.893e-11), (5861.0, 5.563e-11), (23440.0, 1.665e-10),
    (93770.0, 2.683e-10), (375100.0, 4.448e-10), (1500000.0, 7.639e-10))

_CUDA_MEASURED = {
    "sdot.querycostmodel.sort.payload.seconds.per.row": 4.725e-11,
    "sdot.querycostmodel.scatter.seconds.per.update": _CUDA_SCATTER_CURVE,
}

_MEASURED = {"cpu": _CPU_MEASURED, "cuda": _CUDA_MEASURED}

# the probe's shape: SF1 lineitem's row count; slot counts of the curve
PROBE_ROWS = 6_001_465
PROBE_PAYLOAD_SLOTS = 16_384
PROBE_SCATTER_SLOTS = (4, 16, 64, 256, 1024, 4096, 16384, 262144, 4194304)


def unit_cost(config, entry, device, rows_per_slot: float = 1.0) -> float:
    """The unit cost ``entry`` names on ``device``: the configured value
    when set explicitly (even to the default), else the device type's
    measured value, read at ``rows_per_slot`` where it is a curve."""
    if config.is_set(entry):
        return float(config.get(entry))
    kind = torch.device(device).type
    value = _MEASURED.get(kind, {}).get(entry.key)
    if value is None:
        raise KeyError(f"no measured {entry.key} for a {kind} device")
    if isinstance(value, tuple):
        return _on_curve(value, rows_per_slot)
    return float(value)


def _on_curve(curve, x: float) -> float:
    """Log-log interpolation of ``curve`` at ``x``, flat past its ends."""
    if x <= curve[0][0]:
        return float(curve[0][1])
    for (x0, y0), (x1, y1) in zip(curve, curve[1:]):
        if x <= x1:
            f = math.log(x / x0) / math.log(x1 / x0)
            return float(math.exp(math.log(y0)
                                  + f * (math.log(y1) - math.log(y0))))
    return float(curve[-1][1])


def measure_unit_costs(device, rows: int = PROBE_ROWS, seed: int = 0,
                       reps: int = 5) -> dict:
    """Measure the ``cuda`` table on ``device``: each unit cost is the
    slope between 1 and 5 float64 sums over ``rows`` uniform random keys,
    device time by CUDA events (median of ``reps`` after one warm-up).
    ``sort.payload`` over a table of ``PROBE_PAYLOAD_SLOTS``; the scatter
    at every slot count of ``PROBE_SCATTER_SLOTS``, as (rows per slot,
    seconds per update) pairs, rows per slot ascending."""
    from spark_druid_olap_tpu_torch.ops import groupby as G
    from spark_druid_olap_tpu_torch.ops import sorted_groupby as SG
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = [torch.rand(rows, generator=g, device=dev, dtype=torch.float64)
            for _ in range(5)]
    valid = torch.ones(rows, dtype=torch.bool, device=dev)

    def aggs(m):
        ins = [G.AggInput(f"s{i}", "sum", vals[i]) for i in range(m)]
        return ins, {a.name: G.Route(a.name, "sum", "f64") for a in ins}

    def slope(fn):
        ms = {m: _device_ms(lambda: fn(*aggs(m)), reps) for m in (1, 5)}
        return (ms[5] - ms[1]) * 1e-3 / (4 * rows), ms

    def keys(slots):
        return torch.randint(0, slots, (rows,), generator=g, device=dev,
                             dtype=torch.int32)
    key = keys(PROBE_PAYLOAD_SLOTS)
    zero = torch.zeros_like(key)
    payload, payload_ms = slope(lambda ins, routes: SG.sorted_hash_groupby(
        key, zero, valid, PROBE_PAYLOAD_SLOTS, ins, routes))
    curve, scatter_ms = [], {}
    for slots in PROBE_SCATTER_SLOTS:
        k = keys(slots)
        s, scatter_ms[slots] = slope(
            lambda ins, routes, k=k, slots=slots: G.scatter_groupby(
                k, slots, ins, routes))
        curve.append((rows / slots, s))
    curve.reverse()
    return {"sdot.querycostmodel.sort.payload.seconds.per.row": payload,
            "sdot.querycostmodel.scatter.seconds.per.update": curve,
            "rows": rows, "payload_ms": payload_ms,
            "scatter_ms": scatter_ms}


def _device_ms(fn, reps: int) -> float:
    """Median device ms of ``fn`` by CUDA events, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]
