"""Per-device unit costs and the estimates the engine's gates read.

Port of the JAX-free parts of ``spark_druid_olap_tpu/parallel/cost.py``
that the executor's gates read: ``unit_cost``, the filter-selectivity
estimate (``_filter_selectivity`` with ``_bound_overlap_fraction`` and
``_pattern_fraction``), ``bytes_per_segment`` and the wave plan
(``wave_budget_bytes``, ``tier_io_budget``, ``tier_io_seg_bytes``,
``plan_waves``). The rest of that cost model (single vs sharded,
explain's cost table) is ROADMAP A.9.

A unit cost is the configured value when the key is set explicitly;
otherwise the measured table of the engine's device type.

- ``cpu``: the JAX package's CPU-measured table (copied), else the
  entry's default, as the JAX package's ``unit_cost`` returns on its CPU
  backend; so the port on the CPU takes the decisions the JAX package
  takes there.
- ``cuda``: measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
  by :func:`measure_unit_costs` (``scripts/torch_unit_costs.py``; phase
  ``hashed`` of ``chip_smoke.py`` measures it again and reports both). No
  TPU default is used for the card: a key missing from the table raises.
  ``sort.payload`` is the time one more float64 sum adds per row on the
  sorted-run tier (its gather and segmented sum). The scatter's time per
  update depends on how many rows share a slot: the card's atomics
  serialize on one address, so a few groups over many rows cost far more
  per update than spread keys. It is kept as a curve over rows per slot
  and read at the gate's estimate (rows selected by the segment pruning
  over the groups they can form). The two costs cross between 1,465 and
  5,861 rows per slot: below, ``auto`` keeps the scatter tier; above, it
  takes the sorted-run tier. ``sort`` is the late-materialization
  compaction per scanned row (``ops/scan.compact_keep``), ``gather`` one
  probe of a compacted column read, ``scatter.big`` one float64 update
  into a table far past the 50 MB L2, ``fused`` the dense group-by
  kernel's (B1) time per row of a 5-aggregate pass.
"""

from __future__ import annotations

import math
import re
from collections import OrderedDict
from typing import Optional

import torch

from spark_druid_olap_tpu_torch.ir import spec as S

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

# H100 80GB HBM3, 700.00 W; to 4 significant digits
_CUDA_MEASURED = {
    "sdot.querycostmodel.sort.payload.seconds.per.row": 4.725e-11,
    "sdot.querycostmodel.scatter.seconds.per.update": _CUDA_SCATTER_CURVE,
    "sdot.querycostmodel.sort.seconds.per.row": 6.439e-11,
    "sdot.querycostmodel.gather.seconds.per.probe": 2.142e-11,
    "sdot.querycostmodel.scatter.big.seconds.per.update": 8.722e-11,
    "sdot.querycostmodel.fused.seconds.per.row": 3.302e-11,
}

_MEASURED = {"cpu": _CPU_MEASURED, "cuda": _CUDA_MEASURED}

# the probe's shape: SF1 lineitem's row count; slot counts of the curve
PROBE_ROWS = 6_001_465
PROBE_PAYLOAD_SLOTS = 16_384
PROBE_SCATTER_SLOTS = (4, 16, 64, 256, 1024, 4096, 16384, 262144, 4194304)
PROBE_BIG_SLOTS = 1 << 25          # 256 MB of float64, 5x the L2
PROBE_GATHER_M = 1 << 20           # compacted prefix of the gather probe
PROBE_FUSED_KEYS = 6               # Q1's key space


def unit_cost(config, entry, device, rows_per_slot: float = 1.0) -> float:
    """The unit cost ``entry`` names on ``device``: the configured value
    when set explicitly (even to the default), else the device type's
    measured value (read at ``rows_per_slot`` where it is a curve); on a
    cpu device an entry the table lacks reads its default, as in the JAX
    package."""
    if config.is_set(entry):
        return float(config.get(entry))
    kind = torch.device(device).type
    value = _MEASURED.get(kind, {}).get(entry.key)
    if value is None:
        if kind == "cpu":
            return float(entry.default)
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


# -- estimates ----------------------------------------------------------------

def _filter_selectivity(f: Optional[S.FilterSpec], ds) -> float:
    """Per-filter selectivity heuristics (the JAX package's
    ``_filter_selectivity``, ≈ the reference's)."""
    if f is None:
        return 1.0
    if isinstance(f, S.SelectorFilter):
        card = ds.cardinality(f.dimension) or 100
        return 1.0 / max(card, 1)
    if isinstance(f, S.BoundFilter):
        frac = _bound_overlap_fraction(f, ds)
        if frac is not None:
            return frac
        both = f.lower is not None and f.upper is not None
        return 0.25 if both else 0.5
    if isinstance(f, S.InFilter):
        card = ds.cardinality(f.dimension) or 100
        return min(1.0, len(f.values) / max(card, 1))
    if isinstance(f, S.PatternFilter):
        frac = _pattern_fraction(f, ds)
        return frac if frac is not None else 0.25
    if isinstance(f, S.NullFilter):
        return 0.9 if f.negated else 0.1
    if isinstance(f, S.LogicalFilter):
        sels = [_filter_selectivity(x, ds) for x in f.fields]
        if f.op == "and":
            out = 1.0
            for s_ in sels:
                out *= s_
            return out
        if f.op == "or":
            return min(1.0, sum(sels))
        return max(0.0, 1.0 - (sels[0] if sels else 0.0))
    return 0.5  # ExprFilter: unknown


_PATTERN_FRAC_BOUND = 256


def _pattern_fraction(f: S.PatternFilter, ds) -> Optional[float]:
    """Matching-dictionary fraction as the pattern's selectivity
    (uniform-frequency assumption). One regex pass over the dictionary,
    cached on the datasource (LRU-bounded)."""
    from spark_druid_olap_tpu_torch.ops import expr_compile as EC
    dim = getattr(ds, "dims", {}).get(f.dimension)
    if dim is None:
        return None
    cache = getattr(ds, "_pattern_frac_cache", None)
    if cache is None:
        cache = ds._pattern_frac_cache = OrderedDict()
    key = (f.dimension, f.kind, f.pattern)
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
        return hit
    vals = dim.dictionary
    n = len(vals)
    if n == 0:
        return None
    try:
        if f.kind == "like":
            rx = re.compile(EC.like_to_regex(f.pattern))
            cnt = sum(1 for s in vals if rx.match(s))
        elif f.kind == "regex":
            rx = re.compile(f.pattern)
            cnt = sum(1 for s in vals if rx.search(s))
        elif f.kind == "contains":
            cnt = sum(1 for s in vals if f.pattern in s)
        else:
            return None
    except re.error:
        return None
    frac = max(cnt / n, 1.0 / (2 * n))
    cache[key] = frac
    while len(cache) > _PATTERN_FRAC_BOUND:
        cache.popitem(last=False)
    return frac


def _bound_overlap_fraction(f: S.BoundFilter, ds) -> Optional[float]:
    """Range-overlap selectivity from column min/max metadata (DATE /
    LONG / DOUBLE metrics): |bound ∩ [min, max]| / |[min, max]|, assuming
    uniform density."""
    from spark_druid_olap_tpu_torch.ops import time_ops
    from spark_druid_olap_tpu_torch.segment.column import ColumnKind
    try:
        kind = ds.column_kind(f.dimension)
    except KeyError:
        return None
    if kind not in (ColumnKind.DATE, ColumnKind.LONG, ColumnKind.DOUBLE):
        return None
    m = ds.metrics.get(f.dimension)
    if m is None:
        return None
    mn, mx = m.min, m.max
    if mn is None or mx is None:
        return None
    lo_col, hi_col = float(mn), float(mx)
    if not (hi_col > lo_col):            # also rejects NaN bounds
        return None
    unit = 0.0 if kind == ColumnKind.DOUBLE else 1.0

    def conv(v):
        if v is None:
            return None
        if kind == ColumnKind.DATE:
            return float(time_ops.date_literal_to_days(v))
        return float(v)

    try:
        lo = conv(f.lower)
        hi = conv(f.upper)
    except (TypeError, ValueError):
        return None
    # half-open [lo_eff, hi_eff) over the column's [min, max + unit):
    # integer/date inclusive bounds widen by one unit; strict bounds
    # shift by one unit (measure-zero for DOUBLE, where unit = 0)
    lo = lo_col if lo is None else (lo + (unit if f.lower_strict else 0.0))
    hi = (hi_col + unit) if hi is None \
        else (hi + (0.0 if f.upper_strict else unit))
    lo = max(lo, lo_col)
    hi = min(hi, hi_col + unit)
    width = hi_col + unit - lo_col
    if width <= 0:
        return None
    return max(0.0, min(1.0, (hi - lo) / width))


def array_itemsize(ds, key: str) -> int:
    """Host itemsize of one stacked array."""
    from spark_druid_olap_tpu_torch.ops.scan import (
        NULL_VALID_PREFIX, ROW_VALID_KEY, TIME_MS_KEY)
    if key == ROW_VALID_KEY or key.startswith(NULL_VALID_PREFIX):
        return 1
    if key == TIME_MS_KEY:
        return int(ds.time.ms_dtype().itemsize)
    if key in ds.dims:
        return int(ds.dims[key].data_dtype().itemsize)
    if key in ds.metrics:
        return int(ds.metrics[key].data_dtype().itemsize)
    if ds.time is not None and key == ds.time.name:
        return int(ds.time.data_dtype().itemsize)
    return 4


def bytes_per_segment(ds, names) -> int:
    return int(ds.padded_rows) * sum(array_itemsize(ds, k) for k in names)


# -- waves --------------------------------------------------------------------

# the auto wave budget's share of a cuda device's memory: two waves are
# resident at once (the one computing and the next one's copy), beside the
# bind cache; the JAX package takes 0.6 of its device's HBM limit
CUDA_WAVE_MEMORY_SHARE = 0.3


def wave_budget_bytes(conf, device) -> Optional[int]:
    """Per-device byte budget for one wave's scan arrays (the JAX
    package's ``wave_budget_bytes``). The configured
    ``sdot.engine.wave.max.bytes`` wins; else, on a cuda device,
    ``CUDA_WAVE_MEMORY_SHARE`` of its memory; else None (one wave), as the
    JAX package reads a CPU backend."""
    from spark_druid_olap_tpu_torch.utils.config import WAVE_MAX_BYTES
    b = conf.get(WAVE_MAX_BYTES)
    if b:
        return int(b)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(device).total_memory
    return int(total * CUDA_WAVE_MEMORY_SHARE)


def tier_io_budget(ds, conf) -> Optional[int]:
    """Per-wave host-I/O byte cap of a tiered (cold) datasource (the JAX
    package's ``tier_io_budget``), None on an in-memory store. Every
    store of the port is in memory: the tiered store is ROADMAP A.9."""
    if getattr(ds, "tier", None) is None:
        return None
    raise NotImplementedError(
        "tiered datasource not ported yet (ROADMAP A.9)")


def tier_io_seg_bytes(ds, names) -> Optional[int]:
    """Per-segment host bytes one wave faults for the named scan keys on
    an encoded tiered store (the JAX package's ``tier_io_seg_bytes``),
    None elsewhere."""
    fn = getattr(ds, "host_bytes_per_segment", None)
    if fn is None:
        return None
    b = int(fn(names))
    return b if b > 0 else None


def plan_waves(n_segments: int, n_dev: int, seg_bytes: int,
               budget: Optional[int], conf, output_groups: int,
               n_aggs: int, io_budget: Optional[int] = None,
               io_seg_bytes: Optional[int] = None) -> tuple:
    """Segments per wave and the wave count (the JAX package's
    ``plan_waves``, verbatim). Every wave costs a dispatch plus a host
    merge of its [K] partials while scan and transport totals do not
    depend on the wave count, so the min-cost segments-per-wave is the
    largest ``n_dev`` multiple whose scan arrays for one device fit
    ``budget``; ``io_budget`` caps one wave's host bytes (all devices),
    over ``io_seg_bytes`` per segment (default ``seg_bytes``).

    Returns ``(segments_per_wave, n_waves)``; segments_per_wave is a
    multiple of ``n_dev``."""
    n_dev = max(1, n_dev)
    if n_segments <= 0:
        return n_dev, 1
    cap = -(-n_segments // n_dev) * n_dev
    if budget is not None and seg_bytes > 0:
        per_dev = int(budget // seg_bytes)
        cap = min(cap, max(1, per_dev) * n_dev)
    io_div = io_seg_bytes if io_seg_bytes is not None else seg_bytes
    if io_budget is not None and io_div > 0:
        per_wave = max(1, int(io_budget // io_div))
        cap = min(cap, -(-per_wave // n_dev) * n_dev)
    return cap, -(-n_segments // cap)


# -- measuring the cuda table -------------------------------------------------

def measure_unit_costs(device, rows: int = PROBE_ROWS, seed: int = 0,
                       reps: int = 5) -> dict:
    """Measure the ``cuda`` table on ``device``, device time by CUDA
    events (median of ``reps`` after one warm-up) over ``rows`` rows:

    - ``sort.payload`` and ``scatter`` (a curve), ``scatter.big``: the
      slope between 1 and 5 float64 sums over uniform random keys, per row
      and added sum; ``sort.payload`` into ``PROBE_PAYLOAD_SLOTS``, the
      scatter at every slot count of ``PROBE_SCATTER_SLOTS`` as (rows per
      slot, seconds per update) pairs, rows per slot ascending, and
      ``scatter.big`` into ``PROBE_BIG_SLOTS``;
    - ``sort``: the compaction (``ops/scan.compact_keep``) of a 1%-live
      validity mask, per scanned row;
    - ``gather``: the slope between 1 and 5 float64 columns read through
      ``PROBE_GATHER_M`` ascending row positions, per probe;
    - ``fused``: one launch of the dense group-by kernel over
      ``PROBE_FUSED_KEYS`` keys with a count and 4 float64 sums, per
      row."""
    from spark_druid_olap_tpu_torch.ops import cuda_groupby as CG
    from spark_druid_olap_tpu_torch.ops import groupby as G
    from spark_druid_olap_tpu_torch.ops import sorted_groupby as SG
    from spark_druid_olap_tpu_torch.ops.scan import compact_keep
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = [torch.rand(rows, generator=g, device=dev, dtype=torch.float64)
            for _ in range(5)]
    valid = torch.ones(rows, dtype=torch.bool, device=dev)

    def aggs(m):
        ins = [G.AggInput(f"s{i}", "sum", vals[i]) for i in range(m)]
        return ins, {a.name: G.Route(a.name, "sum", "f64") for a in ins}

    def slope(fn, n=rows):
        ms = {m: _device_ms(lambda: fn(*aggs(m)), reps) for m in (1, 5)}
        return (ms[5] - ms[1]) * 1e-3 / (4 * n), ms

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
    kbig = keys(PROBE_BIG_SLOTS)
    big, big_ms = slope(lambda ins, routes: G.scatter_groupby(
        kbig, PROBE_BIG_SLOTS, ins, routes))
    del kbig
    live = torch.rand(rows, generator=g, device=dev) < 0.01
    m = 1 << max(6, math.ceil(math.log2(max(rows * 0.02, 1.0))))
    sort_ms = _device_ms(lambda: compact_keep(live, m), reps)
    keep = torch.sort(torch.randperm(rows, generator=g, device=dev)[
        :PROBE_GATHER_M]).values
    gather_ms = {n: _device_ms(lambda n=n: [v[keep] for v in vals[:n]],
                               reps) for n in (1, 5)}
    fkey = keys(PROBE_FUSED_KEYS)
    fins = [G.AggInput("n", "count")] + aggs(4)[0]
    fused_ms = _device_ms(lambda: CG.dense_groupby_kernel(
        fkey, PROBE_FUSED_KEYS, fins, 64), reps)
    return {"sdot.querycostmodel.sort.payload.seconds.per.row": payload,
            "sdot.querycostmodel.scatter.seconds.per.update": curve,
            "sdot.querycostmodel.scatter.big.seconds.per.update": big,
            "sdot.querycostmodel.sort.seconds.per.row":
            sort_ms * 1e-3 / rows,
            "sdot.querycostmodel.gather.seconds.per.probe":
            (gather_ms[5] - gather_ms[1]) * 1e-3 / (4 * PROBE_GATHER_M),
            "sdot.querycostmodel.fused.seconds.per.row":
            fused_ms * 1e-3 / rows,
            "rows": rows, "payload_ms": payload_ms,
            "scatter_ms": scatter_ms, "scatter_big_ms": big_ms,
            "compact_ms": sort_ms, "compact_m": m, "gather_ms": gather_ms,
            "fused_ms": fused_ms}


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
