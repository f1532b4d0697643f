"""Chip smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — ``Context()`` -> ``ingest_dataframe`` ->
``execute(QuerySpec)`` -> the fused dense group-by CUDA kernel — over TPC-H
SF1 lineitem (~6M rows, generated from a seed by the port's own
``tools/tpch.py``), with TPC-H Q1 and Q6 written as QuerySpecs, and Q1's
grouping with 17 aggregates (more than one kernel launch takes), each checked
against a pandas oracle on the same frame, then the 8-query storm that the
shared-scan tier coalesces into one launch of the wave kernel. Its phase
``sql`` flattens the SF1 star (``tools/tpch.flatten``, 68 columns) and runs
eight TPC-H statements through ``Context.sql`` in engine mode against
pandas, four of them at once under shared scan (one wave launch), and a
census of the other benchmark statements (each one's mode, or the ROADMAP
item its ``NotImplementedError`` names). Its phase ``hashed`` drives the
wide-key path: the two unit costs the sorted-run gate compares, q7 on the
sorted-run and the scatter tier, q3 over the flat star (hashed tier,
device top-k) and ``basic_agg`` (9M keys, compacted table) against pandas,
the full star's top-k statements against the engine-free host tier, Q1
forced onto the hashed tier against its dense answer, and each step's
device time. Its phase ``tail`` drives what
earlier slices refused: q2, q16, q18 and q20 against pandas, q18's inner
group-by with device HAVING, on the host path and with a HAVING most
groups pass, q6 and q12 forced compacted (late materialization) against
their uncompacted runs with each compacted B1 launch held against its
plain version, q3 hashed with compaction, one overflow retry, a paged
select over lineitem with its mask on the device and on the host, and one
search. The census holds every statement in engine mode. Its phase
``sketch`` runs HLL, theta and KLL: one statement with all three (B1 and
the register ops), its registers against the plain version and its
estimates against pandas, then four sketch statements coalesced into one
wave launch whose theta stripe runs inside the kernel (held against the
plain version bit for bit) and whose HLL, KLL and wide theta run in the
epilogue, their answers equal to the solo answers. Its last phase,
``waves``, generates TPC-H SF5 lineitem (~30M rows; cut from SF10, whose
run passed 1,000 s) and runs Q1, the sketch statement, revenue by part on
the hashed tier, a HAVING with an ordered LIMIT and the storm under a wave
budget (``sdot.engine.wave.max.bytes``) that gives Q1 8 waves: each
statement in 4 or more waves against the same statement in one wave and
against pandas, every B1 / B2 launch of every wave against its plain
version, with per-wave bind, copy and compute times and the overlap share;
then Q1 in one wave under a bind-cache cap below its bound bytes. Before
that it builds every kernel of the path from the sources in this checkout and
holds each against its plain PyTorch version on the card: the dense
group-by in each fold tier that holds a case, the wave kernel in each
register-file layout that fits, every case launched twice and required
bit-identical. Each phase prints one JSON line (``timing`` holds each
pass's device time); the ``kernels`` line and the card's ``nvidia-smi``
name and power limit come before the last line, which is
``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; so does a machine without CUDA. The
script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20260729
SF = 1.0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data-sheet memory rate
PCIE_BYTES_PER_S = 64e9          # PCIe Gen5 x16, one direction (data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM data-sheet fp32 rate (no tensor cores)
FLOAT_SUM_RTOL_KERNEL = 1e-9     # both sides sum in f64; only the order differs
FLOAT_SUM_RTOL_ORACLE = 1e-6     # float metric columns are stored f32
REPEATS = 7
SLEEP_CYCLES = 4_000_000         # ~2 ms of sleep kernel at the H100's clock


# every JSON line also goes to this file, so the whole run is kept where
# only the end of standard output is (the directory is gitignored)
LOG = pathlib.Path(__file__).resolve().parent / "chiprun_out" \
    / "chip_smoke.jsonl"


def say(line: str) -> None:
    print(line, flush=True)
    LOG.parent.mkdir(exist_ok=True)
    with open(LOG, "a") as f:
        f.write(line + "\n")


def emit(phase: str, **fields) -> None:
    say(json.dumps({"phase": phase, **fields}, default=float))


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# -- kernel vs plain version --------------------------------------------------

def compare(case, got, want, inputs):
    """Exact for integers, counts and min/max; float sums to rtol 1e-9;
    NaN in the same groups on both sides. Returns the largest absolute
    float difference."""
    worst = 0.0
    for a in inputs:
        g, w = got[a.name], want[a.name]
        what = f"{case}/{a.name}"
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        if g.dtype.is_floating_point:
            nan = torch.isnan(w)
            if not torch.equal(torch.isnan(g), nan):
                raise AssertionError(f"{what}: NaN in other groups than "
                                     f"the plain version's")
            g, w = g[~nan], w[~nan]
        if a.kind == "sum" and g.dtype == torch.float64:
            err = (g - w).abs()
            worst = max(worst, float(err.max()) if err.numel() else 0.0)
            if not bool((err <= FLOAT_SUM_RTOL_KERNEL * w.abs()).all()):
                raise AssertionError(f"{what}: float sums differ beyond "
                                     f"rtol {FLOAT_SUM_RTOL_KERNEL}")
        elif not torch.equal(g, w):
            raise AssertionError(f"{what}: kernel and plain version differ")
    return worst


def same_bits(a, b) -> bool:
    """Two outputs (name -> tensor) equal bit for bit."""
    return a.keys() == b.keys() and all(
        torch.equal(a[k].view(torch.int64) if a[k].is_floating_point()
                    else a[k], b[k].view(torch.int64)
                    if b[k].is_floating_point() else b[k]) for k in a)


def kernel_cases(CG, dev):
    """Kernel vs plain version over the sizes, key counts, fold tiers and
    edge cases of the contract, each case launched twice (bit-identical);
    returns (cases run, largest float difference, tiers per case)."""
    from spark_druid_olap_tpu_torch.ops.groupby import AggInput as Agg
    rng = np.random.default_rng(SEED)
    cases, worst, tiers = 0, 0.0, {}

    def run(name, key, n_keys, inputs, check=None, max_keys=128):
        """Every tier that holds the launch's slots, against one plain
        version; each tier twice."""
        nonlocal cases, worst
        want = CG.dense_groupby_reference(key, n_keys, inputs)
        per_launch, chosen = CG.plan_launches(n_keys, len(inputs))
        ran = [t for t in CG.TIERS
               if CG.smem_bytes(n_keys * per_launch, t) <= CG.SMEM_LIMIT]
        for tier in ran:
            got = CG.dense_groupby_kernel(key, n_keys, inputs, max_keys,
                                          tier)
            again = CG.dense_groupby_kernel(key, n_keys, inputs, max_keys,
                                            tier)
            torch.cuda.synchronize()
            what = f"{name}[{tier}]"
            if not same_bits(got, again):
                raise AssertionError(f"{what}: two launches differ")
            worst = max(worst, compare(what, got, want, inputs))
            if check is not None:
                check(got)
        tiers[name] = {"chosen": chosen, "ran": ran}
        cases += 1
        return want

    def on(x):
        return torch.from_numpy(x).to(dev)

    for n in (1000, 70_000, 6_000_000):
        f32 = on(rng.random(n, dtype=np.float32))
        f64 = on(rng.random(n))
        i32 = on(rng.integers(-1000, 1000, n, dtype=np.int32))
        i64 = on(rng.integers(0, 2**40, n, dtype=np.int64))
        for n_keys in (1, 6, 64):
            # keys in [0, n_keys]: n_keys is the filtered-out sentinel
            key = on(rng.integers(0, n_keys + 1, n, dtype=np.int32))
            for masked in (False, True):
                m = on(rng.random(n) < 0.5) if masked else None
                m8 = on((rng.random(n) < 0.3).astype(np.uint8)) \
                    if masked else None
                inputs = [Agg("n", "count"), Agg("nm", "count", mask=m),
                          Agg("s32", "sum", f32, m),
                          Agg("s64", "sum", f64, m8),
                          Agg("si32", "sum", i32), Agg("si64", "sum", i64, m),
                          Agg("mn32", "min", f32, m),
                          Agg("mx64", "max", f64),
                          Agg("mni32", "min", i32, m8),
                          Agg("mxi64", "max", i64, m),
                          Agg("__rows__", "count")]
                run(f"n{n}_k{n_keys}_m{int(masked)}", key, n_keys, inputs)

    n = 6_000_000
    # integer sums far past 2^24 (one group takes every row)
    key = on(np.zeros(n, np.int32))
    big = on(rng.integers(0, 1000, n, dtype=np.int32))

    def past_2_24(got):
        if int(got["s"][0]) <= 2**24:
            raise AssertionError("int-sum case did not pass 2^24")
    run("int_sum_past_2_24", key, 1, [Agg("s", "sum", big)], past_2_24)

    # all rows masked out: counts and sums 0, extrema at their sentinels
    key = on(np.full(n, 6, np.int32))
    vals = on(rng.random(n, dtype=np.float32))
    ivals = on(rng.integers(0, 100, n, dtype=np.int32))

    def all_masked(got):
        if int(got["n"].sum()) != 0 or float(got["s"].abs().sum()) != 0.0 \
                or not bool((got["mn"] == float("inf")).all()) \
                or not bool((got["mx"] == CG.I64_MIN).all()):
            raise AssertionError("all-masked case is not empty")
    run("all_masked", key, 6,
        [Agg("n", "count"), Agg("s", "sum", vals), Agg("mn", "min", vals),
         Agg("mx", "max", ivals)], all_masked)

    # empty groups keep their sentinels (keys only in [0, 32) of 64)
    key = on(rng.integers(0, 32, 70_000, dtype=np.int32))
    v = on(rng.random(70_000, dtype=np.float32))
    iv = on(rng.integers(0, 100, 70_000, dtype=np.int32))

    def sentinels(got):
        if not (bool((got["mn"][32:] == float("inf")).all())
                and bool((got["mx"][32:] == float("-inf")).all())
                and bool((got["mni"][32:] == CG.I64_MAX).all())
                and bool((got["mxi"][32:] == CG.I64_MIN).all())
                and int(got["n"][32:].sum()) == 0):
            raise AssertionError("empty groups lost their sentinels")
    run("empty_group_sentinels", key, 64,
        [Agg("n", "count"), Agg("mn", "min", v), Agg("mx", "max", v),
         Agg("mni", "min", iv), Agg("mxi", "max", iv)], sentinels)

    # a NaN value makes its group's float min / max / sum NaN, unless a
    # mask drops it
    key = rng.integers(0, 6, 70_000, dtype=np.int32)
    v = rng.random(70_000)
    key[[10, 20, 30]] = [1, 2, 2]
    v[[10, 20, 30]] = np.nan
    keep = np.ones(70_000, bool)
    keep[[20, 30]] = False
    key, v, v32, keep = on(key), on(v), on(v.astype(np.float32)), on(keep)

    def nan_groups(got):
        for name in ("mn", "mx", "s", "mn32", "mx32"):
            if not bool(torch.isnan(got[name][1:3]).all()) \
                    or bool(torch.isnan(got[name][[0, 3, 4, 5]]).any()):
                raise AssertionError(f"{name}: NaN not in groups 1 and 2")
        if not bool(torch.isnan(got["mnm"][1])) \
                or bool(torch.isnan(got["mnm"][2])):
            raise AssertionError("a masked-out NaN reached its group")
    run("nan_min_max", key, 6,
        [Agg("mn", "min", v), Agg("mx", "max", v), Agg("s", "sum", v),
         Agg("mn32", "min", v32), Agg("mx32", "max", v32),
         Agg("mnm", "min", v, keep), Agg("mxm", "max", v32, keep)],
        nan_groups)

    # more aggregates than one launch takes: one launch per group of
    # MAX_AGGS, every group held against the plain version
    key = on(rng.integers(0, 7, n, dtype=np.int32))
    f32 = on(rng.random(n, dtype=np.float32))
    i32 = on(rng.integers(-1000, 1000, n, dtype=np.int32))
    m = on(rng.random(n) < 0.5)
    wide = [Agg(f"{kind}{j}", kind, None if kind == "count"
                else (f32 if j % 2 else i32), m if j % 3 == 0 else None)
            for j in range(6) for kind in CG.KINDS]
    run("wide_24_aggs", key, 6, wide)
    before = CG.launches
    CG.dense_groupby_kernel(key, 6, wide, 64)
    want_launches = -(-len(wide) // CG.MAX_AGGS)
    if CG.launches - before != want_launches:
        raise AssertionError(f"{len(wide)} aggregates took "
                             f"{CG.launches - before} launches, not "
                             f"{want_launches}")

    # the tiers' edges: one key for every row; every lane of a warp its
    # own key (K = 32 in both tiers, K = 64 with 16 aggregates in the warp
    # tier); K = 128 with 16 aggregates; row counts that are no multiple
    # of 256, below one block and below one warp
    def mixed(n, m):
        f = on(rng.normal(0.0, 100.0, n).astype(np.float32))
        d = on(rng.normal(0.0, 1e6, n))
        i = on(rng.integers(-10**6, 10**6, n, dtype=np.int32))
        mask = on(rng.random(n) < 0.6)
        pool = [Agg("n", "count"), Agg("nm", "count", mask=mask),
                Agg("sf", "sum", f), Agg("sd", "sum", d, mask),
                Agg("si", "sum", i), Agg("mnf", "min", f, mask),
                Agg("mxd", "max", d), Agg("mni", "min", i),
                Agg("mxi", "max", i, mask), Agg("sf2", "sum", f, mask),
                Agg("mnd", "min", d), Agg("mxf", "max", f),
                Agg("sd2", "sum", d), Agg("si2", "sum", i, mask),
                Agg("nm2", "count", mask=on(rng.random(n) < 0.1)),
                Agg("__rows__", "count")]
        return pool[:m - 1] + [pool[-1]]

    n = 6_000_000
    run("one_key_every_row", on(np.zeros(n, np.int32)), 1, mixed(n, 8))
    run("one_key_k6_every_row", on(np.full(n, 4, np.int32)), 6,
        mixed(n, 16))
    lane_keys = on((np.arange(n) % 32).astype(np.int32))
    run("warp_lanes_distinct_k32", lane_keys, 32, mixed(n, 3))
    lane_keys = on((np.arange(n) % 64).astype(np.int32))
    run("warp_lanes_distinct_k64_16aggs", lane_keys, 64, mixed(n, 16))
    if CG.plan_launches(64, 16) != (16, "warps"):
        raise AssertionError("K = 64 with 16 aggregates left the warp tier")
    run("k128_16aggs", on(rng.integers(0, 129, n, dtype=np.int32)), 128,
        mixed(n, 16))
    for rows in (100_003, 3001, 100, 31):
        run(f"n{rows}_k6", on(rng.integers(0, 7, rows, dtype=np.int32)), 6,
            mixed(rows, 12))
        run(f"n{rows}_k64", on(rng.integers(0, 65, rows, dtype=np.int32)),
            64, mixed(rows, 16))
    return cases, worst, tiers


# -- timing -------------------------------------------------------------------

_flush_buf = None


def flush_l2():
    """Evict the 50 MB L2 so each timed launch reads from device memory,
    as the main path's first read of a bound column does."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    _flush_buf.zero_()


def device_ms(fn, repeats=REPEATS, host_gap=False) -> float:
    """Median device time of ``fn`` over ``repeats`` cold-L2 calls, from
    CUDA events. A sleep kernel queued before the start event keeps the card
    busy while the host enqueues ``fn``'s launches, so the events span the
    device work; ``host_gap=True`` leaves it out (the method of the
    kernel's earlier numbers in PERF.md), and the span then also holds the
    host's enqueue time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        flush_l2()
        if not host_gap:
            torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_call(key, n_keys, inputs):
    """The same function from PyTorch's own calls, one per aggregate:
    ``torch.bincount(weights=...)`` for counts and sums, ``scatter_reduce_``
    for min/max. Timed as a yardstick only; the port never calls it."""
    k = key.long()
    for a in inputs:
        if a.kind == "count":
            w = None if a.mask is None else a.mask.to(torch.float64)
            torch.bincount(k, weights=w, minlength=n_keys + 1)
        elif a.kind == "sum":
            w = a.values.to(torch.float64)
            if a.mask is not None:
                w = w * a.mask
            torch.bincount(k, weights=w, minlength=n_keys + 1)
        else:
            v = a.values.to(torch.float64)
            torch.full((n_keys + 1,), 0.0, dtype=torch.float64,
                       device=key.device).scatter_reduce_(
                0, k, v, "amin" if a.kind == "min" else "amax")


def kernel_work(key, n_keys, inputs):
    """(bytes, operations) the function needs: each input read once, each
    output written once; two operations (select + combine) per row and
    aggregate."""
    nbytes = key.numel() * key.element_size() + n_keys * len(inputs) * 8
    for a in inputs:
        for t in (a.values, a.mask):
            if t is not None:
                nbytes += t.numel() * t.element_size()
    return nbytes, 2 * key.numel() * len(inputs)


def timed_execute(ctx, spec) -> float:
    """Host wall-clock ms of one query, to its result on the host."""
    t = time.perf_counter()
    ctx.execute(spec)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def profile_query(ctx, spec, counted) -> dict:
    """One warm run under torch.profiler: device busy time by kernel, and
    the device's idle share of the profiled wall time."""
    return profile_run(lambda: timed_execute(ctx, spec), counted)


def dev_us(e) -> float:
    """A profiler event's own device time, in us."""
    v = getattr(e, "self_device_time_total", None)
    return float(v if v is not None else e.self_cuda_time_total)


def pass_ms(fn, repeats=REPEATS) -> dict:
    """Device ms per launch of each pass (kernel) that ``fn`` launches:
    torch.profiler over ``repeats`` calls, L2 flushed before each; the
    flush itself is left out."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            flush_l2()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"(dense_groupby_\w+|wave_\w+)(<[^>]*>)?", e.key)
        if m and dev_us(e) > 0:
            out[m.group(0)] = dev_us(e) / 1e3 / e.count
    return out


def on_device(e) -> bool:
    """A profiler event that ran on the card (a kernel, copy or memset),
    not the host-side operator that launched it: an operator carries its
    kernels' device time too, so summing both counts it twice."""
    return str(getattr(e, "device_type", "")).rsplit(".", 1)[-1] == "CUDA"


def profiled(fn):
    """``fn()`` under torch.profiler (host and card); its result and the
    events that ran on the card, by their own device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    timed = [e for e in prof.key_averages() if dev_us(e) > 0]
    events = sorted((e for e in timed if on_device(e)), key=dev_us,
                    reverse=True)
    if timed and not events:
        raise AssertionError("profiler: device time but no device events")
    return out, events


def shows(events, kernel) -> bool:
    """Whether a kernel whose names start with ``kernel`` is among the
    events."""
    return any(re.search(rf"\b{kernel}_\w+", e.key) for e in events)


def profile_run(run, counted) -> dict:
    """``run()`` (which returns its host wall ms) once to warm up, then
    once under torch.profiler; device busy time sums the events that ran
    on the card. ``counted`` maps each kernel's name prefix to the module
    whose ``launches`` counts it. A profile with no device events, or
    without a kernel the run launched (named in ``missing_kernels``), lost
    device work: torch.profiler drops device records, PyTorch's own kernels
    too, in most profiles once a process has run for minutes
    (``scripts/torch_profiler_probe.py --wait 240``). Its busy time and
    idle share are then null; where they are not, the busy time is still a
    lower bound."""
    run()
    before = {k: m.launches for k, m in counted.items()}
    wall_ms, events = profiled(run)
    launched = {k: m.launches - before[k] for k, m in counted.items()}
    missing = [k for k, n in launched.items() if n and not shows(events, k)]
    busy_ms = None if missing or not events \
        else sum(dev_us(e) for e in events) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms
            if wall_ms and busy_ms is not None else None,
            "launches": launched, "missing_kernels": missing,
            "top": [{"name": e.key[:80], "calls": e.count,
                     "device_ms": dev_us(e) / 1e3} for e in events[:10]]}


def profiler_sees(probe, kernel, profiles=3) -> int:
    """Of ``profiles`` profiles of ``probe()``, how many show ``kernel``
    among the device events: taken at points along the run, it shows how
    far torch.profiler still records the card's work there."""
    return sum(shows(profiled(probe)[1], kernel) for _ in range(profiles))


# -- the main path ------------------------------------------------------------

def ms_of(day: str) -> int:
    return int(np.datetime64(day, "ms").astype(np.int64))


def q1_spec(S, E):
    C, L = E.Column, E.Literal
    disc = E.BinaryOp("*", C("l_extendedprice"),
                      E.BinaryOp("-", L(1), C("l_discount")))
    return S.GroupByQuerySpec(
        "lineitem",
        (S.DimensionSpec("l_returnflag", "l_returnflag"),
         S.DimensionSpec("l_linestatus", "l_linestatus")),
        (S.AggregationSpec("longsum", "sum_qty", field="l_quantity"),
         S.AggregationSpec("doublesum", "sum_base_price",
                           field="l_extendedprice"),
         S.AggregationSpec("doublesum", "sum_disc_price", expr=disc),
         S.AggregationSpec("doublesum", "sum_charge", expr=E.BinaryOp(
             "*", disc, E.BinaryOp("+", L(1), C("l_tax")))),
         S.AggregationSpec("doublesum", "sum_disc", field="l_discount"),
         S.AggregationSpec("count", "count_order")),
        post_aggregations=tuple(
            S.PostAggregationSpec(n, E.BinaryOp("/", C(s), C("count_order")))
            for n, s in (("avg_qty", "sum_qty"),
                         ("avg_price", "sum_base_price"),
                         ("avg_disc", "sum_disc"))),
        limit=S.LimitSpec((S.OrderByColumn("l_returnflag"),
                           S.OrderByColumn("l_linestatus"))),
        # l_shipdate <= date '1998-12-01' - interval '90' day
        intervals=((ms_of("1900-01-01"), ms_of("1998-09-03")),))


def q6_spec(S, E):
    C = E.Column
    return S.TimeseriesQuerySpec(
        "lineitem",
        (S.AggregationSpec("doublesum", "revenue", expr=E.BinaryOp(
            "*", C("l_extendedprice"), C("l_discount"))),),
        filter=S.LogicalFilter("and", (
            S.BoundFilter("l_discount", lower=0.05, upper=0.07,
                          numeric=True),
            S.BoundFilter("l_quantity", upper=24, upper_strict=True,
                          numeric=True))),
        intervals=((ms_of("1994-01-01"), ms_of("1995-01-01")),))


WIDE_COLUMNS = (("l_quantity", "long"), ("l_extendedprice", "double"),
                ("l_discount", "double"), ("l_tax", "double"))


def wide_spec(S, E):
    """Q1's grouping over every row with 17 aggregates: with the engine's
    row count that is 18, more than one kernel launch takes."""
    C, L = E.Column, E.Literal
    aggs = [S.AggregationSpec("count", "n")]
    for col, typ in WIDE_COLUMNS:
        aggs += [S.AggregationSpec(typ + fn, f"{fn}_{col}", field=col)
                 for fn in ("sum", "min", "max")]
    aggs += [
        S.AggregationSpec("count", "n_air", filter=S.InFilter(
            "l_shipmode", ("AIR", "MAIL"))),
        S.AggregationSpec("doublesum", "price_small",
                          field="l_extendedprice",
                          filter=S.BoundFilter("l_quantity", upper=10,
                                               numeric=True)),
        S.AggregationSpec("longmax", "max_qty_none", field="l_quantity",
                          filter=S.SelectorFilter("l_shipinstruct", "NONE")),
        S.AggregationSpec("doublesum", "sum_disc_price", expr=E.BinaryOp(
            "*", C("l_extendedprice"),
            E.BinaryOp("-", L(1), C("l_discount"))))]
    return S.GroupByQuerySpec(
        "lineitem",
        (S.DimensionSpec("l_returnflag", "l_returnflag"),
         S.DimensionSpec("l_linestatus", "l_linestatus")),
        tuple(aggs),
        limit=S.LimitSpec((S.OrderByColumn("l_returnflag"),
                           S.OrderByColumn("l_linestatus"))))


def wide_oracle(df):
    keys = ["l_returnflag", "l_linestatus"]
    d = df.assign(
        air=df["l_shipmode"].isin(["AIR", "MAIL"]),
        price_small=df["l_extendedprice"].where(df["l_quantity"] <= 10, 0.0),
        qty_none=df["l_quantity"].where(df["l_shipinstruct"] == "NONE"),
        disc=df["l_extendedprice"] * (1 - df["l_discount"]))
    spec = {"n": ("l_quantity", "size")}
    for col, _ in WIDE_COLUMNS:
        spec.update({f"{fn}_{col}": (col, fn) for fn in ("sum", "min",
                                                           "max")})
    spec.update(n_air=("air", "sum"), price_small=("price_small", "sum"),
                max_qty_none=("qty_none", "max"),
                sum_disc_price=("disc", "sum"))
    return d.groupby(keys).agg(**spec).reset_index() \
        .sort_values(keys).reset_index(drop=True)


def check_wide(got, want):
    """Integers and counts exact; float sums, and float min / max of the
    f32-stored columns, rtol 1e-6."""
    if list(got.columns) != list(want.columns) \
            or list(got["l_returnflag"]) != list(want["l_returnflag"]) \
            or list(got["l_linestatus"]) != list(want["l_linestatus"]):
        raise AssertionError("wide: groups or columns differ from the oracle")
    exact = ["n", "n_air", "max_qty_none"] + [
        f"{fn}_l_quantity" for fn in ("sum", "min", "max")]
    for c in want.columns[2:]:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if c in exact:
            if not np.array_equal(g.astype(np.int64), w.astype(np.int64)) \
                    or not np.array_equal(w, w.astype(np.int64)):
                raise AssertionError(f"wide {c} differs from the oracle")
        else:
            np.testing.assert_allclose(g, w, rtol=FLOAT_SUM_RTOL_ORACLE,
                                       err_msg=f"wide {c}")


def q1_oracle(df):
    d = df[df["l_shipdate"] <= np.datetime64("1998-09-02")]
    disc = d["l_extendedprice"] * (1 - d["l_discount"])
    g = d.assign(disc=disc, charge=disc * (1 + d["l_tax"])).groupby(
        ["l_returnflag", "l_linestatus"])
    return g.agg(sum_qty=("l_quantity", "sum"),
                 sum_base_price=("l_extendedprice", "sum"),
                 sum_disc_price=("disc", "sum"),
                 sum_charge=("charge", "sum"),
                 sum_disc=("l_discount", "sum"),
                 count_order=("l_quantity", "size")).reset_index() \
        .sort_values(["l_returnflag", "l_linestatus"]).reset_index(drop=True)


def q6_oracle(df):
    m = ((df["l_shipdate"] >= np.datetime64("1994-01-01"))
         & (df["l_shipdate"] < np.datetime64("1995-01-01"))
         & (df["l_discount"] >= 0.05) & (df["l_discount"] <= 0.07)
         & (df["l_quantity"] < 24))
    return float((df["l_extendedprice"] * df["l_discount"])[m].sum())


def check_q1(got, want):
    if list(got["l_returnflag"]) != list(want["l_returnflag"]) \
            or list(got["l_linestatus"]) != list(want["l_linestatus"]):
        raise AssertionError("Q1 groups differ from the oracle")
    for c in ("sum_qty", "count_order"):
        if not np.array_equal(got[c].to_numpy(), want[c].to_numpy()):
            raise AssertionError(f"Q1 {c} differs from the oracle")
    for c in ("sum_base_price", "sum_disc_price", "sum_charge", "sum_disc"):
        np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(),
                                   rtol=FLOAT_SUM_RTOL_ORACLE, err_msg=c)
    for avg, total in (("avg_qty", "sum_qty"),
                       ("avg_price", "sum_base_price"),
                       ("avg_disc", "sum_disc")):
        np.testing.assert_allclose(
            got[avg].to_numpy(),
            (want[total] / want["count_order"]).to_numpy(),
            rtol=1e-12 if total == "sum_qty" else FLOAT_SUM_RTOL_ORACLE,
            err_msg=avg)


# -- the wave kernel vs its plain version -------------------------------------

def synthetic_store(n, rng):
    """``n`` rows over 1995-1996 with int32, int64, float32 and float64
    metrics (the float64 one with NaNs; the int64 one large enough that a
    group's sum passes 2^53), two dimensions and a time column. Carried in
    with ``datasource_from_arrays``, which keeps the float64 column."""
    from spark_druid_olap_tpu_torch.segment.store import (
        datasource_from_arrays)
    f64 = rng.normal(0.0, 1000.0, n)
    f64[rng.random(n) < 1e-3] = np.nan
    seg = 1 << 20

    def dim(card, prefix):
        return {"kind": "dimension", "validity": None,
                "values": rng.integers(0, card, n).astype(np.int32),
                "dictionary": [f"{prefix}{i:02d}" for i in range(card)]}

    def met(kind, values):
        return {"kind": kind, "values": values, "validity": None}

    return datasource_from_arrays("synth", {
        "time": {"name": "ts", "millis": np.sort(rng.integers(
            ms_of("1995-01-01"), ms_of("1997-01-01"), n))},
        "segments": [(lo, min(lo + seg, n)) for lo in range(0, n, seg)],
        "columns": {
            "k6": dim(6, "a"), "k16": dim(16, "g"),
            "i32": met("long", rng.integers(-10**6, 10**6, n,
                                            dtype=np.int32)),
            "i64": met("long", rng.integers(0, 2**62 // n, n,
                                            dtype=np.int64)),
            "f32": met("double", rng.normal(0.0, 100.0, n)
                       .astype(np.float32)),
            "f64": met("double", f64)}})


def wave_specs(S, E, n_lanes):
    """``n_lanes`` distinct lanes over the synthetic store: every
    aggregate kind on every column type, dimension and granularity keys,
    selector / bound / expression / logical / interval filters, filtered
    aggregates, and one lane whose filter no row passes."""
    C, L = E.Column, E.Literal
    aggs = (S.AggregationSpec("count", "n"),
            S.AggregationSpec("longsum", "s64", field="i64"),
            S.AggregationSpec("longsum", "s32", field="i32"),
            S.AggregationSpec("doublesum", "sf32", field="f32"),
            S.AggregationSpec("doublesum", "sf64", field="f64"),
            S.AggregationSpec("doublemin", "mn64", field="f64"),
            S.AggregationSpec("doublemax", "mx64", field="f64"),
            S.AggregationSpec("doublemin", "mn32", field="f32"),
            S.AggregationSpec("longmin", "mni", field="i32"),
            S.AggregationSpec("longmax", "mxi", field="i64"),
            S.AggregationSpec("doublesum", "sf_pos", field="f64",
                              filter=S.BoundFilter("i32", lower=0,
                                                   numeric=True)),
            S.AggregationSpec("count", "n_c", filter=S.SelectorFilter(
                "k6", "a02")))
    filters = [
        None,
        S.BoundFilter("f32", lower=0, numeric=True),
        S.SelectorFilter("k6", "a03"),
        S.ExprFilter(E.Comparison("=", E.BinaryOp("%", C("i32"), L(3)),
                                  L(0))),
        S.LogicalFilter("or", (S.BoundFilter("f64", upper=-100,
                                             numeric=True),
                               S.SelectorFilter("k16", "g03"))),
        S.ExprFilter(E.Comparison(">", C("f32"), C("f32"))),  # no row
        S.LogicalFilter("not", (S.SelectorFilter("k16", "g07"),)),
        S.ExprFilter(E.Comparison("<", E.BinaryOp(
            "*", C("f32"), E.BinaryOp("-", L(1), C("f64"))), L(50.0)))]
    keys = [((S.DimensionSpec("k6", "k6"),), S.GRAN_ALL),
            ((S.DimensionSpec("k16", "k16"),), S.GRAN_ALL),
            ((), S.Granularity("month")),
            ((S.DimensionSpec("k6", "k6"),), S.Granularity("year"))]
    window = ((ms_of("1995-06-01"), ms_of("1996-02-15")),)
    out = []
    for i in range(n_lanes):
        dims, gran = keys[(i // 2) % len(keys)]
        out.append(S.GroupByQuerySpec(
            "synth", dims, aggs, filter=filters[i % len(filters)],
            granularity=gran, intervals=window if i >= 8 else None))
    return out


def compile_specs(eng, ds, specs, CW, FU):
    """Plan ``specs`` as one fused group of ``eng``'s coalescer and compile
    its lane program with its register-file layout, as the coalescer's
    build does; returns (program, layout, flat columns)."""
    co = eng.sharedscan
    plans, seg_u, min_day, max_day = co._plan_members(ds, specs)
    if seg_u is None or any(p is None for p in plans):
        raise AssertionError("a synthetic lane did not plan")
    by_sig = {}
    for lp in plans:
        by_sig.setdefault(lp.sig, lp)
    lanes = [by_sig[k] for k in sorted(by_sig)]
    cols, names = co._union(ds, lanes)
    fplan = FU.plan_lanes(
        [(lp.q.filter, lp.q.intervals, tuple(a.filter for a in lp.aggs))
         for lp in lanes], [len(lp.needed) for lp in lanes], len(cols))
    program, layout = CW.compile_wave(ds, lanes, min_day, max_day, fplan,
                                      union_names=names, tz="UTC")
    layout.file = CW.register_file(program, layout)
    if layout.file is None:
        raise AssertionError("a synthetic group needs more shared memory "
                             "than the wave kernel has")
    arrays = eng._bind_arrays(ds, names, seg_u)
    return program, layout, [arrays[k].reshape(-1) for k in program.columns]


def compare_wave(case, got, want, layout):
    """Exact for integers, counts and min/max; float sums to rtol 1e-9;
    NaN in the same groups on both sides. Returns the largest absolute
    float-sum difference."""
    worst = 0.0
    for li, (g_lane, w_lane, ls) in enumerate(zip(got, want, layout.lanes)):
        for name, kind, flt, _, _ in ls.aggs:
            g, w = g_lane[name], w_lane[name]
            what = f"{case}/lane{li}/{name}"
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"{what}: {g.dtype}{tuple(g.shape)} "
                                     f"vs {w.dtype}{tuple(w.shape)}")
            if g.dtype.is_floating_point:
                nan = torch.isnan(w)
                if not torch.equal(torch.isnan(g), nan):
                    raise AssertionError(f"{what}: NaN in other groups "
                                         f"than the plain version's")
                g, w = g[~nan], w[~nan]
            if kind == "sum" and flt:
                err = (g - w).abs()
                worst = max(worst, float(err.max()) if err.numel() else 0.0)
                if not bool((err <= FLOAT_SUM_RTOL_KERNEL * w.abs()).all()):
                    raise AssertionError(f"{what}: float sums differ "
                                         f"beyond rtol "
                                         f"{FLOAT_SUM_RTOL_KERNEL}")
            elif not torch.equal(g, w):
                raise AssertionError(f"{what}: kernel and plain version "
                                     f"differ")
        for name, _, _ in ls.thetas:
            # the theta stripe: float32 lane minima, bit for bit
            g, w = g_lane[name], w_lane[name]
            if g.dtype != w.dtype or g.shape != w.shape \
                    or not torch.equal(g.view(torch.int32),
                                       w.view(torch.int32)):
                raise AssertionError(f"{case}/lane{li}/{name}: the theta "
                                     f"stripe differs from the plain "
                                     f"version")
    return worst


def bits(lanes):
    return [{k: v.view(torch.int64) if v.dtype == torch.float64 else v
             for k, v in d.items()} for d in lanes]


def wave_checked(CW, case, program, layout, cols, want):
    """The wave kernel in every register-file layout that fits, each
    launched twice (the two bit-identical), each against the plain
    version's ``want``. Returns the answer in the layout the wave was built
    with and the largest float-sum difference."""
    default = layout.file
    worst, answer = 0.0, None
    for file in CW.FILE_LAYOUTS:
        if CW.smem_bytes(program, layout, file) > CW.SMEM_LIMIT:
            continue
        got = CW.wave_groupby(program, layout, cols, file)
        again = CW.wave_groupby(program, layout, cols, file)
        torch.cuda.synchronize()
        what = f"{case}[{file[0]} rows, {'shared' if file[1] else 'local'}]"
        if any(not torch.equal(a[k], b[k]) for a, b in
               zip(bits(got), bits(again)) for k in a):
            raise AssertionError(f"{what}: two launches differ")
        worst = max(worst, compare_wave(what, got, want, layout))
        if file == default:
            answer = got
    return answer, worst


def theta_specs(S):
    """Lanes with in-kernel theta stripes over the synthetic store: 2 keys
    (years) over int32 values and a DOUBLE's float32 bits, 4 keys (the
    quarter of the year, 256 stripe slots: the cap) over int64 values under
    an aggregate filter and over dictionary codes, and a 6-key lane whose
    theta (384 slots) and HLL run in the epilogue."""
    def theta(name, field, **kw):
        return S.AggregationSpec("thetasketch", name, field=field, **kw)
    return [
        S.TimeseriesQuerySpec("synth", (
            theta("t_i32", "i32"), theta("t_f32", "f32"),
            S.AggregationSpec("count", "n")),
            granularity=S.Granularity("year")),
        S.GroupByQuerySpec("synth", (S.DimensionSpec(
            "ts", "q", extraction=S.TimeExtraction("quarter")),), (
            theta("t_i64", "i64", filter=S.BoundFilter("i32", lower=0,
                                                       numeric=True)),
            theta("t_k16", "k16"),
            S.AggregationSpec("doublesum", "sf64", field="f64"))),
        S.GroupByQuerySpec("synth", (S.DimensionSpec("k6", "k6"),), (
            theta("t_wide", "i32"),
            S.AggregationSpec("cardinality", "u", field="i64"),
            S.AggregationSpec("longsum", "s32", field="i32")))]


def wave_cases(sdt, S, E, CW, FU):
    """The wave kernel against its plain version over the contract's sizes,
    lane counts, column types and edge cases, and with in-kernel theta
    stripes; returns (cases run, largest float-sum difference, [checks that
    ran])."""
    rng = np.random.default_rng(SEED + 1)
    eng = sdt.Context().engine
    cases, worst, checks = 0, 0.0, []
    for n in (1000, 70_000, 6_000_000):
        ds = synthetic_store(n, rng)
        eng.store.register(ds)
        for n_lanes in (1, 4, 16):
            specs = wave_specs(S, E, n_lanes)
            program, layout, cols = compile_specs(eng, ds, specs, CW, FU)
            case = f"n{n}_lanes{n_lanes}"
            want = CW.wave_reference(program, cols, layout)
            got, err = wave_checked(CW, case, program, layout, cols, want)
            worst = max(worst, err)
            cases += 1
            if n_lanes == 16:
                from spark_druid_olap_tpu_torch.parallel.sharedscan import (
                    _cache_repr)
                no_row = wave_specs(S, E, 6)[5].filter
                empty = [d for d, sp in zip(got, sorted(specs,
                                                        key=_cache_repr))
                         if sp.filter == no_row]
                for d in empty:
                    if int(d["__rows__"].sum()) != 0 \
                            or float(d["sf32"].abs().sum()) != 0.0 \
                            or not bool((d["mn64"] == float("inf")).all()) \
                            or not bool((d["mxi"] == CW.CG.I64_MIN).all()):
                        raise AssertionError(f"{case}: the all-masked lane "
                                             f"is not empty")
                if not empty:
                    raise AssertionError(f"{case}: no all-masked lane")
                checks.append(f"{case}: all-masked lanes empty")
                nan_groups = sum(int(torch.isnan(d["mn64"]).sum())
                                 for d in got)
                if n >= 70_000 and nan_groups == 0:
                    raise AssertionError(f"{case}: no NaN reached a float "
                                         f"min")
                big = max(int(d["s64"].max()) for d in got)
                if big <= 2**53:
                    raise AssertionError(f"{case}: no int sum past 2^53")
                checks.append(f"{case}: {nan_groups} NaN min groups, int "
                              f"sum {big} > 2^53")
        program, layout, cols = compile_specs(eng, ds, theta_specs(S), CW,
                                              FU)
        stripes = sorted(t[0] for ls in layout.lanes for t in ls.thetas)
        if stripes != ["t_f32", "t_i32", "t_i64", "t_k16"]:
            raise AssertionError(f"n{n}_theta: stripes {stripes}")
        want = CW.wave_reference(program, cols, layout)
        worst = max(worst, wave_checked(CW, f"n{n}_theta", program, layout,
                                        cols, want)[1])
        cases += 1
    checks.append("theta stripes (2 and 4 keys; int32, int64, float32 "
                  "bits, codes; an aggregate filter) equal the plain "
                  "version bit for bit")
    checks.append("every case in every register-file layout the shared "
                  "memory allows: two launches bit-identical, and equal to "
                  "the plain version")
    return cases, worst, checks


# -- the storm: 8 concurrent dashboard queries over SF1 lineitem --------------

STORM_CONFIG = {
    "sdot.sharedscan.enabled": True, "sdot.sharedscan.max.queries": 8,
    # the group closes as soon as the 8th query joins; the window only
    # has to outlast the threads' start skew
    "sdot.wlm.batch.window.ms": 2000.0,
    # the monthly lane groups by month over the group's whole day basis
    # (84 months at SF1), above the default 64-key tier of the fused
    # group-by kernel that wave lanes must ride
    "sdot.engine.groupby.pallas.max.keys": 128}


def storm_specs(S, E):
    """One dashboard over lineitem: 8 QuerySpecs that share the Q6
    discount bound (lanes 2, 5, 8) and ``l_returnflag = 'R'`` (4, 7)."""
    C = E.Column
    disc = S.BoundFilter("l_discount", lower=0.05, upper=0.07, numeric=True)
    rflag = S.SelectorFilter("l_returnflag", "R")
    q1_dims = (S.DimensionSpec("l_returnflag", "l_returnflag"),
               S.DimensionSpec("l_linestatus", "l_linestatus"))
    year = lambda y: ((ms_of(f"{y}-01-01"), ms_of(f"{y + 1}-01-01")),)
    return {
        "q1": q1_spec(S, E),
        "q6": q6_spec(S, E),
        "q1_mail_ship": S.GroupByQuerySpec(
            "lineitem", q1_dims,
            (S.AggregationSpec("longsum", "sum_qty", field="l_quantity"),
             S.AggregationSpec("doublesum", "sum_base_price",
                               field="l_extendedprice"),
             S.AggregationSpec("count", "n")),
            filter=S.LogicalFilter("or", (
                S.SelectorFilter("l_shipmode", "MAIL"),
                S.SelectorFilter("l_shipmode", "SHIP")))),
        "mode_year_r": S.GroupByQuerySpec(
            "lineitem", (S.DimensionSpec("l_shipmode", "l_shipmode"),),
            (S.AggregationSpec("count", "n"),
             S.AggregationSpec("longsum", "qty", field="l_quantity"),
             S.AggregationSpec("doublesum", "price",
                               field="l_extendedprice")),
            granularity=S.Granularity("year"), filter=rflag),
        "top_mode_1995": S.TopNQuerySpec(
            "lineitem", S.DimensionSpec("l_shipmode", "l_shipmode"),
            "revenue", 3,
            (S.AggregationSpec("doublesum", "revenue", expr=E.BinaryOp(
                "*", C("l_extendedprice"), C("l_discount"))),
             S.AggregationSpec("count", "n")),
            filter=disc, intervals=year(1995)),
        "monthly_1996": S.TimeseriesQuerySpec(
            "lineitem",
            (S.AggregationSpec("doublemin", "min_disc", field="l_discount"),
             S.AggregationSpec("doublemax", "max_disc", field="l_discount"),
             S.AggregationSpec("longmin", "min_qty", field="l_quantity"),
             S.AggregationSpec("longmax", "max_qty", field="l_quantity"),
             S.AggregationSpec("count", "n")),
            granularity=S.Granularity("month"), intervals=year(1996)),
        "status_r_dip": S.GroupByQuerySpec(
            "lineitem", (S.DimensionSpec("l_linestatus", "l_linestatus"),),
            (S.AggregationSpec("count", "n"),
             S.AggregationSpec("longsum", "qty", field="l_quantity")),
            filter=S.LogicalFilter("and", (rflag, S.SelectorFilter(
                "l_shipinstruct", "DELIVER IN PERSON")))),
        "flag_big_disc": S.GroupByQuerySpec(
            "lineitem", (S.DimensionSpec("l_returnflag", "l_returnflag"),),
            (S.AggregationSpec("count", "n"),),
            filter=S.LogicalFilter("and", (
                S.BoundFilter("l_quantity", lower=25, numeric=True),
                disc)))}


def storm_oracles(df):
    """pandas answers for :func:`storm_specs` on the same frame (keys,
    columns), each sorted by its keys."""
    sd = df["l_shipdate"]
    disc = (df["l_discount"] >= 0.05) & (df["l_discount"] <= 0.07)
    r = df["l_returnflag"] == "R"
    in_year = lambda y: (sd >= np.datetime64(f"{y}-01-01")) \
        & (sd < np.datetime64(f"{y + 1}-01-01"))
    q1k = ["l_returnflag", "l_linestatus"]
    out = {}
    d = df[df["l_shipmode"].isin(["MAIL", "SHIP"])]
    out["q1_mail_ship"] = (q1k, d.groupby(q1k).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        n=("l_quantity", "size")).reset_index())
    d = df[r].assign(timestamp=sd[r].dt.to_period("Y").dt.start_time
                     .astype("datetime64[ms]"))
    out["mode_year_r"] = (["timestamp", "l_shipmode"], d.groupby(
        ["timestamp", "l_shipmode"]).agg(
        n=("l_quantity", "size"), qty=("l_quantity", "sum"),
        price=("l_extendedprice", "sum")).reset_index())
    d = df[disc & in_year(1995)]
    top = d.assign(revenue=d["l_extendedprice"] * d["l_discount"]) \
        .groupby("l_shipmode").agg(revenue=("revenue", "sum"),
                                   n=("l_quantity", "size")) \
        .reset_index().sort_values("revenue", ascending=False).head(3)
    out["top_mode_1995"] = (None, top.reset_index(drop=True))
    d = df[in_year(1996)]
    d = d.assign(timestamp=d["l_shipdate"].dt.to_period("M").dt.start_time
                 .astype("datetime64[ms]"))
    out["monthly_1996"] = (["timestamp"], d.groupby("timestamp").agg(
        min_disc=("l_discount", "min"), max_disc=("l_discount", "max"),
        min_qty=("l_quantity", "min"), max_qty=("l_quantity", "max"),
        n=("l_quantity", "size")).reset_index())
    d = df[r & (df["l_shipinstruct"] == "DELIVER IN PERSON")]
    out["status_r_dip"] = (["l_linestatus"], d.groupby("l_linestatus").agg(
        n=("l_quantity", "size"), qty=("l_quantity", "sum")).reset_index())
    d = df[(df["l_quantity"] >= 25) & disc]
    out["flag_big_disc"] = (["l_returnflag"], d.groupby("l_returnflag").agg(
        n=("l_quantity", "size")).reset_index())
    return out


def check_frame(name, got, want, keys, rtol):
    """``want``'s columns in ``got``: keys and integers exact, floats to
    ``rtol`` (NaN where the other side has NaN)."""
    if keys:
        got = got.sort_values(keys).reset_index(drop=True)
        want = want.sort_values(keys).reset_index(drop=True)
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} rows, want {len(want)}")
    for c in want.columns:
        if c not in got.columns:
            raise AssertionError(f"{name}: no column {c}")
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if w.dtype.kind == "M":
            g, w = g.astype("datetime64[ms]"), w.astype("datetime64[ms]")
        if w.dtype.kind == "f" or g.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), rtol=rtol,
                                       equal_nan=True, err_msg=f"{name} {c}")
        elif not np.array_equal(g, w):
            raise AssertionError(f"{name} {c}: {g[:5]} vs {w[:5]}")


def run_storm(ctx, specs, call=None, stats_out=None):
    """Fire every spec (or, with ``call=ctx.sql``, every statement) at
    once from its own thread (barrier start); returns the frames, the ms
    from the first thread's start to the last answer, and the group's
    host phases (the leader's ``sharedscan`` stats). ``stats_out``, a
    list, receives each member's ``last_stats``."""
    call = call or ctx.execute
    import threading
    n = len(specs)
    res, errs, stats = [None] * n, [None] * n, [None] * n
    starts, ends = [0.0] * n, [0.0] * n
    bar = threading.Barrier(n)

    def worker(i):
        bar.wait()
        starts[i] = time.perf_counter()
        try:
            res[i] = call(specs[i]).to_pandas()
            stats[i] = dict(ctx.engine.last_stats)
        except BaseException as e:  # noqa: BLE001 — raised below
            errs[i] = e
        ends[i] = time.perf_counter()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise AssertionError("storm: a query thread never finished")
    for e in errs:
        if e is not None:
            raise e
    if stats_out is not None:
        stats_out.extend(stats)
    leader = [st["sharedscan"] for st in stats
              if st.get("sharedscan", {}).get("role") == "leader"]
    phases = dict(leader[0]["phases_ms"], held_ms=leader[0]["held_ms"]) \
        if leader else None
    return res, (max(ends) - min(starts)) * 1e3, phases


def wave_work(program, layout, columns):
    """(bytes, operations) of one wave: each union column read once, each
    slot written once; per row, the program's instructions, a select and a
    combine per lane aggregate, and per in-kernel theta its hash lanes'
    integer operations (``REGISTER_OPS_PER_ROW``)."""
    nbytes = sum(c.numel() * c.element_size() for c in columns) \
        + layout.n_slots * 8
    n = columns[0].numel()
    aggs = sum(ls.n_aggs for ls in layout.lanes)
    thetas = sum(len(ls.thetas) for ls in layout.lanes)
    return nbytes, n * (len(program.instrs) + 2 * aggs
                        + thetas * REGISTER_OPS_PER_ROW["theta"])


def bound(nbytes, ops):
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over the fp32 rate."""
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = ops / FP32_OPS_PER_S * 1e3
    return max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops else "operations"


def b1_checked(CG, case, calls) -> dict:
    """Each call a path made to the B1 wrapper, held against the plain
    version on the same inputs (launched twice, bit-identical) and timed as
    phase ``timing`` times the main path's queries; the sums and each
    call's shape and times."""
    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "library_ms": 0.0, "calls": []}
    for i, (key, n_keys, inputs, max_keys) in enumerate(calls):
        what = f"{case}[{i}]"

        def kernel():
            return CG.dense_groupby_kernel(key, n_keys, inputs, max_keys)

        def plain():
            return CG.dense_groupby_reference(key, n_keys, inputs)
        want = plain()
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        if not same_bits(got, again):
            raise AssertionError(f"{what}: two launches differ")
        err = compare(what, got, want, inputs)
        k_ms, p_ms = device_ms(kernel), device_ms(plain)
        l_ms = device_ms(lambda: library_call(key, n_keys, inputs))
        nbytes, ops = kernel_work(key, n_keys, inputs)
        b_ms, b_by = bound(nbytes, ops)
        per_launch = CG.plan_launches(n_keys, len(inputs))[0]
        out["calls"].append(dict(
            rows=int(key.numel()), n_keys=n_keys, n_aggs=len(inputs),
            aggs=sorted({a.kind for a in inputs}),
            masked=sum(a.mask is not None for a in inputs),
            launches=-(-len(inputs) // per_launch), max_abs_err=err,
            kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
            bound_by=b_by, kernel_bytes=nbytes))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["ms"] += k_ms
        out["plain_ms"] += p_ms
        out["bound_ms"] += b_ms
        out["library_ms"] += l_ms
    return out


def wave_timed(CW, case, program, layout, cols) -> dict:
    """A wave launch a path made, held against the plain version on the
    same inputs in every register-file layout that fits (each twice,
    bit-identical) and timed as phase ``timing`` times the storm's."""
    want = CW.wave_reference(program, cols, layout)
    err = wave_checked(CW, case, program, layout, cols, want)[1]
    nbytes, ops = wave_work(program, layout, cols)
    b_ms, b_by = bound(nbytes, ops)
    return dict(
        rows=int(cols[0].numel()), lanes=len(layout.lanes),
        instructions=len(program.instrs), registers=program.n_regs,
        columns=program.columns, register_file=layout.file,
        max_abs_err=err,
        ms=device_ms(lambda: CW.wave_groupby(program, layout, cols)),
        plain_ms=device_ms(lambda: CW.wave_reference(program, cols, layout)),
        bound_ms=b_ms, bound_by=b_by, union_bytes=nbytes)


# -- the SQL front end (phase "sql") ------------------------------------------

SQL_MAIN = ["shipdate_range", "q1", "q5", "q6", "q7", "q8", "q12", "q14"]
SQL_ORDERED = {"q1", "q5", "q7", "q8", "q12"}
# statements whose fused key space is above the dense group-by kernel's
# tier (sdot.engine.groupby.pallas.max.keys, 64; q7 groups 25 x 25 nations
# by 7 years): they launch no kernel and take the tier the sorted-run gate
# picks for medium K (the sorted-run tier, else the scatter tier), as the
# JAX engine does
SQL_MEDIUM_K = {"q7"}
SQL_STORM = ["q1", "q6", "shipdate_range", "q12"]
SQL_STORM_CONFIG = {
    "sdot.sharedscan.enabled": True, "sdot.sharedscan.max.queries": 4,
    # closes as soon as the 4th statement joins; the window only has to
    # outlast the threads' start skew and their planning
    "sdot.wlm.batch.window.ms": 2000.0}
ROADMAP_ITEM = r"not ported yet \(ROADMAP (A\.\d+)"


def _rev(df):
    return df.l_extendedprice * (1 - df.l_discount)


def sql_oracles(t, nr):
    """Pandas answers of the SQL phase's statements over the generator's
    tables (the forms of tests/test_tpch.py), by name."""
    import pandas as pd
    ts = pd.Timestamp
    li = t["lineitem"]
    out = {}
    d = li[(li.l_shipdate >= ts("1994-01-01"))
           & (li.l_shipdate <= ts("1997-01-01"))]
    out["shipdate_range"] = d.groupby(["l_returnflag", "l_linestatus"]) \
        .size().reset_index(name="count_order")
    d = li[li.l_shipdate <= ts("1998-12-01") - pd.Timedelta(days=90)]
    disc = _rev(d)
    d = d.assign(disc_price=disc, charge=disc * (1 + d.l_tax))
    out["q1"] = d.groupby(["l_returnflag", "l_linestatus"],
                          as_index=False).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"), sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"),
        avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"),
        count_order=("l_quantity", "size")) \
        .sort_values(["l_returnflag", "l_linestatus"]).reset_index(drop=True)
    d = (t["customer"]
         .merge(t["orders"], left_on="c_custkey", right_on="o_custkey")
         .merge(li, left_on="o_orderkey", right_on="l_orderkey")
         .merge(t["supplier"], left_on="l_suppkey", right_on="s_suppkey")
         .merge(nr["suppnation"], left_on="s_nationkey",
                right_on="sn_nationkey")
         .merge(nr["suppregion"], left_on="sn_regionkey",
                right_on="sr_regionkey"))
    d = d[(d.sr_name == "ASIA") & (d.o_orderdate >= ts("1994-01-01"))
          & (d.o_orderdate < ts("1995-01-01"))]
    out["q5"] = d.assign(revenue=_rev(d)).groupby(
        "sn_name", as_index=False).revenue.sum() \
        .sort_values("revenue", ascending=False).reset_index(drop=True)
    d = li[(li.l_shipdate >= ts("1994-01-01"))
           & (li.l_shipdate < ts("1995-01-01"))
           & (li.l_discount >= 0.05) & (li.l_discount <= 0.07)
           & (li.l_quantity < 24)]
    out["q6"] = pd.DataFrame(
        {"revenue": [(d.l_extendedprice * d.l_discount).sum()]})
    d = (t["supplier"]
         .merge(li, left_on="s_suppkey", right_on="l_suppkey")
         .merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
         .merge(t["customer"], left_on="o_custkey", right_on="c_custkey")
         .merge(nr["suppnation"], left_on="s_nationkey",
                right_on="sn_nationkey")
         .merge(nr["custnation"], left_on="c_nationkey",
                right_on="cn_nationkey"))
    d = d[(((d.sn_name == "FRANCE") & (d.cn_name == "GERMANY"))
           | ((d.sn_name == "GERMANY") & (d.cn_name == "FRANCE")))
          & (d.l_shipdate >= ts("1995-01-01"))
          & (d.l_shipdate <= ts("1996-12-31"))]
    out["q7"] = d.assign(l_year=d.l_shipdate.dt.year, revenue=_rev(d)) \
        .groupby(["sn_name", "cn_name", "l_year"], as_index=False) \
        .revenue.sum().sort_values(["sn_name", "cn_name", "l_year"]) \
        .reset_index(drop=True)
    d = (t["part"]
         .merge(li, left_on="p_partkey", right_on="l_partkey")
         .merge(t["supplier"], left_on="l_suppkey", right_on="s_suppkey")
         .merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
         .merge(t["customer"], left_on="o_custkey", right_on="c_custkey")
         .merge(nr["custnation"], left_on="c_nationkey",
                right_on="cn_nationkey")
         .merge(nr["custregion"], left_on="cn_regionkey",
                right_on="cr_regionkey")
         .merge(nr["suppnation"], left_on="s_nationkey",
                right_on="sn_nationkey"))
    d = d[(d.cr_name == "AMERICA") & (d.o_orderdate >= ts("1995-01-01"))
          & (d.o_orderdate <= ts("1996-12-31"))
          & (d.p_type == "ECONOMY ANODIZED STEEL")]
    rev = _rev(d)
    out["q8"] = d.assign(o_year=d.o_orderdate.dt.year, total_rev=rev,
                         brazil_rev=rev.where(d.sn_name == "BRAZIL", 0.0)) \
        .groupby("o_year", as_index=False).agg(
            brazil_rev=("brazil_rev", "sum"),
            total_rev=("total_rev", "sum")) \
        .sort_values("o_year").reset_index(drop=True)
    d = t["orders"].merge(li, left_on="o_orderkey", right_on="l_orderkey")
    d = d[d.l_shipmode.isin(["MAIL", "SHIP"])
          & (d.l_receiptdate >= ts("1994-01-01"))
          & (d.l_receiptdate < ts("1995-01-01"))]
    high = d.o_orderpriority.isin(["1-URGENT", "2-HIGH"])
    out["q12"] = d.assign(high_line_count=high.astype(np.int64),
                          low_line_count=(~high).astype(np.int64)) \
        .groupby("l_shipmode", as_index=False).agg(
            high_line_count=("high_line_count", "sum"),
            low_line_count=("low_line_count", "sum")) \
        .sort_values("l_shipmode").reset_index(drop=True)
    d = li.merge(t["part"], left_on="l_partkey", right_on="p_partkey")
    d = d[(d.l_shipdate >= ts("1995-09-01"))
          & (d.l_shipdate < ts("1995-10-01"))]
    rev = _rev(d)
    promo = rev.where(d.p_type.str.startswith("PROMO"), 0.0).sum()
    out["q14"] = pd.DataFrame({"promo_revenue": [100.0 * promo / rev.sum()]})
    return out


def check_sql(name, got, want):
    """Columns in order; rows in order where the statement orders them,
    else sorted by the non-float columns; ints exact, floats rtol 1e-6."""
    if list(got.columns) != list(want.columns):
        raise AssertionError(f"sql {name}: columns {list(got.columns)}, "
                             f"want {list(want.columns)}")
    keys = None if name in SQL_ORDERED else [
        c for c in want.columns if want[c].dtype.kind != "f"]
    check_frame(f"sql {name} vs pandas", got, want, keys,
                FLOAT_SUM_RTOL_ORACLE)


def timed_sql(ctx, sql):
    """Host wall-clock ms of one statement, to its frame on the host, and
    the statement's stats."""
    t = time.perf_counter()
    ctx.sql(sql).to_pandas()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, ctx.history.entries()[-1].stats


def plan_ms(stats) -> dict:
    """The statement's parse and plan.* host phases, ms."""
    return {k: v for k, v in (stats.get("phases") or {}).items()
            if k == "parse" or k.startswith("plan.")}


def engine_spent(ctx):
    """Host ms spent inside ``ctx.engine.execute`` (planning of the
    spec, bind, launches, decode and epilogue, to numpy on the host),
    appended per call until the returned ``stop()``."""
    spent, real = [], ctx.engine.execute

    def timed(q):
        t = time.perf_counter()
        try:
            return real(q)
        finally:
            spent.append((time.perf_counter() - t) * 1e3)
    ctx.engine.execute = timed
    return spent, lambda: delattr(ctx.engine, "execute")


def sql_phase(sdt, tables, lineitem_ds, CG, CW, smi):
    """TPC-H SF1 through ``Context.sql`` over the flattened star: the main
    statements (engine mode, B1 launches, pandas oracles, latencies and
    plan phases), four of them concurrently under shared scan (B2), and a
    census of the other queries once the base tables are in. Returns the
    B1 and B2 launches of its runs."""
    from spark_druid_olap_tpu_torch.tools import tpch
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    flat = tpch.flatten(tables)
    t_flat = time.perf_counter() - t0
    ctx = sdt.Context()
    t0 = time.perf_counter()
    ctx.ingest_dataframe("tpch_flat", flat, time_column="l_shipdate",
                         target_rows=1 << 20)
    t_ingest = time.perf_counter() - t0
    ctx.register_star_schema(tpch.star_schema("tpch_flat"))
    nr = tpch.nation_region_views(tables)
    oracles = sql_oracles(tables, nr)
    rows, flat_cols = len(flat), flat.shape[1]
    del flat

    b1 = b2 = 0
    stmts = {}
    real_kernel = CG.dense_groupby_kernel
    b1_calls = {}        # statement -> the B1 wrapper's inputs, per call
    for name in SQL_MAIN:
        sql = tpch.QUERIES[name]
        calls = b1_calls[name] = []

        def spy(key, n_keys, inputs, max_keys, calls=calls):
            calls.append((key, n_keys, list(inputs), max_keys))
            return real_kernel(key, n_keys, inputs, max_keys)
        CG.dense_groupby_kernel = spy
        try:
            CG.launches = 0
            cold_ms, st = timed_sql(ctx, sql)
            launched = CG.launches
        finally:
            CG.dense_groupby_kernel = real_kernel
        b1 += launched
        route = st.get("route") if name in SQL_MEDIUM_K else "kernel"
        if st["mode"] != "engine" or st.get("route") != route \
                or (launched < 1) == (route == "kernel") \
                or bool(calls) != (route == "kernel"):
            raise AssertionError(f"sql {name}: mode {st['mode']!r}, route "
                                 f"{st.get('route')!r} (want {route}), "
                                 f"{launched} dense_groupby launches")
        check_sql(name, ctx.sql(sql).to_pandas(), oracles[name])
        spent, stop = engine_spent(ctx)
        warm = [timed_sql(ctx, sql) for _ in range(REPEATS)]
        stop()
        stmts[name] = dict(cold_ms=cold_ms, cold_plan_ms=plan_ms(st),
                           warm_median_ms=statistics.median(
                               ms for ms, _ in warm),
                           warm_engine_median_ms=statistics.median(spent),
                           warm_plan_ms=plan_ms(warm[-1][1]),
                           dense_groupby_launches=launched, route=route,
                           groups=st.get("groups"))
    # planning cost with no memo and no plan cache, columns on the card
    ctx.config.set("sdot.plan.memo.enabled", False)
    ctx.config.set("sdot.plan.cache.enabled", False)
    for name in SQL_MAIN:
        runs = [timed_sql(ctx, tpch.QUERIES[name]) for _ in range(REPEATS)]
        phases = sorted({k for _, st in runs for k in plan_ms(st)})
        stmts[name]["replan_median_ms"] = statistics.median(
            ms for ms, _ in runs)
        stmts[name]["replan_plan_ms"] = {
            k: statistics.median(plan_ms(st).get(k, 0.0) for _, st in runs)
            for k in phases}
    ctx.config.set("sdot.plan.memo.enabled", True)
    ctx.config.set("sdot.plan.cache.enabled", True)
    for name in SQL_MAIN:
        prof = profile_run(lambda: timed_sql(ctx, tpch.QUERIES[name])[0],
                           {"dense_groupby": CG})
        stmts[name]["device_busy_ms"] = prof["device_busy_ms"]
        stmts[name]["device_idle_share"] = prof["device_idle_share"]
        stmts[name]["profiled_wall_ms"] = prof["wall_ms"]

    # four statements at once, coalesced by the shared-scan tier
    solo = {n: ctx.sql(tpch.QUERIES[n]).to_pandas() for n in SQL_STORM}
    for k, v in SQL_STORM_CONFIG.items():
        ctx.config.set(k, v)
    queries = [tpch.QUERIES[n] for n in SQL_STORM]
    run_storm(ctx, queries, call=ctx.sql)    # plans the statements once
    st0 = ctx.engine.sharedscan.stats()
    real_wave, waves = CW.wave_groupby, []

    def wave_spy(program, layout, columns):
        waves.append((program, layout, [c.reshape(-1) for c in columns]))
        return real_wave(program, layout, columns)
    CW.wave_groupby = wave_spy
    try:
        CW.launches = 0
        CG.launches = 0
        res, storm_ms, storm_phases = run_storm(ctx, queries, call=ctx.sql)
        torch.cuda.synchronize()
    finally:
        CW.wave_groupby = real_wave
    got = dict(zip(SQL_STORM, res))
    modes = [r.stats["mode"] for r in ctx.history.entries()[-len(queries):]]
    b2 += CW.launches
    b1 += CG.launches
    st1 = ctx.engine.sharedscan.stats()
    storm = {k: st1[k] - st0[k] for k in ("queries_coalesced",
                                          "wave_launches", "wave_fallbacks")}
    storm["wave_fallback_reasons"] = st1["wave_fallback_reasons"]
    storm.update(wave_kernel_launches=CW.launches,
                 dense_groupby_launches=CG.launches, wall_ms=storm_ms,
                 phases_ms=storm_phases, modes=modes)
    if storm["queries_coalesced"] != len(SQL_STORM) \
            or storm["wave_launches"] != 1 or CW.launches != 1 \
            or len(waves) != 1 or modes != ["engine"] * len(queries):
        raise AssertionError(f"sql storm: not {len(SQL_STORM)} statements "
                             f"in one wave launch: {storm}")
    for n in SQL_STORM:
        check_frame(f"sql storm {n} vs solo", got[n], solo[n], None,
                    FLOAT_SUM_RTOL_KERNEL)
    ctx.config.set("sdot.sharedscan.enabled", False)

    # the kernels at the shapes this phase gave them, against their plain
    # versions on the same inputs (launches here are not counted above)
    kernels = {"dense_groupby": {name: b1_checked(CG, f"sql {name}", calls)
                                 for name, calls in b1_calls.items()
                                 if calls},
               "wave": {"storm": wave_timed(CW, "sql storm", *waves[0])}}

    # the wide-key path over the flat star, before the base tables are in
    hashed = hashed_flat(ctx, tables, nr, ctx.device)
    # late materialization over the flat star (phase tail, first half)
    tail = tail_flat(ctx, oracles, tables, CG)

    # census: every other query once, over the whole star (the base
    # tables name what the flat table alone cannot resolve)
    t0 = time.perf_counter()
    ctx.store.register(lineitem_ds)
    for name, df in tables.items():
        if name not in ("nation", "region", "lineitem"):
            ctx.ingest_dataframe(
                name, df, time_column="o_orderdate" if name == "orders"
                else None, target_rows=1 << 20)
    for name, df in nr.items():
        ctx.ingest_dataframe(name, df, target_rows=1 << 20)
    ctx.ingest_dataframe("partsupp_flat", tpch.flatten_partsupp(tables),
                         target_rows=1 << 20)
    ctx.register_star_schema(tpch.partsupp_star_schema("partsupp_flat"))
    # re-registering drops the star's functional-dependency graph, built
    # before the dimension tables were in (setup_context registers last)
    ctx.register_star_schema(tpch.star_schema("tpch_flat"))
    t_base = time.perf_counter() - t0
    census = {}
    for name, sql in tpch.QUERIES.items():
        if name in SQL_MAIN:
            continue
        t0 = time.perf_counter()
        st = {}
        try:
            ctx.sql(sql).to_pandas()
            st = ctx.history.entries()[-1].stats
            outcome = st["mode"]
        except NotImplementedError as e:
            m = re.search(ROADMAP_ITEM, str(e))
            if m is None:
                raise
            outcome = f"refused: {m.group(1)} ({e})"
        census[name] = {"outcome": outcome,
                        "ms": (time.perf_counter() - t0) * 1e3,
                        **{k: st.get(k) for k in ("route", "hashed",
                                                  "topk_device")}}
    refused = {n: c["outcome"] for n, c in census.items()
               if c["outcome"].startswith("refused")}
    if refused:
        raise AssertionError(f"census: statements refused: {refused}")
    hashed.update(hashed_full(ctx, tables, census))
    tail.update(tail_full(ctx, tables, nr, census))
    sketch = sketch_phase(ctx, tables, CG, CW)
    emit("sql", card=smi, sf=SF, flat_rows=rows, flat_columns=flat_cols,
         flatten_s=t_flat, ingest_s=t_ingest, base_tables_ingest_s=t_base,
         statements=stmts, storm=storm, census=census, kernels=kernels,
         seconds=time.perf_counter() - t_phase,
         oracle="pandas on the generator's tables: ints exact, floats rtol "
                "1e-6; storm answers vs solo answers rtol 1e-9",
         note="latency: host wall clock to the frame on the host; cold = "
              "first statement (plan memo empty, columns uploaded); warm "
              "= median of 7 (memo warm), warm_engine the part inside "
              "engine.execute; replan = median of 7 with memo "
              "and plan cache off (columns on the card); plan_ms from "
              "utils/phases; device busy / idle: torch.profiler over one "
              "warm run; kernels: each B1 call of a statement's cold run "
              "and the storm's B2 launch, kernel vs plain version on the "
              "same inputs, times as in phase timing")
    return b1, b2, kernels, hashed, tail, sketch


# -- the wide-key aggregation path (phase "hashed") --------------------------

# Q1's 6 keys are above this dense ceiling: the QuerySpec goes hashed
HASH_FORCED = {"sdot.engine.groupby.dense.max.keys": 4}
HOST_ORACLE_BUDGET_S = 40.0      # host-tier checks of the full-star top-k
HOST_CHECKED = ["q3", "q10", "q21"]


def unit_costs(dev) -> dict:
    """The unit costs ``parallel/cost.py`` holds for a cuda device,
    measured again on this card (``cost.measure_unit_costs``: SF1
    lineitem's row count, uniform random keys, the slope between 1 and 5
    float64 sums), beside the held ones."""
    from spark_druid_olap_tpu_torch.parallel import cost
    return {"held": cost._CUDA_MEASURED,
            "measured": cost.measure_unit_costs(dev, seed=SEED)}


class HashSpy:
    """Records the engine's group-by device calls (slot sort, sorted-run
    or scatter aggregation, top-k gather, transfers) while it is
    installed."""

    def __init__(self):
        from spark_druid_olap_tpu_torch.ops import groupby as G
        from spark_druid_olap_tpu_torch.ops import hash_groupby as H
        from spark_druid_olap_tpu_torch.ops import sorted_groupby as SG
        from spark_druid_olap_tpu_torch.parallel import executor as X
        self.sites = [(H, "live_rows"), (SG, "sorted_hash_groupby"),
                      (H, "build_slots"),
                      (G, "dense_groupby"), (X, "_hash_topk_gather"),
                      (X, "_to_host")]
        self.calls = []

    def __enter__(self):
        self.real = {}
        for mod, name in self.sites:
            real = self.real[name] = getattr(mod, name)

            def spy(*args, _real=real, _name=name):
                out = _real(*args)
                self.calls.append((_name, args, out))
                return out
            setattr(mod, name, spy)
        return self

    def __exit__(self, *exc):
        for mod, name in self.sites:
            setattr(mod, name, self.real[name])

    def count(self, name) -> int:
        return sum(c[0] == name for c in self.calls)

    def counts(self) -> dict:
        """Calls per device function during the spied run."""
        return {name: self.count(name) for _, name in self.sites}


def hash_steps(spy) -> list:
    """Each hashed aggregation the spy saw, step by step on the card: the
    dead rows' drop, the slot sort, the aggregation (sorted-run scans, or
    slot scatter plus the scatter tier), the top-k gather and the one
    device-to-host copy, each with its bound (bytes each step must move
    over 3.35 TB/s; the copy's over PCIe's 64 GB/s)."""
    from spark_druid_olap_tpu_torch.ops import groupby as G
    from spark_druid_olap_tpu_torch.ops import hash_groupby as H
    from spark_druid_olap_tpu_torch.ops import sorted_groupby as SG
    from spark_druid_olap_tpu_torch.parallel import executor as X

    def nb(ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if t is not None)

    def step(fn, nbytes):
        return {"ms": device_ms(fn), "bound_ms":
                nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
    out = []
    for name, args, res in spy.calls:
        if name == "live_rows":
            valid, cols = args
            kept = res[0].numel()
            out.append({"step": "live_rows", "rows": valid.numel(),
                        "live": kept, **step(
                            lambda: H.live_rows(valid, cols),
                            nb([valid] + list(cols)) + sum(
                                kept * t.element_size() for t in res[1]
                                if t is not None))})
            continue
        if name == "sorted_hash_groupby":
            khi, klo, base, T, inputs, routes = args
            tier = "sorted"
        elif name == "build_slots":
            khi, klo, base, T = args
            tier = "scatter"
        else:
            continue
        n = base.numel()
        key_bytes = nb([khi, klo, base])
        sort_out = 8 * n + 8 * n + n + 4 * n     # packed, order, new, gid
        rec = {"tier": tier, "rows": n, "slots": int(T),
               "sort": step(lambda: H.sorted_keys(khi, klo, base),
                            key_bytes + sort_out)}
        if tier == "sorted":
            ins = nb([t for a in inputs for t in (a.values, a.mask)])
            tot = step(lambda: SG.sorted_hash_groupby(
                khi, klo, base, T, inputs, routes),
                key_bytes + ins + 8 * int(T) * (len(inputs) + 1))
            rec["aggregates"] = len(inputs)
            rec["aggregate"] = {"ms": tot["ms"] - rec["sort"]["ms"],
                                "whole_ms": tot["ms"],
                                "bound_ms": tot["bound_ms"]}
        else:
            rec["slots_step"] = step(lambda: H.build_slots(
                khi, klo, base, T), key_bytes + 4 * n + 8 * int(T))
            agg = next(c for c in spy.calls if c[0] == "dense_groupby"
                       and c[1][0] is res[0])
            slot, mask, _, inputs, routes, _ = agg[1]
            ins = nb([t for a in inputs for t in (a.values, a.mask)])
            rec["aggregates"] = len(inputs)
            rec["aggregate"] = step(lambda: G.dense_groupby(
                slot, mask, T, inputs, routes, 0),
                nb([slot, mask]) + ins + 8 * int(T) * len(inputs))
        out.append(rec)
    slots = {id(c[2][0]) for c in spy.calls if c[0] == "build_slots"}
    for name, args, res in spy.calls:
        if name == "dense_groupby" and id(args[0]) not in slots:
            key, mask, n_keys, inputs, routes, pallas_max = args
            ins = nb([t for a in inputs for t in (a.values, a.mask)])
            out.append({"tier": "dense", "rows": key.numel(),
                        "n_keys": n_keys, "aggregates": len(inputs),
                        "aggregate": step(lambda: G.dense_groupby(
                            key, mask, n_keys, inputs, routes, pallas_max),
                            nb([key, mask]) + ins
                            + 8 * n_keys * len(inputs))})
        if name == "_hash_topk_gather":
            tbl, routes, topk, T = args
            out.append({"step": "topk_gather", "slots": int(T),
                        "k_sel": topk[1], **step(
                            lambda: X._hash_topk_gather(tbl, routes, topk,
                                                        T),
                            nb(list(tbl.values())) + nb(list(res.values())))})
    last = next((c for c in reversed(spy.calls) if c[0] == "_to_host"),
                None)
    if last is not None:
        bufs = list(last[1][0].values())
        rec = step(lambda: X._to_host(last[1][0]), nb(bufs))
        rec["bound_ms"] = nb(bufs) / PCIE_BYTES_PER_S * 1e3
        out.append({"step": "copy_to_host", "rows": bufs[0].numel(),
                    **rec})
    return out


def spied_sql(ctx, sql):
    """One run of a statement under a HashSpy: (frame, stats, spy)."""
    with HashSpy() as spy:
        got = ctx.sql(sql).to_pandas()
    return got, ctx.history.entries()[-1].stats, spy


SORTEDRUN = "sdot.engine.groupby.hash.sortedrun"


def tier_choice(ctx, run, timed, check, repeats=REPEATS) -> dict:
    """One statement under ``auto`` and on each tier (``on``: sorted-run,
    ``off``: scatter), every answer held by ``check(mode, frame)``: per
    tier the warm ms, stats and device steps; the tier ``auto`` picked and
    whether it was the faster one. ``run()`` runs the statement once
    under a HashSpy -> (frame, stats, spy); ``timed()`` -> (ms, stats)."""
    out = {}
    try:
        for mode in ("auto", "on", "off"):
            ctx.config.set(SORTEDRUN, mode)
            got, st, spy = run()
            check(mode, got)
            rec = dict(route=st.get("route"), mode=st.get("mode"),
                       hashed=bool(st.get("hashed")),
                       hash_slots=st.get("hash_slots"),
                       hash_compact_k=st.get("hash_compact_k"),
                       compact_m=st.get("compact_m"),
                       topk_device=st.get("topk_device"),
                       groups=st.get("groups"), calls=spy.counts())
            if mode != "auto":
                warm = [timed() for _ in range(repeats)]
                rec.update(warm_median_ms=statistics.median(
                    ms for ms, _ in warm), phases_ms=warm[-1][1].get(
                        "phases"), steps=hash_steps(spy))
            out[mode] = rec
    finally:
        ctx.config.set(SORTEDRUN, "auto")
    if out["on"]["route"] != "sorted" or out["off"]["route"] != "scatter" \
            or out["auto"]["route"] not in ("sorted", "scatter"):
        raise AssertionError(f"tiers: {out}")
    faster = "sorted" if out["on"]["warm_median_ms"] \
        <= out["off"]["warm_median_ms"] else "scatter"
    out.update(auto_picks=out["auto"]["route"], faster=faster,
               auto_picked_faster=out["auto"]["route"] == faster)
    return out


def sql_tiers(ctx, sql, check, repeats=REPEATS) -> dict:
    """tier_choice of a SQL statement, each run in engine mode."""
    out = tier_choice(ctx, lambda: spied_sql(ctx, sql),
                      lambda: timed_sql(ctx, sql), check, repeats)
    if any(out[m]["mode"] != "engine" for m in ("auto", "on", "off")):
        raise AssertionError(f"not in engine mode: {out}")
    return out


def hashed_flat(ctx, tables, nr, dev) -> dict:
    """Phase ``hashed`` over the flat star, before the census brings the
    base tables in: unit costs; q7 (4,375 keys: dense scatter or the
    medium-K reroute) and q3 (3.6e9 keys: hashed, device top-k) under
    ``auto`` and on both tiers, against each other and q3 against pandas,
    with each step's device time."""
    from spark_druid_olap_tpu_torch.tools import tpch
    t0 = time.perf_counter()
    out = {"unit_costs": unit_costs(dev)}
    first = {}

    def same_as_first(label):
        def check(mode, got):
            if label not in first:
                first[label] = got
            else:
                check_frame(f"{label} ({mode}) vs auto", got, first[label],
                            None, FLOAT_SUM_RTOL_KERNEL)
        return check
    out["q7"] = sql_tiers(ctx, tpch.QUERIES["q7"], same_as_first("q7"))
    if not out["q7"]["on"]["hashed"] or out["q7"]["off"]["hashed"]:
        raise AssertionError(f"q7: the reroute is hashed, the dense "
                             f"scatter is not: {out['q7']}")
    want = q3_oracle(tables)

    def q3_check(mode, got):
        check_frame(f"q3 (flat, {mode}) vs pandas", got, want, None,
                    FLOAT_SUM_RTOL_ORACLE)
    out["q3_flat"] = q3 = sql_tiers(ctx, tpch.QUERIES["q3"], q3_check)
    for mode in ("auto", "on", "off"):
        if not q3[mode]["hashed"] or not q3[mode]["topk_device"]:
            raise AssertionError(f"q3 over the flat star ({mode}): {q3}")
    out["flat_seconds"] = time.perf_counter() - t0
    return out


def hashed_full(ctx, tables, census) -> dict:
    """Phase ``hashed`` after the census: ``basic_agg`` (9M keys: hashed,
    compacted) against pandas with its steps, and the full star's top-k
    statements against the port's engine-free host tier while the budget
    lasts."""
    from spark_druid_olap_tpu_torch.planner import host_exec as TH
    from spark_druid_olap_tpu_torch.sql.parser import parse_select
    from spark_druid_olap_tpu_torch.tools import tpch
    t_full = time.perf_counter()
    out = {}
    want = basic_agg_oracle(tables)

    def check(mode, got):
        check_frame(f"basic_agg ({mode}) vs pandas", got, want,
                    ["l_returnflag", "l_linestatus"], FLOAT_SUM_RTOL_ORACLE)
    out["basic_agg"] = ba = sql_tiers(ctx, tpch.QUERIES["basic_agg"], check,
                                      repeats=3)
    for mode in ("auto", "on", "off"):
        if not ba[mode]["hashed"] or not ba[mode]["hash_compact_k"]:
            raise AssertionError(f"basic_agg ({mode}): {ba}")
    t0, checked = time.perf_counter(), {}
    for name in HOST_CHECKED:
        if census[name]["outcome"] != "engine":
            raise AssertionError(f"{name}: {census[name]}")
        if time.perf_counter() - t0 > HOST_ORACLE_BUDGET_S:
            checked[name] = "not checked (host budget spent)"
            continue
        sql = tpch.QUERIES[name]
        eng = ctx.sql(sql).to_pandas()
        ctx.host_engine_assist = False
        try:
            t1 = time.perf_counter()
            host = TH.execute_select(ctx, parse_select(sql))
        finally:
            ctx.host_engine_assist = True
        check_frame(f"{name} engine vs host tier", eng, host, None,
                    FLOAT_SUM_RTOL_ORACLE)
        checked[name] = {"host_s": time.perf_counter() - t1}
    out["full_star_topk"] = checked
    out["full_seconds"] = time.perf_counter() - t_full
    return out


def q3_oracle(t):
    import pandas as pd
    df = (t["customer"]
          .merge(t["orders"], left_on="c_custkey", right_on="o_custkey")
          .merge(t["lineitem"], left_on="o_orderkey",
                 right_on="l_orderkey"))
    df = df[(df.c_mktsegment == "BUILDING")
            & (df.o_orderdate < pd.Timestamp("1995-03-15"))
            & (df.l_shipdate > pd.Timestamp("1995-03-15"))]
    res = df.assign(revenue=_rev(df)).groupby(
        ["o_orderkey", "o_orderdate", "o_shippriority"],
        as_index=False).revenue.sum()
    res = res.sort_values(["revenue", "o_orderdate"],
                          ascending=[False, True]).head(10)
    return res[["o_orderkey", "revenue", "o_orderdate",
                "o_shippriority"]].reset_index(drop=True)


def basic_agg_oracle(t):
    df = (t["lineitem"]
          .merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
          .merge(t["partsupp"], left_on=["l_partkey", "l_suppkey"],
                 right_on=["ps_partkey", "ps_suppkey"]))
    return df.groupby(["l_returnflag", "l_linestatus"], as_index=False).agg(
        count_order=("l_orderkey", "size"), s=("l_extendedprice", "sum"),
        m=("ps_supplycost", "max"), a=("ps_availqty", "mean"),
        od=("o_orderkey", "nunique"))


# -- device HAVING, late materialization, select and search (phase "tail") ---

COMPACT_FORCED = {"sdot.engine.scan.compact.min.rows": 0}
TAIL_REPEATS = 3
Q18_INNER = ("select l_orderkey, sum(l_quantity) as q from lineitem "
             "group by l_orderkey having sum(l_quantity) > {}")


class settings:
    """Config values set for a ``with`` block, the earlier ones restored
    after it."""

    def __init__(self, ctx, values):
        self.config, self.values = ctx.config, dict(values)

    def __enter__(self):
        self.held = {k: self.config.get(k) for k in self.values}
        for k, v in self.values.items():
            self.config.set(k, v)

    def __exit__(self, *exc):
        for k, v in self.held.items():
            self.config.set(k, v)


class CopySpy:
    """Counts the engine's device-to-host copies (``executor._to_host``)
    and their bytes, and times each compaction (``compact_keep``) on the
    card, while it is installed."""

    def __init__(self):
        from spark_druid_olap_tpu_torch.parallel import executor as X
        self.X = X
        self.copies, self.copy_bytes, self.compactions = 0, 0, []

    def __enter__(self):
        X = self.X
        self.real = (X._to_host, X.compact_keep)

        def to_host(out):
            self.copies += 1
            self.copy_bytes += sum(t.numel() * t.element_size()
                                   for t in out.values())
            return self.real[0](out)

        def keep(valid, m):
            self.compactions.append((valid, m))
            return self.real[1](valid, m)
        X._to_host, X.compact_keep = to_host, keep
        return self

    def __exit__(self, *exc):
        self.X._to_host, self.X.compact_keep = self.real

    def compaction_ms(self) -> list:
        """Each compaction seen, timed again on its own inputs (device ms,
        as phase timing times kernels), beside its bound: the mask read
        once, the [m] positions written once."""
        out = []
        for valid, m in self.compactions:
            nbytes = valid.numel() * valid.element_size() + 8 * m
            out.append({"rows": valid.numel(), "m": m,
                        "ms": device_ms(lambda: self.real[1](valid, m)),
                        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
        return out


def spied_run(ctx, sql, CG=None):
    """One statement under a CopySpy, B1's launch count zeroed just
    before and read just after, its calls to the B1 wrapper kept: (frame,
    stats, spy, B1 launches, B1 calls)."""
    calls = []
    real = CG.dense_groupby_kernel if CG is not None else None

    def b1_spy(key, n_keys, inputs, max_keys):
        calls.append((key, n_keys, list(inputs), max_keys))
        return real(key, n_keys, inputs, max_keys)
    if CG is not None:
        CG.dense_groupby_kernel = b1_spy
        CG.launches = 0
    try:
        with CopySpy() as spy:
            got = ctx.sql(sql).to_pandas()
            torch.cuda.synchronize()
        launched = CG.launches if CG is not None else 0
    finally:
        if CG is not None:
            CG.dense_groupby_kernel = real
    return got, dict(ctx.history.entries()[-1].stats), spy, launched, calls


def warm_ms(ctx, sql, repeats=TAIL_REPEATS):
    """Median warm ms of a statement and its last run's engine phases."""
    runs = [timed_sql(ctx, sql) for _ in range(repeats)]
    return statistics.median(ms for ms, _ in runs), runs[-1][1].get("phases")


COMPACT_MODES = {
    "compacted": dict(COMPACT_FORCED, **{"sdot.engine.scan.compact": True}),
    "uncompacted": {"sdot.engine.scan.compact": False}}


def compaction_pair(ctx, name, sql, check, CG, compacts, kernel) -> dict:
    """One statement forced compacted and uncompacted: each run once
    under the spies (its answer held by ``check``, the two held to each
    other, the compaction decision and the tier asserted), then warm ms
    of both in turns (compacted first on even rounds), medians of
    ``REPEATS``."""
    rec, frames = {}, {}
    for mode, conf in COMPACT_MODES.items():
        with settings(ctx, conf):
            got, st, spy, launched, calls = spied_run(ctx, sql, CG)
        check(got)
        if bool(st.get("compact_m")) != (mode == "compacted" and compacts) \
                or (st.get("route") == "kernel") != kernel \
                or (kernel and launched < 1):
            raise AssertionError(f"tail {name} ({mode}): {st}, "
                                 f"{launched} B1 launches")
        frames[mode] = got
        rec[mode] = dict(compact_m=st.get("compact_m"),
                         hashed=bool(st.get("hashed")),
                         b1_launches=launched,
                         b1_rows=[int(c[0].numel()) for c in calls],
                         copies=spy.copies, copy_bytes=spy.copy_bytes,
                         compaction=spy.compaction_ms(), calls=calls)
    check_frame(f"tail {name} compacted vs uncompacted", frames["compacted"],
                frames["uncompacted"], None, FLOAT_SUM_RTOL_KERNEL)
    runs = {mode: [] for mode in COMPACT_MODES}
    for i in range(REPEATS):
        order = list(COMPACT_MODES) if i % 2 == 0 \
            else list(reversed(COMPACT_MODES))
        for mode in order:
            with settings(ctx, COMPACT_MODES[mode]):
                runs[mode].append(timed_sql(ctx, sql)[0])
    for mode, ms in runs.items():
        rec[mode]["warm_median_ms"] = statistics.median(ms)
    return rec


def tail_flat(ctx, oracles, tables, CG) -> dict:
    """Phase ``tail`` over the flat star (before the census): q6 and q12
    forced compacted (``compact.min.rows`` 0) against ``scan.compact``
    false and pandas, each compacted B1 launch held against the plain
    version; q14, which has no row filter to compact on; q3 hashed,
    compacted against uncompacted and pandas; one overflow retry (a
    selectivity estimate of 1e-7)."""
    from spark_druid_olap_tpu_torch.parallel import cost
    from spark_druid_olap_tpu_torch.tools import tpch
    t0 = time.perf_counter()
    out, b1, kernels = {}, 0, {}
    want_q3 = q3_oracle(tables)
    for name in ("q6", "q12", "q14", "q3"):
        if name == "q3":
            def check(got):
                check_frame("tail q3 (flat) vs pandas", got, want_q3, None,
                            FLOAT_SUM_RTOL_ORACLE)
        else:
            def check(got, name=name):
                check_sql(name, got, oracles[name])
        # q14's only predicate is its shipdate interval, which prunes
        # segments and is no row filter: neither engine compacts it
        rec = compaction_pair(ctx, name, tpch.QUERIES[name], check, CG,
                              compacts=name != "q14", kernel=name != "q3")
        calls = rec["compacted"].pop("calls")
        rec["uncompacted"].pop("calls")
        if rec["compacted"]["compact_m"] and calls:
            b1 += rec["compacted"]["b1_launches"]
            kernels[name] = b1_checked(CG, f"tail {name} compacted", calls)
        out[name if name != "q3" else "q3_flat"] = rec
    # a selectivity estimate far too low: the budget overflows on the
    # card, the statement re-runs uncompacted with the same answer
    real = cost._filter_selectivity
    cost._filter_selectivity = lambda f, ds: 1e-7
    try:
        with settings(ctx, COMPACT_FORCED):
            got, st, spy, _, _ = spied_run(ctx, tpch.QUERIES["q6"])
    finally:
        cost._filter_selectivity = real
        ctx.engine._compact_overflowed.clear()
    check_sql("q6", got, oracles["q6"])
    if not st.get("compact_overflow") or st.get("compact_m"):
        raise AssertionError(f"tail overflow retry: {st}")
    out["overflow_retry"] = dict(statement="q6",
                                 compact_overflow=st["compact_overflow"],
                                 copies=spy.copies)
    out["flat_seconds"] = time.perf_counter() - t0
    return {"statements": out, "b1_launches": b1, "kernels": kernels}


def tail_oracles(t, nr):
    """Pandas answers of q2, q16, q18 and q20 (the forms of
    tests/test_tpch22.py)."""
    import pandas as pd
    eu = (t["partsupp"]
          .merge(t["supplier"], left_on="ps_suppkey", right_on="s_suppkey")
          .merge(nr["suppnation"], left_on="s_nationkey",
                 right_on="sn_nationkey")
          .merge(nr["suppregion"], left_on="sn_regionkey",
                 right_on="sr_regionkey"))
    eu = eu[eu.sr_name == "EUROPE"]
    df = t["part"].merge(eu, left_on="p_partkey", right_on="ps_partkey")
    df = df[(df.p_size == 15) & df.p_type.str.endswith("BRASS")]
    mins = eu.groupby("ps_partkey").ps_supplycost.min()
    df = df[df.ps_supplycost == df.p_partkey.map(mins)]
    df = df.sort_values(["s_acctbal", "sn_name", "s_name", "p_partkey"],
                        ascending=[False, True, True, True]).head(100)
    out = {"q2": df[["s_acctbal", "s_name", "sn_name", "p_partkey",
                     "p_mfgr", "s_address", "s_phone", "s_comment"]]
           .reset_index(drop=True)}
    df = t["partsupp"].merge(t["part"], left_on="ps_partkey",
                             right_on="p_partkey")
    df = df[(df.p_brand != "Brand#45")
            & ~df.p_type.str.startswith("MEDIUM POLISHED")
            & df.p_size.isin([49, 14, 23, 45, 19, 3, 36, 9])]
    bad = t["supplier"][t["supplier"].s_comment.str.contains(
        "Customer.*Complaints", regex=True)].s_suppkey
    df = df[~df.ps_suppkey.isin(bad)]
    res = df.groupby(["p_brand", "p_type", "p_size"], as_index=False) \
        .ps_suppkey.nunique()
    res.columns = ["p_brand", "p_type", "p_size", "supplier_cnt"]
    out["q16"] = res.sort_values(
        ["supplier_cnt", "p_brand", "p_type", "p_size"],
        ascending=[False, True, True, True]).reset_index(drop=True)
    li = t["lineitem"]
    big = li.groupby("l_orderkey").l_quantity.sum()
    big = big[big > 300].index
    df = (t["customer"]
          .merge(t["orders"], left_on="c_custkey", right_on="o_custkey")
          .merge(li, left_on="o_orderkey", right_on="l_orderkey"))
    df = df[df.o_orderkey.isin(big)]
    res = df.groupby(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                      "o_totalprice"], as_index=False).l_quantity.sum()
    out["q18"] = res.rename(columns={"l_quantity": "total_qty"}) \
        .sort_values(["o_totalprice", "o_orderdate"],
                     ascending=[False, True]).head(100) \
        .reset_index(drop=True)
    forest = t["part"][t["part"].p_name.str.contains("forest")].p_partkey
    ps = t["partsupp"][t["partsupp"].ps_partkey.isin(forest)]
    d = li[(li.l_shipdate >= pd.Timestamp("1994-01-01"))
           & (li.l_shipdate < pd.Timestamp("1995-01-01"))]
    half = d.groupby(["l_partkey", "l_suppkey"]).l_quantity.sum() * 0.5
    idx = pd.MultiIndex.from_arrays([ps.ps_partkey, ps.ps_suppkey])
    ps = ps[ps.ps_availqty.to_numpy() > half.reindex(idx).to_numpy()]
    supp = t["supplier"].merge(nr["suppnation"], left_on="s_nationkey",
                               right_on="sn_nationkey")
    supp = supp[(supp.sn_name == "CANADA")
                & supp.s_suppkey.isin(ps.ps_suppkey)]
    out["q20"] = supp[["s_name", "s_address"]].sort_values("s_name") \
        .reset_index(drop=True)
    return out


SELECT_COLUMNS = ("l_orderkey", "l_linenumber", "l_quantity", "l_discount",
                  "l_shipdate")
SELECT_PAGE = 1000


def tail_full(ctx, tables, nr, census) -> dict:
    """Phase ``tail`` after the census (every base table in): q2, q16,
    q18 and q20 against pandas; q18's inner group-by (1.5M keys) with
    device HAVING, on the host path, and with a HAVING most groups pass;
    a selective select over lineitem, paged, device mask against host
    mask and pandas; one search against pandas."""
    import pandas as pd
    from spark_druid_olap_tpu_torch.ir import spec as S
    from spark_druid_olap_tpu_torch.tools import tpch
    t0 = time.perf_counter()
    out = {}
    want = tail_oracles(tables, nr)
    for name in ("q2", "q16", "q18", "q20"):
        got, st, spy, _, _ = spied_run(ctx, tpch.QUERIES[name])
        check_frame(f"tail {name} vs pandas", got, want[name], None,
                    FLOAT_SUM_RTOL_ORACLE)
        out[name] = dict(mode=st["mode"], rows=len(got),
                         census=census[name]["outcome"],
                         cold_ms=census[name]["ms"])
    li = tables["lineitem"]
    sums = li.groupby("l_orderkey").l_quantity.sum()
    having = {}
    for label, lit, conf in (("device", 300, None),
                             ("host", 300, 1 << 30),
                             ("most_pass", 0, None)):
        sql = Q18_INNER.format(lit)
        with settings(ctx, {} if conf is None else {
                "sdot.engine.having.device.min.keys": conf}):
            got, st, spy, _, _ = spied_run(ctx, sql)
            ms, phases = warm_ms(ctx, sql)
        sel = sums[sums > lit]
        check_frame(f"tail q18 inner ({label}) vs pandas", got,
                    pd.DataFrame({"l_orderkey": sel.index.to_numpy(),
                                  "q": sel.to_numpy()}),
                    ["l_orderkey"], FLOAT_SUM_RTOL_ORACLE)
        hd = st.get("having_device", 0)
        if (label == "host") != (hd == 0) or st["mode"] != "engine" \
                or (label == "most_pass" and hd < len(sel)):
            raise AssertionError(f"tail q18 inner ({label}): {st}")
        having[label] = dict(having_device=hd, groups=len(got),
                             copies=spy.copies, copy_bytes=spy.copy_bytes,
                             warm_median_ms=ms, phases_ms=phases)
    out["q18_inner"] = having
    out["select"] = tail_select(ctx, li, S)
    sql = ("select l_shipmode, count(*) as n from lineitem "
           "where l_shipmode like '%AI%' group by l_shipmode")
    got, st, _, _, _ = spied_run(ctx, sql)
    ms, _ = warm_ms(ctx, sql)
    w = li[li.l_shipmode.str.contains("AI")].groupby(
        "l_shipmode").size().reset_index(name="n")
    check_frame("tail search vs pandas", got, w, ["l_shipmode"], 0)
    if not st.get("search_values"):
        raise AssertionError(f"tail search: not a search: {st}")
    out["search"] = dict(values=st["search_values"], warm_median_ms=ms)
    out["full_seconds"] = time.perf_counter() - t0
    return out


def tail_select(ctx, li, S) -> dict:
    """A selective select over lineitem (l_quantity = 50 and l_discount
    >= 0.09) as QuerySpecs: three pages and the whole selection, the mask
    on the device (the default) and on the host, against each other and
    the whole selection against pandas."""
    f = S.LogicalFilter("and", (
        S.BoundFilter("l_quantity", lower=50),
        S.BoundFilter("l_discount", lower=0.09)))

    def page(offset, size):
        return S.SelectQuerySpec("lineitem", SELECT_COLUMNS, filter=f,
                                 page_size=size, page_offset=offset)
    out = {}
    frames = {}
    for where, conf in (("device", None), ("host", 1 << 40)):
        with settings(ctx, {} if conf is None else {
                "sdot.select.device.min.rows": conf}):
            with CopySpy() as spy:
                pages = [ctx.execute(page(o, SELECT_PAGE)).to_pandas()
                         for o in (0, SELECT_PAGE, 5 * SELECT_PAGE)]
                whole = ctx.execute(page(0, 10 ** 9)).to_pandas()
            st = dict(ctx.engine.last_stats)
            runs = []
            for _ in range(TAIL_REPEATS):
                t = time.perf_counter()
                ctx.execute(page(SELECT_PAGE, SELECT_PAGE))
                runs.append((time.perf_counter() - t) * 1e3)
        if st.get("select_filter") != where:
            raise AssertionError(f"tail select ({where}): {st}")
        frames[where] = (pages, whole)
        out[where] = dict(copies=spy.copies, copy_bytes=spy.copy_bytes,
                          rows=len(whole),
                          page_warm_median_ms=statistics.median(runs),
                          bytes_scanned=st.get("bytes_scanned"))
    for i, (a, b) in enumerate(zip(*(frames[w][0] for w in frames))):
        check_frame(f"tail select page {i} device vs host", a, b, None, 0)
    keys = ["l_orderkey", "l_linenumber"]
    want = li[(li.l_quantity >= 50) & (li.l_discount >= 0.09)][
        list(SELECT_COLUMNS)]
    for w in frames:
        check_frame(f"tail select ({w}) vs pandas", frames[w][1], want,
                    keys, FLOAT_SUM_RTOL_ORACLE)
    return out


# -- the sketch aggregations (phase "sketch") ---------------------------------

# one statement with all three sketches beside a dense count: B1 for the
# count, then the three register ops (the fused key holds 3 x 2 = 6 keys,
# 4 of them occupied)
SKETCH_SOLO = ("select l_returnflag, l_linestatus, count(*) as n, "
               "approx_count_distinct(l_orderkey) as u_order, "
               "approx_count_distinct_theta(l_suppkey) as t_supp, "
               "percentile_approx(l_extendedprice, 0.5) as p50 "
               "from tpch_flat group by l_returnflag, l_linestatus")
# four statements coalesced into one wave launch: theta on 3 keys (3 x 64
# stripe slots, inside the kernel), theta on 7 keys (448 slots, past the
# 256-row cap: the epilogue), HLL and KLL (the epilogue)
SKETCH_STORM = {
    "theta_flag": "select l_returnflag, "
                  "approx_count_distinct_theta(l_partkey) as t_part, "
                  "count(*) as n from tpch_flat group by l_returnflag",
    "theta_mode": "select l_shipmode, "
                  "approx_count_distinct_theta(l_suppkey) as t_supp, "
                  "sum(l_quantity) as q from tpch_flat group by l_shipmode",
    "hll_status": "select l_linestatus, "
                  "approx_count_distinct(l_orderkey) as u_order, "
                  "count(*) as n from tpch_flat group by l_linestatus",
    "kll_flag": "select l_returnflag, "
                "percentile_approx(l_extendedprice, 0.9) as p90 "
                "from tpch_flat where l_shipdate >= date '1995-01-01' "
                "group by l_returnflag",
}
# the estimates against pandas, each about 3 standard errors: HLL (2^11
# registers, 1.04 / sqrt(2^11) = 2.3%) within 6.9%, theta (k = 64, ~12.5%)
# within 40%, KLL's estimate at a rank within sdot.quantile.rank_bound of
# its fraction. The reference's HLL hash (the murmur3 finalizer alone) runs
# -4.2% and -5.9% on two of SF1's four (l_returnflag, l_linestatus) groups
# of l_orderkey, where a splitmix64 hash of the same keys gives +1.5% and
# -2.4% (tools/hll_bias.py); the port keeps the reference's
# registers bit for bit (a cluster merges raw registers), so its hash too
HLL_REL_BOUND = 3 * 1.04 / 2 ** 5.5
THETA_REL_BOUND = 0.40
# integer operations per row, counted from each op's steps (ops/hll.py,
# ops/theta.py, ops/kll.py): HLL one murmur finalizer (8), register and
# rho (5), the fused index and the max (3); theta the shared multiply, then
# per hash lane the seed xor, a murmur round pair (8), the float part (3),
# the index and the min (2); KLL three mixes (27), the salt (3), lane and
# level (7), tie (3), two indexed mins and a count (5)
REGISTER_OPS_PER_ROW = {"hll": 16, "theta": 1 + 64 * 14, "kll": 45}


def sketch_estimates_check(name, got, df, keys, cols, rank_bound):
    """Each sketch column of ``got`` (grouped by ``keys``) against pandas
    over the statement's rows ``df``: ``cols`` maps the column to (kind,
    source column, fraction). Returns the worst relative error per kind
    and, for KLL, the worst distance of the estimate's rank interval from
    the fraction."""
    worst = {}
    groups = {(k if isinstance(k, tuple) else (k,)): g
              for k, g in df.groupby(keys)} if keys else {(): df}
    for _, row in got.iterrows():
        k = tuple(row[c] for c in keys)
        part = groups[k]
        for c, (kind, src, q) in cols.items():
            if kind == "kll":
                v = part[src].to_numpy(np.float64)
                est = float(row[c])
                lo, hi = (v < est).mean(), (v <= est).mean()
                off = max(0.0, lo - q, q - hi)
                worst["kll_rank"] = max(worst.get("kll_rank", 0.0), off)
                if off > rank_bound:
                    raise AssertionError(
                        f"{name} {c} {k}: estimate {est} at rank "
                        f"[{lo:.4f}, {hi:.4f}], fraction {q} +- {rank_bound}")
                continue
            exact = part[src].nunique()
            rel = abs(int(row[c]) - exact) / exact
            worst[kind] = max(worst.get(kind, 0.0), rel)
            bound_ = HLL_REL_BOUND if kind == "hll" else THETA_REL_BOUND
            if rel > bound_:
                raise AssertionError(f"{name} {c} {k}: {int(row[c])} vs "
                                     f"{exact} distinct ({rel:.4f} > "
                                     f"{bound_})")
    return worst


def register_ops_checked(captured, real) -> dict:
    """Each register op the solo statement ran, again on the card (twice,
    bit-identical) and on the host over the same inputs copied there (the
    plain version: the same PyTorch function on the CPU), registers bit
    for bit; device ms beside the bound of the bytes it must move (inputs
    read once, registers written once) and its integer operations."""
    out = {}
    for kind, (args, kw) in captured.items():
        fn = real[kind]
        got, again = fn(*args, **kw), fn(*args, **kw)
        host = fn(*[a.cpu() if torch.is_tensor(a) else a for a in args],
                  **kw)
        torch.cuda.synchronize()
        g = got.cpu()
        for a, b, what in ((got, again, "two runs"), (g, host, "host")):
            if a.dtype != b.dtype or not torch.equal(
                    a.view(torch.int32).cpu(), b.view(torch.int32).cpu()):
                raise AssertionError(f"sketch {kind} registers: card vs "
                                     f"{what} differ")
        tensors = [a for a in args if torch.is_tensor(a)]
        rows = int(tensors[0].numel())
        nbytes = sum(t.numel() * t.element_size() for t in tensors) \
            + got.numel() * got.element_size()
        ops = rows * REGISTER_OPS_PER_ROW[kind]
        b_ms, b_by = bound(nbytes, ops)
        out[kind] = dict(
            rows=rows, n_keys=int(got.shape[0]), width=int(got.shape[1]),
            dtype=str(got.dtype).replace("torch.", ""),
            value_dtype=str(tensors[2].dtype).replace("torch.", ""),
            device_ms=device_ms(lambda: fn(*args, **kw)), bound_ms=b_ms,
            bound_by=b_by, bytes=nbytes, int_ops=ops)
    return out


def sketch_phase(ctx, tables, CG, CW) -> dict:
    """Phase ``sketch`` over the flat star: the solo statement (B1 and the
    three register ops), its registers against the plain version and its
    estimates against pandas; the four-statement storm in ONE wave launch,
    the in-kernel theta stripe against the plain version in every
    register-file layout that fits, the storm's answers equal to the solo
    answers and its estimates against pandas; device times beside bounds."""
    from spark_druid_olap_tpu_torch.ops import hll as HLL
    from spark_druid_olap_tpu_torch.ops import kll as KLL
    from spark_druid_olap_tpu_torch.ops import theta as TH
    from spark_druid_olap_tpu_torch.utils.config import QUANTILE_RANK_BOUND
    t_phase = time.perf_counter()
    li = tables["lineitem"]
    eps = float(ctx.config.get(QUANTILE_RANK_BOUND))
    out = {}

    # 1. solo: B1 for the count, the three register ops after it
    mods = {"hll": (HLL, "hll_registers"), "theta": (TH, "theta_registers"),
            "kll": (KLL, "kll_registers")}
    real = {k: getattr(m, f) for k, (m, f) in mods.items()}
    captured, b1_calls = {}, []
    real_kernel = CG.dense_groupby_kernel

    def spy(kind):
        def run(*args, **kw):
            captured.setdefault(kind, (args, kw))
            return real[kind](*args, **kw)
        return run

    def b1_spy(key, n_keys, inputs, max_keys):
        b1_calls.append((key, n_keys, list(inputs), max_keys))
        return real_kernel(key, n_keys, inputs, max_keys)
    for k, (m, f) in mods.items():
        setattr(m, f, spy(k))
    CG.dense_groupby_kernel = b1_spy
    try:
        CG.launches = 0
        cold_ms, st = timed_sql(ctx, SKETCH_SOLO)
        b1 = CG.launches
    finally:
        for k, (m, f) in mods.items():
            setattr(m, f, real[k])
        CG.dense_groupby_kernel = real_kernel
    if st["mode"] != "engine" or b1 < 1 or set(captured) != set(mods):
        raise AssertionError(f"sketch solo: mode {st['mode']!r}, {b1} B1 "
                             f"launches, register ops {sorted(captured)}")
    got = ctx.sql(SKETCH_SOLO).to_pandas()
    keys = ["l_returnflag", "l_linestatus"]
    want_n = li.groupby(keys).size()
    if sorted(zip(got.l_returnflag, got.l_linestatus, got.n)) != sorted(
            (a, b, int(c)) for (a, b), c in want_n.items()):
        raise AssertionError("sketch solo: counts differ from pandas")
    solo_err = sketch_estimates_check(
        "sketch solo", got, li, keys,
        {"u_order": ("hll", "l_orderkey", None),
         "t_supp": ("theta", "l_suppkey", None),
         "p50": ("kll", "l_extendedprice", 0.5)}, eps)
    warm = [timed_sql(ctx, SKETCH_SOLO)[0] for _ in range(REPEATS)]
    out["solo"] = dict(
        statement=SKETCH_SOLO, groups=len(got), cold_ms=cold_ms,
        warm_median_ms=statistics.median(warm), dense_groupby_launches=b1,
        worst_error=solo_err,
        estimates=got.drop(columns=keys).to_dict("list"))
    out["registers"] = register_ops_checked(captured, real)
    out["b1"] = b1_checked(CG, "sketch solo", b1_calls)
    out["b1_launches"] = b1

    # 2. the storm: one wave launch, theta split between stripe and epilogue
    for k, v in SQL_STORM_CONFIG.items():
        ctx.config.set(k, v)
    names, queries = list(SKETCH_STORM), list(SKETCH_STORM.values())
    run_storm(ctx, queries, call=ctx.sql)      # plans and builds once
    st0 = ctx.engine.sharedscan.stats()
    real_wave, waves = CW.wave_groupby, []

    def wave_spy(program, layout, columns):
        waves.append((program, layout, [c.reshape(-1) for c in columns]))
        return real_wave(program, layout, columns)
    CW.wave_groupby = wave_spy
    try:
        CW.launches = 0
        CG.launches = 0
        res, storm_ms, phases = run_storm(ctx, queries, call=ctx.sql)
        torch.cuda.synchronize()
        b2, b1_storm = CW.launches, CG.launches
    finally:
        CW.wave_groupby = real_wave
    entries = ctx.history.entries()[-len(queries):]
    waves_info = [e.stats.get("sharedscan", {}).get("wave")
                  for e in entries]
    st1 = ctx.engine.sharedscan.stats()
    storm = {k: st1[k] - st0[k] for k in ("queries_coalesced",
                                          "wave_launches", "wave_fallbacks")}
    info = waves_info[0] or {}
    storm.update(wave_kernel_launches=b2, dense_groupby_launches=b1_storm,
                 wall_ms=storm_ms, phases_ms=phases,
                 modes=[e.stats["mode"] for e in entries],
                 theta_inkernel=info.get("theta_inkernel"),
                 sketch_epilogue=info.get("sketch_epilogue"))
    if storm["queries_coalesced"] != len(queries) \
            or storm["wave_launches"] != 1 or storm["wave_fallbacks"] != 0 \
            or b2 != 1 or b1_storm != 0 or len(waves) != 1 \
            or storm["modes"] != ["engine"] * len(queries) \
            or not info.get("theta_inkernel") \
            or not info.get("sketch_epilogue"):
        raise AssertionError(f"sketch storm: not {len(queries)} statements "
                             f"in one wave launch with a stripe and an "
                             f"epilogue: {storm}, reasons "
                             f"{st1['wave_fallback_reasons']}")
    ctx.config.set("sdot.sharedscan.enabled", False)
    got = dict(zip(names, res))
    for n, q in SKETCH_STORM.items():
        check_frame(f"sketch storm {n} vs solo", got[n],
                    ctx.sql(q).to_pandas(), None, 0)
    late = li[li.l_shipdate >= np.datetime64("1995-01-01")]
    storm["worst_error"] = {}
    for n, keys, df, cols in (
            ("theta_flag", ["l_returnflag"], li,
             {"t_part": ("theta", "l_partkey", None)}),
            ("theta_mode", ["l_shipmode"], li,
             {"t_supp": ("theta", "l_suppkey", None)}),
            ("hll_status", ["l_linestatus"], li,
             {"u_order": ("hll", "l_orderkey", None)}),
            ("kll_flag", ["l_returnflag"], late,
             {"p90": ("kll", "l_extendedprice", 0.9)})):
        storm["worst_error"][n] = sketch_estimates_check(
            f"sketch storm {n}", got[n], df, keys, cols, eps)
    out["storm"] = storm
    out["b2_launches"] = b2
    program, layout, cols = waves[0]
    out["wave"] = wave_timed(CW, "sketch storm", program, layout, cols)
    out["wave"]["stripes"] = [[t[0] for t in ls.thetas]
                              for ls in layout.lanes]
    out["seconds"] = time.perf_counter() - t_phase
    return out


def hashed_q1(ctx, spec, dense) -> dict:
    """Q1 as a QuerySpec forced onto the hashed tier (6 keys over 6M rows:
    few groups, many rows each), under ``auto`` and on both tiers,
    against the dense answer."""
    for k, v in HASH_FORCED.items():
        ctx.config.set(k, v)

    def run():
        with HashSpy() as spy:
            got = ctx.execute(spec).to_pandas()
        return got, ctx.engine.last_stats, spy

    def timed():
        return timed_execute(ctx, spec), ctx.engine.last_stats

    def check(mode, got):
        check_frame(f"Q1 hashed ({mode}) vs dense", got, dense, None,
                    FLOAT_SUM_RTOL_KERNEL)
    try:
        out = tier_choice(ctx, run, timed, check)
    finally:
        ctx.config.set("sdot.engine.groupby.dense.max.keys", 1 << 22)
    for mode in ("auto", "on", "off"):
        if not out[mode]["hashed"]:
            raise AssertionError(f"Q1 forced hashed ({mode}): {out}")
    return out


# -- multi-wave binding (phase "waves") ---------------------------------------

# SF5, cut from SF10: the whole run took 1,007.9 s at SF10 on one H100
# (SF10's generation and ingest alone 412 s of host time)
WAVES_SF = 5.0
WAVES_Q1 = 8                # Q1's waves under the phase's budget
WAVES_MIN = 4               # waves every statement of the phase must take
WAVES_REPEATS = 3
# the hashed statement's key space (1M parts at SF5) over this dense
# ceiling, so it takes the hashed tier in both wave modes
WAVES_HASHED = {"sdot.engine.groupby.dense.max.keys": 1 << 19}
WAVES_HAVING_MIN = 300      # lines per (supplier, status) in the HAVING
WAVES_LIMIT = 10


def waves_specs(S, E):
    """The phase's statements over lineitem as QuerySpecs: Q1 (B1 per
    wave), phase sketch's statement (B1 and the three register ops per
    wave), revenue by part (hashed tier, 1M groups at SF5) and a HAVING
    with an ordered LIMIT by supplier and line status (100,000 keys at
    SF5: device HAVING in one wave, the host under waves)."""
    C, L = E.Column, E.Literal
    rev = E.BinaryOp("*", C("l_extendedprice"),
                     E.BinaryOp("-", L(1), C("l_discount")))
    return {
        "q1": q1_spec(S, E),
        "sketch": S.GroupByQuerySpec(
            "lineitem", (S.DimensionSpec("l_returnflag", "l_returnflag"),
                         S.DimensionSpec("l_linestatus", "l_linestatus")),
            (S.AggregationSpec("count", "n"),
             S.AggregationSpec("cardinality", "u_order", field="l_orderkey"),
             S.AggregationSpec("thetasketch", "t_supp", field="l_suppkey"),
             S.AggregationSpec("quantile", "p50", field="l_extendedprice",
                               fraction=0.5))),
        "hashed": S.GroupByQuerySpec(
            "lineitem", (S.DimensionSpec("l_partkey", "l_partkey"),),
            (S.AggregationSpec("doublesum", "revenue", expr=rev),
             S.AggregationSpec("count", "n"))),
        "having_limit": S.GroupByQuerySpec(
            "lineitem", (S.DimensionSpec("l_suppkey", "l_suppkey"),
                         S.DimensionSpec("l_linestatus", "l_linestatus")),
            (S.AggregationSpec("longsum", "qty", field="l_quantity"),
             S.AggregationSpec("doublesum", "revenue", expr=rev),
             S.AggregationSpec("count", "n")),
            having=S.HavingSpec(E.Comparison(
                ">", C("n"), L(WAVES_HAVING_MIN))),
            limit=S.LimitSpec((S.OrderByColumn("revenue", ascending=False),),
                              WAVES_LIMIT))}


def waves_oracles(df) -> dict:
    """pandas answers for :func:`waves_specs` (Q1's and the sketch
    statement's are checked by their own functions): ``(keys, frame)``."""
    d = df.assign(revenue=df["l_extendedprice"] * (1 - df["l_discount"]))
    hashed = d.groupby("l_partkey").agg(
        revenue=("revenue", "sum"), n=("l_quantity", "size")).reset_index()
    sup = d.groupby(["l_suppkey", "l_linestatus"]).agg(
        qty=("l_quantity", "sum"), revenue=("revenue", "sum"),
        n=("l_quantity", "size")).reset_index()
    sup = sup[sup["n"] > WAVES_HAVING_MIN].sort_values(
        "revenue", ascending=False).head(WAVES_LIMIT).reset_index(drop=True)
    return {"hashed": (["l_partkey"], hashed), "having_limit": (None, sup)}


def pinned_copy_gb_per_s(nbytes, repeats=5) -> float:
    """GB/s of one host-to-device copy of ``nbytes`` from pinned memory on
    this card (CUDA events, median): the rate a wave's copy can reach."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dev.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return nbytes / statistics.median(times) / 1e6


class LaunchSpy:
    """Within the block: every B1 and B2 wrapper call recorded (its inputs,
    for the check against the plain version) and both launch counts from
    0."""

    def __init__(self, CG, CW):
        self.CG, self.CW = CG, CW
        self.b1, self.b2 = [], []

    def __enter__(self):
        CG, CW = self.CG, self.CW
        self.real = CG.dense_groupby_kernel, CW.wave_groupby
        real_b1, real_b2 = self.real

        def b1(key, n_keys, inputs, max_keys):
            self.b1.append((key, n_keys, list(inputs), max_keys))
            return real_b1(key, n_keys, inputs, max_keys)

        def b2(program, layout, columns):
            self.b2.append((program, layout,
                            [c.reshape(-1) for c in columns]))
            return real_b2(program, layout, columns)
        CG.dense_groupby_kernel, CW.wave_groupby = b1, b2
        CG.launches = CW.launches = 0
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.b1_launches, self.b2_launches = self.CG.launches, \
            self.CW.launches
        self.CG.dense_groupby_kernel, self.CW.wave_groupby = self.real
        return False


def wave_summary(steps, wall_ms, kernel_ms=None) -> dict:
    """One multi-wave run: per wave its host bind, copy and compute
    (``wave_steps``) and its kernel's device ms; the overlap share
    1 - wall / (sum of binds and copies + sum of compute spans)."""
    serial = sum(st["bind_ms"] + (st.get("h2d_ms") or 0.0)
                 + (st.get("compute_ms") or 0.0) for st in steps)
    per_wave = []
    for i, st in enumerate(steps):
        row = dict(st)
        if st.get("h2d_ms"):
            row["h2d_gb_per_s"] = st["h2d_bytes"] / st["h2d_ms"] / 1e6
        if kernel_ms is not None and len(kernel_ms) == len(steps):
            row["kernel_ms"] = kernel_ms[i]
        per_wave.append(row)
    h2d_ms = sum(st.get("h2d_ms") or 0.0 for st in steps)
    return dict(
        wall_ms=wall_ms, per_wave=per_wave,
        bind_ms=sum(st["bind_ms"] for st in steps), h2d_ms=h2d_ms,
        compute_ms=sum(st.get("compute_ms") or 0.0 for st in steps),
        h2d_bytes=sum(st["h2d_bytes"] for st in steps),
        h2d_gb_per_s=sum(st["h2d_bytes"] for st in steps) / h2d_ms / 1e6
        if h2d_ms else None,
        overlap_share=1.0 - wall_ms / serial if serial else None)


def waves_phase(sdt, S, E, CG, CW, smi, sf=WAVES_SF, device="cuda",
                ingest_kw=None) -> dict:
    """Phase ``waves``: TPC-H lineitem at ``WAVES_SF`` (generated by the
    port's ``tools/tpch.generate``, ingested without ``l_comment``) under a
    wave budget that gives Q1 ``WAVES_Q1`` waves. Each statement runs
    multi-wave (launch counts, every B1 / B2 launch of every wave against
    its plain version, per-wave bind / copy / compute, the overlap share),
    against the same statement in one wave (answers; cold and warm ms) and
    against pandas; the storm of 8 QuerySpecs takes one B2 launch per wave.
    Then the bind-cache repair: Q1 in one wave under a device cache cap
    below its bound bytes answers, with the cache dropped. ``sf``,
    ``device`` and ``ingest_kw`` (segment size) serve a rehearsal on the
    CPU at a tiny scale."""
    from spark_druid_olap_tpu_torch.parallel import cost as C
    from spark_druid_olap_tpu_torch.parallel import executor as X
    from spark_druid_olap_tpu_torch.tools.tpch import generate
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tables = generate(sf, seed=SEED)
    df = tables.pop("lineitem").drop(columns="l_comment")
    del tables
    t_gen = time.perf_counter() - t0
    base = sdt.Context(device=device)
    t0 = time.perf_counter()
    ds = base.ingest_dataframe("lineitem", df, time_column="l_shipdate",
                               **(ingest_kw or {}))
    t_ingest = time.perf_counter() - t0
    out = {"sf": sf, "card": smi, "rows": len(df),
           "segments": ds.num_segments, "padded_rows": ds.padded_rows,
           "generate_s": t_gen, "ingest_s": t_ingest}

    specs = waves_specs(S, E)
    q1 = specs["q1"]
    seg = ds.prune_segments(q1.intervals, q1.filter)
    q1_names = base.engine._plan_agg(
        ds, seg, list(q1.dimensions), q1.aggregations, q1.granularity,
        q1.filter, q1.intervals)[5]
    q1_seg_bytes = C.bytes_per_segment(ds, q1_names)
    budget = q1_seg_bytes * -(-len(seg) // WAVES_Q1)
    out["wave_max_bytes"] = budget

    def context(config):
        ctx = sdt.Context(dict(config), device=device)
        ctx.store.register(ds)
        return ctx

    multi = {"sdot.engine.wave.max.bytes": budget}
    oracles = waves_oracles(df)
    q1_want = q1_oracle(df)
    b1_all, b2_all = [], []
    launches = {"dense_groupby": 0, "wave": 0}
    statements = {}
    eps = float(base.config.get("sdot.quantile.rank_bound"))

    # 1. the four statements, each multi-wave against one wave
    for name, spec in specs.items():
        extra = WAVES_HASHED if name == "hashed" else {}
        wctx, sctx = context(dict(multi, **extra)), context(extra)
        # the finals the decode reads: the waves' merge (multi-wave), the
        # one copy's (single wave, which runs after)
        captured = {}
        real_run, real_finals = X.QueryEngine._run_waves, X._finals_from_out

        def run_waves(self, *a, **k):
            r = real_run(self, *a, **k)
            captured["multi"] = r[0]
            return r

        def finals(*a, **k):
            captured["single"] = real_finals(*a, **k)
            return captured["single"]
        X.QueryEngine._run_waves, X._finals_from_out = run_waves, finals
        try:
            with LaunchSpy(CG, CW) as spy:
                t = time.perf_counter()
                got = wctx.execute(spec).to_pandas()
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t) * 1e3
            st = dict(wctx.engine.last_stats)
            single = sctx.execute(spec).to_pandas()
            sst = dict(sctx.engine.last_stats)
        finally:
            X.QueryEngine._run_waves, X._finals_from_out = real_run, \
                real_finals
        if st.get("waves", 1) < WAVES_MIN or sst.get("waves") != 1 \
                or (name == "hashed") != bool(st.get("hashed")) \
                or (name == "hashed") != bool(sst.get("hashed")) \
                or (name == "having_limit") != bool(sst.get("having_device")) \
                or st.get("having_device") or st.get("topk_device"):
            raise AssertionError(
                f"waves {name}: {st.get('waves')} waves multi-wave, "
                f"{sst.get('waves')} single; hashed {st.get('hashed')} / "
                f"{sst.get('hashed')}; device HAVING "
                f"{st.get('having_device')} / {sst.get('having_device')}")
        # both runs decode in key order (or the LIMIT's order)
        check_frame(f"waves {name} vs one wave", got, single, None,
                    FLOAT_SUM_RTOL_KERNEL)
        if name == "q1":
            check_q1(got, q1_want)
        elif name == "sketch":
            for k in ("u_order", "t_supp", "p50"):
                a, b = captured["multi"][k], captured["single"][k]
                if a.dtype != b.dtype or a.shape != b.shape \
                        or not np.array_equal(a.view(np.uint8),
                                              b.view(np.uint8)):
                    raise AssertionError(f"waves sketch {k}: registers "
                                         f"differ from one wave")
            keys = ["l_returnflag", "l_linestatus"]
            want_n = df.groupby(keys).size()
            if sorted(zip(got.l_returnflag, got.l_linestatus, got.n)) \
                    != sorted((a, b, int(c)) for (a, b), c in
                              want_n.items()):
                raise AssertionError("waves sketch: counts differ from "
                                     "pandas")
            captured["worst_error"] = sketch_estimates_check(
                "waves sketch", got, df, keys,
                {"u_order": ("hll", "l_orderkey", None),
                 "t_supp": ("theta", "l_suppkey", None),
                 "p50": ("kll", "l_extendedprice", 0.5)}, eps)
        else:
            keys, want = oracles[name]
            check_frame(f"waves {name} vs pandas", got, want, keys,
                        FLOAT_SUM_RTOL_ORACLE)
        checked = b1_checked(CG, f"waves {name}", spy.b1) if spy.b1 \
            else None
        runs = []
        for _ in range(WAVES_REPEATS):
            ms = timed_execute(wctx, spec)
            runs.append(wave_summary(
                wctx.engine.last_stats["wave_steps"], ms,
                [c["kernel_ms"] for c in checked["calls"]]
                if checked else None))
        cold, warm = [], []
        for _ in range(WAVES_REPEATS):
            sctx.engine.clear_caches()
            cold.append(timed_execute(sctx, spec))
        for _ in range(WAVES_REPEATS):
            warm.append(timed_execute(sctx, spec))
        med = sorted(runs, key=lambda r: r["wall_ms"])[len(runs) // 2]
        statements[name] = dict(
            waves=st["waves"], segments_per_wave=st["segments_per_wave"],
            rows=len(got), tier="hashed" if st.get("hashed") else
            st.get("route"), dense_groupby_launches=spy.b1_launches,
            wave_launches=spy.b2_launches, first_ms=first_ms,
            wall_ms=[r["wall_ms"] for r in runs], median_run=med,
            single_cold_ms=cold, single_warm_ms=warm,
            single_cold_median_ms=statistics.median(cold),
            single_warm_median_ms=statistics.median(warm),
            having_device=[st.get("having_device"),
                           sst.get("having_device")],
            b1={k: checked[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "library_ms", "max_abs_err")}
            if checked else None,
            worst_error=captured.get("worst_error"))
        b1_all.append(checked)
        launches["dense_groupby"] += spy.b1_launches
        launches["wave"] += spy.b2_launches
        del wctx, sctx, spy

    # 2. the storm: one B2 launch per wave, answers equal one wave's
    storm = context(dict(STORM_CONFIG, **multi))
    snames = list(storm_specs(S, E))
    slist = list(storm_specs(S, E).values())
    run_storm(storm, slist)                 # plans and builds once
    st0 = storm.engine.sharedscan.stats()
    members = []
    with LaunchSpy(CG, CW) as spy:
        res, storm_ms, phases = run_storm(storm, slist, stats_out=members)
    st1 = storm.engine.sharedscan.stats()
    delta = {k: st1[k] - st0[k] for k in ("queries_coalesced",
                                          "wave_launches", "wave_fallbacks")}
    n_waves = {m["waves"] for m in members}
    if len(n_waves) != 1 or min(n_waves) < WAVES_MIN \
            or delta["queries_coalesced"] != len(slist) \
            or delta["wave_launches"] != min(n_waves) \
            or spy.b2_launches != min(n_waves) or spy.b1_launches != 0 \
            or delta["wave_fallbacks"] != 0:
        raise AssertionError(f"waves storm: {n_waves} waves, {delta}, "
                             f"B2 {spy.b2_launches}, B1 {spy.b1_launches}")
    solo = context({})
    got = dict(zip(snames, res))
    for n, q in zip(snames, slist):
        check_frame(f"waves storm {n} vs one wave", got[n],
                    solo.execute(q).to_pandas(), None, FLOAT_SUM_RTOL_KERNEL)
    check_q1(got["q1"], q1_want)
    checked = [wave_timed(CW, f"waves storm[{i}]", *call)
               for i, call in enumerate(spy.b2)]
    steps = next(m["wave_steps"] for m in members if "wave_steps" in m)
    runs = []
    for _ in range(WAVES_REPEATS):
        members = []
        ms = run_storm(storm, slist, stats_out=members)[1]
        runs.append(wave_summary(
            next(m["wave_steps"] for m in members if "wave_steps" in m), ms,
            [c["ms"] for c in checked]))
    one = context(STORM_CONFIG)
    cold, warm = [], []
    for _ in range(WAVES_REPEATS):
        one.engine.clear_caches()
        cold.append(run_storm(one, slist)[1])
    for _ in range(WAVES_REPEATS):
        warm.append(run_storm(one, slist)[1])
    med = sorted(runs, key=lambda r: r["wall_ms"])[len(runs) // 2]
    statements["storm"] = dict(
        waves=min(n_waves), segments_per_wave=members[0]["segments_per_wave"],
        coalescer=delta, wave_launches=spy.b2_launches,
        dense_groupby_launches=spy.b1_launches, first_ms=storm_ms,
        first_steps=len(steps), wall_ms=[r["wall_ms"] for r in runs],
        median_run=med, single_cold_ms=cold, single_warm_ms=warm,
        single_cold_median_ms=statistics.median(cold),
        single_warm_median_ms=statistics.median(warm),
        b2=[{k: c[k] for k in ("rows", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by")} for c in checked])
    b2_all = checked
    launches["wave"] += spy.b2_launches
    del storm, one, solo, spy

    # 3. the bind-cache repair: a cap below Q1's bound bytes drops the
    # cache and Q1 binds and answers in one wave
    q1_bytes = q1_seg_bytes * len(seg)
    cap = q1_bytes // 2
    fctx = context({"sdot.engine.device.cache.bytes": cap})
    got = fctx.execute(q1).to_pandas()
    fst = fctx.engine.last_stats
    check_q1(got, q1_want)
    if fst["waves"] != 1 \
            or len(fctx.engine._device_arrays) >= len(q1_names):
        raise AssertionError(f"waves cache repair: {fst['waves']} waves, "
                             f"{len(fctx.engine._device_arrays)} of "
                             f"{len(q1_names)} arrays resident")
    out["cache_repair"] = dict(
        q1_bound_bytes=q1_bytes, cap=cap, waves=fst["waves"],
        resident_arrays=len(fctx.engine._device_arrays),
        bound_arrays=len(q1_names),
        resident_bytes=fctx.engine._device_bytes)
    del fctx

    widest = max(r["h2d_bytes"] / len(r["per_wave"])
                 for st in statements.values() for r in [st["median_run"]])
    out["pinned_copy_gb_per_s"] = pinned_copy_gb_per_s(int(widest))
    out["pinned_probe_bytes"] = int(widest)
    out["statements"] = statements
    out["launches"] = launches
    b1 = [c for c in b1_all if c]
    out["b1"] = {k: sum(c[k] for c in b1) for k in (
        "ms", "plain_ms", "bound_ms", "library_ms")}
    out["b1"]["max_abs_err"] = max(c["max_abs_err"] for c in b1)
    out["b1"]["calls"] = [call for c in b1 for call in c["calls"]]
    out["b2"] = {k: sum(c[k] for c in b2_all) for k in (
        "ms", "plain_ms", "bound_ms")}
    out["b2"]["max_abs_err"] = max(c["max_abs_err"] for c in b2_all)
    out["b2"]["calls"] = len(b2_all)
    out["b2"]["bound_by"] = sorted({c["bound_by"] for c in b2_all})
    out["seconds"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    LOG.unlink(missing_ok=True)
    import spark_druid_olap_tpu_torch as sdt
    from spark_druid_olap_tpu_torch.ir import expr as E
    from spark_druid_olap_tpu_torch.ir import spec as S
    from spark_druid_olap_tpu_torch.ops import cuda_groupby as CG
    from spark_druid_olap_tpu_torch.ops import cuda_wave as CW
    from spark_druid_olap_tpu_torch.planner import fusion as FU
    from spark_druid_olap_tpu_torch.tools.tpch import generate

    t_start = time.perf_counter()
    smi = nvidia_smi()
    say(smi)
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    dev = torch.device("cuda")

    # 2. build every kernel of the path from this checkout's sources, one
    # nvcc per source, all at once
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(m.library) for m in (CG, CW)]:
            f.result()
    for name, m in (("dense_groupby", CG), ("wave", CW)):
        emit("build", kernel=name, source=str(m.SOURCE.name),
             seconds=m.build_info["seconds"], cached=m.build_info["cached"],
             wall_s=time.perf_counter() - t0,
             ptxas=[ln.strip() for ln in str(m.build_info["log"])
                    .splitlines() if any(w in ln for w in (
                        "Compiling entry", "registers", "stack frame"))])

    # a fixed B1 call: does torch.profiler record the port's kernels?
    from spark_druid_olap_tpu_torch.ops.groupby import AggInput
    pkey = torch.arange(1_000_000, device=dev, dtype=torch.int32) % 7
    pin = [AggInput("n", "count")]

    def probe():
        CG.dense_groupby_kernel(pkey, 6, pin, 64)
    sees = {"after_build": profiler_sees(probe, "dense_groupby")}

    # 3. kernel vs plain version on the card
    t0 = time.perf_counter()
    n_cases, worst, tiers = kernel_cases(CG, dev)
    emit("kernel_check", kernel="dense_groupby", cases=n_cases,
         max_abs_err=worst, seconds=time.perf_counter() - t0, tiers=tiers,
         tolerance="ints/counts/min/max exact; float sums rtol 1e-9; NaN "
                   "in the same groups; every tier that fits, each launched "
                   "twice, bit-identical")
    t0 = time.perf_counter()
    w_cases, w_worst, w_checks = wave_cases(sdt, S, E, CW, FU)
    emit("wave_kernel", kernel="wave", cases=w_cases, max_abs_err=w_worst,
         checks=w_checks, seconds=time.perf_counter() - t0,
         tolerance="ints/counts/min/max exact; float sums rtol 1e-9; NaN "
                   "in the same groups; two launches bit-identical")

    # 4. the main path at SF1
    t0 = time.perf_counter()
    tables = generate(SF, seed=SEED)
    df = tables["lineitem"]
    t_gen = time.perf_counter() - t0
    ctx = sdt.Context()
    t0 = time.perf_counter()
    ctx.ingest_dataframe("lineitem", df, time_column="l_shipdate")
    t_ingest = time.perf_counter() - t0
    emit("ingest", sf=SF, rows=len(df), generate_s=t_gen, ingest_s=t_ingest,
         segments=ctx.store.get("lineitem").num_segments)

    # 4a. the SQL front end over the flattened star
    sql_b1, sql_b2, sql_k, hashed, tail, sketch = sql_phase(
        sdt, tables, ctx.store.get("lineitem"), CG, CW, smi)
    emit("tail", card=smi, **tail,
         oracle="q2 / q16 / q18 / q20, q18's inner group-by, the select "
                "and the search vs pandas (ints exact, floats rtol 1e-6); "
                "compacted vs uncompacted (floats rtol 1e-9); select pages "
                "device mask vs host mask (exact); each compacted B1 "
                "launch vs its plain version (kernels)",
         note="warm ms: median of 3, host wall clock to the frame; "
              "copies / copy_bytes: the engine's device-to-host copies "
              "in one run; compaction: compact_keep's device ms by CUDA "
              "events, bound = mask read + positions written / 3.35 TB/s")
    emit("sketch", card=smi, **sketch,
         oracle="estimates vs pandas: HLL within 6.9% (3 standard errors), "
                "theta within 40%, KLL's estimate at a rank within "
                "sdot.quantile.rank_bound of its fraction; the solo "
                "statement's counts exact; storm answers equal the solo "
                "answers exactly; registers on the card equal the plain "
                "version's (the same op on the host) bit for bit; the B2 "
                "launch with the theta stripe equals wave_reference bit "
                "for bit in every register-file layout that fits, launched "
                "twice",
         note="register ops: device ms by CUDA events as in phase timing; "
              "bound = the larger of the bytes (inputs read once, registers "
              "written once) / 3.35 TB/s and the integer operations "
              "(REGISTER_OPS_PER_ROW per row) / 67e12 per s (the data "
              "sheet's fp32 rate; it lists no int32 rate)")
    sees["after_sql"] = profiler_sees(probe, "dense_groupby")

    captured = {}
    real_kernel = CG.dense_groupby_kernel

    def run_main(name, spec):
        """One main-path run with the launch count zeroed just before it
        and read just after; keeps the kernel's inputs for timing."""
        def spy(key, n_keys, inputs, max_keys):
            captured[name] = (key, n_keys, list(inputs), max_keys)
            return real_kernel(key, n_keys, inputs, max_keys)
        CG.dense_groupby_kernel = spy
        try:
            CG.launches = 0
            res = ctx.execute(spec).to_pandas()
            torch.cuda.synchronize()
            launched = CG.launches
        finally:
            CG.dense_groupby_kernel = real_kernel
        if launched < 1 or name not in captured:
            raise AssertionError(f"{name}: the main path launched no "
                                 f"dense_groupby kernel")
        return res, launched

    q1, q6, wide = q1_spec(S, E), q6_spec(S, E), wide_spec(S, E)
    r1, l1 = run_main("q1", q1)
    check_q1(r1, q1_oracle(df))
    r6, l6 = run_main("q6", q6)
    rev = q6_oracle(df)
    np.testing.assert_allclose(r6["revenue"].to_numpy(), [rev],
                               rtol=FLOAT_SUM_RTOL_ORACLE)
    rw, lw = run_main("wide", wide)
    check_wide(rw, wide_oracle(df))
    if lw < 2:
        raise AssertionError(f"wide: {len(wide.aggregations)} aggregates "
                             f"took {lw} kernel launch(es), not 2")
    emit("main_path", q1_groups=len(r1), q1_launches=l1, q6_launches=l6,
         wide_launches=lw, wide_aggs=len(wide.aggregations),
         q1_sum_qty=r1["sum_qty"].tolist(),
         q6_revenue=float(r6["revenue"][0]), q6_oracle=rev,
         oracle="pandas on the same frame: ints exact, float sums and "
                "float min/max rtol 1e-6",
         route=ctx.engine.last_stats.get("route"))

    sees["after_main_path"] = profiler_sees(probe, "dense_groupby")

    # 4a'. the wide-key path: Q1 forced hashed, and what phase sql found
    t0 = time.perf_counter()
    hashed["q1_forced_hashed"] = hashed_q1(ctx, q1, r1)
    emit("hashed", card=smi, **hashed,
         q1_seconds=time.perf_counter() - t0,
         oracle="q3 (flat) and basic_agg vs pandas (ints exact, floats "
                "rtol 1e-6); q7 sorted vs scatter tier and Q1 hashed vs "
                "dense (floats rtol 1e-9); q3 / q10 / q21 (full star) vs "
                "the engine-free host tier while its budget lasts",
         note="steps: device ms by CUDA events as in phase timing; "
              "bound = bytes the step must move / 3.35 TB/s (the copy to "
              "the host: / 64 GB/s, PCIe Gen5 x16); unit costs: s per row "
              "per added aggregate, slope 1 -> 5 float64 sums, held = "
              "parallel/cost.py's table; per statement: warm ms on each "
              "tier, the tier auto picks and whether it is the faster")

    # 4b. the storm: 8 concurrent queries coalesced into one wave launch
    ds = ctx.store.get("lineitem")
    storm = sdt.Context(STORM_CONFIG)
    storm.store.register(ds)
    sspecs = storm_specs(S, E)
    snames, slist = list(sspecs), list(sspecs.values())
    real_wave = CW.wave_groupby

    def wave_spy(program, layout, columns):
        captured["storm"] = (program, layout,
                             [c.reshape(-1) for c in columns])
        return real_wave(program, layout, columns)

    st0 = storm.engine.sharedscan.stats()
    CW.wave_groupby = wave_spy
    try:
        CG.launches = 0
        CW.launches = 0
        sres, cold_storm_ms, cold_phases = run_storm(storm, slist)
        torch.cuda.synchronize()
        storm_launches, storm_b1 = CW.launches, CG.launches
    finally:
        CW.wave_groupby = real_wave
    st1 = storm.engine.sharedscan.stats()
    delta = {k: st1[k] - st0[k] for k in ("queries_coalesced",
                                          "wave_launches", "wave_fallbacks",
                                          "groups_coalesced", "fallbacks")}
    fusion = {k: st1["fusion"][k] - st0["fusion"][k] for k in st1["fusion"]}
    if delta["queries_coalesced"] != 8 or delta["wave_launches"] != 1 \
            or delta["wave_fallbacks"] != 0 or storm_launches != 1 \
            or storm_b1 != 0 or "storm" not in captured:
        raise AssertionError(f"storm: not 8 queries in one wave launch: "
                             f"{delta}, wave kernel launches "
                             f"{storm_launches}, dense_groupby launches "
                             f"{storm_b1}, reasons "
                             f"{st1['wave_fallback_reasons']}")
    if fusion["shared_predicates"] < 2:
        raise AssertionError(f"storm: fusion shared {fusion}")
    got = dict(zip(snames, sres))
    check_q1(got["q1"], q1_oracle(df))
    np.testing.assert_allclose(got["q6"]["revenue"].to_numpy(), [rev],
                               rtol=FLOAT_SUM_RTOL_ORACLE)
    for name, (keys, want) in storm_oracles(df).items():
        check_frame(f"storm {name} vs pandas", got[name], want, keys,
                    FLOAT_SUM_RTOL_ORACLE)
    solo = {name: ctx.execute(q).to_pandas() for name, q in sspecs.items()}
    for name in snames:
        if list(got[name].columns) != list(solo[name].columns):
            raise AssertionError(f"storm {name}: columns differ from solo")
        check_frame(f"storm {name} vs solo", got[name], solo[name], None,
                    FLOAT_SUM_RTOL_KERNEL)
    program, layout, scols = captured["storm"]
    swant = CW.wave_reference(program, scols, layout)
    w_worst = max(w_worst, wave_checked(CW, "storm", program, layout, scols,
                                        swant)[1])
    emit("storm", queries=snames, coalescer=delta, fusion=fusion,
         wave_kernel_launches=storm_launches,
         dense_groupby_launches=storm_b1, cold_storm_ms=cold_storm_ms,
         cold_phases_ms=cold_phases,
         program={"instructions": len(program.instrs),
                  "registers": program.n_regs,
                  "columns": program.columns, "lanes": len(layout.lanes),
                  "slots": layout.n_slots,
                  "register_bytes": CW.register_width(program),
                  "register_file": layout.file,
                  "smem_bytes": CW.smem_bytes(program, layout, layout.file)},
         rows={n: len(f) for n, f in got.items()},
         oracle="pandas on the same frame (ints exact, floats rtol 1e-6) "
                "and the port's solo answers (floats rtol 1e-9); the "
                "storm's own program: kernel vs plain version")

    sees["after_storm"] = profiler_sees(probe, "dense_groupby")

    # 5. timings, beside the card's name and power limit
    ds = ctx.store.get("lineitem")
    per_query = {}
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    bound_by = set()
    for name, spec in (("q1", q1), ("q6", q6), ("wide", wide)):
        cold, warm = [], []
        for _ in range(REPEATS):
            ctx.engine.clear_caches()     # columns leave the card
            cold.append(timed_execute(ctx, spec))
        for _ in range(REPEATS):
            warm.append(timed_execute(ctx, spec))
        rows = sum(ds.segments[int(i)].num_rows
                   for i in ds.prune_segments(spec.intervals, spec.filter))
        key, n_keys, inputs, max_keys = captured[name]
        per_launch = CG.plan_launches(n_keys, len(inputs))[0]
        got = real_kernel(key, n_keys, inputs, max_keys)
        want = CG.dense_groupby_reference(key, n_keys, inputs)
        torch.cuda.synchronize()
        worst = max(worst, compare(name, got, want, inputs))
        k_ms = device_ms(lambda: real_kernel(key, n_keys, inputs, max_keys))
        k_host_ms = device_ms(lambda: real_kernel(key, n_keys, inputs,
                                                  max_keys), host_gap=True)
        p_ms = device_ms(lambda: CG.dense_groupby_reference(key, n_keys,
                                                            inputs))
        l_ms = device_ms(lambda: library_call(key, n_keys, inputs))
        nbytes, ops = kernel_work(key, n_keys, inputs)
        b_ms, b_by = bound(nbytes, ops)
        bound_by.add(b_by)
        warm_ms = statistics.median(warm)
        per_query[name] = dict(
            cold_median_ms=statistics.median(cold), warm_median_ms=warm_ms,
            warm_min_ms=min(warm), warm_max_ms=max(warm),
            rows_scanned=rows, rows_per_s=rows / warm_ms * 1e3,
            kernel_rows=int(key.numel()), n_keys=n_keys,
            n_aggs=len(inputs), kernel_ms=k_ms,
            kernel_ms_with_host_gap=k_host_ms, plain_ms=p_ms,
            library_ms=l_ms, bound_ms=b_ms, kernel_bytes=nbytes,
            tiers=[CG.fold_tier(n_keys * len(inputs[lo:lo + per_launch]))
                   for lo in range(0, len(inputs), per_launch)],
            tier_ms={t: device_ms(lambda: real_kernel(key, n_keys, inputs,
                                                      max_keys, t))
                     for t in CG.TIERS if CG.smem_bytes(
                         n_keys * per_launch, t) <= CG.SMEM_LIMIT},
            passes_ms=pass_ms(lambda: real_kernel(key, n_keys, inputs,
                                                  max_keys)),
            kernel_gb_per_s=nbytes / k_ms / 1e6,
            share_of_3_35_tb_per_s=nbytes / (k_ms * 1e-3) / HBM_BYTES_PER_S)
        total["ms"] += k_ms
        total["plain_ms"] += p_ms
        total["bound_ms"] += b_ms
        total["library_ms"] += l_ms
    warm = [run_storm(storm, slist)[1:] for _ in range(REPEATS)]
    storm_ms = [ms for ms, _ in warm]
    storm_phases = {k: statistics.median(ph[k] for _, ph in warm)
                    for k in warm[0][1]}
    solo_ms = []
    for _ in range(REPEATS):
        t = time.perf_counter()
        for q in slist:
            ctx.execute(q).to_pandas()
        torch.cuda.synchronize()
        solo_ms.append((time.perf_counter() - t) * 1e3)
    wk_ms = device_ms(lambda: real_wave(program, layout, scols))
    wk_host_ms = device_ms(lambda: real_wave(program, layout, scols),
                           host_gap=True)
    wp_ms = device_ms(lambda: CW.wave_reference(program, scols, layout))
    w_bytes, w_ops = wave_work(program, layout, scols)
    wb_bytes = w_bytes / HBM_BYTES_PER_S * 1e3
    wb_ops = w_ops / FP32_OPS_PER_S * 1e3
    wave_timing = dict(
        warm_storm_median_ms=statistics.median(storm_ms),
        warm_storm_min_ms=min(storm_ms), warm_storm_max_ms=max(storm_ms),
        warm_storm_phases_median_ms=storm_phases,
        solo_sequence_median_ms=statistics.median(solo_ms),
        solo_sequence_min_ms=min(solo_ms), solo_sequence_max_ms=max(solo_ms),
        kernel_ms=wk_ms, kernel_ms_with_host_gap=wk_host_ms,
        register_file=layout.file,
        plain_ms=wp_ms, bound_ms=max(wb_bytes, wb_ops),
        passes_ms=pass_ms(lambda: real_wave(program, layout, scols)),
        bound_bytes_ms=wb_bytes, bound_ops_ms=wb_ops,
        bound_by="bytes" if wb_bytes >= wb_ops else "operations",
        union_bytes=w_bytes, rows=int(scols[0].numel()),
        kernel_gb_per_s=w_bytes / wk_ms / 1e6)
    emit("timing", card=smi, repeats=REPEATS, queries=per_query,
         storm=wave_timing,
         note="device times: CUDA events, median, L2 flushed before each "
              "call, a sleep kernel ahead so the events span device work "
              "only (kernel_ms_with_host_gap: without it, the earlier "
              "method); "
              "passes_ms: torch.profiler, mean per call; query times: host "
              "wall clock to synchronize, cold = device column cache "
              "dropped before each run")

    sees["after_timing"] = profiler_sees(probe, "dense_groupby")

    # 6. where a warm query's time goes: torch.profiler over one run each
    counted = {"dense_groupby": CG, "wave": CW}
    emit("profile", card=smi,
         queries={name: profile_query(ctx, spec, counted)
                  for name, spec in (("q1", q1), ("q6", q6))},
         storm=profile_run(lambda: run_storm(storm, slist)[1], counted),
         profiler_sees=dict(sees, profile=profiler_sees(probe,
                                                        "dense_groupby")),
         note="profiler_sees: of 3 profiles of one B1 call on 1,000,000 "
              "synthetic rows, how many show the kernel, at points along "
              "the run")

    # 7. multi-wave binding at WAVES_SF, after the SF1 state leaves host
    # and card
    del ctx, storm, ds, df, tables, captured, program, layout, scols, got
    del sres, solo
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    waves = waves_phase(sdt, S, E, CG, CW, smi)
    emit("waves", **waves,
         oracle="each statement multi-wave vs the same statement in one "
                "wave (ints, counts, min/max and sketch registers exact; "
                "floats rtol 1e-9) and vs pandas (floats rtol 1e-6; the "
                "sketch estimates as in phase sketch; the storm's Q1); "
                "every B1 / B2 launch of every wave vs its plain version",
         note="per wave: bind_ms host (gather into pinned staging), "
              "h2d_bytes / h2d_ms (CUDA events on the copy stream), "
              "compute_ms (CUDA events around the wave's program on the "
              "compute stream), kernel_ms (the wave's B1 call, timed as "
              "in phase timing); overlap_share = 1 - wall / (sum of bind "
              "+ copy + compute); single-wave cold = device cache "
              "dropped before each run; pinned_copy_gb_per_s: one copy "
              "of the widest wave's bytes from pinned memory")

    # 8. every ported kernel with its check result: the sums over the
    # shapes the main path gave it (Q1, Q6, wide, the SQL statements and
    # the waves for B1; the QuerySpec, SQL and wave storms for B2)
    for k in list(sql_k["dense_groupby"].values()) \
            + list(tail["kernels"].values()) + [sketch["b1"], waves["b1"]]:
        worst = max(worst, k["max_abs_err"])
        for f in ("ms", "plain_ms", "bound_ms", "library_ms"):
            total[f] += k[f]
        bound_by.update(c["bound_by"] for c in k["calls"])
    sw, kw, ww = sql_k["wave"]["storm"], sketch["wave"], waves["b2"]
    w_worst = max(w_worst, sw["max_abs_err"], kw["max_abs_err"],
                  ww["max_abs_err"])
    w_bound_by = {wave_timing["bound_by"], sw["bound_by"], kw["bound_by"],
                  *ww["bound_by"]}
    say(json.dumps({"kernels": [{
        "name": "dense_groupby", "route": "cuda",
        "source": "spark_druid_olap_tpu_torch/csrc/dense_groupby.cu",
        "replaces": "spark_druid_olap_tpu/ops/pallas_groupby.py:205",
        "launches": l1 + l6 + lw + sql_b1 + tail["b1_launches"]
        + sketch["b1_launches"] + waves["launches"]["dense_groupby"],
        "max_abs_err": worst,
        "b1_checked": dict({n: len(k["calls"])
                            for n, k in tail["kernels"].items()},
                           sketch_solo=len(sketch["b1"]["calls"]),
                           waves=len(waves["b1"]["calls"])),
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
        "library_ms": total["library_ms"]}, {
        "name": "wave", "route": "cuda",
        "source": "spark_druid_olap_tpu_torch/csrc/wave.cu",
        "replaces": "spark_druid_olap_tpu/ops/pallas_wave.py:371",
        "launches": storm_launches + sql_b2 + sketch["b2_launches"]
        + waves["launches"]["wave"],
        "max_abs_err": w_worst,
        "ms": wk_ms + sw["ms"] + kw["ms"] + ww["ms"],
        "plain_ms": wp_ms + sw["plain_ms"] + kw["plain_ms"]
        + ww["plain_ms"],
        "bound_ms": wave_timing["bound_ms"] + sw["bound_ms"]
        + kw["bound_ms"] + ww["bound_ms"],
        "b2_checked": {"waves": ww["calls"]},
        "bound_by": "bytes" if w_bound_by == {"bytes"} else "operations",
        "library_ms": None,
        # the launch with the in-kernel theta stripe (phase sketch)
        "stripe_case": {k: kw[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "max_abs_err")}}]}))
    emit("done", seconds=time.perf_counter() - t_start, card=smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
