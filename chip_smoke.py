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
epilogue, their answers equal to the solo answers. Phases ``join`` and
``window`` (inside ``sql``, over the whole star) run four joins on the
broadcast tier (orders x customer with a residual and a build-side group,
partsupp x supplier, and orders x customer again in 3 or more probe
waves) against pandas and the host tier, and three windowed statements
(ranks over a group-by of 10,000 suppliers, a moving sum and a lag, a
bounded min / max frame and a row number over ~370,000 orders) against
pandas. Phase ``ingest`` reports the native string encoder: which columns
it encoded, pyarrow's version, and orders ingested with and without it.
Phase ``spatial`` ingests lineitem (without ``l_comment``) with a
spatial dimension and runs a statement whose two ranges collapse into one
spatial filter (B1), the same filter as one lane of a storm (B2), and
bounding-box pruning on a synthetic table against its unpruned answer. Phase ``serving`` runs
the result cache, WLM and cancellation with their defaults over the flat
star: phase ``sql``'s statements as warm misses and as hits (each hit bit
for bit the miss that put it, the engine / session split, ``wlm.admit``
and the lookup's host ms), three answers derived from cached supersets
against cache-off runs, an invalidating re-ingest, a storm into a
one-slot lane that WLM hands into one shared-scan group (one wave
launch), and a cancel of a held member, a zero timeout and a cancel at a
wave boundary, each followed by a right answer and empty lanes. Every
other phase's context sets ``sdot.cache.enabled`` false, so its warm
times stay the engine's (WLM admission included). Phase ``ssb`` (run
before the TPC-H phases) generates the SSB lineorder at SF1 straight into
Parquet, star-joins it chunk by chunk and streams it into ``ssb_flat``
(``Context.ingest_parquet_stream``: seconds, peak resident set), runs the
13 SSB statements through ``Context.sql`` against pandas (cold, warm, tier,
the device's idle share) and the q1 flight as one wave launch. After
phase ``serving``: phase ``rollup`` builds rollups over SF1 lineitem (Q1
and Q6 served from them against the rewrite off and pandas, stale after
an append, served again after REFRESH) and the SSB cube over SSB SF 0.1
(its 13 statements against the rewrite off); phase ``append`` streams 4
batches of 250,000 rows into a copy of SF1 lineitem, each with a return
flag new to the dictionary and a widened metric, with Q1 (B1, a cache
miss after each batch) and the storm (B2) against pandas after each;
phase ``persist`` checkpoints SF1 lineitem raw and encoded, recovers each
root in a fresh context (the store bit for bit; Q1, Q6 and the storm
against pandas and against the answers before the checkpoint), recovers
both roots again as tiered datasources (Q1, Q6 and the storm cold and
warm under a hot-set budget, bit for bit against the eager store in the
same waves; Q1 cold again under a budget of two waves, where the
prefetcher's chunks are hit), journals
phase ``append``'s batches and 4 producers' 16 small batches through the
write-ahead log (group commit), recovers that root in a fresh context
(the snapshot plus all 20 frames replayed, the store bit for bit),
recovers a child process's root after a kill -9, poisons another child's
CUDA context (its Q1 and Q6 then answer on the host tier, mode ``host
(backend_lost ...)``) and restarts over that child's root on the card,
compacts the appended tail (B2's padded rows and time before and
after) and runs ``sys_snapshots``, RESTORE and CLEAR METADATA ... PURGE;
phase ``modules`` installs a module from ``sdot.modules`` (a string
function grouped on through B1, a spec rule, a statement handler) and runs
Q1's QuerySpec as ``ON DATASOURCE ... EXECUTE QUERY``. Phase ``server``
(after ``serving``) serves phase ``sql``'s flat star from the port's
HTTP ``SqlServer`` on a loopback port: phase sql's 8 statements as JSON
and as Arrow, each response byte for byte the in-process answer, Q1's
QuerySpec on ``/query``, 8 clients at once into a one-slot lane (one
wave launch), a shed (429) and a cancel (499), and two statements over
Arrow Flight. Phase ``cluster`` (after ``modules``) boots 3 historicals
and a broker on the card over phase ``persist``'s raw SF1 lineitem root
(replication 2, shared scan on every node) and runs Q1, Q6, a TopN and
an HLL + theta + KLL statement through the broker against the single
context over the same root, the 8-spec storm twice (wave launches per
historical), a historical stopped mid-storm with zero mismatches, its
restart and a 10,000-row ``stream_ingest`` read back through the
broker. Every B1 and B2 call of these phases is held against its plain
version. Its last phase,
``waves``, ingests the run's SF1 lineitem again without ``l_comment``
(cut from SF10, whose run passed 1,000 s, then from SF5, SF3 and SF2 for
the phases above) and runs Q1, the
sketch statement, revenue by part on the hashed tier, a HAVING with an
ordered LIMIT and the storm under a wave budget
(``sdot.engine.wave.max.bytes``) of a Q1 segment's bytes times
ceil(segments / 6) (Q1 in 6 waves at SF1): each
statement in 4 or more waves against the same statement in one wave and
against pandas, every B1 / B2 launch of every wave against its plain
version, with per-wave bind, copy and compute times and the overlap share;
then Q1 in one wave under a bind-cache cap below its bound bytes, then
EXPLAIN of Q1 (its printed waves against the ones it runs) and of Q6
compacted (its printed survivor budget against its run), and the cost
model's calibration. Any statement demoted as ``backend_lost`` outside
the device-loss child fails the run. Before
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
# the plain versions and library calls a path's kernel calls are held
# against, 100-1000x slower than the kernels: medians of 7 of them took
# about a minute of the run, so outside phase timing they are medians of 3
PLAIN_REPEATS = 3
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

# the phases that repeat warm statements time the engine: a result-cache
# hit would answer them from host memory (phase serving times the hits);
# WLM stays on, as every statement of a user pays it
ENGINE_TIMED = {"sdot.cache.enabled": False}
STORM_CONFIG = {
    **ENGINE_TIMED,
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


def b1_checked(CG, case, calls, timed_shapes=None) -> dict:
    """Each call a path made to the B1 wrapper, held against the plain
    version on the same inputs (launched twice, bit-identical) and timed as
    phase ``timing`` times the main path's queries (the plain version and
    the library call over ``PLAIN_REPEATS``); the sums and each call's
    shape and times. With ``timed_shapes`` (a set), a call whose shape
    (rows, keys, aggregates, their masks) an earlier call of the set was
    timed at is checked but not timed again: its entry says ``timed``
    false and the sums leave it out (ms, plain, bound and library alike)."""
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
        if timed_shapes is not None:
            shape = (int(key.numel()), n_keys, max_keys,
                     tuple((a.kind, a.mask is not None) for a in inputs))
            if shape in timed_shapes:
                out["calls"].append(dict(
                    rows=int(key.numel()), n_keys=n_keys,
                    n_aggs=len(inputs), max_abs_err=err, timed=False))
                out["max_abs_err"] = max(out["max_abs_err"], err)
                continue
            timed_shapes.add(shape)
        k_ms, p_ms = device_ms(kernel), device_ms(plain, PLAIN_REPEATS)
        l_ms = device_ms(lambda: library_call(key, n_keys, inputs),
                         PLAIN_REPEATS)
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


def wave_timed(CW, case, program, layout, cols, timed_shapes=None) -> dict:
    """A wave launch a path made, held against the plain version on the
    same inputs in every register-file layout that fits (each twice,
    bit-identical) and timed as phase ``timing`` times the storm's (the
    plain version over ``PLAIN_REPEATS``). With ``timed_shapes`` (a set),
    a launch of a program and layout already timed is checked only:
    ``timed`` false, and no ms, plain_ms or bound_ms."""
    want = CW.wave_reference(program, cols, layout)
    err = wave_checked(CW, case, program, layout, cols, want)[1]
    nbytes, ops = wave_work(program, layout, cols)
    b_ms, b_by = bound(nbytes, ops)
    if timed_shapes is not None:
        shape = (int(cols[0].numel()), len(layout.lanes),
                 len(program.instrs), program.n_regs,
                 tuple(program.columns), layout.file, repr(program.instrs))
        if shape in timed_shapes:
            return dict(rows=int(cols[0].numel()), lanes=len(layout.lanes),
                        max_abs_err=err, timed=False, ms=0.0, plain_ms=0.0,
                        bound_ms=0.0, bound_by=b_by)
        timed_shapes.add(shape)
    return dict(
        rows=int(cols[0].numel()), lanes=len(layout.lanes),
        instructions=len(program.instrs), registers=program.n_regs,
        columns=program.columns, register_file=layout.file,
        max_abs_err=err,
        ms=device_ms(lambda: CW.wave_groupby(program, layout, cols)),
        plain_ms=device_ms(lambda: CW.wave_reference(program, cols, layout),
                           PLAIN_REPEATS),
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
    out = lineitem_sql_oracles(li)
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
    ctx = sdt.Context(ENGINE_TIMED)
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
    # the broadcast join and window tiers over the whole star
    extra = {"join": join_phase(sdt, ctx, tables, CG),
             "window": window_phase(ctx, tables),
             "flat_ingest_s": t_ingest, "base_tables_ingest_s": t_base,
             "flat_ds": ctx.store.get("tpch_flat")}
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
              "same inputs, times as in phase timing (the plain version "
              "and the library call medians of 3)")
    return b1, b2, kernels, hashed, tail, sketch, extra


# -- the serving tier: result cache, WLM and cancellation (phase "serving") --

# the handoff storm: one slot, so every other statement queues and the
# admission poll hands it into the open shared-scan group
HANDOFF_CONFIG = {"sdot.wlm.lanes": "interactive:slots=1,queue=16",
                  "sdot.sharedscan.enabled": True,
                  "sdot.wlm.batch.window.ms": 50.0}
# q7's 4,375 keys are above B1's tier and would keep the whole group off
# the wave kernel: the storm's eighth thread repeats q1 instead
HANDOFF_SQL = [n for n in SQL_MAIN if n not in SQL_MEDIUM_K] + ["q1"]
HELD_CONFIG = {"sdot.sharedscan.enabled": True,
               "sdot.wlm.batch.window.ms": 800.0}
HELD_SQL = {"q1": None, "shipdate_range": None, "q6": "held-victim"}
INVALIDATE_SQL = ("select n_regionkey, count(*) as n from nation_again "
                  "group by n_regionkey order by n_regionkey")


class KernelSpies:
    """Every call of the B1 and B2 wrappers inside ``run``, the launch
    counts zeroed just before and read just after; ``b1`` / ``b2`` keep
    each call's inputs for the checks against the plain versions."""

    def __init__(self, CG, CW):
        self.CG, self.CW = CG, CW
        self.b1, self.b2 = [], []
        self.b1_launches = self.b2_launches = 0

    def run(self, fn):
        CG, CW = self.CG, self.CW
        real1, real2 = CG.dense_groupby_kernel, CW.wave_groupby

        def spy1(key, n_keys, inputs, max_keys):
            self.b1.append((key, n_keys, list(inputs), max_keys))
            return real1(key, n_keys, inputs, max_keys)

        def spy2(program, layout, columns):
            self.b2.append((program, layout,
                            [c.reshape(-1) for c in columns]))
            return real2(program, layout, columns)
        CG.dense_groupby_kernel, CW.wave_groupby = spy1, spy2
        CG.launches = CW.launches = 0
        try:
            return fn()
        finally:
            # a run that raised (a cancel) counts what it launched too
            torch.cuda.synchronize()
            self.b1_launches += CG.launches
            self.b2_launches += CW.launches
            CG.dense_groupby_kernel, CW.wave_groupby = real1, real2


def bit_equal(name, got, want):
    """Two frames bit for bit: columns, dtypes and every value (NaN where
    the other has NaN)."""
    if list(got.columns) != list(want.columns) or len(got) != len(want):
        raise AssertionError(f"{name}: shape {list(got.columns)} x "
                             f"{len(got)} vs {list(want.columns)} x "
                             f"{len(want)}")
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if g.dtype != w.dtype or not (
                np.array_equal(g, w, equal_nan=True) if w.dtype.kind == "f"
                else np.array_equal(g, w)):
            raise AssertionError(f"{name} {c}: {g[:5]} vs {w[:5]}")


def lanes_idle(name, ctx):
    """No lane runs or queues anything, and nothing is in flight."""
    busy = [ln for ln in ctx.engine.wlm.stats()["lanes"]
            if ln["active"] or ln["queued"]]
    if busy or ctx.engine.inflight.snapshot():
        raise AssertionError(f"{name}: lanes not empty: {busy}, in flight "
                             f"{ctx.engine.inflight.snapshot()}")


def serving_context(sdt, flat_ds, star, config=None):
    """A context over phase sql's flat star, with the defaults (cache on,
    WLM on) but for ``config``."""
    ctx = sdt.Context(config)
    ctx.store.register(flat_ds)
    ctx.register_star_schema(star)
    return ctx


def hit_vs_miss(ctx, tpch, spies) -> dict:
    """Each statement of phase sql: the warm miss (the cache cleared before
    each call) and the hit, medians of 7; the hit's frame bit for bit the
    miss's; the engine / session split and the WLM and lookup host phases."""
    out = {}
    for name in SQL_MAIN:
        sql = tpch.QUERIES[name]
        ctx.engine.result_cache.clear()
        first = spies.run(lambda: ctx.sql(sql).to_pandas())   # cold, spied
        st = ctx.history.entries()[-1].stats
        if st.get("cache") != "miss" or st["mode"] != "engine":
            raise AssertionError(f"serving {name}: first run {st.get('cache')}"
                                 f" in mode {st['mode']}")
        runs = {}
        for kind in ("miss", "hit"):
            spent, stop = engine_spent(ctx)
            timed = []
            for _ in range(REPEATS):
                if kind == "miss":
                    ctx.engine.result_cache.clear()
                t = time.perf_counter()
                frame = ctx.sql(sql).to_pandas()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                st = dict(ctx.history.entries()[-1].stats)
                timed.append((ms, st))
                if kind == "miss":
                    # q7's scatter tier sums floats in atomics' order
                    check_frame(f"serving {name} miss", frame, first, None,
                                FLOAT_SUM_RTOL_KERNEL)
                    put = frame        # the entry the hits read
                else:
                    bit_equal(f"serving {name} hit", frame, put)
            stop()
            if len(spent) != REPEATS:
                raise AssertionError(f"serving {name}: {len(spent)} engine "
                                     f"calls in {REPEATS} runs")
            status = {s.get("cache") for _, s in timed}
            served = {s.get("served_from") for _, s in timed}
            want = ({"miss"}, {None}) if kind == "miss" \
                else ({"hit"}, {"result_cache"})
            if (status, served) != want:
                raise AssertionError(f"serving {name} {kind}: cache "
                                     f"{status}, served_from {served}")
            ms = [m for m, _ in timed]
            session = [m - e for m, e in zip(ms, spent)]
            ph = [s.get("phases") or {} for _, s in timed]
            runs[kind] = dict(
                median_ms=statistics.median(ms), min_ms=min(ms),
                max_ms=max(ms), engine_median_ms=statistics.median(spent),
                session_median_ms=statistics.median(session),
                wlm_admit_median_ms=statistics.median(
                    p.get("wlm.admit", 0.0) for p in ph),
                cache_lookup_median_ms=statistics.median(
                    p.get("cache.lookup", 0.0) for p in ph),
                cache=status.pop(), served_from=served.pop(),
                wlm=timed[-1][1].get("wlm"))
        out[name] = runs
    return out


def subsumption_on_card(ctx, S, spies) -> dict:
    """Answers derived from cached supersets on the host, each against the
    same spec run with the cache off."""
    revenue = (S.AggregationSpec("count", "n"),
               S.AggregationSpec("longsum", "qty", field="l_quantity"),
               S.AggregationSpec("doublesum", "price",
                                 field="l_extendedprice"))
    brand = (S.DimensionSpec("p_brand", "p_brand"),)
    cases = {
        "monthly_from_daily": (
            S.TimeseriesQuerySpec("lineitem", revenue,
                                  granularity=S.Granularity("day")),
            S.TimeseriesQuerySpec("lineitem", revenue,
                                  granularity=S.Granularity("month"))),
        "topn_from_groupby": (
            S.GroupByQuerySpec("tpch_flat", brand, revenue),
            S.TopNQuerySpec("tpch_flat", brand[0], "price", 5, revenue)),
        "filtered_from_unfiltered": (
            S.GroupByQuerySpec("tpch_flat", brand, revenue),
            S.GroupByQuerySpec("tpch_flat", brand, revenue,
                               filter=S.InFilter(
                                   "p_brand", ("Brand#13", "Brand#42")))),
    }
    out = {}
    for name, (wide, narrow) in cases.items():
        with settings(ctx, {"sdot.cache.enabled": False}):
            want = spies.run(lambda: ctx.execute(narrow).to_pandas())
        ctx.engine.result_cache.clear()
        spies.run(lambda: ctx.execute(wide))
        t = time.perf_counter()
        got = ctx.execute(narrow).to_pandas()
        ms = (time.perf_counter() - t) * 1e3
        status = ctx.engine.last_stats.get("cache")
        if status != "subsumed":
            raise AssertionError(f"serving {name}: {status}, not subsumed")
        check_frame(f"serving {name} vs cache off", got, want,
                    [c for c in want.columns if want[c].dtype.kind != "f"],
                    FLOAT_SUM_RTOL_KERNEL)
        out[name] = {"status": status, "rows": len(got), "derive_ms": ms}
    return out


def invalidation_on_card(ctx, tables, tpch, spies) -> dict:
    """A re-ingested datasource misses; the star's statements still hit."""
    nation = tables["nation"]
    for name in SQL_MAIN:               # the star's answers in the cache
        ctx.sql(tpch.QUERIES[name])
    events = []
    ctx.store.add_listener(lambda ev, name: events.append((ev, name)))
    ctx.ingest_dataframe("nation_again", nation)
    statuses = []
    for _ in range(2):
        first = spies.run(lambda: ctx.sql(INVALIDATE_SQL).to_pandas())
        statuses.append(ctx.history.entries()[-1].stats.get("cache"))
    ctx.ingest_dataframe("nation_again", nation)
    again = spies.run(lambda: ctx.sql(INVALIDATE_SQL).to_pandas())
    statuses.append(ctx.history.entries()[-1].stats.get("cache"))
    bit_equal("serving re-ingest", again, first)
    star = {}
    for name in SQL_MAIN:
        ctx.sql(tpch.QUERIES[name]).to_pandas()
        star[name] = ctx.history.entries()[-1].stats.get("cache")
    if statuses != ["miss", "hit", "miss"] \
            or set(star.values()) != {"hit"} \
            or events != [("register", "nation_again")] * 2:
        raise AssertionError(f"serving invalidation: {statuses}, star "
                             f"{star}, events {events}")
    return {"re_ingested": statuses, "star_after": star,
            "version": ctx.store.datasource_version("nation_again"),
            "events": len(events)}


def handoff_storm(sdt, flat_ds, star, tpch, solo, spies) -> dict:
    """phase sql's statements from 8 threads into a one-slot lane: the
    queued ones ride the open shared-scan group (B2)."""
    ctx = serving_context(sdt, flat_ds, star, HANDOFF_CONFIG)
    queries = [tpch.QUERIES[n] for n in HANDOFF_SQL]
    for sql in dict.fromkeys(queries):        # plans and columns warm
        ctx.sql(sql)
    ctx.engine.result_cache.clear()
    lane0 = ctx.engine.wlm.stats()["lanes"]
    ss0 = ctx.engine.sharedscan.stats()
    stats = []
    res, wall_ms, phases = spies.run(lambda: run_storm(
        ctx, queries, call=ctx.sql, stats_out=stats))
    lane = next(ln for ln in ctx.engine.wlm.stats()["lanes"]
                if ln["lane"] == "interactive")
    before = next(ln for ln in lane0 if ln["lane"] == "interactive")
    ss = ctx.engine.sharedscan.stats()
    for name, frame in zip(HANDOFF_SQL, res):
        check_frame(f"serving handoff {name} vs solo", frame, solo[name],
                    None, FLOAT_SUM_RTOL_KERNEL)
    out = {"statements": HANDOFF_SQL, "wall_ms": wall_ms,
           "group_phases_ms": phases,
           "admitted": lane["admitted"] - before["admitted"],
           "coalesced_handoff": lane["coalesced_handoff"]
           - before["coalesced_handoff"],
           "wlm_handoffs": ss["wlm_handoffs"] - ss0["wlm_handoffs"],
           "queries_coalesced": ss["queries_coalesced"]
           - ss0["queries_coalesced"],
           "wave_launches": ss["wave_launches"] - ss0["wave_launches"],
           "max_active_seen": lane["max_active_seen"],
           "queued_ms": [(s.get("wlm") or {}).get("queued_ms")
                         for s in stats],
           "cache": [s.get("cache") for s in stats]}
    if out["max_active_seen"] != 1 or out["wlm_handoffs"] < 1 \
            or out["wave_launches"] < 1 \
            or out["admitted"] != len(queries):
        raise AssertionError(f"serving handoff storm: {out}")
    lanes_idle("serving handoff storm", ctx)
    return out


def cancel_on_card(sdt, S, E, flat_ds, star, lineitem_ds, df, tpch, solo,
                   spies) -> dict:
    """Cancel one member of a held batch, a zero timeout, and a cancel at a
    wave boundary; then the next statement on each engine, and the lanes
    empty."""
    import threading
    from spark_druid_olap_tpu_torch.parallel import executor as X
    out = {}
    # 1. one member of a held batch
    ctx = serving_context(sdt, flat_ds, star, HELD_CONFIG)
    for name in HELD_SQL:
        ctx.sql(tpch.QUERIES[name])
    ctx.engine.result_cache.clear()
    names = list(HELD_SQL)
    res, errs = [None] * len(names), [None] * len(names)
    bar = threading.Barrier(len(names) + 1)

    def worker(i):
        bar.wait()
        try:
            res[i] = ctx.sql(tpch.QUERIES[names[i]],
                             query_id=HELD_SQL[names[i]]).to_pandas()
        except BaseException as e:  # noqa: BLE001 — checked below
            errs[i] = e

    ss0 = ctx.engine.sharedscan.stats()

    def storm():
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(names))]
        for t in threads:
            t.start()
        bar.wait()
        time.sleep(0.2)                # well inside the 800 ms window
        cancelled = ctx.engine.cancel("held-victim")
        for t in threads:
            t.join(timeout=300)
        return cancelled
    cancelled = spies.run(storm)
    ss = ctx.engine.sharedscan.stats()
    victim = names.index("q6")
    if not cancelled or not isinstance(errs[victim], X.QueryCancelled):
        raise AssertionError(f"serving held cancel: {cancelled}, "
                             f"{errs[victim]!r}")
    for i, name in enumerate(names):
        if i != victim:
            if errs[i] is not None:
                raise errs[i]
            check_frame(f"serving held {name} vs solo", res[i], solo[name],
                        None, FLOAT_SUM_RTOL_KERNEL)
    nxt = ctx.sql(tpch.QUERIES["q6"], query_id="held-victim").to_pandas()
    check_frame("serving after the held cancel", nxt, solo["q6"], None,
                FLOAT_SUM_RTOL_KERNEL)
    lanes_idle("serving held cancel", ctx)
    out["held_batch"] = {
        "cancelled": names[victim], "error": type(errs[victim]).__name__,
        "queries_coalesced": ss["queries_coalesced"]
        - ss0["queries_coalesced"],
        "wave_launches": ss["wave_launches"] - ss0["wave_launches"]}
    # 2. a zero timeout
    q6 = q6_spec(S, E)
    tctx = sdt.Context()
    tctx.store.register(lineitem_ds)
    import dataclasses
    try:
        tctx.execute(dataclasses.replace(
            q6, context=S.QueryContext(timeout_millis=0)))
        raise AssertionError("serving: timeout_millis=0 answered")
    except X.QueryTimeout as e:
        out["timeout"] = str(e)
    rev = q6_oracle(df)
    got = spies.run(lambda: tctx.execute(q6).to_pandas())
    np.testing.assert_allclose(got["revenue"].to_numpy(), [rev],
                               rtol=FLOAT_SUM_RTOL_ORACLE)
    lanes_idle("serving timeout", tctx)
    # 3. a cancel at a wave boundary: one segment per wave
    wctx = sdt.Context({"sdot.engine.wave.max.bytes": 1,
                        "sdot.cache.enabled": False})
    wctx.store.register(lineitem_ds)
    q1 = q1_spec(S, E)
    real_bind = X._WaveBinder.bind_wave
    bound_waves = []

    def bind_then_cancel(binder, segs):
        bound_waves.append(len(segs))
        if len(bound_waves) == 3:      # wave 2 bound: cancel before launch
            wctx.engine.cancel("wave-victim")
        return real_bind(binder, segs)
    X._WaveBinder.bind_wave = bind_then_cancel
    try:
        spies.run(lambda: wctx.execute(dataclasses.replace(
            q1, context=S.QueryContext(query_id="wave-victim"))))
        raise AssertionError("serving: the wave-boundary cancel answered")
    except X.QueryCancelled as e:
        out["wave_cancel"] = {"error": str(e), "waves_bound": len(bound_waves)}
    finally:
        X._WaveBinder.bind_wave = real_bind
    got = spies.run(lambda: wctx.execute(q1).to_pandas())
    st = wctx.engine.last_stats
    check_q1(got, q1_oracle(df))
    if st["waves"] < 4 or wctx.engine._device_arrays:
        raise AssertionError(f"serving wave cancel: {st['waves']} waves, "
                             f"{len(wctx.engine._device_arrays)} bound")
    out["wave_cancel"]["next_waves"] = st["waves"]
    lanes_idle("serving wave cancel", wctx)
    return out


def serving_phase(sdt, S, E, flat_ds, lineitem_ds, df, tables, CG,
                  CW) -> dict:
    """Phase serving: the result cache, WLM and cancellation around the
    engine, on phase sql's flat star with the defaults."""
    from spark_druid_olap_tpu_torch.tools import tpch
    t_phase = time.perf_counter()
    star = tpch.star_schema("tpch_flat")
    spies = KernelSpies(CG, CW)
    ctx = serving_context(sdt, flat_ds, star)
    ctx.store.register(lineitem_ds)
    stmts = hit_vs_miss(ctx, tpch, spies)
    # before any cache-off run: turning the key off and on again moves
    # the config fingerprint, and with it every key
    invalidation = invalidation_on_card(ctx, tables, tpch, spies)
    solo = {}
    for name in SQL_MAIN:
        with settings(ctx, {"sdot.cache.enabled": False}):
            solo[name] = ctx.sql(tpch.QUERIES[name]).to_pandas()
    subsumed = subsumption_on_card(ctx, S, spies)
    lanes_idle("serving", ctx)
    handoff = handoff_storm(sdt, flat_ds, star, tpch, solo, spies)
    cancel = cancel_on_card(sdt, S, E, flat_ds, star, lineitem_ds, df, tpch,
                            solo, spies)
    kernels = {"b1": b1_checked(CG, "serving", spies.b1),
               "b2": [wave_timed(CW, f"serving b2[{i}]", *w)
                      for i, w in enumerate(spies.b2)]}
    return dict(statements=stmts, subsumption=subsumed,
                invalidation=invalidation, handoff_storm=handoff,
                cancel=cancel, cache=ctx.engine.result_cache.stats(),
                b1_launches=spies.b1_launches, b2_launches=spies.b2_launches,
                kernels=kernels, seconds=time.perf_counter() - t_phase)


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

# SF1, the run's own lineitem without l_comment: cut from SF10 (the whole
# run took 1,007.9 s at SF10 on one H100, SF10's generation and ingest
# alone 412 s of host time), then from SF5 to make room for phases ssb,
# rollup, append and modules, from SF3 for phase persist and from SF2 for
# phase persist's tier and device-loss legs
WAVES_SF = 1.0
WAVES_Q1 = 6                # at most this many waves for Q1 under the budget
WAVES_MIN = 4               # waves every statement of the phase must take
WAVES_REPEATS = 3
# the hashed statement's key space (200,000 parts at SF1) over this dense
# ceiling, so it takes the hashed tier in both wave modes
WAVES_HASHED = {"sdot.engine.groupby.dense.max.keys": 1 << 17}
# the HAVING statement's 20,000 keys at SF1 (10,000 suppliers by 2 line
# statuses) over this device-HAVING floor, so its one-wave run takes
# device HAVING (the default floor, 65,536, held 100,000 keys at SF5)
WAVES_HAVING = {"sdot.engine.having.device.min.keys": 1 << 14}
WAVES_HAVING_MIN = 150      # lines per (supplier, status) in the HAVING
WAVES_LIMIT = 10


def waves_specs(S, E):
    """The phase's statements over lineitem as QuerySpecs: Q1 (B1 per
    wave), phase sketch's statement (B1 and the three register ops per
    wave), revenue by part (hashed tier, 400,000 groups at SF2) and a
    HAVING with an ordered LIMIT by supplier and line status (40,000 keys
    at SF2: device HAVING in one wave, the host under waves)."""
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
                ingest_kw=None, df=None, ds=None) -> dict:
    """Phase ``waves``: TPC-H lineitem at ``WAVES_SF`` without
    ``l_comment`` (``df`` and its datasource ``ds``, the run's own at that
    scale, seen without the column; else generated by the port's
    ``tools/tpch.generate`` and ingested) under a wave budget that gives
    Q1 ``WAVES_Q1`` waves. Each statement runs
    multi-wave (launch counts, every B1 / B2 launch of every wave against
    its plain version, per-wave bind / copy / compute, the overlap share),
    against the same statement in one wave (answers; cold and warm ms) and
    against pandas; the storm of 8 QuerySpecs takes one B2 launch per wave.
    Then the bind-cache repair: Q1 in one wave under a device cache cap
    below its bound bytes answers, with the cache dropped; then EXPLAIN
    (:func:`explain_leg`) and the cost model's calibration. ``sf``,
    ``device`` and ``ingest_kw`` (segment size) serve a rehearsal on the
    CPU at a tiny scale."""
    from spark_druid_olap_tpu_torch.parallel import cost as C
    from spark_druid_olap_tpu_torch.parallel import executor as X
    from spark_druid_olap_tpu_torch.tools.tpch import generate
    from spark_druid_olap_tpu_torch.segment.store import Datasource
    t_phase = time.perf_counter()
    base = sdt.Context(ENGINE_TIMED, device=device)
    t0 = time.perf_counter()
    if ds is None:
        if df is None:
            df = generate(sf, seed=SEED)["lineitem"]
        df = df.drop(columns="l_comment")
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds = base.ingest_dataframe("lineitem", df, time_column="l_shipdate",
                                   **(ingest_kw or {}))
        made = {"generate_s": t_gen, "ingest_s": time.perf_counter() - t0}
    else:
        # the run's frame and datasource seen without l_comment, shared,
        # not copied: view_s times that view, not a generation or ingest
        df = df.drop(columns="l_comment")
        ds = Datasource(ds.name, ds.time,
                        {k: d for k, d in ds.dims.items()
                         if k != "l_comment"}, dict(ds.metrics),
                        list(ds.segments), spatial=dict(ds.spatial))
        made = {"view_s": time.perf_counter() - t0}
    out = {"sf": sf, "card": smi, "rows": len(df),
           "segments": ds.num_segments, "padded_rows": ds.padded_rows,
           **made}

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
        ctx = sdt.Context({**config, **ENGINE_TIMED}, device=device)
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
        extra = {"hashed": WAVES_HASHED,
                 "having_limit": WAVES_HAVING}.get(name, {})
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

    # 4. EXPLAIN against the executed plans, and the calibration
    out["explain"] = explain_leg(context, multi, df, CG, CW)
    b1_all.append(out["explain"].pop("b1"))
    launches["dense_groupby"] += out["explain"]["b1_launches"]

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


def explain_leg(context, multi, df, CG, CW) -> dict:
    """EXPLAIN over phase waves' store: Q1's ``waves=NxM`` under the
    phase's wave budget equals the plan Q1 then runs; Q6 with compaction
    forced (in one wave) prints the late-materialize line whose survivor
    budget its run then takes; both answers against pandas. Then
    ``tools.calibrate.calibrate`` fits the single-device cost constants
    (seconds) on the store in one wave, not applied: each probe shape
    spied once, then its timed repeats."""
    from spark_druid_olap_tpu_torch.tools import calibrate as CAL
    from spark_druid_olap_tpu_torch.tools.tpch import QUERIES
    want = lineitem_sql_oracles(df)
    ctx = context(multi)
    out = {}
    with LaunchSpy(CG, CW) as spy:
        text = ctx.explain(QUERIES["q1"])
        got = ctx.sql(QUERIES["q1"]).to_pandas()
        st = ctx.history.entries()[-1].stats
        printed = [(int(a), int(b)) for a, b in
                   re.findall(r"waves=(\d+)x(\d+)seg", text)]
        check_sql("q1", got, want["q1"])
        if st["mode"] != "engine" \
                or printed != [(st["waves"], st["segments_per_wave"])]:
            raise AssertionError(f"explain: Q1 printed {printed}, ran "
                                 f"{st['waves']} x "
                                 f"{st['segments_per_wave']}: {text}")
        out["q1"] = dict(explain=text.split("\n")[-2:], waves=st["waves"],
                         segments_per_wave=st["segments_per_wave"])
        with settings(ctx, dict(COMPACT_FORCED, **{
                "sdot.engine.wave.max.bytes": 0})):
            text = ctx.explain(QUERIES["q6"])
            got = ctx.sql(QUERIES["q6"]).to_pandas()
            st = ctx.history.entries()[-1].stats
        check_sql("q6", got, want["q6"])
        m = re.search(r"scan: late-materialize to \[([\d,]+)\] survivors",
                      text)
        if m is None or st.get("compact_m") \
                != int(m.group(1).replace(",", "")):
            raise AssertionError(f"explain: Q6 compacted to "
                                 f"{st.get('compact_m')}: {text}")
        out["q6"] = dict(explain=text.split("\n")[-3:],
                         compact_m=st["compact_m"])
        with settings(ctx, {"sdot.engine.wave.max.bytes": 0}):
            shapes = CAL.default_shapes("lineitem",
                                        ctx.store.get("lineitem"))
            for q in shapes:
                ctx.execute(q)
    b1 = b1_checked(CG, "explain", spy.b1)
    if spy.b2 or not spy.b1:
        raise AssertionError(f"explain: {len(spy.b1)} B1 calls, "
                             f"{len(spy.b2)} B2")
    with settings(ctx, {"sdot.engine.wave.max.bytes": 0}):
        t0 = time.perf_counter()
        fitted = CAL.calibrate(ctx, "lineitem", apply=False)
        out["calibrate"] = dict(fitted=fitted,
                                seconds=time.perf_counter() - t0,
                                shapes=[repr(q.dimensions) for q in shapes])
    if not fitted["sdot.querycostmodel.historical.processing.cost"] > 0:
        raise AssertionError(f"calibrate: {fitted}")
    out["b1"], out["b1_launches"] = b1, spy.b1_launches
    return out


# -- the native encoder at ingest (phase "ingest") -----------------------------

def native_state() -> dict:
    """Whether the native string encoder built and loaded, and pyarrow's
    version. Where pyarrow and g++ are both present the encoder must load:
    a build failure may not hide behind the numpy path."""
    import shutil
    from spark_druid_olap_tpu_torch.segment import native
    mod = native.load()
    pa = native.pyarrow_version()
    gxx = shutil.which("g++")
    if mod is None and pa is not None and gxx is not None:
        raise AssertionError("ingest: pyarrow and g++ are present but the "
                             "native encoder did not build or load")
    return {"native_loaded": mod is not None, "pyarrow": pa,
            "gxx": gxx is not None}


def encoder_spy():
    """Wrap the native encoder's entry point: the columns it encoded and
    the columns it declined (which then take the numpy path), by name."""
    from spark_druid_olap_tpu_torch.segment import native
    real = native.encode_strings
    took = {"native": [], "numpy": []}

    def spy(raw):
        out = real(raw)
        took["numpy" if out is None else "native"].append(
            getattr(raw, "name", None))
        return out
    native.encode_strings = spy
    return took


def native_columns(state, took, where) -> dict:
    """The columns each encoder path took since ``took`` was last
    cleared; with the encoder loaded, a string column on the numpy path
    fails the run (TPC-H has no NULL strings, the one reason to take
    it)."""
    cols = {k: list(v) for k, v in took.items()}
    if state["native_loaded"] and cols["numpy"]:
        raise AssertionError(f"ingest ({where}): string columns took the "
                             f"numpy path: {cols['numpy']}")
    for v in took.values():
        v.clear()
    return cols


def native_pair(sdt, df, name, time_column, target_rows):
    """One table ingested with the native encoder and without it, in this
    run: seconds of each, and the two datasources equal column by
    column. Returns the summary and the datasource the encoder built."""
    from spark_druid_olap_tpu_torch.segment import native
    from spark_druid_olap_tpu_torch.segment.ingest import ingest_dataframe
    t0 = time.perf_counter()
    fast = ingest_dataframe(name, df, time_column=time_column,
                            target_rows=target_rows)
    t_fast = time.perf_counter() - t0
    # without the encoder: what a machine without g++ or pyarrow runs
    # (sequential numpy encoding, no thread pool)
    load, encode = native.load, native.encode_strings
    native.load, native.encode_strings = (lambda: None), (lambda raw: None)
    try:
        t0 = time.perf_counter()
        slow = ingest_dataframe(name, df, time_column=time_column,
                                target_rows=target_rows)
        t_slow = time.perf_counter() - t0
    finally:
        native.load, native.encode_strings = load, encode
    for k, d in fast.dims.items():
        s = slow.dims[k]
        if not (np.array_equal(np.asarray(d.dictionary, dtype=object),
                               np.asarray(s.dictionary, dtype=object))
                and d.codes.dtype == s.codes.dtype
                and np.array_equal(d.codes, s.codes)):
            raise AssertionError(f"ingest {name}.{k}: the native and numpy "
                                 f"paths differ")
    return {"table": name, "rows": len(df), "string_columns": len(fast.dims),
            "native_s": t_fast, "numpy_s": t_slow,
            "speedup": t_slow / max(t_fast, 1e-9)}, fast


# -- the spatial filter (phase "spatial") --------------------------------------

SPATIAL_DIMS = {"qty_price": ("l_quantity", "l_extendedprice")}
SPATIAL_SQL = ("select l_returnflag, count(*) as n, sum(l_extendedprice) "
               "as s, min(l_discount) as d from lineitem "
               "where l_quantity >= 10 and l_quantity <= 30 "
               "and l_extendedprice >= 15000 and l_extendedprice <= 25000 "
               "group by l_returnflag")
PRUNE_ROWS = 1 << 22
PRUNE_SEGMENT_ROWS = 1 << 19
PRUNE_SQL = ("select city, count(*) as c, sum(fare) as f from trips "
             "where lat >= 10 and lat <= 20 and lon >= -50 and lon <= 40 "
             "group by city")


def spied_b1(CG, calls):
    """Wrap the B1 wrapper: each call's inputs go to ``calls``; returns
    the undo."""
    real = CG.dense_groupby_kernel

    def spy(key, n_keys, inputs, max_keys, *a, **k):
        calls.append((key, n_keys, list(inputs), max_keys))
        return real(key, n_keys, inputs, max_keys, *a, **k)
    CG.dense_groupby_kernel = spy
    return lambda: setattr(CG, "dense_groupby_kernel", real)


def spied_sql_b1(ctx, sql, CG):
    """One statement with B1's launch count zeroed just before it and read
    just after: (frame, stats, launches, the B1 calls, host ms)."""
    calls = []
    undo = spied_b1(CG, calls)
    try:
        CG.launches = 0
        t = time.perf_counter()
        got = ctx.sql(sql).to_pandas()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launched = CG.launches
    finally:
        undo()
    return got, ctx.history.entries()[-1].stats, launched, calls, ms


def spatial_points(n, rng):
    """Points whose latitude grows with time, so time-contiguous segments
    have boxes that differ (``tests/test_spatial.py``'s frame, scaled)."""
    import pandas as pd
    return pd.DataFrame({
        "ts": pd.date_range("2020-01-01", periods=n, freq="s"),
        "lat": np.sort(rng.uniform(-60, 60, n)) + rng.normal(0, 0.5, n),
        "lon": rng.uniform(-170, 170, n),
        "city": rng.choice(["ny", "sf", "la", "chi"], n),
        "fare": np.round(rng.uniform(3, 80, n), 2)})


def spatial_phase(sdt, df, S, E, CG, CW) -> dict:
    """Phase ``spatial``: SF1 lineitem (without ``l_comment``) ingested
    with ``SPATIAL_DIMS``; a
    statement whose two ranges collapse into one ``SpatialFilter`` (B1)
    against pandas; the same filter as one lane of a three-lane storm (one
    B2 launch) against its solo answer; and pruning by bounding box on a
    synthetic table whose segments' boxes differ: segments pruned, the
    answer equal to the unpruned one and to pandas."""
    from spark_druid_olap_tpu_torch.planner import builder as B
    from spark_druid_olap_tpu_torch.sql.parser import parse_select
    t_phase = time.perf_counter()
    sp = sdt.Context(ENGINE_TIMED)
    # without l_comment, which no statement here reads (its 6M distinct
    # strings were most of this ingest's ~28 s; cut for the run's 900 s
    # when the server and cluster phases came)
    df = df.drop(columns="l_comment")
    t0 = time.perf_counter()
    ds = sp.ingest_dataframe("lineitem", df, time_column="l_shipdate",
                             spatial_dims=SPATIAL_DIMS)
    t_ingest = time.perf_counter() - t0
    f = B.build(sp, parse_select(SPATIAL_SQL)).specs[0].filter
    if not isinstance(f, S.SpatialFilter) \
            or f.axes != SPATIAL_DIMS["qty_price"]:
        raise AssertionError(f"spatial: the ranges did not collapse: {f}")
    got, st, launched, calls, cold_ms = spied_sql_b1(sp, SPATIAL_SQL, CG)
    if st["mode"] != "engine" or launched < 1 or len(got) < 2:
        raise AssertionError(f"spatial: mode {st['mode']!r}, {launched} "
                             f"B1 launches")
    m = df.l_quantity.between(10, 30) \
        & df.l_extendedprice.astype(np.float32).between(15000, 25000)
    want = df[m].groupby("l_returnflag").agg(
        n=("l_quantity", "size"), s=("l_extendedprice", "sum"),
        d=("l_discount", "min")).reset_index()
    want["d"] = want["d"].astype(np.float32).astype(np.float64)
    check_frame("spatial vs pandas", got, want, ["l_returnflag"],
                FLOAT_SUM_RTOL_ORACLE)
    warm = [timed_sql(sp, SPATIAL_SQL)[0] for _ in range(REPEATS)]

    # the filter as one lane of a storm: one B2 launch
    storm = sdt.Context(STORM_CONFIG)
    storm.store.register(ds)
    lane = S.GroupByQuerySpec(
        "lineitem", dimensions=(S.DimensionSpec("l_returnflag",
                                                "l_returnflag"),),
        aggregations=(S.AggregationSpec("count", "n"),
                      S.AggregationSpec("doublesum", "s",
                                        field="l_extendedprice")),
        filter=f)
    specs = [lane, q1_spec(S, E), q6_spec(S, E)]
    solo = [sp.execute(q).to_pandas() for q in specs]
    waves, real_wave = [], CW.wave_groupby

    def wave_spy(program, layout, columns):
        waves.append((program, layout, [c.reshape(-1) for c in columns]))
        return real_wave(program, layout, columns)
    st0 = storm.engine.sharedscan.stats()
    CW.wave_groupby = wave_spy
    try:
        CW.launches = 0
        CG.launches = 0
        res, storm_ms, _ = run_storm(storm, specs)
        torch.cuda.synchronize()
        b2, storm_b1 = CW.launches, CG.launches
    finally:
        CW.wave_groupby = real_wave
    st1 = storm.engine.sharedscan.stats()
    coalesced = st1["queries_coalesced"] - st0["queries_coalesced"]
    if b2 != 1 or coalesced != len(specs) or len(waves) != 1:
        raise AssertionError(f"spatial storm: {coalesced} coalesced, {b2} "
                             f"wave launches, reasons "
                             f"{st1['wave_fallback_reasons']}")
    for i, (g, w) in enumerate(zip(res, solo)):
        check_frame(f"spatial storm lane {i} vs solo", g, w, None,
                    FLOAT_SUM_RTOL_KERNEL)

    # pruning by bounding box on a table whose segments' boxes differ
    pts = spatial_points(PRUNE_ROWS, np.random.default_rng(SEED))
    pc = sdt.Context(ENGINE_TIMED)
    pds = pc.ingest_dataframe("trips", pts, time_column="ts",
                              target_rows=PRUNE_SEGMENT_ROWS,
                              spatial_dims={"pickup": ("lat", "lon")})
    pf = B.build(pc, parse_select(PRUNE_SQL)).specs[0].filter
    kept = pds.prune_segments(None, pf)
    pruned, pst, p_launched, p_calls, p_cold = spied_sql_b1(pc, PRUNE_SQL,
                                                            CG)
    if not 0 < len(kept) < pds.num_segments \
            or pst["segments"] != len(kept) or p_launched < 1:
        raise AssertionError(f"spatial pruning: kept {len(kept)} of "
                             f"{pds.num_segments}, statement scanned "
                             f"{pst['segments']}, {p_launched} launches")
    p_warm = [timed_sql(pc, PRUNE_SQL)[0] for _ in range(REPEATS)]
    pds._filter_keep_mask = lambda _f: np.ones(pds.num_segments, dtype=bool)
    try:
        full, fst, f_launched, f_calls, _ = spied_sql_b1(pc, PRUNE_SQL, CG)
        u_warm = [timed_sql(pc, PRUNE_SQL)[0] for _ in range(REPEATS)]
    finally:
        del pds._filter_keep_mask
    if fst["segments"] != pds.num_segments:
        raise AssertionError("spatial pruning: the unpruned run pruned")
    check_frame("spatial pruned vs unpruned", pruned, full, ["city"],
                FLOAT_SUM_RTOL_KERNEL)
    box = pts.lat.between(10, 20) & pts.lon.between(-50, 40)
    check_frame("spatial pruned vs pandas", pruned,
                pts[box].groupby("city").agg(
                    c=("fare", "size"), f=("fare", "sum")).reset_index(),
                ["city"], FLOAT_SUM_RTOL_ORACLE)
    return {
        "lineitem_ingest_s": t_ingest, "filter": {
            "axes": list(f.axes), "min": list(f.min_coords),
            "max": list(f.max_coords)},
        "statement": {"cold_ms": cold_ms,
                      "warm_median_ms": statistics.median(warm),
                      "segments": st["segments"], "groups": len(got),
                      "dense_groupby_launches": launched},
        "storm": {"lanes": len(specs), "queries_coalesced": coalesced,
                  "wave_launches": b2, "dense_groupby_launches": storm_b1,
                  "wall_ms": storm_ms},
        "pruning": {"rows": PRUNE_ROWS, "segments": pds.num_segments,
                    "kept": int(len(kept)),
                    "pruned_cold_ms": p_cold,
                    "pruned_warm_median_ms": statistics.median(p_warm),
                    "unpruned_warm_median_ms": statistics.median(u_warm),
                    "dense_groupby_launches": p_launched + f_launched},
        "b1_launches": launched + p_launched + f_launched,
        "b2_launches": b2,
        "b1": b1_checked(CG, "spatial", calls + p_calls + f_calls),
        "b2": wave_timed(CW, "spatial storm", *waves[0]),
        "seconds": time.perf_counter() - t_phase}


# -- the broadcast join tier (phase "join") ------------------------------------

JOIN_SQL = {
    "J1": ("select o_orderpriority, count(*) as c from orders o join "
           "customer c on o.o_custkey = c.c_custkey "
           "group by o_orderpriority"),
    # a residual and a build-side group; the probe filter is on
    # o_orderstatus: a range on o_orderdate (the time column) makes the JAX
    # package's recognizer decline, and the statement runs on its host tier
    "J2": ("select c_mktsegment, count(*) as n, sum(o_totalprice) as s, "
           "max(c_acctbal) as m from orders o join customer c "
           "on o.o_custkey = c.c_custkey "
           "and o.o_totalprice > c.c_acctbal * 20 "
           "where o.o_orderstatus = 'F' group by c_mktsegment"),
    # the residual keeps it off the partsupp star: without one, both
    # packages collapse partsupp x supplier onto partsupp_flat
    "J3": ("select s_nationkey, sum(ps_supplycost * ps_availqty) as v, "
           "count(*) as n from partsupp ps join supplier s "
           "on ps.ps_suppkey = s.s_suppkey "
           "and ps.ps_supplycost < s.s_acctbal group by s_nationkey"),
}
# J4: J1 over orders ingested again in smaller segments, under a wave
# budget that holds a JOIN_WAVES_MIN-th of their probe arrays
JOIN_SQL["J4"] = JOIN_SQL["J1"].replace("from orders o", "from orders_w o")
JOIN_WAVE_SEGMENT_ROWS = 1 << 18
JOIN_WAVES_MIN = 3


def _f32(s):
    """A float column as the store holds it (float32), read as float64."""
    return s.astype(np.float32).astype(np.float64)


def join_oracles(t) -> dict:
    o, c = t["orders"], t["customer"]
    oc = o.merge(c, left_on="o_custkey", right_on="c_custkey")
    j1 = oc.groupby("o_orderpriority").size().rename("c").reset_index()
    keep = (_f32(oc.o_totalprice) > _f32(oc.c_acctbal) * 20) \
        & (oc.o_orderstatus == "F")
    j2 = oc[keep].groupby("c_mktsegment").agg(
        n=("o_orderkey", "size"), s=("o_totalprice", "sum"),
        m=("c_acctbal", "max")).reset_index()
    j2["m"] = _f32(j2["m"])
    ps = t["partsupp"].merge(t["supplier"], left_on="ps_suppkey",
                             right_on="s_suppkey")
    ps = ps[_f32(ps.ps_supplycost) < _f32(ps.s_acctbal)]
    ps["v"] = _f32(ps.ps_supplycost) * ps.ps_availqty
    j3 = ps.groupby("s_nationkey").agg(v=("v", "sum"),
                                       n=("v", "size")).reset_index()
    return {"J1": j1, "J2": j2, "J3": j3, "J4": j1}


class Stopwatch:
    """Stream ms of the calls it wraps: CUDA events recorded before and
    after each call on a cuda device, host wall clock on the CPU (a
    rehearsal). The span between two events also holds the gaps while the
    host queues the call's work, so it bounds the call's device time from
    above."""

    def __init__(self):
        self.spans = []

    def wrap(self, module, name):
        real = getattr(module, name)

        def timed(*a, **k):
            if torch.cuda.is_available():
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = real(*a, **k)
                ev[1].record()
                self.spans.append(ev)
            else:
                t = time.perf_counter()
                out = real(*a, **k)
                self.spans.append((time.perf_counter() - t) * 1e3)
            return out
        setattr(module, name, timed)
        return lambda: setattr(module, name, real)

    def ms(self) -> float:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return sum(s if isinstance(s, float) else s[0].elapsed_time(s[1])
                   for s in self.spans)


def timed_steps(ctx, sql, parts) -> dict:
    """One warm run of ``sql`` with each ``(module, function)`` of
    ``parts`` timed: the stream ms of each (an upper bound on its device
    time), summed over its calls."""
    watches, undo = {}, []
    for label, (mod, fn) in parts.items():
        watches[label] = Stopwatch()
        undo.append(watches[label].wrap(mod, fn))
    try:
        ctx.sql(sql).to_pandas()
    finally:
        for u in undo:
            u()
    return {label: w.ms() for label, w in watches.items()}


def join_phase(sdt, ctx, tables, CG) -> dict:
    """Phase ``join``: J1-J4 on the broadcast tier over the SF1 star. Each
    against pandas and against the same statement on the host tier
    (``sdot.join.enabled`` false); cold and warm ms, ``last_stats["join"]``,
    the probe / expand and group-by stream ms. J4 is J1 over orders in
    smaller segments, under a wave budget that gives its probe at least
    ``JOIN_WAVES_MIN`` waves, equal to J1. That orders ingest is also the
    native encoder's on / off comparison; the encoder's datasource is the
    one registered."""
    from spark_druid_olap_tpu_torch.ops import groupby as G
    from spark_druid_olap_tpu_torch.ops import hash_join as HJ
    from spark_druid_olap_tpu_torch.ops.scan import array_names
    from spark_druid_olap_tpu_torch.parallel import cost as C
    t_phase = time.perf_counter()
    encoder, ow = native_pair(sdt, tables["orders"], "orders_w",
                              "o_orderdate", JOIN_WAVE_SEGMENT_ROWS)
    ctx.store.register(ow)
    budget = max(1, ow.num_segments // JOIN_WAVES_MIN) * C.bytes_per_segment(
        ow, array_names(ow, ["o_custkey", "o_orderpriority"], False))
    oracles = join_oracles(tables)
    out, calls, answers = {}, [], {}
    b1 = 0
    for name, sql in JOIN_SQL.items():
        if name == "J4":
            ctx.config.set("sdot.engine.wave.max.bytes", budget)
        try:
            got, st, launched, c, cold_ms = spied_sql_b1(ctx, sql, CG)
            js = dict(st.get("join") or {})
            if st["mode"] != "engine" or js.get("mode") != "broadcast" \
                    or launched < 1:
                raise AssertionError(f"join {name}: mode {st['mode']!r}, "
                                     f"join {js}, {launched} B1 launches")
            keys = [c_ for c_ in got.columns if got[c_].dtype.kind != "f"]
            check_frame(f"join {name} vs pandas", got, oracles[name], keys,
                        FLOAT_SUM_RTOL_ORACLE)
            warm = [timed_sql(ctx, sql)[0] for _ in range(REPEATS)]
            steps = timed_steps(ctx, sql, {
                "canonical_key_ms": (HJ, "canonical_key"),
                "probe_ms": (HJ, "probe"), "expand_ms": (HJ, "expand"),
                "groupby_ms": (G, "dense_groupby")})
            ctx.config.set("sdot.join.enabled", False)
            try:
                t = time.perf_counter()
                host = ctx.sql(sql).to_pandas()
                host_ms = (time.perf_counter() - t) * 1e3
                host_mode = ctx.history.entries()[-1].stats["mode"]
            finally:
                ctx.config.set("sdot.join.enabled", True)
            if not host_mode.startswith("host"):
                raise AssertionError(f"join {name}: tier off ran {host_mode}")
            check_frame(f"join {name} vs host tier", got, host, keys,
                        FLOAT_SUM_RTOL_ORACLE)
        finally:
            ctx.config.set("sdot.engine.wave.max.bytes", 0)
        if name == "J4":
            if js["waves"] < JOIN_WAVES_MIN:
                raise AssertionError(f"join J4: {js['waves']} waves")
            check_frame("join J4 vs J1", got, answers["J1"], keys, 0.0)
        answers[name] = got
        b1 += launched
        calls += c
        js.pop("build_ledger", None)
        out[name] = dict(cold_ms=cold_ms, warm_median_ms=statistics.median(
            warm), warm_min_ms=min(warm), host_tier_ms=host_ms,
            join=js, groups=len(got), dense_groupby_launches=launched,
            stream_ms=steps)
    return {"statements": out, "encoder": encoder, "b1_launches": b1,
            "b1": b1_checked(CG, "join", calls),
            "seconds": time.perf_counter() - t_phase}


# -- the window tier (phase "window") ------------------------------------------

WINDOW_REV = "sum(l_extendedprice * (1 - l_discount))"
WINDOW_SQL = {
    "W1": (f"select l_suppkey, {WINDOW_REV} as rev, rank() over "
           f"(order by {WINDOW_REV} desc) as r, dense_rank() over "
           f"(order by {WINDOW_REV} desc) as dr from lineitem "
           f"group by l_suppkey"),
    # o_orderkey breaks ties of o_orderdate: the moving frames are
    # order-dependent, so a unique order keeps the pandas reference exact
    "W2": ("select o_orderkey, o_custkey, o_orderdate, o_totalprice, "
           "sum(o_totalprice) over (partition by o_custkey order by "
           "o_orderdate, o_orderkey rows between 2 preceding and current "
           "row) as mv, lag(o_totalprice, 1) over (partition by o_custkey "
           "order by o_orderdate, o_orderkey) as prev from orders "
           "where o_orderdate >= date '1997-01-01'"),
    "W3": ("select o_orderkey, o_custkey, min(o_totalprice) over "
           "(partition by o_custkey order by o_orderdate, o_orderkey rows "
           "between 2 preceding and 1 following) as mn, max(o_totalprice) "
           "over (partition by o_custkey order by o_orderdate, o_orderkey "
           "rows between 2 preceding and 1 following) as mx, row_number() "
           "over (partition by o_custkey order by o_orderdate, o_orderkey) "
           "as rn from orders where o_orderdate >= date '1997-01-01'"),
}


def window_oracles(t) -> dict:
    """pandas references: W1's revenue per supplier (its ranks are checked
    against the statement's own revenue column, see ``window_phase``);
    W2 / W3 over the same orders, frames by grouped shifts."""
    import pandas as pd
    li = t["lineitem"]
    rev = (_f32(li.l_extendedprice) * (1 - _f32(li.l_discount))) \
        .groupby(li.l_suppkey).sum().rename("rev").reset_index()
    o = t["orders"]
    o = o[o.o_orderdate >= pd.Timestamp("1997-01-01")].sort_values(
        ["o_custkey", "o_orderdate", "o_orderkey"], kind="mergesort")
    o = o[["o_orderkey", "o_custkey", "o_totalprice"]].reset_index(drop=True)
    o["o_totalprice"] = _f32(o.o_totalprice)
    g = o.groupby("o_custkey")["o_totalprice"]
    w2 = o.copy()
    w2["mv"] = g.rolling(3, min_periods=1).sum().reset_index(
        level=0, drop=True)
    w2["prev"] = g.shift(1)
    w3 = o[["o_orderkey", "o_custkey"]].copy()
    lanes = [g.shift(k) for k in (-1, 0, 1, 2)]
    w3["mn"] = pd.concat(lanes, axis=1).min(axis=1)
    w3["mx"] = pd.concat(lanes, axis=1).max(axis=1)
    w3["rn"] = o.groupby("o_custkey").cumcount() + 1
    return {"W1": rev, "W2": w2.drop(columns="o_custkey"), "W3": w3}


def window_phase(ctx, tables) -> dict:
    """Phase ``window``: W1-W3 through ``Context.sql`` (mode
    ``engine+window``) against pandas; cold and warm ms; the stream ms of
    each window function (rank, offset, framed aggregate) in one warm
    run."""
    from spark_druid_olap_tpu_torch.window import exec as WX
    t_phase = time.perf_counter()
    oracles = window_oracles(tables)
    out = {}
    for name, sql in WINDOW_SQL.items():
        cold_ms, st = timed_sql(ctx, sql)
        got = ctx.sql(sql).to_pandas()
        if st["mode"] != "engine+window":
            raise AssertionError(f"window {name}: mode {st['mode']!r}")
        if name == "W1":
            check_frame("window W1 rev vs pandas", got[["l_suppkey", "rev"]],
                        oracles["W1"], ["l_suppkey"], FLOAT_SUM_RTOL_ORACLE)
            # ranks are a function of the statement's own revenue: float
            # sums within rtol may order near-equal suppliers either way
            r = got["rev"].rank(method="min", ascending=False)
            dr = got["rev"].rank(method="dense", ascending=False)
            if not (np.array_equal(got["r"], r.astype(np.int64))
                    and np.array_equal(got["dr"], dr.astype(np.int64))):
                raise AssertionError("window W1: ranks differ from pandas")
        else:
            check_frame(f"window {name} vs pandas", got, oracles[name],
                        ["o_orderkey"], FLOAT_SUM_RTOL_ORACLE)
        warm = [timed_sql(ctx, sql)[0] for _ in range(REPEATS)]
        out[name] = dict(
            cold_ms=cold_ms, warm_median_ms=statistics.median(warm),
            warm_min_ms=min(warm), rows=len(got),
            fns=st["window"]["fns"],
            stream_ms=timed_steps(ctx, sql, {
                "rank_ms": (WX, "_rank_kernel"),
                "offset_ms": (WX, "_offset_kernel"),
                "agg_ms": (WX, "_agg_kernel")}),
            window_ms=st["window"]["window_ms"])
    return {"statements": out, "seconds": time.perf_counter() - t_phase}


# -- SSB, rollups, stream append, modules (phases ssb, rollup, append,
# modules) -------------------------------------------------------------------

# BASELINE.json config 3 ("SSB SF30 — denormalized wide fact table"), cut
# to SF1 for the run's time limit: 6,000,000 lineorder rows
SSB_SF = 1.0
# the SSB statements the coalescer fuses into one wave launch: the q1
# flight (one group each); the others group by more keys than the fused
# group-by kernel's tier, which wave lanes must ride
SSB_STORM = ["q1.1", "q1.2", "q1.3"]
SSB_STORM_CONFIG = {
    "sdot.sharedscan.enabled": True,
    "sdot.sharedscan.max.queries": len(SSB_STORM),
    "sdot.wlm.batch.window.ms": 2000.0}
SSB_ORDER = {   # each statement's ORDER BY: (column, ascending)
    "q2": [("d_year", True), ("p_brand1", True)],
    "q3": [("d_year", True), ("lo_revenue", False)],
    "q4.1": [("d_year", True), ("c_nation", True)],
    "q4.2": [("d_year", True), ("s_nation", True), ("p_category", True)],
    "q4.3": [("d_year", True), ("s_city", True), ("p_brand1", True)]}
UK_CITIES = ["UNITED KI1", "UNITED KI5"]


class SsbOracle:
    """pandas answers for ``tools/ssb.QUERIES`` from the lineorder Parquet
    file and the generator's in-memory dimensions: each dimension column
    reaches the fact rows by its key (the dimension tables' keys are 1..n,
    the date table's rows are consecutive days), not through the flat
    file the engine ingests. Float measures are read as the store holds
    them (float32) and each row's expression is evaluated in float32, as
    the engine evaluates it, before the float64 sum: a difference of two
    measures (q4's profit) cancels, and rounding the other way would pass
    rtol 1e-6 of a small group's sum."""

    KEYS = {"d": ("date", "lo_orderdate"), "c": ("customer", "lo_custkey"),
            "s": ("supplier", "lo_suppkey"), "p": ("part", "lo_partkey")}

    def __init__(self, dims, lineorder_path):
        import pandas as pd
        import pyarrow.parquet as pq
        self.pd = pd
        self.dims = dims
        self.lo = pq.read_table(lineorder_path, columns=[
            "lo_orderdate", "lo_custkey", "lo_suppkey", "lo_partkey",
            "lo_quantity", "lo_extendedprice", "lo_discount", "lo_revenue",
            "lo_supplycost"]).to_pandas()
        self.cols = {}

    def col(self, name):
        if name in self.cols:
            return self.cols[name]
        pd = self.pd
        if name.startswith("lo_"):
            out = self.lo[name].to_numpy()
            if out.dtype.kind == "f":
                out = out.astype(np.float32)    # as the store holds it
        else:
            table, key = self.KEYS[name[0]]
            d = self.dims[table]
            if table == "date":
                first = d["d_datekey"].iloc[0]
                idx = ((self.lo[key] - first) // pd.Timedelta(days=1)) \
                    .to_numpy()
            else:
                idx = self.lo[key].to_numpy() - 1
            vals = d[name].to_numpy()
            if vals.dtype == object:
                codes, uniq = pd.factorize(vals)
                out = pd.Categorical.from_codes(codes[idx], uniq)
            else:
                out = vals[idx]
        self.cols[name] = out
        return out

    def isin(self, name, values):
        return np.asarray(self.pd.Series(self.col(name)).isin(values))

    def eq(self, name, value):
        return np.asarray(self.col(name) == value)

    def between(self, name, lo, hi):
        v = self.col(name)
        if isinstance(v, self.pd.Categorical):
            v = np.asarray(v, dtype=object)
        return (v >= lo) & (v <= hi)

    def mask(self, name):
        c = self.between
        q1 = {"q1.1": self.eq("d_year", 1993) & c("lo_discount", 1, 3)
              & (self.col("lo_quantity") < 25),
              "q1.2": self.eq("d_yearmonthnum", 199401)
              & c("lo_discount", 4, 6) & c("lo_quantity", 26, 35),
              "q1.3": self.eq("d_weeknuminyear", 6) & self.eq("d_year", 1994)
              & c("lo_discount", 5, 7) & c("lo_quantity", 26, 35)}
        if name in q1:
            return q1[name]
        years = c("d_year", 1992, 1997)
        us = lambda side: self.eq(f"{side}_nation", "UNITED STATES")
        am = lambda side: self.eq(f"{side}_region", "AMERICA")
        mfgr12 = self.isin("p_mfgr", ["MFGR#1", "MFGR#2"])
        uk = self.isin("c_city", UK_CITIES) & self.isin("s_city", UK_CITIES)
        late = self.isin("d_year", [1997, 1998])
        return {
            "q2.1": self.eq("p_category", "MFGR#12") & am("s"),
            "q2.2": c("p_brand1", "MFGR#2221", "MFGR#2228")
            & self.eq("s_region", "ASIA"),
            "q2.3": self.eq("p_brand1", "MFGR#2239")
            & self.eq("s_region", "EUROPE"),
            "q3.1": self.eq("c_region", "ASIA") & self.eq("s_region", "ASIA")
            & years,
            "q3.2": us("c") & us("s") & years,
            "q3.3": uk & years,
            "q3.4": uk & self.eq("d_yearmonth", "Dec1997"),
            "q4.1": am("c") & am("s") & mfgr12,
            "q4.2": am("c") & am("s") & late & mfgr12,
            "q4.3": us("s") & late & self.eq("p_category", "MFGR#14")}[name]

    def answer(self, name):
        """(frame, order): the statement's columns, sorted by its ORDER BY,
        and that order (None: one row)."""
        pd = self.pd
        m = self.mask(name)
        if name.startswith("q1"):
            rev = self.col("lo_extendedprice")[m] \
                * self.col("lo_discount")[m].astype(np.float32)
            return pd.DataFrame({"revenue": [rev.astype(np.float64)
                                             .sum()]}), None
        group = {"q2": ["d_year", "p_brand1"],
                 "q3.1": ["c_nation", "s_nation", "d_year"],
                 "q4.1": ["d_year", "c_nation"],
                 "q4.2": ["d_year", "s_nation", "p_category"],
                 "q4.3": ["d_year", "s_city", "p_brand1"]}
        keys = group.get(name[:2]) or group.get(name) \
            or ["c_city", "s_city", "d_year"]
        frame = pd.DataFrame({k: np.asarray(self.col(k))[m] for k in keys})
        if name.startswith("q4"):
            agg = "profit"
            frame[agg] = (self.col("lo_revenue")[m]
                          - self.col("lo_supplycost")[m]).astype(np.float64)
        else:
            agg = "lo_revenue"
            frame[agg] = self.col("lo_revenue")[m].astype(np.float64)
        out = frame.groupby(keys, sort=False)[agg].sum().reset_index()
        order = SSB_ORDER.get(name[:2]) or SSB_ORDER[name]
        out = out.sort_values([c for c, _ in order],
                              ascending=[a for _, a in order],
                              kind="mergesort").reset_index(drop=True)
        return out, [c for c, _ in order]


def q1_sql_oracle(df):
    """pandas answer of ``tools/tpch.QUERIES['q1']`` (Q1 through SQL: the
    averages, no ``sum_disc``)."""
    want = q1_oracle(df)
    for avg, total in (("avg_qty", "sum_qty"),
                       ("avg_price", "sum_base_price"),
                       ("avg_disc", "sum_disc")):
        want[avg] = want[total] / want["count_order"]
    return want.drop(columns="sum_disc")


def check_ssb(name, got, want, order):
    """The engine's frame against the oracle's: the same rows in the
    statement's order, keys and integers exact, sums rtol 1e-6."""
    if order is not None:
        keys = [c for c in want.columns if c in got.columns
                and want[c].dtype.kind != "f"]
        g = list(got[keys].itertuples(index=False, name=None))
        w = list(want[keys].itertuples(index=False, name=None))
        if g != w:
            raise AssertionError(f"ssb {name}: rows or their order differ "
                                 f"from the oracle: {g[:3]} vs {w[:3]}")
    check_frame(f"ssb {name} vs pandas", got, want, None,
                FLOAT_SUM_RTOL_ORACLE)


def _status_gb(key):
    """A ``/proc/self/status`` size line (``VmRSS``, ``VmHWM``), GB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024 / 1e9
    raise AssertionError(f"no {key} in /proc/self/status")


def rss_gb():
    """The process's resident set (``VmRSS``), GB."""
    return _status_gb("VmRSS")


class RssPeak:
    """The process's largest resident set while the ``with`` block runs,
    GB. The kernel's high-water mark ``VmHWM`` is reset to the current
    resident set on entry (``5`` written to ``/proc/self/clear_refs``) and
    read on exit, so nothing runs beside the timed block; where the reset
    is refused or does not take, ``VmRSS`` is read every 5 ms on a thread
    instead. ``method`` says which (``"hwm"`` or ``"poll"``)."""

    def __enter__(self):
        self.before = self.peak = rss_gb()
        self.thread = None
        try:
            with open("/proc/self/clear_refs", "w") as f:
                f.write("5")
            # a reset high-water mark sits at the resident set (+ 1%)
            reset = _status_gb("VmHWM") <= rss_gb() * 1.01 + 1e-3
        except (OSError, AssertionError):
            reset = False
        self.method = "hwm" if reset else "poll"
        if reset:
            return self
        import threading
        self.done = threading.Event()

        def poll():
            while not self.done.wait(0.005):
                self.peak = max(self.peak, rss_gb())
        self.thread = threading.Thread(target=poll, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        if self.thread is None:
            self.peak = max(self.peak, _status_gb("VmHWM"))
        else:
            self.done.set()
            self.thread.join()
        self.after = rss_gb()
        self.peak = max(self.peak, self.after)


def ssb_storm(ctx, sql_of, spies, solo) -> dict:
    """The q1 flight from threads under shared scan: one group, one wave
    launch, each answer equal to its solo answer."""
    with settings(ctx, SSB_STORM_CONFIG):
        queries = [sql_of[n] for n in SSB_STORM]
        run_storm(ctx, queries, call=ctx.sql)   # plans the statements once
        st0 = ctx.engine.sharedscan.stats()
        b1, b2 = spies.b1_launches, spies.b2_launches
        res, wall_ms, phases = spies.run(lambda: run_storm(
            ctx, queries, call=ctx.sql))
        st1 = ctx.engine.sharedscan.stats()
    out = {k: st1[k] - st0[k] for k in ("queries_coalesced",
                                        "wave_launches", "wave_fallbacks")}
    out.update(statements=SSB_STORM, wall_ms=wall_ms, phases_ms=phases,
               wave_kernel_launches=spies.b2_launches - b2,
               dense_groupby_launches=spies.b1_launches - b1,
               wave_fallback_reasons=st1["wave_fallback_reasons"])
    if out["queries_coalesced"] != len(SSB_STORM) \
            or out["wave_launches"] != 1 \
            or out["wave_kernel_launches"] != 1 \
            or out["dense_groupby_launches"] != 0:
        raise AssertionError(f"ssb storm: not {len(SSB_STORM)} statements "
                             f"in one wave launch: {out}")
    for n, frame in zip(SSB_STORM, res):
        check_frame(f"ssb storm {n} vs solo", frame, solo[n], None,
                    FLOAT_SUM_RTOL_KERNEL)
    return out


def ssb_phase(sdt, CG, CW, smi, sf=SSB_SF, ingest_kw=None) -> dict:
    """Phase ``ssb``: the SSB lineorder generated at ``sf`` straight into
    Parquet (``ssb.generate_stream``), star-joined chunk by chunk
    (``flatten_stream``) and streamed into ``ssb_flat``
    (``Context.ingest_parquet_stream``, its seconds and peak resident set);
    the 13 statements through ``Context.sql`` against pandas (cold, warm,
    tier, mode, the device's idle share), then the q1 flight as one
    storm."""
    import tempfile
    from spark_druid_olap_tpu_torch.tools import ssb
    t_phase = time.perf_counter()
    out = {"sf": sf, "card": smi}
    with tempfile.TemporaryDirectory(prefix="sdot_ssb_") as tmp:
        lo_path = str(pathlib.Path(tmp) / "lineorder.parquet")
        flat_path = str(pathlib.Path(tmp) / "ssb_flat.parquet")
        t0 = time.perf_counter()
        dims, n_lo = ssb.generate_stream(sf, lo_path, seed=SEED)
        out["generate_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["flat_rows"] = ssb.flatten_stream(dims, lo_path, flat_path)
        out["flatten_s"] = time.perf_counter() - t0
        out["lineorder_rows"] = n_lo
        out["flat_file_mb"] = pathlib.Path(flat_path).stat().st_size / 1e6
        ctx = sdt.Context(ENGINE_TIMED)

        def ingest():
            t0 = time.perf_counter()
            ds = ctx.ingest_parquet_stream("ssb_flat", flat_path,
                                           time_column="lo_orderdate",
                                           **(ingest_kw or {}))
            return ds, time.perf_counter() - t0
        with RssPeak() as rss:
            ds, out["ingest_s"] = ingest()
        out["ingest_rss_gb"] = {"before": rss.before, "peak": rss.peak,
                                "after": rss.after, "method": rss.method}
        if rss.method == "poll":
            # the poller's thread shares the GIL with the ingest: the
            # seconds are taken again from an ingest with nothing beside it
            out["ingest_polled_s"] = out["ingest_s"]
            ds = None
            ds, out["ingest_s"] = ingest()
        out["store_gb"] = sum(
            c.codes.nbytes for c in ds.dims.values()) / 1e9 + sum(
            m.values.nbytes for m in ds.metrics.values()) / 1e9
        out["segments"], out["columns"] = ds.num_segments, \
            len(ds.column_names())
        oracle = SsbOracle(dims, lo_path)
    if out["flat_rows"] != n_lo or ds.num_rows != n_lo:
        raise AssertionError(f"ssb: {n_lo} lineorder rows, {out['flat_rows']}"
                             f" flat, {ds.num_rows} ingested")
    ctx.register_star_schema(ssb.star_schema("ssb_flat"))
    spies = KernelSpies(CG, CW)
    counted = {"dense_groupby": CG, "wave": CW}
    stmts, solo = {}, {}
    for name, sql in ssb.QUERIES.items():
        b1, b2 = spies.b1_launches, spies.b2_launches
        t = time.perf_counter()
        got = spies.run(lambda: ctx.sql(sql).to_pandas())
        cold = (time.perf_counter() - t) * 1e3
        st = dict(ctx.history.entries()[-1].stats)
        if st["mode"] != "engine" or spies.b2_launches != b2:
            raise AssertionError(f"ssb {name}: mode {st['mode']!r}, "
                                 f"{spies.b2_launches - b2} wave launches")
        want, order = oracle.answer(name)
        check_ssb(name, got, want, order)
        if st.get("route") == "kernel" and spies.b1_launches == b1:
            raise AssertionError(f"ssb {name}: kernel route, no B1 launch")
        warm = [timed_sql(ctx, sql)[0] for _ in range(REPEATS)]
        prof = profile_run(lambda: timed_sql(ctx, sql)[0], counted)
        solo[name] = got
        stmts[name] = dict(
            cold_ms=cold, warm_median_ms=statistics.median(warm),
            warm_min_ms=min(warm), warm_max_ms=max(warm), mode=st["mode"],
            route=st.get("route"), hashed=bool(st.get("hashed")),
            groups=st.get("groups"), rows=len(got),
            b1_launches=spies.b1_launches - b1,
            device_idle_share=prof["device_idle_share"],
            device_busy_ms=prof["device_busy_ms"])
    del oracle
    out["statements"] = stmts
    out["storm"] = ssb_storm(ctx, ssb.QUERIES, spies, solo)
    out["kernels"] = {"b1": b1_checked(CG, "ssb", spies.b1),
                      "b2": [wave_timed(CW, f"ssb b2[{i}]", *w)
                             for i, w in enumerate(spies.b2)]}
    out["b1_launches"], out["b2_launches"] = spies.b1_launches, \
        spies.b2_launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase rollup: a lineitem rollup by flag, status and ship mode serves Q1;
# Q6 filters on l_discount and l_quantity and sums l_extendedprice *
# l_discount, none of which that rollup keeps, so Q6 gets a rollup of its
# own
ROLLUP_Q1 = (
    "create rollup li_q1 on lineitem dimensions (l_returnflag, "
    "l_linestatus, l_shipmode) aggregations (sum(l_quantity), "
    "sum(l_extendedprice), sum(l_extendedprice * (1 - l_discount)), "
    "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)), "
    "sum(l_discount), count(*)) granularity day")
ROLLUP_Q6 = (
    "create rollup li_q6 on lineitem dimensions (l_discount, l_quantity) "
    "aggregations (sum(l_extendedprice * l_discount), count(*)) "
    "granularity day")
ROLLUP_SSB = (     # tests/test_rollup.py:52-57
    "create rollup ssb_cube on ssb_flat dimensions ("
    "d_year, d_yearmonthnum, d_weeknuminyear, d_yearmonth, "
    "c_city, c_nation, c_region, s_city, s_nation, s_region, "
    "p_mfgr, p_category, p_brand1, lo_discount, lo_quantity) "
    "aggregations (sum(lo_extendedprice * lo_discount), sum(lo_revenue), "
    "sum(lo_revenue - lo_supplycost), count(*))")
# tests/test_rollup.py's tolerance for a rollup answer against its base
# (conftest.assert_frames_equal): the rollup sums stored f64 partials
ROLLUP_RTOL = 1e-4
REWRITE = "sdot.mv.rewrite.enabled"
ROLLUP_APPEND_ROWS = 250_000
# the SSB cube's base: SSB at this scale, generated in memory (cut from
# phase ssb's SF1 store, whose host build of the cube took 65.7 s, to make
# room for phase persist's tier and device-loss legs)
ROLLUP_CUBE_SF = 0.1


def rollup_served(ctx, sql, spies, want_status):
    """One statement with the rewrite on and off (each run once spied,
    then ``REPEATS`` times timed): the rewrite leg's status, both frames
    and each leg's warm median ms."""
    got = spies.run(lambda: ctx.sql(sql).to_pandas())
    status = ctx.history.entries()[-1].stats.get("rollup")
    if status != want_status:
        raise AssertionError(f"rollup: {sql.split()[:6]} served from "
                             f"{status}, want {want_status}")
    ms = statistics.median(timed_sql(ctx, sql)[0] for _ in range(REPEATS))
    with settings(ctx, {REWRITE: False}):
        base = spies.run(lambda: ctx.sql(sql).to_pandas())
        base_ms = statistics.median(timed_sql(ctx, sql)[0]
                                    for _ in range(REPEATS))
    return got, base, ms, base_ms


def rollup_build(ctx, sql, spies) -> dict:
    """CREATE ROLLUP, timed; ``host_tier``: whether its group-by fell to
    the host tier (a key space the engine does not pack)."""
    from spark_druid_olap_tpu_torch.planner import host_exec as HX
    real, host = HX.execute_select, []

    def on_host(*a, **k):
        host.append(1)
        return real(*a, **k)
    HX.execute_select = on_host
    try:
        t = time.perf_counter()
        msg = spies.run(lambda: ctx.sql(sql).to_pandas())["status"][0]
        ms = (time.perf_counter() - t) * 1e3
    finally:
        HX.execute_select = real
    name = sql.split()[2]
    r = ctx.rollups[name]
    return {"status": msg, "build_ms": ms, "host_tier": bool(host),
            "rows": ctx.store.get(r.backing).num_rows,
            "base_rows": ctx.store.get(r.base).num_rows,
            "time_identity": r.time_identity}


def rollup_phase(sdt, lineitem_ds, df, CG, CW, smi,
                 cube_sf=ROLLUP_CUBE_SF) -> dict:
    """Phase ``rollup``: the lineitem rollups over phase sql's SF1
    lineitem (build ms, rows, ``sys_rollups``); Q1 and Q6 from them
    against the rewrite off (ints exact, floats ``ROLLUP_RTOL``) and
    pandas; one append, after which the base answers, then REFRESH, after
    which the rollups answer again, each against pandas; then the SSB
    cube over ``ssb_flat`` at ``cube_sf`` (its 15 dimensions' key space
    packs into no engine key, so the build's group-by runs on the host
    tier, in both packages) and the 13 SSB statements it serves against
    the rewrite off."""
    import pandas as pd
    from spark_druid_olap_tpu_torch.tools import ssb, tpch
    t_phase = time.perf_counter()
    spies = KernelSpies(CG, CW)
    ctx = sdt.Context(ENGINE_TIMED)
    ctx.store.register(lineitem_ds)
    out = {"card": smi, "builds": {}}
    for sql in (ROLLUP_Q1, ROLLUP_Q6):
        out["builds"][sql.split()[2]] = rollup_build(ctx, sql, spies)
    out["sys_rollups"] = ctx.sql("select * from sys_rollups").to_pandas() \
        .to_dict("records")
    stmts = {"q1": "li_q1", "q6": "li_q6"}

    def against_pandas(name, got, frame):
        if name == "q1":
            check_frame("rollup q1 vs pandas", got, q1_sql_oracle(frame),
                        None, FLOAT_SUM_RTOL_ORACLE)
        else:
            np.testing.assert_allclose(got["revenue"].to_numpy(),
                                       [q6_oracle(frame)],
                                       rtol=FLOAT_SUM_RTOL_ORACLE)

    def served(tag, frame, fresh):
        res = {}
        for name, rollup in stmts.items():
            sql = tpch.QUERIES[name]
            got, base, ms, base_ms = rollup_served(
                ctx, sql, spies, f"rollup:{rollup}" if fresh else "base")
            check_frame(f"rollup {tag} {name} vs rewrite off", got, base,
                        None, ROLLUP_RTOL)
            against_pandas(name, got, frame)
            res[name] = {"warm_ms": ms, "rewrite_off_warm_ms": base_ms,
                         "status": "rollup:" + rollup if fresh else "base"}
        return res

    out["fresh"] = served("fresh", df, True)
    batch = df.sample(n=ROLLUP_APPEND_ROWS, random_state=SEED) \
        .reset_index(drop=True)
    t = time.perf_counter()
    ctx.stream_ingest("lineitem", batch, time_column="l_shipdate")
    out["append_ms"] = (time.perf_counter() - t) * 1e3
    full = pd.concat([df, batch], ignore_index=True)
    view = ctx.sql("select name, fresh from sys_rollups").to_pandas()
    if view["fresh"].any():
        raise AssertionError(f"rollup: fresh after an append: {view}")
    out["stale"] = served("stale", full, False)
    out["refresh_ms"] = {}
    for name in ("li_q1", "li_q6"):
        t = time.perf_counter()
        spies.run(lambda: ctx.sql(f"refresh rollup {name}"))
        out["refresh_ms"][name] = (time.perf_counter() - t) * 1e3
    out["refreshed"] = served("refreshed", full, True)
    del full, batch

    # the SSB cube: a wide-key build on the hashed tier
    sctx = sdt.Context(ENGINE_TIMED)
    t = time.perf_counter()
    flat = ssb.flatten(ssb.generate(cube_sf, seed=SEED))
    sctx.ingest_dataframe("ssb_flat", flat, time_column="lo_orderdate")
    out["cube_base"] = dict(sf=cube_sf, rows=len(flat),
                            setup_s=time.perf_counter() - t)
    del flat
    sctx.register_star_schema(ssb.star_schema("ssb_flat"))
    out["builds"]["ssb_cube"] = rollup_build(sctx, ROLLUP_SSB, spies)
    ssb_stmts = {}
    for name, sql in ssb.QUERIES.items():
        got, base, ms, base_ms = rollup_served(sctx, sql, spies,
                                               "rollup:ssb_cube")
        check_frame(f"rollup ssb {name} vs rewrite off", got, base, None,
                    ROLLUP_RTOL)
        ssb_stmts[name] = {"warm_ms": ms, "rewrite_off_warm_ms": base_ms}
    out["ssb"] = ssb_stmts
    out["kernels"] = {"b1": b1_checked(CG, "rollup", spies.b1),
                      "b2": [wave_timed(CW, f"rollup b2[{i}]", *w)
                             for i, w in enumerate(spies.b2)]}
    out["b1_launches"], out["b2_launches"] = spies.b1_launches, \
        spies.b2_launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase append: 4 batches of 250,000 lineitem rows; each brings a return
# flag new to the dictionary (it sorts among the old ones, so the old
# codes remap and Q1 groups one more flag) and a value that widens a
# metric's stored dtype
APPEND_ROWS = 250_000
APPEND_FLAGS = ["B", "D", "M", "P"]
APPEND_WIDEN = [("l_quantity", 200, "int16"), ("l_quantity", 40_000, "int32"),
                ("l_quantity", 3_000_000_000, "int64"),
                ("l_linenumber", 1_000, "int16")]


def append_batch(df, i):
    b = df.sample(n=APPEND_ROWS, random_state=SEED + 1 + i) \
        .reset_index(drop=True)
    b.loc[::997, "l_returnflag"] = APPEND_FLAGS[i]
    col, value, _ = APPEND_WIDEN[i]
    b.loc[7, col] = value
    return b


def append_phase(sdt, S, E, lineitem_ds, df, CG, CW, smi) -> dict:
    """Phase ``append``: ``Context.stream_ingest`` of 4 batches
    into a copy of SF1 lineitem (its own context, with the defaults: the
    result cache on). Before each batch Q1 is cached (a hit); after it Q1
    is a miss (the cache's version check) and equals pandas over the
    concatenated frame (B1), and the storm of 8 QuerySpecs (one B2 launch)
    equals pandas too; the dictionary grows by the batch's flag and the
    widened column holds its new dtype."""
    import pandas as pd
    t_phase = time.perf_counter()
    spies = KernelSpies(CG, CW)
    ctx = sdt.Context()
    ctx.store.register(lineitem_ds)
    storm = sdt.Context(STORM_CONFIG)
    specs = storm_specs(S, E)
    names, slist = list(specs), list(specs.values())
    q1 = q1_spec(S, E)
    full, out = df, {"card": smi, "batches": []}
    for i in range(len(APPEND_FLAGS)):
        ctx.execute(q1)
        ctx.execute(q1)
        if ctx.engine.last_stats.get("cache") != "hit":
            raise AssertionError(
                f"append {i}: Q1 before the batch is not cached: "
                f"{ctx.engine.last_stats.get('cache')}")
        batch = append_batch(df, i)
        t = time.perf_counter()
        ds = ctx.stream_ingest("lineitem", batch, time_column="l_shipdate")
        ingest_ms = (time.perf_counter() - t) * 1e3
        full = pd.concat([full, batch], ignore_index=True)
        col, _, dtype = APPEND_WIDEN[i]
        flags = list(ds.dims["l_returnflag"].dictionary)
        if str(ds.metrics[col].values.dtype) != dtype \
                or APPEND_FLAGS[i] not in flags:
            raise AssertionError(f"append {i}: {col} stored as "
                                 f"{ds.metrics[col].values.dtype}, want "
                                 f"{dtype}; flags {flags}")
        b1 = spies.b1_launches
        t = time.perf_counter()
        r1 = spies.run(lambda: ctx.execute(q1).to_pandas())
        q1_ms = (time.perf_counter() - t) * 1e3
        st = dict(ctx.engine.last_stats)
        if st.get("cache") != "miss" or spies.b1_launches == b1:
            raise AssertionError(f"append {i}: Q1 after the batch: cache "
                                 f"{st.get('cache')}, B1 launches "
                                 f"{spies.b1_launches - b1}")
        check_q1(r1, q1_oracle(full))
        storm.store.register(ds)
        ss0 = storm.engine.sharedscan.stats()
        b2 = spies.b2_launches
        res, storm_ms, _ = spies.run(lambda: run_storm(storm, slist))
        ss1 = storm.engine.sharedscan.stats()
        coalesced = ss1["queries_coalesced"] - ss0["queries_coalesced"]
        if coalesced != len(slist) or spies.b2_launches - b2 != 1:
            raise AssertionError(f"append {i}: storm coalesced {coalesced}, "
                                 f"{spies.b2_launches - b2} wave launches, "
                                 f"{ss1['wave_fallback_reasons']}")
        got = dict(zip(names, res))
        check_q1(got["q1"], q1_oracle(full))
        np.testing.assert_allclose(got["q6"]["revenue"].to_numpy(),
                                   [q6_oracle(full)],
                                   rtol=FLOAT_SUM_RTOL_ORACLE)
        for name, (keys, want) in storm_oracles(full).items():
            check_frame(f"append {i} storm {name} vs pandas", got[name],
                        want, keys, FLOAT_SUM_RTOL_ORACLE)
        out["batches"].append(dict(
            rows=ds.num_rows, segments=ds.num_segments,
            stream_ingest_ms=ingest_ms, q1_ms=q1_ms, q1_cache=st["cache"],
            storm_ms=storm_ms, flags=flags,
            widened={col: str(ds.metrics[col].values.dtype)}))
    out["kernels"] = {"b1": b1_checked(CG, "append", spies.b1),
                      "b2": [wave_timed(CW, f"append b2[{i}]", *w)
                             for i, w in enumerate(spies.b2)]}
    out["b1_launches"], out["b2_launches"] = spies.b1_launches, \
        spies.b2_launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase persist: durable persistence over SF1 lineitem — checkpoints raw
# and encoded, recovery, journaled appends, a kill -9, compaction and the
# SQL surface, each statement over recovered, replayed or compacted data
PERSIST_SMALL_ROWS = 10_000      # each producer thread's batches
PERSIST_PRODUCERS = 4
PERSIST_PRODUCER_BATCHES = 4    # 8 in PR 13: cut for the run's 900 s
CRASH_SF = 0.05                  # the kill -9 child's frame
CRASH_BATCH_ROWS = 1_000
CRASH_PRODUCERS = 2
CRASH_MIN_ACKS = 3
CRASH_TIMEOUT_S = 180.0
CRASH_DEVICE = "cuda"            # the child's context


def store_diffs(a, b) -> list:
    """Where two datasources differ (empty when equal bit for bit):
    segments, time, each dimension's dictionary, codes and validity, each
    metric's kind, dtype, values and validity."""
    out = []

    def arr(x, y, what):
        if x is None or y is None:
            if (x is None) != (y is None):
                out.append(what)
        elif x.dtype != y.dtype or not np.array_equal(x, y):
            out.append(what)
    if [(s.id, s.start_row, s.end_row, s.min_millis, s.max_millis)
            for s in a.segments] != \
            [(s.id, s.start_row, s.end_row, s.min_millis, s.max_millis)
             for s in b.segments]:
        out.append("segments")
    if (a.time is None) != (b.time is None):
        out.append("time")
    elif a.time is not None:
        arr(a.time.days, b.time.days, "time days")
        arr(a.time.ms_in_day, b.time.ms_in_day, "time ms")
    if list(a.dims) != list(b.dims) or list(a.metrics) != list(b.metrics):
        out.append("schema")
        return out
    for k in a.dims:
        if len(a.dims[k].dictionary) != len(b.dims[k].dictionary) \
                or list(a.dims[k].dictionary) != list(b.dims[k].dictionary):
            out.append(f"{k} dictionary")
        arr(a.dims[k].codes, b.dims[k].codes, f"{k} codes")
        arr(a.dims[k].validity, b.dims[k].validity, f"{k} validity")
    for k in a.metrics:
        if a.metrics[k].kind != b.metrics[k].kind:
            out.append(f"{k} kind")
        arr(a.metrics[k].values, b.metrics[k].values, f"{k} values")
        arr(a.metrics[k].validity, b.metrics[k].validity, f"{k} validity")
    return out


def column_codecs(manifest) -> dict:
    """Column -> codec of its data blob (``raw`` where the chooser kept
    it raw), from a snapshot manifest."""
    enc = (manifest.get("encoding") or {}).get("columns", {})
    out = {}
    if manifest["time"] is not None:
        t = manifest["time"]
        out[t["name"]] = {"days": enc.get(t["days"], "raw"),
                          "ms": enc.get(t["ms"], "raw")}
    for e in manifest["dims"] + manifest["metrics"]:
        rel = e.get("codes") or e.get("values")
        out[e["name"]] = enc.get(rel, "raw")
    return out


def padded(ds) -> int:
    return ds.num_segments * ds.padded_rows


def storm_answers(storm, ds, slist, spies):
    """The storm of 8 QuerySpecs over ``ds`` (registered into the storm
    context): one B2 launch, its frames and wall ms."""
    storm.store.register(ds)
    ss0 = storm.engine.sharedscan.stats()
    b2 = spies.b2_launches
    res, ms, _ = spies.run(lambda: run_storm(storm, slist))
    ss1 = storm.engine.sharedscan.stats()
    if ss1["queries_coalesced"] - ss0["queries_coalesced"] != len(slist) \
            or spies.b2_launches - b2 != 1:
        raise AssertionError(f"persist storm: {spies.b2_launches - b2} "
                             f"wave launches, "
                             f"{ss1['wave_fallback_reasons']}")
    return res, ms


def persist_oracles(df) -> dict:
    """pandas answers of Q1, Q6 and the storm over ``df``, computed once
    for every check against the same frame."""
    return {"q1": q1_oracle(df), "q6": q6_oracle(df),
            "storm": storm_oracles(df)}


def check_storm_oracle(what, names, res, want):
    """The storm's answers ``res`` against ``want`` (persist_oracles)."""
    got = dict(zip(names, res))
    check_q1(got["q1"], want["q1"])
    np.testing.assert_allclose(got["q6"]["revenue"].to_numpy(),
                               [want["q6"]], rtol=FLOAT_SUM_RTOL_ORACLE)
    for name, (keys, w) in want["storm"].items():
        check_frame(f"{what} storm {name} vs pandas", got[name], w, keys,
                    FLOAT_SUM_RTOL_ORACLE)


# the tier leg of phase persist: step (a)'s SF1 roots recovered as tiered
# datasources (tier/) under a hot-set budget of a quarter of Q1's bound
# bytes and a per-wave I/O cap that gives Q1 on the raw root 3 waves; then
# Q1 cold again under a second budget that holds TIER_PREFETCH_WAVES of
# those waves, where the prefetcher's chunks stay hot until their bind
TIER_BUDGET_SHARE = 4
TIER_Q1_WAVES = 3
TIER_PREFETCH_WAVES = 2


class ResidentSampler:
    """Within the block, a thread samples the hot set every millisecond:
    its resident bytes and, under the store's lock, the bytes pinned by
    in-flight queries; ``peak`` and ``peak_pinned`` are the largest seen,
    ``over`` the samples whose residency passed budget + pinned."""

    def __init__(self, tier):
        self.tier = tier
        self.peak = self.peak_pinned = self.samples = 0
        self.over = []

    def _sample(self):
        t = self.tier
        with t._lock:
            hot = t._bytes
            pinned = sum(e.nbytes for k, e in t._hot.items()
                         if t._pins.get(k))
        self.peak = max(self.peak, hot)
        self.peak_pinned = max(self.peak_pinned, pinned)
        self.samples += 1
        if hot > t.budget + pinned:
            self.over.append((hot, pinned))

    def __enter__(self):
        import threading
        self.stop = threading.Event()

        def loop():
            while not self.stop.wait(0.001):
                self._sample()
        self.thread = threading.Thread(target=loop, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self._sample()
        return False


def tier_delta(before, after) -> dict:
    """The hot set's counters one run moved, and its residency after."""
    keys = ("faults", "hits", "bytes_faulted", "evictions", "bytes_evicted",
            "crc_verified_files", "prefetch_submitted", "prefetch_loaded",
            "prefetch_hits", "prefetch_hit_bytes", "decode_ms_saved")
    out = {k: after[k] - before[k] for k in keys}
    out.update(hot_bytes=after["hot_bytes"],
               decoded_cache_bytes=after["decoded_cache_bytes"],
               pinned_entries=after["pinned_entries"])
    return out


def same_plan_budget(st) -> int:
    """The wave budget under which an in-memory scan takes the waves a
    tiered run took (``sdot.engine.wave.max.bytes``: segments per wave
    times the bytes one segment binds, read off the first wave's copy);
    0 (the default) for a run in one wave."""
    if st.get("waves", 1) <= 1:
        return 0
    return int(st["wave_steps"][0]["h2d_bytes"])


def tier_run(tctx, run, stats_of, spies, spied):
    """One run of a statement over the tiered store (``spied``: its B1 /
    B2 calls kept for the checks against the plain versions): its answer,
    wall ms, waves, the hot set's counters, peak residency against budget
    + pinned, the demand path's fault and decode ms (``tier.fault`` /
    ``tier.decode``, this thread) and the waves' steps."""
    from spark_druid_olap_tpu_torch.utils import phases as PH
    tier = tctx.persist.tier
    s0 = tier.stats_snapshot()
    tok = PH.begin()
    with ResidentSampler(tier) as rs:
        t = time.perf_counter()
        got = spies.run(run) if spied else run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
    ph = PH.end(tok) or {}
    if rs.over:
        raise AssertionError(f"tier: residency {rs.over[:3]} over budget "
                             f"{tier.budget} + pinned")
    st = stats_of()
    if st.get("waves", 1) > 1 and st.get("wave_steps"):
        # the binder pins a wave's chunks only while it builds the wave
        wave = max(w["h2d_bytes"] for w in st["wave_steps"])
        if rs.peak_pinned > wave:
            raise AssertionError(f"tier: {rs.peak_pinned} bytes pinned, "
                                 f"more than one wave's {wave}")
    r = dict(ms=ms, waves=st.get("waves", 1),
             segments_per_wave=st.get("segments_per_wave"),
             tier=tier_delta(s0, tier.stats_snapshot()),
             peak_resident_bytes=rs.peak, peak_pinned_bytes=rs.peak_pinned,
             budget_bytes=tier.budget, samples=rs.samples,
             fault_ms=ph.get("tier.fault", 0.0),
             decode_ms=ph.get("tier.decode", 0.0))
    if st.get("wave_steps"):
        r["steps"] = wave_summary(st["wave_steps"], ms)
    return got, r, st


def tier_leg(sdt, S, E, roots, eager, before, want_df, storm, spies,
             rec) -> dict:
    """Phase persist's tier leg: a fresh context over each of step (a)'s
    roots with ``sdot.tier.enabled`` (boot ms against step (b)'s eager
    recovery), Q1, Q6 (B1) and the storm (B2) each cold (the hot set and
    the engine's caches dropped first, so every chunk faults and every
    blob's CRC is checked again; its B1 / B2 calls held against the plain
    versions) and warm; every answer bit for bit
    against the eager context of step (b) under the same wave plan,
    against step (b)'s one-wave answers (ints exact, floats rtol 1e-9)
    and against pandas; a waved run never pins more than one wave's
    bytes. Then Q1 cold under a second budget that holds
    ``TIER_PREFETCH_WAVES`` of its waves: bit for bit against the first
    setting's cold answer, with ``prefetch_hit_bytes`` above 0."""
    from spark_druid_olap_tpu_torch.parallel import cost as C
    from spark_druid_olap_tpu_torch.tier.handles import TieredDatasource
    q1, q6 = q1_spec(S, E), q6_spec(S, E)
    specs = storm_specs(S, E)
    names, slist = list(specs), list(specs.values())
    # the configuration, reckoned on the raw root's eager store: Q1's bound
    # bytes as cost.bytes_per_segment reckons them over its segments, and
    # the bytes a raw segment of Q1's arrays faults (its real rows)
    eds = eager["raw"].store.get("lineitem")
    seg = eds.prune_segments(q1.intervals, q1.filter)
    q1_names = eager["raw"].engine._plan_agg(
        eds, seg, list(q1.dimensions), q1.aggregations, q1.granularity,
        q1.filter, q1.intervals)[5]
    q1_bytes = C.bytes_per_segment(eds, q1_names) * len(seg)
    budget = q1_bytes // TIER_BUDGET_SHARE
    raw_seg_io = max(s.num_rows for s in eds.segments) * sum(
        C.array_itemsize(eds, k) for k in q1_names if k != "__rows__")
    spw = -(-len(seg) // TIER_Q1_WAVES)
    io = int((spw + 0.5) * raw_seg_io)
    prefetch_budget = TIER_PREFETCH_WAVES * io
    out = {"config": {"sdot.tier.budget.bytes": budget,
                      "sdot.tier.wave.io.bytes": io,
                      "prefetch_setting_budget_bytes": prefetch_budget,
                      "q1_bound_bytes": q1_bytes, "q1_arrays": q1_names,
                      "raw_segment_io_bytes": raw_seg_io,
                      "segments": len(seg)}}
    for leg in ("raw", "encoded"):
        ectx = eager[leg]
        t0 = time.perf_counter()
        tctx = sdt.Context({**ENGINE_TIMED, "sdot.persist.path": roots[leg],
                            "sdot.tier.enabled": True,
                            "sdot.tier.budget.bytes": budget,
                            "sdot.tier.wave.io.bytes": io})
        boot_ms = (time.perf_counter() - t0) * 1e3
        tds = tctx.store.get("lineitem")
        tier = tctx.persist.tier
        if not isinstance(tds, TieredDatasource) \
                or tier.stats_snapshot()["faults"]:
            raise AssertionError(f"tier {leg}: boot gave {type(tds)}, "
                                 f"{tier.stats_snapshot()['faults']} faults")
        r = {"boot_ms": boot_ms, "eager_recovery_ms": rec[leg]["context_ms"],
             "recovery": dict(tctx.store.recovery_info["lineitem"]),
             "encoding": tds.encoding_info(),
             "host_bytes_per_segment_q1": tds.host_bytes_per_segment(
                 q1_names)}
        solo = {"q1": (q1, lambda g: check_q1(g, want_df["q1"])),
                "q6": (q6, lambda g: np.testing.assert_allclose(
                    g["revenue"].to_numpy(), [want_df["q6"]],
                    rtol=FLOAT_SUM_RTOL_ORACLE))}
        cold = {}
        for name, (spec, oracle) in solo.items():
            runs = {}
            for temp in ("cold", "warm"):
                if temp == "cold":
                    tier.clear()
                    tctx.engine.clear_caches()
                got, runs[temp], st = tier_run(
                    tctx, lambda: tctx.execute(spec).to_pandas(),
                    lambda: dict(tctx.engine.last_stats), spies,
                    temp == "cold")
                oracle(got)
                with settings(ectx, {"sdot.engine.wave.max.bytes":
                                     same_plan_budget(st)}):
                    same = ectx.execute(spec).to_pandas()
                    est = dict(ectx.engine.last_stats)
                if (est.get("waves", 1), est.get("segments_per_wave")) \
                        != (st.get("waves", 1), st.get("segments_per_wave")):
                    raise AssertionError(
                        f"tier {leg} {name}: eager plan {est.get('waves')} x "
                        f"{est.get('segments_per_wave')}, tiered "
                        f"{st.get('waves')} x {st.get('segments_per_wave')}")
                bit_equal(f"tier {leg} {name} {temp} vs eager, same waves",
                          got, same)
                check_frame(f"tier {leg} {name} {temp} vs step (b)", got,
                            before[name], None, FLOAT_SUM_RTOL_KERNEL)
                if temp == "cold":
                    cold[name] = (got, st)
            r[name] = runs
        if leg == "raw" and r["q1"]["cold"]["waves"] != TIER_Q1_WAVES:
            raise AssertionError(f"tier raw: Q1 in {r['q1']['cold']['waves']}"
                                 f" waves, want {TIER_Q1_WAVES}")
        # the storm: one B2 launch per tier-forced wave
        runs = {}
        for temp in ("cold", "warm"):
            if temp == "cold":
                tier.clear()
                storm.engine.clear_caches()
            storm.store.register(tds)
            members, ss0 = [], storm.engine.sharedscan.stats()
            b2 = spies.b2_launches
            with settings(storm, {"sdot.tier.wave.io.bytes": io}):
                res, runs[temp], _ = tier_run(
                    tctx, lambda: run_storm(storm, slist,
                                            stats_out=members)[0],
                    lambda: members[0], spies, temp == "cold")
            ss1 = storm.engine.sharedscan.stats()
            waves = {m.get("waves", 1) for m in members}
            if len(waves) != 1 or ss1["queries_coalesced"] \
                    - ss0["queries_coalesced"] != len(slist) \
                    or ss1["wave_launches"] - ss0["wave_launches"] \
                    != min(waves) or spies.b2_launches - b2 \
                    != (min(waves) if temp == "cold" else 0):
                raise AssertionError(
                    f"tier {leg} storm: waves {waves}, "
                    f"{spies.b2_launches - b2} wave launches, "
                    f"{ss1['wave_fallback_reasons']}")
            runs[temp]["member_tier"] = members[0].get("tier")
            check_storm_oracle(f"tier {leg}", names, res, want_df)
            storm.store.register(eds)
            with settings(storm, {"sdot.engine.wave.max.bytes":
                                  same_plan_budget(members[0])}):
                same = run_storm(storm, slist)[0]
            for n_, g, w, b in zip(names, res, same, before["storm"]):
                bit_equal(f"tier {leg} storm {n_} {temp} vs eager, same "
                          f"waves", g, w)
                check_frame(f"tier {leg} storm {n_} {temp} vs step (b)", g,
                            b, None, FLOAT_SUM_RTOL_KERNEL)
        r["storm"] = runs
        r["final"] = tier.stats_snapshot()
        tctx.close()
        # the second setting: Q1 cold under a budget that holds two of
        # its waves, so the chunks the prefetcher loads behind the running
        # wave are still hot when their wave binds them
        pctx = sdt.Context({**ENGINE_TIMED, "sdot.persist.path": roots[leg],
                            "sdot.tier.enabled": True,
                            "sdot.tier.budget.bytes": prefetch_budget,
                            "sdot.tier.wave.io.bytes": io})
        got, pr, st = tier_run(
            pctx, lambda: pctx.execute(q1).to_pandas(),
            lambda: dict(pctx.engine.last_stats), spies, True)
        check_q1(got, want_df["q1"])
        want_got, want_st = cold["q1"]
        if (st.get("waves", 1), st.get("segments_per_wave")) \
                != (want_st.get("waves", 1),
                    want_st.get("segments_per_wave")):
            raise AssertionError(f"tier {leg} prefetch: Q1 in "
                                 f"{st.get('waves')} waves, the first "
                                 f"setting's in {want_st.get('waves')}")
        bit_equal(f"tier {leg} q1 prefetch setting vs first setting", got,
                  want_got)
        if pr["waves"] < 2 or pr["tier"]["prefetch_hit_bytes"] <= 0:
            raise AssertionError(f"tier {leg} prefetch: {pr['waves']} "
                                 f"waves, {pr['tier']}")
        r["prefetch_setting"] = pr
        pctx.close()
        out[leg] = r
    return out


# the device-loss leg of phase persist: a child streams SF 0.05 lineitem
# into its own root, answers Q1 and Q6 on the card, poisons its CUDA
# context and answers them again on the host tier
LOSS_SF = 0.05
LOSS_BATCHES = 4
LOSS_COOLDOWN_S = 2.0
LOSS_PROBE_DEADLINE_S = 10.0
LOSS_TIMEOUT_S = 300.0


def lineitem_sql_oracles(li) -> dict:
    """pandas answers of TPC-H shipdate_range, Q1 and Q6 (``Context.sql``)
    over a lineitem frame (the forms of tests/test_tpch.py)."""
    import pandas as pd
    ts = pd.Timestamp
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
    d = li[(li.l_shipdate >= ts("1994-01-01"))
           & (li.l_shipdate < ts("1995-01-01"))
           & (li.l_discount >= 0.05) & (li.l_discount <= 0.07)
           & (li.l_quantity < 24)]
    out["q6"] = pd.DataFrame(
        {"revenue": [(d.l_extendedprice * d.l_discount).sum()]})
    return out


def poison_cuda_context() -> dict:
    """Provoke a sticky CUDA error: an out-of-bounds index on a CUDA
    tensor trips the indexing kernel's device-side assert, after which
    the context refuses every call. Returns how, the error and its ms."""
    x = torch.zeros(4, device="cuda")
    idx = torch.tensor([1 << 20], device="cuda")
    t0 = time.perf_counter()
    try:
        x[idx] = 1.0
        torch.cuda.synchronize()
    except RuntimeError as e:
        return {"how": "out-of-bounds index (device-side assert)",
                "error": f"{type(e).__name__}: {str(e)[:200]}",
                "ms": (time.perf_counter() - t0) * 1e3, "exc": e}
    raise AssertionError("device loss: an out-of-bounds CUDA index raised "
                         "nothing")


def device_loss_child(root) -> int:
    """The device-loss leg's child (``chip_smoke.py --device-loss-child
    ROOT``): stream SF ``LOSS_SF`` lineitem into ``ROOT`` and checkpoint
    it, answer Q1 and Q6 through ``Context.sql`` on the card, poison the
    CUDA context, answer them again (the host tier, mode ``host
    (backend_lost ...)``), one statement inside the cooldown with a spy on
    ``_bind_arrays``, then the re-attach probe after the cooldown. Prints
    one ``LOSS {json}`` line per finding and leaves by ``os._exit(0)``:
    the poisoned context must not be torn down."""
    import os
    import spark_druid_olap_tpu_torch as sdt
    from spark_druid_olap_tpu_torch.parallel import executor as X
    from spark_druid_olap_tpu_torch.tools.tpch import QUERIES, generate

    def report(step, **fields):
        print("LOSS " + json.dumps({"step": step, **fields}), flush=True)

    def mode(ctx):
        return ctx.history.entries()[-1].stats["mode"]
    df = generate(LOSS_SF, seed=SEED)["lineitem"]
    want = lineitem_sql_oracles(df)
    ctx = sdt.Context({**ENGINE_TIMED, "sdot.persist.path": root,
                       "sdot.engine.backend.retry.seconds": LOSS_COOLDOWN_S})
    n = -(-len(df) // LOSS_BATCHES)
    for i in range(LOSS_BATCHES):
        ctx.stream_ingest("lineitem", df.iloc[i * n:(i + 1) * n],
                          time_column="l_shipdate")
    ctx.checkpoint()
    report("ingest", rows=len(df), batches=LOSS_BATCHES)
    first = {}
    for name in ("q1", "q6"):
        got = ctx.sql(QUERIES[name]).to_pandas()
        check_sql(name, got, want[name])
        if mode(ctx) != "engine":
            raise AssertionError(f"device loss: {name} before the loss ran "
                                 f"in {mode(ctx)}")
        first[name] = got
    report("before", modes="engine",
           q1={c: first["q1"][c].tolist() for c in first["q1"].columns},
           dtypes={c: str(first["q1"][c].dtype) for c in first["q1"]})
    poison = poison_cuda_context()
    t_poison = time.perf_counter() - poison["ms"] / 1e3
    classified = X._is_backend_loss(poison.pop("exc"))
    report("poison", classified_loss=classified, **poison)
    after = {}
    for name in ("q1", "q6"):
        t0 = time.perf_counter()
        got = ctx.sql(QUERIES[name]).to_pandas()
        after[name] = dict(
            ms=(time.perf_counter() - t0) * 1e3,
            since_poison_ms=(time.perf_counter() - t_poison) * 1e3,
            mode=mode(ctx),
            backend_lost=ctx.history.entries()[-1].stats.get(
                "backend_lost"))
        check_sql(name, got, want[name])
        if not after[name]["mode"].startswith("host (backend_lost"):
            raise AssertionError(f"device loss: {name} after the loss ran "
                                 f"in {after[name]['mode']}")
    report("after", **after)
    # inside the cooldown no statement touches the device
    binds, real = [], X.QueryEngine._bind_arrays

    def spy(self, *a, **k):
        binds.append(1)
        return real(self, *a, **k)
    X.QueryEngine._bind_arrays = spy
    t0 = time.perf_counter()
    got = ctx.sql(QUERIES["q1"]).to_pandas()
    check_sql("q1", got, want["q1"])
    report("cooldown", binds=len(binds), mode=mode(ctx),
           ms=(time.perf_counter() - t0) * 1e3,
           retry_in_s=ctx.engine._backend_retry_at - time.time())
    if binds or not mode(ctx).startswith("host (backend_lost"):
        raise AssertionError(f"device loss: {len(binds)} binds inside the "
                             f"cooldown, mode {mode(ctx)}")
    # after it, the probe runs once, within its deadline, and fails: a
    # sticky error poisons the context for the rest of the process
    time.sleep(max(0.0, ctx.engine._backend_retry_at - time.time()) + 0.1)
    t0 = time.perf_counter()
    alive = X._probe_device_alive(ctx.engine.device,
                                  timeout_s=LOSS_PROBE_DEADLINE_S)
    probe_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    got = ctx.sql(QUERIES["q6"]).to_pandas()
    check_sql("q6", got, want["q6"])
    report("probe", alive=alive, probe_ms=probe_ms,
           deadline_ms=LOSS_PROBE_DEADLINE_S * 1e3, binds=len(binds),
           statement_ms=(time.perf_counter() - t0) * 1e3, mode=mode(ctx))
    if alive or probe_ms > LOSS_PROBE_DEADLINE_S * 1e3 + 1000 \
            or not mode(ctx).startswith("host (backend_lost"):
        raise AssertionError(f"device loss: probe alive={alive} in "
                             f"{probe_ms} ms, mode {mode(ctx)}")
    report("done")
    sys.stdout.flush()
    os._exit(0)


def start_device_loss_child(tmp) -> dict:
    """Start the device-loss leg's child (``--device-loss-child``) over
    its own root under ``tmp``; it runs beside the parent's next steps (a
    CUDA context is the process's own: poisoning it touches no other)."""
    import subprocess as sp
    root = str(pathlib.Path(tmp) / "loss")
    err = open(pathlib.Path(tmp) / "loss_child.err", "w+")
    proc = sp.Popen([sys.executable, str(pathlib.Path(__file__).resolve()),
                     "--device-loss-child", root], stdout=sp.PIPE,
                    stderr=err, text=True,
                    cwd=str(pathlib.Path(__file__).resolve().parent))
    return {"proc": proc, "root": root, "err": err,
            "t0": time.perf_counter()}


def device_loss_leg(sdt, child, spies) -> dict:
    """Wait for the child (:func:`start_device_loss_child`), read its
    findings, then a fresh context on the card over the child's root: Q1
    in engine mode, bit for bit the child's answer before the loss (a
    restart after a device loss loses nothing)."""
    import subprocess as sp
    from spark_druid_olap_tpu_torch.tools.tpch import QUERIES, generate
    proc, root, err = child["proc"], child["root"], child["err"]
    try:
        stdout, _ = proc.communicate(timeout=LOSS_TIMEOUT_S)
    except sp.TimeoutExpired:
        proc.kill()
        stdout, _ = proc.communicate()
    child_s = time.perf_counter() - child["t0"]
    err.seek(0)
    stderr = err.read()
    err.close()
    found = {}
    for line in stdout.splitlines():
        if line.startswith("LOSS "):
            d = json.loads(line[5:])
            found[d.pop("step")] = d
    if proc.returncode != 0 or "done" not in found:
        raise AssertionError(f"device loss: child exited {proc.returncode}"
                             f", steps {sorted(found)}: {stderr[-3000:]}")
    if not found["poison"]["classified_loss"]:
        raise AssertionError(f"device loss: {found['poison']['error']} "
                             f"not classified as a loss")
    t0 = time.perf_counter()
    ctx = sdt.Context({**ENGINE_TIMED, "sdot.persist.path": root})
    restart_ms = (time.perf_counter() - t0) * 1e3
    got = spies.run(lambda: ctx.sql(QUERIES["q1"]).to_pandas())
    mode = ctx.history.entries()[-1].stats["mode"]
    want = found["before"]["q1"]
    if mode != "engine" or {c: got[c].tolist() for c in got.columns} \
            != want or {c: str(got[c].dtype) for c in got} \
            != found["before"]["dtypes"]:
        raise AssertionError(f"device loss: the restarted Q1 ran in {mode}"
                             f" or differs from the child's answer before "
                             f"the loss")
    check_sql("q1", got, lineitem_sql_oracles(
        generate(LOSS_SF, seed=SEED)["lineitem"])["q1"])
    ctx.close()
    return dict(child_s=child_s, restart_ms=restart_ms, restart_mode=mode,
                poison=found["poison"], after=found["after"],
                cooldown=found["cooldown"], probe=found["probe"],
                first_host_answer_ms=found["after"]["q1"]["since_poison_ms"])


class LossGuard:
    """Every device loss the engine marks in this process: the run fails
    on any, since only the device-loss leg's child may lose the device (a
    kernel bug that poisons the context would otherwise be served quietly
    by the host tier)."""

    def __init__(self):
        from spark_druid_olap_tpu_torch.parallel import executor as X
        self.marks = []
        real = X.QueryEngine._mark_backend_lost

        def marked(engine, *a, **k):
            self.marks.append(a or k)
            return real(engine, *a, **k)
        X.QueryEngine._mark_backend_lost = marked

    def check(self, where):
        if self.marks:
            raise AssertionError(f"{where}: {len(self.marks)} statements "
                                 f"demoted as backend_lost outside the "
                                 f"device-loss leg, at {self.marks[:3]}")


def persist_child(root, device, sf, rows) -> int:
    """The kill -9 leg's child (``chip_smoke.py --persist-child ROOT
    DEVICE SF ROWS``): ``CRASH_PRODUCERS`` threads stream ``ROWS``-row
    slices of TPC-H SF ``SF`` lineitem into ``lineitem`` under ``ROOT``
    (a context on ``DEVICE``, the WAL's fsync and group commit on),
    printing ``ACK producer batch`` after each ``stream_ingest`` returns,
    until the parent kills it."""
    import threading
    import spark_druid_olap_tpu_torch as sdt
    from spark_druid_olap_tpu_torch.tools.tpch import generate
    sf, rows = float(sf), int(rows)
    df = generate(sf, seed=SEED)["lineitem"]
    ctx = sdt.Context({**ENGINE_TIMED, "sdot.persist.path": root},
                      device=device)
    n = len(df) // rows
    lock = threading.Lock()
    # the create first, so the producers race only on appends
    ctx.stream_ingest("lineitem", df.iloc[:rows], time_column="l_shipdate")
    print("ACK 0 0", flush=True)

    def producer(p):
        for b in range(1 + p, n, CRASH_PRODUCERS):
            ctx.stream_ingest("lineitem", df.iloc[b * rows:(b + 1) * rows],
                              time_column="l_shipdate")
            with lock:
                print(f"ACK {p} {b}", flush=True)
    threads = [threading.Thread(target=producer, args=(p,))
               for p in range(CRASH_PRODUCERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return 0


def kill9_leg(sdt, S, E, tmp, spies) -> dict:
    """Start the child, SIGKILL it after ``CRASH_MIN_ACKS`` acknowledged
    batches, recover its root in a fresh context: every acknowledged batch
    present whole, no batch in part, at most one unacknowledged batch per
    producer; Q1 (B1) against pandas over exactly the recovered batches."""
    import signal
    import subprocess as sp
    import threading
    from spark_druid_olap_tpu_torch.tools.tpch import generate
    root = str(pathlib.Path(tmp) / "crash")
    t0 = time.perf_counter()
    err_path = pathlib.Path(tmp) / "crash_child.err"
    with open(err_path, "w") as err_f:
        proc = sp.Popen([sys.executable,
                         str(pathlib.Path(__file__).resolve()),
                         "--persist-child", root, CRASH_DEVICE,
                         repr(CRASH_SF), str(CRASH_BATCH_ROWS)],
                        stdout=sp.PIPE, stderr=err_f, text=True,
                        cwd=str(pathlib.Path(__file__).resolve().parent))
    timer = threading.Timer(CRASH_TIMEOUT_S, proc.kill)
    timer.start()
    acked, killed_at = [], None
    try:
        for line in proc.stdout:
            if line.startswith("ACK "):
                _, p, b = line.split()
                acked.append((int(p), int(b)))
                if len(acked) >= CRASH_MIN_ACKS and killed_at is None:
                    proc.send_signal(signal.SIGKILL)
                    killed_at = len(acked)
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    child_s = time.perf_counter() - t0
    err = err_path.read_text()
    if rc != -signal.SIGKILL or killed_at is None:
        raise AssertionError(f"kill -9: child exited {rc} after "
                             f"{len(acked)} acks: {err[-2000:]}")
    df = generate(CRASH_SF, seed=SEED)["lineitem"]
    n = len(df) // CRASH_BATCH_ROWS
    t0 = time.perf_counter()
    ctx = sdt.Context({**ENGINE_TIMED, "sdot.persist.path": root})
    recover_ms = (time.perf_counter() - t0) * 1e3
    if not ctx.store.names():
        raise AssertionError(f"kill -9: nothing recovered; child: "
                             f"{err[-2000:]}")
    ds = ctx.store.get("lineitem")
    key = lambda o, ln: np.asarray(o, np.int64) * 8 + np.asarray(ln, np.int64)
    have = key(ds.metrics["l_orderkey"].values,
               ds.metrics["l_linenumber"].values)
    want = key(df["l_orderkey"].to_numpy(), df["l_linenumber"].to_numpy())
    per = np.isin(want[:n * CRASH_BATCH_ROWS], have) \
        .reshape(n, CRASH_BATCH_ROWS).sum(axis=1)
    partial = [int(b) for b in np.flatnonzero(
        (per > 0) & (per < CRASH_BATCH_ROWS))]
    present = {int(b) for b in np.flatnonzero(per == CRASH_BATCH_ROWS)}
    acked_b = {b for _, b in acked}
    lost = sorted(acked_b - present)
    extra = sorted(present - acked_b)
    per_producer = {p: sum(1 for b in extra
                           if b > 0 and (b - 1) % CRASH_PRODUCERS == p)
                    for p in range(CRASH_PRODUCERS)}
    if partial or lost or any(v > 1 for v in per_producer.values()) \
            or len(have) != len(present) * CRASH_BATCH_ROWS \
            or 0 in extra:
        raise AssertionError(f"kill -9: partial {partial}, lost {lost}, "
                             f"unacked present {extra}, rows {len(have)}")
    rows = np.concatenate([np.arange(b * CRASH_BATCH_ROWS,
                                     (b + 1) * CRASH_BATCH_ROWS)
                           for b in sorted(present)])
    got = spies.run(lambda: ctx.execute(q1_spec(S, E)).to_pandas())
    check_q1(got, q1_oracle(df.iloc[rows]))
    info = dict(ctx.store.recovery_info["lineitem"])
    ctx.close()
    return dict(child_s=child_s, acked=len(acked), killed_after=killed_at,
                batches=n, recovered_batches=len(present),
                unacked_present=extra, recovered_rows=int(len(have)),
                recovery_ms=recover_ms, recovery=info)


def persist_phase(sdt, S, E, lineitem_ds, df, append, CG, CW, smi,
                  keep_root=None) -> dict:
    """Phase ``persist``: (a) CHECKPOINT of SF1 lineitem raw and encoded
    (seconds, bytes, codecs, the largest dictionary's JSON encode alone,
    disk space); (b) a fresh context over each root (recovery and
    checksum ms, the store bit for bit, Q1 / Q6 / the storm against pandas
    and bit for bit against the answers before the checkpoint, cold and
    warm); (b') each root recovered as tiered datasources
    (:func:`tier_leg`); (c) phase append's 4 batches through the journaled
    ``stream_ingest``, then 4 producer threads x 4 batches (group
    commits), Q1 and the storm against pandas, and a fresh context over
    that root replaying all 20 frames onto the snapshot (its ms, the
    store bit for bit, Q1 bit for bit); (d) a kill -9 of a child
    streaming into its own root; (d') a real device loss in a child
    started beside (d) (:func:`device_loss_leg`); (e) ``persist.compact``
    (segments, rows, padded rows, B2's ms before and after); (f)
    ``sys_snapshots``, RESTORE and CLEAR METADATA ... PURGE through
    SQL."""
    import json as _json
    import shutil
    import tempfile
    import threading
    import pandas as pd
    from spark_druid_olap_tpu_torch.persist import snapshot as SNAP
    t_phase = time.perf_counter()
    spies = KernelSpies(CG, CW)
    specs = storm_specs(S, E)
    names, slist = list(specs), list(specs.values())
    q1, q6 = q1_spec(S, E), q6_spec(S, E)
    out = {"card": smi}
    steps, t_step = {}, [t_phase]

    def step(name):
        now = time.perf_counter()
        steps[name] = now - t_step[0]
        t_step[0] = now
    storm = sdt.Context(STORM_CONFIG)
    with tempfile.TemporaryDirectory(prefix="sdot_persist_") as tmp:
        roots = {"raw": str(pathlib.Path(tmp) / "raw"),
                 "encoded": str(pathlib.Path(tmp) / "encoded")}
        out["disk_free_gb_before"] = shutil.disk_usage(tmp).free / 1e9
        # the answers before any checkpoint, over the ingested store
        base = sdt.Context(ENGINE_TIMED)
        base.store.register(lineitem_ds)
        before = {"q1": spies.run(lambda: base.execute(q1).to_pandas()),
                  "q6": spies.run(lambda: base.execute(q6).to_pandas())}
        before["storm"], _ = storm_answers(storm, lineitem_ds, slist, spies)
        del base
        want_df = persist_oracles(df)
        step("before")
        # (a) checkpoints
        t0 = time.perf_counter()
        big = max(lineitem_ds.dims.values(), key=lambda d: d.cardinality)
        blob = _json.dumps([str(v) for v in big.dictionary]).encode()
        ck = {"largest_dictionary": dict(
            column=big.name, values=big.cardinality, json_bytes=len(blob),
            encode_s=time.perf_counter() - t0)}
        del blob
        for leg, enc in (("raw", False), ("encoded", True)):
            c = sdt.Context({**ENGINE_TIMED, "sdot.persist.path": roots[leg],
                             "sdot.encode.enabled": enc})
            c.store.register(lineitem_ds)
            t0 = time.perf_counter()
            summary = c.checkpoint("lineitem")[0]
            secs = time.perf_counter() - t0
            ds_root = c.persist._ds_root("lineitem")
            man = SNAP.load_manifest(ds_root, SNAP.current_version(ds_root))
            ck[leg] = dict(seconds=secs, bytes=summary["bytes"],
                           rows=summary["rows"],
                           codecs=column_codecs(man))
            if enc:
                e = man["encoding"]
                ck[leg].update(raw_bytes=e["raw_bytes"],
                               encoded_bytes=e["encoded_bytes"],
                               ratio=e["raw_bytes"] / e["encoded_bytes"])
            c.close()
        out["checkpoint"] = ck
        out["disk_free_gb_after_checkpoints"] = \
            shutil.disk_usage(tmp).free / 1e9
        if keep_root is not None:
            # phase cluster's deep storage: the raw root as checkpointed
            # (blobs linked, the still empty WAL copied)
            link_root(roots["raw"], keep_root)
        step("checkpoint")
        # (b) recovery
        rec = {}
        ctxs = {}
        for leg in ("raw", "encoded"):
            t0 = time.perf_counter()
            c = ctxs[leg] = sdt.Context({**ENGINE_TIMED,
                                         "sdot.persist.path": roots[leg]})
            wall_ms = (time.perf_counter() - t0) * 1e3
            ds = c.store.get("lineitem")
            diffs = store_diffs(ds, lineitem_ds)
            if diffs:
                raise AssertionError(f"persist {leg}: recovered store "
                                     f"differs: {diffs}")
            r = {"context_ms": wall_ms,
                 "recovery_ms": c.persist.recovery_report["total_ms"]}
            t0 = time.perf_counter()
            got1 = spies.run(lambda: c.execute(q1).to_pandas())
            r["q1_cold_ms"] = (time.perf_counter() - t0) * 1e3
            r["recovery"] = dict(c.engine.last_stats["persist"])
            t0 = time.perf_counter()
            again = spies.run(lambda: c.execute(q1).to_pandas())
            r["q1_warm_ms"] = (time.perf_counter() - t0) * 1e3
            got6 = spies.run(lambda: c.execute(q6).to_pandas())
            check_q1(got1, want_df["q1"])
            np.testing.assert_allclose(got6["revenue"].to_numpy(),
                                       [want_df["q6"]],
                                       rtol=FLOAT_SUM_RTOL_ORACLE)
            for what, g, w in (("q1", got1, before["q1"]),
                               ("q1 warm", again, before["q1"]),
                               ("q6", got6, before["q6"])):
                bit_equal(f"persist {leg} {what}", g, w)
            res, r["storm_ms"] = storm_answers(storm, ds, slist, spies)
            for n_, g, w in zip(names, res, before["storm"]):
                bit_equal(f"persist {leg} storm {n_}", g, w)
            check_storm_oracle(f"persist {leg}", names, res, want_df)
            rec[leg] = r
        out["recovery"] = rec
        step("recovery")
        # (b') the same roots recovered as tiered datasources
        out["tier"] = tier_leg(sdt, S, E, roots, ctxs, before, want_df,
                               storm, spies, rec)
        ctxs["encoded"].close()
        del ctxs["encoded"]
        step("tier")
        # (c) journaled appends on the raw root's context
        ctx = ctxs["raw"]
        frames, batches = [df], []
        for i in range(len(APPEND_FLAGS)):
            b = append_batch(df, i)
            t0 = time.perf_counter()
            ctx.stream_ingest("lineitem", b, time_column="l_shipdate")
            batches.append(dict(
                ms=(time.perf_counter() - t0) * 1e3,
                in_memory_ms=append["batches"][i]["stream_ingest_ms"]))
            frames.append(b)
        small = [df.sample(n=PERSIST_SMALL_ROWS, random_state=SEED + 100 + k)
                 .reset_index(drop=True)
                 for k in range(PERSIST_PRODUCERS * PERSIST_PRODUCER_BATCHES)]
        errs = []

        def producer(p):
            try:
                for k in range(p, len(small), PERSIST_PRODUCERS):
                    ctx.stream_ingest("lineitem", small[k],
                                      time_column="l_shipdate")
            except BaseException as e:  # noqa: BLE001 — raised below
                errs.append(e)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=producer, args=(p,))
                   for p in range(PERSIST_PRODUCERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        producers_s = time.perf_counter() - t0
        if errs:
            raise errs[0]
        full = pd.concat(frames + small, ignore_index=True)
        gc = ctx.persist.stats()["groupCommit"]
        if gc["frames"] != len(APPEND_FLAGS) + len(small) \
                or not 1 <= gc["commits"] <= gc["frames"]:
            raise AssertionError(f"persist: group commit {gc}")
        ds = ctx.store.get("lineitem")
        if ds.num_rows != len(full):
            raise AssertionError(f"persist: {ds.num_rows} rows, want "
                                 f"{len(full)}")
        live_q1 = spies.run(lambda: ctx.execute(q1).to_pandas())
        want_full = persist_oracles(full)
        check_q1(live_q1, want_full["q1"])
        b2_pre = len(spies.b2)
        pre_storm, pre_storm_ms = storm_answers(storm, ds, slist, spies)
        check_storm_oracle("persist journaled", names, pre_storm, want_full)
        out["journaled"] = dict(
            batches=batches, producers=PERSIST_PRODUCERS,
            producer_batches=len(small), producer_rows=PERSIST_SMALL_ROWS,
            producers_s=producers_s, group_commits=gc["commits"],
            group_frames=gc["frames"], rows=ds.num_rows,
            wal_bytes=ctx.persist.stats()["datasources"]["lineitem"]
            ["walBytes"])
        step("journaled")
        # crash recovery at the phase's size: nothing was checkpointed
        # since (b), so a fresh context over the live root loads the SF1
        # snapshot and replays every frame journaled above, as after a
        # crash of ``ctx`` (the root is only read: no torn tail to trim)
        t0 = time.perf_counter()
        rc = sdt.Context({**ENGINE_TIMED, "sdot.persist.path": roots["raw"]})
        wall_ms = (time.perf_counter() - t0) * 1e3
        rds = rc.store.get("lineitem")
        diffs = store_diffs(rds, ds)
        if diffs:
            raise AssertionError(f"persist replay: store differs: {diffs}")
        info = dict(rc.store.recovery_info["lineitem"])
        if info["source"] != "snapshot+wal" \
                or info["wal_records"] != gc["frames"]:
            raise AssertionError(f"persist replay: {info}, want "
                                 f"{gc['frames']} records")
        total_ms = rc.persist.recovery_report["total_ms"]
        bit_equal("persist replayed q1",
                  spies.run(lambda: rc.execute(q1).to_pandas()), live_q1)
        rc.close()
        out["replay"] = dict(
            context_ms=wall_ms, recovery_ms=total_ms,
            checksum_verify_ms=info["checksum_verify_ms"],
            wal_records=info["wal_records"], rows=rds.num_rows,
            wal_bytes=out["journaled"]["wal_bytes"])
        del rc, rds
        step("replay")
        # (d) kill -9, with (d')'s child, a real device loss, beside it
        loss_child = start_device_loss_child(tmp)
        out["kill9"] = kill9_leg(sdt, S, E, tmp, spies)
        step("kill9")
        # (d') the device-loss child's findings, a restart over its root
        out["device_loss"] = device_loss_leg(sdt, loss_child, spies)
        step("device_loss")
        # (e) compaction
        pre_q1 = spies.run(lambda: ctx.execute(q1).to_pandas())
        t0 = time.perf_counter()
        (summary,) = ctx.persist.compact("lineitem")
        compact_s = time.perf_counter() - t0
        cds = ctx.store.get("lineitem")
        if cds.num_rows != ds.num_rows:
            raise AssertionError("persist: compaction changed the rows")
        post_q1 = spies.run(lambda: ctx.execute(q1).to_pandas())
        check_frame("persist compacted q1", post_q1, pre_q1,
                    ["l_returnflag", "l_linestatus"], FLOAT_SUM_RTOL_ORACLE)
        b2_post = len(spies.b2)
        post_storm, post_storm_ms = storm_answers(storm, cds, slist, spies)
        for n_, g, w in zip(names, post_storm, pre_storm):
            check_frame(f"persist compacted storm {n_}", g, w, None,
                        FLOAT_SUM_RTOL_ORACLE)
        out["compaction"] = dict(
            seconds=compact_s, summary=summary,
            segments=[ds.num_segments, cds.num_segments],
            rows=[ds.num_rows, cds.num_rows],
            padded_rows=[padded(ds), padded(cds)],
            storm_ms=[pre_storm_ms, post_storm_ms], b2_index=[b2_pre,
                                                              b2_post])
        step("compaction")
        # (f) the SQL surface
        snaps = ctx.sql("select datasource, version, state, current, rows "
                        "from sys_snapshots").to_pandas()
        if not snaps["current"].any() or len(snaps) < 1:
            raise AssertionError(f"persist: sys_snapshots {snaps}")
        last = append_batch(df, 0).head(PERSIST_SMALL_ROWS)
        ctx.stream_ingest("lineitem", last, time_column="l_shipdate")
        want = spies.run(lambda: ctx.execute(q1).to_pandas())
        t0 = time.perf_counter()
        st = ctx.sql("restore lineitem").to_pandas()
        restore_s = time.perf_counter() - t0
        if list(st["status"]) != ["restored lineitem from snapshot+wal"]:
            raise AssertionError(f"persist: restore said {st}")
        got = spies.run(lambda: ctx.execute(q1).to_pandas())
        bit_equal("persist q1 after RESTORE", got, want)
        check_q1(got, q1_oracle(pd.concat([full, last], ignore_index=True)))
        ctx.sql("clear metadata lineitem purge")
        ctx.close()
        fresh = sdt.Context({**ENGINE_TIMED,
                             "sdot.persist.path": roots["raw"]})
        if "lineitem" in fresh.store.names():
            raise AssertionError("persist: lineitem survived PURGE")
        fresh.close()
        out["sql"] = dict(
            sys_snapshots=snaps.astype(str).to_dict("records"),
            restore_s=restore_s, restore_status=list(st["status"]),
            purged=True)
        out["disk_free_gb_after"] = shutil.disk_usage(tmp).free / 1e9
        del ctxs, ctx, fresh, storm
        step("sql")
    out["kernels"] = {"b1": b1_checked(CG, "persist", spies.b1),
                      "b2": [wave_timed(CW, f"persist b2[{i}]", *w)
                             for i, w in enumerate(spies.b2)]}
    out["compaction"]["b2_kernel_ms"] = [
        out["kernels"]["b2"][i]["ms"] for i in out["compaction"]["b2_index"]]
    out["compaction"]["b2_rows"] = [
        out["kernels"]["b2"][i]["rows"]
        for i in out["compaction"]["b2_index"]]
    out["b1_launches"], out["b2_launches"] = spies.b1_launches, \
        spies.b2_launches
    step("kernels")
    out["steps_s"] = steps
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase modules: a module named in sdot.modules (this script's
# ``SmokeModule``, built at first access so importing the script loads
# nothing of the port)
FLAG_NAMES = {"A": "accepted", "N": "none", "R": "returned"}
MODULE_CONFIG = {**ENGINE_TIMED, "sdot.modules": "chip_smoke:SmokeModule"}
MODULE_FN_SQL = ("select flagname(l_returnflag) as flag, count(*) as n, "
                 "sum(l_quantity) as qty from lineitem "
                 "group by flagname(l_returnflag) order by flag")
MODULE_TOPN_SQL = ("select l_shipmode, sum(l_extendedprice) as rev "
                   "from lineitem group by l_shipmode order by rev desc "
                   "limit 5")
MODULE_TOPN_CLAMP = 3


def __getattr__(name):
    if name == "SmokeModule":
        return smoke_module_class()
    raise AttributeError(name)


def smoke_module_class():
    """A module with a one-argument string function (``flagname``), a spec
    rule (a topN's threshold clamped to ``MODULE_TOPN_CLAMP``, as
    tests/test_modules.py's) and a statement handler (``PING``)."""
    import dataclasses
    from spark_druid_olap_tpu_torch.ir import spec as S
    from spark_druid_olap_tpu_torch.result import QueryResult
    from spark_druid_olap_tpu_torch.utils.modules import Module

    def clamp(q, conf):
        if isinstance(q, S.TopNQuerySpec) and q.threshold > MODULE_TOPN_CLAMP:
            return dataclasses.replace(q, threshold=MODULE_TOPN_CLAMP)
        return None

    def ping(ctx, sql):
        if sql.strip().upper() == "PING":
            return QueryResult(["pong"],
                               {"pong": np.array([1], dtype=np.int64)})
        return None

    class SmokeModule(Module):
        def functions(self):
            return {"flagname": lambda s: FLAG_NAMES.get(s, s)}

        def spec_rules(self):
            return [clamp]

        def statement_handlers(self):
            return [ping]
    return SmokeModule


def modules_phase(sdt, S, E, lineitem_ds, df, CG, CW, smi) -> dict:
    """Phase ``modules``: the module from ``sdot.modules``; its function
    grouped on over a dictionary dimension (B1, against pandas), its spec
    rule (a clamped topN, against pandas), its handler; then ``ON
    DATASOURCE lineitem EXECUTE QUERY`` with Q1's QuerySpec as serde JSON,
    against Q1 through SQL."""
    from spark_druid_olap_tpu_torch.ir import serde
    from spark_druid_olap_tpu_torch.tools import tpch
    t_phase = time.perf_counter()
    spies = KernelSpies(CG, CW)
    ctx = sdt.Context(MODULE_CONFIG)
    ctx.store.register(lineitem_ds)
    out = {"card": smi, "modules": [type(m).__name__ for m in ctx.modules]}
    try:
        if out["modules"] != ["SmokeModule"]:
            raise AssertionError(f"modules: installed {out['modules']}")
        pong = ctx.sql("PING").to_pandas()
        if pong["pong"].tolist() != [1]:
            raise AssertionError(f"modules: PING answered {pong}")
        b1 = spies.b1_launches
        t = time.perf_counter()
        got = spies.run(lambda: ctx.sql(MODULE_FN_SQL).to_pandas())
        fn_ms = (time.perf_counter() - t) * 1e3
        st = ctx.history.entries()[-1].stats
        want = df.assign(flag=df["l_returnflag"].map(FLAG_NAMES)) \
            .groupby("flag").agg(n=("l_quantity", "size"),
                                 qty=("l_quantity", "sum")).reset_index()
        if st["mode"] != "engine" or st.get("route") != "kernel" \
                or spies.b1_launches == b1:
            raise AssertionError(f"modules: flagname took mode {st['mode']}"
                                 f", route {st.get('route')}, "
                                 f"{spies.b1_launches - b1} B1 launches")
        check_frame("modules flagname vs pandas", got, want, None, 0)
        out["function"] = {"ms": fn_ms, "route": st.get("route"),
                           "groups": len(got),
                           "b1_launches": spies.b1_launches - b1}
        top = spies.run(lambda: ctx.sql(MODULE_TOPN_SQL).to_pandas())
        st = ctx.history.entries()[-1].stats
        rev = df.groupby("l_shipmode")["l_extendedprice"].sum() \
            .sort_values(ascending=False).head(MODULE_TOPN_CLAMP)
        if list(top["l_shipmode"]) != list(rev.index):
            raise AssertionError(f"modules: clamped topN {top}")
        np.testing.assert_allclose(top["rev"].to_numpy(), rev.to_numpy(),
                                   rtol=FLOAT_SUM_RTOL_ORACLE)
        out["spec_rule"] = {"rows": len(top), "mode": st["mode"],
                            "route": st.get("route")}
        body = serde.query_to_json(q1_spec(S, E))
        raw_sql = f"ON DATASOURCE lineitem EXECUTE QUERY '{body}'"
        t = time.perf_counter()
        raw = spies.run(lambda: ctx.sql(raw_sql).to_pandas())
        raw_ms = (time.perf_counter() - t) * 1e3
        recorded = ctx.history.entries()[-1]
        via_sql = spies.run(lambda: ctx.sql(tpch.QUERIES["q1"]).to_pandas())
        check_frame("modules raw Q1 vs SQL Q1", raw, via_sql, None,
                    FLOAT_SUM_RTOL_KERNEL)
        check_q1(raw, q1_oracle(df))
        out["raw_query"] = {"ms": raw_ms, "json_bytes": len(body),
                            "recorded": [recorded.query_type,
                                         recorded.datasource]}
    finally:
        ctx.functions.pop("flagname", None)
    out["kernels"] = {"b1": b1_checked(CG, "modules", spies.b1),
                      "b2": [wave_timed(CW, f"modules b2[{i}]", *w)
                             for i, w in enumerate(spies.b2)]}
    out["b1_launches"], out["b2_launches"] = spies.b1_launches, \
        spies.b2_launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- the serving layer (phase "server") ---------------------------------------

SERVER_JSON_POSTS = 3            # JSON posts per statement (round trip ms)
SERVER_INPROCESS_REPEATS = 3     # in-process warm runs per statement
SERVER_FLIGHT_SQL = ["q1", "q6"]
SERVER_SHED_CONFIG = {**ENGINE_TIMED, "sdot.wlm.lanes": "only:slots=1,queue=0",
                      "sdot.wlm.default.lane": "only"}


def http_call(port, path, payload=None, headers=None, timeout=300):
    """One request to a loopback server -> (status, headers, body bytes);
    an HTTP error status is returned, not raised."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def arrow_frame(body):
    import io
    import pyarrow as pa
    return pa.ipc.open_stream(io.BytesIO(body)).read_all().to_pandas()


def json_frame(body, like):
    """A ``POST /sql`` JSON body as a frame with ``like``'s dtypes."""
    import pandas as pd
    doc = json.loads(body.decode())
    rows = doc["rows"]
    return pd.DataFrame({c: pd.Series([r[c] for r in rows],
                                      dtype=like[c].dtype)
                         for c in doc["columns"]})


class Gate:
    """Replaces an engine's ``_execute_admitted`` while installed: each
    statement that reaches it (its WLM slot held) waits for ``release``,
    then runs on the real method."""

    def __init__(self, engine):
        import threading
        self.engine, self.real = engine, engine._execute_admitted
        self.entered, self.release = threading.Event(), threading.Event()

    def __enter__(self):
        def gated(q, t0):
            self.entered.set()
            if not self.release.wait(120):
                raise AssertionError("gate never released")
            return self.real(q, t0)
        self.engine._execute_admitted = gated
        return self

    def __exit__(self, *exc):
        self.release.set()
        del self.engine._execute_admitted


def server_phase(sdt, flat_ds, lineitem_ds, S, E, df, CG, CW, smi) -> dict:
    """Phase ``server``: the port's ``SqlServer`` on a loopback port over
    phase sql's SF1 flat star (nothing new ingested). Phase sql's 8
    statements posted as JSON and as Arrow, each response byte for byte
    the in-process ``Context.sql`` answer encoded by the server's own
    encoders (a statement on the scatter tier, whose float sums follow
    the atomics' order, decoded and held within rtol 1e-9); Q1's QuerySpec
    posted raw to ``/query``; 8 statements posted at once from 8 client
    threads into a one-slot lane (one B2 launch, as phase serving's
    handoff storm); one statement cancelled mid-flight (499) and one shed
    under a one-slot lane (429 with ``Retry-After``); two statements over
    Arrow Flight ``do_get``."""
    import threading

    from spark_druid_olap_tpu_torch.ir import serde
    from spark_druid_olap_tpu_torch.server import flight as F
    from spark_druid_olap_tpu_torch.server import http as H
    from spark_druid_olap_tpu_torch.tools import tpch
    t_phase = time.perf_counter()
    spies = KernelSpies(CG, CW)
    star = tpch.star_schema("tpch_flat")
    ctx = serving_context(sdt, flat_ds, star, ENGINE_TIMED)
    ctx.store.register(lineitem_ds)
    srv = H.SqlServer(ctx, "127.0.0.1", 0).start()
    out = {"card": smi}
    servers = [srv]
    try:
        # (a) phase sql's statements: JSON and Arrow vs in-process
        stmts = {}
        for name in SQL_MAIN:
            sql = tpch.QUERIES[name]
            want = ctx.sql(sql).to_pandas()           # plans, columns warm
            route = ctx.history.entries()[-1].stats.get("route")
            warm = []
            for _ in range(SERVER_INPROCESS_REPEATS):
                t = time.perf_counter()
                want = ctx.sql(sql).to_pandas()
                warm.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            want_json = H._df_to_json_rows(want)
            enc_json_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            want_arrow = H._df_to_arrow(want)
            enc_arrow_ms = (time.perf_counter() - t) * 1e3
            exact = route != "scatter"
            rt = []
            for i in range(SERVER_JSON_POSTS):
                qid = f"server-{name}-{i}"
                t = time.perf_counter()
                code, _, body = spies.run(lambda: http_call(
                    srv.port, "/sql", {"sql": sql, "queryId": qid}))
                rt.append((time.perf_counter() - t) * 1e3)
                if code != 200:
                    raise AssertionError(f"server {name}: http {code} "
                                         f"{body[:200]}")
                if exact:
                    if body != want_json[:-1] + \
                            b', "queryId": "%s"}' % qid.encode():
                        raise AssertionError(f"server {name}: JSON differs "
                                             f"from the in-process answer")
                else:
                    check_frame(f"server {name} json", json_frame(body, want),
                                want, None, FLOAT_SUM_RTOL_KERNEL)
            t = time.perf_counter()
            code, hdrs, abody = spies.run(lambda: http_call(
                srv.port, "/sql", {"sql": sql, "format": "arrow"}))
            arrow_ms = (time.perf_counter() - t) * 1e3
            if code != 200 or hdrs.get("Content-Type") != \
                    "application/vnd.apache.arrow.stream":
                raise AssertionError(f"server {name} arrow: http {code}")
            if exact:
                if abody != want_arrow:
                    raise AssertionError(f"server {name}: Arrow differs from "
                                         f"the in-process answer")
            else:
                check_frame(f"server {name} arrow", arrow_frame(abody), want,
                            None, FLOAT_SUM_RTOL_KERNEL)
            stmts[name] = dict(
                route=route, exact_bytes=exact, rows=len(want),
                http_json_ms=statistics.median(rt), http_json_all_ms=rt,
                http_arrow_ms=arrow_ms,
                inprocess_warm_ms=statistics.median(warm),
                overhead_ms=statistics.median(rt) - statistics.median(warm),
                encode_json_ms=enc_json_ms, encode_arrow_ms=enc_arrow_ms,
                json_bytes=len(want_json), arrow_bytes=len(want_arrow))
        out["statements"] = stmts
        if spies.b1_launches < len(SQL_MAIN) - len(SQL_MEDIUM_K):
            raise AssertionError(f"server: {spies.b1_launches} B1 launches "
                                 f"for phase sql's statements")
        # (b) Q1's QuerySpec on the raw wire
        q1 = q1_spec(S, E)
        want = ctx.execute(q1).to_pandas()
        t = time.perf_counter()
        code, _, body = spies.run(lambda: http_call(
            srv.port, "/query", serde.query_to_dict(q1)))
        raw_ms = (time.perf_counter() - t) * 1e3
        if code != 200 or body != H._df_to_json_rows(want):
            raise AssertionError(f"server /query: http {code}, or not the "
                                 f"in-process answer")
        check_q1(json_frame(body, want), q1_oracle(df))
        out["raw_query"] = {"ms": raw_ms, "bytes": len(body)}
        # (c) 8 client threads into a one-slot lane: one shared-scan group
        sctx = serving_context(sdt, flat_ds, star,
                               {**ENGINE_TIMED, **HANDOFF_CONFIG})
        ssrv = H.SqlServer(sctx, "127.0.0.1", 0).start()
        servers.append(ssrv)
        queries = [tpch.QUERIES[n] for n in HANDOFF_SQL]
        solo = {n: ctx.sql(tpch.QUERIES[n]).to_pandas() for n in HANDOFF_SQL}
        for sql in dict.fromkeys(queries):            # plans and columns warm
            sctx.sql(sql)
        lane0 = next(ln for ln in sctx.engine.wlm.stats()["lanes"]
                     if ln["lane"] == "interactive")
        ss0 = sctx.engine.sharedscan.stats()
        res, ends = [None] * len(queries), [0.0] * len(queries)
        bar = threading.Barrier(len(queries))

        def client(i):
            bar.wait()
            res[i] = http_call(ssrv.port, "/sql",
                               {"sql": queries[i], "format": "arrow"})
            ends[i] = time.perf_counter()

        def storm():
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(queries))]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(300)
            return (max(ends) - t) * 1e3
        storm_ms = spies.run(storm)
        for name, (code, _, body) in zip(HANDOFF_SQL, res):
            if code != 200:
                raise AssertionError(f"server storm {name}: http {code}")
            check_frame(f"server storm {name} vs solo", arrow_frame(body),
                        solo[name], None, FLOAT_SUM_RTOL_KERNEL)
        lane = next(ln for ln in sctx.engine.wlm.stats()["lanes"]
                    if ln["lane"] == "interactive")
        ss = sctx.engine.sharedscan.stats()
        st = {"clients": len(queries), "wall_ms": storm_ms,
              "admitted": lane["admitted"] - lane0["admitted"],
              "wlm_handoffs": ss["wlm_handoffs"] - ss0["wlm_handoffs"],
              "queries_coalesced": ss["queries_coalesced"]
              - ss0["queries_coalesced"],
              "wave_launches": ss["wave_launches"] - ss0["wave_launches"],
              "max_active_seen": lane["max_active_seen"]}
        if st["max_active_seen"] != 1 or st["wlm_handoffs"] < 1 \
                or st["wave_launches"] < 1 \
                or st["admitted"] != len(queries):
            raise AssertionError(f"server storm: {st}")
        lanes_idle("server storm", sctx)
        out["storm"] = st
        # (d) a shed (429) and a cancel (499) under a one-slot lane
        shed_ctx = serving_context(sdt, flat_ds, star, SERVER_SHED_CONFIG)
        qsrv = H.SqlServer(shed_ctx, "127.0.0.1", 0).start()
        servers.append(qsrv)
        q6_sql = tpch.QUERIES["q6"]
        want6 = ctx.sql(q6_sql).to_pandas()
        held = {}

        def holder(qid, key):
            held[key] = http_call(qsrv.port, "/sql",
                                  {"sql": q6_sql, "queryId": qid})

        with Gate(shed_ctx.engine) as gate:
            th = threading.Thread(target=holder, args=("server-held", "held"))
            th.start()
            if not gate.entered.wait(60):
                raise AssertionError("server shed: the holder never ran")
            code, hdrs, body = http_call(qsrv.port, "/sql", {"sql": q6_sql})
            gate.release.set()
            spies.run(lambda: th.join(120))
        shed = json.loads(body.decode())
        if code != 429 or int(hdrs.get("Retry-After", 0)) < 1 \
                or shed.get("error") != "LaneFullError":
            raise AssertionError(f"server shed: http {code} {shed}")
        hcode, _, hbody = held["held"]
        if hcode != 200:
            raise AssertionError(f"server shed holder: http {hcode}")
        check_frame("server shed holder", json_frame(hbody, want6), want6,
                    None, 0.0)
        with Gate(shed_ctx.engine) as gate:
            th = threading.Thread(target=holder,
                                  args=("server-cancel", "cancel"))
            th.start()
            if not gate.entered.wait(60):
                raise AssertionError("server cancel: the victim never ran")
            t = time.perf_counter()
            code, _, body = http_call(qsrv.port, "/sql/cancel",
                                      {"queryId": "server-cancel"})
            gate.release.set()
            spies.run(lambda: th.join(120))
            cancel_ms = (time.perf_counter() - t) * 1e3
        vcode, _, vbody = held["cancel"]
        if code != 200 or not json.loads(body)["cancelled"] or vcode != 499 \
                or json.loads(vbody)["error"] != "QueryCancelled":
            raise AssertionError(f"server cancel: cancel http {code} "
                                 f"{body[:100]}, victim http {vcode} "
                                 f"{vbody[:200]}")
        code, _, body = spies.run(lambda: http_call(
            qsrv.port, "/sql", {"sql": q6_sql}))
        check_frame("server after cancel", json_frame(body, want6), want6,
                    None, 0.0)
        lanes_idle("server shed / cancel", shed_ctx)
        out["shed"] = {"status": 429, "retry_after_s":
                       int(hdrs.get("Retry-After", 0))}
        out["cancel"] = {"status": vcode, "ms_to_answer": cancel_ms}
        # (e) Arrow Flight do_get
        import pyarrow.flight as flight
        fsrv = F.SdotFlightServer(ctx, "grpc://127.0.0.1:0")
        client = flight.connect(f"grpc://127.0.0.1:{fsrv.port}")
        try:
            fl = {}
            for name in SERVER_FLIGHT_SQL:
                sql = tpch.QUERIES[name]
                want = ctx.sql(sql).to_pandas()
                cmd = F.encode_statement_query(sql)
                t = time.perf_counter()
                table = spies.run(lambda: client.do_get(
                    flight.Ticket(cmd)).read_all())
                fl[name] = {"ms": (time.perf_counter() - t) * 1e3,
                            "rows": table.num_rows,
                            "bytes": table.nbytes}
                bit_equal(f"server flight {name}", table.to_pandas(), want)
            out["flight"] = fl
        finally:
            client.close()
            fsrv.shutdown()
        code, _, body = http_call(srv.port, "/metadata/wlm")
        out["metadata_wlm_lanes"] = len(json.loads(body)["lanes"])
    finally:
        for x in servers:
            x.stop()
    timed = set()
    out["kernels"] = {"b1": b1_checked(CG, "server", spies.b1, timed),
                      "b2": [wave_timed(CW, f"server b2[{i}]", *w)
                             for i, w in enumerate(spies.b2)]}
    out["b1_launches"], out["b2_launches"] = spies.b1_launches, \
        spies.b2_launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- the broker / historical cluster (phase "cluster") ------------------------

CLUSTER_NODES = 3
CLUSTER_WARM = 3                 # warm runs per statement, broker and single
CLUSTER_INGEST_ROWS = 10_000
# docs/DISTRIBUTED.md's storm serving config on every historical
# (shared scan, single-slot lanes), plus the storm's monthly-lane key tier
CLUSTER_HIST_CONFIG = {
    **ENGINE_TIMED, "sdot.sharedscan.enabled": True,
    "sdot.sharedscan.max.queries": 64, "sdot.wlm.batch.window.ms": 25.0,
    "sdot.wlm.lanes": ("interactive:slots=1,queue=256;"
                       "reporting:slots=1,queue=64;batch:slots=1,queue=32"),
    "sdot.engine.groupby.pallas.max.keys": 128}
# the broker passes the storm's concurrency through (DISTRIBUTED.md:
# scatter threads ~ users x shards, lanes at least as wide as the users)
CLUSTER_BROKER_CONFIG = {
    **ENGINE_TIMED, "sdot.cluster.role": "broker",
    "sdot.cluster.replication": 2,
    "sdot.cluster.probe.interval.seconds": 0.2,
    "sdot.cluster.retry.backoff.start.seconds": 0.01,
    "sdot.cluster.scatter.threads": 32,
    "sdot.wlm.lanes": ("interactive:slots=16,queue=256;"
                       "reporting:slots=16,queue=64;batch:slots=16,queue=64"),
    "sdot.engine.groupby.pallas.max.keys": 128}
CLUSTER_SQL = {
    "q1": None,          # tpch.QUERIES, over lineitem
    "q6": None,
    "topn": ("select l_shipmode, sum(l_extendedprice) as rev, "
             "count(*) as n from lineitem group by l_shipmode "
             "order by rev desc limit 3"),
    "sketch": ("select l_returnflag, l_linestatus, count(*) as n, "
               "approx_count_distinct(l_orderkey) as u_order, "
               "approx_count_distinct_theta(l_suppkey) as t_supp, "
               "percentile_approx(l_extendedprice, 0.5) as p50 "
               "from lineitem group by l_returnflag, l_linestatus "
               "order by l_returnflag, l_linestatus"),
}


def link_root(src, dst):
    """A copy of a persist root whose snapshot blobs are hard links (a
    snapshot version never changes once written) and whose other files
    (the WAL, pointers, manifests, dictionaries) are copies."""
    import os
    import shutil

    def copy(a, b):
        if a.endswith(".bin"):
            os.link(a, b)
        else:
            shutil.copy2(a, b)
    shutil.copytree(src, dst, copy_function=copy)


def free_ports(n):
    import socket
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class RpcLog:
    """Wraps a broker client's ``_rpc``: each subquery RPC's node, ms and
    response bytes, while installed."""

    def __init__(self, client):
        self.client, self.real, self.calls = client, client._rpc, []

    def __enter__(self):
        def rpc(st, node_id, payload, deadline, path="/cluster/subquery"):
            t = time.perf_counter()
            status, body = self.real(st, node_id, payload, deadline,
                                     path=path)
            self.calls.append((node_id, (time.perf_counter() - t) * 1e3,
                               len(body), status))
            return status, body
        self.client._rpc = rpc
        return self

    def __exit__(self, *exc):
        del self.client._rpc

    def summary(self, since=0) -> dict:
        out = {}
        for nid, ms, nbytes, status in self.calls[since:]:
            d = out.setdefault(str(nid), {"rpcs": 0, "ms": [], "bytes": 0})
            d["rpcs"] += 1
            d["ms"].append(ms)
            d["bytes"] += nbytes
        for d in out.values():
            d["median_ms"] = statistics.median(d.pop("ms"))
        return out


def cluster_phase(sdt, root, S, E, df, CG, CW, smi, device="cuda") -> dict:
    """Phase ``cluster``: 3 in-process historicals and a broker on the
    card over phase persist's raw SF1 lineitem root (6 segments; shards at
    their default, one per node; replication 2; shared scan on with the
    storm serving config of docs/DISTRIBUTED.md). Q1, Q6, a TopN and an
    HLL + theta + KLL statement through the broker against the
    single-process context over the same root (ints, dims and sketch
    estimates exact, floats rtol 1e-9); the 8-spec storm from 8 threads
    (the B2 launches per historical); a historical stopped mid-storm with
    zero mismatches; its restart, probed back up; a 10,000-row
    ``stream_ingest`` pushed to the shard's owners and read back through
    the broker (read-your-writes)."""
    import threading

    from spark_druid_olap_tpu_torch.cluster.historical import HistoricalNode
    from spark_druid_olap_tpu_torch.tools import tpch
    t_phase = time.perf_counter()
    spies = KernelSpies(CG, CW)
    out = {"card": smi, "nodes": CLUSTER_NODES}
    nodes_csv = ",".join(f"127.0.0.1:{p}" for p in free_ports(CLUSTER_NODES))
    common = {**CLUSTER_HIST_CONFIG, "sdot.persist.path": root,
              "sdot.cluster.nodes": nodes_csv,
              "sdot.cluster.replication": 2}
    hist, broker, single = [], None, None
    try:
        boot_ms = []
        for i in range(CLUSTER_NODES):
            t = time.perf_counter()
            hist.append(HistoricalNode(dict(common), node_id=i,
                                       device=device).start())
            boot_ms.append((time.perf_counter() - t) * 1e3)
        out["boot_ms"] = boot_ms
        out["shards"] = {str(h.node_id): h.ctx.store.names() for h in hist}
        t = time.perf_counter()
        broker = sdt.Context({**CLUSTER_BROKER_CONFIG,
                              "sdot.persist.path": root,
                              "sdot.cluster.nodes": nodes_csv}, device=device)
        out["broker_boot_ms"] = (time.perf_counter() - t) * 1e3
        single = sdt.Context({**ENGINE_TIMED, "sdot.persist.path": root},
                             device=device)
        cl = broker.cluster
        plan = cl.plan.datasources["lineitem"]
        out["plan"] = {"shards": plan.n_shards, "segments": plan.num_segments,
                       "rows": plan.num_rows,
                       "owners": {str(sh.index): list(sh.owners)
                                  for sh in plan.shards}}
        if plan.n_shards != CLUSTER_NODES:
            raise AssertionError(f"cluster: {plan.n_shards} shards")
        rpc = RpcLog(cl)
        stmts = {}
        with rpc:
            for name, sql in CLUSTER_SQL.items():
                sql = sql or tpch.QUERIES[name]
                want = single.sql(sql).to_pandas()
                since = len(rpc.calls)
                t = time.perf_counter()
                got = spies.run(lambda: broker.sql(sql).to_pandas())
                cold_ms = (time.perf_counter() - t) * 1e3
                st = dict(broker.engine.last_stats.get("cluster") or {})
                if st.get("mode") != "scatter":
                    raise AssertionError(f"cluster {name}: {st}")
                if name == "sketch":
                    bit_equal("cluster sketch vs single", got, want)
                else:
                    check_frame(f"cluster {name} vs single", got, want, None,
                                FLOAT_SUM_RTOL_KERNEL)
                rpc_cold, mid = rpc.summary(since), len(rpc.calls)
                warm, swarm, merge = [], [], []
                for _ in range(CLUSTER_WARM):
                    t = time.perf_counter()
                    spies.run(lambda: broker.sql(sql).to_pandas())
                    warm.append((time.perf_counter() - t) * 1e3)
                    merge.append(broker.engine.last_stats["cluster"]
                                 ["merge_ms"])
                    t = time.perf_counter()
                    single.sql(sql).to_pandas()
                    swarm.append((time.perf_counter() - t) * 1e3)
                stmts[name] = dict(
                    rows=len(got), cold_ms=cold_ms,
                    scatter_ms=statistics.median(warm), merge_ms=statistics
                    .median(merge), single_warm_ms=statistics.median(swarm),
                    broker_over_single=statistics.median(warm)
                    / statistics.median(swarm),
                    shards=st.get("shards"), nodes=st.get("nodes"),
                    rpc_cold=rpc_cold, rpc_warm=rpc.summary(mid))
        out["statements"] = stmts
        # (b) the 8-spec storm from 8 threads: per-node coalescing (B2)
        specs = storm_specs(S, E)
        names, slist = list(specs), list(specs.values())
        solo = {n: single.execute(q).to_pandas() for n, q in specs.items()}
        ss0 = [h.ctx.engine.sharedscan.stats() for h in hist]
        res, storm_ms, _ = spies.run(lambda: run_storm(broker, slist))
        ss1 = [h.ctx.engine.sharedscan.stats() for h in hist]
        for n, got in zip(names, res):
            check_frame(f"cluster storm {n} vs single", got, solo[n], None,
                        FLOAT_SUM_RTOL_KERNEL)
        per_node = {str(h.node_id): {
            k: ss1[i][k] - ss0[i][k] for k in
            ("queries_coalesced", "wave_launches", "wave_fallbacks",
             "solo_groups")} for i, h in enumerate(hist)}
        for i, h in enumerate(hist):
            per_node[str(h.node_id)]["wave_fallback_reasons"] = {
                k: v - ss0[i]["wave_fallback_reasons"].get(k, 0)
                for k, v in ss1[i]["wave_fallback_reasons"].items()
                if v != ss0[i]["wave_fallback_reasons"].get(k, 0)}
        if any(d["wave_launches"] < 1 for d in per_node.values()):
            raise AssertionError(f"cluster storm: a historical launched no "
                                 f"B2: {per_node}")
        # the same storm again, every node's lane programs built
        res, warm_storm_ms, _ = spies.run(lambda: run_storm(broker, slist))
        for n, got in zip(names, res):
            check_frame(f"cluster warm storm {n} vs single", got, solo[n],
                        None, FLOAT_SUM_RTOL_KERNEL)
        out["storm"] = {"queries": names, "cold_wall_ms": storm_ms,
                        "warm_wall_ms": warm_storm_ms, "per_node": per_node}
        # (c) one historical stopped mid-storm: zero mismatches
        victim = 1
        lock = threading.Lock()
        done, ends, errors, mismatches = threading.Event(), [], [], []
        failovers0 = cl.counters["failovers"]

        def worker(i):
            for k in range(2):
                try:
                    got = broker.execute(slist[(i + k) % len(slist)]) \
                        .to_pandas()
                    check_frame("failover", got,
                                solo[names[(i + k) % len(slist)]], None,
                                FLOAT_SUM_RTOL_KERNEL)
                except AssertionError as e:
                    mismatches.append(str(e)[:200])
                except Exception as e:  # noqa: BLE001 — raised below
                    errors.append(repr(e)[:200])
                with lock:
                    ends.append(time.perf_counter())
                done.set()

        def failover_storm():
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(len(slist))]
            for th in threads:
                th.start()
            if not done.wait(120):
                raise AssertionError("cluster failover: no first answer")
            t_stop = time.perf_counter()
            hist[victim].ready = False
            hist[victim].server.stop(join_timeout_s=0.2)
            for th in threads:
                th.join(300)
            return t_stop
        t_stop = spies.run(failover_storm)
        if errors or mismatches:
            raise AssertionError(f"cluster failover: errors {errors[:2]}, "
                                 f"mismatches {mismatches[:2]}")
        after = sorted(e for e in ends if e > t_stop)
        out["failover"] = {
            "victim": victim, "answers": len(ends), "mismatches": 0,
            "answers_after_stop": len(after),
            "stop_to_first_answer_ms": (after[0] - t_stop) * 1e3
            if after else None,
            "failovers": cl.counters["failovers"] - failovers0}
        # (d) the restart, probed back up, then Q1 through it
        hist[victim].stop()
        t = time.perf_counter()
        hist[victim] = HistoricalNode(dict(common), node_id=victim,
                                      device=device).start()
        restart_ms = (time.perf_counter() - t) * 1e3
        deadline = time.monotonic() + 30
        while cl.stats()["nodes"][victim]["state"] != "up":
            if time.monotonic() > deadline:
                raise AssertionError("cluster: restarted node never up")
            time.sleep(0.02)
        up_ms = (time.perf_counter() - t) * 1e3 - restart_ms
        q1 = q1_spec(S, E)
        got = spies.run(lambda: broker.execute(q1).to_pandas())
        st = broker.engine.last_stats.get("cluster") or {}
        if victim not in (st.get("nodes") or ()):
            raise AssertionError(f"cluster restart: node {victim} unused "
                                 f"{st}")
        check_frame("cluster restart q1", got, solo["q1"], None,
                    FLOAT_SUM_RTOL_KERNEL)
        out["restart"] = {"boot_ms": restart_ms, "probe_up_ms": up_ms,
                          "breaker_resets": cl.counters["breaker_resets"]}
        # (e) stream_ingest pushed to the owners, read back (RYW)
        batch = df.iloc[:CLUSTER_INGEST_ROWS].reset_index(drop=True)
        single.close()
        expect = sdt.Context(ENGINE_TIMED, device=device)
        expect.store.register(single.store.get("lineitem"))
        expect.stream_ingest("lineitem", batch, time_column="l_shipdate")
        want = expect.execute(q1).to_pandas()
        pushes0 = cl.counters["ingest_pushes"]
        t = time.perf_counter()
        broker.stream_ingest("lineitem", batch, time_column="l_shipdate")
        ingest_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        got = spies.run(lambda: broker.execute(q1).to_pandas())
        ryw_ms = (time.perf_counter() - t) * 1e3
        st = broker.engine.last_stats.get("cluster") or {}
        if st.get("mode") != "scatter" or cl.counters["ryw_scatters"] < 1:
            raise AssertionError(f"cluster ingest: not a read-your-writes "
                                 f"scatter: {st}")
        check_frame("cluster ingest q1", got, want, None,
                    FLOAT_SUM_RTOL_KERNEL)
        ing = cl.stats()["ingest"]
        out["ingest"] = {"rows": CLUSTER_INGEST_ROWS, "ms": ingest_ms,
                         "q1_after_ms": ryw_ms,
                         "pushes": cl.counters["ingest_pushes"] - pushes0,
                         "push_failures": cl.counters["ingest_push_failures"],
                         "state": ing["datasources"].get("lineitem")}
        out["broker"] = {k: cl.counters[k] for k in (
            "queries", "scatters", "subqueries", "retries", "failovers",
            "local_fallbacks", "probe_marks_down", "probe_marks_up",
            "ryw_scatters", "ingest_pushes")}
    finally:
        for h in hist:
            h.stop()
        if broker is not None:
            broker.close()
    timed = set()
    out["kernels"] = {"b1": b1_checked(CG, "cluster", spies.b1, timed),
                      "b2": [wave_timed(CW, f"cluster b2[{i}]", *w, timed)
                             for i, w in enumerate(spies.b2)]}
    out["b1_launches"], out["b2_launches"] = spies.b1_launches, \
        spies.b2_launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


NEW_PHASES = ("ssb", "rollup", "append", "persist", "modules", "server",
              "cluster")


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
    loss_guard = LossGuard()
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

    # 3b. the SSB workload: SF1 streamed from Parquet into ssb_flat, its 13
    # statements against pandas, the q1 flight as one storm
    ssb = ssb_phase(sdt, CG, CW, smi)
    emit("ssb", **ssb,
         oracle="pandas from the lineorder Parquet file and the generator's "
                "dimensions, each dimension column reached by its key, "
                "floats as stored and each row's expression in float32, as "
                "the engine evaluates it: ints exact, float sums rtol 1e-6, "
                "the statement's order; the "
                "storm's answers vs the solo answers (floats rtol 1e-9); "
                "each B1 call and the B2 launch vs their plain versions "
                "(kernels)",
         note="ms: host wall clock to the frame, cold = the first run "
              "(columns uploaded), warm = median of 7; idle share: "
              "torch.profiler over one warm run (null where the profile "
              "lost device records); ingest_rss_gb: the process's VmRSS "
              "before, after and at its largest during the streamed "
              "ingest (method hwm: VmHWM reset on entry; poll: VmRSS "
              "read every 5 ms, and ingest_s then from a second ingest "
              "without the poller, ingest_polled_s from the first)")

    # 4. the main path at SF1; every ingest from here on encodes its
    # string columns with the native encoder where it loaded
    encoder = native_state()
    say(f"native encoder: loaded {encoder['native_loaded']}, pyarrow "
        f"{encoder['pyarrow']}" + ("" if encoder["native_loaded"] else
                                   " (the numpy path: a host fast path "
                                   "is missing, not a device one)"))
    took = encoder_spy()
    t0 = time.perf_counter()
    tables = generate(SF, seed=SEED)
    df = tables["lineitem"]
    t_gen = time.perf_counter() - t0
    ctx = sdt.Context(ENGINE_TIMED)
    t0 = time.perf_counter()
    ctx.ingest_dataframe("lineitem", df, time_column="l_shipdate")
    t_ingest = time.perf_counter() - t0

    # 4a. the SQL front end over the flattened star
    sql_b1, sql_b2, sql_k, hashed, tail, sketch, extra = sql_phase(
        sdt, tables, ctx.store.get("lineitem"), CG, CW, smi)
    join, window = extra["join"], extra["window"]
    emit("ingest", card=smi, sf=SF, rows=len(df), generate_s=t_gen,
         ingest_s=t_ingest, segments=ctx.store.get("lineitem").num_segments,
         flat_ingest_s=extra["flat_ingest_s"],
         base_tables_ingest_s=extra["base_tables_ingest_s"],
         **encoder, columns=native_columns(encoder, took, "sql"),
         on_off=join["encoder"],
         note="seconds: host wall clock; on_off: orders ingested in this "
              "run with the native encoder and without it (the numpy "
              "path), equal dictionaries and codes")
    emit("join", card=smi, **{k: v for k, v in join.items()
                              if k != "encoder"},
         oracle="pandas on the generator's tables (floats as stored, "
                "float32: ints exact, float sums rtol 1e-6); the same "
                "statement on the host tier (sdot.join.enabled false); J4 "
                "(>= 3 probe waves) equal to J1 exactly; each B1 call vs "
                "its plain version (b1)",
         note="ms: host wall clock to the frame, warm = median of 7; "
              "stream_ms: one warm run, CUDA events around each call of "
              "the step, summed over its calls (stream ms: an upper bound "
              "on device time, since the span also holds the host's "
              "queueing gaps)")
    emit("window", card=smi, **window,
         oracle="pandas on the generator's tables: W1's revenue rtol 1e-6 "
                "and its ranks exactly as pandas ranks the statement's own "
                "revenue; W2 / W3 exact but the moving sum (rtol 1e-6)",
         note="ms: host wall clock to the frame, warm = median of 7; "
              "stream_ms: one warm run, CUDA events around each window "
              "function, summed over its calls (stream ms: an upper bound "
              "on device time, since the span also holds the host's "
              "queueing gaps)")
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

    # 4a''. the result cache, WLM and cancellation around the engine, with
    # the defaults, on phase sql's flat star
    flat_ds = extra.pop("flat_ds")
    serving = serving_phase(sdt, S, E, flat_ds,
                            ctx.store.get("lineitem"), df, tables, CG, CW)
    emit("serving", card=smi, **serving,
         oracle="each hit bit for bit the frame of the miss that put it; "
                "warm misses vs the first (floats rtol 1e-9: q7's scatter "
                "tier sums in atomics' order); subsumed answers vs the "
                "same spec with the cache off (floats rtol 1e-9); the "
                "handoff storm's and the held batch's answers vs the "
                "solo answers (floats rtol 1e-9); Q1 / Q6 after a cancel "
                "or timeout vs pandas (floats rtol 1e-6); every lane 0 "
                "running and 0 queued after each step; each B1 call and "
                "B2 launch of the phase's spied runs vs its plain version "
                "(kernels)",
         note="ms: host wall clock to the frame, medians of 7; miss = the "
              "cache cleared before each call (plans and columns warm); "
              "engine = inside engine.execute (WLM admission, cache "
              "lookup, the engine), session = the rest; wlm_admit / "
              "cache_lookup: the statement's utils/phases host phases; "
              "kernels: timed as in phase timing (the plain version and "
              "the library call medians of 3)")

    # 4b'. the HTTP SQL server and Arrow Flight over the same flat star
    server = server_phase(sdt, flat_ds, ctx.store.get("lineitem"), S, E, df,
                          CG, CW, smi)
    del flat_ds
    emit("server", **server,
         oracle="each JSON and Arrow response byte for byte the in-process "
                "Context.sql answer through the server's own encoders (a "
                "statement on the scatter tier decoded, floats rtol 1e-9); "
                "/query's Q1 byte for byte ctx.execute's and vs pandas "
                "(floats rtol 1e-6); the 8-client storm's answers vs the "
                "in-process ones (floats rtol 1e-9) in one shared-scan "
                "group; the shed holder's and the post-cancel Q6 exact; "
                "Flight tables bit for bit; each B1 call and B2 launch "
                "inside the server vs its plain version (kernels)",
         note="ms: host wall clock; http_json_ms: median of 3 POSTs (urllib "
              "client, a new connection each, loopback), inprocess_warm_ms: "
              "median of 3 ctx.sql calls; overhead_ms = their difference; "
              "encode_*_ms: the server's encoder on the answer frame; "
              "bytes: the response body; kernels: a B1 call of a shape "
              "already timed in the phase is checked, not timed again")

    # 4c. rollups over lineitem and ssb_flat, stream appends, modules
    rollup = rollup_phase(sdt, ctx.store.get("lineitem"), df, CG, CW, smi)
    emit("rollup", **rollup,
         oracle="each rollup answer vs the same statement with "
                "sdot.mv.rewrite.enabled false (ints exact, floats rtol "
                "1e-4: tests/test_rollup.py's tolerance, the rollup sums "
                "stored f64 partials) and Q1 / Q6 vs pandas (floats rtol "
                "1e-6), fresh, stale after an append (the base answers) and "
                "refreshed; each B1 call vs its plain version (kernels)",
         note="warm_ms / rewrite_off_warm_ms: host wall clock to the "
              "frame, median of 7 after a first (spied) run, with the "
              "rewrite on and off; build_ms: CREATE ROLLUP, the backing "
              "datasource's group-by and its ingest (host_tier: the "
              "group-by fell to the host tier)")
    append = append_phase(sdt, S, E, ctx.store.get("lineitem"), df, CG, CW,
                          smi)
    emit("append", **append,
         oracle="Q1 and the storm of 8 QuerySpecs after each batch vs "
                "pandas over the concatenated frame (ints exact, floats "
                "rtol 1e-6); Q1 cached before a batch (hit), a miss after "
                "it; each B1 call and B2 launch vs its plain version "
                "(kernels)",
         note="ms: host wall clock; stream_ingest_ms: the append (the "
              "dictionary merge and code remap of every column, O(rows)); "
              "q1_ms: the first Q1 after it (a result-cache miss, the new "
              "columns uploaded)")
    import tempfile
    cluster_tmp = tempfile.TemporaryDirectory(prefix="sdot_cluster_")
    cluster_root = str(pathlib.Path(cluster_tmp.name) / "root")
    persist = persist_phase(sdt, S, E, ctx.store.get("lineitem"), df, append,
                            CG, CW, smi, keep_root=cluster_root)
    emit("persist", **persist,
         oracle="recovered stores vs the ingested store column by column, "
                "bit for bit (dictionaries included); Q1 / Q6 / the storm "
                "after recovery vs pandas (ints exact, floats rtol 1e-6) "
                "and bit for bit vs the answers before the checkpoint; "
                "after the journaled appends Q1 and the storm vs pandas "
                "over the concatenated frame; the journaled root replayed "
                "in a fresh context: its store bit for bit vs the live one, "
                "every frame replayed, Q1 bit for bit; the kill -9 child's "
                "root: "
                "every acknowledged batch whole, none in part, at most one "
                "unacknowledged per producer, Q1 vs pandas over exactly "
                "the recovered batches; compacted Q1 / storm vs their "
                "answers before compaction (ints exact, floats rtol 1e-6); "
                "Q1 after RESTORE bit for bit vs before it; tier: every "
                "tiered answer bit for bit vs the eager context in the same "
                "waves, vs step (b)'s one-wave answers (ints exact, floats "
                "rtol 1e-9) and vs pandas, residency <= budget + pinned at "
                "every sample; device_loss: the child's demoted Q1 / Q6 vs "
                "pandas in mode host (backend_lost ...), no bind inside the "
                "cooldown, the probe false within its deadline, the "
                "restarted Q1 in engine mode bit for bit the child's first; "
                "each B1 call and B2 launch of a spied run vs its plain "
                "version (kernels)",
         note="ms / s: host wall clock; recovery_ms: the manager's "
              "recovery report (snapshot load, checksums, WAL replay; "
              "replay: the SF1 snapshot plus the 20 journaled frames); "
              "checksum_verify_ms: stats['persist'] of the first "
              "statement; cold = the first statement over the recovered "
              "store (columns uploaded); the WAL's fsync and group commit "
              "on; the root in a temporary directory on the machine's "
              "local disk, its reads warm (file cache not dropped); "
              "steps_s: host wall seconds of each step of the phase; "
              "tier: boot_ms the tiered context's construction, ms host "
              "wall clock of each run to its frame, tier the hot set's "
              "counters the run moved, fault_ms / decode_ms the demand "
              "path's tier.fault / tier.decode phases on the calling "
              "thread (the storm's run on its workers: not counted), "
              "peak_resident_bytes / peak_pinned_bytes sampled every ms; "
              "device_loss: since_poison_ms from the poisoning kernel's "
              "launch to the first host answer, probe_ms the re-attach "
              "probe's wall clock")
    modules = modules_phase(sdt, S, E, ctx.store.get("lineitem"), df, CG, CW,
                            smi)
    emit("modules", **modules,
         oracle="flagname's group-by and the clamped topN vs pandas (ints "
                "exact, floats rtol 1e-6); the raw Q1 QuerySpec vs Q1 "
                "through SQL (floats rtol 1e-9) and pandas; each B1 call "
                "vs its plain version (kernels)",
         note="ms: host wall clock to the frame")
    # 4d. the broker / historical cluster over phase persist's raw root
    cluster = cluster_phase(sdt, cluster_root, S, E, df, CG, CW, smi)
    cluster_tmp.cleanup()
    emit("cluster", **cluster,
         oracle="each broker answer vs the single-process context over the "
                "same root (ints and dims exact, floats rtol 1e-9; the "
                "sketch statement bit for bit); the storm's and the "
                "failover storm's answers vs the single context's (floats "
                "rtol 1e-9), zero mismatches; Q1 after the restart vs the "
                "single context; Q1 after the 10,000-row stream_ingest vs "
                "an in-memory context holding the same rows (floats rtol "
                "1e-9), served by a read-your-writes scatter; each B1 call "
                "and B2 launch inside the historicals vs its plain version "
                "(kernels)",
         note="ms: host wall clock; boot_ms: HistoricalNode.start (the "
              "server, recovery of the root, the owned shards sliced); "
              "scatter_ms: the broker's statement, median of 3 warm runs "
              "(merge_ms inside it), single_warm_ms: the same statement on "
              "the single context, median of 3; rpc_*: per node, subquery "
              "RPCs (http.client, loopback) with their median ms and "
              "response bytes, cold = the first run (shard columns "
              "uploaded); storm cold_wall_ms: the first storm (each "
              "node traces and builds its lane programs), warm_wall_ms: "
              "the second; per_node: each historical's shared-scan "
              "counters over the first; stop_to_first_answer_ms: from the "
              "stop to the first broker answer completed after it; "
              "probe_up_ms: from the restarted node's start returning to "
              "the broker's prober marking it up; kernels: a call of a "
              "shape already timed in the phase is checked, not timed "
              "again")
    new_phases = (ssb, rollup, append, persist, modules, server, cluster)

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

    # 6b. the spatial filter over SF1 lineitem (B1, one B2 lane, pruning)
    spatial = spatial_phase(sdt, df, S, E, CG, CW)
    emit("spatial", card=smi, **spatial,
         oracle="pandas on the same frame (ints exact, floats rtol 1e-6); "
                "the storm lane vs its solo answer and the pruned vs the "
                "unpruned answer (floats rtol 1e-9); each B1 call and the "
                "B2 launch vs their plain versions (b1, b2)",
         note="ms: host wall clock to the frame, warm = median of 7")

    # 7. multi-wave binding at WAVES_SF, after the SF1 state leaves host
    # and card
    waves_source = (df, ctx.store.get("lineitem"))
    del ctx, storm, ds, df, tables, captured, program, layout, scols, got
    del sres, solo
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    native_columns(encoder, took, "spatial")
    waves = waves_phase(sdt, S, E, CG, CW, smi, df=waves_source[0],
                        ds=waves_source[1])
    del waves_source
    waves["encoder_columns"] = native_columns(encoder, took, "waves")
    emit("waves", **waves,
         oracle="each statement multi-wave vs the same statement in one "
                "wave (ints, counts, min/max and sketch registers exact; "
                "floats rtol 1e-9) and vs pandas (floats rtol 1e-6; the "
                "sketch estimates as in phase sketch; the storm's Q1); "
                "every B1 / B2 launch of every wave vs its plain version; "
                "explain: Q1's printed waves=NxM equal to the waves it "
                "runs, Q6's printed survivor budget equal to its run's "
                "compact_m, both vs pandas",
         note="per wave: bind_ms host (gather into pinned staging), "
              "h2d_bytes / h2d_ms (CUDA events on the copy stream), "
              "compute_ms (CUDA events around the wave's program on the "
              "compute stream), kernel_ms (the wave's B1 call, timed as "
              "in phase timing); overlap_share = 1 - wall / (sum of bind "
              "+ copy + compute); single-wave cold = device cache "
              "dropped before each run; pinned_copy_gb_per_s: one copy "
              "of the widest wave's bytes from pinned memory")

    loss_guard.check("chip_smoke")
    # 8. every ported kernel with its check result: the sums over the
    # shapes the main path gave it (Q1, Q6, wide, the SQL statements and
    # the waves for B1; the QuerySpec, SQL and wave storms for B2)
    for k in list(sql_k["dense_groupby"].values()) \
            + list(tail["kernels"].values()) \
            + [sketch["b1"], waves["b1"], spatial["b1"], join["b1"],
               serving["kernels"]["b1"]] \
            + [p["kernels"]["b1"] for p in new_phases]:
        worst = max(worst, k["max_abs_err"])
        for f in ("ms", "plain_ms", "bound_ms", "library_ms"):
            total[f] += k[f]
        bound_by.update(c["bound_by"] for c in k["calls"]
                        if "bound_by" in c)
    sw, kw, ww = sql_k["wave"]["storm"], sketch["wave"], waves["b2"]
    pw = spatial["b2"]
    vw = serving["kernels"]["b2"] \
        + [w for p in new_phases for w in p["kernels"]["b2"]]
    w_worst = max(w_worst, sw["max_abs_err"], kw["max_abs_err"],
                  ww["max_abs_err"], pw["max_abs_err"],
                  *(w["max_abs_err"] for w in vw))
    w_bound_by = {wave_timing["bound_by"], sw["bound_by"], kw["bound_by"],
                  *ww["bound_by"], pw["bound_by"],
                  *(w["bound_by"] for w in vw)}
    say(json.dumps({"kernels": [{
        "name": "dense_groupby", "route": "cuda",
        "source": "spark_druid_olap_tpu_torch/csrc/dense_groupby.cu",
        "replaces": "spark_druid_olap_tpu/ops/pallas_groupby.py:205",
        "launches": l1 + l6 + lw + sql_b1 + tail["b1_launches"]
        + sketch["b1_launches"] + waves["launches"]["dense_groupby"]
        + spatial["b1_launches"] + join["b1_launches"]
        + serving["b1_launches"] + sum(p["b1_launches"] for p in new_phases),
        "max_abs_err": worst,
        "b1_checked": dict({n: len(k["calls"])
                            for n, k in tail["kernels"].items()},
                           sketch_solo=len(sketch["b1"]["calls"]),
                           waves=len(waves["b1"]["calls"]),
                           spatial=len(spatial["b1"]["calls"]),
                           join=len(join["b1"]["calls"]),
                           serving=len(serving["kernels"]["b1"]["calls"]),
                           **{n: len(p["kernels"]["b1"]["calls"])
                              for n, p in zip(NEW_PHASES, new_phases)}),
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
        "library_ms": total["library_ms"]}, {
        "name": "wave", "route": "cuda",
        "source": "spark_druid_olap_tpu_torch/csrc/wave.cu",
        "replaces": "spark_druid_olap_tpu/ops/pallas_wave.py:371",
        "launches": storm_launches + sql_b2 + sketch["b2_launches"]
        + waves["launches"]["wave"] + spatial["b2_launches"]
        + serving["b2_launches"] + sum(p["b2_launches"] for p in new_phases),
        "max_abs_err": w_worst,
        "ms": wk_ms + sw["ms"] + kw["ms"] + ww["ms"] + pw["ms"]
        + sum(w["ms"] for w in vw),
        "plain_ms": wp_ms + sw["plain_ms"] + kw["plain_ms"]
        + ww["plain_ms"] + pw["plain_ms"] + sum(w["plain_ms"] for w in vw),
        "bound_ms": wave_timing["bound_ms"] + sw["bound_ms"]
        + kw["bound_ms"] + ww["bound_ms"] + pw["bound_ms"]
        + sum(w["bound_ms"] for w in vw),
        "b2_checked": {"waves": ww["calls"], "spatial": 1,
                       "serving": len(serving["kernels"]["b2"]),
                       **{n: len(p["kernels"]["b2"])
                          for n, p in zip(NEW_PHASES, new_phases)}},
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
    if sys.argv[1:2] == ["--persist-child"]:
        sys.exit(persist_child(*sys.argv[2:6]))
    if sys.argv[1:2] == ["--device-loss-child"]:
        sys.exit(device_loss_child(sys.argv[2]))
    sys.exit(main())
