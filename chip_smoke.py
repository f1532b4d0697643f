"""Chip smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — ``Context()`` -> ``ingest_dataframe`` ->
``execute(QuerySpec)`` -> the fused dense group-by CUDA kernel — over TPC-H
SF1 lineitem (~6M rows, generated from a seed by the port's own
``tools/tpch.py``), with TPC-H Q1 and Q6 written as QuerySpecs, and Q1's
grouping with 17 aggregates (more than one kernel launch takes), each checked
against a pandas oracle on the same frame. Before that it builds every
kernel of the path from the sources in this checkout and holds each against
its plain PyTorch version on the card. Each phase prints one JSON line; the
``kernels`` line and the card's ``nvidia-smi`` name and power limit come
before the last line, which is ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; so does a machine without CUDA. The
script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20260729
SF = 1.0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data-sheet memory rate
FP32_OPS_PER_S = 67e12           # H100 SXM data-sheet fp32 rate (no tensor cores)
FLOAT_SUM_RTOL_KERNEL = 1e-9     # both sides sum in f64; only the order differs
FLOAT_SUM_RTOL_ORACLE = 1e-6     # float metric columns are stored f32
REPEATS = 7


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# -- kernel vs plain version ---------------------------------------------------

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


def kernel_cases(CG, dev):
    """Kernel vs plain version over the sizes, key counts and edge cases
    of the contract; returns (cases run, largest float difference)."""
    from spark_druid_olap_tpu_torch.ops.groupby import AggInput as Agg
    rng = np.random.default_rng(SEED)
    cases, worst = 0, 0.0

    def run(name, key, n_keys, inputs, check=None):
        nonlocal cases, worst
        got = CG.dense_groupby_kernel(key, n_keys, inputs, 64)
        torch.cuda.synchronize()
        want = CG.dense_groupby_reference(key, n_keys, inputs)
        torch.cuda.synchronize()
        worst = max(worst, compare(name, got, want, inputs))
        if check is not None:
            check(got)
        cases += 1
        return got

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
    before = CG.launches
    run("wide_24_aggs", key, 6, wide)
    want_launches = -(-len(wide) // CG.MAX_AGGS)
    if CG.launches - before != want_launches:
        raise AssertionError(f"{len(wide)} aggregates took "
                             f"{CG.launches - before} launches, not "
                             f"{want_launches}")

    # the same input gives bit-identical float sums on every run
    key = on(rng.integers(0, 7, n, dtype=np.int32))
    inputs = [Agg("s", "sum", on(rng.random(n, dtype=np.float32)))]
    a = CG.dense_groupby_kernel(key, 6, inputs, 64)["s"].clone()
    b = CG.dense_groupby_kernel(key, 6, inputs, 64)["s"]
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("kernel float sums are not deterministic")
    return cases, worst


# -- timing --------------------------------------------------------------------

_flush_buf = None


def flush_l2():
    """Evict the 50 MB L2 so each timed launch reads from device memory,
    as the main path's first read of a bound column does."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    _flush_buf.zero_()


def device_ms(fn, repeats=REPEATS) -> float:
    """Median device time of ``fn`` over ``repeats`` cold-L2 calls, from
    CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        flush_l2()
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


def profile_query(ctx, spec) -> dict:
    """One warm run under torch.profiler: device busy time by kernel, and
    the device's idle share of the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    timed_execute(ctx, spec)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = timed_execute(ctx, spec)

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return float(v if v is not None else e.self_cuda_time_total)
    events = sorted((e for e in prof.key_averages() if dev_us(e) > 0),
                    key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "top": [{"name": e.key[:80], "calls": e.count,
                     "device_ms": dev_us(e) / 1e3} for e in events[:10]]}


# -- the main path ---------------------------------------------------------------

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import spark_druid_olap_tpu_torch as sdt
    from spark_druid_olap_tpu_torch.ir import expr as E
    from spark_druid_olap_tpu_torch.ir import spec as S
    from spark_druid_olap_tpu_torch.ops import cuda_groupby as CG
    from spark_druid_olap_tpu_torch.tools.tpch import generate

    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    dev = torch.device("cuda")

    # 2. build every kernel of the path from this checkout's sources
    t0 = time.perf_counter()
    CG.library()
    emit("build", kernel="dense_groupby", source=str(CG.SOURCE.name),
         seconds=time.perf_counter() - t0, cached=CG.build_info["cached"],
         ptxas=[ln for ln in str(CG.build_info["log"]).splitlines()
                if "registers" in ln or "smem" in ln])

    # 3. kernel vs plain version on the card
    t0 = time.perf_counter()
    n_cases, worst = kernel_cases(CG, dev)
    emit("kernel_check", kernel="dense_groupby", cases=n_cases,
         max_abs_err=worst, seconds=time.perf_counter() - t0,
         tolerance="ints/counts/min/max exact; float sums rtol 1e-9")

    # 4. the main path at SF1
    t0 = time.perf_counter()
    df = generate(SF, seed=SEED)["lineitem"]
    t_gen = time.perf_counter() - t0
    ctx = sdt.Context()
    t0 = time.perf_counter()
    ctx.ingest_dataframe("lineitem", df, time_column="l_shipdate")
    t_ingest = time.perf_counter() - t0
    emit("ingest", sf=SF, rows=len(df), generate_s=t_gen, ingest_s=t_ingest,
         segments=ctx.store.get("lineitem").num_segments)

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
        got = real_kernel(key, n_keys, inputs, max_keys)
        want = CG.dense_groupby_reference(key, n_keys, inputs)
        torch.cuda.synchronize()
        worst = max(worst, compare(name, got, want, inputs))
        k_ms = device_ms(lambda: real_kernel(key, n_keys, inputs, max_keys))
        p_ms = device_ms(lambda: CG.dense_groupby_reference(key, n_keys,
                                                            inputs))
        l_ms = device_ms(lambda: library_call(key, n_keys, inputs))
        nbytes, ops = kernel_work(key, n_keys, inputs)
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = ops / FP32_OPS_PER_S * 1e3
        b_ms = max(b_bytes, b_ops)
        bound_by.add("bytes" if b_bytes >= b_ops else "operations")
        warm_ms = statistics.median(warm)
        per_query[name] = dict(
            cold_median_ms=statistics.median(cold), warm_median_ms=warm_ms,
            warm_min_ms=min(warm), warm_max_ms=max(warm),
            rows_scanned=rows, rows_per_s=rows / warm_ms * 1e3,
            kernel_rows=int(key.numel()), n_keys=n_keys,
            n_aggs=len(inputs), kernel_ms=k_ms, plain_ms=p_ms,
            library_ms=l_ms, bound_ms=b_ms, kernel_bytes=nbytes,
            kernel_gb_per_s=nbytes / k_ms / 1e6,
            share_of_3_35_tb_per_s=nbytes / (k_ms * 1e-3) / HBM_BYTES_PER_S)
        total["ms"] += k_ms
        total["plain_ms"] += p_ms
        total["bound_ms"] += b_ms
        total["library_ms"] += l_ms
    emit("timing", card=smi, repeats=REPEATS, queries=per_query,
         note="device times: CUDA events, median, L2 flushed before each "
              "call; query times: host wall clock to synchronize, cold = "
              "device column cache dropped before each run")

    # 6. where a warm query's time goes: torch.profiler over one run each
    emit("profile", card=smi, queries={name: profile_query(ctx, spec)
                                       for name, spec in (("q1", q1),
                                                          ("q6", q6))})

    # 7. every ported kernel with its check result
    print(json.dumps({"kernels": [{
        "name": "dense_groupby", "route": "cuda",
        "source": "spark_druid_olap_tpu_torch/csrc/dense_groupby.cu",
        "replaces": "spark_druid_olap_tpu/ops/pallas_groupby.py:205",
        "launches": l1 + l6 + lw, "max_abs_err": worst,
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
        "library_ms": total["library_ms"]}]}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start, card=smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
