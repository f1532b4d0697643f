"""The wave kernel's lane-program compiler and plain version
(``ops/cuda_wave.py``), on the CPU.

For every filter, key and aggregate shape the port lowers, a group of
lanes is traced and compiled into the kernel's register program; the
program, interpreted by ``run_program`` over the bound columns, must give
bit for bit the tensors the engine's own lowering (``_lane_parts`` over a
``ScanContext``) gives, and ``wave_reference`` must give exactly what the
lane-by-lane fused group-by gives. Shapes the kernel does not run must be
declined at build time with a named reason (``WaveFallback``). The
kernel's host-side layout (program blob, shared memory, output split) is
checked against the same program. The kernel itself runs only on the card
(``chip_smoke.py`` holds it against ``wave_reference`` there).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.ops import cuda_groupby as CG
from spark_druid_olap_tpu_torch.ops import cuda_wave as CW
from spark_druid_olap_tpu_torch.ops import groupby as G
from spark_druid_olap_tpu_torch.ops.scan import ScanContext
from spark_druid_olap_tpu_torch.planner import fusion as FU
from spark_druid_olap_tpu_torch.segment.store import datasource_from_arrays
from spark_druid_olap_tpu_torch.tools.tpch import generate

C, L = E.Column, E.Literal
N = 20_000


def _ms(day: str) -> int:
    return int(pd.Timestamp(day).value // 10**6)


@pytest.fixture(scope="module")
def ctx():
    """A seeded frame with narrow, int32 and int64 longs, f32 doubles, a
    date, string dims (one nullable) and sub-day timestamps across 1969-75
    (negative day numbers exercise floor division and remainder)."""
    r = np.random.default_rng(11)
    ts = (np.datetime64("1969-03-01")
          + r.integers(0, 2400, N).astype("timedelta64[D]")
          + r.integers(0, 86_400_000, N).astype("timedelta64[ms]"))
    df = pd.DataFrame({
        "ts": ts.astype("datetime64[ns]"),
        "region": r.choice(["east", "west", "north", "south"], N),
        "product": r.choice([f"p{i:02d}" for i in range(12)], N),
        "tag": r.choice(["a", "b", None], N),
        "qty": r.integers(1, 51, N).astype(np.int64),
        "b": r.integers(-50_000, 50_000, N).astype(np.int64),
        "a": r.integers(-2**40, 2**40, N),
        "price": np.round(r.uniform(-100.0, 1000.0, N), 2),
        "disc": np.round(r.uniform(0.0, 0.1, N), 2),
        "due": (ts + r.integers(5, 60, N).astype("timedelta64[D]"))
        .astype("datetime64[D]").astype("datetime64[ns]"),
    })
    c = tsdot.Context(device="cpu")
    c.ingest_dataframe("t", df, time_column="ts", target_rows=4096)
    return c


@pytest.fixture(scope="module")
def f64_ctx():
    """float64 and int64 metrics with NaNs, carried in unconverted."""
    r = np.random.default_rng(12)
    n = 5000
    f64 = r.normal(0.0, 100.0, n)
    f64[r.random(n) < 0.01] = np.nan
    c = tsdot.Context(device="cpu")
    c.store.register(datasource_from_arrays("w", {
        "time": {"name": "ts", "millis": np.sort(r.integers(
            _ms("1999-01-01"), _ms("2001-01-01"), n))},
        "segments": [(0, 2500), (2500, n)],
        "columns": {
            "k": {"kind": "dimension", "validity": None,
                  "values": r.integers(0, 5, n).astype(np.int32),
                  "dictionary": list("vwxyz")},
            "f64": {"kind": "double", "values": f64, "validity": None},
            "i64": {"kind": "long", "validity": None,
                    "values": r.integers(0, 2**58, n, dtype=np.int64)}}}))
    return c


def plan(ctx, specs, fusion=True):
    """Plan ``specs`` as one fused group; (lanes, day basis, union names,
    fusion plan, bound arrays)."""
    eng = ctx.engine
    ds = ctx.store.get(specs[0].datasource)
    plans, seg_u, lo, hi = eng.sharedscan._plan_members(ds, specs)
    assert all(p is not None for p in plans)
    by_sig = {}
    for lp in plans:
        by_sig.setdefault(lp.sig, lp)
    lanes = [by_sig[k] for k in sorted(by_sig)]
    cols, names = eng.sharedscan._union(ds, lanes)
    fplan = FU.plan_lanes(
        [(lp.q.filter, lp.q.intervals, tuple(a.filter for a in lp.aggs))
         for lp in lanes], [len(lp.needed) for lp in lanes],
        len(cols)) if fusion else None
    return ds, lanes, lo, hi, names, fplan, eng._bind_arrays(ds, names,
                                                             seg_u)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype:
        return False
    a, b = a.reshape(-1).numpy(), b.reshape(-1).numpy()
    a, b = np.broadcast_arrays(a, b)
    return bool(np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))


def check_group(ctx, specs, fusion=True):
    """Program == direct lowering, bit for bit; wave_reference == the
    lane-by-lane fused group-by, exactly."""
    ds, lanes, lo, hi, names, fplan, arrays = plan(ctx, specs, fusion)
    program, layout = CW.compile_wave(ds, lanes, lo, hi, fplan,
                                      union_names=names, tz="UTC")
    cols = [arrays[k] for k in program.columns]
    outs = CW.run_program(program, cols)
    sctx = ScanContext(ds, arrays, lo, hi)
    cse = None
    if fplan is not None:
        cse = FU.CSECache(sctx)
        cse.prelower(fplan)
    got = CW.wave_reference(program, cols, layout)
    for li, (lp, ls) in enumerate(zip(lanes, layout.lanes)):
        base, key, dense, _ = CW._lane_parts(lp, sctx, cse)
        assert same(outs[ls.base], base), f"lane {li} base"
        assert same(outs[ls.key], key), f"lane {li} key"
        for (name, kind, flt, v, m), (_, _, vals, mask) in zip(ls.aggs,
                                                               dense):
            if v is not None:
                assert same(outs[v], vals), f"lane {li} {name} values"
            if m is not None:
                assert same(outs[m], mask), f"lane {li} {name} mask"
        inputs = [G.AggInput(name, kind, vals, mask)
                  for kind, name, vals, mask in dense]
        want = G.dense_groupby(key, base, lp.n_keys, inputs, lp.routes, 0)
        assert set(got[li]) == set(want) | {t[0] for t in ls.thetas}
        for name in want:
            assert same(got[li][name], want[name]), f"lane {li} {name}"
    return program, layout, cols, got


AGGS = (S.AggregationSpec("count", "n"),
        S.AggregationSpec("longsum", "q", field="qty"),
        S.AggregationSpec("doublesum", "p", field="price"),
        S.AggregationSpec("doublemin", "pmin", field="price"),
        S.AggregationSpec("longmax", "amax", field="a"))


def gb(*dims, aggs=AGGS, **kw):
    return S.GroupByQuerySpec(
        "t", tuple(S.DimensionSpec(d, d) for d in dims), aggs, **kw)


def expr_aggs(*exprs):
    return tuple(S.AggregationSpec("doublesum" if i % 2 else "doublemax",
                                   f"e{i}", expr=x)
                 for i, x in enumerate(exprs))


def time_dim(field, out):
    return S.DimensionSpec("ts", out, extraction=S.TimeExtraction(field))


SHAPES = {
    "selector_dim": [gb("product", filter=S.SelectorFilter("region",
                                                             "east"))],
    "selector_long_and_absent": [
        gb("region", filter=S.SelectorFilter("qty", "7")),
        gb("region", filter=S.SelectorFilter("product", "nope"))],
    "selector_time": [gb("region", filter=S.SelectorFilter(
        "ts", "1970-03-04T05:06:07"))],
    "bound_numeric": [
        gb("region", filter=S.BoundFilter("price", lower=10.5, upper=500,
                                          upper_strict=True, numeric=True)),
        gb("region", filter=S.BoundFilter("b", lower=-7, numeric=True))],
    "bound_string_codes": [gb("region", filter=S.BoundFilter(
        "product", lower="p03", upper="p09", lower_strict=True))],
    "bound_date_and_time": [
        gb("region", filter=S.BoundFilter("due", lower="1971-02-03")),
        gb("region", filter=S.BoundFilter("ts", lower="1970-01-01T12:00:00",
                                          upper="1973-06-30"))],
    "intervals": [gb("region", intervals=(
        (_ms("1969-06-01"), _ms("1970-02-01")),
        (_ms("1972-01-01T06:00:00"), _ms("1974-01-01"))))],
    "logical_and_or_not": [gb("region", filter=S.LogicalFilter("or", (
        S.LogicalFilter("and", (S.SelectorFilter("product", "p01"),
                                S.BoundFilter("qty", upper=20,
                                              numeric=True))),
        S.LogicalFilter("not", (S.SelectorFilter("region", "west"),)))))],
    "null_filters": [
        gb("region", filter=S.NullFilter("tag")),
        gb("tag", filter=S.SelectorFilter("tag", None)),
        gb("region", filter=S.NullFilter("tag", negated=True))],
    "expression_filter": [gb("region", filter=S.ExprFilter(E.And((
        E.Comparison(">", E.BinaryOp("*", C("price"), C("disc")), L(3.5)),
        E.Not(E.Comparison("=", E.BinaryOp("%", C("b"), L(7)), L(2)))))))],
    "arithmetic_case_casts": [gb("region", aggs=expr_aggs(
        E.BinaryOp("*", C("price"), E.BinaryOp("-", L(1), C("disc"))),
        E.BinaryOp("%", C("b"), L(7)),
        E.BinaryOp("%", C("b"), L(-3)),
        E.BinaryOp("/", C("b"), L(3)),
        E.BinaryOp("%", C("price"), L(3.5)),
        E.BinaryOp("-", C("a"), E.BinaryOp("*", C("qty"), L(3))),
        E.Cast(C("price"), "long"),
        E.Cast(C("qty"), "double"),
        E.Case(((E.Comparison(">", C("price"), L(0)), C("b")),
                (E.Comparison("<", C("disc"), L(0.05)), L(2))), L(-1)),
        E.Between(C("qty"), L(10), L(20)),
        E.InList(C("qty"), (3, 5, 8))))],
    "granularity_keys": [
        S.TimeseriesQuerySpec("t", AGGS, granularity=S.Granularity(g))
        for g in ("day", "week", "month", "quarter", "year")] + [
        S.TimeseriesQuerySpec("t", AGGS, granularity=S.Granularity("hour"),
                              intervals=((_ms("1970-01-01"),
                                          _ms("1970-01-03")),))],
    "time_extraction_keys": [
        S.GroupByQuerySpec("t", (time_dim(f, f),), AGGS)
        for f in ("year", "month", "quarter", "day", "dow", "doy", "hour",
                  "minute", "second", "trunc_month", "trunc_week")],
    "two_dims_and_dates": [
        S.GroupByQuerySpec("t", (S.DimensionSpec("region", "region"),
                                 time_dim("quarter", "q")), AGGS),
        S.GroupByQuerySpec("t", (S.DimensionSpec(
            "due", "dm", extraction=S.TimeExtraction("month")),), AGGS)],
    "filtered_aggregates": [gb("product", aggs=(
        S.AggregationSpec("count", "n_east",
                          filter=S.SelectorFilter("region", "east")),
        S.AggregationSpec("doublesum", "p_big", field="price",
                          filter=S.BoundFilter("qty", lower=40,
                                               numeric=True)),
        S.AggregationSpec("longmin", "b_min", field="b",
                          filter=S.ExprFilter(E.Comparison(
                              ">=", E.BinaryOp("%", C("a"), L(5)), L(2)))),
        S.AggregationSpec("longsum", "tagged", field="qty",
                          filter=S.NullFilter("tag", negated=True))))],
}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_program_matches_direct_lowering(shape, ctx):
    check_group(ctx, SHAPES[shape])


def test_whole_group_with_fusion_plan(ctx):
    """Every shape's lanes in one group, shared predicates lowered once:
    the program still equals the lowering lane for lane."""
    specs = [q for qs in SHAPES.values() for q in qs
             if not isinstance(q, S.TimeseriesQuerySpec)
             or q.granularity.kind != "hour"][:16]
    program, layout, _, _ = check_group(ctx, specs)
    assert len(layout.lanes) == 16
    unfused, _, _, _ = check_group(ctx, specs, fusion=False)
    assert len(program.instrs) <= len(unfused.instrs)


def test_float64_columns_nan_and_wide_sums(f64_ctx):
    aggs = (S.AggregationSpec("doublemin", "mn", field="f64"),
            S.AggregationSpec("doublemax", "mx", field="f64"),
            S.AggregationSpec("doublesum", "s", field="f64"),
            S.AggregationSpec("longsum", "si", field="i64"),
            S.AggregationSpec("count", "n"))
    specs = [S.GroupByQuerySpec("w", (S.DimensionSpec("k", "k"),), aggs),
             S.TimeseriesQuerySpec(
                 "w", aggs, granularity=S.Granularity("month"),
                 filter=S.BoundFilter("f64", lower=-50, numeric=True))]
    program, layout, _, got = check_group(f64_ctx, specs)
    assert torch.float64 in program.column_dtypes
    by_k = got[[ls.n_keys for ls in layout.lanes].index(5)]
    assert bool(torch.isnan(by_k["mn"]).all())       # NaN in every group
    assert int(by_k["si"].max()) > 2**53


def test_chip_smoke_storm_program(ctx):
    """The 8-query dashboard of chip_smoke.py, at a small scale factor."""
    df = generate(0.01)["lineitem"]
    c = tsdot.Context(dict(chip_smoke.STORM_CONFIG), device="cpu")
    c.ingest_dataframe("lineitem", df, time_column="l_shipdate",
                       target_rows=1 << 14)
    program, layout, _, _ = check_group(
        c, list(chip_smoke.storm_specs(S, E).values()))
    assert len(layout.lanes) == 8


# -- the in-kernel theta stripe -----------------------------------------------

def theta_aggs(*specs):
    return tuple(S.AggregationSpec("thetasketch", n, field=f, **kw)
                 for n, f, kw in specs)


# theta on 4 keys (region) and on 3 (tag and its null slot) runs in the
# kernel's stripe: dictionary codes, a DOUBLE's float32 bits, int64 longs,
# a date, an aggregate filter, a nullable group key; theta on 12 keys
# (product, 768 slots) and HLL / KLL run in the epilogue
THETA_GROUP = [
    gb("region", aggs=AGGS + theta_aggs(
        ("t_prod", "product", {}), ("t_price", "price", {}),
        ("t_a", "a", {"filter": S.BoundFilter("qty", lower=25,
                                              numeric=True)}))
       + (S.AggregationSpec("cardinality", "u_b", field="b"),)),
    gb("tag", aggs=theta_aggs(("t_due", "due", {}), ("t_b", "b", {}))
       + (S.AggregationSpec("count", "n"),),
       filter=S.BoundFilter("qty", upper=30, numeric=True)),
    gb("product", aggs=theta_aggs(("t_wide", "qty", {})) + (
        S.AggregationSpec("quantile", "p", field="price", fraction=0.5),
        S.AggregationSpec("longsum", "q", field="qty"))),
    # three of the four keys hold no row
    gb("region", aggs=theta_aggs(("t_east", "qty", {})),
       filter=S.SelectorFilter("region", "east"))]
INKERNEL = {"t_prod", "t_price", "t_a", "t_due", "t_b", "t_east"}


def test_theta_stripe_program_and_plain_version(ctx):
    """The stripe's lane program gives the engine's own theta values (a
    DOUBLE raw, the kernel hashes its bits) and masks bit for bit, and the
    plain version's stripe equals the JAX package's theta_registers over
    the same rows with its empty +inf read as the TPU stripe's 2.0."""
    import jax.numpy as jnp
    from spark_druid_olap_tpu.ops import theta as JTH
    program, layout, cols, got = check_group(ctx, THETA_GROUP)
    ds, lanes, lo, hi, names, fplan, arrays = plan(ctx, THETA_GROUP)
    assert {t[0] for ls in layout.lanes for t in ls.thetas} == INKERNEL
    outs = CW.run_program(program, cols)
    sctx = ScanContext(ds, arrays, lo, hi)
    for lp, ls, g in zip(lanes, layout.lanes, got):
        base, key, _, theta = CW._lane_parts(
            lp, sctx, None, dense=False, sketches=CW.theta_inkernel(lp))
        assert [t[0] for t in theta] == [t[0] for t in ls.thetas]
        kb = torch.where(base, key, lp.n_keys)
        for (name, vals, mask), (_, v, m) in zip(theta, ls.thetas):
            assert same(outs[v], vals), name
            assert (m is None) == (mask is None), name
            if m is not None:
                assert same(outs[m], mask), name
            ok = base if mask is None else base & mask
            bits = vals.view(torch.int32) if vals.dtype == torch.float32 \
                else vals
            want = np.asarray(JTH.theta_registers(
                jnp.asarray(kb.numpy()), jnp.asarray(ok.numpy()),
                jnp.asarray(bits.numpy()), lp.n_keys)).astype(np.float32)
            want = np.where(np.isinf(want), np.float32(2.0), want)
            assert g[name].dtype == torch.float32
            assert np.array_equal(g[name].numpy().view(np.int32),
                                  want.view(np.int32)), name
        for name, _, _ in theta:
            assert (g[name] <= 2.0).all(), name
            # a group no row reaches keeps 2.0 in every hash lane
            assert (g[name] == 2.0).all(1).sum() == \
                int((g["__rows__"] == 0).sum()), name


def test_theta_stripe_split_and_blob(ctx):
    """Stripe slots as the kernel writes them (float64 min words, +inf
    where no row counts, after the lane's dense slots) split back into the
    plain version's registers; the blob carries the theta descriptors and
    min / float64 slot kinds; shared memory counts the stripes."""
    program, layout, cols, want = check_group(ctx, THETA_GROUP)
    words = torch.empty(layout.n_slots, dtype=torch.int64)
    for ls, w in zip(layout.lanes, want):
        for m, (name, kind, flt, v, mk) in enumerate(ls.aggs):
            t = w[name].view(torch.int64) if flt else w[name]
            words[ls.slot_off + m: ls.theta_off: ls.n_aggs] = t
        for i, (name, v, mk) in enumerate(ls.thetas):
            r = w[name].to(torch.float64)
            r = torch.where(r == 2.0, float("inf"), r)
            lo = ls.theta_off + i * ls.n_keys * 64
            words[lo: lo + ls.n_keys * 64] = r.reshape(-1).view(torch.int64)
    for g, w in zip(CW._split(layout, words), want):
        assert set(g) == set(w)
        for name in w:
            assert same(g[name], w[name]), name
    blob = CW.blob_bytes(program, layout)
    n_desc = sum(ls.n_aggs + len(ls.thetas) for ls in layout.lanes)
    assert len(blob) == CW._blob_len(len(program.instrs), len(layout.lanes),
                                     n_desc, layout.n_slots)
    off = -(-len(program.instrs) * CW.INSTR.itemsize // 8) * 8
    lanes = np.frombuffer(blob, CW.LANE, len(layout.lanes), off)
    off += -(-lanes.nbytes // 8) * 8
    aggs = np.frombuffer(blob, CW.AGG, n_desc, off)
    off += -(-aggs.nbytes // 8) * 8
    kinds = np.frombuffer(blob, np.uint8, layout.n_slots, off)
    for lane, ls in zip(lanes, layout.lanes):
        assert lane["n_theta"] == len(ls.thetas)
        for i, (name, v, mk) in enumerate(ls.thetas):
            a = aggs[lane["agg_start"] + ls.n_aggs + i]
            assert (a["kind"], a["flt"]) == (CG._KIND_CODE["min"], 1)
            assert a["val_reg"] == program.outputs[v]
            assert a["val_dt"] == CW.DT[program.output_dtypes[v]]
            assert a["mask_reg"] == (CW.NONE if mk is None
                                     else program.outputs[mk])
        stripe = kinds[ls.theta_off: ls.slot_off + ls.n_slots]
        assert len(stripe) == len(ls.thetas) * ls.n_keys * 64
        assert (stripe == (CG._KIND_CODE["min"] | 1 << 2)).all()
    assert layout.n_slots == sum(ls.n_slots for ls in layout.lanes)
    for file in CW.FILE_LAYOUTS:
        assert CW.smem_bytes(program, layout, file) >= \
            8 * CW.WARPS * layout.n_slots + len(blob)


def test_wave_fn_runs_the_epilogue_as_the_lane_by_lane_program(ctx):
    """One wave: dense aggregates and the stripe from the kernel's plain
    version, HLL / KLL / wide theta from the epilogue; every output equals
    the lane-by-lane program's (a stripe's 2.0 is that program's +inf)."""
    ds, lanes, lo, hi, names, fplan, arrays = plan(ctx, THETA_GROUP)
    wave_fn, info = build(ctx, THETA_GROUP)
    assert info["theta_inkernel"] == 6 and info["sketch_epilogue"] == 3
    got = wave_fn(arrays)
    fused = ctx.engine.sharedscan._build_fused_program(ds, lanes, lo, hi,
                                                       fplan)(arrays)
    for g, w in zip(got, fused):
        assert set(g) == set(w)
        for name in w:
            want = w[name]
            if name in INKERNEL:
                want = want.clamp(max=2.0)
            assert same(g[name], want), name


# -- the kernel's interpreter, built with the host compiler ---------------------

HOST_HARNESS = r"""
#include <vector>
#include "wave_program.cuh"
using namespace sdot_wave_program;

template <int R, typename Word>
static void run(const Instr* prog, int n_instr, const void* const* cols,
                long long n, int n_regs, const int* outs, int n_outs,
                long long* out) {
  std::vector<Word> words((size_t)n_regs * R);
  const RegFile<R, Word> f{words.data(), 1, 0};
  for (long long base = 0; base < n; base += R) {
    long long rows[R];
    for (int r = 0; r < R; ++r) rows[r] = base + r < n ? base + r : n - 1;
    run_rows<R>(prog, n_instr, cols, rows, f);
    for (int o = 0; o < n_outs; ++o)
      for (int r = 0; r < R && base + r < n; ++r)
        out[o * n + base + r] = f.get(outs[o], r).i;
  }
}

extern "C" int sdot_test_run(const Instr* prog, int n_instr,
                             const void* const* cols, long long n, int n_regs,
                             int rows, int word, const int* outs, int n_outs,
                             long long* out) {
  if (word == 8 && rows == 0) {            // run_program, row by row
    std::vector<Reg> regs((size_t)n_regs);
    for (long long row = 0; row < n; ++row) {
      run_program(prog, n_instr, cols, row, regs.data());
      for (int o = 0; o < n_outs; ++o) out[o * n + row] = regs[outs[o]].i;
    }
  } else if (word == 8) {
    if (rows == 1) run<1, long long>(prog, n_instr, cols, n, n_regs, outs,
                                     n_outs, out);
    else run<2, long long>(prog, n_instr, cols, n, n_regs, outs, n_outs, out);
  } else {
    if (rows == 1) run<1, int32_t>(prog, n_instr, cols, n, n_regs, outs,
                                   n_outs, out);
    else run<2, int32_t>(prog, n_instr, cols, n, n_regs, outs, n_outs, out);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_interpreter(tmp_path_factory):
    """``csrc/wave_program.cuh`` built with the host C++ compiler: the
    kernel's interpreter (generic and specialised paths, one or two rows at
    once as the kernel's local and shared register files run it, 8- and
    4-byte words), with no CUDA; ``rows = 0`` runs ``run_program`` row by
    row."""
    import ctypes
    import shutil
    import subprocess
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the interpreter with")
    d = tmp_path_factory.mktemp("wave_program")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libharness.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(CW.CB.CSRC), "-o", str(so),
                    str(d / "harness.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.sdot_test_run.restype = ctypes.c_int
    return lib


def run_host(lib, program, layout, cols, rows, word, fast):
    """The host-built interpreter over ``cols``: each output register of
    ``program`` as [n] int64 Reg words."""
    import ctypes
    ins = np.frombuffer(CW.blob_bytes(program, layout), CW.INSTR,
                        len(program.instrs)).copy()
    if not fast:
        ins["fast"] = 0
    arrays = [np.ascontiguousarray(c.reshape(-1).numpy()) for c in cols]
    n = arrays[0].size
    ptrs = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])
    outs = np.asarray(program.outputs, np.int32)
    out = np.zeros((len(outs), n), np.int64)
    lib.sdot_test_run(ins.ctypes.data_as(ctypes.c_void_p),
                      ctypes.c_int(len(ins)), ptrs, ctypes.c_longlong(n),
                      ctypes.c_int(program.n_regs), ctypes.c_int(rows),
                      ctypes.c_int(word), outs.ctypes.data_as(ctypes.c_void_p),
                      ctypes.c_int(len(outs)),
                      out.ctypes.data_as(ctypes.c_void_p))
    return out


SKETCH_HARNESS = r"""
#include <stdint.h>
#include "sketch_hash.cuh"

extern "C" void sdot_test_theta_hash(const uint32_t* v, long long n, int j,
                                     float* out) {
  for (long long i = 0; i < n; ++i)
    out[i] = sdot_sketch::theta_hash01(sdot_sketch::theta_base(v[i]), j);
}
"""


def test_host_built_theta_hash_matches_both_packages(tmp_path):
    """``csrc/sketch_hash.cuh`` (the stripe's hash), host-built, against
    ``ops/theta._hash01`` and the JAX package's, bit for bit, over the low
    32 bits of int32, int64 and float32-bit values for hash lanes 0-63."""
    import ctypes
    import shutil
    import subprocess
    import jax.numpy as jnp
    from spark_druid_olap_tpu.ops import theta as JTH
    from spark_druid_olap_tpu_torch.ops import theta as TTH
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the hash with")
    (tmp_path / "h.cpp").write_text(SKETCH_HARNESS)
    so = tmp_path / "libh.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(CW.CB.CSRC), "-o", str(so),
                    str(tmp_path / "h.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    r = np.random.default_rng(21)
    vals = np.concatenate([
        r.integers(-2**31, 2**31, 2000).astype(np.int64),
        r.integers(-2**62, 2**62, 2000),
        r.normal(0, 1e4, 2000).astype(np.float32).view(np.int32)
        .astype(np.int64), np.array([0, -1, 2**31 - 1, -2**31, 2**32])])
    low = np.ascontiguousarray((vals & 0xFFFFFFFF).astype(np.uint32))
    out = np.empty(len(vals), np.float32)
    for j in range(64):
        lib.sdot_test_theta_hash(low.ctypes.data_as(ctypes.c_void_p),
                                 ctypes.c_longlong(len(vals)), ctypes.c_int(j),
                                 out.ctypes.data_as(ctypes.c_void_p))
        port = TTH._hash01(torch.from_numpy(vals), j).numpy()
        jax_ = np.asarray(JTH._hash01(jnp.asarray(vals), j))
        assert np.array_equal(out.view(np.int32), port.view(np.int32)), j
        assert np.array_equal(out.view(np.int32), jax_.view(np.int32)), j


def reg_values(words: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """Reg words as the values of ``dtype`` (a float32 sits in the low
    word)."""
    if dtype == torch.float32:
        return (words & 0xffffffff).astype(np.uint32).view(np.float32)
    if dtype == torch.float64:
        return words.view(np.float64)
    return words


@pytest.mark.parametrize("shape", ["arithmetic_case_casts",
                                   "time_extraction_keys", "null_filters",
                                   "expression_filter", "bound_date_and_time"])
@pytest.mark.parametrize("rows,word,fast", [(0, 8, False), (0, 8, True),
                                            (1, 8, True), (2, 8, True),
                                            (2, 4, True)])
def test_host_built_interpreter_matches_plain_version(
        shape, rows, word, fast, ctx, host_interpreter):
    """The kernel's C++ interpreter, host-built, gives every output
    register the plain version's values bit for bit: ``run_program`` row by
    row, generic and specialised handlers, 1 / 2 rows per step, and the
    4-byte file on every program that :func:`cuda_wave.register_width`
    gives it."""
    ds, lanes, lo, hi, names, fplan, arrays = plan(ctx, SHAPES[shape])
    program, layout = CW.compile_wave(ds, lanes, lo, hi, fplan,
                                      union_names=names, tz="UTC")
    word = max(word, CW.register_width(program))   # as the kernel keeps it
    cols = [arrays[k] for k in program.columns]
    got = run_host(host_interpreter, program, layout, cols, rows, word, fast)
    want = CW.run_program(program, cols)
    n = cols[0].numel()
    for j, (w, dt) in enumerate(zip(want, program.output_dtypes)):
        w = np.broadcast_to(w.reshape(-1).numpy(), (n,))
        g = reg_values(got[j], dt)
        assert np.array_equal(g, w.astype(g.dtype), equal_nan=dt in (
            torch.float32, torch.float64)), f"output {j} ({dt})"


def test_host_built_interpreter_runs_the_storm(host_interpreter):
    """chip_smoke.py's storm program, at a small scale factor: every
    instruction but the float constants takes a specialised handler, the
    4-byte file holds it, and the host-built interpreter equals the plain
    version."""
    df = generate(0.01)["lineitem"]
    c = tsdot.Context(dict(chip_smoke.STORM_CONFIG), device="cpu")
    c.ingest_dataframe("lineitem", df, time_column="l_shipdate",
                       target_rows=1 << 14)
    ds, lanes, lo, hi, names, fplan, arrays = plan(
        c, list(chip_smoke.storm_specs(S, E).values()))
    program, layout = CW.compile_wave(ds, lanes, lo, hi, fplan,
                                      union_names=names, tz="UTC")
    generic = [i for i in program.instrs if CW.fast_code(*i[:3]) == 0]
    assert all(CW.OPS[i[0]] == "const" and CW.DTYPES[i[1]].is_floating_point
               for i in generic)
    assert CW.register_width(program) == 4
    cols = [arrays[k] for k in program.columns]
    want = CW.run_program(program, cols)
    n = cols[0].numel()
    for rows in (1, 2):
        got = run_host(host_interpreter, program, layout, cols, rows, 4, True)
        for j, (w, dt) in enumerate(zip(want, program.output_dtypes)):
            w = np.broadcast_to(w.reshape(-1).numpy(), (n,))
            g = reg_values(got[j], dt)
            assert np.array_equal(g, w.astype(g.dtype), equal_nan=True), j


# -- declines -----------------------------------------------------------------

def build(ctx, specs, tz="UTC", max_lanes=16, scratch=CW.SMEM_LIMIT):
    ds, lanes, lo, hi, names, fplan, _ = plan(ctx, specs)
    return CW.build_wave_fn(ds, lanes, lo, hi, fplan, union_names=names,
                            tz=tz, n_rows=ds.num_rows, max_lanes=max_lanes,
                            scratch_bytes=scratch)


@pytest.fixture
def lut_gathers(monkeypatch):
    """Code masks lower to range compares only up to EC._CHAIN_MAX_RANGES
    runs, and to a gather from the per-code mask above; at 0 every mask
    takes the gather, which the tests' 12-value dictionaries never reach
    on their own."""
    from spark_druid_olap_tpu_torch.ops import expr_compile as EC
    monkeypatch.setattr(EC, "_CHAIN_MAX_RANGES", 0)


def test_dim_in_filter_lut_declines(ctx, lut_gathers):
    with pytest.raises(CW.WaveFallback, match=r"aten\.index\.Tensor"):
        build(ctx, [gb("region", filter=S.InFilter("product",
                                                    ("p01", "p02")))])


def test_string_comparison_lut_declines(ctx, lut_gathers):
    with pytest.raises(CW.WaveFallback, match=r"aten\.index\.Tensor"):
        build(ctx, [gb("region", filter=S.ExprFilter(
            E.Comparison(">", C("product"), L("p04"))))])


def test_pattern_filter_declines(ctx, lut_gathers):
    """A pattern filter lowers (the coalescer plans its lane); when its
    code mask takes the gather, the build declines it, naming the op."""
    spec = gb("region", filter=S.PatternFilter("product", "like", "p0%"))
    ds = ctx.store.get("t")
    assert ctx.engine.sharedscan._plan_members(ds, [spec])[0] != [None]
    with pytest.raises(CW.WaveFallback, match=r"aten\.index\.Tensor"):
        build(ctx, [spec])


def test_unported_filter_declines(ctx, monkeypatch):
    """The coalescer sends a lane the port cannot lower solo at plan time;
    the build declines it too, naming the error."""
    spec = gb("region", filter=S.SpatialFilter(
        "qty_price", ("qty", "price"), (1.0, 10.0), (20.0, 500.0)))
    ds = ctx.store.get("t")
    assert ctx.engine.sharedscan._plan_members(ds, [spec])[0] == [None]
    monkeypatch.setattr(type(ctx.engine.sharedscan), "_lowers",
                        lambda *a: True)
    with pytest.raises(CW.WaveFallback,
                       match="lane trace failed: NotImplementedError"):
        build(ctx, [spec])


@pytest.mark.parametrize("filt", [
    S.InFilter("product", ("p01", "p02", "p07")),
    S.ExprFilter(E.Comparison(">", C("product"), L("p04"))),
    S.PatternFilter("product", "like", "p0%"),
    S.ExprFilter(E.Like(C("product"), "%1"))], ids=["in", "cmp", "pattern",
                                                    "like"])
def test_string_predicates_ride_the_wave_as_code_compares(ctx, filt):
    """By default a code mask of few runs lowers to range compares (the
    JAX compiler's ``_take_mask``), which the lane program runs: the wave
    builds, and its program equals the direct lowering bit for bit."""
    specs = [gb("region", filter=filt), gb("product")]
    build(ctx, specs)
    check_group(ctx, specs)


def test_non_utc_timezone_declines(ctx):
    tz = "America/New_York"
    local = tsdot.Context({"sdot.timezone": tz}, device="cpu")
    local.store.register(ctx.store.get("t"))
    with pytest.raises(CW.WaveFallback, match=r"aten\.index\.Tensor"):
        build(local, [S.TimeseriesQuerySpec(
            "t", AGGS, granularity=S.Granularity("month"))], tz=tz)


def test_too_many_lanes_decline(ctx):
    specs = SHAPES["time_extraction_keys"][1:4]
    with pytest.raises(CW.WaveFallback,
                       match="3 lanes exceed sdot.pallas.wave.max.lanes=2"):
        build(ctx, specs, max_lanes=2)
    ds, lanes, *_ = plan(ctx, specs)
    assert CW.wave_decline(lanes, 2, 64) == \
        "3 lanes exceed sdot.pallas.wave.max.lanes=2"
    assert CW.wave_decline(lanes, 16, 64) is None
    assert CW.wave_eligible(lanes, 16, 64)
    assert "outside the fused group-by tier" in CW.wave_decline(lanes, 16, 4)
    assert not CW.wave_eligible(lanes, 16, 4)


@pytest.mark.parametrize("cap,value,reason", [
    ("MAX_INSTRS", 4, "instructions exceeds the kernel's 4"),
    ("MAX_REGS", 3, "registers, over the kernel's 3"),
    ("MAX_COLS", 2, "columns, over the kernel's 2")])
def test_kernel_caps_decline(cap, value, reason, ctx, monkeypatch):
    monkeypatch.setattr(CW, cap, value)
    with pytest.raises(CW.WaveFallback, match=reason):
        build(ctx, SHAPES["logical_and_or_not"])


def test_scratch_over_budget_declines(ctx):
    wave_fn, info = build(ctx, SHAPES["time_extraction_keys"][:2])
    assert info["smem_bytes"] > 4096
    with pytest.raises(CW.WaveFallback, match="sdot.cuda.wave.scratch"):
        build(ctx, SHAPES["time_extraction_keys"][:2], scratch=4096)


def test_scratch_budget_below_the_shared_file_takes_the_local_file(ctx):
    """A budget one byte short of the two-row shared register file builds
    the wave with the one-row local file, and records the choice."""
    specs = SHAPES["time_extraction_keys"][:2]
    _, info = build(ctx, specs)
    assert (info["rows_per_thread"], info["register_file_shared"]) \
        == (2, True)
    _, info = build(ctx, specs, scratch=info["smem_bytes"] - 1)
    assert (info["rows_per_thread"], info["register_file_shared"]) \
        == (1, False)
    ds, lanes, lo, hi, names, fplan, _ = plan(ctx, specs)
    program, layout = CW.compile_wave(ds, lanes, lo, hi, fplan,
                                      union_names=names, tz="UTC")
    assert info["smem_bytes"] == CW.smem_bytes(program, layout, (1, False))


# -- the kernel's host-side layout --------------------------------------------

def test_blob_layout_and_shared_memory(ctx):
    program, layout, _, _ = check_group(ctx, SHAPES["filtered_aggregates"]
                                        + SHAPES["null_filters"])
    blob = CW.blob_bytes(program, layout)
    n_aggs = sum(ls.n_aggs for ls in layout.lanes)
    assert len(blob) == CW._blob_len(len(program.instrs), len(layout.lanes),
                                     n_aggs, layout.n_slots)
    width = CW.register_width(program)
    assert width == (8 if any(CW.DTYPES[i[1]] in (torch.int64, torch.float64)
                              for i in program.instrs) else 4)
    for rows, shared in CW.FILE_LAYOUTS:
        assert CW.smem_bytes(program, layout, (rows, shared)) == len(blob) \
            + 8 * CW.WARPS * layout.n_slots \
            + shared * program.n_regs * rows * CW.THREADS * width
    ins = np.frombuffer(blob, CW.INSTR, len(program.instrs))
    assert [tuple(int(x) for x in r)[:7] + (int(r["imm"]),) for r in ins] \
        == [tuple(i[:7]) + (i[7],) for i in program.instrs]
    assert [int(r["fast"]) for r in ins] == [CW.fast_code(*i[:3])
                                             for i in program.instrs]
    off = -(-ins.nbytes // 8) * 8
    lanes = np.frombuffer(blob, CW.LANE, len(layout.lanes), off)
    off += -(-lanes.nbytes // 8) * 8
    aggs = np.frombuffer(blob, CW.AGG, n_aggs, off)
    off += -(-aggs.nbytes // 8) * 8
    kinds = np.frombuffer(blob, np.uint8, layout.n_slots, off)
    j = 0
    for lane, ls in zip(lanes, layout.lanes):
        assert lane["base_reg"] == program.outputs[ls.base]
        assert lane["key_reg"] == program.outputs[ls.key]
        assert (lane["n_keys"], lane["n_aggs"], lane["agg_start"],
                lane["slot_off"]) == (ls.n_keys, ls.n_aggs, j, ls.slot_off)
        for m, (name, kind, flt, v, mk) in enumerate(ls.aggs):
            a = aggs[j + m]
            assert a["kind"] == CG._KIND_CODE[kind] and a["flt"] == flt
            assert a["val_reg"] == (CW.NONE if v is None
                                    else program.outputs[v])
            assert a["mask_reg"] == (CW.NONE if mk is None
                                     else program.outputs[mk])
            slots = kinds[ls.slot_off + m: ls.slot_off + ls.n_keys
                          * ls.n_aggs: ls.n_aggs]
            assert (slots == (CG._KIND_CODE[kind] | int(flt) << 2)).all()
        j += ls.n_aggs
    # every register index fits the kernel's byte fields
    assert program.n_regs <= CW.MAX_REGS < CW.NONE


def test_split_reads_the_kernel_output_layout(ctx):
    """Slots packed as the kernel writes them ([slot_off + k * n_aggs + m],
    int64 or float64 bits) split back into the plain version's dicts."""
    program, layout, cols, want = check_group(
        ctx, SHAPES["granularity_keys"][:3] + SHAPES["selector_dim"])
    words = torch.empty(layout.n_slots, dtype=torch.int64)
    for ls, w in zip(layout.lanes, want):
        for m, (name, kind, flt, v, mk) in enumerate(ls.aggs):
            t = w[name].view(torch.int64) if flt else w[name]
            words[ls.slot_off + m: ls.slot_off + ls.n_keys * ls.n_aggs:
                  ls.n_aggs] = t
    got = CW._split(layout, words)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in w:
            assert same(g[name], w[name]), name


def test_cpu_tensors_take_the_plain_version(ctx):
    program, layout, cols, want = check_group(ctx, SHAPES["intervals"])
    before = CW.launches
    got = CW.wave_groupby(program, layout, cols)
    assert CW.launches == before
    for g, w in zip(got, want):
        for name in w:
            assert same(g[name], w[name])
