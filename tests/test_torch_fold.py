"""The host-side choices of the port's shared fold (``csrc/groupby_fold.cuh``),
on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against their
plain versions there, in every tier and register-file layout). What the
wrapper decides before a launch is plain Python and is checked here: the
dense group-by's fold tier and aggregates per launch
(``ops/cuda_groupby.plan_launches``), its shared-memory sizing, the row
ranges of the blocks (``launch_geometry``: the row count alone decides them,
so a float sum's fold order never depends on the card), and the wave
kernel's register-file layout (``ops/cuda_wave.register_file``) with its
decline when nothing fits.
"""

import test_torch_cache_pin  # noqa: F401 (the port's result cache off)

import numpy as np
import pytest
import torch

import chip_smoke
import spark_druid_olap_tpu_torch as tsdot
from spark_druid_olap_tpu_torch.ir import expr as E
from spark_druid_olap_tpu_torch.ir import spec as S
from spark_druid_olap_tpu_torch.ops import cuda_groupby as CG
from spark_druid_olap_tpu_torch.ops import cuda_wave as CW
from spark_druid_olap_tpu_torch.ops.groupby import AggInput as CG_Agg
from spark_druid_olap_tpu_torch.planner import fusion as FU
from spark_druid_olap_tpu_torch.tools.tpch import generate

# the thread tier's most slots: two of its blocks on one SM
THREAD_SLOTS = (CG.SM_SMEM_BYTES // 2 - CG.BLOCK_SMEM_RESERVED) \
    // (8 * CG.THREADS)
WARP_SLOTS = CG.SMEM_LIMIT // (8 * CG.WARPS)       # the warp tier's most


@pytest.mark.parametrize("case,n_keys,n_aggs,want", [
    # chip_smoke.py's queries: Q1 (6 aggregates + the row count), Q6, and
    # the wide query's 18 aggregates (two launches: 96 slots in the warp
    # tier, then 12 in the thread tier)
    ("q1", 6, 7, (7, "threads")),
    ("q6", 1, 2, (2, "threads")),
    ("wide", 6, 18, (16, "warps")),
    # the tier switch: one slot below, at and above the thread tier's most
    ("below_switch", THREAD_SLOTS - 1, 1, (1, "threads")),
    ("at_switch", THREAD_SLOTS, 1, (1, "threads")),
    ("above_switch", THREAD_SLOTS + 1, 1, (1, "warps")),
    # K = 64 and K = 128 with 16 aggregates: one launch, warp tier
    ("k64_16aggs", 64, 16, (16, "warps")),
    ("k128_16aggs", 128, 16, (16, "warps")),
    # more slots than one launch's tier holds: the launch splits
    ("k256_16aggs", 256, 16, (WARP_SLOTS // 256, "warps")),
    ("k2000_16aggs", 2000, 16, (1, "warps")),
])
def test_plan_launches(case, n_keys, n_aggs, want):
    per_launch, tier = CG.plan_launches(n_keys, n_aggs)
    assert (per_launch, tier) == want, case
    slots = n_keys * per_launch
    assert CG.smem_bytes(slots, tier) <= CG.SMEM_LIMIT
    assert CG.fold_tier(slots) == tier
    if tier == "threads":
        assert CG.blocks_per_sm(CG.smem_bytes(slots, tier)) >= 2
    if per_launch < min(n_aggs, CG.MAX_AGGS):        # one more would not fit
        assert CG.fold_tier(n_keys * (per_launch + 1)) is None


@pytest.mark.parametrize("n_slots,tier,nbytes", [
    (42, "threads", 42 * 8 * 256), (2, "threads", 2 * 8 * 256),
    (96, "threads", 96 * 8 * 256), (1024, "warps", 1024 * 8 * 8),
    (2048, "warps", 2048 * 8 * 8)])
def test_shared_memory_of_each_tier(n_slots, tier, nbytes):
    """[slot][thread] words in the thread tier, [warp][slot] in the warp
    tier (the kernel's sdot_dense_groupby_smem_bytes; the library checks
    the two agree when it loads)."""
    assert CG.smem_bytes(n_slots, tier) == nbytes


def test_the_last_launch_takes_its_own_tier():
    """Wide's second launch holds 2 aggregates x 6 keys: thread tier."""
    per_launch, _ = CG.plan_launches(6, 18)
    assert CG.fold_tier(6 * (18 - per_launch)) == "threads"


def test_no_tier_takes_one_aggregate_of_too_many_keys():
    assert CG.fold_tier(WARP_SLOTS + 1) is None
    with pytest.raises(ValueError, match="shared memory per aggregate"):
        CG.plan_launches(WARP_SLOTS + 1, 3)


def test_cpu_tensors_take_the_plain_version_whatever_the_tier():
    key = torch.zeros(64, dtype=torch.int32)
    inputs = [CG_Agg("n", "count")]
    before = CG.launches
    got = CG.dense_groupby_kernel(key, 4, inputs, 64, tier="warps")
    assert CG.launches == before
    assert got["n"].tolist() == [64, 0, 0, 0]


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 4095, 4096, 4097, 100_003,
                               2_000_490, 6_001_465, 6_002_688, 50_000_000])
def test_launch_geometry_depends_on_the_row_count_alone(n, monkeypatch):
    """Whole warps per block, at most MAX_BLOCKS blocks, every row in one
    block, no empty block — computed without asking the card anything."""
    def no_card(*a, **k):
        raise AssertionError("launch_geometry asked the card")
    for name in ("get_device_properties", "device_count", "is_available",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    rows_per_block, n_blocks = CG.launch_geometry(n)
    assert (rows_per_block, n_blocks) == CG.launch_geometry(n)
    assert rows_per_block % 32 == 0 and rows_per_block >= 32
    assert 1 <= n_blocks <= CG.MAX_BLOCKS
    assert rows_per_block * n_blocks >= n
    assert n == 0 or rows_per_block * (n_blocks - 1) < n


def test_launch_geometry_of_the_main_path():
    assert CG.MAX_BLOCKS == 1024
    assert CG.launch_geometry(6_001_465) == (5888, 1020)     # Q1, wide
    assert CG.launch_geometry(2_000_490) == (4096, 489)      # Q6
    assert CG.launch_geometry(6_002_688) == (5888, 1020)     # the storm


# -- the wave kernel's register file ------------------------------------------

@pytest.fixture(scope="module")
def storm():
    """chip_smoke.py's 8-query storm at a small scale factor: its program
    and layout."""
    df = generate(0.01)["lineitem"]
    c = tsdot.Context(dict(chip_smoke.STORM_CONFIG), device="cpu")
    c.ingest_dataframe("lineitem", df, time_column="l_shipdate",
                       target_rows=1 << 14)
    program, layout, _ = chip_smoke.compile_specs(
        c.engine, c.store.get("lineitem"),
        list(chip_smoke.storm_specs(S, E).values()), CW, FU)
    return program, layout


@pytest.mark.parametrize("smem,blocks", [
    (0, 8), (20_000, 8), (113_448, 2), (116_000, 1),
    (CG.SM_SMEM_BYTES - CG.BLOCK_SMEM_RESERVED, 1),
    (CG.SM_SMEM_BYTES, 0)])
def test_blocks_per_sm(smem, blocks):
    assert CG.blocks_per_sm(smem) == blocks


def test_storm_register_file(storm):
    """The storm's program is all 32-bit: 4-byte registers, immediates for
    its constants, and its two-row file in shared memory, two blocks to an
    SM."""
    program, layout = storm
    assert CW.register_width(program) == 4
    assert sum(i[5] == CW.IMM for i in program.instrs) > 20
    file = CW.register_file(program, layout)
    assert file == (2, True)
    assert CG.blocks_per_sm(CW.smem_bytes(program, layout, file)) == 2


@pytest.mark.parametrize("fits,short,want", [
    ((2, True), 0, (2, True)), ((2, True), 1, (1, False)),
    ((1, False), 0, (1, False)), ((1, False), 1, None)])
def test_register_file_within_a_budget(storm, fits, short, want):
    """At a budget that just holds a layout, or one byte short of it: the
    shared two-row file where it fits, else the local-memory file, else
    none."""
    program, layout = storm
    budget = CW.smem_bytes(program, layout, fits) - short
    file = CW.register_file(program, layout, budget)
    assert file == want
    if file is not None:
        assert CW.smem_bytes(program, layout, file) <= budget


def test_local_file_takes_only_the_partials_and_the_program(storm):
    """The local-memory file's shared memory is the warps' partials and the
    program blob: below that nothing fits
    (``test_register_file_within_a_budget``)."""
    program, layout = storm
    local = CW.smem_bytes(program, layout, (1, False))
    assert local == 8 * CW.WARPS * layout.n_slots + len(
        CW.blob_bytes(program, layout))


def test_fast_handlers_cover_the_kernels_table():
    """Every specialised handler name maps to a code the blob can carry,
    and an instruction without one keeps the generic path (code 0)."""
    assert CW.FAST[0] == "generic" and len(set(CW.FAST)) == len(CW.FAST)
    assert len(CW.FAST) < 256
    op, dt = CW.OP["rem"], CW.DT[torch.float64]
    assert CW.fast_code(op, dt, 0) == 0
    assert CW.FAST[CW.fast_code(CW.OP["add"], CW.DT[torch.int32], 0)] \
        == "add_i32"
    assert CW.FAST[CW.fast_code(CW.OP["lt"], CW.DT[torch.int64], 0)] \
        == "lt_int"
    assert CW.FAST[CW.fast_code(CW.OP["cast"], CW.DT[torch.int32],
                                CW.DT[torch.int8])] == "cast_i32"
    assert CW.fast_code(CW.OP["cast"], CW.DT[torch.int32],
                        CW.DT[torch.float32]) == 0
    assert np.dtype(CW.INSTR).itemsize == 16
