// Wave kernel for Hopper (sm_90a): one launch runs every lane of a fused
// shared-scan wave — each lane's filter, interval, group key and filtered
// dense aggregates — over the wave's union columns.
//
// Replaces the JAX package's Pallas TPU kernel
// spark_druid_olap_tpu/ops/pallas_wave.py:build_wave_fn (its inner
// `kernel`, launched by the pl.pallas_call there), for the dense lanes of a
// wave. The lanes' query semantics are not written here: the host traces
// the engine's own lowering (ops/cuda_wave.py) into a short register
// program, and every thread interprets that program over its rows. The
// program is the same for every thread, so the dispatch switch does not
// diverge inside a warp.
//
// Bound: device-memory bytes. Each union column is read once per row, and
// the fusion plan's shared predicates evaluate once per row for every lane
// (the trace memoizes them), so the bytes moved are those of the column
// union. The per-row work — the program's instructions plus one warp fold
// per lane and aggregate — is a few hundred operations, which this first
// version does not hide behind the loads.
//
// Exactness:
//   * registers keep the trace's dtypes: an int32 add wraps as in int32, a
//     float32 multiply is one float32 multiply (the _rn intrinsics are never
//     contracted into an FMA, and the file builds with -fmad=false), and
//     casts, floor division and remainder follow PyTorch's definitions
//     (wave_program.cuh), so the registers agree bit for bit with the
//     plain version (ops/cuda_wave.py:wave_reference);
//   * accumulation is the deterministic fold of groupby_fold.cuh, shared
//     with the fused dense group-by kernel: int64 / float64 slots, fixed
//     row ranges per block, lane-order folds in a warp, warp order in a
//     block, block order in a second pass. No atomics: two launches on one
//     input give bit-identical float sums.
//
// Layout. The program blob (device memory, built once per program by the
// wrapper) holds, each section padded to 8 bytes: Instr[n_instr],
// LaneDesc[n_lanes], AggDesc[n_aggs], uint8 slot kind[n_slots]. Lane l owns
// the slots [slot_off, slot_off + n_keys * n_aggs), the slot of (key k,
// aggregate m) at slot_off + k * n_aggs + m; its last aggregate is the
// lane's row count. The output is [n_slots] 64-bit words (int64 or float64
// bits). The wrapper allocates the output and the [n_blocks, n_slots]
// block scratch; nothing is allocated here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "groupby_fold.cuh"
#include "wave_program.cuh"

namespace {

using namespace sdot_wave_program;
using sdot_fold::Acc;
using sdot_fold::identity;
using sdot_fold::kCount;
using sdot_fold::kFull;
using sdot_fold::kThreads;
using sdot_fold::kWarps;

struct LaneDesc {         // 24 bytes
  int base_reg, key_reg, n_keys, n_aggs, agg_start, slot_off;
};

struct AggDesc {          // 8 bytes
  uint8_t kind, flt, val_reg, val_dt, mask_reg, pad0, pad1, pad2;
};

struct Params {
  long long n;
  long long rows_per_block;   // a multiple of 32
  int n_instr, n_lanes, n_aggs, n_slots, n_cols;
  const uint8_t* blob;
  const void* cols[kMaxCols];
};

__host__ __device__ constexpr long long pad8(long long b) {
  return (b + 7) / 8 * 8;
}

__host__ __device__ inline long long blob_bytes(int n_instr, int n_lanes,
                                                int n_aggs, int n_slots) {
  return pad8((long long)sizeof(Instr) * n_instr)
         + pad8((long long)sizeof(LaneDesc) * n_lanes)
         + pad8((long long)sizeof(AggDesc) * n_aggs) + pad8(n_slots);
}

struct SlotKinds {
  const uint8_t* kinds;   // kind | flt << 2
  __device__ void operator()(int slot, int& kind, bool& flt) const {
    kind = kinds[slot] & 3;
    flt = (kinds[slot] >> 2) & 1;
  }
};

// Pass 1: one fixed, contiguous row range per block -> one [n_slots]
// partial per block in `block_out`.
__global__ void __launch_bounds__(kThreads)
wave_partials(const Params p, Acc* __restrict__ block_out) {
  extern __shared__ long long smem_words[];
  Acc* warp_part = reinterpret_cast<Acc*>(smem_words);   // [kWarps][S]
  Acc* stage = warp_part + kWarps * p.n_slots;            // [kWarps][32]
  long long* blob_words = reinterpret_cast<long long*>(stage + kThreads);
  const long long n_words =
      blob_bytes(p.n_instr, p.n_lanes, p.n_aggs, p.n_slots) / 8;
  const long long* src = reinterpret_cast<const long long*>(p.blob);
  for (long long w = threadIdx.x; w < n_words; w += kThreads) {
    blob_words[w] = src[w];
  }
  const uint8_t* blob = reinterpret_cast<const uint8_t*>(blob_words);
  const Instr* prog = reinterpret_cast<const Instr*>(blob);
  blob += pad8((long long)sizeof(Instr) * p.n_instr);
  const LaneDesc* lanes = reinterpret_cast<const LaneDesc*>(blob);
  blob += pad8((long long)sizeof(LaneDesc) * p.n_lanes);
  const AggDesc* aggs = reinterpret_cast<const AggDesc*>(blob);
  blob += pad8((long long)sizeof(AggDesc) * p.n_aggs);
  const SlotKinds slots{blob};
  __shared__ const void* cols[kMaxCols];
  if (threadIdx.x < kMaxCols) cols[threadIdx.x] = p.cols[threadIdx.x];
  __syncthreads();
  sdot_fold::init_warps(warp_part, p.n_slots, slots);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long start = (long long)blockIdx.x * p.rows_per_block;
  long long end = start + p.rows_per_block;
  if (end > p.n) end = p.n;
  Acc* my_part = warp_part + warp * p.n_slots;
  Acc* my_stage = stage + warp * 32;
  Reg regs[kMaxRegs];

  // the loop bound depends on the warp only, so every lane runs the same
  // iterations and the warp-wide intrinsics below see the full warp
  for (long long base = start + warp * 32; base < end;
       base += (long long)kWarps * 32) {
    const long long row = base + lane;
    const bool in_range = row < end;
    if (in_range) run_program(prog, p.n_instr, cols, row, regs);
    for (int l = 0; l < p.n_lanes; ++l) {
      const LaneDesc L = lanes[l];
      const long long k = in_range ? regs[L.key_reg].i : -1;
      const bool live = in_range && regs[L.base_reg].i != 0 && k >= 0 &&
                        k < L.n_keys;
      if (__ballot_sync(kFull, live) == 0) continue;
      // lanes holding one key form a group; its lowest lane folds it
      const unsigned peers = __match_any_sync(kFull, live ? (int)k : -1);
      const bool leader = live && lane == __ffs(peers) - 1;
      Acc* part = my_part + L.slot_off + (live ? k : 0) * L.n_aggs;
      for (int m = 0; m < L.n_aggs; ++m) {
        const AggDesc a = aggs[L.agg_start + m];
        const bool flt = a.flt != 0;
        const bool ok = live &&
                        (a.mask_reg == kNone || regs[a.mask_reg].i != 0);
        Acc v;
        if (a.kind == kCount) {
          v.i = ok ? 1 : 0;
        } else if (ok) {
          const Reg x = regs[a.val_reg];
          if (!flt) v.i = x.i;
          else v.f = a.val_dt == kF32 ? (double)x.f : x.d;
        } else {
          v = identity(a.kind, flt);
        }
        sdot_fold::warp_fold(my_stage, lane, v, leader, peers, part + m,
                             a.kind, flt);
      }
    }
  }
  __syncthreads();
  sdot_fold::fold_warps(warp_part, p.n_slots, slots, block_out);
}

// Pass 2: fold the per-block partials in block order.
__global__ void __launch_bounds__(kThreads)
wave_reduce(const Params p, const Acc* __restrict__ block_out, int n_blocks,
            Acc* __restrict__ out) {
  const uint8_t* kinds = p.blob
      + blob_bytes(p.n_instr, p.n_lanes, p.n_aggs, 0);
  sdot_fold::fold_blocks(block_out, n_blocks, p.n_slots, SlotKinds{kinds},
                         out);
}

}  // namespace

extern "C" {

int sdot_wave_max_instrs() { return kMaxInstrs; }
int sdot_wave_max_regs() { return kMaxRegs; }
int sdot_wave_max_cols() { return kMaxCols; }
int sdot_wave_record_bytes() {
  // sizes of Instr, LaneDesc and AggDesc, packed for a layout check
  return (int)(sizeof(Instr) * 10000 + sizeof(LaneDesc) * 100
               + sizeof(AggDesc));
}

long long sdot_wave_blob_bytes(int n_instr, int n_lanes, int n_aggs,
                               int n_slots) {
  return blob_bytes(n_instr, n_lanes, n_aggs, n_slots);
}

// Dynamic shared memory of pass 1.
long long sdot_wave_smem_bytes(int n_instr, int n_lanes, int n_aggs,
                               int n_slots) {
  return (long long)sizeof(Acc) * ((long long)kWarps * n_slots + kThreads)
         + blob_bytes(n_instr, n_lanes, n_aggs, n_slots);
}

// Launches both passes on `stream`. Returns a cudaError_t (0 = success).
// col_ptrs are the device addresses of the program's columns, in the
// order its kLoad instructions index them.
int sdot_wave(const void* blob, int n_instr, int n_lanes, int n_aggs,
              int n_slots, const unsigned long long* col_ptrs, int n_cols,
              long long n, long long rows_per_block, int n_blocks,
              void* block_scratch, void* out, void* stream) {
  if (n_instr < 0 || n_instr > kMaxInstrs || n_lanes < 1 || n_aggs < 1 ||
      n_slots < 1 || n_cols < 0 || n_cols > kMaxCols || n_blocks < 1 ||
      rows_per_block < 32 || rows_per_block % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.n = n;
  p.rows_per_block = rows_per_block;
  p.n_instr = n_instr;
  p.n_lanes = n_lanes;
  p.n_aggs = n_aggs;
  p.n_slots = n_slots;
  p.n_cols = n_cols;
  p.blob = static_cast<const uint8_t*>(blob);
  for (int c = 0; c < kMaxCols; ++c) {
    p.cols[c] = c < n_cols ? reinterpret_cast<const void*>(col_ptrs[c])
                           : nullptr;
  }
  const long long smem = sdot_wave_smem_bytes(n_instr, n_lanes, n_aggs,
                                              n_slots);
  cudaError_t err = cudaFuncSetAttribute(
      wave_partials, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Acc* scratch = static_cast<Acc*>(block_scratch);
  wave_partials<<<n_blocks, kThreads, (size_t)smem, s>>>(p, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wave_reduce<<<(n_slots + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      p, scratch, n_blocks, static_cast<Acc*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
