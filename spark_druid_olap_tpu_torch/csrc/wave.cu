// Wave kernel for Hopper (sm_90a): one launch runs every lane of a fused
// shared-scan wave — each lane's filter, interval, group key, filtered
// dense aggregates and in-kernel theta sketches — over the wave's union
// columns.
//
// Replaces the JAX package's Pallas TPU kernel
// spark_druid_olap_tpu/ops/pallas_wave.py:build_wave_fn (its inner
// `kernel`, launched by the pl.pallas_call there), the theta stripe of
// :403-414 included: for each in-kernel theta aggregate, key k and hash
// lane j < 64, the minimum over the lane's rows that count of
// _hash01(value, j) (sketch_hash.cuh). HLL, KLL and wider theta sketches
// run after the launch (ops/cuda_wave.py's epilogue), as on the TPU. The
// lanes' query semantics are not written here: the host traces
// the engine's own lowering (ops/cuda_wave.py) into a short register
// program, and every thread interprets that program over its rows. The
// program is the same for every thread, so the dispatch switch does not
// diverge inside a warp.
//
// Bound: device-memory bytes. Each union column is read once per row, and
// the fusion plan's shared predicates evaluate once per row for every lane
// (the trace memoizes them), so the bytes moved are those of the column
// union. What keeps the kernel above that bound is the per-row work: the
// program's instructions plus one fold per lane aggregate. Each
// interpreted instruction costs a dispatch of near-fixed latency, so the
// design keeps many rows in flight and spends few dispatches:
//   * each thread runs the program over R = 2 rows at once: one dispatch
//     serves two independent rows;
//   * the register file is sized by the program's own register count,
//     [reg][row][thread], 4-byte words when no register is wider than 32
//     bits (wave_program.cuh:RegFile), in shared memory; where it does not
//     fit there, the wrapper (ops/cuda_wave.py:register_file) puts a
//     one-row file in local memory;
//   * the host gives each instruction a specialised handler where its
//     (op, dtype) has one, and folds constants into immediate operands;
//   * the fold is the warp-parallel tier of groupby_fold.cuh, R batches in
//     lockstep: per lane and 32-row batch one key sort (none where every
//     live row has one key), then per aggregate a segmented shuffle scan.
//     A value moves from its row's lane to the sorted position with one
//     shuffle, so the register file stays private to its thread;
//   * a second launch folds the blocks' partials, a warp per slot;
//   * a theta aggregate expands each row into 64 min updates, one per
//     hash lane, each folded like a min aggregate (one segmented scan per
//     lane over the batch's sorted keys). A simple design that is right:
//     privatising n_keys * 64 slots per thread would not fit.
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
//     row ranges per block, fixed sort and scan trees in a warp, warp order
//     in a block, a fixed tree over blocks. No atomics: two launches on one
//     input give bit-identical float sums;
//   * a theta stripe is a min over float32 hashes held in float64 slots:
//     exact and independent of order, so bit-identical under any fold.
//
// Layout. The program blob (device memory, built once per program by the
// wrapper) holds, each section padded to 8 bytes: Instr[n_instr],
// LaneDesc[n_lanes], AggDesc[n_aggs] (each lane's dense descriptors, then
// its theta ones), uint8 slot kind[n_slots]. Lane l owns the slots
// [slot_off, slot_off + n_keys * n_aggs), the slot of (key k,
// aggregate m) at slot_off + k * n_aggs + m; its last aggregate is the
// lane's row count. Its n_theta theta descriptors follow its dense ones in
// AggDesc[] (kind min, float64 slots; val_reg holds the hashed value,
// val_dt its dtype), and their stripes follow its dense slots: the slot of
// (theta t, key k, hash lane j) at slot_off + n_keys * n_aggs
// + (t * n_keys + k) * 64 + j. A stripe slot no row reaches keeps the fold's
// +inf identity (the wrapper reads it as the TPU stripe's 2.0). The output
// is [n_slots] 64-bit words (int64 or float64 bits). The wrapper allocates
// the output and the [n_slots][n_blocks] block scratch; nothing is
// allocated here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "groupby_fold.cuh"
#include "sketch_hash.cuh"
#include "wave_program.cuh"

namespace {

using namespace sdot_wave_program;
using sdot_fold::Acc;
using sdot_fold::identity;
using sdot_fold::kCount;
using sdot_fold::kFull;
using sdot_fold::kThreads;
using sdot_fold::kWarps;
using sdot_sketch::kThetaLanes;

struct LaneDesc {         // 32 bytes
  int base_reg, key_reg, n_keys, n_aggs, agg_start, slot_off, n_theta, pad;
};

struct AggDesc {          // 8 bytes
  uint8_t kind, flt, val_reg, val_dt, mask_reg, pad0, pad1, pad2;
};

struct Params {
  long long n;
  long long rows_per_block;   // a multiple of 32
  int n_instr, n_lanes, n_aggs, n_slots, n_cols, n_regs, n_blocks;
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

// Pass 1: one fixed, contiguous row range per block -> the block's column
// of the slot-major `scratch`. Warp w takes the 32 R-row stretches
// start + 32 R w, start + 32 R (w + kWarps), ...; thread `lane` of it runs
// rows stretch + 32 r + lane, r < R, and the warp folds the stretch as R
// 32-row batches, in row order. The register file is in shared memory
// ([reg][row][thread]) where kSharedFile, else in the thread's local
// memory.
template <int R, typename Word, bool kSharedFile>
__global__ void __launch_bounds__(kThreads)
wave_partials(const Params p, Acc* __restrict__ scratch) {
  extern __shared__ long long smem_words[];
  Acc* warp_part = reinterpret_cast<Acc*>(smem_words);   // [kWarps][S]
  Word* file = reinterpret_cast<Word*>(warp_part + kWarps * p.n_slots);
  long long* blob_words = reinterpret_cast<long long*>(
      file + (kSharedFile ? (long long)p.n_regs * R * kThreads : 0));
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
  Word local_file[kSharedFile ? 1 : kMaxRegs * R];
  const RegFile<R, Word> f{kSharedFile ? file : local_file,
                           kSharedFile ? kThreads : 1,
                           kSharedFile ? (int)threadIdx.x : 0};

  // the loop bound depends on the warp only, so every lane runs the same
  // iterations and the warp-wide intrinsics below see the full warp
  for (long long base = start + (long long)warp * 32 * R; base < end;
       base += (long long)kWarps * 32 * R) {
    long long rows[R];
    bool valid[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rows[r] = base + 32 * r + lane;
      valid[r] = rows[r] < end;
      if (!valid[r]) rows[r] = start;     // a row that exists; not folded
    }
    run_rows<R>(prog, p.n_instr, cols, rows, f);
    for (int l = 0; l < p.n_lanes; ++l) {
      const LaneDesc L = lanes[l];
      bool live[R];
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const long long k = valid[r] ? f.get(L.key_reg, r).i : -1;
        live[r] = valid[r] && f.get(L.base_reg, r).i != 0 && k >= 0 &&
                  k < L.n_keys;
        any |= live[r];
      }
      if (!__any_sync(kFull, any)) continue;
      // the R batches' sorts and scans are independent chains
      sdot_fold::Seg seg[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const long long k = f.get(L.key_reg, r).i;
        seg[r] = sdot_fold::warp_segments(live[r] ? (int)k : 0, live[r],
                                          lane);
      }
      Acc* lane_part = my_part + L.slot_off;
      for (int m = 0; m < L.n_aggs; ++m) {
        const AggDesc a = aggs[L.agg_start + m];
        const bool flt = a.flt != 0;
        bool ok[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          ok[r] = live[r] && (a.mask_reg == kNone ||
                              f.get(a.mask_reg, r).i != 0);
        }
        if (a.kind == kCount) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const long long c = sdot_fold::seg_count(
                seg[r], lane, sdot_fold::to_sorted(seg[r], ok[r]));
            if (seg[r].tail) lane_part[seg[r].key * L.n_aggs + m].i += c;
            if (r + 1 < R) __syncwarp();   // batch r + 1 may hit this slot
          }
          continue;
        }
        sdot_fold::with_op(a.kind, flt, [&](auto op) {
          using Op = decltype(op);
          Acc x[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            Acc v = Op::id();
            if (ok[r]) {
              const Reg g = f.get(a.val_reg, r);
              if (!flt) v.i = g.i;
              else v.f = a.val_dt == kF32 ? (double)g.f : g.d;
            }
            x[r] = sdot_fold::to_sorted(seg[r], v);
          }
          sdot_fold::seg_scan<Op>(seg, lane, x);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (seg[r].tail) {
              Acc* slot = lane_part + seg[r].key * L.n_aggs + m;
              *slot = Op::op(*slot, x[r]);
            }
            if (r + 1 < R) __syncwarp();   // batch r + 1 may hit this slot
          }
        });
      }
      // the theta stripes: per hash lane j, the batch's hashes fold into
      // the slots of (key, j) as a min aggregate does
      Acc* stripe = lane_part + L.n_keys * L.n_aggs;
      for (int t = 0; t < L.n_theta; ++t) {
        const AggDesc a = aggs[L.agg_start + L.n_aggs + t];
        bool ok[R];
        uint32_t hbase[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          ok[r] = live[r] && (a.mask_reg == kNone ||
                              f.get(a.mask_reg, r).i != 0);
          const Reg g = f.get(a.val_reg, r);
          hbase[r] = sdot_sketch::theta_base(
              a.val_dt == kF32 ? __float_as_uint(g.f)
                               : (uint32_t)(unsigned long long)g.i);
        }
        for (int j = 0; j < kThetaLanes; ++j) {
          Acc x[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            Acc h = sdot_fold::MinF::id();
            if (ok[r]) h.f = (double)sdot_sketch::theta_hash01(hbase[r], j);
            x[r] = sdot_fold::to_sorted(seg[r], h);
          }
          sdot_fold::seg_scan<sdot_fold::MinF>(seg, lane, x);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (seg[r].tail) {
              Acc* slot = stripe + seg[r].key * kThetaLanes + j;
              *slot = sdot_fold::MinF::op(*slot, x[r]);
            }
            if (r + 1 < R) __syncwarp();   // batch r + 1 may hit this slot
          }
        }
        stripe += L.n_keys * kThetaLanes;
      }
    }
    __syncwarp();     // the next stretch's tails may fold into these slots
  }
  __syncthreads();
  sdot_fold::fold_warps(warp_part, p.n_slots, slots, scratch, p.n_blocks);
}

// Pass 2: fold the blocks' partials, a warp per slot.
__global__ void __launch_bounds__(kThreads)
wave_fold(const Params p, const Acc* __restrict__ scratch,
          Acc* __restrict__ out) {
  const uint8_t* kinds = p.blob
      + blob_bytes(p.n_instr, p.n_lanes, p.n_aggs, 0);
  sdot_fold::fold_blocks(scratch, p.n_blocks, p.n_slots, SlotKinds{kinds},
                         out);
}

template <int R, typename Word, bool kSharedFile>
cudaError_t launch_partials(const Params& p, long long smem, cudaStream_t s,
                            Acc* scratch) {
  auto kernel = wave_partials<R, Word, kSharedFile>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.n_blocks, kThreads, (size_t)smem, s>>>(p, scratch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int sdot_wave_max_instrs() { return kMaxInstrs; }
int sdot_wave_max_regs() { return kMaxRegs; }
int sdot_wave_max_cols() { return kMaxCols; }
int sdot_wave_fast_handlers() { return kNumFast; }
int sdot_wave_record_bytes() {
  // sizes of Instr, LaneDesc and AggDesc, packed for a layout check
  return (int)(sizeof(Instr) * 10000 + sizeof(LaneDesc) * 100
               + sizeof(AggDesc));
}

long long sdot_wave_blob_bytes(int n_instr, int n_lanes, int n_aggs,
                               int n_slots) {
  return blob_bytes(n_instr, n_lanes, n_aggs, n_slots);
}

// Dynamic shared memory of pass 1: the warps' partials, the program blob
// and, where shared_file, the register file of n_regs registers x `rows`
// rows x kThreads threads of `word` bytes.
long long sdot_wave_smem_bytes(int n_instr, int n_lanes, int n_aggs,
                               int n_slots, int n_regs, int rows, int word,
                               int shared_file) {
  return (long long)sizeof(Acc) * kWarps * n_slots
         + (shared_file ? (long long)n_regs * rows * kThreads * word : 0)
         + blob_bytes(n_instr, n_lanes, n_aggs, n_slots);
}

// Launches both passes on `stream`. Returns a cudaError_t (0 = success).
// col_ptrs are the device addresses of the program's columns, in the
// order its kLoad instructions index them; rows, word (4 or 8) and
// shared_file choose the register file: 2 rows in shared memory or 1 row in
// local memory; block_scratch holds n_slots * n_blocks words.
int sdot_wave(const void* blob, int n_instr, int n_lanes, int n_aggs,
              int n_slots, int n_regs, int rows, int word, int shared_file,
              const unsigned long long* col_ptrs, int n_cols,
              long long n, long long rows_per_block, int n_blocks,
              void* block_scratch, void* out, void* stream) {
  if (n_instr < 0 || n_instr > kMaxInstrs || n_lanes < 1 || n_aggs < 1 ||
      n_slots < 1 || n_regs < 1 || n_regs > kMaxRegs || n_cols < 0 ||
      n_cols > kMaxCols || n_blocks < 1 || rows_per_block < 32 ||
      rows_per_block % 32 != 0 || (word != 4 && word != 8) ||
      rows != (shared_file ? 2 : 1)) {
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
  p.n_regs = n_regs;
  p.n_blocks = n_blocks;
  p.blob = static_cast<const uint8_t*>(blob);
  for (int c = 0; c < kMaxCols; ++c) {
    p.cols[c] = c < n_cols ? reinterpret_cast<const void*>(col_ptrs[c])
                           : nullptr;
  }
  const long long smem = sdot_wave_smem_bytes(
      n_instr, n_lanes, n_aggs, n_slots, n_regs, rows, word, shared_file);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Acc* scratch = static_cast<Acc*>(block_scratch);
  cudaError_t err;
  if (!shared_file) {
    err = word == 4 ? launch_partials<1, int32_t, false>(p, smem, s, scratch)
                    : launch_partials<1, long long, false>(p, smem, s,
                                                           scratch);
  } else {
    err = word == 4 ? launch_partials<2, int32_t, true>(p, smem, s, scratch)
                    : launch_partials<2, long long, true>(p, smem, s,
                                                          scratch);
  }
  if (err != cudaSuccess) return (int)err;
  wave_fold<<<(n_slots + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      p, scratch, static_cast<Acc*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
