// Fused small-K dense group-by for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// spark_druid_olap_tpu/ops/pallas_groupby.py:_make_kernel (launched by
// pallas_dense_groupby). One call aggregates every count / sum / min / max
// of a query over one int32 key column in which filtered-out rows already
// carry the sentinel key n_keys.
//
// Bound: device-memory bytes. Each row costs 4 key bytes plus 4 or 8 bytes
// per value column and 1 byte per mask, against a handful of integer or
// float operations, far below the card's operations-per-byte ratio. The
// design therefore reads every row exactly once, all aggregates of a query
// in one launch, with warp-contiguous (coalesced) loads, and folds with no
// serial step (groupby_fold.cuh). Two fold tiers; the wrapper picks one per
// launch on the host from its slot count (ops/cuda_groupby.py:fold_tier):
//   * the thread-private tier (dense_groupby_threads) while two blocks of a
//     [slot][thread] array fit on an SM (Q1, Q6, wide's second launch):
//     each thread folds its own strided rows in row order into its column,
//     one aggregate after another in a loop specialised to the aggregate's
//     kind and dtype, with kUnroll rows' loads in flight; then the block
//     folds its threads slot by slot with a shuffle tree;
//   * the warp-parallel tier (dense_groupby_warps) above that (wide's
//     96-slot launch, K = 64 with 16 aggregates): per 32-row batch one key
//     sort per warp, then per aggregate a segmented shuffle scan; a lane
//     loads the values of the row it holds after the sort, so values need
//     no shuffle;
//   * a second launch (dense_groupby_fold) folds the blocks, a warp per
//     slot.
// What bounds it in practice is latency, not bytes: a thread-tier block
// waits on its loads between aggregates, and a warp-tier batch on its
// shuffle chains (PERF.md has the times against the byte bound).
//
// Results are exact and deterministic:
//   * counts and integer sums accumulate in int64 (exact at any magnitude),
//     float sums in float64, min / max in the value's own 64-bit type with
//     the x64 routes' empty-group sentinels (INT64_MAX / INT64_MIN, +-inf);
//     a NaN value makes its group's float min / max NaN, as a NaN makes
//     its float sum NaN;
//   * no atomics, and every fold runs in an order fixed by the row range
//     of each block (launch_geometry: the row count alone) and the data, so
//     two launches on one input give bit-identical sums.
//
// Layout: slot k * n_aggs + m holds (key k, aggregate m); the output is
// [n_keys, n_aggs] of 64-bit words (int64 or float64 bits per aggregate),
// the block scratch [n_keys * n_aggs][n_blocks]. One launch takes at most
// kMaxAggs aggregates; the wrapper launches once per group of them and
// allocates the outputs and the scratch; nothing is allocated here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "groupby_fold.cuh"

namespace {

using sdot_fold::Acc;
using sdot_fold::combine;
using sdot_fold::identity;
using sdot_fold::kCount;
using sdot_fold::kFull;
using sdot_fold::kThreads;
using sdot_fold::kThreadTier;
using sdot_fold::kWarps;
using sdot_fold::kWarpTier;

constexpr int kMaxAggs = 16;
constexpr int kUnroll = 8;      // rows per thread whose loads overlap

enum DType : int { kI32 = 0, kI64 = 1, kF32 = 2, kF64 = 3 };

struct AggDesc {
  const void* values;    // null for count
  const uint8_t* mask;   // null when the aggregate has no filter
  int kind;
  int dtype;
};

struct Params {
  const int32_t* key;
  long long n;
  int n_keys;
  int n_aggs;
  long long rows_per_block;   // a multiple of 32
  int n_blocks;
  AggDesc aggs[kMaxAggs];
};

__device__ __forceinline__ bool is_float(int dtype) { return dtype >= kF32; }

// slot k * n_aggs + m takes aggregate m's kind and type
struct AggSlots {
  const AggDesc* aggs;
  int n_aggs;
  __device__ void operator()(int slot, int& kind, bool& flt) const {
    const AggDesc& a = aggs[slot % n_aggs];
    kind = a.kind;
    flt = is_float(a.dtype);
  }
};

__device__ __forceinline__ Acc load_value(const AggDesc& a, long long row) {
  Acc v;
  switch (a.dtype) {
    case kI32: v.i = static_cast<const int32_t*>(a.values)[row]; break;
    case kI64: v.i = static_cast<const long long*>(a.values)[row]; break;
    case kF32: v.f = static_cast<const float*>(a.values)[row]; break;
    default: v.f = static_cast<const double*>(a.values)[row]; break;
  }
  return v;
}

// descriptors indexed at run time live in shared memory, not in the
// kernel's parameter space
__device__ __forceinline__ void stage_aggs(const Params& p, AggDesc* aggs) {
  if (threadIdx.x < kMaxAggs) aggs[threadIdx.x] = p.aggs[threadIdx.x];
  __syncthreads();
}

// One aggregate of the thread-private tier: this thread folds its rows
// first, first + kThreads, ... (< end), in row order, into its column
// `mine` of the aggregate's slots (slot k at mine[k * M * kThreads]).
// kUnroll rows' key, mask and value loads are in flight at once: values load
// whether or not the row counts, so no load waits on another.
template <class Op, typename T>
__device__ __forceinline__ void fold_column(const int32_t* __restrict__ key,
                                            int K, int M, const T* values,
                                            const uint8_t* mask, Acc* mine,
                                            long long first, long long end) {
  for (long long base = first; base < end;
       base += (long long)kThreads * kUnroll) {
    int k[kUnroll];
    bool ok[kUnroll];
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = base + (long long)u * kThreads;
      const bool in = row < end;
      k[u] = in ? __ldg(key + row) : K;
      ok[u] = in && (mask == nullptr || __ldg(mask + row) != 0);
      if (values != nullptr && in) v[u] = __ldg(values + row);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u] || k[u] < 0 || k[u] >= K) continue;
      Acc* slot = mine + k[u] * M * kThreads;
      if (values == nullptr) {
        slot->i += 1;                               // a count
      } else {
        Acc x;
        if (Op::kFloat) x.f = (double)v[u];
        else x.i = (long long)v[u];
        *slot = Op::op(*slot, x);
      }
    }
  }
}

// Thread-private tier: thread t of a block folds rows start + t,
// start + t + kThreads, ... into its column of part[K * M][kThreads], one
// aggregate after another (the block's keys stay in L1 between them).
__global__ void __launch_bounds__(kThreads)
dense_groupby_threads(const Params p, Acc* __restrict__ scratch) {
  extern __shared__ long long smem_words[];
  Acc* part = reinterpret_cast<Acc*>(smem_words);
  __shared__ AggDesc aggs[kMaxAggs];
  stage_aggs(p, aggs);
  const int K = p.n_keys;
  const int M = p.n_aggs;
  const AggSlots slots{aggs, M};
  sdot_fold::init_threads(part, K * M, slots);
  const long long start = (long long)blockIdx.x * p.rows_per_block;
  long long end = start + p.rows_per_block;
  if (end > p.n) end = p.n;
  const long long first = start + threadIdx.x;

  for (int m = 0; m < M; ++m) {
    const AggDesc a = aggs[m];
    Acc* mine = part + m * kThreads + threadIdx.x;
    if (a.kind == kCount) {
      fold_column<sdot_fold::SumI, int32_t>(p.key, K, M, nullptr, a.mask,
                                            mine, first, end);
      continue;
    }
    sdot_fold::with_op(a.kind, is_float(a.dtype), [&](auto op) {
      using Op = decltype(op);
      switch (a.dtype) {
        case kI32:
          fold_column<Op>(p.key, K, M, static_cast<const int32_t*>(a.values),
                          a.mask, mine, first, end);
          break;
        case kI64:
          fold_column<Op>(p.key, K, M,
                          static_cast<const long long*>(a.values), a.mask,
                          mine, first, end);
          break;
        case kF32:
          fold_column<Op>(p.key, K, M, static_cast<const float*>(a.values),
                          a.mask, mine, first, end);
          break;
        default:
          fold_column<Op>(p.key, K, M, static_cast<const double*>(a.values),
                          a.mask, mine, first, end);
          break;
      }
    });
  }
  __syncthreads();
  sdot_fold::fold_threads(part, K * M, slots, scratch, p.n_blocks);
}

// Warp-parallel tier: warp w of a block takes the 32-row batches
// start + 32 w, start + 32 (w + kWarps), ... into its partials
// warp_part[kWarps][K * M].
__global__ void __launch_bounds__(kThreads)
dense_groupby_warps(const Params p, Acc* __restrict__ scratch) {
  extern __shared__ long long smem_words[];
  Acc* warp_part = reinterpret_cast<Acc*>(smem_words);
  __shared__ AggDesc aggs[kMaxAggs];
  stage_aggs(p, aggs);
  const int K = p.n_keys;
  const int M = p.n_aggs;
  const AggSlots slots{aggs, M};
  sdot_fold::init_warps(warp_part, K * M, slots);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long start = (long long)blockIdx.x * p.rows_per_block;
  long long end = start + p.rows_per_block;
  if (end > p.n) end = p.n;
  Acc* my_part = warp_part + warp * K * M;

  // the loop bound depends on the warp only, so every lane runs the same
  // iterations and the warp-wide intrinsics see the full warp
  for (long long base = start + warp * 32; base < end;
       base += (long long)kWarps * 32) {
    const long long row = base + lane;
    const bool in = row < end;
    const int key = in ? p.key[row] : K;
    const bool live = in && key >= 0 && key < K;
    if (__ballot_sync(kFull, live) == 0) continue;
    const sdot_fold::Seg seg[1] = {sdot_fold::warp_segments(key, live,
                                                            lane)};
    const sdot_fold::Seg& s = seg[0];
    const long long srow = base + s.src;      // the row this lane holds
    Acc* part = my_part + (s.tail ? s.key : 0) * M;
    for (int m = 0; m < M; ++m) {
      const AggDesc a = aggs[m];
      const bool ok = s.live && (a.mask == nullptr || a.mask[srow] != 0);
      if (a.kind == kCount) {
        const long long c = sdot_fold::seg_count(s, lane, ok);
        if (s.tail) part[m].i += c;
        continue;
      }
      sdot_fold::with_op(a.kind, is_float(a.dtype), [&](auto op) {
        using Op = decltype(op);
        Acc x[1] = {ok ? load_value(a, srow) : Op::id()};
        sdot_fold::seg_scan<Op>(seg, lane, x);
        if (s.tail) part[m] = Op::op(part[m], x[0]);
      });
    }
    __syncwarp();     // the next batch's tails may fold into these slots
  }
  __syncthreads();
  sdot_fold::fold_warps(warp_part, K * M, slots, scratch, p.n_blocks);
}

// Second launch: fold the blocks' partials, a warp per slot.
__global__ void __launch_bounds__(kThreads)
dense_groupby_fold(const Params p, const Acc* __restrict__ scratch,
                   Acc* __restrict__ out) {
  sdot_fold::fold_blocks(scratch, p.n_blocks, p.n_keys * p.n_aggs,
                         AggSlots{p.aggs, p.n_aggs}, out);
}

}  // namespace

extern "C" {

int sdot_dense_groupby_threads() { return kThreads; }
int sdot_dense_groupby_max_aggs() { return kMaxAggs; }

// Dynamic shared memory of the partials pass for n_keys x n_aggs slots in
// `tier` (kThreadTier: [slots][kThreads] words; kWarpTier: [kWarps][slots]).
long long sdot_dense_groupby_smem_bytes(int n_keys, int n_aggs, int tier) {
  const long long slots = (long long)n_keys * n_aggs;
  return (long long)sizeof(Acc) * slots
         * (tier == kThreadTier ? kThreads : kWarps);
}

// Launches both passes on `stream`. Returns a cudaError_t (0 = success).
// value_ptrs / mask_ptrs are device addresses (0 for none); kinds and
// dtypes use the Kind / DType codes above; tier is a sdot_fold::Tier.
// block_scratch holds n_keys * n_aggs * n_blocks words.
int sdot_dense_groupby(const int32_t* key, long long n, int n_keys,
                       int n_aggs, const int* kinds, const int* dtypes,
                       const unsigned long long* value_ptrs,
                       const unsigned long long* mask_ptrs,
                       long long rows_per_block, int n_blocks, int tier,
                       void* block_scratch, void* out, void* stream) {
  if (n_aggs < 1 || n_aggs > kMaxAggs || n_keys < 1 ||
      n_keys >= (1 << 26) || n_blocks < 1 || rows_per_block < 32 ||
      rows_per_block % 32 != 0 || (tier != kThreadTier && tier != kWarpTier)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.key = key;
  p.n = n;
  p.n_keys = n_keys;
  p.n_aggs = n_aggs;
  p.rows_per_block = rows_per_block;
  p.n_blocks = n_blocks;
  for (int m = 0; m < kMaxAggs; ++m) {
    AggDesc d = {nullptr, nullptr, kCount, kI64};
    if (m < n_aggs) {
      d.values = reinterpret_cast<const void*>(value_ptrs[m]);
      d.mask = reinterpret_cast<const uint8_t*>(mask_ptrs[m]);
      d.kind = kinds[m];
      d.dtype = dtypes[m];
    }
    p.aggs[m] = d;
  }
  const long long smem = sdot_dense_groupby_smem_bytes(n_keys, n_aggs, tier);
  auto partials = tier == kThreadTier ? dense_groupby_threads
                                      : dense_groupby_warps;
  cudaError_t err = cudaFuncSetAttribute(
      partials, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Acc* scratch = static_cast<Acc*>(block_scratch);
  partials<<<n_blocks, kThreads, (size_t)smem, s>>>(p, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int slots = n_keys * n_aggs;
  dense_groupby_fold<<<(slots + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      p, scratch, static_cast<Acc*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
