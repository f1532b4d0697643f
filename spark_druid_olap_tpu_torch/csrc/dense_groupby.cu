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
// in the same pass, with warp-contiguous (coalesced) loads.
//
// Results are exact and deterministic:
//   * counts and integer sums accumulate in int64 (exact at any magnitude),
//     float sums in float64, min / max in the value's own 64-bit type with
//     the x64 routes' empty-group sentinels (INT64_MAX / INT64_MIN, +-inf);
//     a NaN value makes its group's float min / max NaN, as a NaN makes
//     its float sum NaN;
//   * no atomics and no float reassociation that depends on scheduling:
//     the fold of groupby_fold.cuh (shared with the wave kernel, wave.cu):
//     each block owns a fixed contiguous row range; inside a warp, rows of
//     one key are folded by that key's lowest lane in lane order into a
//     warp-private partial in shared memory; a block folds its warps in
//     warp order, and a second kernel folds the blocks in block order. The
//     same input and grid therefore give bit-identical sums on every run.
//
// Layout: the partial for (key k, aggregate m) sits at k * n_aggs + m; the
// output is [n_keys, n_aggs] of 64-bit words (int64 or float64 bits per
// aggregate). One launch takes at most kMaxAggs aggregates; the wrapper
// (ops/cuda_groupby.py) launches once per group of them, and allocates the
// outputs and the [n_blocks, n_keys, n_aggs] block scratch; nothing is
// allocated here.

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
using sdot_fold::kWarps;

constexpr int kMaxAggs = 16;

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

// Pass 1: one fixed, contiguous row range per block -> one [K, M] partial
// per block in `block_out`.
__global__ void __launch_bounds__(kThreads)
dense_groupby_partials(const Params p, Acc* __restrict__ block_out) {
  extern __shared__ long long smem_words[];
  Acc* smem = reinterpret_cast<Acc*>(smem_words);
  const int K = p.n_keys;
  const int M = p.n_aggs;
  const int KM = K * M;
  Acc* warp_part = smem;                    // [kWarps][K][M]
  Acc* stage = smem + kWarps * KM;          // [kWarps][32]
  // descriptors indexed at run time live in shared memory, not in the
  // kernel's parameter space
  __shared__ AggDesc aggs[kMaxAggs];
  if (threadIdx.x < kMaxAggs) aggs[threadIdx.x] = p.aggs[threadIdx.x];
  __syncthreads();
  const AggSlots slots{aggs, M};
  sdot_fold::init_warps(warp_part, KM, slots);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long start = (long long)blockIdx.x * p.rows_per_block;
  long long end = start + p.rows_per_block;
  if (end > p.n) end = p.n;
  Acc* my_part = warp_part + warp * KM;
  Acc* my_stage = stage + warp * 32;

  // the loop bound depends on the warp only, so every lane runs the same
  // iterations and the warp-wide intrinsics below see the full warp
  for (long long base = start + warp * 32; base < end;
       base += (long long)kWarps * 32) {
    const long long row = base + lane;
    const bool in_range = row < end;
    const int k = in_range ? p.key[row] : K;
    const bool live = in_range && k >= 0 && k < K;
    if (__ballot_sync(kFull, live) == 0) continue;
    // lanes holding one key form a group; its lowest lane folds it
    const unsigned peers = __match_any_sync(kFull, live ? k : -1);
    const bool leader = live && lane == __ffs(peers) - 1;
    for (int m = 0; m < M; ++m) {
      const AggDesc& a = aggs[m];
      const bool flt = is_float(a.dtype);
      const bool ok = live && (a.mask == nullptr || a.mask[row] != 0);
      Acc v;
      if (a.kind == kCount) {
        v.i = ok ? 1 : 0;
      } else if (ok) {
        v = load_value(a, row);
      } else {
        v = identity(a.kind, flt);
      }
      sdot_fold::warp_fold(my_stage, lane, v, leader, peers,
                           my_part + (live ? k : 0) * M + m, a.kind, flt);
    }
  }
  __syncthreads();
  sdot_fold::fold_warps(warp_part, KM, slots, block_out);
}

// Pass 2: fold the per-block partials in block order.
__global__ void __launch_bounds__(kThreads)
dense_groupby_reduce(const Params p, const Acc* __restrict__ block_out,
                     int n_blocks, Acc* __restrict__ out) {
  sdot_fold::fold_blocks(block_out, n_blocks, p.n_keys * p.n_aggs,
                         AggSlots{p.aggs, p.n_aggs}, out);
}

}  // namespace

extern "C" {

int sdot_dense_groupby_threads() { return kThreads; }
int sdot_dense_groupby_max_aggs() { return kMaxAggs; }

// Shared memory pass 1 needs for n_keys x n_aggs partials.
long long sdot_dense_groupby_smem_bytes(int n_keys, int n_aggs) {
  return (long long)sizeof(Acc) * ((long long)kWarps * n_keys * n_aggs
                                   + kWarps * 32);
}

// Launches both passes on `stream`. Returns a cudaError_t (0 = success).
// value_ptrs / mask_ptrs are device addresses (0 for none); kinds and
// dtypes use the Kind / DType codes above.
int sdot_dense_groupby(const int32_t* key, long long n, int n_keys,
                       int n_aggs, const int* kinds, const int* dtypes,
                       const unsigned long long* value_ptrs,
                       const unsigned long long* mask_ptrs,
                       long long rows_per_block, int n_blocks,
                       void* block_scratch, void* out, void* stream) {
  if (n_aggs < 1 || n_aggs > kMaxAggs || n_keys < 1 || n_blocks < 1 ||
      rows_per_block < 32 || rows_per_block % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.key = key;
  p.n = n;
  p.n_keys = n_keys;
  p.n_aggs = n_aggs;
  p.rows_per_block = rows_per_block;
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
  const long long smem = sdot_dense_groupby_smem_bytes(n_keys, n_aggs);
  cudaError_t err = cudaFuncSetAttribute(
      dense_groupby_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Acc* scratch = static_cast<Acc*>(block_scratch);
  dense_groupby_partials<<<n_blocks, kThreads, (size_t)smem, s>>>(p, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int km = n_keys * n_aggs;
  dense_groupby_reduce<<<(km + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      p, scratch, n_blocks, static_cast<Acc*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
