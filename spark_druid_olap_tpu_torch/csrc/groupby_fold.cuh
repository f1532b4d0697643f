// Deterministic group-by fold shared by the fused dense group-by kernel
// (dense_groupby.cu) and the wave kernel (wave.cu).
//
// Accumulators are 64-bit words: int64 for counts, integer sums and integer
// min / max, float64 for float sums and float min / max, with the x64
// routes' empty-group identities (INT64_MAX / INT64_MIN, +-inf). A NaN
// makes a float min / max NaN, as it makes a float sum NaN.
//
// The fold order never depends on scheduling, so the same input and grid
// give bit-identical float sums on every run:
//   * each block owns one fixed, contiguous row range;
//   * inside a warp, the lanes holding one key form a group
//     (__match_any_sync) and its lowest lane folds the group's staged
//     values in lane order into a warp-private partial in shared memory;
//   * a block folds its warps' partials in warp order (fold_warps);
//   * a second kernel folds the blocks' partials in block order
//     (fold_blocks).
// There are no atomics.
//
// A "slot" is one (key, aggregate) accumulator. Callers describe a slot's
// kind and type with a functor `void operator()(int slot, int& kind,
// bool& flt) const`.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sdot_fold {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Kind : int { kCount = 0, kSum = 1, kMin = 2, kMax = 3 };

union Acc {
  long long i;
  double f;
};

__device__ __forceinline__ Acc identity(int kind, bool flt) {
  Acc a;
  if (kind == kMin) {
    if (flt) a.f = __longlong_as_double(0x7ff0000000000000ll);   // +inf
    else a.i = 0x7fffffffffffffffll;
  } else if (kind == kMax) {
    if (flt) a.f = __longlong_as_double((long long)0xfff0000000000000ull);
    else a.i = (long long)0x8000000000000000ull;
  } else if (flt) {
    a.f = 0.0;
  } else {
    a.i = 0;
  }
  return a;
}

__device__ __forceinline__ Acc combine(int kind, bool flt, Acc a, Acc b) {
  Acc r;
  if (kind == kMin) {
    if (flt) r.f = (isnan(b.f) || b.f < a.f) ? b.f : a.f;
    else r.i = b.i < a.i ? b.i : a.i;
  } else if (kind == kMax) {
    if (flt) r.f = (isnan(b.f) || b.f > a.f) ? b.f : a.f;
    else r.i = b.i > a.i ? b.i : a.i;
  } else if (flt) {
    r.f = a.f + b.f;
  } else {
    r.i = a.i + b.i;
  }
  return r;
}

// Every lane of the warp calls this with its value `v` (the identity when
// the lane's row does not count). The leader of each key group folds its
// peers' staged values, in lane order, into `*slot`.
__device__ __forceinline__ void warp_fold(Acc* stage, int lane, Acc v,
                                          bool leader, unsigned peers,
                                          Acc* slot, int kind, bool flt) {
  stage[lane] = v;
  __syncwarp();
  if (leader) {
    Acc acc = *slot;
    unsigned bits = peers;
    while (bits) {
      const int j = __ffs(bits) - 1;
      bits &= bits - 1;
      acc = combine(kind, flt, acc, stage[j]);
    }
    *slot = acc;
  }
  __syncwarp();
}

// Set every warp's partials ([kWarps][n_slots]) to their identities.
template <class SlotKind>
__device__ void init_warps(Acc* warp_part, int n_slots, const SlotKind& sk) {
  for (int idx = threadIdx.x; idx < kWarps * n_slots; idx += kThreads) {
    int kind;
    bool flt;
    sk(idx % n_slots, kind, flt);
    warp_part[idx] = identity(kind, flt);
  }
}

// Fold the warps' partials in warp order into this block's row of
// `block_out` ([n_blocks][n_slots]).
template <class SlotKind>
__device__ void fold_warps(const Acc* warp_part, int n_slots,
                           const SlotKind& sk, Acc* __restrict__ block_out) {
  for (int idx = threadIdx.x; idx < n_slots; idx += kThreads) {
    int kind;
    bool flt;
    sk(idx, kind, flt);
    Acc acc = identity(kind, flt);
    for (int w = 0; w < kWarps; ++w) {
      acc = combine(kind, flt, acc, warp_part[w * n_slots + idx]);
    }
    block_out[(long long)blockIdx.x * n_slots + idx] = acc;
  }
}

// Second pass: one thread per slot folds the blocks in block order.
template <class SlotKind>
__device__ void fold_blocks(const Acc* __restrict__ block_out, int n_blocks,
                            int n_slots, const SlotKind& sk,
                            Acc* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_slots) return;
  int kind;
  bool flt;
  sk(idx, kind, flt);
  Acc acc = identity(kind, flt);
  for (int b = 0; b < n_blocks; ++b) {
    acc = combine(kind, flt, acc, block_out[(long long)b * n_slots + idx]);
  }
  out[idx] = acc;
}

}  // namespace sdot_fold
