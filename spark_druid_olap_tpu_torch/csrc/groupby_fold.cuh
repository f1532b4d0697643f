// Deterministic group-by fold shared by the fused dense group-by kernel
// (dense_groupby.cu, B1) and the wave kernel (wave.cu, B2), the Hopper
// counterparts of the JAX package's Pallas kernels
// spark_druid_olap_tpu/ops/pallas_groupby.py:_make_kernel and
// spark_druid_olap_tpu/ops/pallas_wave.py:build_wave_fn.
//
// Accumulators are 64-bit words: int64 for counts, integer sums and integer
// min / max, float64 for float sums and float min / max, with the x64
// routes' empty-group identities (INT64_MAX / INT64_MIN, +-inf). A NaN
// makes a float min / max NaN, as it makes a float sum NaN.
//
// Both kernels are bound by device-memory bytes; what held them far above
// that bound in their first version was a serial fold (one leader lane per
// key walking its peers, one thread per slot walking every block), so every
// step here is parallel. Rows reach a per-block partial through one of two
// tiers, which the wrapper picks per launch on the host from the slot
// count, the thread count and the shared memory
// (ops/cuda_groupby.py:fold_tier):
//   * thread-private (few slots: while two blocks of it fit on an SM): each
//     thread folds its own fixed, strided rows, in row order, into its own
//     column of a [slot][thread] shared array (a warp's 32 words of one
//     slot are contiguous, so no bank conflicts). No warp-level step at
//     all. The block then folds its threads slot by slot (fold_threads):
//     lane i takes threads i, i + 32, ... in order, then a fixed 5-step
//     shuffle tree;
//   * warp-parallel (many slots; the wave kernel always): in each 32-row
//     batch the warp sorts its (key, lane) pairs with a fixed bitonic
//     shuffle network — ties broken by lane, so the order is fixed — or
//     skips the sort when every live row has one key (warp_segments).
//     Then, per aggregate, a segmented scan over the sorted keys (at most 5
//     shuffle steps, seg_scan, with the aggregate's combine chosen once,
//     with_op; counts are one ballot, seg_count) leaves each key's batch
//     total in the last lane of its segment, which folds it into the warp's
//     private slot. Keys are distinct among those lanes, so no slot is
//     written twice in a batch. R batches scan in lockstep as R independent
//     chains and fold into the slots in row order. The block folds its
//     warps in warp order (fold_warps).
// Either way the block writes its partials slot-major, scratch[slot][block].
// A second launch folds the blocks with one warp per slot (fold_blocks):
// lane i takes blocks i, i + 32, ... in order, then the same shuffle tree.
//
// So the fold order depends on the row count and the data alone, never on
// the card or on scheduling: two launches on one input are bit-identical.
// No lane runs a per-row loop for other lanes, no thread walks all blocks,
// and there are no atomics.
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

// fold tiers (ops/cuda_groupby.py:TIERS)
enum Tier : int { kThreadTier = 0, kWarpTier = 1 };

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

// Fixed 5-step shuffle tree: lane 0 ends with the fold of the 32 lanes'
// values, lower lanes' first at every level.
__device__ __forceinline__ Acc warp_tree(int kind, bool flt, Acc v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    Acc o;
    o.i = __shfl_down_sync(kFull, v.i, d);
    v = combine(kind, flt, v, o);
  }
  return v;
}

// The combine of one (kind, type), as a type: the warp-parallel tier picks
// one per aggregate (with_op), so its scan steps do not branch on the kind.
struct SumI {
  static constexpr bool kFloat = false;
  static __device__ __forceinline__ Acc id() { Acc a; a.i = 0; return a; }
  static __device__ __forceinline__ Acc op(Acc a, Acc b) {
    a.i += b.i;
    return a;
  }
};
struct SumF {
  static constexpr bool kFloat = true;
  static __device__ __forceinline__ Acc id() { Acc a; a.f = 0.0; return a; }
  static __device__ __forceinline__ Acc op(Acc a, Acc b) {
    a.f += b.f;
    return a;
  }
};
struct MinI {
  static constexpr bool kFloat = false;
  static __device__ __forceinline__ Acc id() { return identity(kMin, false); }
  static __device__ __forceinline__ Acc op(Acc a, Acc b) {
    return b.i < a.i ? b : a;
  }
};
struct MaxI {
  static constexpr bool kFloat = false;
  static __device__ __forceinline__ Acc id() { return identity(kMax, false); }
  static __device__ __forceinline__ Acc op(Acc a, Acc b) {
    return b.i > a.i ? b : a;
  }
};
struct MinF {
  static constexpr bool kFloat = true;
  static __device__ __forceinline__ Acc id() { return identity(kMin, true); }
  static __device__ __forceinline__ Acc op(Acc a, Acc b) {
    return (isnan(b.f) || b.f < a.f) ? b : a;
  }
};
struct MaxF {
  static constexpr bool kFloat = true;
  static __device__ __forceinline__ Acc id() { return identity(kMax, true); }
  static __device__ __forceinline__ Acc op(Acc a, Acc b) {
    return (isnan(b.f) || b.f > a.f) ? b : a;
  }
};

// Calls f(Op{}) with the Op of (kind, flt); kind is not kCount.
template <class F>
__device__ __forceinline__ void with_op(int kind, bool flt, F&& f) {
  if (kind == kSum) {
    if (flt) f(SumF{});
    else f(SumI{});
  } else if (kind == kMin) {
    if (flt) f(MinF{});
    else f(MinI{});
  } else if (flt) {
    f(MaxF{});
  } else {
    f(MaxI{});
  }
}

// -- warp-parallel tier -------------------------------------------------------

// One 32-row batch of one key space in sorted order: this lane holds the
// row of lane `src`; its key segment starts at lane `lo`.
struct Seg {
  int src;      // the lane whose row this lane holds
  int key;      // that row's key (meaningful where `tail`)
  bool live;    // that row counts
  bool tail;    // last lane of a live key's segment: it writes the total
  bool sorted;  // the rows moved (else src == lane on every lane)
  int lo;       // first lane of this lane's segment
  int steps;    // scan steps the longest segment needs (0..5)
};

// A batch with no live row: nothing moves, nothing is written.
__device__ __forceinline__ Seg empty_segments(int lane) {
  Seg s;
  s.src = lane;
  s.key = 0;
  s.live = false;
  s.tail = false;
  s.sorted = false;
  s.lo = 0;
  s.steps = 0;
  return s;
}

// `key` is in [0, 2^26) where `live`. Every lane of the warp calls this.
__device__ __forceinline__ Seg warp_segments(int key, bool live, int lane) {
  const unsigned lives = __ballot_sync(kFull, live);
  if (lives == 0) return empty_segments(lane);
  Seg s;
  const int k0 = __shfl_sync(kFull, key, __ffs(lives) - 1);
  if (__all_sync(kFull, !live || key == k0)) {
    // one key in the batch: no sort; dead rows fold their identities
    s.src = lane;
    s.key = k0;
    s.live = live;
    s.tail = lane == 31;
    s.sorted = false;
    s.lo = 0;
    s.steps = 5;
    return s;
  }
  // bitonic sort of (key << 5 | lane), dead rows last; every value is
  // distinct, so the sorted order is fixed
  unsigned v = live ? ((unsigned)key << 5) | (unsigned)lane
                    : 0xffffffe0u | (unsigned)lane;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned o = __shfl_xor_sync(kFull, v, j);
      const bool keep_min = ((lane & k) == 0) == ((lane & j) == 0);
      v = keep_min ? (o < v ? o : v) : (o > v ? o : v);
    }
  }
  const unsigned kv = v >> 5;
  const unsigned prev = __shfl_up_sync(kFull, kv, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || kv != prev);
  const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1u;
  const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
  s.src = (int)(v & 31u);
  s.key = (int)kv;
  s.live = v < 0xffffffe0u;
  s.tail = last && s.live;
  s.sorted = true;
  s.lo = 31 - __clz(heads & upto);
  const unsigned longest =
      __reduce_max_sync(kFull, last ? (unsigned)(lane - s.lo + 1) : 0u);
  s.steps = 32 - __clz(longest - 1u);     // ceil(log2(longest))
  return s;
}

// This lane's value moved to where the sort put its row.
__device__ __forceinline__ Acc to_sorted(const Seg& s, Acc v) {
  if (s.sorted) v.i = __shfl_sync(kFull, v.i, s.src);
  return v;
}

// Whether the row this lane holds after the sort has `ok`, from every
// lane's own `ok`.
__device__ __forceinline__ bool to_sorted(const Seg& s, bool ok) {
  const unsigned b = __ballot_sync(kFull, ok);
  return s.sorted ? (b >> s.src) & 1u : ok;
}

// Inclusive segmented scans of R batches in lockstep (R independent
// chains): the tail of each segment ends with the fold of its segment's
// values, in lane order.
template <class Op, int R>
__device__ __forceinline__ void seg_scan(const Seg (&s)[R], int lane,
                                         Acc (&x)[R]) {
  int steps = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) steps = s[r].steps > steps ? s[r].steps : steps;
  for (int i = 0, d = 1; i < steps; ++i, d <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Acc u;
      u.i = __shfl_up_sync(kFull, x[r].i, d);
      if (lane - d >= s[r].lo) x[r] = Op::op(u, x[r]);
    }
  }
}

// How many lanes of this lane's segment, up to this lane, have `ok` (the
// held row's).
__device__ __forceinline__ long long seg_count(const Seg& s, int lane,
                                               bool ok) {
  const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1u;
  return __popc(__ballot_sync(kFull, ok) & upto & ~((1u << s.lo) - 1u));
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

// Fold the warps' partials in warp order into this block's column of the
// slot-major `scratch` ([n_slots][n_blocks]).
template <class SlotKind>
__device__ void fold_warps(const Acc* warp_part, int n_slots,
                           const SlotKind& sk, Acc* __restrict__ scratch,
                           int n_blocks) {
  for (int idx = threadIdx.x; idx < n_slots; idx += kThreads) {
    int kind;
    bool flt;
    sk(idx, kind, flt);
    Acc acc = warp_part[idx];
    for (int w = 1; w < kWarps; ++w) {
      acc = combine(kind, flt, acc, warp_part[w * n_slots + idx]);
    }
    scratch[(long long)idx * n_blocks + blockIdx.x] = acc;
  }
}

// -- thread-private tier ------------------------------------------------------

// Set this thread's column of `part` ([n_slots][kThreads]) to identities.
template <class SlotKind>
__device__ void init_threads(Acc* part, int n_slots, const SlotKind& sk) {
  for (int s = 0; s < n_slots; ++s) {
    int kind;
    bool flt;
    sk(s, kind, flt);
    part[s * kThreads + threadIdx.x] = identity(kind, flt);
  }
}

// Fold the threads' partials slot by slot: warp w takes slots w, w + 8,
// ...; lane i folds threads i, i + 32, ... in order, then the shuffle tree.
template <class SlotKind>
__device__ void fold_threads(const Acc* part, int n_slots, const SlotKind& sk,
                             Acc* __restrict__ scratch, int n_blocks) {
  const int lane = threadIdx.x & 31;
  for (int s = threadIdx.x >> 5; s < n_slots; s += kWarps) {
    int kind;
    bool flt;
    sk(s, kind, flt);
    const Acc* row = part + s * kThreads;
    Acc acc = row[lane];
#pragma unroll
    for (int j = 1; j < kWarps; ++j) {
      acc = combine(kind, flt, acc, row[lane + 32 * j]);
    }
    acc = warp_tree(kind, flt, acc);
    if (lane == 0) scratch[(long long)s * n_blocks + blockIdx.x] = acc;
  }
}

// -- blocks -------------------------------------------------------------------

// Second launch, one warp per slot: lane i folds blocks i, i + 32, ... in
// order, then the shuffle tree. Launch ceil(n_slots / kWarps) blocks.
template <class SlotKind>
__device__ void fold_blocks(const Acc* __restrict__ scratch, int n_blocks,
                            int n_slots, const SlotKind& sk,
                            Acc* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int s = (int)((blockIdx.x * (long long)kThreads + threadIdx.x) >> 5);
  if (s >= n_slots) return;           // the whole warp leaves together
  int kind;
  bool flt;
  sk(s, kind, flt);
  const Acc* col = scratch + (long long)s * n_blocks;
  Acc acc = identity(kind, flt);
  for (int b = lane; b < n_blocks; b += 32) acc = combine(kind, flt, acc,
                                                          col[b]);
  acc = warp_tree(kind, flt, acc);
  if (lane == 0) out[s] = acc;
}

}  // namespace sdot_fold
