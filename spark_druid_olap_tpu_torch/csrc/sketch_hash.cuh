// The theta sketch's hash, shared by the wave kernel's in-kernel theta
// stripe (wave.cu) and the CPU tests, which build this header with the host
// compiler and hold it bit for bit against ops/theta.py:_hash01 and the JAX
// package's spark_druid_olap_tpu/ops/theta.py:_hash01.
//
// _hash01(v, j): the value's low 32 bits v (uint32, as astype(uint32) takes
// them: an int32 or int64 two's complement, a float32's bits) times
// 0x9E3779B1, xor (0x85EBCA6B * (2 j + 1)) mod 2^32, two murmur3 rounds,
// then float32(h >> 8) * 2^-24 + 1e-7 in float32 — a uniform (0, 1] value
// per hash lane j. h >> 8 < 2^24 converts exactly, the multiply by 2^-24
// is exact, and the add is one correctly rounded float32 add (__fadd_rn on
// the device, never contracted; the host build uses -ffp-contract=off).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SDOT_SKETCH_HD __host__ __device__ __forceinline__
#else
#define SDOT_SKETCH_HD inline
#endif

namespace sdot_sketch {

constexpr int kThetaLanes = 64;      // ops/theta.py:K_LANES

SDOT_SKETCH_HD uint32_t mix32(uint32_t h) {
  h = (h ^ (h >> 16)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// v * 0x9E3779B1 (mod 2^32): the part of the hash shared by every lane.
SDOT_SKETCH_HD uint32_t theta_base(uint32_t v) { return v * 0x9E3779B1u; }

// The hash of lane j from theta_base(v).
SDOT_SKETCH_HD float theta_hash01(uint32_t base, int j) {
  const uint32_t seed = 0x85EBCA6Bu * (2u * (uint32_t)j + 1u);
  const uint32_t h = mix32(base ^ seed);
  const float f = (float)(h >> 8);
#if defined(__CUDA_ARCH__)
  return __fadd_rn(__fmul_rn(f, 5.9604644775390625e-08f), 1e-7f);
#else
  return f * 5.9604644775390625e-08f + 1e-7f;
#endif
}

}  // namespace sdot_sketch
