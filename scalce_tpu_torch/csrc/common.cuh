// Shared device helpers of the port's kernels (u32 bit utilities of
// scalce_tpu/ops/bitops.py, in native uint32_t arithmetic).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace scalce {

// murmur3-style finalizer: the implicit dictionary's k-mer ranking
// (scalce_tpu/ops/bitops.py::mix32).
__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x ^= seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Reverse the 16 2-bit lanes of a word (bitops.rev_lanes_u32): a bit
// reverse, then each lane's two bits swapped back.
__device__ __forceinline__ uint32_t rev_lanes(uint32_t v) {
  const uint32_t b = __brev(v);
  return ((b >> 1) & 0x55555555u) | ((b & 0x55555555u) << 1);
}

// Reverse complement of a 2-bit big-endian k-mer (core_match.revcomp_kmer).
__device__ __forceinline__ uint32_t revcomp(uint32_t v, int k) {
  return rev_lanes(~v) >> (32 - 2 * k);
}

// The rANS encoders' divide (K3, K5): x / f is a multiply-high by a
// reciprocal, exact for the state before the divide.
constexpr int kMaxF = 4096;   // the largest frequency (12-bit tables)

// ceil(2^44 / f) << 20 for 2 <= f <= 4096 (f = 1 wraps to 0: callers
// special-case it).
__device__ __forceinline__ unsigned long long recip_of(uint32_t f) {
  return ((((unsigned long long)1 << 44) + f - 1) / f) << 20;
}

// floor(x / f) for x < f << 20 (the encoder's state before the divide),
// given M = recip_of(f): floor(x * M / 2^64), from 32-bit halves of M.
__device__ __forceinline__ uint32_t div_recip(uint32_t x, uint32_t f,
                                              unsigned long long M) {
  const unsigned long long hi =
      (unsigned long long)x * (uint32_t)(M >> 32) + __umulhi(x, (uint32_t)M);
  return f == 1 ? x : (uint32_t)(hi >> 32);
}

// An L2 prefetch of the line holding p.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

}  // namespace scalce
