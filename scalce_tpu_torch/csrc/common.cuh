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

}  // namespace scalce
