// K8: per-lane compaction of interleaved rANS emissions.
//
// Replaces scalce_tpu/ops/rans.py::compact_emissions, which the reference
// compiles into its pass-B XLA jit (a minor-axis sort, no pallas_call).
// Input: the encoder's words (u16 values in int32) and emits (bool), both
// [T, N], step t of lane n at [t, n] (K3's and K5's outputs as they are).
// Output: packed [N, T] as int16 holding the u16 bits (what the download
// takes), lane n's emitted words in step order at packed[n, :counts[n]]
// and zeros beyond; counts i32 [N].
//
// Bound on the H100: the bytes, the [T, N] words and emits read once and
// the [N, T] int16 words written once (235 MB per 2048 x 16384 block:
// 0.07 ms at 3.35 TB/s).  Design:
//  - A CTA takes 32 lanes and walks the T steps in chunks of 32: its
//    threads read the chunk's [32 steps, 32 lanes] tile of words and
//    emits coalesced along N into shared memory.
//  - A warp then takes one lane of the tile at a time, thread i on step
//    t0 + i (the transpose): a ballot of the emits and a popcount below
//    the thread give each emitted word its slot after the lane's running
//    count, so the warp's stores into the lane's [N, T] row are
//    contiguous.
//  - After the last chunk the warp zeroes the lane's row from its count
//    to T, 16 bytes a store where aligned.

#include "common.cuh"

namespace {

constexpr int kLanes = 32;    // lanes per CTA
constexpr int kSteps = 32;    // steps per chunk (one per thread of a warp)
constexpr int kWarps = 8;
constexpr int kPerWarp = kLanes / kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Zero out[a, b) with the 32 threads of a warp.
__device__ __forceinline__ void zero_range(int16_t* out, long long a,
                                           long long b, int lane) {
  const long long a8 = min(b, (a + 7) & ~7LL);
  const long long b8 = max(a8, b & ~7LL);
  for (long long i = a + lane; i < a8; i += 32) out[i] = 0;
  uint4* v = reinterpret_cast<uint4*>(out);
  for (long long i = a8 / 8 + lane; i < b8 / 8; i += 32)
    v[i] = make_uint4(0, 0, 0, 0);
  for (long long i = b8 + lane; i < b; i += 32) out[i] = 0;
}

__global__ void __launch_bounds__(kWarps * 32) compact_kernel(
    const int* __restrict__ words, const uint8_t* __restrict__ emits, int T,
    int N, int16_t* __restrict__ packed, int* __restrict__ counts) {
  __shared__ int word_s[kSteps][kLanes + 1];
  __shared__ uint8_t emit_s[kSteps][kLanes + 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kLanes;
  int count[kPerWarp] = {};   // running counts of lanes warp + kWarps * m
  for (int t0 = 0; t0 < T; t0 += kSteps) {
    for (int i = threadIdx.x; i < kSteps * kLanes; i += kWarps * 32) {
      const int s = i / kLanes, l = i % kLanes;
      const int t = t0 + s, n = n0 + l;
      const bool in = t < T && n < N;
      const long long at = (long long)t * N + n;
      word_s[s][l] = in ? __ldg(words + at) : 0;
      emit_s[s][l] = in ? __ldg(emits + at) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kPerWarp; ++m) {
      const int l = warp + kWarps * m, n = n0 + l;
      const bool e = emit_s[lane][l] != 0;
      const unsigned bal = __ballot_sync(kFull, e);
      if (e)   // no emit lies past N or T (zero-filled above)
        packed[(long long)n * T + count[m] +
               __popc(bal & ((1u << lane) - 1))] = (int16_t)word_s[lane][l];
      count[m] += __popc(bal);
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < kPerWarp; ++m) {
    const int n = n0 + warp + kWarps * m;
    if (n >= N) continue;
    zero_range(packed, (long long)n * T + count[m], (long long)(n + 1) * T,
               lane);
    if (lane == 0) counts[n] = count[m];
  }
}

}  // namespace

// words int32 [T, N] (u16 values), emits bool [T, N]; packed int16 [N, T]
// (16-byte aligned), counts i32 [N].
extern "C" int scalce_compact(const void* words, const void* emits, int T,
                              int N, void* packed, void* counts,
                              void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  compact_kernel<<<(N + kLanes - 1) / kLanes, kWarps * 32, 0,
                   (cudaStream_t)stream>>>(
      (const int*)words, (const uint8_t*)emits, T, N, (int16_t*)packed,
      (int*)counts);
  return (int)cudaGetLastError();
}
