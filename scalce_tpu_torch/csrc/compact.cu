// K8: per-lane compaction of interleaved rANS emissions.
//
// Replaces scalce_tpu/ops/rans.py::compact_emissions, which the reference
// compiles into its pass-B XLA jit (a minor-axis sort, no pallas_call).
// Input: the encoder's words (int16 holding the u16 bits, as K3 and K5
// write them) and emits (bool), both [T, N], step t of lane n at [t, n].
// Output: packed [N, T] as int16 holding the u16 bits (what the download
// takes), lane n's emitted words in step order at packed[n, :counts[n]]
// and zeros beyond; counts i32 [N].
//
// Bound on the H100: the bytes, the [T, N] words and emits read once and
// the [N, T] words written once (168 MB per 2048 x 16384 block: 0.050 ms
// at 3.35 TB/s).  The work per cell is a few integer operations, so the
// kernel has to keep enough bytes in flight, in whole sectors, to run
// near the HBM rate.  Design:
//  - A CTA takes a strip of 64 lanes and walks the T steps in chunks of
//    32 through a ring of kStages chunks in shared memory.  Its threads
//    fill a slot with cp.async 16-byte copies, a warp's 32 copies
//    covering 4 whole 128-byte rows of words or 8 rows of emits, and
//    each thread's copies arrive on the slot's `full` mbarrier as they
//    land.  A thread waits on `full` before it reads its row of a chunk,
//    then arrives on the slot's `empty` mbarrier; a slot is refilled once
//    `empty` completes.  No CTA-wide barrier stands between a chunk's
//    load and the next chunk's issue: while chunk c is compacted, chunks
//    c + 1 .. c + kStages - 1 are in flight.
//  - Each warp compacts 8 lanes, thread i taking step t0 + i: one
//    16-byte read of its words and an 8-byte read of its emits from the
//    ring (pieces swizzled so that a quarter-warp hits 8 bank groups);
//    per lane a ballot of the emits and a popcount below the thread give
//    each emitted word its slot after the lane's staged words.
//  - Each lane's emitted words are staged in shared memory and stored in
//    whole 32-byte sectors; after the last chunk its last sector (the
//    staged words, then zeros) and the zeros to T follow in 16-byte
//    stores, and its count: every output byte is written once, and the
//    L2 never holds a partly written sector.
//  - Strip, warp width and stages, from timings on the H100 at the main
//    block (T = 2048, N = 16384) and K5's group (N = 65536): emitted
//    words stored in place (2-byte stores into partly written sectors)
//    cost more than all the zeros; a ring per warp (16 lanes, 32-byte
//    pieces of rows) read slower than the CTA's shared ring of whole
//    rows; 8 lanes a warp beat 16 (twice the warps per SM for the
//    compaction, no spills); stages 4-8 differ by a few percent.
//    8 stages of 6 KB
//    and the 6 KB of staged words take 54 KB a CTA: 256 CTAs at
//    N = 16384, about 2 an SM with 84 KB in flight; 4 an SM at 65536.
//  - Other shapes (N % 16 != 0, T % 16 != 0, unaligned rows) take a
//    scalar path chosen at launch: the same ballots on registers loaded
//    element by element, lanes past N masked, words stored in place.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kStrip = 64;              // lanes per CTA
constexpr int kLanes = 8;               // lanes per warp
constexpr int kWarps = kStrip / kLanes;
constexpr int kSteps = 32;              // steps per chunk (one per thread)
constexpr int kStages = 8;              // chunks in the ring
constexpr int kPend = 48;               // staged words per lane (15 + 32)
constexpr int kTpl = 32 / kLanes;       // threads per lane in a flush
constexpr unsigned kFull = 0xFFFFFFFFu;

// One chunk of a CTA's strip: 32 steps of its 64 lanes, each row's
// 16-byte pieces swizzled so that the 8 threads of a quarter-warp
// reading one column of pieces from 8 rows hit 8 different groups of
// banks: words piece c of row r at c ^ (r & 7), emits piece c at
// c ^ ((r >> 1) & 3).
struct Chunk {
  uint4 w[kSteps][kStrip / 8];
  uint4 e[kSteps][kStrip / 16];
};

// A CTA's dynamic shared memory on the ring path: the ring, then each
// warp's staged words.
constexpr int kRingSmem =
    kStages * (int)sizeof(Chunk) + kWarps * kLanes * kPend * 2;

// A 16-byte copy into shared memory, zero-filled when !in.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (counted in the barrier's arrivals: .noinc).
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

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

// Lane j's emit flag and word in this thread's step of a chunk: words w
// (two per u32, lane j in the half j & 1 of w[j / 2]) and emit bytes e
// (lane j in byte j & 3 of e[j / 4]).
__device__ __forceinline__ bool emit_of(const uint32_t (&e)[kLanes / 4],
                                        int j) {
  return ((e[j >> 2] >> (8 * (j & 3))) & 0xFFu) != 0;
}

__device__ __forceinline__ int16_t word_of(const uint32_t (&w)[kLanes / 2],
                                           int j) {
  return (int16_t)(w[j >> 1] >> (16 * (j & 1)));
}

// The ring path (N % 16 == 0, T % 16 == 0, aligned rows): the CTA's
// strip from n_strip, warp w compacting lanes n0 = n_strip + 8 w.
// Chunk c lands in slot c % kStages.  Each lane's emitted words are
// staged after its pending ones (stage[j], at most 15 + 32), and every
// whole 32-byte sector of them is stored at once; `done` counts the
// words stored, `pend` those staged.  A warp whose lanes lie past N
// still copies and arrives, and compacts nothing.
__device__ __forceinline__ void compact_ring(
    const int16_t* __restrict__ words, const uint8_t* __restrict__ emits,
    int T, int N, int n_strip, int warp, int lane, Chunk* ring,
    uint64_t* full, uint64_t* empty, int16_t (*stage)[kPend],
    int16_t* __restrict__ packed, int* __restrict__ counts) {
  const int chunks = (T + kSteps - 1) / kSteps;
  const int tid = warp * 32 + lane;
  // copy chunk c into its slot once the slot's last chunk has been read;
  // pieces past T or N are zero fills from a clamped (valid) address
  auto issue = [&](int c) {
    const int s = c % kStages;
    if (c >= kStages) mbar_wait(&empty[s], (c / kStages + 1) & 1);
    Chunk& dst = ring[s];
#pragma unroll
    for (int p = tid; p < kSteps * kStrip / 8; p += kWarps * 32) {
      const int r = p / (kStrip / 8), col = p % (kStrip / 8);
      const int t = c * kSteps + r, n = n_strip + col * 8;
      cp_async16(&dst.w[r][col ^ (r & 7)],
                 words + (long long)min(t, T - 1) * N + min(n, N - 8),
                 t < T && n < N);
    }
#pragma unroll
    for (int p = tid; p < kSteps * kStrip / 16; p += kWarps * 32) {
      const int r = p / (kStrip / 16), col = p % (kStrip / 16);
      const int t = c * kSteps + r, n = n_strip + col * 16;
      cp_async16(&dst.e[r][col ^ ((r >> 1) & 3)],
                 emits + (long long)min(t, T - 1) * N + min(n, N - 16),
                 t < T && n < N);
    }
    mbar_arrive_copies(&full[s]);
  };
  for (int c = 0; c < min(kStages - 1, chunks); ++c) issue(c);
  const int n0 = n_strip + warp * kLanes;
  const bool live = n0 < N;   // warp-uniform; then all its lanes are
  const unsigned below = (1u << lane) - 1;
  // the kTpl threads of lane mj: thread `sub` flushes the lane's 16-byte
  // piece sub and moves piece sub of its remainder
  const int mj = lane / kTpl, sub = lane % kTpl;
  int16_t* const my_row = packed + (long long)(n0 + mj) * T;
  int done[kLanes], pend[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) done[j] = pend[j] = 0;
  for (int c = 0; c < chunks; ++c) {
    if (c + kStages - 1 < chunks) issue(c + kStages - 1);
    const int s = c % kStages;
    mbar_wait(&full[s], (c / kStages) & 1);   // chunk c has landed
    const Chunk& ch = ring[s];
    const uint4 wv = ch.w[lane][warp ^ (lane & 7)];
    const uint2 ev = reinterpret_cast<const uint2*>(
        &ch.e[lane][(warp >> 1) ^ ((lane >> 1) & 3)])[warp & 1];
    mbar_arrive(&empty[s]);
    if (!live) continue;
    const uint32_t w[kLanes / 2] = {wv.x, wv.y, wv.z, wv.w};
    const uint32_t e[kLanes / 4] = {ev.x, ev.y};
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const bool emit = emit_of(e, j);
      const unsigned bal = __ballot_sync(kFull, emit);
      if (emit) stage[j][pend[j] + __popc(bal & below)] = word_of(w, j);
      pend[j] += __popc(bal);
    }
    int my_pend = 0, my_done = 0;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      if (mj == j) my_pend = pend[j], my_done = done[j];
    }
    __syncwarp();
    // whole sectors staged: 0, 1 or 2 (pieces 0 .. 2q - 1)
    const int q = my_pend >> 4;
    uint4* const src = reinterpret_cast<uint4*>(stage[mj]);
    uint4 out = {}, rest = {};
    if (sub < 2 * q) out = src[sub];
    if (sub < 2) rest = src[2 * q + sub];
    __syncwarp();
    if (sub < 2 * q) reinterpret_cast<uint4*>(my_row + my_done)[sub] = out;
    if (q && sub < 2) src[sub] = rest;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int whole = pend[j] & ~15;
      done[j] += whole;
      pend[j] -= whole;
    }
  }
  if (!live) return;
  // the last sector: the staged words, then zeros; then zeros to T
  int my_pend = 0, my_done = 0;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    if (mj == j) my_pend = pend[j], my_done = done[j];
  }
  if (my_done < T && sub < 2) {
    uint32_t v[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = 8 * sub + 2 * x;
      const uint32_t lo = i < my_pend ? (uint16_t)stage[mj][i] : 0u;
      const uint32_t hi = i + 1 < my_pend ? (uint16_t)stage[mj][i + 1] : 0u;
      v[x] = lo | hi << 16;
    }
    reinterpret_cast<uint4*>(my_row + my_done)[sub] =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  if (sub == 0) counts[n0 + mj] = my_done + my_pend;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const long long row = (long long)(n0 + j) * T;
    if (done[j] < T) zero_range(packed, row + done[j] + 16, row + T, lane);
  }
}

// The scalar path: the warp's lanes from n0 (those past N masked), loaded
// element by element, emitted words stored in place.
__device__ __forceinline__ void compact_scalar(
    const int16_t* __restrict__ words, const uint8_t* __restrict__ emits,
    int T, int N, int n0, int lane, int16_t* __restrict__ packed,
    int* __restrict__ counts) {
  const unsigned below = (1u << lane) - 1;
  int count[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) count[j] = 0;
  for (int t0 = 0; t0 < T; t0 += kSteps) {
    const int t = t0 + lane;
    uint32_t w[kLanes / 2] = {}, e[kLanes / 4] = {};
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      if (t < T && n0 + j < N) {
        const long long at = (long long)t * N + n0 + j;
        w[j >> 1] |= (uint32_t)(uint16_t)__ldg(words + at) << (16 * (j & 1));
        e[j >> 2] |= (uint32_t)(__ldg(emits + at) != 0) << (8 * (j & 3));
      }
    }
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const bool emit = emit_of(e, j);
      const unsigned bal = __ballot_sync(kFull, emit);
      if (emit)
        packed[(long long)(n0 + j) * T + count[j] + __popc(bal & below)] =
            word_of(w, j);
      count[j] += __popc(bal);
    }
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int n = n0 + j;
    if (n < N) {   // warp-uniform
      zero_range(packed, (long long)n * T + count[j], (long long)(n + 1) * T,
                 lane);
      if (lane == j) counts[n] = count[j];
    }
  }
}

template <bool kRing>
__global__ void __launch_bounds__(kWarps * 32) compact_kernel(
    const int16_t* __restrict__ words, const uint8_t* __restrict__ emits,
    int T, int N, int16_t* __restrict__ packed, int* __restrict__ counts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_strip = blockIdx.x * kStrip;
  if constexpr (kRing) {
    extern __shared__ uint4 smem[];   // kRingSmem bytes
    Chunk* ring = reinterpret_cast<Chunk*>(smem);
    auto stage = reinterpret_cast<int16_t(*)[kLanes][kPend]>(ring + kStages);
    __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
    if (threadIdx.x < kStages) {
      mbar_init(&full[threadIdx.x], kWarps * 32);
      mbar_init(&empty[threadIdx.x], kWarps * 32);
    }
    __syncthreads();   // the barriers, once
    compact_ring(words, emits, T, N, n_strip, warp, lane, ring, full, empty,
                 stage[warp], packed, counts);
  } else {
    const int n0 = n_strip + warp * kLanes;
    if (n0 < N)   // warp-uniform
      compact_scalar(words, emits, T, N, n0, lane, packed, counts);
  }
}

}  // namespace

// words int16 [T, N] (the u16 bits), emits bool [T, N]; packed int16
// [N, T], counts i32 [N].  16-byte aligned input rows and 32-byte aligned
// output rows (N % 16 == 0, T % 16 == 0) take the ring, other shapes the
// scalar path.
extern "C" int scalce_compact(const void* words, const void* emits, int T,
                              int N, void* packed, void* counts,
                              void* stream) {
  if (N <= 0 || T <= 0) return (int)cudaGetLastError();
  const bool ring = N % 16 == 0 && T % 16 == 0 &&
                    (uintptr_t)words % 16 == 0 && (uintptr_t)emits % 16 == 0 &&
                    (uintptr_t)packed % 32 == 0;
  auto k = ring ? compact_kernel<true> : compact_kernel<false>;
  const int smem = ring ? kRingSmem : 0;
  if (ring)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  k<<<(N + kStrip - 1) / kStrip, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const int16_t*)words, (const uint8_t*)emits, T, N, (int16_t*)packed,
      (int*)counts);
  return (int)cudaGetLastError();
}
