// K7: the aligned-predecessor delta of a sorted block.
//
// Replaces scalce_tpu/pipeline/encode.py::_delta_seq, which the reference
// compiles into its stage-B XLA jit (no pallas_call).  Row r of the sorted
// block matches against the best of rows r-1 .. r-4: a candidate r-k
// counts only if it has r's core (not NO_CORE), r >= k and r < n_reads;
// the shift is cp[r-k] - cp[r], and its count is the number of columns c
// in [max(-shift, 0), min(len[r], len[r-k] - shift)) where
// codes[r-k][c + shift] == codes[r][c].  The winner has the strictly
// larger count (a tie keeps the nearer row).  Outputs: shifts i16 [B],
// pred_k u8 [B] (winner k - 1), mask_bits u8 [B, L/8] (copied columns,
// LSB-first), and lit_packed (the other valid columns' codes, compacted
// row-major, 2-bit big-endian in u32 words, zero beyond).
//
// Bound on the H100: the bytes, about 53 MB per 262,144 x 128 block
// (the codes 33.5 MB, the [B] inputs, the outputs): 16 us at 3.35 TB/s.
// Design (a simple one that is right at every width up to L = 32752, W =
// L/16 words per row; it is not yet near the bound):
//  - One warp per row, the lanes over the row's W words, 32 at a time: no
//    row lives in registers, so any W works.  Each lane packs its 2-bit
//    words from 16 code bytes (one 16-byte load); a predecessor's words
//    are read the same way from its row (adjacent rows: L1 and L2 hits).
//  - The shifted window is a funnel shift of two predecessor words; the
//    count is a popcount of the 2-bit equality mask restricted to the
//    candidate's interval, summed over the warp (__reduce_add_sync).  The
//    interval masks, not the zero padding (code 0 is A), keep columns
//    outside the predecessor from matching.
//  - Launch 1 (count) writes shifts, pred_k and each row's literal count
//    (len - matched).  The wrapper's torch.cumsum over the B counts gives
//    each row's end in the literal stream (the reference's own
//    jnp.cumsum).  Launch 2 (emit) rebuilds the winner's mask, writes the
//    mask bits (16 columns per lane, one u16 store), compacts each word's
//    literals to the top of a word, places it at the row's 2-bit offset
//    by a warp prefix over the per-word counts into the row's words in
//    shared memory, and stores them: plain stores, but atomicOr on the at
//    most two boundary words the row shares with its neighbours (into a
//    zeroed lit_packed).
// Nothing here reads a device value on the host.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;                 // rows per CTA, one warp each
constexpr int kDeltaK = 4;                // candidate predecessors
constexpr uint32_t kEven = 0x55555555u;   // the low bit of each 2-bit lane
constexpr unsigned kFull = 0xFFFFFFFFu;

// Four code bytes (b0 lowest, each in [0, 4)) -> b0 b1 b2 b3, 2 bits each,
// big-endian.
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return ((x & 3u) << 6) | ((x >> 4) & 0x30u) | ((x >> 14) & 0xCu) |
         ((x >> 24) & 3u);
}

// Word j of a row of W words (16 codes, first in the top bits), 0
// outside [0, W): ops/bitops.py::pack_bases_u32.
__device__ __forceinline__ uint32_t packed_word(const uint8_t* row, int j,
                                                int W) {
  if (j < 0 || j >= W) return 0;
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(row) + j);
  return pack4(v.x) << 24 | pack4(v.y) << 16 | pack4(v.z) << 8 | pack4(v.w);
}

// The top n (clamped to [0, 16]) 2-bit lanes of a word set.
__device__ __forceinline__ uint32_t lead_pairs(int n) {
  n = min(max(n, 0), 16);
  return n == 0 ? 0u : kFull << (32 - 2 * n);
}

// One candidate: the predecessor row, its shift (split into whole words
// and bits) and the interval [lo, hi) of columns it can supply.
struct Cand {
  const uint8_t* prev;
  int ws, bs, lo, hi;
};

__device__ __forceinline__ Cand make_cand(const uint8_t* prev, int shift,
                                          int len, int prev_len) {
  return {prev, shift >> 4, 2 * (shift & 15), max(-shift, 0),
          min(len, prev_len - shift)};
}

// The equality mask of word j (own packed word p): the low bit of lane c
// set where prev[16j + c + shift] == codes[16j + c], inside [lo, hi).
__device__ __forceinline__ uint32_t eq_mask(uint32_t p, const Cand& c, int j,
                                            int W) {
  uint32_t g = packed_word(c.prev, j + c.ws, W);
  if (c.bs) g = (g << c.bs) | (packed_word(c.prev, j + c.ws + 1, W) >>
                               (32 - c.bs));
  const uint32_t x = g ^ p;
  return ~(x | (x >> 1)) & kEven & lead_pairs(c.hi - 16 * j) &
         ~lead_pairs(c.lo - 16 * j);
}

// Row r's candidate k qualifies (warp-uniform).
__device__ __forceinline__ bool same_core(const long long* ck, int r, int k,
                                          int n_reads, long long no_core) {
  if (r < k || r >= n_reads) return false;
  const long long core = ck[r];
  return core != no_core && ck[r - k] == core;
}

__global__ void __launch_bounds__(kWarps * 32) delta_seq_count_kernel(
    const uint8_t* __restrict__ codes, const long long* __restrict__ len,
    const long long* __restrict__ ck, int B, int W, int n_reads,
    long long no_core, const long long* __restrict__ cp,
    int16_t* __restrict__ shifts, uint8_t* __restrict__ pred_k,
    int* __restrict__ lit_count) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= B) return;                     // the whole warp
  const long long L = 16LL * W;
  const uint8_t* row = codes + r * L;
  const int len_r = (int)len[r];
  bool same[kDeltaK];
  int shift[kDeltaK], cnt[kDeltaK];
  Cand cand[kDeltaK];
#pragma unroll
  for (int k = 1; k <= kDeltaK; ++k) {
    same[k - 1] = same_core(ck, r, k, n_reads, no_core);
    shift[k - 1] = same[k - 1] ? (int)(cp[r - k] - cp[r]) : 0;
    cand[k - 1] = make_cand(row - k * L, shift[k - 1], len_r,
                            same[k - 1] ? (int)len[r - k] : 0);
    cnt[k - 1] = 0;
  }
  for (int j = lane; j - lane < W; j += 32) {
    if (j >= W) continue;
    const uint32_t p = packed_word(row, j, W);
#pragma unroll
    for (int k = 0; k < kDeltaK; ++k)
      if (same[k]) cnt[k] += __popc(eq_mask(p, cand[k], j, W));
  }
  int best = -1, best_k = 0, best_shift = 0;
#pragma unroll
  for (int k = 0; k < kDeltaK; ++k) {
    const int c = same[k] ? (int)__reduce_add_sync(kFull, cnt[k]) : -1;
    if (c > best) {
      best = c;
      best_k = k;
      best_shift = shift[k];
    }
  }
  if (lane == 0) {
    shifts[r] = (int16_t)best_shift;
    pred_k[r] = (uint8_t)best_k;
    lit_count[r] = len_r - max(best, 0);
  }
}

__global__ void __launch_bounds__(kWarps * 32) delta_seq_emit_kernel(
    const uint8_t* __restrict__ codes, const long long* __restrict__ len,
    const long long* __restrict__ ck, int B, int W, int n_reads,
    long long no_core, const int16_t* __restrict__ shifts,
    const uint8_t* __restrict__ pred_k, const int* __restrict__ lit_count,
    const long long* __restrict__ lit_end, uint8_t* __restrict__ mask_bits,
    uint32_t* __restrict__ lit_packed) {
  extern __shared__ uint32_t words_s[];   // kWarps x (W + 2)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= B) return;                     // the whole warp
  const long long L = 16LL * W;
  const uint8_t* row = codes + r * L;
  const int len_r = (int)len[r];
  const int k = pred_k[r] + 1;
  // the winner's candidate qualifies iff the row has a predecessor at all
  // (with none, pred_k is 0 and r - 1 does not qualify)
  const bool ok = same_core(ck, r, k, n_reads, no_core);
  const Cand cand = make_cand(row - k * L, shifts[r], len_r,
                              ok ? (int)len[r - k] : 0);
  const long long end = lit_end[r];
  const int count = lit_count[r];
  const long long start = end - count;
  const long long q0 = start >> 4;        // the row's first output word
  const int nq = count ? (int)(((end - 1) >> 4) - q0 + 1) : 0;
  uint32_t* acc = words_s + warp * (W + 2);
  for (int i = lane; i < nq; i += 32) acc[i] = 0;
  __syncwarp();
  uint16_t* mrow = reinterpret_cast<uint16_t*>(mask_bits + r * 2LL * W);
  int before = (int)(start & 15);         // 2-bit lanes before this chunk
  for (int j = lane; j - lane < W; j += 32) {
    uint32_t p = 0, e = 0;
    if (j < W) {
      p = packed_word(row, j, W);
      if (ok) e = eq_mask(p, cand, j, W);
      // columns 16j .. 16j + 15 as bits 0 .. 15
      uint32_t x = e;
      x = (x | (x >> 1)) & 0x33333333u;
      x = (x | (x >> 2)) & 0x0F0F0F0Fu;
      x = (x | (x >> 4)) & 0x00FF00FFu;
      x = (x | (x >> 8)) & 0x0000FFFFu;
      mrow[j] = (uint16_t)(__brev(x) >> 16);
    }
    // literals: valid columns not copied, compacted to the word's top
    const uint32_t lit = j < W ? lead_pairs(len_r - 16 * j) & ~(e | (e << 1))
                               : 0u;
    const int wc = __popc(lit) >> 1;
    uint32_t cw = 0;
    for (uint32_t m = lit & 0xAAAAAAAAu; m; ) {
      const int b = 31 - __clz(m);
      cw = (cw << 2) | ((p >> (b - 1)) & 3u);
      m &= ~(1u << b);
    }
    cw = wc ? cw << (32 - 2 * wc) : 0u;
    int incl = wc;                        // inclusive prefix over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (wc) {
      const int pos = before + incl - wc;
      const int q = pos >> 4, s = 2 * (pos & 15);
      atomicOr(&acc[q], cw >> s);
      if (s && s + 2 * wc > 32) atomicOr(&acc[q + 1], cw << (32 - s));
    }
    before += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();
  for (int i = lane; i < nq; i += 32) {
    const bool shared = (i == 0 && (start & 15)) ||
                        (i == nq - 1 && (end & 15));
    if (shared)
      atomicOr(&lit_packed[q0 + i], acc[i]);
    else
      lit_packed[q0 + i] = acc[i];
  }
}

int grid_of(int B) { return (B + kWarps - 1) / kWarps; }

}  // namespace

// codes u8 [B, 16W] (16-byte aligned rows, codes in [0, 4)); len, ck, cp
// int64 [B]; shifts i16 [B], pred_k u8 [B], lit_count i32 [B] written.
extern "C" int scalce_delta_count(const void* codes, const void* len,
                                  const void* ck, int B, int W, int n_reads,
                                  long long no_core, const void* cp,
                                  void* shifts, void* pred_k, void* lit_count,
                                  void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (W <= 0) return (int)cudaErrorInvalidValue;
  delta_seq_count_kernel<<<grid_of(B), kWarps * 32, 0,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const long long*)len, (const long long*)ck, B,
      W, n_reads, no_core, (const long long*)cp, (int16_t*)shifts,
      (uint8_t*)pred_k, (int*)lit_count);
  return (int)cudaGetLastError();
}

// The count launch's outputs and lit_end (the inclusive cumsum of
// lit_count, int64) -> mask_bits u8 [B, 2W] and lit_packed u32 [B * W]
// (zeroed by the caller).
extern "C" int scalce_delta_emit(const void* codes, const void* len,
                                 const void* ck, int B, int W, int n_reads,
                                 long long no_core, const void* shifts,
                                 const void* pred_k, const void* lit_count,
                                 const void* lit_end, void* mask_bits,
                                 void* lit_packed, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (W <= 0) return (int)cudaErrorInvalidValue;
  const int smem = kWarps * (W + 2) * (int)sizeof(uint32_t);
  cudaFuncSetAttribute(delta_seq_emit_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  delta_seq_emit_kernel<<<grid_of(B), kWarps * 32, smem,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const long long*)len, (const long long*)ck, B,
      W, n_reads, no_core, (const int16_t*)shifts, (const uint8_t*)pred_k,
      (const int*)lit_count, (const long long*)lit_end, (uint8_t*)mask_bits,
      (uint32_t*)lit_packed);
  return (int)cudaGetLastError();
}
