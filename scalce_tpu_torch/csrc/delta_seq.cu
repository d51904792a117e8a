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
// Bound on the H100: the bytes, about 48 MB per 262,144 x 128 block at
// the narrowest widths (the codes 33.5 MB, the [B] inputs, the outputs):
// 15 us at 3.35 TB/s; the integer work (about 40 operations per 16-column
// word) is a sixth of that.  So K7 streams: each code byte is read from
// device memory once, with every lane busy at any width.
// Design (W = L/16 packed words a row, any W up to 2047; the tile plan,
// R rows and G lanes a row, is ops/delta_seq.py::tile_plan):
//  - Launch 1, delta_seq_match_kernel: one CTA per tile of R consecutive
//    rows plus the 4 rows above it (the halo).  The tile's codes are one
//    contiguous byte range: coalesced 16-byte loads, neighbouring threads
//    on neighbouring chunks, each chunk packed into one 2-bit word in
//    shared memory; the rows' len, core and cp go there too, once.  A row
//    is served by G lanes (G the power of two >= min(W, 32): four rows a
//    warp at W = 8), looping over its words when W > G.  Each candidate's
//    shifted window is a funnel shift of two of its shared words; the
//    count is a popcount of the 2-bit equality mask restricted to the
//    columns the candidate can supply (the interval masks, not the zero
//    padding, since code 0 is A), summed over the group by shuffles.  The
//    winner's mask bits (one u16 store per word), shift, selector and
//    literal count go out, with the row's packed words into a scratch
//    [B, W] and zeros into the same range of lit_packed.
//  - Between: the wrapper's torch.cumsum of the literal counts gives each
//    row's end in the literal stream (the reference's own jnp.cumsum).
//  - Launch 2, delta_seq_place_kernel: one CTA per R rows reads the packed
//    words, the mask bits, len and the row ends (no code byte, no
//    predecessor), compacts each word's literals branch-free (a 5-step
//    bit compress), places them by a group prefix over the words' counts
//    into the CTA's output words in shared memory, and stores them: plain
//    stores but for the CTA's first and last word, which may be shared
//    with a neighbouring CTA (atomicOr into launch 1's zeros).
// Nothing here reads a device value on the host.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;             // threads per CTA, both launches
constexpr int kDeltaK = 4;                // candidates, and the halo rows
constexpr int kUnroll = 4;                // 16-byte loads in flight a thread
constexpr int kMaxSmem = 232448;          // what a CTA may take on sm_90
constexpr uint32_t kEven = 0x55555555u;   // the low bit of each 2-bit lane
constexpr unsigned kFull = 0xFFFFFFFFu;

// Four code bytes (b0 lowest, each in [0, 4)) -> b0 b1 b2 b3, 2 bits each,
// big-endian.
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return ((x & 3u) << 6) | ((x >> 4) & 0x30u) | ((x >> 14) & 0xCu) |
         ((x >> 24) & 3u);
}

// 16 codes -> one word, the first in the top bits
// (ops/bitops.py::pack_bases_u32).
__device__ __forceinline__ uint32_t pack16(uint4 v) {
  return pack4(v.x) << 24 | pack4(v.y) << 16 | pack4(v.z) << 8 | pack4(v.w);
}

// The top n (clamped to [0, 16]) 2-bit lanes of a word set.
__device__ __forceinline__ uint32_t lead_pairs(int n) {
  n = min(max(n, 0), 16);
  return n == 0 ? 0u : kFull << (32 - 2 * n);
}

// Word j of a shared row of W words, 0 outside [0, W).
__device__ __forceinline__ uint32_t word_at(const uint32_t* row, int j,
                                            int W) {
  return j >= 0 && j < W ? row[j] : 0u;
}

// One candidate: the predecessor's shared row, its shift (split into
// whole words and bits) and the interval [lo, hi) of columns it can
// supply.
struct Cand {
  const uint32_t* prev;
  int ws, bs, lo, hi;
};

__device__ __forceinline__ Cand make_cand(const uint32_t* prev, int shift,
                                          int len, int prev_len) {
  return {prev, shift >> 4, 2 * (shift & 15), max(-shift, 0),
          min(len, prev_len - shift)};
}

// The equality mask of word j (own word p): the low bit of lane c set
// where prev[16j + c + shift] == codes[16j + c], inside [lo, hi).
__device__ __forceinline__ uint32_t eq_mask(uint32_t p, const Cand& c, int j,
                                            int W) {
  uint32_t g = word_at(c.prev, j + c.ws, W);
  if (c.bs)
    g = (g << c.bs) | (word_at(c.prev, j + c.ws + 1, W) >> (32 - c.bs));
  const uint32_t x = g ^ p;
  return ~(x | (x >> 1)) & kEven & lead_pairs(c.hi - 16 * j) &
         ~lead_pairs(c.lo - 16 * j);
}

// An equality mask (low bits of the lanes) -> 16 column bits, LSB first.
__device__ __forceinline__ uint16_t mask16(uint32_t e) {
  uint32_t x = e;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  x = (x | (x >> 8)) & 0x0000FFFFu;
  return (uint16_t)(__brev(x) >> 16);
}

// The inverse: 16 column bits -> both bits of each copied lane.
__device__ __forceinline__ uint32_t lanes_of(uint16_t m) {
  uint32_t x = __brev((uint32_t)m) >> 16;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x | (x << 1);
}

// The bits of x under m moved to the low end, in order (Hacker's
// Delight's compress, five branch-free steps).
__device__ __forceinline__ uint32_t compress_bits(uint32_t x, uint32_t m) {
  x &= m;
  uint32_t mk = ~m << 1;                  // zeros to the right, counted
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    uint32_t mp = mk ^ (mk << 1);         // their parity, a prefix xor
    mp ^= mp << 2;
    mp ^= mp << 4;
    mp ^= mp << 8;
    mp ^= mp << 16;
    const uint32_t mv = mp & m;           // bits that move 2^i down
    m = (m ^ mv) | (mv >> (1 << i));
    const uint32_t t = x & mv;
    x = (x ^ t) | (t >> (1 << i));
    mk &= ~mp;
  }
  return x;
}

// The group reduction and prefix run over G aligned lanes of a warp
// (shuffles of width G); every loop around them is warp-uniform.
template <int G>
__device__ __forceinline__ int group_sum(int v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o, G);
  return v;
}

template <int G>
__global__ void __launch_bounds__(kThreads) delta_seq_match_kernel(
    const uint8_t* __restrict__ codes, const long long* __restrict__ len,
    const long long* __restrict__ ck, const long long* __restrict__ cp,
    int B, int W, int R, int n_reads, long long no_core,
    int16_t* __restrict__ shifts, uint8_t* __restrict__ pred_k,
    uint16_t* __restrict__ mask_bits, long long* __restrict__ lit_count,
    uint32_t* __restrict__ own, uint32_t* __restrict__ lit_packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = R + kDeltaK;              // tile rows with the halo
  long long* ck_s = reinterpret_cast<long long*>(smem);
  uint32_t* words = reinterpret_cast<uint32_t*>(ck_s + T);  // [T][W]
  int* len_s = reinterpret_cast<int*>(words + (long long)T * W);
  int* cp_s = len_s + T;
  // tile row t is row r0 - kDeltaK + t; rows above 0 or from B on are
  // absent, and no candidate reaches them
  const int r0 = blockIdx.x * R;
  const int t_lo = max(kDeltaK - r0, 0);
  const int t_hi = min(T, B - r0 + kDeltaK);
  const long long first = (long long)r0 - kDeltaK;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const bool in = t >= t_lo && t < t_hi;
    ck_s[t] = in ? ck[first + t] : no_core;
    len_s[t] = in ? (int)len[first + t] : 0;
    cp_s[t] = in ? (int)cp[first + t] : 0;
  }
  const uint4* src = reinterpret_cast<const uint4*>(codes);
  const long long c_first = first * W;    // chunk c of the tile is word c
  const int c_hi = t_hi * W;
  for (int c0 = t_lo * W + threadIdx.x; c0 < c_hi;
       c0 += kUnroll * kThreads) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      v[u] = c < c_hi ? __ldg(src + c_first + c) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      if (c < c_hi) words[c] = pack16(v[u]);
    }
  }
  __syncthreads();

  constexpr int kGroups = kThreads / G;
  const int lg = threadIdx.x & (G - 1), group = threadIdx.x / G;
  for (int i0 = 0; i0 < R; i0 += kGroups) {
    const int i = i0 + group;
    const long long r = (long long)r0 + i;
    const bool active = i < R && r < B;
    const int t = active ? i + kDeltaK : kDeltaK;   // a valid row if not
    const uint32_t* row = words + (long long)t * W;
    const int len_r = len_s[t];
    const long long core = ck_s[t];
    bool same[kDeltaK];
    int shift[kDeltaK], cnt[kDeltaK];
    Cand cand[kDeltaK];
#pragma unroll
    for (int k = 1; k <= kDeltaK; ++k) {
      same[k - 1] = active && r >= k && r < n_reads && core != no_core &&
                    ck_s[t - k] == core;
      shift[k - 1] = same[k - 1] ? cp_s[t - k] - cp_s[t] : 0;
      cand[k - 1] = make_cand(row - k * W, shift[k - 1], len_r,
                              same[k - 1] ? len_s[t - k] : 0);
      cnt[k - 1] = 0;
    }
    for (int j = lg; j < W; j += G) {
      const uint32_t p = row[j];
#pragma unroll
      for (int k = 0; k < kDeltaK; ++k)
        if (same[k]) cnt[k] += __popc(eq_mask(p, cand[k], j, W));
    }
    int best = -1, best_k = 0, best_shift = 0;
    Cand win = cand[0];
#pragma unroll
    for (int k = 0; k < kDeltaK; ++k) {
      const int c = group_sum<G>(cnt[k]);
      if (same[k] && c > best) {
        best = c;
        best_k = k;
        best_shift = shift[k];
        win = cand[k];
      }
    }
    if (!active) continue;
    const long long o = r * W;
    for (int j = lg; j < W; j += G) {
      const uint32_t p = row[j];
      mask_bits[o + j] = best >= 0 ? mask16(eq_mask(p, win, j, W)) : 0;
      own[o + j] = p;
      lit_packed[o + j] = 0;
    }
    if (lg == 0) {
      shifts[r] = (int16_t)best_shift;
      pred_k[r] = (uint8_t)best_k;
      lit_count[r] = len_r - max(best, 0);
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads) delta_seq_place_kernel(
    const uint32_t* __restrict__ own, const uint16_t* __restrict__ mask_bits,
    const long long* __restrict__ len, const long long* __restrict__ lit_count,
    const long long* __restrict__ lit_end, int B, int W, int R,
    uint32_t* __restrict__ lit_packed) {
  extern __shared__ uint32_t acc[];       // the CTA's output words
  const int r0 = blockIdx.x * R;
  const int r1 = min(r0 + R, B);
  const long long start = r0 ? lit_end[r0 - 1] : 0;
  const long long end = lit_end[r1 - 1];
  const long long q0 = start >> 4;
  const int nq = end > start ? (int)(((end - 1) >> 4) - q0 + 1) : 0;
  for (int i = threadIdx.x; i < nq; i += kThreads) acc[i] = 0;
  __syncthreads();

  constexpr int kGroups = kThreads / G;
  const int lg = threadIdx.x & (G - 1), group = threadIdx.x / G;
  for (int i0 = 0; i0 < R; i0 += kGroups) {
    const long long r = (long long)r0 + i0 + group;
    const bool active = r < r1;
    // the row's first literal, in 2-bit lanes from acc[0]
    int pos = active ? (int)(lit_end[r] - lit_count[r] - (q0 << 4)) : 0;
    const int len_r = active ? (int)len[r] : 0;
    for (int j0 = 0; j0 < W; j0 += G) {
      const int j = j0 + lg;
      uint32_t p = 0, lit = 0;
      if (active && j < W) {
        p = own[r * W + j];
        lit = lead_pairs(len_r - 16 * j) & ~lanes_of(mask_bits[r * W + j]);
      }
      const int wc = __popc(lit) >> 1;
      int incl = wc;                      // inclusive prefix over the group
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d, G);
        if (lg >= d) incl += v;
      }
      if (wc) {
        const uint32_t cw = compress_bits(p, lit) << (32 - 2 * wc);
        const int at = pos + incl - wc;
        const int q = at >> 4, s = 2 * (at & 15);
        atomicOr(&acc[q], cw >> s);
        if (s && s + 2 * wc > 32) atomicOr(&acc[q + 1], cw << (32 - s));
      }
      pos += __shfl_sync(kFull, incl, G - 1, G);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq; i += kThreads) {
    const bool shared = (i == 0 && (start & 15)) ||
                        (i == nq - 1 && (end & 15));
    if (shared)
      atomicOr(&lit_packed[q0 + i], acc[i]);
    else
      lit_packed[q0 + i] = acc[i];
  }
}

// f(std::integral_constant<int, G>) for G in {1, 2, 4, ..., 32}.
template <typename F>
int with_group(int G, F&& f) {
  switch (G) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The shared bytes of each launch (ops/delta_seq.py::tile_plan).
long long match_smem(int W, int R) {
  return (long long)(R + kDeltaK) * (4LL * W + 16);
}
long long place_smem(int W, int R) { return 4LL * ((long long)R * W + 1); }

bool bad_plan(int W, int R) {
  return W <= 0 || R <= 0 || match_smem(W, R) > kMaxSmem ||
         place_smem(W, R) > kMaxSmem;
}

}  // namespace

// codes u8 [B, 16W] (16-byte aligned rows, codes in [0, 4)); len, ck, cp
// int64 [B]; tiles of R rows, G lanes a row.  Writes shifts i16 [B],
// pred_k u8 [B], mask_bits u16 [B, W], lit_count i64 [B], own u32 [B, W]
// (the rows' packed words) and zeros into lit_packed u32 [B * W].
extern "C" int scalce_delta_match(const void* codes, const void* len,
                                  const void* ck, const void* cp, int B,
                                  int W, int R, int G, int n_reads,
                                  long long no_core, void* shifts,
                                  void* pred_k, void* mask_bits,
                                  void* lit_count, void* own,
                                  void* lit_packed, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (bad_plan(W, R)) return (int)cudaErrorInvalidValue;
  const int smem = (int)match_smem(W, R);
  return with_group(G, [&](auto g) {
    constexpr int kG = decltype(g)::value;
    cudaFuncSetAttribute(delta_seq_match_kernel<kG>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    delta_seq_match_kernel<kG><<<(B + R - 1) / R, kThreads, smem,
                                 (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const long long*)len, (const long long*)ck,
        (const long long*)cp, B, W, R, n_reads, no_core, (int16_t*)shifts,
        (uint8_t*)pred_k, (uint16_t*)mask_bits, (long long*)lit_count,
        (uint32_t*)own, (uint32_t*)lit_packed);
    return (int)cudaGetLastError();
  });
}

// The match launch's own words, mask bits and literal counts, len and
// lit_end (their inclusive cumsum) -> each row's
// literals at its place in lit_packed (zeroed by the match launch).
extern "C" int scalce_delta_place(const void* own, const void* mask_bits,
                                  const void* len, const void* lit_count,
                                  const void* lit_end, int B, int W, int R,
                                  int G, void* lit_packed, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (bad_plan(W, R)) return (int)cudaErrorInvalidValue;
  const int smem = (int)place_smem(W, R);
  return with_group(G, [&](auto g) {
    constexpr int kG = decltype(g)::value;
    cudaFuncSetAttribute(delta_seq_place_kernel<kG>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    delta_seq_place_kernel<kG><<<(B + R - 1) / R, kThreads, smem,
                                 (cudaStream_t)stream>>>(
        (const uint32_t*)own, (const uint16_t*)mask_bits,
        (const long long*)len, (const long long*)lit_count,
        (const long long*)lit_end, B, W, R, (uint32_t*)lit_packed);
    return (int)cudaGetLastError();
  });
}
