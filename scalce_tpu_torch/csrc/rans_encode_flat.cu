// K5: interleaved rANS encode of D blocks' grids, each block's cells
// against its own flat (f, cum) table.
//
// Replaces scalce_tpu/ops/rans_pallas.py::encode_scan_pallas (Mosaic
// kernel `_kernel`) together with what fed it: the reference's
// rans.rans_encode(sym, ctx, freq_lut, cum_lut, n_syms, T) over a group's
// stacked tables (streams/qualities.py::group_encode, the data-parallel
// pass B).  The D blocks' symbol and context grids are int64 (the low word
// holds the value) as stage B leaves them, `cells` cells per block, in
// n_lanes = D * cells / T lanes of T cells; lane n owns the flat cells
// n*T .. n*T + T - 1, all in block d = n*T / cells.  Each cell reads the
// packed table entry tab[(d * C + ctx) * n_syms + sym] = f << 16 | cum.
// Lane n walks t = T - 1 down to 0 with a u32 state starting at 2^16,
// emits the low 16 bits when (x >> 20) >= f, and sets
// x = ((x / f) << 12) + x % f + cum.  Words (as int16 holding the u16
// bits, the form K8 in rans.compact_emissions reads) and emit flags are
// written in [T, n_lanes] (decode order).  The kernel knows nothing of
// the quality context model.
//
// Bound on the H100: memory.  Per cell it reads the two int64 grids (16
// bytes) and writes a 2-byte word and a flag; a group of 4 blocks
// (262144 x 128 cells each) moves 2.5 GB, one block 0.64 GB.  The group's
// table (D * C * 94 u32, 1.1 MB at order 1) stays in L2 and L1.  The
// serial chain is T steps per lane, with 16,384 lanes per block: about
// one 128-thread CTA per SM for one block.  The words' 2-byte stores (64
// bytes a warp a step) slow that one-block launch against 4-byte ones,
// while a group's launch gains; K8 reads the narrower words, so the pair
// is faster either way (PERF.md §6-§7).  What the design does (K3's,
// csrc/rans_encode.cu, without its position-bucket tables):
//  - Each lane loads its cells 16 at a time from the int64 grids in
//    place (16-byte loads of two cells when T is even) one chunk ahead of
//    the chain, and asks L2 for the chunk four ahead, or one ahead when
//    so many lanes run (a group of 4 blocks: 65,536) that four chunks
//    each would not stay in L2 until their use.
//  - At most 128 registers a thread, so four 128-lane CTAs share an SM
//    and a group of 4 blocks runs in one wave; CTA b takes block
//    b % D's lanes, so an SM's CTAs mostly read one block's table.
//  - A chunk's table entries are looked up one chunk before the chain
//    reaches it: the lookups depend on the grids only, never on the state.
//  - x / f is a multiply-high by a reciprocal from a per-CTA shared table
//    M[f] = ceil(2^44 / f) << 20 (common.cuh), exact for x < f << 20.
//  - The row offset d * C and the index product happen here, so no
//    stacked context grid, index grid, gathered (f, cum) grids, transposes
//    or narrowing passes are built, and the words need no widening.
// The TPU's two corrected f32 divides are not carried over.

#include "common.cuh"

namespace {

constexpr int kChunk = 16;    // cells per lane per load
constexpr int kThreads = 128;
// L2 bytes the lanes' prefetched chunks may hold at once (of the 50 MB)
constexpr long long kPrefetchBudget = 24LL << 20;

// Low words of cells hi - 1, hi - 2, ..., lo of the lane whose first cell
// is `base` (index i holds cell hi - 1 - i).  kPairs: T is even, so base,
// lo and hi are even and cells pair into aligned 16-byte loads.
template <bool kPairs>
__device__ __forceinline__ void load_chunk(const uint32_t* __restrict__ g,
                                           size_t base, int lo, int hi,
                                           uint32_t (&v)[kChunk]) {
  const int cnt = hi - lo;
  if (kPairs) {
#pragma unroll
    for (int p = 0; p < kChunk / 2; ++p) {
      if (2 * p < cnt) {
        const uint4 q = __ldg((const uint4*)(g + 2 * (base + hi - 2 - 2 * p)));
        v[2 * p] = q.z;
        v[2 * p + 1] = q.x;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < cnt) v[i] = __ldg(g + 2 * (base + hi - 1 - i));
    }
  }
}

// The packed table entries of a chunk's cells (row = the block's table).
__device__ __forceinline__ void lookup(const uint32_t* __restrict__ row,
                                       int C, int S, int cnt,
                                       const uint32_t (&s)[kChunk],
                                       const uint32_t (&c)[kChunk],
                                       uint32_t (&e)[kChunk]) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (i < cnt) {
      const uint32_t ci = min(c[i], (uint32_t)(C - 1));
      const uint32_t si = min(s[i], (uint32_t)(S - 1));
      e[i] = __ldg(row + ci * S + si);
    }
  }
}

// kAhead: chunks between an L2 prefetch and its use.
template <bool kPairs, int kAhead>
__global__ void __launch_bounds__(kThreads, 4) rans_encode_flat_kernel(
    const uint32_t* __restrict__ sym, const uint32_t* __restrict__ ctx,
    const uint32_t* __restrict__ tab, int n_lanes, int T, long long cells,
    int C, int S, uint32_t* __restrict__ states, int16_t* __restrict__ words,
    uint8_t* __restrict__ emits) {
  __shared__ unsigned long long rcp[scalce::kMaxF + 1];
  for (int f = threadIdx.x; f <= scalce::kMaxF; f += blockDim.x)
    rcp[f] = f >= 2 ? scalce::recip_of(f) : 0ull;
  __syncthreads();
  // CTA b takes lanes of block b % D, so the CTAs that share an SM at
  // once (b, b + #SMs, ...) mostly share one block's table in L1
  const int N = (int)(cells / T), D = n_lanes / N;
  const int d = blockIdx.x % D;
  const int m = blockIdx.x / D * blockDim.x + threadIdx.x;
  if (m >= N) return;
  const int n = d * N + m;
  const size_t base = (size_t)n * T;
  const uint32_t* row = tab + (size_t)d * C * S;

  // chunk [lo, hi): the current one; [nlo, nhi): the next, whose grids
  // are in (s, c); [plo, phi): the one prefetched into L2
  int hi = T, lo = max(T - kChunk, 0);
  uint32_t s[kChunk], c[kChunk], e[kChunk], e_next[kChunk];
  load_chunk<kPairs>(sym, base, lo, hi, s);
  load_chunk<kPairs>(ctx, base, lo, hi, c);
  lookup(row, C, S, hi - lo, s, c, e);
  int nhi = lo, nlo = max(lo - kChunk, 0);
  if (nhi > 0) {
    load_chunk<kPairs>(sym, base, nlo, nhi, s);
    load_chunk<kPairs>(ctx, base, nlo, nhi, c);
  }
  int phi = nlo;
  for (int i = 1; i < kAhead && phi > 0; ++i) phi = max(phi - kChunk, 0);
  uint32_t x = 1u << 16;
  while (true) {
    if (nhi > 0) {
      lookup(row, C, S, nhi - nlo, s, c, e_next);
      const int n2hi = nlo, n2lo = max(nlo - kChunk, 0);
      if (n2hi > 0) {
        load_chunk<kPairs>(sym, base, n2lo, n2hi, s);
        load_chunk<kPairs>(ctx, base, n2lo, n2hi, c);
      }
    }
    if (phi > 0) {
      const int plo = max(phi - kChunk, 0);
      scalce::prefetch_l2(sym + 2 * (base + plo));
      scalce::prefetch_l2(sym + 2 * (base + phi - 1));
      scalce::prefetch_l2(ctx + 2 * (base + plo));
      scalce::prefetch_l2(ctx + 2 * (base + phi - 1));
      phi = plo;
    }
    const int cnt = hi - lo;
    unsigned long long M[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < cnt) M[i] = rcp[e[i] >> 16];
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < cnt) {
        const uint32_t f = e[i] >> 16;
        const size_t at = (size_t)(hi - 1 - i) * n_lanes + n;
        const bool emit = (x >> 20) >= f;
        words[at] = (int16_t)(x & 0xFFFFu);
        emits[at] = emit;
        if (emit) x >>= 16;
        const uint32_t q = scalce::div_recip(x, f, M[i]);
        x = (q << 12) + (x - q * f) + (e[i] & 0xFFFFu);
      }
    }
    if (lo == 0) break;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) e[i] = e_next[i];
    hi = nhi;
    lo = nlo;
    nhi = nlo;
    nlo = max(nlo - kChunk, 0);
  }
  states[n] = x;
}

}  // namespace

// sym, ctx: D blocks' grids as int64 (values below 2^32), `cells` cells per
// block, contiguous; tab u32 [D * C * n_syms], f << 16 | cum; T divides
// cells.  states u32 [n_lanes]; words int16 [T, n_lanes] (the u16 bits);
// emits u8 [T, n_lanes], n_lanes = D * cells / T.
extern "C" int scalce_rans_encode_flat(const void* sym, const void* ctx,
                                       const void* tab, int n_lanes, int T,
                                       long long cells, int C, int n_syms,
                                       void* states, void* words, void* emits,
                                       void* stream) {
  if (T < 1 || cells % T || C < 1 || n_syms < 1)
    return (int)cudaErrorInvalidValue;
  if (n_lanes <= 0) return (int)cudaGetLastError();
  const int N = (int)(cells / T);
  const int blocks = n_lanes / N * ((N + kThreads - 1) / kThreads);
  const uint32_t* g[3] = {(const uint32_t*)sym, (const uint32_t*)ctx,
                          (const uint32_t*)tab};
  cudaStream_t s = (cudaStream_t)stream;
  // prefetch 4 chunks ahead while every lane's prefetched lines (two
  // grids, 128 bytes each) fit the budget (one block: 16,384 lanes),
  // else 1: 4 ahead over a group of 4 blocks evicted lines before their
  // use
  const bool far = (long long)n_lanes * 4 * 256 <= kPrefetchBudget;
  auto k = T % 2 ? (far ? rans_encode_flat_kernel<false, 4>
                        : rans_encode_flat_kernel<false, 1>)
                 : (far ? rans_encode_flat_kernel<true, 4>
                        : rans_encode_flat_kernel<true, 1>);
  k<<<blocks, kThreads, 0, s>>>(g[0], g[1], g[2], n_lanes, T, cells, C,
                                n_syms, (uint32_t*)states, (int16_t*)words,
                                (uint8_t*)emits);
  return (int)cudaGetLastError();
}
