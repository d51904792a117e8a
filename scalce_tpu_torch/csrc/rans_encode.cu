// K3: interleaved rANS encode of a block's quality grid.
//
// Replaces scalce_tpu/ops/rans_pallas.py::encode_scan_tbl_pallas (Mosaic
// kernel `_kernel_tbl`).  Lane n owns the flat cells n*T .. n*T + T - 1 of
// the [B, L] symbol and context grids and walks them from t = T - 1 down
// to 0 with a u32 state starting at 2^16; each step looks up (f, cum) at
// (ctx, sym), emits the low 16 bits when (x >> 20) >= f, and sets
// x = ((x / f) << 12) + x % f + cum.  Words (as int16 holding the u16
// bits, the form K8 reads and the download takes) and emit flags are
// written in [T, N] (decode order); K8 (compact.cu) compacts them.
//
// Bound on the H100: reading the two int64 grids as stage B leaves them
// (2 x 8 bytes per cell; the low word holds the value) and writing the
// words and flags: memory, with only N = 16384 lanes of T = 2048 serial
// steps each (about one 128-thread CTA per SM).  What the design does:
//  - The table lookups depend on the inputs only, never on the state, so
//    they leave the serial chain.  The table lives in shared memory as u16
//    cumulative-frequency rows (96 per row: 94 exclusive cums, the total,
//    a pad; f is the difference of neighbours), each position bucket
//    transposed (entry-major) so that the lanes' reads of different rows
//    fall in different banks.  When every row a read
//    reaches fits (order 1: 761 rows, 146 KB) it is staged once;
//    otherwise (orders 2 and 3) the padding row stays staged and, since
//    all lanes sit at the same column at each step, one position bucket's
//    R rows at a time, double-buffered with cp.async while the current
//    bucket encodes (walking t down), one __syncthreads() per bucket.
//  - Each lane loads its next chunk of up to 16 cells (16-byte loads of
//    two cells when L is even) while it encodes the current one, and asks
//    L2 for the chunk four ahead; the current chunk's (f, cum) and
//    reciprocals are read from shared memory before its chain starts.
//    The chain per step is the renorm and the state update.
//  - x / f is a multiply-high by a reciprocal from a per-CTA shared table
//    M[f] = ceil(2^44 / f) << 20 (f = 1 special-cased): before the divide
//    x < f << 20 <= 2^32, so floor(x * M / 2^64) is exact.
//  - The grids are read as stage B leaves them: no narrowing pass.

#include "common.cuh"

namespace {

constexpr int kNSyms = 94;
constexpr int kRow = 96;      // u16 per staged row
constexpr int kChunk = 16;    // cells per lane per load
constexpr int kAhead = 4;     // chunks between an L2 prefetch and its use
constexpr int kRcpBytes = (scalce::kMaxF + 1) * 8;
constexpr int kSmemMax = 200 * 1024;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Entries [first, first + count) of the u16 table into `dst` (cp.async,
// uncommitted; both multiples of 8).
__device__ __forceinline__ void stage(uint16_t* dst, const uint16_t* tab,
                                      int first, int count) {
  const uint16_t* src = tab + first;
  for (int i = threadIdx.x; i < count / 8; i += blockDim.x)
    cp_async16(dst + 8 * i, src + 8 * i);
}

}  // namespace

namespace {

// Chunk c of the lane's walk: cells [lo, hi) of read j (columns), inside
// position bucket m, visited from hi - 1 down.
struct Chunk {
  int j, m, lo, hi;
};

__device__ __forceinline__ int seg_lo(int m, int cw) { return m * cw; }

__device__ __forceinline__ int seg_hi(int m, int nseg, int cw, int L) {
  return m == nseg - 1 ? L : min((m + 1) * cw, L);
}

__device__ __forceinline__ Chunk first_chunk(int k, int nseg, int cw,
                                             int L) {
  Chunk c;
  c.j = k - 1;
  c.m = nseg - 1;
  c.hi = seg_hi(c.m, nseg, cw, L);
  c.lo = max(seg_lo(c.m, cw), c.hi - kChunk);
  return c;
}

__device__ __forceinline__ Chunk next_chunk(Chunk c, int nseg, int cw,
                                            int L) {
  if (c.lo > seg_lo(c.m, cw)) {
    c.hi = c.lo;
  } else if (c.m > 0) {
    c.m -= 1;
    c.hi = seg_hi(c.m, nseg, cw, L);
  } else {
    c.j -= 1;
    c.m = nseg - 1;
    c.hi = seg_hi(c.m, nseg, cw, L);
  }
  c.lo = max(seg_lo(c.m, cw), c.hi - kChunk);
  return c;
}

// Low words of columns hi - 1, hi - 2, ..., lo of read j of the lane
// whose first cell is `base` (index i holds column hi - 1 - i).  kPairs:
// L is even, so lo, hi and every read's first cell are even and cells
// pair into aligned 16-byte loads.
template <bool kPairs>
__device__ __forceinline__ void load_chunk(const uint32_t* __restrict__ g,
                                           size_t base, int L, Chunk c,
                                           uint32_t (&v)[kChunk]) {
  const int cnt = c.hi - c.lo;
  const size_t row = base + (size_t)c.j * L;
  if (kPairs) {
#pragma unroll
    for (int p = 0; p < kChunk / 2; ++p) {
      if (2 * p < cnt) {
        const uint4 q =
            *(const uint4*)(g + 2 * (row + (size_t)(c.hi - 2 - 2 * p)));
        v[2 * p] = q.z;
        v[2 * p + 1] = q.x;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < cnt) v[i] = g[2 * (row + (size_t)(c.hi - 1 - i))];
    }
  }
}

template <bool kPairs>
__global__ void __launch_bounds__(128) rans_encode_kernel(
    const uint32_t* __restrict__ sym, const uint32_t* __restrict__ ctx,
    const uint16_t* __restrict__ tab, int N, int T, int L, int R, int PB,
    int cw, int whole, uint32_t* __restrict__ states,
    int16_t* __restrict__ words, uint8_t* __restrict__ emits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = T / L;
  const int nseg = min(PB, (L + cw - 1) / cw);
  // whole: rows 0 .. nseg*R staged once; else row 0, then two buffers of
  // one bucket (R rows) each
  uint16_t* rows = (uint16_t*)smem;
  const int n_rows = whole ? 1 + nseg * R : 1 + 2 * R;
  unsigned long long* rcp =
      (unsigned long long*)(smem + (size_t)n_rows * kRow * 2);
  const uint16_t* row0 = rows;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = n < N;

  const size_t base = (size_t)(active ? n : 0) * T;
  Chunk c = first_chunk(k, nseg, cw, L);
  // the table (rans.bucket_slabs): row 0, then bucket m's R rows
  // transposed at kRow + m * R * kRow (entry e of row r at e * R + r)
  if (whole) {
    stage(rows, tab, 0, n_rows * kRow);
  } else {
    stage(rows, tab, 0, kRow);
    stage(rows + kRow, tab, kRow + c.m * R * kRow, R * kRow);
  }
  cp_async_commit();
  for (int f = threadIdx.x; f <= scalce::kMaxF; f += blockDim.x)
    rcp[f] = f >= 2 ? scalce::recip_of(f) : 0ull;
  uint32_t s_next[kChunk], c_next[kChunk];
  if (active) {
    load_chunk<kPairs>(sym, base, L, c, s_next);
    load_chunk<kPairs>(ctx, base, L, c, c_next);
  }
  Chunk pf = c;
  for (int i = 0; i < kAhead && pf.j >= 0; ++i) pf = next_chunk(pf, nseg, cw, L);
  if (whole) {
    cp_async_wait_all();
    __syncthreads();
  }
  int b = 0;
  uint32_t x = 1u << 16;
  while (c.j >= 0) {
    if (!whole && c.hi == seg_hi(c.m, nseg, cw, L)) {
      // a new bucket: wait for it, then prefetch the one after it
      cp_async_wait_all();
      __syncthreads();
      const int next = c.m > 0 ? c.m - 1 : (c.j > 0 ? nseg - 1 : -1);
      if (next >= 0) {
        stage(rows + kRow + (b ^ 1) * R * kRow, tab, kRow + next * R * kRow,
              R * kRow);
        cp_async_commit();
      }
    }
    uint32_t s_cur[kChunk], c_cur[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      s_cur[i] = s_next[i];
      c_cur[i] = c_next[i];
    }
    const Chunk nc = next_chunk(c, nseg, cw, L);
    if (active && nc.j >= 0) {
      load_chunk<kPairs>(sym, base, L, nc, s_next);
      load_chunk<kPairs>(ctx, base, L, nc, c_next);
    }
    if (active && pf.j >= 0) {
      const size_t r0 = base + (size_t)pf.j * L;
      scalce::prefetch_l2(sym + 2 * (r0 + pf.lo));
      scalce::prefetch_l2(sym + 2 * (r0 + pf.hi - 1));
      scalce::prefetch_l2(ctx + 2 * (r0 + pf.lo));
      scalce::prefetch_l2(ctx + 2 * (r0 + pf.hi - 1));
    }
    if (pf.j >= 0) pf = next_chunk(pf, nseg, cw, L);
    if (active) {
      const int cnt = c.hi - c.lo;
      const uint16_t* bucket =
          whole ? rows + kRow + (size_t)c.m * R * kRow
                : rows + kRow + (size_t)b * R * kRow;
      const uint32_t first = 1u + (uint32_t)(c.m * R);
      uint32_t v[kChunk];
      unsigned long long M[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (i < cnt) {
          const uint32_t s = min(s_cur[i], (uint32_t)(kNSyms - 1));
          const uint32_t r = min(c_cur[i] - first, (uint32_t)(R - 1));
          const bool pad = c_cur[i] == 0;
          const uint32_t lo = pad ? row0[s] : bucket[s * R + r];
          const uint32_t hi = pad ? row0[s + 1] : bucket[(s + 1) * R + r];
          v[i] = (hi - lo) << 16 | lo;
          M[i] = rcp[hi - lo];
        }
      }
      const size_t t0 = (size_t)c.j * L + c.hi - 1;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (i < cnt) {
          const uint32_t f = v[i] >> 16;
          const size_t at = (t0 - i) * N + n;
          const bool emit = (x >> 20) >= f;
          words[at] = (int16_t)(x & 0xFFFFu);
          emits[at] = emit;
          if (emit) x >>= 16;
          const uint32_t q = scalce::div_recip(x, f, M[i]);
          x = (q << 12) + (x - q * f) + (v[i] & 0xFFFFu);
        }
      }
    }
    if (!whole && (nc.m != c.m || nc.j != c.j)) b ^= 1;
    c = nc;
  }
  if (active) states[n] = x;
}

template <bool kPairs>
cudaError_t launch(const void* sym, const void* ctx, const void* tab, int N,
                   int T, int L, int R, int PB, int cw, void* states,
                   void* words, void* emits, cudaStream_t stream) {
  const int threads = 128;
  const int nseg = min(PB, (L + cw - 1) / cw);
  const int whole = (1 + nseg * R) * kRow * 2 + kRcpBytes <= kSmemMax;
  const int smem = (whole ? 1 + nseg * R : 1 + 2 * R) * kRow * 2 + kRcpBytes;
  cudaFuncSetAttribute(rans_encode_kernel<kPairs>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  rans_encode_kernel<kPairs>
      <<<(N + threads - 1) / threads, threads, smem, stream>>>(
          (const uint32_t*)sym, (const uint32_t*)ctx, (const uint16_t*)tab,
          N, T, L, R, PB, cw, whole, (uint32_t*)states, (int16_t*)words,
          (uint8_t*)emits);
  return cudaGetLastError();
}

// floor(x / f) and x % f through the kernel's reciprocal, one per element
// (the reciprocal's exactness check).
__global__ void divmod_recip_kernel(const uint32_t* __restrict__ x,
                                    const uint32_t* __restrict__ f, int n,
                                    uint32_t* __restrict__ q,
                                    uint32_t* __restrict__ r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t fi = f[i];
  const uint32_t qi = scalce::div_recip(x[i], fi, scalce::recip_of(fi));
  q[i] = qi;
  r[i] = x[i] - qi * fi;
}

}  // namespace

// sym, ctx: the [B, L] grids as int64 (values below 2^32); tab u16 [C*96]
// (per row: exclusive cums, the total, a pad; rans.bucket_slabs's
// layout); R, PB, cw: the context model's
// position buckets (ctx = 1 + min(col / cw, PB - 1) * R + row, 0 =
// padding).  states u32 [N]; words int16 [T, N] (the u16 bits); emits u8
// [T, N].
extern "C" int scalce_rans_encode(const void* sym, const void* ctx,
                                  const void* tab, int N, int T, int L,
                                  int R, int PB, int cw, void* states,
                                  void* words, void* emits, void* stream) {
  if (T % L || R < 1 || (1 + 2 * R) * kRow * 2 + kRcpBytes > kSmemMax)
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(L % 2 == 0
                   ? launch<true>(sym, ctx, tab, N, T, L, R, PB, cw, states,
                                  words, emits, s)
                   : launch<false>(sym, ctx, tab, N, T, L, R, PB, cw, states,
                                   words, emits, s));
}

extern "C" int scalce_divmod_recip(const void* x, const void* f, int n,
                                   void* q, void* r, void* stream) {
  if (n > 0) {
    divmod_recip_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)f, n, (uint32_t*)q,
        (uint32_t*)r);
  }
  return (int)cudaGetLastError();
}
