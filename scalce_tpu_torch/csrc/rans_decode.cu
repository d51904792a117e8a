// K4: quality rANS decode of D stacked blocks straight into their uint8
// quality grids, context orders 1/2/3.
//
// Replaces scalce_tpu/ops/rans_decode_pallas.py::decode_scan_pallas
// (Mosaic kernel `_kernel`) and the widening, transpose and offset that
// followed it.  Lane n of block d owns reads n*k .. n*k+k-1 (k = T / L);
// at step t it sits at read t / L, column t % L.  Inside the read, the
// context is rebuilt from the lane's previous one or two symbols and the
// column (streams/qualities.py::_ctx_from), the symbol is the owner of
// slot = x & 4095 among the context's cumulative frequencies,
// x = f * (x >> 12) + slot - cum, and a state below 2^16 pulls the lane's
// next 16-bit word.  Padding cells give 0 and keep the state.  Lane n's T
// outputs are bytes n*T .. n*T + T - 1 of block d's [B*L] grid: sym + 33
// on valid cells, 0 on padding.
//
// Bound on the H100: per lane T = 2048 dependent steps, and only 16,384
// lanes per block (about 4 warps per SM for one block): the latency of one
// step, and at D = 4 blocks the instructions per step, set the time; the
// memory traffic is small (the words in, the grid out).  What the design
// does:
//  - A CTA holds lanes of one block, and every lane sits at the same
//    column at the same step, so the only table rows any lane can need
//    are one position bucket's R rows (context 1 + bucket * R + row).  The
//    rows live in shared memory as u16 cumulative frequencies (96 per
//    row: 94 exclusive cums, the total, a pad), each bucket transposed
//    (entry-major): lanes on different rows then read different banks,
//    where row-major rows 192 bytes apart fall in two banks and a warp's
//    loads of one entry serialize.  When every bucket a read reaches fits
//    (order 1: 760 rows, 146 KB) they are staged once; otherwise (orders
//    2 and 3) one bucket at a time, double-buffered with cp.async while
//    the current bucket decodes, one __syncthreads() per bucket.
//  - The symbol search is a 4-ary search of the row in shared memory:
//    four dependent levels of up to three independent loads (probes 32
//    and 64, then 8, 16, 24 and 2, 4, 6 past the last success, then 1) in
//    place of a binary search's seven.
//  - A step is branch-free apart from the word refill: a
//    padding cell computes and discards, so no lane waits on another's
//    path, and 16 columns of padding for a whole warp are skipped.  The
//    lane's next four words sit in a register, loaded when the previous
//    four are taken (inside the refill's branch, so that no other step
//    waits on that register); the read's length is loaded a read ahead.
//    Shared memory is indexed from the one extern array, so every table
//    read is a plain shared load, and the context model is a template
//    parameter.
//  - Output leaves as one 16-byte store per 16 columns: when T and L are
//    multiples of 16, 16 unrolled steps fill four registers; otherwise the
//    bytes go through a 16-byte shift register, stored whole at each
//    aligned 16 and byte by byte only at the head and tail of a lane's
//    span that T % 16 != 0 leaves unaligned.

#include "common.cuh"

namespace {

constexpr int kNSyms = 94;
constexpr int kCumRow = 96;        // u16 per staged row
constexpr int kSmemMax = 200 * 1024;
constexpr uint32_t kQualOffset = 33;

// Row of the context within its position bucket (qualities._ctx_from
// minus 1 + bucket * R), at a valid cell.
template <bool kOrder2>
__device__ __forceinline__ uint32_t bucket_row(int col, uint32_t prev1,
                                               uint32_t prev2) {
  if (kOrder2) {
    const uint32_t pq = col == 0 ? 24u : min(prev1 >> 2, 23u);
    const uint32_t p2 = col <= 1 ? 6u : min(prev2 >> 4, 5u);
    return pq * 7u + p2;
  }
  return col == 0 ? 94u : min(prev1, 93u);
}

// The context model's position buckets: R rows per bucket, PB buckets,
// cw columns per bucket (qualities._slab_spec).
template <int kOrder>
struct Model {
  static constexpr int R = kOrder == 2 ? 175 : 95;
  static constexpr int PB = kOrder == 3 ? 32 : 8;
  static constexpr int cw = kOrder == 3 ? 4 : 16;
};

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

// Bytes base .. base + 15 of w (w[0]'s low byte first), those at or after
// `lo` only.
__device__ __forceinline__ void store_bytes(uint8_t* out, long long base,
                                            long long lo, const uint32_t* w) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (base + i >= lo) out[base + i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
  }
}

extern __shared__ __align__(16) unsigned char smem[];

// Position buckets m0 .. m0 + nb - 1 of one block's cum table (each
// bucket R rows, transposed: entry e of row r at e * R + r;
// rans.bucket_slabs) at byte `dst` of shared memory, as one cp.async group.
__device__ __forceinline__ void stage_buckets(int dst, const uint16_t* cum,
                                              int m0, int nb, int R) {
  const unsigned char* src =
      (const unsigned char*)(cum + kCumRow + (size_t)m0 * R * kCumRow);
  const int n16 = nb * R * kCumRow * 2 / 16;
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    cp_async16(smem + dst + 16 * i, src + 16 * i);
  cp_async_commit();
}

// One lane's decoder state.
struct Lane {
  uint32_t x, prev1, prev2;
  int cursor, n_quads;
  unsigned long long cur, nxt;         // the next words, four per quad
  const unsigned long long* quads;
};

// One step at column `col` of a read with `valid` set where the cell holds
// a symbol; `tab` (u16 index) locates the column's position bucket of R
// rows in shared memory.  Returns the output byte.
template <int kOrder>
__device__ __forceinline__ uint32_t step(Lane& ln, int col, bool valid,
                                         uint32_t tab) {
  constexpr uint32_t R = Model<kOrder>::R;
  const uint16_t* rows = (const uint16_t*)smem;
  const uint32_t r = bucket_row<kOrder == 2>(col, ln.prev1, ln.prev2);
  const uint32_t row = tab + r;                 // entry e at row + e * R
  const uint32_t slot = ln.x & 4095u;
  // largest s with row[s] <= slot (row[0] <= slot < row[94]): the probes
  // 32 and 64 (96 is past the row), then two levels of three probes 8 and
  // 2 apart, then one; every probe stays at or below 94, the total, which
  // no slot reaches
  uint32_t lo = (rows[row + 32 * R] <= slot) + (rows[row + 64 * R] <= slot);
  lo *= 32;
#pragma unroll
  for (uint32_t q = 8; q >= 2; q >>= 2) {
    lo += q * ((rows[row + (lo + q) * R] <= slot) +
               (rows[row + (lo + 2 * q) * R] <= slot) +
               (rows[row + (lo + 3 * q) * R] <= slot));
  }
  uint32_t s = min(lo + (rows[row + (lo + 1) * R] <= slot), kNSyms - 1u);
  const uint32_t lo_v = rows[row + s * R];
  const uint32_t hi_v = rows[row + (s + 1) * R];
  uint32_t xn = (hi_v - lo_v) * (ln.x >> 12) + slot - lo_v;
  const bool pull = valid && xn < (1u << 16);
  xn = pull ? (xn << 16) | ((uint32_t)ln.cur & 0xFFFFu) : xn;
  ln.x = valid ? xn : ln.x;
  ln.cur = pull ? ln.cur >> 16 : ln.cur;     // the next word lowest
  ln.cursor += pull;
  // every fourth pull takes the prefetched quad and loads the next one
  // (past the lane's W words, zeros); a branch, so that no other step
  // reads the register the load is filling
  if (pull && (ln.cursor & 3) == 0) {
    ln.cur = ln.nxt;
    const int q = (ln.cursor >> 2) + 1;
    ln.nxt = q < ln.n_quads ? ln.quads[q] : 0ull;
  }
  s = valid ? s : 0u;
  ln.prev2 = ln.prev1;
  ln.prev1 = s;
  return valid ? s + kQualOffset : 0u;
}

template <int kOrder>
__global__ void __launch_bounds__(512) rans_decode_kernel(
    const uint32_t* __restrict__ states, const uint16_t* __restrict__ words,
    const uint16_t* __restrict__ cum, const int32_t* __restrict__ lengths, int N, int W, int C, int T, int L,
    int whole, uint8_t* __restrict__ out) {
  constexpr int R = Model<kOrder>::R, PB = Model<kOrder>::PB,
                cw = Model<kOrder>::cw;
  const int d = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = n < N;
  const unsigned warp_active = __ballot_sync(0xFFFFFFFFu, active);
  const int k = T / L;
  const int nseg = min(PB, (L + cw - 1) / cw);
  // whole: rows 1 .. nseg*R of the block, staged once; else one bucket
  // (R rows) per buffer, two buffers
  const int unit = whole ? nseg * R : R;
  const int unit_bytes = unit * kCumRow * 2;
  const uint16_t* cum_d = cum + (size_t)d * C * kCumRow;

  const size_t lane = (size_t)d * N + (active ? n : 0);
  const int32_t* lens = lengths + lane * k;          // B = N * k per block
  Lane ln;
  ln.quads = (const unsigned long long*)(words + lane * W);  // W % 4 == 0
  ln.n_quads = W / 4;                                         // >= 1
  ln.x = active ? states[lane] : 0u;
  ln.cur = active ? ln.quads[0] : 0ull;
  ln.nxt = active && ln.n_quads > 1 ? ln.quads[1] : 0ull;
  ln.cursor = 0;
  ln.prev1 = ln.prev2 = 0;
  int len_next = active ? lens[0] : 0;
  const long long span0 = (long long)lane * T;      // lane's first byte
  // 16 aligned output bytes per 16 columns: T % 16 == 0 puts every span
  // start on a 16-byte boundary, L % 16 == 0 every read start, and cw == 16
  // keeps each 16 columns in one bucket
  const bool groups = T % 16 == 0 && L % 16 == 0 && cw == 16;
  long long p = span0 - 1;
  uint32_t w[4] = {0, 0, 0, 0};

  int buf = 0;
  stage_buckets(0, cum_d, 0, whole ? nseg : 1, R);
  if (whole) {
    cp_async_wait_all();
    __syncthreads();
  }
  for (int j = 0; j < k; ++j) {
    const int len = len_next;
    if (active && j + 1 < k) len_next = lens[j + 1];
    for (int m = 0; m < nseg; ++m) {
      uint32_t tab;                        // u16 index
      if (whole) {
        tab = m * R * kCumRow;
      } else {
        cp_async_wait_all();
        __syncthreads();
        const int next = m + 1 < nseg ? m + 1 : (j + 1 < k ? 0 : -1);
        if (next >= 0) {
          stage_buckets((buf ^ 1) * unit_bytes, cum_d, next, 1, R);
        }
        tab = buf * unit_bytes / 2;
      }
      const int c0 = m * cw;
      const int c1 = m == nseg - 1 ? L : min(c0 + cw, L);
      if (active && groups) {
        uint8_t* o = out + span0 + (long long)j * L;
        for (int g = c0; g < c1; g += 16) {
          if (__all_sync(warp_active, g >= len)) {
            // padding for the whole warp: what 16 padding steps give
            *(uint4*)(o + g) = make_uint4(0, 0, 0, 0);
            ln.prev1 = ln.prev2 = 0;
            continue;
          }
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const uint32_t b = step<kOrder>(ln, g + i, g + i < len, tab);
            w[i >> 2] = i & 3 ? w[i >> 2] | b << (8 * (i & 3)) : b;
          }
          *(uint4*)(o + g) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      } else if (active) {
        for (int col = c0; col < c1; ++col) {
          const uint32_t b = step<kOrder>(ln, col, col < len, tab);
          w[0] = __funnelshift_r(w[0], w[1], 8);
          w[1] = __funnelshift_r(w[1], w[2], 8);
          w[2] = __funnelshift_r(w[2], w[3], 8);
          w[3] = (w[3] >> 8) | (b << 24);
          ++p;
          if ((p & 15) == 15) {
            if (p - 15 >= span0) {
              *(uint4*)(out + p - 15) = make_uint4(w[0], w[1], w[2], w[3]);
            } else {
              store_bytes(out, p - 15, span0, w);
            }
          }
        }
      }
      buf ^= 1;
    }
  }
  if (active && !groups && (p & 15) != 15) {
    store_bytes(out, p - 15, max(span0, p - (p & 15)), w);
  }
}

template <int kOrder>
cudaError_t launch(const void* states, const void* words, const void* cum,
                   const void* lengths, int D, int N, int W, int C, int T,
                   int L, void* out, cudaStream_t stream) {
  using M = Model<kOrder>;
  const int nseg = min(M::PB, (L + M::cw - 1) / M::cw);
  const int row_bytes = kCumRow * 2;
  const int whole = nseg * M::R * row_bytes <= kSmemMax;
  const int smem = (whole ? nseg : 2) * M::R * row_bytes;
  // about one CTA per SM: 512 lanes when that still gives 128 CTAs
  int threads = 128;
  for (int t = 512; t > 128; t >>= 1) {
    if ((long long)D * ((N + t - 1) / t) >= 128) {
      threads = t;
      break;
    }
  }
  cudaFuncSetAttribute(rans_decode_kernel<kOrder>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((N + threads - 1) / threads, D);
  rans_decode_kernel<kOrder><<<grid, threads, smem, stream>>>(
      (const uint32_t*)states, (const uint16_t*)words, (const uint16_t*)cum,
      (const int32_t*)lengths, N, W, C, T, L, whole, (uint8_t*)out);
  return cudaGetLastError();
}

}  // namespace

// states u32 [D, N]; words u16 [D, N, W] (W % 4 == 0, W >= 4); cum u16
// [D, C*96] (per row: exclusive cums, the total, a pad) in
// rans.bucket_slabs's layout; lengths i32 [D, B]; out u8 [D, B*L].
extern "C" int scalce_rans_decode(const void* states, const void* words,
                                  const void* cum, const void* lengths,
                                  int D, int N, int W, int C, int T, int L,
                                  int order, void* out, void* stream) {
  if (order < 1 || order > 3 || T % L || W % 4 || W < 4)
    return (int)cudaErrorInvalidValue;
  if (D <= 0 || N <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 1)
    return (int)launch<1>(states, words, cum, lengths, D, N, W, C, T, L, out,
                          s);
  if (order == 2)
    return (int)launch<2>(states, words, cum, lengths, D, N, W, C, T, L, out,
                          s);
  return (int)launch<3>(states, words, cum, lengths, D, N, W, C, T, L, out,
                        s);
}
