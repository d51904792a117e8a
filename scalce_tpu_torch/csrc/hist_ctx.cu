// K2: quality pass A, from the quality bytes: the symbol and context
// grids and their (context, symbol) histogram.
//
// Replaces scalce_tpu/ops/hist_pallas.py::hist_ctx_slab_pallas (Mosaic
// kernel `_slab_kernel`) together with its producers, the grids of
// streams/qualities.py::sym_ctx_hist and the lossy remap in front of
// them, which the TPU leaves to fused XLA elementwise ops.  Per cell
// (r, c) of the uint8 [B, L] quality grid, with q' = lut[q] (the
// identity when lossless):
//   sym = c < len ? clamp(q' - 33, 0, 93) : 0
//   ctx = c < len ? 1 + pb(c) * R + pidx(prev1, prev2, c) : 0
// (qualities._ctx_from: order 1 pidx = c == 0 ? 94 : min(prev1, 93),
// pb = min(c / 16, 7); order 3 the same with pb = min(c / 4, 31);
// order 2 pidx = pq * 7 + p2 with pq = c == 0 ? 24 : min(prev1 >> 2, 23),
// p2 = c <= 1 ? 6 : min(prev2 >> 4, 5), R = 175), written as u32 values
// in int64 [B, L] grids, the form K3 and the data-parallel path read;
// with the histogram, counts[ctx * 94 + sym] += 1 into i32
// [(1 + PB * R) * 94] (padding cells count into cell (0, 0)).
//
// Bound on the H100: bytes.  The function needs the quality bytes in
// (B = 262144, L = 128: 33.5 MB) and the grids out at their narrowest
// (u8 sym, u16 ctx: 101 MB), 0.040 ms; the int64 grids K3 reads are
// 537 MB, 0.160 ms, a cost of that interface.  Design: one block per
// (position bucket, row chunk), as the Mosaic slab kernel: the bucket
// fixes the contexts a cell can take, so the block counts into a
// shared-memory slab of R x 94 i32 (order 2: 65.8 KB, dynamic shared
// memory above 48 KB) with shared atomics, then adds each non-zero entry
// to the table with one global atomic; integer atomics give the exact
// count in any order.  Threads lie 16 (orders 1, 2) or 4 (order 3) to a
// row across the bucket's columns, so one warp store covers whole
// 32-byte sectors of a grid; a cell reads its own and its two
// predecessors' bytes (L1 hits) through the LUT in shared memory.
// Padding cells are counted per thread and added once per block.
// Without the histogram (the data-parallel path, whose K6 counts the
// whole group) there is no slab.

#include "common.cuh"

namespace {

constexpr int kSyms = 94;
constexpr int kOffset = 33;
constexpr int kThreads = 512;

__device__ __forceinline__ uint32_t sym_of(uint32_t q) {
  return (uint32_t)min(max((int)q - kOffset, 0), kSyms - 1);
}

// Row of the context within its position bucket.
template <int kOrder>
__device__ __forceinline__ uint32_t pidx_of(uint32_t prev1, uint32_t prev2,
                                            int c) {
  if (kOrder == 2) {
    const uint32_t pq = c == 0 ? 24u : min(prev1 >> 2, 23u);
    const uint32_t p2 = c <= 1 ? 6u : min(prev2 >> 4, 5u);
    return pq * 7 + p2;
  }
  return c == 0 ? 94u : min(prev1, 93u);
}

template <int kOrder, bool kHist>
__global__ void __launch_bounds__(kThreads) hist_ctx_kernel(
    const uint8_t* __restrict__ qual, const int64_t* __restrict__ lengths,
    const uint8_t* __restrict__ lut, int B, int L, int R, int PB,
    int rows_per_chunk, long long* __restrict__ sym_out,
    long long* __restrict__ ctx_out, int* __restrict__ hist) {
  constexpr int kCols = kOrder == 3 ? 4 : 16;  // bucket width
  extern __shared__ int slab[];  // R * 94 counts of this bucket
  __shared__ uint8_t map[256];
  __shared__ int n_pad;
  const int pb = blockIdx.x;
  const int c0 = pb * kCols;
  if (c0 >= L) return;  // grid narrower than the bucket range
  const int c1 = (pb == PB - 1) ? L : min(c0 + kCols, L);
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(B, r0 + rows_per_chunk);
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    map[i] = lut ? lut[i] : (uint8_t)i;
  if (kHist) {
    for (int i = threadIdx.x; i < R * kSyms; i += blockDim.x) slab[i] = 0;
    if (threadIdx.x == 0) n_pad = 0;
  }
  __syncthreads();

  const uint32_t base = 1u + (uint32_t)pb * R;
  int my_pad = 0;
  for (int r = r0 + threadIdx.x / kCols; r < r1; r += blockDim.x / kCols) {
    const uint8_t* q = qual + (size_t)r * L;
    const long long len = lengths[r];
    for (int c = c0 + threadIdx.x % kCols; c < c1; c += kCols) {
      uint32_t s = 0, ctx = 0;
      if (c < len) {
        s = sym_of(map[q[c]]);
        const uint32_t p1 = c >= 1 ? sym_of(map[q[c - 1]]) : 0u;
        const uint32_t p2 = c >= 2 ? sym_of(map[q[c - 2]]) : 0u;
        const uint32_t pidx = pidx_of<kOrder>(p1, p2, c);
        ctx = base + pidx;
        if (kHist) atomicAdd(&slab[pidx * kSyms + s], 1);
      } else {
        ++my_pad;
      }
      const size_t off = (size_t)r * L + c;
      sym_out[off] = s;
      ctx_out[off] = ctx;
    }
  }
  if (kHist) {
    for (int off = 16; off > 0; off >>= 1)
      my_pad += __shfl_down_sync(0xFFFFFFFFu, my_pad, off);
    if ((threadIdx.x & 31) == 0 && my_pad) atomicAdd(&n_pad, my_pad);
    __syncthreads();
    int* out = hist + (size_t)base * kSyms;
    for (int i = threadIdx.x; i < R * kSyms; i += blockDim.x)
      if (slab[i]) atomicAdd(&out[i], slab[i]);
    if (threadIdx.x == 0 && n_pad) atomicAdd(&hist[0], n_pad);
  }
}

using Launch = cudaError_t (*)(const void*, const void*, const void*, int,
                               int, int, int, void*, void*, void*,
                               cudaStream_t);

template <int kOrder, bool kHist>
cudaError_t launch(const void* qual, const void* lengths, const void* lut,
                   int B, int L, int R, int PB, void* sym, void* ctx,
                   void* hist, cudaStream_t stream) {
  const size_t smem = kHist ? (size_t)R * kSyms * sizeof(int) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      hist_ctx_kernel<kOrder, kHist>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // ~8 blocks per SM over the whole grid (132 SMs)
  int chunks = (1056 + PB - 1) / PB;
  if (chunks > B) chunks = B;
  const int rows = (B + chunks - 1) / chunks;
  chunks = (B + rows - 1) / rows;
  hist_ctx_kernel<kOrder, kHist><<<dim3(PB, chunks), kThreads, smem,
                                   stream>>>(
      (const uint8_t*)qual, (const int64_t*)lengths, (const uint8_t*)lut, B,
      L, R, PB, rows, (long long*)sym, (long long*)ctx, (int*)hist);
  return cudaSuccess;
}

}  // namespace

// lut: uint8 [256] or null (identity); hist: null for the grids alone,
// else (1 + PB * R) * 94 i32 cells zeroed by the caller.  (R, PB) are
// qualities._slab_spec(order), whose bucket width (16, or 4 at order 3)
// the kernel's kCols repeats.
extern "C" int scalce_hist_ctx(const void* qual, const void* lengths,
                               const void* lut, int B, int L, int order,
                               int R, int PB, void* sym, void* ctx,
                               void* hist, void* stream) {
  static const Launch kLaunch[3][2] = {{launch<1, false>, launch<1, true>},
                                       {launch<2, false>, launch<2, true>},
                                       {launch<3, false>, launch<3, true>}};
  if (order < 1 || order > 3) return (int)cudaErrorInvalidValue;
  if (B > 0 && L > 0) {
    const cudaError_t err = kLaunch[order - 1][hist != nullptr](
        qual, lengths, lut, B, L, R, PB, sym, ctx, hist,
        (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
