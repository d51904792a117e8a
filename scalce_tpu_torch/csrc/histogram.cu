// K6: histogram of D blocks' (context, symbol) cells, and the flat
// histogram of cell indices.
//
// Replaces scalce_tpu/ops/hist_pallas.py::histogram_pallas (Mosaic kernel
// `_kernel`) together with what fed it on the data-parallel path: the
// reference's rans.context_histogram over a group's stacked tables
// (streams/qualities.py::group_histogram).  The grids entry counts cell
// (d * C + ctx) * n_syms + sym for every cell of block d's int64 symbol
// and context grids, read in place (the low word holds the value), into
// hist i32 [D * C * n_syms]: no stacked context grid, index grid or int32
// narrowing is built.  The flat entry counts hist[v] += 1 for every
// int64 v = idx[i] (the lossy histogram all-reduce, 95 cells).  A cell
// outside the table (ctx >= C, sym >= n_syms, v outside [0, n_cells))
// counts nothing.
//
// Bound on the H100: reading the grids, 16 bytes per cell (537 MB for one
// 262144 x 128 block: 0.16 ms at 3.35 TB/s).  The first version's
// global atomics, one per group of equal values in a warp (about 26M per
// block), serialized on the hot cells in L2 and took 4x that.  Design:
//  - Each CTA (1024 threads, one per SM) walks tiles of kTile < 65,536
//    consecutive cells of one block and counts them into a private copy
//    of the block's table in shared memory, two u16 counters per 32-bit
//    word (order 1: 71,534 cells in 143 KB, dynamic shared memory), added
//    with a shared atomicAdd of 1 << 16 * (cell & 1).  No counter can
//    reach 65,536 inside a tile, so none carries into its neighbour; after
//    each tile the CTA adds its nonzero counters to hist with one global
//    atomic each and clears them.
//  - Cell 0 (padding past a read's end, about 22% of the cells at 100 bp
//    in L = 128) is counted in a register and added once per warp and
//    tile, as csrc/hist_ctx.cu does.
//  - Each thread loads 4 cells of both grids before it counts any.
//  - Tables too large for shared memory (orders 2 and 3: 131,694 and
//    285,854 cells) take the first version's warp-aggregated global
//    atomics (__match_any_sync), still without the padding cell.
// Integer atomics give the exact count in any order.  The TPU's one-hot
// matmul accumulation was the MXU's way to scatter-add and is not carried
// over.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kPer = 4;       // cells per thread per step, loaded together
constexpr int kSteps = 15;
// cells per tile: a u16 counter takes at most kTile < 2^16 increments
constexpr long long kTile = (long long)kThreads * kPer * kSteps;
constexpr int kSharedMax = 200 * 1024;

// Element i's cell: its table index, or -1 (counts nothing).
template <bool kGrids>
__device__ __forceinline__ int cell_of(const long long* __restrict__ a,
                                       const long long* __restrict__ b,
                                       long long i, int C, int S,
                                       int n_cells) {
  if (kGrids) {
    const unsigned s = (unsigned)__ldg(a + i);
    const unsigned c = (unsigned)__ldg(b + i);
    return c < (unsigned)C && s < (unsigned)S ? (int)(c * S + s) : -1;
  }
  const long long v = __ldg(a + i);
  return v >= 0 && v < n_cells ? (int)v : -1;
}

template <bool kGrids, bool kShared>
__global__ void __launch_bounds__(kThreads) histogram_kernel(
    const long long* __restrict__ a, const long long* __restrict__ b,
    long long cells, int C, int S, int n_cells, long long tiles_per_block,
    long long n_tiles, int* __restrict__ hist) {
  extern __shared__ uint32_t cnt[];   // kShared: cells 2w and 2w + 1
  __shared__ unsigned pad_s;
  const int tid = threadIdx.x, lane = tid & 31;
  const int words = (n_cells + 1) / 2;
  if (kShared) {
    for (int w = tid; w < words; w += kThreads) cnt[w] = 0;
  }
  if (tid == 0) pad_s = 0;
  __syncthreads();
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long d = tile / tiles_per_block;
    const long long first = d * cells + tile % tiles_per_block * kTile;
    const long long end = min(first + kTile, (d + 1) * cells);
    int* out = hist + d * n_cells;
    unsigned pad = 0;
    // warp-uniform bounds: every lane runs every step (the global path's
    // __match_any_sync takes the whole warp)
    for (long long j = first + tid - lane; j < end;
         j += (long long)kThreads * kPer) {
      int v[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const long long i = j + lane + (long long)k * kThreads;
        v[k] = i < end ? cell_of<kGrids>(a, b, i, C, S, n_cells) : -1;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        pad += v[k] == 0;
        if (kShared) {
          if (v[k] > 0) atomicAdd(&cnt[v[k] >> 1], 1u << ((v[k] & 1) << 4));
        } else {
          const unsigned peers = __match_any_sync(0xFFFFFFFFu, v[k]);
          if (v[k] > 0 && lane == __ffs(peers) - 1)
            atomicAdd(&out[v[k]], __popc(peers));
        }
      }
    }
    pad = __reduce_add_sync(0xFFFFFFFFu, pad);
    if (lane == 0 && pad) atomicAdd(&pad_s, pad);
    __syncthreads();
    if (kShared) {
      for (int w = tid; w < words; w += kThreads) {
        const uint32_t x = cnt[w];
        if (x) {
          cnt[w] = 0;
          if (x & 0xFFFFu) atomicAdd(&out[2 * w], (int)(x & 0xFFFFu));
          if (x >> 16) atomicAdd(&out[2 * w + 1], (int)(x >> 16));
        }
      }
    }
    if (tid == 0 && pad_s) {
      atomicAdd(&out[0], (int)pad_s);
      pad_s = 0;
    }
    __syncthreads();
  }
}

template <bool kGrids>
cudaError_t launch(const void* a, const void* b, int D, long long cells,
                   int C, int S, int n_cells, void* hist,
                   cudaStream_t stream) {
  if (D <= 0 || cells <= 0) return cudaGetLastError();
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles_per_block = (cells + kTile - 1) / kTile;
  const long long n_tiles = tiles_per_block * D;
  const int smem = (n_cells + 1) / 2 * 4;
  if (smem <= kSharedMax) {
    auto k = histogram_kernel<kGrids, true>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    const long long grid = std::min(n_tiles, (long long)sms);
    k<<<(int)grid, kThreads, smem, stream>>>(
        (const long long*)a, (const long long*)b, cells, C, S, n_cells,
        tiles_per_block, n_tiles, (int*)hist);
  } else {
    const long long grid = std::min(n_tiles, 2LL * sms);
    histogram_kernel<kGrids, false><<<(int)grid, kThreads, 0, stream>>>(
        (const long long*)a, (const long long*)b, cells, C, S, n_cells,
        tiles_per_block, n_tiles, (int*)hist);
  }
  return cudaGetLastError();
}

}  // namespace

// D blocks' grids sym, ctx: int64 (values below 2^32), `cells` cells per
// block, contiguous; hist i32 [D * C * n_syms], zeroed by the caller.
extern "C" int scalce_histogram_grids(const void* sym, const void* ctx,
                                      int D, long long cells, int C,
                                      int n_syms, void* hist, void* stream) {
  if (C < 1 || n_syms < 1) return (int)cudaErrorInvalidValue;
  return (int)launch<true>(sym, ctx, D, cells, C, n_syms, C * n_syms, hist,
                           (cudaStream_t)stream);
}

// idx: S int64 cell indices; hist i32 [n_cells], zeroed by the caller.
extern "C" int scalce_histogram(const void* idx, long long S, int n_cells,
                                void* hist, void* stream) {
  if (n_cells < 1) return (int)cudaErrorInvalidValue;
  return (int)launch<false>(idx, nullptr, 1, S, 1, 1, n_cells, hist,
                            (cudaStream_t)stream);
}
