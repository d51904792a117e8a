// K6: flat histogram of cell indices.
//
// Replaces scalce_tpu/ops/hist_pallas.py::histogram_pallas (Mosaic kernel
// `_kernel`).  hist[v] += 1 for every v = idx[i], i < S: equals
// zeros.at[idx].add(1) for indices in [0, n_cells); an index outside that
// range counts nothing.
//
// Bound on the H100: the data-parallel quality path counts a whole group
// of D blocks in one launch, S = D * B * L indices (4 x 262144 x 128 =
// 134M i32, 537 MB read) into D * C * 94 cells (order 1: 286,136 i32 =
// 1.1 MB: too large for shared memory, small enough to stay in L2).  The
// read is 0.2 ms of bandwidth; the bound is global atomic throughput on
// hot cells.  Each block's padding cell d * C * 94 takes every position
// past a read's end (~22% of the grid at 100 bp in L = 128), and a read's
// neighbouring columns often share a cell.  Design: a grid-stride loop
// with 64-bit element indices (S passes 2^31 at block_reads 2^18 x L 4096
// x D 4); each warp reads 32 consecutive indices, groups equal values
// with __match_any_sync, and the lowest lane of each group adds the
// group's size with one atomicAdd, so a run of padding costs one atomic
// per warp, not 32.  Integer atomics give the exact count in any order.
// The TPU's one-hot matmul accumulation was the MXU's way to scatter-add
// and is not carried over.

#include "common.cuh"

namespace {

__global__ void histogram_kernel(const int* __restrict__ idx, long long S,
                                 int n_cells, int* hist) {
  const int lane = threadIdx.x & 31;
  // warp-uniform: every lane of a warp walks the same bases
  const long long warp0 =
      (long long)blockIdx.x * blockDim.x + threadIdx.x - lane;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = warp0; base < S; base += stride) {
    const long long i = base + lane;
    const unsigned active = __ballot_sync(0xFFFFFFFFu, i < S);
    if (i >= S) continue;
    const int v = idx[i];
    const unsigned peers = __match_any_sync(active, v);
    if (lane == __ffs(peers) - 1 && (unsigned)v < (unsigned)n_cells)
      atomicAdd(&hist[v], __popc(peers));
  }
}

}  // namespace

// hist must be zeroed by the caller; n_cells i32 cells.
extern "C" int scalce_histogram(const void* idx, long long S, int n_cells,
                                void* hist, void* stream) {
  if (S > 0) {
    const int threads = 256;
    long long blocks = (S + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM
    histogram_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)idx, S, n_cells, (int*)hist);
  }
  return (int)cudaGetLastError();
}
