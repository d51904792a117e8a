// K5: interleaved rANS encode over pre-gathered (f, cum).
//
// Replaces scalce_tpu/ops/rans_pallas.py::encode_scan_pallas (Mosaic
// kernel `_kernel`).  f_all and cum_all are u32 [T, N] in data order: lane
// n's symbol t has frequency f_all[t, n] and cumulative frequency
// cum_all[t, n], gathered in torch from any flat table
// (ops/rans.py::gather_tables).  Lane n walks t = T - 1 down to 0 with a
// u32 state starting at 2^16, emits the low 16 bits when (x >> 20) >= f,
// and sets x = ((x / f) << 12) + x % f + cum.  Words and emit flags are
// written in [T, N] (decode order); compaction follows in torch.
//
// Bound on the H100: the serial dependency along each lane, T = 2048
// steps of a 32-bit divide.  The data-parallel quality path encodes a
// group of D blocks as one set of D * N lanes (D = 4: 65,536 lanes, four
// times K3's), reading 2 x 4 B and writing 3 B per symbol (1.5 GB for the
// group).  Design: K3 (csrc/rans_encode.cu) without the in-kernel table
// read: one thread per lane with the state in a register and a native
// uint32_t divide; the [T, N] layout makes every load and store of a step
// coalesced across the warp, and the loads do not depend on the state, so
// they are fetched ahead of the divide chain.  The TPU's two corrected f32
// divides are not carried over.

#include "common.cuh"

namespace {

__global__ void rans_encode_flat_kernel(const uint32_t* __restrict__ f_all,
                                        const uint32_t* __restrict__ c_all,
                                        int N, int T, uint32_t* states,
                                        uint16_t* words, uint8_t* emits) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  uint32_t x = 1u << 16;
  for (int t = T - 1; t >= 0; --t) {
    const size_t o = (size_t)t * N + n;
    const uint32_t f = f_all[o];
    const bool emit = (x >> 20) >= f;
    words[o] = (uint16_t)(x & 0xFFFFu);
    emits[o] = emit;
    if (emit) x >>= 16;
    x = ((x / f) << 12) + x % f + c_all[o];
  }
  states[n] = x;
}

}  // namespace

extern "C" int scalce_rans_encode_flat(const void* f_all, const void* c_all,
                                       int N, int T, void* states,
                                       void* words, void* emits,
                                       void* stream) {
  if (N > 0) {
    const int threads = 128;
    rans_encode_flat_kernel<<<(N + threads - 1) / threads, threads, 0,
                              (cudaStream_t)stream>>>(
        (const uint32_t*)f_all, (const uint32_t*)c_all, N, T,
        (uint32_t*)states, (uint16_t*)words, (uint8_t*)emits);
  }
  return (int)cudaGetLastError();
}
