// K1: the canonical core rank of each read, from its bases.
//
// Replaces scalce_tpu/ops/core_pallas.py::rank_argmin_pallas (Mosaic
// kernel `_kernel`) together with its producers, core_match's rolling
// k-mer grid and window mask, which the TPU leaves to fused XLA
// elementwise ops.  Per read of the uint8 [B, L] codes (0..3), the bool
// [B, L] exception mask and the int64 lengths, every window p in [0, P),
// P = L - k + 1, is ranked on both strands with mix32 (a window with
// p > len - k, or covering an exception, ranks U32_MAX), and the kernel
// returns
//   bf  min forward rank        pf  FIRST position reaching it
//   br  min reverse-complement  pfw LAST forward position reaching it
//   kf  forward k-mer at pf     kr  RC k-mer at pfw
// (all-invalid rows: bf = br = U32_MAX, pf = 0, pfw = P - 1).
//
// Bound on the H100: the ranks, ~40 integer operations per window
// (B = 262144, P = 117: 30.7M windows, 0.037 ms at 33.5 Tops/s), above
// reading the codes and the mask once (67 MB, 0.020 ms).  Design: one
// warp per read, and the [B, P] k-mer grid never exists.  The warp reads
// its row 128 bytes at a time (a 4-byte word of codes and of mask per
// lane, neighbouring lanes on neighbouring words), packs each lane's four
// codes into a byte and ORs four lanes' bytes into a word of 16 bases,
// 2-bit big-endian (__shfl_xor_sync), and eight lanes' mask nibbles into
// a word of 32 exception bits; both go to the warp's slice of shared
// memory.  Then lane j takes windows p = j, j + 32, ... up to len - k:
// the k-mer at p is a funnel shift of two packed words, its k exception
// bits another, and its reverse complement a bit reverse.  Each lane
// keeps (rank, pos) minima for both strands in registers, and four
// warp reductions (__reduce_min_sync / __reduce_max_sync) give each
// strand's rank and its position under the tie rule (lower pos wins
// forward, higher pos wins RC).
//
// The explicit dictionaries (dict_mode lut / lcp, k <= 12) rank a k-mer
// by a table of its 4^k u32 ranks in place of mix32: the same kernel
// with kLut set (the reference keeps that mode on XLA,
// scalce_tpu/ops/core_match.py:181-196, as Mosaic has no vector gather).
// At k = 12 the table is 64 MB of 4-byte words, more than the 50 MB L2:
// each window reads two words at data-dependent addresses through the
// read-only path (__ldg), so the bound is the 32-byte sectors those
// lookups move, not the ranks' arithmetic.  The hash path (kLut false)
// is the kernel as it was.

#include "common.cuh"

namespace {

constexpr uint32_t kMax = 0xFFFFFFFFu;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kWarpsPerBlock = 8;

// Shared words of one warp's row, L rounded up to 128 positions: 16
// bases per code word and 32 positions per exception word, each with one
// zero word after the row (a funnel shift reads it, never its bits).
__host__ __device__ inline int code_words(int L) {
  return (L + 127) / 128 * 8 + 1;
}
__host__ __device__ inline int exc_words(int L) {
  return (L + 127) / 128 * 4 + 1;
}

// The k bases from position p of a row packed 16 to a word.
__device__ __forceinline__ uint32_t kmer_at(const uint32_t* w, int p,
                                            int k) {
  return __funnelshift_l(w[(p >> 4) + 1], w[p >> 4], 2 * (p & 15)) >>
         (32 - 2 * k);
}

template <bool kLut>
__global__ void core_rank_kernel(const uint8_t* __restrict__ codes,
                                 const uint8_t* __restrict__ exc,
                                 const int64_t* __restrict__ lengths, int B,
                                 int L, int k, uint32_t seed,
                                 const uint32_t* __restrict__ lut,
                                 bool aligned,
                                 long long* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= B) return;  // warp-uniform: a whole warp owns one row
  const int nw = code_words(L);
  uint32_t* cw = smem + warp * (nw + exc_words(L));
  uint32_t* ew = cw + nw;
  const uint8_t* rc = codes + (size_t)row * L;
  const uint8_t* re = exc + (size_t)row * L;
  const long long len = lengths[row];

  for (int c = 0; c < L; c += 128) {
    const int p0 = c + 4 * lane;  // this lane's four positions
    uint32_t cv = 0, ev = 0;      // byte i: position p0 + i
    if (aligned && p0 + 3 < L) {
      cv = *reinterpret_cast<const uint32_t*>(rc + p0);
      ev = *reinterpret_cast<const uint32_t*>(re + p0);
    } else {
      for (int i = 0; i < 4 && p0 + i < L; ++i) {
        cv |= (uint32_t)rc[p0 + i] << (8 * i);
        ev |= (uint32_t)re[p0 + i] << (8 * i);
      }
    }
    // four codes -> one byte, position p0 in the top two bits; four
    // lanes' bytes -> one big-endian word of 16 bases
    const uint32_t b = ((cv & 3u) << 6) | (((cv >> 8) & 3u) << 4) |
                       (((cv >> 16) & 3u) << 2) | ((cv >> 24) & 3u);
    uint32_t word = b << (24 - 8 * (lane & 3));
    word |= __shfl_xor_sync(kFull, word, 1);
    word |= __shfl_xor_sync(kFull, word, 2);
    // four mask bytes (0 or 1) -> a nibble, position p0 in bit 0; eight
    // lanes' nibbles -> one word of 32 positions
    uint32_t bits = (ev & 1u) | ((ev >> 7) & 2u) | ((ev >> 14) & 4u) |
                    ((ev >> 21) & 8u);
    bits <<= 4 * (lane & 7);
    bits |= __shfl_xor_sync(kFull, bits, 1);
    bits |= __shfl_xor_sync(kFull, bits, 2);
    bits |= __shfl_xor_sync(kFull, bits, 4);
    if ((lane & 3) == 0) cw[c / 16 + (lane >> 2)] = word;
    if ((lane & 7) == 0) ew[c / 32 + (lane >> 3)] = bits;
  }
  if (lane == 0) {
    cw[nw - 1] = 0;
    ew[exc_words(L) - 1] = 0;
  }
  __syncwarp();

  // Windows past the read's end rank U32_MAX: only windows 0..lim are
  // ranked, and a strand whose best rank is U32_MAX takes the tie rule's
  // position over all P windows below.
  const int P = L - k + 1;
  const int lim = (int)min((long long)P - 1, len - k);
  const uint32_t kbits = (1u << k) - 1;
  uint32_t f_rank = kMax, r_rank = kMax;
  int f_pos = 0, r_pos = 0;
  for (int p = lane; p <= lim; p += 32) {
    uint32_t rf = kMax, rr = kMax;
    const int e = p >> 5;
    if ((__funnelshift_r(ew[e], ew[e + 1], p & 31) & kbits) == 0) {
      const uint32_t v = kmer_at(cw, p, k);
      if constexpr (kLut) {
        rf = __ldg(lut + v);
        rr = __ldg(lut + scalce::revcomp(v, k));
      } else {
        rf = scalce::mix32(v, seed);
        rr = scalce::mix32(scalce::revcomp(v, k), seed);
      }
    }
    if (rf < f_rank) {  // p grows: the first position keeps a tie
      f_rank = rf;
      f_pos = p;
    }
    if (rr <= r_rank) {  // the last one does
      r_rank = rr;
      r_pos = p;
    }
  }
  const uint32_t bf = __reduce_min_sync(kFull, f_rank);
  const uint32_t br = __reduce_min_sync(kFull, r_rank);
  const uint32_t pf =
      bf == kMax ? 0u
                 : __reduce_min_sync(kFull, f_rank == bf ? f_pos : kMax);
  const uint32_t pfw =
      br == kMax ? (uint32_t)(P - 1)
                 : __reduce_max_sync(kFull, r_rank == br ? r_pos : 0u);
  uint32_t v = 0;
  switch (lane) {  // lane j writes output j
    case 0: v = bf; break;
    case 1: v = pf; break;
    case 2: v = br; break;
    case 3: v = pfw; break;
    case 4: v = kmer_at(cw, pf, k); break;
    case 5: v = scalce::revcomp(kmer_at(cw, pfw, k), k); break;
  }
  if (lane < 6) out[(size_t)lane * B + row] = v;
}

template <bool kLut>
int launch_core_rank(const void* codes, const void* exc, const void* lengths,
                     int B, int L, int k, uint32_t seed, const void* lut,
                     void* out, void* stream) {
  const size_t smem = sizeof(uint32_t) * kWarpsPerBlock *
                      (code_words(L) + exc_words(L));
  cudaError_t err = cudaFuncSetAttribute(
      core_rank_kernel<kLut>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = L % 4 == 0 && (uintptr_t)codes % 4 == 0 &&
                       (uintptr_t)exc % 4 == 0;
  if (B > 0) {
    const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    core_rank_kernel<kLut><<<blocks, 32 * kWarpsPerBlock, smem,
                             (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const uint8_t*)exc, (const int64_t*)lengths,
        B, L, k, seed, (const uint32_t*)lut, aligned, (long long*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// 1 <= k <= 16 and L >= k (the wrapper checks both).
// out: int64 [6, B], the rows (bf, pf, br, pfw, kf, kr) as u32 values.
extern "C" int scalce_core_rank(const void* codes, const void* exc,
                                const void* lengths, int B, int L, int k,
                                uint32_t seed, void* out, void* stream) {
  return launch_core_rank<false>(codes, exc, lengths, B, L, k, seed, nullptr,
                                 out, stream);
}

// The explicit dictionaries: lut holds the u32 rank of each of the 4^k
// k-mers, k <= 12 (the wrapper checks both).
extern "C" int scalce_core_rank_lut(const void* codes, const void* exc,
                                    const void* lengths, int B, int L, int k,
                                    const void* lut, void* out,
                                    void* stream) {
  return launch_core_rank<true>(codes, exc, lengths, B, L, k, 0u, lut, out,
                                stream);
}

// Error text for the Python wrappers (one definition for the library).
extern "C" const char* scalce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
