// The partial-IUPAC correction gram of the split decomposition on Hopper
// (sm_90a), straight from the packed words.
//
// Replaces tracs_tpu/ops/pairsnp.py::_gram_partial (XLA: the 10 plane-pair and
// plane-triple AND channels unpacked to int8 and contracted on the matrix
// unit).  From the exclusive planes at the partial sites, part_a [na, 4, Wp]
// and part_b [nb, 4, Wp] (uint32 words), it writes int32 [na, nb]
//
//   out[i, j] = sum_{|S|=3} G_S - sum_{|S|=2} G_S,
//   G_S[i, j] = sum_w popc(AND_{x in S} a_i,x[w] & AND_{x in S} b_j,x[w]),
//
// over the 6 plane pairs and the 4 plane triples.  Per site, with k the number
// of planes set in both a and b (x_p = a_p & b_p), the 10 products add up to
// C(k, 3) - C(k, 2) = 0, 0, -1, -2, -2 for k = 0..4, which is
// -([k >= 2] + [k >= 3]).  So a word pair costs 4 ANDs, the two carry-save
// half adders of x_0 + x_1 and x_2 + x_3, the two threshold masks and 2 POPC,
// instead of 10 AND-products and 10 POPC, and the result is the same integer
// for every input (the tests hold it against the 10-channel plain version on
// random words).
//
// Design.  A CUDA-core gram: a block of 256 threads computes a 64 x 64 tile of
// pairs, 4 x 4 a thread; the word axis goes through shared memory 8 words at a
// time, laid out [word][plane][row] (a word's stride padded by 4 words so that
// the copy is free of bank conflicts) so that a thread reads its 4 rows of a
// plane as one 16-byte load.  Operands are read as 4-byte words: the partial
// planes have no pitch rule.
//
// What bounds it on an H100.  At the main path's block (1024 x 4096 pairs, 64
// words) the operands are 5 MB and the output 16.8 MB: a bytes bound of a few
// microseconds; the kernel is bound by its integer instructions and POPC
// (16 a clock on each SM), far above that.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                  // rows and columns of a block's tile
constexpr int kWords = 8;                  // words a shared-memory stage
constexpr int kThreads = 256;
constexpr int kStride = 4 * kTile + 4;     // a word's stride in shared memory

__device__ __forceinline__ uint32_t correction(uint32_t a0, uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0, uint32_t b1,
                                               uint32_t b2, uint32_t b3) {
  const uint32_t x0 = a0 & b0, x1 = a1 & b1, x2 = a2 & b2, x3 = a3 & b3;
  const uint32_t c1 = x0 & x1, s1 = x0 ^ x1, c2 = x2 & x3, s2 = x2 ^ x3;
  const uint32_t ge2 = c1 | c2 | (s1 & s2);
  const uint32_t ge3 = (c1 & c2) | ((c1 | c2) & (s1 | s2));
  return __popc(ge2) + __popc(ge3);
}

__device__ __forceinline__ void stage(const uint32_t* __restrict__ p, int64_t n, int64_t Wp,
                                      int64_t row0, int64_t w0, uint32_t* s) {
  // 64 rows x 4 planes x 8 words; 8 consecutive threads read 8 consecutive
  // words of one (row, plane)
  for (int e = threadIdx.x; e < kTile * 4 * kWords; e += kThreads) {
    const int kw = e & (kWords - 1), r = (e >> 3) & (kTile - 1), plane = e >> 9;
    const int64_t row = row0 + r, w = w0 + kw;
    s[kw * kStride + plane * kTile + r] =
        row < n && w < Wp ? p[(row * 4 + plane) * Wp + w] : 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
partial_gram_kernel(const uint32_t* __restrict__ pa, const uint32_t* __restrict__ pb,
                    int64_t na, int64_t nb, int64_t Wp, int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t As[kWords * kStride];
  __shared__ __align__(16) uint32_t Bs[kWords * kStride];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t row0 = (int64_t)blockIdx.y * kTile, col0 = (int64_t)blockIdx.x * kTile;
  uint32_t acc[4][4] = {};
  for (int64_t w0 = 0; w0 < Wp; w0 += kWords) {
    stage(pa, na, Wp, row0, w0, As);
    stage(pb, nb, Wp, col0, w0, Bs);
    __syncthreads();
#pragma unroll 2
    for (int kw = 0; kw < kWords; ++kw) {
      uint4 a[4], b[4];
#pragma unroll
      for (int plane = 0; plane < 4; ++plane) {
        a[plane] = *reinterpret_cast<const uint4*>(&As[kw * kStride + plane * kTile + ty * 4]);
        b[plane] = *reinterpret_cast<const uint4*>(&Bs[kw * kStride + plane * kTile + tx * 4]);
      }
      const uint32_t av[4][4] = {{a[0].x, a[1].x, a[2].x, a[3].x},
                                 {a[0].y, a[1].y, a[2].y, a[3].y},
                                 {a[0].z, a[1].z, a[2].z, a[3].z},
                                 {a[0].w, a[1].w, a[2].w, a[3].w}};
      const uint32_t bv[4][4] = {{b[0].x, b[1].x, b[2].x, b[3].x},
                                 {b[0].y, b[1].y, b[2].y, b[3].y},
                                 {b[0].z, b[1].z, b[2].z, b[3].z},
                                 {b[0].w, b[1].w, b[2].w, b[3].w}};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] += correction(av[r][0], av[r][1], av[r][2], av[r][3],
                                  bv[c][0], bv[c][1], bv[c][2], bv[c][3]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t i = row0 + ty * 4 + r;
    if (i >= na) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t j = col0 + tx * 4 + c;
      if (j < nb) out[i * nb + j] = -static_cast<int32_t>(acc[r][c]);
    }
  }
}

}  // namespace

// C entry point, loaded with ctypes (tracs_tpu_torch/ops/kernels.py).
//
// pa, pb : [na, 4, Wp] and [nb, 4, Wp] uint32 exclusive planes at the partial
//          sites, contiguous
// out    : int32 [na, nb], contiguous
// stream : the cudaStream_t to launch on
//
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).  The caller
// checks every bound (na below 65535 tiles, 64 * Wp below 2^31); the kernel
// does not synchronise.
extern "C" int tracs_partial_gram(const void* pa, const void* pb, long long na, long long nb,
                                  long long Wp, void* out, void* stream) {
  if (na <= 0 || nb <= 0) return 0;
  const dim3 grid((unsigned)((nb + kTile - 1) / kTile), (unsigned)((na + kTile - 1) / kTile));
  partial_gram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pa), static_cast<const uint32_t*>(pb),
      static_cast<int64_t>(na), static_cast<int64_t>(nb), static_cast<int64_t>(Wp),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
