// Split-decomposition grams on Hopper (sm_90a), straight from packed words.
//
// Replaces tracs_tpu/ops/pallas_kernels.py::_split_gram_kernel (K1), and with
// it the XLA grams _dense_split / _dense_split_ranged of
// tracs_tpu/ops/pairsnp.py, which compute the same values.  For a row block
// [r0, r0+rb) of the A layout against the column suffix [c0, n_b) of the B
// layout it writes, as int32 [rb, n_b - c0] row-major,
//
//     gn[i][j] = sum_w popc(nA[r0+i][w] & nB[c0+j][w])                 (Gn)
//     g [i][j] = sum_w sum_x popc(eA[r0+i][x][w] & eB[c0+j][x][w]) - gn  (G4 - Gn)
//
// where e = the 4 N-exclusive allele planes [n, 4, W] and n = the N mask
// [n, W], both packed 32 sites per uint32 word.
//
// Design.  The TPU kernel unpacks every bit to an int8 0/1 value so that its
// matrix unit can take the dot product; that unpack is a workaround for the
// TPU.  Here each 32-site word pair costs one AND and one POPC on the CUDA
// cores, and nothing is unpacked.  Each 256-thread block owns a 64 x 64
// output tile and walks the word axis in chunks of 16 words: the chunk's 64
// A rows and 64 B rows (5 planes each, 40 KB) are staged in shared memory,
// and each thread accumulates a 4 x 4 sub-tile of G4 and Gn in registers.
// Rows past the block, columns past n_b and words past W load as zero, which
// adds nothing, and the store masks the ragged tile edge.
//
// What bounds it on an H100.  Per word pair the tile does 5 AND + 5 POPC +
// 5 IADD, and POPC issues at a quarter of the integer ALU rate, so the
// kernel is bound by integer POPC throughput, not by bytes: a 64-row tile
// reuses every staged word 64 times, about 0.13 bytes of global or L2
// traffic per POPC.  Tensor-core forms (b1 mma.sync AND+POPC, or an int8
// wgmma after an in-register unpack) are the way past that bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;      // output rows per block
constexpr int kBN = 64;      // output columns per block
constexpr int kKW = 16;      // words per staged chunk
constexpr int kTM = 4;       // output rows per thread
constexpr int kTN = 4;       // output columns per thread
constexpr int kPlanes = 5;   // 4 exclusive planes + the N mask
constexpr int kThreadsX = kBN / kTN;              // 16
constexpr int kThreadsY = kBM / kTM;              // 16
constexpr int kThreads = kThreadsX * kThreadsY;   // 256
// +1 word of padding per (word, plane) row of the staged tiles: the loads
// below walk the word index fastest, and without the pad every one of them
// would hit the same shared-memory bank
constexpr int kPadRows = kBM + 1;

__device__ __forceinline__ uint32_t load_word(
    const uint32_t* __restrict__ e, const uint32_t* __restrict__ nm,
    int64_t row, int plane, int64_t W, int64_t w) {
  return plane < 4 ? e[(row * 4 + plane) * W + w] : nm[row * W + w];
}

__global__ void __launch_bounds__(kThreads)
split_gram_kernel(const uint32_t* __restrict__ ea, const uint32_t* __restrict__ nma,
                  const uint32_t* __restrict__ eb, const uint32_t* __restrict__ nmb,
                  int64_t W, int r0, int rb, int c0, int m,
                  int32_t* __restrict__ g, int32_t* __restrict__ gn) {
  __shared__ uint32_t As[kKW][kPlanes][kPadRows];
  __shared__ uint32_t Bs[kKW][kPlanes][kPadRows];

  const int tx = threadIdx.x % kThreadsX;
  const int ty = threadIdx.x / kThreadsX;
  const int row0 = blockIdx.y * kBM;  // first local output row of the tile
  const int col0 = blockIdx.x * kBN;  // first local output column of the tile

  int acc4[kTM][kTN];
  int accn[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      acc4[i][j] = 0;
      accn[i][j] = 0;
    }
  }

  for (int64_t k0 = 0; k0 < W; k0 += kKW) {
    // stage the chunk: index = (row, plane, word) with the word fastest, so
    // a warp reads 64-byte runs of consecutive words from global memory
    for (int idx = threadIdx.x; idx < kBM * kPlanes * kKW; idx += kThreads) {
      const int k = idx % kKW;
      const int p = (idx / kKW) % kPlanes;
      const int r = idx / (kKW * kPlanes);
      const int64_t w = k0 + k;
      uint32_t va = 0u, vb = 0u;
      if (w < W) {
        if (row0 + r < rb) va = load_word(ea, nma, (int64_t)r0 + row0 + r, p, W, w);
        if (col0 + r < m) vb = load_word(eb, nmb, (int64_t)c0 + col0 + r, p, W, w);
      }
      As[k][p][r] = va;
      Bs[k][p][r] = vb;
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < kKW; ++k) {
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        uint32_t a[kTM], b[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = As[k][p][ty + kThreadsY * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = Bs[k][p][tx + kThreadsX * j];
        if (p < 4) {
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j) acc4[i][j] += __popc(a[i] & b[j]);
        } else {
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j) accn[i][j] += __popc(a[i] & b[j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + kThreadsY * i;
    if (r >= rb) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx + kThreadsX * j;
      if (c >= m) continue;
      const int64_t o = (int64_t)r * m + c;
      gn[o] = accn[i][j];
      g[o] = acc4[i][j] - accn[i][j];
    }
  }
}

}  // namespace

// C entry point, loaded with ctypes (tracs_tpu_torch/ops/kernels.py).
//
// ea, nma : A layout, [n_a, 4, W] and [n_a, W] uint32, contiguous
// eb, nmb : B layout, [n_b, 4, W] and [n_b, W] uint32, contiguous
// rows [r0, r0+rb) of A against rows [c0, c0+m) of B, where m = n_b - c0
// g, gn   : int32 [rb, m] outputs, contiguous
// stream  : the cudaStream_t to launch on
//
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).  The
// caller checks every bound; the kernel does not synchronise.
extern "C" int tracs_split_gram(const void* ea, const void* nma, const void* eb,
                                const void* nmb, long long W, int r0, int rb,
                                int c0, int m, void* g, void* gn, void* stream) {
  if (rb <= 0 || m <= 0) return 0;
  const dim3 grid((m + kBN - 1) / kBN, (rb + kBM - 1) / kBM);
  split_gram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ea), static_cast<const uint32_t*>(nma),
      static_cast<const uint32_t*>(eb), static_cast<const uint32_t*>(nmb),
      static_cast<int64_t>(W), r0, rb, c0, m, static_cast<int32_t*>(g),
      static_cast<int32_t*>(gn));
  return static_cast<int>(cudaGetLastError());
}
