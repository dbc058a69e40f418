// Popcount engine on Hopper (sm_90a): match and N-union counts straight from
// the raw packed planes, both in one pass.
//
// Replaces tracs_tpu/ops/pallas_kernels.py::_shared_kernel (K2) and
// ::_union_kernel (K3), and with them the XLA twin _gram_popcount of
// tracs_tpu/ops/pairsnp.py, which computes both outputs in one pass too.
// For a row block [r0, r0+rb) of the A planes against the row suffix
// [c0, n_b) of the B planes it writes, as int32 [rb, n_b - c0] row-major,
//
//     matches[i][j] = sum_w popc(OR_x(a[r0+i][x][w] & b[c0+j][x][w]))    (K2)
//     nunion [i][j] = sum_w popc(N_a[r0+i][w] | N_b[c0+j][w])             (K3)
//
// where a, b are the 4 raw allele planes [n, 4, W] (IUPAC codes set several
// bits, N sets all four), packed 32 sites per uint32 word, and
// N = p0 & p1 & p2 & p3 is the N mask.
//
// Design.  The TPU kernels run as two grids over a [TI, TJ, WC] popcount
// intermediate in VMEM; here one kernel does both on the CUDA cores and
// nothing is materialised.  Each 256-thread block owns a 64 x 64 output tile
// and walks the word axis in chunks of 16 words: the chunk's 64 A rows and
// 64 B rows are staged in shared memory as 5 planes each (the 4 raw planes
// and the N mask, derived from them while staging, so no N-mask array
// exists in device memory), and each thread accumulates a 4 x 4 sub-tile of
// both counts in registers.  Rows past the block, columns past n_b and words
// past W load as zero: a zero word shares no bit and has N = 0, so it adds
// nothing, and the store masks the ragged tile edge.
//
// What bounds it on an H100.  Per word pair the tile does 4 AND + 3 OR (the
// OR-of-ANDs folds into 4 LOP3), 1 OR for the union, 2 POPC and 2 IADD.
// POPC issues at 16 per clock per SM, a quarter of the LOP3/IADD rate, so
// the 2 POPC (1/8 clock per word pair per SM) and the ~7 ALU operations
// (~1/9 clock) cost about the same: the kernel is bound by the integer
// pipes, not by bytes, since a 64-row tile reuses every staged word 64
// times.  Against the split-gram kernel (5 POPC per word pair) it does 2.5x
// fewer POPC but only ~1.4x fewer ALU operations, and it measured 1.9x
// faster (98.6 vs 188.3 ms for a 1024 x 4096 x 31250-word block on an H100
// SXM at 700 W, about 63% of the POPC issue rate), with 100 registers a
// thread against split_gram's 64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;      // output rows per block
constexpr int kBN = 64;      // output columns per block
constexpr int kKW = 16;      // words per staged chunk
constexpr int kTM = 4;       // output rows per thread
constexpr int kTN = 4;       // output columns per thread
constexpr int kPlanes = 5;   // 4 raw planes + the derived N mask
constexpr int kThreadsX = kBN / kTN;              // 16
constexpr int kThreadsY = kBM / kTM;              // 16
constexpr int kThreads = kThreadsX * kThreadsY;   // 256
// +1 word of padding per (word, plane) row of the staged tiles, against
// shared-memory bank conflicts of the staging stores (word index fastest)
constexpr int kPadRows = kBM + 1;

// Stages word w of the 4 planes of ``row`` and their N mask into
// tile[k][0..4][r]; a row or word outside the operand stages zeros.
__device__ __forceinline__ void stage_word(
    const uint32_t* __restrict__ p, bool valid, int64_t row, int64_t W,
    int64_t w, int k, int r, uint32_t (*tile)[kPlanes][kPadRows]) {
  uint32_t v0 = 0u, v1 = 0u, v2 = 0u, v3 = 0u;
  if (valid) {
    const uint32_t* base = p + row * 4 * W + w;
    v0 = base[0];
    v1 = base[W];
    v2 = base[2 * W];
    v3 = base[3 * W];
  }
  tile[k][0][r] = v0;
  tile[k][1][r] = v1;
  tile[k][2][r] = v2;
  tile[k][3][r] = v3;
  tile[k][4][r] = v0 & v1 & v2 & v3;
}

__global__ void __launch_bounds__(kThreads)
popcount_gram_kernel(const uint32_t* __restrict__ pa, const uint32_t* __restrict__ pb,
                     int64_t W, int r0, int rb, int c0, int m,
                     int32_t* __restrict__ matches, int32_t* __restrict__ nunion) {
  __shared__ uint32_t As[kKW][kPlanes][kPadRows];
  __shared__ uint32_t Bs[kKW][kPlanes][kPadRows];

  const int tx = threadIdx.x % kThreadsX;
  const int ty = threadIdx.x / kThreadsX;
  const int row0 = blockIdx.y * kBM;  // first local output row of the tile
  const int col0 = blockIdx.x * kBN;  // first local output column of the tile

  int accm[kTM][kTN];
  int accu[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      accm[i][j] = 0;
      accu[i][j] = 0;
    }
  }

  for (int64_t k0 = 0; k0 < W; k0 += kKW) {
    // stage the chunk: index = (row, word) with the word fastest, so a warp
    // reads 64-byte runs of consecutive words of each plane
    for (int idx = threadIdx.x; idx < kBM * kKW; idx += kThreads) {
      const int k = idx % kKW;
      const int r = idx / kKW;
      const int64_t w = k0 + k;
      stage_word(pa, w < W && row0 + r < rb, (int64_t)r0 + row0 + r, W, w, k, r, As);
      stage_word(pb, w < W && col0 + r < m, (int64_t)c0 + col0 + r, W, w, k, r, Bs);
    }
    __syncthreads();

#pragma unroll 2
    for (int k = 0; k < kKW; ++k) {
      uint32_t a[kPlanes][kTM], b[kPlanes][kTN];
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[p][i] = As[k][p][ty + kThreadsY * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[p][j] = Bs[k][p][tx + kThreadsX * j];
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const uint32_t shared = (a[0][i] & b[0][j]) | (a[1][i] & b[1][j]) |
                                  (a[2][i] & b[2][j]) | (a[3][i] & b[3][j]);
          accm[i][j] += __popc(shared);
          accu[i][j] += __popc(a[4][i] | b[4][j]);
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
      matches[o] = accm[i][j];
      nunion[o] = accu[i][j];
    }
  }
}

}  // namespace

// C entry point, loaded with ctypes (tracs_tpu_torch/ops/kernels.py).
//
// pa : A planes, [n_a, 4, W] uint32, contiguous
// pb : B planes, [n_b, 4, W] uint32, contiguous
// rows [r0, r0+rb) of A against rows [c0, c0+m) of B, where m = n_b - c0
// matches, nunion : int32 [rb, m] outputs, contiguous
// stream : the cudaStream_t to launch on
//
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).  The
// caller checks every bound; the kernel does not synchronise.
extern "C" int tracs_popcount_gram(const void* pa, const void* pb, long long W,
                                   int r0, int rb, int c0, int m, void* matches,
                                   void* nunion, void* stream) {
  if (rb <= 0 || m <= 0) return 0;
  const dim3 grid((m + kBN - 1) / kBN, (rb + kBM - 1) / kBM);
  popcount_gram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pa), static_cast<const uint32_t*>(pb),
      static_cast<int64_t>(W), r0, rb, c0, m, static_cast<int32_t*>(matches),
      static_cast<int32_t*>(nunion));
  return static_cast<int>(cudaGetLastError());
}
