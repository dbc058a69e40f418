// The partial-IUPAC correction gram of the split decomposition on Hopper
// (sm_90a), on the b1 tensor cores straight from the packed words.
//
// Replaces tracs_tpu/ops/pairsnp.py::_gram_partial (XLA: the 10 plane-pair and
// plane-triple AND channels unpacked to int8 and contracted on the matrix
// unit).  From the exclusive planes at the partial sites, part_a [na, 4, W]
// and part_b [nb, 4, W] (uint32 words), it writes int32 [na, nb]
//
//   out[i, j] = sum_{|S|=3} G_S - sum_{|S|=2} G_S,
//   G_S[i, j] = sum_w popc(AND_{x in S} a_i,x[w] & AND_{x in S} b_j,x[w]),
//
// over the 6 plane pairs and the 4 plane triples, for every bit pattern of the
// words.
//
// What bounds it on an H100.  At the main path's block (1024 x 4096 pairs, 64
// words) the operands are 5 MB and the output 16.8 MB, a bytes bound of about
// 6 us; the 10 AND-products a site pair are 11 us at the card's b1 tensor-core
// peak (15.8 POP/s, 8 x int8's) and about 17 us at the rate mma.sync reaches.
// So it is bound by operations.  On the CUDA cores, where the 10 products
// fold into 2 POPC a word pair, POPC (16 a clock on an SM) bounds it at
// 0.13 ms, and such a kernel took 0.25 ms on the card.
//
// Design.  The TPU ran _gram_partial on its matrix unit; here each of the 10
// grams of a 16 x 8 output tile over 256 sites is one tensor-core instruction,
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc, on operands
// formed in registers from the 4 staged planes (one LOP3 each), exactly as
// csrc/popcount_gram.cu forms its 15 subset grams: the staging, the fragments
// and the TMA ring are that kernel's, shared through csrc/plane_ring.cuh.
// The instruction only adds, so there are two accumulator sets, the pairs and
// the triples, and the store writes triples - pairs.  The K axis is short (64
// words are 2 chunks of the ring, 8 k256 steps), so what matters is the tile:
// the block owns 128 x 64 outputs, 8 warps of 32 x 32, and the ring has two
// stages (192 KiB: one block an SM, both chunks of a 64-word block in flight
// at once).  On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// block_kernels) the block above takes 0.051 ms on the card (186 registers,
// no spills).  A 128 x 128 tile (one stage of 128 KiB, twice the
// accumulators, the A rows staged once per 128 columns) was no faster: 0.052
// ms at 255 registers with 32 B spilled (both built from this source and
// timed on the card).  Each 128 x 64 tile stages
// 192 KiB of planes from L2 for 8 k256 steps of 80 mma a warp, one block an
// SM, so the staging and the store of each tile do not overlap the next
// tile's mma.  Where whole tiles would leave SMs idle the word axis is cut
// into parts that add with integer atomics (plane_ring.cuh).
//
// Range.  The pairs' set sums 6 products of at most 32 sites a word:
// 192 W < 2^31 needs W < 2^23 words; the caller refuses more.  A zero word
// adds nothing to any gram, so the partial planes carry the card's word pitch
// (a multiple of 4 words, ops/kernels.py::pad_planes) as the raw planes do.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "plane_ring.cuh"

namespace {

using namespace plane_ring;

// One k256 step of subset S into accumulator set SET (0 the pairs, 1 the
// triples).
template <int S, int SET, int NT>
__device__ __forceinline__ void subset_mma(int (&acc)[2][kMT][NT][4],
                                           const uint2 (&ra)[kPlanes][kMT][2],
                                           const uint2 (&rb)[kPlanes][NT]) {
  uint32_t a[kMT][4], b[NT][2];
  subset_operands<S>(ra, rb, a, b);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_b1(acc[SET][i][j], a[i], b[j]);
}

template <class T>
__global__ void __launch_bounds__(kThreads, 1)
partial_gram_kernel(const __grid_constant__ PlaneMaps maps, int64_t W, int na, int nb,
                    int part_chunks, int32_t* __restrict__ out) {
  constexpr int kNT = T::kNT;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * T::kStages];   // full[s], then empty[s]

  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * T::kBN;
  // this block's part of the word axis, in chunks
  const int n_chunks = (int)((W + kKW - 1) / kKW);
  const int chunk0 = blockIdx.z * part_chunks;
  const int chunk1 = min(n_chunks, chunk0 + part_chunks);

  int acc[2][kMT][kNT][4];   // the pairs, the triples
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][i][j][e] = 0;

  auto step = [&](const uint2 (&ra)[kPlanes][kMT][2], const uint2 (&rb)[kPlanes][kNT], int) {
    // the 10 subsets, in an order in which each shares planes with the last
    subset_mma<3, 0>(acc, ra, rb);
    subset_mma<7, 1>(acc, ra, rb);
    subset_mma<6, 0>(acc, ra, rb);
    subset_mma<14, 1>(acc, ra, rb);
    subset_mma<12, 0>(acc, ra, rb);
    subset_mma<13, 1>(acc, ra, rb);
    subset_mma<9, 0>(acc, ra, rb);
    subset_mma<11, 1>(acc, ra, rb);
    subset_mma<10, 0>(acc, ra, rb);
    subset_mma<5, 0>(acc, ra, rb);
  };
  walk_chunks<T>(maps, smem_raw, bars, row0, col0, chunk0, chunk1, step);

  const WarpPos<T> wp;
  const bool add = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wp.row(i, e), c = col0 + wp.col(j, e);
        if (r >= na || c >= nb) continue;
        const int64_t o = (int64_t)r * nb + c;
        const int v = acc[1][i][j][e] - acc[0][i][j][e];
        if (add) {
          atomicAdd(out + o, v);
        } else {
          out[o] = v;
        }
      }
}

// the block tile: 128 x 64 on a ring of two chunks
using PartialTile = Tile<64, 2>;

int launch(const void* pa, const void* pb, long long na, long long nb, long long W,
           int word_splits, void* out, cudaStream_t st) {
  using T = PartialTile;
  EncodeTiledFn encode;
  cudaError_t err;
  if ((err = encoder(&encode)) != cudaSuccess) return static_cast<int>(err);
  PlaneMaps maps;
  int rc;
  if ((rc = encode_map(encode, &maps.a, pa, W, na, kBM))) return rc;
  if ((rc = encode_map(encode, &maps.b, pb, W, nb, T::kBN))) return rc;
  err = cudaFuncSetAttribute(partial_gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles_n = (nb + T::kBN - 1) / T::kBN, tiles_m = (na + kBM - 1) / kBM;
  const int n_chunks = (int)((W + kKW - 1) / kKW);
  int splits, part_chunks;
  err = plan_splits(word_splits, tiles_n * tiles_m, n_chunks, &splits, &part_chunks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    err = cudaMemsetAsync(out, 0, (size_t)na * nb * sizeof(int32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((unsigned)tiles_n, (unsigned)tiles_m, splits);
  partial_gram_kernel<T><<<grid, kThreads, T::kSmemBytes, st>>>(
      maps, static_cast<int64_t>(W), (int)na, (int)nb, part_chunks, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int attributes(int* registers, int* local_bytes, int* shared_bytes) {
  using T = PartialTile;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, partial_gram_kernel<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes + T::kSmemBytes;
  return 0;
}

}  // namespace

// C entry point, loaded with ctypes (tracs_tpu_torch/ops/kernels.py).
//
// pa, pb : [na, 4, W] and [nb, 4, W] uint32 planes at the partial sites,
//          contiguous, 16-byte aligned
// W      : words of a plane row, a multiple of 4 below 2^23
// word_splits : parts of the word axis; 0 = chosen here from the tile count
//               and the card's SM count
// out    : int32 [na, nb], contiguous
// stream : the cudaStream_t to launch on
//
// Returns the first CUDA error of the set-up or cudaGetLastError() after the
// launch (0 = cudaSuccess).  The caller checks every bound (na below 65535
// tiles of 128 rows); the kernel does not synchronise.
extern "C" int tracs_partial_gram(const void* pa, const void* pb, long long na, long long nb,
                                  long long W, int word_splits, void* out, void* stream) {
  if (na <= 0 || nb <= 0) return 0;
  if (W % 4 || W >= (1LL << 23)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W == 0)   // no site: every gram is zero, and a tensor map cannot be empty
    return static_cast<int>(cudaMemsetAsync(out, 0, (size_t)na * nb * sizeof(int32_t), st));
  return launch(pa, pb, na, nb, W, word_splits, out, st);
}

// The build's facts of the kernel: registers a thread, local memory a thread
// (spills), shared memory a block (static + the ring).
extern "C" int tracs_partial_gram_attributes(int* registers, int* local_bytes,
                                             int* shared_bytes) {
  return attributes(registers, local_bytes, shared_bytes);
}
