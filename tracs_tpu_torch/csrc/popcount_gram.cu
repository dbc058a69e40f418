// Popcount engine on Hopper (sm_90a): match and N-union counts straight from
// the raw packed planes, both in one pass, on the b1 tensor cores.
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
// N = p0 & p1 & p2 & p3 is the N mask.  W, the planes' word pitch, is a
// multiple of 4 and the storage 16-byte aligned (the caller checks).
//
// Design.  The TPU kernels run as two grids over a [TI, TJ, WC] popcount
// intermediate in VMEM, on the vector unit.  An OR of ANDs is no matrix
// product, but by inclusion-exclusion over the OR it is a signed sum of 15:
// with a_S = AND_{x in S} a_x for the 15 non-empty subsets S of the planes,
//
//     matches = sum_S (-1)^(|S|+1) sum_w popc(a_S & b_S)
//     nunion  = cnt_N(a) + cnt_N(b) - sum_w popc(a_ACGT & b_ACGT)
//
// and each of the 15 AND + POPC grams of a 16 x 8 output tile over 256 sites
// is one tensor-core instruction on packed words,
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc.  Only the 4 raw
// planes are staged; a thread forms the subset operands in registers from the
// plane fragments it holds (one LOP3 each: an AND of up to three registers),
// so no derived plane exists in shared or device memory.  The instruction
// only adds, so there are three accumulator sets: the subsets of odd size,
// the pairs, and the 4-plane subset, which nunion needs alone:
// matches = odd - pairs - quad.
//
// A 256-thread block owns a 128 x 64 output tile; each of its 8 warps owns a
// 32 x 32 sub-tile (2 x 4 mma tiles, 3 x 32 accumulator registers a thread;
// 212 registers in all, no spills, one block an SM).  Three accumulator sets
// of a 128 x 128 tile would take 49,152 of an SM's 65,536 registers and leave
// none for the fragments, hence the narrower tile; the wide warp tile keeps
// the ANDs down (16 operand registers a subset for 8 mma).
//
// Staging (csrc/plane_ring.cuh, shared with csrc/partial_gram.cu).  The
// block walks the word axis in chunks of 32 words (four k256 steps) through
// a ring of two stages in shared memory, each the 4 planes of
// 128 A rows and 64 B rows (98,304 B).  The copies are TMA tensor loads
// (cp.async.bulk.tensor): a box of rows x 32 words of one plane lands as rows
// of 128 B in the 128-byte swizzle, eight boxes a chunk, issued by the
// block's first thread; no other thread computes an address or touches the
// data on its way in, rows of 128 B are whole L2 lines, and what a box reads
// past the operand's last row or word arrives as zeros (a zero word shares
// no allele and has N = 0, so it adds nothing; only the stores mask the
// ragged tile edge).  A stage's full mbarrier counts the bytes of its boxes;
// every warp waits on it, runs the stage's 480 mma, and arrives on the
// stage's empty mbarrier, on which the first thread waits before it refills
// the stage with the chunk two on: there is no block-wide barrier in the
// loop, so the warps drift apart by up to a chunk and the tensor cores are
// not left idle while the slowest one arrives.  A barrier that never
// completes traps after 2^22 polls instead of hanging the card.  The tensor
// maps are made by the launcher on every call through libcuda's
// cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint so that the
// build links nothing but the runtime, and passed as __grid_constant__
// arguments.  (The same loop fed by a 16-byte cp.async ring with one
// __syncthreads() a chunk took 28 ms for the block below instead of 21.)
//
// Fragments.  The sum over sites does not depend on which k slot a site lands
// in, as long as the A and the B operand use the same assignment, and which
// staged row plays which row of a fragment is free as long as the stores
// follow.  Holding all four k256 steps of all four planes would take 192
// registers, so a thread (grp = lane / 4, tig = lane % 4) takes one step at a
// time: 8 bytes of the step's 32 bytes of a staged row with one load, the two
// k halves of that mma.  Fragment row g of a group of 8 is staged row
// 2 (g % 4) + g / 4: the 4 rows a half-warp loads from then differ in the
// address bits the swizzle mixes in, and its 8-byte loads fall on all 32
// banks once.
//
// Row counts.  cnt_N(a) and cnt_N(b) come from the fragments too: the
// 4-plane operand of an A row is spread over the 4 threads of a group, each
// POPCs its words once, and the warps of a tile row (tile column) take turns
// by chunk, so every staged word of the N mask is counted exactly once a
// block; the sums meet in shared memory before the stores.
//
// Narrow blocks.  The all-pairs sweep calls this kernel with rb = 1024 and a
// shrinking column suffix: 512, 384, 256, then 128 tiles on 132 SMs that
// hold one block each, 97% of whole waves, so the four calls take times in
// proportion.  For other shapes the launcher cuts the word axis into s parts
// as csrc/split_gram.cu does, one block per (tile, part), and the parts add
// their sums (their share of the row counts included) to zeroed outputs with
// integer atomicAdd: bit-identical whatever s is.
//
// Range.  The odd accumulator sums 8 subsets of at most 32 bits a word:
// 256 W < 2^31 needs W < 2^23 words (268 M sites); the caller refuses more.
//
// What bounds it on an H100.  By operations it is 15 bit-products a site
// pair, 7.9 ms for the rb=1024 x n=4096 x 1 Mb block at the card's b1 peak
// (12.2 ms at the rate mma.sync reaches), far above the bytes-per-operation
// line.  Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (experiments/split_gram_probe.py): the whole kernel 21 ms for that block;
// its copies alone take about half of that and now hide behind the rest; the
// fragment loads, ANDs and mma without the copies take as long as the whole
// kernel, and about a fifth less with the ANDs left out.  So the warps' own
// instruction stream bounds it: per k256 step a warp issues 120 mma, 176 AND
// (LOP3) to form their operands and 32 shared-memory loads, and the ANDs and
// the mma do not overlap fully.  Fewer ANDs an mma would need a larger warp
// tile, which the three accumulator sets do not leave registers for.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "plane_ring.cuh"

namespace {

using namespace plane_ring;
using PTile = Tile<64, 2>;          // 128 x 64 outputs, a ring of two chunks
constexpr int kBN = PTile::kBN;
constexpr int kNT = PTile::kNT;     // 8-column mma tiles per warp (32 columns)
static_assert(PTile::kStageBytes == 98304 && PTile::kSmemBytes == 197632,
              "the ring described above");

// the accumulator set of subset S: 0 odd size, 1 pairs, 2 the 4-plane subset
template <int S>
constexpr int kSubsetSet =
    ((S & 1) + ((S >> 1) & 1) + ((S >> 2) & 1) + ((S >> 3) & 1)) == 2 ? 1 : S == 15 ? 2 : 0;

// One k256 step of subset S: the operands from the plane fragments ra and
// rb, then the warp's mma into the subset's accumulator set.  For the
// 4-plane subset, the N mask, also the popcounts of the operands this warp is
// due to count.
template <int S>
__device__ __forceinline__ void subset_step(int (&acc)[3][kMT][kNT][4],
                                            const uint2 (&ra)[kPlanes][kMT][2],
                                            const uint2 (&rb)[kPlanes][kNT],
                                            bool count_a, bool count_b,
                                            int (&cnt_a)[kMT][2], int (&cnt_b)[kNT]) {
  uint32_t a[kMT][4], b[kNT][2];
  subset_operands<S>(ra, rb, a, b);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_b1(acc[kSubsetSet<S>][i][j], a[i], b[j]);
  if constexpr (S == 15) {
    if (count_a) {
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        cnt_a[i][0] += __popc(a[i][0]) + __popc(a[i][2]);
        cnt_a[i][1] += __popc(a[i][1]) + __popc(a[i][3]);
      }
    }
    if (count_b) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) cnt_b[j] += __popc(b[j][0]) + __popc(b[j][1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
popcount_gram_kernel(const __grid_constant__ PlaneMaps maps, int64_t W, int r0, int rb, int c0,
                     int m, int part_chunks, int32_t* __restrict__ matches,
                     int32_t* __restrict__ nunion) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * PTile::kStages];   // full[s], then empty[s]
  __shared__ int row_cnt[kBM];   // N sites of the tile's A rows, this block's words
  __shared__ int col_cnt[kBN];   // and of its B rows

  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  // this block's part of the word axis, in chunks
  const int n_chunks = (int)((W + kKW - 1) / kKW);
  const int chunk0 = blockIdx.z * part_chunks;
  const int chunk1 = min(n_chunks, chunk0 + part_chunks);

  if (threadIdx.x < kBM) row_cnt[threadIdx.x] = 0;
  if (threadIdx.x < kBN) col_cnt[threadIdx.x] = 0;

  const WarpPos<PTile> wp;
  int acc[3][kMT][kNT][4];   // odd-size subsets, pairs, the 4-plane subset
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][i][j][e] = 0;
  int cnt_a[kMT][2] = {}, cnt_b[kNT] = {};

  auto step = [&](const uint2 (&ra)[kPlanes][kMT][2], const uint2 (&rbv)[kPlanes][kNT],
                  int chunk) {
    // the warps that share this warp's A rows (B rows) take turns by chunk
    const bool count_a = wp.wx == (chunk & (kWarpsN - 1));
    const bool count_b = wp.wy == (chunk & (kWarpsM - 1));
    // the 15 subsets, in an order in which each shares planes with the last
    subset_step<1>(acc, ra, rbv, count_a, count_b, cnt_a, cnt_b);
    subset_step<3>(acc, ra, rbv, count_a, count_b, cnt_a, cnt_b);
    subset_step<2>(acc, ra, rbv, count_a, count_b, cnt_a, cnt_b);
    subset_step<6>(acc, ra, rbv, count_a, count_b, cnt_a, cnt_b);
    subset_step<7>(acc, ra, rbv, count_a, count_b, cnt_a, cnt_b);
    subset_step<5>(acc, ra, rbv, count_a, count_b, cnt_a, cnt_b);
    subset_step<4>(acc, ra, rbv, count_a, count_b, cnt_a, cnt_b);
    subset_step<12>(acc, ra, rbv, count_a, count_b, cnt_a, cnt_b);
    subset_step<13>(acc, ra, rbv, count_a, count_b, cnt_a, cnt_b);
    subset_step<15>(acc, ra, rbv, count_a, count_b, cnt_a, cnt_b);
    subset_step<14>(acc, ra, rbv, count_a, count_b, cnt_a, cnt_b);
    subset_step<10>(acc, ra, rbv, count_a, count_b, cnt_a, cnt_b);
    subset_step<11>(acc, ra, rbv, count_a, count_b, cnt_a, cnt_b);
    subset_step<9>(acc, ra, rbv, count_a, count_b, cnt_a, cnt_b);
    subset_step<8>(acc, ra, rbv, count_a, count_b, cnt_a, cnt_b);
  };
  walk_chunks<PTile>(maps, smem_raw, bars, r0 + row0, c0 + col0, chunk0, chunk1, step);

  // the row counts: a row's words lie with the 4 threads of its group
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = cnt_a[i][h];
      v += __shfl_xor_sync(0xFFFFFFFFu, v, 1);
      v += __shfl_xor_sync(0xFFFFFFFFu, v, 2);
      if (wp.tig == 0 && v) atomicAdd(&row_cnt[wp.wm + i * 16 + 8 * h + wp.prow], v);
    }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    int v = cnt_b[j];
    v += __shfl_xor_sync(0xFFFFFFFFu, v, 1);
    v += __shfl_xor_sync(0xFFFFFFFFu, v, 2);
    if (wp.tig == 0 && v) atomicAdd(&col_cnt[wp.wn + j * 8 + wp.prow], v);
  }
  __syncthreads();

  const bool add = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = wp.row(i, e), lc = wp.col(j, e);
        const int r = row0 + lr, c = col0 + lc;
        if (r >= rb || c >= m) continue;
        const int64_t o = (int64_t)r * m + c;
        const int quad = acc[2][i][j][e];
        const int vm = acc[0][i][j][e] - acc[1][i][j][e] - quad;
        const int vu = row_cnt[lr] + col_cnt[lc] - quad;
        if (add) {
          atomicAdd(matches + o, vm);
          atomicAdd(nunion + o, vu);
        } else {
          matches[o] = vm;
          nunion[o] = vu;
        }
      }
}

}  // namespace
// C entry point, loaded with ctypes (tracs_tpu_torch/ops/kernels.py).
//
// pa : A planes, [n_a, 4, W] uint32, contiguous
// pb : B planes, [n_b, 4, W] uint32, contiguous
// W  : words of a plane row, a multiple of 4 below 2^23; both pointers
//      16-byte aligned
// rows [r0, r0+rb) of A against rows [c0, c0+m) of B, where m = n_b - c0
// word_splits : parts of the word axis; 0 = chosen here from the tile count
//               and the card's SM count
// matches, nunion : int32 [rb, m] outputs, contiguous
// stream : the cudaStream_t to launch on
//
// Returns the first CUDA error of the set-up or cudaGetLastError() after the
// launch (0 = cudaSuccess).  The caller checks every bound; the kernel does
// not synchronise.
extern "C" int tracs_popcount_gram(const void* pa, const void* pb, long long W,
                                   int r0, int rb, int c0, int m, int word_splits,
                                   void* matches, void* nunion, void* stream) {
  if (rb <= 0 || m <= 0) return 0;
  if (W % 4 || W >= (1LL << 23)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)rb * m * sizeof(int32_t);
  cudaError_t err;
  if (W == 0) {   // no site: both counts are zero, and a tensor map cannot be empty
    if ((err = cudaMemsetAsync(matches, 0, bytes, st)) == cudaSuccess)
      err = cudaMemsetAsync(nunion, 0, bytes, st);
    return static_cast<int>(err);
  }
  EncodeTiledFn encode;
  if ((err = encoder(&encode)) != cudaSuccess) return static_cast<int>(err);
  // the maps end at the block's last row and at n_b = c0 + m
  PlaneMaps maps;
  int rc;
  if ((rc = encode_map(encode, &maps.a, pa, W, (long long)r0 + rb, kBM))) return rc;
  if ((rc = encode_map(encode, &maps.b, pb, W, (long long)c0 + m, kBN))) return rc;
  err = cudaFuncSetAttribute(
      popcount_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PTile::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tiles_n = (m + kBN - 1) / kBN, tiles_m = (rb + kBM - 1) / kBM;
  const int n_chunks = (int)((W + kKW - 1) / kKW);
  int splits, part_chunks;
  err = plan_splits(word_splits, (long long)tiles_n * tiles_m, n_chunks, &splits, &part_chunks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    if ((err = cudaMemsetAsync(matches, 0, bytes, st)) != cudaSuccess)
      return static_cast<int>(err);
    if ((err = cudaMemsetAsync(nunion, 0, bytes, st)) != cudaSuccess)
      return static_cast<int>(err);
  }
  const dim3 grid(tiles_n, tiles_m, splits);
  popcount_gram_kernel<<<grid, kThreads, PTile::kSmemBytes, st>>>(
      maps, static_cast<int64_t>(W), r0, rb, c0, m, part_chunks,
      static_cast<int32_t*>(matches), static_cast<int32_t*>(nunion));
  return static_cast<int>(cudaGetLastError());
}
