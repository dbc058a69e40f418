// Split-decomposition grams on Hopper (sm_90a), straight from packed words,
// on the tensor cores.
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
// [n, W], both packed 32 sites per uint32 word.  W, the layouts' word pitch,
// is a multiple of 4 and the storage 16-byte aligned (the caller checks).
//
// Design.  The TPU kernel unpacks every bit to an int8 0/1 value so that its
// matrix unit can take the dot product; that unpack is a workaround for the
// TPU.  Here the AND + POPC of one 16 x 8 output tile over 256 sites is one
// tensor-core instruction on the packed words,
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc, and nothing is
// unpacked.  A 512-thread block owns a 128 x 128 output tile; each of its 16
// warps owns a 32 x 32 sub-tile (2 x 4 mma tiles for each gram, 64
// accumulator registers a thread; 128 registers in all, no spills).  The block
// walks the word axis in chunks of 16 words (two k256 steps) through a ring of
// two chunk buffers in shared memory, 5 planes of 128 A rows and 128 B rows
// each (81,920 B a buffer, one block an SM):
// while the warps run the 80 mma of one chunk, the 16-byte cp.async copies of
// the next one are in flight, and one __syncthreads() a chunk orders both the
// arrival of a buffer and its reuse.  Rows past the block, columns past n_b
// and words past W are copied with a source size of 0, which fills the 16
// bytes with zeros and adds nothing to either gram; only the stores mask the
// ragged tile edge.
//
// Fragments.  The sum over sites does not depend on which k slot a site
// lands in, as long as the A and the B operand use the same assignment.  So
// a thread (grp = lane / 4, tig = lane % 4) takes the four words
// 4 tig .. 4 tig + 3 of a staged row with one 16-byte load: words 0 and 1
// are the two k halves of the chunk's first mma, words 2 and 3 those of the
// second.  A staged row is 16 words with no padding: a quarter-warp's 16-byte
// loads cover two rows, 128 contiguous bytes, all 32 banks once, and so do
// the 16-byte stores of the copies.
//
// Narrow blocks.  The all-pairs sweep calls this kernel with rb = 1024 and a
// shrinking column suffix: 256, 192, 128, then 64 tiles on 132 SMs that hold
// one block each.  Where whole tiles would leave SMs idle in the last wave,
// the launcher cuts the word axis into s parts, one block per (tile, part),
// and the parts add their sums to zeroed outputs with integer atomicAdd: s
// is the smallest count that minimises ceil(tiles * s / SMs) / s.  Integer
// sums are the same in any order, so the outputs are bit-identical whatever s
// is.
//
// What bounds it on an H100.  By operations it is a matrix product far above
// the card's bytes-per-operation line (a 128 x 128 tile reuses every staged
// word 128 times), but neither the tensor cores nor device memory hold it
// back: the copies do.  Per chunk a block brings 80 KB from L2 into shared
// memory as 64-byte row pieces, 41 GB per main-path block (rb=1024 x n=4096 x
// 1 Mb), and the 16-byte cp.async requests deliver them at about 3.3 TB/s.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (experiments/split_gram_probe.py): the whole
// kernel 14 ms for that block, the copies alone 12 ms, the mma with their
// fragment loads alone 7 ms, and the same mma issued back to back from
// registers 4.1 ms (6.7 clocks an instruction a tensor core).  8-word chunks
// in rings of 3 to 5 buffers are slower (18 to 21 ms: twice the requests for
// the same bytes), so the constants below stay at 16 words and 2 buffers;
// kKW = 8 still builds, for that comparison.  Fewer bytes from L2 (a larger
// tile, or one copy shared by the blocks of a cluster) or a copy engine that
// asks in larger pieces (TMA, as the b1-128 variant of csrc/split_gram_mma.cu
// does) is what would move it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;     // output rows per block
constexpr int kBN = 128;     // output columns per block
constexpr int kKW = 16;      // words per staged chunk: kKW / 8 k256 steps
constexpr int kPlanes = 5;   // 4 exclusive planes + the N mask
constexpr int kStages = 2;   // chunk buffers in the ring
constexpr int kMT = 2;       // 16-row mma tiles per warp (32 rows)
constexpr int kNT = 4;       // 8-column mma tiles per warp (32 columns)
constexpr int kThreads = (kBM / 32) * (kBN / 32) * 32;          // 512
constexpr int kRows = kBM + kBN;                                 // staged rows a plane
constexpr int kStageWords = kPlanes * kRows * kKW;
constexpr int kSmemBytes = kStages * kStageWords * (int)sizeof(uint32_t);
constexpr int kPieces = kKW / 4;                  // 16-byte pieces of a staged row
constexpr int kPasses = kRows * kPieces / kThreads;   // staged rows a thread copies
constexpr int kMaxSplits = 16;      // most parts of the word axis
constexpr int kMinSplitChunks = 1024 / kKW;   // fewest chunks a part is worth

static_assert(kKW == 8 || kKW == 16, "a fragment load takes 8 or 16 bytes of a row");
static_assert(kStages >= 2 && kSmemBytes <= 227 * 1024, "the ring fits an SM");
static_assert(kRows * kPieces % kThreads == 0, "every thread copies kPasses rows a plane");

__device__ __forceinline__ void mma_b1(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, asynchronously, past L1; ``bytes``
// is 16, or 0 to fill the 16 bytes with zeros and read nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most kStages - 2 of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
split_gram_kernel(const uint32_t* __restrict__ ea, const uint32_t* __restrict__ nma,
                  const uint32_t* __restrict__ eb, const uint32_t* __restrict__ nmb,
                  int64_t W, int r0, int rb, int c0, int m, int part_chunks,
                  int32_t* __restrict__ g, int32_t* __restrict__ gn) {
  // [stage][plane][A rows, then B rows][kKW words]
  extern __shared__ __align__(16) uint32_t smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;   // row of a 16x8 tile's A fragment, column of its B fragment
  const int tig = lane & 3;    // k slot of the fragments, column pair of the accumulator
  const int wm = (warp / (kBN / 32)) * 32;   // the warp's rows inside the block tile
  const int wn = (warp % (kBN / 32)) * 32;   // the warp's columns inside the block tile
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  // this block's part of the word axis, in chunks
  const int n_chunks = (int)((W + kKW - 1) / kKW);
  const int chunk0 = blockIdx.z * part_chunks;
  const int chunk1 = min(n_chunks, chunk0 + part_chunks);

  // staging: piece sq (4 words) of the staged rows sr + pass * (kThreads /
  // kPieces), every plane; staged rows below kBM are A rows, the others B rows
  const int sq = threadIdx.x % kPieces;
  const int sr = threadIdx.x / kPieces;
  const uint32_t* src_e[kPasses];   // the row's piece in plane 0; plane p is p * W on
  const uint32_t* src_n[kPasses];   // the row's piece in the mask
  bool in_rows[kPasses];
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int row = sr + pass * (kThreads / kPieces);
    const bool side_b = row >= kBM;
    in_rows[pass] = side_b ? col0 + row - kBM < m : row0 + row < rb;
    const int64_t src_row =
        !in_rows[pass] ? 0 : side_b ? (int64_t)c0 + col0 + row - kBM : (int64_t)r0 + row0 + row;
    src_e[pass] = (side_b ? eb : ea) + src_row * 4 * W + sq * 4;
    src_n[pass] = (side_b ? nmb : nma) + src_row * W + sq * 4;
  }
  const uint32_t dst0 =
      (uint32_t)__cvta_generic_to_shared(smem) + (sr * kKW + sq * 4) * (int)sizeof(uint32_t);

  auto stage = [&](int buf, int chunk) {
    const int64_t k0 = (int64_t)chunk * kKW;
    const bool in_w = k0 + sq * 4 < W;   // W is a multiple of 4: a piece is in or out whole
    constexpr int kPlaneBytes = kRows * kKW * (int)sizeof(uint32_t);
    constexpr int kPassBytes = (kThreads / kPieces) * kKW * (int)sizeof(uint32_t);
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int bytes = in_rows[pass] && in_w ? 16 : 0;
      const uint32_t dst = dst0 + buf * kStageWords * (int)sizeof(uint32_t) + pass * kPassBytes;
      // a piece that reads nothing names the layout's first word as its source
#pragma unroll
      for (int p = 0; p < 4; ++p)
        cp_async16(dst + p * kPlaneBytes, bytes ? src_e[pass] + p * W + k0 : ea, bytes);
      cp_async16(dst + 4 * kPlaneBytes, bytes ? src_n[pass] + k0 : nma, bytes);
    }
  };

  int acc4[kMT][kNT][4];
  int accn[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc4[i][j][e] = 0;
        accn[i][j][e] = 0;
      }

  // one staged chunk of plane p into the accumulators acc: a thread takes
  // words (kKW / 4) tig .. of a row in one load, two words a k256 step
  auto plane = [&](int (&acc)[kMT][kNT][4], const uint32_t* buf, int p) {
    const uint32_t* Ap = buf + (p * kRows + wm + grp) * kKW + (kKW / 4) * tig;
    const uint32_t* Bp = buf + (p * kRows + kBM + wn + grp) * kKW + (kKW / 4) * tig;
    if constexpr (kKW == 16) {
      uint4 a[kMT][2], b[kNT];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        a[i][0] = *reinterpret_cast<const uint4*>(Ap + (i * 16) * kKW);
        a[i][1] = *reinterpret_cast<const uint4*>(Ap + (i * 16 + 8) * kKW);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) b[j] = *reinterpret_cast<const uint4*>(Bp + (j * 8) * kKW);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_b1(acc[i][j], a[i][0].x, a[i][1].x, a[i][0].y, a[i][1].y, b[j].x, b[j].y);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_b1(acc[i][j], a[i][0].z, a[i][1].z, a[i][0].w, a[i][1].w, b[j].z, b[j].w);
    } else {
      uint2 a[kMT][2], b[kNT];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        a[i][0] = *reinterpret_cast<const uint2*>(Ap + (i * 16) * kKW);
        a[i][1] = *reinterpret_cast<const uint2*>(Ap + (i * 16 + 8) * kKW);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) b[j] = *reinterpret_cast<const uint2*>(Bp + (j * 8) * kKW);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_b1(acc[i][j], a[i][0].x, a[i][1].x, a[i][0].y, a[i][1].y, b[j].x, b[j].y);
    }
  };

  // the ring: kStages - 1 chunks are in flight ahead of the one computed
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (chunk0 + s < chunk1) stage(s, chunk0 + s);
    cp_async_commit();
  }
  int buf = 0;   // the buffer of ``chunk``
  for (int chunk = chunk0; chunk < chunk1; ++chunk) {
    // this chunk has landed, and every warp is done with the buffer of the
    // chunk before it, which the copies issued next fill again
    cp_async_wait_oldest();
    __syncthreads();
    const int ahead = chunk + kStages - 1;
    if (ahead < chunk1) stage(buf == 0 ? kStages - 1 : buf - 1, ahead);
    cp_async_commit();

    const uint32_t* cur = smem + buf * kStageWords;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      if (p < 4)
        plane(acc4, cur, p);
      else
        plane(accn, cur, p);
    }
    buf = buf + 1 == kStages ? 0 : buf + 1;
  }

  const bool add = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // accumulator element e: row grp + 8 (e / 2), column 2 tig + e % 2
        const int r = row0 + wm + i * 16 + grp + 8 * (e >> 1);
        const int c = col0 + wn + j * 8 + 2 * tig + (e & 1);
        if (r >= rb || c >= m) continue;
        const int64_t o = (int64_t)r * m + c;
        const int vn = accn[i][j][e];
        const int v = acc4[i][j][e] - vn;
        if (add) {
          atomicAdd(gn + o, vn);
          atomicAdd(g + o, v);
        } else {
          gn[o] = vn;
          g[o] = v;
        }
      }
}

// parts of the word axis for ``tiles`` output tiles on ``sms`` SMs (one block
// an SM): the smallest s that minimises ceil(tiles * s / sms) / s, the sweep's
// time in units of one whole tile, while a part keeps kMinSplitChunks chunks
int choose_splits(long long tiles, int sms, int n_chunks) {
  int best = 1;
  double best_cost = (double)((tiles + sms - 1) / sms);
  for (int s = 2; s <= kMaxSplits && n_chunks / s >= kMinSplitChunks; ++s) {
    const double cost = (double)((tiles * s + sms - 1) / sms) / s;
    if (cost < best_cost * 0.98) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace

// C entry point, loaded with ctypes (tracs_tpu_torch/ops/kernels.py).
//
// ea, nma : A layout, [n_a, 4, W] and [n_a, W] uint32, contiguous
// eb, nmb : B layout, [n_b, 4, W] and [n_b, W] uint32, contiguous
// W       : words of a plane row, a multiple of 4; every pointer 16-byte aligned
// rows [r0, r0+rb) of A against rows [c0, c0+m) of B, where m = n_b - c0
// word_splits : parts of the word axis; 0 = chosen here from the tile count
//               and the card's SM count
// g, gn   : int32 [rb, m] outputs, contiguous
// stream  : the cudaStream_t to launch on
//
// Returns the first CUDA error of the set-up or cudaGetLastError() after the
// launch (0 = cudaSuccess).  The caller checks every bound; the kernel does
// not synchronise.
extern "C" int tracs_split_gram(const void* ea, const void* nma, const void* eb,
                                const void* nmb, long long W, int r0, int rb,
                                int c0, int m, int word_splits, void* g, void* gn,
                                void* stream) {
  if (rb <= 0 || m <= 0) return 0;
  if (W % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      split_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tiles_n = (m + kBN - 1) / kBN, tiles_m = (rb + kBM - 1) / kBM;
  const int n_chunks = W > 0 ? (int)((W + kKW - 1) / kKW) : 1;
  int splits = word_splits;
  if (splits <= 0) {
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    splits = choose_splits((long long)tiles_n * tiles_m, sms, n_chunks);
  }
  if (splits > n_chunks) splits = n_chunks;
  const int part_chunks = (n_chunks + splits - 1) / splits;
  splits = (n_chunks + part_chunks - 1) / part_chunks;  // no part is empty
  if (splits > 1) {
    const size_t bytes = (size_t)rb * m * sizeof(int32_t);
    if ((err = cudaMemsetAsync(g, 0, bytes, st)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaMemsetAsync(gn, 0, bytes, st)) != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(tiles_n, tiles_m, splits);
  split_gram_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const uint32_t*>(ea), static_cast<const uint32_t*>(nma),
      static_cast<const uint32_t*>(eb), static_cast<const uint32_t*>(nmb),
      static_cast<int64_t>(W), r0, rb, c0, m, part_chunks, static_cast<int32_t*>(g),
      static_cast<int32_t*>(gn));
  return static_cast<int>(cudaGetLastError());
}
