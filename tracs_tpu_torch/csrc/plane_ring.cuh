// The staging and tensor-core fragments shared by the b1 plane-subset gram
// kernels on Hopper (sm_90a): csrc/popcount_gram.cu and csrc/partial_gram.cu.
//
// Both compute, for a tile of A rows against a tile of B rows of [n, 4, W]
// packed planes (32 sites a uint32 word), AND + POPC grams of plane-subset
// operands, G_S[i][j] = sum_w popc(a_S[i][w] & b_S[j][w]) with
// a_S = AND_{x in S} a_x, each 16 x 8 x 256-site piece one tensor-core
// instruction, mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc.
// Only the 4 planes are staged; a thread forms the subset operands in
// registers from the plane fragments it holds (one LOP3 each), so no derived
// plane exists in shared or device memory.  What differs between the kernels
// is which subsets they form, into how many accumulator sets, and the tile
// width: that is theirs; this header is the rest.
//
// The block tile is kBM = 128 rows x BN columns, 8 warps of 32 x BN/2 (4
// down, 2 across).  The block walks the word axis in chunks of kKW = 32 words
// (four k256 steps) through a ring of STAGES stages in shared memory, each
// the 4 planes of the tile's A rows and B rows.  The copies are TMA tensor
// loads (cp.async.bulk.tensor): a box of rows x 32 words of one plane lands
// as rows of 128 B in the 128-byte swizzle, eight boxes a chunk, issued by the
// block's first thread; what a box reads past the operand's last row or word
// arrives as zeros (a zero word adds nothing to any AND gram).  A stage's full
// mbarrier counts the bytes of its boxes; every warp waits on it, runs the
// chunk, and arrives on the stage's empty mbarrier, on which the first thread
// waits before it refills the stage: there is no block-wide barrier in the
// loop.  A barrier that never completes traps after 2^22 polls instead of
// hanging the card.  The tensor maps are made by the launcher through libcuda's
// cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint so that the
// build links nothing but the runtime, and passed as __grid_constant__
// arguments.  The word pitch W is therefore a multiple of 4 (TMA takes only
// strides that are multiples of 16 bytes) and the storage 16-byte aligned.
//
// Fragments.  The sum over sites does not depend on which k slot a site lands
// in, as long as the A and the B operand use the same assignment, and which
// staged row plays which row of a fragment is free as long as the stores
// follow.  A thread (grp = lane / 4, tig = lane % 4) takes one k256 step at a
// time: 8 bytes of the step's 32 bytes of a staged row with one load, the two
// k halves of that mma.  Fragment row g of a group of 8 is staged row
// perm(g) = 2 (g % 4) + g / 4: the 4 rows a half-warp loads from then differ
// in the address bits the swizzle mixes in, and its 8-byte loads fall on all
// 32 banks once.
//
// Narrow calls.  Where whole tiles would leave SMs idle, the launcher cuts the
// word axis into parts (choose_splits), one block per (tile, part); the parts
// add their sums to zeroed outputs with integer atomicAdd: bit-identical
// whatever the cut.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace plane_ring {

constexpr int kKW = 32;      // words per staged chunk: a row of 128 B, four k256 steps
constexpr int kPlanes = 4;   // the staged planes; the subsets are formed in registers
constexpr int kBM = 128;     // output rows per block
constexpr int kMT = 2;       // 16-row mma tiles per warp (32 rows)
constexpr int kWarpsM = kBM / (16 * kMT);   // warps down a tile: 4
constexpr int kWarpsN = 2;                  // warps across a tile
constexpr int kThreads = kWarpsM * kWarpsN * 32;   // 256
constexpr int kMaxSplits = 16;               // most parts of the word axis
constexpr int kMinSplitChunks = 1024 / kKW;  // fewest chunks a part is worth
constexpr unsigned kSpinLimit = 1u << 22;    // polls of a barrier before the kernel gives up

static_assert(kKW == 32, "a staged row is the 128 bytes of the swizzle");
static_assert((kWarpsM & (kWarpsM - 1)) == 0 && (kWarpsN & (kWarpsN - 1)) == 0,
              "warps that share rows take turns by chunk & (warps - 1)");

// A block tile of kBM x BN outputs staged through a ring of STAGES chunks.
template <int BN, int STAGES>
struct Tile {
  static constexpr int kBN = BN;
  static constexpr int kStages = STAGES;
  static constexpr int kNT = BN / (8 * kWarpsN);        // 8-column mma tiles per warp
  static constexpr int kTileBytesA = kBM * kKW * 4;     // one plane's A rows
  static constexpr int kTileBytesB = BN * kKW * 4;      // one plane's B rows
  static constexpr int kPlaneBytes = kTileBytesA + kTileBytesB;
  static constexpr int kStageBytes = kPlanes * kPlaneBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;   // + room to align to 1,024 B
  static_assert(kNT >= 1 && BN == 8 * kWarpsN * kNT, "the warps cover the tile's columns");
  static_assert(STAGES >= 1 && kSmemBytes <= 227 * 1024, "the ring fits an SM");
  static_assert(kTileBytesA % 1024 == 0 && kTileBytesB % 1024 == 0,
                "every tile starts at a multiple of the swizzle's period");
};

struct PlaneMaps {
  CUtensorMap a, b;   // the [n, 4, W] planes of the two operands
};

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// waits for the phase of parity ``parity`` to complete; a barrier that never
// completes (a fault in the ring) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (unsigned spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins > kSpinLimit) __trap();
  }
}

// one box (rows x 128 B of one plane) from global to this block's shared
// memory; completes, with its bytes, on the mbarrier ``bar``
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int word, int plane, int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(map), "r"(bar), "r"(word), "r"(plane), "r"(row) : "memory");
}

// the AND of the registers of x whose plane is in subset S (a bit mask)
template <int S>
__device__ __forceinline__ uint32_t subset_and(uint32_t x0, uint32_t x1, uint32_t x2,
                                               uint32_t x3) {
  uint32_t v = 0xFFFFFFFFu;
  if constexpr (S & 1) v &= x0;
  if constexpr (S & 2) v &= x1;
  if constexpr (S & 4) v &= x2;
  if constexpr (S & 8) v &= x3;
  return v;
}

// The mma operands of subset S for one k256 step from the plane fragments
// ra (rows grp and grp + 8 of each mma tile; .x and .y the two k halves) and
// rb (column grp of each mma tile).
template <int S, int NT>
__device__ __forceinline__ void subset_operands(const uint2 (&ra)[kPlanes][kMT][2],
                                                const uint2 (&rb)[kPlanes][NT],
                                                uint32_t (&a)[kMT][4], uint32_t (&b)[NT][2]) {
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    a[i][0] = subset_and<S>(ra[0][i][0].x, ra[1][i][0].x, ra[2][i][0].x, ra[3][i][0].x);
    a[i][1] = subset_and<S>(ra[0][i][1].x, ra[1][i][1].x, ra[2][i][1].x, ra[3][i][1].x);
    a[i][2] = subset_and<S>(ra[0][i][0].y, ra[1][i][0].y, ra[2][i][0].y, ra[3][i][0].y);
    a[i][3] = subset_and<S>(ra[0][i][1].y, ra[1][i][1].y, ra[2][i][1].y, ra[3][i][1].y);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    b[j][0] = subset_and<S>(rb[0][j].x, rb[1][j].x, rb[2][j].x, rb[3][j].x);
    b[j][1] = subset_and<S>(rb[0][j].y, rb[1][j].y, rb[2][j].y, rb[3][j].y);
  }
}

// Fragment row (column) g of a group of 8 is staged row perm(g).
__device__ __forceinline__ int perm(int g) { return 2 * (g & 3) + (g >> 2); }

// Where this thread's warp and fragments lie in a block tile of T.
template <class T>
struct WarpPos {
  int lane, warp, grp, tig, wy, wx, wm, wn, prow;
  __device__ __forceinline__ WarpPos() {
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    grp = lane >> 2;   // row of a 16x8 tile's A fragment, column of its B fragment
    tig = lane & 3;    // k slot of the fragments, column pair of the accumulator
    wy = warp / kWarpsN;
    wx = warp % kWarpsN;
    wm = wy * 16 * kMT;     // the warp's rows inside the block tile
    wn = wx * 8 * T::kNT;   // the warp's columns inside the block tile
    prow = perm(grp);
  }
  // the tile row and column of accumulator element e of mma tile (i, j):
  // fragment row grp + 8 (e / 2), fragment column 2 tig + e % 2, each the
  // staged row perm() gives it
  __device__ __forceinline__ int row(int i, int e) const { return wm + i * 16 + 8 * (e >> 1) + prow; }
  __device__ __forceinline__ int col(int j, int e) const {
    return wn + j * 8 + perm(2 * tig + (e & 1));
  }
};

// Walks chunks [chunk0, chunk1) of the word axis of the block tile whose
// first A row is ``a_row`` and first B row ``b_row`` through the ring, and
// calls step(ra, rb, chunk) for every k256 step of every chunk with this
// thread's fragments of the 4 planes (ra: uint2 [kPlanes][kMT][2], rb: uint2
// [kPlanes][T::kNT]).  ``smem_raw`` is the block's dynamic shared memory
// (T::kSmemBytes), ``bars`` 2 * T::kStages mbarriers in shared memory.
// Every thread of the block calls it; it syncs the block once, at the start.
template <class T, class Step>
__device__ __forceinline__ void walk_chunks(const PlaneMaps& maps, uint8_t* smem_raw,
                                            uint64_t* bars, int a_row, int b_row, int chunk0,
                                            int chunk1, Step& step) {
  constexpr int kStages = T::kStages;
  // the ring: stage s holds, plane by plane, [A rows | B rows][128 B] of one
  // chunk, every tile at a multiple of 1,024 B (the swizzle's period)
  const uint32_t pad = (1024u - ((uint32_t)__cvta_generic_to_shared(smem_raw) & 1023u)) & 1023u;
  const uint8_t* ring = smem_raw + pad;
  const uint32_t ring_addr = (uint32_t)__cvta_generic_to_shared(ring);
  const uint32_t bar0 = (uint32_t)__cvta_generic_to_shared(bars);
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kStages + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);                 // the copying thread's arrive; the copies add bytes
      mbar_init(empty(s), kThreads / 32);    // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the copies of one chunk into its stage, by the block's first thread.
  // What a box reads past the operand's last row or word arrives as zeros.
  auto load = [&](int chunk) {
    const int s = (chunk - chunk0) % kStages;
    mbar_expect_tx(full(s), T::kStageBytes);
    const uint32_t dst = ring_addr + s * T::kStageBytes;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      tma_load_3d(dst + p * T::kPlaneBytes, &maps.a, full(s), chunk * kKW, p, a_row);
      tma_load_3d(dst + p * T::kPlaneBytes + T::kTileBytesA, &maps.b, full(s), chunk * kKW, p,
                  b_row);
    }
  };
  if (threadIdx.x == 0)
    for (int chunk = chunk0; chunk < min(chunk1, chunk0 + kStages); ++chunk) load(chunk);

  const WarpPos<T> wp;
  const int frag_a = (wp.wm + wp.prow) * (kKW * 4) + 8 * (wp.tig & 1);
  const int frag_b = T::kTileBytesA + (wp.wn + wp.prow) * (kKW * 4) + 8 * (wp.tig & 1);

  for (int chunk = chunk0; chunk < chunk1; ++chunk) {
    const int it = chunk - chunk0, s = it % kStages;
    // the stage of the chunk before this one is refilled, kStages chunks on,
    // as soon as every warp has read it
    if (threadIdx.x == 0 && it >= 1 && chunk - 1 + kStages < chunk1) {
      mbar_wait(empty((it - 1) % kStages), ((it - 1) / kStages) & 1);
      load(chunk - 1 + kStages);
    }
    __syncwarp();
    mbar_wait(full(s), (it / kStages) & 1);
    const uint8_t* cur = ring + s * T::kStageBytes;
#pragma unroll
    for (int ks = 0; ks < kKW / 8; ++ks) {
      // the thread's 8 bytes of the k256 step: the two k halves of its mma.
      // Piece q (16 bytes) of staged row r lies at piece q ^ (r % 8): the
      // 128-byte swizzle of the tensor maps.
      const int piece = ((2 * ks + (wp.tig >> 1)) ^ wp.prow) * 16;
      uint2 ra[kPlanes][kMT][2], rb[kPlanes][T::kNT];
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        const uint8_t* Ap = cur + p * T::kPlaneBytes + frag_a + piece;
        const uint8_t* Bp = cur + p * T::kPlaneBytes + frag_b + piece;
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          ra[p][i][0] = *reinterpret_cast<const uint2*>(Ap + (i * 16) * (kKW * 4));
          ra[p][i][1] = *reinterpret_cast<const uint2*>(Ap + (i * 16 + 8) * (kKW * 4));
        }
#pragma unroll
        for (int j = 0; j < T::kNT; ++j)
          rb[p][j] = *reinterpret_cast<const uint2*>(Bp + (j * 8) * (kKW * 4));
      }
      step(ra, rb, chunk);
    }
    // this warp has read the stage: it may be filled again
    __syncwarp();
    if (wp.lane == 0) mbar_arrive(empty(s));
  }
}

// ---------------------------------------------------------------------------
// the launcher's side
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's encoder, reached through the runtime: the build links nothing else
inline cudaError_t encoder(EncodeTiledFn* out) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                    cudaEnableDefault);
    if (err != cudaSuccess) return err;
    if (fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// the tensor map of the first ``n`` rows of [.., 4, W] planes with a box of
// ``box_rows`` rows x 128 B of one plane in the 128-byte swizzle; what a box
// reads past the tensor's edge arrives as zeros
inline int encode_map(EncodeTiledFn encode, CUtensorMap* map, const void* base, long long W,
                      long long n, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)W, 4, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)W * 16};
  const cuuint32_t box[3] = {kKW, 1, (cuuint32_t)box_rows};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// parts of the word axis for ``tiles`` output tiles on ``sms`` SMs (one block
// an SM): the smallest s that minimises ceil(tiles * s / sms) / s, the sweep's
// time in units of one whole tile, while a part keeps kMinSplitChunks chunks
inline int choose_splits(long long tiles, int sms, int n_chunks) {
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

// The cut of the word axis for ``tiles`` output tiles: ``requested`` parts,
// or chosen from the card's SM count when it is 0; no part is empty.  Sets
// the number of parts and the chunks of each.
inline cudaError_t plan_splits(int requested, long long tiles, int n_chunks, int* splits,
                               int* part_chunks) {
  int s = requested;
  if (s <= 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    s = choose_splits(tiles, sms, n_chunks);
  }
  if (s > n_chunks) s = n_chunks;
  *part_chunks = (n_chunks + s - 1) / s;
  *splits = (n_chunks + *part_chunks - 1) / *part_chunks;
  return cudaSuccess;
}

}  // namespace plane_ring
