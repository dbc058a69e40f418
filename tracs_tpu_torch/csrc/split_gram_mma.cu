// Split-decomposition grams on Hopper's tensor cores (sm_90a): the variant
// family of the split gram.
//
// Replaces scripts/kernel_experiments.py::make_kernel (K1'), the factory of
// TPU variants of the split gram that unpack every bit and contract on the
// matrix unit.  Like csrc/split_gram.cu (K1) each variant writes, for a row
// block [r0, r0+rb) of the A layout against the column suffix [c0, n_b) of
// the B layout, as int32 [rb, n_b - c0] row-major,
//
//     gn[i][j] = sum_w popc(nA[r0+i][w] & nB[c0+j][w])                 (Gn)
//     g [i][j] = sum_w sum_x popc(eA[r0+i][x][w] & eB[c0+j][x][w]) - gn  (G4 - Gn)
//
// bit for bit what K1 writes.  The variants differ in the instruction and
// the operand type of the inner product:
//
//   b1    AND + POPC straight on the packed words, nothing unpacked.  At the
//         128 x 128 tile it is Hopper's own matrix instruction,
//         wgmma.mma_async.m64n128k256 .b1 .and.popc with both operands read
//         from shared memory; at the 64 x 64 tile warp-level
//         mma.sync.m16n8k256 .b1 .and.popc.
//   s8    every word unpacked in registers to 0/1 int8, mma.sync.m16n8k32 .s8
//         with int32 accumulation.  Two unpack routines: "shift" takes bits
//         j, j+8, j+16, j+24 of a word with one shift and one mask per
//         register; "nibble" spreads one 4-bit nibble over the 4 bytes of a
//         register with a multiply (the byte-view form).
//   bf16  every word unpacked to bf16 operands, mma.sync.m16n8k16 .bf16 with
//         f32 accumulation.  A set bit becomes 2.0 (bit pattern 0x4000, a
//         single bit, so the unpack is one shift and one mask): the
//         accumulators hold 4 * count, exact while count < 2^24, and are
//         scaled by 1/4 and added to the int32 output every ``flush_words``
//         words, before any partial count can reach 2^24.
//
// Design of the mma.sync variants (b1 at 64 x 64, s8, bf16).  A block owns a
// BM x BN output tile and walks the word axis in chunks of 16 words staged in
// shared memory with plain 4-byte loads, 5 planes (4 exclusive planes + the N
// mask) of BM A rows and BN B rows, two barriers a chunk.  Each warp owns a
// 32 x 32 sub-tile: 2 x 4 mma tiles of 16 x 8, for both grams, 64 accumulator
// registers a thread.  The sum over sites does not depend on the order of the
// sites, so any assignment of bits to the k slots of a fragment is right as
// long as the A and B operands use the same one; the unpack routines use that
// freedom.
//
// Design of the wgmma variant (b1 at 128 x 128).  A block of two consumer
// warpgroups, 64 rows x 128 columns each with both grams in registers (2 x 64
// int32 a thread; 154 registers in all, no spills), and one more warp whose
// first thread issues the copies.  The copies are TMA tensor loads
// (cp.async.bulk.tensor): a box of rows x 32 words of one plane lands in
// shared memory as rows of 128 B in the 128-byte swizzle, the K-major layout
// the instruction's matrix descriptor names with layout type 1 and a stride
// offset of 1,024 B between 8-row groups; a k256 step is 32 bytes on along
// the row.  The ring has 6 slots of one plane's A and B tile each (32 KB): a
// slot's full mbarrier counts the bytes of its boxes, the consumers wait on
// it, issue the slot's four wgmma, keep that group in flight while they wait
// for the one before, and then arrive on that earlier slot's empty mbarrier,
// on which the loader waits before it refills the slot.  No thread computes
// an address or touches the data on its way in, rows of 128 B are whole L2
// lines, and what a box reads past the layout's last row or word arrives as
// zeros.  The tensor maps are made by the launcher on every call through
// libcuda's cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint so
// that the build links nothing but the runtime, and passed as
// __grid_constant__ arguments.  Fed by the 16-byte cp.async ring of csrc/split_gram.cu the same
// wgmma loop was slower than K1: 8 warps keep fewer copies in flight than
// K1's 16.
//
// Clusters.  At 128 x 128 tiles 41 GB cross from L2 to shared memory per
// rb=1024 x n=4096 x 1 Mb block, and that traffic, not the tensor cores,
// bounds a block that copies its own tiles.  So the grid is launched in
// clusters of 2 x 2 blocks, 256 x 256 outputs: the two blocks of a cluster
// row share their A tile and the two of a cluster column their B tile, each
// block copies half of each with a multicast TMA load that writes the box
// into both blocks' shared memory and completes on both blocks' barriers, and
// half as many bytes leave L2.  A slot is then refilled only when every block
// that reads the copy has released it: a consumer warp arrives on the empty
// barrier of its own block and of the two others (mapa + a remote
// mbarrier.arrive), and a cluster barrier at both ends keeps a block from
// touching another's barriers before they exist or after it has gone.  The
// grid is rounded up to whole clusters; a block past the last tile copies
// and multiplies zeros.  A barrier that never completes traps after 2^22
// polls instead of hanging the card.
//
// In every variant rows past the block, columns past n_b and words past W are
// staged as zero, which adds nothing to either gram, and only the stores mask
// the ragged tile edge.
//
// What bounds it on an H100.  The work is 5 bit-products per site and output
// (rb * m * 32 W * 5 multiply-adds), a matrix product far above the card's
// bytes-per-operation line; the least time is that work at the tensor cores'
// dense int8 rate.  The s8 and bf16 variants spend 2 integer operations per
// unpacked register besides, on the CUDA cores, and with b1 at 64 x 64 their
// synchronous staging leaves the tensor cores idle while a chunk loads.  The
// wgmma variant is bound by what arrives in shared memory: a block on its own
// copies at about 4.5 TB/s from L2 (9 ms for the rb=1024 x n=4096 x 1 Mb
// block), a 2 x 2 cluster takes 6 ms, and larger clusters no less, because
// every SM still takes in its 32 KB a slot (41 GB a block in all, near 7
// TB/s); its wgmma alone would take 2.7 ms (NVIDIA H100 80GB HBM3, 700 W;
// experiments/tensor_rate.py measures 15.8 POP/s for b1 wgmma, 8 times the
// int8 rate: an instruction takes the same time in both types).  A larger
// tile per SM is what would move it.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kKW = 16;           // words per staged chunk
// row pitch of the staged tiles in words: a fragment load reads 8 rows x 4
// consecutive words per warp, and a pitch of 20 puts those on 32 banks
constexpr int kPitch = kKW + 4;
constexpr int kPlanes = 5;        // 4 exclusive planes + the N mask
constexpr int kMT = 2;            // 16-row mma tiles per warp (32 rows)
constexpr int kNT = 4;            // 8-column mma tiles per warp (32 columns)

enum Dot { kB1 = 0, kS8Shift = 1, kS8Nibble = 2, kBF16 = 3 };

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4 int8 0/1 values of a word, register j of 8: bits j, j+8, j+16, j+24
__device__ __forceinline__ uint32_t unpack_s8_shift(uint32_t w, int j) {
  return (w >> j) & 0x01010101u;
}

// 4 int8 0/1 values of a word, register j of 8: the bits of nibble j, spread
// to one byte each (x * 0x00204081 = x | x<<7 | x<<14 | x<<21 for x < 16)
__device__ __forceinline__ uint32_t unpack_s8_nibble(uint32_t w, int j) {
  return (((w >> (4 * j)) & 0xFu) * 0x00204081u) & 0x01010101u;
}

// 2 bf16 values 0.0 / 2.0 of a word, register j of 16: bits j and j+16 moved
// to bits 14 and 30 (2.0 in bf16 is the single bit 0x4000)
__device__ __forceinline__ uint32_t unpack_bf16(uint32_t w, int j) {
  return (j <= 14 ? (w << (14 - j)) : (w >> (j - 14))) & 0x40004000u;
}

template <int DOT>
__device__ __forceinline__ uint32_t unpack(uint32_t w, int reg) {
  if constexpr (DOT == kS8Shift) return unpack_s8_shift(w, reg);
  else if constexpr (DOT == kS8Nibble) return unpack_s8_nibble(w, reg);
  else return unpack_bf16(w, reg);
}

__device__ __forceinline__ uint32_t load_word(
    const uint32_t* __restrict__ e, const uint32_t* __restrict__ nm,
    int64_t row, int plane, int64_t W, int64_t w) {
  return plane < 4 ? e[(row * 4 + plane) * W + w] : nm[row * W + w];
}

// stage ROWS rows x 5 planes x kKW words, the word index fastest so that a
// warp reads 64-byte runs; rows >= valid and words >= W are staged as zero
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage(uint32_t* __restrict__ s,
                                      const uint32_t* __restrict__ e,
                                      const uint32_t* __restrict__ nm,
                                      int64_t first_row, int valid, int64_t W,
                                      int64_t k0) {
  for (int idx = threadIdx.x; idx < ROWS * kPlanes * kKW; idx += THREADS) {
    const int k = idx % kKW;
    const int p = (idx / kKW) % kPlanes;
    const int r = idx / (kKW * kPlanes);
    uint32_t v = 0u;
    if (k0 + k < W && r < valid) v = load_word(e, nm, first_row + r, p, W, k0 + k);
    s[(p * ROWS + r) * kPitch + k] = v;
  }
}

template <int DOT> struct AccType { using type = int; };
template <> struct AccType<kBF16> { using type = float; };

template <int DOT, int BM, int BN>
__global__ void __launch_bounds__((BM / 32) * (BN / 32) * 32)
split_gram_mma_kernel(const uint32_t* __restrict__ ea, const uint32_t* __restrict__ nma,
                      const uint32_t* __restrict__ eb, const uint32_t* __restrict__ nmb,
                      int64_t W, int r0, int rb, int c0, int m, int flush_chunks,
                      int32_t* __restrict__ g, int32_t* __restrict__ gn) {
  using acc_t = typename AccType<DOT>::type;
  constexpr int kThreads = (BM / 32) * (BN / 32) * 32;
  extern __shared__ uint32_t smem[];
  uint32_t* As = smem;                            // [kPlanes][BM][kPitch]
  uint32_t* Bs = smem + kPlanes * BM * kPitch;    // [kPlanes][BN][kPitch]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;   // row of a 16x8 tile's A fragment, column of its B fragment
  const int tig = lane & 3;    // k slot of the fragments, column pair of the accumulator
  const int wm = (warp / (BN / 32)) * 32;   // the warp's rows inside the block tile
  const int wn = (warp % (BN / 32)) * 32;   // the warp's columns inside the block tile
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  acc_t acc4[kMT][kNT][4];
  acc_t accn[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc4[i][j][e] = 0;
        accn[i][j][e] = 0;
      }

  // adds (flushed == true) or stores the accumulators' counts to the outputs
  auto flush = [&](bool flushed) {
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
          int v4, vn;
          if constexpr (DOT == kBF16) {
            v4 = __float2int_rn(acc4[i][j][e] * 0.25f);
            vn = __float2int_rn(accn[i][j][e] * 0.25f);
          } else {
            v4 = acc4[i][j][e];
            vn = accn[i][j][e];
          }
          const int64_t o = (int64_t)r * m + c;
          if (flushed) {
            gn[o] += vn;
            g[o] += v4 - vn;
          } else {
            gn[o] = vn;
            g[o] = v4 - vn;
          }
        }
  };

  // one staged chunk of plane p into the accumulators acc
  auto plane = [&](acc_t (&acc)[kMT][kNT][4], int p) {
    const uint32_t* Ap = As + (p * BM + wm + grp) * kPitch + tig;
    const uint32_t* Bp = Bs + (p * BN + wn + grp) * kPitch + tig;
    if constexpr (DOT == kB1) {
      // one mma covers 8 words: k slot tig takes words tig and 4 + tig
#pragma unroll
      for (int ks = 0; ks < kKW; ks += 8) {
        uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          a[i][0] = Ap[(i * 16) * kPitch + ks];
          a[i][1] = Ap[(i * 16 + 8) * kPitch + ks];
          a[i][2] = Ap[(i * 16) * kPitch + ks + 4];
          a[i][3] = Ap[(i * 16 + 8) * kPitch + ks + 4];
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          b[j][0] = Bp[(j * 8) * kPitch + ks];
          b[j][1] = Bp[(j * 8) * kPitch + ks + 4];
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_b1(acc[i][j], a[i], b[j]);
      }
    } else {
      // k slot tig takes word tig of each group of 4 words and unpacks it
      // to kRegs registers; each mma consumes 2 of them per operand row
      constexpr int kRegs = DOT == kBF16 ? 16 : 8;
#pragma unroll
      for (int ks = 0; ks < kKW; ks += 4) {
        uint32_t wa[kMT][2], wb[kNT];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          wa[i][0] = Ap[(i * 16) * kPitch + ks];
          wa[i][1] = Ap[(i * 16 + 8) * kPitch + ks];
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) wb[j] = Bp[(j * 8) * kPitch + ks];
#pragma unroll
        for (int q = 0; q < kRegs; q += 2) {
          uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            a[i][0] = unpack<DOT>(wa[i][0], q);
            a[i][1] = unpack<DOT>(wa[i][1], q);
            a[i][2] = unpack<DOT>(wa[i][0], q + 1);
            a[i][3] = unpack<DOT>(wa[i][1], q + 1);
          }
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            b[j][0] = unpack<DOT>(wb[j], q);
            b[j][1] = unpack<DOT>(wb[j], q + 1);
          }
#pragma unroll
          for (int i = 0; i < kMT; ++i)
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              if constexpr (DOT == kBF16)
                mma_bf16(acc[i][j], a[i], b[j]);
              else
                mma_s8(acc[i][j], a[i], b[j]);
            }
        }
      }
    }
  };

  bool flushed = false;
  int since = 0;
  for (int64_t k0 = 0; k0 < W; k0 += kKW) {
    stage<BM, kThreads>(As, ea, nma, (int64_t)r0 + row0, rb - row0, W, k0);
    stage<BN, kThreads>(Bs, eb, nmb, (int64_t)c0 + col0, m - col0, W, k0);
    __syncthreads();

#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      if (p < 4)
        plane(acc4, p);
      else
        plane(accn, p);
    }
    __syncthreads();

    if (DOT == kBF16 && ++since == flush_chunks && k0 + kKW < W) {
      flush(flushed);
      flushed = true;
      since = 0;
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc4[i][j][e] = 0;
            accn[i][j][e] = 0;
          }
    }
  }
  flush(flushed);
}

template <int DOT, int BM, int BN>
int launch(const void* ea, const void* nma, const void* eb, const void* nmb,
           long long W, int r0, int rb, int c0, int m, int flush_chunks,
           void* g, void* gn, void* stream) {
  constexpr int kThreads = (BM / 32) * (BN / 32) * 32;
  constexpr int kSmem = kPlanes * (BM + BN) * kPitch * (int)sizeof(uint32_t);
  auto kern = split_gram_mma_kernel<DOT, BM, BN>;
  // every tile needs more than the 48 KB a block gets without asking
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + BN - 1) / BN, (rb + BM - 1) / BM);
  kern<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ea), static_cast<const uint32_t*>(nma),
      static_cast<const uint32_t*>(eb), static_cast<const uint32_t*>(nmb),
      static_cast<int64_t>(W), r0, rb, c0, m, flush_chunks,
      static_cast<int32_t*>(g), static_cast<int32_t*>(gn));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// b1 at 128 x 128: wgmma from shared memory, fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kWgTile = 128;               // output rows and columns per block
constexpr int kWgConsumers = 256;          // two warpgroups of 64 rows
constexpr int kWgThreads = kWgConsumers + 32;   // and the warp that issues the copies
constexpr int kWgKW = 32;                  // words of a staged row: 128 B, four k256 steps
constexpr int kWgTileBytes = kWgTile * kWgKW * 4;      // one side of a slot: 16,384
constexpr int kWgSlotBytes = 2 * kWgTileBytes;         // A rows, then B rows, of one plane
constexpr int kWgSlots = 6;                // slots in the ring
constexpr int kWgSmemBytes = kWgSlots * kWgSlotBytes + 1024;   // + room to align to 1,024 B
// a cluster of kWgCX x kWgCY blocks shares its copies: a block copies
// 1 / kWgCX of its A tile for all blocks of its cluster row (they share the
// rows) and 1 / kWgCY of its B tile for all blocks of its cluster column
constexpr int kWgCX = 2;
constexpr int kWgCY = 2;
constexpr int kWgPartA = kWgTile / kWgCX;      // rows of the A tile a block copies
constexpr int kWgPartB = kWgTile / kWgCY;      // rows of the B tile a block copies
constexpr int kWgPeers = kWgCX + kWgCY - 1;    // blocks that read a block's copies, itself included
constexpr unsigned kWgSpinLimit = 1u << 22;   // polls of a barrier before the kernel gives up

struct WgmmaMaps {
  CUtensorMap ea, na, eb, nb;   // [n, 4, W] planes and [n, W] masks of the two layouts
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// one arrive, by the threads for which ``pred`` holds, on the barrier at this
// block's address ``bar`` in block ``rank`` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 remote;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n"
      :: "r"(bar), "r"(rank), "r"((int)pred) : "memory");
}

// every thread of every block of the cluster arrives and waits
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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
    if (spins > kWgSpinLimit) __trap();
  }
}

// one box of a plane's tile from global memory to the shared memory of every
// block of the cluster named in ``mask``, at this block's addresses ``dst``
// and ``bar`` in each of them; completes on each block's own barrier
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int word, int plane, int row, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n"
      :: "r"(dst), "l"(map), "r"(bar), "r"(word), "r"(plane), "r"(row), "h"(mask) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int word, int row, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n"
      :: "r"(dst), "l"(map), "r"(bar), "r"(word), "r"(row), "h"(mask) : "memory");
}

// the matrix descriptor of a K-major operand tile in the 128-byte swizzle:
// rows of 128 B, 8-row groups 1,024 B apart (the stride offset, in units of
// 16 bytes; the leading offset is not used in this mode), layout type 1
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define TRACS_R8(d, o)                                                              \
  "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]), "+r"(d[o + 4]),       \
      "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])

// d[64] += A (64 rows x 256 bits) AND-POPC B (128 rows x 256 bits), both from
// shared memory; thread t of the warpgroup holds, in d[i], row
// 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4) + i % 2
__device__ __forceinline__ void wgmma_b1(int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : TRACS_R8(d, 0), TRACS_R8(d, 8), TRACS_R8(d, 16), TRACS_R8(d, 24), TRACS_R8(d, 32),
        TRACS_R8(d, 40), TRACS_R8(d, 48), TRACS_R8(d, 56)
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
}

// pins the accumulators between the asynchronous products and their readers
__device__ __forceinline__ void wgmma_fence_operand(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

__global__ void __cluster_dims__(kWgCX, kWgCY, 1) __launch_bounds__(kWgThreads, 1)
split_gram_wgmma_kernel(const __grid_constant__ WgmmaMaps maps, int64_t W, int r0, int rb,
                        int c0, int m, int32_t* __restrict__ g, int32_t* __restrict__ gn) {
  // the ring: slot s holds [A rows | B rows][128 rows][128 B] of one plane of
  // one chunk, every tile at a multiple of 1,024 B (the swizzle's period)
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kWgSlots];   // full[s], then empty[s]
  const uint32_t ring = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar0 = (uint32_t)__cvta_generic_to_shared(bars);
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kWgSlots + s); };

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;                 // warpgroup: rows [64 wg, 64 wg + 64)
  const int row0 = blockIdx.y * kWgTile;
  const int col0 = blockIdx.x * kWgTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgSlots; ++s) {
      mbar_init(full(s), 1);                  // the loader's arrive; the copies add bytes
      mbar_init(empty(s), kWgPeers * kWgConsumers / 32);   // one arrive a warp of every reader
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // no block touches a barrier of another before it exists

  // this block's place in its cluster, and the blocks that share its rows
  // (the cluster row) and its columns (the cluster column), as rank masks
  uint32_t cx, cy;
  asm("mov.u32 %0, %%cluster_ctaid.x;\n" : "=r"(cx));
  asm("mov.u32 %0, %%cluster_ctaid.y;\n" : "=r"(cy));
  const uint16_t row_mask = (uint16_t)(((1u << kWgCX) - 1u) << (cy * kWgCX));
  uint16_t col_mask = 0;
#pragma unroll
  for (int j = 0; j < kWgCY; ++j) col_mask |= (uint16_t)(1u << (cx + kWgCX * j));

  // item i of the walk is plane i % 5 of chunk i / 5 and lives in slot i % kWgSlots
  const int n_chunks = (int)((W + kWgKW - 1) / kWgKW);
  const int n_items = n_chunks * kPlanes;
  auto load = [&](int item) {   // the loader thread only
    const int p = item % kPlanes, word = (item / kPlanes) * kWgKW, s = item % kWgSlots;
    // this block's part of each tile, to the same place in every reader
    const uint32_t dst_a = ring + s * kWgSlotBytes + cx * kWgPartA * kWgKW * 4;
    const uint32_t dst_b = ring + s * kWgSlotBytes + kWgTileBytes + cy * kWgPartB * kWgKW * 4;
    const int row_a = r0 + row0 + cx * kWgPartA, row_b = c0 + col0 + cy * kWgPartB;
    mbar_expect_tx(full(s), kWgSlotBytes);   // its own parts and the other blocks'
    if (p < 4) {
      tma_load_3d(dst_a, &maps.ea, full(s), word, p, row_a, row_mask);
      tma_load_3d(dst_b, &maps.eb, full(s), word, p, row_b, col_mask);
    } else {
      tma_load_2d(dst_a, &maps.na, full(s), word, row_a, row_mask);
      tma_load_2d(dst_b, &maps.nb, full(s), word, row_b, col_mask);
    }
  };

  if (warp == kWgConsumers / 32) {
    // the loader: one thread fills every slot once, then refills a slot as
    // soon as the warpgroups of every block that reads its copies have read it
    if (lane == 0) {
      for (int item = 0; item < n_items; ++item) {
        if (item >= kWgSlots)
          mbar_wait(empty(item % kWgSlots), ((item - kWgSlots) / kWgSlots) & 1);
        load(item);
      }
    }
    cluster_sync();   // as below
    return;
  }

  int acc4[64], accn[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc4[i] = 0;
    accn[i] = 0;
  }

  // the loop is unrolled over the planes so that the accumulator of an item
  // is known at compile time
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      const int item = chunk * kPlanes + p;
      const int s = item % kWgSlots;
      mbar_wait(full(s), (item / kWgSlots) & 1);

      wgmma_fence_operand(acc4);
      wgmma_fence_operand(accn);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint32_t a0 = ring + s * kWgSlotBytes + wg * 64 * kWgKW * 4;
      const uint32_t b0 = ring + s * kWgSlotBytes + kWgTileBytes;
#pragma unroll
      for (int k = 0; k < kWgKW / 8; ++k) {
        // a k256 step is 32 bytes on along the swizzled row
        if (p < 4)
          wgmma_b1(acc4, wgmma_desc(a0 + 32 * k), wgmma_desc(b0 + 32 * k));
        else
          wgmma_b1(accn, wgmma_desc(a0 + 32 * k), wgmma_desc(b0 + 32 * k));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");

      // the item before this one has been read: its slot goes back to the loader
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (item > 0) {
        const uint32_t bar = empty((item - 1) % kWgSlots);
#pragma unroll
        for (int j = 0; j < kWgCX; ++j) mbar_arrive_cluster(bar, cy * kWgCX + j, lane == 0);
#pragma unroll
        for (int j = 0; j < kWgCY; ++j)
          mbar_arrive_cluster(bar, cx + kWgCX * j, lane == 0 && j != cy);
      }
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wgmma_fence_operand(acc4);
  wgmma_fence_operand(accn);

  const int r_base = row0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int c_base = col0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = r_base + 8 * ((i >> 1) & 1);
    const int c = c_base + 8 * (i >> 2) + (i & 1);
    if (r >= rb || c >= m) continue;
    const int64_t o = (int64_t)r * m + c;
    gn[o] = accn[i];
    g[o] = acc4[i] - accn[i];
  }
  // no block leaves while another may still copy into it or arrive on its barriers
  cluster_sync();
}

#undef TRACS_R8

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the tensor map of a layout's planes ([n, 4, W], rank 3) or masks ([n, W],
// rank 2) with a box of ``box_rows`` rows x 128 B of one plane in the
// 128-byte swizzle; what a box reads past the tensor's edge arrives as zeros
int encode_map(EncodeTiledFn encode, CUtensorMap* map, const void* base, long long W,
               long long n, bool planes, int box_rows) {
  const cuuint64_t dims3[3] = {(cuuint64_t)W, 4, (cuuint64_t)n};
  const cuuint64_t strides3[2] = {(cuuint64_t)W * 4, (cuuint64_t)W * 16};
  const cuuint32_t box3[3] = {kWgKW, 1, (cuuint32_t)box_rows};
  const cuuint64_t dims2[2] = {(cuuint64_t)W, (cuuint64_t)n};
  const cuuint64_t strides2[1] = {(cuuint64_t)W * 4};
  const cuuint32_t box2[2] = {kWgKW, (cuuint32_t)box_rows};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT32, planes ? 3 : 2, const_cast<void*>(base),
      planes ? dims3 : dims2, planes ? strides3 : strides2, planes ? box3 : box2, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int launch_wgmma(const void* ea, const void* nma, const void* eb, const void* nmb,
                 long long W, int r0, int rb, int c0, int m, void* g, void* gn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (W == 0) {   // no site: both grams are zero, and a tensor map cannot be empty
    const size_t bytes = (size_t)rb * m * sizeof(int32_t);
    cudaError_t err = cudaMemsetAsync(g, 0, bytes, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(gn, 0, bytes, st);
    return static_cast<int>(err);
  }
  // the maps end at the block's last row and at n_b = c0 + m: what a box
  // reads past them arrives as zeros
  const long long n_a = (long long)r0 + rb, n_b = (long long)c0 + m;
  // libcuda's encoder, reached through the runtime: the build links nothing else
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  WgmmaMaps maps;
  int rc;
  if ((rc = encode_map(encode, &maps.ea, ea, W, n_a, true, kWgPartA))) return rc;
  if ((rc = encode_map(encode, &maps.na, nma, W, n_a, false, kWgPartA))) return rc;
  if ((rc = encode_map(encode, &maps.eb, eb, W, n_b, true, kWgPartB))) return rc;
  if ((rc = encode_map(encode, &maps.nb, nmb, W, n_b, false, kWgPartB))) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      split_gram_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // whole clusters: a block past the last tile copies and computes zeros
  const int tiles_n = (m + kWgTile - 1) / kWgTile, tiles_m = (rb + kWgTile - 1) / kWgTile;
  const dim3 grid((tiles_n + kWgCX - 1) / kWgCX * kWgCX, (tiles_m + kWgCY - 1) / kWgCY * kWgCY);
  split_gram_wgmma_kernel<<<grid, kWgThreads, kWgSmemBytes, st>>>(
      maps, static_cast<int64_t>(W), r0, rb, c0, m, static_cast<int32_t*>(g),
      static_cast<int32_t*>(gn));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, loaded with ctypes (tracs_tpu_torch/ops/kernels.py).
//
// ea, nma, eb, nmb, W, r0, rb, c0, m, g, gn, stream : as tracs_split_gram
//               (b1 at tile 128 needs its W a multiple of 4 and 16-byte
//               aligned pointers, TMA's rule for strides and addresses; the
//               others take any W)
// dot         : 0 = b1, 1 = s8 (shift unpack), 2 = s8 (nibble unpack), 3 = bf16
// tile        : rows and columns of a block's output tile
// flush_words : bf16 only: words between two flushes of the f32 accumulators
//               (rounded up to whole 16-word chunks); the caller keeps
//               3 * 32 * flush_words below 2^24
//
// Returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue (1) for a (dot, tile) pair that is not built.  The
// caller checks every bound; the kernel does not synchronise.
extern "C" int tracs_split_gram_mma(const void* ea, const void* nma, const void* eb,
                                    const void* nmb, long long W, int r0, int rb,
                                    int c0, int m, int dot, int tile, int flush_words,
                                    void* g, void* gn, void* stream) {
  if (rb <= 0 || m <= 0) return 0;
  const int fc = flush_words > 0 ? (flush_words + kKW - 1) / kKW : 1 << 30;
#define TRACS_LAUNCH(DOT, T) \
  return launch<DOT, T, T>(ea, nma, eb, nmb, W, r0, rb, c0, m, fc, g, gn, stream)
  if (dot == kB1 && tile == 64) TRACS_LAUNCH(kB1, 64);
  if (dot == kB1 && tile == 128)
    return launch_wgmma(ea, nma, eb, nmb, W, r0, rb, c0, m, g, gn, stream);
  if (dot == kS8Shift && tile == 128) TRACS_LAUNCH(kS8Shift, 128);
  if (dot == kS8Nibble && tile == 128) TRACS_LAUNCH(kS8Nibble, 128);
  if (dot == kBF16 && tile == 128) TRACS_LAUNCH(kBF16, 128);
#undef TRACS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
