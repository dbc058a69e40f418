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
// Design of the mma.sync variants (b1 at 64 x 64, s8, bf16): one template,
// the staging of csrc/split_gram.cu (K1).  A block owns a BM x BN output tile
// and walks the word axis in chunks of 16 words through a ring of two chunk
// buffers in shared memory, 5 planes (4 exclusive planes + the N mask) of BM
// A rows and BN B rows each: while the warps work on one chunk, the 16-byte
// cp.async copies of the next are in flight, and one __syncthreads() a chunk
// orders both the arrival of a buffer and its reuse.  Each warp owns a
// 32 x 32 sub-tile: 2 x 4 mma tiles of 16 x 8, for both grams, 64 accumulator
// registers a thread.  The sum over sites does not depend on the order of the
// sites, so any assignment of bits to the k slots of a fragment is right as
// long as the A and B operands use the same one: a thread (tig = lane % 4)
// takes the words 4 tig .. 4 tig + 3 of a staged row with one 16-byte load
// off unpadded 16-word rows, on both sides, and the unpack routines take
// their words from that piece.  The bf16 variant adds its accumulators to
// the outputs in the middle of the walk; every output element belongs to one
// thread, so that flush races nothing.
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
// rate for the operand type.  Measured on an NVIDIA H100 80GB HBM3 at 700 W
// for the rb=1024 x n=4096 x 1 Mb block (experiments/split_gram_probe.py
// times each variant's copies alone, its unpack alone and its mma alone):
//   b1 at 64 x 64 (25 ms) is bound by its copies: a 64 x 64 tile brings twice
//   K1's bytes from L2 an output, 82 GB a block, and the copies alone take as
//   long as the whole kernel while its mma take 7 ms;
//   s8 (61 ms shift, 86 ms nibble) by the warps' instruction stream: the
//   unpack alone (2 integer operations a register for shift, 3 for nibble)
//   takes 43 and 53 ms, the s8 mma alone 48 ms (mma.sync reaches 65% of the
//   int8 rate wgmma does), the two overlap only in part, and the copies
//   (12 ms) hide behind them;
//   bf16 (112 ms) the same way: its mma alone 87 ms, its unpack alone 73 ms.
// The wgmma variant is bound by what arrives in shared memory: a block on its
// own copies at about 4.5 TB/s from L2 (9 ms for that block), a 2 x 2 cluster
// takes 6 ms, and larger clusters no less, because every SM still takes in
// its 32 KB a slot (41 GB a block in all, near 7 TB/s); its wgmma alone would
// take 2.7 ms (15.8 POP/s for b1 wgmma on an H100 at 700 W,
// 8 times the int8 rate: an instruction takes the same time in both types).
// A larger tile per SM is what would move it.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kKW = 16;           // words per staged chunk: four 16-byte pieces a row
constexpr int kPlanes = 5;        // 4 exclusive planes + the N mask
constexpr int kMT = 2;            // 16-row mma tiles per warp (32 rows)
constexpr int kNT = 4;            // 8-column mma tiles per warp (32 columns)
constexpr int kPieces = kKW / 4;  // 16-byte pieces of a staged row

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

// 16 bytes from global to shared memory, asynchronously, past L1; ``bytes``
// is 16, or 0 to fill the 16 bytes with zeros and read nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most PENDING of this thread's copy groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// word c of 4 of a 16-byte piece
__device__ __forceinline__ uint32_t word_of(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <int DOT> struct AccType { using type = int; };
template <> struct AccType<kBF16> { using type = float; };

// the ring of a (tile, depth): threads, staged rows and bytes
template <int BM, int BN, int STAGES>
struct Ring {
  static constexpr int kThreads = (BM / 32) * (BN / 32) * 32;
  static constexpr int kRows = BM + BN;                     // staged rows a plane
  static constexpr int kStageWords = kPlanes * kRows * kKW;
  static constexpr int kSmemBytes = STAGES * kStageWords * (int)sizeof(uint32_t);
  static constexpr int kPasses = kRows * kPieces / kThreads;   // staged rows a thread copies
  static_assert(STAGES >= 2 && kSmemBytes <= 227 * 1024, "the ring fits an SM");
  static_assert(kRows * kPieces % kThreads == 0, "every thread copies kPasses rows a plane");
  static_assert(BM % (kThreads / kPieces) == 0, "a pass copies A rows or B rows, not both");
};

template <int DOT, int BM, int BN, int STAGES, int BLOCKS>
__global__ void __launch_bounds__((BM / 32) * (BN / 32) * 32, BLOCKS)
split_gram_mma_kernel(const uint32_t* __restrict__ ea, const uint32_t* __restrict__ nma,
                      const uint32_t* __restrict__ eb, const uint32_t* __restrict__ nmb,
                      int64_t W, int r0, int rb, int c0, int m, int flush_chunks,
                      int32_t* __restrict__ g, int32_t* __restrict__ gn) {
  using acc_t = typename AccType<DOT>::type;
  using R = Ring<BM, BN, STAGES>;
  constexpr int kThreads = R::kThreads, kRows = R::kRows, kStageWords = R::kStageWords;
  constexpr int kPasses = R::kPasses;
  // [stage][plane][A rows, then B rows][kKW words]
  extern __shared__ __align__(16) uint32_t smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;   // row of a 16x8 tile's A fragment, column of its B fragment
  const int tig = lane & 3;    // k slot of the fragments, column pair of the accumulator
  const int wm = (warp / (BN / 32)) * 32;   // the warp's rows inside the block tile
  const int wn = (warp % (BN / 32)) * 32;   // the warp's columns inside the block tile
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int n_chunks = (int)((W + kKW - 1) / kKW);

  // staging: piece sq (4 words) of the staged rows sr + pass * (kThreads /
  // kPieces), every plane; staged rows below BM are A rows, the others B rows
  const int sq = threadIdx.x % kPieces;
  const int sr = threadIdx.x / kPieces;
  const uint32_t* src_e[kPasses];   // the row's piece in plane 0; plane p is p * W on
  const uint32_t* src_n[kPasses];   // the row's piece in the mask
  bool in_rows[kPasses];
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int row = sr + pass * (kThreads / kPieces);
    const bool side_b = row >= BM;
    in_rows[pass] = side_b ? col0 + row - BM < m : row0 + row < rb;
    const int64_t src_row =
        !in_rows[pass] ? 0 : side_b ? (int64_t)c0 + col0 + row - BM : (int64_t)r0 + row0 + row;
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

  // adds (flushed == true) or stores the accumulators' counts to the outputs.
  // Every output element belongs to one thread of one block, which is the
  // only one to read or write it, in program order: a flush in the middle of
  // the walk races nothing, whatever copies are in flight.
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

  // one staged chunk of plane p into the accumulators acc.  A thread takes
  // the piece tig, words 4 tig .. 4 tig + 3, of each of its staged rows with
  // one 16-byte load, on the A and on the B side alike: which k slot a site
  // lands in does not matter to the sum as long as both sides agree.  Rows
  // are 16 words with no padding: a quarter-warp's loads cover two rows, all
  // 32 banks once.
  auto plane = [&](acc_t (&acc)[kMT][kNT][4], const uint32_t* buf, int p) {
    const uint32_t* Ap = buf + (p * kRows + wm + grp) * kKW + 4 * tig;
    const uint32_t* Bp = buf + (p * kRows + BM + wn + grp) * kKW + 4 * tig;
    uint4 wa[kMT][2], wb[kNT];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      wa[i][0] = *reinterpret_cast<const uint4*>(Ap + (i * 16) * kKW);
      wa[i][1] = *reinterpret_cast<const uint4*>(Ap + (i * 16 + 8) * kKW);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) wb[j] = *reinterpret_cast<const uint4*>(Bp + (j * 8) * kKW);
    if constexpr (DOT == kB1) {
      // words 0 and 1 of the piece are the two k halves of the chunk's first
      // k256 step, words 2 and 3 those of the second
#pragma unroll
      for (int c = 0; c < 4; c += 2) {
        uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          a[i][0] = word_of(wa[i][0], c);
          a[i][1] = word_of(wa[i][1], c);
          a[i][2] = word_of(wa[i][0], c + 1);
          a[i][3] = word_of(wa[i][1], c + 1);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          b[j][0] = word_of(wb[j], c);
          b[j][1] = word_of(wb[j], c + 1);
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_b1(acc[i][j], a[i], b[j]);
      }
    } else {
      // word c of the piece is unpacked to kRegs registers; each mma
      // consumes 2 of them per operand row
      constexpr int kRegs = DOT == kBF16 ? 16 : 8;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int q = 0; q < kRegs; q += 2) {
          uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            a[i][0] = unpack<DOT>(word_of(wa[i][0], c), q);
            a[i][1] = unpack<DOT>(word_of(wa[i][1], c), q);
            a[i][2] = unpack<DOT>(word_of(wa[i][0], c), q + 1);
            a[i][3] = unpack<DOT>(word_of(wa[i][1], c), q + 1);
          }
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            b[j][0] = unpack<DOT>(word_of(wb[j], c), q);
            b[j][1] = unpack<DOT>(word_of(wb[j], c), q + 1);
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

  // the ring: STAGES - 1 chunks are in flight ahead of the one computed
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) stage(s, s);
    cp_async_commit();
  }
  bool flushed = false;
  int since = 0;
  int buf = 0;   // the buffer of ``chunk``
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    // this chunk has landed, and every warp is done with the buffer of the
    // chunk before it, which the copies issued next fill again
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int ahead = chunk + STAGES - 1;
    if (ahead < n_chunks) stage(buf == 0 ? STAGES - 1 : buf - 1, ahead);
    cp_async_commit();

    const uint32_t* cur = smem + buf * kStageWords;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      if (p < 4)
        plane(acc4, cur, p);
      else
        plane(accn, cur, p);
    }
    buf = buf + 1 == STAGES ? 0 : buf + 1;

    if (DOT == kBF16 && ++since == flush_chunks && chunk + 1 < n_chunks) {
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

// STAGES buffers in the ring and BLOCKS blocks an SM (registers and shared
// memory allowing)
template <int DOT, int BM, int BN, int STAGES, int BLOCKS>
int launch(const void* ea, const void* nma, const void* eb, const void* nmb,
           long long W, int r0, int rb, int c0, int m, int flush_chunks,
           void* g, void* gn, void* stream) {
  using R = Ring<BM, BN, STAGES>;
  if (W % 4) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = split_gram_mma_kernel<DOT, BM, BN, STAGES, BLOCKS>;
  // every ring needs more than the 48 KB a block gets without asking
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + BN - 1) / BN, (rb + BM - 1) / BM);
  kern<<<grid, R::kThreads, R::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
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
//               (W a multiple of 4 and 16-byte aligned pointers: the rule of
//               the 16-byte cp.async pieces and of TMA's strides and addresses)
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
#define TRACS_LAUNCH(DOT, T, STAGES, BLOCKS) \
  return launch<DOT, T, T, STAGES, BLOCKS>(ea, nma, eb, nmb, W, r0, rb, c0, m, fc, g, gn, stream)
  if (dot == kB1 && tile == 64) TRACS_LAUNCH(kB1, 64, 2, 2);
  if (dot == kB1 && tile == 128)
    return launch_wgmma(ea, nma, eb, nmb, W, r0, rb, c0, m, g, gn, stream);
  if (dot == kS8Shift && tile == 128) TRACS_LAUNCH(kS8Shift, 128, 2, 1);
  if (dot == kS8Nibble && tile == 128) TRACS_LAUNCH(kS8Nibble, 128, 2, 1);
  if (dot == kBF16 && tile == 128) TRACS_LAUNCH(kBF16, 128, 2, 1);
#undef TRACS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
