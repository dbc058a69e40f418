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
// bit for bit what K1 writes, but the inner product runs as warp-level
// ``mma.sync`` operations.  The variants differ in the operand type:
//
//   b1    mma.m16n8k256 .b1 .and.popc straight on the packed words: the
//         AND + POPC of K1 done by the tensor core, nothing unpacked.
//   s8    every word unpacked in registers to 0/1 int8, mma.m16n8k32 .s8
//         with int32 accumulation.  Two unpack routines: "shift" takes bits
//         j, j+8, j+16, j+24 of a word with one shift and one mask per
//         register; "nibble" spreads one 4-bit nibble over the 4 bytes of a
//         register with a multiply (the byte-view form).
//   bf16  every word unpacked to bf16 operands, mma.m16n8k16 .bf16 with f32
//         accumulation.  A set bit becomes 2.0 (bit pattern 0x4000, a single
//         bit, so the unpack is one shift and one mask): the accumulators
//         hold 4 * count, exact while count < 2^24, and are scaled by 1/4 and
//         added to the int32 output every ``flush_words`` words, before any
//         partial count can reach 2^24.
//
// Design.  A block owns a BM x BN output tile (64 x 64 or 128 x 128) and
// walks the word axis in chunks of 16 words staged in shared memory, 5
// planes (4 exclusive planes + the N mask) of BM A rows and BN B rows.  Each
// warp owns a 32 x 32 sub-tile: 2 x 4 mma tiles of 16 x 8, for both grams,
// 64 accumulator registers a thread.  The sum over sites does not depend on
// the order of the sites, so any assignment of bits to the k slots of a
// fragment is right as long as the A and B operands use the same one; the
// unpack routines use that freedom.  Rows past the block, columns past n_b
// and words past W are staged as zero, which adds nothing to either gram,
// and only the stores mask the ragged tile edge.
//
// What bounds it on an H100.  The work is 5 bit-products per site and output
// (rb * m * 32 W * 5 multiply-adds), a matrix product far above the card's
// bytes-per-operation line; the least time is that work at the tensor cores'
// dense int8 rate.  The s8 and bf16 variants spend 2 integer operations per
// unpacked register besides, on the CUDA cores; b1 spends none.

#include <cstdint>
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

}  // namespace

// C entry point, loaded with ctypes (tracs_tpu_torch/ops/kernels.py).
//
// ea, nma, eb, nmb, W, r0, rb, c0, m, g, gn, stream : as tracs_split_gram
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
  if (dot == kB1 && tile == 128) TRACS_LAUNCH(kB1, 128);
  if (dot == kS8Shift && tile == 128) TRACS_LAUNCH(kS8Shift, 128);
  if (dot == kS8Nibble && tile == 128) TRACS_LAUNCH(kS8Nibble, 128);
  if (dot == kBF16 && tile == 128) TRACS_LAUNCH(kBF16, 128);
#undef TRACS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
