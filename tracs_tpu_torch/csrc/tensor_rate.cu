// Issue rates of the tensor-core instructions the split-gram kernels are
// built on, measured on the card (sm_90a): a yardstick, not a kernel of the
// port.  It replaces no TPU kernel and nothing on any entry point's path
// calls it; tracs_tpu_torch/experiments/tensor_rate.py times it.
//
// The card's data sheet gives dense rates for int8, fp8 and the float types
// and none for single-bit operands, so the bound of a b1 kernel cannot be
// looked up.  Each kernel here runs one instruction in a loop with its
// operands in place (registers for mma.sync; a shared-memory tile written
// once for wgmma) and nothing else: no global loads, no staging, no barrier.
// Its time over the instructions issued is the rate a kernel could reach if
// it did nothing but that instruction.
//
//   0  mma.sync.m16n8k256 .b1 .and.popc   16 warps a block, 8 accumulator tiles a warp
//   1  mma.sync.m16n8k32  .s8             the same shape of loop, for calibration
//   2  wgmma.m64n128k256  .b1 .and.popc   2 warpgroups a block, operands in shared memory
//   3  wgmma.m64n128k32   .s8             the same, for calibration against the data sheet
//
// The loop shapes are those of csrc/split_gram.cu (0, 1) and of the b1-128
// variant of csrc/split_gram_mma.cu (2, 3): one block an SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMmaThreads = 512;
constexpr int kWgThreads = 256;
constexpr int kWgTileBytes = 128 * 32;   // 128 rows x 32 bytes: [2 pieces][128 rows][16 B]

template <bool B1>
__global__ void __launch_bounds__(kMmaThreads, 1)
mma_sync_rate_kernel(int iters, int32_t* __restrict__ out) {
  int acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0;
  // operands that the compiler cannot fold: the thread's own index
  uint32_t a[2][4], b[4][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) a[i][k] = threadIdx.x * 2654435761u + i * 40503u + k;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 2; ++k) b[j][k] = (threadIdx.x + blockIdx.x) * 2246822519u + j * 9973u + k;

  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int (&d)[4] = acc[i * 4 + j];
        if constexpr (B1) {
          asm volatile(
              "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
              : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]), "r"(b[j][0]),
                "r"(b[j][1]));
        } else {
          asm volatile(
              "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
              : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]), "r"(b[j][0]),
                "r"(b[j][1]));
        }
      }
  }
  int sum = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += acc[t][e];
  out[blockIdx.x * kMmaThreads + threadIdx.x] = sum;
}

#define TRACS_R8(d, o)                                                              \
  "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]), "+r"(d[o + 4]),       \
      "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])
#define TRACS_WGMMA(SHAPE_AND_TYPES)                                                      \
  asm volatile(                                                                           \
      "{\n"                                                                               \
      ".reg .pred p;\n"                                                                   \
      "setp.ne.b32 p, %66, 0;\n"                                                          \
      "wgmma.mma_async.sync.aligned." SHAPE_AND_TYPES " "                                 \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "%64, %65, p;\n"                                                                    \
      "}\n"                                                                               \
      : TRACS_R8(d, 0), TRACS_R8(d, 8), TRACS_R8(d, 16), TRACS_R8(d, 24), TRACS_R8(d, 32), \
        TRACS_R8(d, 40), TRACS_R8(d, 48), TRACS_R8(d, 56)                                 \
      : "l"(desc_a), "l"(desc_b), "r"(1)                                                  \
      : "memory")

// K-major, no swizzle: 8-row x 16-byte core matrices 128 B apart along the
// rows and 128 rows x 16 B apart along k (the layout of the b1-128 variant)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)((128 * 16) >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

template <bool B1>
__global__ void __launch_bounds__(kWgThreads, 1)
wgmma_rate_kernel(int iters, int32_t* __restrict__ out) {
  // one A tile and one B tile a plane, 5 planes, as a chunk buffer holds them
  __shared__ __align__(128) uint32_t smem[2 * 5 * kWgTileBytes / 4];
  for (int k = threadIdx.x; k < 2 * 5 * kWgTileBytes / 4; k += kWgThreads)
    smem[k] = (k + blockIdx.x) * 2654435761u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const int wg = threadIdx.x >> 7;

  int acc4[64], accn[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc4[i] = 0;
    accn[i] = 0;
  }
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      const uint64_t desc_a = wgmma_desc(base + p * kWgTileBytes + wg * 64 * 16);
      const uint64_t desc_b = wgmma_desc(base + (5 + p) * kWgTileBytes);
      int (&d)[64] = p < 4 ? acc4 : accn;
      if constexpr (B1) {
        TRACS_WGMMA("m64n128k256.s32.b1.b1.and.popc");
      } else {
        TRACS_WGMMA("m64n128k32.s32.s8.s8");
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    asm volatile("" : "+r"(acc4[i]), "+r"(accn[i]) :: "memory");
    sum += acc4[i] + accn[i];
  }
  out[blockIdx.x * kWgThreads + threadIdx.x] = sum;
}

#undef TRACS_WGMMA
#undef TRACS_R8

}  // namespace

// C entry point, loaded with ctypes (tracs_tpu_torch/experiments/tensor_rate.py).
//
// which   : 0 mma.sync b1, 1 mma.sync s8, 2 wgmma b1, 3 wgmma s8 (see above)
// blocks  : blocks to launch (one an SM fills the card once)
// iters   : loop turns of every warp (0, 1: 8 mma a turn) or warpgroup (2, 3:
//           5 wgmma a turn)
// out     : int32 [blocks * 512] scratch that keeps the sums alive
// stream  : the cudaStream_t to launch on
//
// Returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue (1) for another ``which``.
extern "C" int tracs_tensor_rate(int which, int blocks, int iters, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  if (which == 0) mma_sync_rate_kernel<true><<<blocks, kMmaThreads, 0, st>>>(iters, o);
  else if (which == 1) mma_sync_rate_kernel<false><<<blocks, kMmaThreads, 0, st>>>(iters, o);
  else if (which == 2) wgmma_rate_kernel<true><<<blocks, kWgThreads, 0, st>>>(iters, o);
  else if (which == 3) wgmma_rate_kernel<false><<<blocks, kWgThreads, 0, st>>>(iters, o);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
