// The split layout of an alignment built on Hopper (sm_90a) from its raw
// planes, with the gather of its partial planes as a second launch.
//
// Replaces no TPU kernel: the JAX package builds the layout on the host
// (tracs_tpu/ops/packing.py::split_alignment, the native pass tn_split_stats
// of src/tracs_native.cpp), and so did the port.  On one card that host pass
// wrote five fresh arrays of ~4.1 GB at 4,096 samples x 1 Mb, of which the
// card path read only the N counts, the partial-site OR and the gathered
// partial planes.  Here the raw planes [n, 4, W] (uint32 words, one bit a
// site; N sets all four planes), uploaded once, give in one pass
//
//   excl[i, p, w]   = plane[i, p, w] & ~all4[i, w],   all4 = A & C & G & T
//   nmask[i, w]     = all4[i, w]
//   cnt_n[i]        = sum_w popc(all4[i, w])
//   partial_or[w]   = OR_i (ge2[i, w] & ~all4[i, w]),
//                     ge2 = the sites with at least two planes set
//
// with excl and nmask written at the word pitch of the card's layout (a
// multiple of 4 words, ops/kernels.py::padded_words) and the pad words zero,
// so no padded copy of the raw planes and no elementwise temporaries are made.
// The second launch packs the bits of excl at the P partial positions into
// partial [n, 4, Wp'] (Wp' the pitch of ceil(P / 32) words, pad words zero).
//
// What bounds it on an H100.  The layout pass is a stream: each plane word
// is read once and excl and nmask written once.  At 4,096 x 31,250 words
// that is 2.048 GB read and 2.56 GB written, 1.38 ms at 3.35 TB/s; its few
// integer operations a word are nothing beside that.  So it is bound by
// bytes, and the design keeps the bytes streaming: a block owns 1,024
// consecutive words (4 a thread, neighbouring threads on neighbouring words,
// so every warp access is one 128-byte line) of 32 samples in turn, with the
// 16 loads of a sample independent and in flight together.  The rows start
// at any word (the raw width W has no pitch), so the accesses are 4 bytes
// wide.  The reductions stay off the stream: a sample's N count is summed
// within each warp (__reduce_add_sync) and the block's 8 warp sums in shared
// memory, one global atomic a sample a block; the partial OR is kept in
// registers over the block's 32 samples and leaves with one atomicOr a
// nonzero word a block.  The gather reads each partial site's word once a
// row (a warp a 32-bit output word, one lane a site, __ballot_sync packs
// them): 4 MB written at the headline's 2,048 sites.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;
constexpr int kChunkWords = kThreads * kWordsPerThread;
constexpr int kSamplesPerBlock = 32;

__global__ void __launch_bounds__(kThreads)
split_layout_kernel(const uint32_t* __restrict__ planes, long long n, long long W,
                    long long pitch, uint32_t* __restrict__ excl,
                    uint32_t* __restrict__ nmask, int* __restrict__ cnt_n,
                    uint32_t* __restrict__ partial_or) {
  __shared__ int counts[kSamplesPerBlock];
  const long long w0 = static_cast<long long>(blockIdx.x) * kChunkWords + threadIdx.x;
  const long long s0 = static_cast<long long>(blockIdx.y) * kSamplesPerBlock;
  const int rows = static_cast<int>(min(static_cast<long long>(kSamplesPerBlock), n - s0));
  if (threadIdx.x < kSamplesPerBlock) counts[threadIdx.x] = 0;
  __syncthreads();

  uint32_t partial[kWordsPerThread] = {};
  for (int r = 0; r < rows; ++r) {
    const long long i = s0 + r;
    const uint32_t* src = planes + i * 4 * W;
    uint32_t* dst = excl + i * 4 * pitch;
    uint32_t* nm = nmask + i * pitch;
    uint32_t a[kWordsPerThread], c[kWordsPerThread], g[kWordsPerThread], t[kWordsPerThread];
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      const long long w = w0 + k * kThreads;
      const bool in = w < W;   // words in [W, pitch) are the pad: zero
      a[k] = in ? __ldg(src + w) : 0u;
      c[k] = in ? __ldg(src + W + w) : 0u;
      g[k] = in ? __ldg(src + 2 * W + w) : 0u;
      t[k] = in ? __ldg(src + 3 * W + w) : 0u;
    }
    int pop = 0;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      const long long w = w0 + k * kThreads;
      const uint32_t all4 = a[k] & c[k] & g[k] & t[k];
      const uint32_t ge2 = (a[k] & c[k]) | (a[k] & g[k]) | (a[k] & t[k]) | (c[k] & g[k]) |
                           (c[k] & t[k]) | (g[k] & t[k]);
      partial[k] |= ge2 & ~all4;
      pop += __popc(all4);
      if (w < pitch) {
        dst[w] = a[k] & ~all4;
        dst[pitch + w] = c[k] & ~all4;
        dst[2 * pitch + w] = g[k] & ~all4;
        dst[3 * pitch + w] = t[k] & ~all4;
        nm[w] = all4;
      }
    }
    pop = __reduce_add_sync(0xffffffffu, pop);
    if ((threadIdx.x & 31) == 0 && pop) atomicAdd(&counts[r], pop);
  }
  __syncthreads();
  if (threadIdx.x < rows && counts[threadIdx.x]) atomicAdd(cnt_n + s0 + threadIdx.x,
                                                          counts[threadIdx.x]);
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) {
    const long long w = w0 + k * kThreads;
    if (w < W && partial[k]) atomicOr(partial_or + w, partial[k]);
  }
}

// One warp a word of the output: lane j takes the bit of site pos[32 k + j]
// of its row of excl, and the ballot is the packed word.
__global__ void __launch_bounds__(kThreads)
split_gather_kernel(const uint32_t* __restrict__ excl, long long rows, long long pitch,
                    const long long* __restrict__ pos, long long P, long long out_pitch,
                    uint32_t* __restrict__ out) {
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (warp >= rows * out_pitch) return;   // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long row = warp / out_pitch, k = warp % out_pitch;
  const long long j = k * 32 + lane;
  uint32_t bit = 0;
  if (j < P) {
    const long long site = __ldg(pos + j);
    bit = (__ldg(excl + row * pitch + (site >> 5)) >> (site & 31)) & 1u;
  }
  const uint32_t word = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) out[row * out_pitch + k] = word;
}

}  // namespace

// The layout pass on ``stream``: zeroes cnt_n [n] (int32) and partial_or [W]
// (uint32), then writes excl [n, 4, pitch], nmask [n, pitch], cnt_n and
// partial_or.  pitch >= W, a multiple of 4.  Returns the CUDA error of the
// launch (0 when it was accepted).
extern "C" int tracs_split_layout(const void* planes, long long n, long long W,
                                  long long pitch, void* excl, void* nmask, void* cnt_n,
                                  void* partial_or, void* stream) {
  if (n < 0 || W < 0 || pitch < W || pitch % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(cnt_n, 0, static_cast<size_t>(n) * sizeof(int), st);
  if (rc == cudaSuccess && W > 0)
    rc = cudaMemsetAsync(partial_or, 0, static_cast<size_t>(W) * sizeof(uint32_t), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (n == 0 || pitch == 0) return 0;
  const long long ys = (n + kSamplesPerBlock - 1) / kSamplesPerBlock;
  if (ys > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((pitch + kChunkWords - 1) / kChunkWords),
                  static_cast<unsigned>(ys));
  split_layout_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(planes), n, W, pitch, static_cast<uint32_t*>(excl),
      static_cast<uint32_t*>(nmask), static_cast<int*>(cnt_n),
      static_cast<uint32_t*>(partial_or));
  return static_cast<int>(cudaGetLastError());
}

// The gather on ``stream``: out [rows, out_pitch] (rows = n * 4) from excl
// [rows, pitch] at the P sites pos (int64, each below 32 * pitch); every
// word of out is written, those past ceil(P / 32) zero.
extern "C" int tracs_split_gather(const void* excl, long long rows, long long pitch,
                                  const void* pos, long long P, long long out_pitch, void* out,
                                  void* stream) {
  if (rows < 0 || P < 0 || out_pitch * 32 < P) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = rows * out_pitch * 32;
  if (threads == 0) return 0;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  split_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(excl), rows, pitch, static_cast<const long long*>(pos), P,
      out_pitch, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The build's facts of a kernel (0: the layout pass, 1: the gather):
// registers a thread, local memory a thread (spills), shared memory a block.
extern "C" int tracs_split_layout_attributes(int which, int* registers, int* local_bytes,
                                             int* shared_bytes) {
  cudaFuncAttributes attr{};
  const cudaError_t rc = which == 0
      ? cudaFuncGetAttributes(&attr, split_layout_kernel)
      : cudaFuncGetAttributes(&attr, split_gather_kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
