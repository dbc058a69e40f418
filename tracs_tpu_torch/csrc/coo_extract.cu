// Threshold, triangle mask and row-major COO compaction of one block of the
// all-pairs sweep on Hopper (sm_90a), with the D/NN assembly fused in.
//
// Replaces tracs_tpu/ops/pairsnp.py::_extract_coo_packed (XLA: a mask, a
// hierarchical cumsum, a searchsorted and four gathers over whole D and NN
// blocks) together with the block assembly before it (_assemble_d,
// _assemble_nn, _assemble_popcount).  From the engine's int32 gram blocks
// [rb, m] it forms, per pair (i, j),
//
//   split  : D = L - (g + gp + cnt_a[i] + cnt_b[j]),  NN = L - cnt_a[i] - cnt_b[j] + gn
//   direct : D = L - g,                               NN = L - gn
//
// (int32 arithmetic that wraps as XLA's does) and emits (i, j, D, NN) of every
// pair with D <= thr, j < jhi (the global column c0 + j below n_valid) and, on
// triangle blocks, j > i + diag (global column above global row; diag = r0 -
// c0), in row-major order: tracs_tpu's emission order.  No D or NN block is
// written to device memory.
//
// Design.  A row is cut into segments of ``seg`` columns (a multiple of 32),
// one warp a segment, so that a block of 1024 rows x 4096 columns gives 4096
// warps and not 1024.  Three launches:
//   (1) count: each warp walks its segment 32 columns a step (4 steps in
//       flight), forms D and counts its survivors with __ballot_sync/__popc;
//   (2) scan: one block turns the [rb * nseg] counts into int64 exclusive
//       offsets (row-major over segments) and the total;
//   (3) emit (after the caller read the total and sized the output): each
//       warp walks its segment again and places each surviving lane at its
//       segment's offset plus the survivors of the lanes below it
//       (__popc of the ballot under the lane mask), so order within a row is
//       kept.  NN is read only for survivors.
// Offsets and output indices are 64-bit: the block may hold 2^31 pairs or more.
//
// What bounds it on an H100.  Bytes: the in-range columns of g (and gp) are
// read twice (count and emit) and gn once a survivor; a pair costs a handful
// of integer operations.  Nothing is reused, so the kernel runs at the rate
// the memory system streams the blocks; one warp a segment with 4 loads in
// flight a lane is the simple design, not a tuned one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Block {
  const int32_t* g;      // [rb, m]
  const int32_t* gn;     // [rb, m]
  const int32_t* gp;     // [rb, m] or null
  const int32_t* cnt_a;  // [rb] or null (direct mode)
  const int32_t* cnt_b;  // [m] or null
  int64_t rb, m, nseg, seg;
  int64_t diag;          // triangle: column j survives only above i + diag
  int64_t jhi;           // columns at or past this lie past n_valid
  int32_t L, thr;
  int triangle, split;
};

// Columns [lo, hi) of the warp's segment that can hold survivors.
__device__ __forceinline__ void seg_range(const Block& b, int64_t i, int64_t s,
                                          int64_t& lo, int64_t& hi) {
  lo = s * b.seg;
  hi = lo + b.seg < b.m ? lo + b.seg : b.m;
  if (hi > b.jhi) hi = b.jhi;
  if (b.triangle) {
    const int64_t first = i + b.diag + 1;
    if (lo < first) lo = first;
  }
}

// D of pair (i, j); ``base`` = L - cnt_a[i] (split) or L (direct), wrapping.
__device__ __forceinline__ int32_t distance(const Block& b, uint32_t base, int64_t idx,
                                            int64_t j) {
  uint32_t sub = static_cast<uint32_t>(b.g[idx]);
  if (b.gp) sub += static_cast<uint32_t>(b.gp[idx]);
  if (b.split) sub += static_cast<uint32_t>(b.cnt_b[j]);
  return static_cast<int32_t>(base - sub);
}

__device__ __forceinline__ uint32_t row_base(const Block& b, int64_t i) {
  uint32_t base = static_cast<uint32_t>(b.L);
  if (b.split) base -= static_cast<uint32_t>(b.cnt_a[i]);
  return base;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
coo_count_kernel(Block b, int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= b.rb * b.nseg) return;  // the whole warp leaves together
  const int64_t i = w / b.nseg;
  int64_t lo, hi;
  seg_range(b, i, w % b.nseg, lo, hi);
  const uint32_t base = row_base(b, i);
  const int64_t row = i * b.m;
  int total = 0;
  for (int64_t j0 = lo; j0 < hi; j0 += 32 * kUnroll) {
    int32_t d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * 32 + lane;
      d[u] = j < hi ? distance(b, base, row + j, j) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * 32 + lane;
      total += __popc(__ballot_sync(kFull, j < hi && d[u] <= b.thr));
    }
  }
  if (lane == 0) counts[w] = total;
}

// One block: offsets[k] = sum of counts[0..k), offsets[n] = the total.
__global__ void __launch_bounds__(kScanThreads)
coo_scan_kernel(const int32_t* __restrict__ counts, int64_t n, int64_t* __restrict__ offsets) {
  __shared__ int64_t warp_sums[kScanThreads / 32];
  __shared__ int64_t carry_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry_s = 0;
  __syncthreads();
  for (int64_t base = 0; base < n; base += (int64_t)kScanThreads * kScanItems) {
    const int64_t first = base + (int64_t)tid * kScanItems;
    int64_t v[kScanItems];
    int64_t local = 0;
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      v[q] = first + q < n ? counts[first + q] : 0;
      local += v[q];
    }
    // inclusive scan of the threads' sums: in the warp, then over the warps
    int64_t incl = local;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t x = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += x;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int64_t s = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int64_t x = __shfl_up_sync(kFull, s, d);
        if (lane >= d) s += x;
      }
      warp_sums[lane] = s;  // inclusive over the warps
    }
    __syncthreads();
    const int64_t carry = carry_s;
    int64_t off = carry + (warp ? warp_sums[warp - 1] : 0) + incl - local;
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      if (first + q < n) offsets[first + q] = off;
      off += v[q];
    }
    __syncthreads();  // every thread has read carry_s and warp_sums
    if (tid == 0) carry_s = carry + warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (tid == 0) offsets[n] = carry_s;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
coo_emit_kernel(Block b, const int64_t* __restrict__ offsets, int64_t k,
                int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= b.rb * b.nseg) return;
  const int64_t i = w / b.nseg;
  int64_t lo, hi;
  seg_range(b, i, w % b.nseg, lo, hi);
  int64_t pos = offsets[w];
  if (offsets[w + 1] == pos) return;  // no survivor in this segment
  const uint32_t base = row_base(b, i);
  const int64_t row = i * b.m;
  const unsigned below = (1u << lane) - 1u;
  for (int64_t j0 = lo; j0 < hi; j0 += 32 * kUnroll) {
    int32_t d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * 32 + lane;
      d[u] = j < hi ? distance(b, base, row + j, j) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * 32 + lane;
      const bool keep = j < hi && d[u] <= b.thr;
      const unsigned ballot = __ballot_sync(kFull, keep);
      if (keep) {
        const int64_t p = pos + __popc(ballot & below);
        // NN = base - cnt_b[j] + gn (split) or base - gn (direct: base = L)
        const uint32_t gn = static_cast<uint32_t>(b.gn[row + j]);
        const uint32_t nn = b.split ? base - static_cast<uint32_t>(b.cnt_b[j]) + gn : base - gn;
        out[p] = static_cast<int32_t>(i);
        out[k + p] = static_cast<int32_t>(j);
        out[2 * k + p] = d[u];
        out[3 * k + p] = static_cast<int32_t>(nn);
      }
      pos += __popc(ballot);
    }
  }
}

}  // namespace

// C entry point, loaded with ctypes (tracs_tpu_torch/ops/kernels.py).
//
// phase 0: count and scan.  counts: int32 [rb * nseg], offsets: int64
//          [rb * nseg + 1], nseg = ceil(m / seg); offsets[rb * nseg] is the
//          number of survivors k, which the caller reads to size ``out``.
// phase 1: emit into out: int32 [4, k] = (row, column, D, NN), local indices,
//          after phase 0 on the same stream with the same arguments.
// g, gn   : int32 [rb, m], contiguous; gp: the same or null
// cnt_a   : int32 [rb], cnt_b: int32 [m] (split == 1), or both null (direct)
// L, thr  : sites, and the threshold already clamped to [-1, 2^31 - 1]
// diag    : r0 - c0 (read when triangle != 0); jhi: n_valid - c0 clamped to [0, m]
// seg     : columns a warp, a positive multiple of 32
// stream  : the cudaStream_t to launch on
//
// Returns cudaGetLastError() after the launches (0 = cudaSuccess).  The
// caller checks every bound; the kernels do not synchronise.
extern "C" int tracs_coo_extract(int phase, const void* g, const void* gn, const void* gp,
                                 const void* cnt_a, const void* cnt_b, long long rb,
                                 long long m, int L, int thr, long long diag, int triangle,
                                 long long jhi, int split, long long seg, void* counts,
                                 void* offsets, long long k, void* out, void* stream) {
  if (rb <= 0 || m <= 0) return 0;
  Block b;
  b.g = static_cast<const int32_t*>(g);
  b.gn = static_cast<const int32_t*>(gn);
  b.gp = static_cast<const int32_t*>(gp);
  b.cnt_a = static_cast<const int32_t*>(cnt_a);
  b.cnt_b = static_cast<const int32_t*>(cnt_b);
  b.rb = rb;
  b.m = m;
  b.seg = seg;
  b.nseg = (m + seg - 1) / seg;
  b.diag = diag;
  b.jhi = jhi;
  b.L = L;
  b.thr = thr;
  b.triangle = triangle;
  b.split = split;
  const int64_t warps = b.rb * b.nseg;
  const unsigned blocks = (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (phase == 0) {
    coo_count_kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(b, static_cast<int32_t*>(counts));
    coo_scan_kernel<<<1, kScanThreads, 0, s>>>(static_cast<const int32_t*>(counts), warps,
                                                static_cast<int64_t*>(offsets));
  } else if (k > 0) {
    coo_emit_kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        b, static_cast<const int64_t*>(offsets), static_cast<int64_t>(k),
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
