// Mismatch positions of a batch of sample pairs on Hopper (sm_90a), for the
// recombination filter.
//
// Replaces tracs_tpu/ops/pairsnp.py::_mism_positions_kernel, which XLA runs
// as an unpack of every pair to [P, L] int32, a hierarchical cumsum along L
// and a vmapped searchsorted.  For pair p = (ii[p], jj[p]) it writes the row
// out[p] = [count, pos_0, ..., pos_{capacity-1}] (int32): the number of sites
// below L where the two samples share no allele, and the first ``capacity``
// of those sites in ascending order; entries past the count hold -1.
//
// A site is shared when OR_x(a_x & b_x) is set.  With raw planes (mask
// pointers null) that is the whole test; with the split layout (N-exclusive
// planes and N masks) an N on either side matches everything, so
// shared = OR_x(ea_x & eb_x) | na | nb.
//
// Design.  One warp per pair walks the word axis 32 words at a time, one
// word a lane, so that each plane row is read in 128-byte runs straight from
// the resident layout (no [P, 4, W] gather exists).  Each lane forms its
// mismatch word, clears the bits at or past L and counts it with POPC; an
// inclusive shuffle scan of the counts plus the warp's running total gives
// each lane its offset into the pair's row, and an FFS loop writes the lane's
// positions while the offset is below the capacity.  Steps in which no lane
// has a mismatch (most of them: tens of mismatches in 31,250 words) skip the
// scan.
//
// What bounds it on an H100.  Bytes: a pair reads 8 or 10 words per 32 sites
// and does a handful of integer operations on them, so the kernel runs at
// the rate the memory system delivers the two samples' rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
mism_positions_kernel(const uint32_t* __restrict__ pa, const uint32_t* __restrict__ ma,
                      const uint32_t* __restrict__ pb, const uint32_t* __restrict__ mb,
                      const int64_t* __restrict__ ii, const int64_t* __restrict__ jj,
                      int64_t P, int64_t W, int64_t L, int capacity,
                      int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t pair = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= P) return;  // the whole warp leaves together
  const int64_t i = ii[pair], j = jj[pair];
  const uint32_t* a = pa + i * 4 * W;
  const uint32_t* b = pb + j * 4 * W;
  const uint32_t* na = ma ? ma + i * W : nullptr;
  const uint32_t* nb = ma ? mb + j * W : nullptr;
  int32_t* row = out + pair * (1 + (int64_t)capacity);

  int running = 0;  // mismatches of the words before this step
  for (int64_t w0 = 0; w0 < W; w0 += 32) {
    const int64_t w = w0 + lane;
    uint32_t mism = 0u;
    if (w < W) {
      uint32_t shared = (a[w] & b[w]) | (a[W + w] & b[W + w]) |
                        (a[2 * W + w] & b[2 * W + w]) | (a[3 * W + w] & b[3 * W + w]);
      if (na) shared |= na[w] | nb[w];
      mism = ~shared;
      const int64_t inside = L - w * 32;  // sites of this word below L
      if (inside < 32) mism = inside <= 0 ? 0u : mism & (kFull >> (int)(32 - inside));
    }
    if (!__any_sync(kFull, mism != 0u)) continue;
    const int c = __popc(mism);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    int off = running + incl - c;
    while (mism && off < capacity) {
      row[1 + off] = (int32_t)(w * 32 + (__ffs(mism) - 1));
      mism &= mism - 1u;
      ++off;
    }
    running += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) row[0] = running;
  for (int k = min(running, capacity) + lane; k < capacity; k += 32) row[1 + k] = -1;
}

}  // namespace

// C entry point, loaded with ctypes (tracs_tpu_torch/ops/kernels.py).
//
// pa, pb  : [n_a, 4, W] and [n_b, 4, W] uint32 planes, contiguous (raw planes,
//           or N-exclusive planes when the masks are given)
// ma, mb  : [n_a, W] and [n_b, W] uint32 N masks, or both null
// ii, jj  : int64 [P] row of A and row of B of each pair
// L       : sites; positions at or past L are not reported
// out     : int32 [P, 1 + capacity], contiguous
// stream  : the cudaStream_t to launch on
//
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).  The caller
// checks every bound; the kernel does not synchronise.
extern "C" int tracs_mism_positions(const void* pa, const void* ma, const void* pb,
                                    const void* mb, const void* ii, const void* jj,
                                    long long P, long long W, long long L, int capacity,
                                    void* out, void* stream) {
  if (P <= 0) return 0;
  const unsigned blocks = (unsigned)((P + kWarpsPerBlock - 1) / kWarpsPerBlock);
  mism_positions_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pa), static_cast<const uint32_t*>(ma),
      static_cast<const uint32_t*>(pb), static_cast<const uint32_t*>(mb),
      static_cast<const int64_t*>(ii), static_cast<const int64_t*>(jj),
      static_cast<int64_t>(P), static_cast<int64_t>(W), static_cast<int64_t>(L),
      capacity, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
