// Mismatch positions of a batch of sample pairs on Hopper (sm_90a): another
// design of csrc/mism_positions.cu, in which the pairs that list a sample
// share its row through shared memory.  It computes the same table (see that
// file for the function) and is SLOWER on an H100 than the kernel on the
// path, so nothing in the package launches it:
// tracs_tpu_torch/experiments/mism_positions_probe.py builds it, holds it
// against the plain version and times it and its parts, and PERF.md keeps
// what that showed.
//
// Why it was tried.  The filter lists the pairs of a sweep block row-major,
// and those pairs lie within clusters: about a thousand distinct samples make
// ten thousand pairs, so a warp a pair that reads both rows from the memory
// system moves each sample's row some twenty times (12.9 GB for 0.64 GB of
// distinct rows at the main path's block).
//
// Design.  A block takes ``group`` consecutive pairs of the caller's list.
// Its threads first give every distinct sample among the group's ii and jj a
// slot (a linear search for the first equal index among at most 256), then
// walk the word axis in chunks: the chunk of every slot's 4 planes (and mask)
// is copied to shared memory once, one bulk copy (``cp.async.bulk``) a row
// asked for by the block's first warp and landing on the buffer's mbarrier,
// into one of kStages buffers so that later chunks' copies fly while this one
// is read.  The chunk is as wide as a buffer allows for the group's number of
// distinct samples (up to 128 words: one uint4 a lane).  Each warp then takes
// a run of the group's pairs: a lane forms four mismatch words from shared
// memory (the first sample's words stay in registers while consecutive pairs
// share it), clears the bits at or past L and counts them with POPC; an
// inclusive shuffle scan plus the pair's running total (kept in shared memory
// between chunks) gives each lane its offset into the pair's row, and an FFS
// loop writes positions while the offset is below the capacity.  A block
// walks the whole word axis for its pairs, so positions come out ascending
// and the capacity cut is exact without a second pass.  Rows whose pitch or
// address is not a multiple of 16 bytes are copied word by word by all
// threads.
//
// What bounds it.  The copies: alone they take longer than the whole kernel
// on the path, and their time goes with the number of row pieces asked for
// (rows x chunks), not with their bytes and not with the depth of the ring;
// 16-byte ``cp.async`` by all warps took the same time as the bulk copies.
// A row piece is at most 512 bytes here, because a sample's planes and mask
// are five separate rows of the layout.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 128;      // pairs of a block
constexpr int kMaxKeys = 2 * kMaxGroup;  // the indices a block lists: an ii and a jj a pair
constexpr int kStages = 2;          // staging buffers: kStages - 1 chunks are in flight
constexpr int kStageWords = 10240;  // words of one staging buffer (40 KB)
constexpr int kMaxChunk = 128;      // words of a chunk: one uint4 a lane
constexpr unsigned kFull = 0xFFFFFFFFu;

static_assert(kStageWords / (5 * 2 * kMaxGroup) >= 4, "a chunk holds at least one uint4 a row");

constexpr unsigned kSpinLimit = 1u << 22;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// waits for the phase of parity ``parity`` to complete; a barrier that never
// completes traps instead of hanging the card
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

// one bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte aligned) from
// device memory to shared memory; completes, with its bytes, on ``bar``
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Bits of word ``w`` (its 32 sites start at site 32 w) that lie below L.
__device__ __forceinline__ uint32_t below_length(uint32_t mism, int64_t w, int64_t L) {
  const int64_t inside = L - w * 32;
  if (inside >= 32) return mism;
  return inside <= 0 ? 0u : mism & (kFull >> static_cast<int>(32 - inside));
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
mism_positions_kernel(const uint32_t* __restrict__ pa, const uint32_t* __restrict__ ma,
                      const uint32_t* __restrict__ pb, const uint32_t* __restrict__ mb,
                      const int64_t* __restrict__ ii, const int64_t* __restrict__ jj,
                      int64_t P, int64_t W, int64_t L, int capacity, int group,
                      int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t stage[];  // kStages buffers of kStageWords
  __shared__ long long s_key[kMaxKeys];              // listed index -> (row, side)
  __shared__ const uint32_t* s_planes[kMaxKeys];     // slot -> the sample's 4 planes
  __shared__ const uint32_t* s_mask[kMaxKeys];       // slot -> the sample's N mask
  __shared__ short s_slot[kMaxKeys];                 // listed index -> slot
  __shared__ short s_first[kMaxKeys];                // listed index -> the first with its key
  __shared__ int s_running[kMaxGroup];               // pair -> mismatches before this chunk
  __shared__ __align__(8) uint64_t s_full[kStages];  // a buffer's bytes have landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * group;
  const int g = P - p0 < group ? static_cast<int>(P - p0) : group;
  const int n_keys = 2 * g;
  const int planes = ma ? 5 : 4;
  // one layout on both sides: row i of A and row i of B are the same words
  const bool self = pa == pb && ma == mb;

  if (VEC && tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(smem_addr(&s_full[st]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // a slot for every distinct (row, side) among the group's indices
  for (int k = tid; k < n_keys; k += kThreads)
    s_key[k] = k < g ? ii[p0 + k] * 2 : jj[p0 + k - g] * 2 + (self ? 0 : 1);
  for (int k = tid; k < g; k += kThreads) s_running[k] = 0;
  __syncthreads();
  for (int k = tid; k < n_keys; k += kThreads) {
    const long long key = s_key[k];
    int first = k;
    for (int t = 0; t < k; ++t)
      if (s_key[t] == key) { first = t; break; }
    s_first[k] = static_cast<short>(first);
  }
  __syncthreads();
  int distinct = 0;
  for (int k = 0; k < n_keys; ++k) distinct += s_first[k] == k;
  for (int k = tid; k < n_keys; k += kThreads) {
    const int first = s_first[k];
    int slot = 0;
    for (int t = 0; t < first; ++t) slot += s_first[t] == t;
    s_slot[k] = static_cast<short>(slot);
    if (first == k) {
      const long long key = s_key[k];
      const int64_t row = key >> 1;
      const bool b_side = key & 1;
      s_planes[slot] = (b_side ? pb : pa) + row * 4 * W;
      s_mask[slot] = ma ? (b_side ? mb : ma) + row * W : nullptr;
    }
  }
  __syncthreads();

  // as many words a chunk as one buffer holds of every slot's rows
  const int cw = min(kMaxChunk, (kStageWords / (planes * distinct)) & ~3);
  const int64_t n_chunks = (W + cw - 1) / cw;
  const int n_rows = distinct * planes;

  // VEC: the block's first warp asks for one bulk copy a row, which lands on
  // the buffer's barrier.  Otherwise every thread copies words itself, and
  // the block barrier before the chunk is read makes them visible.
  auto stage_chunk = [&](int buf, int64_t chunk) {
    const int64_t w0 = chunk * cw;
    const int width = W - w0 < cw ? static_cast<int>(W - w0) : cw;
    uint32_t* dst0 = stage + buf * kStageWords;
    if constexpr (VEC) {
      if (warp != 0) return;
      const uint32_t bar = smem_addr(&s_full[buf]);
      if (lane == 0) mbar_expect_tx(bar, n_rows * width * 4);
      __syncwarp();
      for (int r = lane; r < n_rows; r += 32) {
        const int slot = r / planes, x = r - slot * planes;
        const uint32_t* src = (x < 4 ? s_planes[slot] + x * W : s_mask[slot]) + w0;
        bulk_copy(smem_addr(dst0 + r * cw), src, width * 4, bar);
      }
    } else {
      for (int r = warp; r < n_rows; r += kWarps) {
        const int slot = r / planes, x = r - slot * planes;
        const uint32_t* src = (x < 4 ? s_planes[slot] + x * W : s_mask[slot]) + w0;
        uint32_t* dst = dst0 + r * cw;
        for (int k = lane; k < width; k += 32) dst[k] = src[k];
      }
    }
  };

  const int q4 = cw >> 2;  // uint4 a plane row of a chunk
  // a warp takes consecutive pairs: in a list sorted by sample they share
  // their first sample, whose words then stay in registers
  const int per_warp = (g + kWarps - 1) / kWarps;
  const int q_begin = warp * per_warp;
  const int q_end = q_begin + per_warp < g ? q_begin + per_warp : g;
  for (int st = 0; st < kStages - 1; ++st)
    if (st < n_chunks) stage_chunk(st, st);
  for (int64_t chunk = 0; chunk < n_chunks; ++chunk) {
    // every warp has read chunk - 1: its buffer takes the chunk kStages - 1 ahead
    __syncthreads();
    const int64_t ahead = chunk + kStages - 1;
    if (ahead < n_chunks) stage_chunk(static_cast<int>(ahead % kStages), ahead);
    if constexpr (VEC)
      mbar_wait(smem_addr(&s_full[chunk % kStages]), static_cast<int>((chunk / kStages) & 1));
    const uint4* buf = reinterpret_cast<const uint4*>(stage + (chunk % kStages) * kStageWords);
    const int64_t wl = chunk * cw + lane * 4;  // this lane's first word
    // words past the chunk's width hold an earlier chunk's bits: they lie at
    // or past W, so at or past L, and are cleared with the tail
    const bool tail = (wl + 4) * 32 > L;
    int held = -1;  // the slot whose words va holds
    uint4 va[5];
    for (int q = q_begin; q < q_end; ++q) {
      uint32_t m[4] = {0u, 0u, 0u, 0u};
      if (lane < q4) {
        const int sa = s_slot[q];
        if (sa != held) {
          const uint4* a = buf + sa * planes * q4 + lane;
#pragma unroll
          for (int x = 0; x < 5; ++x)
            if (x < planes) va[x] = a[x * q4];
          held = sa;
        }
        const uint4* b = buf + s_slot[g + q] * planes * q4 + lane;
        uint4 sh = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const uint4 vb = b[x * q4];
          sh.x |= va[x].x & vb.x; sh.y |= va[x].y & vb.y;
          sh.z |= va[x].z & vb.z; sh.w |= va[x].w & vb.w;
        }
        if (planes == 5) {
          const uint4 vb = b[4 * q4];
          sh.x |= va[4].x | vb.x; sh.y |= va[4].y | vb.y;
          sh.z |= va[4].z | vb.z; sh.w |= va[4].w | vb.w;
        }
        m[0] = ~sh.x; m[1] = ~sh.y; m[2] = ~sh.z; m[3] = ~sh.w;
        if (tail) {
#pragma unroll
          for (int k = 0; k < 4; ++k) m[k] = below_length(m[k], wl + k, L);
        }
      }
      if (!__any_sync(kFull, (m[0] | m[1] | m[2] | m[3]) != 0u)) continue;
      const int running = s_running[q];
      const int c = __popc(m[0]) + __popc(m[1]) + __popc(m[2]) + __popc(m[3]);
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      int off = running + incl - c;
      int32_t* row = out + (p0 + q) * (1 + static_cast<int64_t>(capacity));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t bits = m[k];
        while (bits && off < capacity) {
          row[1 + off] = static_cast<int32_t>((wl + k) * 32 + (__ffs(bits) - 1));
          bits &= bits - 1u;
          ++off;
        }
      }
      if (lane == 31) s_running[q] = running + incl;
    }
  }
  __syncthreads();

  for (int q = q_begin; q < q_end; ++q) {
    const int running = s_running[q];
    int32_t* row = out + (p0 + q) * (1 + static_cast<int64_t>(capacity));
    if (lane == 0) row[0] = running;
    for (int k = min(running, capacity) + lane; k < capacity; k += 32) row[1 + k] = -1;
  }
}

template <bool VEC>
int launch(const uint32_t* pa, const uint32_t* ma, const uint32_t* pb, const uint32_t* mb,
           const int64_t* ii, const int64_t* jj, int64_t P, int64_t W, int64_t L, int capacity,
           int group, int32_t* out, cudaStream_t stream) {
  constexpr int smem = kStages * kStageWords * static_cast<int>(sizeof(uint32_t));
  const cudaError_t rc = cudaFuncSetAttribute(
      mism_positions_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned blocks = static_cast<unsigned>((P + group - 1) / group);
  mism_positions_kernel<VEC><<<blocks, kThreads, smem, stream>>>(
      pa, ma, pb, mb, ii, jj, P, W, L, capacity, group, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, loaded with ctypes (tracs_tpu_torch/ops/kernels.py).
//
// pa, pb  : [n_a, 4, W] and [n_b, 4, W] uint32 planes, contiguous (raw planes,
//           or N-exclusive planes when the masks are given)
// ma, mb  : [n_a, W] and [n_b, W] uint32 N masks, or both null
// ii, jj  : int64 [P] row of A and row of B of each pair
// L       : sites; positions at or past L are not reported
// group   : consecutive pairs a block takes together, 1..128
// out     : int32 [P, 1 + capacity], contiguous
// stream  : the cudaStream_t to launch on
//
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).  The caller
// checks every bound; the kernel does not synchronise.
extern "C" int tracs_mism_positions_shared(const void* pa, const void* ma, const void* pb,
                                    const void* mb, const void* ii, const void* jj,
                                    long long P, long long W, long long L, int capacity,
                                    int group, void* out, void* stream) {
  if (P <= 0) return 0;
  if (group < 1 || group > kMaxGroup) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(pa) | reinterpret_cast<uintptr_t>(ma) |
                              reinterpret_cast<uintptr_t>(pb) | reinterpret_cast<uintptr_t>(mb);
  const bool vec = W % 4 == 0 && addresses % 16 == 0;
  auto* fn = vec ? launch<true> : launch<false>;
  return fn(static_cast<const uint32_t*>(pa), static_cast<const uint32_t*>(ma),
            static_cast<const uint32_t*>(pb), static_cast<const uint32_t*>(mb),
            static_cast<const int64_t*>(ii), static_cast<const int64_t*>(jj),
            static_cast<int64_t>(P), static_cast<int64_t>(W), static_cast<int64_t>(L), capacity,
            group, static_cast<int32_t*>(out), static_cast<cudaStream_t>(stream));
}
