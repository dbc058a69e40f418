// Threshold, triangle mask and row-major COO compaction of one block of the
// all-pairs sweep on Hopper (sm_90a), with the D/NN assembly fused in, in one
// launch.
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
// What bounds it on an H100.  Bytes: the in-range pairs' g (and gp) read
// once, 16 B written a survivor; a pair costs a handful of integer
// operations.  At the main path's block (1024 x 4096 triangle pairs, 0.5%
// survivors) that is 29 MB, 9 us at 3.35 TB/s.  A count pass, a scan and an
// emit pass with the host reading the total between them to size the output
// would be bound by that round trip (0.1-0.2 ms a block), not by the bytes;
// so there is one launch, and the host waits once, for the total, after it.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// block_kernels): 0.016 ms on the card for that block, 64 registers.
//
// Design.  The output is sized on the host with no card involved: a block
// keeps at most the pairs the triangle and n_valid masks leave, plain
// arithmetic on its geometry (ops/kernels.py::coo_capacity).  The wrapper
// allocates that many 16-byte rows, [capacity, 4], and this kernel is
// launched once; it counts, scans and emits, so the survivors are the first k
// rows, one contiguous piece.  The total k goes to device memory, from where the
// wrapper copies it to a pinned host word: the one wait of a call.
//
// A row is cut into segments of kSeg = 1024 columns, one warp a segment, and
// 8 consecutive segments (row-major) are a tile, one block a tile.  A warp
// walks its segment 32 columns a step, the loads of 8 steps in flight, forms
// D and counts its survivors with __ballot_sync/__popc; lane u keeps the
// ballot of step u, so the 32 steps' survivors cost one register.  The block
// sums its warps' counts and takes its place in the scan by decoupled
// look-back (Merrill and Garland's single-pass scan): it publishes its
// aggregate in a status word, sums its predecessors' published values 32 at
// a time, a warp's lane a predecessor, until it meets an inclusive prefix,
// and publishes its own.  Tiles are numbered by an atomic ticket that a block
// takes when it starts, not by blockIdx, so a block waits only on tiles that
// have started and none can wait on one that cannot run; a wait that never
// completes traps instead of hanging the card.  Then each warp walks the
// steps whose ballot is not empty and places each surviving lane at its
// offset plus the survivors of the lanes below it (__popc of the ballot under
// the lane mask), so the order within a row is kept; only those lanes read
// the grams again (L2 still holds them) and NN's gram.  At most 64 registers
// a thread keep four blocks on an SM: the main path's first block, 512
// tiles, runs in one wave.  The mode (split with or without the correction
// gram, direct) is a template parameter, so no branch on it sits between
// one step's loads and the next.
//
// The ticket counter, the total and the tiles' status words (a flag for an
// aggregate, a flag for an inclusive prefix, a 62-bit value) are scratch that
// the wrapper allocates at the length tracs_coo_extract_scratch_words gives;
// the entry point refuses a shorter buffer and zeroes them on the stream
// before the launch (a memset of 16 + 8 x tiles bytes).  Offsets are 64-bit: a block may
// hold 2^31 pairs or more.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;            // warps a block: the segments of a tile
constexpr int kSteps = 32;           // 32-column steps a segment: one ballot a lane
constexpr int kSeg = 32 * kSteps;    // columns a segment
constexpr int kInFlight = 8;         // steps whose loads a warp issues together
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kSpinLimit = 1u << 24;   // polls of a status word before the kernel gives up

// a tile's status word: 0 until published, then a flag and a value
constexpr unsigned long long kPrefix = 1ull << 63;      // the value is an inclusive prefix
constexpr unsigned long long kAggregate = 1ull << 62;   // the value is the tile's own count
constexpr unsigned long long kValueMask = kAggregate - 1;

struct Block {
  const int32_t* g;      // [rb, m]
  const int32_t* gn;     // [rb, m]
  const int32_t* gp;     // [rb, m] or null
  const int32_t* cnt_a;  // [rb] or null (direct mode)
  const int32_t* cnt_b;  // [m] or null
  int64_t rb, m, nseg;
  int64_t diag;          // triangle: column j survives only above i + diag
  int64_t jhi;           // columns at or past this lie past n_valid
  int32_t L, thr;
  int triangle;
};

struct Scan {
  unsigned long long* ticket;   // the ticket counter, zero before the launch
  long long* total;             // the number of survivors, written by the last tile
  unsigned long long* status;   // [tiles] status words, zero before the launch
};

// D of pair (i, j); ``base`` = L - cnt_a[i] (split) or L (direct), wrapping.
template <bool kSplit, bool kGp>
__device__ __forceinline__ int32_t distance(const Block& b, uint32_t base, int64_t idx,
                                            int64_t j) {
  uint32_t sub = static_cast<uint32_t>(__ldg(b.g + idx));
  if constexpr (kGp) sub += static_cast<uint32_t>(__ldg(b.gp + idx));
  if constexpr (kSplit) sub += static_cast<uint32_t>(__ldg(b.cnt_b + j));
  return static_cast<int32_t>(base - sub);
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// The exclusive prefix of tile ``tile`` whose own count is ``agg``, by
// decoupled look-back; called by a whole warp, lane ``lane``.  Publishes the
// tile's aggregate first and its inclusive prefix last.
__device__ long long look_back(const Scan& sc, long long tile, long long agg, int lane) {
  if (tile == 0) {
    if (lane == 0) store_status(&sc.status[0], kPrefix | (unsigned long long)agg);
    return 0;
  }
  if (lane == 0) store_status(&sc.status[tile], kAggregate | (unsigned long long)agg);
  long long excl = 0;
  for (long long pred = tile - 1;; pred -= 32) {
    // lane l reads predecessor pred - l; before tile 0 lies a prefix of 0
    const long long idx = pred - lane;
    unsigned long long w;
    for (unsigned spins = 0;; ++spins) {
      w = idx >= 0 ? load_status(&sc.status[idx]) : kPrefix;
      if (__all_sync(kFull, w != 0)) break;
      if (spins > kSpinLimit) __trap();
      __nanosleep(32);
    }
    const long long v = (long long)(w & kValueMask);
    const unsigned prefixes = __ballot_sync(kFull, (w & kPrefix) != 0);
    if (prefixes) {   // the nearest inclusive prefix ends the walk
      const int first = __ffs(prefixes) - 1;
      excl += warp_sum(lane <= first ? v : 0);
      break;
    }
    excl += warp_sum(v);
  }
  if (lane == 0)
    store_status(&sc.status[tile], kPrefix | (unsigned long long)(excl + agg));
  return excl;
}

template <bool kSplit, bool kGp>
__global__ void __launch_bounds__(kWarps * 32, 4)
coo_extract_kernel(Block b, Scan sc, long long tiles, int4* __restrict__ out) {
  __shared__ long long tile_s, base_s;
  __shared__ int counts[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_s = (long long)atomicAdd(sc.ticket, 1ull);
  __syncthreads();
  const long long tile = tile_s;
  const long long w = tile * kWarps + warp;   // the warp's segment, row-major
  const bool has = w < b.rb * b.nseg;         // the same for the whole warp

  // the segment's columns [lo, hi) that can hold survivors
  int64_t i = 0, col0 = 0, lo = 0, hi = 0;
  uint32_t base = 0;
  unsigned mine = 0;   // lane u holds the ballot of the survivors of step u
  int count = 0;
  if (has) {
    i = w / b.nseg;
    col0 = (w % b.nseg) * kSeg;
    lo = col0;
    if (b.triangle && i + b.diag + 1 > lo) lo = i + b.diag + 1;
    hi = col0 + kSeg < b.jhi ? col0 + kSeg : b.jhi;
    base = static_cast<uint32_t>(b.L);
    if constexpr (kSplit) base -= static_cast<uint32_t>(b.cnt_a[i]);
    const int64_t row = i * b.m;
    for (int u0 = 0; u0 < kSteps; u0 += kInFlight) {
      int32_t d[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int64_t j = col0 + 32 * (u0 + u) + lane;
        d[u] = (j >= lo && j < hi) ? distance<kSplit, kGp>(b, base, row + j, j) : 0;
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int64_t j = col0 + 32 * (u0 + u) + lane;
        const unsigned ballot = __ballot_sync(kFull, j >= lo && j < hi && d[u] <= b.thr);
        count += __popc(ballot);
        if (lane == u0 + u) mine = ballot;
      }
    }
  }
  if (lane == 0) counts[warp] = count;
  __syncthreads();
  if (warp == 0) {
    // the warps' exclusive offsets inside the tile, then the tile's in the block
    const int c = lane < kWarps ? counts[lane] : 0;
    int incl = c;
#pragma unroll
    for (int s = 1; s < kWarps; s <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += x;
    }
    const long long agg = __shfl_sync(kFull, incl, kWarps - 1);
    const long long excl = look_back(sc, tile, agg, lane);
    if (lane < kWarps) counts[lane] = incl - c;
    if (lane == 0) {
      base_s = excl;
      if (tile == tiles - 1) *sc.total = excl + agg;
    }
  }
  __syncthreads();
  if (!has || count == 0) return;

  // the steps with survivors again: their grams are in L2 still, and only
  // the surviving lanes read them
  long long pos = base_s + counts[warp];
  const unsigned below = (1u << lane) - 1u;
  const int64_t row = i * b.m;
  for (int u = 0; u < kSteps; ++u) {
    const unsigned ballot = __shfl_sync(kFull, mine, u);
    if (ballot == 0) continue;
    if (ballot >> lane & 1u) {
      const int64_t j = col0 + 32 * u + lane;
      // NN = base - cnt_b[j] + gn (split) or base - gn (direct: base = L)
      const uint32_t gn = static_cast<uint32_t>(__ldg(b.gn + row + j));
      uint32_t nn = base - gn;
      if constexpr (kSplit) nn = base - static_cast<uint32_t>(__ldg(b.cnt_b + j)) + gn;
      out[pos + __popc(ballot & below)] =
          make_int4(static_cast<int>(i), static_cast<int>(j),
                    distance<kSplit, kGp>(b, base, row + j, j), static_cast<int>(nn));
    }
    pos += __popc(ballot);
  }
}

// Tiles of an rb x m block: 8 segments of 1024 columns each, row-major.
long long scan_tiles(long long rb, long long m) {
  const long long nseg = m > 0 ? (m + kSeg - 1) / kSeg : 0;
  return rb > 0 ? (rb * nseg + kWarps - 1) / kWarps : 0;
}

}  // namespace

// The int64 words of scratch tracs_coo_extract needs for an rb x m block:
// the ticket counter, the total and one status word a tile.
extern "C" long long tracs_coo_extract_scratch_words(long long rb, long long m) {
  return 2 + scan_tiles(rb, m);
}

// C entry point, loaded with ctypes (tracs_tpu_torch/ops/kernels.py).
//
// g, gn   : int32 [rb, m], contiguous; gp: the same or null
// cnt_a   : int32 [rb], cnt_b: int32 [m] (split == 1), or both null (direct)
// L, thr  : sites, and the threshold already clamped to [-1, 2^31 - 1]
// diag    : r0 - c0 (read when triangle != 0); jhi: n_valid - c0 clamped to [0, m]
// scratch : int64 [scratch_words]: the ticket counter, the total (written by
//           the launch, 0 when the block is empty), the tiles' status words;
//           zeroed here first.  Refused (cudaErrorInvalidValue) when shorter
//           than tracs_coo_extract_scratch_words(rb, m)
// out     : int32 [capacity, 4], capacity at least the number of survivors:
//           rows (row, column, D, NN), local indices; rows [0, total) are
//           written, in row-major order
// stream  : the cudaStream_t to launch on
//
// Returns the memset's error or cudaGetLastError() after the launch (0 =
// cudaSuccess).  The caller checks every other bound; the kernel does not
// synchronise.
extern "C" int tracs_coo_extract(const void* g, const void* gn, const void* gp, const void* cnt_a,
                                 const void* cnt_b, long long rb, long long m, int L, int thr,
                                 long long diag, int triangle, long long jhi, int split,
                                 void* scratch, long long scratch_words, void* out,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = scan_tiles(rb, m);
  if (tiles >= (1LL << 31) || scratch_words < 2 + tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)(2 + tiles) * 8, st);
  if (err != cudaSuccess || tiles == 0) return static_cast<int>(err);
  Block b;
  b.g = static_cast<const int32_t*>(g);
  b.gn = static_cast<const int32_t*>(gn);
  b.gp = static_cast<const int32_t*>(gp);
  b.cnt_a = static_cast<const int32_t*>(cnt_a);
  b.cnt_b = static_cast<const int32_t*>(cnt_b);
  b.rb = rb;
  b.m = m;
  b.nseg = (m + kSeg - 1) / kSeg;
  b.diag = diag;
  b.jhi = jhi;
  b.L = L;
  b.thr = thr;
  b.triangle = triangle;
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  Scan sc;
  sc.ticket = words;
  sc.total = reinterpret_cast<long long*>(words + 1);
  sc.status = words + 2;
  const dim3 grid((unsigned)tiles), block(kWarps * 32);
  int4* rows = static_cast<int4*>(out);
  if (!split)
    coo_extract_kernel<false, false><<<grid, block, 0, st>>>(b, sc, tiles, rows);
  else if (gp)
    coo_extract_kernel<true, true><<<grid, block, 0, st>>>(b, sc, tiles, rows);
  else
    coo_extract_kernel<true, false><<<grid, block, 0, st>>>(b, sc, tiles, rows);
  return static_cast<int>(cudaGetLastError());
}

// The build's facts of the kernel of a mode (split with or without gp, or
// direct: split == 0): registers a thread, local memory a thread (spills),
// static shared memory a block.
extern "C" int tracs_coo_extract_attributes(int split, int gp, int* registers, int* local_bytes,
                                            int* shared_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, !split ? coo_extract_kernel<false, false>
                    : gp ? coo_extract_kernel<true, true> : coo_extract_kernel<true, false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return 0;
}
