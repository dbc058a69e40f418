// Mismatch positions of a batch of sample pairs on Hopper (sm_90a), for the
// recombination filter: two kernels of one function.
//
// Replaces tracs_tpu/ops/pairsnp.py::_mism_positions_kernel, which XLA runs
// as an unpack of every pair to [P, L] int32, a hierarchical cumsum along L
// and a vmapped searchsorted.  For pair p = (ii[p], jj[p]) both kernels write
// the row out[p] = [count, pos_0, ..., pos_{capacity-1}] (int32): the number
// of sites below L where the two samples share no allele, and the first
// ``capacity`` of those sites in ascending order; entries past the count hold
// -1.
//
// A site is shared when OR_x(a_x & b_x) is set.  With raw planes (no masks)
// that is the whole test; with the split layout (N-exclusive planes and N
// masks) an N on either side matches everything, so
// shared = OR_x(ea_x & eb_x) | na | nb.
//
// What bounds it on an H100.  The function's bytes: a pair's test is a
// handful of integer operations on 8 or 10 words per 32 sites.  The filter
// hands over the pairs a sweep block emitted, row-major, and those lie
// within clusters: at the main path's block 1,029 distinct samples make
// 10,280 pairs, so each sample's rows serve ~20 pairs.  Reading each
// distinct sample once is 0.64 GB (0.19 ms at 3.35 TB/s); reading both rows
// of every pair is 12.9 GB, which the warp kernel does (L2 serves the
// re-reads: 1.85 ms on an H100 80GB HBM3 at 700 W).  The tiled kernel stages
// 0.85 GB (tiles of 28 samples) and then reads the pairs' rows from shared
// memory, 6.5 GB at that block: those reads and their latency bound it
// (experiments/mism_positions_probe.py --tiled-parts on that card: the
// copies alone 0.25 ms, the copies and the pairs' mismatch words without
// ranks 0.61 ms, the whole kernel 0.65 ms).
//
// The tiled kernel (the design on the path).  The wrapper cuts the pair list
// into tiles of consecutive pairs holding at most kTileSamples (28) distinct
// samples and at most kMaxTilePairs pairs (ops/kernels.py::mism_tile_plan,
// on the host by csrc/mism_plan.cpp: the tiles, each tile's samples, each
// pair's two slots among them, and the tile's copies), and the word axis
// below L into K parts, so that tiles x K blocks make two waves or more on
// the card.  A block takes one (tile, part) by an atomic ticket and walks the
// part in chunks of CW = kChunkWords (128) words through a ring of
// shared-memory stages (a full tile's chunks fit three times): warp 0
// asks, for every run of samples on consecutive rows (up to 8), one TMA box
// of their 4 planes x CW words and one of their N masks (3-D and 2-D tensor
// maps over the resident layouts, one a box height; what a box reads past
// the pitch arrives as zeros, and bits at or past L are cleared anyway), all
// landing on the stage's full mbarrier; every warp
// reads the stage and arrives on its empty mbarrier, on which warp 0 waits
// before it refills the stage.  So each sample's words cross the memory
// system once a tile, not once a pair.  The 32 warps split the tile's pairs
// into runs; a lane forms CW / 32 mismatch words of a pair from shared memory
// (the first sample's words stay in registers while consecutive pairs share
// it, as the row-major list makes them), clears the bits at or past L and
// counts them with POPC; a ballot (a shuffle scan where a lane has two or
// more) plus the pair's running count of this part gives each mismatch its
// rank inside the part.
//
// Positions come out ascending across the parts without a host read: a block
// keeps the (pair, rank, position) of every mismatch whose rank is below the
// capacity in its warps' own regions of a global scratch (no atomics; the
// wrapper sizes them), publishes its per-pair
// counts (flag per block, release), waits for the blocks of the same tile's
// earlier parts (acquire; tickets are taken in order at the start, so a
// block waits only on blocks that are running and never wait on it; a wait
// that never completes traps), sums their counts into each pair's offset and
// writes its positions at offset + rank where that is below the capacity.
// The last part writes each pair's count and the -1 tail.  A block whose
// mismatches overflow its scratch region walks its part again, writing
// positions straight to their places (the offsets are known by then).
//
// The warp kernel (the first version, kept for inputs where tiles cannot
// pay: the wrapper's rule in ops/kernels.py::mism_design).  One warp per pair
// walks the word axis 32 words at a time, one word a lane, straight from the
// resident layout; the same scan and an FFS loop write the lane's positions
// while the offset is below the capacity.  It reads both rows of every pair,
// so at the main path's block L2 serves the re-reads and bounds it.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "plane_ring.cuh"

namespace {

using plane_ring::mbar_arrive;
using plane_ring::mbar_expect_tx;
using plane_ring::mbar_init;
using plane_ring::mbar_wait;
using plane_ring::tma_load_3d;

constexpr unsigned kFull = 0xFFFFFFFFu;

// Bits of word ``w`` (its 32 sites start at site 32 w) that lie below L.
__device__ __forceinline__ uint32_t below_length(uint32_t mism, int64_t w, int64_t L) {
  const int64_t inside = L - w * 32;
  if (inside >= 32) return mism;
  return inside <= 0 ? 0u : mism & (kFull >> static_cast<int>(32 - inside));
}

// ---------------------------------------------------------------------------
// the warp kernel: one warp a pair
// ---------------------------------------------------------------------------

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
mism_positions_warp(const uint32_t* __restrict__ pa, const uint32_t* __restrict__ ma,
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
      mism = below_length(~shared, w, L);
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

// ---------------------------------------------------------------------------
// the tiled kernel: a block a (tile of pairs, part of the word axis)
// ---------------------------------------------------------------------------

constexpr int kTileWarps = 32;
constexpr int kTileThreads = kTileWarps * 32;
constexpr int kMaxTilePairs = 512;   // pairs a tile: the per-pair state in shared memory
constexpr int kTileSamples = 28;     // samples a tile at most: a chunk of each a stage
constexpr int kChunkWords = 128;     // words a chunk: 4 a lane (at 8 a lane 1,024 threads spill)
constexpr int kMaxParts = 16;        // parts of the word axis
constexpr int kMinStages = 3;
constexpr int kMaxStages = 8;
constexpr int kRingBytes = 216 * 1024;   // the ring's share of an SM's shared memory
// a full tile's chunks (4 planes and the N mask of each sample) fit the fewest stages
static_assert(kMinStages * kTileSamples * 5 * kChunkWords * 4 <= kRingBytes,
              "three stages of a full tile's chunks must fit the ring");
static_assert(kTileSamples <= 255, "a slot is a byte of the pair's word");
constexpr int kMaxCapacity = 65535;      // a rank is the high half of an entry's first word
constexpr unsigned kFlagSpins = 1u << 24;   // polls of a flag before the kernel gives up

constexpr int kBoxSizes = 4;         // boxes of 1, 2, 4 or 8 consecutive rows

// the tensor maps of side A (0) and B (1) with a box of 1 << lg rows
struct TiledMaps {
  CUtensorMap planes[2][kBoxSizes];   // [n, 4, Wp] uint32, box {kChunkWords, 4, 1 << lg}
  CUtensorMap masks[2][kBoxSizes];    // [n, Wp] uint32, box {kChunkWords, 1 << lg}
};

struct TiledArgs {
  const int32_t* pair_start;   // [tiles + 1]: the tile's first pair
  const int32_t* key_start;    // [tiles + 1]: the tile's first sample in keys
  const int32_t* keys;         // a tile's samples: row of A, or ~row of B
  const int32_t* slots;        // [P]: slot of the pair's A sample | slot of B << 8
  const int32_t* box_start;    // [tiles + 1]: the tile's first copy in boxes
  const int32_t* boxes;        // a tile's copies: first slot | log2(rows) << 8
  int32_t* counts;             // [parts, P]: a part's mismatches of each pair
  int32_t* flags;              // [1 + tiles * parts]: the ticket, then a flag a block
  uint2* entries;              // [tiles * parts, entry_cap]: (pair | rank << 16, position),
                               // entry_cap / 16 a warp
  int32_t* out;                // [P, 1 + capacity]
  long long P, L, tiles;
  int capacity, parts, part_chunks, n_chunks, slots_alloc, stages, entry_cap;
};

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int word, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(map), "r"(bar), "r"(word), "r"(row) : "memory");
}

__device__ __forceinline__ int load_acquire(const int32_t* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int load_relaxed(const int32_t* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int32_t* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

// V consecutive words from shared memory, 8 or 16 bytes at a time
template <int V>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = p[0];
  } else if constexpr (V == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(p + k);
      v[k] = x.x; v[k + 1] = x.y; v[k + 2] = x.z; v[k + 3] = x.w;
    }
  }
}

template <bool MASK>
__global__ void __launch_bounds__(kTileThreads, 1)
mism_positions_tiled(const __grid_constant__ TiledMaps maps, const TiledArgs a) {
  constexpr int CW = kChunkWords;
  constexpr int V = CW / 32;              // words a lane holds of a chunk
  constexpr int kRows = MASK ? 5 : 4;     // rows staged a sample
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxStages];
  __shared__ int s_running[kMaxTilePairs];   // a pair's mismatches in this part so far
  __shared__ int s_prefix[kMaxTilePairs];    // a pair's mismatches in the earlier parts
  __shared__ int s_slots[kMaxTilePairs];
  __shared__ int s_keys[kTileSamples];
  __shared__ int s_boxes[kTileSamples];
  __shared__ int s_ticket, s_overflow;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int stages = a.stages;
  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kMaxStages + s); };
  if (tid == 0) {
    s_ticket = static_cast<int>(atomicAdd(reinterpret_cast<unsigned*>(a.flags), 1u));
    s_overflow = 0;
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);              // warp 0's arrive; the copies add their bytes
      mbar_init(empty(s), kTileWarps);    // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ticket = s_ticket;
  const long long tile = ticket / a.parts;
  const int part = ticket % a.parts;
  const int p0 = a.pair_start[tile], np = a.pair_start[tile + 1] - p0;
  const int k0 = a.key_start[tile], nk = a.key_start[tile + 1] - k0;
  const int b0 = a.box_start[tile], nb = a.box_start[tile + 1] - b0;
  for (int q = tid; q < np; q += kTileThreads) {
    s_slots[q] = a.slots[p0 + q];
    s_running[q] = 0;
  }
  for (int s = tid; s < nk; s += kTileThreads) s_keys[s] = a.keys[k0 + s];
  for (int b = tid; b < nb; b += kTileThreads) s_boxes[b] = a.boxes[b0 + b];
  __syncthreads();

  // the ring, at a multiple of 128 bytes: stage s holds, sample slot by
  // slot, [4][CW] plane words, then every slot's [CW] mask words
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (128u - (raw & 127u)) & 127u;
  const uint32_t* ring = reinterpret_cast<const uint32_t*>(smem_raw + pad);
  const uint32_t ring_addr = raw + pad;
  const int stage_words = a.slots_alloc * kRows * CW;
  const int mask_words = a.slots_alloc * 4 * CW;   // where a stage's masks start
  const int c0 = part * a.part_chunks;
  const int c1 = min(a.n_chunks, c0 + a.part_chunks);
  const int n = c1 > c0 ? c1 - c0 : 0;
  const int64_t L = a.L;
  const int cap = a.capacity;
  // this warp's entries: its own region of the block's, so no atomics
  const int warp_cap = a.entry_cap / kTileWarps;
  uint2* entries = a.entries + static_cast<int64_t>(ticket) * a.entry_cap + warp * warp_cap;
  int fill = 0;   // entries this warp has asked for (the same in every lane)
  int32_t* out = a.out;

  // warp 0: ring use g (stage g % stages) takes chunk ``chunk``, once the
  // stage's previous use has been read by every warp
  auto load = [&](int g, int chunk) {
    const int st = g % stages, use = g / stages;
    if (use > 0) mbar_wait(empty(st), (use - 1) & 1);
    if (lane == 0) mbar_expect_tx(full(st), nk * kRows * CW * 4);
    __syncwarp();
    const uint32_t dst = ring_addr + st * stage_words * 4;
    for (int b = lane; b < nb; b += 32) {
      // a box of consecutive rows lands on consecutive slots
      const int s = s_boxes[b] & 0xFF, lg = s_boxes[b] >> 8;
      const int key = s_keys[s];
      const int side = key < 0;
      const int row = side ? ~key : key;
      tma_load_3d(dst + s * 16 * CW, &maps.planes[side][lg], full(st), chunk * CW, 0, row);
      if constexpr (MASK)
        tma_load_2d(dst + (mask_words + s * CW) * 4, &maps.masks[side][lg], full(st),
                    chunk * CW, row);
    }
  };

  // this warp's run of the tile's pairs
  const int per_warp = (np + kTileWarps - 1) / kTileWarps;
  const int q_begin = min(np, warp * per_warp), q_end = min(np, q_begin + per_warp);

  // The mismatch words of pair q in the staged chunk, with the first
  // sample's rows in va (loaded when the slot changes).
  int held = -1;
  uint32_t va[kRows][V];
  auto pair_words = [&](const uint32_t* stage, int q, int64_t w0, bool tail,
                        uint32_t (&m)[V]) {
    const int sl = s_slots[q], sa = sl & 0xFF, sb = sl >> 8;
    if (sa != held) {
#pragma unroll
      for (int x = 0; x < 4; ++x) load_words<V>(stage + (sa * 4 + x) * CW + lane * V, va[x]);
      if constexpr (MASK) load_words<V>(stage + mask_words + sa * CW + lane * V, va[4]);
      held = sa;
    }
    uint32_t vb[V];
    load_words<V>(stage + sb * 4 * CW + lane * V, vb);
#pragma unroll
    for (int u = 0; u < V; ++u) m[u] = va[0][u] & vb[u];
#pragma unroll
    for (int x = 1; x < 4; ++x) {
      load_words<V>(stage + (sb * 4 + x) * CW + lane * V, vb);
#pragma unroll
      for (int u = 0; u < V; ++u) m[u] |= va[x][u] & vb[u];
    }
    if constexpr (MASK) {
      load_words<V>(stage + mask_words + sb * CW + lane * V, vb);
#pragma unroll
      for (int u = 0; u < V; ++u) m[u] |= va[4][u] | vb[u];
    }
    uint32_t any = 0u;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      m[u] = ~m[u];
      if (tail) m[u] = below_length(m[u], w0 + u, L);
      any |= m[u];
    }
    return any;
  };

  // Pair q's mismatches in the chunk (``hit``: the lanes that have some):
  // each gets its rank inside the part, from a ballot where no lane has two
  // (nearly always: tens of mismatches in a million sites), else from a
  // shuffle scan.  direct: written to its place in ``out`` (the offsets
  // s_prefix are known); otherwise kept as (pair, rank, position) while the
  // rank is below the capacity.
  auto emit = [&](int q, const uint32_t (&m)[V], int64_t w0, unsigned hit, bool direct) {
    int c = 0;
#pragma unroll
    for (int u = 0; u < V; ++u) c += __popc(m[u]);
    int excl, total;
    if (__ballot_sync(kFull, c > 1) == 0) {
      excl = __popc(hit & ((1u << lane) - 1u));
      total = __popc(hit);
    } else {
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      excl = incl - c;
      total = __shfl_sync(kFull, incl, 31);
    }
    const int run = s_running[q];
    int r = run + excl;   // the part's rank of this lane's first mismatch
    if (direct) {
      int32_t* row = out + (static_cast<int64_t>(p0) + q) * (1 + static_cast<int64_t>(cap)) + 1;
      const int pre = s_prefix[q];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        uint32_t bits = m[u];
        while (bits && pre + r < cap) {
          row[pre + r] = static_cast<int32_t>((w0 + u) * 32 + (__ffs(bits) - 1));
          bits &= bits - 1u;
          ++r;
        }
      }
    } else if (run < cap) {
      // ranks [run, min(run + total, cap)) go to consecutive entries
      const int base = fill - run;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        uint32_t bits = m[u];
        while (bits && r < cap) {
          if (base + r < warp_cap)
            entries[base + r] = make_uint2(
                static_cast<uint32_t>(q) | (static_cast<uint32_t>(r) << 16),
                static_cast<uint32_t>((w0 + u) * 32 + (__ffs(bits) - 1)));
          bits &= bits - 1u;
          ++r;
        }
      }
      fill += min(run + total, cap) - run;
    }
    __syncwarp();
    if (lane == 0) s_running[q] = run + total;
  };

  // The pairs of this warp's run in one staged chunk.
  auto chunk_pairs = [&](const uint32_t* stage, int chunk, bool direct) {
    const int64_t w0 = static_cast<int64_t>(chunk) * CW + lane * V;   // this lane's first word
    const bool tail = (static_cast<int64_t>(chunk) * CW + CW) * 32 > L;
    held = -1;
    for (int q = q_begin; q < q_end; ++q) {
      uint32_t m[V];
      const unsigned hit = __ballot_sync(kFull, pair_words(stage, q, w0, tail, m) != 0u);
      if (hit) emit(q, m, w0, hit, direct);
    }
  };

  // walks the part's n chunks as ring uses g0 .. g0 + n - 1
  auto walk = [&](int g0, bool direct) {
    if (warp == 0)
      for (int i = 0; i < min(n, stages); ++i) load(g0 + i, c0 + i);
    for (int i = 0; i < n; ++i) {
      const int g = g0 + i, st = g % stages;
      // the stage of the chunk before this one takes the chunk ``stages`` on
      if (warp == 0 && i >= 1 && i - 1 + stages < n) load(g - 1 + stages, c0 + i - 1 + stages);
      mbar_wait(full(st), (g / stages) & 1);
      chunk_pairs(ring + st * stage_words, c0 + i, direct);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
  };

  walk(0, false);
  if (lane == 0 && fill > warp_cap) s_overflow = 1;
  __syncthreads();

  // publish this part's counts, then wait for the tile's earlier parts
  const int64_t P = a.P;
  for (int q = tid; q < np; q += kTileThreads) a.counts[part * P + p0 + q] = s_running[q];
  __threadfence();
  __syncthreads();
  if (tid == 0) store_release(a.flags + 1 + ticket, 1);
  if (tid < part) {
    const int32_t* flag = a.flags + 1 + tile * a.parts + tid;
    for (unsigned spins = 0; load_acquire(flag) == 0; ++spins) {
      if (spins > kFlagSpins) __trap();
      __nanosleep(64);
    }
  }
  __syncthreads();
  for (int q = tid; q < np; q += kTileThreads) {
    int pre = 0;
    for (int j = 0; j < part; ++j) pre += load_relaxed(a.counts + j * P + p0 + q);
    s_prefix[q] = pre;
  }
  __syncthreads();

  // the last part writes each pair's count and the -1 past it
  if (part == a.parts - 1) {
    for (int q = warp; q < np; q += kTileWarps) {
      const int total = s_prefix[q] + s_running[q];
      int32_t* row = out + (static_cast<int64_t>(p0) + q) * (1 + static_cast<int64_t>(cap));
      if (lane == 0) row[0] = total;
      for (int k = min(total, cap) + lane; k < cap; k += 32) row[1 + k] = -1;
    }
  }
  if (!s_overflow) {
    // each warp writes its own entries
    for (int e = lane; e < fill; e += 32) {
      const uint2 v = entries[e];
      const int q = v.x & 0xFFFF, off = s_prefix[q] + static_cast<int>(v.x >> 16);
      if (off < cap)
        out[(static_cast<int64_t>(p0) + q) * (1 + static_cast<int64_t>(cap)) + 1 + off] =
            static_cast<int32_t>(v.y);
    }
  } else {
    // the part's mismatches overflowed its entries: walk it again, writing
    // every position to its place
    __syncthreads();
    for (int q = tid; q < np; q += kTileThreads) s_running[q] = 0;
    __syncthreads();
    walk(n, true);
  }
}

template <bool MASK>
cudaError_t launch_tiled(const TiledMaps& maps, const TiledArgs& args, cudaStream_t stream) {
  auto* kernel = mism_positions_tiled<MASK>;
  const int smem = args.stages * args.slots_alloc * (MASK ? 5 : 4) * kChunkWords * 4 + 128;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(args.tiles * args.parts), kTileThreads, smem, stream>>>(maps,
                                                                                       args);
  return cudaGetLastError();
}

// the tensor maps: [n, 4, W] planes with a box of ``rows`` samples' 4 planes
// x kChunkWords words, and [n, W] masks with a box of ``rows`` x kChunkWords words, no
// swizzle; what a box reads past the tensor's edge arrives as zeros
int encode_planes(plane_ring::EncodeTiledFn encode, CUtensorMap* map, const void* base,
                  long long W, long long n, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)W, 4, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)W * 16};
  const cuuint32_t box[3] = {(cuuint32_t)kChunkWords, 4, (cuuint32_t)rows};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int encode_mask(plane_ring::EncodeTiledFn encode, CUtensorMap* map, const void* base,
                long long W, long long n, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)W, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)W * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kChunkWords, (cuuint32_t)rows};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The stages of the ring for ``slots`` samples a tile (with N masks or
// without): as many as fit, at most kMaxStages; the static_assert above
// keeps it at kMinStages or more for every tile the plan makes.
int ring_stages(int slots, bool mask) {
  const int s = kRingBytes / (slots * (mask ? 5 : 4) * kChunkWords * 4);
  return s < kMaxStages ? s : kMaxStages;
}

}  // namespace

// C entry points, loaded with ctypes (tracs_tpu_torch/ops/kernels.py).  Each
// returns the first CUDA error (0 = cudaSuccess); the kernels do not
// synchronise, and the caller checks every bound not named here.

// The warp kernel.
// pa, pb  : [n_a, 4, W] and [n_b, 4, W] uint32 planes, contiguous (raw planes,
//           or N-exclusive planes when the masks are given)
// ma, mb  : [n_a, W] and [n_b, W] uint32 N masks, or both null
// ii, jj  : int64 [P] row of A and row of B of each pair
// L       : sites; positions at or past L are not reported
// out     : int32 [P, 1 + capacity], contiguous
extern "C" int tracs_mism_positions_warp(const void* pa, const void* ma, const void* pb,
                                         const void* mb, const void* ii, const void* jj,
                                         long long P, long long W, long long L, int capacity,
                                         void* out, void* stream) {
  if (P <= 0) return 0;
  const unsigned blocks = (unsigned)((P + kWarpsPerBlock - 1) / kWarpsPerBlock);
  mism_positions_warp<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pa), static_cast<const uint32_t*>(ma),
      static_cast<const uint32_t*>(pb), static_cast<const uint32_t*>(mb),
      static_cast<const int64_t*>(ii), static_cast<const int64_t*>(jj),
      static_cast<int64_t>(P), static_cast<int64_t>(W), static_cast<int64_t>(L), capacity,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The int32 words of scratch the tiled kernel needs: 2 words an entry,
// entry_cap a block, then the ticket and a flag a block, then a count a
// (pair, part).
extern "C" long long tracs_mism_positions_scratch_words(long long tiles, int parts, long long P,
                                                        int entry_cap) {
  return 2 * tiles * parts * (long long)entry_cap + 1 + tiles * parts + parts * P;
}

// The tiled kernel.
// pa, ma, pb, mb : as for the warp kernel, with n_a and n_b rows; W is the
//           word pitch, a multiple of 4, every base 16-byte aligned (the
//           tensor maps' rule)
// plan    : int32 [tiles + 1] pair_start, [tiles + 1] key_start, [n_keys]
//           keys (row of A, or ~row of B), [P] slots (A's | B's << 8),
//           [tiles + 1] box_start, then the boxes (first slot | log2(rows)
//           << 8, at most 8 rows): the wrapper's mism_tile_plan; a tile
//           holds at most 512 pairs and ``slots`` samples (at most 28)
// parts, part_chunks, n_chunks : the cut of the word axis below L into chunks
//           of 128 words, at most 16 parts
// scratch : int32 [tracs_mism_positions_scratch_words(...)], 8-byte aligned;
//           its ticket and flags are zeroed here first
// out     : int32 [P, 1 + capacity], capacity at most 65535
extern "C" int tracs_mism_positions_tiled(const void* pa, const void* ma, const void* pb,
                                          const void* mb, long long n_a, long long n_b,
                                          long long W, long long L, int capacity,
                                          const void* plan, long long tiles, long long n_keys,
                                          long long P, int slots, int parts,
                                          int part_chunks, int n_chunks, int entry_cap,
                                          void* scratch, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mask = ma != nullptr;
  if (P <= 0 || tiles <= 0) return 0;
  if (slots < 1 || slots > kTileSamples || parts < 1 ||
      parts > kMaxParts || capacity < 0 || capacity > kMaxCapacity || W % 4 != 0 ||
      tiles * parts >= (1LL << 31) || P >= (1LL << 31) || entry_cap < kTileWarps ||
      entry_cap % kTileWarps != 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 7u))
    return static_cast<int>(cudaErrorInvalidValue);
  plane_ring::EncodeTiledFn encode = nullptr;
  cudaError_t err = plane_ring::encoder(&encode);
  if (err != cudaSuccess) return static_cast<int>(err);
  TiledMaps maps;
  int rc = 0;
  for (int lg = 0; lg < kBoxSizes && !rc; ++lg) {
    rc = encode_planes(encode, &maps.planes[0][lg], pa, W, n_a, 1 << lg);
    if (!rc) rc = encode_planes(encode, &maps.planes[1][lg], pb, W, n_b, 1 << lg);
    if (!rc && mask) rc = encode_mask(encode, &maps.masks[0][lg], ma, W, n_a, 1 << lg);
    if (!rc && mask) rc = encode_mask(encode, &maps.masks[1][lg], mb, W, n_b, 1 << lg);
    if (!mask) maps.masks[0][lg] = maps.masks[1][lg] = maps.planes[0][lg];   // never read
  }
  if (rc) return rc;
  const int32_t* words = static_cast<const int32_t*>(plan);
  int32_t* sc = static_cast<int32_t*>(scratch);
  const long long blocks = tiles * parts;
  TiledArgs args;
  args.pair_start = words;
  args.key_start = words + tiles + 1;
  args.keys = words + 2 * (tiles + 1);
  args.slots = words + 2 * (tiles + 1) + n_keys;
  args.box_start = args.slots + P;
  args.boxes = args.box_start + tiles + 1;
  args.entries = reinterpret_cast<uint2*>(sc);
  args.flags = sc + 2 * blocks * entry_cap;
  args.counts = args.flags + 1 + blocks;
  args.out = static_cast<int32_t*>(out);
  args.P = P;
  args.L = L;
  args.tiles = tiles;
  args.capacity = capacity;
  args.parts = parts;
  args.part_chunks = part_chunks;
  args.n_chunks = n_chunks;
  args.slots_alloc = slots;
  args.stages = ring_stages(slots, mask);
  args.entry_cap = entry_cap;
  err = cudaMemsetAsync(args.flags, 0, (size_t)(1 + blocks) * 4, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mask ? launch_tiled<true>(maps, args, st)
                              : launch_tiled<false>(maps, args, st));
}

// The build's facts of the tiled kernel with N masks (mask 1) or without:
// registers a thread, local memory a thread (spills), static shared memory a
// block.
extern "C" int tracs_mism_positions_attributes(int mask, int* registers, int* local_bytes,
                                               int* shared_bytes) {
  const void* fn = mask ? (const void*)mism_positions_tiled<true>
                        : (const void*)mism_positions_tiled<false>;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return 0;
}
