// The tile plan of the tiled mismatch-position kernel (csrc/mism_positions.cu):
// host code, built with g++ at first use (runtime/build.py::load_host_library)
// and called by ops/kernels.py::mism_tile_plan.
//
// The pair list (ii[p], jj[p]) is cut greedily, in the caller's order, into
// tiles of consecutive pairs: a tile grows while it holds at most ``samples``
// distinct samples and ``max_pairs`` pairs.  A sample is a row of A, or a row
// of B when the two sides are separate layouts (one_layout 0: row r of B is
// key ~r, apart from row r of A).  Each tile's samples are listed sorted by
// side, then row, and each pair gets the slots of its two samples among them.
// The tile's copies follow: every run of samples on consecutive rows of one
// side is cut into boxes of 8, 4, 2 or 1 rows (largest first), so that one
// TMA copy brings several samples where the layout keeps them together (a
// cluster of consecutive samples is a handful of copies a chunk, not one
// a sample).  One pass over the pairs, with the tile that last took each row
// and its slot there kept per row: tens of microseconds a sweep block, well
// under the kernel's own time.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

constexpr int kMaxBoxLog = 3;   // boxes of up to 8 rows

// sorts tile t's keys by (side, row), renumbers the slots of its pairs and
// appends its boxes (first slot | log2(rows) << 8)
void finish_tile(long long t, const int32_t* pair_start, const int32_t* key_start,
                 int32_t* keys, int32_t* slots, int32_t* box_start, int32_t* boxes,
                 long long& n_boxes) {
  const int k0 = key_start[t], nk = key_start[t + 1] - k0;
  int order[64], renumber[64];
  int32_t sorted[64];
  auto rank = [&](int32_t key) { return key >= 0 ? (long long)key : (1LL << 32) + ~key; };
  for (int s = 0; s < nk; ++s) order[s] = s;
  std::sort(order, order + nk,
            [&](int x, int y) { return rank(keys[k0 + x]) < rank(keys[k0 + y]); });
  for (int s = 0; s < nk; ++s) {
    renumber[order[s]] = s;
    sorted[s] = keys[k0 + order[s]];
  }
  std::copy(sorted, sorted + nk, keys + k0);
  for (int p = pair_start[t]; p < pair_start[t + 1]; ++p)
    slots[p] = renumber[slots[p] & 0xFF] | renumber[slots[p] >> 8] << 8;
  box_start[t] = static_cast<int32_t>(n_boxes);
  for (int s = 0; s < nk;) {
    int run = 1;
    while (s + run < nk && rank(sorted[s + run]) == rank(sorted[s]) + run &&
           (sorted[s + run] >= 0) == (sorted[s] >= 0))
      ++run;
    for (int lg = kMaxBoxLog; run > 0; --lg) {
      while (run >= (1 << lg)) {
        boxes[n_boxes++] = s | lg << 8;
        s += 1 << lg;
        run -= 1 << lg;
      }
    }
  }
}

}  // namespace

// pair_start, key_start, box_start : int32 [P + 1]; keys, boxes : int32 [2 P];
// slots : int32 [P] (A's slot | B's slot << 8).  Returns the number of tiles
// T (pair_start, key_start and box_start hold T + 1 entries, keys
// key_start[T], boxes box_start[T]), or -1 as soon as the tiles' samples add
// up to more than stop_above (when stop_above >= 0), or -2 for a pair index
// outside [0, n_a) x [0, n_b) or caps outside [2, 64] x [1, 512].
extern "C" long long tracs_mism_tile_plan(const int64_t* ii, const int64_t* jj, long long P,
                                          long long n_a, long long n_b, int samples,
                                          int max_pairs, int one_layout, long long stop_above,
                                          int32_t* pair_start, int32_t* key_start,
                                          int32_t* keys, int32_t* slots, int32_t* box_start,
                                          int32_t* boxes) {
  if (samples < 2 || samples > 64 || max_pairs < 1 || max_pairs > 512) return -2;
  std::vector<long long> tile_a(n_a, -1), tile_b(one_layout ? 0 : n_b, -1);
  std::vector<int32_t> slot_a(n_a), slot_b(one_layout ? 0 : n_b);
  long long t = 0, nk = 0, n_boxes = 0;
  int held = 0, pairs = 0;
  pair_start[0] = key_start[0] = box_start[0] = 0;
  for (long long p = 0; p < P; ++p) {
    const int64_t a = ii[p], b = jj[p];
    if (a < 0 || a >= n_a || b < 0 || b >= n_b) return -2;
    long long& tb = one_layout ? tile_a[b] : tile_b[b];
    const int fresh = (tile_a[a] != t) + (tb != t && (!one_layout || b != a));
    if (pairs > 0 && (held + fresh > samples || pairs == max_pairs)) {
      pair_start[t + 1] = static_cast<int32_t>(p);
      key_start[t + 1] = static_cast<int32_t>(nk);
      finish_tile(t, pair_start, key_start, keys, slots, box_start, boxes, n_boxes);
      ++t;
      held = pairs = 0;
    }
    if (tile_a[a] != t) {
      tile_a[a] = t;
      slot_a[a] = held++;
      keys[nk++] = static_cast<int32_t>(a);
    }
    int32_t& sb = one_layout ? slot_a[b] : slot_b[b];
    if (tb != t) {
      tb = t;
      sb = held++;
      keys[nk++] = static_cast<int32_t>(one_layout ? b : ~b);
    }
    slots[p] = slot_a[a] | sb << 8;
    ++pairs;
    if (stop_above >= 0 && nk > stop_above) return -1;
  }
  if (P > 0) {
    pair_start[t + 1] = static_cast<int32_t>(P);
    key_start[t + 1] = static_cast<int32_t>(nk);
    finish_tile(t, pair_start, key_start, keys, slots, box_start, boxes, n_boxes);
    ++t;
  }
  box_start[t] = static_cast<int32_t>(n_boxes);
  return t;
}
