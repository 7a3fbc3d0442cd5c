// The histogram engine's single-device pass: grouped value counts and
// their exact float64 contraction in one kernel, the (G, V, T) histogram
// never written to device memory.
//
// Replaces the Pallas kernel illico_tpu/ops/hist_engine.py:_hist_kernel
// (launched by grouped_histograms through hist_pass) together with the
// contraction that consumes its output (illico_tpu/ops/hist_engine.py:
// hist_contract, jnp).  Two kernels:
//
//   row_counts_kernel:  cnt[v, j] = #{ r in rows : x[r, j] == table[v] }
//     over a row list: the reference group's rows give OVO's reference
//     counts a, every real row gives OVR's value counts c.
//   grouped_hist_contract_kernel: each (group, 32-column block) counted in
//     shared hist[V][32] with K1's bucket rule, then contracted over v for
//     its 32 columns, with tab and a from torch:
//       fc[g, j]   = sum_v h * v
//       main[g, j] = sum_v h * tab[v, j]                   (U2 or R2)
//       tie[g, j]  = sum_v (h^3 - h) + 3*a*h*(a + h)       (OVO)
//       nz[g, j]   = sum_{v>0} h                           (k, nnz split)
//       tot[g, j]  = sum_v h                               (OVO totals)
//     Under the nnz split the v=0 plane is left out of main and tie.
//     These are csrc/hist_contract.cu's contract_kernel sums, with the
//     bucket rule and the tie term from hist_common.cuh.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  The grouped pass reads each
// row it counts once (n_rows * T * 4 bytes) and writes the (G, T) float64
// outputs; tab and a (V * T * 8 bytes each) stay in the 50 MB L2 and are
// read only where h != 0.  The float64 work, a dozen operations per nonzero
// count, is far below the card's float64 rate.
//
// Design (both kernels):
// - Persistent CTAs over work items (row chunk, 32-column block).  One
//   wave, SMs x resident CTAs; the shared counts are zeroed once per CTA.
//   The grouped kernel's items differ in cost (a group, a split chunk, the
//   reference's counts; and a column's cost follows its gene's expression),
//   so a global counter hands them out, largest first; row_counts' equal
//   chunks are walked by a stride.  (Binding each CTA to one column block
//   was slower: the CTAs of heavily expressed columns finished last.)
// - Staged row loads (hist_common.cuh:load_index, load_rows).  Rows are
//   dealt to the CTA's warps in turn, so all of them count a short group; a
//   warp loads 12 row indices in one instruction, broadcasts them by
//   shuffle and has their 12 row segments in flight together, not 4
//   chained index -> value pairs.  Two rounds are staged in registers (v,
//   w); the next item's are loaded during the current item's epilogue, its
//   bounds and row indices while the current item counts.  Registers and
//   not a shared ring: at V=512 the counts take 64 KB of shared memory,
//   three CTAs an SM, and leave no room for a ring of the same depth.
// - A sparse epilogue, O(nonzero buckets) and not O(V).  Each lane keeps a
//   64-bit register bitmap of the buckets it counted, bit k / W (W warps),
//   and ORs it into the CTA's shared bitmap once an item.  After one barrier
//   warp w walks its buckets v = W i + w for the set bits i, ascending (those
//   K1's write loop gave it), adds each nonzero count's terms and writes the
//   count back to zero: the next item finds zeros without a pass over V.
//   The bitmaps alternate by item parity, so clearing one waits on nothing.
// - No straggler group.  The grouped kernel takes OVO's reference group
//   from the counting pass's counts (the same counts: chip_smoke.py holds
//   row_counts == hist[ref]) without reading its rows, and the largest
//   other groups longer than SPLIT_ROWS in row chunks
//   (ops/hist_engine.py:fused_work, passed by value).  A chunk adds its
//   nonzero counts into a global int32 scratch plane with atomics; the
//   last chunk of a (group, column block) to finish (a ticket per block)
//   contracts the plane.  Its items come from `order` and `indptr`: no
//   work list in device memory.
//
// What holds it (hist_fused_probe.py times each part on the card; PERF.md
// section 6): at V=512 reading every row without counting runs at ~36% of
// the byte bound and counting without reading at ~44%, so both must get
// faster, and together they overlap poorly; the epilogue's L2 reads of tab
// and a take about a quarter.  Not yet tested: the cost of an item itself
// (about 320 a CTA, each behind the order -> indptr -> perm -> x chain and
// two barriers).
//
// Exactness: every count is an integer, tab and v integers, so every
// product and sum is an integer; the statics' narrow tiers prove the
// statistics below 2^53, where any order of the sum over v gives the same
// bits.  The order is fixed all the same: warp w sums its v = w, w + W,
// ... ascending (from the bitmap, the reference counts or the scratch
// plane alike), the warps' partial sums are added in warp order (warp 0's
// first), and each product and sum rounds on its own (__dmul_rn/__dadd_rn),
// so past 2^53, where a sum may differ from the plain version's in its last
// bits (as the contraction kernels' may), it does not change from run to
// run.
//
// Shared memory at V=512: 64 KB of counts, 8.25 KB of partial sums and
// 512 bytes of bitmaps, three 8-warp CTAs an SM; at V=256, six 4-warp CTAs
// of 32 KB of counts each (Shape, Tier).  row_counts_kernel has the same
// counting and staging; its epilogue adds each nonzero count into the
// (V, T) output with an int32 atomic (the order of integer atomics cannot
// change a total) and zeroes it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_common.cuh"

namespace {

using illico_hist::kCols;

constexpr int kParts = 4;  // partial sums, one warp reduces each: fc, main, tie, nz
constexpr int kMaxV = 512;  // ops/hist_engine.py:MAX_V
constexpr int kMaskWords = 2;  // coarse bitmap, 64 bits a column: bit i = a count in
                               // [kWarps * i, kWarps * (i + 1))
constexpr int kPhase = 4;  // values whose table loads a count issues together
constexpr int kEpiBatch = 2;  // buckets whose loads an epilogue issues together

// A kernel's shape: kWarps warps a CTA (warp w's buckets are v = w, w +
// kWarps, ...), kBatch rows a warp stages a round (twice over), and the
// CTAs an SM that __launch_bounds__ must fit (it caps the registers a
// thread may take).
template <int kWarps_, int kBatch_, int kMinBlocks_>
struct Shape {
  static constexpr int kWarps = kWarps_, kBatch = kBatch_, kMinBlocks = kMinBlocks_;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int64_t kRound = static_cast<int64_t>(kWarps) * kBatch;  // rows a CTA stages
  static_assert(kWarps >= kParts, "warp p reduces partial sum p");
  static_assert(kBatch % kPhase == 0, "a staged round is whole phases");
};

// The shapes are the fastest that hist_fused_probe.py found on the card
// (PERF.md section 6).  At V=512 the counts take 64 KB of shared memory,
// three CTAs an SM, and a thread may take 80 registers.  At V <= 256 shared
// memory allows more CTAs, but capping the registers to fit them spills and
// is slower; the grouped kernel takes 4-warp CTAs there instead, six an SM
// at 80 registers: the same warps, twice the items in flight.  So it is
// built once per table tier, V <= 256 and <= 512 (kTierMaxV), and its
// wrapper picks the tier of its v_buckets.  row_counts_kernel, whose items
// are long and need no epilogue sums, is fastest at every V in 16-warp
// CTAs, two an SM at 64 registers, staging 8 rows a warp.
constexpr int kTiers = 2;
constexpr int kTierMaxV[kTiers] = {256, kMaxV};
template <int kTier> struct Tier;
template <> struct Tier<0> { using Fused = Shape<4, 12, 6>; };
template <> struct Tier<1> { using Fused = Shape<8, 12, 3>; };
using CountShape = Shape<16, 8, 2>;

int tier_of(int v_buckets) {
  int t = 0;
  while (t + 1 < kTiers && v_buckets > kTierMaxV[t]) ++t;
  return t;
}

constexpr int64_t kMinChunkRows = 1024;  // row_counts: rows per item, at least
constexpr int kItemsPerCta = 8;  // row_counts: items per resident CTA, at most
// The grouped kernel's chunks: first every chunk of the split groups (the
// largest groups but the reference past SPLIT_ROWS rows, at most kMaxSplit:
// ops/hist_engine.py:fused_work), then every group in `order` (by size,
// largest first).  An item's slot: a split group's scratch plane (>= 0),
// kWhole (the group's rows counted here), kFromCounts (OVO's reference,
// contracted from the counting pass's counts) or kSkip (a split group's
// own entry in `order`: its chunks do its work).
constexpr int kMaxSplit = 8;  // ops/hist_engine.py:MAX_SPLIT_SLOTS
constexpr int kWhole = -1;
constexpr int kFromCounts = -2;
constexpr int kSkip = -3;

// The split groups, passed by value: group[s] is split into chunks
// first[s] .. first[s + 1] - 1 of equal rows (the last one shorter).
struct SplitSpec {
  int n;
  int group[kMaxSplit];
  int first[kMaxSplit + 1];
};

// Shared layout: [partials: (kParts * kWarps + 1) * kCols doubles, fused
// only: each warp's four sums, then warp 0's v=0 count] [hist: v_buckets *
// kCols int32] [mask: 2 (item parity) * kMaskWords * kCols uint32] [the
// next item, the last-chunk flag].
template <class S>
size_t smem_bytes(int v_buckets, bool partials) {
  return (partials ? sizeof(double) * (kParts * S::kWarps + 1) * kCols : 0) +
         sizeof(int32_t) * static_cast<size_t>(v_buckets) * kCols +
         sizeof(uint32_t) * 2 * kMaskWords * kCols + 2 * sizeof(int64_t);
}

// The warp's rows of the round at `base`: rows base + w + kWarps * u for
// u < n (interleaved, so every warp of a CTA counts a share of a short
// group).  Warp-uniform.
template <class S>
__device__ __forceinline__ int round_rows(int64_t base, int64_t end) {
  const int64_t first = base + (threadIdx.x >> 5);
  if (first >= end) return 0;
  const int64_t left = (end - first + S::kWarps - 1) / S::kWarps;
  return left < S::kBatch ? static_cast<int>(left) : S::kBatch;
}

// One round of the warp's rows staged into v; the rows it holds.
template <class S>
__device__ __forceinline__ int stage(const float* __restrict__ x,
                                     const int32_t* __restrict__ rows, int64_t base,
                                     int64_t end, int64_t t_cols, int64_t col, bool col_ok,
                                     float (&v)[S::kBatch]) {
  const int n = round_rows<S>(base, end);
  if (n) {
    const int32_t index =
        illico_hist::load_index(rows, base + (threadIdx.x >> 5), S::kWarps, n);
    illico_hist::load_rows(x, index, n, t_cols, col, col_ok, v);
  }
  return n;
}

// Counts one staged round into the lane's column: zeros in a register,
// every other bucket k in hist_col, and bit k / kWarps of `seen`, the lane's
// coarse bitmap (one shared atomic a value, as K1).  kPhase values at a
// time: their candidates, then their table loads together (accept()), then
// the counts.
template <class S, bool kLog1p>
__device__ __forceinline__ void count_staged(const float (&v)[S::kBatch], int n, bool col_ok,
                                             const float* __restrict__ table, int v_buckets,
                                             int32_t* hist_col, int32_t& zeros,
                                             unsigned long long& seen) {
  if (!col_ok) return;
#pragma unroll
  for (int u0 = 0; u0 < S::kBatch; u0 += kPhase) {
    if (u0 >= n) break;
    int k[kPhase];
    float x[kPhase];
#pragma unroll
    for (int i = 0; i < kPhase; ++i) {
      x[i] = v[u0 + i];
      k[i] = u0 + i < n ? illico_hist::candidate<kLog1p>(x[i], v_buckets) : -1;
    }
    illico_hist::accept(k, x, table);
#pragma unroll
    for (int i = 0; i < kPhase; ++i) {
      if (k[i] < 0) continue;
      if (k[i] == 0) {
        ++zeros;
      } else {
        atomicAdd(hist_col + k[i] * kCols, 1);
        seen |= 1ull << (static_cast<unsigned int>(k[i]) / S::kWarps);
      }
    }
  }
}

// The next item's first two rounds, in two steps: ahead() loads their row
// indices (issued while the CTA still counts the current item), stage_ahead()
// their values into v and w (issued after the item's barrier, in flight
// during its epilogue).  A group of up to 2 * kRound rows then waits on no
// load once its item starts.
struct Ahead {
  int32_t index0, index1;
  int n, nw;
};

template <class S>
__device__ __forceinline__ Ahead ahead(const int32_t* __restrict__ rows, int64_t begin,
                                       int64_t end) {
  const int64_t first = begin + (threadIdx.x >> 5);
  Ahead a;
  a.n = round_rows<S>(begin, end);
  a.nw = round_rows<S>(begin + S::kRound, end);
  a.index0 = illico_hist::load_index(rows, first, S::kWarps, a.n);
  a.index1 = illico_hist::load_index(rows, first + S::kRound, S::kWarps, a.nw);
  return a;
}

template <class S>
__device__ __forceinline__ void stage_ahead(const float* __restrict__ x, const Ahead& a,
                                            int64_t t_cols, int64_t col, bool col_ok,
                                            float (&v)[S::kBatch], float (&w)[S::kBatch]) {
  if (a.n) illico_hist::load_rows(x, a.index0, a.n, t_cols, col, col_ok, v);
  if (a.nw) illico_hist::load_rows(x, a.index1, a.nw, t_cols, col, col_ok, w);
}

// The warp's rows of [begin, end), its first two rounds staged in v and w:
// each later round's loads are issued before the one staged ahead of it is
// counted (v and w in turn).  (Loading a round's row indices two rounds
// ahead, not just before its values, was no faster.)  Then the zeros into
// bucket 0 and the coarse bitmap into the CTA's `mask` (two words a column).
template <class S, bool kLog1p>
__device__ __forceinline__ void count_item(const float* __restrict__ x,
                                           const int32_t* __restrict__ rows, int64_t begin,
                                           int64_t end, int64_t t_cols, int64_t col,
                                           bool col_ok, const float* __restrict__ table,
                                           int v_buckets, int32_t* hist_col,
                                           uint32_t* mask_col, float (&v)[S::kBatch],
                                           float (&w)[S::kBatch], int n, int nw) {
  constexpr int64_t kRound = S::kRound;
  int32_t zeros = 0;
  unsigned long long seen = 0;
  for (int64_t base = begin + kRound;;) {  // base: the round held in w
    count_staged<S, kLog1p>(v, n, col_ok, table, v_buckets, hist_col, zeros, seen);
    if (nw == 0) break;
    n = stage<S>(x, rows, base + kRound, end, t_cols, col, col_ok, v);
    count_staged<S, kLog1p>(w, nw, col_ok, table, v_buckets, hist_col, zeros, seen);
    if (n == 0) break;
    base += 2 * kRound;
    nw = stage<S>(x, rows, base, end, t_cols, col, col_ok, w);
  }
  if (zeros) atomicAdd(hist_col, zeros);
  const uint32_t lo = static_cast<uint32_t>(seen), hi = static_cast<uint32_t>(seen >> 32);
  if (lo) atomicOr(mask_col, lo);
  if (hi) atomicOr(mask_col + kCols, hi);
}

// One (group, column) sum set: the warp's partial sums, h0 = the v=0 count.
struct Sums {
  double fc = 0.0, main = 0.0, tie = 0.0, nz = 0.0, h0 = 0.0;
};

// Bucket v's terms with count hd (> 0), in ascending v within the warp;
// t = tab[v, j], a = ref[v, j] (read only where they are used).  v = 0
// comes first in warp 0's walk and adds nothing to fc or nz.
template <bool kTie, bool kNnzSplit>
__device__ __forceinline__ void add_bucket(Sums& s, int v, double hd, double t, double a) {
  if (v == 0) {
    s.h0 = hd;
    if (!kNnzSplit) {
      s.main = __dadd_rn(s.main, __dmul_rn(hd, t));
      if (kTie) s.tie = __dadd_rn(s.tie, illico_hist::tie_term(hd, a));
    }
    return;
  }
  s.fc = __dadd_rn(s.fc, __dmul_rn(hd, static_cast<double>(v)));
  s.nz = __dadd_rn(s.nz, hd);
  s.main = __dadd_rn(s.main, __dmul_rn(hd, t));
  if (kTie) s.tie = __dadd_rn(s.tie, illico_hist::tie_term(hd, a));
}

template <bool kNnzSplit>
__device__ __forceinline__ bool reads_tables(int v) {
  return v > 0 || !kNnzSplit;
}

// The next kEpiBatch of the warp's candidate buckets v = kWarps * i + warp
// for the set bits i of `bits`, ascending (-1: none, or past the table).
template <class S>
__device__ __forceinline__ void next_candidates(unsigned long long& bits, int v_buckets,
                                                int (&v)[kEpiBatch]) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kEpiBatch; ++i) {
    v[i] = -1;
    if (bits) {
      const int c = S::kWarps * (__ffsll(static_cast<long long>(bits)) - 1) + warp;
      bits &= bits - 1;
      if (c < v_buckets) v[i] = c;
    }
  }
}

__device__ __forceinline__ unsigned long long coarse_bits(const uint32_t* mask_col) {
  return mask_col[0] | (static_cast<unsigned long long>(mask_col[kCols]) << 32);
}

// The sparse epilogue of an item counted here: bucket 0 (warp 0, from the
// zeros), then the warp's buckets v = w, w + kWarps, ... that the coarse
// bitmap marks, ascending, kEpiBatch buckets' loads issued together.  Leaves the
// warp's counts at zero.
template <class S, bool kTie, bool kNnzSplit>
__device__ __forceinline__ void contract_counted(Sums& s, int32_t* hist,
                                                 const uint32_t* mask_col, int v_buckets,
                                                 int64_t col, bool col_ok, int64_t t_cols,
                                                 const double* __restrict__ tab,
                                                 const double* __restrict__ ref) {
  const int lane = threadIdx.x & 31;
  if (!col_ok) return;  // nothing was counted in this column
  if ((threadIdx.x >> 5) == 0 && hist[lane] != 0) {
    const double hd = static_cast<double>(hist[lane]);
    hist[lane] = 0;
    const bool use = reads_tables<kNnzSplit>(0);
    add_bucket<kTie, kNnzSplit>(s, 0, hd, use ? __ldg(tab + col) : 0.0,
                                kTie && use ? __ldg(ref + col) : 0.0);
  }
  unsigned long long bits = coarse_bits(mask_col);
  while (bits) {
    int v[kEpiBatch];
    double h[kEpiBatch], t[kEpiBatch], a[kEpiBatch];
    next_candidates<S>(bits, v_buckets, v);
#pragma unroll
    for (int i = 0; i < kEpiBatch; ++i) {
      h[i] = t[i] = a[i] = 0.0;
      if (v[i] >= 0) {
        int32_t* cell = hist + v[i] * kCols + lane;
        const int32_t c = *cell;
        if (c) {
          *cell = 0;
          h[i] = static_cast<double>(c);
          const int64_t off = static_cast<int64_t>(v[i]) * t_cols + col;
          t[i] = __ldg(tab + off);
          if (kTie) a[i] = __ldg(ref + off);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kEpiBatch; ++i) {
      if (h[i] != 0.0) add_bucket<kTie, kNnzSplit>(s, v[i], h[i], t[i], a[i]);
    }
  }
}

// Counts of a (V, T) plane read from device memory: the reference counts
// (float64, read-only) or a split group's scratch plane (int32, added by
// other CTAs' atomics: read from L2).
struct PlaneF64 {
  const double* p;
  __device__ __forceinline__ double operator()(int64_t i) const { return __ldg(p + i); }
};
struct PlaneI32 {
  const int32_t* p;
  __device__ __forceinline__ double operator()(int64_t i) const {
    return static_cast<double>(__ldcg(p + i));
  }
};

// The dense epilogue of an item whose counts lie in a (V, T) plane: warp w
// reads its v = w, w + kWarps, ... ascending, kEpiBatch at a time, zero counts
// skipped (a zero adds +0.0 to a non-negative sum).
template <class S, bool kTie, bool kNnzSplit, class Plane>
__device__ __forceinline__ void contract_plane(Sums& s, Plane plane, int v_buckets,
                                               int64_t col, bool col_ok, int64_t t_cols,
                                               const double* __restrict__ tab,
                                               const double* __restrict__ ref) {
  if (!col_ok) return;
  const int warp = threadIdx.x >> 5;
  for (int v0 = warp; v0 < v_buckets; v0 += S::kWarps * kEpiBatch) {
    double h[kEpiBatch], t[kEpiBatch], a[kEpiBatch];
#pragma unroll
    for (int i = 0; i < kEpiBatch; ++i) {
      const int v = v0 + i * S::kWarps;
      h[i] = v < v_buckets ? plane(static_cast<int64_t>(v) * t_cols + col) : 0.0;
    }
#pragma unroll
    for (int i = 0; i < kEpiBatch; ++i) {
      const int v = v0 + i * S::kWarps;
      const int64_t off = static_cast<int64_t>(v) * t_cols + col;
      const bool use = h[i] != 0.0 && reads_tables<kNnzSplit>(v);
      t[i] = use ? __ldg(tab + off) : 0.0;
      a[i] = kTie && use ? __ldg(ref + off) : 0.0;
    }
#pragma unroll
    for (int i = 0; i < kEpiBatch; ++i) {
      if (h[i] != 0.0) add_bucket<kTie, kNnzSplit>(s, v0 + i * S::kWarps, h[i], t[i], a[i]);
    }
  }
}

// An item's epilogue that hands its counts on: every nonzero count of the
// warp's marked buckets added into `out` (a (V, T) int32 plane) with an
// atomic, the counts left at zero.
template <class S>
__device__ __forceinline__ void flush_counted(int32_t* hist, const uint32_t* mask_col,
                                              int v_buckets, int32_t* __restrict__ out,
                                              int64_t col, bool col_ok, int64_t t_cols) {
  const int lane = threadIdx.x & 31;
  if (!col_ok) return;
  if ((threadIdx.x >> 5) == 0 && hist[lane] != 0) {
    atomicAdd(out + col, hist[lane]);
    hist[lane] = 0;
  }
  unsigned long long bits = coarse_bits(mask_col);
  while (bits) {
    int v[kEpiBatch];
    next_candidates<S>(bits, v_buckets, v);
#pragma unroll
    for (int i = 0; i < kEpiBatch; ++i) {
      if (v[i] < 0) continue;
      int32_t* cell = hist + v[i] * kCols + lane;
      const int32_t c = *cell;
      if (c) {
        atomicAdd(out + static_cast<int64_t>(v[i]) * t_cols + col, c);
        *cell = 0;
      }
    }
  }
}

// An item's chunk (item / n_col_blocks) and column block (item %
// n_col_blocks).  Offsets into perm fit int32: perm holds int32 row
// indices of x, each row at most once.
struct Item {
  int32_t group, begin, end, slot, parts, block;
};

// The group of an item in `order`'s part of the chunks (-1 for a split
// chunk): loaded an item ahead of decode(), so that decoding waits on no
// chain of loads.
__device__ __forceinline__ int order_group(const int32_t* __restrict__ order,
                                           const SplitSpec& split, int64_t item,
                                           int n_col_blocks) {
  const int64_t chunk = item / n_col_blocks - split.first[split.n];
  return chunk >= 0 ? __ldg(order + chunk) : -1;
}

__device__ __forceinline__ Item decode(const int64_t* __restrict__ indptr,
                                       const SplitSpec& split, int ref_code, int64_t item,
                                       int group, int n_col_blocks) {
  const int64_t chunk = item / n_col_blocks;
  Item it;
  it.block = static_cast<int32_t>(item - chunk * n_col_blocks);
  if (chunk < split.first[split.n]) {
    int s = 0;
    while (chunk >= split.first[s + 1]) ++s;
    const int g = split.group[s];
    const int32_t lo = static_cast<int32_t>(__ldg(indptr + g));
    const int32_t hi = static_cast<int32_t>(__ldg(indptr + g + 1));
    it.group = g;
    it.slot = s;
    it.parts = split.first[s + 1] - split.first[s];
    const int32_t step = (hi - lo + it.parts - 1) / it.parts;
    const int32_t part = static_cast<int32_t>(chunk) - split.first[s];
    it.begin = lo + part * step;
    it.end = it.begin + step < hi ? it.begin + step : hi;
    return it;
  }
  it.group = group;
  it.begin = static_cast<int32_t>(__ldg(indptr + group));
  it.end = static_cast<int32_t>(__ldg(indptr + group + 1));
  it.parts = 1;
  it.slot = group == ref_code ? kFromCounts : kWhole;
  for (int s = 0; s < split.n; ++s) {
    if (split.group[s] == group) it.slot = kSkip;
  }
  if (it.slot != kWhole) it.end = it.begin;  // no rows to read
  return it;
}

__device__ __forceinline__ int64_t column(int block) {
  return static_cast<int64_t>(block) * kCols + (threadIdx.x & 31);
}

// row_counts_kernel's items are chunks of equal rows: CTA c takes items c,
// c + grid, c + 2 * grid, ..., its column block changing from one to the
// next (the columns' costs differ with their genes' expression).

template <class S, bool kLog1p>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks) row_counts_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ rows, int64_t n_rows,
    const float* __restrict__ table, int32_t* __restrict__ cnt, int64_t t_cols,
    int n_col_blocks, int64_t rows_per_chunk, int64_t n_items, int v_buckets) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* hist = reinterpret_cast<int32_t*>(smem);  // [v_buckets][kCols]
  auto* mask = reinterpret_cast<uint32_t*>(hist + v_buckets * kCols);
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < v_buckets * kCols; i += S::kThreads) hist[i] = 0;
  for (int i = threadIdx.x; i < 2 * kMaskWords * kCols; i += S::kThreads) mask[i] = 0;
  __syncthreads();

  int32_t* hist_col = hist + lane;
  float v[S::kBatch], w[S::kBatch];
  auto bounds = [&](int64_t it, int64_t& begin, int64_t& end, int64_t& col) {
    const int64_t chunk = it / n_col_blocks;
    begin = chunk * rows_per_chunk;
    end = begin + rows_per_chunk < n_rows ? begin + rows_per_chunk : n_rows;
    col = (it - chunk * n_col_blocks) * kCols + lane;
  };
  int64_t item = blockIdx.x, begin = 0, end = 0, col = 0;
  Ahead a{0, 0, 0, 0};
  if (item < n_items) {
    bounds(item, begin, end, col);
    a = ahead<S>(rows, begin, end);
    stage_ahead<S>(x, a, t_cols, col, col < t_cols, v, w);
  }
  for (int parity = 0; item < n_items; parity ^= 1) {
    uint32_t* mask_col = mask + parity * kMaskWords * kCols + lane;
    const bool col_ok = col < t_cols;
    const int64_t done_col = col, done_begin = begin, done_end = end;
    item += gridDim.x;
    if (item < n_items) {  // the next item's row indices, loaded while this one counts
      bounds(item, begin, end, col);
      a = ahead<S>(rows, begin, end);
    }
    count_item<S, kLog1p>(x, rows, done_begin, done_end, t_cols, done_col, col_ok, table,
                          v_buckets, hist_col, mask_col, v, w, a.n, a.nw);
    __syncthreads();  // the item's counts are complete

    if (item < n_items) {  // the next item's first rows in flight during the epilogue
      stage_ahead<S>(x, a, t_cols, col, col < t_cols, v, w);
    } else {
      a = Ahead{0, 0, 0, 0};
    }
    flush_counted<S>(hist, mask_col, v_buckets, cnt, done_col, col_ok, t_cols);
    __syncthreads();  // every count is back at zero before the next item counts
    if ((threadIdx.x >> 5) == S::kWarps - 1) mask_col[0] = mask_col[kCols] = 0;
  }
}

// grouped_hist_contract_kernel's items differ (a group's rows, a split
// chunk, the reference's counts), so a counter hands them out, largest
// first: CTA c starts with item c, then takes grid + the counter's next
// value.  Each item's successor is known one item ahead: its group (from
// `order`) is read during the epilogue before, its bounds while the CTA
// counts, its row indices right after, its rows during the epilogue.
template <class S, bool kLog1p, bool kTie, bool kNnzSplit>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks) grouped_hist_contract_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ perm,
    const int64_t* __restrict__ indptr, const int32_t* __restrict__ order, SplitSpec split,
    int ref_code, int64_t n_items, const float* __restrict__ table,
    const double* __restrict__ tab, const double* __restrict__ ref,
    const double* __restrict__ ref_counts, double* __restrict__ fc,
    double* __restrict__ main_out, double* __restrict__ tie, double* __restrict__ nz_out,
    double* __restrict__ tot, unsigned int* __restrict__ next_item,
    unsigned int* __restrict__ tickets, int32_t* __restrict__ planes, int64_t t_cols,
    int n_col_blocks, int v_buckets) {
  constexpr int kWarps = S::kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  double* part = reinterpret_cast<double*>(smem);  // [kParts][kWarps][kCols], then h0
  int32_t* hist = reinterpret_cast<int32_t*>(part + (kParts * kWarps + 1) * kCols);
  auto* mask = reinterpret_cast<uint32_t*>(hist + v_buckets * kCols);
  auto* next_slot = reinterpret_cast<int64_t*>(mask + 2 * kMaskWords * kCols);
  auto* last_slot = reinterpret_cast<int*>(next_slot + 1);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < v_buckets * kCols; i += S::kThreads) hist[i] = 0;
  for (int i = threadIdx.x; i < 2 * kMaskWords * kCols; i += S::kThreads) mask[i] = 0;
  if (threadIdx.x == 0) *next_slot = gridDim.x + atomicAdd(next_item, 1u);
  __syncthreads();

  int32_t* hist_col = hist + lane;
  const int64_t plane_size = static_cast<int64_t>(v_buckets) * t_cols;
  float v[S::kBatch], w[S::kBatch];
  int64_t item = blockIdx.x, next = *next_slot;
  int next_group = next < n_items ? order_group(order, split, next, n_col_blocks) : -1;
  Item it{};
  Ahead a{0, 0, 0, 0};
  if (item < n_items) {
    it = decode(indptr, split, ref_code, item,
                order_group(order, split, item, n_col_blocks), n_col_blocks);
    a = ahead<S>(perm, it.begin, it.end);
    stage_ahead<S>(x, a, t_cols, column(it.block), column(it.block) < t_cols, v, w);
  }
  for (int parity = 0; item < n_items; parity ^= 1) {
    unsigned int ticket = 0;
    if (threadIdx.x == 0) ticket = atomicAdd(next_item, 1u);  // the item after next
    uint32_t* mask_col = mask + parity * kMaskWords * kCols + lane;
    const Item done = it;
    const int64_t col = column(done.block);
    const bool col_ok = col < t_cols;
    const int n = a.n, nw = a.nw;
    if (next < n_items) {  // read while this item counts
      it = decode(indptr, split, ref_code, next, next_group, n_col_blocks);
    }
    if (done.slot >= kWhole) {  // a split chunk or a whole group: rows to count
      count_item<S, kLog1p>(x, perm, done.begin, done.end, t_cols, col, col_ok, table,
                            v_buckets, hist_col, mask_col, v, w, n, nw);
    }
    a = next < n_items ? ahead<S>(perm, it.begin, it.end) : Ahead{0, 0, 0, 0};
    if (threadIdx.x == 0) *next_slot = gridDim.x + ticket;
    __syncthreads();  // the item's counts are complete

    item = next;
    next = *next_slot;
    if (next < n_items) next_group = order_group(order, split, next, n_col_blocks);
    if (item < n_items) {  // the next item's first rows in flight during the epilogue
      stage_ahead<S>(x, a, t_cols, column(it.block), column(it.block) < t_cols, v, w);
    }

    Sums s;
    bool write = done.slot != kSkip;
    if (done.slot == kWhole) {
      contract_counted<S, kTie, kNnzSplit>(s, hist, mask_col, v_buckets, col, col_ok, t_cols,
                                           tab, ref);
    } else if (done.slot == kFromCounts) {
      contract_plane<S, kTie, kNnzSplit>(s, PlaneF64{ref_counts}, v_buckets, col, col_ok,
                                         t_cols, tab, ref);
    } else if (done.slot >= 0) {
      int32_t* plane = planes + done.slot * plane_size;
      flush_counted<S>(hist, mask_col, v_buckets, plane, col, col_ok, t_cols);
      __threadfence();  // this chunk's counts reach L2 before its ticket
      __syncthreads();
      if (threadIdx.x == 0) {
        const unsigned int got =
            atomicAdd(tickets + static_cast<int64_t>(done.slot) * n_col_blocks + done.block,
                      1u);
        *last_slot = got + 1 == static_cast<unsigned int>(done.parts);
      }
      __syncthreads();
      write = *last_slot != 0;
      if (write) {  // the last chunk of this (group, column block): every count is in
        __threadfence();
        contract_plane<S, kTie, kNnzSplit>(s, PlaneI32{plane}, v_buckets, col, col_ok,
                                           t_cols, tab, ref);
      }
    }

    part[(0 * kWarps + warp) * kCols + lane] = s.fc;
    part[(1 * kWarps + warp) * kCols + lane] = s.main;
    part[(2 * kWarps + warp) * kCols + lane] = s.tie;
    part[(3 * kWarps + warp) * kCols + lane] = s.nz;
    if (warp == 0) part[kParts * kWarps * kCols + lane] = s.h0;
    __syncthreads();  // partials written; every count is back at zero

    // Warp p adds sum p's partials in warp order (warp 0's first) and
    // writes it; the last warp clears this item's bitmap.
    if (warp < kParts && col_ok && write) {
      const double* row = part + warp * kWarps * kCols + lane;
      double acc = row[0];
      for (int k = 1; k < kWarps; ++k) acc = __dadd_rn(acc, row[k * kCols]);
      const int64_t i = static_cast<int64_t>(done.group) * t_cols + col;
      if (warp == 0) {
        fc[i] = acc;
      } else if (warp == 1) {
        main_out[i] = acc;
      } else if (warp == 2) {
        if (kTie) tie[i] = acc;
      } else {
        if (kNnzSplit) nz_out[i] = acc;
        if (tot != nullptr) tot[i] = __dadd_rn(acc, part[kParts * kWarps * kCols + lane]);
      }
    }
    if (warp == kWarps - 1) mask_col[0] = mask_col[kCols] = 0;
  }
}

// One persistent wave of `kernel`: the SMs times the CTAs an SM holds at
// `threads` threads and `smem` bytes, at most `n_items`.  0 on error.
template <class Kernel>
int64_t wave(Kernel kernel, int threads, size_t smem, int64_t n_items, cudaError_t& err) {
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return 0;
  const int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  return grid < n_items ? grid : n_items;
}

// The pointers of one grouped pass, as illico_hist_contract takes them.
struct FusedArgs {
  const float* x;
  const int32_t* perm;
  const int64_t* indptr;
  const int32_t* order;
  SplitSpec split;
  int ref_code;
  int64_t n_items;
  const float* table;
  const double *tab, *ref, *ref_counts;
  double *fc, *main_out, *tie, *nz, *tot;
  unsigned int *next_item, *tickets;
  int32_t* planes;
  int64_t t_cols;
  int n_col_blocks, v_buckets;
};

// grouped_hist_contract_kernel of one tier and flags, on `stream`.
template <int kTier, bool kLog1p, bool kTie, bool kNnzSplit>
cudaError_t launch_fused(const FusedArgs& f, cudaStream_t stream) {
  using S = typename Tier<kTier>::Fused;
  static_assert(kTierMaxV[kTier] <= 64 * S::kWarps, "bucket v is bit v / kWarps of 64");
  auto kernel = grouped_hist_contract_kernel<S, kLog1p, kTie, kNnzSplit>;
  const size_t smem = smem_bytes<S>(f.v_buckets, true);
  cudaError_t err;
  const int64_t grid = wave(kernel, S::kThreads, smem, f.n_items, err);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned int>(grid), S::kThreads, smem, stream>>>(
      f.x, f.perm, f.indptr, f.order, f.split, f.ref_code, f.n_items, f.table, f.tab, f.ref,
      f.ref_counts, f.fc, f.main_out, f.tie, f.nz, f.tot, f.next_item, f.tickets, f.planes,
      f.t_cols, f.n_col_blocks, f.v_buckets);
  return cudaGetLastError();
}

// launch_fused<kTier, ...> for the flags at 4 * kLog1p + 2 * kTie + kNnzSplit.
template <int kTier>
cudaError_t launch_fused_tier(int flags, const FusedArgs& f, cudaStream_t stream) {
  using Launch = cudaError_t (*)(const FusedArgs&, cudaStream_t);
  static const Launch launches[8] = {
      launch_fused<kTier, false, false, false>, launch_fused<kTier, false, false, true>,
      launch_fused<kTier, false, true, false>,  launch_fused<kTier, false, true, true>,
      launch_fused<kTier, true, false, false>,  launch_fused<kTier, true, false, true>,
      launch_fused<kTier, true, true, false>,   launch_fused<kTier, true, true, true>,
  };
  return launches[flags](f, stream);
}

}  // namespace

// Each entry point launches on `stream` and returns the cudaError_t of its
// launch (0 = success).  Pointers are device pointers to contiguous arrays:
// x (n_cells, t_cols) float32 row-major, table (v_buckets,) float32,
// v_buckets at most 512.

// rows (n_rows,) int32 row indices into x; cnt (v_buckets, t_cols) int32
// must hold zeros: the kernel adds into it.
extern "C" int illico_row_counts(const void* x, const void* rows, int64_t n_rows,
                                 const void* table, void* cnt, int64_t t_cols,
                                 int v_buckets, int is_log1p, void* stream) {
  using S = CountShape;
  static_assert(kMaxV <= 64 * S::kWarps, "bucket v is bit v / kWarps of 64");
  if (n_rows <= 0 || t_cols <= 0 || v_buckets <= 0) return 0;
  if (v_buckets > kMaxV) return static_cast<int>(cudaErrorInvalidValue);
  const int n_col_blocks = static_cast<int>((t_cols + kCols - 1) / kCols);
  const size_t smem = smem_bytes<S>(v_buckets, false);
  auto kernel = is_log1p ? row_counts_kernel<S, true> : row_counts_kernel<S, false>;
  cudaError_t err;
  const int64_t resident = wave(kernel, S::kThreads, smem, INT64_MAX, err);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Row chunks: whole passes of the wave over the items (kItemsPerCta at
  // most), each chunk at least kMinChunkRows rows.
  int64_t chunks = kItemsPerCta * resident / n_col_blocks;
  const int64_t most = (n_rows + kMinChunkRows - 1) / kMinChunkRows;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  const int64_t rows_per_chunk = (n_rows + chunks - 1) / chunks;
  chunks = (n_rows + rows_per_chunk - 1) / rows_per_chunk;
  const int64_t n_items = chunks * n_col_blocks;
  if (n_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t grid = resident < n_items ? resident : n_items;
  kernel<<<static_cast<unsigned int>(grid), S::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(rows), n_rows,
      static_cast<const float*>(table), static_cast<int32_t*>(cnt), t_cols, n_col_blocks,
      rows_per_chunk, n_items, v_buckets);
  return static_cast<int>(cudaGetLastError());
}

// perm (n_real,) int32, indptr (n_groups + 1,) int64, order (n_groups,)
// int32: K1's inputs.  split (host memory) int32 [n, group[0..n-1],
// parts[0..n-1]]: ops/hist_engine.py:fused_work's split groups, n at most
// 8.  ref_code: the group taken from ref_counts ((v_buckets, t_cols)
// float64, the counting pass's counts), or -1.  tab (and ref, the
// (v_buckets, t_cols) reference counts a, with tie) float64.  fc, main_out
// (n_groups, t_cols) float64, always written; tie only when non-null (then
// ref is required); nz only under nnz_split (then required); tot only when
// non-null.  scratch int32 zeros: the work counter, then for the split
// groups n * ceil(t_cols / 32) tickets and n (v_buckets, t_cols) planes.
extern "C" int illico_hist_contract(const void* x, const void* perm, const void* indptr,
                                    const void* order, const void* split_groups,
                                    const void* table, const void* tab, const void* ref,
                                    const void* ref_counts, void* fc, void* main_out,
                                    void* tie, void* nz, void* tot, void* scratch,
                                    int n_groups, int ref_code, int64_t t_cols,
                                    int v_buckets, int is_log1p, int nnz_split,
                                    void* stream) {
  if (n_groups <= 0 || t_cols <= 0 || v_buckets <= 0) return 0;
  const bool has_tie = tie != nullptr;
  if ((has_tie && ref == nullptr) || (nnz_split && nz == nullptr) || scratch == nullptr ||
      split_groups == nullptr || v_buckets > kMaxV || ref_code >= n_groups ||
      (ref_code >= 0 && ref_counts == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* spec = static_cast<const int32_t*>(split_groups);
  SplitSpec split{};
  split.n = spec[0];
  if (split.n < 0 || split.n > kMaxSplit) return static_cast<int>(cudaErrorInvalidValue);
  for (int s = 0; s < split.n; ++s) {
    split.group[s] = spec[1 + s];
    const int parts = spec[1 + split.n + s];
    if (split.group[s] < 0 || split.group[s] >= n_groups || parts < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    split.first[s + 1] = split.first[s] + parts;
  }
  const int n_col_blocks = static_cast<int>((t_cols + kCols - 1) / kCols);
  const int64_t n_chunks = static_cast<int64_t>(split.first[split.n]) + n_groups;
  const int64_t n_items = n_chunks * n_col_blocks;
  if (n_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  FusedArgs f;
  f.x = static_cast<const float*>(x);
  f.perm = static_cast<const int32_t*>(perm);
  f.indptr = static_cast<const int64_t*>(indptr);
  f.order = static_cast<const int32_t*>(order);
  f.split = split;
  f.ref_code = ref_code;
  f.n_items = n_items;
  f.table = static_cast<const float*>(table);
  f.tab = static_cast<const double*>(tab);
  f.ref = static_cast<const double*>(ref);
  f.ref_counts = static_cast<const double*>(ref_counts);
  f.fc = static_cast<double*>(fc);
  f.main_out = static_cast<double*>(main_out);
  f.tie = static_cast<double*>(tie);
  f.nz = static_cast<double*>(nz);
  f.tot = static_cast<double*>(tot);
  f.next_item = static_cast<unsigned int*>(scratch);
  f.tickets = f.next_item + 1;
  f.planes = reinterpret_cast<int32_t*>(f.tickets + static_cast<int64_t>(split.n) *
                                                        n_col_blocks);
  f.t_cols = t_cols;
  f.n_col_blocks = n_col_blocks;
  f.v_buckets = v_buckets;
  const int flags = 4 * (is_log1p != 0) + 2 * (has_tie ? 1 : 0) + (nnz_split != 0);
  const int tier = tier_of(v_buckets);
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(tier == 0 ? launch_fused_tier<0>(flags, f, st)
                                    : launch_fused_tier<1>(flags, f, st));
}
