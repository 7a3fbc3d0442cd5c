// Exact float64 contractions of grouped value histograms: the histogram
// engine's statistics, read from S float32 (G, V, T) histograms of one
// shape whose sum is the tile's histogram: under the cell mesh, the one
// path in the package that contracts a histogram, S >= 2, one per cell
// shard, made by K1 on that shard's rows (S = 1 is a lone histogram).
//
// Replaces the op-by-op float64 contraction of
// illico_tpu/ops/hist_engine.py:hist_contract (jnp, compiled by XLA on the
// TPU; no Pallas kernel there) and, under the cell mesh, the sum of the
// shards' histograms that comes before it (illico_tpu/parallel/cells.py's
// psum, a collective on the TPU; in the port a torch add over the whole
// histogram per extra shard).  One kernel, one CTA per (group, 128-column
// block):
//
//   h[v, j]    = sum_s hist_s[g, v, j]          (float32, in registers)
//   fc[g, j]   = sum_v h * v
//   main[g, j] = sum_v h * tab[v, j]            (U2 or R2; tab from torch)
//   tie[g, j]  = sum_v (h^3 - h) + 3*a*h*(a + h)      (OVO; a = ref row)
//   nz[g, j]   = sum_{v>0} h                   (k under the nnz split)
//   tot[g, j]  = sum_v h                     (OVO's per-column totals)
//   Under the nnz split the v=0 plane is left out of main and tie.
//
// The tables' counts come from torch: OVO's reference row of the summed
// histogram, and OVR's value counts c = sum_g h, which the cell mesh takes
// from each shard's rows (csrc/hist_fused.cu:row_counts_kernel) and a lone
// histogram from a torch reduction: nothing here reads the histogram twice.
//
// Exactness: h holds integer counts, each below 2^24 summed over the
// shards (ops/hist_engine.py:HIST_EXACT_MAX_GROUP), so the float32 sum over
// shards is exact in any order and equals the sum of the shards added
// first; v and tab are integers, so every product and sum above is an
// integer, and the statics' narrow tiers prove them below 2^53, where any
// order of the sum over v gives the plain torch version's bits.  The order
// is fixed all the same: warp w sums its buckets ascending, the warps'
// partial sums are added in warp order (warp 0's first, which holds v = 0),
// and each product and sum rounds on its own (__dmul_rn/__dadd_rn, never a
// fused multiply-add) in the plain version's expression order, so a
// statistic past 2^53 differs from the plain version's only by the order
// of the sum over v (rtol 1e-13), and not from run to run.  A zero count
// adds +0.0 to a non-negative sum and is skipped: single-cell histograms
// are mostly zeros, so the float64 work follows the nonzeros.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  Each histogram is read once,
// S x 8.39 GB at G=2,000, V=512, T=2,048 (S x 2.50 ms), and the (G, T)
// float64 outputs written once; the (V, T) tables (8 MB each at V=512) stay
// in the 50 MB L2 and are read only where h != 0.  The float64 work, a few
// operations per nonzero count, is far below the card's float64 rate.
//
// Design (hist_contract_probe.py times each choice on the card, PERF.md
// section 6):
// - A CTA per (group, 128 columns), its 8 warps splitting v: warp w takes
//   v = 1 + w, 1 + w + 8, ... ascending (warp 0 also v = 0).  A lane owns
//   4 consecutive columns: one 16-byte load of a row, 512 bytes a warp.  (A
//   width that is not a multiple of 4 leaves rows off 16-byte boundaries;
//   its wrapper then launches the kVec=false build, 4-byte loads.)
// - kUnroll rows a warp and shard in registers, streamed past L1 and marked
//   evict-first in L2 (__ldcs), so the tables' gathers find L2 holding the
//   tables: an SM holds up to kMinBlocks x kWarps x kUnroll x 512 bytes of
//   one shard in flight.
// - The shards' addresses are a device array, so S stays a runtime value
//   and any number of shards is taken.  A row's loads from every shard are
//   issued before their float32 adds: two shards cost one trip to memory.
// - Each warp's partial sums go to shared memory, where one thread per
//   (sum, column) adds them in warp order and writes the output, one
//   coalesced 1-KB row segment per sum.
// - What bounds it: the stream from memory.  The kernel takes about as
//   long as reading the histograms with no sums at all, at ~90% of the
//   card's rate; torch.sum of the same bytes runs at ~93%.  Prefetching a
//   lone histogram's next rows, or a bulk-copy ring in shared memory
//   (cp.async.bulk, mbarriers), gained 1-5% on one histogram, which no user
//   path contracts (the cell mesh has S >= 2), so neither is here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_common.cuh"

namespace {

using illico_hist::tie_term;  // shared with csrc/hist_fused.cu

// The kernel's shape: warps a CTA (they split v), rows in flight a lane
// and shard per buffer, and the CTAs an SM that __launch_bounds__ must fit
// (it caps the registers).
constexpr int kWarps = 8;
constexpr int kUnroll = 6;
constexpr int kMinBlocks = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kLaneCols = 4;  // one 16-byte load
constexpr int kBlockCols = 32 * kLaneCols;
constexpr int kSums = 4;  // partial sums a lane keeps per column: fc, nz, main, tie
enum { kFc = 0, kNz = 1, kMain = 2, kTie = 3 };

struct Cols {
  float x[kLaneCols];
};

// The lane's 4 columns of row `row` of one histogram (p: the group's first
// row at the lane's first column); columns past the tile, and every column
// when n_ok is 0, read 0 without a load.
template <bool kVec>
__device__ __forceinline__ Cols load_cols(const float* p, int64_t row, int64_t t_cols,
                                          int n_ok) {
  Cols c;
  const float* q = p + row * t_cols;
  if (kVec) {
    float4 f = n_ok > 0 ? __ldcs(reinterpret_cast<const float4*>(q))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    c.x[0] = f.x, c.x[1] = f.y, c.x[2] = f.z, c.x[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < kLaneCols; ++i) c.x[i] = i < n_ok ? __ldcs(q + i) : 0.0f;
  }
  return c;
}

// Shard s's histogram, from the device array of the shards' addresses.
__device__ __forceinline__ const float* shard(const unsigned long long* __restrict__ hists,
                                              int s) {
  return reinterpret_cast<const float*>(__ldg(hists + s));
}

// One nonzero count h of bucket v into the lane's partial sums of one
// column; tp, ap: that column's tab and ref entries of bucket v.
template <bool kTieSum>
__device__ __forceinline__ void add_count(double (&s)[kSums], float h, int v,
                                          const double* tp, const double* ap) {
  if (h != 0.0f) {
    const double hd = static_cast<double>(h);
    s[kFc] = __dadd_rn(s[kFc], __dmul_rn(hd, static_cast<double>(v)));
    s[kNz] = __dadd_rn(s[kNz], hd);
    s[kMain] = __dadd_rn(s[kMain], __dmul_rn(hd, __ldg(tp)));
    if (kTieSum) s[kTie] = __dadd_rn(s[kTie], tie_term(hd, __ldg(ap)));
  }
}

template <bool kTieSum, bool kNnzSplit, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks) contract_kernel(
    const unsigned long long* __restrict__ hists, int n_shards,
    const double* __restrict__ tab, const double* __restrict__ ref,
    double* __restrict__ fc, double* __restrict__ main_out, double* __restrict__ tie,
    double* __restrict__ nz_out, double* __restrict__ tot,
    int64_t t_cols, int v_buckets, int64_t n_col_blocks) {
  __shared__ double part[kSums][kWarps][kBlockCols];
  __shared__ float zero_plane[kBlockCols];
  const int warp = threadIdx.x >> 5;
  const int cb = (threadIdx.x & 31) * kLaneCols;  // the lane's first column in the CTA
  const int64_t g = blockIdx.x / n_col_blocks;
  const int64_t col0 = (blockIdx.x - g * n_col_blocks) * kBlockCols;
  const int64_t j = col0 + cb;  // the lane's first column
  const int64_t left = t_cols - j;
  const int n_ok = left <= 0 ? 0 : (left < kLaneCols ? static_cast<int>(left) : kLaneCols);
  const int64_t base = g * v_buckets * t_cols + j;  // (g, v=0, j) in every histogram
  const float* first = shard(hists, 0) + base;

  double s[kLaneCols][kSums];
#pragma unroll
  for (int c = 0; c < kLaneCols; ++c) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[c][k] = 0.0;
  }

  if (warp == 0) {  // v = 0 adds nothing to fc and nz; its count makes OVO's totals
    Cols h0 = load_cols<kVec>(first, 0, t_cols, n_ok);
    for (int sh = 1; sh < n_shards; ++sh) {
      const Cols o = load_cols<kVec>(shard(hists, sh) + base, 0, t_cols, n_ok);
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) h0.x[c] += o.x[c];
    }
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
      if (!kNnzSplit && h0.x[c] != 0.0f) {
        const double hd = static_cast<double>(h0.x[c]);
        s[c][kMain] = __dmul_rn(hd, __ldg(tab + j + c));
        if (kTieSum) s[c][kTie] = tie_term(hd, __ldg(ref + j + c));
      }
      zero_plane[cb + c] = h0.x[c];
    }
  }

  // The warp's rows v = v0 + u * kWarps, u < kUnroll: shard 0's loads,
  // then every other shard's (issued together, then added), then the sums.
  auto load_rows = [&](Cols (&h)[kUnroll], int v0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kWarps;
      h[u] = load_cols<kVec>(first, v, t_cols, v < v_buckets ? n_ok : 0);
    }
  };
  auto add_shards = [&](Cols (&h)[kUnroll], int v0) {
    for (int sh = 1; sh < n_shards; ++sh) {
      const float* p = shard(hists, sh) + base;
      Cols o[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + u * kWarps;
        o[u] = load_cols<kVec>(p, v, t_cols, v < v_buckets ? n_ok : 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < kLaneCols; ++c) h[u].x[c] += o[u].x[c];
      }
    }
  };
  auto sums = [&](const Cols (&h)[kUnroll], int v0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kWarps;  // a bucket past the table holds zeros
      const int64_t off = static_cast<int64_t>(v) * t_cols + j;
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) {
        add_count<kTieSum>(s[c], h[u].x[c], v, tab + off + c, ref + off + c);
      }
    }
  };

  constexpr int kStep = kWarps * kUnroll;
  int v0 = 1 + warp;
  if (v0 < v_buckets) {
    Cols cur[kUnroll];
    load_rows(cur, v0);
    add_shards(cur, v0);
    for (;; v0 += kStep) {
      sums(cur, v0);
      if (v0 + kStep >= v_buckets) break;
      load_rows(cur, v0 + kStep);
      add_shards(cur, v0 + kStep);
    }
  }

#pragma unroll
  for (int c = 0; c < kLaneCols; ++c) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) part[k][warp][cb + c] = s[c][k];
  }
  __syncthreads();
  // One thread per (sum, column): the warps' partials in warp order.
  for (int i = threadIdx.x; i < kSums * kBlockCols; i += kThreads) {
    const int k = i / kBlockCols;
    const int col = i - k * kBlockCols;
    if (col0 + col >= t_cols || (k == kTie && !kTieSum)) continue;
    double acc = part[k][0][col];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) acc = __dadd_rn(acc, part[k][w][col]);
    const int64_t o = g * t_cols + col0 + col;
    if (k == kFc) {
      fc[o] = acc;
    } else if (k == kMain) {
      main_out[o] = acc;
    } else if (k == kTie) {
      tie[o] = acc;
    } else {
      if (kNnzSplit) nz_out[o] = acc;
      if (tot != nullptr) tot[o] = __dadd_rn(acc, static_cast<double>(zero_plane[col]));
    }
  }
}

template <bool kTieSum, bool kNnzSplit>
cudaError_t launch(bool vec, const unsigned long long* hists, int n_shards, const double* tab,
                   const double* ref, double* fc, double* main_out, double* tie, double* nz,
                   double* tot, int64_t t_cols, int n_groups, int v_buckets,
                   cudaStream_t stream) {
  const int64_t n_col_blocks = (t_cols + kBlockCols - 1) / kBlockCols;
  const int64_t blocks = n_col_blocks * n_groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const unsigned int grid = static_cast<unsigned int>(blocks);
  if (vec) {
    contract_kernel<kTieSum, kNnzSplit, true><<<grid, kThreads, 0, stream>>>(
        hists, n_shards, tab, ref, fc, main_out, tie, nz, tot, t_cols, v_buckets,
        n_col_blocks);
  } else {
    contract_kernel<kTieSum, kNnzSplit, false><<<grid, kThreads, 0, stream>>>(
        hists, n_shards, tab, ref, fc, main_out, tie, nz, tot, t_cols, v_buckets,
        n_col_blocks);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 =
// success).  Pointers are device pointers to contiguous arrays: hists, an
// array of n_shards >= 1 addresses (64-bit), each of an (n_groups, v_buckets, t_cols)
// float32 histogram; every other array float64.  vec != 0 (16-byte loads)
// requires t_cols % 4 == 0 and every histogram 16-byte aligned.
// fc, main_out: (n_groups, t_cols), always written.  tie (with ref, the
// (v_buckets, t_cols) reference row) only when non-null; nz only under
// nnz_split (then required); tot only when non-null.
extern "C" int illico_contract(const void* hists, int n_shards, const void* tab,
                               const void* ref, void* fc, void* main_out, void* tie, void* nz,
                               void* tot, int64_t t_cols, int n_groups, int v_buckets,
                               int nnz_split, int vec, void* stream) {
  if (n_groups <= 0 || t_cols <= 0 || v_buckets <= 0) return 0;
  const bool has_tie = tie != nullptr;
  if (n_shards < 1 || hists == nullptr || (has_tie && ref == nullptr) ||
      (nnz_split && nz == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto h = static_cast<const unsigned long long*>(hists);
  auto tb = static_cast<const double*>(tab);
  auto rf = static_cast<const double*>(ref);
  auto f = static_cast<double*>(fc);
  auto m = static_cast<double*>(main_out);
  auto t = static_cast<double*>(tie);
  auto z = static_cast<double*>(nz);
  auto o = static_cast<double*>(tot);
  auto s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  cudaError_t err;
  if (has_tie) {
    err = nnz_split
        ? launch<true, true>(v, h, n_shards, tb, rf, f, m, t, z, o, t_cols, n_groups, v_buckets, s)
        : launch<true, false>(v, h, n_shards, tb, rf, f, m, t, z, o, t_cols, n_groups, v_buckets, s);
  } else {
    err = nnz_split
        ? launch<false, true>(v, h, n_shards, tb, rf, f, m, t, z, o, t_cols, n_groups, v_buckets, s)
        : launch<false, false>(v, h, n_shards, tb, rf, f, m, t, z, o, t_cols, n_groups, v_buckets, s);
  }
  return static_cast<int>(err);
}
