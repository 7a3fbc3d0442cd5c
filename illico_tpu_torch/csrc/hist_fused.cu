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
//   grouped_hist_contract_kernel: K1's grid, row loop and shared
//     hist[V][32] (csrc/hist_kernel.cu), then an epilogue that contracts
//     the CTA's group over v for its 32 columns, with tab and a from torch:
//       fc[g, j]   = sum_v h * v
//       main[g, j] = sum_v h * tab[v, j]                   (U2 or R2)
//       tie[g, j]  = sum_v (h^3 - h) + 3*a*h*(a + h)       (OVO)
//       nz[g, j]   = sum_{v>0} h                           (k, nnz split)
//       tot[g, j]  = sum_v h                               (OVO totals)
//     Under the nnz split the v=0 plane is left out of main and tie.
//     These are csrc/hist_contract.cu's contract_kernel sums, with the
//     bucket rule, the row loop and the tie term from hist_common.cuh.
//
// Why: K1 writes the histogram (8.39 GB a tile at G=2,000, V=512,
// T=2,048) and the contraction reads it back once (OVO) or twice (OVR);
// both exist only to carry each CTA's shared counts to the next kernel.
// Here each CTA contracts its own counts where they are, so a tile costs
// one read of its rows for the counting pass (the reference's ~10%, or
// every row in OVR) and one for the grouped pass, plus the (G, T) float64
// outputs: about 2.9 GB (OVO) or 5.0 GB (OVR) on that tile, against ~19 GB.
//
// Exactness: every count is an integer, tab and v integers, so every
// product and sum is an integer; the statics' narrow tiers prove the
// statistics below 2^53, where any order of the sum over v gives the same
// bits.  The epilogue spreads v over the CTA's warps as K1's write loop
// does (warp w takes v = w, w + 8, ...: the nonzero counts, mostly small v,
// spread evenly), each warp walks its v in ascending order, and warp 0
// adds the partial sums in warp order; each product and sum rounds on its
// own (__dmul_rn/__dadd_rn).  Past 2^53 a sum may differ from the plain
// version's in its last bits, as the contraction kernels' may.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  The grouped pass reads each
// real row once (n_real * T * 4 bytes) and writes the (G, T) float64
// outputs (3-5 of them); tab and a (V * T * 8 bytes each) stay in the
// 50 MB L2 and are read only where h != 0.  The float64 work, a dozen
// operations per nonzero count, is far below the card's float64 rate.
// Shared memory is K1's (64 KB at V=512, three CTAs an SM); the warps'
// partial sums reuse it after the counts are read.  row_counts_kernel
// splits its rows into chunks so its grid fills the card whatever the
// row count, and adds each CTA's nonzero counts with int32 atomics (the
// order of integer atomics cannot change a total).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_common.cuh"

namespace {

using illico_hist::kCols;
using illico_hist::kThreads;
using illico_hist::kWarps;

constexpr int kParts = 4;  // partial sums a warp hands to warp 0: fc, main, tie, nz
constexpr int kMinBlocks = 3;  // three CTAs an SM at V=512, as K1
constexpr int64_t kMinChunkRows = 1024;  // rows per row_counts CTA, at least
constexpr int kWaves = 2;  // row_counts: CTAs for about two full waves

template <bool kLog1p>
__global__ void __launch_bounds__(kThreads) row_counts_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ rows, int64_t n_rows,
    const float* __restrict__ table, int32_t* __restrict__ cnt, int64_t t_cols,
    int n_col_blocks, int64_t rows_per_chunk, int v_buckets) {
  extern __shared__ int32_t hist[];  // [v_buckets][kCols]
  const int64_t chunk = blockIdx.x / n_col_blocks;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t col = static_cast<int64_t>(blockIdx.x % n_col_blocks) * kCols + lane;
  const bool col_ok = col < t_cols;

  for (int i = threadIdx.x; i < v_buckets * kCols; i += kThreads) hist[i] = 0;
  __syncthreads();

  int32_t* hist_col = hist + lane;
  int32_t zeros = 0;
  if (col_ok) {
    const int64_t begin = chunk * rows_per_chunk;
    const int64_t end = begin + rows_per_chunk < n_rows ? begin + rows_per_chunk : n_rows;
    zeros = illico_hist::count_rows<kLog1p>(x, rows, begin + warp, end, t_cols, col,
                                            table, v_buckets, hist_col);
  }
  if (zeros) atomicAdd(hist_col, zeros);
  __syncthreads();

  if (col_ok) {
    int32_t* dst = cnt + col;
    for (int v = warp; v < v_buckets; v += kWarps) {
      const int32_t c = hist[v * kCols + lane];
      if (c) atomicAdd(dst + static_cast<int64_t>(v) * t_cols, c);
    }
  }
}

template <bool kLog1p, bool kTie, bool kNnzSplit>
__global__ void __launch_bounds__(kThreads, kMinBlocks) grouped_hist_contract_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ perm,
    const int64_t* __restrict__ indptr, const int32_t* __restrict__ order,
    const float* __restrict__ table, const double* __restrict__ tab,
    const double* __restrict__ ref, double* __restrict__ fc,
    double* __restrict__ main_out, double* __restrict__ tie,
    double* __restrict__ nz_out, double* __restrict__ tot, int64_t t_cols,
    int n_col_blocks, int v_buckets) {
  extern __shared__ int32_t hist[];  // [v_buckets][kCols], then the partials
  const int g = order[blockIdx.x / n_col_blocks];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t col = static_cast<int64_t>(blockIdx.x % n_col_blocks) * kCols + lane;
  const bool col_ok = col < t_cols;

  for (int i = threadIdx.x; i < v_buckets * kCols; i += kThreads) hist[i] = 0;
  __syncthreads();

  int32_t* hist_col = hist + lane;
  int32_t zeros = 0;
  if (col_ok) {
    zeros = illico_hist::count_rows<kLog1p>(x, perm, indptr[g] + warp, indptr[g + 1],
                                            t_cols, col, table, v_buckets, hist_col);
  }
  if (zeros) atomicAdd(hist_col, zeros);
  __syncthreads();

  // Epilogue: warp w walks v = w, w + kWarps, ... of its lane's column.
  double s_fc = 0.0, s_main = 0.0, s_tie = 0.0, s_nz = 0.0, h0 = 0.0;
  if (col_ok) {
    for (int v = warp; v < v_buckets; v += kWarps) {
      const int32_t c = hist[v * kCols + lane];
      if (c == 0) continue;  // adds +0.0 to a non-negative sum
      const double hd = static_cast<double>(c);
      const int64_t off = static_cast<int64_t>(v) * t_cols + col;
      if (v == 0) {  // warp 0 only; v = 0 adds nothing to fc or nz
        h0 = hd;
        if (!kNnzSplit) {
          s_main = __dmul_rn(hd, __ldg(tab + off));
          if (kTie) s_tie = illico_hist::tie_term(hd, __ldg(ref + off));
        }
        continue;
      }
      s_fc = __dadd_rn(s_fc, __dmul_rn(hd, static_cast<double>(v)));
      s_nz = __dadd_rn(s_nz, hd);
      s_main = __dadd_rn(s_main, __dmul_rn(hd, __ldg(tab + off)));
      if (kTie) s_tie = __dadd_rn(s_tie, illico_hist::tie_term(hd, __ldg(ref + off)));
    }
  }
  __syncthreads();  // every warp has read the counts: their space takes the partials

  double* part = reinterpret_cast<double*>(hist);  // [kParts][kWarps][kCols]
  part[(0 * kWarps + warp) * kCols + lane] = s_fc;
  part[(1 * kWarps + warp) * kCols + lane] = s_main;
  part[(2 * kWarps + warp) * kCols + lane] = s_tie;
  part[(3 * kWarps + warp) * kCols + lane] = s_nz;
  __syncthreads();

  if (warp == 0 && col_ok) {
    for (int w = 1; w < kWarps; ++w) {
      s_fc = __dadd_rn(s_fc, part[(0 * kWarps + w) * kCols + lane]);
      s_main = __dadd_rn(s_main, part[(1 * kWarps + w) * kCols + lane]);
      s_tie = __dadd_rn(s_tie, part[(2 * kWarps + w) * kCols + lane]);
      s_nz = __dadd_rn(s_nz, part[(3 * kWarps + w) * kCols + lane]);
    }
    const int64_t i = static_cast<int64_t>(g) * t_cols + col;
    fc[i] = s_fc;
    main_out[i] = s_main;
    if (kTie) tie[i] = s_tie;
    if (kNnzSplit) nz_out[i] = s_nz;
    if (tot != nullptr) tot[i] = __dadd_rn(s_nz, h0);
  }
}

size_t fused_smem(int v_buckets) {
  const size_t counts = static_cast<size_t>(v_buckets) * kCols * sizeof(int32_t);
  const size_t parts = static_cast<size_t>(kParts) * kWarps * kCols * sizeof(double);
  return counts > parts ? counts : parts;
}

template <bool kLog1p, bool kTie, bool kNnzSplit>
cudaError_t launch_fused(const float* x, const int32_t* perm, const int64_t* indptr,
                         const int32_t* order, const float* table, const double* tab,
                         const double* ref, double* fc, double* main_out, double* tie,
                         double* nz, double* tot, int64_t t_cols, int n_groups,
                         int v_buckets, cudaStream_t stream) {
  const int n_col_blocks = static_cast<int>((t_cols + kCols - 1) / kCols);
  const int64_t n_blocks = static_cast<int64_t>(n_groups) * n_col_blocks;
  if (n_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = fused_smem(v_buckets);
  auto kernel = grouped_hist_contract_kernel<kLog1p, kTie, kNnzSplit>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned int>(n_blocks), kThreads, smem, stream>>>(
      x, perm, indptr, order, table, tab, ref, fc, main_out, tie, nz, tot, t_cols,
      n_col_blocks, v_buckets);
  return cudaGetLastError();
}

template <bool kLog1p>
cudaError_t launch_fused_tie(bool has_tie, bool nnz_split, const float* x,
                             const int32_t* perm, const int64_t* indptr,
                             const int32_t* order, const float* table, const double* tab,
                             const double* ref, double* fc, double* main_out, double* tie,
                             double* nz, double* tot, int64_t t_cols, int n_groups,
                             int v_buckets, cudaStream_t s) {
  if (has_tie) {
    return nnz_split
        ? launch_fused<kLog1p, true, true>(x, perm, indptr, order, table, tab, ref, fc,
                                           main_out, tie, nz, tot, t_cols, n_groups,
                                           v_buckets, s)
        : launch_fused<kLog1p, true, false>(x, perm, indptr, order, table, tab, ref, fc,
                                            main_out, tie, nz, tot, t_cols, n_groups,
                                            v_buckets, s);
  }
  return nnz_split
      ? launch_fused<kLog1p, false, true>(x, perm, indptr, order, table, tab, ref, fc,
                                          main_out, tie, nz, tot, t_cols, n_groups,
                                          v_buckets, s)
      : launch_fused<kLog1p, false, false>(x, perm, indptr, order, table, tab, ref, fc,
                                           main_out, tie, nz, tot, t_cols, n_groups,
                                           v_buckets, s);
}

}  // namespace

// Each entry point launches on `stream` and returns the cudaError_t of its
// launch (0 = success).  Pointers are device pointers to contiguous arrays:
// x (n_cells, t_cols) float32 row-major, table (v_buckets,) float32.

// rows (n_rows,) int32 row indices into x; cnt (v_buckets, t_cols) int32
// must hold zeros: the kernel adds into it.
extern "C" int illico_row_counts(const void* x, const void* rows, int64_t n_rows,
                                 const void* table, void* cnt, int64_t t_cols,
                                 int v_buckets, int is_log1p, void* stream) {
  if (n_rows <= 0 || t_cols <= 0 || v_buckets <= 0) return 0;
  const int n_col_blocks = static_cast<int>((t_cols + kCols - 1) / kCols);
  const size_t smem = static_cast<size_t>(v_buckets) * kCols * sizeof(int32_t);
  auto kernel = is_log1p ? row_counts_kernel<true> : row_counts_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // Row chunks: about kWaves full waves of CTAs over the column blocks,
  // each chunk at least kMinChunkRows rows.
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  int64_t chunks = kWaves * resident / n_col_blocks;
  const int64_t most = (n_rows + kMinChunkRows - 1) / kMinChunkRows;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  const int64_t rows_per_chunk = (n_rows + chunks - 1) / chunks;
  chunks = (n_rows + rows_per_chunk - 1) / rows_per_chunk;
  const int64_t n_blocks = chunks * n_col_blocks;
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned int>(n_blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(rows), n_rows,
      static_cast<const float*>(table), static_cast<int32_t*>(cnt), t_cols, n_col_blocks,
      rows_per_chunk, v_buckets);
  return static_cast<int>(cudaGetLastError());
}

// perm (n_real,) int32, indptr (n_groups + 1,) int64, order (n_groups,)
// int32: K1's inputs.  tab (and ref, the (v_buckets, t_cols) reference
// counts, with tie) float64.  fc, main_out (n_groups, t_cols) float64,
// always written; tie only when non-null (then ref is required); nz only
// under nnz_split (then required); tot only when non-null.
extern "C" int illico_hist_contract(const void* x, const void* perm, const void* indptr,
                                    const void* order, const void* table, const void* tab,
                                    const void* ref, void* fc, void* main_out, void* tie,
                                    void* nz, void* tot, int64_t t_cols, int n_groups,
                                    int v_buckets, int is_log1p, int nnz_split,
                                    void* stream) {
  if (n_groups <= 0 || t_cols <= 0 || v_buckets <= 0) return 0;
  const bool has_tie = tie != nullptr;
  if ((has_tie && ref == nullptr) || (nnz_split && nz == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto launch = is_log1p ? launch_fused_tie<true> : launch_fused_tie<false>;
  return static_cast<int>(launch(
      has_tie, nnz_split != 0, static_cast<const float*>(x),
      static_cast<const int32_t*>(perm), static_cast<const int64_t*>(indptr),
      static_cast<const int32_t*>(order), static_cast<const float*>(table),
      static_cast<const double*>(tab), static_cast<const double*>(ref),
      static_cast<double*>(fc), static_cast<double*>(main_out), static_cast<double*>(tie),
      static_cast<double*>(nz), static_cast<double*>(tot), t_cols, n_groups, v_buckets,
      static_cast<cudaStream_t>(stream)));
}
