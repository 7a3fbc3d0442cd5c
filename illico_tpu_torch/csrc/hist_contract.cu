// Exact float64 contractions of the grouped value histograms: the
// histogram engine's statistics, read from K1's float32 (G, V, T) output.
//
// Replaces the op-by-op float64 contraction of
// illico_tpu/ops/hist_engine.py:hist_contract (jnp, compiled by XLA on the
// TPU; no Pallas kernel there), whose port ran as plain torch ops over
// group chunks of a float64 copy of the histogram.  Two kernels:
//
//   value_counts_kernel:  c[v, j] = sum_g h[g, v, j]            (OVR only)
//   contract_kernel, one thread per (g, j), walking v:
//     fc[g, j]   = sum_v h * v
//     main[g, j] = sum_v h * tab[v, j]            (U2 or R2; tab from torch)
//     tie[g, j]  = sum_v (h^3 - h) + 3*a*h*(a + h)      (OVO; a = ref row)
//     nz[g, j]   = sum_{v>0} h                   (k under the nnz split)
//     tot[g, j]  = sum_v h                     (OVO's per-column totals)
//   Under the nnz split the v=0 plane is left out of main and tie.
//
// Exactness: h holds integer counts, v and tab integers, so every product
// and sum above is an integer; the statics' narrow tiers prove them below
// 2^53, where any summation order gives the same bits as the plain torch
// version.  Each product and sum rounds on its own (__dmul_rn/__dadd_rn,
// never a fused multiply-add), in the plain version's expression order, so
// a statistic past 2^53 differs from it only by the order of the sum over v.
// A zero count adds +0.0 to a non-negative sum and is skipped: single-cell
// histograms are mostly zeros, so the float64 work follows the nonzeros.
//
// Bound on an H100 SXM (3.35 TB/s): the histogram is read once per kernel
// (8.39 GB at G=2,000, V=512, T=2,048, ~2.5 ms); the (V, T) tables (8 MB
// each) stay in the 50 MB L2 and are read only where h != 0.  Consecutive
// threads take consecutive columns j, so each warp reads one 128-byte
// segment per v; kUnroll independent loads per thread keep enough bytes in
// flight.  The float64 work, a few operations per nonzero count, is far
// below the card's float64 rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_common.cuh"

namespace {

using illico_hist::tie_term;  // shared with csrc/hist_fused.cu

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kMinBlocks = 4;  // contract_kernel: at most 64 registers, 1,024 threads an SM
constexpr int64_t kTargetThreads = 1 << 22;  // value_counts: group slices to fill the card

__global__ void __launch_bounds__(kThreads) value_counts_kernel(
    const float* __restrict__ hist, double* __restrict__ c, int64_t vt,
    int n_groups, int groups_per_slice) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= vt) return;
  const int g0 = blockIdx.y * groups_per_slice;
  const int g1 = min(n_groups, g0 + groups_per_slice);
  const float* p = hist + static_cast<int64_t>(g0) * vt + i;
  double acc = 0.0;
  int g = g0;
  for (; g + kUnroll <= g1; g += kUnroll, p += kUnroll * vt) {
    float h[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) h[u] = __ldg(p + u * vt);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = __dadd_rn(acc, static_cast<double>(h[u]));
  }
  for (; g < g1; ++g, p += vt) acc = __dadd_rn(acc, static_cast<double>(__ldg(p)));
  // Integer partial sums: the atomics' order cannot change the total.
  if (acc != 0.0) atomicAdd(c + i, acc);
}

template <bool kTie, bool kNnzSplit>
__global__ void __launch_bounds__(kThreads, kMinBlocks) contract_kernel(
    const float* __restrict__ hist, const double* __restrict__ tab,
    const double* __restrict__ ref, double* __restrict__ fc,
    double* __restrict__ main_out, double* __restrict__ tie,
    double* __restrict__ nz_out, double* __restrict__ tot,
    int64_t t_cols, int n_groups, int v_buckets) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;  // g*T + j
  if (i >= static_cast<int64_t>(n_groups) * t_cols) return;
  const int64_t g = i / t_cols;
  const int64_t j = i - g * t_cols;
  const float* hp = hist + g * v_buckets * t_cols + j;
  const double* tp = tab + j;
  const double* ap = ref + j;

  double s_fc = 0.0, s_main = 0.0, s_tie = 0.0, s_nz = 0.0;
  const double h0 = static_cast<double>(__ldg(hp));
  if (!kNnzSplit && h0 != 0.0) {  // v = 0 adds nothing to fc
    s_main = __dmul_rn(h0, __ldg(tp));
    if (kTie) s_tie = tie_term(h0, __ldg(ap));
  }
  int v = 1;
  for (; v < v_buckets; v += kUnroll) {
    float h[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h[u] = v + u < v_buckets ? __ldg(hp + static_cast<int64_t>(v + u) * t_cols) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (h[u] != 0.0f) {
        const int64_t off = static_cast<int64_t>(v + u) * t_cols;
        const double hd = static_cast<double>(h[u]);
        s_fc = __dadd_rn(s_fc, __dmul_rn(hd, static_cast<double>(v + u)));
        s_nz = __dadd_rn(s_nz, hd);
        s_main = __dadd_rn(s_main, __dmul_rn(hd, __ldg(tp + off)));
        if (kTie) s_tie = __dadd_rn(s_tie, tie_term(hd, __ldg(ap + off)));
      }
    }
  }
  fc[i] = s_fc;
  main_out[i] = s_main;
  if (kTie) tie[i] = s_tie;
  if (kNnzSplit) nz_out[i] = s_nz;
  if (tot != nullptr) tot[i] = __dadd_rn(s_nz, h0);
}

template <bool kTie, bool kNnzSplit>
cudaError_t launch_contract(const float* hist, const double* tab, const double* ref,
                            double* fc, double* main_out, double* tie, double* nz,
                            double* tot, int64_t t_cols, int n_groups, int v_buckets,
                            cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(n_groups) * t_cols;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  contract_kernel<kTie, kNnzSplit><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      hist, tab, ref, fc, main_out, tie, nz, tot, t_cols, n_groups, v_buckets);
  return cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns the cudaError_t of its
// launch (0 = success).  Pointers are device pointers to contiguous arrays:
// hist (n_groups, v_buckets, t_cols) float32, every other array float64.

// c (v_buckets, t_cols) must hold zeros: the kernel adds into it.
extern "C" int illico_value_counts(const void* hist, void* c, int64_t t_cols,
                                   int n_groups, int v_buckets, void* stream) {
  const int64_t vt = static_cast<int64_t>(v_buckets) * t_cols;
  if (n_groups <= 0 || vt <= 0) return 0;
  const int64_t blocks = (vt + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  int64_t slices = (kTargetThreads + vt - 1) / vt;
  if (slices > n_groups) slices = n_groups;
  if (slices > 65535) slices = 65535;
  const int per_slice = static_cast<int>((n_groups + slices - 1) / slices);
  const unsigned int grid_y = static_cast<unsigned int>((n_groups + per_slice - 1) / per_slice);
  value_counts_kernel<<<dim3(static_cast<unsigned int>(blocks), grid_y), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hist), static_cast<double*>(c), vt, n_groups, per_slice);
  return static_cast<int>(cudaGetLastError());
}

// fc, main_out: (n_groups, t_cols), always written.  tie (with ref, the
// (v_buckets, t_cols) reference row) only when non-null; nz only under
// nnz_split (then required); tot only when non-null.
extern "C" int illico_contract(const void* hist, const void* tab, const void* ref,
                               void* fc, void* main_out, void* tie, void* nz, void* tot,
                               int64_t t_cols, int n_groups, int v_buckets, int nnz_split,
                               void* stream) {
  if (n_groups <= 0 || t_cols <= 0 || v_buckets <= 0) return 0;
  const bool has_tie = tie != nullptr;
  if ((has_tie && ref == nullptr) || (nnz_split && nz == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto h = static_cast<const float*>(hist);
  auto tb = static_cast<const double*>(tab);
  auto rf = static_cast<const double*>(ref);
  auto f = static_cast<double*>(fc);
  auto m = static_cast<double*>(main_out);
  auto t = static_cast<double*>(tie);
  auto z = static_cast<double*>(nz);
  auto o = static_cast<double*>(tot);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (has_tie) {
    err = nnz_split ? launch_contract<true, true>(h, tb, rf, f, m, t, z, o, t_cols, n_groups, v_buckets, s)
                    : launch_contract<true, false>(h, tb, rf, f, m, t, z, o, t_cols, n_groups, v_buckets, s);
  } else {
    err = nnz_split ? launch_contract<false, true>(h, tb, rf, f, m, t, z, o, t_cols, n_groups, v_buckets, s)
                    : launch_contract<false, false>(h, tb, rf, f, m, t, z, o, t_cols, n_groups, v_buckets, s);
  }
  return static_cast<int>(err);
}
