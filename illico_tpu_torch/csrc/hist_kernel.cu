// Grouped value histograms of a gene tile: the histogram engine's one kernel.
//
// Replaces the Pallas kernel illico_tpu/ops/hist_engine.py:_hist_kernel
// (launched by grouped_histograms through hist_pass).  It computes
//
//   out[g, v, j] = #{ rows r of group g : x[r, j] == table[v] }
//
// for an (n_cells, T) float32 tile in ORIGINAL row order: the kernel reads
// x[perm[k], j] for the group's rows k in indptr[g]:indptr[g+1], so the
// TPU's padded, group-contiguous copy of the tile is never built.  Values
// that match no table entry (counts >= V, non-integers, negatives, NaN,
// +-inf) count nowhere; the contraction flags their columns from the totals.
//
// Bucket: instead of V compares, k = rint(is_log1p ? expm1(x) : x) is
// range-checked in float (NaN and inf never reach the integer cast) and
// accepted only if table[k] == x, the reference's float compare (so -0.0
// lands in bucket 0, like the Pallas kernel's `==`).
//
// Layout: one CTA per (group, 32-column block), both flattened onto
// gridDim.x (gridDim.y stops at 65,535); the host orders groups largest
// first so the long CTAs of a big control group start early instead of
// forming the tail.  Lane = column, so each row read is one coalesced
// 128-byte segment; warps stride over the group's rows.  Counts live in a
// shared int32 hist[V][32] (16 KB at V=128, 64 KB at V=512: dynamic shared
// memory past 48 KB).  Lane j only ever touches column j, so a warp's 32
// atomics hit 32 distinct banks.  Zeros (~90% of single-cell counts) are
// counted in a register and added once per thread, which takes the hot
// bucket-0 address out of the atomic traffic.  Every (g, v, j) is written
// exactly once as a float (exact: groups stay below 2^24 cells), so the
// output needs no zero fill and no cross-CTA atomics.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel must read n_cells*T*4 bytes
// and write G*V*T*4 bytes.  At 300k cells x 2048 genes x 2000 groups x
// V=128 that is 2.46 GB + 2.10 GB, about 1.4 ms.  The work per element is a
// handful of float ops, far below the compute roofline.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

template <bool kLog1p>
__device__ __forceinline__ void count_value(
    float v, const float* __restrict__ table, int v_buckets,
    int32_t* hist_col, int32_t& zeros) {
  float k = rintf(kLog1p ? expm1f(v) : v);
  if (k >= 0.0f && k < static_cast<float>(v_buckets)) {
    int ki = static_cast<int>(k);
    if (__ldg(table + ki) == v) {
      if (ki == 0) {
        ++zeros;
      } else {
        atomicAdd(hist_col + ki * kCols, 1);
      }
    }
  }
}

template <bool kLog1p>
__global__ void __launch_bounds__(kThreads) grouped_hist_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ perm,
    const int64_t* __restrict__ indptr, const int32_t* __restrict__ order,
    const float* __restrict__ table, float* __restrict__ out,
    int64_t t_cols, int n_col_blocks, int v_buckets) {
  extern __shared__ int32_t hist[];  // [v_buckets][kCols]
  const int g = order[blockIdx.x / n_col_blocks];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t col =
      static_cast<int64_t>(blockIdx.x % n_col_blocks) * kCols + lane;
  const bool col_ok = col < t_cols;

  for (int i = threadIdx.x; i < v_buckets * kCols; i += kThreads) hist[i] = 0;
  __syncthreads();

  int32_t zeros = 0;
  int32_t* hist_col = hist + lane;
  if (col_ok) {
    const int64_t end = indptr[g + 1];
    int64_t r = indptr[g] + warp;
    // kUnroll independent row loads in flight per warp.
    for (; r + (kUnroll - 1) * kWarps < end; r += kUnroll * kWarps) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t src = __ldg(perm + r + u * kWarps);
        v[u] = __ldg(x + src * t_cols + col);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        count_value<kLog1p>(v[u], table, v_buckets, hist_col, zeros);
      }
    }
    for (; r < end; r += kWarps) {
      const int64_t src = __ldg(perm + r);
      count_value<kLog1p>(__ldg(x + src * t_cols + col), table, v_buckets,
                          hist_col, zeros);
    }
  }
  if (zeros) atomicAdd(hist_col, zeros);
  __syncthreads();

  if (col_ok) {
    float* dst = out + static_cast<int64_t>(g) * v_buckets * t_cols + col;
    for (int v = warp; v < v_buckets; v += kWarps) {
      dst[static_cast<int64_t>(v) * t_cols] =
          static_cast<float>(hist[v * kCols + lane]);
    }
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// Pointers are device pointers: x (n_cells, t_cols) float32 row-major,
// perm (n_real,) int32, indptr (n_groups + 1,) int64, order (n_groups,)
// int32, table (v_buckets,) float32, out (n_groups, v_buckets, t_cols)
// float32.
extern "C" int illico_hist_pass(
    const void* x, const void* perm, const void* indptr, const void* order,
    const void* table, void* out, int64_t t_cols, int n_groups,
    int v_buckets, int is_log1p, void* stream) {
  const int n_col_blocks = static_cast<int>((t_cols + kCols - 1) / kCols);
  const int64_t n_blocks = static_cast<int64_t>(n_groups) * n_col_blocks;
  if (n_groups <= 0 || t_cols <= 0) return 0;
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(v_buckets) * kCols * sizeof(int32_t);
  auto kernel = is_log1p ? grouped_hist_kernel<true> : grouped_hist_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(n_blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(perm),
      static_cast<const int64_t*>(indptr), static_cast<const int32_t*>(order),
      static_cast<const float*>(table), static_cast<float*>(out), t_cols,
      n_col_blocks, v_buckets);
  return static_cast<int>(cudaGetLastError());
}
