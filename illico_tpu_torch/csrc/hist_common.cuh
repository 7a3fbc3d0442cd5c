// Device code shared by the histogram engine's kernels: K1's bucket rule
// and row loop (csrc/hist_kernel.cu, csrc/hist_fused.cu) and the OVO tie
// term of the contraction (csrc/hist_contract.cu, csrc/hist_fused.cu).
// Every kernel that counts or contracts includes this one copy, so the
// kernels cannot drift apart; utils/cuda_build.py hashes it into each
// library's build key.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace illico_hist {

constexpr int kCols = 32;  // columns per CTA: lane = column
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // independent row loads in flight per warp

// One value into a column's shared int32 counts hist_col[v * kCols].
// k = rint(is_log1p ? expm1(x) : x) is range-checked in float (NaN and inf
// never reach the integer cast) and accepted only if table[k] == x, the
// reference's float compare (so -0.0 lands in bucket 0).  Zeros are counted
// in a register and added once by the caller: bucket 0 is the hot address.
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

// The values x[rows[r], col] for r = first, first + kWarps, ... < end into
// hist_col: each warp of a CTA walks its own rows (first = begin + warp), a
// lane reads its own column, so each row read is one coalesced 128-byte
// segment.  Returns the zeros seen, for the caller to add into bucket 0.
template <bool kLog1p>
__device__ __forceinline__ int32_t count_rows(
    const float* __restrict__ x, const int32_t* __restrict__ rows, int64_t first,
    int64_t end, int64_t t_cols, int64_t col, const float* __restrict__ table,
    int v_buckets, int32_t* hist_col) {
  int32_t zeros = 0;
  int64_t r = first;
  for (; r + (kUnroll - 1) * kWarps < end; r += kUnroll * kWarps) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t src = __ldg(rows + r + u * kWarps);
      v[u] = __ldg(x + src * t_cols + col);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      count_value<kLog1p>(v[u], table, v_buckets, hist_col, zeros);
    }
  }
  for (; r < end; r += kWarps) {
    const int64_t src = __ldg(rows + r);
    count_value<kLog1p>(__ldg(x + src * t_cols + col), table, v_buckets, hist_col, zeros);
  }
  return zeros;
}

// (h*h*h - h) + 3.0*a*h*(a + h), the OVO tie term of one bucket, as the
// plain version evaluates it: each product and sum rounds on its own
// (never a fused multiply-add), in the plain version's expression order.
__device__ __forceinline__ double tie_term(double h, double a) {
  const double cube = __dsub_rn(__dmul_rn(__dmul_rn(h, h), h), h);
  const double cross = __dmul_rn(__dmul_rn(__dmul_rn(3.0, a), h), __dadd_rn(a, h));
  return __dadd_rn(cube, cross);
}

}  // namespace illico_hist
