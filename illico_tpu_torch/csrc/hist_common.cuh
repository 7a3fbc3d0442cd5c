// Device code shared by the histogram engine's kernels: the bucket rule
// (every counting kernel), K1's row loop (csrc/hist_kernel.cu), the staged
// row loads of the fused pass (csrc/hist_fused.cu) and the OVO tie term of
// the contraction (csrc/hist_contract.cu, csrc/hist_fused.cu).
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
constexpr int kUnroll = 4;  // independent row loads in flight per warp (K1)

// The bucket rule, in two steps: candidate() is k = rint(is_log1p ?
// expm1(x) : x) (round half to even) when 0 <= k < v_buckets, else -1; the
// value lands in bucket k only if table[k] == x (accept()), the reference's
// float compare (so -0.0 lands in bucket 0).  One conversion does the
// rounding: it saturates +-inf and values past the int range (then out of
// range) and turns NaN into 0, whose table compare then fails, so every
// value lands where rint, a float range check and a cast would put it.
// bucket() is both steps for one value (K1's row loop); a caller that
// counts many values passes kN candidates to accept(), the same table check
// with their table loads issued together.  (bucket() keeps its own one-line
// check: written through accept(), K1 ran 11-22% slower on an H100.)
template <bool kLog1p>
__device__ __forceinline__ int candidate(float v, int v_buckets) {
  const int k = __float2int_rn(kLog1p ? expm1f(v) : v);
  return static_cast<unsigned int>(k) < static_cast<unsigned int>(v_buckets) ? k : -1;
}

template <bool kLog1p>
__device__ __forceinline__ int bucket(float v, const float* __restrict__ table,
                                      int v_buckets) {
  const int k = candidate<kLog1p>(v, v_buckets);
  return k >= 0 && __ldg(table + k) == v ? k : -1;
}

// k[i] (a candidate or -1) becomes -1 unless table[k[i]] == v[i].
template <int kN>
__device__ __forceinline__ void accept(int (&k)[kN], const float (&v)[kN],
                                       const float* __restrict__ table) {
  float t[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) t[i] = k[i] >= 0 ? __ldg(table + k[i]) : 0.0f;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if (t[i] != v[i]) k[i] = -1;
  }
}

// One value into a column's shared int32 counts hist_col[v * kCols].  Zeros
// are counted in a register and added once by the caller: bucket 0 is the
// hot address.
template <bool kLog1p>
__device__ __forceinline__ void count_value(
    float v, const float* __restrict__ table, int v_buckets,
    int32_t* hist_col, int32_t& zeros) {
  const int ki = bucket<kLog1p>(v, table, v_buckets);
  if (ki == 0) {
    ++zeros;
  } else if (ki > 0) {
    atomicAdd(hist_col + ki * kCols, 1);
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

// One warp's staged row loads (the fused pass's row loop), in two steps so
// that the index loads can be issued early: load_index() has lane u read
// the row index rows[base + u * stride] for u < n (one load instruction for
// up to 32 indices); load_rows() then has every lane read x[index of lane
// u, col] for each u < n <= kBatch, the index broadcast from lane u.
// The n value loads are independent of each other and of any count, so a
// warp keeps up to kBatch 128-byte row segments in flight where count_rows
// keeps kUnroll chained index -> value pairs.  The values are read through
// L2 only (__ldcg): each is used once, and in L1 they would evict the value
// table.  Every lane of the warp must call load_rows (the broadcast is a
// shuffle); lanes whose column is past the tile load no value.
__device__ __forceinline__ int32_t load_index(const int32_t* __restrict__ rows, int64_t base,
                                              int stride, int n) {
  const int lane = threadIdx.x & 31;
  return lane < n ? __ldg(rows + base + static_cast<int64_t>(lane) * stride) : 0;
}

template <int kBatch>
__device__ __forceinline__ void load_rows(const float* __restrict__ x, int32_t index, int n,
                                          int64_t t_cols, int64_t col, bool col_ok,
                                          float (&v)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int64_t src = __shfl_sync(0xffffffffu, index, u);
    v[u] = (u < n && col_ok) ? __ldcg(x + src * t_cols + col) : 0.0f;
  }
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
