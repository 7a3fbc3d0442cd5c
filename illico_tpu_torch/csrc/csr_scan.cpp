// Host scans of an in-RAM CSR matrix for illico_tpu_torch: the per-row
// index-order check and the dense gather of a column window.
//
// Built into the same shared library as tail.cpp (see
// illico_tpu_torch/native/__init__.py).  Both entry points take indptr and
// indices as int32 or int64 (idx64, ptr64), allocate nothing and split the
// rows over n_threads OpenMP threads; every row is read and written by one
// thread, so the results do not depend on the thread count.
//
// The gather relies on sorted indices within each row: it binary-searches
// [lb, ub) in each row instead of testing every entry, so it must only run on
// rows that illico_csr_check_sorted has passed.  Duplicate (row, column)
// entries are summed in storage order into a zeroed output, in the data's
// own dtype, as scipy's toarray sums them.

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

// Value types of illico_csr_gather_window (keep in sync with
// illico_tpu_torch/native/__init__.py:CSR_GATHER_DTYPES).
enum GatherDtype : int32_t {
  kI8 = 0, kU8 = 1, kI16 = 2, kU16 = 3, kI32 = 4, kI64 = 5, kF32 = 6, kF64 = 7,
};

// a + b in T.  Signed integers wrap as scipy's compiled sum does; the sum
// goes through the unsigned type, where wrapping is defined.
template <class T>
inline T add(T a, T b) {
  if constexpr (std::is_integral_v<T>) {
    using U = std::make_unsigned_t<T>;
    return static_cast<T>(static_cast<U>(static_cast<U>(a) + static_cast<U>(b)));
  } else {
    return a + b;
  }
}

// First row in [0, n_rows) whose indices decrease within the row, or -1.
// Row r spans [indptr[r], indptr[r + 1]), except that the first row starts
// at 0 and the last ends at nnz: a drop is allowed exactly where a row
// begins strictly inside [0, nnz), as in the numpy check this replaces.
template <class I, class P>
int64_t check_sorted(const P* indptr, const I* indices, int64_t n_rows, int64_t nnz,
                     int32_t n_threads) {
  (void)n_threads;  // referenced only from the OpenMP pragma below
  if (n_rows <= 0) {
    for (int64_t k = 1; k < nnz; ++k) {
      if (indices[k] < indices[k - 1]) return 0;
    }
    return -1;
  }
  int64_t first = n_rows;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(n_threads) \
    if (n_threads > 1) reduction(min : first)
#endif
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t s = r == 0 ? 0 : static_cast<int64_t>(indptr[r]);
    int64_t e = r == n_rows - 1 ? nnz : static_cast<int64_t>(indptr[r + 1]);
    s = std::clamp<int64_t>(s, 0, nnz);
    e = std::clamp<int64_t>(e, 0, nnz);
    for (int64_t k = s + 1; k < e; ++k) {
      if (indices[k] < indices[k - 1]) {
        first = std::min(first, r);
        break;
      }
    }
  }
  return first == n_rows ? -1 : first;
}

// out[r, j - lb] += data[k] for the entries k of row r with lb <= j < ub,
// in storage order; out is a zeroed C-order (n_rows, ub - lb) array.
template <class T, class I, class P>
void gather_window(const P* indptr, const I* indices, const T* data, int64_t n_rows,
                   int64_t lb, int64_t ub, T* out, int32_t n_threads) {
  (void)n_threads;  // referenced only from the OpenMP pragma below
  const int64_t w = ub - lb;
  if (w <= 0) return;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(n_threads) \
    if (n_threads > 1)
#endif
  for (int64_t r = 0; r < n_rows; ++r) {
    const I* row = indices + indptr[r];
    const I* end = indices + indptr[r + 1];
    if (end <= row) continue;
    const I* a = std::lower_bound(row, end, static_cast<I>(lb));
    const I* b = std::lower_bound(a, end, static_cast<I>(ub));
    T* dst = out + r * w;
    const T* src = data + (a - indices);
    for (const I* k = a; k < b; ++k, ++src) {
      const int64_t j = static_cast<int64_t>(*k) - lb;
      // Always true on a checked row; keeps the writes inside the window.
      if (j >= 0 && j < w) dst[j] = add(dst[j], *src);
    }
  }
}

template <class I, class P>
int32_t gather_typed(const void* indptr, const void* indices, const void* data,
                     int64_t n_rows, int64_t lb, int64_t ub, void* out, int32_t dtype,
                     int32_t n_threads) {
  const P* p = static_cast<const P*>(indptr);
  const I* i = static_cast<const I*>(indices);
#define ILLICO_GATHER(T)                                                              \
  gather_window<T, I, P>(p, i, static_cast<const T*>(data), n_rows, lb, ub,           \
                         static_cast<T*>(out), n_threads);                            \
  return 0
  switch (dtype) {
    case kI8: ILLICO_GATHER(int8_t);
    case kU8: ILLICO_GATHER(uint8_t);
    case kI16: ILLICO_GATHER(int16_t);
    case kU16: ILLICO_GATHER(uint16_t);
    case kI32: ILLICO_GATHER(int32_t);
    case kI64: ILLICO_GATHER(int64_t);
    case kF32: ILLICO_GATHER(float);
    case kF64: ILLICO_GATHER(double);
    default: return -1;
  }
#undef ILLICO_GATHER
}

}  // namespace

extern "C" {

// First row whose column indices decrease within the row, or -1 when every
// row is sorted (equal neighbours, i.e. duplicates, pass).  nnz is the
// length of indices.
int64_t illico_csr_check_sorted(const void* indptr, const void* indices, int64_t n_rows,
                                int64_t nnz, int32_t idx64, int32_t ptr64,
                                int32_t n_threads) {
  if (idx64) {
    const auto* i = static_cast<const int64_t*>(indices);
    return ptr64 ? check_sorted(static_cast<const int64_t*>(indptr), i, n_rows, nnz, n_threads)
                 : check_sorted(static_cast<const int32_t*>(indptr), i, n_rows, nnz, n_threads);
  }
  const auto* i = static_cast<const int32_t*>(indices);
  return ptr64 ? check_sorted(static_cast<const int64_t*>(indptr), i, n_rows, nnz, n_threads)
               : check_sorted(static_cast<const int32_t*>(indptr), i, n_rows, nnz, n_threads);
}

// Dense window [lb, ub) of a CSR with sorted rows into the zeroed C-order
// (n_rows, ub - lb) array out of the data's dtype (GatherDtype).  Returns 0,
// or -1 for a dtype code this build does not know (out untouched).
int32_t illico_csr_gather_window(const void* indptr, const void* indices, const void* data,
                                 int64_t n_rows, int64_t lb, int64_t ub, void* out,
                                 int32_t dtype_code, int32_t idx64, int32_t ptr64,
                                 int32_t n_threads) {
  if (idx64) {
    return ptr64 ? gather_typed<int64_t, int64_t>(indptr, indices, data, n_rows, lb, ub, out,
                                                  dtype_code, n_threads)
                 : gather_typed<int64_t, int32_t>(indptr, indices, data, n_rows, lb, ub, out,
                                                  dtype_code, n_threads);
  }
  return ptr64 ? gather_typed<int32_t, int64_t>(indptr, indices, data, n_rows, lb, ub, out,
                                                dtype_code, n_threads)
               : gather_typed<int32_t, int32_t>(indptr, indices, data, n_rows, lb, ub, out,
                                                dtype_code, n_threads);
}

}  // extern "C"
