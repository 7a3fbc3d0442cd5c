// Native statistical tail of illico_tpu_torch: fused p-value computation.
//
// Host-side counterpart of the device engines: turns exact rank/tie
// summaries into asymptotic Mann-Whitney p-values in one cache-friendly
// pass.  The p-value tail is precision-critical (1e-12 contract against
// scipy), so the formula order matches the float64 numpy implementation in
// illico_tpu_torch/stats.py exactly and erfc comes from libm.  Compiled
// with -O2 and *no* fast-math (see illico_tpu_torch/native/__init__.py).
//
// Layout: row-major (n_groups, n_cols) arrays; per-group scalars for the
// reference/target sample sizes (OVR: n_ref = n_total - n_g; OVO: constant).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {
constexpr double kSqrt2 = 1.4142135623730951;

enum Alternative : int32_t { kTwoSided = 0, kGreater = 1, kLess = 2 };
}  // namespace

extern "C" {

// 1 when this library was compiled with OpenMP (the n_threads arguments
// take effect), else 0.
int32_t illico_openmp(void) {
#ifdef _OPENMP
  return 1;
#else
  return 0;
#endif
}

// p[g, j] from U[g, j], tie[g, j], with per-group n_ref/n_tgt.
// n[g] = n_ref[g] + n_tgt[g] is formed as in the numpy implementation, so
// both associate the arithmetic alike.
void illico_pvalue_tail(
    const double* U,
    const double* tie_sum,
    const double* n_ref,
    const double* n_tgt,
    int64_t n_groups,
    int64_t n_cols,
    int32_t alternative,
    int32_t use_continuity,
    int32_t tie_correct,
    double* p_out,
    int32_t n_threads  // <=1: serial
) {
  (void)n_threads;  // referenced only from the OpenMP pragma below
  const double contin = use_continuity ? 0.5 : 0.0;
  // Rows are independent: bit-exact for any thread count (see
  // illico_consume_tile).
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(n_threads) \
    if (n_threads > 1)
#endif
  for (int64_t g = 0; g < n_groups; ++g) {
    const double nr = n_ref[g];
    const double nt = n_tgt[g];
    const double n = nr + nt;
    const double mu = nr * nt / 2.0;
    const double tie_denom = n * (n - 1.0) * (n + 1.0);
    const double* Ug = U + g * n_cols;
    const double* tg = tie_sum + g * n_cols;
    double* pg = p_out + g * n_cols;
    for (int64_t j = 0; j < n_cols; ++j) {
      const double tie = tie_correct ? tg[j] : 0.0;
      const double tie_corr = 1.0 - tie / tie_denom;
      if (!(tie_corr > 1.0e-9)) {  // degenerate: all values tied
        pg[j] = 1.0;
        continue;
      }
      const double sigma = std::sqrt(nr * nt * (n + 1.0) / 12.0 * tie_corr);
      double u = Ug[j];
      double p;
      if (alternative == kTwoSided) {
        const double u2 = nr * nt - u;
        if (u2 < u) u = u2;
        const double delta = u - mu;
        const double sign = (delta > 0.0) - (delta < 0.0);
        const double z = (std::fabs(delta) + sign * contin) / sigma;
        p = std::erfc(z / kSqrt2);
      } else if (alternative == kGreater) {
        const double z = (u - mu - contin) / sigma;
        p = 0.5 * std::erfc(z / kSqrt2);
      } else {
        const double z = (u - mu + contin) / sigma;
        p = 0.5 * std::erfc(-z / kSqrt2);
      }
      pg[j] = p;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused tile consumer: packed device buffer -> final (p, U, fc) triples.
// A second entry point (illico_consume_tile_ksplit, below) serves the
// nnz-split OVO wire, which replaces the (G, T) U2/tie_seg arrays with
// per-(group, column) nonzero counts plus narrow residuals and a small
// per-column exception buffer (see illico_tpu_torch/ops/wire.py,
// NNZ_SPLIT_SLOTS block).
//
// One pass over a tile's statistics, writing straight into the caller's
// (n_groups, n_genes, 3) result buffer.  Replaces ~8 numpy passes (dtype
// casts, tie broadcast-add, contiguity copies, p tail, fold change): the
// consume tail runs on the thread that drives the device, between result
// copies, so its CPU time is wall-clock.
//
// Array encodings (see illico_tpu_torch/ops/wire.py pack_device_outputs):
//   dtype 0: float32      dtype 1: int32      dtype 4: uint16
//   dtype 2: float64 packed as hi/lo uint32 word blocks (value =
//            hi * 2^32 + lo; exact for the non-negative integer
//            statistics involved)
//   dtype 5: float64 < 2^48 packed as a uint32 lo block followed by a
//            uint16 hi block (6 bytes per value)
//   dtype 6: uint32 < 2^24 packed as a uint16 lo block followed by a
//            uint8 hi block (3 bytes per value)
//   dtype 7: plain uint32
//   dtype 8: float64 < 2^40 packed as a uint32 lo block followed by a
//            uint8 hi block (5 bytes per value)
//   dtype 9: float64 of ANY magnitude/sign packed as three uint32 word
//            blocks (mantissa lo, mantissa hi, biased exponent with the
//            sign in bit 31): value = sign * (hi*2^32 + lo) * 2^(e-53),
//            e = (exp & 0x7fffffff) - 2048.  Bit-faithful ("f96" tier:
//            tie sums past 2^63, non-integer csort fc sums)
//   dtype 3: plain float64

namespace {

inline double decode(const void* p, int32_t dtype, int64_t idx, int64_t n) {
  switch (dtype) {
    case 0:
      return static_cast<double>(static_cast<const float*>(p)[idx]);
    case 1:
      return static_cast<double>(static_cast<const int32_t*>(p)[idx]);
    case 2: {
      const uint32_t* q = static_cast<const uint32_t*>(p);
      return static_cast<double>(q[idx]) * 4294967296.0 +
             static_cast<double>(q[n + idx]);
    }
    case 4:
      return static_cast<double>(static_cast<const uint16_t*>(p)[idx]);
    case 5: {
      const uint32_t* lo = static_cast<const uint32_t*>(p);
      const uint16_t* hi = reinterpret_cast<const uint16_t*>(lo + n);
      return static_cast<double>(hi[idx]) * 4294967296.0 +
             static_cast<double>(lo[idx]);
    }
    case 6: {
      const uint16_t* lo = static_cast<const uint16_t*>(p);
      const uint8_t* hi = reinterpret_cast<const uint8_t*>(lo + n);
      return static_cast<double>((static_cast<uint32_t>(hi[idx]) << 16) |
                                 lo[idx]);
    }
    case 7:
      return static_cast<double>(static_cast<const uint32_t*>(p)[idx]);
    case 10:
      return static_cast<double>(static_cast<const uint8_t*>(p)[idx]);
    case 8: {
      const uint32_t* lo = static_cast<const uint32_t*>(p);
      const uint8_t* hi = reinterpret_cast<const uint8_t*>(lo + n);
      return static_cast<double>(hi[idx]) * 4294967296.0 +
             static_cast<double>(lo[idx]);
    }
    case 9: {
      const uint32_t* lo = static_cast<const uint32_t*>(p);
      const uint32_t* hi = lo + n;
      const uint32_t* ew = hi + n;
      const double m = static_cast<double>(hi[idx]) * 4294967296.0 +
                       static_cast<double>(lo[idx]);
      const int e =
          static_cast<int>(ew[idx] & 0x7fffffffu) - 2048 - 53;
      const double v = std::ldexp(m, e);
      return (ew[idx] >> 31) ? -v : v;
    }
    default:
      return static_cast<const double*>(p)[idx];
  }
}

inline double pval(double u, double tie, double nr, double nt, double mu,
                   double tie_denom, double contin, int32_t alternative) {
  const double tie_corr = 1.0 - tie / tie_denom;
  if (!(tie_corr > 1.0e-9)) return 1.0;  // degenerate: all values tied
  const double sigma = std::sqrt(nr * nt * (nr + nt + 1.0) / 12.0 * tie_corr);
  if (alternative == kTwoSided) {
    const double u2 = nr * nt - u;
    if (u2 < u) u = u2;
    const double delta = u - mu;
    const double sign = (delta > 0.0) - (delta < 0.0);
    const double z = (std::fabs(delta) + sign * contin) / sigma;
    return std::erfc(z / kSqrt2);
  } else if (alternative == kGreater) {
    const double z = (u - mu - contin) / sigma;
    return 0.5 * std::erfc(z / kSqrt2);
  }
  const double z = (u - mu + contin) / sigma;
  return 0.5 * std::erfc(-z / kSqrt2);
}

}  // namespace

extern "C" {

// u2:      (G, T) U2 (OVO) or R2 (OVR), dtype u2_dtype
// u2_split_col: (T,) R2 row of group u2_split_code (OVR), shipped
//          separately so one huge group does not widen the whole R2
//          encoding; null/-1 when absent (then u2 holds every row)
// fc_sums: (G, T) per-group expression sums, dtype fc_dtype
// fc_split_col: (T,) expression sums of group fc_split_code, shipped
//          separately so one huge group does not widen the whole fc_sums
//          encoding; null/-1 when absent (then fc_sums holds every row)
// tie_seg: (G, T) OVO per-pair tie increment, dtype tie_seg_dtype; ignored
//          for OVR
// tie_col: (T,)  OVO: ref-only tie sum; OVR: full-column tie sum
// counts:  (G,)  cells per group (float64)
// results: (G, n_genes, 3) float64, written at columns [col0, col0 + w)
//          in [p, U, fc] order.
void illico_consume_tile(
    const void* u2, int32_t u2_dtype,
    const void* u2_split_col, int32_t u2_split_dtype, int64_t u2_split_code,
    const void* fc_sums, int32_t fc_dtype,
    const void* fc_split_col, int32_t fc_split_dtype, int64_t fc_split_code,
    const void* tie_seg, int32_t tie_seg_dtype,
    const void* tie_col, int32_t tie_col_dtype,
    const double* counts,
    int64_t G, int64_t T, int64_t w,
    int64_t ref_code,  // -1 => OVR
    int32_t alternative, int32_t use_continuity, int32_t tie_correct,
    double* results, int64_t col0, int64_t n_genes,
    double* col_scratch,  // (w,) workspace
    int32_t n_threads  // <=1: serial
) {
  (void)n_threads;  // referenced only from the OpenMP pragma below
  const double contin = use_continuity ? 0.5 : 0.0;
  const int64_t GT = G * T;
  const bool ovr = ref_code < 0;

  double n_total = 0.0;
  for (int64_t g = 0; g < G; ++g) n_total += counts[g];

  // Per-column reference means: OVO uses the reference group's mean; OVR
  // needs column totals (rest = total - group).
  if (ovr) {
    for (int64_t j = 0; j < w; ++j) col_scratch[j] = 0.0;
    for (int64_t g = 0; g < G; ++g)
      for (int64_t j = 0; j < w; ++j)
        col_scratch[j] += decode(fc_sums, fc_dtype, g * T + j, GT);
    if (fc_split_code >= 0)  // split row is zeroed inside fc_sums
      for (int64_t j = 0; j < w; ++j)
        col_scratch[j] += decode(fc_split_col, fc_split_dtype, j, T);
  } else {
    // True division (not reciprocal-multiply): bit-exact match with the
    // numpy path `group_sums / counts[:, None]`.
    const double nref_cells = counts[ref_code];
    for (int64_t j = 0; j < w; ++j)
      col_scratch[j] =
          (fc_split_code == ref_code
               ? decode(fc_split_col, fc_split_dtype, j, T)
               : decode(fc_sums, fc_dtype, ref_code * T + j, GT)) /
          nref_cells;
  }

  // Group rows are independent (disjoint `results` slices, identical
  // per-iteration arithmetic), so parallelizing this loop is bit-exact for
  // any thread count.  The caller picks the count (native/__init__.py:
  // tail_threads).  The pragma is inert unless compiled with -fopenmp.
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(n_threads) \
    if (n_threads > 1)
#endif
  for (int64_t g = 0; g < G; ++g) {
    const double nt = counts[g];
    const double nr = ovr ? n_total - nt : counts[ref_code];
    const double mu = nr * nt / 2.0;
    const double n = nr + nt;
    const double tie_denom = n * (n - 1.0) * (n + 1.0);
    const double u_base = ovr ? nr * nt + nt * (nt + 1.0) / 2.0 : nr * nt;
    double* row = results + (g * n_genes + col0) * 3;
    for (int64_t j = 0; j < w; ++j) {
      const double r2 = g == u2_split_code
                            ? decode(u2_split_col, u2_split_dtype, j, T)
                            : decode(u2, u2_dtype, g * T + j, GT);
      const double u = u_base - 0.5 * r2;
      double tie = 0.0;
      if (tie_correct) {
        tie = decode(tie_col, tie_col_dtype, j, T);
        if (!ovr) tie += decode(tie_seg, tie_seg_dtype, g * T + j, GT);
      }
      const double s = g == fc_split_code
                           ? decode(fc_split_col, fc_split_dtype, j, T)
                           : decode(fc_sums, fc_dtype, g * T + j, GT);
      const double mu_tgt = s / nt;
      double mu_ref;
      if (ovr) {
        mu_ref = (col_scratch[j] - s) / (n_total - nt);
      } else {
        mu_ref = col_scratch[j];
      }
      row[j * 3 + 0] =
          pval(u, tie, nr, nt, mu, tie_denom, contin, alternative);
      row[j * 3 + 1] = u;
      row[j * 3 + 2] =
          mu_ref == 0.0 ? HUGE_VAL : mu_tgt / mu_ref;
    }
  }
}

// nnz-split OVO consumer.  Per (g, j) the wire carries the nonzero count
// k (uint8), U2_nz (uint16) and the biased tie residual (u24); the zero
// bucket is rebuilt in closed form from a0 = R - ref_nnz[j] and
// h0 = n_g - k (exact-integer float64, bounds proven at engagement).
// Entries outside their narrow range arrive exactly in the (S, T)
// exception slots (key = (array id << 24) | group, value on the f96 tier;
// key 0xFFFFFFFF = empty); columns with more than S violators were
// flagged in overflow_cols by the device and are recomputed by the
// caller's sort-engine fallback, so their values here are don't-care.
void illico_consume_tile_ksplit(
    const void* k8,  // (G, T) uint8 nonzero counts (ref row zeroed)
    const void* u2res, int32_t u2res_dtype,
    const void* tieres, int32_t tieres_dtype,
    const void* fc_sums, int32_t fc_dtype,
    int32_t fc_is_res,  // 1: fc_sums holds fc - k (uint8 tier); add k back
    const void* fc_split_col, int32_t fc_split_dtype, int64_t fc_split_code,
    const void* tie_ref_col, int32_t tie_ref_dtype,
    const void* ref_nnz_col, int32_t ref_nnz_dtype,
    const void* tie_base_col, int32_t tie_base_dtype,
    const void* exc_key,  // (S, T) uint32
    const void* exc_val, int32_t exc_val_dtype,
    int64_t n_exc,
    const double* counts,
    int64_t G, int64_t T, int64_t w,
    int64_t ref_code,
    int32_t alternative, int32_t use_continuity, int32_t tie_correct,
    double* results, int64_t col0, int64_t n_genes,
    double* col_scratch,  // (w,) workspace: per-column reference fc mean
    int32_t n_threads) {
  (void)n_threads;
  const double contin = use_continuity ? 0.5 : 0.0;
  const int64_t GT = G * T;
  const uint8_t* kk = static_cast<const uint8_t*>(k8);
  const uint32_t* ek = static_cast<const uint32_t*>(exc_key);
  constexpr double kTieBias = 8388608.0;  // 2^23

  const double nref_cells = counts[ref_code];
  for (int64_t j = 0; j < w; ++j)
    col_scratch[j] =
        (fc_split_code == ref_code
             ? decode(fc_split_col, fc_split_dtype, j, T)
             : decode(fc_sums, fc_dtype, ref_code * T + j, GT)) /
        nref_cells;

  // Per-column scalars, decoded once.
  std::vector<double> a0(w), dslope(w), tieref(w);
  for (int64_t j = 0; j < w; ++j) {
    a0[j] = nref_cells - decode(ref_nnz_col, ref_nnz_dtype, j, T);
    dslope[j] = decode(tie_base_col, tie_base_dtype, j, T);
    tieref[j] = decode(tie_ref_col, tie_ref_dtype, j, T);
  }

  // One full cell, recomputed from (possibly exception-corrected) u2_nz,
  // tie residual and fc value.  Shared by the main loop and the fix-up
  // pass.  ``fcv`` is the decoded fc entry (residual when fc_is_res).
  auto emit = [&](int64_t g, int64_t j, double u2nz, double resid,
                  double fcv) {
    const double nt = counts[g];
    const double nr = nref_cells;
    const double mu = nr * nt / 2.0;
    const double n = nr + nt;
    const double k_gj = static_cast<double>(kk[g * T + j]);
    const double h0 = nt - k_gj;
    const double u2 = a0[j] * (nt + k_gj) + u2nz;
    const double u = nr * nt - 0.5 * u2;
    double tie = 0.0;
    if (tie_correct) {
      tie = tieref[j] + 3.0 * a0[j] * h0 * (a0[j] + h0) + h0 * h0 * h0 -
            h0 + dslope[j] * k_gj + resid;
    }
    double s;
    if (g == fc_split_code) {
      s = decode(fc_split_col, fc_split_dtype, j, T);
    } else {
      s = fcv + (fc_is_res ? k_gj : 0.0);
    }
    const double mu_ref = col_scratch[j];
    double* cell = results + (g * n_genes + col0 + j) * 3;
    cell[0] = pval(u, tie, nr, nt, mu, n * (n - 1.0) * (n + 1.0), contin,
                   alternative);
    cell[1] = u;
    cell[2] = mu_ref == 0.0 ? HUGE_VAL : (s / nt) / mu_ref;
  };

#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(n_threads) \
    if (n_threads > 1)
#endif
  for (int64_t g = 0; g < G; ++g) {
    for (int64_t j = 0; j < w; ++j) {
      const double u2nz = decode(u2res, u2res_dtype, g * T + j, GT);
      const double resid =
          decode(tieres, tieres_dtype, g * T + j, GT) - kTieBias;
      const double fcv = decode(fc_sums, fc_dtype, g * T + j, GT);
      emit(g, j, u2nz, resid, fcv);
    }
  }

  // Exception fix-up (serial; a handful of cells per column).  For each
  // excepted cell, re-read BOTH components — either may have its own
  // exception in this column — then re-emit.  Duplicate re-emits of the
  // same cell are idempotent.
  for (int64_t j = 0; j < w; ++j) {
    for (int64_t s = 0; s < n_exc; ++s) {
      const uint32_t key = ek[s * T + j];
      if (key == 0xFFFFFFFFu) continue;
      const int64_t g = static_cast<int64_t>(key & 0xFFFFFFu);
      if (g >= G) continue;  // corrupt key: leave the cell as decoded
      double u2nz = decode(u2res, u2res_dtype, g * T + j, GT);
      double resid = decode(tieres, tieres_dtype, g * T + j, GT) - kTieBias;
      double fcv = decode(fc_sums, fc_dtype, g * T + j, GT);
      for (int64_t s2 = 0; s2 < n_exc; ++s2) {
        const uint32_t key2 = ek[s2 * T + j];
        if (key2 == 0xFFFFFFFFu) continue;
        if (static_cast<int64_t>(key2 & 0xFFFFFFu) != g) continue;
        const double v = decode(exc_val, exc_val_dtype, s2 * T + j,
                                n_exc * T);
        const uint32_t aid = key2 >> 24;
        if (aid == 0u) {
          u2nz = v;
        } else if (aid == 1u) {
          resid = v;
        } else {
          fcv = v;
        }
      }
      emit(g, j, u2nz, resid, fcv);
    }
  }
}

}  // extern "C"
