"""Exact statistical tail: z-scores, p-values, fold changes (host, float64).

Port of ``illico_tpu.stats``.  The device computes the exact rank sums, tie
sums and group expression sums; this module turns those (n_groups, n_genes)
summaries into p-values and fold changes in IEEE double precision, with
the native C++ tail (libm erfc) when it is available and numpy with scipy's
erfc otherwise, so the 1e-12 contract against ``scipy.stats.mannwhitneyu``
does not depend on device arithmetic.

Semantics: tie correction, the degenerate guard ``tie_corr <= 1e-9 -> p = 1``,
two-sided folding ``U = min(U, n_ref*n_tgt - U)``, continuity corrections;
fold change with reference = rest for OVR and ``mu_ref == 0 -> +inf``.
"""

from __future__ import annotations

import numpy as np
from scipy import special as sp_special

__all__ = ["pvalues_from_stats", "fold_change_from_summed_expr"]

_SQRT2 = np.sqrt(2.0)


def _per_group_ok(arr: np.ndarray, shape: tuple) -> bool:
    """True when ``arr`` broadcasts to ``shape`` as a per-ROW constant.

    The native tail takes one sample size per group (row).  A 1-D
    ``(n_groups,)`` array does not qualify: numpy broadcasting aligns it with
    the trailing (column) axis, so the numpy path would scale per column and
    the two paths would disagree.
    """
    if arr.ndim == 0:
        return True
    if arr.ndim == 1:
        return arr.size == 1
    if arr.ndim == 2:
        return arr.shape[1] == 1 and arr.shape[0] in (1, shape[0])
    return False


def pvalues_from_stats(
    U: np.ndarray,
    tie_sum: np.ndarray,
    n_ref: np.ndarray,
    n_tgt: np.ndarray,
    use_continuity: bool = True,
    tie_correct: bool = True,
    alternative: str = "two-sided",
    prefer_native: bool = True,
    n_threads: int | None = None,
) -> np.ndarray:
    """Vectorized asymptotic Mann-Whitney p-values.

    Parameters
    ----------
    U : float64 array — U statistic of the *reference* sample (scipy's ``U1``
        for ``mannwhitneyu(ref, tgt)``), any shape.
    tie_sum : float64 array broadcastable to ``U.shape`` — ``sum(t^3 - t)``
        over tie blocks of the combined sample.
    n_ref, n_tgt : integer arrays broadcastable to ``U.shape``.
    use_continuity : apply the +-0.5 continuity correction.
    tie_correct : apply the tie correction to sigma.
    alternative : 'two-sided' | 'greater' | 'less' — hypothesis on ref vs tgt.
    prefer_native : use the C++ tail when it is available.
    n_threads : the C++ tail's threads (default
        :func:`illico_tpu_torch.native.tail_threads`).

    Returns
    -------
    float64 p-values, same shape as broadcast inputs.
    """
    if alternative not in ("two-sided", "greater", "less"):
        raise ValueError(f"Unsupported alternative hypothesis: {alternative}")

    U = np.asarray(U, dtype=np.float64)
    n_ref = np.asarray(n_ref, dtype=np.float64)
    n_tgt = np.asarray(n_tgt, dtype=np.float64)
    tie_sum = np.asarray(tie_sum, dtype=np.float64)

    # Fast path: the fused C++ tail (same formula, libm erfc) when the
    # sample sizes are per-group scalars of a 2-d (n_groups, n_cols) batch.
    if (
        prefer_native and U.ndim == 2
        and _per_group_ok(n_ref, U.shape) and _per_group_ok(n_tgt, U.shape)
    ):
        from illico_tpu_torch.native import pvalue_tail_native

        res = pvalue_tail_native(
            U, tie_sum, n_ref, n_tgt, use_continuity, tie_correct, alternative,
            n_threads=n_threads,
        )
        if res is not None:
            return res
    if not tie_correct:
        tie_sum = np.zeros_like(tie_sum)

    n = n_ref + n_tgt
    mu = n_ref * n_tgt / 2.0
    contin = 0.5 if use_continuity else 0.0

    with np.errstate(divide="ignore", invalid="ignore"):
        tie_corr = 1.0 - tie_sum / (n * (n - 1.0) * (n + 1.0))
        degenerate = ~(tie_corr > 1.0e-9)
        sigma = np.sqrt(n_ref * n_tgt * (n + 1.0) / 12.0 * tie_corr)

        if alternative == "two-sided":
            U2 = np.minimum(U, n_ref * n_tgt - U)
            delta = U2 - mu
            z = (np.abs(delta) + np.sign(delta) * contin) / sigma
            p = sp_special.erfc(z / _SQRT2)
        elif alternative == "greater":
            z = (U - mu - contin) / sigma
            p = 0.5 * sp_special.erfc(z / _SQRT2)
        else:  # less
            z = (U - mu + contin) / sigma
            p = 0.5 * sp_special.erfc(-z / _SQRT2)

    return np.where(degenerate, 1.0, p)


def fold_change_from_summed_expr(
    group_sums: np.ndarray,
    counts: np.ndarray,
    ref_code: int,
) -> np.ndarray:
    """Fold change per (group, gene) from per-group summed expression.

    Parameters
    ----------
    group_sums : (n_groups, n_genes) float64 — per-group sums of (possibly
        expm1-transformed) expression values.
    counts : (n_groups,) — cells per group.
    ref_code : encoded reference group, or -1 for OVR (reference = rest).
    """
    group_sums = np.asarray(group_sums, dtype=np.float64)
    counts = np.asarray(counts, dtype=np.float64)
    mu_tgt = group_sums / counts[:, None]
    if ref_code == -1:
        rest_sums = group_sums.sum(axis=0, keepdims=True) - group_sums
        rest_counts = (counts.sum() - counts)[:, None]
        mu_ref = rest_sums / rest_counts
    else:
        mu_ref = mu_tgt[ref_code][None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        fc = np.where(mu_ref == 0, np.inf, mu_tgt / mu_ref)
    return fc
