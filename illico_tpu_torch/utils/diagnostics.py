"""Input diagnostics: the log1p-consistency warning.

Copy of ``illico_tpu.utils.diagnostics.warn_if_log1p_mismatch`` for callers
that already sampled the data (the runner passes its sampled maximum).
"""

from __future__ import annotations

import warnings

__all__ = ["warn_if_log1p_mismatch"]


def warn_if_log1p_mismatch(
    *,
    is_log1p: bool,
    max_value: float,
    integral: bool | None = None,
) -> None:
    """Warn when the user's ``is_log1p`` flag looks inconsistent with the data.

    Heuristic: log1p-transformed expression rarely exceeds ~15, raw counts
    usually do.  ``integral=True`` suppresses the low-max warning for
    ``is_log1p=False``: small integer counts are legitimately below 15.
    """
    max_val = float(max_value)
    if not is_log1p and integral is True:
        return
    if is_log1p and max_val > 15:
        warnings.warn(
            f"is_log1p=True, yet a sampled maximum of {max_val:.2f} looks "
            "like raw counts (log1p expression rarely exceeds ~15). Fold "
            "changes would be computed on expm1 of already-raw values — "
            "check the flag against how the matrix was produced.",
            UserWarning,
        )
    elif not is_log1p and max_val < 15:
        warnings.warn(
            f"is_log1p=False, yet a sampled maximum of {max_val:.2f} looks "
            "like log1p-transformed expression (raw counts usually exceed "
            "15). Fold changes would then be ratios of log values — check "
            "the flag against how the matrix was produced.",
            UserWarning,
        )
