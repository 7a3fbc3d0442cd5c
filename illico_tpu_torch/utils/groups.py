"""Group encoding and run-length layout.

Host-side copy of ``illico_tpu.utils.groups`` (numpy only): groups are
encoded to dense integer codes, and the *group-contiguous permutation*
``perm`` (rows reordered so that group ``g`` occupies rows
``indptr[g]:indptr[g+1]``) is precomputed.  The histogram kernel walks each
group's rows through ``perm``; the sort engine's segment sums run over the
same contiguous segments.  Both packages must build identical arrays from
the same labels (``tests/test_torch_host.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

__all__ = ["GroupInfo", "encode_and_count_groups"]


@dataclasses.dataclass(frozen=True)
class GroupInfo:
    """All group-related metadata, host-resident (numpy).

    Mirrors the information content of the reference ``GroupContainer``
    (``groups.py:6-15``) with the extra ``perm`` layout array.

    Attributes
    ----------
    encoded_groups : (n_cells,) int32 — group code per row (original order).
    counts : (n_groups,) int64 — number of rows per group.
    perm : (n_cells,) int32 — row permutation making groups contiguous;
        ``perm[k]`` is the original row index of contiguous position ``k``.
    indptr : (n_groups + 1,) int64 — segment bounds in the permuted layout.
    ref_code : int — encoded reference group, ``-1`` when OVR (no reference),
        same convention as the reference (``groups.py:55-57``).
    """

    encoded_groups: np.ndarray
    counts: np.ndarray
    perm: np.ndarray
    indptr: np.ndarray
    ref_code: int

    @property
    def n_groups(self) -> int:
        return int(self.counts.size)

    @property
    def n_cells(self) -> int:
        return int(self.encoded_groups.size)

    @property
    def is_ovr(self) -> bool:
        return self.ref_code == -1


def encode_and_count_groups(
    groups: Sequence[Any] | np.ndarray,
    ref_group: Any | None = None,
) -> tuple[np.ndarray, GroupInfo]:
    """Encode group labels and build the contiguous layout.

    Parameters
    ----------
    groups : 1-d sequence of group labels, one per cell/row.
    ref_group : label of the reference (control) group for OVO tests, or
        ``None`` for OVR.

    Returns
    -------
    (unique_groups, GroupInfo) — unique labels in sorted (np.unique) order, and
    the group metadata.  The unique order matches the reference so the output
    DataFrame index is identical (``groups.py:42``).

    Raises
    ------
    ValueError — if ``ref_group`` is given but absent from ``groups``
    (same contract as ``groups.py:40-41``).
    """
    groups = np.asarray(groups)
    # pandas' hash-based factorize is ~10x faster than np.unique's sort on
    # large string label arrays; re-rank its appearance-order codes into
    # np.unique's sorted order so the output contract is unchanged.
    import pandas as pd

    codes, uniques = pd.factorize(groups)
    if codes.min(initial=0) < 0:
        # factorize encodes missing labels (NaN/None/NaT) as -1; silently
        # wrapping them into the last group would corrupt every statistic
        # of that group.  Fail loudly instead.
        n_bad = int(np.count_nonzero(codes < 0))
        raise ValueError(
            f"Group labels contain {n_bad} missing value(s) (NaN/None); "
            "drop or fill those cells before running the test."
        )
    uniques = np.asarray(uniques)
    order = np.argsort(uniques, kind="stable")
    rank = np.empty(order.size, dtype=np.int64)
    rank[order] = np.arange(order.size)
    encoded = rank[codes]
    unique_groups = uniques[order]
    counts = np.bincount(encoded, minlength=order.size)
    if ref_group is not None:
        hit = np.flatnonzero(unique_groups == np.asarray(ref_group))
        if hit.size == 0:
            raise ValueError(
                f"Reference group `{ref_group}` is not present in the group labels."
            )
        ref_code = int(hit[0])
    else:
        ref_code = -1

    encoded = np.ascontiguousarray(encoded.ravel().astype(np.int32))
    # Stable sort so that within a group, original row order is preserved.
    perm = np.argsort(encoded, kind="stable").astype(np.int32)
    indptr = np.zeros(counts.size + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])

    info = GroupInfo(
        encoded_groups=encoded,
        counts=counts.astype(np.int64),
        perm=perm,
        indptr=indptr,
        ref_code=ref_code,
    )
    return unique_groups, info
