"""Histogram-contraction engine: rank statistics without sorting.

Port of ``illico_tpu.ops.hist_engine``, packed result wire included.  Single-cell
expression values are small integers (UMI counts) or their exact float32
log1p images, and every statistic the tests need is a contraction of
per-(group, value, column) histograms h with per-column value tables:

  c[v,j]      = sum_g h[g,v,j]                    (global value counts)
  r2tab[v,j]  = 2*ccum_excl[v,j] + c[v,j] + 1     (2x tie-averaged rank of v)
  OVR:  R2[g,j]     = sum_v h * r2tab             (exact rank sums)
        tie_col[j]  = sum_v c^3 - c
  OVO:  U2[g,j]     = sum_v h * (2*acum_excl + a) (a = ref histogram)
        tie_seg[g,j]= sum_v (h^3 - h) + 3*a*h*(a + h)
        tie_ref[j]  = sum_v a^3 - a
  FC:   sums[g,j]   = sum_v h * v

On one device (or each shard of the gene mesh) a tile takes
:func:`hist_pass_contract`: on CUDA tensors the hand-written kernels of
``csrc/hist_fused.cu`` first count the values of the rows the (V, T) tables
need (:func:`row_counts`: the reference's rows, or every row in OVR), then
count each (group, 32-column) block in shared memory and contract it there
over v, so the (G, V, T) histogram is never written.  The cell mesh
counts each cell shard's rows apart, so it keeps histograms: on each
shard :func:`hist_pass` launches ``csrc/hist_kernel.cu`` (K1) (and, in
OVR, :func:`row_counts` counts the shard's rows), and on the lead
:func:`hist_contract` launches ``csrc/hist_contract.cu``'s
``contract_kernel``, which reads every shard's float32 histogram once,
sums them in registers and writes the exact float64 sums.  CPU tensors
take each kernel's plain torch version (:func:`row_counts_plain`,
:func:`hist_pass_plain`, :func:`hist_contract_plain`).  Values outside the table match nothing; the
contraction flags their columns from the totals (``overflow_cols``) and the
runner recomputes those with the sort engine.

The statistics of a tile leave the device as one ``uint8`` buffer on the
packed wire of :mod:`illico_tpu_torch.ops.wire` (its names are re-exported
here, where the reference package keeps them): :func:`hist_contract_statics`
proves from the group sizes how few bytes each statistic needs, and
``hist_contract(pack=True)`` narrows and packs them on the tile's device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from illico_tpu_torch.ops.rank_engine import BLOCK, PaddedLayout
from illico_tpu_torch.ops.wire import (  # noqa: F401  (re-exported)
    _DEV_DTYPE,
    _DTYPE_WIRE_BYTES,
    _EXC_AID_SHIFT,
    _EXC_KEY_SENTINEL,
    _F96_EXP_BIAS,
    _TIE_RES_BIAS,
    _WIRE_COUNT_ALIGN,
    _WIRE_RANK,
    NNZ_SPLIT_SLOTS,
    Abstract,
    _narrow_bytes,
    _narrow_map,
    _pick_exact_dtype,
    _pick_split_dtype,
    _split_hi_lo_words,
    _split_mantexp_words,
    _wire_bytes,
    assert_spec_size_unique,
    build_pack_spec,
    pack_device_outputs,
    reconstruct_ksplit,
    spec_lookup,
    spec_total_bytes,
    to_wire_dtype,
    unpack_host_buffer,
)

__all__ = [
    "DEFAULT_V",
    "MAX_V",
    "HIST_EXACT_MAX_GROUP",
    "NNZ_SPLIT_SLOTS",
    "build_pack_spec",
    "pack_device_outputs",
    "unpack_host_buffer",
    "reconstruct_ksplit",
    "spec_total_bytes",
    "hist_contract_statics",
    "hist_stat_bounds",
    "hist_pass",
    "hist_pass_plain",
    "hist_contract",
    "hist_contract_plain",
    "hist_pass_contract",
    "hist_pass_contract_plain",
    "row_counts",
    "row_counts_plain",
    "counting_rows",
    "fused_work",
    "make_hist_tile_fn",
    "make_value_table",
    "prepare_hist_inputs",
    "validate_hist_layout",
]

DEFAULT_V = 128  # table covers integer values 0..V-1
MAX_V = 512  # largest value table (_pick_v_buckets); counts >= MAX_V - 1 overflow

# The reference accumulates bucket counts in float32, exact only below 2^24
# per (group, value).  The kernel counts in int32 but keeps the same routing
# bound, so engine="auto" picks the same engine as the reference.
HIST_EXACT_MAX_GROUP = 2**24

# The fused kernel's split groups (:func:`fused_work`): a group longer than
# SPLIT_ROWS real rows is counted in row chunks of at most that many rows by
# several CTAs, which add their counts into a (V, T) int32 scratch plane, one
# per split group and at most MAX_SPLIT_SLOTS of them (the largest groups;
# csrc/hist_fused.cu's kMaxSplit).  Unsplit, a 120,000-row group of a
# 300,000-cell tile holds the kernel ~1.6x as long; a 30,000-row group costs
# less whole than split (hist_fused_probe.py, PERF.md section 6).
SPLIT_ROWS = 32768
MAX_SPLIT_SLOTS = 8

# Group-chunk size of the plain contraction's float64 workspace:
# hist_contract_plain never materializes more than ~this many bytes per
# float64 (chunk, V, T) temporary.  The kernels need no workspace.
CONTRACT_CHUNK_BYTES = 256 << 20


def make_value_table(v_buckets: int, is_log1p: bool) -> np.ndarray:
    """(V,) float32 table of tabulated values, ascending.

    log1p is numpy's float32 ``log1p`` (never torch's), matching data made by
    float32 pipelines and the reference package's table bit for bit; data
    transformed differently matches no entry and takes the exact sort path.
    """
    vals = np.arange(v_buckets, dtype=np.float32)
    if is_log1p:
        vals = np.log1p(vals)
    return vals.astype(np.float32)


def real_rows_per_group(layout: PaddedLayout) -> np.ndarray:
    return np.asarray(
        [
            np.count_nonzero(~layout.pad_mask[s * BLOCK : e * BLOCK])
            for s, e in zip(layout.block_starts, layout.block_ends)
        ],
        dtype=np.int64,
    )


def pads_per_group(layout: PaddedLayout) -> np.ndarray:
    seg = (layout.block_ends.astype(np.int64) - layout.block_starts) * BLOCK
    return (seg - real_rows_per_group(layout)).astype(np.int32)


def prepare_hist_inputs(
    layout: PaddedLayout, v_buckets: int, is_log1p: bool, device
) -> dict:
    """Device tensors for :func:`hist_pass` and :func:`hist_contract`.

    The kernel walks each group's REAL rows, so the padded layout is reduced
    to ``perm`` (source row per real slot, group-contiguous), ``indptr``
    (group segment bounds), and ``order`` (groups by descending size: the
    launch order of the kernel's CTAs).  ``ppg`` (pads per group) feeds the
    contraction's overflow test, as in the reference.
    """
    real = real_rows_per_group(layout)
    indptr = np.zeros(real.size + 1, np.int64)
    np.cumsum(real, out=indptr[1:])
    arrays = dict(
        perm=layout.perm[~layout.pad_mask].astype(np.int32),
        indptr=indptr,
        order=np.argsort(-real, kind="stable").astype(np.int32),
        table=make_value_table(v_buckets, is_log1p),
        ppg=pads_per_group(layout),
    )
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def validate_hist_layout(layout: PaddedLayout) -> None:
    """Reject layouts the histogram engine cannot serve exactly."""
    real_check = real_rows_per_group(layout)
    if real_check.size and real_check.max() >= HIST_EXACT_MAX_GROUP:
        raise ValueError(
            f"Histogram engine requires every group below {HIST_EXACT_MAX_GROUP} "
            f"cells for exact f32 bucket counts (largest group: "
            f"{int(real_check.max())}); use engine='sort'."
        )
    if real_check.size and real_check.min() == 0:
        raise ValueError(
            "Histogram engine requires every group to have at least one "
            "row; use engine='sort' for layouts with empty groups."
        )


def _as_float32(x):
    # Narrow wire dtypes (int8/uint8/int16/float16 tiles shipped in their
    # storage dtype) are cast on the device: exact for integers below 2**24
    # and every float16 value.  float64 would alias distinct values into
    # float32 buckets, so it is refused (the runner routes it to sort).
    if x.dtype == torch.float64:
        raise TypeError("hist_pass takes float32 or narrower tiles, not float64")
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def _buckets(x, rows, table, *, is_log1p: bool):
    """K1's bucket rule on the rows ``rows`` of ``x``: (bucket index k as
    int64, mask of the values that land in bucket k), both (len(rows), T)."""
    vals = _as_float32(x).index_select(0, rows.long())
    k = torch.round(torch.expm1(vals) if is_log1p else vals)
    ok = (k >= 0) & (k < table.numel())
    k = torch.where(ok, k, 0).long()
    ok &= table[k] == vals
    return k, ok


def hist_pass_plain(x, perm, indptr, order, table, *, is_log1p: bool):
    """Plain torch version of the kernel: same bucket rule, a gather and one
    ``scatter_add_`` over the flattened ``(g*V + bucket)*T + j`` index.
    ``order`` only schedules the kernel and does not change the result."""
    del order
    n_groups, v_buckets, t_cols = indptr.numel() - 1, table.numel(), x.shape[1]
    k, ok = _buckets(x, perm, table, is_log1p=is_log1p)  # group-contiguous rows
    grp = torch.repeat_interleave(
        torch.arange(n_groups, device=x.device), torch.diff(indptr)
    )
    cols = torch.arange(t_cols, device=x.device)
    key = ((grp[:, None] * v_buckets + k) * t_cols + cols)[ok]
    out = torch.zeros(n_groups * v_buckets * t_cols, dtype=torch.float32, device=x.device)
    out.scatter_add_(0, key, torch.ones(key.numel(), dtype=torch.float32, device=x.device))
    return out.view(n_groups, v_buckets, t_cols)


def _check(name, t, dtype, ndim, device, fn="hist_pass"):
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous {ndim}-d {dtype} tensor; "
            f"got {t.dtype} with shape {tuple(t.shape)}"
        )


def _check_pass_inputs(x, perm, indptr, order, table, fn):
    """The tile (cast to float32) after checking K1's inputs for ``fn``."""
    x = _as_float32(x)
    dev = x.device
    _check("x", x, torch.float32, 2, dev, fn)
    _check("perm", perm, torch.int32, 1, dev, fn)
    _check("indptr", indptr, torch.int64, 1, dev, fn)
    _check("order", order, torch.int32, 1, dev, fn)
    _check("table", table, torch.float32, 1, dev, fn)
    n_groups, v_buckets = indptr.numel() - 1, table.numel()
    if order.numel() != n_groups:
        raise ValueError(f"{fn}: order has {order.numel()} groups, indptr {n_groups}")
    if not 1 <= v_buckets <= MAX_V:
        raise ValueError(f"{fn}: table size {v_buckets} outside [1, {MAX_V}]")
    return x


def _hist_pass_cuda(x, perm, indptr, order, table, *, is_log1p: bool):
    from illico_tpu_torch.utils.cuda_build import load_library

    x = _check_pass_inputs(x, perm, indptr, order, table, "hist_pass")
    dev = x.device
    n_groups, v_buckets, t_cols = indptr.numel() - 1, table.numel(), x.shape[1]
    out = torch.empty((n_groups, v_buckets, t_cols), dtype=torch.float32, device=dev)
    lib = load_library("hist_kernel")
    fn = lib.illico_hist_pass
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    with torch.cuda.device(dev):
        err = fn(
            x.data_ptr(), perm.data_ptr(), indptr.data_ptr(), order.data_ptr(),
            table.data_ptr(), out.data_ptr(), t_cols, n_groups, v_buckets,
            int(bool(is_log1p)), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"hist kernel launch failed with cudaError_t {err}")
    hist_pass.launches += 1
    return out


def hist_pass(x, perm, indptr, order, table, *, is_log1p: bool):
    """(G, V, T) float32 counts ``h[g, v, j] = #{rows of g : x[r, j] == table[v]}``.

    ``x`` is the (n_cells, T) tile in original row order.  A CUDA tensor
    launches ``csrc/hist_kernel.cu``; a CPU tensor takes
    :func:`hist_pass_plain`.  Any other device raises.

    ``hist_pass.launches`` counts a tile's grouped-histogram passes on the
    card: each launch of this kernel (K1) and each of the fused kernel of
    :func:`hist_pass_contract`, the same pass with the contraction in its
    epilogue.  ``hist_pass.v_buckets`` is the value-table size V of the
    latest call of either, on either device (None before the first).
    """
    hist_pass.v_buckets = table.numel()
    if x.device.type == "cuda":
        return _hist_pass_cuda(x, perm, indptr, order, table, is_log1p=is_log1p)
    if x.device.type == "cpu":
        return hist_pass_plain(x, perm, indptr, order, table, is_log1p=is_log1p)
    raise ValueError(f"hist_pass: unsupported device {x.device}")


hist_pass.launches = 0
hist_pass.v_buckets = None


def row_counts_plain(x, rows, table, *, is_log1p: bool):
    """Plain torch version of ``row_counts_kernel``: K1's bucket rule on the
    rows ``rows`` of ``x`` and one ``bincount`` of the flattened ``v*T + j``
    index, exact at any row count.  Values off the table go to one extra
    bin, dropped after the count (cheaper than a masked copy of the keys)."""
    v_buckets, t_cols = table.numel(), x.shape[1]
    k, ok = _buckets(x, rows, table, is_log1p=is_log1p)
    off = v_buckets * t_cols
    key = torch.where(ok, k * t_cols + torch.arange(t_cols, device=x.device), off)
    counts = torch.bincount(key.view(-1), minlength=off + 1)[:off]
    return counts.to(torch.float64).view(v_buckets, t_cols)


def _fused_library():
    from illico_tpu_torch.utils.cuda_build import load_library

    lib = load_library("hist_fused")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.illico_row_counts.restype = lib.illico_hist_contract.restype = i32
    lib.illico_row_counts.argtypes = [ptr, ptr, i64, ptr, ptr, i64, i32, i32, ptr]
    lib.illico_hist_contract.argtypes = [ptr] * 15 + [i32, i32, i64, i32, i32, i32, ptr]
    return lib


def _row_counts_cuda(x, rows, table, *, is_log1p: bool):
    """:func:`row_counts_plain` by ``row_counts_kernel``: int32 counts
    added into zeros by the card, then widened to float64."""
    x = _as_float32(x)
    dev = x.device
    _check("x", x, torch.float32, 2, dev, "row_counts")
    _check("rows", rows, torch.int32, 1, dev, "row_counts")
    _check("table", table, torch.float32, 1, dev, "row_counts")
    v_buckets, t_cols = table.numel(), x.shape[1]
    if not 1 <= v_buckets <= MAX_V:
        raise ValueError(f"row_counts: table size {v_buckets} outside [1, {MAX_V}]")
    counts = torch.zeros((v_buckets, t_cols), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _fused_library().illico_row_counts(
            x.data_ptr(), rows.data_ptr(), rows.numel(), table.data_ptr(),
            counts.data_ptr(), t_cols, v_buckets, int(bool(is_log1p)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"row_counts kernel launch failed with cudaError_t {err}")
    row_counts.launches += 1
    return counts.to(torch.float64)


def row_counts(x, rows, table, *, is_log1p: bool):
    """(V, T) float64 counts ``c[v, j] = #{r in rows : x[r, j] == table[v]}``
    with K1's bucket rule: a group's row of :func:`hist_pass`, or the sum
    of several, from the rows alone.  ``rows`` (int32) indexes ``x``'s rows:
    the reference group's rows give OVO's reference counts, every real row
    OVR's value counts.  A CUDA tensor launches ``csrc/hist_fused.cu``'s
    ``row_counts_kernel`` (counted in ``row_counts.launches``); a CPU
    tensor takes :func:`row_counts_plain`.  Any other device raises."""
    if x.device.type == "cuda":
        return _row_counts_cuda(x, rows, table, is_log1p=is_log1p)
    if x.device.type == "cpu":
        return row_counts_plain(x, rows, table, is_log1p=is_log1p)
    raise ValueError(f"row_counts: unsupported device {x.device}")


row_counts.launches = 0


def counting_rows(real_counts: np.ndarray, perm, ref_code: int):
    """The rows whose value counts the contraction's tables need, as a view
    of ``perm`` (:func:`prepare_hist_inputs`), from the real rows per group
    (:func:`real_rows_per_group`): the reference group's real rows in OVO,
    every real row in OVR (``ref_code == -1``)."""
    if ref_code == -1:
        return perm
    lo = int(real_counts[:ref_code].sum())
    return perm[lo : lo + int(real_counts[ref_code])]


class FusedWork(NamedTuple):
    """How the fused kernel walks a layout's groups (:func:`fused_work`):
    the groups it splits over row chunks and the group it takes from the
    counting pass's counts.  Host data, passed to the kernel by value."""

    split_groups: tuple  # group codes, largest first
    split_parts: tuple  # row chunks of each
    ref_code: int  # the group taken from the counting pass's counts, or -1

    @property
    def n_slots(self) -> int:
        """(V, T) int32 scratch planes: one per split group."""
        return len(self.split_groups)


def fused_work(real_counts, ref_code: int) -> FusedWork:
    """The fused kernel's split groups, from the real rows per group: the
    ``MAX_SPLIT_SLOTS`` largest groups but OVO's reference (``ref_code >=
    0``, contracted from its counts without reading its rows) longer than
    ``SPLIT_ROWS`` rows, each in ``ceil(rows / SPLIT_ROWS)`` chunks of equal
    rows (the last one shorter).  The kernel takes those chunks first, then
    every other group in ``order`` (by size, largest first), each once per
    32-column block.  Built once per layout by the tile function
    (:func:`make_hist_tile_fn`)."""
    real = np.asarray(real_counts, dtype=np.int64)
    split = [int(g) for g in np.argsort(-real, kind="stable")
             if real[g] > SPLIT_ROWS and g != ref_code][:MAX_SPLIT_SLOTS]
    parts = tuple(int(-(-real[g] // SPLIT_ROWS)) for g in split)
    return FusedWork(tuple(split), parts, int(ref_code))


def hist_stat_bounds(
    layout: PaddedLayout, ref_code: int, v_buckets: int
) -> tuple[float, float]:
    """Static upper bounds on U2/R2 and fc_sums (exact integer statistics)."""
    real = real_rows_per_group(layout).astype(np.float64)
    if ref_code == -1:
        u2_bound = 2.0 * (real.max() if real.size else 0.0) * real.sum()
    else:
        others = np.delete(real, ref_code)
        u2_bound = 2.0 * real[ref_code] * (others.max() if others.size else 0.0)
    fc_bound = (real.max() if real.size else 0.0) * (v_buckets - 1)
    return u2_bound, fc_bound


def hist_contract_statics(
    layout: PaddedLayout,
    ref_code: int,
    v_buckets: int,
    *,
    compute_fc: bool = True,
    wire: bool = True,
    fc_u8_hint: bool = False,
    nnz_split_hint: bool = True,
) -> dict:
    """Dtype-narrowing statics for :func:`hist_contract`, proven exact by
    the layout's static group-size bounds; equal to the reference package's
    (which has no ``nnz_split_hint``: False keeps the nnz-split wire off
    where the caller's data sampling expects its narrow residuals to
    overflow in most columns, see ``WilcoxonRunner._nnz_split_hint``).

    ``wire=True`` (the packed path): split-word tiers (u40/f48) and the row
    splits are in play, and the statistics leave the device in 1-6 bytes
    each.  ``wire=False`` (plain arrays): only true device dtypes narrow
    (uint16/uint32/int32).  ``compute_fc`` is carried so the dict equals the
    reference's; this package always computes fold changes.
    """
    u2_bound, fc_bound = hist_stat_bounds(layout, ref_code, v_buckets)
    real = real_rows_per_group(layout).astype(np.float64)
    pick = _pick_split_dtype if wire else _pick_exact_dtype
    # Per-column tie scalars: bounded by n**3 (OVR tie_col) / n_ref**3 (OVO
    # tie_ref_col).  Past 2**63 the packed wire needs the f96 triple.
    n_total = real.sum()
    tiecol_bound = (
        n_total**3 if ref_code == -1 or real.size == 0 else real[ref_code] ** 3
    )
    tiecol_dtype = "f96" if wire and tiecol_bound >= 2.0**63 else "float64"
    if ref_code == -1 or real.size == 0:
        tie_dtype = "float64"  # OVR has no per-(group, column) tie array
    else:
        others = np.delete(real, ref_code)
        r_ref = real[ref_code]
        m_max = others.max() if others.size else 0.0
        # Non-reference rows of tie_seg are maximized by concentrating both
        # samples in one value bucket: (M^3 - M) + 3*R*M*(R + M).  The
        # reference self-row (~7 R^3, far larger) is zeroed on the device.
        tie_bound = (m_max**3 - m_max) + 3.0 * r_ref * m_max * (r_ref + m_max)
        tie_dtype = pick(tie_bound)

    # Row splits: one huge group (typically the control, often 100x the
    # others) otherwise dictates the encoding for a whole (G, T) array; its
    # row ships separately (one row, per column) when that lets the bulk
    # array drop a wire tier.
    def _try_row_split(big, rest_bound, row_ok, pick_fn, current_dtype):
        rest_dtype = pick_fn(rest_bound)
        if row_ok and _DTYPE_WIRE_BYTES[rest_dtype] < _DTYPE_WIRE_BYTES[current_dtype]:
            return big, rest_dtype
        return -1, current_dtype

    fc_dtype = _pick_exact_dtype(fc_bound)
    fc_split_code = -1
    u2_dtype = pick(u2_bound)
    u2_split_code = -1
    if wire and real.size > 1:
        big = int(np.argmax(real))
        rest_max = float(np.delete(real, big).max())
        if compute_fc:
            # The fc split row travels as uint32, so the big row must fit it.
            fc_split_code, fc_dtype = _try_row_split(
                big,
                rest_max * (v_buckets - 1),
                row_ok=real[big] * (v_buckets - 1) < 2.0**32,
                pick_fn=_pick_exact_dtype,
                current_dtype=fc_dtype,
            )
        if ref_code == -1:
            # OVR rank sums: R2[g] <= 2 * n_g * n_total.  The split row
            # ships as float64 (hi/lo packed), exact for any size.
            u2_split_code, u2_dtype = _try_row_split(
                big,
                2.0 * rest_max * real.sum(),
                row_ok=True,
                pick_fn=pick,
                current_dtype=u2_dtype,
            )

    # nnz-split OVO wire: engages when k fits uint8 statically (every
    # non-reference group below 256 cells, the perturbation-screen norm) and
    # the tie tier it replaces is a split-word one (u40/f48), so the scheme
    # both saves bytes and keeps the host's closed-form zero-bucket
    # reconstruction exact in float64 (tie bound < 2^48).
    nnz_split = bool(
        wire
        and nnz_split_hint
        and ref_code != -1
        and real.size > 1
        and tie_dtype in ("u40", "f48")
        and float(np.delete(real, ref_code).max()) < 256.0
    )
    # fc-residual uint8 tier: only under nnz_split (needs k), only when the
    # control row already splits out (the k array zeroes the reference row),
    # and only when the caller's data sampling says the typical
    # per-(group, column) expression above one is uint8-sized (a wrong hint
    # costs fallback columns, never exactness).
    fc_u8 = bool(
        nnz_split and fc_u8_hint and compute_fc and fc_split_code == ref_code
    )

    return dict(
        ref_code=int(ref_code),
        compute_fc=compute_fc,
        u2_dtype=u2_dtype,
        fc_dtype=fc_dtype,
        tie_dtype=tie_dtype,
        tiecol_dtype=tiecol_dtype,
        fc_split_code=fc_split_code,
        u2_split_code=u2_split_code,
        nnz_split=nnz_split,
        fc_u8=fc_u8,
    )


def packed_width(t_cols: int) -> int:
    """Columns at which a histogram tile's statistics are packed: the tile's
    width rounded up to a multiple of 4, which meets every split tier's
    element-count alignment for any group count.  (The reference pads to
    128 for its kernel's lane tiling; the CUDA kernel takes any width.)  The
    pad columns are zero and the consumer reads only the tile's own."""
    return t_cols + (-t_cols) % 4


def hist_contract_abstract(n_groups: int, t_cols: int, statics: dict) -> dict:
    """Shapes and numpy dtypes of :func:`hist_contract`'s unpacked outputs
    at ``t_cols`` columns, without computing them."""
    f64, u32 = np.dtype(np.float64), np.dtype(np.uint32)
    bulk, col = (n_groups, t_cols), (t_cols,)

    def dev(name):
        return np.dtype(_DEV_DTYPE.get(name, name))

    nnz_split = statics.get("nnz_split", False)
    fc_u8 = nnz_split and statics.get("fc_u8", False)
    out = {"overflow_cols": Abstract(col, np.dtype(np.bool_))}
    if statics.get("fc_split_code", -1) >= 0:
        out["fc_split_col"] = Abstract(col, u32)
    if not fc_u8:
        out["fc_sums"] = Abstract(bulk, dev(statics.get("fc_dtype", "float64")))
    if statics["ref_code"] == -1:
        if statics.get("u2_split_code", -1) >= 0:
            out["r2_split_col"] = Abstract(col, f64)
        out["R2"] = Abstract(bulk, dev(statics.get("u2_dtype", "float64")))
        out["tie_col"] = Abstract(col, f64)
    elif nnz_split:
        slots = (min(NNZ_SPLIT_SLOTS, (3 if fc_u8 else 2) * n_groups), t_cols)
        out["tie_ref_col"] = Abstract(col, f64)
        out["k"] = Abstract(bulk, np.dtype(np.uint8))
        out["u2_res"] = Abstract(bulk, np.dtype(np.uint16))
        out["tie_res"] = Abstract(bulk, u32)
        out["ref_nnz_col"] = Abstract(col, u32)
        out["tie_base_col"] = Abstract(col, f64)
        if fc_u8:
            out["fc_res"] = Abstract(bulk, np.dtype(np.uint8))
        out["exc_key"] = Abstract(slots, u32)
        out["exc_val"] = Abstract(slots, f64)
    else:
        out["U2"] = Abstract(bulk, dev(statics.get("u2_dtype", "float64")))
        out["tie_ref_col"] = Abstract(col, f64)
        out["tie_seg"] = Abstract(bulk, dev(statics.get("tie_dtype", "float64")))
    return out


def _pad_columns(out: dict, width: int) -> dict:
    """Zero-pad every tensor's last (column) axis to ``width``."""
    return {
        k: v if v.shape[-1] == width
        else torch.nn.functional.pad(v, (0, width - v.shape[-1]))
        for k, v in out.items()
    }


def _ksplit_outputs(out, u2_nz, tie_nz, k, a_nz, fc_sums, fc_u8: bool):
    """The nnz-split wire arrays (see :mod:`illico_tpu_torch.ops.wire`) from
    the nonzero-bucket statistics, all exact float64 of shape (G, T) with
    the reference group's own rows zeroed; adds the columns with more
    violators than exception slots to ``out["overflow_cols"]``."""
    # Per-column integer slope D: least squares of tie_nz on k, rounded.
    # Only a predictor: exactness comes from the exact residual, and the
    # clamp keeps D*k exact in float64 (D*255 < 2^48).
    denom = (k * k).sum(dim=0)
    d_col = torch.where(
        denom > 0.0,
        torch.round((tie_nz * k).sum(dim=0) / denom.clamp(min=1.0)),
        0.0,
    ).clamp(0.0, 2.0**40)
    resid = tie_nz - d_col[None, :] * k
    out["k"] = k.to(torch.uint8)
    out["u2_res"] = to_wire_dtype(u2_nz.clamp(0.0, 65535.0), "uint16")
    out["tie_res"] = to_wire_dtype(
        (resid + _TIE_RES_BIAS).clamp(0.0, 2.0**24 - 1.0), "uint32"
    )
    out["ref_nnz_col"] = to_wire_dtype(a_nz.sum(dim=0), "uint32")
    out["tie_base_col"] = d_col
    # Exceptions: the rare entries outside their narrow range travel exactly
    # in S per-column slots (the clipped narrow stores are overwritten at
    # decode).  One stable sort brings each column's violators to the front
    # in (array, group) order.
    g_rows, t_cols = k.shape
    gidx = torch.arange(g_rows, dtype=torch.int64, device=k.device)[:, None].expand(g_rows, t_cols)
    key_parts = [gidx, gidx + (1 << _EXC_AID_SHIFT)]
    val_parts = [u2_nz, resid]
    vio_parts = [u2_nz > 65535.0, (resid < -_TIE_RES_BIAS) | (resid >= _TIE_RES_BIAS)]
    if fc_u8:
        # fc residual against k: every nonzero contributes a value >= 1, so
        # fc_sums - k >= 0 and is ~k * (mean - 1) in count space.  The
        # control row travels in fc_split_col.
        fc_res = fc_sums - k
        out["fc_res"] = fc_res.clamp(0.0, 255.0).to(torch.uint8)
        key_parts.append(gidx + (2 << _EXC_AID_SHIFT))
        val_parts.append(fc_res)
        vio_parts.append(fc_res > 255.0)
    keys, vals, vio = (torch.cat(p, dim=0) for p in (key_parts, val_parts, vio_parts))
    s = NNZ_SPLIT_SLOTS
    front = torch.sort((~vio).to(torch.uint8), dim=0, stable=True).indices[:s]
    hit = torch.gather(vio, 0, front)
    out["exc_key"] = to_wire_dtype(
        torch.where(hit, torch.gather(keys, 0, front), int(_EXC_KEY_SENTINEL)), "uint32"
    )
    out["exc_val"] = torch.where(hit, torch.gather(vals, 0, front), 0.0)
    out["overflow_cols"] = out["overflow_cols"] | (vio.sum(dim=0) > s)


def _group_chunks(hist):
    """(g0, g1) group ranges whose float64 (chunk, V, T) copy stays within
    ``CONTRACT_CHUNK_BYTES``."""
    n_groups, v_buckets, t_cols = hist.shape
    chunk = max(1, CONTRACT_CHUNK_BYTES // max(1, v_buckets * t_cols * 8))
    return [(g0, min(g0 + chunk, n_groups)) for g0 in range(0, n_groups, chunk)]


def _shards(hists) -> list:
    """The histograms whose sum :func:`hist_contract` contracts, as a list:
    one (G, V, T) tensor, or several (the cell mesh's shards), which must
    share one shape, dtype and device."""
    hists = [hists] if isinstance(hists, torch.Tensor) else list(hists)
    if not hists:
        raise ValueError("hist_contract: no histogram")
    first = hists[0]
    for s, h in enumerate(hists[1:], 1):
        if h.shape != first.shape or h.dtype != first.dtype or h.device != first.device:
            raise ValueError(
                f"hist_contract: shard {s} is {h.dtype} {tuple(h.shape)} on {h.device}, "
                f"shard 0 {first.dtype} {tuple(first.shape)} on {first.device}"
            )
    return hists


def _chunk_sum(hists, g0, g1):
    """The shards' sum over groups [g0, g1) as float64 (exact: integer counts)."""
    h = hists[0][g0:g1].to(torch.float64)
    for other in hists[1:]:
        h += other[g0:g1]
    return h


def _value_counts_plain(hists):
    """(V, T) global value counts ``c[v, j] = sum_s sum_g h_s[g, v, j]``,
    exact.  Summed chunk by chunk: a reduction with dtype=float64 over a
    whole histogram would first materialize its float64 copy (G x V x T x 8
    bytes)."""
    hists = _shards(hists)
    c = torch.zeros(hists[0].shape[1:], dtype=torch.float64, device=hists[0].device)
    for h in hists:
        for g0, g1 in _group_chunks(h):
            c += h[g0:g1].to(torch.float64).sum(dim=0)
    return c


def _ref_counts(hists, ref_code: int):
    """(V, T) float64 counts of the reference group: its row of the shards'
    sum (exact)."""
    return _chunk_sum([h[ref_code : ref_code + 1] for h in hists], 0, 1)[0]


def _group_sums_plain(hists, tab, a, *, nnz_split: bool, total: bool):
    """Plain torch version of ``contract_kernel``: over the sum of the
    shards' histograms ``hists`` (one tensor or a list), the (G, T) float64
    sums over v of ``h * v`` (fc), ``h * tab`` (U2 or R2), the OVO tie term
    when ``a`` (the reference row) is given, ``h`` over v > 0 under
    ``nnz_split`` (k; the v=0 plane then also leaves the U2 and tie sums)
    and ``h`` over every v when ``total``; None for the sums not asked for.
    The shards are summed chunk by chunk, never into a whole histogram."""
    f64 = torch.float64
    hists = _shards(hists)
    n_groups, v_buckets, t_cols = hists[0].shape
    vals = torch.arange(v_buckets, dtype=f64, device=hists[0].device)[:, None]

    def new():
        return hists[0].new_empty((n_groups, t_cols), dtype=f64)

    fc_sums, main = new(), new()
    tie = new() if a is not None else None
    k = new() if nnz_split else None
    tot = new() if total else None
    for g0, g1 in _group_chunks(hists[0]):
        h = _chunk_sum(hists, g0, g1)
        fc_sums[g0:g1] = (h * vals).sum(dim=1)
        if total:
            tot[g0:g1] = h.sum(dim=1)
        if nnz_split:  # nonzero buckets only: the v=0 plane is rebuilt on the host
            h[:, 0, :] = 0.0
            k[g0:g1] = h.sum(dim=1)
        main[g0:g1] = (h * tab).sum(dim=1)
        if tie is not None:
            tie[g0:g1] = ((h * h * h - h) + 3.0 * a * h * (a + h)).sum(dim=1)
    return fc_sums, main, tie, k, tot


def _contract_library():
    from illico_tpu_torch.utils.cuda_build import load_library

    lib = load_library("hist_contract")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.illico_contract.restype = i32
    lib.illico_contract.argtypes = [ptr, i32] + [ptr] * 7 + [i64, i32, i32, i32, i32, ptr]
    return lib


def _group_sums_cuda(hists, tab, a, *, nnz_split: bool, total: bool):
    """:func:`_group_sums_plain` by ``contract_kernel``: one launch, one
    read of each shard's histogram, their sum never written.  The shards'
    addresses reach the kernel as a device array (any number of shards);
    rows on 16-byte boundaries take 16-byte loads."""
    f64 = torch.float64
    hists = _shards(hists)
    dev = hists[0].device
    for h in hists:
        _check("hist", h, torch.float32, 3, dev, "hist_contract")
    n_groups, v_buckets, t_cols = hists[0].shape
    for name, t in (("tab", tab), ("a", a)):
        if t is not None:
            _check(name, t, f64, 2, dev, "hist_contract")
            if tuple(t.shape) != (v_buckets, t_cols):
                raise ValueError(f"hist_contract: {name} has shape {tuple(t.shape)}, "
                                 f"expected {(v_buckets, t_cols)}")

    def new():
        return torch.empty((n_groups, t_cols), dtype=f64, device=dev)

    fc_sums, main = new(), new()
    tie = new() if a is not None else None
    k = new() if nnz_split else None
    tot = new() if total else None
    addrs = [h.data_ptr() for h in hists]
    # Copied from pageable memory in stream order, without waiting for the card.
    table = torch.tensor(addrs, dtype=torch.int64).to(dev, non_blocking=True)
    vec = t_cols % 4 == 0 and all(p % 16 == 0 for p in addrs)
    with torch.cuda.device(dev):
        err = _contract_library().illico_contract(
            table.data_ptr(), len(hists),
            *(None if t is None else t.data_ptr() for t in (tab, a, fc_sums, main, tie, k, tot)),
            t_cols, n_groups, v_buckets, int(bool(nnz_split)), int(vec),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"hist_contract kernel launch failed with cudaError_t {err}")
    _CONTRACT_ENTRY.launches += 1
    return fc_sums, main, tie, k, tot


def _contract_counts(
    counts,
    group_sums,
    pads_per_group,
    *,
    n_pad: float,
    ref_code: int,
    u2_dtype: str = "float64",
    fc_dtype: str = "float64",
    tie_dtype: str = "float64",
    tiecol_dtype: str = "float64",
    fc_split_code: int = -1,
    u2_split_code: int = -1,
    nnz_split: bool = False,
    fc_u8: bool = False,
    pack: bool = False,
    mark=None,
):
    """The contraction around its sums, whatever computes them: from the
    (V, T) float64 ``counts`` (OVR: every row's value counts c; OVO: the
    reference group's counts a) the (V, T) tables, then
    ``group_sums(tab, a, nnz_split=, total=)`` (plain, kernel or fused
    kernel alike), then every (G, T) step after the sums, all torch.
    ``mark("kernel")``, when given, is called right after the sums."""
    f64 = torch.float64
    ovr = ref_code == -1
    fc_u8 = bool(nnz_split and fc_u8)
    out = {}
    n_real = float(n_pad) - pads_per_group.to(f64).sum()
    if ovr:
        c = counts
        matched = c.sum(dim=0)
        tab = 2.0 * (torch.cumsum(c, dim=0) - c) + c + 1.0
        # Past 2^53 (a bucket count above 208,063) this sum rounds, so it
        # stays one torch expression: its order decides its bits.
        tie_col = (c * c * c - c).sum(dim=0)
        a = None
    else:
        a = counts
        tie_col = (a * a * a - a).sum(dim=0)
        if nnz_split:  # nonzero buckets only: the v=0 plane is rebuilt on the host
            a = a.clone()
            a[0] = 0.0
        tab = 2.0 * (torch.cumsum(a, dim=0) - a) + a
    fc_sums, main, tie, k, tot = group_sums(tab, a, nnz_split=nnz_split, total=not ovr)
    if mark is not None:
        mark("kernel")
    if not ovr:
        matched = tot.sum(dim=0)
    out["overflow_cols"] = matched < n_real

    if fc_split_code >= 0:
        out["fc_split_col"] = to_wire_dtype(fc_sums[fc_split_code], "uint32")
        fc_sums[fc_split_code] = 0.0
    if not fc_u8:
        out["fc_sums"] = to_wire_dtype(fc_sums, _DEV_DTYPE.get(fc_dtype, fc_dtype))
    if ovr:
        if u2_split_code >= 0:
            out["r2_split_col"] = main[u2_split_code].clone()
            main[u2_split_code] = 0.0
        out["R2"] = to_wire_dtype(main, _DEV_DTYPE.get(u2_dtype, u2_dtype))
        out["tie_col"] = tie_col
    else:
        out["tie_ref_col"] = tie_col
        main[ref_code] = 0.0
        tie[ref_code] = 0.0
        if nnz_split:
            k[ref_code] = 0.0
            _ksplit_outputs(out, main, tie, k, a, fc_sums, fc_u8)
        else:
            out["U2"] = to_wire_dtype(main, _DEV_DTYPE.get(u2_dtype, u2_dtype))
            out["tie_seg"] = to_wire_dtype(tie, _DEV_DTYPE.get(tie_dtype, tie_dtype))

    if not pack:
        return out
    narrow = _narrow_map(dict(
        ref_code=ref_code, u2_dtype=u2_dtype, fc_dtype=fc_dtype,
        tie_dtype=tie_dtype, tiecol_dtype=tiecol_dtype,
        nnz_split=nnz_split, fc_u8=fc_u8,
    ))
    return pack_device_outputs(out, narrow)[0]


def _contract(hists, pads_per_group, group_sums, *, counts=None, ref_code: int, **statics):
    """The contraction of the sum of one or several (G, V, T) histograms
    around its group sums ``group_sums(hists, tab, a, ...)``, plain or
    kernel alike.  ``counts`` are the tables' (V, T) float64 counts (OVR:
    the value counts; OVO: the reference group's); without them OVR sums the
    histograms (:func:`_value_counts_plain`) and OVO takes the reference's
    row of their sum."""
    hists = _shards(hists)
    v_buckets, t_cols = hists[0].shape[1:]
    if counts is None:
        counts = _value_counts_plain(hists) if ref_code == -1 else _ref_counts(hists, ref_code)
    else:
        _check("counts", counts, torch.float64, 2, hists[0].device, "hist_contract")
        if tuple(counts.shape) != (v_buckets, t_cols):
            raise ValueError(f"hist_contract: counts have shape {tuple(counts.shape)}, "
                             f"expected {(v_buckets, t_cols)}")
    return _contract_counts(
        counts, lambda tab, a, **kw: group_sums(hists, tab, a, **kw), pads_per_group,
        ref_code=ref_code, **statics,
    )


def hist_contract_plain(hists, pads_per_group, *, counts=None, **statics):
    """Plain torch version of :func:`hist_contract` on any device: the sums
    as float64 torch ops over group chunks of at most
    ``CONTRACT_CHUNK_BYTES`` per temporary (the shards summed chunk by
    chunk), so device memory holds the float32 histograms plus a bounded
    workspace."""
    return _contract(hists, pads_per_group, _group_sums_plain, counts=counts, **statics)


def hist_contract(hists, pads_per_group, *, counts=None, **statics):
    """All statistics as exact float64 contractions of the sum of ``hists``:
    one (G, V, T) float32 histogram, or a list of several of one shape,
    dtype and device (the cell mesh's shards, whose sum is the tile's
    histogram; it is never formed).

    Same output contract as :func:`illico_tpu_torch.ops.rank_engine.rank_stats_tile`
    plus ``overflow_cols`` (columns where a real row matched no table entry).
    A CUDA histogram launches ``csrc/hist_contract.cu``'s ``contract_kernel``
    once, which reads each shard once (counted in
    ``hist_contract.launches``); a CPU histogram takes
    :func:`hist_contract_plain`.  Any other device raises.

    ``counts``: the (V, T) float64 counts the tables need, on the
    histograms' device: OVR's value counts ``c[v, j] = sum_g h[g, v, j]``
    (the cell mesh takes them from the rows, :func:`row_counts`) or OVO's
    reference counts.  Without them OVR sums the histograms in torch and OVO
    takes the reference's row.

    Keywords (the statics of :func:`hist_contract_statics` with ``n_pad``):
    ``n_pad`` and ``ref_code`` (-1: OVR) are required.  In OVO the
    reference group's own rows of U2 and tie_seg are zeroed (the runner
    writes sentinels there), which is what makes narrow encodings bounded
    by the other groups' sizes sound.  Buckets index the integer counts for
    raw and log1p tables alike, so ``fc_sums`` is exact in both.

    ``u2_dtype`` / ``fc_dtype`` / ``tie_dtype`` narrow U2 (or R2), fc_sums
    and tie_seg to tiers proven exact by :func:`hist_contract_statics`.
    ``fc_split_code >= 0`` ships that group's expression-sum row as the
    per-column uint32 ``fc_split_col`` and zeroes it inside ``fc_sums``;
    ``u2_split_code >= 0`` (OVR) does the same for R2 with the float64
    ``r2_split_col``: one huge group otherwise forces a wider encoding onto
    the whole (G, T) array.  ``nnz_split`` replaces U2 and tie_seg by the
    nnz-split arrays of :mod:`illico_tpu_torch.ops.wire` (``fc_u8`` also
    fc_sums by ``fc_res``).

    ``pack=True`` returns one uint8 tensor (:func:`pack_device_outputs`)
    whose bytes equal the reference package's for the same histogram.
    """
    hists = _shards(hists)
    dev = hists[0].device
    if dev.type == "cuda":
        return _contract(hists, pads_per_group, _group_sums_cuda, counts=counts, **statics)
    if dev.type == "cpu":
        return hist_contract_plain(hists, pads_per_group, counts=counts, **statics)
    raise ValueError(f"hist_contract: unsupported device {dev}")


hist_contract.launches = 0
# The counter's owner, reached without the module's name: a caller may wrap
# ``hist_engine.hist_contract`` from outside (``tail_overlap.py`` does).
_CONTRACT_ENTRY = hist_contract


def _grouped_sums_cuda(x, perm, indptr, order, table, tab, a, *, is_log1p: bool,
                       nnz_split: bool, total: bool, work: FusedWork, ref_counts=None):
    """:func:`_group_sums_plain` of :func:`hist_pass`'s histogram by
    ``grouped_hist_contract_kernel``, one launch from the tile itself: the
    histogram stays in each CTA's shared memory.  ``work`` is
    :func:`fused_work` of the groups of ``indptr`` (``order`` sorts them by
    size, largest first); when it takes the reference group from counts
    (``work.ref_code >= 0``), ``ref_counts`` are those counts, (V, T)
    float64 (:func:`row_counts` of the reference's rows).  The scratch (the
    kernel's work counter, then for each split group a ticket per column
    block and a (V, T) int32 plane) is allocated here as zeros.  Counted in
    ``hist_pass.launches`` (the tile's grouped pass) and in
    ``hist_pass_contract.launches``."""
    f64 = torch.float64
    x = _check_pass_inputs(x, perm, indptr, order, table, "hist_pass_contract")
    dev = x.device
    n_groups, v_buckets, t_cols = indptr.numel() - 1, table.numel(), x.shape[1]
    for name, t in (("tab", tab), ("a", a), ("ref_counts", ref_counts)):
        if t is not None:
            _check(name, t, f64, 2, dev, "hist_pass_contract")
            if tuple(t.shape) != (v_buckets, t_cols):
                raise ValueError(f"hist_pass_contract: {name} has shape {tuple(t.shape)}, "
                                 f"expected {(v_buckets, t_cols)}")
    if work.ref_code >= 0 and ref_counts is None:
        raise ValueError("hist_pass_contract: the work takes the reference group from "
                         "ref_counts, and none were given")
    if not (work.ref_code < n_groups and all(0 <= g < n_groups for g in work.split_groups)
            and len(work.split_groups) <= MAX_SPLIT_SLOTS):
        raise ValueError(f"hist_pass_contract: {work} does not fit {n_groups} groups")

    def new():
        return torch.empty((n_groups, t_cols), dtype=f64, device=dev)

    fc_sums, main = new(), new()
    tie = new() if a is not None else None
    k = new() if nnz_split else None
    tot = new() if total else None
    n_blocks = -(-t_cols // 32)
    scratch = torch.zeros(1 + work.n_slots * (n_blocks + v_buckets * t_cols),
                          dtype=torch.int32, device=dev)
    split = (ctypes.c_int32 * (1 + 2 * work.n_slots))(
        work.n_slots, *work.split_groups, *work.split_parts)
    args = (x, perm, indptr, order)
    tail = (table, tab, a, ref_counts, fc_sums, main, tie, k, tot, scratch)
    with torch.cuda.device(dev):
        err = _fused_library().illico_hist_contract(
            *(t.data_ptr() for t in args), ctypes.addressof(split),
            *(None if t is None else t.data_ptr() for t in tail),
            n_groups, work.ref_code, t_cols, v_buckets, int(bool(is_log1p)),
            int(bool(nnz_split)), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"hist_pass_contract kernel launch failed with cudaError_t {err}")
    hist_pass.launches += 1
    _FUSED_ENTRY.launches += 1
    return fc_sums, main, tie, k, tot


def hist_pass_contract_plain(x, perm, indptr, order, table, pads_per_group, *,
                             count_rows, is_log1p: bool, mark=None, **statics):
    """Plain torch version of :func:`hist_pass_contract` on any device:
    :func:`hist_contract_plain` of :func:`hist_pass_plain`'s histogram, the
    tables' counts taken by :func:`row_counts_plain`."""
    x = _as_float32(x)  # a narrow wire dtype is cast once for both passes
    hist = hist_pass_plain(x, perm, indptr, order, table, is_log1p=is_log1p)
    counts = row_counts_plain(x, count_rows, table, is_log1p=is_log1p)
    return _contract_counts(
        counts, lambda tab, a, **kw: _group_sums_plain(hist, tab, a, **kw), pads_per_group,
        mark=mark, **statics,
    )


def hist_pass_contract(x, perm, indptr, order, table, pads_per_group, *, count_rows,
                       is_log1p: bool, mark=None, work: FusedWork | None = None,
                       **statics):
    """:func:`hist_contract` of :func:`hist_pass`'s histogram, without the
    histogram: the same outputs, bit for bit where the statics' tiers are
    exact (below 2^53).

    A CUDA tile launches ``csrc/hist_fused.cu``: :func:`row_counts` of
    ``count_rows`` (:func:`counting_rows`: OVO's reference rows, or every
    real row in OVR) gives the (V, T) tables' counts, then
    ``grouped_hist_contract_kernel`` contracts each (group, 32-column)
    block in shared memory (counted in ``hist_pass.launches`` and in
    ``hist_pass_contract.launches``; ``hist_contract.launches`` does not
    move), along ``work`` (:func:`fused_work` of the layout: the tile
    function builds it once; without it it is built here from ``indptr``,
    which waits for the card).  In OVO the reference group is contracted
    from the counting pass's counts.  A CPU tile takes
    :func:`hist_pass_contract_plain` (``work`` unused).  Any other device
    raises.  ``statics`` are :func:`hist_contract`'s keywords;
    ``mark("kernel")``, when given, is called after the grouped pass (the
    counting pass and the tables before it included), before the (G, T)
    steps.  Sets ``hist_pass.v_buckets``."""
    hist_pass.v_buckets = table.numel()
    if x.device.type == "cpu":
        return hist_pass_contract_plain(x, perm, indptr, order, table, pads_per_group,
                                        count_rows=count_rows, is_log1p=is_log1p,
                                        mark=mark, **statics)
    if x.device.type != "cuda":
        raise ValueError(f"hist_pass_contract: unsupported device {x.device}")
    x = _as_float32(x)  # a narrow wire dtype is cast once for both passes
    if work is None:
        work = fused_work(np.diff(indptr.cpu().numpy()), statics["ref_code"])
    counts = _row_counts_cuda(x, count_rows, table, is_log1p=is_log1p)

    def group_sums(tab, a, **kw):
        return _grouped_sums_cuda(x, perm, indptr, order, table, tab, a, is_log1p=is_log1p,
                                  work=work, ref_counts=counts, **kw)

    return _contract_counts(counts, group_sums, pads_per_group, mark=mark, **statics)


hist_pass_contract.launches = 0
# The counter's owner, reached without the module's name: a caller may wrap
# ``hist_engine.hist_pass_contract`` from outside (``tail_overlap.py`` does).
_FUSED_ENTRY = hist_pass_contract


def make_hist_tile_fn(
    layout: PaddedLayout,
    *,
    ref_code: int,
    is_log1p: bool,
    device: torch.device,
    v_buckets: int = DEFAULT_V,
    fc_u8_hint: bool = False,
    nnz_split_hint: bool = True,
    pack: bool = True,
    hist_fn=None,
):
    """Histogram-engine tile function with the layout staged on ``device``.

    ``run(x, mark=None)`` returns the tile's packed uint8 buffer on the
    device (``pack=False``: the plain dict of float64 tensors), from
    :func:`hist_pass_contract`: on the card the grouped pass contracts
    each group in shared memory and no (G, V, T) histogram is made.
    ``mark(name)``, when given, is called after the grouped pass
    (``"kernel"``: the counting pass, the (V, T) tables and the fused
    kernel) and after the contraction's (G, T) steps (``"contract"``), so
    the caller can time the kernel, the contraction and the pack apart.  A tile of
    ``T`` columns is packed at ``packed_width(T)`` columns; ``run.unpack``
    and ``run.find_spec`` read such a buffer on the host, and
    ``run._statics`` holds the wire statics of
    :func:`hist_contract_statics`.

    ``hist_fn(x, mark)``, when given, returns ``(hists, counts)``: the
    (G, V, T) histogram, or several whose sum is the tile's, and the tables'
    counts or None (:func:`hist_contract`'s ``counts=``), all on
    ``device``; :func:`hist_contract` then contracts them (``contract_kernel``
    on the card), and ``hist_fn`` does its own ``"kernel"`` mark.  The
    cell-sharded path passes its shards' histograms, unsummed, and in OVR
    their rows' value counts; ``x`` is then whatever that function takes.
    """
    validate_hist_layout(layout)
    arrs = prepare_hist_inputs(layout, v_buckets, is_log1p, device)
    real_counts = real_rows_per_group(layout)
    pass_args = (arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"])
    count_rows = counting_rows(real_counts, arrs["perm"], ref_code)
    work = fused_work(real_counts, ref_code)
    ppg = arrs["ppg"]
    statics = hist_contract_statics(
        layout, ref_code, v_buckets, wire=pack, fc_u8_hint=fc_u8_hint,
        nnz_split_hint=nnz_split_hint,
    )
    contract_kw = {k: v for k, v in statics.items() if k != "compute_fc"}
    contract_kw["n_pad"] = float(layout.n_pad)
    narrow = _narrow_map(statics)
    # Packed width -> pack spec: tiles whose widths round up to the same
    # packed width (a full tile and a short last one, a shard and its
    # warm-up) share one layout, so they share one spec.
    spec_cache: dict[int, list] = {}
    find_spec, match = spec_lookup(spec_cache)

    def _spec_for(t_cols: int):
        width = packed_width(t_cols)
        if width not in spec_cache:
            abstract = hist_contract_abstract(layout.n_groups, width, statics)
            spec = build_pack_spec(abstract, narrow)
            assert_spec_size_unique(spec_cache, width, spec)
            spec_cache[width] = spec
        return spec_cache[width]

    def unpack(buf) -> dict:
        """Standard contract dict (numpy) of a packed host buffer."""
        buf = np.asarray(buf)
        out = unpack_host_buffer(buf, match(buf))
        if "k" in out:  # nnz-split wire -> standard contract
            out = reconstruct_ksplit(out, real_counts, ref_code)
        return out

    def run(x, mark=None):
        if hist_fn is None:
            out = hist_pass_contract(x, *pass_args, ppg, count_rows=count_rows,
                                     is_log1p=is_log1p, mark=mark, work=work,
                                     **contract_kw)
        else:
            hists, counts = hist_fn(x, mark)
            out = hist_contract(hists, ppg, counts=counts, **contract_kw)
            del hists, counts
        if mark is not None:
            mark("contract")
        t_cols = out["overflow_cols"].shape[0]
        if not pack:
            return out
        _spec_for(t_cols)
        return pack_device_outputs(_pad_columns(out, packed_width(t_cols)), narrow)[0]

    run._statics = {"n_pad": float(layout.n_pad), "is_log1p": bool(is_log1p), **statics}
    run._spec_cache = spec_cache
    run._spec_for = _spec_for
    run.unpack = unpack
    run.find_spec = find_spec
    return run
