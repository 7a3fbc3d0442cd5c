"""Histogram-contraction engine: rank statistics without sorting.

Port of ``illico_tpu.ops.hist_engine`` (unpacked path).  Single-cell
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

The histograms come from :func:`hist_pass`, which launches the hand-written
CUDA kernel ``csrc/hist_kernel.cu`` on CUDA tensors and runs its plain torch
version (:func:`hist_pass_plain`) on CPU tensors.  Values outside the table
match nothing; :func:`hist_contract` flags their columns from the totals
(``overflow_cols``) and the runner recomputes those with the sort engine.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from illico_tpu_torch.ops.rank_engine import BLOCK, PaddedLayout

__all__ = [
    "DEFAULT_V",
    "MAX_V",
    "HIST_EXACT_MAX_GROUP",
    "hist_pass",
    "hist_pass_plain",
    "hist_contract",
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

# Group-chunk size of the float64 contraction workspace: hist_contract never
# materializes more than ~this many bytes per float64 (chunk, V, T) temporary.
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


def hist_pass_plain(x, perm, indptr, order, table, *, is_log1p: bool):
    """Plain torch version of the kernel: same bucket rule, a gather and one
    ``scatter_add_`` over the flattened ``(g*V + bucket)*T + j`` index.
    ``order`` only schedules the kernel and does not change the result."""
    del order
    x = _as_float32(x)
    n_groups, v_buckets, t_cols = indptr.numel() - 1, table.numel(), x.shape[1]
    rows = x.index_select(0, perm.long())  # (n_real, T), group-contiguous
    k = torch.round(torch.expm1(rows) if is_log1p else rows)
    ok = (k >= 0) & (k < v_buckets)
    k = torch.where(ok, k, 0).long()
    ok &= table[k] == rows
    grp = torch.repeat_interleave(
        torch.arange(n_groups, device=x.device), torch.diff(indptr)
    )
    cols = torch.arange(t_cols, device=x.device)
    key = ((grp[:, None] * v_buckets + k) * t_cols + cols)[ok]
    out = torch.zeros(n_groups * v_buckets * t_cols, dtype=torch.float32, device=x.device)
    out.scatter_add_(0, key, torch.ones(key.numel(), dtype=torch.float32, device=x.device))
    return out.view(n_groups, v_buckets, t_cols)


def _check(name, t, dtype, ndim, device):
    if t.device != device:
        raise ValueError(f"hist_pass: {name} is on {t.device}, x on {device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"hist_pass: {name} must be a contiguous {ndim}-d {dtype} tensor; "
            f"got {t.dtype} with shape {tuple(t.shape)}"
        )


def _hist_pass_cuda(x, perm, indptr, order, table, *, is_log1p: bool):
    from illico_tpu_torch.utils.cuda_build import load_library

    x = _as_float32(x)
    dev = x.device
    _check("x", x, torch.float32, 2, dev)
    _check("perm", perm, torch.int32, 1, dev)
    _check("indptr", indptr, torch.int64, 1, dev)
    _check("order", order, torch.int32, 1, dev)
    _check("table", table, torch.float32, 1, dev)
    n_groups, v_buckets, t_cols = indptr.numel() - 1, table.numel(), x.shape[1]
    if order.numel() != n_groups:
        raise ValueError(f"hist_pass: order has {order.numel()} groups, indptr {n_groups}")
    if not 1 <= v_buckets <= MAX_V:
        raise ValueError(f"hist_pass: table size {v_buckets} outside [1, {MAX_V}]")
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
    launches ``csrc/hist_kernel.cu`` (counted in ``hist_pass.launches``); a
    CPU tensor takes :func:`hist_pass_plain`.  Any other device raises.
    """
    if x.device.type == "cuda":
        return _hist_pass_cuda(x, perm, indptr, order, table, is_log1p=is_log1p)
    if x.device.type == "cpu":
        return hist_pass_plain(x, perm, indptr, order, table, is_log1p=is_log1p)
    raise ValueError(f"hist_pass: unsupported device {x.device}")


hist_pass.launches = 0


def hist_contract(
    hist,
    pads_per_group,
    *,
    n_pad: float,
    ref_code: int,
):
    """All statistics as exact float64 histogram contractions.

    Same output contract as :func:`illico_tpu_torch.ops.rank_engine.rank_stats_tile`
    plus ``overflow_cols`` (columns where a real row matched no table entry).
    In OVO the reference group's own rows of U2 and tie_seg are zeroed (the
    runner writes sentinels there).  The float64 work runs in group chunks of
    at most ``CONTRACT_CHUNK_BYTES`` per temporary, so device memory holds
    the float32 histogram plus a bounded workspace.  Buckets index the
    integer counts for raw and log1p tables alike, so ``fc_sums`` is exact
    in both.
    """
    f64 = torch.float64
    n_groups, v_buckets, t_cols = hist.shape
    chunk = max(1, CONTRACT_CHUNK_BYTES // max(1, v_buckets * t_cols * 8))
    chunks = [(g0, min(g0 + chunk, n_groups)) for g0 in range(0, n_groups, chunk)]
    out = {}
    n_real = float(n_pad) - pads_per_group.to(f64).sum()
    # (V, T) global value counts, exact.  Summed chunk by chunk: a reduction
    # with dtype=float64 over the whole histogram would first materialize
    # its float64 copy (G x V x T x 8 bytes).
    c = torch.zeros((v_buckets, t_cols), dtype=f64, device=hist.device)
    for g0, g1 in chunks:
        c += hist[g0:g1].to(f64).sum(dim=0)
    out["overflow_cols"] = c.sum(dim=0) < n_real
    ccum_excl = torch.cumsum(c, dim=0) - c
    vals = torch.arange(v_buckets, dtype=f64, device=hist.device)[:, None]

    if ref_code == -1:
        tab = 2.0 * ccum_excl + c + 1.0
        main_key = "R2"
        out["tie_col"] = (c * c * c - c).sum(dim=0)
    else:
        a = hist[ref_code].to(f64)
        tab = 2.0 * (torch.cumsum(a, dim=0) - a) + a
        main_key = "U2"
        out["tie_ref_col"] = (a * a * a - a).sum(dim=0)
        out["tie_seg"] = hist.new_empty((n_groups, t_cols), dtype=f64)
    out[main_key] = hist.new_empty((n_groups, t_cols), dtype=f64)
    out["fc_sums"] = hist.new_empty((n_groups, t_cols), dtype=f64)

    for g0, g1 in chunks:
        h = hist[g0:g1].to(f64)
        out[main_key][g0:g1] = (h * tab).sum(dim=1)
        out["fc_sums"][g0:g1] = (h * vals).sum(dim=1)
        if ref_code != -1:
            out["tie_seg"][g0:g1] = ((h * h * h - h) + 3.0 * a * h * (a + h)).sum(dim=1)
    if ref_code != -1:
        out["U2"][ref_code] = 0.0
        out["tie_seg"][ref_code] = 0.0
    return out


def make_hist_tile_fn(
    layout: PaddedLayout,
    *,
    ref_code: int,
    is_log1p: bool,
    device: torch.device,
    v_buckets: int = DEFAULT_V,
):
    """Histogram-engine tile function with the layout staged on ``device``.

    ``run(x, mark=None)`` returns the plain dict of device tensors;
    ``mark(name)``, when given, is called after the histogram pass so the
    caller can time the kernel and the contraction apart.
    """
    validate_hist_layout(layout)
    arrs = prepare_hist_inputs(layout, v_buckets, is_log1p, device)
    pass_args = (arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"])
    ppg = arrs["ppg"]
    n_pad = float(layout.n_pad)

    def run(x, mark=None):
        hist = hist_pass(x, *pass_args, is_log1p=is_log1p)
        if mark is not None:
            mark("kernel")
        return hist_contract(hist, ppg, n_pad=n_pad, ref_code=ref_code)

    return run
