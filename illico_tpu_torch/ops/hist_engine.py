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

The histograms come from :func:`hist_pass`, which launches the hand-written
CUDA kernel ``csrc/hist_kernel.cu`` on CUDA tensors and runs its plain torch
version (:func:`hist_pass_plain`) on CPU tensors.  Values outside the table
match nothing; :func:`hist_contract` flags their columns from the totals
(``overflow_cols``) and the runner recomputes those with the sort engine.

The statistics of a tile leave the device as one ``uint8`` buffer on the
packed wire of :mod:`illico_tpu_torch.ops.wire` (its names are re-exported
here, where the reference package keeps them): :func:`hist_contract_statics`
proves from the group sizes how few bytes each statistic needs, and
``hist_contract(pack=True)`` narrows and packs them on the tile's device.
"""

from __future__ import annotations

import ctypes

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
    ``hist_pass.v_buckets`` is the value-table size V of the latest call on
    either device (None before the first).
    """
    hist_pass.v_buckets = table.numel()
    if x.device.type == "cuda":
        return _hist_pass_cuda(x, perm, indptr, order, table, is_log1p=is_log1p)
    if x.device.type == "cpu":
        return hist_pass_plain(x, perm, indptr, order, table, is_log1p=is_log1p)
    raise ValueError(f"hist_pass: unsupported device {x.device}")


hist_pass.launches = 0
hist_pass.v_buckets = None


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


def hist_contract(
    hist,
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
):
    """All statistics as exact float64 histogram contractions.

    Same output contract as :func:`illico_tpu_torch.ops.rank_engine.rank_stats_tile`
    plus ``overflow_cols`` (columns where a real row matched no table entry).
    In OVO the reference group's own rows of U2 and tie_seg are zeroed (the
    runner writes sentinels there), which is what makes narrow encodings
    bounded by the other groups' sizes sound.  The float64 work runs in
    group chunks of at most ``CONTRACT_CHUNK_BYTES`` per temporary, so
    device memory holds the float32 histogram plus a bounded workspace.
    Buckets index the integer counts for raw and log1p tables alike, so
    ``fc_sums`` is exact in both.

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
    f64 = torch.float64
    n_groups, v_buckets, t_cols = hist.shape
    chunk = max(1, CONTRACT_CHUNK_BYTES // max(1, v_buckets * t_cols * 8))
    chunks = [(g0, min(g0 + chunk, n_groups)) for g0 in range(0, n_groups, chunk)]
    ovr = ref_code == -1
    fc_u8 = bool(nnz_split and fc_u8)
    out = {}
    n_real = float(n_pad) - pads_per_group.to(f64).sum()
    # (V, T) global value counts, exact.  Summed chunk by chunk: a reduction
    # with dtype=float64 over the whole histogram would first materialize
    # its float64 copy (G x V x T x 8 bytes).
    c = torch.zeros((v_buckets, t_cols), dtype=f64, device=hist.device)
    for g0, g1 in chunks:
        c += hist[g0:g1].to(f64).sum(dim=0)
    out["overflow_cols"] = c.sum(dim=0) < n_real
    vals = torch.arange(v_buckets, dtype=f64, device=hist.device)[:, None]

    if ovr:
        tab = 2.0 * (torch.cumsum(c, dim=0) - c) + c + 1.0
        tie_col = (c * c * c - c).sum(dim=0)
    else:
        a = hist[ref_code].to(f64)
        tie_col = (a * a * a - a).sum(dim=0)
        if nnz_split:  # nonzero buckets only: the v=0 plane is rebuilt on the host
            a = a.clone()
            a[0] = 0.0
        tab = 2.0 * (torch.cumsum(a, dim=0) - a) + a
        tie = hist.new_empty((n_groups, t_cols), dtype=f64)
    main = hist.new_empty((n_groups, t_cols), dtype=f64)
    fc_sums = hist.new_empty((n_groups, t_cols), dtype=f64)
    k = hist.new_empty((n_groups, t_cols), dtype=f64) if nnz_split else None

    for g0, g1 in chunks:
        h = hist[g0:g1].to(f64)
        fc_sums[g0:g1] = (h * vals).sum(dim=1)
        if nnz_split:
            h[:, 0, :] = 0.0
            k[g0:g1] = h.sum(dim=1)
        main[g0:g1] = (h * tab).sum(dim=1)
        if not ovr:
            tie[g0:g1] = ((h * h * h - h) + 3.0 * a * h * (a + h)).sum(dim=1)

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
    device (``pack=False``: the plain dict of float64 tensors).
    ``mark(name)``, when given, is called after the histogram pass
    (``"kernel"``) and after the contraction (``"contract"``), so the caller
    can time the kernel, the contraction and the pack apart.  A tile of
    ``T`` columns is packed at ``packed_width(T)`` columns; ``run.unpack``
    and ``run.find_spec`` read such a buffer on the host, and
    ``run._statics`` holds the wire statics of
    :func:`hist_contract_statics`.

    ``hist_fn(x, mark)``, when given, takes the place of :func:`hist_pass`
    and does its own stage marks: the cell-sharded path passes the sum of
    its shards' histograms, on ``device``, and ``x`` is then whatever that
    function takes.
    """
    validate_hist_layout(layout)
    arrs = prepare_hist_inputs(layout, v_buckets, is_log1p, device)
    pass_args = (arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"])
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
    real_counts = real_rows_per_group(layout)

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
        if hist_fn is not None:
            hist = hist_fn(x, mark)
        else:
            hist = hist_pass(x, *pass_args, is_log1p=is_log1p)
            if mark is not None:
                mark("kernel")
        t_cols = hist.shape[2]
        out = hist_contract(hist, ppg, **contract_kw)
        del hist
        if mark is not None:
            mark("contract")
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
