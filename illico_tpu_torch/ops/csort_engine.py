"""Compact (nonzero-only) sort engine: the sparse tier of the rank path.

Port of ``illico_tpu.ops.csort_engine`` (XLA code there, plain torch here).
Single-cell matrices are mostly zeros, and the zero block
never needs sorting: rank only the nonzeros and add the zero block in
closed form.

- The **host tiler** (:func:`compact_from_entries`, numpy, run on the
  prefetch workers) packs a tile's nonzeros into a dense padded ``(M, T)``
  block (``M`` = the tile's largest column nnz, bucketed to a power of two),
  group-major within each column, plus a per-column group ``indptr``
  ``(G+1, T)``.  Its arrays are byte-identical to the reference tiler's.
- The **device side** (:func:`csort_stats_tile`) sorts only that block,
  computes the per-element rank / pair-count payloads as the sort engine
  does, restores layout order by scatter, and reduces each (group, column)
  segment at per-column boundaries (two-level exact prefix sums + gathers).
- The **zero block** enters in closed form: per (group, column) zero counts
  are ``counts[g] - nnz[g, j]``, and every zero-block statistic is a scalar
  expression in those counts, negative values included (the zero block
  then sits between the negative and the positive nonzeros).

Exact for any float32/float64 data (scanpy's ``normalize_total`` + ``log1p``
output included).  Output contract: that of
:func:`illico_tpu_torch.ops.rank_engine.rank_stats_tile`, so the runner's
consume tail is shared.

Ordering: the reference sorts the OVO block on (value, group).  One stable
value sort gives the same order, because real entries are group-ascending
within each column and the pads (``+inf``, group ``G``) come last; NaN
sorts after the pads in both, and each NaN is its own tie block.
"""

from __future__ import annotations

import numpy as np
import torch

from illico_tpu_torch.ops.rank_engine import (
    _block_starts,
    _ref_counts,
    _sub_block_sizes,
    _tie_blocks,
    _to_layout_order,
    _twice_rank,
)

from illico_tpu_torch.ops.wire import (
    _WIRE_COUNT_ALIGN,
    Abstract,
    _narrow_map,
    _pick_split_dtype,
    assert_spec_size_unique,
    build_pack_spec,
    spec_lookup,
    unpack_host_buffer,
)

__all__ = [
    "CompactTile",
    "compact_from_entries",
    "csort_narrow_statics",
    "csort_stats_tile",
    "make_csort_tile_fn",
    "make_rank_unpackers",
    "rank_output_abstract",
]

# Per-element integer payloads are bounded by 3*n_total + 2; a 32-row
# partial sum must fit int32 (same scheme as rank_engine._I32_SAFE_N_PAD).
_SEG_BLOCK = 32
_I32_SAFE_N_TOTAL = (2**31 // _SEG_BLOCK - 3) // 3
# Payloads carry 2 * (zero count): int32 wraps once n_total reaches this,
# so the payloads widen to float64 there (exact below 2**53).
_WIDE_PAYLOAD_N_TOTAL = 2**30


class CompactTile:
    """Compacted tile: nonzeros only, group-major per column.

    Attributes (numpy on the host, tensors once staged)
    ----------
    vals : (M, T) float32/float64 — nonzero values; pad slots hold +inf.
        Column ``j``'s real entries occupy rows ``[0, indptr[G, j])``,
        grouped by ascending group code.
    grp : (M, T) uint16 — group code per slot (``G`` on pads); None for OVR
        (the OVR algebra needs only the boundaries).
    indptr : (G+1, T) int32 — per-column group segment bounds.
    """

    __slots__ = ("vals", "grp", "indptr", "t_cols")

    def __init__(self, vals, grp, indptr, t_cols):
        self.vals = vals
        self.grp = grp
        self.indptr = indptr
        self.t_cols = t_cols


def _bucket_rows(m_max: int) -> int:
    """Row-count bucket: next power of two, at least ``_SEG_BLOCK``."""
    m = max(int(m_max), 1)
    b = _SEG_BLOCK
    while b < m:
        b *= 2
    return b


def _stable_argsort(key: np.ndarray, n_keys: int) -> np.ndarray:
    """``np.argsort(key, kind="stable")`` for non-negative integer keys
    below ``n_keys``, as LSD radix passes over 16-bit digits: numpy
    radix-sorts 16-bit integers but takes timsort for wider ones
    (``chip_smoke.py`` phase 7 times both).  Wider key ranges keep the
    plain sort."""
    if n_keys <= 1 << 16:
        return np.argsort(key.astype(np.uint16), kind="stable")
    if n_keys > 1 << 32:
        return np.argsort(key, kind="stable")
    order = np.argsort((key & 0xFFFF).astype(np.uint16), kind="stable")
    high = (key[order] >> 16).astype(np.uint16)
    return order[np.argsort(high, kind="stable")]


def compact_from_entries(
    v: np.ndarray,
    r: np.ndarray,
    c: np.ndarray,
    t_cols: int,
    group_codes: np.ndarray,
    n_groups: int,
    value_dtype=np.float32,
    need_grp: bool = True,
) -> CompactTile:
    """Build a :class:`CompactTile` from (value, row, col) nonzero entries.

    ``group_codes`` maps original row -> group code
    (``GroupInfo.encoded_groups``).  Explicit stored zeros are dropped: they
    belong to the closed-form zero block.  Entries may arrive in any order;
    a stable radix argsort on a combined int32 (column, group) key makes
    them (column, group)-contiguous.
    """
    nz = v != 0
    if not nz.all():
        v, r, c = v[nz], r[nz], c[nz]
    g = group_codes[r]
    # int32 keys whenever the bounds allow: int64 passes over ~10M entries
    # cost more than the sort itself.
    idx_t = np.int32 if n_groups * t_cols < 2**31 and v.size < 2**31 else np.int64
    c = c.astype(idx_t, copy=False)
    key = c * idx_t(n_groups) + g.astype(idx_t)
    # Counts do not depend on entry order: bincount the unsorted key.
    cnt_gc = np.ascontiguousarray(
        np.bincount(key, minlength=n_groups * t_cols)
        .reshape(t_cols, n_groups).T
    )
    order = _stable_argsort(key, n_groups * t_cols)
    c_s = c[order]
    v_s = v[order]

    col_nnz = cnt_gc.sum(axis=0)
    m_pad = _bucket_rows(col_nnz.max() if col_nnz.size else 0)

    # Scatter targets live in [0, m_pad * t_cols): widen if the padded tile
    # is larger than the key-domain bound that picked idx_t.
    tgt_t = idx_t if m_pad * t_cols < 2**31 else np.int64
    col_start = np.zeros(t_cols + 1, dtype=tgt_t)
    np.cumsum(col_nnz, out=col_start[1:])
    tgt = np.arange(c_s.size, dtype=tgt_t) - col_start[c_s]
    tgt *= tgt_t(t_cols)
    tgt += c_s

    vals = np.full((m_pad, t_cols), np.inf, dtype=value_dtype)
    vals.ravel()[tgt] = v_s.astype(value_dtype)
    grp = None
    if need_grp:
        grp = np.full((m_pad, t_cols), n_groups, dtype=np.uint16)
        grp.ravel()[tgt] = g.astype(np.uint16)[order]

    indptr = np.zeros((n_groups + 1, t_cols), dtype=np.int32)
    np.cumsum(cnt_gc, axis=0, out=indptr[1:])
    return CompactTile(vals, grp, indptr, t_cols)


def _colwise_segment_sum(q, indptr, *, exact_int: bool):
    """(G, T) segment sums of a column-major ``q`` (T, M) at per-column
    boundaries; every prefix sum runs along the innermost dim.

    ``exact_int``: q is int32 with 32-row partial sums provably inside
    int32; int32 within-block partials plus a float64 block prefix keep
    every integer exact below 2**53.
    """
    t, m = q.shape
    idx = indptr.t().long()  # (T, G+1)
    if exact_int:
        nb = m // _SEG_BLOCK
        qb = q.reshape(t, nb, _SEG_BLOCK)
        within = qb.sum(dim=2, dtype=torch.int32)  # (T, nb)
        blk_css = torch.cat(
            [within.new_zeros((t, 1), dtype=torch.float64),
             torch.cumsum(within.to(torch.float64), dim=1)], dim=1
        )  # (T, nb+1)
        pre_excl = (torch.cumsum(qb, dim=2, dtype=torch.int32) - qb).reshape(t, m)
        # Position M pairs with blk_css[:, nb] (M is a block multiple).
        pre_ext = torch.cat([pre_excl, pre_excl.new_zeros((t, 1))], dim=1)
        a = torch.gather(blk_css, 1, idx // _SEG_BLOCK)
        b = torch.gather(pre_ext, 1, idx).to(torch.float64)
        css_at = a + b
    else:
        css = torch.cat(
            [q.new_zeros((t, 1), dtype=torch.float64),
             torch.cumsum(q.to(torch.float64), dim=1)], dim=1
        )
        css_at = torch.gather(css, 1, idx)
    # (G, T) strides even when T is 0, which contiguous() would keep as they are.
    return (css_at[:, 1:] - css_at[:, :-1]).t().clone(memory_format=torch.contiguous_format)


def csort_narrow_statics(counts: np.ndarray, ref_code: int) -> dict:
    """Wire tiers for the packed rank-contract output, proven by group-size
    bounds; equal to the reference package's.

    Integer statistics (U2/R2, tie sums) pick the narrowest faithful
    encoding: the int32 device cast below 2**31, split-word tiers (u40/f48)
    below 2**48, the 8-byte word split below 2**63, f96 beyond.  fc sums are
    arbitrary floats here, so they always ride the f96 triple.
    """
    c = np.asarray(counts, dtype=np.float64)
    n = float(c.sum())

    def pick(bound: float) -> str:
        # The arrays stay float64 on the device except for the int32 cast.
        d = _pick_split_dtype(bound)
        return "int32" if d in ("uint16", "uint24", "int32") else d

    if ref_code == -1:
        u2_dtype = pick(2.0 * n * (c.max() if c.size else 0.0))
        tie_dtype = "float64"  # no (G, T) tie array in OVR
        tiecol_dtype = "f96" if n**3 >= 2.0**63 else "float64"
    else:
        others = np.delete(c, ref_code)
        m_max = others.max() if others.size else 0.0
        r = c[ref_code]
        u2_dtype = pick(2.0 * r * m_max)
        tie_dtype = pick((m_max**3 - m_max) + 3.0 * r * m_max * (r + m_max))
        tiecol_dtype = "f96" if r**3 >= 2.0**63 else "float64"
    return dict(u2_dtype=u2_dtype, tie_dtype=tie_dtype, tiecol_dtype=tiecol_dtype)


def _narrow_for(t_cols: int, g_rows: int, narrow_statics: dict, ref_code: int) -> dict:
    """Pack-narrowing map for a rank-contract tile, alignment-checked.

    Split-word tiers (u40/f48) need element counts divisible by 4/2 to keep
    later pack blocks aligned, and these tiles keep the caller's width,
    which can be odd for small inputs.  Misaligned keys fall back to the
    natural 8-byte word split, always valid since every split tier's bound
    is below 2**63 by construction.
    """
    narrow = _narrow_map(dict(fc_dtype="f96", ref_code=ref_code, **narrow_statics))
    narrow["fc_sums"] = 12  # non-integer float64: f96, always
    bulk = g_rows * t_cols
    sizes = {
        "R2": bulk, "U2": bulk, "tie_seg": bulk, "fc_sums": bulk,
        "tie_col": t_cols, "tie_ref_col": t_cols,
    }
    for k, wb in list(narrow.items()):
        if sizes.get(k, 0) % _WIRE_COUNT_ALIGN.get(wb, 1):
            del narrow[k]
    return narrow


def rank_output_abstract(t_cols: int, g_rows: int, ref_code: int, narrow_statics: dict) -> dict:
    """Shapes and numpy dtypes of the packed rank-stats contract (R2/tie_col
    OVR; U2/tie_seg/tie_ref_col OVO; fc_sums; overflow_cols), shared by the
    compact and full sort engines.  "int32" is a real device cast; the
    split and f96 tiers stay float64."""
    f64, i32 = np.dtype(np.float64), np.dtype(np.int32)
    bulk, col = (g_rows, t_cols), (t_cols,)
    u2d = i32 if narrow_statics["u2_dtype"] == "int32" else f64
    out = {
        "overflow_cols": Abstract(col, np.dtype(np.bool_)),
        "fc_sums": Abstract(bulk, f64),
    }
    if ref_code == -1:
        out["R2"] = Abstract(bulk, u2d)
        out["tie_col"] = Abstract(col, f64)
    else:
        out["U2"] = Abstract(bulk, u2d)
        out["tie_seg"] = Abstract(bulk, i32 if narrow_statics["tie_dtype"] == "int32" else f64)
        out["tie_ref_col"] = Abstract(col, f64)
    return out


def make_rank_unpackers(g_rows: int, ref_code: int, narrow_statics: dict):
    """(spec_cache, _spec_for, find_spec, unpack) for a rank-contract
    engine's packed wire, keyed by tile width."""
    spec_cache: dict = {}
    find_spec, match = spec_lookup(spec_cache)

    def _spec_for(t_cols: int):
        if t_cols not in spec_cache:
            spec = build_pack_spec(
                rank_output_abstract(t_cols, g_rows, ref_code, narrow_statics),
                _narrow_for(t_cols, g_rows, narrow_statics, ref_code),
            )
            assert_spec_size_unique(spec_cache, t_cols, spec)
            spec_cache[t_cols] = spec
        return spec_cache[t_cols]

    def unpack(buf) -> dict:
        buf = np.asarray(buf)
        return unpack_host_buffer(buf, match(buf))

    return spec_cache, _spec_for, find_spec, unpack


def csort_stats_tile(
    vals,
    grp,
    indptr,
    counts,
    *,
    ref_code: int,
    is_log1p: bool,
    n_total: int,
    u2_dtype: str = "float64",
    tie_dtype: str = "float64",
    tiecol_dtype: str = "float64",
    pack: bool = False,
):
    """Rank statistics of a compacted tile; zero block in closed form.

    Parameters
    ----------
    vals : (M, T) float32/float64 — compacted nonzeros (+inf pads),
        (column, group)-contiguous.
    grp : (M, T) integer — group code per slot (G on pads).  Read only by
        the OVO sub-block tie terms; OVR callers may pass None.
    indptr : (G+1, T) int32 — per-column group boundaries.
    counts : (G,) integer — total cells per group (zeros included).
    n_total : total cells (zeros included).
    u2_dtype / tie_dtype / tiecol_dtype : wire tiers from
        :func:`csort_narrow_statics`, read only with ``pack=True``, which
        returns the tile's packed uint8 buffer instead of the dict.

    Returns the :func:`rank_engine.rank_stats_tile` contract as float64
    tensors.  In OVO the reference group's own U2/tie_seg rows are zeroed
    (the consumer writes sentinels there).
    """
    if pack:
        from illico_tpu_torch.ops.rank_engine import _packed_rank_stats

        out = csort_stats_tile(
            vals, grp, indptr, counts, ref_code=ref_code, is_log1p=is_log1p, n_total=n_total
        )
        statics = dict(u2_dtype=u2_dtype, tie_dtype=tie_dtype, tiecol_dtype=tiecol_dtype)
        return _packed_rank_stats(
            out, vals.shape[1], ref_code=ref_code, u2_dtype=u2_dtype, tie_dtype=tie_dtype,
            narrow=_narrow_for(vals.shape[1], indptr.shape[0] - 1, statics, ref_code),
        )
    if vals.dtype not in (torch.float32, torch.float64):
        vals = vals.to(torch.float32)
    m_pad, t_cols = vals.shape
    exact_int = n_total <= _I32_SAFE_N_TOTAL
    wide_payload = n_total >= _WIDE_PAYLOAD_N_TOTAL
    f64 = torch.float64

    def _int_seg(q):
        if exact_int:
            return _colwise_segment_sum(q, indptr, exact_int=True)
        return _colwise_segment_sum(q.to(f64), indptr, exact_int=False)

    counts = counts.to(f64)  # (G,)
    nnz_g = (indptr[1:] - indptr[:-1]).to(f64)  # (G, T)
    m_real = indptr[-1]  # (T,)
    n0 = float(n_total) - m_real.to(f64)  # (T,) zeros per column
    # Column-major from here on, (T, M), as in the sort engine.
    vals = vals.t().contiguous()
    rows = torch.arange(m_pad, dtype=torch.int32, device=vals.device)[None, :]
    real_mask = rows < m_real[:, None]  # layout-order real slots

    expr = torch.expm1(vals) if is_log1p else vals
    expr = torch.where(real_mask, expr, 0.0).to(f64)
    out = {"fc_sums": _colwise_segment_sum(expr, indptr, exact_int=False)}

    sv, spos = torch.sort(vals, dim=1, stable=True)
    starts = _block_starts(sv)
    start, end = _tie_blocks(starts)
    pad_sorted = torch.isinf(sv)
    zero_g = counts[:, None] - nnz_g  # (G, T) zeros per group and column

    if ref_code == -1:
        # 2x global tie-averaged rank of a nonzero: within-nonzeros rank
        # offset by the zeros below it (positives only).
        r2 = _twice_rank(start, end)
        if wide_payload:
            r2 = r2.to(f64) + torch.where(sv > 0, 2.0 * n0[:, None], 0.0)
        else:
            n0_i = n0.to(torch.int32)
            r2 = r2 + torch.where(sv > 0, 2 * n0_i[:, None], 0)
        n_neg = (sv < 0).to(f64).sum(dim=1)  # (T,)
        t_blk = (end - start).to(f64)
        tie_el = torch.where(pad_sorted, 0.0, t_blk * t_blk - 1.0)
        out["tie_col"] = tie_el.sum(dim=1) + (n0 * n0 - 1.0) * n0
        (r2_l,) = _to_layout_order(spos, r2)
        r2_nz = _int_seg(torch.where(real_mask, r2_l, 0))
        # Zero block: 2x average rank of a zero = 2*n_neg + n0 + 1.
        out["R2"] = r2_nz + zero_g * (2.0 * n_neg + n0 + 1.0)[None, :]
        return out

    sg = torch.gather(grp.t(), 1, spos)
    isref = sg == ref_code
    # Reference nonzeros strictly below my tie block, and inside it.
    ref_less, ref_eq = _ref_counts(isref, start, end)
    # Reference zero / negative-nonzero counts per column.
    nnz_ref = (indptr[ref_code + 1] - indptr[ref_code]).to(f64)  # (T,)
    n0r = counts[ref_code] - nnz_ref  # (T,)
    refnz_neg = (isref & (sv < 0)).to(f64).sum(dim=1)  # (T,)
    # 2x per-element U_tgt contribution of a nonzero target: reference
    # nonzeros strictly below + reference zeros below (positives only),
    # each twice, + tied reference nonzeros once.
    if wide_payload:
        qu2 = (2 * ref_less + ref_eq).to(f64) + torch.where(sv > 0, 2.0 * n0r[:, None], 0.0)
    else:
        n0r_i = n0r.to(torch.int32)
        qu2 = 2 * ref_less + ref_eq + torch.where(sv > 0, 2 * n0r_i[:, None], 0)
    # (value, group) sub-block size t for the 3at(a+t) + (t^3-t) tie terms.
    t_sub = _sub_block_sizes(starts, sg).to(f64)
    a_ref = ref_eq.to(f64)
    q_tie = (t_sub * t_sub - 1.0) + 3.0 * a_ref * (a_ref + t_sub)
    ref_term = torch.where(pad_sorted | ~isref, 0.0, a_ref * a_ref - 1.0)
    out["tie_ref_col"] = ref_term.sum(dim=1) + (n0r * n0r - 1.0) * n0r
    qu2_l, qtie_l = _to_layout_order(spos, qu2, q_tie)
    u2_nz = _int_seg(torch.where(real_mask, qu2_l, 0))
    tie_nz = _colwise_segment_sum(
        torch.where(real_mask, qtie_l, 0.0), indptr, exact_int=False
    )
    # Zero-block pair counts: a target zero sees every negative reference
    # nonzero strictly below it and ties the n0r reference zeros.
    u2 = u2_nz + zero_g * (2.0 * refnz_neg + n0r)[None, :]
    # Zero-block tie terms: (t0^3 - t0) + 3*a0*t0*(a0 + t0) with a0 = n0r
    # (the a0^3 - a0 part is in tie_ref_col above).
    n0r_b = n0r[None, :]
    tie = tie_nz + (
        (zero_g * zero_g - 1.0) * zero_g + 3.0 * n0r_b * zero_g * (n0r_b + zero_g)
    )
    u2[ref_code] = 0.0
    tie[ref_code] = 0.0
    out["U2"] = u2
    out["tie_seg"] = tie
    return out


def make_csort_tile_fn(group_info, *, ref_code: int, is_log1p: bool, device,
                       pack: bool = True):
    """Tile function over :class:`CompactTile` inputs, with the group
    counts staged once on ``device``.

    The tile's arrays may be numpy (copied to ``device`` here) or tensors
    already there.  ``grp`` may arrive as uint16 or as its int16 view (the
    runner stages the view: torch's uint16 has few device ops); either is
    widened to int32 on the device.  ``run(tile, mark=None)`` returns the
    tile's packed uint8 buffer (``run.unpack`` and ``run.find_spec`` read it
    on the host), or with ``pack=False`` the plain dict of device tensors;
    ``mark("kernel")``, when given, is called between the statistics and
    the pack.
    """
    from illico_tpu_torch.ops.rank_engine import _packed_rank_stats

    counts = torch.from_numpy(np.asarray(group_info.counts, np.int64)).to(device)
    n_total = int(group_info.n_cells)
    ref_code = int(ref_code)
    g_rows = int(group_info.n_groups)
    narrow_statics = csort_narrow_statics(group_info.counts, ref_code)
    spec_cache, _spec_for, find_spec, unpack = make_rank_unpackers(
        g_rows, ref_code, narrow_statics
    )

    def _dev(a):
        if isinstance(a, np.ndarray):
            if a.dtype == np.uint16:
                a = a.view(np.int16)
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(device)

    def run(tile: CompactTile, mark=None):
        grp = None
        if tile.grp is not None:
            grp = _dev(tile.grp).to(torch.int32) & 0xFFFF
        vals = _dev(tile.vals)
        out = csort_stats_tile(
            vals, grp, _dev(tile.indptr), counts,
            ref_code=ref_code, is_log1p=bool(is_log1p), n_total=n_total,
        )
        if mark is not None:
            mark("kernel")
        if not pack:
            return out
        t_cols = vals.shape[1]
        _spec_for(t_cols)
        return _packed_rank_stats(
            out, t_cols, ref_code=ref_code,
            u2_dtype=narrow_statics["u2_dtype"], tie_dtype=narrow_statics["tie_dtype"],
            narrow=_narrow_for(t_cols, g_rows, narrow_statics, ref_code),
        )

    run._statics = dict(
        ref_code=ref_code, is_log1p=bool(is_log1p), n_total=n_total,
        pack=bool(pack), **narrow_statics,
    )
    run._spec_cache = spec_cache
    run.unpack = unpack
    run.find_spec = find_spec
    return run
