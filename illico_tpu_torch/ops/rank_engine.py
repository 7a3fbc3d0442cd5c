"""Sort engine: one global sort per column serves every group.

Port of ``illico_tpu.ops.rank_engine`` (which is XLA code, not a Pallas
kernel) to plain torch ops.  It serves float64 inputs, non-count data and
the histogram engine's overflow columns.

- **OVR**: global tie-averaged ranks from the sorted column, then exact
  per-group rank sums over the group-contiguous padded layout.
- **OVO**: for the pair (ref, g), ``U_tgt = #{(r,e): r in ref, e in g, r < e}
  + 0.5 * #{r == e}``; both counts are per-element prefix quantities of the
  same global sort, so every group's U against the reference comes from one
  sort.  Tie sums decompose per value block as
  ``(a+t)^3-(a+t) = (a^3-a) + (t^3-t) + 3at(a+t)``.

Layout contract: rows are permuted so groups are contiguous, and each group
segment is padded to a multiple of ``BLOCK`` rows with +inf sentinel rows
that sort last in every column and carry zero payloads.  Per-group sums are
int32 within-block sums (exact) plus a float64 cross-block cumsum (exact
below 2^53).

Ordering: the reference sorts by (value, group) with ``lax.sort(num_keys=2)``.
Here one *stable* ``torch.sort`` on value does the same, because the padded
layout's ``grp`` never decreases along the row axis: equal values keep row
order, hence group order.  Only tie-block boundaries matter downstream, so
the two agree exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "BLOCK",
    "PaddedLayout",
    "build_padded_layout",
    "rank_stats_tile",
    "make_tile_fn",
]

# Rows per segment-sum block. Group segments are padded to a multiple of this,
# so within-block partial sums never cross a group boundary.
BLOCK = 32

_I32_MAX = 2**31 - 1

# Largest padded row count for which the int32 block-partial segment sums
# are provably exact: per-element integer payloads are bounded by
# 3*n_pad + 2, and a BLOCK-row partial sum of them must stay below 2^31.
# Beyond this (~22M rows) the segment sums switch to float64.
_I32_SAFE_N_PAD = (2**31 // BLOCK - 3) // 3


class PaddedLayout(NamedTuple):
    """Static (host-side) description of the group-contiguous padded layout."""

    perm: np.ndarray          # (n_pad,) int32: source row per padded slot; -1 = pad
    grp: np.ndarray           # (n_pad,) int32: group code per padded slot
    pad_mask: np.ndarray      # (n_pad,) bool: True on pad slots
    block_starts: np.ndarray  # (n_groups,) int32: first block index of each group
    block_ends: np.ndarray    # (n_groups,) int32: one-past-last block index
    n_cells: int
    n_groups: int

    @property
    def n_pad(self) -> int:
        return int(self.perm.size)


def build_padded_layout(perm: np.ndarray, indptr: np.ndarray, block: int = BLOCK) -> PaddedLayout:
    """Pad each group's contiguous segment to a multiple of ``block`` rows."""
    n_groups = indptr.size - 1
    counts = np.diff(indptr)
    padded_counts = ((counts + block - 1) // block) * block
    # Groups with zero rows keep zero blocks.
    out_indptr = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(padded_counts, out=out_indptr[1:])
    n_pad = int(out_indptr[-1])

    perm_pad = np.full(n_pad, -1, dtype=np.int32)
    grp_pad = np.full(n_pad, n_groups, dtype=np.int32)
    for g in range(n_groups):
        s, e = int(indptr[g]), int(indptr[g + 1])
        os = int(out_indptr[g])
        perm_pad[os : os + (e - s)] = perm[s:e]
        grp_pad[os : int(out_indptr[g + 1])] = g

    return PaddedLayout(
        perm=perm_pad,
        grp=grp_pad,
        pad_mask=perm_pad < 0,
        block_starts=(out_indptr[:-1] // block).astype(np.int32),
        block_ends=(out_indptr[1:] // block).astype(np.int32),
        n_cells=int(indptr[-1]),
        n_groups=int(n_groups),
    )


def _segment_sum(q, block_starts, block_ends, within_dtype):
    """(G, T) per-group sums of a column-major ``(T, n_pad)`` payload over
    block-aligned segments: within-block sums in ``within_dtype`` (int32:
    exact for bounded payloads), then a float64 cumsum across blocks along
    the innermost dim, and constant-index differences."""
    t, n_pad = q.shape
    within = q.reshape(t, n_pad // BLOCK, BLOCK).sum(dim=2, dtype=within_dtype)
    cross = torch.cumsum(within.to(torch.float64), dim=1)
    css = torch.cat([cross.new_zeros((t, 1)), cross], dim=1)
    out = css[:, block_ends.long()] - css[:, block_starts.long()]
    # clone, not contiguous(): an empty (G, 0) result must get (G, T) strides too.
    return out.t().clone(memory_format=torch.contiguous_format)


def _block_starts(sv):
    """True where an element of a ``(T, n)`` tile sorted along its rows
    starts its tie block: at each value change and at each row's first
    element, so that no block runs on across rows once the tile is
    flattened."""
    brk = sv[:, 1:] != sv[:, :-1]
    return torch.cat([brk.new_ones((sv.shape[0], 1)), brk], dim=1)


def _tie_blocks(starts):
    """Flat bounds of every element's block in a ``(T, n)`` tile whose
    blocks begin where ``starts`` is True (and at least at each row's first
    element): ``(start, end)``, each ``(T, n)``, the flat position (into
    the row-major tile) of the block's first element and one past its
    last.  Parallel throughout: one 1-D cumsum numbers the blocks, one
    scatter records where each begins, two gathers read it back.  int32
    positions while the tile has fewer than 2**31 - 1 elements, else int64.
    """
    t, n = starts.shape
    total = t * n
    idt = torch.int32 if total < _I32_MAX else torch.int64
    flat = starts.reshape(-1)
    bid = torch.cumsum(flat, 0, dtype=idt) - 1  # each element's block number
    pos = torch.arange(total, dtype=idt, device=flat.device)
    # bounds[b] is where block b begins and bounds[n_blocks] stays total.
    # An element that begins no block is the (pos - bid)-th such element, so
    # it writes to a slot of its own past n_blocks: no two writes collide,
    # and the number of blocks never has to reach the host.
    slot = torch.where(flat, bid, (total + 1) - pos + bid)
    bounds = torch.full((total + 1,), total, dtype=idt, device=flat.device)
    bounds.index_put_((slot,), pos)
    start = bounds.index_select(0, bid).view(t, n)
    end = bounds.index_select(0, bid + 1).view(t, n)
    return start, end


def _ref_counts(isref, start, end):
    """``(ref_less, ref_eq)``, int32 ``(T, n)``: per element of a sorted
    tile, the reference elements of its row strictly below its tie block
    and inside it, from one 1-D cumsum of ``isref`` read at the block
    bounds of :func:`_tie_blocks`."""
    t, n = isref.shape
    cum = torch.cumsum(isref.reshape(-1), 0, dtype=start.dtype)
    cex = torch.cat([cum.new_zeros(1), cum])  # reference elements before each position
    below = cex.index_select(0, start.reshape(-1)).view(t, n)
    ref_eq = cex.index_select(0, end.reshape(-1)).view(t, n) - below
    ref_less = below - cex[: t * n : n, None]  # less those of the rows before
    return ref_less.to(torch.int32), ref_eq.to(torch.int32)


def _twice_rank(start, end):
    """2x the 1-based tie-averaged rank of each element within its row,
    first + last + 2, from the flat bounds of :func:`_tie_blocks` (exact
    int32)."""
    t, n = start.shape
    base = torch.arange(t, dtype=start.dtype, device=start.device)[:, None] * n
    return ((start - base) + (end - base) + 1).to(torch.int32)


def _sub_block_sizes(starts, sg):
    """Size of each element's (value, group) sub-block in a sorted
    ``(T, n)`` tile: its tie block, cut again where the group code changes."""
    sub = starts.clone()
    sub[:, 1:] |= sg[:, 1:] != sg[:, :-1]
    start, end = _tie_blocks(sub)
    return end - start


def _to_layout_order(spos, *payloads):
    """Scatter sorted-order payloads back to layout order along the rows
    (``spos`` is a permutation of each row's positions)."""
    return [torch.empty_like(p).scatter_(1, spos, p) for p in payloads]


def rank_stats_tile(
    x_raw,
    perm,
    grp,
    pad_mask,
    block_starts,
    block_ends,
    *,
    ref_code: int,
    is_log1p: bool,
):
    """Per-tile rank statistics; same contract as the reference function
    (with ``compute_fc=True``, the only setting the runner uses).

    Parameters
    ----------
    x_raw : (n_cells, T) tile of expression values (original row order).
    perm : (n_pad,) int32 — padded permutation (pads clipped to 0, masked).
    grp : (n_pad,) int32 — group code per padded slot.
    pad_mask : (n_pad,) bool.
    block_starts / block_ends : (G,) int32 — segment bounds in blocks.
    ref_code : -1 selects OVR, otherwise OVO against that group.
    is_log1p : expm1 data before summing expression for fold change.

    Returns a dict of small float64 tensors:
      OVR: R2 (2x rank sums, exact) (G, T), tie_col (T,)
      OVO: U2 (2x U_tgt, exact) (G, T), tie_seg (G, T), tie_ref_col (T,)
      both: fc_sums (G, T).

    The tile is worked column-major, ``(T, n_pad)``, so that every scan
    runs along the innermost dim or over the flattened tile; torch runs a
    scan along an outer dim with one thread per column.
    """
    # Narrow wire dtypes are cast on the device: exact for integers below
    # 2**24 and for every float16 value.
    if x_raw.dtype not in (torch.float32, torch.float64):
        x_raw = x_raw.to(torch.float32)
    n_pad = perm.shape[0]
    int_within = torch.int32 if n_pad <= _I32_SAFE_N_PAD else torch.float64

    gathered = x_raw.index_select(0, perm.clamp(0, x_raw.shape[0] - 1).long()).t().contiguous()
    pad2d = pad_mask[None, :]
    xp = torch.where(pad2d, torch.inf, gathered)

    expr = torch.expm1(gathered) if is_log1p else gathered
    expr = torch.where(pad2d, 0.0, expr).to(torch.float64)
    out = {"fc_sums": _segment_sum(expr, block_starts, block_ends, torch.float64)}

    sv, spos = torch.sort(xp, dim=1, stable=True)
    starts = _block_starts(sv)
    start, end = _tie_blocks(starts)
    pad_sorted = torch.isinf(sv)

    if ref_code == -1:
        r2 = _twice_rank(start, end)
        # Per-column tie sum: each element of a t-block contributes t^2 - 1.
        t_blk = (end - start).to(torch.float64)
        out["tie_col"] = torch.where(pad_sorted, 0.0, t_blk * t_blk - 1.0).sum(1)
        (r2_l,) = _to_layout_order(spos, r2)
        r2_l = torch.where(pad2d, 0, r2_l)
        out["R2"] = _segment_sum(r2_l, block_starts, block_ends, int_within)
        return out

    sg = grp[spos]  # (value, group)-sorted group codes
    isref = sg == ref_code
    ref_less, ref_eq = _ref_counts(isref, start, end)
    qu2 = 2 * ref_less + ref_eq  # 2 * per-element U_tgt contribution
    # (value, group) sub-block size t for the 3at(a+t) + (t^3-t) tie terms.
    t_sub = _sub_block_sizes(starts, sg).to(torch.float64)
    a_ref = ref_eq.to(torch.float64)
    q_tie = (t_sub * t_sub - 1.0) + 3.0 * a_ref * (a_ref + t_sub)
    # Per-column scalar: sum over value blocks of a^3 - a (each reference
    # element contributes a^2 - 1).
    ref_term = torch.where(pad_sorted | ~isref, 0.0, a_ref * a_ref - 1.0)
    out["tie_ref_col"] = ref_term.sum(1)
    qu2_l, qtie_l = _to_layout_order(spos, qu2, q_tie)
    qu2_l = torch.where(pad2d, 0, qu2_l)
    qtie_l = torch.where(pad2d, 0.0, qtie_l)
    out["U2"] = _segment_sum(qu2_l, block_starts, block_ends, int_within)
    out["tie_seg"] = _segment_sum(qtie_l, block_starts, block_ends, torch.float64)
    return out


def _packed_rank_stats(out: dict, t_cols: int, *, ref_code: int, u2_dtype: str,
                       tie_dtype: str, narrow: dict):
    """The single-buffer packed wire of a rank-contract dict (this engine's
    and the compact sort engine's).

    OVO reference self-rows are zeroed (the consumer writes sentinels
    there), which is what makes the narrow tiers' bounds, computed over the
    other groups, sound.  Both engines are exact for every value, so no
    column ever overflows; the all-False ``overflow_cols`` column is carried
    because the native consumer keys on its presence.
    """
    from illico_tpu_torch.ops.wire import pack_device_outputs, to_wire_dtype

    out = dict(out)
    u2_dev = "int32" if u2_dtype == "int32" else "float64"
    if ref_code != -1:
        tie_dev = "int32" if tie_dtype == "int32" else "float64"
        for key, dev in (("U2", u2_dev), ("tie_seg", tie_dev)):
            v = out[key].clone()
            v[ref_code] = 0.0
            out[key] = to_wire_dtype(v, dev)
    else:
        out["R2"] = to_wire_dtype(out["R2"], u2_dev)
    any_v = next(iter(out.values()))
    out["overflow_cols"] = torch.zeros(t_cols, dtype=torch.bool, device=any_v.device)
    return pack_device_outputs(out, narrow)[0]


def make_tile_fn(
    layout: PaddedLayout,
    *,
    ref_code: int,
    is_log1p: bool,
    device: torch.device,
    pack: bool = False,
):
    """Tile function with the layout staged once on ``device``.

    ``run(x, mark=None)`` returns the plain dict of device tensors, or with
    ``pack=True`` the tile's packed uint8 buffer (``run.unpack`` and
    ``run.find_spec`` read it on the host), with the same bound-proven
    narrow tiers as the compact sort engine.  ``mark("kernel")``, when
    given, is called between the statistics and the pack.
    """
    layout_args = tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (
            layout.perm, layout.grp, layout.pad_mask,
            layout.block_starts, layout.block_ends,
        )
    )
    ref_code = int(ref_code)
    if pack:
        # Narrow tiers and spec/unpack machinery shared with the compact
        # engine (identical output contract; counts from the layout).
        from illico_tpu_torch.ops.csort_engine import (
            _narrow_for,
            csort_narrow_statics,
            make_rank_unpackers,
        )
        from illico_tpu_torch.ops.hist_engine import real_rows_per_group

        narrow_statics = csort_narrow_statics(real_rows_per_group(layout), ref_code)
        spec_cache, _spec_for, find_spec, unpack = make_rank_unpackers(
            layout.n_groups, ref_code, narrow_statics
        )

    def run(x_raw, mark=None):
        out = rank_stats_tile(
            x_raw, *layout_args, ref_code=ref_code, is_log1p=bool(is_log1p)
        )
        if mark is not None:
            mark("kernel")
        if not pack:
            return out
        t_cols = x_raw.shape[1]
        _spec_for(t_cols)
        return _packed_rank_stats(
            out, t_cols, ref_code=ref_code,
            u2_dtype=narrow_statics["u2_dtype"], tie_dtype=narrow_statics["tie_dtype"],
            narrow=_narrow_for(t_cols, layout.n_groups, narrow_statics, ref_code),
        )

    run._statics = dict(ref_code=ref_code, is_log1p=bool(is_log1p))
    run._spec_cache = spec_cache if pack else None
    if pack:
        run.unpack = unpack
        run.find_spec = find_spec
    return run
