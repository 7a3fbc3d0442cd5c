"""Tie-block statistics of the sort engines, held against plain loops and
against the JAX package.

The port numbers the tie blocks of a sorted tile with one cumsum over the
flattened ``(T, n)`` tile and finds their bounds by a scatter and two
gathers (``rank_engine._tie_blocks``), so every column's first element must
start a block.  Each helper is checked here against a numpy loop over each
sorted column, on the columns where a block could run on across a column
boundary (an all-+inf column after one ending in +inf pads, two adjacent
constant columns of one value), on all-tied and all-distinct columns, real
+inf values tied with the pads, a NaN, the reference group first, last and
absent, ``T = 1`` and one row per group; with int32 and with int64 flat
positions.  Then ``rank_stats_tile`` and ``csort_stats_tile`` on tiles with
those columns against the JAX package under x64, bit for bit, through the
int32 and the float64 segment sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import illico_tpu.ops.csort_engine as jcs
import illico_tpu.ops.rank_engine as jre
from illico_tpu.utils.groups import encode_and_count_groups as jax_encode
from illico_tpu_torch.ops import csort_engine as tcs
from illico_tpu_torch.ops import rank_engine as tre
from illico_tpu_torch.utils.groups import encode_and_count_groups

N = 12  # elements per helper column
REF = 1  # reference group code of the helper columns


def _column(case, rng):
    """(values, group codes) of one unsorted helper column; group code 9
    marks a pad (+inf, after every real group)."""
    grp = np.sort(rng.randint(0, 4, N))
    x = rng.randint(0, 4, N).astype(np.float32)
    if case == "all_tied":
        x[:] = 2.0
    elif case == "distinct":
        x = rng.permutation(N).astype(np.float32)
    elif case == "inf_ties_pads":
        x[[1, 4]] = np.inf
        x[-3:], grp[-3:] = np.inf, 9
    elif case == "ends_in_pads":
        x[-4:], grp[-4:] = np.inf, 9
    elif case == "all_inf":
        x[:] = np.inf
    elif case == "constant":
        x[:] = 5.0
    elif case == "nan":
        x[3] = np.nan
    elif case == "ref_first":
        x = np.where(grp == REF, 0.0, x + 1).astype(np.float32)
    elif case == "ref_last":
        x = np.where(grp == REF, 9.0, x).astype(np.float32)
    elif case == "ref_absent":
        grp[grp == REF] = 0
    elif case == "one_per_group":
        grp = np.arange(N)
    return x, grp


# Adjacent pairs that would merge across the column boundary if the first
# element of each column did not start a block.
COLUMNS = ["all_tied", "distinct", "ends_in_pads", "all_inf", "constant", "constant",
           "inf_ties_pads", "nan", "ref_first", "ref_last", "ref_absent", "one_per_group"]


def _sorted_tile(cases, seed=0):
    """(sv, sg): each column stably sorted by value, as the engines sort."""
    rng = np.random.RandomState(seed)
    cols = [_column(c, rng) for c in cases]
    x = np.stack([c[0] for c in cols])
    grp = np.stack([c[1] for c in cols])
    order = np.argsort(x, axis=1, kind="stable")
    return np.take_along_axis(x, order, 1), np.take_along_axis(grp, order, 1)


def _loop_blocks(sv, sg):
    """Per element: tie block first/last (column-local), reference elements
    below the block and in it, and the (value, group) sub-block first/last."""
    t, n = sv.shape
    out = {k: np.zeros((t, n), np.int64)
           for k in ("first", "last", "ref_less", "ref_eq", "sub_first", "sub_last")}
    for c in range(t):
        i = 0
        while i < n:
            j = i
            while j + 1 < n and sv[c, j + 1] == sv[c, i]:
                j += 1
            out["first"][c, i:j + 1] = i
            out["last"][c, i:j + 1] = j
            out["ref_less"][c, i:j + 1] = np.sum(sg[c, :i] == REF)
            out["ref_eq"][c, i:j + 1] = np.sum(sg[c, i:j + 1] == REF)
            k = i
            while k <= j:
                m = k
                while m + 1 <= j and sg[c, m + 1] == sg[c, k]:
                    m += 1
                out["sub_first"][c, k:m + 1] = k
                out["sub_last"][c, k:m + 1] = m
                k = m + 1
            i = j + 1
    return out


def _port_blocks(sv, sg):
    sv_t, sg_t = torch.from_numpy(sv), torch.from_numpy(sg)
    t, n = sv.shape
    base = np.arange(t)[:, None] * n
    starts = tre._block_starts(sv_t)
    start, end = tre._tie_blocks(starts)
    ref_less, ref_eq = tre._ref_counts(sg_t == REF, start, end)
    sub = starts.clone()
    sub[:, 1:] |= sg_t[:, 1:] != sg_t[:, :-1]
    sub_start, sub_end = tre._tie_blocks(sub)
    sizes = tre._sub_block_sizes(starts, sg_t)
    assert start.dtype == end.dtype == sub_start.dtype
    assert ref_less.dtype == ref_eq.dtype == torch.int32
    np.testing.assert_array_equal(sizes.numpy(), (sub_end - sub_start).numpy())
    return start.dtype, {
        "first": start.numpy() - base, "last": end.numpy() - 1 - base,
        "ref_less": ref_less.numpy(), "ref_eq": ref_eq.numpy(),
        "sub_first": sub_start.numpy() - base, "sub_last": sub_end.numpy() - 1 - base,
    }


@pytest.fixture(params=["int32", "int64"])
def flat_dtype(request, monkeypatch):
    """int64 flat positions are forced by lowering the int32 limit."""
    if request.param == "int64":
        monkeypatch.setattr(tre, "_I32_MAX", 0)
    return getattr(torch, request.param)


@pytest.mark.parametrize("cases", [COLUMNS] + [[c] for c in dict.fromkeys(COLUMNS)],
                         ids=["all-columns"] + [f"T1-{c}" for c in dict.fromkeys(COLUMNS)])
def test_tie_blocks_match_loop(cases, flat_dtype):
    sv, sg = _sorted_tile(cases)
    dtype, got = _port_blocks(sv, sg)
    assert dtype == flat_dtype
    want = _loop_blocks(sv, sg)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_column_starts_split_equal_neighbours():
    """Two adjacent constant columns of one value, and an all-+inf column
    after +inf pads: the flattened tile holds one run each, the blocks two."""
    sv, sg = _sorted_tile(["constant", "constant", "ends_in_pads", "all_inf"])
    _, got = _port_blocks(sv, sg)
    np.testing.assert_array_equal(got["first"][[0, 1, 3]], 0)
    np.testing.assert_array_equal(got["last"][[0, 1, 3]], N - 1)
    np.testing.assert_array_equal(got["ref_less"][[0, 1, 3]], 0)


# -- the tile functions on those columns against the JAX package -------------

REF_LABEL = 2


def _edge_tile(layout, rng):
    """(x, labels): cells x 9 columns of the edge cases, in cell order."""
    n = 40 if layout == "one_per_group" else 64
    labels = np.arange(n) if layout == "one_per_group" else rng.randint(0, 5, n)
    x = rng.poisson(2.0, (n, 9)).astype(np.float32)
    x[:, 0] = 3.0  # all tied
    x[:, 1] = rng.permutation(n)  # all distinct
    x[rng.rand(n) < 0.1, 2] = np.inf  # real +inf, tied with the pads
    x[:, 3] = np.inf  # all +inf, after a column ending in +inf pads
    x[:, 4:6] = 5.0  # two adjacent constant columns of one value
    x[labels == REF_LABEL, 6] = -1.0  # the reference first
    x[labels == REF_LABEL, 7] = 99.0  # the reference last
    return x, labels


def _layout_args(layout):
    return [np.ascontiguousarray(a) for a in (layout.perm, layout.grp, layout.pad_mask,
                                              layout.block_starts, layout.block_ends)]


@pytest.mark.parametrize("layout", ["mixed", "one_per_group"])
@pytest.mark.parametrize("width", ["all", "T1"])
@pytest.mark.parametrize("ref", [None, REF_LABEL], ids=["ovr", "ovo"])
@pytest.mark.parametrize("i32_safe", [True, False], ids=["i32", "f64-segsum"])
def test_rank_stats_tile_edge_columns(layout, width, ref, i32_safe, monkeypatch):
    x, labels = _edge_tile(layout, np.random.RandomState(21))
    if width == "T1":
        x = np.ascontiguousarray(x[:, 2:3])
    _, info = encode_and_count_groups(labels, ref)
    lay = tre.build_padded_layout(info.perm, info.indptr)
    args = _layout_args(lay)
    with jax.enable_x64(True):
        want = jre._jitted_rank_stats(
            jnp.asarray(x), *(jnp.asarray(a) for a in args),
            ref_code=info.ref_code, is_log1p=False, compute_fc=True,
        )
        want = {k: np.asarray(v) for k, v in want.items()}
    if not i32_safe:
        monkeypatch.setattr(tre, "_I32_SAFE_N_PAD", 0)
    got = tre.rank_stats_tile(torch.from_numpy(x), *(torch.from_numpy(a) for a in args),
                              ref_code=info.ref_code, is_log1p=False)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == torch.float64, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def _csort_edge_tile(rng):
    """Sparse cells x 10 columns: the edge columns above, the reference's
    values all zero in column 8 (absent from the compacted block) and an
    all-zero column 9."""
    x, labels = _edge_tile("mixed", rng)
    x = np.hstack([x, np.zeros((x.shape[0], 1), np.float32)])
    x[rng.rand(*x.shape) < 0.3] = 0.0
    x[:, 8] = np.where(labels == REF_LABEL, 0.0, x[:, 8] + 1)
    x[:, 0] = 3.0  # all tied again: no zero block
    return x, labels.astype(str)


@pytest.mark.parametrize("ref", [None, str(REF_LABEL)], ids=["ovr", "ovo"])
@pytest.mark.parametrize("i32_safe", [True, False], ids=["i32", "f64-segsum"])
def test_csort_stats_tile_edge_columns(ref, i32_safe, monkeypatch):
    x, labels = _csort_edge_tile(np.random.RandomState(22))
    r, c = np.nonzero(x)
    tiles = {}
    for lib, encode in ((jcs, jax_encode), (tcs, encode_and_count_groups)):
        _, info = encode(labels, ref)
        tiles[lib] = info, lib.compact_from_entries(
            x[r, c], r, c, x.shape[1], info.encoded_groups, info.n_groups,
            value_dtype=x.dtype, need_grp=ref is not None)
    info, tile = tiles[jcs]
    grp = tile.grp if tile.grp is not None else tile.vals
    with jax.enable_x64(True):
        want = jcs.csort_stats_tile(
            jnp.asarray(tile.vals), jnp.asarray(grp), jnp.asarray(tile.indptr),
            jnp.asarray(info.counts), ref_code=info.ref_code, is_log1p=False,
            n_total=info.n_cells, pack=False,
        )
        want = {k: np.asarray(v) for k, v in want.items()}
    if not i32_safe:
        monkeypatch.setattr(tcs, "_I32_SAFE_N_TOTAL", 0)
    info, tile = tiles[tcs]
    grp = None if tile.grp is None else torch.from_numpy(tile.grp.astype(np.int32))
    got = tcs.csort_stats_tile(
        torch.from_numpy(tile.vals), grp, torch.from_numpy(tile.indptr),
        torch.from_numpy(info.counts), ref_code=info.ref_code, is_log1p=False,
        n_total=info.n_cells,
    )
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
