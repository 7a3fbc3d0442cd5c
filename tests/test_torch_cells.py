"""Cell-axis sharding of the port against its single-device run and against
the JAX package's cell-sharded plans, kernel and ``devices=(c, g)`` runs, on
the CPU.

The histogram engine's counts add up over cells: each cell shard's histogram
is made from shard-local kernel inputs (a group may have no row in a shard),
and the sum over shards is the single-device histogram bit for bit, so every
frame of a 2-D mesh equals the single-device frame exactly.  A mesh here is
several entries of the one CPU device (logical shards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import illico_tpu
import illico_tpu_torch
from illico_tpu.ops import hist_engine as jhe
from illico_tpu.ops import rank_engine as jre
from illico_tpu.parallel import cells as jcells
from illico_tpu.utils import groups as jgroups
from illico_tpu_torch.ops import hist_engine as he
from illico_tpu_torch.ops.rank_engine import build_padded_layout
from illico_tpu_torch.parallel import mesh as pmesh
from illico_tpu_torch.parallel.cells import (
    build_cell_shard_plans,
    make_cell_sharded_hist_fn,
    make_mesh_2d,
)
from illico_tpu_torch.utils.groups import encode_and_count_groups

CPU = torch.device("cpu")
CPU8 = [CPU] * 8


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(7)
    n, t, g = 1003, 256, 6  # n NOT divisible by 2/4/8: the last shard is shorter
    x = rng.poisson(2.0, (n, t)).astype(np.float32)
    x[rng.rand(n, t) < 0.5] = 0
    labels = rng.randint(0, g, n)
    return x, labels


def _groups(labels):
    return np.array([f"p{v}" for v in labels])


def _port(x, groups, **kw):
    return illico_tpu_torch.asymptotic_wilcoxon_arrays(
        x, groups, device="cpu", progress=False, **kw)


# -- plans ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_plan_partitions_rows_exactly_once(problem, n_shards):
    """Every input row lands in exactly one shard's perm, at its shard-local
    index and inside its own group's segment; each shard's entries equal the
    reference plan's non-pad entries."""
    _, labels = problem
    _, info = encode_and_count_groups(labels, 0)
    plan = build_cell_shard_plans(info, n_shards)
    _, jinfo = jgroups.encode_and_count_groups(labels, 0)
    want = jcells.build_cell_shard_plans(jinfo, n_shards)

    n_cells = info.n_cells
    assert plan.n_shards == n_shards and plan.n_groups == info.n_groups
    assert plan.n_cells == n_cells
    assert plan.rows_per_shard == want.rows_per_shard == -(-n_cells // n_shards)
    codes = np.asarray(info.encoded_groups)
    seen = 0
    for s in range(n_shards):
        lo, hi = plan.row_bounds[s]
        assert (lo, hi) == (min(s * plan.rows_per_shard, n_cells),
                            min((s + 1) * plan.rows_per_shard, n_cells))
        perm, indptr, order = plan.perm[s], plan.indptr[s], plan.order[s]
        assert perm.dtype == np.int32 and indptr.dtype == np.int64 and order.dtype == np.int32
        assert sorted(perm.tolist()) == list(range(hi - lo))
        seen += perm.size
        ref_perm = np.asarray(want.perm[s])
        np.testing.assert_array_equal(perm, ref_perm[ref_perm >= 0])
        assert indptr[0] == 0 and indptr[-1] == hi - lo
        for g in range(info.n_groups):
            np.testing.assert_array_equal(codes[lo + perm[indptr[g] : indptr[g + 1]]], g)
        sizes = np.diff(indptr)
        assert sorted(order.tolist()) == list(range(info.n_groups))
        assert (np.diff(sizes[order]) <= 0).all()  # largest first
    assert seen == n_cells


def test_plan_shard_with_absent_group():
    """A group with no row in a shard has an empty segment there."""
    labels = np.array([0] * 500 + [1] * 300 + [2] * 203)  # sorted: shard 0
    _, info = encode_and_count_groups(labels, 0)           # sees only group 0
    plan = build_cell_shard_plans(info, 4)
    np.testing.assert_array_equal(plan.indptr[0], [0, 251, 251, 251])
    np.testing.assert_array_equal(plan.indptr[3], [0, 0, 47, 250])
    assert plan.order[0][0] == 0 and plan.order[3][0] == 2
    with pytest.raises(ValueError, match=">= 1"):
        build_cell_shard_plans(info, 0)
    # More shards than rows: the trailing shards are empty, not an error.
    tiny = build_cell_shard_plans(encode_and_count_groups(labels[498:503], 0)[1], 8)
    assert [hi - lo for lo, hi in tiny.row_bounds] == [1, 1, 1, 1, 1, 0, 0, 0]


# -- the summed histogram ---------------------------------------------------------------


def _jax_hist(x, labels, v_buckets, is_log1p):
    _, info = jgroups.encode_and_count_groups(labels, None)
    layout = jre.build_padded_layout(info.perm, info.indptr)
    perm, pad_mask, _, blk_group, blk_flush, _ = jhe.prepare_hist_inputs(
        layout, v_buckets, is_log1p)
    table = jnp.asarray(jhe.make_value_table(v_buckets, is_log1p))
    with jax.enable_x64(False):
        hist = jhe.hist_pass(
            jnp.asarray(x), perm, pad_mask, table, blk_group, blk_flush,
            n_groups=layout.n_groups, interpret=True,
        )
    return np.asarray(hist)[:, :, : x.shape[1]]


@pytest.mark.parametrize("n_shards", [2, 3, 8])
@pytest.mark.parametrize("is_log1p", [False, True], ids=["raw", "log1p"])
def test_summed_shard_histograms_equal_the_single_device_histogram(problem, n_shards, is_log1p):
    """Per-shard ``hist_pass`` on shard-local inputs, summed, equals the
    unsharded pass and the Pallas kernel in interpret mode, bit for bit;
    sorted labels give shards whole groups are absent from."""
    x, labels = problem
    x = x[:, :64]
    labels = np.sort(labels)
    if is_log1p:
        x = np.log1p(x).astype(np.float32)
    x[5, 3] = 600.0  # off the table: counted nowhere
    _, info = encode_and_count_groups(labels, None)
    layout = build_padded_layout(info.perm, info.indptr)
    arrs = he.prepare_hist_inputs(layout, 128, is_log1p, CPU)
    whole = he.hist_pass(torch.from_numpy(x), arrs["perm"], arrs["indptr"], arrs["order"],
                         arrs["table"], is_log1p=is_log1p)
    plan = build_cell_shard_plans(info, n_shards)
    assert any((np.diff(p) == 0).any() for p in plan.indptr)
    total = torch.zeros_like(whole)
    for s, (lo, hi) in enumerate(plan.row_bounds):
        part = he.hist_pass(
            torch.from_numpy(x[lo:hi]), torch.from_numpy(plan.perm[s]),
            torch.from_numpy(plan.indptr[s]), torch.from_numpy(plan.order[s]),
            arrs["table"], is_log1p=is_log1p,
        )
        absent = np.flatnonzero(np.diff(plan.indptr[s]) == 0)
        assert not part[absent].any()
        total += part
    assert torch.equal(total, whole)
    np.testing.assert_array_equal(total.numpy(), _jax_hist(x, labels, 128, is_log1p))


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1), (2, 1)])
@pytest.mark.parametrize("reference", [0, None], ids=["ovo", "ovr"])
def test_cell_sharded_fn_matches_single_device(problem, shape, reference):
    """Each gene shard's packed buffer unpacks to the single-device engine's
    statistics on the shard's columns, bit for bit."""
    x, labels = problem
    _, info = encode_and_count_groups(labels, reference)
    layout = build_padded_layout(info.perm, info.indptr)
    kw = dict(ref_code=info.ref_code, is_log1p=False)
    single = he.make_hist_tile_fn(layout, device=CPU, **kw)
    mesh = make_mesh_2d(*shape, devices=CPU8)
    plan = build_cell_shard_plans(info, shape[0])
    run = make_cell_sharded_hist_fn(layout, plan, mesh, **kw)
    assert run._plan is plan and len(run.shards) == shape[1]
    width = x.shape[1] // shape[1]
    tiles = [
        [torch.from_numpy(np.ascontiguousarray(x[lo:hi, j * width : (j + 1) * width]))
         for lo, hi in plan.row_bounds]
        for j in range(shape[1])
    ]
    outs = run(tiles)
    assert run._counters == {"calls": shape[1]}
    for j, buf in enumerate(outs):
        cols = np.ascontiguousarray(x[:, j * width : (j + 1) * width])
        want = single(torch.from_numpy(cols))
        assert torch.equal(buf, want)
        got = run.unpack(buf.numpy())
        for key, val in single.unpack(want.numpy()).items():
            np.testing.assert_array_equal(got[key], val, err_msg=key)


def test_cell_mesh_validation(problem):
    x, labels = problem
    _, info = encode_and_count_groups(labels, 0)
    layout = build_padded_layout(info.perm, info.indptr)
    plan = build_cell_shard_plans(info, 2)
    with pytest.raises(ValueError, match="cells"):
        make_cell_sharded_hist_fn(
            layout, plan, pmesh.make_gene_mesh(2, devices=CPU8), ref_code=0, is_log1p=False)
    with pytest.raises(ValueError, match="shards"):
        make_cell_sharded_hist_fn(
            layout, plan, make_mesh_2d(4, 2, devices=CPU8), ref_code=0, is_log1p=False)
    with pytest.raises(ValueError):
        make_mesh_2d(16, 1, devices=CPU8)  # more devices than the pool holds


# -- the public API -------------------------------------------------------------------------


@pytest.mark.parametrize("devices", [(2, 4), (4, 2), (8, 1), (1, 8), (1, 1)])
@pytest.mark.parametrize("reference", ["p0", None], ids=["ovo", "ovr"])
def test_public_api_cells_matches_single_and_reference(problem, devices, reference):
    x, labels = problem
    groups = _groups(labels)
    kw = dict(reference=reference, engine="hist")
    one = _port(x, groups, **kw)
    many = _port(x, groups, devices=devices, **kw)
    pd.testing.assert_frame_equal(many, one, check_exact=True)
    path = many.attrs["consume_path"]
    assert path == {"native": devices[1], "numpy": 0}, path
    want = illico_tpu.asymptotic_wilcoxon_arrays(
        x, groups, devices=devices, progress=False, **kw)
    np.testing.assert_array_equal(many.statistic.values, want.statistic.values)
    np.testing.assert_allclose(many.p_value.values, want.p_value.values, rtol=1e-12, atol=0)
    np.testing.assert_allclose(many.fold_change.values, want.fold_change.values, rtol=1e-6)


@pytest.mark.parametrize("devices", [(2, 4), (3, 1)])
def test_public_api_cells_sorted_labels(problem, devices):
    """Sorted labels concentrate groups in single shards; most groups are
    absent from most shards."""
    x, labels = problem
    groups = _groups(np.sort(labels))
    kw = dict(reference="p0", engine="hist")
    pd.testing.assert_frame_equal(
        _port(x, groups, devices=devices, **kw), _port(x, groups, **kw), check_exact=True)


@pytest.mark.parametrize("reference", ["p0", None], ids=["ovo", "ovr"])
def test_public_api_cells_log1p(problem, reference):
    x, labels = problem
    xl = np.log1p(x)
    groups = _groups(labels)
    kw = dict(reference=reference, is_log1p=True)
    many = _port(xl, groups, devices=(2, 4), **kw)
    assert many.attrs["engine"] == "hist"
    pd.testing.assert_frame_equal(many, _port(xl, groups, **kw), check_exact=True)


@pytest.mark.parametrize("kw, match", [
    (dict(engine="sort"), "Cell-axis sharding requires the histogram engine"),
    (dict(engine="csort"), "engine='csort' cannot shard the cell axis"),
    (dict(dtype=np.float64), "Cell-axis sharding requires the histogram engine"),
    (dict(dtype=np.float64, engine="hist"), "does not support float64"),
])
def test_cells_need_the_histogram_engine(problem, kw, match):
    """The reference's guards, messages included: a cell mesh with the sort
    engines, or with float64 input (which auto routes to sort and never to
    csort under a cell mesh), fails loudly."""
    x, labels = problem
    groups = _groups(labels)
    kw = dict(kw)
    dtype = kw.pop("dtype", np.float32)
    with pytest.raises(ValueError, match=match) as err:
        _port(x.astype(dtype), groups, reference="p0", devices=(2, 4), **kw)
    with pytest.raises(ValueError) as want:
        illico_tpu.asymptotic_wilcoxon_arrays(
            x.astype(dtype), groups, reference="p0", devices=(2, 4), progress=False, **kw)
    theirs = str(want.value).replace("illico_tpu.", "illico_tpu_torch.")
    assert str(err.value) == theirs.replace("Device-resident arrays", "Device-resident tensors")


@pytest.mark.parametrize("devices, match", [((2,), "pair"), ((0, 4), ">= 1"), ((2, 2, 2), "pair")])
def test_cells_devices_tuple_validation(problem, devices, match):
    x, labels = problem
    with pytest.raises(ValueError, match=match):
        _port(x, _groups(labels), reference="p0", devices=devices)


# -- unequal tiles ---------------------------------------------------------------------


def _unpacked(fn, buf):
    """A hist shard's unpacked dict, split rows patched back, as float64."""
    got = {k: np.asarray(v, np.float64) for k, v in fn.unpack(buf).items()}
    st = fn._statics
    for key, split, col in (("fc_sums", "fc_split_code", "fc_split_col"),
                            ("R2", "u2_split_code", "r2_split_col")):
        if st.get(split, -1) >= 0 and key in got:
            got[key][st[split]] = got[col]
    return got


@pytest.mark.parametrize("widths", [(32, 30), (1024, 1022)])
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_cell_sharded_unequal_tiles_unpack_to_their_own_dicts(problem, shape, widths):
    """A full tile and then a short last one through the same cell-sharded
    gene shards (2,046 genes at batch_size=1024 and devices=(2, 1), or a
    30-column shard after its 32-column warm-up): the widths pack to the
    same byte count, and each buffer unpacks to its own statistics."""
    x, labels = problem
    x = np.tile(x, (1, 8))[:, : shape[1] * widths[0]]
    _, info = encode_and_count_groups(labels, 0)
    layout = build_padded_layout(info.perm, info.indptr)
    kw = dict(ref_code=info.ref_code, is_log1p=False)
    single = he.make_hist_tile_fn(layout, device=CPU, pack=False, **kw)
    plan = build_cell_shard_plans(info, shape[0])
    run = make_cell_sharded_hist_fn(layout, plan, make_mesh_2d(*shape, devices=CPU8), **kw)
    sizes = set()
    for w in widths:
        cols = [(j * widths[0], j * widths[0] + w) for j in range(shape[1])]
        tiles = [[torch.from_numpy(np.ascontiguousarray(x[lo:hi, a:b]))
                  for lo, hi in plan.row_bounds] for a, b in cols]
        for (a, b), buf, shard in zip(cols, run(tiles), run.shards):
            sizes.add(buf.numel())
            got = _unpacked(shard.fn, buf.numpy())
            for key, want in single(torch.from_numpy(np.ascontiguousarray(x[:, a:b]))).items():
                np.testing.assert_array_equal(got[key][..., :w],
                                              want.numpy().astype(np.float64), err_msg=key)
    assert len(sizes) == 1
