"""Gene-axis sharding of the port against its single-device run and against
the JAX package's ``devices=`` runs, on the CPU.

torch has no virtual devices, so a mesh here is eight entries of the one CPU
device: each entry is a logical shard with its own slice of every tile (see
``illico_tpu_torch.parallel.mesh``).  The JAX package runs on its 8 virtual
CPU devices (``tests/conftest.py``) with the Pallas kernel in interpret mode.
A sharded frame of the port equals its single-device frame bit for bit, and
the JAX package's sharded frame with U exact, p within rtol 1e-12 and fold
change within rtol 1e-6.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import illico_tpu
import illico_tpu_torch
from illico_tpu.parallel import cells as jcells
from illico_tpu_torch.models.wilcoxon import WilcoxonRunner
from illico_tpu_torch.ops import hist_engine as he
from illico_tpu_torch.ops.csort_engine import compact_from_entries, make_csort_tile_fn
from illico_tpu_torch.ops.rank_engine import build_padded_layout, make_tile_fn
from illico_tpu_torch.parallel import mesh as pmesh
from illico_tpu_torch.parallel.cells import make_mesh_2d, mesh_from_spec
from illico_tpu_torch.utils.groups import encode_and_count_groups
from illico_tpu_torch.utils.registry import DeviceDenseDataHandler, data_handler_registry

CPU = torch.device("cpu")
CPU8 = [CPU] * 8


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(0)
    n, t, g = 1000, 256, 6
    x = rng.poisson(2.0, (n, t)).astype(np.float32)
    x[rng.rand(n, t) < 0.5] = 0
    labels = rng.randint(0, g, n)
    return x, labels


def _groups(labels):
    return np.array([f"p{v}" for v in labels])


def _port(x, groups, **kw):
    kw.setdefault("device", "cpu")
    return illico_tpu_torch.asymptotic_wilcoxon_arrays(x, groups, progress=False, **kw)


def _assert_bit_equal(a, b):
    pd.testing.assert_frame_equal(a, b, check_exact=True)


def _check_against_reference(got, want):
    assert got.index.equals(want.index)
    np.testing.assert_array_equal(got.statistic.values, want.statistic.values)
    np.testing.assert_allclose(got.p_value.values, want.p_value.values, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.fold_change.values, want.fold_change.values, rtol=1e-6)


# -- meshes ---------------------------------------------------------------------


@pytest.mark.parametrize("spec", [None, 1, (1, 1), 2, 8, (1, 2), [1, 2], (2, 2), (4, 2), (8, 1)])
def test_mesh_from_spec_routes_like_the_reference(spec):
    got = mesh_from_spec(spec, devices=CPU8)
    want = jcells.mesh_from_spec(spec)
    if want is None:
        assert got is None
        return
    assert tuple(got.axis_names) == tuple(want.axis_names)
    assert dict(got.shape) == {k: int(v) for k, v in want.shape.items()}
    assert len(got.devices) == want.devices.size


@pytest.mark.parametrize("spec, match", [((2, 2, 2), "pair"), ((2,), "pair"),
                                         ((2, -1), ">= 1"), ((0, 4), ">= 1")])
def test_mesh_from_spec_errors_like_the_reference(spec, match):
    messages = []
    for fn, kw in ((mesh_from_spec, dict(devices=CPU8)), (jcells.mesh_from_spec, {})):
        with pytest.raises(ValueError, match=match) as err:
            fn(spec, **kw)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_more_devices_than_the_pool_raises(problem):
    with pytest.raises(ValueError, match="Requested 9 devices but only 8"):
        pmesh.make_gene_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="Requested 3x3 = 9 devices but only 8"):
        make_mesh_2d(3, 3, devices=CPU8)
    with pytest.raises(ValueError, match="only 8"):
        mesh_from_spec(16, devices=CPU8)
    # The default pool is the visible CUDA devices: none here.
    assert not torch.cuda.is_available()
    with pytest.raises(ValueError, match="only 0"):
        pmesh.make_gene_mesh(2)
    with pytest.raises(ValueError, match="only 0"):
        make_mesh_2d(2, 1)
    # The public API never drops to fewer devices, or to the CPU, unasked.
    x, labels = problem
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port(x, _groups(labels), devices=2, device=None)


def test_device_mesh_shape_and_columns():
    a, b = torch.device("cpu"), torch.device("meta")
    m = make_mesh_2d(2, 2, devices=[a, b, a, b])
    assert m.axis_names == ("cells", "genes") and m.shape == {"cells": 2, "genes": 2}
    assert m.devices == (a, b, a, b)
    assert m.column(0) == (a, a) and m.column(1) == (b, b)
    g = pmesh.make_gene_mesh(devices=[a, a, a])
    assert g.axis_names == ("genes",) and g.shape == {"genes": 3}
    assert g.column(2) == (a,)


# -- the sharded factories against the single-device engines ---------------------


def _dicts_equal(got, want, cols, is_log1p):
    """A shard's plain dict against the single-device dict's columns."""
    assert set(got) == set(want)
    for key, w in want.items():
        g, w = got[key].numpy(), w.numpy()[..., cols]
        if key == "fc_sums" and is_log1p:
            # expm1 in float32 before the float64 sums: same code, same
            # device here, but ROADMAP section 3 keeps the tolerance.
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("n_devices", [2, 8])
@pytest.mark.parametrize("is_log1p", [False, True], ids=["raw", "log1p"])
@pytest.mark.parametrize("reference", [0, None], ids=["ovo", "ovr"])
@pytest.mark.parametrize("engine", ["hist", "sort", "csort"])
def test_sharded_factory_matches_single_engine(problem, engine, reference, is_log1p, n_devices):
    x, labels = problem
    if is_log1p:
        x = np.log1p(x).astype(np.float32)
    _, info = encode_and_count_groups(labels, reference)
    layout = build_padded_layout(info.perm, info.indptr)
    kw = dict(ref_code=info.ref_code, is_log1p=is_log1p, pack=False)
    mesh = pmesh.make_gene_mesh(n_devices, devices=CPU8)
    width = x.shape[1] // n_devices
    bounds = [(j * width, (j + 1) * width) for j in range(n_devices)]

    def compact(lb, ub):
        r, c = np.nonzero(x[:, lb:ub])
        return compact_from_entries(
            x[:, lb:ub][r, c], r, c, ub - lb, info.encoded_groups, info.n_groups,
            need_grp=reference is not None,
        )

    if engine == "hist":
        single = he.make_hist_tile_fn(layout, device=CPU, **kw)(torch.from_numpy(x))
        run = pmesh.make_sharded_hist_fn(layout, mesh, **kw)
    elif engine == "sort":
        single = make_tile_fn(layout, device=CPU, **kw)(torch.from_numpy(x))
        run = pmesh.make_sharded_tile_fn(layout, mesh, **kw)
    else:
        single = make_csort_tile_fn(info, device=CPU, **kw)(compact(0, x.shape[1]))
        run = pmesh.make_sharded_csort_fn(info, mesh, **kw)
    if engine == "csort":
        tiles = [compact(lb, ub) for lb, ub in bounds]
    else:
        tiles = [torch.from_numpy(np.ascontiguousarray(x[:, lb:ub])) for lb, ub in bounds]
    outs = run(tiles)
    assert len(outs) == n_devices and run._counters == {"calls": n_devices}
    assert run._mesh is mesh
    for (lb, ub), out in zip(bounds, outs):
        _dicts_equal(out, single, slice(lb, ub), is_log1p)


def test_hist_guards_apply_under_a_mesh(problem, monkeypatch):
    """The histogram engine's exactness guards hold on the mesh path: a
    forced engine='hist' fails loudly, not with inexact counts."""
    x, labels = problem
    _, info = encode_and_count_groups(labels, 0)
    layout = build_padded_layout(info.perm, info.indptr)
    mesh = pmesh.make_gene_mesh(2, devices=CPU8)
    monkeypatch.setattr(he, "HIST_EXACT_MAX_GROUP", 50)
    with pytest.raises(ValueError, match="sort"):
        pmesh.make_sharded_hist_fn(layout, mesh, ref_code=0, is_log1p=False)
    monkeypatch.setattr(he, "HIST_EXACT_MAX_GROUP", 2**24)
    assert pmesh.make_sharded_hist_fn(layout, mesh, ref_code=0, is_log1p=False) is not None
    with pytest.raises(ValueError, match="float64"):
        _port(x.astype(np.float64), _groups(labels), engine="hist", devices=2)
    with pytest.raises(ValueError, match="1-D"):
        pmesh.make_sharded_hist_fn(
            layout, make_mesh_2d(2, 2, devices=CPU8), ref_code=0, is_log1p=False)


# -- the public API ---------------------------------------------------------------


@pytest.mark.parametrize("devices", [2, 8])
@pytest.mark.parametrize("reference", ["p0", None], ids=["ovo", "ovr"])
@pytest.mark.parametrize("engine", ["hist", "sort", "csort"])
def test_public_api_devices_matches_single_and_reference(problem, engine, reference, devices):
    x, labels = problem
    groups = _groups(labels)
    kw = dict(reference=reference, engine=engine)
    one = _port(x, groups, **kw)
    many = _port(x, groups, devices=devices, **kw)
    _assert_bit_equal(many, one)
    path = many.attrs["consume_path"]
    assert path["numpy"] == 0 and path["native"] == devices, path
    assert many.attrs["engine"] == engine
    want = illico_tpu.asymptotic_wilcoxon_arrays(
        x, groups, devices=devices, progress=False, **kw)
    _check_against_reference(many, want)


@pytest.mark.parametrize("engine", ["hist", "sort", "csort"])
@pytest.mark.parametrize("n_genes", [15, 250, 300])
def test_gene_count_that_does_not_divide(problem, engine, n_genes):
    """Shares past the end of a short tile do not exist; the last one that
    does is simply narrower."""
    x, labels = problem
    x = np.concatenate([x, x[:, :44] + 1.0], axis=1)[:, :n_genes]
    groups = _groups(labels)
    kw = dict(reference="p0", engine=engine)
    _assert_bit_equal(_port(x, groups, devices=8, **kw), _port(x, groups, **kw))
    _assert_bit_equal(_port(x, groups, devices=3, **kw), _port(x, groups, **kw))


@pytest.mark.parametrize("engine, per_shard", [("hist", 32), ("sort", 4), ("csort", 4)])
def test_tile_width_realigns_per_shard(problem, engine, per_shard):
    """Every gene shard gets an equal share of a tile, a multiple of 32
    columns for the histogram kernel's column blocks and of 4 (the packed
    wire's widest alignment) otherwise."""
    x, labels = problem
    groups = _groups(labels)
    _, info = encode_and_count_groups(labels, 0)
    mesh = pmesh.make_gene_mesh(8, devices=CPU8)
    runner = WilcoxonRunner(
        data_handler_registry.get(x), info, is_log1p=False, engine=engine,
        mesh=mesh, batch_size=50,
    )
    assert runner.tile_width == 8 * per_shard * -(-50 // (8 * per_shard))
    assert runner._shard_width * 8 == runner.tile_width
    assert runner.bounds[0] == (0, runner.tile_width) and runner.bounds[-1][1] == 256
    items = runner._work_items()
    assert [(lb, ub) for lb, ub, _ in items][:2] == [
        (0, runner._shard_width), (runner._shard_width, 2 * runner._shard_width)]
    assert sum(ub - lb for lb, ub, _ in items) == 256
    kw = dict(reference="p0", engine=engine, batch_size=50)
    _assert_bit_equal(_port(x, groups, devices=8, **kw), _port(x, groups, **kw))


@pytest.mark.parametrize("devices", [8, (2, 4)])
@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16])
def test_narrow_input_dtypes_under_a_mesh(problem, dtype, devices):
    """Integer counts ship in their storage dtype, per shard, and the frame
    equals the float32 single-device run's."""
    x, labels = problem
    groups = _groups(labels)
    kw = dict(reference="p0", engine="hist")
    _assert_bit_equal(_port(x.astype(dtype), groups, devices=devices, **kw),
                      _port(x, groups, **kw))


@pytest.mark.parametrize("devices", [8, (2, 4)])
def test_overflow_column_under_a_mesh_falls_back_exactly(problem, devices):
    """A column past the sampled value table is recomputed by the sort
    fallback (on the mesh's first device), under either mesh."""
    x, labels = problem
    x = x.copy()
    x[::3, 60] = 1000.0  # outside the sampled windows (0-23, 116-139, 232-255)
    groups = _groups(labels)
    want = _port(x, groups, reference="p0", engine="sort")
    got = _port(x, groups, reference="p0", engine="hist", devices=devices)
    _assert_bit_equal(got, want)
    assert got.attrs["n_fallback_cols"] == 1


@pytest.mark.parametrize("engine", ["hist", "sort", "csort"])
def test_precompile_is_not_counted_and_every_shard_tile_is(problem, engine):
    x, labels = problem
    _, info = encode_and_count_groups(labels, 0)
    mesh = pmesh.make_gene_mesh(8, devices=CPU8)
    runner = WilcoxonRunner(
        data_handler_registry.get(x), info, is_log1p=False, engine=engine, mesh=mesh)
    assert runner.tile_fn._mesh is mesh and runner.device == CPU
    assert runner.precompile() > 0
    assert runner.tile_fn._counters == {"calls": 0}
    res = runner.run(progress=False)
    assert runner.tile_fn._counters == {"calls": len(runner._work_items())}
    assert res.consume_path == {"native": len(runner._work_items()), "numpy": 0}
    assert np.isfinite(res.stacked[info.ref_code + 1 :, :, 0]).all()


def test_stage_seconds_keep_their_keys_and_gain_the_device_split(problem):
    x, labels = problem
    groups = _groups(labels)
    one = _port(x, groups, reference="p0")
    many = _port(x, groups, reference="p0", devices=4)
    assert list(one.attrs["stage_seconds"]) == list(many.attrs["stage_seconds"]) == [
        "setup", "precompile", "fetch", "h2d", "kernel", "contract", "pack", "d2h",
        "tail", "fallback"]
    split = many.attrs["stage_seconds_by_device"]
    assert list(split) == ["cpu"]
    for stage in ("h2d", "kernel", "contract", "pack", "d2h"):
        assert split["cpu"][stage] == many.attrs["stage_seconds"][stage] >= 0.0
    cells = _port(x, groups, reference="p0", devices=(2, 2))
    assert cells.attrs["stage_seconds_by_device"]["cpu"]["reduce"] >= 0.0


@pytest.mark.parametrize("devices", [4, (2, 2)])
@pytest.mark.parametrize("reference", ["p0", None], ids=["ovo", "ovr"])
def test_device_resident_input_under_a_mesh(problem, reference, devices):
    """A tensor that already lives on a device is sliced per shard where it
    lives (driven here with a CPU tensor, as tests/test_torch_device_input.py
    does)."""
    x, labels = problem
    x = x[:, :250]
    groups = _groups(labels)
    want = _port(x, groups, reference=reference)
    saved = dict.__getitem__(data_handler_registry, torch.Tensor)
    data_handler_registry[torch.Tensor] = DeviceDenseDataHandler
    try:
        got = _port(torch.from_numpy(x.copy()), groups, reference=reference, devices=devices)
    finally:
        data_handler_registry[torch.Tensor] = saved
    _assert_bit_equal(got, want)
    assert got.attrs["stage_seconds"]["h2d"] == 0.0


def test_device_tile_cap_counts_what_each_device_holds(problem, monkeypatch):
    """The auto tile width's device bound: per column of a shard's share a
    device holds one histogram and its rows of the tile for every shard
    placed on it, and a cell-sharded column's lead also the histograms that
    arrive from other devices.  (No card here: the free memory is given.)"""
    import illico_tpu_torch.models.wilcoxon as runner_mod

    x, labels = problem
    _, info = encode_and_count_groups(labels, 0)
    a, b = torch.device("cpu"), torch.device("meta")
    free = 8 << 30
    monkeypatch.setattr(runner_mod, "device_free_bytes", lambda dev: free)
    usable = 0.5 * free - 4 * he.CONTRACT_CHUNK_BYTES
    hist_col, rows = info.n_groups * 128 * 4, x.shape[0] * 4

    def cap(mesh):
        runner = WilcoxonRunner(
            data_handler_registry.get(x), info, is_log1p=False, engine="hist",
            mesh=mesh, device=None if mesh is not None else a)
        return runner._device_tile_cap()

    assert cap(None) == int(usable / (hist_col + rows))
    # Two logical shards on one device share its memory and each takes the
    # contraction's workspace; two devices hold one shard each.
    shared = int((0.5 * free - 8 * he.CONTRACT_CHUNK_BYTES) / (2 * hist_col + 2 * rows))
    assert cap(pmesh.make_gene_mesh(devices=[a, a])) == 2 * shared
    assert cap(pmesh.make_gene_mesh(devices=[a, b])) == 2 * cap(None)
    # A cell-sharded column: both histograms end up on the lead.
    half = -(-x.shape[0] // 2) * 4
    assert cap(make_mesh_2d(2, 1, devices=[a, a])) == int(usable / (2 * hist_col + 2 * half))
    assert cap(make_mesh_2d(2, 1, devices=[a, b])) == int(usable / (2 * hist_col + half))
    monkeypatch.setattr(runner_mod, "device_free_bytes", lambda dev: None)
    assert cap(None) is None


# -- unequal shards ------------------------------------------------------------


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
@pytest.mark.parametrize("reference", [0, None], ids=["ovo", "ovr"])
def test_sharded_hist_unequal_shards_unpack_to_their_own_dicts(problem, reference, widths):
    """Two gene shards on one device share its tile function: shards whose
    widths pack to the same byte count (the last tile's shards of 2,046
    genes at devices=2, or a 30-column shard after its 32-column warm-up)
    each unpack to their own statistics."""
    x, labels = problem
    x = np.tile(x, (1, 8))[:, : sum(widths)]
    _, info = encode_and_count_groups(labels, reference)
    layout = build_padded_layout(info.perm, info.indptr)
    kw = dict(ref_code=info.ref_code, is_log1p=False)
    run = pmesh.make_sharded_hist_fn(layout, pmesh.make_gene_mesh(2, devices=CPU8), **kw)
    assert run.shards[0].fn is run.shards[1].fn
    single = he.make_hist_tile_fn(layout, device=CPU, pack=False, **kw)
    bounds = [(0, widths[0]), (widths[0], sum(widths))]
    tiles = [torch.from_numpy(np.ascontiguousarray(x[:, lb:ub])) for lb, ub in bounds]
    outs = run(tiles)
    assert outs[0].numel() == outs[1].numel()
    for (lb, ub), buf, shard, tile in zip(bounds, outs, run.shards, tiles):
        got = _unpacked(shard.fn, buf.numpy())
        for key, want in single(tile).items():
            np.testing.assert_array_equal(got[key][..., : ub - lb],
                                          want.numpy().astype(np.float64), err_msg=key)
