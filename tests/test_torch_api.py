"""Public API of the port against the JAX package and scipy, on the CPU.

For dense, CSR and CSC inputs at the conftest size (10k cells x 15 genes x
5 groups), ``illico_tpu_torch.asymptotic_wilcoxon(..., device="cpu")`` gives
the same DataFrame as ``illico_tpu.asymptotic_wilcoxon`` and as the scipy
oracle of ``tests/test_asymptotic_wilcoxon.py``: U exact, p within rtol
1e-12, fold change within rtol 1e-6.  Both packages run on their packed
result wire and their own build of the native C++ tail; every tile of the
port must report the native consume path.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from conftest import _make_rand_adata
from scipy import sparse
from test_asymptotic_wilcoxon import scipy_mannwhitneyu

import illico_tpu
import illico_tpu_torch


def _check_frames(got, want):
    assert got.index.equals(want.index)
    assert list(got.columns) == ["p_value", "statistic", "fold_change"]
    np.testing.assert_array_equal(got.statistic.values, want.statistic.values)
    np.testing.assert_allclose(got.p_value.values, want.p_value.values, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.fold_change.values, want.fold_change.values, rtol=1e-6)


def _check_scipy(got, adata, reference, use_continuity=True, alternative="two-sided",
                 tie_correct=True, check_fc=True):
    oracle = scipy_mannwhitneyu(
        adata, "pert", reference, use_continuity, alternative, tie_correct=tie_correct,
    )
    sub = got.loc[oracle.index]
    np.testing.assert_array_equal(sub.statistic.values, oracle.statistic.values)
    np.testing.assert_allclose(sub.p_value.values, oracle.p_value.values, rtol=1e-12, atol=0)
    if check_fc:
        np.testing.assert_allclose(sub.fold_change.values, oracle.fold_change.values, rtol=1e-6)


def _both(adata, **kw):
    got = illico_tpu_torch.asymptotic_wilcoxon(adata, device="cpu", progress=False, **kw)
    path = got.attrs["consume_path"]
    assert path["numpy"] == 0 and path["native"] >= 1, path
    want = illico_tpu.asymptotic_wilcoxon(adata, progress=False, **kw)
    return got, want


@pytest.mark.parametrize("fmt", ["dense", "csr", "csc"])
@pytest.mark.parametrize("test", ["ovo", "ovr"])
def test_formats_match_reference_and_scipy(fmt, test):
    adata = _make_rand_adata(fmt)
    cached = adata.copy()
    reference = "pert_0" if test == "ovo" else None
    kw = dict(is_log1p=False, group_keys="pert", reference=reference, batch_size=16)
    got, want = _both(adata, **kw)
    assert got.attrs["engine"] == "hist"
    _check_frames(got, want)
    _check_scipy(got, adata, reference)
    # Inputs are left untouched.
    X = adata.X if isinstance(adata.X, np.ndarray) else adata.X.toarray()
    X0 = cached.X if isinstance(cached.X, np.ndarray) else cached.X.toarray()
    np.testing.assert_array_equal(X, X0)
    pd.testing.assert_frame_equal(adata.obs, cached.obs)


@pytest.mark.parametrize("alternative", ["two-sided", "less", "greater"])
@pytest.mark.parametrize("tie_correct", [True, False], ids=["tie-correct", "no-tie-correct"])
@pytest.mark.parametrize("use_continuity", [True, False])
@pytest.mark.parametrize("test", ["ovo", "ovr"])
def test_options_match_reference_and_scipy(test, use_continuity, tie_correct, alternative):
    adata = _make_rand_adata("dense")
    reference = "pert_0" if test == "ovo" else None
    kw = dict(
        is_log1p=False, group_keys="pert", reference=reference,
        use_continuity=use_continuity, tie_correct=tie_correct, alternative=alternative,
    )
    got, want = _both(adata, **kw)
    _check_frames(got, want)
    _check_scipy(got, adata, reference, use_continuity, alternative, tie_correct)


@pytest.mark.parametrize("test", ["ovo", "ovr"])
def test_log1p_and_overflow_columns(test):
    """log1p data, and counts past the value table: those columns take the
    sort-engine fallback and stay exact.  The sampled maximum (650) picks
    the largest table, V=512, so the column of 300s is tabulated."""
    from illico_tpu_torch.ops import hist_engine

    adata = _make_rand_adata("dense", n_genes=20, seed=1)
    X = adata.X.copy()
    X[::97, 7] = 650.0  # past MAX_V: overflow column (sampling sees 0..19)
    X[::89, 11] = 300.0  # in the V=512 table
    raw = type(adata)(X, adata.obs.copy(), adata.var.copy())
    for is_log1p in (False, True):
        Xi = np.log1p(X).astype(np.float32) if is_log1p else X
        ad = type(adata)(Xi, adata.obs.copy(), adata.var.copy())
        reference = "pert_0" if test == "ovo" else None
        hist_engine.hist_pass.v_buckets = None
        got, want = _both(ad, is_log1p=is_log1p, group_keys="pert", reference=reference)
        assert got.attrs["engine"] == "hist"
        assert hist_engine.hist_pass.v_buckets == 512
        assert got.attrs["n_fallback_cols"] == 1  # column 7
        _check_frames(got, want)
        # Ranks, hence U and p, are those of the raw counts; the log1p fold
        # change is held against the reference package above.
        _check_scipy(got, raw, reference, check_fc=not is_log1p)


@pytest.mark.parametrize("engine", ["auto", "sort"])
def test_float64_routes_to_sort(engine):
    adata = _make_rand_adata("dense", seed=2)
    X = adata.X.astype(np.float64)
    X[:, :5] += 1e-12  # off the float32 grid
    ad = type(adata)(X, adata.obs.copy(), adata.var.copy())
    got, want = _both(ad, is_log1p=False, group_keys="pert", reference="pert_1", engine=engine)
    assert got.attrs["engine"] == "sort"
    _check_frames(got, want)
    _check_scipy(got, ad, "pert_1")
    with pytest.raises(ValueError, match="float64"):
        illico_tpu_torch.asymptotic_wilcoxon(
            ad, is_log1p=False, group_keys="pert", engine="hist", device="cpu",
            progress=False,
        )


@pytest.mark.parametrize("engine", ["auto", "hist", "sort", "csort"])
@pytest.mark.parametrize("test", ["ovo", "ovr"])
def test_zero_genes_give_the_empty_frame(engine, test):
    """A matrix with no genes gives the empty (0, 3) frame on every engine:
    the JAX package's sort-engine frame (its histogram engine raises
    ZeroDivisionError there, a fault of the reference)."""
    x = np.zeros((60, 0), np.float32)
    labels = np.array(["a", "b", "c"] * 20)
    reference = "a" if test == "ovo" else None
    got = illico_tpu_torch.asymptotic_wilcoxon_arrays(
        x, labels, reference=reference, engine=engine, progress=False, device="cpu")
    want = illico_tpu.asymptotic_wilcoxon_arrays(
        x, labels, reference=reference, engine="sort", progress=False)
    assert got.shape == want.shape == (0, 3)
    pd.testing.assert_frame_equal(got, want)


def _reference_engine(ad, reference=None):
    """The engine ``engine="auto"`` picks in the JAX package."""
    from illico_tpu.models.wilcoxon import WilcoxonRunner
    from illico_tpu.utils.groups import encode_and_count_groups
    from illico_tpu.utils.registry import data_handler_registry

    _, info = encode_and_count_groups(np.asarray(ad.obs["pert"]), reference)
    return WilcoxonRunner(data_handler_registry.get(ad.X), info, is_log1p=False).engine


def test_normalized_float32_routes_to_sort():
    """Non-count float32 data that is mostly nonzero never hits the value
    table and is too dense for the compact sort: auto picks sort, as the
    reference does."""
    adata = _make_rand_adata("dense", seed=3)
    X = ((adata.X + 1.0) / np.float32(3.7)).astype(np.float32)
    ad = type(adata)(X, adata.obs.copy(), adata.var.copy())
    got, want = _both(ad, is_log1p=False, group_keys="pert", reference=None)
    assert got.attrs["engine"] == _reference_engine(ad) == "sort"
    _check_frames(got, want)
    _check_scipy(got, ad, None)


@pytest.mark.parametrize("test", ["ovo", "ovr"])
def test_normalized_float32_routes_to_csort(test):
    """Non-count float32 data at most half nonzero: auto picks the compact
    sort, as the reference does."""
    adata = _make_rand_adata("dense", seed=3)
    X = (adata.X / np.float32(3.7)).astype(np.float32)
    ad = type(adata)(X, adata.obs.copy(), adata.var.copy())
    reference = "pert_0" if test == "ovo" else None
    got, want = _both(ad, is_log1p=False, group_keys="pert", reference=reference)
    assert got.attrs["engine"] == _reference_engine(ad, reference) == "csort"
    _check_frames(got, want)
    _check_scipy(got, ad, reference)


@pytest.mark.parametrize("fmt", ["dense", "csr", "csc"])
@pytest.mark.parametrize("test", ["ovo", "ovr"])
def test_csort_engine_matches_reference_and_scipy(fmt, test):
    adata = _make_rand_adata(fmt, seed=4)
    reference = "pert_0" if test == "ovo" else None
    kw = dict(is_log1p=False, group_keys="pert", reference=reference, engine="csort",
              batch_size=8)  # two tiles, the second one short
    got, want = _both(adata, **kw)
    assert got.attrs["engine"] == "csort"
    _check_frames(got, want)
    _check_scipy(got, adata, reference)


def _nan_input():
    """3,000 cells x 40 genes of Poisson(2) at ~20% density, groups
    ctl/a/b/c, and one NaN in a cell of group c."""
    rng = np.random.RandomState(0)
    X = rng.poisson(2.0, (3000, 40)).astype(np.float32)
    X[rng.rand(3000, 40) >= 0.2] = 0
    groups = rng.choice(["ctl", "a", "b", "c"], 3000)
    groups[0] = "c"
    X[0, 0] = np.nan
    return X, groups


@pytest.fixture(params=["native", "numpy"])
def consume_path(request, monkeypatch):
    """Run the port on its native tail, then with the library hidden."""
    import illico_tpu_torch.native as native

    assert native.native_available()
    if request.param == "numpy":
        monkeypatch.setattr(native, "_LIB", None)
    return request.param


@pytest.mark.parametrize("engine", ["sort", "csort", "auto"])
@pytest.mark.parametrize("test", ["ovo", "ovr"])
def test_nan_input_matches_reference(engine, test, consume_path):
    """A NaN makes the fold-change sums of its group, and of every group
    after it in code order, NaN.  The reference reads a NaN sum as 0.0
    (its result wire's NaN-to-integer conversion), so fold changes against
    a NaN reference mean are inf and those of a NaN group are 0."""
    X, groups = _nan_input()
    reference = "ctl" if test == "ovo" else None
    kw = dict(reference=reference, engine=engine, progress=False)
    got = illico_tpu_torch.asymptotic_wilcoxon_arrays(X, groups, device="cpu", **kw)
    want = illico_tpu.asymptotic_wilcoxon_arrays(X, groups, **kw)
    assert got.attrs["engine"] == (engine if engine != "auto" else "csort")
    assert got.attrs["consume_path"][consume_path] == 1
    assert got.attrs["consume_path"][{"native": "numpy", "numpy": "native"}[consume_path]] == 0
    _check_frames(got, want)
    for col in ("p_value", "statistic", "fold_change"):
        np.testing.assert_array_equal(np.isnan(got[col]), np.isnan(want[col]), err_msg=col)
        np.testing.assert_array_equal(np.isinf(got[col]), np.isinf(want[col]), err_msg=col)
    fc0 = got.xs("gene_0", level="feature").fold_change
    if reference:
        assert np.isinf(fc0.drop("ctl")).all()
    else:
        assert (fc0[["c", "ctl"]] == 0.0).all()


def _ksplit_input(seed, **kw):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "ops"))
    from test_ksplit_wire import _ksplit_problem

    x, info, _ = _ksplit_problem(seed=seed, **kw)
    return x, info, np.array([f"g{i:03d}" for i in info.encoded_groups])


def _runners(x, labels, engine, reference="g000"):
    from illico_tpu.models.wilcoxon import WilcoxonRunner as JaxRunner
    from illico_tpu.utils.groups import encode_and_count_groups as jax_encode
    from illico_tpu.utils.registry import data_handler_registry as jax_registry
    from illico_tpu_torch.models.wilcoxon import WilcoxonRunner
    from illico_tpu_torch.utils.groups import encode_and_count_groups
    from illico_tpu_torch.utils.registry import data_handler_registry

    _, jinfo = jax_encode(labels, reference)
    _, info = encode_and_count_groups(labels, reference)
    want = JaxRunner(jax_registry.get(x), jinfo, is_log1p=False, engine=engine)
    got = WilcoxonRunner(data_handler_registry.get(x), info, is_log1p=False,
                         engine=engine, device=torch.device("cpu"))
    return got, want


def test_ksplit_public_api_end_to_end_with_fallback(consume_path):
    """The nnz-split wire through the public API, one column overflowing its
    exception slots into the sort fallback
    (tests/ops/test_ksplit_wire.py::test_ksplit_public_api_end_to_end_with_fallback)."""
    kw = dict(reference="g000", engine="hist", progress=False)
    for density, n_fallback in ((0.12, 0), (0.25, 1)):  # the reference's input, then a denser one
        x, info, labels = _ksplit_input(13, t=40, density=density)
        for g in range(1, 28):
            x[np.flatnonzero(info.encoded_groups == g), 5] = 2.0
        got = illico_tpu_torch.asymptotic_wilcoxon_arrays(x, labels, device="cpu", **kw)
        want = illico_tpu.asymptotic_wilcoxon_arrays(x, labels, **kw)
        assert got.attrs["n_fallback_cols"] == n_fallback
        assert got.attrs["consume_path"][consume_path] == 1
        _check_frames(got, want)
    by_sort = illico_tpu_torch.asymptotic_wilcoxon_arrays(
        x, labels, device="cpu", reference="g000", engine="sort", progress=False)
    np.testing.assert_array_equal(got.statistic.values, by_sort.statistic.values)
    np.testing.assert_allclose(got.p_value.values, by_sort.p_value.values, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.fold_change.values, by_sort.fold_change.values, rtol=1e-12)
    runner, _ = _runners(x, labels, "hist")
    assert runner.tile_fn._statics["nnz_split"] is True


def test_fc_u8_hint_equals_reference():
    """The inputs of
    tests/ops/test_ksplit_wire.py::test_ksplit_runner_engages_fc_u8_from_sampling:
    the sampled column statistics, the hint and the wire statics are the
    reference's."""
    x, _, labels = _ksplit_input(21)
    x2 = x * 40.0
    x2[x2 > 500] = 500.0
    for data, engaged in ((x, True), (np.ascontiguousarray(x2), False)):
        got, want = _runners(data, labels, "hist")
        assert got._fc_u8_hint() == want._fc_u8_hint() == engaged
        for a, b in zip(got._sampled_colstats, want._sampled_colstats):
            np.testing.assert_array_equal(a, b)
        assert got._nnz_split_hint() is True
        ref_statics = {k: v for k, v in want.tile_fn._statics.items()
                       if k not in ("n_groups", "interpret")}
        assert got.tile_fn._statics == ref_statics


def test_nnz_split_hint_keeps_the_wire_off_dense_screens():
    """A large control group and 30% nonzeros: nearly every column would
    send more U2 residuals past uint16 than it has exception slots, so the
    sampled estimate keeps the nnz-split wire off; the result is the
    reference's either way."""
    x, info, labels = _ksplit_input(5, n_ref=30000, g_other=40, n_per=200, t=30, density=0.3)
    runner, ref_runner = _runners(x, labels, "hist")
    assert ref_runner.tile_fn._statics["nnz_split"] is True
    assert runner._nnz_split_hint() is False
    assert runner.tile_fn._statics["nnz_split"] is False
    kw = dict(reference="g000", engine="hist", progress=False)
    got = illico_tpu_torch.asymptotic_wilcoxon_arrays(x, labels, device="cpu", **kw)
    want = illico_tpu.asymptotic_wilcoxon_arrays(x, labels, **kw)
    assert got.attrs["n_fallback_cols"] == 0
    _check_frames(got, want)


def test_arrays_api_matches_reference():
    rng = np.random.RandomState(5)
    X = rng.poisson(1.5, (600, 9)).astype(np.int16)
    groups = rng.choice(["ctl", "a", "b"], 600)
    got = illico_tpu_torch.asymptotic_wilcoxon_arrays(
        X, groups, reference="ctl", device="cpu", progress=False,
    )
    want = illico_tpu.asymptotic_wilcoxon_arrays(X, groups, reference="ctl", progress=False)
    _check_frames(got, want)
    np.testing.assert_array_equal(got.loc["ctl"].statistic.values, -1.0)


def test_unsorted_csr_indices_raise():
    X = sparse.csr_matrix(_make_rand_adata("dense").X)
    X.indices[:] = X.indices[::-1]
    adata = _make_rand_adata("dense")
    adata.X = X
    with pytest.raises(ValueError, match="unsorted column indices"):
        illico_tpu_torch.asymptotic_wilcoxon(
            adata, is_log1p=False, group_keys="pert", reference="pert_0",
            device="cpu", progress=False,
        )


def test_argument_errors(monkeypatch):
    adata = _make_rand_adata("dense", n_cells=200)
    kw = dict(is_log1p=False, group_keys="pert", progress=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        illico_tpu_torch.asymptotic_wilcoxon(adata, **kw)
    with pytest.raises(ValueError, match="Invalid engine"):
        illico_tpu_torch.asymptotic_wilcoxon(adata, engine="bogus", device="cpu", **kw)
    with pytest.raises(ValueError, match="pair"):
        illico_tpu_torch.asymptotic_wilcoxon(adata, devices=(2,), device="cpu", **kw)
    with pytest.raises(ValueError, match=">= 1"):
        illico_tpu_torch.asymptotic_wilcoxon(adata, devices=(2, 0), device="cpu", **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        illico_tpu_torch.asymptotic_wilcoxon(adata, devices=2, **kw)
    with pytest.raises(ValueError, match="Unsupported alternative"):
        illico_tpu_torch.asymptotic_wilcoxon(adata, alternative="x", device="cpu", **kw)
    with pytest.raises(ValueError, match="not present"):
        illico_tpu_torch.asymptotic_wilcoxon(adata, reference="nope", device="cpu", **kw)
    with pytest.raises(KeyError, match="is not implemented"):
        illico_tpu_torch.asymptotic_wilcoxon_arrays(
            pd.DataFrame(adata.X), np.zeros(200), device="cpu", progress=False,
        )


def test_import_leaves_jax_out():
    code = (
        "import sys, illico_tpu_torch, illico_tpu_torch.models.wilcoxon, "
        "illico_tpu_torch.ops.hist_engine, illico_tpu_torch.utils.cuda_build, "
        "illico_tpu_torch.ops.csort_engine, illico_tpu_torch.io.h5ad, "
        "illico_tpu_torch.ops.wire, illico_tpu_torch.native, illico_tpu_torch.stats, "
        "illico_tpu_torch.utils.registry, illico_tpu_torch.parallel.mesh, "
        "illico_tpu_torch.parallel.cells, illico_tpu_torch.parallel.multihost; "
        "assert illico_tpu_torch.native.native_available(); "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'illico_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    # The multi-process layer is lazy: importing the package loads neither
    # it nor any module of torch.distributed beyond what ``import torch``
    # itself loads, and starts no process group.
    code = (
        "import sys, torch\n"
        "before = {m for m in sys.modules if m.startswith('torch.distributed')}\n"
        "import illico_tpu_torch\n"
        "after = {m for m in sys.modules if m.startswith('torch.distributed')}\n"
        "assert after == before, sorted(after - before)\n"
        "assert 'illico_tpu_torch.parallel.multihost' not in sys.modules\n"
        "fn = illico_tpu_torch.asymptotic_wilcoxon_multihost\n"
        "assert 'illico_tpu_torch.parallel.multihost' in sys.modules\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_enable_compilation_cache_builds_into_its_directory(tmp_path):
    """``enable_compilation_cache(path)`` builds the native tail into
    ``path`` now (no nvcc and no CUDA device here, so no kernel), a later
    API call loads it from there, and a call for another directory after
    first use raises.  In a subprocess: it changes process-wide state."""
    code = (
        "import os, sys, numpy as np, illico_tpu_torch\n"
        "import illico_tpu_torch.native as native\n"
        "cache, other = sys.argv[1], sys.argv[2]\n"
        "got = illico_tpu_torch.enable_compilation_cache(cache)\n"
        "assert got == os.path.realpath(cache), got\n"
        "built = os.listdir(cache)\n"
        "assert len(built) == 1 and built[0].startswith('illico_tail_'), built\n"
        "x = np.zeros((50, 3), np.float32); x[::7] = 1.5\n"
        "df = illico_tpu_torch.asymptotic_wilcoxon_arrays(x, np.arange(50) % 2, "
        "device='cpu', progress=False)\n"
        "assert df.attrs['consume_path'] == {'native': 1, 'numpy': 0}\n"
        "assert os.path.dirname(native.BUILD_INFO['path']) == got\n"
        "assert os.listdir(cache) == built\n"
        "assert illico_tpu_torch.enable_compilation_cache(cache) == got\n"
        "try:\n"
        "    illico_tpu_torch.enable_compilation_cache(other)\n"
        "except RuntimeError as e:\n"
        "    assert 'before first use' in str(e)\n"
        "    print('RAISED')\n"
        "os.environ['ILLICO_TPU_COMPILE_CACHE'] = cache\n"
        "assert illico_tpu_torch.enable_compilation_cache() == got\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "cache"), str(tmp_path / "other")],
        capture_output=True, text=True, timeout=240,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "RAISED" in res.stdout


def test_in_ram_call_runs_without_h5py():
    """h5py is a soft dependency: with it unimportable, the package imports
    and an in-RAM API call (csort, which registers the backed handlers)
    runs."""
    code = (
        "import sys; sys.modules['h5py'] = None\n"
        "import numpy as np, illico_tpu_torch\n"
        "x = np.zeros((50, 3), np.float32); x[::7] = 1.5\n"
        "df = illico_tpu_torch.asymptotic_wilcoxon_arrays(x, np.arange(50) % 2, "
        "device='cpu', progress=False, engine='csort')\n"
        "assert 'h5py' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
        "print(df.shape)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "(6, 3)" in res.stdout
