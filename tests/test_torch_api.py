"""Public API of the port against the JAX package and scipy, on the CPU.

For dense, CSR and CSC inputs at the conftest size (10k cells x 15 genes x
5 groups), ``illico_tpu_torch.asymptotic_wilcoxon(..., device="cpu")`` gives
the same DataFrame as ``illico_tpu.asymptotic_wilcoxon`` and as the scipy
oracle of ``tests/test_asymptotic_wilcoxon.py``: U exact, p within rtol
1e-12, fold change within rtol 1e-6.  The port's p-values come from numpy
and the reference's from its C++ tail, hence the p tolerance between them.
"""

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
    sort-engine fallback and stay exact."""
    adata = _make_rand_adata("dense", n_genes=20, seed=1)
    X = adata.X.copy()
    X[::97, 7] = 650.0  # past MAX_V: overflow column (sampling sees 0..19)
    X[::89, 11] = 300.0
    raw = type(adata)(X, adata.obs.copy(), adata.var.copy())
    for is_log1p in (False, True):
        Xi = np.log1p(X).astype(np.float32) if is_log1p else X
        ad = type(adata)(Xi, adata.obs.copy(), adata.var.copy())
        reference = "pert_0" if test == "ovo" else None
        got, want = _both(ad, is_log1p=is_log1p, group_keys="pert", reference=reference)
        assert got.attrs["engine"] == "hist"
        assert got.attrs["n_fallback_cols"] >= 2
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


@pytest.mark.parametrize("engine", ["sort", "csort", "auto"])
@pytest.mark.parametrize("test", ["ovo", "ovr"])
def test_nan_input_matches_reference(engine, test):
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
    _check_frames(got, want)
    for col in ("p_value", "statistic", "fold_change"):
        np.testing.assert_array_equal(np.isnan(got[col]), np.isnan(want[col]), err_msg=col)
        np.testing.assert_array_equal(np.isinf(got[col]), np.isinf(want[col]), err_msg=col)
    fc0 = got.xs("gene_0", level="feature").fold_change
    if reference:
        assert np.isinf(fc0.drop("ctl")).all()
    else:
        assert (fc0[["c", "ctl"]] == 0.0).all()


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
    with pytest.raises(NotImplementedError, match="devices"):
        illico_tpu_torch.asymptotic_wilcoxon(adata, devices=2, device="cpu", **kw)
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
        "illico_tpu_torch.ops.csort_engine, illico_tpu_torch.io.h5ad; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'illico_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


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
