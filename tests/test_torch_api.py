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


def test_normalized_float32_routes_to_sort():
    """Non-count float32 data never hits the value table: auto picks sort
    (the reference picks its compact sort here; results are the same)."""
    adata = _make_rand_adata("dense", seed=3)
    X = (adata.X / np.float32(3.7)).astype(np.float32)
    ad = type(adata)(X, adata.obs.copy(), adata.var.copy())
    got, want = _both(ad, is_log1p=False, group_keys="pert", reference=None)
    assert got.attrs["engine"] == "sort"
    _check_frames(got, want)
    _check_scipy(got, ad, None)


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
    with pytest.raises(NotImplementedError, match="csort"):
        illico_tpu_torch.asymptotic_wilcoxon(adata, engine="csort", device="cpu", **kw)
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
        "illico_tpu_torch.ops.hist_engine, illico_tpu_torch.utils.cuda_build; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'illico_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
