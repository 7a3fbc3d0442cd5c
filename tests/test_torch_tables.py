"""The heavy-tailed count path of the port against the JAX package, on the CPU.

Raw UMI counts of highly expressed genes reach the hundreds and thousands,
so the runner sizes the histogram's value table at V=512 and sends the
columns with counts past it to the exact sort fallback.  The counts here
come from the Poisson-lognormal model of ``chip_smoke.py``'s
``heavy_tailed_counts`` (made with numpy, at 3,000 cells x 64 genes x 8
groups), with a few columns planted past 511 and some in 256-510.  Every
frame of the port (dense, CSR and CPU-tensor input; raw counts and numpy
float32 ``log1p``; OVO and OVR) must pick the histogram engine at V=512,
send at least one and fewer than half of the columns to the fallback, and
equal the JAX package's frame (its histogram kernel in interpret mode): U
equal, p within rtol 1e-12, fold change within rtol 1e-6 (under log1p the
fold change goes through ``expm1`` in float32 on both sides and is never
held bit for bit).
"""

import functools

import numpy as np
import pytest
import torch
from scipy import sparse

import illico_tpu
import illico_tpu_torch
from illico_tpu.models.wilcoxon import WilcoxonRunner as JaxRunner
from illico_tpu.utils.groups import encode_and_count_groups as jax_encode
from illico_tpu.utils.registry import data_handler_registry as jax_registry
from illico_tpu_torch.models.wilcoxon import WilcoxonRunner
from illico_tpu_torch.ops import hist_engine as he
from illico_tpu_torch.utils.groups import encode_and_count_groups
from illico_tpu_torch.utils.registry import DeviceDenseDataHandler, data_handler_registry

N_CELLS, N_GENES, N_GROUPS = 3000, 64, 8
PAST_TABLE = [5, 30, 57]  # planted counts past the largest table (V=512)
UPPER_TABLE = [12, 44, 61]  # planted counts in 256-510: V=512, no fallback


def heavy_tailed_counts(rng, n_cells, n_genes, m=-4.0, s=2.6, c=0.5, sigma=1.3):
    """float32 UMI-like counts: gene mean exp(N(m, s^2)), cell size factor
    exp(N(0, c^2)), x ~ Poisson(mean * size * exp(sigma * eps - sigma^2 / 2))."""
    mu = np.exp(rng.normal(m, s, n_genes))
    ell = np.exp(rng.normal(0.0, c, n_cells))[:, None]
    eps = rng.standard_normal((n_cells, n_genes))
    return rng.poisson(mu * ell * np.exp(sigma * eps - sigma**2 / 2)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _problem():
    rng = np.random.default_rng(6)
    x = heavy_tailed_counts(rng, N_CELLS, N_GENES)
    for j in PAST_TABLE:
        x[rng.integers(0, N_CELLS, 4), j] = rng.integers(512, 4000, 4)
    for j in UPPER_TABLE:
        x[rng.integers(0, N_CELLS, 4), j] = rng.integers(256, 511, 4)
    codes = rng.integers(1, N_GROUPS, N_CELLS)
    codes[rng.random(N_CELLS) < 0.1] = 0
    labels = np.where(codes == 0, "ctl", np.char.add("g", codes.astype(str)))
    x.setflags(write=False)
    return x, labels


def _values(is_log1p):
    x, _ = _problem()
    return np.log1p(x).astype(np.float32) if is_log1p else x


def _input(fmt, is_log1p):
    x = _values(is_log1p)
    if fmt == "csr":
        return sparse.csr_matrix(x)
    if fmt == "tensor":
        return torch.from_numpy(x.copy())
    return x.copy()


@functools.lru_cache(maxsize=None)
def _reference(fmt, is_log1p, reference):
    """The JAX package's frame (a CPU tensor is its dense input)."""
    x = _input("dense" if fmt == "tensor" else fmt, is_log1p)
    _, labels = _problem()
    return illico_tpu.asymptotic_wilcoxon_arrays(
        x, labels, is_log1p=is_log1p, reference=reference, progress=False,
    )


def test_problem_plants_both_bands():
    """The data exercise what the cases claim: some columns past the table,
    some in its upper half, most below 128, ~90% zeros."""
    x, _ = _problem()
    col_max = x.max(axis=0)
    past = np.flatnonzero(col_max >= 512)
    assert set(PAST_TABLE) <= set(past) and past.size < N_GENES // 2
    assert set(UPPER_TABLE) <= set(np.flatnonzero((col_max >= 256) & (col_max < 512)))
    assert np.mean(col_max < 128) > 0.5
    assert 0.8 < np.mean(x == 0) < 0.95


@pytest.mark.parametrize("fmt", ["dense", "csr", "tensor"])
@pytest.mark.parametrize("is_log1p", [False, True], ids=["raw", "log1p"])
@pytest.mark.parametrize("test", ["ovo", "ovr"])
def test_heavy_tailed_counts_match_reference(fmt, is_log1p, test):
    x, labels = _problem()
    reference = "ctl" if test == "ovo" else None
    he.hist_pass.v_buckets = None
    got = illico_tpu_torch.asymptotic_wilcoxon_arrays(
        _input(fmt, is_log1p), labels, is_log1p=is_log1p, reference=reference,
        progress=False, device="cpu",
    )
    assert got.attrs["engine"] == "hist"
    assert he.hist_pass.v_buckets == 512
    past = int(np.count_nonzero(x.max(axis=0) >= 512))
    assert 1 <= got.attrs["n_fallback_cols"] == past < N_GENES // 2
    assert got.attrs["consume_path"] == {"native": 1, "numpy": 0}
    want = _reference(fmt, is_log1p, reference)
    assert got.index.equals(want.index)
    np.testing.assert_array_equal(got.statistic.values, want.statistic.values)
    np.testing.assert_allclose(got.p_value.values, want.p_value.values, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.fold_change.values, want.fold_change.values, rtol=1e-6)


def _aliased_problem():
    """9,000 cells x 48 genes of counts below 128, and counts of 300 in two
    odd columns.  Each sampled window is 24 columns wide, so the host's
    strided value sample (every 2nd value of a C-ordered 9,000 x 24 window)
    reads the even columns only."""
    rng = np.random.default_rng(7)
    x = rng.poisson(0.3, (9000, 48)).astype(np.float32)
    x[rng.integers(0, 9000, 6), 13] = 300.0
    x[rng.integers(0, 9000, 6), 29] = 300.0
    labels = np.char.add("g", rng.integers(0, 6, 9000).astype(str))
    return x, labels


@pytest.mark.parametrize("fmt", ["dense", "csr"])
def test_host_sample_sizes_the_table_from_whole_windows(fmt):
    """Host input picks the value table that device-resident input picks: the
    sampled maximum is the whole windows', not the strided sample's.  The
    JAX package sizes it from the strided sample (V=128 here) and sends the
    two columns to the sort fallback; the port tabulates them at V=512.  The
    frames are equal either way."""
    x, labels = _aliased_problem()
    X = sparse.csr_matrix(x) if fmt == "csr" else x
    _, info = encode_and_count_groups(labels, "g0")
    cpu = torch.device("cpu")
    host = WilcoxonRunner(data_handler_registry.get(X), info, is_log1p=False, device=cpu)
    dev = WilcoxonRunner(DeviceDenseDataHandler(torch.from_numpy(x)), info, is_log1p=False,
                         device=cpu)
    assert host._sampled_vmax == dev._sampled_vmax == 300.0
    assert host._v_buckets == dev._v_buckets == 512
    _, jinfo = jax_encode(labels, "g0")
    assert JaxRunner(jax_registry.get(X), jinfo, is_log1p=False)._v_buckets == 128
    got = illico_tpu_torch.asymptotic_wilcoxon_arrays(X, labels, reference="g0",
                                                      progress=False, device="cpu")
    want = illico_tpu.asymptotic_wilcoxon_arrays(X, labels, reference="g0", progress=False)
    assert got.attrs["n_fallback_cols"] == 0
    np.testing.assert_array_equal(got.statistic.values, want.statistic.values)
    np.testing.assert_allclose(got.p_value.values, want.p_value.values, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.fold_change.values, want.fold_change.values, rtol=1e-6)
