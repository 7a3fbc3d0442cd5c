"""Compact sort engine of the port against the JAX package, on the CPU.

Same inputs (numpy seeds) through ``illico_tpu.ops.csort_engine`` (JAX on
the CPU, x64 from ``conftest.py``) and ``illico_tpu_torch.ops.csort_engine``:

- the host tiler's arrays are byte-identical;
- ``csort_stats_tile``: integer statistics (R2, U2, integer-valued tie and
  fc sums) equal bit for bit, float64 sums of non-integer values within
  rtol 1e-12, ``fc_sums`` under log1p within rtol 1e-6 (torch's and XLA's
  float32 ``expm1`` may differ by ULPs), on every branch of the port
  (int32 block partials, float64 segment sums, float64 payloads);
- the port's csort against the port's own full-column sort engine;
- the runner's ``engine="auto"`` choice against the JAX runner's on the
  routing cases of ``tests/test_csort_routing.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import illico_tpu.ops.csort_engine as jcs
from illico_tpu.models.wilcoxon import WilcoxonRunner as JaxRunner
from illico_tpu.utils.groups import encode_and_count_groups as jax_encode
from illico_tpu.utils.registry import data_handler_registry as jax_registry
from illico_tpu_torch.models.wilcoxon import WilcoxonRunner
from illico_tpu_torch.ops import csort_engine as tcs
from illico_tpu_torch.ops import rank_engine as tre
from illico_tpu_torch.utils.groups import encode_and_count_groups
from illico_tpu_torch.utils.registry import data_handler_registry

KINDS = ["raw", "negative", "float64", "log1p"]


def _tile(kind, seed=0, n=300, t=9, g=5):
    """(x, labels): a sparse tile with an all-zero column (0), a full column
    (1), real +inf values tied with the pads (2) and a NaN (3)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, g, n)
    labels[:g] = np.arange(g)  # every group nonempty
    x = rng.poisson(3.0, (n, t)).astype(np.float64)
    x[rng.rand(n, t) >= 0.3] = 0
    x[:, 0] = 0.0
    x[:, 1] = rng.randint(1, 6, n)
    x[rng.rand(n) < 0.05, 2] = np.inf
    x[7, 3] = np.nan
    if kind == "negative":
        x = np.where(x != 0, x - 3.5 + rng.randn(n, t).round(1), 0.0)
    if kind == "float64":
        x[:, 4:] += np.where(x[:, 4:] != 0, 1e-12, 0.0)  # ties off the f32 grid
        return x, labels
    if kind == "log1p":
        return np.log1p(x).astype(np.float32), labels
    return x.astype(np.float32), labels


def _entries(x, rng):
    """Nonzero entries shuffled, with explicit zeros mixed in."""
    r, c = np.nonzero(x)
    zr, zc = np.nonzero(x == 0)
    pick = rng.choice(zr.size, 15, replace=False)
    r = np.concatenate([r, zr[pick]])
    c = np.concatenate([c, zc[pick]])
    order = rng.permutation(r.size)
    return x[r, c][order], r[order], c[order]


def _compact(x, labels, ref, lib):
    encode = jax_encode if lib is jcs else encode_and_count_groups
    _, info = encode(labels.astype(str), ref)
    v, r, c = _entries(x, np.random.RandomState(1))
    tile = lib.compact_from_entries(
        v, r, c, x.shape[1], info.encoded_groups, info.n_groups,
        value_dtype=x.dtype, need_grp=ref is not None,
    )
    return tile, info


@pytest.mark.parametrize("need_grp", [True, False], ids=["ovo", "ovr"])
@pytest.mark.parametrize("kind", ["negative", "float64"])
@pytest.mark.parametrize("t_pad", [0, 7], ids=["exact-width", "padded-width"])
def test_compact_from_entries_byte_equal(kind, need_grp, t_pad):
    x, labels = _tile(kind)
    _, info = encode_and_count_groups(labels.astype(str), None)
    rng = np.random.RandomState(2)
    v, r, c = _entries(x, rng)
    # Duplicate (row, col) entries travel through the tiler unchanged.
    dup = rng.choice(v.size, 10, replace=False)
    v, r, c = (np.concatenate([a, a[dup]]) for a in (v, r, c))
    args = (v, r, c, x.shape[1] + t_pad, info.encoded_groups, info.n_groups)
    kw = dict(value_dtype=x.dtype, need_grp=need_grp)
    want = jcs.compact_from_entries(*args, **kw)
    got = tcs.compact_from_entries(*args, **kw)
    for name in ("vals", "grp", "indptr"):
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    assert got.t_cols == want.t_cols


@pytest.mark.parametrize("n_keys", [100, 70_000, 2**31 - 1])
def test_stable_argsort_matches_numpy(n_keys):
    rng = np.random.RandomState(3)
    key = rng.randint(0, n_keys, 5000).astype(np.int32)
    key[::7] = key[0]  # long runs of equal keys: stability matters
    np.testing.assert_array_equal(
        tcs._stable_argsort(key, n_keys), np.argsort(key, kind="stable")
    )


def test_compact_from_entries_byte_equal_wide_keys():
    """More (group, column) keys than 2**16: two radix passes."""
    rng = np.random.RandomState(4)
    n, t, g = 3000, 300, 400
    codes = rng.randint(0, g, n).astype(np.int32)
    nnz = 40_000
    args = (rng.rand(nnz).astype(np.float32) - 0.5, rng.randint(0, n, nnz),
            rng.randint(0, t, nnz), t, codes, g)
    want = jcs.compact_from_entries(*args)
    got = tcs.compact_from_entries(*args)
    for name in ("vals", "grp", "indptr"):
        assert getattr(got, name).tobytes() == getattr(want, name).tobytes(), name


@functools.lru_cache(maxsize=None)
def _reference_stats(kind, ref):
    x, labels = _tile(kind)
    tile, info = _compact(x, labels, ref, jcs)
    grp = tile.grp if tile.grp is not None else tile.vals
    with jax.enable_x64(True):
        out = jcs.csort_stats_tile(
            jnp.asarray(tile.vals), jnp.asarray(grp), jnp.asarray(tile.indptr),
            jnp.asarray(info.counts), ref_code=info.ref_code,
            is_log1p=kind == "log1p", n_total=info.n_cells, pack=False,
        )
        return {k: np.asarray(v) for k, v in out.items()}


def _port_stats(kind, ref):
    x, labels = _tile(kind)
    tile, info = _compact(x, labels, ref, tcs)
    grp = None if tile.grp is None else torch.from_numpy(tile.grp.astype(np.int32))
    out = tcs.csort_stats_tile(
        torch.from_numpy(tile.vals), grp, torch.from_numpy(tile.indptr),
        torch.from_numpy(info.counts), ref_code=info.ref_code,
        is_log1p=kind == "log1p", n_total=info.n_cells,
    )
    return {k: v.numpy() for k, v in out.items()}


def _assert_stats_equal(got, want, kind):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype == np.float64, k
        if k == "fc_sums" and kind == "log1p":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        elif k == "fc_sums" and kind in ("negative", "float64"):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ref", [None, "2"], ids=["ovr", "ovo"])
@pytest.mark.parametrize("branch", ["i32", "f64-segsum", "wide-payload"])
def test_csort_stats_tile_matches_reference(kind, ref, branch, monkeypatch):
    if branch != "i32":
        monkeypatch.setattr(tcs, "_I32_SAFE_N_TOTAL", 0)
    if branch == "wide-payload":
        monkeypatch.setattr(tcs, "_WIDE_PAYLOAD_N_TOTAL", 0)
    _assert_stats_equal(_port_stats(kind, ref), _reference_stats(kind, ref), kind)


@pytest.mark.parametrize("kind", ["raw", "negative", "float64"])
@pytest.mark.parametrize("ref", [None, "2"], ids=["ovr", "ovo"])
def test_csort_matches_port_sort_engine(kind, ref):
    x, labels = _tile(kind)
    x[:, 2:4] = 0.0  # +inf and NaN rank differently in the two engines
    tile, info = _compact(x, labels, ref, tcs)
    run = tcs.make_csort_tile_fn(
        info, ref_code=info.ref_code, is_log1p=False, device=torch.device("cpu"),
        pack=False,
    )
    got = {k: v.numpy() for k, v in run(tile).items()}
    layout = tre.build_padded_layout(info.perm, info.indptr)
    sort_fn = tre.make_tile_fn(
        layout, ref_code=info.ref_code, is_log1p=False, device=torch.device("cpu")
    )
    want = {k: v.numpy() for k, v in sort_fn(torch.from_numpy(x)).items()}
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if k in ("U2", "tie_seg"):  # csort zeroes the reference's own row
            g, w = np.delete(g, info.ref_code, 0), np.delete(w, info.ref_code, 0)
        if k in ("fc_sums", "tie_seg") and kind != "raw":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_tile_fn_widens_uint16_groups():
    x, labels = _tile("raw")
    tile, info = _compact(x, labels, "1", tcs)
    assert tile.grp.dtype == np.uint16
    run = tcs.make_csort_tile_fn(info, ref_code=info.ref_code, is_log1p=False,
                                 device=torch.device("cpu"), pack=False)
    got = run(tile)
    want = tcs.csort_stats_tile(
        torch.from_numpy(tile.vals), torch.from_numpy(tile.grp.astype(np.int32)),
        torch.from_numpy(tile.indptr), torch.from_numpy(info.counts),
        ref_code=info.ref_code, is_log1p=False, n_total=info.n_cells,
    )
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, equal_nan=True)


# -- engine routing, the cases of tests/test_csort_routing.py ----------------
def _normalized(rng, n=600, t=40, g=5, density=0.3):
    labels = rng.randint(0, g, n).astype(str)
    x = rng.poisson(2.0, (n, t)).astype(np.float64)
    x[rng.rand(n, t) >= density] = 0
    totals = x.sum(axis=1, keepdims=True)
    totals[totals == 0] = 1.0
    return np.log1p(x / totals * 1e4).astype(np.float32), labels


def _counts(seed, lam, density, cap=None, hot=False):
    rng = np.random.RandomState(seed)
    n, t, g = 500, 30, 4
    labels = rng.randint(0, g, n).astype(str)
    x = rng.poisson(lam, (n, t)).astype(np.float32)
    x[rng.rand(n, t) >= density] = 0
    if cap is not None:
        x = np.minimum(x, cap)
    if hot:
        x[:5, 15] = 1000.0
    return sp.csr_matrix(x), labels


def _routing_case(name):
    if name.startswith("normalized-"):
        xn, labels = _normalized(np.random.RandomState(0))
        fmt = name.split("-")[1]
        return {"csr": sp.csr_matrix, "csc": sp.csc_matrix, "dense": np.asarray}[fmt](xn), labels
    if name == "dense-sampled-density":
        return _normalized(np.random.RandomState(1), density=0.25)
    if name == "dense-above-threshold":
        return _normalized(np.random.RandomState(2), density=0.95)
    if name == "high-counts":
        return _counts(3, 5000.0, 0.4)
    if name == "mid-band-counts":
        return _counts(3, 5000.0, 0.4, cap=900.0)
    if name == "few-overflow-columns":
        return _counts(13, 3.0, 0.35, hot=True)
    if name == "float64-sparse":
        xn, labels = _normalized(np.random.RandomState(4))
        return sp.csr_matrix(xn.astype(np.float64)), labels
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "normalized-csr", "normalized-csc", "normalized-dense",
    "dense-sampled-density", "dense-above-threshold", "high-counts",
    "mid-band-counts", "few-overflow-columns", "float64-sparse",
])
def test_auto_routing_matches_reference(name):
    X, labels = _routing_case(name)
    _, jinfo = jax_encode(labels, None)
    want = JaxRunner(jax_registry.get(X), jinfo, is_log1p=False)
    _, info = encode_and_count_groups(labels, None)
    got = WilcoxonRunner(data_handler_registry.get(X), info, is_log1p=False,
                         device=torch.device("cpu"))
    assert got.engine == want.engine, name
    assert got._sampled_density == want._sampled_density
    assert got._sampled_overflow_frac == want._sampled_overflow_frac
