"""h5ad IO and backed inputs of the port, against the JAX package, on the CPU.

The cases of ``tests/test_io.py`` for ``illico_tpu_torch.io.h5ad`` and the
port's backed handlers, plus the public API over backed dense and backed
CSC files, which must equal ``illico_tpu``'s DataFrame on the same file (U
exact, p within rtol 1e-12, fold change within rtol 1e-6).  Files are
written under ``tmp_path``.
"""

import numpy as np
import pandas as pd
import pytest
from scipy import sparse

import illico_tpu
import illico_tpu_torch
from illico_tpu.io import h5ad as jax_h5ad
from illico_tpu.utils import registry as jax_registry
from illico_tpu_torch.io.h5ad import AnnDataLite, BackedCSC, BackedCSR, read_h5ad, write_h5ad
from illico_tpu_torch.models.wilcoxon import WilcoxonRunner
from illico_tpu_torch.utils.groups import encode_and_count_groups
from illico_tpu_torch.utils.registry import data_handler_registry, ensure_backed_handlers

h5py = pytest.importorskip("h5py")


def _adata(fmt, n=300, t=20, normalized=False):
    rng = np.random.RandomState(0)
    dense = rng.poisson(1.5, (n, t)).astype(np.float32)
    dense[rng.rand(n, t) < 0.5] = 0
    if normalized:
        totals = np.maximum(dense.sum(axis=1, keepdims=True), 1.0)
        dense = np.log1p(dense / totals * 1e4).astype(np.float32)
    X = {"dense": dense,
         "csc": sparse.csc_matrix(dense),
         "csr": sparse.csr_matrix(dense)}[fmt]
    obs = pd.DataFrame({
        "pert": pd.Categorical([f"p{v}" for v in rng.randint(0, 4, n)]),
        "score": rng.rand(n).astype(np.float64),
        "name": [f"cell{i}" for i in range(n)],
    })
    var = pd.DataFrame(index=[f"gene_{i}" for i in range(t)])
    return AnnDataLite(X, obs, var), dense


@pytest.mark.parametrize("fmt", ["dense", "csc", "csr"])
def test_h5ad_roundtrip_eager(fmt, tmp_path):
    adata, dense = _adata(fmt)
    path = tmp_path / "x.h5ad"
    adata.write_h5ad(path)
    for back in (read_h5ad(path), jax_h5ad.read_h5ad(path)):
        X = back.X if isinstance(back.X, np.ndarray) else back.X.toarray()
        np.testing.assert_array_equal(X, dense)
        assert list(back.obs.columns) == ["pert", "score", "name"]
        assert (np.asarray(back.obs["pert"]) == np.asarray(adata.obs["pert"])).all()
        np.testing.assert_allclose(back.obs["score"], adata.obs["score"])
        assert list(back.var_names) == list(adata.var_names)
        assert not back.isbacked


@pytest.mark.parametrize("fmt", ["dense", "csc", "csr"])
def test_h5ad_backed_read(fmt, tmp_path):
    adata, dense = _adata(fmt)
    path = tmp_path / "x.h5ad"
    jax_h5ad.write_h5ad(adata, path)  # a file the reference wrote
    back = read_h5ad(path, backed="r")
    assert back.isbacked
    ensure_backed_handlers()
    if fmt == "csr":
        assert isinstance(back.X, BackedCSR)
        np.testing.assert_array_equal(back.X.toarray(), dense)
        return
    if fmt == "csc":
        assert isinstance(back.X, BackedCSC)
        np.testing.assert_array_equal(back.X.densify_columns(3, 9), dense[:, 3:9])
        np.testing.assert_array_equal(back.X.toarray(), dense)
        assert back.X.nbytes > 0
    else:
        assert isinstance(back.X, h5py.Dataset)
    handler = data_handler_registry.get(back.X)
    np.testing.assert_array_equal(handler.fetch_tile(0, 7), dense[:, :7])
    np.testing.assert_array_equal(handler.fetch_tile(15, 20), dense[:, 15:20])
    assert handler.footprint() > 0
    v, r, c = handler.fetch_tile_entries(4, 11)
    window = np.zeros((dense.shape[0], 7), np.float32)
    window[r, c] = v
    np.testing.assert_array_equal(window, dense[:, 4:11])


def test_backed_csr_raises_reference_keyerror(tmp_path):
    adata, _ = _adata("csr")
    path = tmp_path / "x.h5ad"
    adata.write_h5ad(path)
    ensure_backed_handlers()
    jax_registry.ensure_backed_handlers()
    with pytest.raises(KeyError) as got:
        data_handler_registry.get(read_h5ad(path, backed="r").X)
    with pytest.raises(KeyError) as want:
        jax_registry.data_handler_registry.get(jax_h5ad.read_h5ad(path, backed="r").X)
    assert str(got.value).replace("illico_tpu_torch.", "illico_tpu.") == str(want.value)
    with pytest.raises(KeyError, match="is not implemented"):
        illico_tpu_torch.asymptotic_wilcoxon(
            read_h5ad(path, backed="r"), is_log1p=False, group_keys="pert",
            device="cpu", progress=False,
        )


@pytest.mark.parametrize("fmt", ["dense", "csc"])
@pytest.mark.parametrize("test", ["ovo", "ovr"])
@pytest.mark.parametrize("data", ["counts", "normalized"])
def test_backed_api_matches_reference(fmt, test, data, tmp_path):
    adata, dense = _adata(fmt, normalized=data == "normalized")
    path = tmp_path / "x.h5ad"
    adata.write_h5ad(path)
    reference = "p0" if test == "ovo" else None
    kw = dict(is_log1p=False, group_keys="pert", reference=reference, progress=False,
              batch_size=8)
    got = illico_tpu_torch.asymptotic_wilcoxon(read_h5ad(path, backed="r"), device="cpu", **kw)
    want = illico_tpu.asymptotic_wilcoxon(jax_h5ad.read_h5ad(path, backed="r"), **kw)
    in_ram = illico_tpu_torch.asymptotic_wilcoxon(adata, device="cpu", **kw)
    assert got.attrs["engine"] == in_ram.attrs["engine"] == (
        "hist" if data == "counts" else "csort"
    )
    for other in (want, in_ram):
        assert got.index.equals(other.index)
        np.testing.assert_array_equal(got.statistic.values, other.statistic.values)
        np.testing.assert_allclose(got.p_value.values, other.p_value.values, rtol=1e-12, atol=0)
        np.testing.assert_allclose(got.fold_change.values, other.fold_change.values, rtol=1e-6)


def test_fetch_columns_coalesces_ranges(tmp_path):
    """One backed read per contiguous column range, in any request order,
    with duplicates."""
    adata, dense = _adata("csc")
    path = tmp_path / "x.h5ad"
    adata.write_h5ad(path)
    ensure_backed_handlers()
    handler = data_handler_registry.get(read_h5ad(path, backed="r").X)

    calls = []
    orig = handler.fetch_tile
    handler.fetch_tile = lambda lb, ub: (calls.append((lb, ub)), orig(lb, ub))[1]

    idx = [7, 8, 2, 3, 4, 12, 3]  # sorted runs: [2,4) [3,5) [7,9) [12,13)
    np.testing.assert_array_equal(handler.fetch_columns(idx), dense[:, idx])
    assert sorted(calls) == [(2, 4), (3, 5), (7, 9), (12, 13)]
    assert handler.fetch_columns([]).shape == (dense.shape[0], 0)


def test_backed_csc_csort_never_densifies_tiles(tmp_path, monkeypatch):
    """csort over backed CSC streams O(window nnz) entries from disk and
    never builds a dense tile."""
    ensure_backed_handlers()
    rng = np.random.RandomState(11)
    n, t, g = 400, 12, 4
    dense = rng.poisson(2.0, (n, t)).astype(np.float32)
    dense[rng.rand(n, t) >= 0.3] = 0
    labels = rng.randint(0, g, n)
    labels[:g] = np.arange(g)
    ad = AnnDataLite(sparse.csc_matrix(dense),
                     pd.DataFrame({"g": labels.astype(str)}),
                     pd.DataFrame(index=[f"v{i}" for i in range(t)]))
    p = tmp_path / "x.h5ad"
    ad.write_h5ad(p)
    handler = data_handler_registry.get(read_h5ad(p, backed="r").X)
    _, info = encode_and_count_groups(labels.astype(str), "0")
    cpu = dict(is_log1p=False, engine="csort", device="cpu")
    runner = WilcoxonRunner(handler, info, **cpu)

    def _no_densify(lb, ub):  # engine-selection sampling already ran
        raise AssertionError("csort on backed CSC densified a tile via fetch_tile")

    monkeypatch.setattr(handler, "fetch_tile", _no_densify)
    got = runner.run(progress=False).stacked
    eager = data_handler_registry.get(sparse.csc_matrix(dense))
    want = WilcoxonRunner(eager, info, **cpu).run(progress=False).stacked
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)


def test_backed_mode_exposes_lazy_layers(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.poisson(2.0, (40, 6)).astype(np.float32)
    write_h5ad(AnnDataLite(X, layers={"counts": (X * 2).astype(np.float32)}),
               tmp_path / "l.h5ad")
    backed = read_h5ad(tmp_path / "l.h5ad", backed="r")
    assert "counts" in backed.layers and backed.layers._cache == {}
    np.testing.assert_array_equal(backed.layers["counts"], X * 2)
    assert list(backed.layers.keys()) == ["counts"]
    eager = read_h5ad(tmp_path / "l.h5ad")
    assert isinstance(eager.layers, dict)
    np.testing.assert_array_equal(eager.layers["counts"], X * 2)


def test_backed_copy_keeps_layers_lazy(tmp_path):
    rng = np.random.RandomState(1)
    X = rng.poisson(2.0, (30, 5)).astype(np.float32)
    ad = AnnDataLite(X, layers={"a": (X * 2).astype(np.float32),
                                "b": (X + 1).astype(np.float32)})
    write_h5ad(ad, tmp_path / "c.h5ad")
    backed = read_h5ad(tmp_path / "c.h5ad", backed="r")
    _ = backed.layers["a"]
    cp = backed.copy()
    assert set(cp.layers._cache) == {"a"}
    cp.layers._cache["a"][0, 0] = -1.0
    assert backed.layers["a"][0, 0] != -1.0
    np.testing.assert_array_equal(cp.layers["b"], X + 1)


def test_nullable_columns_and_shape_errors(tmp_path):
    ad = AnnDataLite(np.zeros((3, 2), np.float32),
                     pd.DataFrame({"g": ["a", "b", "a"]}, index=["c0", "c1", "c2"]))
    p = tmp_path / "n.h5ad"
    write_h5ad(ad, p)
    with h5py.File(p, "r+") as f:
        for name, enc, values in (
            ("n_counts", "nullable-integer", np.array([5, 0, 7], np.int32)),
            ("flagged", "nullable-boolean", np.array([True, False, True])),
        ):
            cg = f["obs"].create_group(name)
            cg.attrs["encoding-type"] = enc
            cg.create_dataset("values", data=values)
            cg.create_dataset("mask", data=np.array([False, True, False]))
        f["obs"].attrs["column-order"] = np.asarray(["g", "n_counts", "flagged"], dtype=object)
    back = read_h5ad(p)
    assert back.obs["n_counts"].tolist() == [5, pd.NA, 7]
    assert back.obs["flagged"].tolist() == [True, pd.NA, True]
    with pytest.raises(TypeError, match="convert to CSR or CSC"):
        write_h5ad(AnnDataLite(sparse.coo_matrix(np.eye(3, dtype=np.float32))),
                   tmp_path / "bad.h5ad")
    with pytest.raises(ValueError, match="var has"):
        AnnDataLite(np.zeros((5, 3)), var=pd.DataFrame(index=range(7)))
