"""Minimal, dependency-light AnnData / h5ad support.

Port of ``illico_tpu.io.h5ad``:

- :class:`AnnDataLite` — a small AnnData-compatible container (``.X``,
  ``.obs``, ``.var``, ``.layers``, ``.obs_names``, ``.var_names``,
  ``.isbacked``, ``copy``, ``write_h5ad``), which
  :func:`illico_tpu_torch.api.asymptotic_wilcoxon_arrays` wraps its inputs
  in.  Real ``anndata.AnnData`` objects are accepted by the public API
  through duck typing.
- :func:`read_h5ad` / :func:`write_h5ad` — the standard h5ad on-disk format
  (AnnData >= 0.8 encodings), eager or backed.  Backed dense matrices are
  exposed as ``h5py.Dataset``, backed CSC as :class:`BackedCSC`, backed CSR
  as :class:`BackedCSR`, which is deliberately not registered with the data
  handler registry, so it fails with the reference's ``KeyError``.

``h5py`` is imported only inside the functions that touch a file: the
package imports, and runs in-RAM data, on a host without it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd
from scipy import sparse as sp

__all__ = ["AnnDataLite", "BackedCSC", "BackedCSR", "read_h5ad", "write_h5ad"]


class BackedCSC:
    """Lazy CSC matrix over an open h5 group with data/indices/indptr."""

    format = "csc"

    def __init__(self, group):
        self._group = group
        self.shape = tuple(int(s) for s in group.attrs["shape"])
        self._indptr = np.asarray(group["indptr"][...], dtype=np.int64)
        self.dtype = group["data"].dtype

    @property
    def nbytes(self) -> int:
        nnz = int(self._indptr[-1])
        return (
            nnz * self.dtype.itemsize
            + nnz * self._group["indices"].dtype.itemsize
            + self._indptr.nbytes
        )

    def densify_columns(self, lb: int, ub: int) -> np.ndarray:
        """Read columns [lb, ub) from disk and densify. Heap = O(tile)."""
        data, indices, cols = self.window_entries(lb, ub)
        out = np.zeros((self.shape[0], ub - lb), dtype=self.dtype)
        out[indices, cols] = data
        return out

    def window_entries(self, lb: int, ub: int):
        """(values, rows, tile-relative cols) of columns [lb, ub): reads
        only the window's nonzeros from disk (the compact sort tiler's
        O(window nnz) source)."""
        s, e = int(self._indptr[lb]), int(self._indptr[ub])
        data = self._group["data"][s:e]
        indices = np.asarray(self._group["indices"][s:e], dtype=np.int64)
        col_nnz = np.diff(self._indptr[lb : ub + 1])
        cols = np.repeat(np.arange(ub - lb, dtype=np.int64), col_nnz)
        return data, indices, cols

    def toarray(self) -> np.ndarray:
        return self.densify_columns(0, self.shape[1])


class BackedCSR:
    """Lazy CSR matrix — deliberately unsupported for column streaming."""

    format = "csr"

    def __init__(self, group):
        self._group = group
        self.shape = tuple(int(s) for s in group.attrs["shape"])
        self.dtype = group["data"].dtype

    def toarray(self) -> np.ndarray:
        m = sp.csr_matrix(
            (
                self._group["data"][...],
                self._group["indices"][...],
                self._group["indptr"][...],
            ),
            shape=self.shape,
        )
        return m.toarray()


class _LazyLayers:
    """Mapping over on-disk h5ad layers, materialized per layer on access,
    so a backed file's layers stay on disk until ``layer=`` selects one."""

    def __init__(self, group):
        self._group = group
        self._cache: dict = {}

    def __getitem__(self, key):
        if key not in self._cache:
            self._cache[key] = _read_matrix(self._group[key], False)
        return self._cache[key]

    def __contains__(self, key) -> bool:
        return key in self._group

    def __iter__(self):
        return iter(self._group.keys())

    def __len__(self) -> int:
        return len(self._group)

    def keys(self):
        return self._group.keys()

    def items(self):
        return ((k, self[k]) for k in self.keys())

    def copy(self) -> "_LazyLayers":
        """Copy that stays lazy: shares the h5 group and deep-copies only
        the layers already materialized."""
        new = _LazyLayers(self._group)
        new._cache = {
            k: (v.copy() if hasattr(v, "copy") else v)
            for k, v in self._cache.items()
        }
        return new


class AnnDataLite:
    """AnnData-compatible container for the DE workflow."""

    def __init__(self, X, obs: pd.DataFrame | None = None, var: pd.DataFrame | None = None,
                 layers: dict | None = None, *, isbacked: bool = False, filename=None):
        self.X = X
        n_obs, n_vars = X.shape
        self.obs = obs if obs is not None else pd.DataFrame(index=pd.RangeIndex(n_obs).astype(str))
        self.var = var if var is not None else pd.DataFrame(index=pd.RangeIndex(n_vars).astype(str))
        if len(self.obs) != n_obs:
            raise ValueError(f"obs has {len(self.obs)} rows but X has {n_obs}.")
        if len(self.var) != n_vars:
            raise ValueError(f"var has {len(self.var)} rows but X has {n_vars}.")
        self.layers = layers or {}
        self.isbacked = isbacked
        self.filename = filename

    @property
    def obs_names(self):
        return self.obs.index

    @property
    def var_names(self):
        return self.var.index

    @property
    def n_obs(self) -> int:
        return int(self.X.shape[0])

    @property
    def n_vars(self) -> int:
        return int(self.X.shape[1])

    @property
    def shape(self):
        return tuple(self.X.shape)

    def copy(self) -> "AnnDataLite":
        X = self.X.copy() if hasattr(self.X, "copy") else self.X
        if isinstance(self.layers, _LazyLayers):
            layers = self.layers.copy()  # stays lazy; see _LazyLayers.copy
        else:
            layers = {k: v.copy() for k, v in self.layers.items()}
        return AnnDataLite(X, self.obs.copy(), self.var.copy(), layers,
                           isbacked=self.isbacked, filename=self.filename)

    def write_h5ad(self, path) -> None:
        write_h5ad(self, path)


# ---------------------------------------------------------------------------
# h5ad format read/write (AnnData >= 0.8 encodings)
# ---------------------------------------------------------------------------

def _write_matrix(f, key: str, X) -> None:
    if isinstance(X, np.ndarray):
        d = f.create_dataset(key, data=X)
        d.attrs["encoding-type"] = "array"
        d.attrs["encoding-version"] = "0.2.0"
    elif sp.issparse(X):
        if X.format not in ("csr", "csc"):
            # Fail before touching the file: COO/BSR/DIA/LIL would either
            # crash mid-write or produce a corrupt "csc_matrix" entry.
            raise TypeError(
                f"Cannot write sparse format {X.format!r} to h5ad; "
                "convert to CSR or CSC first."
            )
        fmt = "csr_matrix" if X.format == "csr" else "csc_matrix"
        g = f.create_group(key)
        g.attrs["encoding-type"] = fmt
        g.attrs["encoding-version"] = "0.1.0"
        g.attrs["shape"] = np.asarray(X.shape, dtype=np.int64)
        g.create_dataset("data", data=X.data)
        g.create_dataset("indices", data=X.indices)
        g.create_dataset("indptr", data=X.indptr)
    else:
        raise TypeError(f"Cannot write matrix of type {type(X)} to h5ad.")


def _write_df(f, key: str, df: pd.DataFrame) -> None:
    import h5py

    g = f.create_group(key)
    g.attrs["encoding-type"] = "dataframe"
    g.attrs["encoding-version"] = "0.2.0"
    g.attrs["_index"] = "_index"
    g.attrs["column-order"] = np.asarray(list(df.columns), dtype=object) if len(df.columns) else np.asarray([], dtype="S")
    str_dt = h5py.string_dtype(encoding="utf-8")
    idx = g.create_dataset("_index", data=np.asarray(df.index.astype(str), dtype=object), dtype=str_dt)
    idx.attrs["encoding-type"] = "string-array"
    idx.attrs["encoding-version"] = "0.2.0"
    for col in df.columns:
        vals = df[col]
        if isinstance(vals.dtype, pd.CategoricalDtype):
            cg = g.create_group(col)
            cg.attrs["encoding-type"] = "categorical"
            cg.attrs["encoding-version"] = "0.2.0"
            cg.attrs["ordered"] = False
            cats = cg.create_dataset(
                "categories", data=np.asarray(vals.cat.categories.astype(str), dtype=object), dtype=str_dt
            )
            cats.attrs["encoding-type"] = "string-array"
            cats.attrs["encoding-version"] = "0.2.0"
            cg.create_dataset("codes", data=vals.cat.codes.to_numpy().astype(np.int32))
        elif vals.dtype == object or pd.api.types.is_string_dtype(vals.dtype):
            d = g.create_dataset(col, data=np.asarray(vals.astype(str), dtype=object), dtype=str_dt)
            d.attrs["encoding-type"] = "string-array"
            d.attrs["encoding-version"] = "0.2.0"
        else:
            d = g.create_dataset(col, data=vals.to_numpy())
            d.attrs["encoding-type"] = "array"
            d.attrs["encoding-version"] = "0.2.0"


def write_h5ad(adata, path) -> None:
    """Write an AnnData-like object to the standard h5ad format."""
    import h5py

    path = Path(path)
    with h5py.File(path, "w") as f:
        f.attrs["encoding-type"] = "anndata"
        f.attrs["encoding-version"] = "0.1.0"
        _write_matrix(f, "X", adata.X)
        _write_df(f, "obs", adata.obs)
        _write_df(f, "var", adata.var if hasattr(adata, "var") else pd.DataFrame(index=adata.var_names))
        if getattr(adata, "layers", None):
            lg = f.create_group("layers")
            lg.attrs["encoding-type"] = "dict"
            lg.attrs["encoding-version"] = "0.1.0"
            for k, v in adata.layers.items():
                _write_matrix(lg, k, v)


def _encoding(node) -> str:
    enc = node.attrs.get("encoding-type", "")
    return enc.decode() if isinstance(enc, bytes) else enc


def _read_series(node):
    import h5py

    enc = _encoding(node)
    is_group = isinstance(node, h5py.Group)
    if enc == "categorical" or (is_group and "codes" in node):
        cats = _decode_strings(node["categories"][...])
        codes = node["codes"][...]
        return pd.Categorical.from_codes(codes, categories=cats)
    if enc in ("nullable-integer", "nullable-boolean") or (is_group and "mask" in node):
        # AnnData >= 0.8 masked encodings: values + boolean mask of missing.
        values = node["values"][...]
        mask = node["mask"][...].astype(bool)
        if enc == "nullable-boolean" or values.dtype.kind == "b":
            return pd.arrays.BooleanArray(values.astype(bool), mask)
        return pd.arrays.IntegerArray(values.astype(np.int64), mask)
    return _decode_strings(node[...])


def _decode_strings(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.kind == "S":
        return np.char.decode(arr, "utf-8")
    if arr.dtype.kind == "O":
        return np.asarray(
            [v.decode() if isinstance(v, bytes) else v for v in arr.ravel()]
        ).reshape(arr.shape)
    return arr


def _read_df(g) -> pd.DataFrame:
    index_key = g.attrs.get("_index", "_index")
    if isinstance(index_key, bytes):
        index_key = index_key.decode()
    index = _decode_strings(g[index_key][...]) if index_key in g else None
    order = g.attrs.get("column-order", [])
    cols = [c.decode() if isinstance(c, bytes) else c for c in order]
    if not cols:
        cols = [k for k in g.keys() if k != index_key]
    df = pd.DataFrame({c: _read_series(g[c]) for c in cols if c in g})
    if index is not None:
        df.index = pd.Index(index)
    return df


def _read_matrix(node, backed: bool):
    import h5py

    if isinstance(node, h5py.Dataset):
        return node if backed else np.asarray(node[...])
    enc = _encoding(node)
    shape = tuple(int(s) for s in node.attrs["shape"])
    if enc == "csc_matrix":
        if backed:
            return BackedCSC(node)
        return sp.csc_matrix(
            (node["data"][...], node["indices"][...], node["indptr"][...]), shape=shape
        )
    if enc == "csr_matrix":
        if backed:
            return BackedCSR(node)
        return sp.csr_matrix(
            (node["data"][...], node["indices"][...], node["indptr"][...]), shape=shape
        )
    raise ValueError(f"Unsupported X encoding: {enc!r}")


def read_h5ad(path, backed: str | None = None) -> AnnDataLite:
    """Read an h5ad file. ``backed='r'`` keeps X on disk (column streaming)."""
    import h5py

    path = Path(path)
    is_backed = backed is not None
    f = h5py.File(path, "r")
    ok = False
    try:
        X = _read_matrix(f["X"], is_backed)
        obs = _read_df(f["obs"]) if "obs" in f else None
        var = _read_df(f["var"]) if "var" in f else None
        layers = {}
        if "layers" in f:
            if is_backed:
                # The handle stays open: layers stay on disk until one is
                # selected (anndata likewise backs only X).
                layers = _LazyLayers(f["layers"])
            else:
                for k in f["layers"].keys():
                    layers[k] = _read_matrix(f["layers"][k], False)
        adata = AnnDataLite(X, obs, var, layers, isbacked=is_backed, filename=path)
        if is_backed:
            adata._file = f  # keep the handle alive
        ok = True
        return adata
    finally:
        # Backed mode hands the open handle to the AnnData; every other
        # path (eager read, or an error mid-read) must close it.
        if not (is_backed and ok):
            f.close()
