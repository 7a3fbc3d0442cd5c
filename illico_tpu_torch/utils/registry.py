"""Input-format dispatch: data handlers and their registry.

Port of ``illico_tpu.utils.registry``: every handler produces *dense gene
tiles* ``(n_cells, tile_width)`` in original row order, and sparse-aware
handlers also stream a window's nonzero entries for the compact sort engine.
Registered here: ``np.ndarray``, scipy CSR and CSC (matrix and array
classes) and ``torch.Tensor`` (a CUDA tensor is device-resident input, its
tiles column slices on the device; a CPU tensor is host input, read through
its zero-copy numpy view).  :class:`DeviceSparseDataHandler` is registered
for no type: the runner puts an in-RAM CSR or CSC on the device with it when
the copy fits there.  :func:`ensure_backed_handlers`
adds ``h5py.Dataset`` (backed dense, when ``h5py`` imports), this package's
:class:`illico_tpu_torch.io.h5ad.BackedCSC`, and anndata's backed CSC (when
``anndata`` imports).  Backed CSR, like any other type, raises ``KeyError``
with the same message as the reference package.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch
from scipy import sparse as sp

import illico_tpu_torch.native as native

__all__ = [
    "DataHandler",
    "DeviceDenseDataHandler",
    "DeviceSparseDataHandler",
    "device_sparse_dtype",
    "sparse_device_bytes",
    "data_handler_registry",
    "DataHandlerRegistry",
    "ensure_backed_handlers",
]


class DataHandlerRegistry(dict):
    """type(X) -> DataHandler factory (exact-type lookup)."""

    def register(self, data_type):
        def decorator(cls):
            self[data_type] = cls
            return cls

        return decorator

    def get(self, X) -> "DataHandler":
        factory = super().get(type(X))
        if factory is None:
            raise KeyError(
                f"Support for data type {type(X)} is not implemented."
            )
        return factory(X)


data_handler_registry = DataHandlerRegistry()


class DataHandler(ABC):
    """Produces dense gene tiles from an expression matrix."""

    def __init__(self, data):
        self.data = data

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.data.shape)

    @property
    @abstractmethod
    def dtype(self) -> np.dtype:
        """Element dtype of the expression values."""

    @abstractmethod
    def fetch_tile(self, lb: int, ub: int) -> np.ndarray:
        """Dense (n_cells, ub - lb) tile of columns [lb, ub), original row order."""

    @abstractmethod
    def footprint(self) -> int:
        """Bytes needed to hold the full matrix in RAM."""

    def tile_footprint(self, width: int) -> int:
        """Host bytes materialized per tile of ``width`` columns."""
        return int(self.shape[0]) * width * np.dtype(self.dtype).itemsize

    def validate(self) -> None:
        """Input invariant checks; raise ValueError on violation."""

    def density(self) -> float | None:
        """Fraction of nonzero entries, or None when unknown (the runner
        then estimates it from its value sample).  Drives the compact sort
        engine's routing only, never exactness."""
        return None

    def fetch_tile_entries(self, lb: int, ub: int):
        """Nonzero entries ``(values, rows, cols)`` of columns [lb, ub).

        ``cols`` are tile-relative; entry order is arbitrary (the compact
        tiler sorts).  The default extracts them from the dense tile; sparse
        handlers override it with O(window nnz) reads.
        """
        tile = self.fetch_tile(lb, ub)
        r, c = np.nonzero(tile)
        return tile[r, c], r, c

    def fetch_columns(self, idx) -> np.ndarray:
        """Dense (n_cells, len(idx)) gather of arbitrary columns (the
        histogram-overflow fallback).  Adjacent requested columns are
        coalesced into ranges, so backed handlers read once per range."""
        idx = np.asarray(idx, dtype=np.int64)
        if idx.size == 0:
            return np.empty((int(self.shape[0]), 0), dtype=self.dtype)
        order = np.argsort(idx, kind="stable")
        s = idx[order]
        breaks = np.flatnonzero(np.diff(s) != 1) + 1
        starts = np.concatenate(([0], breaks))
        ends = np.concatenate((breaks, [s.size]))
        parts = [
            self.fetch_tile(int(s[a]), int(s[e - 1]) + 1)
            for a, e in zip(starts, ends)
        ]
        dense = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
        out = np.empty_like(dense)
        out[:, order] = dense
        return out


@data_handler_registry.register(np.ndarray)
class DenseDataHandler(DataHandler):
    """In-RAM dense matrix."""

    @property
    def dtype(self):
        return self.data.dtype

    def fetch_tile(self, lb, ub):
        return np.ascontiguousarray(self.data[:, lb:ub])

    def fetch_columns(self, idx):
        return self.data[:, np.asarray(idx)]

    def footprint(self):
        return self.data.nbytes


class DeviceDenseDataHandler(DataHandler):
    """Dense matrix that already lives on a torch device: tiles are column
    slices there, with no host work and no host-to-device copy in the tile
    loop."""

    is_device = True

    @property
    def dtype(self):
        return torch.empty(0, dtype=self.data.dtype).numpy().dtype

    def fetch_tile(self, lb, ub):
        return self.data[:, lb:ub]

    def fetch_columns(self, idx):
        idx = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=self.data.device)
        return self.data.index_select(1, idx)

    def footprint(self):
        return self.data.numel() * self.data.element_size()


@data_handler_registry.register(torch.Tensor)
def _tensor_handler(x: torch.Tensor) -> DataHandler:
    """A CUDA tensor is device-resident; a CPU tensor is host input and
    takes the dense handler on its numpy view (no copy)."""
    if x.dim() != 2:
        raise ValueError(f"Expected a 2-d (cells, genes) tensor; got shape {tuple(x.shape)}.")
    if x.is_cuda:
        return DeviceDenseDataHandler(x)
    return DenseDataHandler(x.detach().numpy())


def device_sparse_dtype(dtype) -> np.dtype | None:
    """The dtype in which :class:`DeviceSparseDataHandler` holds values of
    ``dtype`` (uint16 widened to int32, as the host wire widens it: torch's
    uint16 has few device ops), or None for a dtype it does not take."""
    dtype = np.dtype(dtype)
    if dtype == np.uint16:
        return np.dtype(np.int32)
    if dtype in (np.int8, np.uint8, np.int16, np.int32, np.int64, np.float32, np.float64):
        return dtype
    return None


def _wide_rows(shape, nnz: int) -> bool:
    """Row indices of the column-ordered copy are int64 past 2**31 rows or
    entries, int32 below."""
    return max(int(shape[0]), int(nnz)) >= 2**31


def sparse_device_bytes(shape, nnz: int, dtype) -> int:
    """Bytes of a sparse matrix held in column order on the device: an int64
    column pointer, one row index per entry and the values in
    :func:`device_sparse_dtype` (their own dtype when the device route does
    not take it)."""
    value = device_sparse_dtype(dtype) or np.dtype(dtype)
    row = 8 if _wide_rows(shape, nnz) else 4
    return 8 * (int(shape[1]) + 1) + int(nnz) * (row + value.itemsize)


class _SparseDataHandler(DataHandler):
    @property
    def dtype(self):
        return self.data.data.dtype

    def fetch_columns(self, idx):
        return self.data[:, np.asarray(idx)].toarray()

    def footprint(self):
        """Bytes of the matrix in column order, as the device route holds it."""
        return sparse_device_bytes(self.data.shape, self.data.nnz, self.dtype)

    def density(self):
        n_rows, n_cols = self.data.shape
        return float(self.data.nnz) / max(1, int(n_rows) * int(n_cols))

    def _window(self, lb, ub):
        """Column slice [lb, ub) with duplicate entries summed, as the
        dense paths' ``toarray`` sums them (a fresh slice: no mutation of
        the user's matrix)."""
        sub = self.data[:, lb:ub]
        if not sub.has_canonical_format:
            sub.sum_duplicates()
        return sub


@data_handler_registry.register(sp.csr_matrix)
class CSRDataHandler(_SparseDataHandler):
    """In-RAM CSR.  A column window is gathered by the package's own native
    code (``csrc/csr_scan.cpp``): one binary search per row for the
    window's bounds, then the window's own entries.  That needs sorted
    indices within each row, hence :meth:`validate`, which runs before the
    first tile.  Where the library is not loaded (no compiler, or
    ``ILLICO_TPU_NO_NATIVE=1``), or for values or indices of a dtype it does
    not take (:func:`_native_scans`), the plain bodies run: numpy's check
    and scipy's column slice, which tests every entry."""

    def __init__(self, data):
        super().__init__(data)
        self._checked = False  # validate() passed

    def _native_scans(self) -> bool:
        """The native scans take values of ``native.CSR_GATHER_DTYPES``
        (not float16, uint32, uint64 or bool) with int32 or int64 indices."""
        m = self.data
        return (native.native_available() and m.data.dtype in native.CSR_GATHER_DTYPES
                and native.csr_index_dtypes_ok(m.indptr, m.indices))

    def fetch_tile(self, lb, ub):
        if not self._checked:
            self.validate()
        if not self._native_scans():
            return self._fetch_tile_plain(lb, ub)
        m = self.data
        return native.csr_gather_window_native(m.indptr, m.indices, m.data, lb, ub)

    def _fetch_tile_plain(self, lb, ub):
        native.count_csr_scan("gather_plain")
        out = np.zeros((self.data.shape[0], ub - lb), dtype=self.dtype)
        self.data[:, lb:ub].tocsc().toarray(out=out)
        return out

    def fetch_tile_entries(self, lb, ub):
        sub = self._window(lb, ub)
        rows = np.repeat(
            np.arange(sub.shape[0], dtype=np.int64), np.diff(sub.indptr)
        )
        return sub.data, rows, sub.indices.astype(np.int64)

    def validate(self):
        if self._native_scans():
            m = self.data
            if native.csr_check_sorted_native(m.indptr, m.indices) >= 0:
                raise ValueError(_UNSORTED_CSR)
        else:
            self._validate_plain()
        self._checked = True

    def _validate_plain(self):
        native.count_csr_scan("check_plain")
        indices, indptr = self.data.indices, self.data.indptr
        if indices.size:
            bad = np.diff(indices) < 0
            # Drops across row boundaries are fine.  A boundary at position
            # p masks bad[p - 1]; boundaries at 0 (leading empty rows) and
            # at nnz (trailing empty rows) touch no diff.
            row_starts = indptr[1:-1]
            row_starts = row_starts[
                (row_starts > 0) & (row_starts < indices.size)
            ]
            bad[row_starts - 1] = False
            if bad.any():
                raise ValueError(_UNSORTED_CSR)


_UNSORTED_CSR = (
    "CSR matrix has unsorted column indices within a row; "
    "column windowing relies on per-row sorted order and "
    "would silently produce wrong tiles. Unsorted indices "
    "usually come from fancy indexing with an unsorted "
    "selector (e.g. adata[:, permutation]); call "
    "X.sort_indices() (or sort the selector) before running "
    "the test."
)


@data_handler_registry.register(sp.csc_matrix)
class CSCDataHandler(_SparseDataHandler):
    """In-RAM CSC."""

    def fetch_tile(self, lb, ub):
        return self.data[:, lb:ub].toarray()

    def fetch_tile_entries(self, lb, ub):
        sub = self._window(lb, ub)
        cols = np.repeat(
            np.arange(sub.shape[1], dtype=np.int64), np.diff(sub.indptr)
        )
        return sub.data, sub.indices.astype(np.int64), cols


data_handler_registry[sp.csr_array] = CSRDataHandler
data_handler_registry[sp.csc_array] = CSCDataHandler


class DeviceSparseDataHandler(DataHandler):
    """An in-RAM CSR or CSC held in column order on a torch device for one
    run.  :meth:`load` uploads the nonzeros and orders them by column there;
    tiles and column gathers are then densified where they are used (a zero
    fill, then one scatter of the columns' entries) with no host work and no
    host sync; :meth:`release` frees the copy.  The duplicate entries of a
    non-canonical matrix are summed once, at load, in storage order and in
    the stored dtype, as scipy's ``toarray`` sums them, and a float ``-0.0``
    is stored as ``+0.0`` (``toarray`` adds each entry to a zero), so every
    tile equals the host handler's bit for bit.  Shape, dtype and density
    are the host handler's."""

    is_device = True

    def __init__(self, host: _SparseDataHandler, device):
        super().__init__(host.data)
        self.host = host
        self.device = torch.device(device)
        self.col_ptr = self.rows = self.values = None
        self._col_ptr_host = None

    @property
    def dtype(self):
        return self.host.dtype

    def density(self):
        return self.host.density()

    def footprint(self):
        return self.host.footprint()

    def load(self) -> None:
        """Upload the matrix and order it by column on the device: a CSC as
        it is, a CSR by one stable sort of its column indices, which keeps
        each column's rows in ascending order.  Syncs with the host once
        (the column pointer's host copy), more only for a CSC whose rows
        are out of order within a column or a matrix with duplicates."""
        m, dev = self.data, self.device
        wide = _wide_rows(m.shape, m.nnz)
        values = torch.from_numpy(m.data.view(np.int16) if m.data.dtype == np.uint16
                                  else m.data)
        if isinstance(self.host, CSRDataHandler):
            cols, perm = torch.sort(torch.from_numpy(m.indices).to(dev), stable=True)
            col_ptr = torch.searchsorted(
                cols, torch.arange(m.shape[1] + 1, dtype=cols.dtype, device=dev)
            )
            del cols
            indptr = torch.from_numpy(m.indptr).to(dev, torch.int64)
            rows = torch.searchsorted(indptr, perm, right=True, out_int32=not wide) - 1
            del indptr
            values = values.to(dev)[perm]
            del perm
        else:
            col_ptr = torch.from_numpy(m.indptr).to(dev, torch.int64)
            rows = torch.from_numpy(m.indices).to(dev, torch.int64 if wide else torch.int32)
            values = values.to(dev, copy=True)  # changed in place below
        if m.data.dtype == np.uint16:  # int16 bits -> the uint16 value in int32
            values = values.to(torch.int32).bitwise_and_(0xFFFF)
        elif values.is_floating_point():
            values.add_(0)  # -0.0 -> +0.0
        flags = torch.cat([_disorder(rows, col_ptr), col_ptr]).cpu().numpy()
        n_unsorted, n_dup = int(flags[0]), int(flags[1])
        if n_unsorted:
            rows, values = _sort_within_columns(rows, values, col_ptr, m.shape[0])
            n_dup = int(_disorder(rows, col_ptr)[1])
        if n_dup:
            rows, values, col_ptr = _sum_duplicates(
                rows, values, col_ptr, n_dup, uint16=m.data.dtype == np.uint16
            )
            flags = np.concatenate([flags[:2], col_ptr.cpu().numpy()])
        self.col_ptr, self.rows, self.values = col_ptr, rows, values
        self._col_ptr_host = flags[2:]

    def release(self) -> None:
        """Free the device copy."""
        self.col_ptr = self.rows = self.values = None
        self._col_ptr_host = None

    def fetch_tile(self, lb, ub):
        s, e = int(self._col_ptr_host[lb]), int(self._col_ptr_host[ub])
        cols = torch.repeat_interleave(
            torch.arange(ub - lb, dtype=torch.int32, device=self.device),
            torch.diff(self.col_ptr[lb : ub + 1]), output_size=e - s,
        )
        return self._dense(self.rows[s:e], cols, self.values[s:e], ub - lb)

    def fetch_columns(self, idx):
        idx = np.asarray(idx, dtype=np.int64)
        starts = self._col_ptr_host[idx]
        lens = self._col_ptr_host[idx + 1] - starts
        total = int(lens.sum())
        # Entry j of requested column k sits at starts[k] + j - (entries
        # of the columns before k): one small copy carries both arrays.
        plan = torch.from_numpy(np.stack([starts - (np.cumsum(lens) - lens), lens]))
        plan = plan.to(self.device)
        cols = torch.repeat_interleave(
            torch.arange(idx.size, dtype=torch.int32, device=self.device), plan[1],
            output_size=total,
        )
        pos = torch.arange(total, device=self.device) + plan[0][cols]
        return self._dense(self.rows[pos], cols, self.values[pos], idx.size)

    def _dense(self, rows, cols, values, width: int) -> torch.Tensor:
        """Dense (n_rows, width) tile of entries at unique (row, col)."""
        out = torch.zeros((self.shape[0], width), dtype=values.dtype, device=self.device)
        flat = rows.to(torch.int64, copy=True).mul_(width).add_(cols)
        out.view(-1).index_put_((flat,), values)
        return out


def _column_starts(col_ptr, nnz: int) -> torch.Tensor:
    """(nnz,) flags of the entries that begin a column."""
    starts = torch.zeros(nnz + 1, dtype=torch.bool, device=col_ptr.device)
    return starts.index_fill_(0, col_ptr, True)[:nnz]


def _disorder(rows, col_ptr) -> torch.Tensor:
    """(entries whose row is below the previous entry's in the same column,
    entries that repeat the previous entry's row in the same column)."""
    inner = ~_column_starts(col_ptr, rows.numel())[1:]  # entry i >= 1 continues a column
    prev, cur = rows[:-1], rows[1:]
    return torch.stack([((cur < prev) & inner).sum(), ((cur == prev) & inner).sum()])


def _sort_within_columns(rows, values, col_ptr, n_rows: int):
    """Entries of each column by ascending row, duplicates in storage order
    (a stable sort of the (column, row) key)."""
    n_cols = col_ptr.numel() - 1
    col = torch.repeat_interleave(
        torch.arange(n_cols, device=rows.device), torch.diff(col_ptr), output_size=rows.numel()
    )
    _, perm = torch.sort(col.mul_(n_rows).add_(rows), stable=True)
    return rows[perm], values[perm]


def _sum_duplicates(rows, values, col_ptr, n_dup: int, uint16: bool):
    """Collapse each run of entries at one (row, column) into one entry:
    ``((v0 + v1) + v2) + ...`` in storage order and in the stored dtype
    (uint16's wrap-around kept), as ``toarray`` accumulates them."""
    nnz = rows.numel()
    run_start = _column_starts(col_ptr, nnz)
    run_start[1:] |= rows[1:] != rows[:-1]
    run_id = torch.cumsum(run_start, 0) - 1
    first = torch.searchsorted(run_id, torch.arange(nnz - n_dup, device=rows.device))
    length = torch.diff(first, append=first.new_tensor([nnz]))
    acc = values[first]
    for k in range(1, int(length.max())):
        more = length > k
        acc = torch.where(more, acc + values[torch.where(more, first + k, first)], acc)
    if uint16:
        acc.bitwise_and_(0xFFFF)
    return rows[first], acc, torch.searchsorted(first, col_ptr)


# -- backed (out-of-core) inputs ---------------------------------------------
class _BackedCSCHandler(DataHandler):
    """Backed CSC: column windows stream from h5ad storage, so the heap
    stays O(tile), never O(matrix)."""

    @property
    def dtype(self):
        return self.data.dtype


class IllicoBackedCSCHandler(_BackedCSCHandler):
    """This package's own lazy CSC (:class:`illico_tpu_torch.io.h5ad.BackedCSC`)."""

    def fetch_tile(self, lb, ub):
        return self.data.densify_columns(lb, ub)

    def fetch_tile_entries(self, lb, ub):
        # O(window nnz) disk read: the compact sort tiler never densifies
        # a backed tile just to re-sparsify it.
        return self.data.window_entries(lb, ub)

    def footprint(self):
        return self.data.nbytes


class H5pyDatasetDataHandler(DataHandler):
    """Backed dense matrix (``h5py.Dataset``): column windows from disk."""

    @property
    def dtype(self):
        return self.data.dtype

    def fetch_tile(self, lb, ub):
        return np.asarray(self.data[:, lb:ub])

    def footprint(self):
        return int(np.prod(self.data.shape)) * self.data.dtype.itemsize


class AnnDataBackedCSCHandler(_BackedCSCHandler):
    """anndata's backed CSC dataset (``_CSCDataset``), read through the
    private members anndata keeps for it."""

    def fetch_tile(self, lb, ub):
        return self.data[:, lb:ub].toarray()

    def fetch_tile_entries(self, lb, ub):
        d = self.data
        indptr = np.asarray(d._indptr, dtype=np.int64)
        s, e = int(indptr[lb]), int(indptr[ub])
        rows = np.asarray(d._indices[s:e], dtype=np.int64)
        cols = np.repeat(
            np.arange(ub - lb, dtype=np.int64), np.diff(indptr[lb : ub + 1])
        )
        return d._data[s:e], rows, cols

    def footprint(self):
        d = self.data
        return (
            d._data.dtype.itemsize * d._data.shape[0]
            + d._indices.dtype.itemsize * d._indices.shape[0]
            + d._indptr.nbytes
        )


def ensure_backed_handlers() -> None:
    """Register the backed handlers whose libraries import (idempotent).

    Deferred to the first API call so that importing the package needs
    neither ``h5py`` nor ``anndata``.  ``BackedCSR`` stays unregistered.
    """
    from illico_tpu_torch.io.h5ad import BackedCSC

    data_handler_registry[BackedCSC] = IllicoBackedCSCHandler
    try:
        import h5py
    except ImportError:
        pass
    else:
        data_handler_registry[h5py.Dataset] = H5pyDatasetDataHandler
    try:
        from anndata._core import sparse_dataset as _sd
    except ImportError:
        pass
    else:
        data_handler_registry[_sd._CSCDataset] = AnnDataBackedCSCHandler
