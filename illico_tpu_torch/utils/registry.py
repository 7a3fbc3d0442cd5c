"""Input-format dispatch: data handlers and their registry.

Port of the in-RAM part of ``illico_tpu.utils.registry``: every handler
produces *dense gene tiles* ``(n_cells, tile_width)`` in original row order,
and one device engine consumes them.  Registered here: ``np.ndarray``, scipy
CSR and CSC (matrix and array classes).  Any other type raises ``KeyError``
with the same message as the reference package.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
from scipy import sparse as sp

__all__ = ["DataHandler", "data_handler_registry", "DataHandlerRegistry"]


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
    def fetch_columns(self, idx) -> np.ndarray:
        """Dense (n_cells, len(idx)) gather of arbitrary columns (the
        histogram-overflow fallback)."""

    def tile_footprint(self, width: int) -> int:
        """Host bytes materialized per tile of ``width`` columns."""
        return int(self.shape[0]) * width * np.dtype(self.dtype).itemsize

    def validate(self) -> None:
        """Input invariant checks; raise ValueError on violation."""


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


class _SparseDataHandler(DataHandler):
    @property
    def dtype(self):
        return self.data.data.dtype

    def fetch_columns(self, idx):
        return self.data[:, np.asarray(idx)].toarray()


@data_handler_registry.register(sp.csr_matrix)
class CSRDataHandler(_SparseDataHandler):
    """In-RAM CSR.  Column windowing relies on sorted indices per row
    (scipy's column slice binary-searches them), hence the validation."""

    def fetch_tile(self, lb, ub):
        out = np.zeros((self.data.shape[0], ub - lb), dtype=self.dtype)
        self.data[:, lb:ub].tocsc().toarray(out=out)
        return out

    def validate(self):
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
                raise ValueError(
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


data_handler_registry[sp.csr_array] = CSRDataHandler
data_handler_registry[sp.csc_array] = CSCDataHandler
