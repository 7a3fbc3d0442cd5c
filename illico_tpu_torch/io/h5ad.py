"""Minimal AnnData-compatible container (in-RAM only).

Port of ``illico_tpu.io.h5ad.AnnDataLite``, which
:func:`illico_tpu_torch.api.asymptotic_wilcoxon_arrays` wraps its inputs in.
Real ``anndata.AnnData`` objects are accepted by the public API through duck
typing (``.X``, ``.obs``, ``.var_names``, ``.layers``).
"""

from __future__ import annotations

import pandas as pd

__all__ = ["AnnDataLite"]


class AnnDataLite:
    """AnnData-compatible container for the DE workflow."""

    def __init__(self, X, obs: pd.DataFrame | None = None,
                 var: pd.DataFrame | None = None, layers: dict | None = None):
        self.X = X
        n_obs, n_vars = X.shape
        self.obs = obs if obs is not None else pd.DataFrame(index=pd.RangeIndex(n_obs).astype(str))
        self.var = var if var is not None else pd.DataFrame(index=pd.RangeIndex(n_vars).astype(str))
        if len(self.obs) != n_obs:
            raise ValueError(f"obs has {len(self.obs)} rows but X has {n_obs}.")
        if len(self.var) != n_vars:
            raise ValueError(f"var has {len(self.var)} rows but X has {n_vars}.")
        self.layers = layers or {}

    @property
    def obs_names(self):
        return self.obs.index

    @property
    def var_names(self):
        return self.var.index
