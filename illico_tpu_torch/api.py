"""Public API: asymptotic Wilcoxon rank-sum tests on a torch device.

Same signature and output contract as ``illico_tpu.api``: a DataFrame
indexed by ``(pert, feature)`` with columns ``p_value``, ``statistic`` (U of
the reference sample, exact) and ``fold_change``.  Computation runs on
``torch.device("cuda")`` unless ``device`` says otherwise (the tests pass
``device="cpu"``, where every kernel runs as its plain torch version), or
over several devices with ``devices=``.

The DataFrame's ``attrs["stage_seconds"]`` holds the run's per-stage
seconds (see :class:`illico_tpu_torch.models.wilcoxon.RunResult`),
``attrs["stage_seconds_by_device"]`` the device stages per device,
``attrs["consume_path"]`` how many tiles the native tail and numpy consumed,
``attrs["tail_threads"]`` the native tail's thread count, and
``attrs["input_route"]`` where the tiles were made (``"device"`` or
``"host"``).
"""

from __future__ import annotations

import time as _time
from typing import Literal

import numpy as np
import pandas as pd
import torch

from illico_tpu_torch.models.wilcoxon import WilcoxonRunner
from illico_tpu_torch.utils.groups import encode_and_count_groups
from illico_tpu_torch.utils.log import logger
from illico_tpu_torch.utils.registry import data_handler_registry, ensure_backed_handlers

__all__ = [
    "asymptotic_wilcoxon",
    "asymptotic_wilcoxon_arrays",
    "resolve_device",
    "resolve_mesh",
]


def resolve_device(device, X=None) -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA, which must exist.

    A CUDA tensor ``X`` is device-resident input: with ``device=None`` the
    run takes the tensor's device, and an explicit ``device`` that names
    another one raises ``ValueError`` (the matrix is not moved)."""
    if isinstance(X, torch.Tensor) and X.is_cuda:
        if device is not None:
            dev = torch.device(device)
            if dev.type != "cuda" or dev.index not in (None, X.device.index):
                raise ValueError(
                    f"The input tensor lives on {X.device} but device={device!r} was "
                    "requested; move the tensor, or leave device=None to run "
                    "where it is."
                )
        return X.device
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "illico_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain torch "
                "versions of the kernels on the CPU."
            )
        return torch.device("cuda")
    return torch.device(device)


def resolve_mesh(devices, device=None, X=None):
    """The mesh of a ``devices=`` spec, or None for a single-device run.

    With ``device=None`` the pool is the visible CUDA devices (a CUDA tensor
    ``X`` puts its own device first), and asking for more than there are
    raises ``ValueError``.  An explicit ``device`` places every shard on
    that device as logical shards.
    """
    from illico_tpu_torch.parallel.cells import mesh_from_spec

    if devices is None:
        return None
    dev = resolve_device(device, X)
    if device is not None:
        # As many entries as any valid spec can ask for; a malformed spec
        # raises in mesh_from_spec whatever the pool.
        n = int(np.prod(devices)) if isinstance(devices, (tuple, list)) else int(devices)
        return mesh_from_spec(devices, devices=[dev] * max(n, 1))
    pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if dev.index is not None and dev in pool:
        pool.remove(dev)
        pool.insert(0, dev)
    return mesh_from_spec(devices, devices=pool)


def asymptotic_wilcoxon(
    adata,
    is_log1p: bool,
    group_keys: str,
    reference: str | None = None,
    n_threads: int = 1,
    batch_size: int | Literal["auto"] = "auto",
    alternative: str = "two-sided",
    use_continuity: bool = True,
    tie_correct: bool = True,
    layer: str | None = None,
    precompile: bool = True,
    device=None,
    devices: int | tuple[int, int] | None = None,
    progress: bool = True,
    engine: str = "auto",
    profile_dir: str | None = None,
) -> pd.DataFrame:
    """Asymptotic Mann-Whitney (Wilcoxon rank-sum) differential expression.

    One-versus-rest (OVR) tests when ``reference`` is None, else
    one-versus-one (OVO) tests of every group against ``reference``, per
    gene, over an in-RAM dense, CSR or CSC matrix or an h5ad-backed dense
    or CSC matrix (backed CSR is not supported, as in the reference).
    ``device`` is a torch device or string (default CUDA).  ``engine``
    selects the device path: ``"hist"`` (histogram contraction, the fast
    path for integer-count / log1p data, with an exact per-column sort
    fallback), ``"sort"`` (full-column sort), ``"csort"`` (compact sort:
    ranks only the nonzeros, normalized or scaled floats included, and adds
    the zero block in closed form), or ``"auto"`` (hist for tabulable
    counts, csort for other data at most half nonzero, sort otherwise).
    ``X`` may also be a ``torch.Tensor``: a CUDA tensor is used where it
    lives (no fetch, no host-to-device copy; ``device`` defaults to its
    device), a CPU tensor is host input like an ``ndarray``.  An in-RAM CSR
    or CSC on one CUDA device, with the histogram or sort engine, is
    uploaded once per call and ordered by column on the card, which then
    makes every tile and fallback chunk, when that copy fits half the
    card's free memory with room to convert it; otherwise (csort,
    ``devices=``, a matrix too large) it is staged from the host tile by
    tile, as dense and backed inputs are.
    ``precompile`` warms the run up before the tile loop: it builds and
    loads the CUDA kernel and the native C++ tail and runs the tile function
    once on a zero tile of the run's shape.  ``profile_dir`` wraps the run
    in ``torch.profiler.profile`` and writes a Chrome trace
    (``trace.json``) into that directory.

    ``devices`` selects multi-device sharding: an int ``n > 1`` shards every
    tile over a 1-D gene mesh of ``n`` devices (no communication between
    them, any engine); a pair ``(cell_devices, gene_devices)`` lays the
    devices out as a 2-D mesh whose cell axis splits the rows and sums the
    per-shard histograms on one device per gene shard (histogram engine
    only): the scaling axis for datasets too tall for one device's memory.
    ``None`` uses one device.  The pool is the visible CUDA devices, and
    asking for more than there are raises ``ValueError``.  With an explicit
    ``device`` (the tests' ``"cpu"``, or ``"cuda:0"`` on a one-card machine)
    every shard is placed on that device as a logical shard with a stream of
    its own: that buys coverage of the sharded code, not speed.  A CUDA
    tensor input is sliced per shard where it lives and copied to a shard's
    device when that is another card.

    ``df.attrs`` carries ``stage_seconds``, ``stage_seconds_by_device``,
    ``engine``, ``n_fallback_cols``, ``consume_path`` (shard tiles
    consumed by the native tail and by numpy), ``tail_threads`` (the native
    tail's threads: ``ILLICO_TPU_TAIL_THREADS``, else the cores this
    process may use, less the prefetch threads on host input) and
    ``input_route`` (``"device"`` when the tiles were made on the device,
    else ``"host"``).
    """
    if alternative not in ("two-sided", "greater", "less"):
        raise ValueError(f"Unsupported alternative hypothesis: {alternative}")
    ensure_backed_handlers()
    if layer is not None:
        logger.info(f"Using layer '{layer}' for differential expression.")
        X = adata.layers[layer]
    else:
        X = adata.X
    mesh = resolve_mesh(devices, device, X)
    dev = resolve_device(device, X)

    handler = data_handler_registry.get(X)
    handler.validate()

    t0 = _time.perf_counter()
    raw_groups = np.asarray(adata.obs[group_keys])
    unique_groups, info = encode_and_count_groups(raw_groups, reference)
    logger.trace("Group encoding: %.2fs.", _time.perf_counter() - t0)
    logger.info(
        "Found %d unique groups (min size: %d cells; max size: %d cells), "
        "with reference group: %s",
        info.n_groups, int(info.counts.min()), int(info.counts.max()), reference,
    )

    t0 = _time.perf_counter()
    runner = WilcoxonRunner(
        handler,
        info,
        is_log1p=is_log1p,
        device=dev,
        mesh=mesh,
        batch_size=batch_size,
        n_threads=n_threads,
        use_continuity=use_continuity,
        tie_correct=tie_correct,
        alternative=alternative,
        engine=engine,
    )
    setup = _time.perf_counter() - t0
    if precompile:
        runner.precompile()
    res = runner.run(progress=progress, profile_dir=profile_dir)

    df = build_result_frame(unique_groups, adata.var_names, res.stacked.reshape(-1, 3))
    df.attrs["stage_seconds"] = {"setup": setup, **res.stage_seconds}
    df.attrs["stage_seconds_by_device"] = res.stage_seconds_by_device
    df.attrs["engine"] = runner.engine
    df.attrs["n_fallback_cols"] = res.n_fallback_cols
    df.attrs["consume_path"] = dict(res.consume_path)
    df.attrs["tail_threads"] = res.tail_threads
    df.attrs["input_route"] = runner.input_route
    return df


def build_result_frame(unique_groups, var_names, stacked) -> pd.DataFrame:
    """Assemble the output DataFrame from a (n_groups*n_genes, 3) [p, U, fc]
    block: MultiIndex ``(pert, feature)`` and three named columns."""
    rows = pd.Series(unique_groups, name="pert", dtype=str)
    cols = pd.Series(np.asarray(var_names), name="feature", dtype=str)
    return pd.DataFrame(
        data=stacked,
        index=pd.MultiIndex.from_product([rows, cols], names=["pert", "feature"]),
        columns=["p_value", "statistic", "fold_change"],
        copy=False,
    )


def asymptotic_wilcoxon_arrays(
    X,
    groups,
    *,
    is_log1p: bool = False,
    reference: str | None = None,
    var_names=None,
    **kwargs,
) -> pd.DataFrame:
    """Array-first variant: ``X`` (n_cells, n_genes) + per-cell group labels."""
    from illico_tpu_torch.io.h5ad import AnnDataLite

    groups = np.asarray(groups)
    obs = pd.DataFrame({"group": groups})
    var = pd.DataFrame(
        index=(
            pd.Index(var_names)
            if var_names is not None
            else pd.Index([f"gene_{i}" for i in range(X.shape[1])])
        )
    )
    adata = AnnDataLite(X, obs, var)
    return asymptotic_wilcoxon(
        adata, is_log1p=is_log1p, group_keys="group", reference=reference, **kwargs
    )
