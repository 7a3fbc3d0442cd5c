"""Multi-process execution: per-process gene windows, one result gather.

Port of ``illico_tpu.parallel.multihost``, with ``torch.distributed`` in the
place of ``jax.distributed``:

- Every process ("host") of the job owns one contiguous gene window
  (:func:`host_gene_window`) and reads ONLY that window from its storage
  handler, so a backed dataset is read window by window and raw expression
  data never crosses between processes.
- Each process runs the standard runner over its window on its local
  devices (a gene mesh over them when there are several, or
  ``local_mesh=(cell_devices, gene_devices)``).  The hot path has no
  communication between processes.
- The one collective is the final all-gather of the ``(n_groups,
  window, 3)`` float64 result blocks, after which every process holds the
  identical full DataFrame.  The blocks are host arrays, so the gather runs
  over the **gloo** backend on CPU tensors whatever the compute device is:
  two processes may share one card, and float64 crosses unchanged.

:func:`simulate_multihost` drives the same per-host unit
(:func:`_run_host_window`) for every host inside one process, each on its
own slice of a device pool: window math, per-host fetch, per-host mesh and
block assembly are exactly what a real multi-process run executes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from illico_tpu_torch.utils.log import logger

__all__ = [
    "initialize_distributed",
    "host_gene_window",
    "window_handler",
    "ColumnWindowHandler",
    "asymptotic_wilcoxon_multihost",
    "simulate_multihost",
]

_ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _process_count_index() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kwargs,
) -> tuple[int, int]:
    """Bring up ``torch.distributed`` for a multi-process run; a
    single-process no-op otherwise.  Returns ``(process_count,
    process_index)`` either way, and calling it twice is safe.

    With arguments, the process group is initialized over
    ``tcp://<coordinator_address>`` (a ``host:port`` string, or a full init
    method URL) with ``num_processes`` ranks, this one being
    ``process_id``; ``kwargs`` go to ``init_process_group`` (``timeout=``).
    With none, the launcher's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, as ``torchrun`` sets them) is used when it is there,
    and a plain single-process session stays as it is.  The backend is
    gloo: the only collective gathers host arrays.

    ANY explicit argument signals a cluster: an incomplete configuration
    raises ``ValueError`` instead of leaving every process to compute the
    whole gene axis on its own.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return _process_count_index()
    explicit = (
        coordinator_address is not None
        or num_processes is not None
        or process_id is not None
        or bool(kwargs)
    )
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError(
                "An explicit multi-process configuration needs "
                "coordinator_address, num_processes and process_id (got "
                f"{coordinator_address!r}, {num_processes!r}, {process_id!r})."
            )
        address = str(coordinator_address)
        init_method = address if "://" in address else f"tcp://{address}"
        dist.init_process_group(
            "gloo", init_method=init_method, world_size=int(num_processes),
            rank=int(process_id), **kwargs,
        )
    elif all(name in os.environ for name in _ENV_VARS):
        dist.init_process_group("gloo", init_method="env://")
    return _process_count_index()


def _window_base(n_genes: int, num_hosts: int, align: int = 128) -> int:
    """Common (aligned) per-host window width: the one source of truth
    shared by :func:`host_gene_window` and the all-gather padding."""
    base = -(-n_genes // num_hosts)  # ceil
    return -(-base // align) * align  # round up to alignment


def host_gene_window(
    n_genes: int, num_hosts: int, host_id: int, align: int = 128
) -> tuple[int, int]:
    """Contiguous gene window [lb, ub) owned by ``host_id``.

    Windows are balanced and ``align``-aligned (128, as in the reference
    package, so both split a gene axis the same way).  Trailing hosts may
    receive empty windows when ``n_genes`` is small; they still take part in
    the final gather.
    """
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} outside [0, {num_hosts}).")
    base = _window_base(n_genes, num_hosts, align)
    lb = min(host_id * base, n_genes)
    ub = min(lb + base, n_genes)
    return lb, ub


class ColumnWindowHandler:
    """Restriction of a :class:`DataHandler` to columns ``[lb, ub)``.

    Every fetch the runner makes is offset into the window, so a backed
    dataset is only ever read inside it.  Duck-types the handler surface the
    runner consumes.
    """

    def __init__(self, base, lb: int, ub: int):
        n_genes = int(base.shape[1])
        if not 0 <= lb <= ub <= n_genes:
            raise ValueError(
                f"Window [{lb}, {ub}) outside the gene axis [0, {n_genes})."
            )
        self.base = base
        self.lb, self.ub = int(lb), int(ub)

    @property
    def data(self):
        # The handler convention exposes the raw matrix as ``.data``, but
        # this handler's whole contract is column restriction and the base
        # matrix is NOT window-offset.  Fail loudly rather than let a
        # consumer silently read full-axis columns.
        raise AttributeError(
            "ColumnWindowHandler does not expose .data: the base matrix is "
            "not window-offset; use fetch_tile/fetch_columns."
        )

    @property
    def shape(self) -> tuple[int, int]:
        return (int(self.base.shape[0]), self.ub - self.lb)

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def is_device(self) -> bool:
        # Device-resident bases are sliced up front by window_handler().
        return False

    def fetch_tile(self, lb: int, ub: int):
        return self.base.fetch_tile(self.lb + lb, self.lb + ub)

    def fetch_tile_entries(self, lb: int, ub: int):
        # Entry columns are tile-relative, so the offset window needs no fix-up.
        return self.base.fetch_tile_entries(self.lb + lb, self.lb + ub)

    def fetch_columns(self, idx):
        return self.base.fetch_columns(np.asarray(idx, dtype=np.int64) + self.lb)

    def density(self) -> float | None:
        return self.base.density()

    def footprint(self) -> int:
        n_genes = max(1, int(self.base.shape[1]))
        return int(self.base.footprint() * (self.ub - self.lb) / n_genes)

    def tile_footprint(self, width: int) -> int:
        return self.base.tile_footprint(width)

    def validate(self) -> None:
        self.base.validate()


def window_handler(base, lb: int, ub: int):
    """Window view of ``base``; a device-resident matrix is sliced where it
    lives and handled like any tensor input."""
    if getattr(base, "is_device", False):
        from illico_tpu_torch.utils.registry import data_handler_registry

        return data_handler_registry.get(base.data[:, lb:ub])
    return ColumnWindowHandler(base, lb, ub)


def _run_host_window(
    handler,
    info,
    *,
    num_hosts: int,
    host_id: int,
    local_devices=None,
    is_log1p: bool,
    batch_size="auto",
    n_threads: int = 1,
    use_continuity: bool = True,
    tie_correct: bool = True,
    alternative: str = "two-sided",
    engine: str = "auto",
    precompile: bool = True,
    progress: bool = False,
    local_mesh: tuple[int, int] | None = None,
    device=None,
) -> tuple[int, int, np.ndarray]:
    """One host's unit of work: fetch + compute its gene window.

    ``local_devices`` is the host's device pool (default: ``device`` when
    given, or the device of a device-resident matrix, else the process's
    visible CUDA devices): a 1-D gene mesh over it when it holds more than
    one device.  ``local_mesh=(cell_devices, gene_devices)`` lays it out as
    a 2-D mesh instead (with one named device, as logical shards on it), and
    raises when the pool holds fewer devices than that.

    Returns ``(lb, ub, block)`` with ``block`` of shape
    ``(n_groups, ub - lb, 3)`` in [p, U, fc] layout.
    """
    from illico_tpu_torch.api import resolve_device
    from illico_tpu_torch.models.wilcoxon import WilcoxonRunner
    from illico_tpu_torch.parallel.cells import mesh_from_spec
    from illico_tpu_torch.parallel.mesh import make_gene_mesh, visible_devices

    n_genes = int(handler.shape[1])
    lb, ub = host_gene_window(n_genes, num_hosts, host_id)
    G = info.n_groups
    if ub == lb:
        return lb, ub, np.empty((G, 0, 3), np.float64)

    if local_devices is None:
        data = handler.data if getattr(handler, "is_device", False) else None
        if device is not None or data is not None:
            # One named device: a local mesh's shards are logical shards on it.
            n = int(np.prod(local_mesh)) if local_mesh is not None else 1
            local_devices = [resolve_device(device, data)] * n
        else:
            resolve_device(None)  # raises where there is no CUDA device
            local_devices = visible_devices()
    local_devices = list(local_devices)
    if local_mesh is not None:
        mesh = mesh_from_spec(local_mesh, devices=local_devices)
    elif len(local_devices) > 1:
        mesh = make_gene_mesh(devices=local_devices)
    else:
        mesh = None

    runner = WilcoxonRunner(
        window_handler(handler, lb, ub),
        info,
        is_log1p=is_log1p,
        batch_size=batch_size,
        n_threads=n_threads,
        use_continuity=use_continuity,
        tie_correct=tie_correct,
        alternative=alternative,
        engine=engine,
        mesh=mesh,
        device=local_devices[0],
    )
    if precompile:
        runner.precompile()
    res = runner.run(progress=progress)
    return lb, ub, np.ascontiguousarray(res.stacked)


def _assemble_blocks(blocks, n_groups: int, n_genes: int) -> np.ndarray:
    """Scatter per-host ``(lb, ub, block)`` windows into one full result.

    Windows must tile [0, n_genes) exactly: disjointness is checked per
    window, not just by summed width, so an overlapping-plus-gap
    misconfiguration cannot slip uninitialized memory into the results.
    """
    out = np.empty((n_groups, n_genes, 3), np.float64)
    prev_ub = 0
    for lb, ub, block in sorted(blocks, key=lambda b: b[0]):
        if lb != prev_ub or ub < lb:
            raise RuntimeError(
                f"Host windows do not tile the gene axis: window [{lb}, {ub}) "
                f"follows coverage up to {prev_ub}; inconsistent "
                "(n_genes, num_hosts) across hosts?"
            )
        out[:, lb:ub, :] = block[:, : ub - lb, :]
        prev_ub = ub
    if prev_ub != n_genes:
        raise RuntimeError(
            f"Host windows cover only [0, {prev_ub}) of {n_genes} genes; "
            "inconsistent (n_genes, num_hosts) across hosts?"
        )
    return out


def _allgather_blocks(
    lb: int, ub: int, block: np.ndarray, n_genes: int, num_hosts: int
) -> np.ndarray:
    """Gather of the per-host result blocks (the ONLY collective between
    processes).  Blocks are padded to the common window width so the
    all-gather is one dense float64 tensor per host; every host returns the
    identical assembled ``(n_groups, n_genes, 3)``.  The tensors are CPU
    tensors, so the job's process group must gather those (gloo, as
    :func:`initialize_distributed` sets it up)."""
    import torch.distributed as dist

    G = block.shape[0]
    base = _window_base(n_genes, num_hosts)
    padded = np.zeros((G, base, 3), np.float64)
    padded[:, : ub - lb, :] = block
    gathered = [torch.empty((G, base, 3), dtype=torch.float64) for _ in range(num_hosts)]
    dist.all_gather(gathered, torch.from_numpy(padded))
    blocks = [
        (*host_gene_window(n_genes, num_hosts, h), gathered[h].numpy())
        for h in range(num_hosts)
    ]
    return _assemble_blocks(blocks, G, n_genes)


def _prepare(adata, group_keys, reference, layer):
    """The validated handler, the group names and the encoded groups."""
    from illico_tpu_torch.utils.groups import encode_and_count_groups
    from illico_tpu_torch.utils.registry import (
        data_handler_registry,
        ensure_backed_handlers,
    )

    ensure_backed_handlers()
    X = adata.layers[layer] if layer is not None else adata.X
    handler = data_handler_registry.get(X)
    handler.validate()
    raw_groups = np.asarray(adata.obs[group_keys])
    unique_groups, info = encode_and_count_groups(raw_groups, reference)
    return handler, unique_groups, info


def asymptotic_wilcoxon_multihost(
    adata,
    is_log1p: bool,
    group_keys: str,
    reference: str | None = None,
    *,
    layer: str | None = None,
    **kwargs,
):
    """Multi-process entry point: same contract as ``asymptotic_wilcoxon``.

    Run the same program in every process of an initialized
    ``torch.distributed`` job (see :func:`initialize_distributed`).  Each
    process computes its own gene window on its local devices (``device=``
    names one; the default is every CUDA device the process sees); the final
    DataFrame is identical in every process.  In a single-process session
    this is the whole gene axis on the local devices.

    ``adata`` must expose the same genes in every process; for backed h5ad
    data each process opens the (shared or replicated) file and reads only
    its window.

    ``local_mesh=(cell_devices, gene_devices)`` lays each process's devices
    out as a 2-D mesh (cell-axis sharding, histogram engine only) instead of
    the default 1-D gene mesh.
    """
    from illico_tpu_torch.api import build_result_frame

    handler, unique_groups, info = _prepare(adata, group_keys, reference, layer)
    num_hosts, host_id = _process_count_index()
    n_genes = int(handler.shape[1])
    logger.trace(
        "Multi-process run: process %d/%d owns genes %s of %d.",
        host_id, num_hosts, host_gene_window(n_genes, num_hosts, host_id),
        n_genes,
    )
    lb, ub, block = _run_host_window(
        handler, info,
        num_hosts=num_hosts, host_id=host_id,
        is_log1p=is_log1p, **kwargs,
    )
    if num_hosts > 1:
        full = _allgather_blocks(lb, ub, block, n_genes, num_hosts)
    else:
        full = _assemble_blocks([(lb, ub, block)], info.n_groups, n_genes)
    return build_result_frame(unique_groups, adata.var_names, full.reshape(-1, 3))


def simulate_multihost(
    adata,
    is_log1p: bool,
    group_keys: str,
    reference: str | None = None,
    *,
    n_hosts: int,
    devices_per_host: int,
    devices=None,
    layer: str | None = None,
    **kwargs,
):
    """Single-process simulation of the multi-process layout.

    Runs every host's window one after the other, each on its own
    ``devices_per_host``-device slice of ``devices`` (default: the visible
    CUDA devices; an explicit pool may name one device several times), then
    assembles the blocks exactly as the gather would.  Everything except
    the process boundary is the real multi-process code path.
    """
    from illico_tpu_torch.api import build_result_frame
    from illico_tpu_torch.parallel.mesh import visible_devices

    devices = visible_devices() if devices is None else list(devices)
    if n_hosts * devices_per_host > len(devices):
        raise ValueError(
            f"Simulating {n_hosts} hosts x {devices_per_host} devices needs "
            f"{n_hosts * devices_per_host} devices; only {len(devices)} exist."
        )
    handler, unique_groups, info = _prepare(adata, group_keys, reference, layer)
    blocks = []
    for h in range(n_hosts):
        local = devices[h * devices_per_host : (h + 1) * devices_per_host]
        blocks.append(
            _run_host_window(
                handler, info,
                num_hosts=n_hosts, host_id=h, local_devices=local,
                is_log1p=is_log1p, **kwargs,
            )
        )
    full = _assemble_blocks(blocks, info.n_groups, int(handler.shape[1]))
    return build_result_frame(unique_groups, adata.var_names, full.reshape(-1, 3))
