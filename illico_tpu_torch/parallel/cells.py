"""Cell-axis sharding: 2-D (cells x genes) meshes for the histogram engine.

Port of ``illico_tpu.parallel.cells``.  Per-group rank sums do not compose
across cell shards, but the histogram engine's per-(group, value, column)
counts are additive over cells: each cell shard sweeps its own rows with the
unchanged histogram kernel, the per-shard histograms are added on the gene
column's lead device, and every contraction downstream is the single-device
one bit for bit (the counts are exact float32 integers below 2**24, and
adding such integers is exact in any order).

Shard ``s`` owns the contiguous input rows ``[s * rows_per_shard,
(s + 1) * rows_per_shard)``; the last shard is simply shorter.  Each shard
gets the kernel's inputs over its local rows: ``perm`` (local row per slot,
group-contiguous), ``indptr`` (a group absent from the shard has an empty
segment, whose histogram rows the kernel writes as zeros) and ``order``.
The reference's all-pad blocks, super-block padding and block metadata serve
its sweep's flush and have no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from illico_tpu_torch.parallel.mesh import (
    DeviceMesh,
    Shard,
    _canonical,
    _new_stream,
    _sharded,
    make_gene_mesh,
    on_device,
    visible_devices,
)

__all__ = [
    "CellShardPlan",
    "make_mesh_2d",
    "mesh_from_spec",
    "build_cell_shard_plans",
    "make_cell_sharded_hist_fn",
]


def mesh_from_spec(spec, devices=None) -> DeviceMesh | None:
    """Mesh from a user ``devices=`` spec: the single validation point
    shared by the public API and the multi-process layer.

    ``None``/``1`` -> no mesh; ``int > 1`` -> 1-D gene mesh;
    ``(cell_devices, gene_devices)`` -> 2-D cells x genes mesh.  A ``(1, g)``
    pair shards no cells, so it routes to the 1-D gene mesh (any engine, no
    plan and no histogram sum).
    """
    if spec is None:
        return None
    if isinstance(spec, (tuple, list)):
        if len(spec) != 2:
            raise ValueError(
                f"devices must be an int or a (cell_devices, gene_devices) "
                f"pair; got {spec!r}"
            )
        cell_dev, gene_dev = (int(v) for v in spec)
        if cell_dev < 1 or gene_dev < 1:
            raise ValueError(
                f"devices axis sizes must be >= 1; got {spec!r}"
            )
        if cell_dev > 1:
            return make_mesh_2d(cell_dev, gene_dev, devices=devices)
        if gene_dev > 1:
            return make_gene_mesh(gene_dev, devices=devices)
        return None
    if int(spec) > 1:
        return make_gene_mesh(int(spec), devices=devices)
    return None


def make_mesh_2d(cell_devices: int, gene_devices: int, devices=None) -> DeviceMesh:
    """2-D mesh with axes ``("cells", "genes")``; ``devices`` as in
    :func:`illico_tpu_torch.parallel.mesh.make_gene_mesh`.

    The cell axis carries the one transfer between devices (each shard's
    histogram to its gene column's lead); the gene axis moves nothing.
    """
    devices = visible_devices() if devices is None else list(devices)
    cell_devices, gene_devices = int(cell_devices), int(gene_devices)
    n = cell_devices * gene_devices
    if n > len(devices):
        raise ValueError(
            f"Requested {cell_devices}x{gene_devices} = {n} devices but "
            f"only {len(devices)} are available."
        )
    flat = [_canonical(d) for d in devices[:n]]
    grid = tuple(
        tuple(flat[s * gene_devices : (s + 1) * gene_devices])
        for s in range(cell_devices)
    )
    return DeviceMesh(grid, ("cells", "genes"))


class CellShardPlan(NamedTuple):
    """Host-side histogram-kernel inputs of every cell shard.

    ``perm[s]`` holds *local* row indices into shard ``s``'s block of input
    rows ``row_bounds[s]``, stably ordered by group; ``indptr[s]`` the
    (n_groups + 1) segment bounds (empty segments allowed); ``order[s]`` the
    groups by descending local size (the kernel's launch order).
    """

    perm: list        # per shard (rows of the shard,) int32
    indptr: list      # per shard (n_groups + 1,) int64
    order: list       # per shard (n_groups,) int32
    row_bounds: list  # per shard (lo, hi) input rows
    rows_per_shard: int
    n_shards: int
    n_groups: int
    n_cells: int


def build_cell_shard_plans(info, n_shards: int) -> CellShardPlan:
    """Per-shard kernel inputs for a cell-sharded run: contiguous row blocks
    of ``ceil(n_cells / n_shards)`` rows, each stably sorted by group."""
    codes = np.asarray(info.encoded_groups)
    n_groups = int(info.n_groups)
    n_cells = int(codes.size)
    s_count = int(n_shards)
    if s_count < 1:
        raise ValueError(f"n_shards must be >= 1 (got {n_shards})")
    rows_per_shard = -(-n_cells // s_count)
    perm, indptr, order, row_bounds = [], [], [], []
    for s in range(s_count):
        lo = min(s * rows_per_shard, n_cells)
        hi = min(lo + rows_per_shard, n_cells)
        local = codes[lo:hi]
        cnt = np.bincount(local, minlength=n_groups).astype(np.int64)
        ptr = np.zeros(n_groups + 1, np.int64)
        np.cumsum(cnt, out=ptr[1:])
        perm.append(np.argsort(local, kind="stable").astype(np.int32))
        indptr.append(ptr)
        order.append(np.argsort(-cnt, kind="stable").astype(np.int32))
        row_bounds.append((lo, hi))
    return CellShardPlan(
        perm=perm, indptr=indptr, order=order, row_bounds=row_bounds,
        rows_per_shard=int(rows_per_shard), n_shards=s_count,
        n_groups=n_groups, n_cells=n_cells,
    )


def _summed_hist_fn(local_args, devices, streams, is_log1p: bool):
    """``fn(blocks, mark)``: the histogram of each row block on its own
    device and stream, summed on the lead (``devices[0]``) in the lead's
    stream.

    Ordering between streams.  A histogram on another card is copied to the
    lead from the source shard's context: torch runs such a copy on the
    source's stream (so it follows the kernel, and the source block is freed
    in that stream's order) and fences it both ways against the
    destination's current stream, here the lead's.  So the copy starts only
    after what the lead's stream already holds (its own kernel, earlier
    adds), and the lead's stream goes on only after the copy: the add needs
    no event of its own.  A histogram of a logical shard on the lead's own
    device is not copied: an event recorded behind its kernel is what the
    lead's stream waits for, and the histogram is marked as in use by the
    lead's stream until the add has run.
    """
    from illico_tpu_torch.ops.hist_engine import hist_pass

    lead, lead_stream = devices[0], streams[0]

    def fn(blocks, mark=None):
        with on_device(lead, lead_stream):
            total = hist_pass(blocks[0], *local_args[0], is_log1p=is_log1p)
            if mark is not None:
                mark("kernel")  # the lead's own pass; the others' end in "reduce"
            for x, args, dev, stream in zip(blocks[1:], local_args[1:], devices[1:],
                                            streams[1:]):
                with on_device(dev, stream):
                    h = hist_pass(x, *args, is_log1p=is_log1p)
                    if dev != lead:
                        h = h.to(lead, non_blocking=True)
                    elif stream is not None:
                        ready = torch.cuda.Event()
                        ready.record(stream)
                        lead_stream.wait_event(ready)
                        h.record_stream(lead_stream)
                total += h
            if mark is not None:
                mark("reduce")
        return total

    return fn


def make_cell_sharded_hist_fn(
    layout,
    plan: CellShardPlan,
    mesh: DeviceMesh,
    *,
    ref_code: int,
    is_log1p: bool,
    v_buckets: int | None = None,
    fc_u8_hint: bool = False,
    nnz_split_hint: bool = True,
    pack: bool = True,
):
    """Histogram tile function over a 2-D ``("cells", "genes")`` mesh.

    ``run.shards[j]`` takes the row blocks ``plan.row_bounds`` of gene shard
    ``j``'s columns, one per cell shard and each on that shard's device:
    local kernel launch per block -> sum on the column's lead device -> the
    standard contraction and pack there.  ``layout`` is the *global* padded
    layout: the exactness guards, the wire statics, ``ppg`` and ``n_pad``
    are shard-independent, and the summed histogram is the single-device
    one.
    """
    from illico_tpu_torch.ops.hist_engine import (
        DEFAULT_V,
        make_hist_tile_fn,
        make_value_table,
    )

    if tuple(mesh.axis_names) != ("cells", "genes"):
        raise ValueError(
            f"Cell-sharded runs need a mesh with axes ('cells', 'genes') "
            f"(got {mesh.axis_names}); build one with make_mesh_2d."
        )
    if int(mesh.shape["cells"]) != plan.n_shards:
        raise ValueError(
            f"Plan was built for {plan.n_shards} cell shards but the mesh "
            f"has {mesh.shape['cells']}."
        )
    v_buckets = DEFAULT_V if v_buckets is None else v_buckets
    table = make_value_table(v_buckets, is_log1p)

    staged: dict = {}  # (device, cell shard) -> the kernel's local inputs

    def local_inputs(dev, s):
        if (dev, s) not in staged:
            staged[(dev, s)] = tuple(
                torch.from_numpy(a).to(dev)
                for a in (plan.perm[s], plan.indptr[s], plan.order[s], table)
            )
        return staged[(dev, s)]

    counters = {"calls": 0}
    shards = []
    for j in range(int(mesh.shape["genes"])):
        devices = mesh.column(j)
        streams = tuple(_new_stream(d) for d in devices)
        hist_fn = _summed_hist_fn(
            [local_inputs(d, s) for s, d in enumerate(devices)],
            devices, streams, bool(is_log1p),
        )
        fn = make_hist_tile_fn(
            layout, ref_code=ref_code, is_log1p=is_log1p, device=devices[0],
            v_buckets=v_buckets, fc_u8_hint=fc_u8_hint,
            nnz_split_hint=nnz_split_hint, pack=pack, hist_fn=hist_fn,
        )
        shards.append(Shard(fn, devices, streams, counters, row_bounds=plan.row_bounds))
    run = _sharded(mesh, shards, counters)
    run._plan = plan
    return run
