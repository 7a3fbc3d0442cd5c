"""Multi-device execution: the device mesh and gene-axis sharding.

Port of ``illico_tpu.parallel.mesh``.  Every column's rank statistics are
independent, so a tile splits over the gene axis of a mesh with no
communication between devices: each gene shard is the single-device tile
function of its engine with the layout staged on the shard's device, fed its
own contiguous column range, and it returns its own packed buffer, which the
host consumes at the shard's column offset.  (The reference package returns
the plain dict under a mesh; this one keeps the packed wire and the native
tail per shard.)

A mesh is one process's view of its devices: a :class:`DeviceMesh` holds a
1-D tuple (axis ``"genes"``) or a 2-D cells x genes grid of
``torch.device``.  A device may appear several times; each entry is then a
logical shard with its own stream (on the CPU, simply its own slice of the
work).  Cell-axis sharding lives in :mod:`illico_tpu_torch.parallel.cells`.

There is no counterpart of the reference's ``shard_map`` wrapper or of its
ahead-of-time executable caches: torch runs eagerly, and the only things
built are the CUDA kernel and the native tail, which
:func:`illico_tpu_torch.enable_compilation_cache` builds ahead of a run.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

__all__ = [
    "DeviceMesh",
    "Shard",
    "make_gene_mesh",
    "make_sharded_tile_fn",
    "make_sharded_hist_fn",
    "make_sharded_csort_fn",
    "on_device",
    "warm_shards",
]


def _canonical(device) -> torch.device:
    """``device`` with its index filled in, so equal devices compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def visible_devices() -> list[torch.device]:
    """The default device pool: every CUDA device this process sees."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Devices laid out as a 1-D gene mesh or a 2-D cells x genes grid.

    ``grid[s][j]`` is the device of cell shard ``s`` and gene shard ``j``; a
    1-D mesh is a grid of one row.
    """

    grid: tuple[tuple[torch.device, ...], ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        sizes = (len(self.grid), len(self.grid[0]))
        return dict(zip(self.axis_names, sizes[-len(self.axis_names):]))

    @property
    def devices(self) -> tuple[torch.device, ...]:
        """Every entry of the grid, row-major."""
        return tuple(d for row in self.grid for d in row)

    def column(self, j: int) -> tuple[torch.device, ...]:
        """The devices of gene shard ``j``, cell shard 0 (its lead) first."""
        return tuple(row[j] for row in self.grid)


def make_gene_mesh(n_devices: int | None = None, devices=None) -> DeviceMesh:
    """1-D mesh over the gene axis.

    ``devices=None`` takes the visible CUDA devices.  An explicit list is
    taken as given and may name one device several times (logical shards).
    """
    devices = visible_devices() if devices is None else list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            # Silent truncation would let scaling numbers be reported for
            # a device count that never ran.
            raise ValueError(
                f"Requested {n_devices} devices but only {len(devices)} "
                "are available."
            )
        devices = devices[:n_devices]
    return DeviceMesh((tuple(_canonical(d) for d in devices),), ("genes",))


def on_device(device: torch.device, stream=None):
    """Context in which work is enqueued on ``stream`` of a CUDA ``device``
    (its current stream when None); nothing to set on the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    if stream is None:
        return torch.cuda.device(device)
    return torch.cuda.stream(stream)


def _new_stream(device: torch.device):
    return torch.cuda.Stream(device) if device.type == "cuda" else None


class Shard:
    """One gene shard of a tile function.

    ``devices[0]`` is the shard's lead: the device its tile function returns
    its packed buffer on.  A cell-sharded shard has one device per cell
    shard and ``row_bounds`` holds their row blocks; its function takes the
    list of row blocks, each on its own device.  ``streams`` holds one
    stream per device (None: the device's current stream, and always None on
    the CPU).  Calling the shard runs its function on the lead's stream and
    adds one to the shared ``counters["calls"]``.
    """

    def __init__(self, fn, devices, streams, counters, row_bounds=None):
        self.fn = fn
        self.devices = tuple(devices)
        self.streams = tuple(streams)
        self.counters = counters
        self.row_bounds = row_bounds

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def on(self):
        return on_device(self.devices[0], self.streams[0])

    def wait_for_current_streams(self) -> None:
        """Order the shard's streams after what their devices' current
        streams hold now: the layout tensors, and a device-resident input."""
        for dev, stream in zip(self.devices, self.streams):
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(dev))

    def zeros(self, n_rows: int, width: int, dtype: torch.dtype):
        """A zero tile of ``width`` columns where the shard's function takes
        its input."""
        if self.row_bounds is None:
            return torch.zeros((n_rows, width), dtype=dtype, device=self.devices[0])
        return [
            torch.zeros((hi - lo, width), dtype=dtype, device=dev)
            for (lo, hi), dev in zip(self.row_bounds, self.devices)
        ]

    def __call__(self, x, mark=None):
        with self.on():
            out = self.fn(x, mark)
        self.counters["calls"] += 1
        return out


def warm_shards(shards, make_input) -> None:
    """Run the tile function of every distinct device set once on
    ``make_input(shard)`` and wait for it; not counted as a call."""
    seen = set()
    for shard in shards:
        if shard.devices in seen:
            continue
        seen.add(shard.devices)
        shard.wait_for_current_streams()
        with shard.on():
            out = shard.fn(make_input(shard))
        if isinstance(out, dict):
            out = next(iter(out.values()))
        out.cpu()  # waits for the shard's stream


def _sharded(mesh: DeviceMesh, shards: list[Shard], counters: dict):
    """The sharded tile function: ``run(tiles)`` gives each gene shard its
    tile and returns the shards' outputs."""

    def run(tiles, mark=None):
        return [shard(x, mark) for shard, x in zip(shards, tiles)]

    first = shards[0].fn
    run.shards = shards
    run._mesh = mesh
    run._counters = counters
    run._statics = first._statics
    run.unpack = getattr(first, "unpack", None)
    run.find_spec = getattr(first, "find_spec", None)
    return run


def _gene_shards(mesh: DeviceMesh, make_fn):
    """One shard per device of a 1-D mesh; logical shards on one device
    share its tile function (and so its layout tensors)."""
    if mesh.axis_names != ("genes",):
        raise ValueError(
            f"Gene-sharded tile functions need a 1-D ('genes',) mesh (got "
            f"{mesh.axis_names}); build one with make_gene_mesh."
        )
    counters = {"calls": 0}
    fns: dict = {}
    shards = []
    for dev in mesh.devices:
        if dev not in fns:
            fns[dev] = make_fn(dev)
        shards.append(Shard(fns[dev], (dev,), (_new_stream(dev),), counters))
    return _sharded(mesh, shards, counters)


def make_sharded_tile_fn(layout, mesh: DeviceMesh, *, ref_code: int, is_log1p: bool,
                         pack: bool = True):
    """Sort-engine tile function sharded over the gene axis of ``mesh``:
    ``run.shards[j]`` is :func:`illico_tpu_torch.ops.rank_engine.make_tile_fn`
    on device ``j``."""
    from illico_tpu_torch.ops.rank_engine import make_tile_fn

    return _gene_shards(mesh, lambda dev: make_tile_fn(
        layout, ref_code=ref_code, is_log1p=is_log1p, device=dev, pack=pack))


def make_sharded_hist_fn(
    layout,
    mesh: DeviceMesh,
    *,
    ref_code: int,
    is_log1p: bool,
    v_buckets: int | None = None,
    fc_u8_hint: bool = False,
    nnz_split_hint: bool = True,
    pack: bool = True,
):
    """Histogram-engine tile function sharded over the gene axis: the
    histogram kernel and the contraction run per device on the shard's
    columns.  The kernel takes any width, so shards need no lane alignment;
    the runner keeps them at multiples of 32 columns, the kernel's column
    block."""
    from illico_tpu_torch.ops.hist_engine import DEFAULT_V, make_hist_tile_fn

    v_buckets = DEFAULT_V if v_buckets is None else v_buckets
    return _gene_shards(mesh, lambda dev: make_hist_tile_fn(
        layout, ref_code=ref_code, is_log1p=is_log1p, device=dev,
        v_buckets=v_buckets, fc_u8_hint=fc_u8_hint, nnz_split_hint=nnz_split_hint,
        pack=pack))


def make_sharded_csort_fn(group_info, mesh: DeviceMesh, *, ref_code: int, is_log1p: bool,
                          pack: bool = True):
    """Compact-sort tile function sharded over the gene axis.  Every csort
    statistic is per column, so each shard takes the compacted tile of its
    own columns (built by the host tiler per shard) and nothing crosses
    devices."""
    from illico_tpu_torch.ops.csort_engine import make_csort_tile_fn

    return _gene_shards(mesh, lambda dev: make_csort_tile_fn(
        group_info, ref_code=ref_code, is_log1p=is_log1p, device=dev, pack=pack))
