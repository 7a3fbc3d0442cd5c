"""Orchestration of the asymptotic Wilcoxon test over gene tiles.

Port of ``illico_tpu.models.wilcoxon``.  Gene columns are processed in
contiguous tiles: prefetch threads densify the next tiles while
the device works on the current one; each tile is staged through a pinned
host buffer, copied to the device without blocking, reduced to
per-(group, gene) statistics by the histogram, sort or compact sort engine,
packed into one ``uint8`` buffer (:mod:`illico_tpu_torch.ops.wire`), copied
back into pinned memory, and turned into p-values and fold changes on the
host by the native C++ consumer (:mod:`illico_tpu_torch.native`), or by
numpy when that library is not available.  Columns the histogram's value
table cannot hold are recomputed exactly by the sort engine.  Compact-sort
tiles (nonzeros only) are built by the prefetch threads and staged as three
arrays.  A matrix that already lives on the device (a ``torch.Tensor``
there) is sliced in place: no fetch, no staging, every tile dispatched up
front.  So is an in-RAM CSR or CSC on a single-device CUDA run of the
histogram or sort engine when its column-ordered copy fits the card: it is
uploaded once at the start of :meth:`WilcoxonRunner.run` and every tile and
fallback chunk is densified from it on the device
(:class:`~illico_tpu_torch.utils.registry.DeviceSparseDataHandler`).

Under a device mesh (:mod:`illico_tpu_torch.parallel`) a tile splits into
one contiguous column range per gene shard, and the loop runs over (tile,
shard) pairs: each shard has its own device, stream, pinned staging slots,
result-buffer pool and stage clock, and consecutive pairs go to different
shards, so distinct cards overlap.  Under a cell mesh a gene shard's tile
also splits into one row block per cell shard (see
:mod:`illico_tpu_torch.parallel.cells`).
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Literal

import numpy as np
import torch

import illico_tpu_torch.native as native
from illico_tpu_torch.ops.csort_engine import CompactTile
from illico_tpu_torch.ops.rank_engine import BLOCK, build_padded_layout, make_tile_fn
from illico_tpu_torch.parallel.mesh import Shard, on_device, warm_shards
from illico_tpu_torch.stats import fold_change_from_summed_expr, pvalues_from_stats
from illico_tpu_torch.utils.groups import GroupInfo
from illico_tpu_torch.utils.log import logger
from illico_tpu_torch.utils.memory import (
    device_free_bytes,
    estimate_memory_usage,
    log_memory_usage,
)
from illico_tpu_torch.utils.registry import (
    CSCDataHandler,
    CSRDataHandler,
    DataHandler,
    DeviceSparseDataHandler,
    device_sparse_dtype,
)

__all__ = ["WilcoxonRunner", "RunResult", "compute_tile_bounds"]

# OVO sentinel values for the reference group's own row.
REF_SENTINEL_P = 1.0
REF_SENTINEL_U = -1.0

# Above this nonzero fraction the compact sort engine's win over the
# full-column sort fades (compaction costs ~ density x the full sort), and
# auto-selection keeps the plain sort engine.
CSORT_MAX_DENSITY = 0.5

# Share of the free device memory the histogram engine's per-tile workspace
# may take when the auto tile width is chosen.
_DEVICE_MEM_SHARE = 0.5

# Device bytes per nonzero that putting a sparse matrix in column order may
# take beyond the copy itself: a CSR's stable sort holds its column indices,
# the sorted keys, the int64 permutation, the sort's own int64 index input
# and scratch; a CSC sorted within its columns, its int64 keys instead.
_SPARSE_CONVERT_BYTES = 48

# Rows per sampled window that the per-column sums and nonzero counts read
# (a row stride keeps it between this and twice this on taller inputs).
_COLSTAT_ROWS = 1 << 16

# Device stages timed per tile, in stream order (see _StageClock); a cell
# mesh adds "reduce" (the sum of the shards' histograms) after "kernel".
DEVICE_STAGES = ("h2d", "kernel", "contract", "pack", "d2h")


@dataclasses.dataclass
class RunResult:
    # (n_groups, n_genes, 3) float64 results in [p, U, fc] column order.
    stacked: np.ndarray
    # Seconds per stage: host "fetch" (waiting on prefetch), device
    # DEVICE_STAGES (CUDA events; host clock on a CPU device; "h2d" also holds
    # the upload of a sparse matrix put on the device, host clock), host "tail"
    # (consuming the packed buffers: p-values and fold changes), "fallback"
    # (sort-engine recompute) and "precompile" (the warm-up, when run).
    stage_seconds: dict
    n_fallback_cols: int
    # Threads of the native tail (native.tail_threads for this run's route).
    tail_threads: int
    # Tiles of the main loop (per gene shard under a mesh) consumed by the
    # native library and by numpy.
    consume_path: dict = dataclasses.field(default_factory=dict)
    # The device stages of stage_seconds split by the shards' lead devices.
    stage_seconds_by_device: dict = dataclasses.field(default_factory=dict)


def _fits_on_device(device: torch.device, nbytes: int) -> bool:
    """Do ``nbytes`` fit the share of ``device``'s free memory a run may
    take?  Never on a device that reports none (the CPU)."""
    free = device_free_bytes(device)
    return free is not None and nbytes <= _DEVICE_MEM_SHARE * free


def compute_tile_bounds(
    n_genes: int,
    batch_size: int | Literal["auto"],
    n_threads: int,
    auto_width: int = 512,
) -> tuple[list[tuple[int, int]], int]:
    """Contiguous column tiles (same policy as the reference package):
    small inputs collapse to one tile, an integer ``batch_size`` is honored,
    ``"auto"`` minimizes the tile count within ``auto_width`` and rounds the
    width up to a power of two from 128.  ``n_threads`` only sets prefetch
    depth and does not shape the tiles."""
    del n_threads
    if n_genes < 256:
        return [(0, n_genes)], n_genes
    if batch_size == "auto":
        n_tiles = -(-n_genes // auto_width)
        per_tile = -(-n_genes // n_tiles)
        width = 128
        while width < per_tile:
            width *= 2
        width = min(width, auto_width)
    elif isinstance(batch_size, (int, np.integer)):
        width = max(1, min(int(batch_size), n_genes))
    else:
        raise ValueError(
            f"Invalid batch_size value: {batch_size}. Must be 'auto' or an integer."
        )
    bounds = [(lb, min(lb + width, n_genes)) for lb in range(0, n_genes, width)]
    return bounds, width


class _StageClock:
    """Device-stage time accounting for one shard's tiles.

    On CUDA, ``mark`` records an event on the device's current stream (the
    shard's, inside the shard's context) and the time between consecutive
    marks is charged to the later mark's stage, read once at the end (no
    synchronization inside the loop).  On the CPU the work is synchronous
    and the host clock does the same job.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._marks: list[tuple[str, object]] = []

    def mark(self, stage: str | None) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
        else:
            ev = time.perf_counter()
        self._marks.append((stage, ev))

    def finish(self) -> dict:
        """Seconds per device stage; waits for the device first."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        seconds = {s: 0.0 for s in DEVICE_STAGES}
        for (_, a), (stage, b) in zip(self._marks, self._marks[1:]):
            if stage is None:  # a tile boundary: nothing ran between
                continue
            dt = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            seconds[stage] = seconds.get(stage, 0.0) + dt
        self._marks = []
        return seconds


@dataclasses.dataclass
class _ShardRun:
    """One shard's state for one run of the tile loop."""

    shard: Shard
    clock: _StageClock
    # Pinned result buffers by size, and pinned staging slots (host input).
    pool: dict = dataclasses.field(default_factory=dict)
    slots: list = dataclasses.field(default_factory=list)
    n_staged: int = 0

    def next_slot(self) -> dict:
        slot = self.slots[self.n_staged % len(self.slots)]
        self.n_staged += 1
        return slot


class WilcoxonRunner:
    """Configured Wilcoxon test over a dataset on one torch device, or over
    the devices of a mesh (``mesh=``, which then takes the place of
    ``device``; the sort fallback runs on the mesh's first device)."""

    _FALLBACK_WIDTH = 128

    def __init__(
        self,
        handler: DataHandler,
        group_info: GroupInfo,
        *,
        is_log1p: bool,
        device: torch.device | None = None,
        batch_size: int | Literal["auto"] = "auto",
        n_threads: int = 1,
        use_continuity: bool = True,
        tie_correct: bool = True,
        alternative: str = "two-sided",
        engine: Literal["auto", "sort", "hist", "csort"] = "auto",
        mesh=None,
    ):
        self.handler = handler
        self.info = group_info
        self.is_log1p = bool(is_log1p)
        self.use_continuity = use_continuity
        self.tie_correct = tie_correct
        self.alternative = alternative
        self.n_threads = max(1, int(n_threads))
        if mesh is None and device is None:
            raise ValueError("WilcoxonRunner needs a device or a mesh.")
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else torch.device(device)
        self._cell_mesh = mesh is not None and "cells" in mesh.axis_names

        self.n_genes = int(handler.shape[1])
        self.layout = build_padded_layout(group_info.perm, group_info.indptr, BLOCK)
        # float64 inputs stay float64 (sort engine, exact); everything else
        # runs in float32 (integer counts are exact below 2^24).
        in_dtype = np.dtype(handler.dtype)
        self.value_dtype = np.float64 if in_dtype == np.float64 else np.float32
        # Narrow host->device wire: integer counts and float16 ship in their
        # storage dtype and the engines cast to float32 on the device.
        # uint16 is widened on the host (torch's uint16 has few device ops).
        # A matrix already on the device crosses no wire and is cast there.
        if self._device_resident:
            self.wire_dtype = np.dtype(self.value_dtype)
        elif in_dtype == np.uint16:
            self.wire_dtype = np.dtype(np.int32)
        elif (in_dtype.kind in "iu" and in_dtype.itemsize < 4) or in_dtype == np.float16:
            self.wire_dtype = in_dtype
        else:
            self.wire_dtype = np.dtype(self.value_dtype)

        if engine not in ("auto", "sort", "hist", "csort"):
            raise ValueError(
                f"Invalid engine value: {engine!r}. Must be 'auto', 'sort', "
                "'hist' or 'csort'."
            )
        if engine == "csort" and self._device_resident:
            raise ValueError(
                "engine='csort' requires host-resident input (dense numpy, "
                "CSR/CSC, or backed matrices): the compacted tiles are "
                "built by the host tiler. Device-resident tensors use "
                "engine='sort' or 'hist'."
            )
        if engine == "csort" and self._cell_mesh:
            raise ValueError(
                "engine='csort' cannot shard the cell axis (per-group rank "
                "sums do not compose across cell shards); use a 1-D gene "
                "mesh (devices=<int>) or the histogram engine."
            )
        if engine == "hist" and self.value_dtype == np.float64:
            raise ValueError(
                "engine='hist' does not support float64 input: the "
                "histogram value table is float32 and the cast could "
                "silently merge distinct values. Use engine='sort' (the "
                "default for float64) or provide float32/integer counts."
            )
        self._sampled_vmax: float | None = None
        self._sampled_conforms: bool | None = None
        self._sampled_overflow_frac: float | None = None
        self._sampled_density: float | None = None
        self._sampled_colstats: tuple | None = None
        self._sampled_attempted = False
        if engine == "auto":
            engine = self._auto_engine()
        self.engine = engine
        # log1p-flag sanity warning, from the engine-selection sample.
        vmax, conforms = self._sample_value_stats()
        if vmax is not None:
            from illico_tpu_torch.utils.diagnostics import warn_if_log1p_mismatch

            warn_if_log1p_mismatch(
                is_log1p=self.is_log1p,
                max_value=vmax,
                integral=conforms if not self.is_log1p else None,
            )
        self._v_buckets = self._pick_v_buckets() if engine == "hist" else 0
        # After the engine, the sample and the table: they are the host
        # route's, so the frames are too.
        if self._sparse_device_route():
            self.handler = DeviceSparseDataHandler(handler, self.device)
            self.wire_dtype = np.dtype(self.value_dtype)
        n_gene_shards = 1
        if mesh is not None:
            if self._cell_mesh:
                # The cell axis shards through additive per-shard histograms
                # (parallel/cells.py), which the sort engines cannot express.
                if tuple(mesh.axis_names) != ("cells", "genes"):
                    raise ValueError(
                        "2-D meshes must have axes ('cells', 'genes'); got "
                        f"{mesh.axis_names}. Build one with "
                        "illico_tpu_torch.parallel.cells.make_mesh_2d."
                    )
                if engine != "hist":
                    raise ValueError(
                        "Cell-axis sharding requires the histogram engine: "
                        "per-group rank sums do not compose across cell "
                        f"shards in the sort engine, but engine {engine!r} "
                        "was selected (auto-selection routes float64 inputs "
                        "and out-of-bound group sizes there). Use a 1-D "
                        "gene mesh (devices=<int>) for this dataset."
                    )
            n_gene_shards = int(mesh.shape["genes"])
        self.bounds, self.tile_width = compute_tile_bounds(
            self.n_genes, batch_size, self.n_threads,
            auto_width=self._auto_tile_width(),
        )
        if mesh is not None:
            # Every gene shard gets an equal, aligned share of a tile: the
            # histogram kernel works in 32-column blocks, and the packed
            # wire's widest element alignment is 4 columns
            # (ops.hist_engine.packed_width).
            align = n_gene_shards * (32 if engine == "hist" else 4)
            if self.tile_width % align:
                self.tile_width = -(-self.tile_width // align) * align
                self.bounds = [
                    (lb, min(lb + self.tile_width, self.n_genes))
                    for lb in range(0, self.n_genes, self.tile_width)
                ]
        self._shard_width = self.tile_width // n_gene_shards
        if engine == "hist":
            hist_kw = dict(
                ref_code=group_info.ref_code, is_log1p=self.is_log1p,
                v_buckets=self._v_buckets, fc_u8_hint=self._fc_u8_hint(),
                nnz_split_hint=self._nnz_split_hint(),
            )
        if self._cell_mesh:
            from illico_tpu_torch.parallel.cells import (
                build_cell_shard_plans,
                make_cell_sharded_hist_fn,
            )

            plan = build_cell_shard_plans(group_info, int(mesh.shape["cells"]))
            self.tile_fn = make_cell_sharded_hist_fn(self.layout, plan, mesh, **hist_kw)
        elif mesh is not None:
            from illico_tpu_torch.parallel import mesh as pmesh

            if engine == "hist":
                self.tile_fn = pmesh.make_sharded_hist_fn(self.layout, mesh, **hist_kw)
            elif engine == "csort":
                self.tile_fn = pmesh.make_sharded_csort_fn(
                    group_info, mesh, ref_code=group_info.ref_code, is_log1p=self.is_log1p,
                )
            else:
                self.tile_fn = pmesh.make_sharded_tile_fn(
                    self.layout, mesh, ref_code=group_info.ref_code, is_log1p=self.is_log1p,
                )
        elif engine == "hist":
            from illico_tpu_torch.ops.hist_engine import make_hist_tile_fn

            self.tile_fn = make_hist_tile_fn(self.layout, device=self.device, **hist_kw)
        elif engine == "csort":
            from illico_tpu_torch.ops.csort_engine import make_csort_tile_fn

            self.tile_fn = make_csort_tile_fn(
                group_info,
                ref_code=group_info.ref_code,
                is_log1p=self.is_log1p,
                device=self.device,
            )
        else:
            self.tile_fn = make_tile_fn(
                self.layout,
                ref_code=group_info.ref_code,
                is_log1p=self.is_log1p,
                device=self.device,
                pack=True,
            )
        # The gene shards of a tile: the mesh's, or the one device on its
        # current stream.
        self.shards = (
            self.tile_fn.shards if mesh is not None
            else [Shard(self.tile_fn, (self.device,), (None,), {"calls": 0})]
        )
        logger.trace(
            "Engine %s, %s input, tile width %d for %d genes (%d tiles) on %s.",
            self.engine, self.input_route, self.tile_width, self.n_genes, len(self.bounds),
            self.device if mesh is None else f"mesh {mesh.shape} of {set(mesh.devices)}",
        )

    # -- engine choice ---------------------------------------------------------
    def _auto_engine(self) -> str:
        """hist for tabulable count data; otherwise csort when the data is
        sparse enough (exact density from sparse handlers, the sampled one
        from dense and backed-dense handlers), else sort."""
        engine = self._auto_full_engine()
        if engine == "sort" and not self._device_resident and not self._cell_mesh:
            d = self.handler.density()
            if d is None:
                # float64 inputs reach here without a prior sample.
                self._sample_value_stats()
                d = self._sampled_density
            if d is not None and d <= CSORT_MAX_DENSITY:
                logger.trace(
                    "Density %.2f: using the compact (nonzero-only) sort "
                    "engine.", d,
                )
                engine = "csort"
        return engine

    def _auto_full_engine(self) -> str:
        """hist for tabulable count data, sort otherwise."""
        from illico_tpu_torch.ops.hist_engine import HIST_EXACT_MAX_GROUP, MAX_V

        if self.value_dtype == np.float64:
            return "sort"
        counts = self.info.counts
        if counts.size and int(counts.max()) >= HIST_EXACT_MAX_GROUP:
            logger.trace(
                "Largest group (%d cells) exceeds the histogram engine's "
                "exact-count bound; using the sort engine.", int(counts.max()),
            )
            return "sort"
        vmax, conforms = self._sample_value_stats()
        if not conforms:
            logger.trace(
                "Sampled values are not histogram-tabulable (neither integer "
                "counts nor float32 log1p of integer counts); using the sort "
                "engine."
            )
            return "sort"
        if vmax is not None:
            # Columns whose max exceeds the largest table pay the histogram
            # pass AND the sort fallback: route up front when half the
            # sampled columns would.
            counts_max = float(np.expm1(vmax)) if self.is_log1p else vmax
            frac = self._sampled_overflow_frac
            if (frac is not None and frac >= 0.5) or (
                frac is None and counts_max >= 4 * MAX_V
            ):
                logger.trace(
                    "Sampled counts exceed the largest histogram table (%d) "
                    "too often; using the sort engine.", MAX_V,
                )
                return "sort"
        return "hist"

    @property
    def _device_resident(self) -> bool:
        """Tiles are made on the device (no fetch, no staging): a tensor
        there, or a sparse matrix put there by :meth:`run`."""
        return getattr(self.handler, "is_device", False)

    @property
    def input_route(self) -> str:
        """``"device"`` when tiles are made on the device, else ``"host"``."""
        return "device" if self._device_resident else "host"

    def _sparse_device_route(self) -> bool:
        """Put an in-RAM CSR or CSC on the device for the run? Only on one
        device, for the histogram or sort engine (csort compacts on the
        host), for a dtype the device copy holds, and when the copy, with
        the transient memory of its conversion or the workspace of the
        128-column tile floor, whichever is larger, fits
        (:func:`_fits_on_device`).  Otherwise the host route stages the
        matrix tile by tile, out of core."""
        h = self.handler
        if (
            self.mesh is not None
            or self.engine not in ("hist", "sort")
            or type(h) not in (CSRDataHandler, CSCDataHandler)
            or device_sparse_dtype(h.dtype) is None
        ):
            return False
        _, floor = estimate_memory_usage(
            h, self.info, 128, self.n_threads, engine=self.engine,
            v_buckets=self._v_buckets or 128,
            value_itemsize=int(np.dtype(self.value_dtype).itemsize),
        )
        need = h.footprint() + max(_SPARSE_CONVERT_BYTES * int(h.data.nnz), floor)
        return _fits_on_device(self.device, need)

    def _auto_tile_width(self) -> int:
        """Tile width for ``batch_size="auto"``: as wide as the engine cap
        (2048 hist, 1024 csort, whose tiles hold only nonzeros, 512 sort),
        within the host budget for in-flight tiles (host inputs) and, for
        the histogram engine, within a share of the free device memory for
        the (G, V, T) float32 histograms plus the staged tiles (see
        :meth:`_device_tile_cap`)."""
        from illico_tpu_torch.utils.memory import host_tile_budget

        wide_cap = {"hist": 2048, "csort": 1024}.get(self.engine, 512)
        if not self._device_resident:
            in_flight = max(2, self.n_threads) + 2
            itemsize = int(np.dtype(self.wire_dtype).itemsize)
            per_col = in_flight * self.handler.shape[0] * itemsize
            budget = host_tile_budget()
            wide_cap = min(wide_cap, int(budget / max(per_col, 1)))
            if wide_cap < 128:
                logger.warning(
                    "Host tile budget %.0f MB allows only %d columns but the "
                    "engine floor is 128 (in-flight tiles will hold ~%.0f MB); "
                    "raise ILLICO_TPU_HOST_BUDGET or lower n_threads.",
                    budget / 1e6, max(wide_cap, 0), per_col * 128 / 1e6,
                )
        if self.engine == "hist":
            device_cap = self._device_tile_cap()
            if device_cap is not None:
                wide_cap = min(wide_cap, device_cap)
        return max(128, (wide_cap // 128) * 128)

    def _device_tile_cap(self) -> int | None:
        """Widest histogram-engine tile (all gene shards together) whose
        workspace fits a share of each device's free memory; None when no
        device reports its memory (the CPU).

        Per column of a gene shard's share, a device holds one (G, V)
        float32 histogram and its rows of the tile for every shard placed on
        it (logical shards of one card share that card's memory), and the
        lead of a cell-sharded gene column also holds the histograms that
        arrive from the column's other devices until they are summed.  Each
        gene shard a device leads takes the contraction's bounded float64
        workspace besides.
        """
        from illico_tpu_torch.ops.hist_engine import CONTRACT_CHUNK_BYTES

        n_cells = int(self.handler.shape[0])
        # A sparse matrix bound for the device is uploaded by run(), after
        # this: its copy is not yet off the free memory.
        held = (
            self.handler.footprint()
            if isinstance(self.handler, DeviceSparseDataHandler) else 0
        )
        if self.mesh is None:
            columns = [(self.device,)]
        else:
            columns = [self.mesh.column(j) for j in range(int(self.mesh.shape["genes"]))]
        hists: dict = {}
        rows: dict = {}
        led: dict = {}
        for devices in columns:
            lead = devices[0]
            led[lead] = led.get(lead, 0) + 1
            rows_each = -(-n_cells // len(devices))
            for dev in devices:
                hists[dev] = hists.get(dev, 0) + 1
                rows[dev] = rows.get(dev, 0) + rows_each
                if dev != lead:
                    hists[lead] = hists.get(lead, 0) + 1
        hist_col = max(1, self.info.n_groups) * self._v_buckets * 4
        shard_cap = None
        for dev, n_hists in hists.items():
            free = device_free_bytes(dev)
            if free is None:
                continue
            usable = _DEVICE_MEM_SHARE * free - 4 * CONTRACT_CHUNK_BYTES * led.get(dev, 0)
            if dev == self.device:
                usable -= held
            cap = int(usable / (n_hists * hist_col + rows[dev] * 4))
            shard_cap = cap if shard_cap is None else min(shard_cap, cap)
        return None if shard_cap is None else shard_cap * len(columns)

    def _sampled_device_windows(self, starts, w: int):
        """Window statistics of a device-resident matrix with ONE pull for
        all windows: per window the max, the per-column max, sum and nonzero
        count, and the conformity evidence.

        Raw counts: the table is the nonnegative integers and float32
        round/compare are exact, so the FULL window is checked on the
        device and one flag comes back.  log1p data: the table is built
        with numpy's float32 ``log1p``, which the device's may differ from
        by ULPs, so a ~4k-row strided slab comes back and the host probes it
        with the expressions that build the table.
        """
        x = self.handler.data
        parts, slabs = [], []
        for s in starts:
            t = x[:, s : s + w].to(torch.float32)
            parts += [
                t.max().reshape(1).to(torch.float64),
                t.max(dim=0).values.to(torch.float64),
                t.sum(dim=0, dtype=torch.float64),
                (t != 0).sum(dim=0).to(torch.float64),
            ]
            if self.is_log1p:
                slabs.append(t[:: max(1, t.shape[0] // 4096)].reshape(-1))
            else:
                ok = ((t == torch.round(t)) & (t >= 0)).all()
                parts.append(ok.reshape(1).to(torch.float64))
        flat = torch.cat(parts + [v.to(torch.float64) for v in slabs]).cpu().numpy()
        per = 1 + 3 * w + (0 if self.is_log1p else 1)
        head = flat[: per * len(starts)].reshape(len(starts), per)
        vmax = head[:, 0]
        col_max, col_sum, col_nnz = (head[:, 1 + i * w : 1 + (i + 1) * w] for i in range(3))
        evidence = (
            flat[per * len(starts) :].astype(np.float32) if self.is_log1p
            else head[:, -1] != 0
        )
        return vmax, col_max, col_sum, col_nnz, evidence

    def _sample_value_stats(self):
        """(max value, histogram-tabulable) from head/middle/tail samples.

        Memoized; ``(None, True)`` when sampling fails (it is a heuristic:
        exactness never depends on it, because the contraction detects
        untabulated values per column).  Conformity uses the same numpy
        float32 expressions that build the value table, on the host, for
        host and device-resident inputs alike.  Also records the sampled
        nonzero fraction (``_sampled_density``, the csort routing input for
        handlers that cannot report density exactly) and the per-column sums
        and nonzero counts (``_sampled_colstats``, which feed
        :meth:`_fc_u8_hint`).
        """
        if self._sampled_attempted:
            return self._sampled_vmax, self._sampled_conforms

        def _conforms(vals: np.ndarray) -> bool:
            if self.is_log1p:
                # Mislabeled raw counts > ~88 overflow f32 expm1; the inf
                # correctly fails conformity.
                with np.errstate(over="ignore"):
                    rebuilt = np.log1p(np.round(np.expm1(vals)))
            else:
                rebuilt = np.round(vals)
            return bool(np.all((vals == rebuilt) & (vals >= 0)))

        from illico_tpu_torch.ops.hist_engine import MAX_V

        self._sampled_attempted = True
        try:
            n_genes = self.n_genes
            w = max(1, min(24, n_genes))
            starts = sorted({0, max(0, n_genes // 2 - w // 2), max(0, n_genes - w)})
            vmax, conforms = 0.0, True
            col_max: list[float] = []  # per-column maxima
            col_sum: list[float] = []  # per-column value sums (fc-u8 hint)
            col_nnz: list[float] = []  # per-column nonzero counts
            rows_sampled = 0
            if self._device_resident:
                ms, cms, csums, cnnz, evidence = self._sampled_device_windows(starts, w)
                vmax = max(vmax, float(np.max(ms)))
                col_max.extend(cms.ravel().tolist())
                col_sum.extend(csums.ravel().tolist())
                col_nnz.extend(cnnz.ravel().tolist())
                rows_sampled = int(self.handler.shape[0])
                if self.is_log1p:
                    conforms = conforms and _conforms(evidence)
                else:
                    conforms = conforms and bool(np.all(evidence))
            else:
                nz = tot = 0
                for s in starts:
                    arr = np.asarray(self.handler.fetch_tile(s, min(s + w, n_genes)))
                    if not arr.size:
                        continue
                    window_max = arr.max(axis=0)
                    col_max.extend(window_max.astype(np.float64).tolist())
                    # The table size follows the whole window's maximum, as
                    # on the device: the strided sample below aliases onto
                    # the window's first column (every 72nd value of a
                    # 300,000 x 24 window) and would miss the other columns'
                    # counts (the reference package samples so).
                    vmax = max(vmax, float(window_max.max()))
                    # Sums and nonzero counts feed rate estimates only: on
                    # tall inputs every few rows do (all rows below 2**17).
                    sub = arr[:: max(1, arr.shape[0] // _COLSTAT_ROWS)]
                    col_sum.extend(sub.sum(axis=0, dtype=np.float64).tolist())
                    col_nnz.extend(
                        np.count_nonzero(sub, axis=0).astype(np.float64).tolist()
                    )
                    rows_sampled = int(sub.shape[0])
                    step = max(1, arr.size // 100_000)
                    vals = arr.ravel()[::step].astype(np.float32)
                    conforms = conforms and _conforms(vals)
                    nz += int(np.count_nonzero(vals))
                    tot += vals.size
                if tot:
                    self._sampled_density = nz / tot
            if col_max:
                cm = np.asarray(col_max, np.float64)
                if self.is_log1p:
                    with np.errstate(over="ignore"):
                        cm = np.expm1(cm.astype(np.float32)).astype(np.float64)
                self._sampled_overflow_frac = float(np.mean(cm >= MAX_V - 1))
            if col_sum and rows_sampled:
                self._sampled_colstats = (
                    np.asarray(col_sum, np.float64),
                    np.asarray(col_nnz, np.float64),
                    rows_sampled,
                )
        except Exception:  # sampling must never break the run
            logger.warning("Value sampling failed; assuming tabulable data.")
            self._sampled_vmax, self._sampled_conforms = None, True
            return None, True
        self._sampled_vmax, self._sampled_conforms = vmax, conforms
        return vmax, conforms

    def _fc_u8_hint(self) -> bool:
        """Should the fc-residual uint8 tier engage? (hist nnz-split only.)

        fc_res[g, j] = sum of (value - 1) over group g's nonzeros in column
        j ~ k * (mean_nonzero - 1).  Estimated per sampled column from
        (nonzero fraction) * (largest non-reference group) * (mean nonzero
        value); if more than ~5% of columns look at risk of exceeding uint8,
        the 2-byte tier stays.  A wrong True only costs sort-engine fallback
        columns (exceptions and overflow flags keep exactness).  Raw counts
        only: log1p sampling sees log-space sums.
        """
        if (
            self.is_log1p
            or not self._sampled_conforms
            or self._sampled_colstats is None
            or self.info.ref_code < 0
        ):
            return False
        col_sum, col_nnz, rows = self._sampled_colstats
        counts = np.asarray(self.info.counts, np.float64)
        others = np.delete(counts, self.info.ref_code)
        if not others.size:
            return False
        m_max = float(others.max())
        mean_nz = col_sum / np.maximum(col_nnz, 1.0)
        est = (mean_nz - 1.0) * (col_nnz / rows) * m_max
        unsafe = 1.6 * est + 48.0 > 255.0
        return bool(np.mean(unsafe) < 0.05)

    def _nnz_split_hint(self) -> bool:
        """May the nnz-split OVO wire engage, as far as the sample can tell?

        Its ``u2_res`` array holds U2_nz[g, j], about (reference nonzeros in
        column j) per nonzero of group g, in a uint16; entries beyond it
        take one of 24 exception slots per column, and a column with more
        goes to the sort fallback whole.  With a large control group and
        moderately dense counts most columns would: this estimates U2_nz
        for a 3-sigma nonzero count of the largest non-reference group, per
        sampled column, and keeps the wire off when over 5% of the columns
        exceed uint16.  Like :meth:`_fc_u8_hint`, a wrong answer costs
        bytes or fallback columns, never exactness.  (The reference package
        always engages the wire when the group sizes allow.)
        """
        if self._sampled_colstats is None or self.info.ref_code < 0:
            return True
        _, col_nnz, rows = self._sampled_colstats
        counts = np.asarray(self.info.counts, np.float64)
        others = np.delete(counts, self.info.ref_code)
        if not others.size:
            return True
        density = col_nnz / rows
        ref_nnz = density * counts[self.info.ref_code]
        k_mean = density * float(others.max())
        k_high = k_mean + 3.0 * np.sqrt(k_mean) + 1.0
        return bool(np.mean(ref_nnz * k_high > 65535.0) < 0.05)

    def _pick_v_buckets(self) -> int:
        """Size the value table (128/256/512) from the sampled max count."""
        from illico_tpu_torch.ops.hist_engine import DEFAULT_V

        vmax, _ = self._sample_value_stats()
        if vmax is None:
            return DEFAULT_V
        counts_max = float(np.expm1(vmax)) if self.is_log1p else vmax
        if not np.isfinite(counts_max) or counts_max < DEFAULT_V - 1:
            return DEFAULT_V
        for v in (256, 512):
            if counts_max < v - 1:
                return v
        logger.trace(
            "Sampled max count %.0f exceeds the largest table; columns with "
            "counts >= 511 will take the exact sort fallback.", counts_max,
        )
        return 512

    # -- warm-up ------------------------------------------------------------------
    def precompile(self) -> float:
        """Pay the one-time costs before the tile loop: build and load the
        native tail (C++ compiler) and, on CUDA, the histogram and
        contraction kernels (nvcc; the hist tile function launches both),
        then run the tile function once per distinct device on a
        zero tile of a shard's shape, so the loop meets a loaded library,
        initialized device modules and a warm allocator.  (The sort engine's
        zero tile is 8 columns wide.)  Returns the seconds it took."""
        from illico_tpu_torch.native import native_available

        t0 = time.perf_counter()
        native_available()
        if self.engine == "csort":
            from illico_tpu_torch.ops.csort_engine import _SEG_BLOCK

            g, t = self.info.n_groups, self._shard_width
            tile = CompactTile(
                np.full((_SEG_BLOCK, t), np.inf, self.value_dtype),
                None if self.info.is_ovr else np.full((_SEG_BLOCK, t), g, np.uint16),
                np.zeros((g + 1, t), np.int32),
                t,
            )
            warm_shards(self.shards, lambda shard: tile)
        else:
            # The sort engine builds nothing lazily and a tile of it costs
            # as much as a tile of the run: a narrow one warms it up.
            width = self._shard_width if self.engine == "hist" else min(self._shard_width, 8)
            dtype = torch.from_numpy(np.empty(0, self.wire_dtype)).dtype
            n_cells = int(self.handler.shape[0])
            warm_shards(self.shards, lambda shard: shard.zeros(n_cells, width, dtype))
        seconds = time.perf_counter() - t0
        logger.trace(
            "Warm-up of the %s tile function (%d, %d): %.2fs.",
            self.engine, self.handler.shape[0], self._shard_width, seconds,
        )
        self._precompile_seconds = seconds
        return seconds

    # -- tile plumbing ----------------------------------------------------------
    def _host_tile(self, tile: np.ndarray, width: int | None = None) -> np.ndarray:
        """Contiguous tile in the wire dtype, zero-padded to ``width``
        columns when given."""
        if width is not None and tile.shape[1] < width:
            buf = np.zeros((tile.shape[0], width), self.wire_dtype)
            buf[:, : tile.shape[1]] = tile
            return buf
        if tile.dtype != self.wire_dtype:
            tile = tile.astype(self.wire_dtype)
        return np.ascontiguousarray(tile)

    def _device_tile(self, tile: torch.Tensor, width: int) -> torch.Tensor:
        """Contiguous tile of a device-resident matrix in the value dtype,
        a short one zero-padded to ``width`` columns."""
        dtype = torch.float64 if self.value_dtype == np.float64 else torch.float32
        tile = tile.to(dtype)
        if tile.shape[1] < width:
            return torch.nn.functional.pad(tile, (0, width - tile.shape[1]))
        return tile.contiguous()

    def _work_items(self) -> list[tuple[int, int, int]]:
        """The (tile, shard) pairs of the run as ``(lb, ub, j)``: gene shard
        ``j`` of a tile takes its ``j``-th share of ``_shard_width``
        columns; shares past the end of a short last tile do not exist.
        Consecutive items go to different shards."""
        items = []
        for lb, ub in self.bounds:
            for j in range(len(self.shards)):
                s_lb = lb + j * self._shard_width
                if s_lb < ub:
                    items.append((s_lb, min(s_lb + self._shard_width, ub), j))
        return items

    def _fetch(self, lb: int, ub: int):
        """Columns [lb, ub) of one shard's tile.  Host inputs: runs on a
        prefetch thread.  csort: the compacted tile, nonzeros only; a short
        final tile is padded with empty columns to the shard's width.  A
        device-resident matrix gives its column slice where it lives
        (:meth:`_place_device_tile` makes the shard's tile of it)."""
        if self._device_resident:
            return self.handler.fetch_tile(lb, ub)
        if self.engine == "csort":
            from illico_tpu_torch.ops.csort_engine import compact_from_entries

            v, r, c = self.handler.fetch_tile_entries(lb, ub)
            return compact_from_entries(
                v, r, c, self._shard_width, self.info.encoded_groups,
                self.info.n_groups, value_dtype=self.value_dtype,
                need_grp=not self.info.is_ovr,
            )
        return self._host_tile(self.handler.fetch_tile(lb, ub))

    def _place_device_tile(self, cols: torch.Tensor, shard: Shard, width: int):
        """The shard's input from a column slice of a device-resident
        matrix: cast, padded to ``width`` and made contiguous where the
        matrix lives, on the shard's stream when that is the same card,
        then copied when the shard's device is another one (the copy orders
        itself between the two devices' current streams).  A cell-sharded
        shard gets one row block per device."""
        if shard.row_bounds is None:
            with shard.on():
                return self._device_tile(cols, width).to(shard.device, non_blocking=True)
        blocks = []
        for (lo, hi), dev, stream in zip(shard.row_bounds, shard.devices, shard.streams):
            with on_device(dev, stream):
                blocks.append(self._device_tile(cols[lo:hi], width).to(dev, non_blocking=True))
        return blocks

    @staticmethod
    def _stage(arrays: list[np.ndarray], slot: dict, devices, streams) -> list[torch.Tensor]:
        """Host arrays -> device tensors, ``arrays[i]`` to ``devices[i]`` on
        ``streams[i]``.  On CUDA each array goes through a pinned staging
        buffer of ``slot`` and a non-blocking copy; the slot's event for
        that array marks when its buffer may be refilled.  A buffer grows
        to the largest array it has held and is then reused, so tiles whose
        compacted height varies do not reallocate pinned memory every
        time."""
        staged = []
        for i, (a, dev, stream) in enumerate(zip(arrays, devices, streams)):
            if dev.type != "cuda":
                staged.append(torch.from_numpy(a).to(dev))
                continue
            event = slot["events"].get(i)
            if event is not None:
                event.synchronize()
            dtype = torch.from_numpy(a[:0]).dtype
            buf = slot["bufs"].get((i, dtype))
            if buf is None or buf.numel() < a.size:
                slot["bufs"][(i, dtype)] = buf = torch.empty(a.size, dtype=dtype, pin_memory=True)
            host = buf[: a.size].view(a.shape)
            host.numpy()[...] = a
            with on_device(dev, stream):
                staged.append(host.to(dev, non_blocking=True))
                if event is None:
                    event = slot["events"][i] = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
        return staged

    @staticmethod
    def _new_slots(n: int) -> list[dict]:
        return [{"bufs": {}, "events": {}} for _ in range(n)]

    def _stage_tile(self, tile, slot: dict, shard: Shard):
        """Stage a shard's tile: a dense tile (under a cell mesh its row
        blocks, each to its own device), or the arrays of a
        :class:`CompactTile` (``grp`` as its int16 view: torch's uint16 has
        few device ops)."""
        if isinstance(tile, CompactTile):
            arrays = [tile.vals, tile.indptr]
            if tile.grp is not None:
                arrays.append(tile.grp.view(np.int16))
            n = len(arrays)
            staged = self._stage(arrays, slot, shard.devices[:1] * n, shard.streams[:1] * n)
            grp = staged[2] if tile.grp is not None else None
            return CompactTile(staged[0], grp, staged[1], tile.t_cols)
        if shard.row_bounds is None:
            return self._stage([tile], slot, shard.devices, shard.streams)[0]
        blocks = [tile[lo:hi] for lo, hi in shard.row_bounds]
        return self._stage(blocks, slot, shard.devices, shard.streams)

    @staticmethod
    def _pull_async(buf: torch.Tensor, pool: dict):
        """Start the copy of a packed device buffer to the host on the
        current stream of its device; returns ``(host tensor, done
        event)``.  On CUDA the target is a pinned buffer from ``pool``
        (size -> free buffers), which the caller gives back with
        :meth:`_release` after consuming it."""
        if buf.device.type != "cuda":
            return buf, None
        free = pool.setdefault(buf.numel(), [])
        host = free.pop() if free else torch.empty(buf.numel(), dtype=torch.uint8, pin_memory=True)
        with torch.cuda.device(buf.device):
            host.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(buf.device))
        return host, done

    @staticmethod
    def _release(host: torch.Tensor, pool: dict) -> None:
        if host.is_pinned():
            pool.setdefault(host.numel(), []).append(host)

    # -- overflow fallback -------------------------------------------------------
    def _recompute_with_sort_engine(self, cols: np.ndarray, consume_stats) -> None:
        """Exact recomputation of selected columns via the sort engine on
        ``self.device`` (under a mesh its first device), in chunks of
        ``_FALLBACK_WIDTH`` columns, pipelined like the main loop: prefetch
        threads gather the chunks (a short last one padded to the chunk
        width), dispatches run ahead of the pulls within a bounded window,
        and each chunk's packed statistics come back through one
        non-blocking copy."""
        sort_fn = make_tile_fn(
            self.layout, ref_code=self.info.ref_code, is_log1p=self.is_log1p,
            device=self.device, pack=True,
        )
        fw = self._FALLBACK_WIDTH
        chunks = [cols[s : s + fw] for s in range(0, cols.size, fw)]
        shard = Shard(sort_fn, (self.device,), (None,), {"calls": 0})

        def fetch(chunk):
            tile = self.handler.fetch_columns(chunk)
            if self._device_resident:
                return tile
            return self._host_tile(np.asarray(tile), fw)

        n_prefetch = max(2, self.n_threads)
        depth = max(2, self.n_threads)
        slots = self._new_slots(n_prefetch + 1)
        pool: dict = {}
        pending: deque = deque()  # (chunk, host buffer, done event)

        def pull_one():
            chunk, host, done = pending.popleft()
            if done is not None:
                done.synchronize()
            consume_stats(chunk, sort_fn.unpack(host.numpy()))
            self._release(host, pool)

        with ThreadPoolExecutor(max_workers=n_prefetch) as workers:
            ahead = min(n_prefetch, len(chunks))
            futures = {i: workers.submit(fetch, chunks[i]) for i in range(ahead)}
            for i, chunk in enumerate(chunks):
                tile = futures.pop(i).result()
                if i + ahead < len(chunks):
                    futures[i + ahead] = workers.submit(fetch, chunks[i + ahead])
                if self._device_resident:
                    tile = self._place_device_tile(tile, shard, fw)
                else:
                    tile = self._stage_tile(tile, slots[i % len(slots)], shard)
                with shard.on():
                    host, done = self._pull_async(sort_fn(tile), pool)
                del tile
                pending.append((chunk, host, done))
                if len(pending) > depth:
                    pull_one()
            while pending:
                pull_one()

    # -- main loop -----------------------------------------------------------------
    def run(self, progress: bool = True, profile_dir: str | None = None) -> RunResult:
        """Execute the tile loop.  ``profile_dir`` wraps the run in
        ``torch.profiler.profile`` (CPU activity, and CUDA activity on a
        CUDA device) and writes a Chrome trace, ``trace.json``, there."""
        if profile_dir is None:
            return self._run(progress)
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            res = self._run(progress)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        return res

    def _run(self, progress: bool) -> RunResult:
        """The tile loop, between the upload of a sparse matrix bound for
        the device (timed by the host clock up to a sync, charged to
        ``h2d``) and the release of its copy, on success or error."""
        if not isinstance(self.handler, DeviceSparseDataHandler):
            return self._run_tiles(progress)
        t0 = time.perf_counter()
        try:
            self.handler.load()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            upload = time.perf_counter() - t0
            res = self._run_tiles(progress)
        finally:
            self.handler.release()
        res.stage_seconds["h2d"] += upload
        by_device = res.stage_seconds_by_device.setdefault(str(self.device), {})
        by_device["h2d"] = by_device.get("h2d", 0.0) + upload
        return res

    def _run_tiles(self, progress: bool) -> RunResult:
        info = self.info
        G, n_genes = info.n_groups, self.n_genes
        n_tests = G * n_genes
        logger.trace("Performing a total of %d tests.", n_tests)
        log_memory_usage(
            self.handler, info, self.tile_width, self.n_threads,
            engine=self.engine,
            v_buckets=self._v_buckets or 128,
            value_itemsize=int(np.dtype(self.value_dtype).itemsize),
        )
        is_ovr = info.is_ovr
        results = np.empty((G, n_genes, 3), np.float64)
        pvals, U, fc = results[..., 0], results[..., 1], results[..., 2]
        tie = np.empty((G, n_genes), np.float64)

        pbar = None
        if progress:
            try:
                from tqdm.auto import tqdm

                pbar = tqdm(total=n_tests, smoothing=0.0, unit="it",
                            unit_scale=True, unit_divisor=1000)
            except ImportError:
                pass

        overflow_cols: list[int] = []
        counts = info.counts.astype(np.float64)
        n_total = float(info.n_cells)
        if is_ovr:
            nr, nt = n_total - counts[:, None], counts[:, None]
        else:
            nr, nt = np.full((G, 1), counts[info.ref_code]), counts[:, None]
        # Groups whose fc-sum / R2 rows travel as separate per-column arrays
        # (histogram engine only; -1 elsewhere).
        statics = getattr(self.tile_fn, "_statics", {})
        fc_split = int(statics.get("fc_split_code", -1))
        u2_split = int(statics.get("u2_split_code", -1))
        from illico_tpu_torch.native import consume_tile_native, tail_threads

        n_workers = max(2, self.n_threads)  # prefetch threads
        # The tail's threads: the host's cores, less the prefetch threads
        # that run beside it on host input.
        n_tail = tail_threads(busy=0 if self._device_resident else n_workers)

        def consume_stats(cols, out):
            """Scatter one unpacked host dict (numpy) into the result arrays
            at the given global column indices."""
            w = len(cols)
            ov = out.get("overflow_cols")
            if ov is not None:
                bad = np.flatnonzero(np.asarray(ov)[:w])
                if bad.size:
                    overflow_cols.extend(np.asarray(cols)[bad].tolist())
            if is_ovr:
                r2 = np.asarray(out["R2"], dtype=np.float64)[:, :w]
                r2_split = out.get("r2_split_col")
                if r2_split is not None and u2_split >= 0:
                    # In place is safe: the dict is private to this tile.
                    r2[u2_split] = np.asarray(r2_split, np.float64)[:w]
                U[:, cols] = nr * nt + nt * (nt + 1.0) / 2.0 - r2 / 2.0
                tie[:, cols] = np.broadcast_to(np.asarray(out["tie_col"])[None, :w], (G, w))
            else:
                u_tgt = np.asarray(out["U2"], dtype=np.float64)[:, :w] / 2.0
                U[:, cols] = nr * nt - u_tgt
                tie[:, cols] = (
                    np.asarray(out["tie_ref_col"])[None, :w]
                    + np.asarray(out["tie_seg"], dtype=np.float64)[:, :w]
                )
            # A NaN expression sum reads as 0.0, as in the reference, whose
            # wire carries fc sums as an integer mantissa and exponent and
            # converts a NaN mantissa to 0; so does this package's wire, and
            # this line says the same for a dict that never crossed it.
            fc_sums = np.asarray(out["fc_sums"], dtype=np.float64)[:, :w]
            fc_sums = np.where(np.isnan(fc_sums), 0.0, fc_sums)
            split_col = out.get("fc_split_col")
            if split_col is not None and fc_split >= 0:
                fc_sums[fc_split] = np.asarray(split_col, np.float64)[:w]
            fc[:, cols] = fold_change_from_summed_expr(fc_sums, info.counts, info.ref_code)
            pvals[:, cols] = pvalues_from_stats(
                U[:, cols], tie[:, cols], nr, nt,
                use_continuity=self.use_continuity,
                tie_correct=self.tie_correct,
                alternative=self.alternative,
                n_threads=n_tail,
            )

        consume_path = {"native": 0, "numpy": 0}

        def consume(lb, ub, buf: np.ndarray, tile_fn):
            """One shard's packed host buffer -> its columns of ``results``:
            the fused native pass (decode, statistics, p and fc in one C
            loop straight into the result buffer) when the library is
            there, numpy otherwise."""
            w_cols = ub - lb
            spec = tile_fn.find_spec(buf.size)
            if spec is not None and "overflow_cols" in spec:
                _, _, off, nbytes = spec["overflow_cols"]
                bad = np.flatnonzero(buf[off : off + nbytes][:w_cols])
                if consume_tile_native(
                    buf, spec, counts, int(info.ref_code), w_cols,
                    self.alternative, self.use_continuity, self.tie_correct,
                    results, lb, fc_split_code=fc_split, u2_split_code=u2_split,
                    n_threads=n_tail,
                ):
                    if bad.size:
                        overflow_cols.extend((lb + bad).tolist())
                    consume_path["native"] += 1
                    return
            consume_path["numpy"] += 1
            consume_stats(np.arange(lb, ub), tile_fn.unpack(buf))

        host_seconds = {
            "precompile": getattr(self, "_precompile_seconds", 0.0),
            "fetch": 0.0, "tail": 0.0, "fallback": 0.0,
        }
        self._precompile_seconds = 0.0
        runs = [_ShardRun(shard, _StageClock(shard.device)) for shard in self.shards]
        for shard in self.shards:
            shard.wait_for_current_streams()

        def dispatch(x, run: _ShardRun):
            """A shard's tile on its device(s) -> (host buffer, done
            event), stages marked on the shard's stream."""
            with run.shard.on():
                buf = run.shard(x, run.clock.mark)
                run.clock.mark("pack")
                pulled = self._pull_async(buf, run.pool)
                run.clock.mark("d2h")
            return pulled

        def pull(lb, ub, run: _ShardRun, host, done):
            if done is not None:
                done.synchronize()
            t0 = time.perf_counter()
            consume(lb, ub, host.numpy(), run.shard.fn)
            host_seconds["tail"] += time.perf_counter() - t0
            self._release(host, run.pool)
            if pbar is not None:
                pbar.update(G * (ub - lb))

        items = [(lb, ub, runs[j]) for lb, ub, j in self._work_items()]
        t_loop0 = time.perf_counter()
        if self._device_resident:
            # The input is on a device: dispatch one tile (all its shards)
            # ahead of the pulls, so the host consumes tile i while the
            # devices work on tile i+1.  Dispatching every tile first
            # overlaps nothing: a hist tile queues over a thousand small
            # launches, the launch queue fills, and the host waits in it
            # until the devices have nearly drained.
            pending = deque()  # (lb, ub, shard run, host buffer, done event)
            for lb, ub, run in items:
                with run.shard.on():
                    run.clock.mark(None)
                x = self._place_device_tile(self._fetch(lb, ub), run.shard, self._shard_width)
                pending.append((lb, ub, run, *dispatch(x, run)))
                del x
                if len(pending) > len(runs):
                    pull(*pending.popleft())
            while pending:
                pull(*pending.popleft())
        else:
            # Fetches in flight and dispatches ahead of the pulls, in shard
            # tiles: as many full tiles' worth as on one device.
            ahead = min(n_workers * len(runs), len(items))
            depth = n_workers * len(runs)
            for run in runs:
                # One pinned staging slot per tile of the shard that can be
                # in flight between its fetch and its device copy.
                run.slots = self._new_slots(n_workers + 1)
            pending = deque()  # (lb, ub, shard run, host buffer, done event)
            # Each prefetch thread's CSR scans run on one thread: n_workers
            # of them run side by side.
            with ThreadPoolExecutor(max_workers=n_workers,
                                    initializer=native.single_scan_thread) as workers:
                futures = {i: workers.submit(self._fetch, *items[i][:2]) for i in range(ahead)}
                for i, (lb, ub, run) in enumerate(items):
                    t0 = time.perf_counter()
                    tile = futures.pop(i).result()
                    host_seconds["fetch"] += time.perf_counter() - t0
                    if i + ahead < len(items):
                        futures[i + ahead] = workers.submit(self._fetch, *items[i + ahead][:2])
                    with run.shard.on():
                        run.clock.mark(None)
                    x = self._stage_tile(tile, run.next_slot(), run.shard)
                    with run.shard.on():
                        run.clock.mark("h2d")
                    pending.append((lb, ub, run, *dispatch(x, run)))
                    del x, tile
                    if len(pending) > depth:
                        pull(*pending.popleft())
                while pending:
                    pull(*pending.popleft())
        by_device: dict = {}
        for run in runs:
            split = by_device.setdefault(str(run.shard.device), {})
            for stage, dt in run.clock.finish().items():
                split[stage] = split.get(stage, 0.0) + dt
        device_seconds: dict = {s: 0.0 for s in DEVICE_STAGES}
        for split in by_device.values():
            for stage, dt in split.items():
                device_seconds[stage] = device_seconds.get(stage, 0.0) + dt
        stage_seconds = {
            "precompile": host_seconds["precompile"], "fetch": host_seconds["fetch"],
            **device_seconds, "tail": host_seconds["tail"], "fallback": 0.0,
        }
        if pbar is not None:
            pbar.close()
        logger.trace(
            "Tile loop: %.2fs over %d tiles in %d shard tiles (consume path: "
            "%d native, %d numpy); stages %s.",
            time.perf_counter() - t_loop0, len(self.bounds), len(items),
            consume_path["native"], consume_path["numpy"], stage_seconds,
        )

        # -- exact sort-engine fallback for histogram-overflow columns -------
        n_fallback = 0
        if overflow_cols:
            cols = np.unique(np.asarray(overflow_cols, dtype=np.int64))
            n_fallback = int(cols.size)
            logger.trace(
                "Recomputing %d columns with the sort engine (histogram "
                "overflow: counts >= table size or non-tabulated values).",
                cols.size,
            )
            t0 = time.perf_counter()
            self._recompute_with_sort_engine(cols, consume_stats)
            stage_seconds["fallback"] = time.perf_counter() - t0

        # -- OVO reference-row sentinels --------------------------------------
        if not is_ovr:
            pvals[info.ref_code, :] = REF_SENTINEL_P
            U[info.ref_code, :] = REF_SENTINEL_U
            fc[info.ref_code, :] = 1.0
        return RunResult(
            stacked=results, stage_seconds=stage_seconds,
            n_fallback_cols=n_fallback, consume_path=consume_path,
            stage_seconds_by_device=by_device, tail_threads=n_tail,
        )
