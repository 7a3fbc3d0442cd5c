"""Orchestration of the asymptotic Wilcoxon test over gene tiles.

Port of ``illico_tpu.models.wilcoxon`` (single device, host-resident
inputs).  Gene columns are processed in contiguous tiles: prefetch threads
densify the next tiles while the device works on the current one; each tile
is staged through a pinned host buffer, copied to the device without
blocking, reduced to per-(group, gene) statistics by the histogram, sort
or compact sort engine, copied back, and turned into p-values and fold
changes on the host.  Columns the histogram's value table cannot hold are
recomputed exactly by the sort engine.  Compact-sort tiles (nonzeros only)
are built by the prefetch threads and staged as three arrays.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Literal

import numpy as np
import torch

from illico_tpu_torch.ops.csort_engine import CompactTile
from illico_tpu_torch.ops.rank_engine import BLOCK, build_padded_layout, make_tile_fn
from illico_tpu_torch.stats import fold_change_from_summed_expr, pvalues_from_stats
from illico_tpu_torch.utils.groups import GroupInfo
from illico_tpu_torch.utils.log import logger
from illico_tpu_torch.utils.memory import device_free_bytes, log_memory_usage
from illico_tpu_torch.utils.registry import DataHandler

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

# Device stages timed per tile, in stream order (see _StageClock).
DEVICE_STAGES = ("h2d", "kernel", "contract", "d2h")


@dataclasses.dataclass
class RunResult:
    # (n_groups, n_genes, 3) float64 results in [p, U, fc] column order.
    stacked: np.ndarray
    # Seconds per stage: host "fetch" (waiting on prefetch), device
    # DEVICE_STAGES (CUDA events; host clock on a CPU device), host "tail"
    # (p-values and fold changes) and "fallback" (sort-engine recompute).
    stage_seconds: dict
    n_fallback_cols: int


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
    """Per-stage time accounting for the tile loop.

    On CUDA, ``mark`` records an event on the current stream and the time
    between consecutive marks is charged to the later mark's stage, read
    once at the end (no synchronization inside the loop).  On the CPU the
    work is synchronous and the host clock does the same job.
    """

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.seconds = {s: 0.0 for s in ("fetch", *DEVICE_STAGES, "tail", "fallback")}
        self._marks: list[tuple[str, object]] = []

    def mark(self, stage: str | None) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self._marks.append((stage, ev))

    def add(self, stage: str, seconds: float) -> None:
        self.seconds[stage] += seconds

    def finish(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        for (_, a), (stage, b) in zip(self._marks, self._marks[1:]):
            if stage is None:  # a tile boundary: nothing ran between
                continue
            dt = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            self.seconds[stage] += dt
        self._marks = []
        return dict(self.seconds)


class WilcoxonRunner:
    """Configured Wilcoxon test over a dataset on one torch device."""

    _FALLBACK_WIDTH = 128

    def __init__(
        self,
        handler: DataHandler,
        group_info: GroupInfo,
        *,
        is_log1p: bool,
        device: torch.device,
        batch_size: int | Literal["auto"] = "auto",
        n_threads: int = 1,
        use_continuity: bool = True,
        tie_correct: bool = True,
        alternative: str = "two-sided",
        engine: Literal["auto", "sort", "hist", "csort"] = "auto",
    ):
        self.handler = handler
        self.info = group_info
        self.is_log1p = bool(is_log1p)
        self.use_continuity = use_continuity
        self.tie_correct = tie_correct
        self.alternative = alternative
        self.n_threads = max(1, int(n_threads))
        self.device = torch.device(device)

        self.n_genes = int(handler.shape[1])
        self.layout = build_padded_layout(group_info.perm, group_info.indptr, BLOCK)
        # float64 inputs stay float64 (sort engine, exact); everything else
        # runs in float32 (integer counts are exact below 2^24).
        in_dtype = np.dtype(handler.dtype)
        self.value_dtype = np.float64 if in_dtype == np.float64 else np.float32
        # Narrow host->device wire: integer counts and float16 ship in their
        # storage dtype and the engines cast to float32 on the device.
        # uint16 is widened on the host (torch's uint16 has few device ops).
        if in_dtype == np.uint16:
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
        self.bounds, self.tile_width = compute_tile_bounds(
            self.n_genes, batch_size, self.n_threads,
            auto_width=self._auto_tile_width(),
        )
        if engine == "hist":
            from illico_tpu_torch.ops.hist_engine import make_hist_tile_fn

            self.tile_fn = make_hist_tile_fn(
                self.layout,
                ref_code=group_info.ref_code,
                is_log1p=self.is_log1p,
                v_buckets=self._v_buckets,
                device=self.device,
            )
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
            )
        logger.trace(
            "Engine %s, tile width %d for %d genes (%d tiles) on %s.",
            self.engine, self.tile_width, self.n_genes, len(self.bounds),
            self.device,
        )

    # -- engine choice ---------------------------------------------------------
    def _auto_engine(self) -> str:
        """hist for tabulable count data; otherwise csort when the data is
        sparse enough (exact density from sparse handlers, the sampled one
        from dense and backed-dense handlers), else sort."""
        engine = self._auto_full_engine()
        if engine == "sort":
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

    def _auto_tile_width(self) -> int:
        """Tile width for ``batch_size="auto"``: as wide as the engine cap
        (2048 hist, 1024 csort, whose tiles hold only nonzeros, 512 sort),
        within the host budget for in-flight tiles and, for the histogram
        engine, within a share of the free device memory for the (G, V, T)
        float32 histogram plus the staged tile."""
        from illico_tpu_torch.utils.memory import host_tile_budget

        wide_cap = {"hist": 2048, "csort": 1024}.get(self.engine, 512)
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
        free = device_free_bytes(self.device)
        if self.engine == "hist" and free is not None:
            from illico_tpu_torch.ops.hist_engine import CONTRACT_CHUNK_BYTES

            per_dev_col = (
                max(1, self.info.n_groups) * self._v_buckets * 4
                + self.handler.shape[0] * 4
            )
            usable = _DEVICE_MEM_SHARE * free - 4 * CONTRACT_CHUNK_BYTES
            wide_cap = min(wide_cap, int(usable / per_dev_col))
        return max(128, (wide_cap // 128) * 128)

    def _sample_value_stats(self):
        """(max value, histogram-tabulable) from head/middle/tail samples.

        Memoized; ``(None, True)`` when sampling fails (it is a heuristic:
        exactness never depends on it, because the contraction detects
        untabulated values per column).  Conformity uses the same numpy
        float32 expressions that build the value table.  Also records the
        sampled nonzero fraction (``_sampled_density``, the csort routing
        input for handlers that cannot report density exactly).
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
            nz = tot = 0
            col_max: list[float] = []
            for s in starts:
                arr = np.asarray(self.handler.fetch_tile(s, min(s + w, n_genes)))
                if not arr.size:
                    continue
                col_max.extend(arr.max(axis=0).astype(np.float64).tolist())
                step = max(1, arr.size // 100_000)
                vals = arr.ravel()[::step].astype(np.float32)
                conforms = conforms and _conforms(vals)
                vmax = max(vmax, float(vals.max()))
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
        except Exception:  # sampling must never break the run
            logger.warning("Value sampling failed; assuming tabulable data.")
            self._sampled_vmax, self._sampled_conforms = None, True
            return None, True
        self._sampled_vmax, self._sampled_conforms = vmax, conforms
        return vmax, conforms

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

    # -- tile plumbing ----------------------------------------------------------
    def _host_tile(self, tile: np.ndarray) -> np.ndarray:
        if tile.dtype != self.wire_dtype:
            tile = tile.astype(self.wire_dtype)
        return np.ascontiguousarray(tile)

    def _fetch(self, lb: int, ub: int):
        """Host tile of columns [lb, ub) (runs on a prefetch thread).

        csort: the compacted tile, nonzeros only; a short final tile is
        padded with empty columns to ``tile_width``."""
        if self.engine == "csort":
            from illico_tpu_torch.ops.csort_engine import compact_from_entries

            v, r, c = self.handler.fetch_tile_entries(lb, ub)
            return compact_from_entries(
                v, r, c, self.tile_width, self.info.encoded_groups,
                self.info.n_groups, value_dtype=self.value_dtype,
                need_grp=not self.info.is_ovr,
            )
        return self._host_tile(self.handler.fetch_tile(lb, ub))

    def _stage(self, arrays: list[np.ndarray], slot) -> list[torch.Tensor]:
        """Host arrays -> device tensors.  On CUDA each array goes through
        a pinned staging buffer of ``slot`` and a non-blocking copy; the
        slot's event marks when its buffers may be refilled.  A buffer
        grows to the largest array it has held and is then reused, so
        tiles whose compacted height varies do not reallocate pinned
        memory every time."""
        if self.device.type != "cuda":
            return [torch.from_numpy(a).to(self.device) for a in arrays]
        slot["event"].synchronize()
        bufs = slot["bufs"]
        staged = []
        for i, a in enumerate(arrays):
            dtype = torch.from_numpy(a[:0]).dtype
            buf = bufs.get(i)
            if buf is None or buf.numel() < a.size:
                bufs[i] = buf = torch.empty(a.size, dtype=dtype, pin_memory=True)
            host = buf[: a.size].view(a.shape)
            host.numpy()[...] = a
            staged.append(host.to(self.device, non_blocking=True))
        slot["event"].record()
        return staged

    def _stage_tile(self, tile, slot):
        """Stage a dense tile, or the arrays of a :class:`CompactTile`
        (``grp`` as its int16 view: torch's uint16 has few device ops)."""
        if not isinstance(tile, CompactTile):
            return self._stage([tile], slot)[0]
        arrays = [tile.vals, tile.indptr]
        if tile.grp is not None:
            arrays.append(tile.grp.view(np.int16))
        staged = self._stage(arrays, slot)
        grp = staged[2] if tile.grp is not None else None
        return CompactTile(staged[0], grp, staged[1], tile.t_cols)

    # -- overflow fallback -------------------------------------------------------
    def _recompute_with_sort_engine(self, cols: np.ndarray, consume_stats) -> None:
        """Exact recomputation of selected columns via the sort engine, in
        chunks of ``_FALLBACK_WIDTH`` columns."""
        sort_fn = make_tile_fn(
            self.layout, ref_code=self.info.ref_code, is_log1p=self.is_log1p,
            device=self.device,
        )
        fw = self._FALLBACK_WIDTH
        for s in range(0, cols.size, fw):
            chunk = cols[s : s + fw]
            tile = self._host_tile(self.handler.fetch_columns(chunk))
            out = sort_fn(torch.from_numpy(tile).to(self.device))
            consume_stats(chunk, {k: v.cpu() for k, v in out.items()})

    # -- main loop -----------------------------------------------------------------
    def run(self, progress: bool = True) -> RunResult:
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

        def consume_stats(cols, out):
            """Scatter one host output dict into the result arrays at the
            given global column indices."""
            w = len(cols)
            ov = out.get("overflow_cols")
            if ov is not None:
                bad = np.flatnonzero(ov.numpy()[:w])
                if bad.size:
                    overflow_cols.extend(np.asarray(cols)[bad].tolist())
            if is_ovr:
                r_tgt = out["R2"].numpy()[:, :w] / 2.0
                U[:, cols] = nr * nt + nt * (nt + 1.0) / 2.0 - r_tgt
                tie[:, cols] = np.broadcast_to(out["tie_col"].numpy()[None, :w], (G, w))
            else:
                u_tgt = out["U2"].numpy()[:, :w] / 2.0
                U[:, cols] = nr * nt - u_tgt
                tie[:, cols] = out["tie_ref_col"].numpy()[None, :w] + out["tie_seg"].numpy()[:, :w]
            # A NaN expression sum reads as 0.0, as in the reference, whose
            # packed result wire carries fc sums as an integer mantissa and
            # exponent and converts a NaN mantissa to 0.
            fc_sums = out["fc_sums"].numpy()[:, :w]
            fc[:, cols] = fold_change_from_summed_expr(
                np.where(np.isnan(fc_sums), 0.0, fc_sums), info.counts, info.ref_code,
            )
            pvals[:, cols] = pvalues_from_stats(
                U[:, cols], tie[:, cols], nr, nt,
                use_continuity=self.use_continuity,
                tie_correct=self.tie_correct,
                alternative=self.alternative,
            )

        clock = _StageClock(self.device)
        cuda = self.device.type == "cuda"
        n_prefetch = max(2, self.n_threads)
        depth = max(2, self.n_threads)
        # One pinned staging slot per tile that can be in flight between
        # its fetch and its device copy.
        slots = [
            {"bufs": {}, "event": torch.cuda.Event() if cuda else None}
            for _ in range(n_prefetch + 1)
        ]
        pending: deque = deque()  # (lb, ub, host dict, done event)

        def pull_one():
            lb, ub, host_out, done = pending.popleft()
            if done is not None:
                done.synchronize()
            t0 = time.perf_counter()
            consume_stats(np.arange(lb, ub), host_out)
            clock.add("tail", time.perf_counter() - t0)
            if pbar is not None:
                pbar.update(G * (ub - lb))

        t_loop0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_prefetch) as pool:
            ahead = min(n_prefetch, len(self.bounds))
            futures = {i: pool.submit(self._fetch, *self.bounds[i]) for i in range(ahead)}
            for i, (lb, ub) in enumerate(self.bounds):
                t0 = time.perf_counter()
                tile = futures.pop(i).result()
                clock.add("fetch", time.perf_counter() - t0)
                if i + ahead < len(self.bounds):
                    futures[i + ahead] = pool.submit(self._fetch, *self.bounds[i + ahead])
                clock.mark(None)
                x = self._stage_tile(tile, slots[i % len(slots)])
                clock.mark("h2d")
                out = self.tile_fn(x, clock.mark) if self.engine == "hist" else self.tile_fn(x)
                clock.mark("contract" if self.engine == "hist" else "kernel")
                host_out = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
                clock.mark("d2h")
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record()
                del x, out
                pending.append((lb, ub, host_out, done))
                if len(pending) > depth:
                    pull_one()
            while pending:
                pull_one()
        stage_seconds = clock.finish()
        if pbar is not None:
            pbar.close()
        logger.trace(
            "Tile loop: %.2fs over %d tiles; stages %s.",
            time.perf_counter() - t_loop0, len(self.bounds), stage_seconds,
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
            stacked=results,
            stage_seconds=stage_seconds, n_fallback_cols=n_fallback,
        )
