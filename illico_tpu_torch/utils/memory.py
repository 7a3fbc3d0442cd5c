"""A-priori memory budgets and footprint estimates (host RAM and device memory).

Port of ``illico_tpu.utils.memory``: the host tile budget is the same rule;
the device term is measured against ``torch.cuda.mem_get_info`` instead of a
fixed HBM size.
"""

from __future__ import annotations

import os

import torch

from illico_tpu_torch.utils.log import logger

__all__ = [
    "device_free_bytes",
    "estimate_memory_usage",
    "host_tile_budget",
    "log_memory_usage",
]


def _mem_available_bytes() -> int | None:
    """``MemAvailable`` from /proc/meminfo, or None when unreadable."""
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def host_tile_budget() -> int:
    """Host-memory budget (bytes) for in-flight input tiles.

    ``ILLICO_TPU_HOST_BUDGET`` (bytes) overrides; else 25% of the machine's
    currently available RAM, clamped to [256 MB, 8 GB] and quantized down to
    a power of two so that the derived tile width does not jitter between
    runs; 1 GB when availability cannot be read (non-Linux).
    """
    env = os.environ.get("ILLICO_TPU_HOST_BUDGET")
    if env:
        try:
            return max(int(float(env)), 1 << 20)
        except (ValueError, OverflowError):  # "abc", "inf", "nan"
            logger.warning(
                "Ignoring unparseable ILLICO_TPU_HOST_BUDGET=%r.", env
            )
    avail = _mem_available_bytes()
    if avail is None:
        return int(1e9)
    budget = int(min(max(avail // 4, 256 * 2**20), 8 * 2**30))
    return 1 << (budget.bit_length() - 1)


def device_free_bytes(device: torch.device) -> int | None:
    """Device memory this process can still allocate, in bytes, or None for
    a CPU device: what CUDA reports free (``torch.cuda.mem_get_info``) plus
    what torch's caching allocator holds without using it, which CUDA counts
    as taken (after a few large calls in one process that is most of the
    card)."""
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return int(free) + int(cached)


def estimate_memory_usage(
    handler,
    group_info,
    tile_width: int,
    n_threads: int,
    *,
    engine: str = "sort",
    v_buckets: int = 128,
    value_itemsize: int = 4,
):
    """Return (host_bytes, device_bytes) estimates for the given engine."""
    n_groups = group_info.n_groups
    n_cells, n_genes = handler.shape
    # Host: the (G, n_genes, 3) result buffer, the (G, n_genes) tie buffer
    # and the in-flight prefetch tiles.
    results = n_groups * n_genes * 3 * 8
    tie = n_groups * n_genes * 8
    n_prefetch = max(2, n_threads)
    host_tiles = n_prefetch * handler.tile_footprint(tile_width)
    host = results + tie + host_tiles
    tile_bytes = n_cells * tile_width * value_itemsize
    if engine == "hist":
        # The staged tile, the (G, V, T) float32 histogram and the
        # contraction's group-chunked float64 workspace
        # (ops/hist_engine.CONTRACT_CHUNK_BYTES, a few temporaries).
        from illico_tpu_torch.ops.hist_engine import CONTRACT_CHUNK_BYTES

        device = int(
            tile_bytes
            + n_groups * v_buckets * tile_width * 4
            + 4 * CONTRACT_CHUNK_BYTES
        )
    else:
        # Raw tile + padded gather + sort values/indices + payloads.
        device = int(tile_bytes * 6)
    return host, device


def log_memory_usage(handler, group_info, tile_width: int, n_threads: int, **kw):
    host, device = estimate_memory_usage(
        handler, group_info, tile_width, n_threads, **kw
    )
    logger.trace(
        "Estimated peak memory: host ~%.1f MB, device ~%.1f MB.",
        host / 1e6, device / 1e6,
    )
    return host, device
