#!/usr/bin/env python3
"""Smoke test of illico_tpu_torch on one CUDA card: build, check, measure.

    python3 chip_smoke.py                 # all phases (needs one CUDA card)
    python3 chip_smoke.py --phases 1,2    # build and kernel checks only (K1, contraction, fused)
    python3 chip_smoke.py --phases 1,8    # build, then the wire on the card
    python3 chip_smoke.py --phases 1,5,9  # counts at full width, host and device input
    python3 chip_smoke.py --phases 1,5,9,10  # the same, then sharded and multi-process
    python3 chip_smoke.py --phases 1,11   # repaired tile widths, then 8,000 genes
    python3 chip_smoke.py --phases 1,12   # heavy-tailed counts at 8,000 genes, V=512

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit), the nvcc build of every
   kernel in ``illico_tpu_torch/csrc`` (one nvcc process per ``.cu``, all
   started together) and the C++ build of the native host
   library (``csrc/tail.cpp`` and the CSR scans ``csrc/csr_scan.cpp``), with
   its compiler line; the library must hold both sources' entry points
   under their build tag and report an OpenMP build (its default thread
   count depends on it);
2. the histogram kernel (``csrc/hist_kernel.cu``) against its plain torch
   version on the card, bit for bit: V in {128, 256, 512}, raw and log1p
   tables, T=1000, 2000 groups including a 1-cell group, adversarial values
   (NaN, +-inf, -0.0, 0.5, -1, 511, 600, 1e30) and a uint8 tile; on each of
   those six histograms the contraction kernels (``csrc/hist_contract.cu``)
   against ``hist_contract_plain``, bit for bit: OVR with the R2 and fc row
   splits, OVO with the nnz split (and fc_u8) and without it; and in the
   same three variants the fused pass (``csrc/hist_fused.cu``:
   ``row_counts_kernel`` and ``grouped_hist_contract_kernel``) on the same
   tile against its plain version and against the contraction of K1's
   histogram, bit for bit;
3. the sort engine (``rank_stats_tile``) on the card against the same
   function on the CPU, OVO and OVR, raw and log1p;
4. the public API on the card at 20k cells x 300 genes x 50 groups, OVO and
   OVR, raw and log1p, with columns past the value table (the sort
   fallback must run), against ``scipy.stats.mannwhitneyu``: U exact, p
   within rtol 1e-12, fold change within rtol 1e-6;
5. the main path at full width: 300,000 cells x 2,048 genes x 2,000 groups
   (one auto tile; the K562-essential scale cut from 8,000 genes), dense
   float32 Poisson counts with ~90% zeros from a fixed numpy seed, one timed
   public-API call each for OVO and OVR with the native tail on one thread
   (``ILLICO_TPU_TAIL_THREADS=1``) and one each at the default count (the
   runner's, in ``tail_threads``), frames bit-equal,
   with the per-stage split and a scipy spot check; every tile must take
   the native tail, and each call launch the fused pass (one
   ``row_counts_kernel`` and one ``grouped_hist_contract_kernel``, neither K1
   nor the histogram's contraction kernels) for its warm-up and once per
   tile (phase 9 holds its calls to the same counts); then K1's own time at
   that shape (CUDA events) beside its memory bound, its plain version and
   ``torch.bincount``;
6. the compact sort engine (``csort_stats_tile``) on the card against the
   same function on the CPU: OVO and OVR, positive and negative values,
   float32 and float64, an all-zero and a full column, real +inf values and
   a NaN column; integer statistics equal, float64 sums within rtol 1e-12
   (atol 1e-9);
7. the normalized main path at full width: the phase-5 shape (300,000 cells
   x 2,048 genes x 2,000 groups), Poisson counts with ~90% zeros turned into
   scanpy's ``log1p(x / rowsum * 1e4)`` as float32 and held as CSR; one
   timed ``engine="auto"`` public-API call each for OVO and OVR (which must
   pick ``csort``), with the stage split and a scipy spot check; the host
   compaction of one full tile timed alone, the device side of one tile
   against the full-column sort engine on the same columns, and one
   ``engine="sort"`` call on the same matrix, held equal to the csort call;
8. the packed result wire on the card, at 20,000 cells x 300 genes x 150
   groups (control 40%, so OVO takes the nnz-split wire and OVR the row
   split): for one histogram, one sort and one compact-sort tile the buffer
   packed on CUDA equals the buffer packed by the same code on the CPU byte
   for byte, and its unpacking equals the unpacked engine's dict; the pack
   alone is timed; the f96 tier's special values (0, -0.0, a subnormal,
   2**63, NaN, +-inf) pack to the same bytes on both devices; and public-API
   calls through the native tail equal the same calls through the numpy tail
   (U and fold change equal, p within rtol 1e-14);
9. device-resident input at full width: the phase-5 matrix as a CUDA float32
   tensor, OVO and OVR through ``engine="auto"``: the frame equals the
   host-input frame bit for bit, ``h2d`` is 0 and ``fetch`` ~0, every tile
   takes the native tail, scipy spot checks; then one profiled call
   (``profile_dir``) whose trace gives the card's busy share of the call;
10. multi-device and multi-process runs on phase 5's matrix and frames, with
    shards on distinct cards when there are at least two and otherwise as
    logical shards on ``cuda:0``: (a) the histogram kernel on the shard-local
    inputs of a 2-way and a 3-way cell split of phase 2's population (a
    group absent from a shard, a 1-cell group), each shard on a non-default
    stream, against its plain version bit for bit, and the sum over shards
    against the unsharded histogram, then the same on the two 150,000-row
    blocks of phase 5's matrix with its labels' shard-local inputs, the
    shapes the cell mesh gives the kernel; (b) the public API with ``devices=2``
    (gene mesh) and (c) ``devices=(2, 1)`` (cell mesh, host input and a CUDA
    tensor), OVO and OVR: frames equal phase 5's bit for bit, every shard
    tile on the native tail, stage seconds per device, the lead device's
    peak memory and the histogram add timed alone; each gene shard takes the
    fused pass, the cell mesh K1 and the histogram's contraction kernels
    (each path's launches counted from 0 by kernel and held); (d)
    ``simulate_multihost`` with 2 hosts x 1 device at full width, and two
    real processes joined by gloo, both on the card, at phase 4's size and
    at full width (each makes the matrix from the seed and computes its
    1,024-gene window), their frames identical and equal to the
    single-process frame.  The grouped passes are counted from 0 for each
    of (b), (c), the simulated hosts and each worker process, and each count
    is held to what its calls must launch;
11. (a) tiles and gene shards whose widths round up to the same packed
    width: phase 4's population (20,000 cells, 50 groups) at 2,046 genes
    with ``engine="hist"`` and ``batch_size=1024`` (tiles of 1,024 and
    1,022 columns), OVO and OVR, on ``cuda:0``, with ``devices=2`` (shards
    of 512 and 510) and ``devices=(2, 1)``, logical shards on ``cuda:0``,
    each frame held to the same call with ``device="cpu"`` (U equal, p rtol
    1e-12, fc rtol 1e-6), every tile native; then one OVO call at 20,000 x
    8,190 with every default (four auto tiles, the last 2,046 columns)
    against scipy; (c) the published
    width: one OVO call at 300,000 cells x 8,000 genes x 2,000 groups
    (control ~10%, ~90% zeros), the matrix made on the card from a seeded
    ``torch.Generator`` (9.6 GB float32), ``engine="auto"`` (four hist
    tiles, the last 1,856 columns), 50 sampled (group, gene) pairs against
    ``scipy.stats.mannwhitneyu``, wall, stages and peak device memory, K1's
    time on one full 2,048-column tile and K1 against its plain version on
    the last tile.  Each call's grouped passes are counted from 0 and held
    to the warm-up's and one per tile and shard;
12. heavy-tailed raw counts at the published width (300,000 cells x 8,000
    genes x 2,000 groups): Poisson-lognormal counts made on the card from a
    seeded ``torch.Generator`` (~90% zeros, a few percent of the genes with
    a count past 511, the largest table's last value), OVO through
    ``engine="auto"``: (a) on the CUDA tensor: the histogram engine at V=512,
    every column with a count past 511 (and only those) in the sort
    fallback, their share within ``FALLBACK_BAND``, every tile native, the
    fused pass run by the warm-up and once per tile, 50 pairs against scipy (15 on
    fallback columns, 15 on columns whose maximum is in 128-510), the same
    call at ``ILLICO_TPU_TAIL_THREADS=1`` bit-equal beside it (tail and
    wall of both), one call under ``torch.profiler`` whose trace says when
    the first tail starts against the end of the last tile's contraction on
    the card (``tail_overlap.py``); each call's launches counted from 0 by
    kernel and held to one fused pass by the warm-up and one per tile; then one
    128-column and one 512-column chunk of the fallback's columns (padded
    with the columns of next largest maximum) through the sort engine alone,
    timed, the wide one's statistics against the CPU's bit for bit, and the
    top device kernels of one 128-column chunk under ``torch.profiler``; (d) K1
    alone on one full 2,048-column tile at V=256 and V=512, bit for bit
    against its plain version, timed beside its byte bound, its plain
    version and ``torch.bincount``; (e) the contraction kernels alone on the
   V=512 histogram of that tile (G=2,000) with the statics the runner
   derives: OVO with the nnz split (the benchmark's path), OVO with it off,
   OVR with the R2 row split on the control; each bit for bit against
   ``hist_contract_plain``, its kernel launches and every device kernel of
   one call counted, timed by CUDA events beside the plain version and the
   bound (the histogram read once and the outputs written once, against
   the float64 operations of its nonzero counts); (f) the fused pass on
   that tile: ``row_counts_kernel`` and ``grouped_hist_contract_kernel``
   bit for bit against their plain versions and against K1 +
   ``hist_contract`` in six statics variants at V=128, 256 and 512, raw and
   numpy float32 log1p; each kernel timed at each V (the benchmark's OVO
   nnz split, and OVR at V=512) beside its bound and plain version
   (``torch.bincount`` beside the counting kernel), the whole pass beside
   the histogram path's; then one OVO call on the histogram path (the
   ``hist_fn`` hook) whose frame must equal (a)'s bit for bit and whose peak
   device memory must exceed (a)'s by at least 90% of one V=512
   histogram; (b) the same counts as an in-RAM scipy
    CSR (float32 data, int32 indices), twice: as a user's call runs it (the
    device route: the CSR uploaded and ordered by column on the card, every
    tile and fallback chunk made there, 2,048-column tiles) and with the
    route's fit check refused (the host route, the default host tile
    budget): each frame equals (a)'s bit for bit, with the same fallback
    columns, and each call checks the CSR's indices and gathers its sampled
    windows (and, on the host route, its tiles) through the native scans
    (``native.csr_scan_calls``, zeroed before each call), its ``setup`` and
    unstaged seconds printed; then, alone, the CSR's index check and its
    three sampled 24-column windows, native and plain, timed, the windows
    bit-equal, one 2,048-column host tile native and plain, bit-equal, one
    host fallback chunk's fetch, the device upload and column sort, and one
    tile and one chunk densified on the card; (c) numpy float32 ``log1p`` of
    that CSR's data,
    on the device route: U and p equal (a)'s bit for bit, the same
    fallback columns, fold change against float64 numpy on the 50 pairs.

Backed h5ad inputs are not driven here: the chip machine has no ``h5py``.

Any failure raises and exits non-zero; the two worker processes of phase
10 are started here, with a time limit of their own.  The last three lines are the
kernels' JSON record (:func:`kernels_record`), the card's ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Each kernel's ``launches`` there is its
count on its own path, from 0 just before it: the fused pass's two kernels
on phase 5's four calls (one device), K1 and the contraction kernels on
phase 10c's four (the cell mesh, which sums its shards' histograms).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
H100_FP64_PER_S = 34e12  # H100 SXM float64 outside the tensor cores, NVIDIA data sheet
FULL_SHAPE = (300_000, 2048, 2000)  # cells, genes, groups of phases 5, 7 and 9
SEED = 0
DEV = "cuda"  # phases 6 and 7 take a CPU rehearsal at small sizes with "cpu"


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def poisson_counts(rng, n_cells, n_genes, density=0.1):
    """float32 counts, ~(1 - density) zeros, nonzeros 1 + Poisson(lam_gene)."""
    lam = rng.uniform(0.5, 5.0, n_genes).astype(np.float32)
    x = np.zeros((n_cells, n_genes), np.float32)
    for j0 in range(0, n_genes, 256):
        j1 = min(j0 + 256, n_genes)
        block = x[:, j0:j1]
        nz = rng.random(block.shape, dtype=np.float32) < density
        rows, cols = np.nonzero(nz)
        block[rows, cols] = 1.0 + rng.poisson(lam[j0:j1][cols]).astype(np.float32)
    return x


def layout_for(labels, ref=None):
    from illico_tpu_torch.ops.rank_engine import build_padded_layout
    from illico_tpu_torch.utils.groups import encode_and_count_groups

    _, info = encode_and_count_groups(labels, ref)
    return info, build_padded_layout(info.perm, info.indptr)


# --------------------------------------------------------------------------
@contextlib.contextmanager
def environ(name, value):
    """The environment variable ``name`` set to ``value`` inside the block,
    or unset there when ``value`` is None."""
    old = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = str(value)
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


@contextlib.contextmanager
def numpy_tail():
    """The native library hidden inside the block, so consumers take numpy."""
    import illico_tpu_torch.native as native

    native.native_available()
    saved = native._LIB
    native._LIB = None
    try:
        yield
    finally:
        native._LIB = saved


def require_native(tag, df):
    """Fail unless every tile of the call went through the native tail."""
    path = df.attrs["consume_path"]
    if path["numpy"] != 0 or path["native"] < 1:
        raise AssertionError(f"{tag}: consume path {path}, expected all native")


def phase_build():
    import illico_tpu_torch.native as native
    from illico_tpu_torch.utils.cuda_build import BUILD_INFO, SRC_DIR, build_libraries

    stems = sorted(p.stem for p in SRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    build_libraries(stems)
    print(f"[1] built {stems} in {time.perf_counter() - t0:.2f} s", flush=True)
    for stem in stems:
        for line in BUILD_INFO[stem]["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1]   {stem}: {line.strip()}")
    t0 = time.perf_counter()
    if not native.native_available():
        raise AssertionError("the native tail (csrc/tail.cpp) did not build or load")
    command = native.BUILD_INFO["command"]
    print(f"[1] native tail in {time.perf_counter() - t0:.2f} s: "
          f"{command or 'already built'} -> "
          f"{os.path.relpath(native.BUILD_INFO['path'])}", flush=True)
    if not native.openmp_enabled():
        raise AssertionError("the native tail was built without OpenMP: its consume loop "
                             "would run on one thread whatever the thread count says")
    print(f"[1] native tail built with OpenMP; default thread count "
          f"{native.tail_threads()} (host input: {native.tail_threads(busy=2)})", flush=True)
    lib = native._load()
    entries = ("illico_consume_tile", "illico_csr_check_sorted", "illico_csr_gather_window")
    missing = [name for name in entries if not hasattr(lib, name)]
    if missing or not native.BUILD_INFO["path"].endswith(f"illico_tail_{native.build_tag()}.so"):
        raise AssertionError(f"the native library {native.BUILD_INFO['path']} lacks {missing} "
                             f"or is not the build of {[p.name for p in native._SOURCES]}")
    print(f"[1] native library from {[p.name for p in native._SOURCES]} (build tag "
          f"{native.build_tag()}) holds {list(entries)}", flush=True)


def phase_kernel(stats):
    import torch

    from illico_tpu_torch.ops import hist_engine as he

    rng = np.random.default_rng(SEED)
    n_cells, t_cols, n_groups = 60_000, 1000, 2000
    labels = rng.integers(1, n_groups, n_cells)
    labels[rng.integers(n_cells)] = 0  # a 1-cell group
    _, layout = layout_for(labels)
    real = he.real_rows_per_group(layout)
    counts = poisson_counts(rng, n_cells, t_cols)
    adversarial = np.array(
        [np.nan, np.inf, -np.inf, -0.0, 0.5, -1.0, 511.0, 600.0, 1e30], np.float32
    )
    launches0, fused0 = he.hist_pass.launches, he.hist_pass_contract.launches
    worst = 0.0
    for is_log1p in (False, True):
        x = np.log1p(counts).astype(np.float32) if is_log1p else counts.copy()
        extra = adversarial
        if is_log1p:
            extra = np.concatenate([adversarial, np.log1p(np.float32([511, 600, 255]))])
        pos = rng.integers(0, x.size, 20 * extra.size)
        x.ravel()[pos] = np.resize(extra, pos.size)
        for v_buckets in (128, 256, 512):
            arrs = he.prepare_hist_inputs(layout, v_buckets, is_log1p, "cuda")
            args = (arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"])
            xd = torch.from_numpy(x).cuda()
            got = he.hist_pass(xd, *args, is_log1p=is_log1p)
            want = he.hist_pass_plain(xd, *args, is_log1p=is_log1p)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"kernel != plain (V={v_buckets}, log1p={is_log1p}): max |diff| {err}"
                )
            print(f"[2] V={v_buckets} log1p={is_log1p}: kernel == plain "
                  f"({int(want.sum())} counted of {x.size})", flush=True)
            # The contraction kernels on this histogram: OVR with both row
            # splits, OVO (the largest group as reference) with and without
            # the nnz split; then the fused pass on the same tile, against
            # its plain version and the contraction of this histogram.
            del want
            launches = {}
            for name, kw in contract_variants(layout).items():
                tag = f"[2] V={v_buckets} log1p={is_log1p} {name}"
                launches[name], _ = contract_check(tag, got, arrs["ppg"], kw)
                rows = he.counting_rows(real, arrs["perm"], kw["ref_code"])
                fused_check(tag, xd, args, arrs["ppg"], rows, is_log1p, kw, hist=got)
            print(f"[2] V={v_buckets} log1p={is_log1p}: contraction kernels == plain; "
                  f"launches {launches}; fused pass == plain == K1 + contraction", flush=True)
            del got
    # Narrow wire dtype: a uint8 tile is cast on the card.
    arrs = he.prepare_hist_inputs(layout, 128, False, "cuda")
    args = (arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"])
    x8 = torch.from_numpy(np.minimum(counts, 255).astype(np.uint8)).cuda()
    hist8 = he.hist_pass(x8, *args, is_log1p=False)
    if not torch.equal(hist8, he.hist_pass_plain(x8, *args, is_log1p=False)):
        raise AssertionError("kernel != plain on a uint8 tile")
    kw = contract_variants(layout)["ovo_nnz_split"]
    fused_check("[2] uint8 tile ovo_nnz_split", x8, args, arrs["ppg"],
                he.counting_rows(real, arrs["perm"], kw["ref_code"]), False, kw, hist=hist8)
    del hist8
    # K1's own launches: the pass counter less the fused kernel's.
    moved = he.hist_pass.launches - launches0
    fused = he.hist_pass_contract.launches - fused0
    if moved - fused != 7 or fused != 6 * 3 + 1:
        raise AssertionError(f"launch counters moved by {moved} (pass) and {fused} (fused), "
                             f"expected 7 + 19 and 19")
    print(f"[2] uint8 tile: kernel == plain, fused pass == plain == K1 + contraction; K1 "
          f"launches +{moved - fused}, fused +{fused}", flush=True)
    stats["max_abs_err"] = worst
    stats["contract_max_abs_err"] = 0.0  # contract_check raises on any difference


def contract_variants(layout):
    """``hist_contract`` keywords of three runs on one histogram: OVR with
    both row splits on the largest group, and OVO against that group with
    the nnz split (fc_u8 on, the fc row split on the reference) and
    without it."""
    from illico_tpu_torch.ops.hist_engine import real_rows_per_group

    big = ref_code = int(np.argmax(real_rows_per_group(layout)))
    n_pad = float(layout.n_pad)
    return {
        "ovr_row_splits": dict(n_pad=n_pad, ref_code=-1, u2_split_code=big, fc_split_code=big),
        "ovo_nnz_split": dict(n_pad=n_pad, ref_code=ref_code, nnz_split=True, fc_u8=True,
                              fc_split_code=ref_code),
        "ovo": dict(n_pad=n_pad, ref_code=ref_code),
    }


def fused_check(tag, x, args, ppg, rows, is_log1p, kw, hist=None):
    """The fused pass (``row_counts_kernel`` and
    ``grouped_hist_contract_kernel``) against its plain version on the same
    tile and, when given K1's histogram of it, against ``hist_contract`` of
    that histogram: every output equal, bit for bit (every statistic an
    integer below 2^53, or OVR's tie_col, the same torch expression in
    each); each call's launches held to one of each kernel."""
    import torch

    from illico_tpu_torch.ops import hist_engine as he

    counters = (he.hist_pass, he.hist_pass_contract, he.row_counts, he.hist_contract)
    before = [c.launches for c in counters]
    got = he.hist_pass_contract(x, *args, ppg, count_rows=rows, is_log1p=is_log1p, **kw)
    moved = [c.launches - b for c, b in zip(counters, before)]
    if DEV == "cuda" and moved != [1, 1, 1, 0]:
        raise AssertionError(f"{tag}: fused call moved the launch counters (pass, fused, "
                             f"row counts, contraction) by {moved}, expected [1, 1, 1, 0]")
    refs = {"plain": he.hist_pass_contract_plain(x, *args, ppg, count_rows=rows,
                                                 is_log1p=is_log1p, **kw)}
    if hist is not None:
        refs["K1 + hist_contract"] = he.hist_contract(hist, ppg, **kw)
    sync()
    for name, want in refs.items():
        if got.keys() != want.keys():
            raise AssertionError(f"{tag}: fused outputs {sorted(got)} != {name} {sorted(want)}")
        for key, w in want.items():
            if not torch.equal(got[key], w):
                diff = float((got[key].double() - w.double()).abs().max())
                raise AssertionError(f"{tag}: fused pass != {name} in {key}, max |diff| {diff}")


def phase_sort():
    import torch

    from illico_tpu_torch.ops.rank_engine import rank_stats_tile

    rng = np.random.default_rng(SEED + 1)
    n_cells, t_cols = 5000, 64
    labels = rng.integers(0, 20, n_cells)
    counts = poisson_counts(rng, n_cells, t_cols, density=0.4)
    for ref in (None, 3):
        info, layout = layout_for(labels, ref)
        for is_log1p in (False, True):
            x = np.log1p(counts).astype(np.float32) if is_log1p else counts
            res = {}
            for dev in ("cpu", "cuda"):
                args = [
                    torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (layout.perm, layout.grp, layout.pad_mask,
                              layout.block_starts, layout.block_ends)
                ]
                out = rank_stats_tile(
                    torch.from_numpy(x).to(dev), *args,
                    ref_code=info.ref_code, is_log1p=is_log1p,
                )
                res[dev] = {k: v.cpu().numpy() for k, v in out.items()}
            if res["cpu"].keys() != res["cuda"].keys():
                raise AssertionError("sort engine: key sets differ")
            for k, want in res["cpu"].items():
                if k == "fc_sums" and is_log1p:  # expm1 may differ by ULPs
                    np.testing.assert_allclose(res["cuda"][k], want, rtol=1e-6)
                else:
                    np.testing.assert_array_equal(res["cuda"][k], want, err_msg=k)
            print(f"[3] rank_stats_tile {'OVR' if ref is None else 'OVO'} "
                  f"log1p={is_log1p}: cuda == cpu", flush=True)


def scipy_check(tag, df, x, labels, ref, is_log1p, pairs):
    """U exact, p rtol 1e-12, fc rtol 1e-6 against scipy on (group, gene)
    pairs; ``x`` is the matrix or a dict of its columns by gene."""
    from scipy import sparse
    from scipy.stats import mannwhitneyu

    for grp, j in pairs:
        if isinstance(x, dict):  # gene -> host copy of its column
            col = x[j]
        else:
            col = x[:, j].toarray().ravel() if sparse.issparse(x) else x[:, j]
        col = col.astype(np.float64)
        tgt = col[labels == grp]
        rest = col[labels == ref] if ref is not None else col[labels != grp]
        u, p = mannwhitneyu(rest, tgt, method="asymptotic", use_continuity=True,
                            alternative="two-sided")
        if is_log1p:
            tgt, rest = np.expm1(tgt), np.expm1(rest)
        # The packages' fold change is +inf where the reference mean is 0.
        fc = tgt.mean() / rest.mean() if rest.mean() != 0 else np.inf
        row = df.loc[(str(grp), f"gene_{j}")]
        if row.statistic != u:
            raise AssertionError(f"{tag} ({grp}, {j}): U {row.statistic} != scipy {u}")
        np.testing.assert_allclose(row.p_value, p, rtol=1e-12, atol=0, err_msg=f"{tag} p ({grp}, {j})")
        np.testing.assert_allclose(row.fold_change, fc, rtol=1e-6, err_msg=f"{tag} fc ({grp}, {j})")


def frames_close(tag, got, want):
    """U bit for bit, p within rtol 1e-12, fc within rtol 1e-6."""
    if not got.index.equals(want.index):
        raise AssertionError(f"{tag}: index differs")
    np.testing.assert_array_equal(got.statistic.values, want.statistic.values, err_msg=tag)
    np.testing.assert_allclose(got.p_value.values, want.p_value.values, rtol=1e-12, atol=0,
                               err_msg=tag)
    np.testing.assert_allclose(got.fold_change.values, want.fold_change.values, rtol=1e-6,
                               err_msg=tag)


def phase_medium():
    from illico_tpu_torch import asymptotic_wilcoxon_arrays

    rng = np.random.default_rng(SEED + 2)
    n_cells, n_genes, n_groups = 20_000, 300, 50
    counts = poisson_counts(rng, n_cells, n_genes, density=0.3)
    hot = np.arange(50, 56)  # outside the engine's sampling windows
    counts[rng.integers(0, n_cells, 40), np.resize(hot, 40)] = 650.0
    labels = np.char.add("g", rng.integers(0, n_groups, n_cells).astype(str))
    ref = "g0"
    pairs = [(g, int(j)) for g, j in zip(
        np.char.add("g", rng.integers(1, n_groups, 12).astype(str)),
        np.concatenate([hot, rng.integers(0, n_genes, 6)]),
    )]
    for is_log1p in (False, True):
        x = np.log1p(counts).astype(np.float32) if is_log1p else counts
        for reference in (ref, None):
            t0 = time.perf_counter()
            df = asymptotic_wilcoxon_arrays(
                x, labels, is_log1p=is_log1p, reference=reference, progress=False,
            )
            wall = time.perf_counter() - t0
            tag = f"{'OVO' if reference else 'OVR'} log1p={is_log1p}"
            if df.attrs["engine"] != "hist" or df.attrs["n_fallback_cols"] < hot.size:
                raise AssertionError(f"{tag}: engine {df.attrs['engine']}, "
                                     f"{df.attrs['n_fallback_cols']} fallback columns")
            require_native(tag, df)
            scipy_check(tag, df, x, labels, reference, is_log1p, pairs)
            print(f"[4] {tag}: {wall:.2f} s, {df.attrs['n_fallback_cols']} "
                  f"sort-fallback columns, {len(pairs)} pairs match scipy", flush=True)


def full_problem():
    """The full-width counts matrix, its labels and the spot-check pairs;
    every process that makes them makes the same."""
    rng = np.random.default_rng(SEED + 3)
    n_cells, n_genes, n_groups = FULL_SHAPE
    x = poisson_counts(rng, n_cells, n_genes)
    codes = rng.integers(1, n_groups, n_cells)
    codes[rng.random(n_cells) < 0.1] = 0  # control group, ~10% of cells
    labels = np.where(codes == 0, "non-targeting", np.char.add("pert_", codes.astype(str)))
    pairs = [(str(g), int(j)) for g, j in zip(
        np.unique(labels)[rng.integers(0, n_groups - 1, 8)], rng.integers(0, n_genes, 8)
    )]
    return x, labels, pairs


def full_counts(ctx):
    """The full-width problem, made once for phases 5, 9 and 10."""
    if "x" not in ctx:
        n_cells, n_genes, n_groups = FULL_SHAPE
        t0 = time.perf_counter()
        x, labels, pairs = full_problem()
        print(f"[5/9] data {n_cells} x {n_genes}, {n_groups} groups, "
              f"{np.mean(x == 0):.3f} zeros, made in {time.perf_counter() - t0:.1f} s", flush=True)
        ctx.update(x=x, labels=labels, pairs=pairs, frames={})
    return ctx["x"], ctx["labels"], ctx["pairs"]


def full_call(tag, X, labels, reference, shard_tiles=1, **kw):
    """One timed public-API call at full width; returns (frame, record).
    ``shard_tiles``: the gene shards a tile splits into (``devices=``)."""
    import torch

    from illico_tpu_torch import asymptotic_wilcoxon_arrays

    n_groups, n_genes = FULL_SHAPE[2], FULL_SHAPE[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    df = asymptotic_wilcoxon_arrays(X, labels, reference=reference, progress=False, **kw)
    wall = time.perf_counter() - t0
    rec = {
        "wall_s": wall, "tests_per_s": n_groups * n_genes / wall,
        "engine": df.attrs["engine"], "consume_path": df.attrs["consume_path"],
        "tail_threads": df.attrs["tail_threads"],
        "stage_s": df.attrs["stage_seconds"],
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if "devices" in kw:
        rec["stage_s_by_device"] = df.attrs["stage_seconds_by_device"]
    print(f"{tag}: {json.dumps(rec)}", flush=True)
    if df.attrs["engine"] != "hist" or not np.isfinite(df.p_value.values).all():
        raise AssertionError(f"{tag}: engine {df.attrs['engine']} or non-finite p")
    if df.shape != (n_groups * n_genes, 3):
        raise AssertionError(f"{tag}: result shape {df.shape}")
    n_tiles = -(-n_genes // 2048) * shard_tiles
    if df.attrs["consume_path"] != {"native": n_tiles, "numpy": 0}:
        raise AssertionError(f"{tag}: consume path {df.attrs['consume_path']}, "
                             f"expected {n_tiles} native tiles")
    return df, rec


LAUNCH_COUNTERS = ("hist_pass", "hist_pass_contract", "row_counts", "hist_contract")


def zero_launches():
    """Every kernel wrapper's launch count set to 0."""
    from illico_tpu_torch.ops import hist_engine as he

    for name in LAUNCH_COUNTERS:
        getattr(he, name).launches = 0


def read_launches(tag, passes, path="fused", contractions=0):
    """The launch counts since :func:`zero_launches`, held to ``passes``
    grouped-histogram passes on ``path``: "fused" (one device or a gene
    shard: each pass one ``row_counts_kernel`` and one
    ``grouped_hist_contract_kernel``, neither K1 nor the histogram's
    contraction kernels) or "histogram" (the cell mesh and the
    ``hist_fn`` hook: K1, and ``contractions`` launches of the contraction
    kernels, OVO one and OVR two a contraction).  Returns the counts by
    kernel."""
    from illico_tpu_torch.ops import hist_engine as he

    got = {name: getattr(he, name).launches for name in LAUNCH_COUNTERS}
    fused = passes if path == "fused" else 0
    want = {"hist_pass": passes, "hist_pass_contract": fused, "row_counts": fused,
            "hist_contract": 0 if path == "fused" else contractions}
    if DEV == "cuda" and got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")
    return {"grouped_hist_contract_kernel": got["hist_pass_contract"],
            "row_counts_kernel": got["row_counts"],
            "grouped_hist_kernel": got["hist_pass"] - got["hist_pass_contract"],
            "hist_contract_kernels": got["hist_contract"]}


def phase_full(stats, ctx):
    import torch

    # One auto tile of 2048 columns: lift the host budget for in-flight
    # tiles (default 8 GiB at most) so it does not split the tile in two.
    os.environ["ILLICO_TPU_HOST_BUDGET"] = str(16 << 30)
    x, labels, pairs = full_counts(ctx)
    torch.cuda.synchronize()
    zero_launches()  # count the main path's launches only
    runs = {}
    for threads in (1, None):  # one thread, then the default count
        for reference in ("non-targeting", None):
            tag = "OVO" if reference else "OVR"
            with environ("ILLICO_TPU_TAIL_THREADS", threads):
                df, rec = full_call(f"[5] {tag} tail_threads={threads or 'default'}", x,
                                    labels, reference)
            runs[f"{tag} x{rec['tail_threads']}"] = rec
            if threads == 1:
                scipy_check(f"full {tag}", df, x, labels, reference, False,
                            [(g, j) for g, j in pairs if g != reference])
                ctx["frames"][tag] = df
            else:  # bit-equal at any thread count
                np.testing.assert_array_equal(df.values, ctx["frames"][tag].values)
    # Per call: one fused pass by the warm-up and one per tile, each one
    # launch of the counting kernel and one of the fused kernel; neither K1
    # nor the histogram's contraction kernels.
    launches = read_launches("[5] main path", 4 * 2)
    print(f"[5] launches on the main path (four calls, each the warm-up and one tile): "
          f"{launches}; every tile took the native tail; frames bit-equal at 1 and "
          f"{rec['tail_threads']} (the default) tail threads; scipy spot checks pass",
          flush=True)
    stats["full"] = runs

    # The kernel alone at the main path's shape.
    _, layout = layout_for(labels, "non-targeting")
    rec = k1_alone("[5]", torch.from_numpy(x).cuda(), layout, 128)
    stats.update(launches=launches, **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                                           "library_ms")},
                 max_abs_err=max(stats.get("max_abs_err", 0.0), rec["max_abs_err"]))


def phase_csort():
    import torch

    from illico_tpu_torch.ops.csort_engine import compact_from_entries, csort_stats_tile

    rng = np.random.default_rng(SEED + 4)
    n_cells, t_cols, n_groups = 20_000, 64, 50
    labels = rng.integers(0, n_groups, n_cells)
    base = poisson_counts(rng, n_cells, t_cols, density=0.2).astype(np.float64)
    base[:, 0] = 0.0  # all zeros: the zero block alone
    base[:, 1] = 1.0 + rng.poisson(2.0, n_cells)  # no zeros at all
    base[rng.random(n_cells) < 0.02, 2] = np.inf  # real +inf ties the pads
    base[rng.integers(0, n_cells, 5), 3] = np.nan
    shifted = np.where(base != 0, base - 3.5 + rng.normal(0, 1, base.shape).round(2), 0.0)
    for sign, xs in (("positive", base), ("negative", shifted)):
        for dtype in (np.float32, np.float64):
            x = xs.astype(dtype)
            r, c = np.nonzero(x)
            for ref in (None, 3):
                info, _ = layout_for(labels, ref)
                tile = compact_from_entries(
                    x[r, c], r, c, t_cols, info.encoded_groups, info.n_groups,
                    value_dtype=dtype, need_grp=ref is not None,
                )
                res = {}
                for dev in ("cpu", DEV):
                    grp = None if tile.grp is None else torch.from_numpy(
                        tile.grp.astype(np.int32)).to(dev)
                    out = csort_stats_tile(
                        torch.from_numpy(tile.vals).to(dev), grp,
                        torch.from_numpy(tile.indptr).to(dev),
                        torch.from_numpy(info.counts).to(dev),
                        ref_code=info.ref_code, is_log1p=False, n_total=info.n_cells,
                    )
                    res[dev] = {k: v.cpu().numpy() for k, v in out.items()}
                if res["cpu"].keys() != res[DEV].keys():
                    raise AssertionError("csort: key sets differ")
                for k, want in res["cpu"].items():
                    if k in ("R2", "U2", "tie_col", "tie_ref_col", "tie_seg"):
                        np.testing.assert_array_equal(res[DEV][k], want, err_msg=k)
                    else:
                        np.testing.assert_allclose(res[DEV][k], want, rtol=1e-12,
                                                   atol=1e-9, err_msg=k)
                print(f"[6] csort_stats_tile {'OVR' if ref is None else 'OVO'} {sign} "
                      f"{np.dtype(dtype).name} M={tile.vals.shape[0]}: cuda == cpu", flush=True)


def normalized_csr(rng, n_cells, n_genes):
    """scanpy's normalize_total + log1p of ~90%-zero Poisson counts, float32 CSR."""
    from scipy import sparse

    x = poisson_counts(rng, n_cells, n_genes)
    totals = x.sum(axis=1, keepdims=True)
    totals[totals == 0] = 1.0
    np.divide(x, totals, out=x)
    x *= np.float32(1e4)
    np.log1p(x, out=x)
    return sparse.csr_matrix(x)


def phase_normalized(stats, n_cells=300_000, n_genes=2048, n_groups=2000, width=1024):
    import torch

    from illico_tpu_torch import asymptotic_wilcoxon_arrays
    from illico_tpu_torch.ops import hist_engine as he
    from illico_tpu_torch.ops.csort_engine import (
        _stable_argsort,
        compact_from_entries,
        csort_stats_tile,
    )
    from illico_tpu_torch.ops.rank_engine import rank_stats_tile
    from illico_tpu_torch.utils.registry import data_handler_registry

    os.environ["ILLICO_TPU_HOST_BUDGET"] = str(16 << 30)
    rng = np.random.default_rng(SEED + 5)
    t0 = time.perf_counter()
    X = normalized_csr(rng, n_cells, n_genes)
    codes = rng.integers(1, n_groups, n_cells)
    codes[rng.random(n_cells) < 0.1] = 0
    labels = np.where(codes == 0, "non-targeting", np.char.add("pert_", codes.astype(str)))
    print(f"[7] normalized CSR {n_cells} x {n_genes}, {n_groups} groups, {X.nnz} nonzeros "
          f"(density {X.nnz / (n_cells * n_genes):.4f}), made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pairs = [(str(g), int(j)) for g, j in zip(
        np.unique(labels)[rng.integers(0, n_groups - 1, 8)], rng.integers(0, n_genes, 8)
    )]
    X_csc = X.tocsc()  # fast single-column reads for the scipy checks
    runs, frames = {}, {}
    for reference, engine in (("non-targeting", "auto"), (None, "auto"),
                              ("non-targeting", "sort")):
        tag = f"{'OVO' if reference else 'OVR'} engine={engine}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        he.hist_pass.launches = 0
        t0 = time.perf_counter()
        df = asymptotic_wilcoxon_arrays(X, labels, is_log1p=True, reference=reference,
                                        engine=engine, progress=False, device=DEV)
        wall = time.perf_counter() - t0
        runs[tag] = {
            "wall_s": wall, "tests_per_s": n_groups * n_genes / wall,
            "engine": df.attrs["engine"], "stage_s": df.attrs["stage_seconds"],
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
            "hist_launches": he.hist_pass.launches,
            "consume_path": df.attrs["consume_path"], "input_route": df.attrs["input_route"],
        }
        print(f"[7] {tag}: {json.dumps(runs[tag])}", flush=True)
        want = "csort" if engine == "auto" else engine
        if df.attrs["engine"] != want or not np.isfinite(df.p_value.values).all():
            raise AssertionError(f"{tag}: engine {df.attrs['engine']} or non-finite p")
        # csort compacts on the host; the sort engine takes the CSR to the card.
        if df.attrs["input_route"] != ("host" if want == "csort" else "device"):
            raise AssertionError(f"{tag}: input route {df.attrs['input_route']}")
        if df.shape != (n_groups * n_genes, 3):
            raise AssertionError(f"{tag}: result shape {df.shape}")
        require_native(tag, df)
        scipy_check(f"normalized {tag}", df, X_csc, labels, reference, True,
                    [(g, j) for g, j in pairs if g != reference])
        frames[tag] = df
    a, b = frames["OVO engine=auto"], frames["OVO engine=sort"]
    frames_close("[7] csort vs sort", a, b)
    print("[7] csort == sort on the whole OVO frame; scipy spot checks pass", flush=True)

    # One full csort tile: host compaction alone, then its device side
    # against the full-column sort engine on the same columns.
    info, layout = layout_for(labels, "non-targeting")
    handler = data_handler_registry.get(X)
    t0 = time.perf_counter()
    v, r, c = handler.fetch_tile_entries(0, width)
    entries_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tile = compact_from_entries(v, r, c, width, info.encoded_groups, info.n_groups,
                                need_grp=True)
    compact_s = time.perf_counter() - t0
    # The tiler's (column, group) key, sorted by 16-bit radix passes and by
    # numpy's stable argsort of the int32 key (timsort).
    key = c.astype(np.int32) * np.int32(n_groups) + info.encoded_groups[r]
    t0 = time.perf_counter()
    radix = _stable_argsort(key, n_groups * width)
    radix_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    timsort = np.argsort(key, kind="stable")
    timsort_s = time.perf_counter() - t0
    if not np.array_equal(radix, timsort):
        raise AssertionError("radix argsort != numpy stable argsort")
    del key, radix, timsort
    dev = dict(
        vals=torch.from_numpy(tile.vals).to(DEV),
        grp=torch.from_numpy(tile.grp.astype(np.int32)).to(DEV),
        indptr=torch.from_numpy(tile.indptr).to(DEV),
    )
    counts = torch.from_numpy(info.counts).to(DEV)
    csort_ms = cuda_ms(lambda: csort_stats_tile(
        dev["vals"], dev["grp"], dev["indptr"], counts, ref_code=info.ref_code,
        is_log1p=True, n_total=n_cells), reps=5)
    largs = [torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
             for a in (layout.perm, layout.grp, layout.pad_mask,
                       layout.block_starts, layout.block_ends)]
    xd = torch.from_numpy(X[:, :width].toarray()).to(DEV)
    sort_ms = cuda_ms(lambda: rank_stats_tile(
        xd, *largs, ref_code=info.ref_code, is_log1p=True), reps=3)
    print(f"[7] one {width}-column tile: {v.size} entries read in {entries_s:.3f} s, "
          f"compacted in {compact_s:.3f} s to M={tile.vals.shape[0]} "
          f"(key argsort: radix {radix_s:.3f} s, numpy stable {timsort_s:.3f} s) "
          f"({tile.vals.nbytes / 1e6:.1f} MB vals); device csort {csort_ms:.3f} ms, "
          f"full-column sort {sort_ms:.3f} ms", flush=True)
    stats["normalized"] = dict(runs=runs, entries_s=entries_s, compact_s=compact_s,
                               radix_s=radix_s, timsort_s=timsort_s,
                               m_pad=tile.vals.shape[0], csort_ms=csort_ms,
                               sort_ms=sort_ms)


def phase_wire(stats):
    import torch

    from illico_tpu_torch import asymptotic_wilcoxon_arrays
    from illico_tpu_torch.ops import hist_engine as he
    from illico_tpu_torch.ops import wire
    from illico_tpu_torch.ops.csort_engine import compact_from_entries, make_csort_tile_fn
    from illico_tpu_torch.ops.rank_engine import make_tile_fn

    rng = np.random.default_rng(SEED + 6)
    n_cells, n_genes, n_groups = 20_000, 300, 150
    counts = poisson_counts(rng, n_cells, n_genes, density=0.1)
    counts[rng.integers(0, n_cells, 30), 7] = 650.0  # a column off the value table
    codes = rng.integers(1, n_groups, n_cells)
    codes[rng.random(n_cells) < 0.4] = 0  # control 40%: tie tier u40, groups < 256 cells
    labels = np.char.add("g", codes.astype(str))
    r, c = np.nonzero(counts)
    cpu, cuda = torch.device("cpu"), torch.device(DEV)
    out = {}
    for ref in ("g0", None):
        mode = "OVO" if ref else "OVR"
        info, layout = layout_for(labels, ref)
        ctile = compact_from_entries(counts[r, c], r, c, n_genes, info.encoded_groups,
                                     info.n_groups, need_grp=ref is not None)
        makers = {
            "hist": lambda dev, pack: he.make_hist_tile_fn(
                layout, ref_code=info.ref_code, is_log1p=False, device=dev, pack=pack),
            "sort": lambda dev, pack: make_tile_fn(
                layout, ref_code=info.ref_code, is_log1p=False, device=dev, pack=pack),
            "csort": lambda dev, pack: make_csort_tile_fn(
                info, ref_code=info.ref_code, is_log1p=False, device=dev, pack=pack),
        }
        for engine, make in makers.items():
            tile = {d: (ctile if engine == "csort" else torch.from_numpy(counts).to(d))
                    for d in (cpu, cuda)}
            fn = {d: make(d, True) for d in (cpu, cuda)}
            if engine == "hist":
                st = fn[cuda]._statics
                want_wire = st["nnz_split"] if ref else st["u2_split_code"] >= 0
                if not want_wire:
                    raise AssertionError(f"[8] hist {mode}: statics {st} miss the wire under test")
            buf = {d: fn[d](tile[d]).cpu().numpy() for d in (cpu, cuda)}
            if not np.array_equal(buf[cpu], buf[cuda]):
                raise AssertionError(f"[8] {engine} {mode}: CUDA-packed != CPU-packed buffer")
            got = fn[cuda].unpack(buf[cuda])
            plain = {k: v.cpu().numpy() for k, v in make(cuda, False)(tile[cuda]).items()}
            st = getattr(fn[cuda], "_statics", {})
            for key, split in (("fc_sums", "fc_split_code"), ("R2", "u2_split_code")):
                code = st.get(split, -1)
                if engine == "hist" and code >= 0 and key in got:
                    row = got["fc_split_col" if key == "fc_sums" else "r2_split_col"]
                    got[key] = got[key].astype(np.float64)
                    got[key][code] = row
            # Columns off the value table are recomputed by the caller; the
            # two forms need not agree on their (discarded) statistics.
            keep = ~plain.get("overflow_cols", np.zeros(n_genes, bool))
            if engine == "hist" and keep.all():
                raise AssertionError("[8] the off-table column was not flagged")
            for key, want in plain.items():
                have = np.asarray(got[key], np.float64)[..., :n_genes]
                want = want.astype(np.float64)
                if ref and key in ("U2", "tie_seg"):
                    want[info.ref_code] = 0.0  # zeroed on the wire
                if key != "overflow_cols":
                    have, want = have[..., keep], want[..., keep]
                np.testing.assert_array_equal(have, want, err_msg=f"{engine} {mode} {key}")
            n_tests = info.n_groups * n_genes
            if engine == "hist":  # time the pack alone, on the contraction's outputs
                arrs = he.prepare_hist_inputs(layout, 128, False, cuda)
                hist = he.hist_pass(tile[cuda], arrs["perm"], arrs["indptr"], arrs["order"],
                                    arrs["table"], is_log1p=False)
                kw = {k: v for k, v in st.items() if k not in ("compute_fc", "is_log1p")}
                stat = he.hist_contract(hist, arrs["ppg"], **kw)
                narrow = wire._narrow_map(st)
                width = he.packed_width(n_genes)
                pack_ms = cuda_ms(lambda: wire.pack_device_outputs(
                    he._pad_columns(stat, width), narrow), reps=20)
                out[f"hist {mode}"] = dict(bytes_per_test=buf[cuda].size / n_tests, pack_ms=pack_ms)
                print(f"[8] hist {mode}: CUDA pack == CPU pack ({buf[cuda].size} bytes, "
                      f"{buf[cuda].size / n_tests:.3f} B/test), unpack == unpacked contract; "
                      f"pack alone {pack_ms:.3f} ms", flush=True)
            else:
                out[f"{engine} {mode}"] = dict(bytes_per_test=buf[cuda].size / n_tests)
                print(f"[8] {engine} {mode}: CUDA pack == CPU pack ({buf[cuda].size} bytes, "
                      f"{buf[cuda].size / n_tests:.3f} B/test), unpack == unpacked dict",
                      flush=True)

    # The f96 and word-split tiers at their special values, on both devices.
    special = np.array([0.0, -0.0, 5e-324, 1.0, -2.5, 1 / 3, 2.0**53, 2.0**63 - 1024,
                        2.0**63, 3 * 2.0**64, np.nan, np.inf, -np.inf, 1e300], np.float64)
    for narrow in ({"t": 12}, {}):
        bufs = [wire.pack_device_outputs({"t": torch.from_numpy(special).to(d)}, narrow)[0]
                .cpu().numpy() for d in (cpu, cuda)]
        if not np.array_equal(*bufs):
            raise AssertionError(f"[8] special values pack differently on CUDA ({narrow})")
    print("[8] f96 and word-split tiers: special values pack to the same bytes on CUDA "
          "and CPU", flush=True)

    # The native tail against the numpy tail, through the public API.
    for engine in ("hist", "sort", "csort"):
        for ref in ("g0", None):
            kw = dict(reference=ref, engine=engine, progress=False, device=DEV)
            nat = asymptotic_wilcoxon_arrays(counts, labels, **kw)
            require_native(f"[8] {engine}", nat)
            with numpy_tail():
                ref_df = asymptotic_wilcoxon_arrays(counts, labels, **kw)
            if ref_df.attrs["consume_path"]["native"] != 0:
                raise AssertionError("[8] the numpy-tail call still took the native tail")
            np.testing.assert_array_equal(nat.statistic.values, ref_df.statistic.values)
            np.testing.assert_array_equal(nat.fold_change.values, ref_df.fold_change.values)
            np.testing.assert_allclose(nat.p_value.values, ref_df.p_value.values,
                                       rtol=1e-14, atol=0)
            print(f"[8] {engine} {'OVO' if ref else 'OVR'}: native tail == numpy tail "
                  f"(U, fc equal; p rtol 1e-14); {nat.attrs['n_fallback_cols']} fallback "
                  f"columns", flush=True)
    stats["wire"] = out


def phase_device_input(stats, ctx):
    import torch

    from benchmarks_torch.run import device_busy_seconds
    from illico_tpu_torch import asymptotic_wilcoxon_arrays

    os.environ["ILLICO_TPU_HOST_BUDGET"] = str(16 << 30)
    n_cells, n_genes, n_groups = FULL_SHAPE
    x, labels, pairs = full_counts(ctx)
    for reference in ("non-targeting", None):  # host-input frames, when phase 5 did not run
        tag = "OVO" if reference else "OVR"
        if tag not in ctx["frames"]:
            ctx["frames"][tag], _ = full_call(f"[9] {tag} host input", x, labels, reference)
    xd = torch.from_numpy(x).cuda()
    torch.cuda.synchronize()
    zero_launches()
    runs = {}
    for reference in ("non-targeting", None):
        tag = "OVO" if reference else "OVR"
        df, rec = full_call(f"[9] {tag} CUDA tensor", xd, labels, reference)
        runs[tag] = rec
        st = rec["stage_s"]
        if st["h2d"] != 0.0 or st["fetch"] > 0.05:
            raise AssertionError(f"[9] {tag}: h2d {st['h2d']} s, fetch {st['fetch']} s "
                                 f"on device-resident input")
        np.testing.assert_array_equal(df.values, ctx["frames"][tag].values)
        scipy_check(f"device input {tag}", df, x, labels, reference, False,
                    [(g, j) for g, j in pairs if g != reference])
    launches = read_launches("[9] device-input path", 2 * 2)
    print(f"[9] frames equal the host-input frames bit for bit; h2d 0, fetch ~0; "
          f"launches {launches}; scipy spot checks pass", flush=True)

    # One profiled call: the card's busy share from the profiler's trace.
    # A throwaway profiled call on a small input first pays the profiler's
    # own start-up (seconds, once per process).
    profile_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "illico_tpu_torch", "_build", "profile")
    t0 = time.perf_counter()
    asymptotic_wilcoxon_arrays(xd[:2000, :8].contiguous(), labels[:2000], reference=None,
                               progress=False, profile_dir=profile_dir)
    startup = time.perf_counter() - t0
    t0 = time.perf_counter()
    asymptotic_wilcoxon_arrays(xd, labels, reference=None, progress=False,
                               profile_dir=profile_dir)
    wall = time.perf_counter() - t0
    trace = os.path.join(profile_dir, "trace.json")
    busy_s, n_spans = device_busy_seconds(trace)
    plain_wall = runs["OVR"]["wall_s"]
    print(f"[9] profiled OVR call on the CUDA tensor: wall {wall:.3f} s with the profiler "
          f"on (its start-up call took {startup:.1f} s), {n_spans} device spans, device "
          f"busy {busy_s:.4f} s = {100 * busy_s / wall:.1f}% of the profiled "
          f"call and {100 * busy_s / plain_wall:.1f}% of the unprofiled call's "
          f"{plain_wall:.3f} s; trace {os.path.getsize(trace) / 1e6:.1f} MB at {trace}",
          flush=True)
    stats["device_input"] = dict(runs=runs, launches=launches, profiled_wall_s=wall,
                                 device_busy_s=busy_s)


MEDIUM_SHAPE = (20_000, 300, 50)  # cells, genes, groups of phase 10's two processes


def medium_problem():
    """Phase 10d's matrix and labels; every process makes the same."""
    rng = np.random.default_rng(SEED + 7)
    n_cells, n_genes, n_groups = MEDIUM_SHAPE
    counts = poisson_counts(rng, n_cells, n_genes, density=0.3)
    labels = np.char.add("g", rng.integers(0, n_groups, n_cells).astype(str))
    return counts, labels


def array_adata(x, labels):
    import pandas as pd

    from illico_tpu_torch.io.h5ad import AnnDataLite

    return AnnDataLite(x, pd.DataFrame({"group": labels}),
                       pd.DataFrame(index=[f"gene_{i}" for i in range(x.shape[1])]))


def multihost_worker(address, rank, device, out) -> int:
    """One of phase 10d's two processes: its gene window of the medium
    problem and then of the full-width one on ``device``; the gathered
    frames, each call's seconds and its histogram kernel launches are
    written to ``out``."""
    from illico_tpu_torch import asymptotic_wilcoxon_multihost
    from illico_tpu_torch.ops import hist_engine as he
    from illico_tpu_torch.parallel.multihost import initialize_distributed

    t0 = time.perf_counter()
    if initialize_distributed(address, 2, rank) != (2, rank):
        raise AssertionError("the process group did not come up as (2, rank)")
    record = {"joined_s": time.perf_counter() - t0}
    for size, make, control in (("medium", medium_problem, "g0"),
                                ("full", full_problem, "non-targeting")):
        t0 = time.perf_counter()
        x, labels = make()[:2]
        record[f"{size}_data_s"] = time.perf_counter() - t0
        adata = array_adata(x, labels)
        for tag, reference in (("OVO", control), ("OVR", None)):
            zero_launches()
            t0 = time.perf_counter()
            df = asymptotic_wilcoxon_multihost(
                adata, is_log1p=False, group_keys="group", reference=reference, device=device)
            record[f"{size}_{tag}_s"] = time.perf_counter() - t0
            record[f"{size}_{tag}_launches"] = he.hist_pass.launches
            record[f"{size}_{tag}_fused"] = he.hist_pass_contract.launches
            record[f"{size}_{tag}"] = df.values
    np.savez(out, **record)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def phase_sharded(stats, ctx, worker_timeout=300):
    import socket

    import torch

    from illico_tpu_torch import asymptotic_wilcoxon_arrays
    from illico_tpu_torch.ops import hist_engine as he
    from illico_tpu_torch.parallel import mesh as pmesh
    from illico_tpu_torch.parallel.cells import build_cell_shard_plans
    from illico_tpu_torch.parallel.multihost import simulate_multihost

    os.environ["ILLICO_TPU_HOST_BUDGET"] = str(16 << 30)
    if DEV == "cuda":
        n_cards = torch.cuda.device_count()
        cards = [torch.device("cuda", i) for i in range(max(n_cards, 1))]
    else:  # CPU rehearsal
        n_cards, cards = 0, [torch.device(DEV)]
    distinct = n_cards >= 2
    # With one card every shard is a logical shard on cuda:0 (device=).
    api_kw = {} if distinct else {"device": str(cards[0])}
    pool = [cards[i % len(cards)] for i in range(3)]
    # Warm-up launches per call: the gene mesh warms each distinct device
    # once, the cell mesh its one gene shard, which launches per cell shard.
    warm_launches = {2: 2 if distinct else 1, (2, 1): 2}
    print(f"[10] {n_cards} card(s): shards on "
          f"{'distinct cards' if distinct else f'{cards[0]} as logical shards'} "
          f"({[str(d) for d in pool[:2]]})", flush=True)

    # -- 10a: the kernel on shard-local inputs ------------------------------
    rng = np.random.default_rng(SEED)
    n_cells, t_cols, n_groups = 60_000, 1000, 2000
    if DEV != "cuda":
        n_cells, t_cols, n_groups = 3000, 40, 50
    labels = rng.integers(1, n_groups, n_cells)
    lone = int(rng.integers(n_cells))
    labels[lone] = 0  # a 1-cell group: absent from every shard but one
    info, layout = layout_for(labels)
    counts = poisson_counts(rng, n_cells, t_cols)
    arrs = he.prepare_hist_inputs(layout, 128, False, cards[0])
    whole = he.hist_pass(torch.from_numpy(counts).to(cards[0]), arrs["perm"], arrs["indptr"],
                         arrs["order"], arrs["table"], is_log1p=False)
    launches0 = he.hist_pass.launches
    worst = 0.0
    for n_shards in (2, 3):
        plan = build_cell_shard_plans(info, n_shards)
        empty = sum(int((np.diff(p) == 0).sum()) for p in plan.indptr)
        ones = sum(int((np.diff(p) == 1).sum()) for p in plan.indptr)
        if empty < n_shards - 1 or ones < 1:
            raise AssertionError(f"[10a] {n_shards} shards: {empty} empty and {ones} 1-cell "
                                 f"segments, expected a group absent from a shard and a "
                                 f"1-cell group")
        total = torch.zeros_like(whole)
        for s, (lo, hi) in enumerate(plan.row_bounds):
            dev = pool[s]
            stream = pmesh._new_stream(dev)
            args = [torch.from_numpy(a).to(dev)
                    for a in (plan.perm[s], plan.indptr[s], plan.order[s])]
            args.append(arrs["table"].to(dev))
            xs = torch.from_numpy(counts[lo:hi]).to(dev)
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(dev))
            with pmesh.on_device(dev, stream):
                got = he.hist_pass(xs, *args, is_log1p=False)
                want = he.hist_pass_plain(xs, *args, is_log1p=False)
            if stream is not None:
                stream.synchronize()
            worst = max(worst, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"[10a] shard {s} of {n_shards}: kernel != plain")
            absent = torch.from_numpy(np.flatnonzero(np.diff(plan.indptr[s]) == 0)).to(dev)
            if bool(got[absent].any()):
                raise AssertionError(f"[10a] shard {s} of {n_shards}: an absent group's "
                                     f"histogram is not zero")
            total += got.to(cards[0])
        if not torch.equal(total, whole):
            raise AssertionError(f"[10a] {n_shards} shards: summed histogram != unsharded")
        print(f"[10a] {n_shards} cell shards ({empty} empty segments, {ones} of one cell): "
              f"kernel == plain on every shard's own stream; sum == unsharded", flush=True)
    moved = he.hist_pass.launches - launches0
    if DEV == "cuda" and moved != 5:
        raise AssertionError(f"[10a] launch counter moved by {moved}, expected 5")
    del whole, total, got, want, xs

    # The same at the shapes the cell mesh's main path gives the kernel: the
    # two row blocks of phase 5's matrix, one full-width tile each, with the
    # shard-local inputs of phase 5's labels.
    x, labels, pairs = full_counts(ctx)
    n_cells, n_genes, n_groups = FULL_SHAPE
    info, layout = layout_for(labels, "non-targeting")
    arrs = he.prepare_hist_inputs(layout, 128, False, cards[0])
    xd = torch.from_numpy(x).to(cards[0])
    whole = he.hist_pass(xd, arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"],
                         is_log1p=False)
    del xd
    plan = build_cell_shard_plans(info, 2)
    total = torch.zeros_like(whole)
    shard_ms = []
    for s, (lo, hi) in enumerate(plan.row_bounds):
        dev = pool[s]
        stream = pmesh._new_stream(dev)
        args = [torch.from_numpy(a).to(dev) for a in (plan.perm[s], plan.indptr[s], plan.order[s])]
        args.append(arrs["table"].to(dev))
        xs = torch.from_numpy(x[lo:hi]).to(dev)
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
        with pmesh.on_device(dev, stream):
            got = he.hist_pass(xs, *args, is_log1p=False)
            want = he.hist_pass_plain(xs, *args, is_log1p=False)
            if stream is not None:
                stream.synchronize()
            worst = max(worst, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"[10a] row block {s} at full width: kernel != plain")
            del want
            shard_ms.append(cuda_ms(lambda: he.hist_pass(xs, *args, is_log1p=False), reps=5))
        total += got.to(cards[0])
        del got, xs
    if not torch.equal(total, whole):
        raise AssertionError("[10a] full width: summed histogram != unsharded")
    print(f"[10a] the cell mesh's shapes ({plan.rows_per_shard} rows x {n_genes} columns per "
          f"block, {n_groups} groups): kernel == plain on each block's own stream; sum == "
          f"unsharded; kernel {shard_ms[0]:.3f} and {shard_ms[1]:.3f} ms per block", flush=True)
    del whole, total

    # -- 10b, 10c: the public API under a gene mesh and a cell mesh ---------
    for reference in ("non-targeting", None):
        tag = "OVO" if reference else "OVR"
        if tag not in ctx["frames"]:
            ctx["frames"][tag], _ = full_call(f"[10] {tag} host input", x, labels, reference,
                                              **api_kw)
    n_tiles = -(-n_genes // 2048)
    runs = {}
    launches, by_kernel = {}, {}
    for key, name, devices, shard_tiles, kinds in (
        ("gene_mesh", "10b gene mesh devices=2", 2, 2, ("host",)),
        ("cell_mesh", "10c cell mesh devices=(2, 1)", (2, 1), 1, ("host", "CUDA tensor")),
    ):
        zero_launches()  # this path's launches only
        expected = contractions = 0
        for kind in kinds:
            # The matrix is on the card only while it is the input, so the
            # host-input peaks do not count it.
            X = x if kind == "host" else torch.from_numpy(x).to(cards[0])
            for reference in ("non-targeting", None):
                tag = "OVO" if reference else "OVR"
                df, rec = full_call(f"[{name}] {tag} {kind} input", X, labels, reference,
                                    shard_tiles=shard_tiles, devices=devices, **api_kw)
                np.testing.assert_array_equal(df.values, ctx["frames"][tag].values)
                runs[f"{name} {tag} {kind}"] = rec
                expected += warm_launches[devices] + 2 * n_tiles  # 2 shards per tile
                # The cell mesh contracts the summed histogram once by the
                # warm-up and once per tile: OVO one kernel, OVR two.
                contractions += (1 + n_tiles) * (1 if reference else 2)
            del X
        # Each gene shard takes the fused pass; the cell mesh keeps K1 and
        # the histogram's contraction kernels.
        by_kernel[key] = read_launches(
            f"[{name}]", expected, path="fused" if key == "gene_mesh" else "histogram",
            contractions=contractions)
        launches[key] = he.hist_pass.launches
    print(f"[10b/10c] gene-mesh and cell-mesh frames equal phase 5's bit for bit, host and "
          f"CUDA-tensor input; every shard tile took the native tail; grouped passes: "
          f"{launches['gene_mesh']} under the gene mesh (2 calls, each {warm_launches[2]} "
          f"warm-up launch(es) and one per tile and shard), {launches['cell_mesh']} under the "
          f"cell mesh (4 calls, each 2 warm-up launches and one per tile and shard); by "
          f"kernel {json.dumps(by_kernel)}", flush=True)
    # The cell mesh's histogram sum alone: one shard's (G, V, T) float32
    # histogram added into the lead's (copied first when on another card).
    a = torch.zeros((n_groups, 128, min(n_genes, 2048)), dtype=torch.float32, device=cards[0])
    b = torch.ones_like(a, device=pool[1])
    add_ms = cuda_ms(lambda: a.add_(b.to(cards[0], non_blocking=True)), reps=5)
    print(f"[10c] histogram sum alone ({a.numel() * 4 / 1e9:.2f} GB from {pool[1]} into "
          f"{cards[0]}): {add_ms:.3f} ms", flush=True)
    del a, b

    # -- 10d: simulated hosts at full width, then two real processes --------
    from illico_tpu_torch.parallel.multihost import host_gene_window

    adata = array_adata(x, labels)
    zero_launches()  # this path's launches only
    for reference in ("non-targeting", None):
        tag = "OVO" if reference else "OVR"
        t0 = time.perf_counter()
        df = simulate_multihost(adata, False, "group", reference, n_hosts=2,
                                devices_per_host=1, devices=pool[:2])
        wall = time.perf_counter() - t0
        np.testing.assert_array_equal(df.values, ctx["frames"][tag].values)
        if not df.index.equals(ctx["frames"][tag].index):
            raise AssertionError(f"[10d] {tag}: index differs from phase 5's")
        runs[f"10d simulate_multihost {tag}"] = {"wall_s": wall}
        print(f"[10d] simulate_multihost 2 hosts x 1 device {tag}: frame equals phase 5's "
              f"bit for bit, {wall:.3f} s", flush=True)
    launches["multihost"] = he.hist_pass.launches
    # Per call and host: one warm-up pass and one per tile of its window,
    # each host on one device: the fused pass.
    windows = [host_gene_window(n_genes, 2, h) for h in range(2)]
    per_host = [1 + -(-(ub - lb) // 2048) for lb, ub in windows]
    by_kernel["multihost"] = read_launches("[10d] simulated hosts", 2 * sum(per_host))
    print(f"[10d] simulated hosts: {launches['multihost']} grouped passes (2 calls x 2 "
          f"hosts, each one warm-up pass and one per tile of its window): "
          f"{json.dumps(by_kernel['multihost'])}", flush=True)

    mx, mlabels = medium_problem()
    single = {
        tag: asymptotic_wilcoxon_arrays(mx, mlabels, reference=ref, progress=False, **api_kw
                                        ).values
        for tag, ref in (("OVO", "g0"), ("OVR", None))
    }
    if DEV == "cuda":
        torch.cuda.empty_cache()  # the two processes share this card's memory
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{sock.getsockname()[1]}"
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "illico_tpu_torch", "_build", "multihost")
    os.makedirs(out_dir, exist_ok=True)
    outs = [os.path.join(out_dir, f"rank{r}.npz") for r in range(2)]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multihost-worker", address,
             str(r), str(pool[r]), outs[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=worker_timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for r, proc in enumerate(procs):
        if proc.returncode != 0:
            raise AssertionError(f"[10d] process {r} failed ({proc.returncode}):\n"
                                 f"{logs[r][-3000:] if r < len(logs) else ''}")
    timing, launches["multihost_processes"] = {}, []
    for r, path in enumerate(outs):
        with np.load(path) as rank:
            for size, want in (("medium", single),
                               ("full", {t: f.values for t, f in ctx["frames"].items()})):
                for tag in ("OVO", "OVR"):
                    # Equal to the single-process frame, so to the other rank's.
                    np.testing.assert_array_equal(rank[f"{size}_{tag}"], want[tag])
                    # Per call: one warm-up pass and one tile of the window,
                    # each the fused pass (one device per process).
                    n = int(rank[f"{size}_{tag}_launches"])
                    fused = int(rank[f"{size}_{tag}_fused"])
                    if DEV == "cuda" and (n, fused) != (2, 2):
                        raise AssertionError(f"[10d] process {r}, {size} {tag}: {n} grouped "
                                             f"passes, {fused} fused, expected 2 and 2")
            timing[f"rank{r}"] = {k: float(rank[k]) for k in rank.files if k.endswith("_s")}
            launches["multihost_processes"].append(
                sum(int(rank[k]) for k in rank.files if k.endswith("_launches")))
        os.remove(path)
    print(f"[10d] two processes joined by gloo on {[str(d) for d in pool[:2]]}, at "
          f"{MEDIUM_SHAPE[0]} x {MEDIUM_SHAPE[1]} x {MEDIUM_SHAPE[2]} and at {n_cells} x "
          f"{n_genes} x {n_groups} (each process makes the matrix from the seed and computes "
          f"its {windows[0][1]}-gene window): every frame identical in both and equal to the "
          f"single-process frame (the full-width ones to phase 5's); fused passes per "
          f"process {launches['multihost_processes']} (4 calls, each one warm-up pass and "
          f"one tile); {wall:.2f} s from start to exit, per process {json.dumps(timing)}",
          flush=True)
    stats["sharded"] = dict(runs=runs, launches=launches, by_kernel=by_kernel, add_ms=add_ms,
                            shard_kernel_ms=shard_ms, two_process_wall_s=wall, timing=timing)
    stats["max_abs_err"] = max(stats.get("max_abs_err", 0.0), worst)


WIDTHS_SHAPE = (20_000, 8190, 50)  # cells, genes, groups of phase 11a
PUBLISHED_SHAPE = (300_000, 8000, 2000)  # K562-essential at its published width


def sync():
    if DEV == "cuda":
        import torch

        torch.cuda.synchronize()


def widths_problem():
    """Phase 4's population (20,000 cells, 50 groups, 30% nonzero counts)
    at 8,190 genes; phase 11a takes its first 2,046."""
    rng = np.random.default_rng(SEED + 8)
    n_cells, n_genes, n_groups = WIDTHS_SHAPE
    x = poisson_counts(rng, n_cells, n_genes, density=0.3)
    labels = np.char.add("g", rng.integers(0, n_groups, n_cells).astype(str))
    pairs = [(g, int(j)) for g, j in zip(
        np.char.add("g", rng.integers(1, n_groups, 12).astype(str)),
        np.concatenate([[2047, 4095, 6143, 8189], rng.integers(0, n_genes, 8)]),
    )]
    return x, labels, pairs


def phase_widths(stats):
    """11a: tiles and shards whose widths pack to the same byte count."""
    from illico_tpu_torch import asymptotic_wilcoxon_arrays
    from illico_tpu_torch.ops import hist_engine as he

    x, labels, pairs = widths_problem()
    x2046 = np.ascontiguousarray(x[:, :2046])
    # (tag, devices, K1 launches: the warm-up's and one per tile and shard)
    runs = (("one device", None, 1 + 2), ("devices=2", 2, 1 + 4),
            ("devices=(2, 1)", (2, 1), 2 + 2 * 2))
    launches = {}
    for reference in ("g0", None):
        mode = "OVO" if reference else "OVR"
        for tag, devices, expected in runs:
            kw = dict(reference=reference, engine="hist", batch_size=1024, devices=devices,
                      progress=False)
            want = asymptotic_wilcoxon_arrays(x2046, labels, device="cpu", **kw)
            sync()
            he.hist_pass.launches = 0
            got = asymptotic_wilcoxon_arrays(x2046, labels, device=f"{DEV}:0"
                                             if DEV == "cuda" else DEV, **kw)
            sync()
            n = launches[f"{mode} {tag}"] = he.hist_pass.launches
            require_native(f"[11a] {mode} {tag}", got)
            frames_close(f"[11a] {mode} {tag}", got, want)
            if DEV == "cuda" and n != expected:
                raise AssertionError(f"[11a] {mode} {tag}: {n} hist kernel launches, "
                                     f"expected {expected}")
            print(f"[11a] {mode} {x.shape[0]} x 2046 x {WIDTHS_SHAPE[2]}, batch_size=1024, "
                  f"{tag}: frame equals "
                  f"the CPU frame (U equal, p rtol 1e-12, fc rtol 1e-6); "
                  f"{got.attrs['consume_path']['native']} tiles all native; {n} hist kernel "
                  f"launches", flush=True)
    sync()
    he.hist_pass.launches = 0
    t0 = time.perf_counter()
    df = asymptotic_wilcoxon_arrays(x, labels, reference="g0", progress=False,
                                    **({} if DEV == "cuda" else {"device": DEV}))
    wall = time.perf_counter() - t0
    n = launches["OVO 8190 defaults"] = he.hist_pass.launches
    require_native("[11a] 8,190 genes", df)
    if df.attrs["engine"] != "hist" or df.attrs["consume_path"]["native"] != 4:
        raise AssertionError(f"[11a] 8,190 genes: engine {df.attrs['engine']}, consume "
                             f"path {df.attrs['consume_path']}, expected 4 hist tiles")
    if DEV == "cuda" and n != 1 + 4:
        raise AssertionError(f"[11a] 8,190 genes: {n} hist kernel launches, expected 5")
    scipy_check("[11a] 8,190 genes", df, x, labels, "g0", False, pairs)
    print(f"[11a] OVO {x.shape[0]} x {x.shape[1]} x {WIDTHS_SHAPE[2]} with every default: "
          f"4 tiles (the last 2046 columns), all native, {n} hist kernel launches, "
          f"{len(pairs)} pairs match scipy; "
          f"{wall:.3f} s", flush=True)
    stats["widths"] = dict(launches=launches, wall_8190_s=wall)


def device_counts(n_cells, n_genes, density=0.1, seed=SEED + 9):
    """float32 counts made on the device from a seeded ``torch.Generator``:
    ~(1 - density) zeros, nonzeros 1 + Poisson(lam_gene), lam_gene in
    [0.5, 5)."""
    import torch

    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    lam = 0.5 + 4.5 * torch.rand(n_genes, generator=gen, device=DEV)
    x = torch.empty((n_cells, n_genes), dtype=torch.float32, device=DEV)
    for j0 in range(0, n_genes, 256):
        j1 = min(j0 + 256, n_genes)
        nz = torch.rand((n_cells, j1 - j0), generator=gen, device=DEV) < density
        vals = 1.0 + torch.poisson(lam[j0:j1].expand(n_cells, j1 - j0), generator=gen)
        x[:, j0:j1] = torch.where(nz, vals, 0.0)
    return x


def phase_published(stats, shape=PUBLISHED_SHAPE, n_pairs=50):
    """11c: one OVO call at the published width, on a CUDA tensor."""
    import torch

    from illico_tpu_torch import asymptotic_wilcoxon_arrays
    from illico_tpu_torch.ops import hist_engine as he

    n_cells, n_genes, n_groups = shape
    rng = np.random.default_rng(SEED + 9)
    t0 = time.perf_counter()
    xd = device_counts(n_cells, n_genes)
    codes = rng.integers(1, n_groups, n_cells)
    codes[rng.random(n_cells) < 0.1] = 0
    labels = np.where(codes == 0, "non-targeting", np.char.add("pert_", codes.astype(str)))
    sync()
    zeros = 1.0 - float((xd != 0).sum()) / xd.numel()
    print(f"[11c] data {n_cells} x {n_genes} float32 made on {xd.device} "
          f"({xd.numel() * 4 / 1e9:.2f} GB), {n_groups} groups, {zeros:.3f} zeros, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    he.hist_pass.launches = 0
    t0 = time.perf_counter()
    df = asymptotic_wilcoxon_arrays(xd, labels, reference="non-targeting", progress=False,
                                    **({} if DEV == "cuda" else {"device": DEV}))
    wall = time.perf_counter() - t0
    launches = he.hist_pass.launches
    n_tiles = -(-n_genes // 2048)
    rec = {
        "wall_s": wall, "tests_per_s": n_groups * n_genes / wall,
        "engine": df.attrs["engine"], "consume_path": df.attrs["consume_path"],
        "stage_s": df.attrs["stage_seconds"], "launches": launches,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else None,
    }
    print(f"[11c] OVO {n_cells} x {n_genes} x {n_groups}, CUDA tensor, engine=auto: "
          f"{json.dumps(rec)}", flush=True)
    if df.attrs["engine"] != "hist" or df.shape != (n_groups * n_genes, 3):
        raise AssertionError(f"[11c] engine {df.attrs['engine']}, shape {df.shape}")
    if not np.isfinite(df.p_value.values).all():
        raise AssertionError("[11c] non-finite p-values")
    require_native("[11c]", df)
    if df.attrs["consume_path"]["native"] != n_tiles:
        raise AssertionError(f"[11c] {df.attrs['consume_path']} tiles, expected {n_tiles}")
    if DEV == "cuda" and launches != 1 + n_tiles:
        raise AssertionError(f"[11c] {launches} hist kernel launches, expected {1 + n_tiles}")
    groups = np.unique(labels[labels != "non-targeting"])
    pairs = [(str(g), int(j)) for g, j in zip(
        groups[rng.integers(0, groups.size, n_pairs)],
        np.concatenate([[n_genes - 1], rng.integers(0, n_genes, n_pairs - 1)]),
    )]
    genes = sorted({j for _, j in pairs})
    host = xd[:, genes].cpu().numpy()
    scipy_check("[11c]", df, {j: host[:, i] for i, j in enumerate(genes)}, labels,
                "non-targeting", False, pairs)
    print(f"[11c] {len(pairs)} sampled (group, gene) pairs match scipy.stats.mannwhitneyu "
          f"on host copies of their columns", flush=True)

    # K1 alone on the call's tiles: a full 2,048-column one, timed, and the
    # short last one held against its plain version.
    info, layout = layout_for(labels, "non-targeting")
    arrs = he.prepare_hist_inputs(layout, 128, False, DEV)
    args = (arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"])
    full = xd[:, :2048].contiguous()
    ms = cuda_ms(lambda: he.hist_pass(full, *args, is_log1p=False), reps=10) \
        if DEV == "cuda" else None
    del full
    last = xd[:, (n_tiles - 1) * 2048:].contiguous()
    got = he.hist_pass(last, *args, is_log1p=False)
    want = he.hist_pass_plain(last, *args, is_log1p=False)
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"[11c] kernel != plain on the last tile: max |diff| {err}")
    print(f"[11c] hist kernel on one full 2,048-column tile: {ms} ms (mean of 10); on the "
          f"last {last.shape[1]}-column tile kernel == plain", flush=True)
    del got, want, last, xd
    stats["published"] = dict(rec, kernel_ms=ms)
    stats["max_abs_err"] = max(stats.get("max_abs_err", 0.0), err)


# Phase 12 draws its counts with the benchmark's generator and count model
# (``benchmarks_torch/datagen.py``, ``configs/k562_essential.json``), from
# its own seed.  The share of
# columns with a count past 511 that its draw must fall in:
FALLBACK_BAND = (0.005, 0.05)


def device_kernels(fn):
    """(name, ms) of every device kernel that one call of ``fn`` runs,
    from a ``torch.profiler`` Chrome trace of it (after one warm-up call)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = [(e["name"], e["dur"] / 1e3) for e in events
               if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise RuntimeError("the profiler's trace holds no kernel")
    return kernels


def top_device_kernels(fn, n=3):
    """The ``n`` device kernels that take most of one call of ``fn`` under
    ``torch.profiler``: [name, ms, share of the call's kernel time] each,
    from the profiler's Chrome trace (its kernel spans, summed by name)."""
    by_name: dict = {}
    for name, ms in device_kernels(fn):
        by_name[name] = by_name.get(name, 0.0) + ms
    total = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ms, ms / total] for name, ms in ranked] + [["all kernels", total, 1.0]]


def heavy_call(tag, X, labels, is_log1p, shape, route="device", path="fused"):
    """One timed OVO call of phase 12 through ``engine="auto"``, checked to
    run the histogram engine at V=512 with every main tile on the native
    tail, one grouped pass by the warm-up and one per tile (on ``path``, see
    :func:`read_launches`), and its tiles made where ``route`` says
    (``df.attrs["input_route"]``); returns the frame, its record and the
    sorted fallback columns."""
    import torch

    from benchmarks_torch.run import fallback_spy
    from illico_tpu_torch import asymptotic_wilcoxon_arrays
    from illico_tpu_torch.ops import hist_engine as he

    n_groups, n_genes = shape[2], shape[1]
    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_launches()
    he.hist_pass.v_buckets = None
    with fallback_spy() as seen:
        t0 = time.perf_counter()
        df = asymptotic_wilcoxon_arrays(X, labels, is_log1p=is_log1p,
                                        reference="non-targeting", progress=False,
                                        **({} if DEV == "cuda" else {"device": DEV}))
        wall = time.perf_counter() - t0
    cols = np.sort(np.concatenate(seen)) if seen else np.empty(0, np.int64)
    n_tiles = df.attrs["consume_path"]["native"]
    rec = {
        "wall_s": wall, "tests_per_s": n_groups * n_genes / wall,
        "engine": df.attrs["engine"], "v_buckets": he.hist_pass.v_buckets,
        "input_route": df.attrs["input_route"],
        "launches": he.hist_pass.launches,
        "by_kernel": read_launches(tag, 1 + n_tiles, path=path, contractions=1 + n_tiles),
        "tiles": n_tiles,
        "n_fallback_cols": df.attrs["n_fallback_cols"],
        "tail_threads": df.attrs["tail_threads"],
        "stage_s": df.attrs["stage_seconds"], "consume_path": df.attrs["consume_path"],
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else None,
    }
    print(f"{tag}: {json.dumps(rec)}", flush=True)
    if rec["engine"] != "hist" or rec["v_buckets"] != he.MAX_V:
        raise AssertionError(f"{tag}: engine {rec['engine']} at V={rec['v_buckets']}, "
                             f"expected hist at V={he.MAX_V}")
    if df.shape != (n_groups * n_genes, 3) or not np.isfinite(df.p_value.values).all():
        raise AssertionError(f"{tag}: shape {df.shape} or non-finite p")
    require_native(tag, df)
    if rec["input_route"] != route:
        raise AssertionError(f"{tag}: input route {rec['input_route']}, expected {route}")
    if cols.size != rec["n_fallback_cols"]:
        raise AssertionError(f"{tag}: {cols.size} columns reached the fallback, the frame "
                             f"says {rec['n_fallback_cols']}")
    return df, rec, cols


def k1_alone(tag, tile, layout, v_buckets):
    """K1 alone on a contiguous tile with a layout's groups at table size
    ``v_buckets``: bit for bit against its plain version, then (on CUDA) its
    time, the plain version's and ``torch.bincount``'s beside the byte
    bound.  Returns the record."""
    import torch

    from illico_tpu_torch.ops import hist_engine as he

    arrs = he.prepare_hist_inputs(layout, v_buckets, False, tile.device)
    args = (arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"])
    n_groups, t_cols = layout.n_groups, tile.shape[1]
    got = he.hist_pass(tile, *args, is_log1p=False)
    want = he.hist_pass_plain(tile, *args, is_log1p=False)
    sync()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{tag} V={v_buckets}: kernel != plain, max |diff| {err}")
    del got, want
    nbytes = (tile.numel() * tile.element_size() + n_groups * v_buckets * t_cols * 4
              + sum(a.numel() * a.element_size() for a in args))
    rec = {"max_abs_err": err, "bound_ms": nbytes / H100_BYTES_PER_S * 1e3}
    if DEV == "cuda":
        rec["ms"] = cuda_ms(lambda: he.hist_pass(tile, *args, is_log1p=False), reps=10)
        rec["plain_ms"] = cuda_ms(lambda: he.hist_pass_plain(tile, *args, is_log1p=False),
                                  reps=2)
        # torch.bincount over the flattened (g*V + v)*T + j keys of the
        # tabulated values: one library call computing the same counts
        # (int64), the yardstick only.
        rows = tile.index_select(0, args[0].long())
        grp = torch.repeat_interleave(torch.arange(n_groups, device=tile.device),
                                      torch.diff(args[1]))
        keys = ((grp[:, None] * v_buckets + rows.long()) * t_cols
                + torch.arange(t_cols, device=tile.device))[rows < v_buckets]
        del rows, grp
        rec["library_ms"] = cuda_ms(
            lambda: torch.bincount(keys, minlength=n_groups * v_buckets * t_cols), reps=3)
        del keys
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    print(f"{tag} hist kernel alone, V={v_buckets}, {tile.shape[0]} x {t_cols} tile, "
          f"{n_groups} groups: kernel == plain; {json.dumps(rec)} (bound by bytes: "
          f"{nbytes / 1e9:.2f} GB)", flush=True)
    return rec


def contract_check(tag, hist, ppg, kw):
    """``hist_contract`` (the kernels on a CUDA histogram) against
    ``hist_contract_plain`` on the same histogram: every output equal, bit
    for bit (every statistic here is an integer below 2^53, or OVR's
    tie_col, the same torch expression in both).  Returns the kernels'
    launches and the outputs' bytes."""
    import torch

    from illico_tpu_torch.ops import hist_engine as he

    before = he.hist_contract.launches
    got = he.hist_contract(hist, ppg, **kw)
    launches = he.hist_contract.launches - before
    want = he.hist_contract_plain(hist, ppg, **kw)
    sync()
    if got.keys() != want.keys():
        raise AssertionError(f"{tag}: kernel outputs {sorted(got)} != plain {sorted(want)}")
    for key, w in want.items():
        if not torch.equal(got[key], w):
            diff = float((got[key].double() - w.double()).abs().max())
            raise AssertionError(f"{tag}: contraction kernel != plain in {key}, "
                                 f"max |diff| {diff}")
    nbytes = sum(t.numel() * t.element_size() for t in want.values())
    return launches, nbytes


def contract_alone(tag, hist, ppg, kw):
    """The contraction alone on one histogram: the kernels bit for bit
    against the plain version, the kernels' launches and every device
    kernel of one call (the torch steps around them included), then (on
    CUDA) its time by CUDA events beside the plain version's and the
    bound.  The bound counts the histogram read once and the outputs
    written once at 3.35 TB/s, against the float64 operations this
    histogram's nonzero counts need at 34 TFLOP/s (OVO 14 a count: fc 2,
    k 1, U2 2, tie 9; OVR 6: R2 2, fc 2, k 1, c 1).  Returns the record."""
    import torch

    from illico_tpu_torch.ops import hist_engine as he

    launches, out_bytes = contract_check(tag, hist, ppg, kw)
    hist_bytes = hist.numel() * hist.element_size()
    ops = int(torch.count_nonzero(hist)) * (6 if kw["ref_code"] == -1 else 14)
    bytes_ms = (hist_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP64_PER_S * 1e3
    rec = {"max_abs_err": 0.0, "launches": launches, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms}
    if DEV == "cuda":
        kernels = device_kernels(lambda: he.hist_contract(hist, ppg, **kw))
        rec["device_kernels"] = len(kernels)
        own = {}
        for name, ms in kernels:
            for stem in ("contract_kernel", "value_counts_kernel"):
                if stem in name:
                    own[stem] = own.get(stem, 0.0) + ms
        rec["kernel_ms"] = sum(own.values())
        rec["kernels_ms"] = own
        rec["ms"] = cuda_ms(lambda: he.hist_contract(hist, ppg, **kw), reps=10)
        rec["plain_ms"] = cuda_ms(lambda: he.hist_contract_plain(hist, ppg, **kw), reps=2)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    print(f"{tag} contraction alone, histogram {tuple(hist.shape)} "
          f"({hist_bytes / 1e9:.2f} GB): kernels == plain; {json.dumps(rec)}", flush=True)
    return rec


# name -> (OVO?, statics beyond ref_code); "big" is the largest group's code,
# "ref" the reference's (the variants of tests/test_torch_contract_cuda.py).
FUSED_VARIANTS = {
    "ovr": (False, {}),
    "ovr_row_splits": (False, {"u2_split_code": "big", "fc_split_code": "big"}),
    "ovo": (True, {}),
    "ovo_fc_split": (True, {"fc_split_code": "big"}),
    "ovo_nnz_split": (True, {"nnz_split": True}),
    "ovo_nnz_split_fc_u8": (True, {"nnz_split": True, "fc_u8": True, "fc_split_code": "ref"}),
}


def fused_variants_check(tag, x, labels, is_log1p, v_buckets):
    """On one tile at one table size: ``row_counts_kernel`` bit for bit
    against its plain version and against K1's histogram (the reference's
    row in OVO, the sum over groups in OVR), then the fused pass in every
    variant of ``FUSED_VARIANTS`` against its plain version and K1 +
    ``hist_contract`` (:func:`fused_check`)."""
    import torch

    from illico_tpu_torch.ops import hist_engine as he

    for ovo, ref in ((False, None), (True, "non-targeting")):
        info, layout = layout_for(labels, ref)
        arrs = he.prepare_hist_inputs(layout, v_buckets, is_log1p, x.device)
        args = (arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"])
        hist = he.hist_pass(x, *args, is_log1p=is_log1p)
        rows = he.counting_rows(he.real_rows_per_group(layout), arrs["perm"],
                                info.ref_code)
        got = he.row_counts(x, rows, args[3], is_log1p=is_log1p)
        want = he.row_counts_plain(x, rows, args[3], is_log1p=is_log1p)
        from_hist = hist[info.ref_code].double() if ovo else he._value_counts_plain(hist)
        sync()
        if not (torch.equal(got, want) and torch.equal(got, from_hist)):
            raise AssertionError(f"{tag} V={v_buckets} log1p={is_log1p}: row counts "
                                 f"!= plain or != K1's histogram ({'OVO' if ovo else 'OVR'})")
        codes = {"big": int(np.argmax(he.real_rows_per_group(layout))), "ref": info.ref_code}
        for name, (mode, extra) in FUSED_VARIANTS.items():
            if mode != ovo:
                continue
            kw = {k: codes.get(v, v) if isinstance(v, str) else v for k, v in extra.items()}
            kw.update(n_pad=float(layout.n_pad), ref_code=info.ref_code)
            fused_check(f"{tag} V={v_buckets} log1p={is_log1p} {name}", x, args, arrs["ppg"],
                        rows, is_log1p, kw, hist=hist)
        del hist


def with_empty_group(arrs):
    """K1's arrays of ``prepare_hist_inputs`` with one more group, of no
    rows, last (the runner's layouts never have one; the kernels must still
    write its zeros)."""
    import torch

    indptr = torch.cat([arrs["indptr"], arrs["indptr"][-1:]])
    sizes = torch.diff(indptr).cpu().numpy()
    order = torch.from_numpy(np.argsort(-sizes, kind="stable").astype(np.int32))
    return {**arrs, "indptr": indptr, "order": order.to(indptr.device),
            "ppg": torch.cat([arrs["ppg"], arrs["ppg"].new_zeros(1)])}


def skewed_labels(n_cells, seed=SEED + 12):
    """Labels of a skewed screen: one group of 40% of the cells, the
    "non-targeting" reference of 10%, 300 groups of 1-3 cells and the rest
    in groups of ~135, shuffled."""
    rng = np.random.default_rng(seed)
    sizes = [2 * n_cells // 5, n_cells // 10, *rng.integers(1, 4, 300)]
    rest = n_cells - sum(sizes)
    sizes += [135] * (rest // 135) + ([rest % 135] if rest % 135 else [])
    names = ["big", "non-targeting", *(f"p{i}" for i in range(len(sizes) - 2))]
    return rng.permutation(np.repeat(np.array(names), sizes))


def fused_alone(tag, tile, labels, ref, v_buckets, empty_group=False):
    """The fused pass alone on one tile with the runner's statics at table
    size ``v_buckets`` (``empty_group``: one more group of no rows, and the
    pass first held bit for bit to its plain version and to K1 +
    ``hist_contract`` by :func:`fused_check`): each kernel's time by CUDA
    events (the call of its wrapper, mean of 10) beside its plain version's
    and its bound, the whole pass's time (counting, tables, kernel, (G, T)
    steps) beside the histogram path's (K1 + ``hist_contract``) and the
    plain pass's, and the device kernels of one pass from
    ``torch.profiler``.  Bounds: the bytes each kernel must move at 3.35
    TB/s (its rows read once, its inputs and outputs once), against the
    float64 operations of this tile's nonzero (group, value, column) counts
    at 34 TFLOP/s (OVO 14 a count, OVR 6, as 12e).  The fused kernel reads
    the rows of every group but OVO's reference, whose counts it takes from
    the counting pass (``bound_ms``); ``bound_ms_all_rows`` counts every
    real row and no reference counts, as a pass that reads the reference's
    rows would.  ``row_counts`` is held beside ``torch.bincount`` of the
    same tabulated keys (int64).  Returns the record."""
    import torch

    from illico_tpu_torch.ops import hist_engine as he

    info, layout = layout_for(labels, ref)
    statics = he.hist_contract_statics(layout, info.ref_code, v_buckets)
    kw = {k: v for k, v in statics.items() if k != "compute_fc"}
    kw["n_pad"] = float(layout.n_pad)
    arrs = he.prepare_hist_inputs(layout, v_buckets, False, tile.device)
    if empty_group:
        arrs = with_empty_group(arrs)
    args = (arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"])
    ppg, table = arrs["ppg"], arrs["table"]
    real = np.diff(arrs["indptr"].cpu().numpy())
    rows = he.counting_rows(real, arrs["perm"], info.ref_code)
    work = he.fused_work(real, info.ref_code)
    n_groups, t_cols = real.size, tile.shape[1]
    n_real = int(arrs["perm"].numel())
    hist = he.hist_pass(tile, *args, is_log1p=False)
    if empty_group:
        fused_check(f"{tag} V={v_buckets}", tile, args, ppg, rows, False, kw, hist=hist)
    nonzero = int(torch.count_nonzero(hist))
    del hist
    ovo = info.ref_code != -1
    captured = {}
    counts = he.row_counts(tile, rows, table, is_log1p=False)

    def capture(tab, a, **sums_kw):
        captured.update(tab=tab, a=a, kw=sums_kw)
        return he._grouped_sums_cuda(tile, *args, tab, a, is_log1p=False, work=work,
                                     ref_counts=counts, **sums_kw)

    he._contract_counts(counts, capture, ppg, **kw)
    tab, a, sums_kw = captured["tab"], captured["a"], captured["kw"]
    outs = he._grouped_sums_cuda(tile, *args, tab, a, is_log1p=False, work=work,
                                 ref_counts=counts, **sums_kw)
    out_bytes = sum(t.numel() * t.element_size() for t in outs if t is not None)
    small = sum(t.numel() * t.element_size() for t in args[1:])
    f64 = 8
    tables = (1 if a is None else 2) * v_buckets * t_cols * f64
    read_rows = n_real - (int(rows.numel()) if ovo else 0)
    kernel_bytes = (read_rows * (t_cols * 4 + 4) + small + tables + out_bytes
                    + (v_buckets * t_cols * f64 if ovo else 0))
    all_rows_bytes = n_real * t_cols * 4 + n_real * 4 + small + tables + out_bytes
    count_bytes = rows.numel() * (t_cols * 4 + 4) + v_buckets * 4 + v_buckets * t_cols * f64
    bytes_ms = kernel_bytes / H100_BYTES_PER_S * 1e3
    ops_ms = nonzero * (14 if ovo else 6) / H100_FP64_PER_S * 1e3
    fused = {"bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "bound_ms_all_rows": max(all_rows_bytes / H100_BYTES_PER_S * 1e3, ops_ms),
             "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms, "nonzero_counts": nonzero,
             "rows_read": read_rows, "split_groups": work.n_slots,
             "split_chunks": sum(work.split_parts)}
    counts_rec = {"bound_ms": count_bytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
                  "rows": int(rows.numel())}
    rec = {"row_counts": counts_rec, "fused": fused, "statics": kw}
    if DEV == "cuda":
        counts_rec["ms"] = cuda_ms(lambda: he.row_counts(tile, rows, table, is_log1p=False),
                                   reps=10)
        counts_rec["plain_ms"] = cuda_ms(
            lambda: he.row_counts_plain(tile, rows, table, is_log1p=False), reps=3)
        vals = tile.index_select(0, rows.long())
        keys = (vals.long() * t_cols + torch.arange(t_cols, device=tile.device))[
            vals < v_buckets]
        del vals
        counts_rec["library_ms"] = cuda_ms(
            lambda: torch.bincount(keys, minlength=v_buckets * t_cols), reps=3)
        del keys
        fused["ms"] = cuda_ms(lambda: he._grouped_sums_cuda(
            tile, *args, tab, a, is_log1p=False, work=work, ref_counts=counts, **sums_kw),
            reps=10)
        fused["plain_ms"] = cuda_ms(lambda: he._group_sums_plain(
            he.hist_pass_plain(tile, *args, is_log1p=False), tab, a, **sums_kw), reps=2)
        for r in (counts_rec, fused):
            r["bound_share"] = r["bound_ms"] / r["ms"]
        fused["bound_share_all_rows"] = fused["bound_ms_all_rows"] / fused["ms"]
        call = {"ms": cuda_ms(lambda: he.hist_pass_contract(
            tile, *args, ppg, count_rows=rows, is_log1p=False, work=work, **kw), reps=10)}
        call["histogram_path_ms"] = cuda_ms(lambda: he.hist_contract(
            he.hist_pass(tile, *args, is_log1p=False), ppg, **kw), reps=5)
        call["plain_ms"] = cuda_ms(lambda: he.hist_pass_contract_plain(
            tile, *args, ppg, count_rows=rows, is_log1p=False, **kw), reps=2)
        kernels = device_kernels(lambda: he.hist_pass_contract(
            tile, *args, ppg, count_rows=rows, is_log1p=False, work=work, **kw))
        call["device_kernels"] = len(kernels)
        by_name: dict = {}
        for name, ms in kernels:
            by_name[name] = by_name.get(name, 0.0) + ms
        call["top_kernels"] = [[name[:100], ms] for name, ms in
                               sorted(by_name.items(), key=lambda kv: -kv[1])[:4]]
        for stem, r in (("grouped_hist_contract_kernel", fused),
                        ("row_counts_kernel", counts_rec)):
            hits = [ms for name, ms in kernels if stem in name]
            r["kernel_ms"] = sum(hits) if hits else None  # None: the trace lost it
        rec["call"] = call
    print(f"{tag} fused pass alone, V={v_buckets}, {tile.shape[0]} x {t_cols} tile, "
          f"{n_groups} groups ({rows.numel()} counting rows): {json.dumps(rec)}", flush=True)
    return rec


@contextlib.contextmanager
def histogram_path():
    """Inside the block the runner's single-device tile function takes the
    histogram path through ``make_hist_tile_fn``'s ``hist_fn`` hook: K1's
    (G, V, T) histogram, then ``hist_contract`` of it."""
    from illico_tpu_torch.ops import hist_engine as he

    make = he.make_hist_tile_fn

    def with_histogram(layout, *, device, is_log1p, v_buckets=he.DEFAULT_V, **kw):
        arrs = he.prepare_hist_inputs(layout, v_buckets, is_log1p, device)
        args = (arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"])

        def hist_fn(x, mark):
            hist = he.hist_pass(x, *args, is_log1p=is_log1p)
            if mark is not None:
                mark("kernel")
            return hist

        return make(layout, device=device, is_log1p=is_log1p, v_buckets=v_buckets,
                    hist_fn=hist_fn, **kw)

    with mock.patch.object(he, "make_hist_tile_fn", with_histogram):
        yield


def phase_heavy_tailed(stats, shape=PUBLISHED_SHAPE, n_pairs=50):
    """12: the heavy-tailed count screen at the published width: (a) raw
    counts on a CUDA tensor, (d) K1 alone at V=256 and V=512, (b) the same
    counts as an in-RAM CSR, (c) their numpy float32 log1p as a CSR."""
    import torch

    from benchmarks_torch.datagen import heavy_tailed_counts, host_csr, perturbation_labels
    from benchmarks_torch.run import load_config
    from illico_tpu_torch import asymptotic_wilcoxon_arrays, native
    from illico_tpu_torch.models import wilcoxon
    from illico_tpu_torch.ops import hist_engine as he
    from illico_tpu_torch.ops.hist_engine import MAX_V
    from illico_tpu_torch.ops.rank_engine import make_tile_fn
    from illico_tpu_torch.utils.memory import host_tile_budget
    from illico_tpu_torch.utils.registry import DeviceSparseDataHandler, data_handler_registry

    n_cells, n_genes, n_groups = shape
    t_sub = t0 = time.perf_counter()
    model = load_config("k562_essential")["counts"]  # the benchmark's count model
    xd = heavy_tailed_counts(n_cells, n_genes, model, seed=SEED + 10, device=DEV)
    labels = perturbation_labels(n_cells, n_groups, seed=SEED + 10)
    rng = np.random.default_rng([SEED + 10, 1])  # the checked pairs
    col_max = xd.amax(dim=0).cpu().numpy()
    zeros = 1.0 - float((xd != 0).sum()) / xd.numel()
    past = np.flatnonzero(col_max >= MAX_V)  # counts no table holds: the fallback
    upper = np.flatnonzero((col_max >= 128) & (col_max <= 510))
    print(f"[12] data {n_cells} x {n_genes} float32 made on {xd.device} "
          f"({xd.numel() * 4 / 1e9:.2f} GB), {n_groups} groups, {zeros:.4f} zeros, "
          f"{past.size} columns with a count past {MAX_V - 1} ({past.size / n_genes:.4f}), "
          f"{upper.size} with a maximum in 128-510, largest count {col_max.max():.0f}, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    lo, hi = FALLBACK_BAND
    if not lo * n_genes <= past.size <= hi * n_genes:
        raise AssertionError(f"[12] {past.size} columns past the table, outside the "
                             f"calibrated band {FALLBACK_BAND} of {n_genes}")
    # 50 (group, gene) pairs: 15 on fallback columns, 15 on columns whose
    # maximum is in the table's upper part, the rest anywhere.
    groups = np.unique(labels[labels != "non-targeting"])
    genes = np.concatenate([rng.choice(past, 15), rng.choice(upper, 15),
                            rng.integers(0, n_genes, n_pairs - 30)])
    pairs = [(str(g), int(j)) for g, j in zip(groups[rng.integers(0, groups.size, n_pairs)],
                                              genes)]
    picked = sorted({j for _, j in pairs})
    host = xd[:, picked].cpu().numpy()
    raw_cols = {j: host[:, i] for i, j in enumerate(picked)}

    # -- 12a: raw counts, CUDA tensor -----------------------------------------
    with environ("ILLICO_TPU_TAIL_THREADS", None):  # the default thread count
        df_a, rec_a, cols_a = heavy_call("[12a] raw counts, CUDA tensor", xd, labels, False,
                                         shape)
    n_tiles = -(-n_genes // 2048)
    if rec_a["tiles"] != n_tiles:
        raise AssertionError(f"[12a] {rec_a['tiles']} tiles, expected {n_tiles}")
    if not set(past) <= set(cols_a) or not lo * n_genes <= cols_a.size <= hi * n_genes:
        raise AssertionError(f"[12a] fallback columns {cols_a.size}: expected every column "
                             f"past the table ({past.size}), within {FALLBACK_BAND}")
    scipy_check("[12a]", df_a, raw_cols, labels, "non-targeting", False, pairs)
    # The tail at one thread beside the default count, bit-equal; then where
    # the tails ran against the card, from one profiled call.
    with environ("ILLICO_TPU_TAIL_THREADS", 1):
        df_1, rec_1, _ = heavy_call("[12a] raw counts, CUDA tensor, tail_threads=1", xd,
                                    labels, False, shape)
    if not np.array_equal(df_1.values.view(np.uint64), df_a.values.view(np.uint64)):
        raise AssertionError("[12a] the frame at one tail thread differs from the default's")
    del df_1
    print(f"[12a] tail {rec_a['stage_s']['tail']:.4f} s, wall {rec_a['wall_s']:.4f} s at the "
          f"default {rec_a['tail_threads']} threads; tail {rec_1['stage_s']['tail']:.4f} s, "
          f"wall {rec_1['wall_s']:.4f} s at 1 thread; frames bit-equal", flush=True)
    overlap = None
    if DEV == "cuda":
        from tail_overlap import profiled_call

        profile_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "illico_tpu_torch", "_build", "profile")
        asymptotic_wilcoxon_arrays(xd[:2000, :8].contiguous(), labels[:2000],  # start-up
                                   reference=None, progress=False, profile_dir=profile_dir)
        with environ("ILLICO_TPU_TAIL_THREADS", None):
            df_p, wall_p, overlap = profiled_call(xd, labels, "non-targeting", profile_dir)
        if not np.array_equal(df_p.values.view(np.uint64), df_a.values.view(np.uint64)):
            raise AssertionError("[12a] the profiled call's frame differs")
        del df_p
        tiles = overlap["tiles"]
        print(f"[12a] profiled call ({wall_p:.4f} s): the first tail starts at "
              f"{tiles[0]['tail_start_s']:.4f} s, the last tile's contraction ends on the card "
              f"at {tiles[-1]['contract_device_end_s']:.4f} s (lead "
              f"{overlap['first_tail_lead_s']:.4f} s); the card busy "
              f"{overlap['tail_device_busy_share']:.4f} of the tails' "
              f"{overlap['tail_host_s']:.4f} s; {overlap['launch']['n']} launches held the "
              f"host {overlap['launch']['host_s']:.4f} s (longest "
              f"{overlap['launch']['max_ms']:.3f} ms); per tile: "
              f"{json.dumps(tiles)}", flush=True)
    # Fallback chunks alone: the sort engine's packed tile function on the
    # card, as the fallback calls it, at the fallback's 128-column width and
    # at the sort engine's 512-column cap (the fallback columns, then those
    # with the next largest maxima); the wide chunk's statistics held equal
    # to the same tile function's on the CPU, and the device kernels that
    # take most of one 128-column chunk.
    info, layout = layout_for(labels, "non-targeting")
    fns = {dev: make_tile_fn(layout, ref_code=info.ref_code, is_log1p=False, device=dev,
                             pack=True) for dev in {DEV, "cpu"}}
    hot = np.argsort(-col_max, kind="stable")
    wide = np.concatenate([cols_a, hot[~np.isin(hot, cols_a)]])[:512]
    chunk_ms, top = {}, []
    for width in (128, 512):
        chunk = xd.index_select(1, torch.from_numpy(wide[:width]).to(DEV))
        if DEV == "cuda":
            chunk_ms[width] = cuda_ms(lambda: fns[DEV](chunk), reps=3)
            if width == 128:
                top = top_device_kernels(lambda: fns[DEV](chunk))
    got = fns[DEV].unpack(fns[DEV](chunk).cpu().numpy())
    want = fns["cpu"].unpack(fns["cpu"](chunk.cpu()).numpy())
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=f"[12a] 512-column chunk {key}")
    del chunk, fns
    print(f"[12a] top device kernels of one 128-column chunk (name, ms, share of its "
          f"kernel time): {json.dumps(top)}", flush=True)
    print(f"[12a] {cols_a.size} fallback columns ({cols_a.size - past.size} besides those "
          f"past the table); chunks through the sort engine on the card: 128 columns "
          f"{chunk_ms.get(128)} ms, 512 columns {chunk_ms.get(512)} ms, the 512-column "
          f"chunk's statistics equal the CPU's; {len(pairs)} pairs match "
          f"scipy.stats.mannwhitneyu (15 on fallback columns, 15 with a maximum in "
          f"128-510); {time.perf_counter() - t_sub:.1f} s with the data", flush=True)

    # -- 12d: K1 alone at V=256 and V=512 on a full tile ----------------------
    t_sub = time.perf_counter()
    tile = xd[:, :2048].contiguous()
    k1 = {v: k1_alone("[12d]", tile, layout, v) for v in (256, 512)}
    print(f"[12d] {time.perf_counter() - t_sub:.1f} s", flush=True)

    # -- 12e: the contraction kernels alone on that tile's V=512 histogram ----
    # With the statics the runner derives: OVO with the nnz split (the
    # benchmark's path), OVO with it kept off, and OVR, whose R2 row split
    # takes the control.
    t_sub = time.perf_counter()
    contract = {}
    for name, ref, hint in (("ovo_nnz_split", "non-targeting", True),
                            ("ovo", "non-targeting", False), ("ovr_u2_split", None, True)):
        info_e, layout_e = layout_for(labels, ref)
        statics = he.hist_contract_statics(layout_e, info_e.ref_code, MAX_V,
                                           nnz_split_hint=hint)
        if statics["nnz_split"] != (name == "ovo_nnz_split") or (
                ref is None and statics["u2_split_code"] < 0):
            raise AssertionError(f"[12e] {name}: statics {statics} miss the variant")
        kw = {k: v for k, v in statics.items() if k != "compute_fc"}
        kw["n_pad"] = float(layout_e.n_pad)
        arrs = he.prepare_hist_inputs(layout_e, MAX_V, False, tile.device)
        hist = he.hist_pass(tile, arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"],
                            is_log1p=False)
        contract[name] = contract_alone(f"[12e] {name}", hist, arrs["ppg"], kw)
        del hist
    stats["contract_max_abs_err"] = 0.0
    print(f"[12e] {time.perf_counter() - t_sub:.1f} s", flush=True)

    # -- 12f: the fused pass on that tile --------------------------------------
    # Both kernels bit for bit against their plain versions and K1 +
    # hist_contract in every variant at V=128, 256 and 512, raw and numpy
    # float32 log1p; then timed at each V (the benchmark's OVO nnz split,
    # and OVR at V=512); then one OVO call on the histogram path (the
    # hist_fn hook) against 12a's fused call: frames equal, and the peak
    # device memory of each.
    t_sub = time.perf_counter()
    log_tile = torch.from_numpy(np.log1p(tile.cpu().numpy())).to(tile.device)
    for is_log1p, x in ((False, tile), (True, log_tile)):
        for v in (128, 256, 512):
            fused_variants_check("[12f]", x, labels, is_log1p, v)
    del log_tile
    print(f"[12f] row_counts_kernel and grouped_hist_contract_kernel == plain == K1 + "
          f"hist_contract in {len(FUSED_VARIANTS)} variants at V=128, 256, 512, raw and "
          f"log1p; {time.perf_counter() - t_sub:.1f} s", flush=True)
    timed = {f"ovo_nnz_split_v{v}": fused_alone("[12f] ovo_nnz_split", tile, labels,
                                                "non-targeting", v) for v in (128, 256, 512)}
    timed["ovr_v512"] = fused_alone("[12f] ovr", tile, labels, None, MAX_V)
    # A skewed screen on the same tile, one empty group added: held bit for
    # bit to plain and to K1 + hist_contract, then timed.
    skewed = skewed_labels(tile.shape[0])
    timed["skewed_ovo_v512"] = fused_alone("[12f] skewed ovo", tile, skewed, "non-targeting",
                                           MAX_V, empty_group=True)
    timed["skewed_ovr_v512"] = fused_alone("[12f] skewed ovr", tile, skewed, None, MAX_V,
                                           empty_group=True)
    del tile
    with histogram_path(), environ("ILLICO_TPU_TAIL_THREADS", None):
        df_h, rec_h, cols_h = heavy_call("[12f] raw counts, CUDA tensor, histogram path", xd,
                                         labels, False, shape, path="histogram")
    if not (df_h.index.equals(df_a.index) and np.array_equal(cols_h, cols_a)
            and np.array_equal(df_h.values.view(np.uint64), df_a.values.view(np.uint64))):
        raise AssertionError("[12f] the histogram path's frame differs from 12a's fused call")
    del df_h
    hist_gb = n_groups * MAX_V * min(2048, n_genes) * 4 / 1e9
    peaks = {"fused": rec_a["peak_device_gb"], "histogram": rec_h["peak_device_gb"]}
    fused = dict(timed=timed, peak_device_gb=peaks, histogram_path_launches=rec_h["by_kernel"],
                 histogram_path_wall_s=rec_h["wall_s"], fused_wall_s=rec_a["wall_s"])
    if DEV == "cuda" and peaks["histogram"] - peaks["fused"] < 0.9 * hist_gb:
        raise AssertionError(f"[12f] peak device memory {peaks}: the fused call should hold "
                             f"no (G, V, T) histogram ({hist_gb:.2f} GB)")
    print(f"[12f] one OVO call each: frames bit-equal; peak device memory {json.dumps(peaks)} "
          f"GB (one V=512 histogram: {hist_gb:.2f} GB); wall fused {rec_a['wall_s']:.4f} s, "
          f"histogram path {rec_h['wall_s']:.4f} s; {time.perf_counter() - t_sub:.1f} s",
          flush=True)

    # -- 12b: the same counts as an in-RAM CSR ---------------------------------
    t_sub = t0 = time.perf_counter()
    csr = host_csr(xd)
    del xd
    if DEV == "cuda":
        torch.cuda.empty_cache()
    print(f"[12b] CSR {csr.shape[0]} x {csr.shape[1]}, {csr.nnz} nonzeros, data "
          f"{csr.data.dtype}, indices {csr.indices.dtype}, made on the card and copied in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # Twice: as a user's call runs it (the copy fits the card: the device
    # route), then with the fit check refused (the host route, out of core).
    # Each call's CSR scans (the index check, the three sampled windows and
    # on the host route each tile) must take the native path.
    recs_b = {}
    with environ("ILLICO_TPU_HOST_BUDGET", None):  # the budget a user gets
        budget = host_tile_budget()
        for route in ("device", "host"):
            refuse = (mock.patch.object(wilcoxon, "_fits_on_device", lambda dev, nbytes: False)
                      if route == "host" else contextlib.nullcontext())
            native.csr_scan_calls.update(dict.fromkeys(native.csr_scan_calls, 0))
            with refuse:
                df_b, rec_b, cols_b = heavy_call(f"[12b] raw counts, in-RAM CSR, {route} route",
                                                 csr, labels, False, shape, route=route)
            rec_b["csr_scans"] = dict(native.csr_scan_calls)
            want = {"check_native": 1, "check_plain": 0,
                    "gather_native": 3 + (rec_b["tiles"] if route == "host" else 0),
                    "gather_plain": 0}
            if rec_b["csr_scans"] != want:
                raise AssertionError(f"[12b] {route} route: CSR scans {rec_b['csr_scans']}, "
                                     f"expected {want}")
            rec_b["unstaged_s"] = rec_b["wall_s"] - sum(rec_b["stage_s"].values())
            if not df_b.index.equals(df_a.index):
                raise AssertionError(f"[12b] {route} route: index differs from 12a's")
            np.testing.assert_array_equal(df_b.values, df_a.values,
                                          err_msg=f"[12b] {route} route vs [12a]")
            if not np.array_equal(cols_b, cols_a):
                raise AssertionError(f"[12b] {route} route: fallback columns differ from 12a's")
            recs_b[route] = rec_b
            del df_b
    st, sh = recs_b["device"]["stage_s"], recs_b["host"]["stage_s"]
    print(f"[12b] setup {st['setup']:.4f} s, unstaged {recs_b['device']['unstaged_s']:.4f} s "
          f"(device route); setup {sh['setup']:.4f} s, unstaged "
          f"{recs_b['host']['unstaged_s']:.4f} s (host route); CSR scans per call: device "
          f"{recs_b['device']['csr_scans']}, host {recs_b['host']['csr_scans']}", flush=True)
    # The staging costs alone.  Either route: the API's check that each
    # row's column indices are sorted (a pass over all of them) and the
    # runner's three sampled 24-column windows, each native (the package's
    # binary search per row, at the default thread count) and plain (numpy's
    # check, scipy's column slice), the windows bit-equal.  Host route: one
    # 2,048-column tile, native and plain, bit-equal, and one fallback chunk
    # of 128 columns (fancy column indexing of the whole CSR).  Device route:
    # the upload and column sort of the whole CSR, then the same tile and
    # chunk densified on the card.
    handler = data_handler_registry.get(csr)
    t0 = time.perf_counter()
    handler.validate()
    validate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    handler._validate_plain()
    validate_plain_s = time.perf_counter() - t0
    w = min(24, n_genes)
    starts = sorted({0, max(0, n_genes // 2 - w // 2), max(0, n_genes - w)})
    t0 = time.perf_counter()
    windows = [handler.fetch_tile(s, s + w) for s in starts]
    windows_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    windows_plain = [handler._fetch_tile_plain(s, s + w) for s in starts]
    windows_plain_s = time.perf_counter() - t0
    for s, got, want in zip(starts, windows, windows_plain):
        if not np.array_equal(got.view(np.uint8), want.view(np.uint8)):
            raise AssertionError(f"[12b] the native window at column {s} differs from plain")
    del windows, windows_plain
    t0 = time.perf_counter()
    tile_native = handler.fetch_tile(0, min(2048, n_genes))
    fetch_tile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tile_plain = handler._fetch_tile_plain(0, min(2048, n_genes))
    fetch_tile_plain_s = time.perf_counter() - t0
    if not np.array_equal(tile_native.view(np.uint8), tile_plain.view(np.uint8)):
        raise AssertionError("[12b] the native 2,048-column host tile differs from plain")
    del tile_native, tile_plain
    print(f"[12b] alone at {native.scan_threads()} scan threads: the index check native "
          f"{validate_s:.4f} s, plain {validate_plain_s:.4f} s; the three sampled windows "
          f"native {windows_s:.4f} s, plain {windows_plain_s:.4f} s, bit-equal; a "
          f"{min(2048, n_genes)}-column host tile native {fetch_tile_s:.4f} s, plain "
          f"{fetch_tile_plain_s:.4f} s, bit-equal", flush=True)
    t0 = time.perf_counter()
    handler.fetch_columns(cols_a[:128])
    fetch_columns_s = time.perf_counter() - t0
    on_card = DeviceSparseDataHandler(handler, DEV)
    sync()
    t0 = time.perf_counter()
    on_card.load()
    sync()
    load_s = time.perf_counter() - t0
    if DEV == "cuda":
        densify_tile_ms = cuda_ms(lambda: on_card.fetch_tile(0, min(2048, n_genes)), reps=5)
        densify_chunk_ms = cuda_ms(lambda: on_card.fetch_columns(cols_a[:128]), reps=5)
    else:
        densify_tile_ms = densify_chunk_ms = None
    on_card.release()
    del on_card
    print(f"[12b] both routes' frames equal 12a's bit for bit, same {cols_a.size} fallback "
          f"columns; device route: {recs_b['device']['tiles']} tiles, stages fetch "
          f"{st['fetch']:.3f} s, h2d {st['h2d']:.3f} s, kernel {st['kernel']:.3f} s, tail "
          f"{st['tail']:.3f} s, fallback {st['fallback']:.3f} s, peak "
          f"{recs_b['device']['peak_device_gb']} GB; host route (tile budget "
          f"{budget / 2**30:.2f} GiB): {recs_b['host']['tiles']} tiles, fetch "
          f"{sh['fetch']:.3f} s, h2d {sh['h2d']:.3f} s, kernel {sh['kernel']:.3f} s, tail "
          f"{sh['tail']:.3f} s, fallback {sh['fallback']:.3f} s, peak "
          f"{recs_b['host']['peak_device_gb']} GB; alone: host tile fetch "
          f"({min(2048, n_genes)} columns) {fetch_tile_s:.3f} s, host 128-column fallback "
          f"fetch {fetch_columns_s:.3f} s, device upload and column sort {load_s:.3f} s, "
          f"device tile {densify_tile_ms} ms, device 128-column chunk {densify_chunk_ms} ms, "
          f"the CSR's index check {validate_s:.3f} s; "
          f"{time.perf_counter() - t_sub:.1f} s", flush=True)

    # -- 12c: numpy float32 log1p of the same counts, CSR ----------------------
    t_sub = time.perf_counter()
    np.log1p(csr.data, out=csr.data)  # as scanpy does; the table is numpy's log1p too
    with environ("ILLICO_TPU_HOST_BUDGET", None):
        df_c, rec_c, cols_c = heavy_call("[12c] log1p counts, in-RAM CSR", csr, labels, True,
                                         shape)
    del csr
    if not df_c.index.equals(df_a.index):
        raise AssertionError("[12c] index differs from 12a's")
    np.testing.assert_array_equal(df_c.statistic.values, df_a.statistic.values,
                                  err_msg="[12c] U vs [12a]")
    np.testing.assert_array_equal(df_c.p_value.values, df_a.p_value.values,
                                  err_msg="[12c] p vs [12a]")
    if not np.array_equal(cols_c, cols_a):
        raise AssertionError("[12c] fallback columns differ from 12a's")
    log_cols = {j: np.log1p(col) for j, col in raw_cols.items()}
    scipy_check("[12c]", df_c, log_cols, labels, "non-targeting", True, pairs)
    print(f"[12c] U and p equal 12a's bit for bit, same {cols_c.size} fallback columns; fold "
          f"change of {len(pairs)} pairs within rtol 1e-6 of float64 numpy; "
          f"{time.perf_counter() - t_sub:.1f} s", flush=True)
    stats["heavy_tailed"] = dict(
        runs={"12a": rec_a, "12b": recs_b["device"], "12b_host": recs_b["host"], "12c": rec_c},
        k1=k1, contract=contract, zeros=zeros, fallback_chunk_ms=chunk_ms,
        fallback_chunk_top_kernels=top,
        past_table=int(past.size), upper_table=int(upper.size),
        fetch_tile_s=fetch_tile_s, fetch_columns_s=fetch_columns_s, device_load_s=load_s,
        validate_s=validate_s, validate_plain_s=validate_plain_s, windows_s=windows_s,
        windows_plain_s=windows_plain_s, fetch_tile_plain_s=fetch_tile_plain_s,
        device_tile_ms=densify_tile_ms, device_chunk_ms=densify_chunk_ms,
        launches={"12a": rec_a["launches"], "12b": recs_b["device"]["launches"],
                  "12b_host": recs_b["host"]["launches"], "12c": rec_c["launches"]},
        by_kernel={key: rec["by_kernel"] for key, rec in (
            ("12a", rec_a), ("12b", recs_b["device"]), ("12b_host", recs_b["host"]),
            ("12c", rec_c))},
        fused=fused,
    )
    stats["max_abs_err"] = max([stats.get("max_abs_err", 0.0)]
                               + [r["max_abs_err"] for r in k1.values()])


def kernels_record(stats) -> dict:
    """The kernels' JSON record from the phases' statistics: one entry per
    kernel with the keys the record's readers need, None where the phase
    that measures a number did not run."""
    sharded = stats.get("sharded", {}).get("launches", {})
    by_path = stats.get("sharded", {}).get("by_kernel", {})
    cell_mesh = by_path.get("cell_mesh", {})
    main_path = stats.get("launches") or {}
    heavy = stats.get("heavy_tailed", {})
    fused = heavy.get("fused", {})
    # Each kernel's "launches" is its count on its own path, from 0 just
    # before it: phase 5's four calls (one device: the counting and fused
    # kernels) and phase 10c's four (the cell mesh: K1 and the histogram's
    # contraction kernels).  The "passes_*" keys count grouped-histogram
    # passes (``hist_pass.launches``: K1 or the fused kernel) per path.
    kernel = {
        "name": "grouped_hist",
        "route": "cuda",
        "source": "illico_tpu_torch/csrc/hist_kernel.cu",
        "replaces": "illico_tpu/ops/hist_engine.py:80",
        "launches": cell_mesh.get("grouped_hist_kernel"),
        "passes_main_path": main_path.get("grouped_hist_contract_kernel"),
        "passes_device_input": stats.get("device_input", {}).get("launches", {}).get(
            "grouped_hist_contract_kernel"),
        # Phase 10, each path counted from 0 on its own: the gene-mesh and
        # cell-mesh API calls and the simulated hosts (passes_sharded is
        # their sum), then each of the two worker processes' own count.
        "passes_sharded": sum(sharded[k] for k in ("gene_mesh", "cell_mesh", "multihost"))
        if sharded else None,
        "passes_gene_mesh": sharded.get("gene_mesh"),
        "passes_cell_mesh": sharded.get("cell_mesh"),
        "passes_multihost": sharded.get("multihost"),
        "passes_multihost_processes": sharded.get("multihost_processes"),
        # Phase 11, each call counted from 0: 11a per call, 11c's call at
        # the published width.
        "passes_repaired_widths": stats.get("widths", {}).get("launches"),
        "passes_published_width": stats.get("published", {}).get("launches"),
        "ms_published_width": stats.get("published", {}).get("kernel_ms"),
        # Phase 12, each call counted from 0: the heavy-tailed screen on a
        # CUDA tensor (12a), as a CSR (12b) and its log1p as a CSR (12c); then
        # K1 alone on one full tile of it at V=256 and V=512 (12d).
        "passes_heavy_tailed": heavy.get("launches"),
        **{f"{key}_v{v}": heavy.get("k1", {}).get(v, {}).get(key)
           for v in (256, 512) for key in ("ms", "bound_ms", "plain_ms", "library_ms")},
        "max_abs_err": stats.get("max_abs_err"),
        "ms": stats.get("ms"),
        "plain_ms": stats.get("plain_ms"),
        "bound_ms": stats.get("bound_ms"),
        "bound_by": "bytes",
        "library_ms": stats.get("library_ms"),
    }
    contract = heavy.get("contract", {})
    main_contract = contract.get("ovo_nnz_split", {})  # the benchmark's variant
    contract_kernel = {
        "name": "hist_contract",
        "route": "cuda",
        "source": "illico_tpu_torch/csrc/hist_contract.cu",
        "replaces": "illico_tpu/ops/hist_engine.py:706",
        # Launches of contract_kernel and value_counts_kernel on the cell
        # mesh (phase 10c), counted from 0.
        "launches": cell_mesh.get("hist_contract_kernels"),
        # Phase 12e, one full tile's V=512 histogram: per variant the call's
        # time, the plain version's, the bound and its kind, the two
        # kernels' own time and every device kernel of one call.
        **{f"{key}_{name}": rec.get(key) for name, rec in contract.items()
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "kernel_ms",
                       "device_kernels", "launches")},
        "max_abs_err": stats.get("contract_max_abs_err"),
        "ms": main_contract.get("ms"),
        "plain_ms": main_contract.get("plain_ms"),
        "bound_ms": main_contract.get("bound_ms"),
        "bound_by": main_contract.get("bound_by", "bytes"),
        "library_ms": None,  # no one PyTorch call computes these statistics
    }
    # Phase 12f, one full tile: per table size the benchmark's OVO nnz split
    # (and OVR at V=512); the top-level numbers are V=512's OVO nnz split.
    timed = fused.get("timed", {})
    main_fused = timed.get("ovo_nnz_split_v512", {})
    fused_kernels = []
    for name, part, library in (("grouped_hist_contract", "fused", None),
                                ("row_counts", "row_counts", "torch.bincount")):
        fused_kernels.append({
            "name": name,
            "route": "cuda",
            "source": "illico_tpu_torch/csrc/hist_fused.cu",
            "replaces": "illico_tpu/ops/hist_engine.py:80",
            "launches": main_path.get(f"{name}_kernel"),
            "launches_device_input": stats.get("device_input", {}).get("launches", {}).get(
                f"{name}_kernel"),
            "launches_heavy_tailed": {key: rec.get(f"{name}_kernel")
                                      for key, rec in heavy.get("by_kernel", {}).items()},
            **{f"{key}_{case}": rec[part].get(key) for case, rec in timed.items()
               for key in ("ms", "plain_ms", "bound_ms", "bound_by", "kernel_ms",
                           "library_ms", "bound_ms_all_rows")},
            "max_abs_err": 0.0 if main_fused else None,  # fused_check raises on any difference
            "ms": main_fused.get(part, {}).get("ms"),
            "plain_ms": main_fused.get(part, {}).get("plain_ms"),
            "bound_ms": main_fused.get(part, {}).get("bound_ms"),
            "bound_by": main_fused.get(part, {}).get("bound_by", "bytes"),
            # torch.bincount of the tabulated keys beside row_counts; no one
            # PyTorch call computes the fused statistics.
            "library_ms": main_fused.get(part, {}).get("library_ms") if library else None,
        })
    fused_kernels[0].update({
        f"call_{key}_{case}": rec.get("call", {}).get(key) for case, rec in timed.items()
        for key in ("ms", "histogram_path_ms", "plain_ms", "device_kernels")})
    fused_kernels[0]["peak_device_gb"] = fused.get("peak_device_gb")
    return {"kernels": [kernel, contract_kernel, *fused_kernels]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12")
    parser.add_argument("--multihost-worker", nargs=4, help=argparse.SUPPRESS,
                        metavar=("ADDRESS", "RANK", "DEVICE", "OUT"))
    args = parser.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import illico_tpu_torch  # noqa: F401  (fails outside the repository)
    from benchmarks_torch.run import nvidia_smi_line

    if args.multihost_worker:
        address, rank, device, out = args.multihost_worker
        return multihost_worker(address, int(rank), device, out)

    smi = nvidia_smi_line()
    print(f"[1] device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    stats: dict = {}
    ctx: dict = {}  # the full-width matrix and host-input frames, shared by phases 5 and 9
    t0 = time.perf_counter()
    if 1 in phases:
        phase_build()
    if 2 in phases:
        phase_kernel(stats)
    if 3 in phases:
        phase_sort()
    if 4 in phases:
        phase_medium()
    if 5 in phases:
        phase_full(stats, ctx)
    if 9 in phases:  # before phase 7: it shares phase 5's matrix and frames
        phase_device_input(stats, ctx)
    if 10 in phases:  # so does phase 10
        phase_sharded(stats, ctx)
    ctx.clear()
    if 6 in phases:
        phase_csort()
    if 7 in phases:
        phase_normalized(stats)
    if 8 in phases:
        phase_wire(stats)
    if 11 in phases:
        phase_widths(stats)
        phase_published(stats)
    if 12 in phases:
        phase_heavy_tailed(stats)
    print(f"phases {sorted(phases)} passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(kernels_record(stats)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
