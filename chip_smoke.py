#!/usr/bin/env python3
"""Smoke test of illico_tpu_torch on one CUDA card: build, check, measure.

    python3 chip_smoke.py                 # all phases (needs one CUDA card)
    python3 chip_smoke.py --phases 1,2    # build and kernel check only

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit) and the nvcc build of
   every kernel in ``illico_tpu_torch/csrc``;
2. the histogram kernel (``csrc/hist_kernel.cu``) against its plain torch
   version on the card, bit for bit: V in {128, 256, 512}, raw and log1p
   tables, T=1000, 2000 groups including a 1-cell group, adversarial values
   (NaN, +-inf, -0.0, 0.5, -1, 511, 600, 1e30) and a uint8 tile;
3. the sort engine (``rank_stats_tile``) on the card against the same
   function on the CPU, OVO and OVR, raw and log1p;
4. the public API on the card at 20k cells x 300 genes x 50 groups, OVO and
   OVR, raw and log1p, with columns past the value table (the sort
   fallback must run), against ``scipy.stats.mannwhitneyu``: U exact, p
   within rtol 1e-12, fold change within rtol 1e-6;
5. the main path at full width: 300,000 cells x 2,048 genes x 2,000 groups
   (one auto tile; the K562-essential scale cut from 8,000 genes), dense
   float32 Poisson counts with ~90% zeros from a fixed numpy seed, one timed
   public-API call each for OVO and OVR, with the per-stage split and a
   scipy spot check; then the kernel's own time at that shape (CUDA events)
   beside its memory bound, its plain version and ``torch.bincount``.

Any failure raises and exits non-zero.  The last three lines are the
kernels' JSON record, the card's ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SEED = 0


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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
def phase_build():
    from illico_tpu_torch.utils.cuda_build import BUILD_INFO, SRC_DIR, build_libraries

    stems = sorted(p.stem for p in SRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    build_libraries(stems)
    print(f"[1] built {stems} in {time.perf_counter() - t0:.2f} s", flush=True)
    for stem in stems:
        for line in BUILD_INFO[stem]["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1]   {stem}: {line.strip()}")


def phase_kernel(stats):
    import torch

    from illico_tpu_torch.ops import hist_engine as he

    rng = np.random.default_rng(SEED)
    n_cells, t_cols, n_groups = 60_000, 1000, 2000
    labels = rng.integers(1, n_groups, n_cells)
    labels[rng.integers(n_cells)] = 0  # a 1-cell group
    _, layout = layout_for(labels)
    counts = poisson_counts(rng, n_cells, t_cols)
    adversarial = np.array(
        [np.nan, np.inf, -np.inf, -0.0, 0.5, -1.0, 511.0, 600.0, 1e30], np.float32
    )
    launches0 = he.hist_pass.launches
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
    # Narrow wire dtype: a uint8 tile is cast on the card.
    arrs = he.prepare_hist_inputs(layout, 128, False, "cuda")
    args = (arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"])
    x8 = torch.from_numpy(np.minimum(counts, 255).astype(np.uint8)).cuda()
    if not torch.equal(he.hist_pass(x8, *args, is_log1p=False),
                       he.hist_pass_plain(x8, *args, is_log1p=False)):
        raise AssertionError("kernel != plain on a uint8 tile")
    moved = he.hist_pass.launches - launches0
    if moved != 7:
        raise AssertionError(f"launch counter moved by {moved}, expected 7")
    print(f"[2] uint8 tile: kernel == plain; launch counter +{moved}", flush=True)
    stats["max_abs_err"] = worst


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
    """U exact, p rtol 1e-12, fc rtol 1e-6 against scipy on (group, gene) pairs."""
    from scipy.stats import mannwhitneyu

    for grp, j in pairs:
        col = x[:, j].astype(np.float64)
        tgt = col[labels == grp]
        rest = col[labels == ref] if ref is not None else col[labels != grp]
        u, p = mannwhitneyu(rest, tgt, method="asymptotic", use_continuity=True,
                            alternative="two-sided")
        if is_log1p:
            tgt, rest = np.expm1(tgt), np.expm1(rest)
        fc = tgt.mean() / rest.mean()
        row = df.loc[(str(grp), f"gene_{j}")]
        if row.statistic != u:
            raise AssertionError(f"{tag} ({grp}, {j}): U {row.statistic} != scipy {u}")
        np.testing.assert_allclose(row.p_value, p, rtol=1e-12, atol=0, err_msg=f"{tag} p ({grp}, {j})")
        np.testing.assert_allclose(row.fold_change, fc, rtol=1e-6, err_msg=f"{tag} fc ({grp}, {j})")


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
            scipy_check(tag, df, x, labels, reference, is_log1p, pairs)
            print(f"[4] {tag}: {wall:.2f} s, {df.attrs['n_fallback_cols']} "
                  f"sort-fallback columns, {len(pairs)} pairs match scipy", flush=True)


def phase_full(stats):
    import torch

    from illico_tpu_torch import asymptotic_wilcoxon_arrays
    from illico_tpu_torch.ops import hist_engine as he

    # One auto tile of 2048 columns: lift the host budget for in-flight
    # tiles (default 8 GiB at most) so it does not split the tile in two.
    os.environ["ILLICO_TPU_HOST_BUDGET"] = str(16 << 30)
    rng = np.random.default_rng(SEED + 3)
    n_cells, n_genes, n_groups = 300_000, 2048, 2000
    t0 = time.perf_counter()
    x = poisson_counts(rng, n_cells, n_genes)
    codes = rng.integers(1, n_groups, n_cells)
    codes[rng.random(n_cells) < 0.1] = 0  # control group, ~10% of cells
    labels = np.where(codes == 0, "non-targeting", np.char.add("pert_", codes.astype(str)))
    print(f"[5] data {n_cells} x {n_genes}, {n_groups} groups, "
          f"{np.mean(x == 0):.3f} zeros, made in {time.perf_counter() - t0:.1f} s", flush=True)
    pairs = [(str(g), int(j)) for g, j in zip(
        np.unique(labels)[rng.integers(0, n_groups - 1, 8)], rng.integers(0, n_genes, 8)
    )]
    torch.cuda.synchronize()
    he.hist_pass.launches = 0  # count the main path's launches only
    runs = {}
    for reference in ("non-targeting", None):
        tag = "OVO" if reference else "OVR"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        df = asymptotic_wilcoxon_arrays(x, labels, reference=reference, progress=False)
        wall = time.perf_counter() - t0
        runs[tag] = {
            "wall_s": wall, "tests_per_s": n_groups * n_genes / wall,
            "engine": df.attrs["engine"], "stage_s": df.attrs["stage_seconds"],
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        print(f"[5] {tag}: {json.dumps(runs[tag])}", flush=True)
        if df.attrs["engine"] != "hist" or not np.isfinite(df.p_value.values).all():
            raise AssertionError(f"{tag}: engine {df.attrs['engine']} or non-finite p")
        if df.shape != (n_groups * n_genes, 3):
            raise AssertionError(f"{tag}: result shape {df.shape}")
        scipy_check(f"full {tag}", df, x, labels, reference, False,
                    [(g, j) for g, j in pairs if g != reference])
    launches = he.hist_pass.launches
    if launches < 2:
        raise AssertionError(f"main path launched the hist kernel {launches} times")
    print(f"[5] hist kernel launches on the main path: {launches} (one per call "
          f"and tile); scipy spot checks pass", flush=True)

    # The kernel alone at the main path's shape.
    info, layout = layout_for(labels, "non-targeting")
    v_buckets = 128
    arrs = he.prepare_hist_inputs(layout, v_buckets, False, "cuda")
    args = (arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"])
    xd = torch.from_numpy(x).cuda()
    got = he.hist_pass(xd, *args, is_log1p=False)
    want = he.hist_pass_plain(xd, *args, is_log1p=False)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"kernel != plain at full width: max |diff| {err}")
    del got, want
    ms = cuda_ms(lambda: he.hist_pass(xd, *args, is_log1p=False), reps=10)
    plain_ms = cuda_ms(lambda: he.hist_pass_plain(xd, *args, is_log1p=False), reps=2)
    # torch.bincount over the flattened (g*V + v)*T + j keys: one library
    # call computing the same counts (int64), the yardstick only.
    rows = xd.index_select(0, args[0].long())
    grp = torch.repeat_interleave(torch.arange(n_groups, device="cuda"), torch.diff(args[1]))
    keys = ((grp[:, None] * v_buckets + rows.long()) * n_genes
            + torch.arange(n_genes, device="cuda"))[rows < v_buckets]
    del rows
    library_ms = cuda_ms(
        lambda: torch.bincount(keys, minlength=n_groups * v_buckets * n_genes), reps=3
    )
    del keys
    nbytes = (x.nbytes + n_groups * v_buckets * n_genes * 4
              + sum(a.numel() * a.element_size() for a in args))
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    print(f"[5] hist kernel {ms:.3f} ms (bound {bound_ms:.3f} ms by bytes: "
          f"{nbytes / 1e9:.2f} GB), plain {plain_ms:.3f} ms, "
          f"torch.bincount {library_ms:.3f} ms", flush=True)
    stats.update(
        launches=launches, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        library_ms=library_ms, max_abs_err=max(stats.get("max_abs_err", 0.0), err),
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="1,2,3,4,5")
    phases = {int(p) for p in parser.parse_args().phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import illico_tpu_torch  # noqa: F401  (fails outside the repository)

    smi = nvidia_smi_line()
    print(f"[1] device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    stats: dict = {}
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
        phase_full(stats)
    print(f"phases {sorted(phases)} passed in {time.perf_counter() - t0:.1f} s", flush=True)
    kernel = {
        "name": "grouped_hist",
        "route": "cuda",
        "source": "illico_tpu_torch/csrc/hist_kernel.cu",
        "replaces": "illico_tpu/ops/hist_engine.py:80",
        "launches": stats.get("launches"),
        "max_abs_err": stats.get("max_abs_err"),
        "ms": stats.get("ms"),
        "plain_ms": stats.get("plain_ms"),
        "bound_ms": stats.get("bound_ms"),
        "bound_by": "bytes",
        "library_ms": stats.get("library_ms"),
    }
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
