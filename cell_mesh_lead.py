#!/usr/bin/env python3
"""Time the cell mesh's lead after its K1s, and its contraction alone, on one V=512 tile on one card.

    python3 cell_mesh_lead.py                 # this tree's packages
    python3 cell_mesh_lead.py --root DIR      # the packages under DIR (another tree)

Draws one tile of heavy-tailed counts with the benchmark's count model on
the card (300,000 cells x 2,048 genes, 2,000 perturbations with a 10%
control, seed 10: ``chip_smoke.py`` phase 12's tile) and builds the cell
mesh's tile function over two cell shards, logical shards on ``cuda:0``
(``parallel.cells.make_cell_sharded_hist_fn``, ``v_buckets=512``, the
unpacked dict), for OVO with the nnz split (the runner's statics) and for
OVR.  Each shard's K1 histogram is made once, before the clock starts,
and ``hist_engine.hist_pass`` is replaced by a lookup of it, so a timed
call of the tile function runs the lead's part alone, through the tree's
own code: the shards' histograms brought together (added, in a tree that
sums them: then into the lead's cached histogram, whose counts grow from
call to call over the same nonzero buckets), in OVR the value counts
(``row_counts`` on each shard's rows, or the summed histogram's), the
contraction and its (G, T) steps.  Nothing here depends on the tree's
internal names but ``hist_pass`` and the public tile function.

Before the clock, the first call's statistics are held bit for bit to the
single-device tile function's on the same tile (the fused pass).  Then
``--reps`` calls, each ended by ``torch.cuda.synchronize()``, timed by the
host clock after one warm-up; the lead's peak device memory above what it
held before the call.

Then the contraction alone on the tile's whole V=512 histogram (S=1),
``hist_engine.hist_contract`` with the runner's statics in three variants
(``chip_smoke.py`` 12e's: OVO with the nnz split, OVO without it, OVR
with the R2 row split), given the rows' value counts in OVR where the
tree's ``hist_contract`` takes ``counts=``: the call's time by CUDA events
(mean of ``--reps``) and each of its device kernels' own time from one
call under ``torch.profiler``, by name.

The last line is one JSON record: ``{"root": ..., "lead": {"ovo_nnz_split":
{...}, "ovr": {...}}, "alone": {variant: {...}}}``; a lead record has
``ms`` (mean), ``ms_each``, ``peak_above_gb`` and ``hist_gb`` (one shard's
histogram), an alone record ``ms``, ``kernels_ms`` and ``counts_given``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import sys
import time
from pathlib import Path
from unittest import mock

# This tree's timing helpers, imported before --root puts another tree's
# packages first on the path (chip_smoke imports no package at its top).
import chip_smoke

SEED = 10


def tile_and_labels(device):
    """Phase 12's tile and labels, drawn with the benchmark's count model."""
    from benchmarks_torch.datagen import heavy_tailed_counts, perturbation_labels
    from benchmarks_torch.run import load_config

    model = load_config("k562_essential")["counts"]
    tile = heavy_tailed_counts(300_000, 2048, model, seed=SEED, device=device).contiguous()
    return tile, perturbation_labels(300_000, 2000, seed=SEED)


def lead_part(tile, labels, reference, *, reps=10, v_buckets=512, check=True):
    """The lead's part of one two-shard call of the cell mesh's tile
    function on ``tile`` (CUDA): ``{"ms", "ms_each", "peak_above_gb",
    "hist_gb"}``; with ``check`` the first call's statistics are held bit
    for bit to the single-device tile function's."""
    import torch

    from illico_tpu_torch.ops import hist_engine as he
    from illico_tpu_torch.ops.rank_engine import build_padded_layout
    from illico_tpu_torch.parallel.cells import (
        build_cell_shard_plans,
        make_cell_sharded_hist_fn,
        make_mesh_2d,
    )
    from illico_tpu_torch.utils.groups import encode_and_count_groups

    dev = tile.device
    _, info = encode_and_count_groups(labels, reference)
    layout = build_padded_layout(info.perm, info.indptr)
    plan = build_cell_shard_plans(info, 2)
    blocks = [tile[lo:hi].contiguous() for lo, hi in plan.row_bounds]
    table = torch.from_numpy(he.make_value_table(v_buckets, False)).to(dev)
    cached = {}
    for s, x in enumerate(blocks):
        args = [torch.from_numpy(a).to(dev) for a in (plan.perm[s], plan.indptr[s],
                                                      plan.order[s])]
        cached[x.data_ptr()] = he.hist_pass(x, *args, table, is_log1p=False)
    kw = dict(ref_code=info.ref_code, is_log1p=False, v_buckets=v_buckets, pack=False)
    want = he.make_hist_tile_fn(layout, device=dev, **kw)(tile) if check else {}
    with mock.patch.object(he, "hist_pass", lambda x, *a, **k: cached[x.data_ptr()]):
        run = make_cell_sharded_hist_fn(layout, plan, make_mesh_2d(2, 1, devices=[dev] * 2),
                                        **kw)
        # Called as the runner calls it: on the lead's stream, the shards'
        # streams after what this one holds (the blocks and histograms).
        fn = run.shards[0]
        fn.wait_for_current_streams()
        got = fn(blocks)
        torch.cuda.synchronize()
        for key, w in want.items():
            if not torch.equal(got[key], w):
                raise AssertionError(f"{'OVO' if reference else 'OVR'}: the cell mesh's "
                                     f"{key} differs from the single-device pass's")
        del got, want
        fn(blocks)  # warm-up
        torch.cuda.synchronize()
        each = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(blocks)
            torch.cuda.synchronize()
            each.append((time.perf_counter() - t0) * 1e3)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn(blocks)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - before
    hist_gb = next(iter(cached.values())).numel() * 4 / 1e9
    return {"ms": sum(each) / len(each), "ms_each": each, "peak_above_gb": peak / 1e9,
            "hist_gb": hist_gb}


def contraction_alone(tile, labels, *, reps=10, v_buckets=512):
    """``hist_contract`` alone on the tile's whole histogram in 12e's three
    variants: {variant: {"ms", "kernels_ms", "counts_given"}}."""
    import torch

    from illico_tpu_torch.ops import hist_engine as he
    from illico_tpu_torch.ops.rank_engine import build_padded_layout
    from illico_tpu_torch.utils.groups import encode_and_count_groups

    takes_counts = "counts" in inspect.signature(he.hist_contract).parameters
    out = {}
    for name, ref, hint in (("ovo_nnz_split", "non-targeting", True),
                            ("ovo", "non-targeting", False), ("ovr_u2_split", None, True)):
        _, info = encode_and_count_groups(labels, ref)
        layout = build_padded_layout(info.perm, info.indptr)
        statics = he.hist_contract_statics(layout, info.ref_code, v_buckets,
                                           nnz_split_hint=hint)
        kw = {k: v for k, v in statics.items() if k != "compute_fc"}
        kw["n_pad"] = float(layout.n_pad)
        arrs = he.prepare_hist_inputs(layout, v_buckets, False, tile.device)
        hist = he.hist_pass(tile, arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"],
                            is_log1p=False)
        given = {}
        if takes_counts and ref is None:
            given["counts"] = he.row_counts(tile, arrs["perm"], arrs["table"], is_log1p=False)

        def call(hist=hist, ppg=arrs["ppg"], given=given, kw=kw):
            return he.hist_contract(hist, ppg, **given, **kw)

        kernels: dict = {}
        for kernel, ms in chip_smoke.device_kernels(call):
            stem = re.search(r"\w+_kernel", kernel)
            kernel = stem.group(0) if stem else kernel[:60]
            kernels[kernel] = kernels.get(kernel, 0.0) + ms
        out[name] = {"ms": chip_smoke.cuda_ms(call, reps=reps), "kernels_ms": kernels,
                     "counts_given": bool(given)}
        del hist, given
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent),
                        help="the tree whose packages to import")
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("cell_mesh_lead: no CUDA device", file=sys.stderr)
        return 1
    from benchmarks_torch.run import nvidia_smi_line

    tile, labels = tile_and_labels("cuda")
    rec = {"root": args.root, "lead": {}}
    for name, reference in (("ovo_nnz_split", "non-targeting"), ("ovr", None)):
        rec["lead"][name] = lead_part(tile, labels, reference, reps=args.reps)
        torch.cuda.empty_cache()
        print(f"lead {name}: {json.dumps(rec['lead'][name])}", flush=True)
    rec["alone"] = contraction_alone(tile, labels, reps=args.reps)
    print(f"alone: {json.dumps(rec['alone'])}", flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
