#!/usr/bin/env python3
"""Where the host tail runs against the card, read from one profiled call.

    python3 tail_overlap.py                    # the k562_ovo_counts_cuda call, seed 0
    python3 tail_overlap.py --threads 1        # ILLICO_TPU_TAIL_THREADS=1 for every call
    python3 tail_overlap.py --root DIR         # the packages under DIR (another tree)

Draws the counts of the benchmark's ``k562_ovo_counts_cuda`` cell on the
card (``benchmarks_torch/datagen.py``, the cell's configuration and seed),
makes one warm-up call and ``--calls`` timed calls of the public API with
every default, then one call under ``torch.profiler`` (``profile_dir=``, as
the benchmark's profiled call) with named host spans wrapped around the
functions that do the work, from outside the package:
``hist_engine.hist_pass_contract`` ("contract", one per tile: the fused
grouped pass and its contraction) and, where it runs (the cell mesh, or a
tree older than the fused pass), ``hist_engine.hist_contract`` (also
"contract"), ``native.consume_tile_native`` ("tail", one per tile) and
``WilcoxonRunner._recompute_with_sort_engine`` ("fallback").  Wrapping
from outside reads any tree of the package alike.

From the trace (:func:`overlap_from_trace`): how long the host spends
inside ``cudaLaunchKernel`` (a launch that waits for room in the card's
queue takes far longer than its microseconds), when each tile's
contraction ends on the card against when each tail runs on the host, and
how busy the card is while the tails run.  ``first_tail_lead_s`` is the
end of the last tile's contraction on the card less the start of the
first tail: positive when the host began consuming while the card still
worked on the loop.  The last line is one JSON record; its
``frame_sha256`` (:func:`frame_digest` of the first call's frame) compares
two trees' frames bit for bit.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import time
from pathlib import Path

LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("contract", "tail", "fallback")


@contextlib.contextmanager
def named_spans():
    """``torch.profiler.record_function`` spans "contract", "tail" and
    "fallback" around the functions that do that work, inside the block."""
    from torch.profiler import record_function

    from illico_tpu_torch import native
    from illico_tpu_torch.models.wilcoxon import WilcoxonRunner
    from illico_tpu_torch.ops import hist_engine

    def wrap(fn, name):
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapped

    targets = [(owner, name, span) for owner, name, span in (
        # A tile's contraction: the fused pass on one device, or the
        # histogram's under the cell mesh and in trees without the fused pass.
        (hist_engine, "hist_pass_contract", "contract"),
        (hist_engine, "hist_contract", "contract"),
        (native, "consume_tile_native", "tail"),
        (WilcoxonRunner, "_recompute_with_sort_engine", "fallback"),
    ) if hasattr(owner, name)]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]
    for owner, name, span in targets:
        setattr(owner, name, wrap(getattr(owner, name), span))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _union(spans):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(merged, a, b):
    """Microseconds of [a, b] that the merged intervals cover."""
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)


def overlap_from_trace(trace_path) -> dict:
    """The tile loop's timeline from a Chrome trace of one call made under
    :func:`named_spans` (seconds; host and device share the trace's clock).

    ``launch``: the ``cudaLaunchKernel`` calls of the whole trace, their
    total and longest host time, and how many took over 1 ms (a launch
    waiting for room in the queue).  ``tiles``: per tile, its contraction's
    host span (start, length, launches and their host time) and the end of
    the device work those launches queued, and its tail's start and length,
    all from the trace's first event.  ``first_tail_lead_s``: the last
    tile's contraction end on the card less the first tail's start.
    ``tail_device_busy_share``: the share of the tails' host time in which
    the card was busy."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    timed = [e for e in events if "ts" in e and "dur" in e]
    t0 = min(e["ts"] for e in timed)
    device = [e for e in timed if e.get("cat") in DEVICE_CATS]
    if not device:
        raise RuntimeError(f"the trace {trace_path} holds no device activity")
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in device)
    end_by_corr: dict = {}
    for e in device:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            end_by_corr[corr] = max(end_by_corr.get(corr, 0.0), e["ts"] + e["dur"])
    launches = sorted((e for e in timed if e.get("cat") == "cuda_runtime"
                       and e["name"] in LAUNCH_NAMES), key=lambda e: e["ts"])
    spans = {name: sorted((e for e in timed if e.get("cat") == "user_annotation"
                           and e["name"] == name), key=lambda e: e["ts"])
             for name in SPANS}
    tails = spans["tail"]
    # The loop's contractions are the last len(tails) before the fallback
    # (the warm-up runs before the profiled loop, or first).
    fallback_ts = spans["fallback"][0]["ts"] if spans["fallback"] else float("inf")
    contracts = [e for e in spans["contract"] if e["ts"] < fallback_ts][-len(tails):] \
        if tails else []
    launch_us = [e["dur"] for e in launches]
    tiles = []
    for c, t in zip(contracts, tails):
        inside = [e for e in launches if c["ts"] <= e["ts"] <= c["ts"] + c["dur"]]
        ends = [end_by_corr[e["args"]["correlation"]] for e in inside
                if e.get("args", {}).get("correlation") in end_by_corr]
        tiles.append({
            "contract_host_start_s": (c["ts"] - t0) / 1e6,
            "contract_host_s": c["dur"] / 1e6,
            "contract_launches": len(inside),
            "contract_launch_host_s": sum(e["dur"] for e in inside) / 1e6,
            "contract_device_end_s": (max(ends) - t0) / 1e6 if ends else None,
            "tail_start_s": (t["ts"] - t0) / 1e6,
            "tail_s": t["dur"] / 1e6,
            "tail_device_busy_s": _covered(busy, t["ts"], t["ts"] + t["dur"]) / 1e6,
        })
    tail_us = sum(t["dur"] for t in tails)
    last_end = tiles[-1]["contract_device_end_s"] if tiles else None
    return {
        "launch": {
            "n": len(launch_us), "host_s": sum(launch_us) / 1e6,
            "max_ms": max(launch_us) / 1e3 if launch_us else None,
            "n_over_1ms": sum(d > 1e3 for d in launch_us),
            "host_s_over_1ms": sum(d for d in launch_us if d > 1e3) / 1e6,
        },
        "tiles": tiles,
        "first_tail_lead_s": (last_end - tiles[0]["tail_start_s"])
        if tiles and last_end is not None else None,
        "tail_host_s": tail_us / 1e6,
        "tail_device_busy_share": (sum(t["tail_device_busy_s"] for t in tiles) * 1e6 / tail_us)
        if tail_us else None,
        "device_busy_s": sum(b - a for a, b in busy) / 1e6,
        "trace_s": (max(e["ts"] + e["dur"] for e in timed) - t0) / 1e6,
    }


def frame_digest(df) -> str:
    """SHA-256 of a result frame's (pert, feature) index and its values:
    equal digests from two trees (``--root``) mean bit-equal frames."""
    import numpy as np

    digest = hashlib.sha256()
    for level, codes in zip(df.index.levels, df.index.codes):
        digest.update("\n".join(map(str, level)).encode())
        digest.update(np.asarray(codes, np.int64).tobytes())
    digest.update(np.ascontiguousarray(df.values, dtype=np.float64).tobytes())
    return digest.hexdigest()


def profiled_call(X, labels, reference, profile_dir) -> tuple[object, float, dict]:
    """One public-API call under ``torch.profiler`` with the named spans;
    returns the frame, its wall and :func:`overlap_from_trace` of it."""
    import torch

    from illico_tpu_torch import asymptotic_wilcoxon_arrays

    torch.cuda.synchronize()
    with named_spans():
        t0 = time.perf_counter()
        df = asymptotic_wilcoxon_arrays(X, labels, reference=reference, progress=False,
                                        profile_dir=profile_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return df, wall, overlap_from_trace(os.path.join(profile_dir, "trace.json"))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent),
                        help="the tree whose packages to import")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--calls", type=int, default=3, help="timed calls before the profiled one")
    parser.add_argument("--threads", default=None, help="ILLICO_TPU_TAIL_THREADS for every call")
    parser.add_argument("--out", default="illico_tpu_torch/_build/profile",
                        help="the trace's directory")
    args = parser.parse_args()
    if args.threads is not None:
        os.environ["ILLICO_TPU_TAIL_THREADS"] = args.threads
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tail_overlap: no CUDA device", file=sys.stderr)
        return 1
    from benchmarks_torch.datagen import heavy_tailed_counts, perturbation_labels
    from benchmarks_torch.run import load_workload, nvidia_smi_line
    from illico_tpu_torch import asymptotic_wilcoxon_arrays

    cell, cfg = load_workload("k562_ovo_counts_cuda")
    X = heavy_tailed_counts(cfg["n_cells"], cfg["n_genes"], cfg["counts"], seed=args.seed,
                            device="cuda")
    labels = perturbation_labels(cfg["n_cells"], cfg["n_groups"], args.seed, cfg["control"],
                                 cfg["control_share"])
    calls = []
    first = None
    for i in range(args.calls + 1):  # the first call warms up and is not kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df = asymptotic_wilcoxon_arrays(X, labels, reference=cfg["control"], progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if first is None:
            first, digest = df.values, frame_digest(df)
            continue
        if not np.array_equal(df.values.view(np.uint64), first.view(np.uint64)):
            raise AssertionError("a call's frame differs from the first call's")
        st = df.attrs["stage_seconds"]
        calls.append({"wall_s": wall, "tail_s": st["tail"], "stage_s": st,
                      "unstaged_s": wall - sum(st.values()),
                      "tail_threads": df.attrs.get("tail_threads")})
        print(f"call {i}: {json.dumps(calls[-1])}", flush=True)
    profile_dir = os.path.abspath(args.out)
    asymptotic_wilcoxon_arrays(X[:2000, :8].contiguous(), labels[:2000],  # profiler start-up
                               reference=None, progress=False, profile_dir=profile_dir)
    df, wall, overlap = profiled_call(X, labels, cfg["control"], profile_dir)
    if not np.array_equal(df.values.view(np.uint64), first.view(np.uint64)):
        raise AssertionError("the profiled call's frame differs from the first call's")
    overlap["profiled_wall_s"] = wall
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"root": args.root, "threads_env": args.threads, "calls": calls,
                      "frame_sha256": digest, "overlap": overlap}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
