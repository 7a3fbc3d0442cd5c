"""Time build variants of ``csrc/hist_contract.cu`` on one full tile's histogram, on the card.

Builds the contraction's library as it ships and in variants (each a text
edit of a copy of the source, under ``illico_tpu_torch/_build/probe_contract/``),
then times ``contract_kernel`` through its wrapper on the V=512 histogram of
one tile of heavy-tailed counts drawn with the benchmark's count model
(300,000 cells x 2,048 genes, 2,000 perturbations with a 10% control, as
``chip_smoke.py`` phase 12e): OVO with the nnz split, OVO without it and
OVR with the R2 row split, each from the whole histogram (S=1) and from
the two histograms of the tile's rows split in two cell shards (S=2).
The exact builds are held bit for bit to the plain version first.  A
variant that does not compute the right sums is a diagnostic: its time
says what a part of the kernel costs.

  shipped          the source as it is
  shape_<W>_<U>_<B>   W warps a CTA, U rows in flight a lane and shard, built
                   for B CTAs an SM (exact)
  loads_only       every count read as shipped, none added (no table reads)

Beside them, for each case, ``torch.sum`` of each histogram: one library
reduction that reads the same bytes once, the card's rate for this read.

Usage (needs a CUDA device and nvcc): ``python3 hist_contract_probe.py
[--variants shipped,loads_only,...]``.  Prints one JSON line per variant
(milliseconds, mean of 10 calls by CUDA events, beside the byte bound:
each histogram read once and the outputs written once at 3.35 TB/s; each
kernel's registers and spilled bytes from ptxas), then the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

_SHAPE = "constexpr int kWarps = 8;\nconstexpr int kUnroll = 6;\nconstexpr int kMinBlocks = 2;"
_SUMS = "  if (h != 0.0f) {\n    const double hd"
_NO_SUMS = "  if (h == -1.0f) {\n    const double hd"


def _shape(warps, unroll, blocks):
    return (f"constexpr int kWarps = {warps};\nconstexpr int kUnroll = {unroll};\n"
            f"constexpr int kMinBlocks = {blocks};")


# (anchor, replacement) edits of hist_contract.cu; an anchor that is not
# found fails the build of its variant.
VARIANTS = {
    "shipped": {},
    **{f"shape_{w}_{u}_{b}": {_SHAPE: _shape(w, u, b)}
       for w, u, b in ((8, 4, 2), (8, 8, 2), (4, 6, 4))},
    "loads_only": {_SUMS: _NO_SUMS},
}
EXACT = tuple(n for n in VARIANTS if n != "loads_only")
H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet


def build(names):
    """Each variant's shared library, all nvcc processes started together;
    {name: (ctypes library, {kernel: "registers/spilled bytes"})}."""
    from illico_tpu_torch.utils import cuda_build

    root = cuda_build.BUILD_DIR / "probe_contract"
    procs = {}
    for name in names:
        out = root / name
        out.mkdir(parents=True, exist_ok=True)
        text = (cuda_build.SRC_DIR / "hist_contract.cu").read_text()
        for anchor, repl in VARIANTS[name].items():
            if text.count(anchor) != 1:
                raise SystemExit(f"{name}: anchor not found once in the source: {anchor!r}")
            text = text.replace(anchor, repl)
        (out / "hist_contract.cu").write_text(text)
        (out / "hist_common.cuh").write_text((cuda_build.SRC_DIR / "hist_common.cuh").read_text())
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out / "lib.so"),
               str(out / "hist_contract.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.illico_contract.restype = i32
        lib.illico_contract.argtypes = [ptr, i32] + [ptr] * 7 + [i64, i32, i32, i32, i32, ptr]
        libs[name] = (lib, _registers(log))
    return libs


def _registers(log):
    """{kernel: "registers/spilled bytes"} from nvcc's ptxas lines, a kernel
    named by its flags ("110": tie, nnz split, 16-byte loads)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"contract_kernelILb([01])ELb([01])ELb([01])E", line)
        if m and "Compiling entry" in line:
            name = "".join(m.groups())
        spill = re.search(r"(\d+) bytes spill stores", line)
        if name and spill:
            out[name] = spill.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        if name and regs:
            out[name] = f"{regs.group(1)}/{out.get(name, '0')}"
            name = None
    return out


CASES = (("ovo_nnz_split", "non-targeting", True), ("ovo", "non-targeting", False),
         ("ovr_u2_split", None, True))


def case(tile, labels, ref, hint):
    """One V=512 variant of chip_smoke.py 12e: the tile's whole histogram,
    the two histograms of its rows in two cell shards, and the tables and
    group-sum keywords captured from one plain contraction."""
    import torch

    from chip_smoke import layout_for
    from illico_tpu_torch.ops import hist_engine as he
    from illico_tpu_torch.parallel.cells import build_cell_shard_plans

    info, layout = layout_for(labels, ref)
    statics = he.hist_contract_statics(layout, info.ref_code, he.MAX_V, nnz_split_hint=hint)
    kw = {k: v for k, v in statics.items() if k != "compute_fc"}
    kw["n_pad"] = float(layout.n_pad)
    arrs = he.prepare_hist_inputs(layout, he.MAX_V, False, tile.device)
    hist = he.hist_pass(tile, arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"],
                        is_log1p=False)
    plan = build_cell_shard_plans(info, 2)
    shards = []
    for s, (lo, hi) in enumerate(plan.row_bounds):
        args = [torch.from_numpy(a).to(tile.device)
                for a in (plan.perm[s], plan.indptr[s], plan.order[s])]
        shards.append(he.hist_pass(tile[lo:hi].contiguous(), *args, arrs["table"],
                                   is_log1p=False))
    captured = {}

    def capture(hists, tab, a, **sums_kw):
        captured.update(tab=tab, a=a, sums_kw=sums_kw)
        return he._group_sums_plain(hists, tab, a, **sums_kw)

    want = he._contract(hist, arrs["ppg"], capture, **kw)
    del want
    return hist, shards, captured["tab"], captured["a"], captured["sums_kw"]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    names = parser.parse_args().variants.split(",")

    import torch

    if not torch.cuda.is_available():
        print("hist_contract_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from benchmarks_torch.datagen import heavy_tailed_counts, perturbation_labels
    from benchmarks_torch.run import load_config, nvidia_smi_line
    from chip_smoke import cuda_ms
    from illico_tpu_torch.ops import hist_engine as he

    libs = build(names)
    model = load_config("k562_essential")["counts"]
    tile = heavy_tailed_counts(300_000, 2048, model, seed=10, device="cuda").contiguous()
    labels = perturbation_labels(300_000, 2000, seed=10)
    recs = {name: {"variant": name, "ptxas": libs[name][1]} for name in names}
    shipped_lib = he._contract_library
    for cname, ref, hint in CASES:
        hist, shards, tab, a, kw = case(tile, labels, ref, hint)
        want = he._group_sums_plain(hist, tab, a, **kw)
        out_bytes = sum(t.numel() * 8 for t in want if t is not None)
        for n, hists in ((1, [hist]), (2, shards)):
            read = {"variant": "torch.sum", "case": f"{cname}_s{n}",
                    "ms": cuda_ms(lambda hists=hists: [h.sum() for h in hists], reps=10),
                    "bound_ms": sum(h.numel() * 4 for h in hists) / H100_BYTES_PER_S * 1e3}
            print(json.dumps(read), flush=True)
        for name in names:
            he._contract_library = lambda lib=libs[name][0]: lib
            for n, hists in ((1, [hist]), (2, shards)):
                def sums(hists=hists):
                    return he._group_sums_cuda(hists, tab, a, **kw)

                if name in EXACT:
                    got = sums()
                    torch.cuda.synchronize()
                    for g, w in zip(got, want):
                        if (g is None) != (w is None) or (g is not None and not torch.equal(g, w)):
                            raise AssertionError(f"{name} build != plain in {cname} S={n}")
                    del got
                recs[name][f"ms_{cname}_s{n}"] = cuda_ms(sums, reps=10)
                recs[name][f"bound_ms_{cname}_s{n}"] = (
                    sum(h.numel() * 4 for h in hists) + out_bytes) / H100_BYTES_PER_S * 1e3
        del hist, shards, want
        torch.cuda.empty_cache()
    for rec in recs.values():
        print(json.dumps(rec), flush=True)
    he._contract_library = shipped_lib
    print(nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
