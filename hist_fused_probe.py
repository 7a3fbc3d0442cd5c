"""Time build variants of ``csrc/hist_fused.cu`` on one full tile, on the card.

Builds the fused pass's library as it ships and in diagnostic variants
(each a text edit of a copy of the source, under
``illico_tpu_torch/_build/probe/``), then times ``grouped_hist_contract_kernel``
and ``row_counts_kernel`` through their wrappers on a tile of heavy-tailed
counts drawn with the benchmark's count model (300,000 cells x 2,048 genes,
2,000 perturbations with a 10% control, and ``chip_smoke.skewed_labels``):
OVO with the nnz split at V=512, 256 and 128, OVR at 512, both skewed,
and the counting kernel on the reference's rows at each V and on every
row.  The exact builds are held bit for bit to the plain versions first.
A variant that does not compute the right counts is a diagnostic: its
times say what a part of the kernel costs.

  shipped       the source as it is
  loads_only    every row read as shipped, nothing counted (no epilogue work)
  count_only    every value counted as shipped, from a made-up value in
                place of each x load (0..7: few buckets, a short epilogue)
  no_atomics    the counts' shared atomics left out (bitmap and epilogue kept)
  no_epilogue   the coarse bitmap left out, so the epilogue sums nothing
  no_split      the shipped build, no group split over row chunks (the
                work's split groups left empty; exact)
  split_8k      the shipped build, groups split past 8,192 rows, not
                SPLIT_ROWS (exact)
  batch8        the grouped kernel at V=512 staging 8 rows a warp and
                round, not 12 (exact)
  warps16       the grouped kernel in 16-warp CTAs (2 an SM), 8 staged
                rows (exact: another order of the sums, the same bits below
                2^53)
  fused_8_12_3  the grouped kernel at V <= 256 in the V=512 shape: 8-warp
                CTAs, three an SM (exact)
  capped_<B>_<R>   the grouped kernel at V <= 256 in 8-warp CTAs built for
                B CTAs an SM (registers capped to fit), R staged rows (exact)
  counts_<W>_<R>_<B>   the counting kernel in W-warp CTAs, R staged rows,
                built for B CTAs an SM (exact)
  index_ahead   each round's row indices loaded two rounds ahead of its
                values, not just before them (exact)

Usage (needs a CUDA device and nvcc): ``python3 hist_fused_probe.py
[--variants shipped,loads_only,...]``.  Prints one JSON line per variant
(milliseconds, mean of 10 calls by CUDA events; each kernel's registers
and spilled bytes from ptxas), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np


def _tier(tier, shape):
    return f"template <> struct Tier<{tier}> {{ using Fused = Shape<{shape}>; }};"


# The shipped shapes' lines of hist_fused.cu (warps, staged rows, CTAs an
# SM): the grouped kernel's at V <= 256 and at V=512, the counting kernel's.
_FUSED = {0: _tier(0, "4, 12, 6"), 1: _tier(1, "8, 12, 3")}
_COUNTS = "using CountShape = Shape<16, 8, 2>;"


def _counts(shape):
    return f"using CountShape = Shape<{shape}>;"


# count_item's round loop as shipped (each round's row indices loaded just
# before its values), and with the indices loaded two rounds ahead.
_LOOP = """\
  for (int64_t base = begin + kRound;;) {  // base: the round held in w
    count_staged<S, kLog1p>(v, n, col_ok, table, v_buckets, hist_col, zeros, seen);
    if (nw == 0) break;
    n = stage<S>(x, rows, base + kRound, end, t_cols, col, col_ok, v);
    count_staged<S, kLog1p>(w, nw, col_ok, table, v_buckets, hist_col, zeros, seen);
    if (n == 0) break;
    base += 2 * kRound;
    nw = stage<S>(x, rows, base, end, t_cols, col, col_ok, w);
  }
"""
_LOOP_AHEAD = """\
  const int64_t warp = threadIdx.x >> 5;
  auto index_at = [&](int64_t b) {
    return illico_hist::load_index(rows, b + warp, S::kWarps, round_rows<S>(b, end));
  };
  int32_t iv = index_at(begin + 2 * kRound), iw = index_at(begin + 3 * kRound);
  for (int64_t base = begin + kRound;;) {
    count_staged<S, kLog1p>(v, n, col_ok, table, v_buckets, hist_col, zeros, seen);
    if (nw == 0) break;
    n = round_rows<S>(base + kRound, end);
    if (n) {
      illico_hist::load_rows(x, iv, n, t_cols, col, col_ok, v);
      iv = index_at(base + 3 * kRound);
    }
    count_staged<S, kLog1p>(w, nw, col_ok, table, v_buckets, hist_col, zeros, seen);
    if (n == 0) break;
    base += 2 * kRound;
    nw = round_rows<S>(base, end);
    if (nw) {
      illico_hist::load_rows(x, iw, nw, t_cols, col, col_ok, w);
      iw = index_at(base + 2 * kRound);
    }
  }
"""


# (anchor, replacement) edits of hist_fused.cu or hist_common.cuh; an anchor
# that is not found fails the build of its variant.
VARIANTS = {
    "shipped": {},
    "loads_only": {
        "  if (!col_ok) return;\n#pragma unroll\n  for (int u0 = 0;":
            "  if (!col_ok) return;\n  for (int u = 0; u < n; ++u) zeros += v[u] == 7.5f;\n"
            "  return;\n#pragma unroll\n  for (int u0 = 0;"},
    "count_only": {
        "v[u] = (u < n && col_ok) ? __ldcg(x + src * t_cols + col) : 0.0f;":
            "v[u] = (u < n && col_ok) ? static_cast<float>((src + col) & 7) : 0.0f;"},
    "no_atomics": {
        "        atomicAdd(hist_col + k[i] * kCols, 1);\n": "        zeros += k[i];\n"},
    "no_epilogue": {
        "        seen |= 1ull << (static_cast<unsigned int>(k[i]) / S::kWarps);\n": ""},
    "no_split": {},
    "split_8k": {},
    "batch8": {_FUSED[1]: _tier(1, "8, 8, 3")},
    "warps16": {_FUSED[0]: _tier(0, "16, 8, 2"), _FUSED[1]: _tier(1, "16, 8, 2")},
    "fused_8_12_3": {_FUSED[0]: _tier(0, "8, 12, 3")},
    **{f"capped_{b}_{r}": {_FUSED[0]: _tier(0, f"8, {r}, {b}")}
       for b, r in ((4, 12), (5, 8), (6, 8), (8, 4))},
    **{f"counts_{w}_{r}_{b}": {_COUNTS: _counts(f"{w}, {r}, {b}")}
       for w, r, b in ((8, 12, 3), (8, 8, 4))},
    "index_ahead": {_LOOP: _LOOP_AHEAD},
}
# The groups split over row chunks past this many rows (None: none split),
# where a variant departs from hist_engine.SPLIT_ROWS.
SPLIT_ROWS = {"no_split": None, "split_8k": 8192}
# Held bit for bit to the plain versions.
EXACT = ("shipped", *SPLIT_ROWS, "batch8", "warps16",
         *(n for n in VARIANTS if n.startswith(("fused_", "capped_", "counts_", "index_"))))


def build(names):
    """Each variant's shared library, all nvcc processes started together;
    {name: (ctypes library, ptxas register and spill lines)}."""
    from illico_tpu_torch.utils import cuda_build

    root = cuda_build.BUILD_DIR / "probe"
    procs, same = {}, {}
    for name in names:
        key = tuple(sorted(VARIANTS[name].items()))
        if key in same:  # the same source as a variant already started
            same[key].append(name)
            continue
        same[key] = [name]
        out = root / name
        out.mkdir(parents=True, exist_ok=True)
        edits = dict(VARIANTS[name])
        for src in ("hist_fused.cu", "hist_common.cuh"):
            text = (cuda_build.SRC_DIR / src).read_text()
            for anchor in list(edits):
                if anchor in text:
                    text = text.replace(anchor, edits.pop(anchor))
            (out / src).write_text(text)
        if edits:
            raise SystemExit(f"{name}: anchors not found in the sources: {list(edits)}")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out / "lib.so"),
               str(out / "hist_fused.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.illico_row_counts.restype = lib.illico_hist_contract.restype = i32
        lib.illico_row_counts.argtypes = [ptr, ptr, i64, ptr, ptr, i64, i32, i32, ptr]
        lib.illico_hist_contract.argtypes = [ptr] * 15 + [i32, i32, i64, i32, i32, i32, ptr]
        for twin in same[tuple(sorted(VARIANTS[name].items()))]:
            libs[twin] = (lib, _registers(log))
    return libs


def _registers(log):
    """{kernel: "registers/spilled bytes"} from nvcc's ptxas lines, a kernel
    named by its kind, shape and flags ("fused 8.12.3 010": 8 warps, 12
    staged rows, 3 CTAs an SM, raw values, with tie, no nnz split)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(row_counts|grouped_hist_contract)_kernelI\w*?ShapeILi(\d+)ELi(\d+)ELi"
                      r"(\d+)E+((?:Lb[01]E)+)", line)
        if m and "Compiling entry" in line:
            kind = "counts" if m.group(1) == "row_counts" else "fused"
            flags = "".join(re.findall(r"Lb([01])E", m.group(5)))
            name = f"{kind} {m.group(2)}.{m.group(3)}.{m.group(4)} {flags}"
        spill = re.search(r"(\d+) bytes spill stores", line)
        if name and spill:
            out[name] = spill.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        if name and regs:
            out[name] = f"{regs.group(1)}/{out.get(name, '0')}"
            name = None
    return out


def case(tile, labels, ref, v_buckets):
    """The fused pass's inputs for one tile, with the runner's statics, and
    the (tab, a) its group sums take (captured from one plain contraction)."""
    from chip_smoke import layout_for
    from illico_tpu_torch.ops import hist_engine as he

    info, layout = layout_for(labels, ref)
    statics = he.hist_contract_statics(layout, info.ref_code, v_buckets)
    kw = {k: v for k, v in statics.items() if k != "compute_fc"}
    kw["n_pad"] = float(layout.n_pad)
    arrs = he.prepare_hist_inputs(layout, v_buckets, False, tile.device)
    args = (arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"])
    real = he.real_rows_per_group(layout)
    rows = he.counting_rows(real, arrs["perm"], info.ref_code)
    counts = he.row_counts_plain(tile, rows, arrs["table"], is_log1p=False)
    captured = {}

    def capture(tab, a, **sums_kw):
        captured.update(tab=tab, a=a, sums_kw=sums_kw)
        return he._group_sums_plain(he.hist_pass_plain(tile, *args, is_log1p=False), tab, a,
                                    **sums_kw)

    he._contract_counts(counts, capture, arrs["ppg"], **kw)
    return dict(args=args, rows=rows, counts=counts, kw=kw, real=real,
                work=he.fused_work(real, info.ref_code), **captured)


def split_at(real, ref_code, rows):
    """``hist_engine.fused_work`` with groups split past ``rows`` rows (None:
    no group split)."""
    from illico_tpu_torch.ops import hist_engine as he

    saved = he.SPLIT_ROWS
    he.SPLIT_ROWS = rows if rows is not None else int(np.max(real)) + 1
    try:
        return he.fused_work(real, ref_code)
    finally:
        he.SPLIT_ROWS = saved


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    names = parser.parse_args().variants.split(",")

    import torch

    if not torch.cuda.is_available():
        print("hist_fused_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from benchmarks_torch.datagen import heavy_tailed_counts, perturbation_labels
    from benchmarks_torch.run import load_config, nvidia_smi_line
    from chip_smoke import cuda_ms, skewed_labels
    from illico_tpu_torch.ops import hist_engine as he

    libs = build(names)
    model = load_config("k562_essential")["counts"]
    tile = heavy_tailed_counts(300_000, 2048, model, seed=10, device="cuda").contiguous()
    labels = perturbation_labels(300_000, 2000, seed=10)
    skewed = skewed_labels(300_000)
    cases = {
        "ovo_nnz_split_v512": case(tile, labels, "non-targeting", 512),
        "ovo_nnz_split_v256": case(tile, labels, "non-targeting", 256),
        "ovo_nnz_split_v128": case(tile, labels, "non-targeting", 128),
        "ovr_v512": case(tile, labels, None, 512),
        "skewed_ovo_v512": case(tile, skewed, "non-targeting", 512),
        "skewed_ovr_v512": case(tile, skewed, None, 512),
    }
    shipped_lib = he._fused_library
    for name in names:
        lib, ptxas = libs[name]
        he._fused_library = lambda lib=lib: lib
        rec = {"variant": name, "ptxas": ptxas}
        for cname, c in cases.items():
            work = c["work"]
            if name in SPLIT_ROWS:
                work = split_at(c["real"], work.ref_code, SPLIT_ROWS[name])

            def fused(c=c, work=work):
                return he._grouped_sums_cuda(
                    tile, *c["args"], c["tab"], c["a"], is_log1p=False, work=work,
                    ref_counts=c["counts"], **c["sums_kw"])

            if name in EXACT:
                got = fused()
                hist = he.hist_pass_plain(tile, *c["args"], is_log1p=False)
                want = he._group_sums_plain(hist, c["tab"], c["a"], **c["sums_kw"])
                del hist
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    if (g is None) != (w is None) or (g is not None and not torch.equal(g, w)):
                        raise AssertionError(f"{name} build != plain in {cname}")
            rec[f"fused_{cname}"] = cuda_ms(fused, reps=10)
        for cname in ("ovo_nnz_split_v512", "ovo_nnz_split_v256", "ovo_nnz_split_v128",
                      "ovr_v512"):
            c = cases[cname]
            rec[f"row_counts_{cname}"] = cuda_ms(
                lambda c=c: he.row_counts(tile, c["rows"], c["args"][3], is_log1p=False),
                reps=10)
        print(json.dumps(rec), flush=True)
    he._fused_library = shipped_lib
    print(nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
