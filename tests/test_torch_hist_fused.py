"""The fused single-device pass of the histogram engine, on the CPU.

- ``row_counts_plain`` on the reference's rows equals that group's row of
  ``hist_pass_plain``, and on every real row the value counts the
  contraction sums from the histogram, bit for bit;
- ``hist_pass_contract`` on a CPU tile (``hist_pass_contract_plain``)
  equals ``hist_contract_plain(hist_pass_plain(...))`` in every statics
  variant, raw and log1p, at V=128 and 512, with a group that has no real
  rows and a width that is not a multiple of 32;
- ``make_hist_tile_fn`` runs the fused pass unless given ``hist_fn``, and
  its packed bytes equal the JAX package's tile function (its Pallas
  kernel in interpret mode) in OVO with the nnz split and in OVR;
- the CUDA wrappers' plumbing (argument order, pointers, null arrays,
  launch counts, the scratch) runs on the CPU against a numpy rendering of
  the C entry points of ``csrc/hist_fused.cu``, which walks the kernel's
  work items (the reference group from its counts, split groups through
  their scratch planes and tickets) and sums in the kernel's order;
- the kernel's items (``_kernel_chunks``, a rendering of its decode from
  ``order``, ``indptr`` and ``fused_work``) cover every (group, column
  block, row) once, and its summation order (``_warp_order_sums``) gives
  the plain version's sums bit for bit below 2^53;
- the kernels themselves are held to their plain versions on the card by
  ``tests/test_torch_hist_fused_cuda.py`` and, at full width, by
  ``chip_smoke.py`` (phases 2 and 12f).
"""

import contextlib
import ctypes

import jax  # noqa: F401  (the reference package runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

import illico_tpu.ops.hist_engine as jhe
import illico_tpu.ops.rank_engine as jre
import illico_tpu.utils.groups as jgroups
from illico_tpu_torch.ops import hist_engine as the
from illico_tpu_torch.ops import rank_engine as tre
from illico_tpu_torch.utils import cuda_build
from illico_tpu_torch.utils import groups as tgroups
from test_torch_contract_cuda import VARIANTS, _statics
from test_torch_hist import _case
from test_torch_hist_fused_cuda import fused_inputs

CPU = torch.device("cpu")


def _problem(seed, v_buckets, is_log1p, ovo, empty_group=False, t_cols=45):
    """A small tile (adversarial values, a column past the table, a 1-cell
    group, a width off the 32-column block) and the fused pass's inputs."""
    x, labels = _case(seed, v_buckets, is_log1p, n_cells=300, t_cols=t_cols)
    labels = np.where(labels == 1, "ref", labels.astype(str))
    return fused_inputs(x, labels, v_buckets, is_log1p, "ref" if ovo else None, CPU,
                        empty_group=empty_group)


@pytest.mark.parametrize("v_buckets", [128, 512])
@pytest.mark.parametrize("is_log1p", [False, True], ids=["raw", "log1p"])
def test_row_counts_plain_equal_the_histograms_rows(v_buckets, is_log1p):
    xt, args, _, rows, layout, info = _problem(3, v_buckets, is_log1p, True)
    hist = the.hist_pass_plain(xt, *args, is_log1p=is_log1p)
    got = the.row_counts_plain(xt, rows, args[3], is_log1p=is_log1p)
    assert got.dtype == torch.float64 and got.shape == hist.shape[1:]
    np.testing.assert_array_equal(got.numpy(), hist[info.ref_code].double().numpy())
    every = the.row_counts_plain(xt, args[0], args[3], is_log1p=is_log1p)
    np.testing.assert_array_equal(every.numpy(), the._value_counts_plain(hist).numpy())
    # The dispatching entry takes the plain version on a CPU tensor.
    before = the.row_counts.launches
    np.testing.assert_array_equal(
        the.row_counts(xt, rows, args[3], is_log1p=is_log1p).numpy(), got.numpy())
    assert the.row_counts.launches == before


def test_counting_rows_are_the_reference_rows_or_all():
    xt, args, _, rows, layout, info = _problem(4, 128, False, True)
    perm, indptr = args[0], args[1]
    lo, hi = int(indptr[info.ref_code]), int(indptr[info.ref_code + 1])
    assert torch.equal(rows, perm[lo:hi]) and rows.is_contiguous()
    assert the.counting_rows(the.real_rows_per_group(layout), perm, -1) is perm


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("v_buckets", [128, 512])
@pytest.mark.parametrize("is_log1p", [False, True], ids=["raw", "log1p"])
def test_fused_plain_equals_contraction_of_the_histogram(variant, v_buckets, is_log1p):
    ovo = VARIANTS[variant][0]
    xt, args, ppg, rows, layout, info = _problem(5, v_buckets, is_log1p, ovo,
                                                 empty_group=True)
    kw = dict(n_pad=float(layout.n_pad), **_statics(variant, layout, info))
    hist = the.hist_pass_plain(xt, *args, is_log1p=is_log1p)
    assert not bool(hist[-1].any())  # the group with no real rows
    want = the.hist_contract_plain(hist, ppg, **kw)
    counters = (the.hist_pass, the.hist_pass_contract, the.row_counts, the.hist_contract)
    before = [c.launches for c in counters]
    marks = []
    got = the.hist_pass_contract(xt, *args, ppg, count_rows=rows, is_log1p=is_log1p,
                                 mark=marks.append, **kw)
    assert [c.launches for c in counters] == before  # nothing launched on the CPU
    assert marks == ["kernel"] and the.hist_pass.v_buckets == v_buckets
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w.numpy(), err_msg=k)
    assert got["overflow_cols"][3:].any() and not got["overflow_cols"][:3].any()


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float16])
def test_fused_pass_casts_narrow_wire_dtypes(dtype):
    """A tile shipped in a narrow wire dtype gives the float32 tile's
    statistics (the pass casts it once, for both of its passes)."""
    xt, args, ppg, rows, layout, info = _problem(9, 128, False, True)
    x = torch.nan_to_num(xt, nan=0.0, posinf=0.0, neginf=0.0).round().clamp(0, 255)
    kw = dict(n_pad=float(layout.n_pad), ref_code=info.ref_code, nnz_split=True)
    want = the.hist_pass_contract(x, *args, ppg, count_rows=rows, is_log1p=False, **kw)
    got = the.hist_pass_contract(x.to(torch.from_numpy(np.empty(0, dtype)).dtype), *args, ppg,
                                 count_rows=rows, is_log1p=False, **kw)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w.numpy(), err_msg=k)


def test_fused_pass_refuses_other_devices():
    xt, args, ppg, rows, layout, info = _problem(6, 128, False, True)
    meta = torch.empty(xt.shape, device="meta")
    with pytest.raises(ValueError, match="hist_pass_contract: unsupported device"):
        the.hist_pass_contract(meta, *args, ppg, count_rows=rows, is_log1p=False,
                               n_pad=float(layout.n_pad), ref_code=info.ref_code)
    with pytest.raises(ValueError, match="row_counts: unsupported device"):
        the.row_counts(meta, rows, args[3], is_log1p=False)


# -- the tile function ---------------------------------------------------------------
def _spy(monkeypatch, name):
    calls = []
    fn = getattr(the, name)

    def spy(*a, **k):
        calls.append(name)
        return fn(*a, **k)

    monkeypatch.setattr(the, name, spy)
    return calls


@pytest.mark.parametrize("ovo", [False, True], ids=["ovr", "ovo_nnz_split"])
def test_tile_fn_takes_the_fused_pass_unless_given_a_histogram(ovo, monkeypatch):
    rng = np.random.RandomState(9)
    sizes = (4000, 60, 50, 40)
    labels = np.repeat(np.arange(len(sizes)), sizes)
    x = rng.poisson(0.5, (labels.size, 70)).astype(np.float32)
    x[3, 5] = 900.0  # a column past the table
    _, tinfo = tgroups.encode_and_count_groups(labels, 0 if ovo else None)
    layout = tre.build_padded_layout(tinfo.perm, tinfo.indptr)
    kw = dict(ref_code=tinfo.ref_code, is_log1p=False, device=CPU)
    arrs = the.prepare_hist_inputs(layout, the.DEFAULT_V, False, CPU)

    def hist_fn(xt, mark):
        hist = the.hist_pass(xt, arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"],
                             is_log1p=False)
        mark("kernel")
        return hist, None

    fused_calls = _spy(monkeypatch, "hist_pass_contract")
    contract_calls = _spy(monkeypatch, "hist_contract")
    fused, via_hist = the.make_hist_tile_fn(layout, **kw), the.make_hist_tile_fn(
        layout, hist_fn=hist_fn, **kw)
    assert fused._statics["nnz_split"] is ovo
    marks = []
    buf = fused(torch.from_numpy(x), marks.append).numpy()
    assert (fused_calls, contract_calls, marks) == (["hist_pass_contract"], [],
                                                    ["kernel", "contract"])
    marks.clear()
    buf_hist = via_hist(torch.from_numpy(x), marks.append).numpy()
    assert (fused_calls, contract_calls, marks) == (["hist_pass_contract"], ["hist_contract"],
                                                    ["kernel", "contract"])
    np.testing.assert_array_equal(buf, buf_hist)
    assert fused.unpack(buf)["overflow_cols"][5]


def _jax_tile_fn(labels, ref, is_log1p, fc_u8_hint=False):
    _, info = jgroups.encode_and_count_groups(labels, ref)
    layout = jre.build_padded_layout(info.perm, info.indptr)
    return jhe.make_hist_tile_fn(layout, ref_code=info.ref_code, is_log1p=is_log1p,
                                 interpret=True, fc_u8_hint=fc_u8_hint)


@pytest.mark.parametrize("mode,sizes", [("ovo_nnz_split", (4000, 60, 50, 40)),
                                        ("ovr", (700, 23, 19, 15, 11))])
@pytest.mark.parametrize("is_log1p", [False, True], ids=["raw", "log1p"])
def test_tile_fn_packed_bytes_equal_reference(mode, sizes, is_log1p):
    """128 columns, where both packages pack at the same width: the fused
    pass's buffer equals the JAX tile function's byte for byte."""
    rng = np.random.RandomState(13)
    labels = np.repeat(np.arange(len(sizes)), sizes)
    x = rng.poisson(0.7, (labels.size, 128)).astype(np.float32)
    x[rng.rand(*x.shape) < 0.3] = 0
    x[7, 9] = 700.0  # past the table: an overflow column
    if is_log1p:
        x = np.log1p(x).astype(np.float32)
    ref = 0 if mode == "ovo_nnz_split" else None
    _, tinfo = tgroups.encode_and_count_groups(labels, ref)
    tfn = the.make_hist_tile_fn(tre.build_padded_layout(tinfo.perm, tinfo.indptr),
                                ref_code=tinfo.ref_code, is_log1p=is_log1p, device=CPU)
    assert tfn._statics["nnz_split"] is (mode == "ovo_nnz_split")
    jfn = _jax_tile_fn(labels, ref, is_log1p)
    got = tfn(torch.from_numpy(x)).numpy()
    want = np.asarray(jfn(x))
    np.testing.assert_array_equal(got, want)
    assert tfn.unpack(got)["overflow_cols"][9]


# -- the CUDA wrappers against a numpy rendering of the C entry points -----------
def _view(ptr, dtype, shape):
    n = int(np.prod(shape))
    ctype = {np.float32: ctypes.c_float, np.float64: ctypes.c_double,
             np.int32: ctypes.c_int32, np.int64: ctypes.c_int64}[dtype]
    return np.ctypeslib.as_array((ctype * n).from_address(ptr)).reshape(shape)


def _tie_term(h, a):
    """``illico_hist::tie_term``: each product and sum rounded on its own."""
    return (h * h * h - h) + 3.0 * a * h * (a + h)


def _fused_warps(v_buckets):
    """The grouped kernel's warps a CTA at this table size: 4-warp CTAs for
    V <= 256, 8 at V=512 (``csrc/hist_fused.cu``'s ``Tier``)."""
    return 4 if v_buckets <= 256 else 8


def _warp_order_sums(h, tab, a, nnz_split, warps=8):
    """The fused kernel's sums over v of the (..., V, C) counts ``h`` in its
    order: warp w of ``warps`` adds its buckets v = w, w + warps, ...
    ascending, zero counts skipped, then the partial sums are added in warp
    order; v = 0 (warp 0's first) gives h0 and, without the nnz split, main
    and tie terms.  Returns fc, main, tie (None without ``a``), nz and tot."""
    zero = np.zeros(h.shape[:-2] + h.shape[-1:])
    parts = []
    h0 = zero.copy()
    for w in range(warps):
        fc, main, tie, nz = zero.copy(), zero.copy(), zero.copy(), zero.copy()
        for v in range(w, h.shape[-2], warps):
            hv = h[..., v, :]
            on = hv != 0
            t = tab[v]
            term = _tie_term(hv, a[v]) if a is not None else zero
            if v == 0:
                h0 = np.where(on, hv, h0)
                if not nnz_split:
                    main = np.where(on, main + hv * t, main)
                    tie = np.where(on, tie + term, tie)
                continue
            fc = np.where(on, fc + hv * float(v), fc)
            nz = np.where(on, nz + hv, nz)
            main = np.where(on, main + hv * t, main)
            tie = np.where(on, tie + term, tie)
        parts.append((fc, main, tie, nz))
    total = list(parts[0])
    for part in parts[1:]:
        total = [s + p for s, p in zip(total, part)]
    fc, main, tie, nz = total
    return fc, main, tie if a is not None else None, nz, nz + h0


SKIP, FROM_COUNTS, WHOLE = -3, -2, -1  # chunk slots that are not scratch planes


def _kernel_chunks(indptr, order, work):
    """The grouped kernel's chunks in item order, as its decode makes them
    (``csrc/hist_fused.cu``): (group, begin, end, slot, parts), begin and
    end offsets into ``perm``.  First the split groups' chunks of equal rows
    (slot: the group's scratch plane), then every group in ``order``: the
    reference from its counts, a split group skipped, any other whole."""
    chunks = []
    for slot, (g, parts) in enumerate(zip(work.split_groups, work.split_parts)):
        lo, hi = int(indptr[g]), int(indptr[g + 1])
        step = -(-(hi - lo) // parts)
        chunks += [(g, lo + p * step, min(lo + (p + 1) * step, hi), slot, parts)
                   for p in range(parts)]
    for g in (int(g) for g in order):
        lo = int(indptr[g])
        if g in work.split_groups:
            chunks.append((g, lo, lo, SKIP, 1))
        elif g == work.ref_code:
            chunks.append((g, lo, lo, FROM_COUNTS, 1))
        else:
            chunks.append((g, lo, int(indptr[g + 1]), WHOLE, 1))
    return chunks


class _EmulatedFusedLibrary:
    """``illico_row_counts`` and ``illico_hist_contract`` on host pointers,
    with the C signatures.  The grouped pass walks the kernel's items
    (:func:`_kernel_chunks` x 32-column blocks) in order: a chunk's counts
    from its rows, the reference's from ``ref_counts``, a split group's
    added into its scratch plane and contracted by the chunk that takes the
    plane's last ticket, a skipped entry nothing; the sums in the kernel's
    order (:func:`_warp_order_sums`), written where the C code writes,
    each (group, column block) exactly once."""

    def __init__(self):
        self.calls = []
        self.split_chunks = 0

    def illico_row_counts(self, x, rows, n_rows, table, cnt, t_cols, v_buckets, is_log1p,
                          stream):
        self.calls.append("row_counts")
        out = _view(cnt, np.int32, (v_buckets, t_cols))
        assert not out.any(), "row_counts adds into zeros"
        r = _view(rows, np.int32, (n_rows,))
        n_cells = int(r.max()) + 1
        xt = torch.from_numpy(_view(x, np.float32, (n_cells, t_cols)).copy())
        tb = torch.from_numpy(_view(table, np.float32, (v_buckets,)).copy())
        out += the.row_counts_plain(xt, torch.from_numpy(r.copy()), tb,
                                    is_log1p=bool(is_log1p)).numpy().astype(np.int32)
        return 0

    def illico_hist_contract(self, x, perm, indptr, order, split, table, tab, ref,
                             ref_counts, fc, main, tie, nz, tot, scratch, n_groups, ref_code,
                             t_cols, v_buckets, is_log1p, nnz_split, stream):
        self.calls.append("hist_contract")
        ip = _view(indptr, np.int64, (n_groups + 1,))
        n_split = int(_view(split, np.int32, (1,))[0])
        spec = _view(split, np.int32, (1 + 2 * n_split,))
        work = the.FusedWork(tuple(int(g) for g in spec[1 : 1 + n_split]),
                             tuple(int(q) for q in spec[1 + n_split :]), int(ref_code))
        p = _view(perm, np.int32, (int(ip[-1]),))
        n_cells = int(p.max()) + 1 if p.size else 1
        xt = torch.from_numpy(_view(x, np.float32, (n_cells, t_cols)).copy())
        tb = torch.from_numpy(_view(table, np.float32, (v_buckets,)).copy())
        tab_v = _view(tab, np.float64, (v_buckets, t_cols))
        ref_v = _view(ref, np.float64, (v_buckets, t_cols)) if tie else None
        n_blocks = -(-t_cols // 32)
        buf = _view(scratch, np.int32, (1 + n_split * (n_blocks + v_buckets * t_cols),))
        assert not buf.any(), "the scratch holds zeros: the work counter first"
        tickets = buf[1 : 1 + n_split * n_blocks].reshape(n_split, n_blocks)
        planes = buf[1 + n_split * n_blocks :].reshape(n_split, v_buckets, t_cols)
        outs = [None if ptr is None else _view(ptr, np.float64, (n_groups, t_cols))
                for ptr in (fc, main, tie, nz, tot)]
        chunks = _kernel_chunks(ip, _view(order, np.int32, (n_groups,)), work)
        written = np.zeros((n_groups, n_blocks), np.int64)
        for item in range(len(chunks) * n_blocks):
            (g, b, e, slot, parts), blk = chunks[item // n_blocks], item % n_blocks
            cols = slice(blk * 32, min(blk * 32 + 32, t_cols))
            if slot == SKIP:
                continue
            if slot == FROM_COUNTS:
                h = _view(ref_counts, np.float64, (v_buckets, t_cols))[:, cols]
            else:
                rows = torch.from_numpy(p[b:e].copy())
                h = the.row_counts_plain(xt[:, cols].contiguous(), rows, tb,
                                         is_log1p=bool(is_log1p)).numpy()
                if slot >= 0:
                    self.split_chunks += 1
                    planes[slot][:, cols] += h.astype(np.int32)
                    tickets[slot, blk] += 1
                    if tickets[slot, blk] < parts:
                        continue
                    h = planes[slot][:, cols].astype(np.float64)
            sums = _warp_order_sums(h, tab_v[:, cols],
                                    None if ref_v is None else ref_v[:, cols],
                                    bool(nnz_split), _fused_warps(v_buckets))
            for out, val in zip(outs, sums):
                if out is not None:
                    out[g, cols] = val
            written[g, blk] += 1
        assert (written == 1).all(), "every (group, column block) written once"
        return 0


def _emulate(monkeypatch):
    lib = _EmulatedFusedLibrary()
    monkeypatch.setattr(the, "_fused_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    return lib


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cuda_wrappers_with_an_emulated_library(variant, monkeypatch):
    ovo = VARIANTS[variant][0]
    xt, args, ppg, rows, layout, info = _problem(7, 128, False, ovo, empty_group=True)
    lib = _emulate(monkeypatch)
    kw = dict(n_pad=float(layout.n_pad), **_statics(variant, layout, info))
    counters = (the.hist_pass, the.hist_pass_contract, the.row_counts, the.hist_contract)
    before = [c.launches for c in counters]
    counts = the._row_counts_cuda(xt, rows, args[3], is_log1p=False)
    work = the.fused_work(np.diff(args[1].numpy()), info.ref_code)
    got = the._contract_counts(
        counts, lambda tab, a, **k: the._grouped_sums_cuda(
            xt, *args, tab, a, is_log1p=False, work=work, ref_counts=counts, **k), ppg, **kw)
    assert lib.calls == ["row_counts", "hist_contract"]
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0]
    want = the.hist_pass_contract_plain(xt, *args, ppg, count_rows=rows, is_log1p=False, **kw)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w.numpy(), err_msg=k)


def _skewed_labels(rng, n_cells, named, tiny):
    """Groups of the sizes ``named`` (name -> cells), ``tiny`` groups of
    1-3 cells and the rest in groups of 40 (the last one shorter)."""
    sizes = [*named.values(), *rng.integers(1, 4, tiny)]
    rest = n_cells - sum(sizes)
    sizes += [40] * (rest // 40) + ([rest % 40] if rest % 40 else [])
    names = [*named, *(f"g{i}" for i in range(len(sizes) - len(named)))]
    return rng.permutation(np.repeat(np.array(names), sizes))


@pytest.mark.parametrize("ovo", [False, True], ids=["ovr", "ovo"])
def test_cuda_wrappers_split_groups_with_an_emulated_library(ovo, monkeypatch):
    """A skewed tile with the split threshold lowered to 60 rows and two
    scratch planes: the two largest groups past it are split (in OVO the
    big group and "mid", the reference coming from its counts; in OVR the
    big group and the reference) and the others stay whole.  The emulated
    kernel walks its chunks through the scratch planes and equals the
    plain pass, bit for bit."""
    rng = np.random.default_rng(21)
    labels = _skewed_labels(rng, 900, {"big": 400, "ref": 150, "mid": 100, "mid2": 70}, 30)
    x = rng.poisson(1.0, (labels.size, 70)).astype(np.float32)
    x[rng.random(x.shape) < 0.5] = 0
    xt, args, ppg, rows, layout, info = fused_inputs(x, labels, 128, False,
                                                     "ref" if ovo else None, CPU,
                                                     empty_group=True)
    lib = _emulate(monkeypatch)
    monkeypatch.setattr(the, "SPLIT_ROWS", 60)
    monkeypatch.setattr(the, "MAX_SPLIT_SLOTS", 2)
    kw = dict(n_pad=float(layout.n_pad), ref_code=info.ref_code)
    counts = the._row_counts_cuda(xt, rows, args[3], is_log1p=False)
    work = the.fused_work(np.diff(args[1].numpy()), info.ref_code)
    assert work.n_slots == 2 and (work.ref_code >= 0) is ovo
    got = the._contract_counts(
        counts, lambda tab, a, **k: the._grouped_sums_cuda(
            xt, *args, tab, a, is_log1p=False, work=work, ref_counts=counts, **k), ppg, **kw)
    # 70 columns: three blocks; 400 rows in 7 parts, 100 in 2, 150 in 3.
    assert lib.split_chunks == (7 + (2 if ovo else 3)) * 3
    want = the.hist_pass_contract_plain(xt, *args, ppg, count_rows=rows, is_log1p=False, **kw)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w.numpy(), err_msg=k)


@pytest.mark.parametrize("sizes", [
    [0, 135, 3, 0, 1, 2],
    [9000, 40, 3, 1, 0, 2],  # one group of ~90%
    [77],  # G=1
    [2 * the.SPLIT_ROWS + 3616, the.SPLIT_ROWS + 808, the.SPLIT_ROWS + 1, the.SPLIT_ROWS,
     30, 0],
    "drawn",
], ids=["empty_groups", "one_90pct_group", "one_group", "at_the_threshold", "drawn"])
@pytest.mark.parametrize("ref", [None, "first", "largest"])
@pytest.mark.parametrize("t_cols", [45, 64])
def test_fused_work_covers_every_group_block_and_row_once(sizes, ref, t_cols, monkeypatch):
    """The kernel's items (each chunk once per 32-column block, as its
    decode makes them from ``order``, ``indptr`` and ``fused_work``) cover
    every (group, column block, row) exactly once: the reference's rows
    through its counts (one row-free chunk per block), a split group's
    through its parts (each at most ``SPLIT_ROWS`` rows, sharing one
    scratch plane; its own entry in ``order`` skipped), every other group
    through one chunk of all its rows.  The split groups are the largest
    ones but the reference past ``SPLIT_ROWS``, at most ``MAX_SPLIT_SLOTS``
    (2 here), and their chunks come first."""
    monkeypatch.setattr(the, "MAX_SPLIT_SLOTS", 2)
    if sizes == "drawn":
        rng = np.random.default_rng(5)
        sizes = rng.choice([0, 1, 3, 40, 135, 9000, the.SPLIT_ROWS + 7232], 60)
    real = np.asarray(sizes, np.int64)
    ref_code = {None: -1, "first": 0, "largest": int(np.argmax(real))}[ref]
    indptr = np.concatenate([[0], np.cumsum(real)])
    order = np.argsort(-real, kind="stable")
    work = the.fused_work(real, ref_code)
    chunks = _kernel_chunks(indptr, order, work)
    n_blocks = -(-t_cols // 32)
    covered = np.zeros((n_blocks, int(real.sum())), np.int64)
    from_counts = np.zeros((real.size, n_blocks), np.int64)
    for item in range(len(chunks) * n_blocks):
        (g, b, e, slot, parts), blk = chunks[item // n_blocks], item % n_blocks
        assert indptr[g] <= b <= e <= indptr[g + 1]
        if slot == FROM_COUNTS:
            assert g == ref_code and b == e
            from_counts[g, blk] += 1
        covered[blk, b:e] += 1
    ref_rows = np.zeros(covered.shape[1], bool)
    if ref_code >= 0:
        ref_rows[indptr[ref_code] : indptr[ref_code + 1]] = True
        assert (from_counts[ref_code] == 1).all() and from_counts.sum() == n_blocks
    assert (covered[:, ~ref_rows] == 1).all() and not covered[:, ref_rows].any()
    big = [g for g in np.argsort(-real, kind="stable") if g != ref_code][:2]
    assert list(work.split_groups) == [g for g in big if real[g] > the.SPLIT_ROWS]
    n_split = sum(work.split_parts)
    assert all(c[3] >= 0 for c in chunks[:n_split]) and all(c[3] < 0 for c in chunks[n_split:])
    for slot, (g, parts) in enumerate(zip(work.split_groups, work.split_parts)):
        mine = [c for c in chunks if c[0] == g]
        assert [c[3] for c in mine] == [slot] * parts + [SKIP]
        assert all(0 < e - b <= the.SPLIT_ROWS for _, b, e, *_ in mine[:-1])
    assert len(chunks) == n_split + real.size  # a split group's own entry is skipped


@pytest.mark.parametrize("scale", [2.0**52, 2.0**55], ids=["below_2_53", "past_2_53"])
@pytest.mark.parametrize("nnz_split", [False, True])
@pytest.mark.parametrize("v_buckets", [256, 512])
def test_warp_order_sums_match_the_plain_bucket_order(scale, nnz_split, v_buckets):
    """The kernel's order of the sums over v (warp classes, then the warps'
    partials; 4 warps at V=256, 8 at V=512) against the plain version's
    torch reductions, with integer terms whose sums come near ``scale``: bit
    for bit below 2^53, within rtol 1e-13 past it (where either order
    rounds)."""
    rng = np.random.default_rng(17)
    t_cols, n_groups = 37, 3
    h = rng.integers(0, 4, (n_groups, v_buckets, t_cols)).astype(np.float64)
    h[rng.random(h.shape) < 0.6] = 0
    h[:, 0] = rng.integers(0, 5, (n_groups, t_cols))
    # tab: integers whose products with h sum to just under (or past) scale.
    per = np.floor(scale / (h.sum(axis=1).max() + 1.0) / 2.0)
    tab = rng.integers(int(per // 2), int(per), (v_buckets, t_cols)).astype(np.float64)
    a = rng.integers(0, int(round((scale / 1e3) ** (1 / 3))), (v_buckets, t_cols)).astype(
        np.float64)
    got = _warp_order_sums(h, tab, a, nnz_split, _fused_warps(v_buckets))
    want = the._group_sums_plain(torch.from_numpy(h).float(), torch.from_numpy(tab),
                                 torch.from_numpy(a), nnz_split=nnz_split, total=True)
    assert float(got[1].max()) > scale / 4
    for name, g, w in zip(("fc", "main", "tie", "nz", "tot"), got, want):
        if w is None:  # nz: written under the nnz split only
            continue
        w = w.numpy()
        if scale < 2.0**53:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-13, atol=0, err_msg=name)
    if scale < 2.0**53:
        assert float(got[1].max()) < 2.0**53


def test_cuda_wrappers_check_their_inputs(monkeypatch):
    xt, args, ppg, rows, layout, info = _problem(8, 128, False, True)
    _emulate(monkeypatch)
    perm, indptr, order, table = args
    tab = torch.zeros((128, xt.shape[1]), dtype=torch.float64)
    with pytest.raises(TypeError, match="not float64"):
        the._row_counts_cuda(xt.double(), rows, table, is_log1p=False)
    with pytest.raises(ValueError, match="rows must be a contiguous 1-d torch.int32"):
        the._row_counts_cuda(xt, rows.long(), table, is_log1p=False)
    with pytest.raises(ValueError, match="table size 513 outside"):
        the._row_counts_cuda(xt, rows, torch.zeros(513), is_log1p=False)
    work = the.fused_work(np.diff(indptr.numpy()), -1)
    with pytest.raises(ValueError, match="order has"):
        the._grouped_sums_cuda(xt, perm, indptr, order[:-1], table, tab, None,
                               is_log1p=False, nnz_split=False, total=False, work=work)
    with pytest.raises(ValueError, match="tab has shape"):
        the._grouped_sums_cuda(xt, perm, indptr, order, table, tab[:, :-1].contiguous(), None,
                               is_log1p=False, nnz_split=False, total=False, work=work)
    with pytest.raises(ValueError, match="a must be a contiguous 2-d torch.float64"):
        the._grouped_sums_cuda(xt, perm, indptr, order, table, tab, tab.float(),
                               is_log1p=False, nnz_split=False, total=False, work=work)


def test_grouped_sums_check_the_work_list(monkeypatch):
    """Work that takes the reference group from counts needs those counts,
    (V, T) float64, and work for other groups is refused."""
    xt, args, ppg, rows, layout, info = _problem(8, 128, False, True)
    _emulate(monkeypatch)
    tab = torch.zeros((128, xt.shape[1]), dtype=torch.float64)
    sizes = np.diff(args[1].numpy())
    work = the.fused_work(sizes, info.ref_code)
    kw = dict(is_log1p=False, nnz_split=False, total=True)
    with pytest.raises(ValueError, match="takes the reference group from ref_counts"):
        the._grouped_sums_cuda(xt, *args, tab, tab, work=work, **kw)
    with pytest.raises(ValueError, match="ref_counts has shape"):
        the._grouped_sums_cuda(xt, *args, tab, tab, work=work, ref_counts=tab[:-1], **kw)
    for bad in (work._replace(ref_code=sizes.size), work._replace(split_groups=(sizes.size,),
                                                                  split_parts=(2,))):
        with pytest.raises(ValueError, match="does not fit"):
            the._grouped_sums_cuda(xt, *args, tab, tab, work=bad, ref_counts=tab, **kw)


def test_probe_variants_edit_the_sources():
    """Every diagnostic variant of ``hist_fused_probe.py`` edits text that
    the kernel's sources hold once, so the probe builds what it says."""
    import hist_fused_probe

    text = "".join((cuda_build.SRC_DIR / f).read_text()
                   for f in ("hist_fused.cu", "hist_common.cuh"))
    assert hist_fused_probe.VARIANTS["shipped"] == {}
    for name, edits in hist_fused_probe.VARIANTS.items():
        for anchor in edits:
            assert text.count(anchor) == 1, (name, anchor)


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """An edit to a ``csrc/*.cuh`` header changes every library's build key,
    so the libraries that include it are rebuilt."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(cuda_build, "SRC_DIR", tmp_path)
    first = cuda_build._target("k")
    assert cuda_build._target("k") == first
    header.write_text("// two\n")
    assert cuda_build._target("k") != first
    assert (cuda_build._PKG / "csrc" / "hist_common.cuh").exists()
