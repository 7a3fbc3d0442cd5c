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
  launch counts) runs on the CPU against a numpy rendering of the C entry
  points of ``csrc/hist_fused.cu``;
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
        return hist

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


class _EmulatedFusedLibrary:
    """``illico_row_counts`` and ``illico_hist_contract`` on host pointers,
    with the C signatures: the counts in numpy from the pointers, the sums
    by the plain version's arithmetic, written where the C code writes."""

    def __init__(self):
        self.calls = []

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

    def illico_hist_contract(self, x, perm, indptr, order, table, tab, ref, fc, main, tie,
                             nz, tot, t_cols, n_groups, v_buckets, is_log1p, nnz_split,
                             stream):
        self.calls.append("hist_contract")
        ip = _view(indptr, np.int64, (n_groups + 1,))
        p = _view(perm, np.int32, (int(ip[-1]),))
        n_cells = int(p.max()) + 1
        args = [torch.from_numpy(a.copy()) for a in (
            _view(x, np.float32, (n_cells, t_cols)), p, ip,
            _view(order, np.int32, (n_groups,)), _view(table, np.float32, (v_buckets,)))]
        hist = the.hist_pass_plain(*args, is_log1p=bool(is_log1p))
        tb = torch.from_numpy(_view(tab, np.float64, (v_buckets, t_cols)).copy())
        a = torch.from_numpy(_view(ref, np.float64, (v_buckets, t_cols)).copy()) if tie else None
        sums = the._group_sums_plain(hist, tb, a, nnz_split=bool(nnz_split), total=bool(tot))
        for ptr, s in zip((fc, main, tie, nz, tot), sums):
            assert (ptr is None) == (s is None)
            if ptr is not None:
                _view(ptr, np.float64, (n_groups, t_cols))[:] = s.numpy()
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
    got = the._contract_counts(
        counts, lambda tab, a, **k: the._grouped_sums_cuda(xt, *args, tab, a, is_log1p=False,
                                                           **k), ppg, **kw)
    assert lib.calls == ["row_counts", "hist_contract"]
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0]
    want = the.hist_pass_contract_plain(xt, *args, ppg, count_rows=rows, is_log1p=False, **kw)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w.numpy(), err_msg=k)


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
    with pytest.raises(ValueError, match="order has"):
        the._grouped_sums_cuda(xt, perm, indptr, order[:-1], table, tab, None,
                               is_log1p=False, nnz_split=False, total=False)
    with pytest.raises(ValueError, match="tab has shape"):
        the._grouped_sums_cuda(xt, perm, indptr, order, table, tab[:, :-1].contiguous(), None,
                               is_log1p=False, nnz_split=False, total=False)
    with pytest.raises(ValueError, match="a must be a contiguous 2-d torch.float64"):
        the._grouped_sums_cuda(xt, perm, indptr, order, table, tab, tab.float(),
                               is_log1p=False, nnz_split=False, total=False)


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
