"""The histogram contraction of the port: plain version, kernel wrapper, kernel.

- ``hist_contract`` on CPU histograms (its plain version,
  ``hist_contract_plain``) equals ``illico_tpu.ops.hist_engine.hist_contract``
  (JAX in x64 on the CPU) bit for bit in every variant the statics allow:
  OVO and OVR, the nnz split on and off (with ``fc_u8``), the fc and R2 row
  splits, raw and log1p tables, unpacked and packed; each from 1, 2 and 3
  shard histograms (the cell mesh's: the tile's rows in contiguous blocks,
  each counted on its own), whose sum the reference contracts, with the
  tables' counts given from the rows or taken from the histograms;
- a CPU histogram never reaches the kernel's library, another device
  raises, and shards whose shapes, dtypes or devices differ are refused;
- the CUDA wrapper's plumbing (argument order, the shards' address array,
  null arrays, launch counts) runs on the CPU against a numpy rendering of
  the C entry point of ``csrc/hist_contract.cu``, which sums the shards and
  walks v in the kernel's warp order, and gives the plain version's bits;
- the kernel itself is held equal to the plain version on the card by
  ``tests/test_torch_contract_cuda.py`` and, at full width, by
  ``chip_smoke.py``.
"""

import contextlib
import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import illico_tpu.ops.hist_engine as jhe
from illico_tpu_torch.ops import hist_engine as the
from test_torch_contract_cuda import VARIANTS, _statics, shard_histograms
from test_torch_hist import _case, _jax_hist, _torch_inputs


def _inputs(seed, is_log1p, ovo, n_cells=300, t_cols=40):
    x, labels = _case(seed, 128, is_log1p, n_cells=n_cells, t_cols=t_cols)
    labels = np.where(labels == 1, "ref", labels.astype(str))
    ref = "ref" if ovo else None
    arrs, layout, info = _torch_inputs(labels, 128, is_log1p, ref)
    hist = the.hist_pass(
        torch.from_numpy(x), arrs["perm"], arrs["indptr"], arrs["order"],
        arrs["table"], is_log1p=is_log1p,
    )
    return x, labels, ref, hist, arrs, layout, info


@functools.lru_cache(maxsize=None)
def _reference_hist(seed, is_log1p, ovo):
    """The JAX package's histogram of ``_inputs``' tile (Pallas in interpret
    mode), made once per case: every variant and shard count contracts it."""
    x, labels, ref, *_ = _inputs(seed, is_log1p, ovo)
    jhist, jppg, jlayout, jinfo = _jax_hist(x, labels, 128, is_log1p, ref)
    return np.asarray(jhist)[:, :, : x.shape[1]], jlayout.n_pad, jinfo.ref_code


def _given_counts(n_shards):
    """Whether the shards come with their rows' counts (``counts=``): with 1
    and 3 shards, and without (taken from the histograms) with 2."""
    return n_shards % 2 == 1


@pytest.mark.parametrize("n_shards", [1, 2, 3])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("is_log1p", [False, True])
@pytest.mark.parametrize("pack", [False, True])
def test_hist_contract_variants_match_reference(variant, is_log1p, pack, n_shards):
    ovo = VARIANTS[variant][0]
    x, labels, ref, hist, arrs, layout, info = _inputs(5, is_log1p, ovo)
    ppg = arrs["ppg"]
    kw = _statics(variant, layout, info)
    jhist, n_pad, ref_code = _reference_hist(5, is_log1p, ovo)
    assert ref_code == info.ref_code and n_pad == layout.n_pad
    np.testing.assert_array_equal(jhist, hist.numpy())
    shards, counts = shard_histograms(x, info, arrs["table"], is_log1p, n_shards, "cpu")
    assert torch.equal(sum(shards[1:], shards[0]), hist)
    # Both on the same T columns: the reference's tile is padded to 128.
    with jax.enable_x64(True):
        want = jhe.hist_contract(
            jnp.asarray(jhist), jnp.asarray(ppg.numpy()), n_pad=float(layout.n_pad),
            is_log1p=is_log1p, pack=pack, **kw,
        )
    given = dict(counts=counts) if _given_counts(n_shards) else {}
    got = the.hist_contract(shards, ppg, n_pad=float(layout.n_pad), pack=pack, **given, **kw)
    plain = the.hist_contract_plain(hist, ppg, n_pad=float(layout.n_pad), pack=pack, **kw)
    if pack:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(got, plain)
        return
    assert got.keys() == want.keys() == plain.keys()
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
        assert torch.equal(got[k], plain[k]), k
    assert got["overflow_cols"][3:].any() and not got["overflow_cols"][:3].any()


def test_cpu_histogram_takes_the_plain_path(monkeypatch):
    _, _, _, hist, arrs, layout, info = _inputs(6, False, True)
    ppg = arrs["ppg"]

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU histogram reached the kernel's library")

    monkeypatch.setattr(the, "_contract_library", refuse)
    kw = dict(n_pad=float(layout.n_pad), ref_code=info.ref_code, nnz_split=True)
    before = the.hist_contract.launches
    got = the.hist_contract(hist, ppg, **kw)
    want = the.hist_contract_plain(hist, ppg, **kw)
    assert the.hist_contract.launches == before
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    with pytest.raises(ValueError, match="unsupported device"):
        the.hist_contract(torch.empty((2, 3, 4), device="meta"), ppg, **kw)


@pytest.mark.parametrize("other", ["shape", "dtype", "device"])
def test_shards_that_differ_are_refused(other):
    """Shards of one contraction share one shape, dtype and device, on the
    plain path and the kernel's alike."""
    _, _, _, hist, arrs, layout, info = _inputs(6, False, False)
    odd = {"shape": hist[:, :, :-1].contiguous(), "dtype": hist.double(),
           "device": torch.zeros(hist.shape, device="meta")}[other]
    kw = dict(n_pad=float(layout.n_pad), ref_code=info.ref_code)
    for fn in (the.hist_contract, the.hist_contract_plain):
        with pytest.raises(ValueError, match="shard 1 is"):
            fn([hist, odd], arrs["ppg"], **kw)
    with pytest.raises(ValueError, match="shard 1 is"):
        the._group_sums_cuda([hist, odd], None, None, nnz_split=False, total=False)


def test_given_counts_are_checked():
    _, _, _, hist, arrs, layout, info = _inputs(6, False, False)
    kw = dict(n_pad=float(layout.n_pad), ref_code=info.ref_code)
    counts = the._value_counts_plain(hist)
    with pytest.raises(ValueError, match="counts have shape"):
        the.hist_contract(hist, arrs["ppg"], counts=counts[:, :-1].contiguous(), **kw)
    with pytest.raises(ValueError, match="counts must be a contiguous 2-d torch.float64"):
        the.hist_contract(hist, arrs["ppg"], counts=counts.float(), **kw)


# -- the CUDA wrapper against a numpy rendering of the C entry point -------------
KERNEL_WARPS = 8  # csrc/hist_contract.cu:kWarps, the warps that split a column's v


def _view(ptr, dtype, shape):
    n = int(np.prod(shape))
    ctype = {np.float32: ctypes.c_float, np.float64: ctypes.c_double,
             np.int64: ctypes.c_int64}[dtype]
    return np.ctypeslib.as_array((ctype * n).from_address(ptr)).reshape(shape)


class _EmulatedLibrary:
    """``illico_contract`` in numpy, on host pointers, with the C signature
    and the kernel's order of work: the shards' counts summed in float32,
    warp w walking v = 1 + w, 1 + w + W, ... ascending (warp 0 v = 0
    first), zero counts skipped, v=0 left out of main and tie under the
    split, the warps' partial sums added in warp order."""

    def __init__(self):
        self.calls = []

    def illico_contract(self, hists, n_shards, tab, ref, fc, main, tie, nz, tot,
                        t_cols, n_groups, v_buckets, nnz_split, vec, stream):
        self.calls.append(("contract", n_shards, vec))
        shape = (n_groups, v_buckets, t_cols)
        addrs = _view(hists, np.int64, (n_shards,))
        h = _view(int(addrs[0]), np.float32, shape).copy()
        for addr in addrs[1:]:
            h += _view(int(addr), np.float32, shape)
        h = h.astype(np.float64)
        tb = _view(tab, np.float64, (v_buckets, t_cols))
        a = _view(ref, np.float64, (v_buckets, t_cols)) if tie else None
        total = {k: np.zeros((n_groups, t_cols)) for k in ("fc", "nz", "main", "tie")}
        for w in range(KERNEL_WARPS):
            s = {k: np.zeros((n_groups, t_cols)) for k in total}
            if w == 0 and not nnz_split:
                s["main"] += h[:, 0, :] * tb[0]
                if a is not None:
                    s["tie"] += (h[:, 0] ** 3 - h[:, 0]) + 3.0 * a[0] * h[:, 0] * (a[0] + h[:, 0])
            for v in range(1 + w, v_buckets, KERNEL_WARPS):
                hv = h[:, v, :]
                s["fc"] += hv * float(v)
                s["nz"] += hv
                s["main"] += hv * tb[v]
                if a is not None:
                    s["tie"] += (hv * hv * hv - hv) + 3.0 * a[v] * hv * (a[v] + hv)
            for k in total:
                total[k] += s[k]
        for name, ptr in (("fc", fc), ("main", main), ("tie", tie)):
            if ptr:
                _view(ptr, np.float64, (n_groups, t_cols))[:] = total[name]
        if nnz_split:
            _view(nz, np.float64, (n_groups, t_cols))[:] = total["nz"]
        if tot:
            _view(tot, np.float64, (n_groups, t_cols))[:] = total["nz"] + h[:, 0, :]
        return 0


def _emulate(monkeypatch):
    lib = _EmulatedLibrary()
    monkeypatch.setattr(the, "_contract_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    return lib


@pytest.mark.parametrize("n_shards", [1, 2, 3])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cuda_wrappers_with_an_emulated_library(variant, n_shards, monkeypatch):
    ovo = VARIANTS[variant][0]
    x, _, _, hist, arrs, layout, info = _inputs(7, False, ovo)
    shards, counts = shard_histograms(x, info, arrs["table"], False, n_shards, "cpu")
    lib = _emulate(monkeypatch)
    kw = dict(n_pad=float(layout.n_pad), **_statics(variant, layout, info))
    given = dict(counts=counts) if _given_counts(n_shards) else {}
    before = the.hist_contract.launches
    got = the._contract(shards, arrs["ppg"], the._group_sums_cuda, **given, **kw)
    # One launch in OVO and OVR alike; 40 columns: 16-byte loads.
    assert lib.calls == [("contract", n_shards, 1)]
    assert the.hist_contract.launches == before + 1
    want = the.hist_contract_plain(hist, arrs["ppg"], **kw)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w.numpy(), err_msg=k)


def test_cuda_wrapper_takes_4_byte_loads_off_16_byte_rows(monkeypatch):
    """A width that is not a multiple of 4 puts rows off 16-byte
    boundaries: the wrapper launches the 4-byte-load build."""
    x, _, _, hist, arrs, layout, info = _inputs(7, False, False, t_cols=39)
    lib = _emulate(monkeypatch)
    kw = dict(n_pad=float(layout.n_pad), ref_code=info.ref_code)
    got = the._contract([hist, torch.zeros_like(hist)], arrs["ppg"], the._group_sums_cuda, **kw)
    assert lib.calls == [("contract", 2, 0)]
    for k, w in the.hist_contract_plain(hist, arrs["ppg"], **kw).items():
        assert torch.equal(got[k], w), k


def test_cuda_wrappers_check_their_inputs(monkeypatch):
    _, _, _, hist, _, _, _ = _inputs(8, False, True)
    monkeypatch.setattr(the, "_contract_library", _EmulatedLibrary)
    tab = torch.zeros(hist.shape[1:], dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous 3-d torch.float32"):
        the._group_sums_cuda(hist.double(), tab, None, nnz_split=False, total=False)
    with pytest.raises(ValueError, match="contiguous 3-d torch.float32"):
        the._group_sums_cuda([hist, hist.transpose(1, 2).contiguous().transpose(1, 2)], tab,
                             None, nnz_split=False, total=False)
    with pytest.raises(ValueError, match="tab has shape"):
        the._group_sums_cuda(hist, tab[:, :-1].contiguous(), None, nnz_split=False,
                             total=False)
    with pytest.raises(ValueError, match="a must be a contiguous 2-d torch.float64"):
        the._group_sums_cuda(hist, tab, tab.float(), nnz_split=False, total=False)


def test_probe_variants_edit_the_sources():
    """Every variant of ``hist_contract_probe.py`` edits text that the
    kernel's source holds once, so the probe builds what it says, and the
    emulation walks v in the shipped kernel's groups."""
    import re

    import hist_contract_probe

    from illico_tpu_torch.utils import cuda_build

    text = (cuda_build.SRC_DIR / "hist_contract.cu").read_text()
    assert hist_contract_probe.VARIANTS["shipped"] == {}
    for name, edits in hist_contract_probe.VARIANTS.items():
        for anchor in edits:
            assert text.count(anchor) == 1, (name, anchor)
    assert int(re.search(r"constexpr int kWarps = (\d+);", text).group(1)) == KERNEL_WARPS
