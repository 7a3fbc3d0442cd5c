"""The histogram contraction of the port: plain version, kernel wrappers, kernel.

- ``hist_contract`` on a CPU histogram (its plain version,
  ``hist_contract_plain``) equals ``illico_tpu.ops.hist_engine.hist_contract``
  (JAX in x64 on the CPU) bit for bit in every variant the statics allow:
  OVO and OVR, the nnz split on and off (with ``fc_u8``), the fc and R2 row
  splits, raw and log1p tables, unpacked and packed;
- a CPU histogram never reaches the kernels' library, and another device
  raises;
- the CUDA wrappers' plumbing (argument order, the pointers, null arrays,
  launch counts) runs on the CPU against a numpy rendering of the C entry
  points of ``csrc/hist_contract.cu``, walking v in the kernels' order, and
  gives the plain version's bits;
- the kernels themselves are held equal to the plain version on the card
  by ``tests/test_torch_contract_cuda.py`` and, at full width, by
  ``chip_smoke.py``.
"""

import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import illico_tpu.ops.hist_engine as jhe
from illico_tpu_torch.ops import hist_engine as the
from test_torch_contract_cuda import VARIANTS, _statics
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
    return x, labels, ref, hist, arrs["ppg"], layout, info


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("is_log1p", [False, True])
@pytest.mark.parametrize("pack", [False, True])
def test_hist_contract_variants_match_reference(variant, is_log1p, pack):
    ovo = VARIANTS[variant][0]
    x, labels, ref, hist, ppg, layout, info = _inputs(5, is_log1p, ovo)
    kw = _statics(variant, layout, info)
    jhist, jppg, jlayout, jinfo = _jax_hist(x, labels, 128, is_log1p, ref)
    assert jinfo.ref_code == info.ref_code and jlayout.n_pad == layout.n_pad
    np.testing.assert_array_equal(np.asarray(jhist)[:, :, : x.shape[1]], hist.numpy())
    # Both on the same T columns: the reference's tile is padded to 128.
    with jax.enable_x64(True):
        want = jhe.hist_contract(
            jnp.asarray(hist.numpy()), jnp.asarray(ppg.numpy()), n_pad=float(layout.n_pad),
            is_log1p=is_log1p, pack=pack, **kw,
        )
    got = the.hist_contract(hist, ppg, n_pad=float(layout.n_pad), pack=pack, **kw)
    if pack:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
    assert got["overflow_cols"][3:].any() and not got["overflow_cols"][:3].any()


def test_cpu_histogram_takes_the_plain_path(monkeypatch):
    _, _, _, hist, ppg, layout, info = _inputs(6, False, True)

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU histogram reached the kernels' library")

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


# -- the CUDA wrappers against a numpy rendering of the C entry points -----------
def _view(ptr, dtype, shape):
    n = int(np.prod(shape))
    ctype = {np.float32: ctypes.c_float, np.float64: ctypes.c_double}[dtype]
    return np.ctypeslib.as_array((ctype * n).from_address(ptr)).reshape(shape)


class _EmulatedLibrary:
    """``illico_value_counts`` and ``illico_contract`` in numpy, on host
    pointers, with the C signatures and the kernels' order of work: v
    walked in order, zero counts skipped, v=0 left out under the split."""

    def __init__(self):
        self.calls = []

    def illico_value_counts(self, hist, c, t_cols, n_groups, v_buckets, stream):
        self.calls.append("value_counts")
        h = _view(hist, np.float32, (n_groups, v_buckets, t_cols)).astype(np.float64)
        out = _view(c, np.float64, (v_buckets, t_cols))
        assert not out.any(), "value_counts adds into zeros"
        out += h.sum(axis=0)
        return 0

    def illico_contract(self, hist, tab, ref, fc, main, tie, nz, tot,
                        t_cols, n_groups, v_buckets, nnz_split, stream):
        self.calls.append("contract")
        shape = (n_groups, t_cols)
        h = _view(hist, np.float32, (n_groups, v_buckets, t_cols)).astype(np.float64)
        tb = _view(tab, np.float64, (v_buckets, t_cols))
        a = _view(ref, np.float64, (v_buckets, t_cols)) if tie else None
        s = {k: np.zeros(shape) for k in ("fc", "main", "tie", "nz")}
        for v in range(v_buckets):
            hv = h[:, v, :]
            if v > 0:
                s["fc"] += hv * float(v)
                s["nz"] += hv
            if v > 0 or not nnz_split:
                s["main"] += hv * tb[v]
                if a is not None:
                    s["tie"] += (hv * hv * hv - hv) + 3.0 * a[v] * hv * (a[v] + hv)
        for name, ptr in (("fc", fc), ("main", main), ("tie", tie)):
            if ptr:
                _view(ptr, np.float64, shape)[:] = s[name]
        if nnz_split:
            _view(nz, np.float64, shape)[:] = s["nz"]
        if tot:
            _view(tot, np.float64, shape)[:] = s["nz"] + h[:, 0, :]
        return 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cuda_wrappers_with_an_emulated_library(variant, monkeypatch):
    ovo = VARIANTS[variant][0]
    _, _, _, hist, ppg, layout, info = _inputs(7, False, ovo)
    lib = _EmulatedLibrary()
    monkeypatch.setattr(the, "_contract_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    kw = dict(n_pad=float(layout.n_pad), **_statics(variant, layout, info))
    before = the.hist_contract.launches
    got = the._contract(hist, ppg, the._value_counts_cuda, the._group_sums_cuda, **kw)
    assert lib.calls == (["contract"] if ovo else ["value_counts", "contract"])
    assert the.hist_contract.launches == before + len(lib.calls)
    want = the.hist_contract_plain(hist, ppg, **kw)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w.numpy(), err_msg=k)


def test_cuda_wrappers_check_their_inputs(monkeypatch):
    _, _, _, hist, ppg, layout, info = _inputs(8, False, True)
    monkeypatch.setattr(the, "_contract_library", _EmulatedLibrary)
    tab = torch.zeros(hist.shape[1:], dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous 3-d torch.float32"):
        the._group_sums_cuda(hist.double(), tab, None, nnz_split=False, total=False)
    with pytest.raises(ValueError, match="contiguous 3-d torch.float32"):
        the._value_counts_cuda(hist.transpose(1, 2))
    with pytest.raises(ValueError, match="tab has shape"):
        the._group_sums_cuda(hist, tab[:, :-1].contiguous(), None, nnz_split=False,
                             total=False)
    with pytest.raises(ValueError, match="a must be a contiguous 2-d torch.float64"):
        the._group_sums_cuda(hist, tab, tab.float(), nnz_split=False, total=False)
