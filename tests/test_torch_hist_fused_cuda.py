"""The fused single-device pass (``csrc/hist_fused.cu``) on the card against
its plain torch version and against K1 + the contraction kernels, on the
same tiles.

Every test here needs a CUDA device and skips without one.  The file
imports torch and the port only, so on a machine without jax it runs
alone: ``python -m pytest --noconftest -p no:randomly -m cuda
tests/test_torch_hist_fused_cuda.py``.  Equal means bit-equal wherever the
statics' tiers are exact (below 2^53); the one case past 2^53 says so.
"""

import numpy as np
import pytest
import torch

from illico_tpu_torch.ops import hist_engine as the
from illico_tpu_torch.ops import rank_engine as tre
from illico_tpu_torch.utils import groups as tgroups
from test_torch_contract_cuda import VARIANTS, _card_case, _statics


def fused_inputs(x, labels, v_buckets, is_log1p, ref, device, empty_group=False):
    """The fused pass's inputs for a tile: the tile and K1's arrays on
    ``device``, the pads per group, the counting rows, the layout and the
    groups.  ``empty_group`` appends a group with no real rows (the
    runner's layouts never have one; the kernels must still give zeros)."""
    _, info = tgroups.encode_and_count_groups(labels, ref)
    layout = tre.build_padded_layout(info.perm, info.indptr)
    arrs = the.prepare_hist_inputs(layout, v_buckets, is_log1p, device)
    perm, indptr, ppg = arrs["perm"], arrs["indptr"], arrs["ppg"]
    if empty_group:
        indptr = torch.cat([indptr, indptr[-1:]])
        ppg = torch.cat([ppg, ppg.new_zeros(1)])
    sizes = torch.diff(indptr).cpu().numpy()
    order = torch.from_numpy(np.argsort(-sizes, kind="stable").astype(np.int32)).to(device)
    args = (perm, indptr, order, arrs["table"])
    rows = the.counting_rows(the.real_rows_per_group(layout), perm, info.ref_code)
    return torch.from_numpy(x).to(device), args, ppg, rows, layout, info


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernels have no CPU mode")
    return torch.device("cuda")


def _log1p_case(seed, n_cells, t_cols, n_groups, is_log1p):
    x, labels = _card_case(seed, n_cells, t_cols, n_groups)
    if is_log1p:
        x = np.log1p(x).astype(np.float32)
    return x, labels


def _assert_equal(got, want, tag):
    assert got.keys() == want.keys(), tag
    for k, w in want.items():
        assert got[k].dtype == w.dtype, (tag, k)
        assert torch.equal(got[k], w), (tag, k)


@pytest.mark.cuda
@pytest.mark.parametrize("v_buckets", [128, 512])
@pytest.mark.parametrize("is_log1p", [False, True], ids=["raw", "log1p"])
def test_cuda_row_counts_match_plain(cuda_device, v_buckets, is_log1p):
    x, labels = _log1p_case(11, 6000, 333, 40, is_log1p)
    xd, args, _, rows, layout, info = fused_inputs(x, labels, v_buckets, is_log1p, "ref",
                                                   cuda_device)
    hist = the.hist_pass_plain(xd, *args, is_log1p=is_log1p)
    for tag, r, want in (("reference", rows, hist[info.ref_code].double()),
                         ("every row", args[0], hist.double().sum(dim=0))):
        before = the.row_counts.launches
        got = the.row_counts(xd, r, args[3], is_log1p=is_log1p)
        plain = the.row_counts_plain(xd, r, args[3], is_log1p=is_log1p)
        torch.cuda.synchronize()
        assert the.row_counts.launches == before + 1
        assert got.dtype == torch.float64 and torch.equal(got, plain), tag
        assert torch.equal(got, want), tag


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("v_buckets", [128, 512])
@pytest.mark.parametrize("is_log1p", [False, True], ids=["raw", "log1p"])
@pytest.mark.parametrize("shape", [(6000, 1000, 40), (3000, 333, 9)], ids=["even", "odd_width"])
def test_cuda_fused_matches_plain_and_histogram_path(cuda_device, variant, v_buckets,
                                                     is_log1p, shape):
    ovo = VARIANTS[variant][0]
    x, labels = _log1p_case(9, *shape, is_log1p)
    xd, args, ppg, rows, layout, info = fused_inputs(
        x, labels, v_buckets, is_log1p, "ref" if ovo else None, cuda_device,
        empty_group=True)
    kw = dict(n_pad=float(layout.n_pad), **_statics(variant, layout, info))
    counters = (the.hist_pass, the.hist_pass_contract, the.row_counts, the.hist_contract)
    before = [c.launches for c in counters]
    got = the.hist_pass_contract(xd, *args, ppg, count_rows=rows, is_log1p=is_log1p, **kw)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0]
    want = the.hist_pass_contract_plain(xd, *args, ppg, count_rows=rows, is_log1p=is_log1p,
                                        **kw)
    hist = the.hist_pass(xd, *args, is_log1p=is_log1p)
    via_hist = the.hist_contract(hist, ppg, **kw)
    torch.cuda.synchronize()
    assert not bool(hist[-1].any())  # the empty group
    _assert_equal(got, want, "plain")
    _assert_equal(got, via_hist, "K1 + hist_contract")


@pytest.mark.cuda
@pytest.mark.parametrize("ovo", [False, True], ids=["ovr", "ovo"])
def test_cuda_fused_one_group(cuda_device, ovo):
    """G=1: OVR with a single group (the reference itself under OVO)."""
    x, _ = _card_case(10, 2000, 77, 1)
    labels = np.full(2000, "ref")
    xd, args, ppg, rows, layout, info = fused_inputs(x, labels, 128, False,
                                                     "ref" if ovo else None, cuda_device)
    kw = dict(n_pad=float(layout.n_pad), ref_code=info.ref_code)
    got = the.hist_pass_contract(xd, *args, ppg, count_rows=rows, is_log1p=False, **kw)
    want = the.hist_pass_contract_plain(xd, *args, ppg, count_rows=rows, is_log1p=False, **kw)
    torch.cuda.synchronize()
    _assert_equal(got, want, "plain")


@pytest.mark.cuda
def test_cuda_fused_past_2_53(cuda_device):
    """Two groups of 150,000 cells with every count in one bucket: OVO's
    tie sums (~2e16) pass 2^53, where the sum over v rounds and its order
    (the warps' partial sums against torch's reduction) may change the
    last bits: rtol 1e-13, as the contraction kernels' own test.  Every
    other statistic is an integer below 2^53 and stays bit-equal."""
    n = 150_000
    x = np.zeros((2 * n, 4), np.float32)
    x[:, 1] = 3.0
    x[::7, 2] = 1.0
    x[::13, 2] = 2.0  # three buckets: a sum whose order can matter
    x[::11, 3] = 2.0
    labels = np.repeat(np.array(["ref", "g1"]), n)
    xd, args, ppg, rows, layout, info = fused_inputs(x, labels, 128, False, "ref", cuda_device)
    kw = dict(n_pad=float(layout.n_pad), ref_code=info.ref_code)
    got = the.hist_pass_contract(xd, *args, ppg, count_rows=rows, is_log1p=False, **kw)
    want = the.hist_pass_contract_plain(xd, *args, ppg, count_rows=rows, is_log1p=False, **kw)
    torch.cuda.synchronize()
    assert float(want["tie_seg"].max()) > 2.0**53
    for k, w in want.items():
        if k == "tie_seg":
            torch.testing.assert_close(got[k], w, rtol=1e-13, atol=0)
        else:
            assert torch.equal(got[k], w), k
