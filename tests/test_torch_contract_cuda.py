"""The contraction kernel (``csrc/hist_contract.cu``) on the card against
its plain torch version, on the same histograms: one, or the cell mesh's
shards of it (2 and 3), which the kernel sums as it reads them.

Every test here needs a CUDA device and skips without one.  The file
imports torch and the port only, so on a machine without jax it runs
alone: ``python -m pytest --noconftest -p no:randomly -m cuda
tests/test_torch_contract_cuda.py``.  Equal means bit-equal wherever the
statics' tiers are exact (below 2^53); the one case past 2^53 says so.
"""

import numpy as np
import pytest
import torch

from illico_tpu_torch.ops import hist_engine as the
from illico_tpu_torch.ops import rank_engine as tre
from illico_tpu_torch.parallel.cells import build_cell_shard_plans
from illico_tpu_torch.utils import groups as tgroups

# name -> (OVO?, statics beyond ref_code); "big" is the largest group's code.
VARIANTS = {
    "ovr": (False, {}),
    "ovr_row_splits": (False, {"u2_split_code": "big", "fc_split_code": "big"}),
    "ovo": (True, {}),
    "ovo_fc_split": (True, {"fc_split_code": "big"}),
    "ovo_nnz_split": (True, {"nnz_split": True}),
    "ovo_nnz_split_fc_u8": (True, {"nnz_split": True, "fc_u8": True, "fc_split_code": "ref"}),
}


def _statics(variant, layout, info):
    """``hist_contract``'s keywords for ``variant`` on this layout, less ``n_pad``."""
    extra = VARIANTS[variant][1]
    big = int(np.argmax(the.real_rows_per_group(layout)))
    codes = {"big": big, "ref": info.ref_code}
    kw = {k: codes.get(v, v) if isinstance(v, str) else v for k, v in extra.items()}
    return dict(ref_code=info.ref_code, **kw)


def _card_hist(x, labels, v_buckets, ref, device):
    """K1's histogram of ``x`` on the card, its pads per group, layout and groups."""
    _, info = tgroups.encode_and_count_groups(labels, ref)
    layout = tre.build_padded_layout(info.perm, info.indptr)
    arrs = the.prepare_hist_inputs(layout, v_buckets, False, device)
    hist = the.hist_pass(torch.from_numpy(x).to(device), arrs["perm"], arrs["indptr"],
                         arrs["order"], arrs["table"], is_log1p=False)
    return hist, arrs["ppg"], layout, info


def shard_histograms(x, info, table, is_log1p, n_shards, device):
    """The cell mesh's shards of the tile ``x`` (numpy, groups ``info``):
    its rows in ``n_shards`` contiguous blocks, each block's histogram on its
    own local inputs, and the tables' counts from the rows (OVR: every
    row's value counts; OVO: the reference's rows'), the blocks' counts
    added.  Returns (histograms, counts) on ``device``."""
    plan = build_cell_shard_plans(info, n_shards)
    table = table.to(device)
    hists, counts = [], None
    for s, (lo, hi) in enumerate(plan.row_bounds):
        xs = torch.from_numpy(np.ascontiguousarray(x[lo:hi])).to(device)
        perm, indptr, order = (torch.from_numpy(a).to(device)
                               for a in (plan.perm[s], plan.indptr[s], plan.order[s]))
        hists.append(the.hist_pass(xs, perm, indptr, order, table, is_log1p=is_log1p))
        rows = perm
        if info.ref_code >= 0:
            ptr = plan.indptr[s]
            rows = perm[int(ptr[info.ref_code]) : int(ptr[info.ref_code + 1])]
        part = the.row_counts(xs, rows, table, is_log1p=is_log1p)
        counts = part if counts is None else counts + part
    return hists, counts


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the contraction kernel has no CPU mode")
    return torch.device("cuda")


def _card_case(seed, n_cells, t_cols, n_groups):
    """Counts with ~80% zeros and one column past the table; labels with a
    reference of ~30% of the cells."""
    rng = np.random.default_rng(seed)
    x = rng.poisson(rng.uniform(0.2, 4.0, t_cols), (n_cells, t_cols)).astype(np.float32)
    x[rng.random(x.shape) < 0.8] = 0
    x[rng.integers(0, n_cells, 5), 0] = 700.0  # a column off the table
    labels = rng.integers(1, n_groups, n_cells) if n_groups > 1 else np.zeros(n_cells, int)
    labels[rng.random(n_cells) < 0.3] = 0  # the reference, ~30%
    labels = np.where(labels == 0, "ref", np.char.add("g", labels.astype(str)))
    return x, labels


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 2, 3])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("shape", [(6000, 1000, 40), (3000, 333, 9)], ids=["even", "odd_width"])
def test_cuda_kernels_match_plain(cuda_device, variant, shape, n_shards):
    """The kernel on the cell mesh's shards (one histogram: S=1), the
    tables' counts from the rows with an odd shard count and from the
    histograms with an even one, against the plain version of the
    unsharded histogram."""
    ovo = VARIANTS[variant][0]
    n_cells, t_cols, n_groups = shape
    x, labels = _card_case(9, n_cells, t_cols, n_groups)
    hist, ppg, layout, info = _card_hist(x, labels, 512, "ref" if ovo else None, cuda_device)
    table = the.prepare_hist_inputs(layout, 512, False, cuda_device)["table"]
    shards, counts = shard_histograms(x, info, table, False, n_shards, cuda_device)
    kw = dict(n_pad=float(layout.n_pad), **_statics(variant, layout, info))
    given = dict(counts=counts) if n_shards % 2 else {}
    before = the.hist_contract.launches
    got = the.hist_contract(shards, ppg, **given, **kw)
    want = the.hist_contract_plain(hist, ppg, **kw)
    torch.cuda.synchronize()
    assert the.hist_contract.launches == before + 1
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert torch.equal(got[k], w), k


@pytest.mark.cuda
@pytest.mark.parametrize("ovo", [False, True], ids=["ovr", "ovo"])
def test_cuda_kernels_match_plain_one_group(cuda_device, ovo):
    """G=1: OVR with a single group (the reference itself under OVO)."""
    x, _ = _card_case(10, 2000, 77, 1)
    labels = np.full(2000, "ref")
    hist, ppg, layout, info = _card_hist(x, labels, 128, "ref" if ovo else None, cuda_device)
    assert hist.shape[0] == 1
    kw = dict(n_pad=float(layout.n_pad), ref_code=info.ref_code)
    got = the.hist_contract(hist, ppg, **kw)
    want = the.hist_contract_plain(hist, ppg, **kw)
    torch.cuda.synchronize()
    for k, w in want.items():
        assert torch.equal(got[k], w), k


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 2])
def test_cuda_kernels_past_2_53(cuda_device, n_shards):
    """Two groups of 150,000 cells with every count in one bucket: OVO's
    tie sums (~2e16) and the reference row's pass 2^53, where the sum over v
    rounds and its order (the kernel's warp order against torch's
    reduction) may change the last bits: rtol 1e-13.  Every other
    statistic is an integer below 2^53 and stays bit-equal.  With two
    shards each group's counts are split between them (interleaved
    labels), and summed in registers."""
    n = 150_000
    x = np.zeros((2 * n, 4), np.float32)
    x[:, 1] = 3.0
    x[::7, 2] = 1.0
    x[::13, 2] = 2.0  # three buckets: a sum whose order can matter
    x[::11, 3] = 2.0
    labels = np.tile(np.array(["ref", "g1"]), n)
    hist, ppg, layout, info = _card_hist(x, labels, 128, "ref", cuda_device)
    table = the.prepare_hist_inputs(layout, 128, False, cuda_device)["table"]
    shards, _ = shard_histograms(x, info, table, False, n_shards, cuda_device)
    kw = dict(n_pad=float(layout.n_pad), ref_code=info.ref_code)
    got = the.hist_contract(shards, ppg, **kw)
    want = the.hist_contract_plain(hist, ppg, **kw)
    torch.cuda.synchronize()
    assert float(want["tie_seg"].max()) > 2.0**53
    for k, w in want.items():
        if k == "tie_seg":
            torch.testing.assert_close(got[k], w, rtol=1e-13, atol=0)
        else:
            assert torch.equal(got[k], w), k
