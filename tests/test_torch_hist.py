"""Histogram engine of the port against the JAX package's.

- ``hist_pass`` on CPU tensors (the kernel's plain torch version) equals the
  Pallas kernel run in interpret mode on the real ``T`` columns, bit for bit,
  including values off the table;
- ``hist_contract`` equals the reference's unpacked float64 contraction
  exactly (all statistics are integers far below 2^53 here);
- the layout checks and the wrapper's input checks raise.

The CUDA kernel itself is held against the plain version on the card by the
``cuda``-marked test at the end (skipped without a GPU) and by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import illico_tpu.ops.hist_engine as jhe
import illico_tpu.ops.rank_engine as jre
import illico_tpu.utils.groups as jgroups
from illico_tpu_torch.ops import hist_engine as the
from illico_tpu_torch.ops import rank_engine as tre
from illico_tpu_torch.utils import groups as tgroups

ADVERSARIAL = np.array(
    [np.nan, np.inf, -np.inf, -0.0, 0.5, -1.0, 511.0, 600.0, 1e30], np.float32
)


def _case(seed, v_buckets, is_log1p, n_cells=300, t_cols=40):
    """Counts tile with every table value present, adversarial values, a
    1-cell group and a column past the table; labels with 4 groups."""
    rng = np.random.RandomState(seed)
    x = rng.poisson(3.0, (n_cells, t_cols)).astype(np.float32)
    x[rng.rand(n_cells, t_cols) < 0.5] = 0
    x[:v_buckets if v_buckets <= n_cells else n_cells, 0] = np.arange(
        min(v_buckets, n_cells), dtype=np.float32
    )
    x[5, 1] = v_buckets - 1
    if is_log1p:
        x = np.log1p(x).astype(np.float32)
        extra = np.concatenate([ADVERSARIAL, np.log1p(np.float32([511, 600]))])
    else:
        extra = ADVERSARIAL
    # Columns 3.. get the adversarial values; columns 0-2 stay on the table.
    dirty = x[:, 3:].copy()
    pos = rng.choice(dirty.size, 3 * extra.size, replace=False)
    dirty.reshape(-1)[pos] = np.resize(extra, pos.size)
    x[:, 3:] = dirty
    labels = rng.randint(1, 4, n_cells)
    labels[7] = 0  # 1-cell group
    return x, labels


def _jax_hist(x, labels, v_buckets, is_log1p, ref=None):
    _, info = jgroups.encode_and_count_groups(labels, ref)
    layout = jre.build_padded_layout(info.perm, info.indptr)
    perm, pad_mask, _, blk_group, blk_flush, ppg = jhe.prepare_hist_inputs(
        layout, v_buckets, is_log1p
    )
    table = jnp.asarray(jhe.make_value_table(v_buckets, is_log1p))
    with jax.enable_x64(False):
        hist = jhe.hist_pass(
            jnp.asarray(x), perm, pad_mask, table, blk_group, blk_flush,
            n_groups=layout.n_groups, interpret=True,
        )
    return hist, ppg, layout, info


def _torch_inputs(labels, v_buckets, is_log1p, ref=None):
    _, info = tgroups.encode_and_count_groups(labels, ref)
    layout = tre.build_padded_layout(info.perm, info.indptr)
    return the.prepare_hist_inputs(layout, v_buckets, is_log1p, "cpu"), layout, info


@pytest.mark.parametrize("v_buckets", [128, 256])
@pytest.mark.parametrize("is_log1p", [False, True])
def test_hist_pass_matches_pallas_interpret(v_buckets, is_log1p):
    x, labels = _case(0, v_buckets, is_log1p)
    want, *_ = _jax_hist(x, labels, v_buckets, is_log1p)
    arrs, _, _ = _torch_inputs(labels, v_buckets, is_log1p)
    got = the.hist_pass(
        torch.from_numpy(x), arrs["perm"], arrs["indptr"], arrs["order"],
        arrs["table"], is_log1p=is_log1p,
    )
    want = np.asarray(want)[:, :, : x.shape[1]]
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # Every table value lands in its own bucket (column 0 holds them all).
    assert got[:, :, 0].sum(0).min() >= 1


def test_hist_pass_casts_narrow_wire_dtypes():
    x, labels = _case(1, 128, False)
    x = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    x = np.clip(np.round(x), 0, 255)
    arrs, _, _ = _torch_inputs(labels, 128, False)
    args = (arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"])
    want = the.hist_pass(torch.from_numpy(x), *args, is_log1p=False)
    for dtype in (np.uint8, np.int16, np.float16):
        got = the.hist_pass(torch.from_numpy(x.astype(dtype)), *args, is_log1p=False)
        assert torch.equal(got, want), dtype


def test_hist_pass_refuses_float64_and_other_devices():
    x, labels = _case(2, 128, False)
    arrs, _, _ = _torch_inputs(labels, 128, False)
    args = (arrs["perm"], arrs["indptr"], arrs["order"], arrs["table"])
    with pytest.raises(TypeError, match="float64"):
        the.hist_pass(torch.from_numpy(x.astype(np.float64)), *args, is_log1p=False)
    with pytest.raises(ValueError, match="unsupported device"):
        the.hist_pass(torch.empty((3, 3), device="meta"), *args, is_log1p=False)


@pytest.mark.parametrize("ref", [None, "ref"], ids=["ovr", "ovo"])
@pytest.mark.parametrize("is_log1p", [False, True])
@pytest.mark.parametrize("chunked", [False, True])
def test_hist_contract_matches_reference(ref, is_log1p, chunked, monkeypatch):
    x, labels = _case(3, 128, is_log1p)
    labels = np.where(labels == 1, "ref", labels.astype(str))
    jhist, jppg, jlayout, jinfo = _jax_hist(x, labels, 128, is_log1p, ref)
    with jax.enable_x64(True):
        want = jhe.hist_contract(
            jhist, jppg, n_pad=float(jlayout.n_pad), ref_code=jinfo.ref_code,
            is_log1p=is_log1p, pack=False,
        )
    want = {k: np.asarray(v)[..., : x.shape[1]] for k, v in want.items()}

    arrs, layout, info = _torch_inputs(labels, 128, is_log1p, ref)
    hist = the.hist_pass(
        torch.from_numpy(x), arrs["perm"], arrs["indptr"], arrs["order"],
        arrs["table"], is_log1p=is_log1p,
    )
    if chunked:  # one group per float64 chunk
        monkeypatch.setattr(the, "CONTRACT_CHUNK_BYTES", 1)
    got = the.hist_contract(
        hist, arrs["ppg"], n_pad=float(layout.n_pad), ref_code=info.ref_code
    )
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    # Columns 3.. carry values off the table; the clean columns do not.
    assert got["overflow_cols"][3:].any() and not got["overflow_cols"][:3].any()


def test_validate_hist_layout_raises(monkeypatch):
    indptr = np.array([0, 5, 5, 9])  # group 1 is empty
    layout = tre.build_padded_layout(np.arange(9, dtype=np.int32), indptr)
    with pytest.raises(ValueError, match="at least one"):
        the.validate_hist_layout(layout)
    layout = tre.build_padded_layout(np.arange(9, dtype=np.int32), np.array([0, 4, 9]))
    the.validate_hist_layout(layout)
    monkeypatch.setattr(the, "HIST_EXACT_MAX_GROUP", 5)
    with pytest.raises(ValueError, match="engine='sort'"):
        the.validate_hist_layout(layout)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hist kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("v_buckets", [128, 512])
@pytest.mark.parametrize("is_log1p", [False, True])
def test_cuda_kernel_matches_plain(cuda_device, v_buckets, is_log1p):
    x, labels = _case(4, v_buckets, is_log1p, n_cells=3000, t_cols=1000)
    arrs, _, _ = _torch_inputs(labels, v_buckets, is_log1p)
    args = [arrs[k].to(cuda_device) for k in ("perm", "indptr", "order", "table")]
    xd = torch.from_numpy(x).to(cuda_device)
    before = the.hist_pass.launches
    got = the.hist_pass(xd, *args, is_log1p=is_log1p)
    want = the.hist_pass_plain(xd, *args, is_log1p=is_log1p)
    torch.cuda.synchronize()
    assert the.hist_pass.launches == before + 1
    assert torch.equal(got, want)
