"""Sort engine of the port against the JAX package's ``rank_stats_tile``.

Same tile, same layout (numpy seeds), JAX on the CPU under x64: the integer
statistics (R2, U2, tie sums, integer-valued fc_sums) must be equal bit for
bit.  ``fc_sums`` under log1p applies float32 ``expm1`` before the float64
sums, and torch's and XLA's ``expm1`` may differ by ULPs: rtol 1e-6 there.
A float64 tile with non-integer values sums its fc_sums in another order:
rtol 1e-12 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import illico_tpu.ops.rank_engine as jre
from illico_tpu_torch.ops import rank_engine as tre
from illico_tpu_torch.utils.groups import encode_and_count_groups


def _tile(kind, rng, n_cells=500, t_cols=12):
    x = rng.poisson(2.0, (n_cells, t_cols)).astype(np.float32)
    x[rng.rand(n_cells, t_cols) < 0.4] = 0
    x[:, 0] = 3.0  # one column tied throughout
    x[rng.rand(n_cells) < 0.05, 1] = np.inf  # real +inf values tie with the pads
    if kind == "log1p":
        return np.log1p(x).astype(np.float32)
    if kind == "float64":
        x = x.astype(np.float64)
        x[:, 2:6] += np.round(rng.rand(n_cells, 4) * 4) / 4 + 1e-12  # ties off the f32 grid
        return x
    return x


def _layout_args(layout):
    return [
        np.ascontiguousarray(a)
        for a in (layout.perm, layout.grp, layout.pad_mask,
                  layout.block_starts, layout.block_ends)
    ]


@pytest.mark.parametrize("kind", ["raw", "log1p", "float64"])
@pytest.mark.parametrize("ref", [None, 2], ids=["ovr", "ovo"])
@pytest.mark.parametrize("i32_safe", [True, False], ids=["i32", "f64-segsum"])
def test_rank_stats_tile_matches_reference(kind, ref, i32_safe, monkeypatch):
    rng = np.random.RandomState(11)
    x = _tile(kind, rng)
    labels = rng.randint(0, 6, x.shape[0])
    labels[:40] = 5  # uneven group sizes -> pads in every group
    _, info = encode_and_count_groups(labels, ref)
    layout = tre.build_padded_layout(info.perm, info.indptr)
    args = _layout_args(layout)
    is_log1p = kind == "log1p"
    with jax.enable_x64(True):
        want = jre._jitted_rank_stats(
            jnp.asarray(x), *(jnp.asarray(a) for a in args),
            ref_code=info.ref_code, is_log1p=is_log1p, compute_fc=True,
        )
        want = {k: np.asarray(v) for k, v in want.items()}
    if not i32_safe:
        monkeypatch.setattr(tre, "_I32_SAFE_N_PAD", 0)
    got = tre.rank_stats_tile(
        torch.from_numpy(x), *(torch.from_numpy(a) for a in args),
        ref_code=info.ref_code, is_log1p=is_log1p,
    )
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype == np.float64, k
        if k == "fc_sums" and kind == "log1p":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        elif k == "fc_sums" and kind == "float64":
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_make_tile_fn_equals_rank_stats_tile():
    rng = np.random.RandomState(12)
    x = np.minimum(_tile("raw", rng), 255)  # uint8-representable
    labels = rng.randint(0, 4, x.shape[0])
    _, info = encode_and_count_groups(labels, 0)
    layout = tre.build_padded_layout(info.perm, info.indptr)
    run = tre.make_tile_fn(layout, ref_code=0, is_log1p=False, device=torch.device("cpu"))
    got = run(torch.from_numpy(x.astype(np.uint8)))  # narrow wire dtype
    want = tre.rank_stats_tile(
        torch.from_numpy(x), *(torch.from_numpy(a) for a in _layout_args(layout)),
        ref_code=0, is_log1p=False,
    )
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_stable_value_sort_keeps_group_order():
    """The reference sorts on (value, group); a stable value sort matches
    because the padded layout's group codes never decrease along the rows."""
    rng = np.random.RandomState(13)
    labels = rng.randint(0, 7, 300)
    _, info = encode_and_count_groups(labels, 0)
    layout = tre.build_padded_layout(info.perm, info.indptr)
    assert np.all(np.diff(layout.grp) >= 0)
    x = rng.randint(0, 3, (layout.n_pad, 5)).astype(np.float32)
    x[layout.pad_mask] = np.inf
    sv, spos = torch.sort(torch.from_numpy(x), dim=0, stable=True)
    sg = torch.from_numpy(layout.grp).long()[spos].numpy()
    order = np.lexsort((layout.grp[:, None].repeat(5, 1), x), axis=0)
    np.testing.assert_array_equal(sg, layout.grp[order])
    np.testing.assert_array_equal(sv.numpy(), np.take_along_axis(x, order, 0))
