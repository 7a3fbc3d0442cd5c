"""The port's host-side state equals the JAX package's, array for array.

Group encoding, the padded layout, the value tables, pads per group, tile
bounds and the float64 p-value / fold-change tail of ``illico_tpu_torch``
against ``illico_tpu`` on the same inputs (made with numpy seeds).
"""

import numpy as np
import pytest

import illico_tpu.ops.hist_engine as jhe
import illico_tpu.ops.rank_engine as jre
import illico_tpu.stats as jstats
import illico_tpu.utils.groups as jgroups
import illico_tpu.utils.memory as jmemory
from illico_tpu.models.wilcoxon import compute_tile_bounds as j_tile_bounds
from illico_tpu_torch import stats as tstats
from illico_tpu_torch.models.wilcoxon import compute_tile_bounds as t_tile_bounds
from illico_tpu_torch.ops import hist_engine as the
from illico_tpu_torch.ops import rank_engine as tre
from illico_tpu_torch.utils import groups as tgroups
from illico_tpu_torch.utils import memory as tmemory
from illico_tpu_torch.utils.registry import data_handler_registry


def _labels(kind):
    rng = np.random.RandomState(0)
    if kind == "conftest":
        return np.array([f"pert_{g}" for g in rng.randint(0, 5, 10_000)])
    if kind == "ints":
        return rng.randint(0, 40, 3_000)
    # uneven sizes, one single-cell group, unsorted appearance order
    return np.concatenate([np.full(70, "z"), ["solo"], np.full(33, "a"), np.full(5, "m")])


@pytest.mark.parametrize("kind", ["conftest", "ints", "uneven"])
@pytest.mark.parametrize("with_ref", [False, True])
def test_groups_and_layout_equal(kind, with_ref):
    labels = _labels(kind)
    ref = labels[0] if with_ref else None
    ju, jinfo = jgroups.encode_and_count_groups(labels, ref)
    tu, tinfo = tgroups.encode_and_count_groups(labels, ref)
    np.testing.assert_array_equal(tu, ju)
    for field in ("encoded_groups", "counts", "perm", "indptr"):
        a, b = getattr(tinfo, field), getattr(jinfo, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert tinfo.ref_code == jinfo.ref_code

    jl = jre.build_padded_layout(jinfo.perm, jinfo.indptr)
    tl = tre.build_padded_layout(tinfo.perm, tinfo.indptr)
    for field in jl._fields:
        a, b = getattr(tl, field), getattr(jl, field)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            assert a == b, field
    np.testing.assert_array_equal(the.pads_per_group(tl), jhe.pads_per_group(jl))
    np.testing.assert_array_equal(the.real_rows_per_group(tl), jhe.real_rows_per_group(jl))


@pytest.mark.parametrize("v_buckets", [128, 256, 512])
@pytest.mark.parametrize("is_log1p", [False, True])
def test_value_tables_equal(v_buckets, is_log1p):
    got = the.make_value_table(v_buckets, is_log1p)
    want = jhe.make_value_table(v_buckets, is_log1p).ravel()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_constants_equal():
    assert (the.DEFAULT_V, the.MAX_V, the.HIST_EXACT_MAX_GROUP) == (
        jhe.DEFAULT_V, jhe.MAX_V, jhe.HIST_EXACT_MAX_GROUP
    )
    assert (tre.BLOCK, tre._I32_SAFE_N_PAD) == (jre.BLOCK, jre._I32_SAFE_N_PAD)


def test_prepare_hist_inputs_describes_layout():
    labels = _labels("uneven")
    _, info = tgroups.encode_and_count_groups(labels, None)
    layout = tre.build_padded_layout(info.perm, info.indptr)
    arrs = the.prepare_hist_inputs(layout, 128, False, "cpu")
    np.testing.assert_array_equal(arrs["perm"].numpy(), info.perm)
    np.testing.assert_array_equal(arrs["indptr"].numpy(), info.indptr)
    np.testing.assert_array_equal(arrs["ppg"].numpy(), the.pads_per_group(layout))
    # CTA launch order, groups by descending size: z(70), a(33), m(5), solo(1).
    np.testing.assert_array_equal(arrs["order"].numpy(), [3, 0, 1, 2])


@pytest.mark.parametrize(
    "n_genes,batch_size,auto_width",
    [(15, "auto", 512), (300, "auto", 2048), (5000, "auto", 512), (9000, 700, 2048),
     (1000, 16, 512)],
)
def test_tile_bounds_equal(n_genes, batch_size, auto_width):
    assert t_tile_bounds(n_genes, batch_size, 1, auto_width) == j_tile_bounds(
        n_genes, batch_size, 1, auto_width
    )


def test_host_tile_budget_equal(monkeypatch):
    assert tmemory.host_tile_budget() == jmemory.host_tile_budget()
    monkeypatch.setenv("ILLICO_TPU_HOST_BUDGET", "123456789")
    assert tmemory.host_tile_budget() == jmemory.host_tile_budget() == 123456789


def _random_stats(rng, ovr):
    g, t = 6, 40
    n_tgt = rng.randint(1, 400, (g, 1)).astype(np.float64)
    n_ref = (2000.0 - n_tgt) if ovr else np.full((g, 1), 900.0)
    U = np.floor(rng.rand(g, t) * n_ref * n_tgt * 2.0) / 2.0
    n = n_ref + n_tgt
    tie = np.floor(rng.rand(g, t) * 0.5 * (n**3 - n))
    tie[0, :3] = (n**3 - n)[0]  # degenerate: every value tied
    return U, tie, n_ref, n_tgt


@pytest.mark.parametrize("alternative", ["two-sided", "greater", "less"])
@pytest.mark.parametrize("use_continuity", [True, False])
@pytest.mark.parametrize("tie_correct", [True, False])
@pytest.mark.parametrize("ovr", [True, False])
def test_pvalues_equal(alternative, use_continuity, tie_correct, ovr):
    U, tie, n_ref, n_tgt = _random_stats(np.random.RandomState(3), ovr)
    kw = dict(use_continuity=use_continuity, tie_correct=tie_correct,
              alternative=alternative)
    got = tstats.pvalues_from_stats(U, tie, n_ref, n_tgt, **kw)
    want = jstats.pvalues_from_stats(U, tie, n_ref, n_tgt, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_pvalues_reject_bad_alternative():
    with pytest.raises(ValueError, match="Unsupported alternative"):
        tstats.pvalues_from_stats(1.0, 0.0, 2, 2, alternative="bogus")


@pytest.mark.parametrize("ref_code", [-1, 0, 2])
def test_fold_change_equal(ref_code):
    rng = np.random.RandomState(4)
    sums = rng.randint(0, 50, (4, 30)).astype(np.float64)
    sums[:, 0] = 0.0  # zero-mean reference -> inf / nan conventions
    counts = np.array([10, 20, 5, 7])
    got = tstats.fold_change_from_summed_expr(sums, counts, ref_code)
    want = jstats.fold_change_from_summed_expr(sums, counts, ref_code)
    np.testing.assert_array_equal(got, want)


def test_registry_rejects_unknown_types():
    with pytest.raises(KeyError, match="is not implemented"):
        data_handler_registry.get([[1.0, 2.0]])
    with pytest.raises(KeyError, match="is not implemented"):
        data_handler_registry.get(np.ma.masked_array(np.zeros((2, 2))))


@pytest.mark.parametrize(
    "is_log1p,max_value,integral",
    [(True, 20.0, None), (True, 8.0, None), (False, 8.0, False), (False, 8.0, True),
     (False, 300.0, True)],
)
def test_log1p_warning_equal(is_log1p, max_value, integral):
    import warnings

    from illico_tpu.utils.diagnostics import warn_if_log1p_mismatch as jwarn
    from illico_tpu_torch.utils.diagnostics import warn_if_log1p_mismatch as twarn

    caught = []
    for fn in (twarn, jwarn):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            fn(is_log1p=is_log1p, max_value=max_value, integral=integral)
        caught.append([str(x.message) for x in w])
    assert caught[0] == caught[1]
