"""Seeded parity sweep of the port's public API against the JAX package's.

``illico_tpu_torch.asymptotic_wilcoxon_arrays(..., device="cpu")`` against
``illico_tpu.asymptotic_wilcoxon_arrays`` (x64, the 8 virtual CPU devices of
``tests/conftest.py``) on the same inputs:

- random cases, one per seed, each drawn from ``np.random.default_rng(seed)``:
  20-400 cells, 1-70 genes, 2-6 groups; counts, log1p, scanpy-normalized or
  negative values; dense, CSR or CSC in a narrow or a wide dtype, sometimes
  with a NaN; OVO or OVR, every alternative, continuity and tie correction
  on or off; each engine; one device, ``devices=2`` or ``devices=(2, 1)``;
  an explicit ``batch_size`` that often leaves the last tile (or the last
  gene shard) one to three columns short of a full one;
- fixed regression shapes, drawn from no random case: the histogram tiles
  whose widths pack to the same number of bytes (a full tile and a short
  last one, a gene shard and its warm-up tile), every one of which raised
  a pack-spec size collision before the hist spec cache was keyed by the
  packed width.

U is equal, p within rtol 1e-12 and fold change within rtol 1e-6, NaN where
the other has NaN.  Every random case is one that both packages accept, so
every seed compares a frame: the draw gives the histogram engine no float64
input and the cell mesh no other engine.  Those refusals are fixed cases,
in which both packages raise the same exception type.  Under a mesh the JAX package reads a NaN fold-change sum as
NaN (its mesh returns the plain dict) and on one device as 0.0 (its packed
wire); the port keeps the wire under a mesh, so a NaN input under a mesh is
compared with the JAX package's single-device frame (ROADMAP section 3).
"""

import numpy as np
import pytest
from scipy import sparse

import illico_tpu
import illico_tpu_torch

N_SEEDS = 20


def _frames_agree(got, want):
    assert got.index.equals(want.index)
    np.testing.assert_array_equal(got.statistic.values, want.statistic.values)
    np.testing.assert_allclose(got.p_value.values, want.p_value.values, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.fold_change.values, want.fold_change.values, rtol=1e-6)


def _values(rng, kind, n, t):
    """(n, t) float64 values of one kind, ~half zeros."""
    counts = rng.poisson(rng.uniform(0.3, 6.0, t), (n, t)).astype(np.float64)
    counts[rng.random((n, t)) < rng.uniform(0.2, 0.8)] = 0.0
    if kind == "counts":
        return counts
    if kind == "log1p":
        return np.log1p(counts.astype(np.float32)).astype(np.float64)
    if kind == "normalized":
        totals = counts.sum(axis=1, keepdims=True)
        totals[totals == 0] = 1.0
        return np.log1p((counts / totals * 1e4).astype(np.float32)).astype(np.float64)
    signed = counts * rng.choice([-1.0, 1.0], (n, t))
    return signed - np.sign(signed) * rng.choice([0.0, 0.5])


def _dtype(rng, kind, values, engine):
    """A narrow dtype that holds the values exactly, or a float one; no
    float64 for the histogram engine, which refuses it."""
    options = [np.float32, np.float32] + ([] if engine == "hist" else [np.float64])
    if kind in ("counts", "negative") and np.all(values == np.round(values)):
        ints = (np.int8, np.uint8, np.int16, np.int32)
        options += [d for d in ints
                    if np.iinfo(d).min <= values.min() and values.max() <= np.iinfo(d).max]
        options.append(np.float16)
    return options[int(rng.integers(len(options)))]


def draw_case(seed: int) -> dict:
    """One random case: inputs, labels and keyword arguments for both APIs."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 401))
    n_groups = int(rng.integers(2, 7))
    devices = [None, 2, (2, 1)][int(rng.integers(3))]
    t = int(rng.integers(1, 71))
    batch_size = int(rng.integers(1, t + 1))
    if rng.random() < 0.7:
        # A last tile 1-3 columns short of a full one.  Below 256 genes a
        # run is one tile, so under a mesh the short one is the last gene
        # shard (32-column shards for the histogram engine).
        k, short = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        batch_size = int(rng.integers(short + 1, max(short + 2, (70 + short) // k + 1)))
        if devices is not None:
            k, batch_size = int(rng.integers(1, 3)), 32
        t = k * batch_size - short
    # The cell mesh takes only the histogram engine.
    engine = "hist" if devices == (2, 1) else str(rng.choice(["auto", "hist", "sort", "csort"]))
    kind = str(rng.choice(["counts", "counts", "log1p", "normalized", "negative"]))
    values = _values(rng, kind, n, t)
    dtype = _dtype(rng, kind, values, engine)
    if rng.random() < 0.25 and np.dtype(dtype).kind == "f":
        values[rng.integers(n), rng.integers(t)] = np.nan
    x = values.astype(dtype)
    fmt = str(rng.choice(["dense", "csr", "csc"]))
    if x.dtype == np.float16:
        fmt = "dense"  # scipy.sparse holds no float16
    X = x if fmt == "dense" else getattr(sparse, f"{fmt}_matrix")(x)
    codes = rng.integers(0, n_groups, n)
    codes[:n_groups] = np.arange(n_groups)  # every group has a cell
    labels = np.array([f"g{c}" for c in codes])
    kw = dict(
        reference="g0" if rng.random() < 0.5 else None,
        is_log1p=kind in ("log1p", "normalized"),
        alternative=str(rng.choice(["two-sided", "less", "greater"])),
        use_continuity=bool(rng.random() < 0.5),
        tie_correct=bool(rng.random() < 0.5),
        engine=engine,
        batch_size=batch_size,
        devices=devices,
    )
    nan = bool(np.isnan(values).any())
    return dict(X=X, labels=labels, kw=kw, nan=nan, desc=(
        f"{n}x{t} {kind} {np.dtype(dtype).name} {fmt} G={n_groups} nan={nan} {kw}"))


def _both(X, labels, kw):
    """(port frame or exception, JAX frame or exception) of one call."""
    out = []
    for fn, extra in ((illico_tpu_torch.asymptotic_wilcoxon_arrays, {"device": "cpu"}),
                      (illico_tpu.asymptotic_wilcoxon_arrays, {})):
        try:
            out.append(fn(X, labels, progress=False, **kw, **extra))
        except Exception as err:  # compared by type below
            out.append(err)
    return out


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_random_case_matches_reference(seed):
    case = draw_case(seed)
    kw = case["kw"]
    got, want = _both(case["X"], case["labels"], kw)
    for frame in (got, want):
        assert not isinstance(frame, Exception), (case["desc"], frame)
    if case["nan"] and kw["devices"] is not None:
        # The JAX package's mesh reads a NaN fc sum as NaN, its wire as
        # 0.0: a NaN under a mesh is held to its single-device frame.
        want = illico_tpu.asymptotic_wilcoxon_arrays(
            case["X"], case["labels"], progress=False, **dict(kw, devices=None))
    _frames_agree(got, want)
    assert got.attrs["consume_path"]["numpy"] == 0, case["desc"]


# Cases both packages refuse: (value dtype, keyword arguments).
REFUSALS = {
    "hist_float64": (np.float64, dict(engine="hist")),
    "sort_cell_mesh": (np.float32, dict(engine="sort", devices=(2, 1))),
    "csort_cell_mesh": (np.float32, dict(engine="csort", devices=(2, 1))),
    "auto_routed_to_sort_cell_mesh": (np.float64, dict(engine="auto", devices=(2, 1))),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refused_case_raises_alike(name):
    dtype, kw = REFUSALS[name]
    rng = np.random.default_rng(7)
    x = rng.poisson(1.5, (60, 30)).astype(dtype)
    labels = np.array([f"g{c}" for c in np.arange(60) % 3])
    got, want = _both(x, labels, dict(reference="g0", **kw))
    assert isinstance(want, ValueError), want
    assert type(got) is type(want), got


def test_sweep_draws_the_cases_it_promises():
    """The random draw covers what the module docstring says it does."""
    cases = [draw_case(s) for s in range(N_SEEDS)]
    kws = [c["kw"] for c in cases]
    assert {k["engine"] for k in kws} == {"auto", "hist", "sort", "csort"}
    assert {str(k["devices"]) for k in kws} == {"None", "2", "(2, 1)"}
    assert {k["reference"] for k in kws} == {"g0", None}
    assert {k["alternative"] for k in kws} == {"two-sided", "less", "greater"}
    assert any(c["nan"] for c in cases)
    assert {type(c["X"]).__name__ for c in cases} >= {"ndarray", "csr_matrix", "csc_matrix"}
    short = [c for c in cases
             if 1 <= -c["X"].shape[1] % c["kw"]["batch_size"] <= 3]
    assert len(short) >= N_SEEDS // 2


# -- fixed regression shapes -------------------------------------------------------
# Raw counts, OVO against g0.  Each shape gives the histogram engine two tiles
# (or a tile and the warm-up) whose widths pack to the same byte count.
REGRESSIONS = {
    "8190_genes_every_default": (300, 8190, {}),
    "6141_genes": (60, 6141, dict(engine="hist")),
    "1023_genes_batch_512": (60, 1023, dict(engine="hist", batch_size=512)),
    "2046_genes_batch_1024": (60, 2046, dict(engine="hist", batch_size=1024)),
    "2046_genes_batch_1024_cell_mesh": (60, 2046, dict(engine="hist", batch_size=1024,
                                                       devices=(2, 1))),
    "62_genes_devices_2": (60, 62, dict(engine="hist", devices=2)),
    "2046_genes_devices_2": (60, 2046, dict(engine="hist", devices=2)),
    "8190_genes_devices_2_batch_2048": (60, 8190, dict(engine="hist", devices=2,
                                                       batch_size=2048)),
    "126_genes_devices_4": (60, 126, dict(engine="hist", devices=4)),
    "30_genes_devices_2_precompile": (60, 30, dict(engine="hist", devices=2,
                                                   precompile=True)),
}


@pytest.mark.parametrize("name", list(REGRESSIONS))
def test_packed_width_collision_shapes_match_reference(name):
    n, t, kw = REGRESSIONS[name]
    rng = np.random.default_rng(12345)
    x = rng.poisson(1.5, (n, t)).astype(np.float32)
    x[rng.random((n, t)) < 0.5] = 0.0
    labels = np.array([f"g{c}" for c in np.arange(n) % 4])
    got, want = _both(x, labels, dict(reference="g0", **kw))
    for frame in (got, want):
        assert not isinstance(frame, Exception), frame
    assert got.attrs["engine"] == "hist"
    assert got.attrs["consume_path"]["numpy"] == 0
    _frames_agree(got, want)


def test_nan_fold_change_under_a_mesh_is_the_single_device_one():
    """Reference behaviour, pinned: with a NaN in a log1p CSC matrix the JAX
    package's ``devices=2`` frame has a NaN fold change in the NaN's column
    for every group (its mesh returns the plain dict), its single-device
    frame a finite one (its wire reads a NaN sum as 0.0).  The port keeps
    the wire under a mesh: both its frames equal the single-device one."""
    rng = np.random.default_rng(5)
    counts = rng.poisson(2.0, (265, 33)).astype(np.float32)
    counts[rng.random(counts.shape) < 0.6] = 0.0
    x = np.log1p(counts)
    labels = np.array([f"g{c}" for c in rng.integers(0, 4, 265)])
    x[np.flatnonzero(labels == "g2")[0], 32] = np.nan
    X = sparse.csc_matrix(x)
    kw = dict(is_log1p=True, reference=None, progress=False)
    j_one = illico_tpu.asymptotic_wilcoxon_arrays(X, labels, **kw)
    j_mesh = illico_tpu.asymptotic_wilcoxon_arrays(X, labels, devices=2, **kw)
    col = j_one.index.get_level_values(1) == "gene_32"
    assert np.isnan(j_mesh.fold_change.values[col]).all()
    assert np.isfinite(j_one.fold_change.values[col]).all()
    for devices in (None, 2):
        got = illico_tpu_torch.asymptotic_wilcoxon_arrays(X, labels, device="cpu",
                                                          devices=devices, **kw)
        assert got.attrs["engine"] == "csort"
        _frames_agree(got, j_one)
