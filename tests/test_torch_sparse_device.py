"""In-RAM CSR and CSC input put on the device (``DeviceSparseDataHandler``), on the CPU.

On a single-device CUDA run of the histogram or sort engine the runner
uploads an in-RAM sparse matrix once per call and makes every tile and
fallback chunk from that copy where it lives.  Nothing in that path depends
on the device being a CUDA one except the fit check, which finds no memory
to fit on a CPU device; these tests take the route on the CPU by patching
that check (``_fits_on_device``), or the free memory it reads.  The frames
must equal the host route's bit for bit and the JAX package's within the
parity sweep's tolerances.
"""

import numpy as np
import pytest
import torch
from scipy import sparse as sp
from test_torch_parity_sweep import _frames_agree

import illico_tpu
from illico_tpu_torch import asymptotic_wilcoxon_arrays
from illico_tpu_torch.models import wilcoxon
from illico_tpu_torch.models.wilcoxon import WilcoxonRunner
from illico_tpu_torch.utils.groups import encode_and_count_groups
from illico_tpu_torch.utils.registry import (
    CSRDataHandler,
    DeviceSparseDataHandler,
    _SparseDataHandler,
    data_handler_registry,
    sparse_device_bytes,
)

FORMATS = {
    "csr": sp.csr_matrix, "csc": sp.csc_matrix, "csr_array": sp.csr_array,
    "csc_array": sp.csc_array,
}
N_CELLS, N_GENES, BATCH = 600, 300, 128  # tiles 128, 128 and a short 44


@pytest.fixture
def device_route(monkeypatch):
    """Take the device route wherever the runner would on a card that
    holds the copy."""
    monkeypatch.setattr(wilcoxon, "_fits_on_device", lambda device, nbytes: True)


def _counts(seed=0, n=N_CELLS, t=N_GENES, g=5, dtype=np.float32, zeros=0.6):
    """Poisson counts with an empty row and an empty column, and two columns
    past the value table outside the sampled windows (the fallback)."""
    rng = np.random.default_rng(seed)
    x = rng.poisson(2.0, (n, t)).astype(np.float64)
    x[rng.random((n, t)) < zeros] = 0
    x[7] = 0
    x[:, 5] = 0
    if t > 200:
        x[rng.integers(0, n, 20), 60] = 700
        x[rng.integers(0, n, 20), 200] = 650
    groups = np.array([f"p{v}" for v in rng.integers(0, g, n)])
    return x.astype(dtype), groups


def _run(X, groups, **kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("batch_size", BATCH)
    return asymptotic_wilcoxon_arrays(X, groups, progress=False, **kw)


def _jax(X, groups, **kw):
    if isinstance(X, sp.sparray):  # the JAX package registers the matrix classes
        X = sp.csr_matrix(X) if X.format == "csr" else sp.csc_matrix(X)
    kw.setdefault("batch_size", BATCH)
    return illico_tpu.asymptotic_wilcoxon_arrays(X, groups, progress=False, **kw)


def _routes_agree(X, groups, monkeypatch, **kw):
    """The host route's frame, then the device route's: bit for bit equal,
    each route as named, and both within tolerance of the JAX package."""
    host = _run(X, groups, **kw)
    with monkeypatch.context() as m:
        m.setattr(wilcoxon, "_fits_on_device", lambda device, nbytes: True)
        dev = _run(X, groups, **kw)
    assert host.attrs["input_route"] == "host"
    assert dev.attrs["input_route"] == "device"
    assert dev.index.equals(host.index)
    np.testing.assert_array_equal(dev.values, host.values)
    for key in ("engine", "n_fallback_cols"):
        assert dev.attrs[key] == host.attrs[key]
    assert dev.attrs["stage_seconds"]["fetch"] == 0.0
    _frames_agree(dev, _jax(X, groups, **kw))
    return dev


@pytest.mark.parametrize("kind", ["counts", "log1p"])
@pytest.mark.parametrize("reference", ["p0", None], ids=["ovo", "ovr"])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_device_route_frames(fmt, reference, kind, monkeypatch):
    x, groups = _counts()
    if kind == "log1p":
        x = np.log1p(x)
    df = _routes_agree(FORMATS[fmt](x), groups, monkeypatch, reference=reference,
                       is_log1p=kind == "log1p")
    assert df.attrs["engine"] == "hist"
    assert df.attrs["n_fallback_cols"] >= 2  # columns 60 and 200
    assert df.attrs["consume_path"]["native"] + df.attrs["consume_path"]["numpy"] == 3


@pytest.mark.parametrize("dtype", [np.int8, np.uint16, np.int64, np.float64])
def test_device_route_dtypes(dtype, monkeypatch):
    # float64 runs the sort engine: denser than csort's bound, so auto keeps it.
    zeros = 0.3 if dtype == np.float64 else 0.6
    x, groups = _counts(seed=1, dtype=dtype, zeros=zeros)
    df = _routes_agree(sp.csr_matrix(x), groups, monkeypatch, reference="p0")
    assert df.attrs["engine"] == ("sort" if dtype == np.float64 else "hist")


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_device_route_zero_nnz(fmt, monkeypatch):
    _, groups = _counts(t=40)
    X = FORMATS[fmt]((N_CELLS, 40), dtype=np.float32)
    _routes_agree(X, groups, monkeypatch, reference="p0")


def _non_canonical(fmt, values, seed=2, n=N_CELLS, t=N_GENES, n_entries=40_000):
    """A CSR (indices sorted within each row) or CSC (rows in random order
    within each column) with many duplicate entries, stored in random order
    within each duplicate run."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, n_entries)
    cols = rng.integers(0, t, n_entries)
    vals = values(rng, n_entries)
    if fmt == "csr":
        o = np.lexsort((rng.random(n_entries), cols, rows))
        major, minor, size = rows[o], cols[o], n
        cls = sp.csr_matrix
    else:
        o = np.lexsort((rng.random(n_entries), cols))
        major, minor, size = cols[o], rows[o], t
        cls = sp.csc_matrix
    indptr = np.concatenate([[0], np.cumsum(np.bincount(major, minlength=size))])
    X = cls((vals[o], minor.astype(np.int32), indptr), shape=(n, t))
    assert not X.has_canonical_format
    return X


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("kind", ["counts", "float"])
def test_device_route_duplicates(fmt, kind, monkeypatch):
    if kind == "counts":
        X = _non_canonical(fmt, lambda rng, k: rng.poisson(1.5, k).astype(np.float32))
        kw = {}
    else:  # sums that depend on their order, through the sort engine
        X = _non_canonical(
            fmt, lambda rng, k: (rng.standard_normal(k) * 1e3).astype(np.float32)
        )
        kw = {"engine": "sort"}
    groups = _counts()[1]
    _routes_agree(X, groups, monkeypatch, reference="p0", **kw)


def _handler_pairs():
    rng = np.random.default_rng(3)
    x = rng.poisson(1.0, (50, 30)).astype(np.float32)
    x[rng.random((50, 30)) < 0.5] = 0
    x[7] = 0
    x[:, 5] = 0
    mats = [cls(x) for cls in FORMATS.values()]
    for m in mats:
        m.data[m.data == 2] = -0.0  # held as +0.0, as toarray's sum makes it
    mats += [cls(x.astype(d)) for cls in (sp.csr_matrix, sp.csc_matrix)
             for d in (np.int8, np.uint16, np.int64, np.float64)]
    mats.append(_non_canonical("csr", lambda r, k: r.standard_normal(k).astype(np.float32),
                               n=50, t=30, n_entries=600))
    mats.append(_non_canonical("csc", lambda r, k: r.standard_normal(k).astype(np.float32),
                               n=50, t=30, n_entries=600))
    # Duplicates that wrap in their stored dtype, as toarray sums them.
    for dtype, big in ((np.uint16, 40000), (np.int8, 100)):
        mats.append(sp.csc_matrix((np.array([big, 3, big], dtype), np.array([1, 0, 1]),
                                   np.array([0, 3] + [3] * 29)), shape=(50, 30)))
    mats.append(sp.csr_matrix((50, 30), dtype=np.float32))
    return mats


@pytest.mark.parametrize("X", _handler_pairs())
def test_handler_tiles_equal_the_host_handlers(X):
    host = data_handler_registry.get(X)
    dev = DeviceSparseDataHandler(host, "cpu")
    assert dev.is_device and dev.shape == host.shape and dev.dtype == host.dtype
    assert dev.density() == host.density()
    before = X.data.tobytes(), X.indices.tobytes(), X.indptr.tobytes()
    dev.load()
    assert (X.data.tobytes(), X.indices.tobytes(), X.indptr.tobytes()) == before
    assert dev.footprint() == host.footprint() == sparse_device_bytes(X.shape, X.nnz, X.dtype)
    # What the copy holds (fewer entries once duplicates are summed).
    held = sum(a.numel() * a.element_size() for a in (dev.col_ptr, dev.rows, dev.values))
    assert held == sparse_device_bytes(X.shape, dev.rows.numel(), X.dtype)
    for lb, ub in ((0, 30), (3, 25), (29, 30), (4, 4)):
        want = host.fetch_tile(lb, ub)
        got = dev.fetch_tile(lb, ub).numpy()
        assert got.shape == want.shape
        assert got.tobytes() == want.astype(got.dtype).tobytes(), (lb, ub)
    for idx in ([29, 0, 5, 7, 7], [], [12]):
        want = host.fetch_columns(idx)
        got = dev.fetch_columns(idx).numpy()
        assert got.shape == want.shape
        assert got.tobytes() == want.astype(got.dtype).tobytes(), idx
    dev.release()
    assert dev.col_ptr is None and dev.rows is None and dev.values is None


def _runner(X, groups, **kw):
    handler = data_handler_registry.get(X)
    handler.validate()
    _, info = encode_and_count_groups(np.asarray(groups), kw.pop("reference", "p0"))
    return WilcoxonRunner(handler, info, is_log1p=False, device=torch.device("cpu"),
                          batch_size=BATCH, **kw)


def test_device_route_never_reads_the_host_matrix_in_the_run(device_route, monkeypatch):
    """The sample and the table come from the host matrix before the swap
    (never the device windows); the tiles and the fallback chunks, from the
    device copy only; the copy goes at the end of the run, and its upload is
    charged to h2d."""
    x, groups = _counts()
    X = sp.csr_matrix(x)

    def refuse(*args, **kw):
        raise AssertionError("reached on the device route")

    monkeypatch.setattr(WilcoxonRunner, "_sampled_device_windows", refuse)
    runner = _runner(X, groups)
    assert isinstance(runner.handler, DeviceSparseDataHandler)
    assert runner.input_route == "device" and runner.wire_dtype == np.float32
    monkeypatch.setattr(CSRDataHandler, "fetch_tile", refuse)
    monkeypatch.setattr(_SparseDataHandler, "fetch_columns", refuse)
    loaded = []
    load = DeviceSparseDataHandler.load
    monkeypatch.setattr(DeviceSparseDataHandler, "load",
                        lambda self: (load(self), loaded.append(self.rows.numel())))
    res = runner.run(progress=False)
    assert loaded == [X.nnz] and res.n_fallback_cols >= 2
    assert runner.handler.rows is None  # released
    assert res.stage_seconds["fetch"] == 0.0 and res.stage_seconds["h2d"] > 0.0
    monkeypatch.undo()
    want = _runner(X, groups).run(progress=False)
    np.testing.assert_array_equal(res.stacked, want.stacked)


def test_device_copy_is_released_on_error(device_route, monkeypatch):
    x, groups = _counts(t=40)
    runner = _runner(sp.csc_matrix(x), groups)

    def fail(self, progress):
        assert self.handler.rows is not None
        raise RuntimeError("tile loop failed")

    monkeypatch.setattr(WilcoxonRunner, "_run_tiles", fail)
    with pytest.raises(RuntimeError, match="tile loop failed"):
        runner.run(progress=False)
    assert runner.handler.rows is None


def _normalized_csr(seed=4):
    x, groups = _counts(seed=seed, t=40)
    totals = x.sum(axis=1, keepdims=True)
    totals[totals == 0] = 1
    return sp.csr_matrix(np.log1p(x / totals * 1e4).astype(np.float32)), groups


@pytest.mark.parametrize("case", ["csort", "devices", "dense", "engine_csort"])
def test_host_route_where_the_device_route_does_not_apply(case, device_route):
    x, groups = _counts(t=40)
    kw = {"reference": "p0"}
    if case == "csort":
        X, groups = _normalized_csr()
        kw["is_log1p"] = True
    elif case == "engine_csort":
        X = sp.csr_matrix(x)
        kw["engine"] = "csort"
    elif case == "devices":
        X = sp.csr_matrix(x)
        kw["devices"] = 2
    else:
        X = x
    df = _run(X, groups, **kw)
    assert df.attrs["input_route"] == "host"
    if case in ("csort", "engine_csort"):
        assert df.attrs["engine"] == "csort"


def test_the_fit_check_reads_the_free_memory(monkeypatch):
    """Without the patched check: a copy that does not fit half the free
    memory stays on the host; one that fits goes to the device."""
    x, groups = _counts(t=40)
    X = sp.csr_matrix(x)
    need = X.nnz * 8 + 8 * 41  # at least the copy itself
    monkeypatch.setattr(wilcoxon, "device_free_bytes", lambda device: need)
    small = _run(X, groups, reference="p0")
    monkeypatch.setattr(wilcoxon, "device_free_bytes", lambda device: 1 << 40)
    big = _run(X, groups, reference="p0")
    assert small.attrs["input_route"] == "host" and big.attrs["input_route"] == "device"
    np.testing.assert_array_equal(small.values, big.values)


def test_unsorted_csr_still_raises(device_route):
    x, groups = _counts(t=40)
    X = sp.csr_matrix(x)
    X.indices[X.indptr[0] : X.indptr[1]] = X.indices[X.indptr[0] : X.indptr[1]][::-1]
    X.has_sorted_indices = False
    with pytest.raises(ValueError, match="unsorted column indices"):
        _run(X, groups, reference="p0")
