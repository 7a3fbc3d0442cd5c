"""The in-RAM CSR's native scans (``illico_tpu_torch/csrc/csr_scan.cpp``) on the CPU.

``CSRDataHandler`` checks that each row's column indices are sorted and
gathers a column window with one binary search per row, in the package's
native library.  Its plain bodies (numpy's check, scipy's column slice) stay
for the cases the library does not take.  Held here: the native window
equals the plain one bit for bit (every value dtype the library takes, int32
and int64 index arrays, duplicates, empty rows, 0 nonzeros, windows at the
edges, 1 and several threads); the native check flags exactly what the plain
one flags, with the same error; an unchecked unsorted CSR never yields a
tile; the runner's sample, engine, table and wire statics, and the frames on
both input routes, equal the plain path's, and the frames agree with the JAX
package's; the build tag follows both sources.
"""

import hashlib
import os
import shutil
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from scipy import sparse as sp
from test_torch_parity_sweep import _frames_agree
from test_torch_sparse_device import BATCH, _counts, _jax, _run

import illico_tpu_torch.native as native
from illico_tpu_torch.models import wilcoxon
from illico_tpu_torch.utils.groups import encode_and_count_groups
from illico_tpu_torch.utils.registry import CSRDataHandler, _UNSORTED_CSR, data_handler_registry

DTYPES = [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.int64, np.float32, np.float64]
INDEX_DTYPES = {"i32p32": (np.int32, np.int32), "i32p64": (np.int32, np.int64),
                "i64p32": (np.int64, np.int32), "i64p64": (np.int64, np.int64)}


@pytest.fixture
def no_native(monkeypatch):
    """Hide the native library, as ``ILLICO_TPU_NO_NATIVE=1`` does."""

    def hide():
        native.native_available()
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_TRIED", True)

    return hide


@pytest.fixture
def calls():
    """The scan counts, zeroed."""
    for key in native.csr_scan_calls:
        native.csr_scan_calls[key] = 0
    return native.csr_scan_calls


def _values(rng, dtype, k):
    """k values of ``dtype`` over its whole range (integer duplicates wrap);
    floats with -0.0, NaN and infinities among them."""
    dtype = np.dtype(dtype)
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, k, dtype=dtype, endpoint=True)
    v = rng.standard_normal(k).astype(dtype) * 100
    special = np.array([-0.0, np.nan, np.inf, -np.inf], dtype)
    pick = rng.random(k) < 0.05
    v[pick] = special[rng.integers(0, 4, int(pick.sum()))]
    return v


def _csr(kind, dtype, index_dtypes, seed=0, n_rows=40, n_cols=2100, empty=(0, 20, 39)):
    """A CSR with sorted rows, its index arrays in the given dtypes.

    ``canonical``: distinct columns per row, the rows ``empty`` empty (the
    first, a middle one and the last); ``duplicates``: columns drawn with
    replacement and both edge columns twice in every other row (sorted
    duplicates, non-canonical); ``empty``: no nonzero; ``narrow``: 10
    columns."""
    rng = np.random.default_rng(seed)
    if kind == "narrow":
        n_cols = 10
    cols, lens = [], []
    for r in range(n_rows):
        k = 0 if kind == "empty" or r in empty else int(
            rng.integers(1, min(n_cols, 300)))
        c = rng.choice(n_cols, k, replace=kind == "duplicates")
        if kind == "duplicates" and k:  # a run of equal columns at the window edges too
            c = np.concatenate([c, [0, 0, n_cols - 1, n_cols - 1]])
        cols.append(np.sort(c, kind="stable"))
        lens.append(c.size)
    indices = np.concatenate(cols).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    X = sp.csr_matrix((_values(rng, dtype, indices.size), indices, indptr),
                      shape=(n_rows, n_cols))
    X.indices = indices.astype(index_dtypes[0])
    X.indptr = indptr.astype(index_dtypes[1])
    return X


def _windows(n_cols):
    """The sampler's three windows, one-column windows, an empty one and a
    full 2,048-column tile."""
    w = min(24, n_cols)
    starts = sorted({0, max(0, n_cols // 2 - w // 2), max(0, n_cols - w)})
    return ([(s, s + w) for s in starts] + [(0, 1), (n_cols // 2, n_cols // 2 + 1),
                                            (n_cols - 1, n_cols), (3, 3),
                                            (0, min(2048, n_cols))])


@pytest.mark.parametrize("kind", ["canonical", "duplicates", "empty", "narrow"])
@pytest.mark.parametrize("index", list(INDEX_DTYPES))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_native_window_equals_plain(dtype, index, kind, calls):
    X = _csr(kind, dtype, INDEX_DTYPES[index])
    assert X.indices.dtype == INDEX_DTYPES[index][0]
    assert X.indptr.dtype == INDEX_DTYPES[index][1]
    if kind == "duplicates":
        assert not X.has_canonical_format
    handler = CSRDataHandler(X)
    handler.validate()
    assert calls["check_native"] == 1
    for lb, ub in _windows(X.shape[1]):
        want = handler._fetch_tile_plain(lb, ub)
        got = handler.fetch_tile(lb, ub)
        assert got.dtype == want.dtype and got.shape == want.shape == (X.shape[0], ub - lb)
        assert got.flags.c_contiguous
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), (lb, ub)
        for n_threads in (1, 3):
            again = native.csr_gather_window_native(X.indptr, X.indices, X.data, lb, ub,
                                                    n_threads=n_threads)
            assert np.array_equal(again.view(np.uint8), want.view(np.uint8)), (lb, ub, n_threads)
    n = len(_windows(X.shape[1]))
    assert calls["gather_native"] == 3 * n and calls["gather_plain"] == n
    assert calls["check_plain"] == 0


def _unsorted(where, index_dtypes):
    """A float32 CSR whose indices drop inside row ``where`` ("first",
    "middle", "last"), or sorted rows ("none"; drops at row boundaries,
    duplicates and empty rows at the start and in the middle)."""
    X = _csr("duplicates", np.float32, index_dtypes, seed=1, empty=(0, 20))
    row = {"first": 1, "middle": 25, "last": X.shape[0] - 1, "none": None}[where]
    if row is not None:
        s, e = int(X.indptr[row]), int(X.indptr[row + 1])
        seg = X.indices[s:e]
        assert seg[0] < seg[-1]
        X.indices[s:e] = seg[::-1]
    return X, row


@pytest.mark.parametrize("index", list(INDEX_DTYPES))
@pytest.mark.parametrize("where", ["first", "middle", "last", "none"])
def test_native_check_equals_plain(where, index, calls):
    X, row = _unsorted(where, INDEX_DTYPES[index])
    for n_threads in (1, 3):
        got = native.csr_check_sorted_native(X.indptr, X.indices, n_threads=n_threads)
        assert got == (-1 if row is None else row)
    handler = CSRDataHandler(X)
    if row is None:
        handler._validate_plain()
        handler.validate()
    else:
        with pytest.raises(ValueError) as plain:
            handler._validate_plain()
        with pytest.raises(ValueError) as nat:
            handler.validate()
        assert str(nat.value) == str(plain.value) == _UNSORTED_CSR
    assert calls["check_native"] == 3 and calls["check_plain"] == 1


@pytest.mark.parametrize("case", ["sorted", "rows_end_empty", "all_empty", "no_rows",
                                  "middle_empty", "boundary_drop"])
def test_native_check_edges_equal_plain(case):
    """Empty rows at the start, middle and end, an empty matrix, a matrix
    with no rows and one whose drops all fall on row boundaries."""
    if case == "no_rows":
        X = sp.csr_matrix((0, 5), dtype=np.float32)
    elif case == "all_empty":
        X = sp.csr_matrix((6, 5), dtype=np.float32)
    else:
        dense = np.zeros((6, 5), np.float32)
        if case == "sorted":
            dense[[1, 3]] = 1
        elif case == "rows_end_empty":
            dense[0, [1, 4]] = 1
        elif case == "middle_empty":
            dense[[0, 5]] = 1
        else:  # each row ends above where the next starts
            dense[[1, 2, 4], :] = 1
            dense[2, 0] = 0
        X = sp.csr_matrix(dense)
    handler = CSRDataHandler(X)
    handler._validate_plain()
    assert native.csr_check_sorted_native(X.indptr, X.indices) == -1
    handler.validate()
    assert handler._checked
    for lb, ub in ((0, 5), (2, 3)):
        assert np.array_equal(handler.fetch_tile(lb, ub), handler._fetch_tile_plain(lb, ub))


def test_unchecked_unsorted_csr_never_yields_a_tile(calls):
    X, _ = _unsorted("last", INDEX_DTYPES["i32p32"])
    handler = CSRDataHandler(X)
    with pytest.raises(ValueError, match="unsorted column indices"):
        handler.fetch_tile(0, 24)
    assert calls["gather_native"] == 0 and calls["gather_plain"] == 0
    assert not handler._checked
    with pytest.raises(ValueError, match="unsorted column indices"):
        handler.fetch_tile(0, 24)  # still unchecked: checked again
    # A sorted one is checked once, at its first tile.
    good = CSRDataHandler(_csr("canonical", np.float32, INDEX_DTYPES["i32p32"]))
    good.fetch_tile(0, 24)
    good.fetch_tile(24, 48)
    assert calls["check_native"] == 3 and calls["gather_native"] == 2


@pytest.mark.parametrize("dtype", [np.float16, np.uint32, np.uint64, np.bool_],
                         ids=lambda d: np.dtype(d).name)
def test_dtypes_outside_the_template_take_the_plain_bodies(dtype, calls):
    X = _csr("canonical", np.float32, INDEX_DTYPES["i32p32"])
    X.data = (X.data > 0).astype(dtype)  # scipy does not convert float16 itself
    handler = CSRDataHandler(X)
    assert not handler._native_scans()
    handler.validate()
    if dtype is not np.float16:  # scipy slices no float16 matrix
        want = np.zeros((X.shape[0], 24), dtype)
        X[:, 100:124].tocsc().toarray(out=want)
        assert np.array_equal(handler.fetch_tile(100, 124), want)
    assert calls["check_plain"] == 1 and calls["check_native"] == 0
    assert calls["gather_native"] == 0
    with pytest.raises(ValueError, match="not gathered natively"):
        native.csr_gather_window_native(X.indptr, X.indices, X.data, 0, 5)


def test_library_hidden_takes_the_plain_bodies(no_native, calls):
    X, _ = _unsorted("middle", INDEX_DTYPES["i32p32"])
    no_native()
    handler = CSRDataHandler(X)
    assert not handler._native_scans()
    with pytest.raises(ValueError, match="unsorted column indices"):
        handler.validate()
    with pytest.raises(RuntimeError, match="not available"):
        native.csr_check_sorted_native(X.indptr, X.indices)
    good = CSRDataHandler(_csr("canonical", np.float32, INDEX_DTYPES["i32p32"]))
    good.fetch_tile(0, 24)
    assert calls == {"check_native": 0, "check_plain": 2, "gather_native": 0,
                     "gather_plain": 1}


def test_prefetch_threads_scan_on_one_thread(monkeypatch):
    monkeypatch.setenv("ILLICO_TPU_TAIL_THREADS", "5")
    assert native.scan_threads() == 5
    with ThreadPoolExecutor(2, initializer=native.single_scan_thread) as pool:
        assert list(pool.map(lambda _: native.scan_threads(), range(4))) == [1] * 4
    assert native.scan_threads() == 5  # the caller's thread keeps the default


def _runner(X, groups, is_log1p):
    handler = data_handler_registry.get(X)
    handler.validate()
    _, info = encode_and_count_groups(np.asarray(groups), "p0")
    return wilcoxon.WilcoxonRunner(handler, info, is_log1p=is_log1p,
                                   device=torch.device("cpu"), batch_size=BATCH)


def _sampled_state(runner):
    statics = getattr(runner.tile_fn, "_statics", {})
    colstats = runner._sampled_colstats
    return dict(
        vmax=runner._sampled_vmax, conforms=runner._sampled_conforms,
        overflow=runner._sampled_overflow_frac, density=runner._sampled_density,
        colstats=None if colstats is None else (colstats[0].tobytes(), colstats[1].tobytes(),
                                                colstats[2]),
        engine=runner.engine, v_buckets=runner._v_buckets, route=runner.input_route,
        nnz_split=runner._nnz_split_hint(), fc_u8=runner._fc_u8_hint(),
        statics=repr(sorted(statics.items())),
    )


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("kind", ["counts", "log1p"])
def test_sampler_state_equals_the_plain_paths(kind, route, no_native, calls, monkeypatch):
    x, groups = _counts()
    x[:, 150] = np.where(x[:, 150] > 0, 600, 0)  # past the table inside a sampled window
    if kind == "log1p":
        x = np.log1p(x)
    if route == "device":
        monkeypatch.setattr(wilcoxon, "_fits_on_device", lambda device, nbytes: True)
    X = sp.csr_matrix(x)
    nat = _sampled_state(_runner(X, groups, kind == "log1p"))
    assert calls["gather_native"] == 3 and calls["gather_plain"] == 0
    no_native()
    plain = _sampled_state(_runner(X, groups, kind == "log1p"))
    assert calls["gather_plain"] == 3
    assert nat == plain
    assert nat["route"] == route and nat["v_buckets"] == 512 and nat["engine"] == "hist"


@pytest.mark.parametrize("fmt", ["csr", "csr_array"])
@pytest.mark.parametrize("route", ["host", "device"])
def test_frames_equal_the_plain_paths_and_the_jax_package(route, fmt, calls, monkeypatch):
    """OVO counts with columns past the value table inside a sampled window
    and outside (the fallback): the frame with the native scans equals the
    plain bodies' bit for bit (the native tail in both), on both routes, and
    the JAX package's within the parity sweep's tolerances; on the host
    route the tiles come from the prefetch threads at one scan thread each."""
    x, groups = _counts()
    x[:, 150] = np.where(x[:, 150] > 0, 600, 0)
    X = (sp.csr_array if fmt == "csr_array" else sp.csr_matrix)(x)
    if route == "device":
        monkeypatch.setattr(wilcoxon, "_fits_on_device", lambda device, nbytes: True)
    seen = []
    gather = native.csr_gather_window_native

    def spy(*args, **kw):
        seen.append((threading.current_thread() is threading.main_thread(),
                     native.scan_threads()))
        return gather(*args, **kw)

    monkeypatch.setattr(native, "csr_gather_window_native", spy)
    monkeypatch.setenv("ILLICO_TPU_TAIL_THREADS", "3")
    nat = _run(X, groups, reference="p0")
    assert nat.attrs["input_route"] == route and nat.attrs["n_fallback_cols"] >= 2
    assert calls["check_native"] == 1 and calls["check_plain"] == 0
    # The sample's three windows on the caller's thread at the default count;
    # the host route's three tiles on prefetch threads, one thread each.
    assert seen[:3] == [(True, 3)] * 3
    assert seen[3:] == ([(False, 1)] * 3 if route == "host" else [])
    monkeypatch.setattr(CSRDataHandler, "_native_scans", lambda self: False)
    plain = _run(X, groups, reference="p0")
    assert calls["check_plain"] == 1 and calls["gather_plain"] == len(seen)
    assert nat.attrs["consume_path"] == plain.attrs["consume_path"] == {"native": 3, "numpy": 0}
    assert plain.index.equals(nat.index)
    assert np.array_equal(plain.values.view(np.uint64), nat.values.view(np.uint64))
    _frames_agree(nat, _jax(X, groups, reference="p0"))


def test_no_native_environment_gives_the_same_frame(tmp_path, no_native):
    """``ILLICO_TPU_NO_NATIVE=1`` in a fresh process: the plain bodies run,
    and the frame equals this process's with the library hidden bit for
    bit (the numpy tail in both)."""
    x, groups = _counts(t=60)
    X = sp.csr_matrix(x)
    sp.save_npz(tmp_path / "x.npz", X)
    np.save(tmp_path / "groups.npy", groups)
    script = (
        "import sys, json, numpy as np, scipy.sparse as sp\n"
        "import illico_tpu_torch.native as native\n"
        "from illico_tpu_torch import asymptotic_wilcoxon_arrays\n"
        "d = sys.argv[1]\n"
        "X = sp.load_npz(d + '/x.npz').tocsr()\n"
        "g = np.load(d + '/groups.npy')\n"
        "df = asymptotic_wilcoxon_arrays(X, g, reference='p0', device='cpu', progress=False,\n"
        "                                batch_size=128)\n"
        "np.save(d + '/frame.npy', df.values)\n"
        "print(json.dumps(native.csr_scan_calls))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, ILLICO_TPU_NO_NATIVE="1")
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == (
        '{"check_native": 0, "check_plain": 1, "gather_native": 0, "gather_plain": 4}')
    no_native()
    want = _run(X, groups, reference="p0")
    assert want.attrs["consume_path"] == {"native": 0, "numpy": 1}
    got = np.load(tmp_path / "frame.npy")
    assert np.array_equal(got.view(np.uint64), want.values.view(np.uint64))


def test_build_tag_follows_both_sources(tmp_path, monkeypatch):
    copies = []
    for src in native._SOURCES:
        shutil.copy(src, tmp_path / src.name)
        copies.append(tmp_path / src.name)
    assert [p.name for p in copies] == ["tail.cpp", "csr_scan.cpp"]
    monkeypatch.setattr(native, "_SOURCES", tuple(copies))
    tags = [native.build_tag()]
    for path in copies:
        path.write_bytes(path.read_bytes() + b"\n// changed\n")
        tags.append(native.build_tag())
    assert len(set(tags)) == 3 and all(len(t) == 16 for t in tags)
    monkeypatch.undo()
    want = hashlib.sha256(b"".join(hashlib.sha256(s.read_bytes()).digest()
                                   for s in native._SOURCES)).hexdigest()[:16]
    assert native.build_tag() == want


def test_scan_counts_lose_no_update_under_threads(calls):
    """The prefetch threads count their scans side by side."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            done = [pool.submit(lambda: [native.count_csr_scan("gather_native")
                                         for _ in range(2000)]) for _ in range(16)]
            for future in done:
                future.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert calls["gather_native"] == 16 * 2000
