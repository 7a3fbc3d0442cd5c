"""The port's native C++ tail (``illico_tpu_torch/csrc/tail.cpp``) on the CPU.

The library builds with the system C++ compiler into a given directory; its
fused tile consumer equals the numpy consume path (U equal, p and fold change
within rtol 1e-14) for OVO/OVR x three alternatives x continuity x tie
correction; it decodes a buffer packed by the JAX package and one packed by
the port from the same statistics to identical results, the split-word
boundary and f96 cases of ``tests/utils/test_native.py`` included; it is
bit-equal at 1 and 4 threads and at the default count; a truncated cached
library is rebuilt; and with the library disabled a run reports no native
tile and returns the same frame.  The default thread count is the cores the
process may use (less the prefetch threads on host input), which
``ILLICO_TPU_TAIL_THREADS`` overrides; the runner passes its count to both
native entry points.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "ops"))
from test_ksplit_wire import _ksplit_problem  # noqa: E402

import illico_tpu_torch.native as native  # noqa: E402
from illico_tpu.ops import hist_engine as jhe  # noqa: E402
from illico_tpu_torch import asymptotic_wilcoxon_arrays  # noqa: E402
from illico_tpu_torch.ops import wire  # noqa: E402
from illico_tpu_torch.stats import (  # noqa: E402
    fold_change_from_summed_expr,
    pvalues_from_stats,
)


@pytest.fixture
def cores(monkeypatch):
    """``cores(n)``: the process may run on ``n`` cores, and
    ``ILLICO_TPU_TAIL_THREADS`` is unset."""
    monkeypatch.delenv("ILLICO_TPU_TAIL_THREADS", raising=False)

    def set_cores(n):
        monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(n)), raising=False)

    return set_cores


@pytest.fixture
def resident(monkeypatch):
    """Treat every tensor as device-resident input, CPU tensors included."""
    from illico_tpu_torch.utils.registry import DeviceDenseDataHandler, data_handler_registry

    saved = dict.__getitem__(data_handler_registry, torch.Tensor)
    data_handler_registry[torch.Tensor] = DeviceDenseDataHandler
    yield
    data_handler_registry[torch.Tensor] = saved


@pytest.fixture
def no_native(monkeypatch):
    """Hide the native library: every consumer takes the numpy path."""

    def hide():
        native.native_available()
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_TRIED", True)

    return hide


def _problem(seed=3, n=4000, t=96, g=6):
    rng = np.random.RandomState(seed)
    X = rng.poisson(2.0, (n, t)).astype(np.float32)
    X[rng.rand(n, t) < 0.5] = 0
    groups = np.array([f"p{v}" for v in rng.randint(0, g, n)])
    return X, groups


def _run(X, groups, **kw):
    return asymptotic_wilcoxon_arrays(X, groups, device="cpu", progress=False, **kw)


def _assert_native_equals_numpy(a, b):
    np.testing.assert_array_equal(a.statistic.values, b.statistic.values)
    np.testing.assert_allclose(a.p_value.values, b.p_value.values, rtol=1e-14, atol=0)
    np.testing.assert_allclose(a.fold_change.values, b.fold_change.values, rtol=1e-14)


def test_library_builds_into_given_directory(tmp_path):
    lib = native._load_from(tmp_path)
    assert lib is not None, "no C++ compiler: the native tail did not build"
    for name in ("illico_pvalue_tail", "illico_consume_tile", "illico_consume_tile_ksplit"):
        assert hasattr(lib, name)
    for name in ("illico_csr_check_sorted", "illico_csr_gather_window"):
        assert hasattr(lib, name)
    tag = native.build_tag()
    built = [p.name for p in tmp_path.iterdir()]
    assert built == [f"illico_tail_{tag}.so"]  # nothing else, no temporary left
    assert [(s.name, s.parent.name) for s in native._SOURCES] == [
        ("tail.cpp", "csrc"), ("csr_scan.cpp", "csrc")]
    assert native.BUILD_DIR.name == "_build" and native.BUILD_DIR.parent.name == "illico_tpu_torch"


def test_truncated_cached_library_is_rebuilt(tmp_path):
    tag = native.build_tag()
    broken = tmp_path / f"illico_tail_{tag}.so"
    broken.write_bytes(b"\x7fNOT-AN-ELF-OBJECT")
    lib = native._load_from(tmp_path)
    assert lib is not None, "a truncated cached library was not rebuilt"
    assert hasattr(lib, "illico_consume_tile")
    assert broken.read_bytes()[:4] == b"\x7fELF"


def test_default_library_lives_in_package_build_dir():
    assert native.native_available()
    path = native.BUILD_INFO["path"]
    assert os.path.dirname(path) == str(native.BUILD_DIR)
    assert native.tail_threads() >= 1
    assert native.openmp_enabled()  # g++ with -fopenmp builds here


@pytest.mark.parametrize("tie_correct", [True, False], ids=["tie", "no-tie"])
@pytest.mark.parametrize("use_continuity", [True, False], ids=["contin", "no-contin"])
@pytest.mark.parametrize("alternative", ["two-sided", "greater", "less"])
@pytest.mark.parametrize("reference", ["p0", None], ids=["ovo", "ovr"])
def test_native_consume_matches_numpy(reference, alternative, use_continuity, tie_correct,
                                      no_native):
    X, groups = _problem()
    kw = dict(reference=reference, alternative=alternative,
              use_continuity=use_continuity, tie_correct=tie_correct)
    a = _run(X, groups, **kw)
    assert a.attrs["consume_path"] == {"native": 1, "numpy": 0}
    no_native()
    b = _run(X, groups, **kw)
    assert b.attrs["consume_path"] == {"native": 0, "numpy": 1}
    _assert_native_equals_numpy(a, b)


@pytest.mark.parametrize("engine", ["hist", "sort", "csort"])
@pytest.mark.parametrize("reference", ["p0", None], ids=["ovo", "ovr"])
def test_native_consume_threaded_is_bit_exact(reference, engine, monkeypatch):
    X, groups = _problem(seed=5, n=2000, t=300)
    kw = dict(reference=reference, engine=engine, batch_size=128)
    monkeypatch.setenv("ILLICO_TPU_TAIL_THREADS", "1")
    serial = _run(X, groups, **kw)
    assert serial.attrs["consume_path"] == {"native": 3, "numpy": 0}
    assert serial.attrs["tail_threads"] == 1
    monkeypatch.setenv("ILLICO_TPU_TAIL_THREADS", "4")
    assert native.tail_threads() == 4
    threaded = _run(X, groups, **kw)
    assert threaded.attrs["tail_threads"] == 4
    np.testing.assert_array_equal(serial.values, threaded.values)


@pytest.mark.parametrize("engine", ["hist", "sort", "csort"])
@pytest.mark.parametrize("reference", ["p0", None], ids=["ovo", "ovr"])
def test_native_consume_default_threads_is_bit_exact(reference, engine, cores, monkeypatch):
    """The default count (6 cores less 2 prefetch threads) and 1 thread give
    the same frame, the sort fallback's p-values included."""
    cores(6)
    X, groups = _problem(seed=5, n=2000, t=300)
    X[np.random.RandomState(1).randint(0, 2000, 40), 150] = 700.0  # past the table
    kw = dict(reference=reference, engine=engine, batch_size=128)
    default = _run(X, groups, **kw)
    assert default.attrs["tail_threads"] == 4
    assert default.attrs["consume_path"] == {"native": 3, "numpy": 0}
    if engine == "hist":
        assert default.attrs["n_fallback_cols"] >= 1
    monkeypatch.setenv("ILLICO_TPU_TAIL_THREADS", "1")
    serial = _run(X, groups, **kw)
    assert serial.attrs["tail_threads"] == 1
    np.testing.assert_array_equal(default.values, serial.values)


@pytest.mark.parametrize(
    "n_cores, busy, want", [(8, 0, 8), (8, 2, 6), (3, 2, 1), (2, 4, 1), (1, 0, 1)]
)
def test_default_tail_threads_is_the_affinity_count(n_cores, busy, want, cores):
    cores(n_cores)
    assert native.tail_threads(busy) == want


def test_default_tail_threads_without_affinity_is_the_cpu_count(monkeypatch):
    monkeypatch.delenv("ILLICO_TPU_TAIL_THREADS", raising=False)
    monkeypatch.delattr(os, "sched_getaffinity", raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: 5)
    assert native.tail_threads() == 5
    assert native.tail_threads(busy=2) == 3
    monkeypatch.setattr(os, "cpu_count", lambda: None)  # unknown
    assert native.tail_threads() == 1


@pytest.mark.parametrize(
    "value, want",
    [("1", 1), ("3", 3), ("12", 12), ("0", 1), ("-2", 1),
     ("four", None), ("", None), ("2.5", None)],
)
def test_tail_threads_env_overrides_the_default(value, want, cores, monkeypatch):
    """An integer wins over the default (at least 1 thread), prefetch
    threads or not; an unreadable value gives the default."""
    cores(6)
    monkeypatch.setenv("ILLICO_TPU_TAIL_THREADS", value)
    assert native.tail_threads() == (6 if want is None else want)
    assert native.tail_threads(busy=4) == (2 if want is None else want)


@pytest.mark.parametrize("n_threads", [1, 4])
@pytest.mark.parametrize("route", ["host", "device"])
def test_runner_counts_tail_threads_by_route(route, n_threads, cores, monkeypatch, request):
    """Host input leaves the prefetch threads (``max(2, n_threads)``) their
    cores, down to 1 tail thread; the device route has none to leave; the
    environment wins on both.  The count reaches both native entry points:
    the tile consumer and the sort fallback's p-value tail."""
    if route == "device":
        request.getfixturevalue("resident")
    X, groups = _problem(seed=6, n=2000, t=200)
    X[np.random.RandomState(2).randint(0, 2000, 40), 150] = 700.0  # past the table
    X = torch.from_numpy(X)
    seen = {"consume": [], "pvalue": []}
    consume, pvalue = native.consume_tile_native, native.pvalue_tail_native

    def spy_consume(*args, n_threads=None, **kwargs):
        seen["consume"].append(n_threads)
        return consume(*args, n_threads=n_threads, **kwargs)

    def spy_pvalue(*args, n_threads=None, **kwargs):
        seen["pvalue"].append(n_threads)
        return pvalue(*args, n_threads=n_threads, **kwargs)

    monkeypatch.setattr(native, "consume_tile_native", spy_consume)
    monkeypatch.setattr(native, "pvalue_tail_native", spy_pvalue)
    busy = max(2, n_threads) if route == "host" else 0
    for n_cores, env, want in [(8, None, 8 - busy), (3, None, max(1, 3 - busy)),
                               (8, "1", 1), (3, "5", 5)]:
        cores(n_cores)
        if env is not None:
            monkeypatch.setenv("ILLICO_TPU_TAIL_THREADS", env)
        seen["consume"].clear()
        seen["pvalue"].clear()
        df = _run(X, groups, reference="p0", batch_size=128, n_threads=n_threads)
        assert df.attrs["input_route"] == route
        assert df.attrs["tail_threads"] == want
        assert df.attrs["n_fallback_cols"] >= 1
        assert seen["consume"] == [want] * df.attrs["consume_path"]["native"]
        assert seen["pvalue"] and set(seen["pvalue"]) == {want}


@pytest.mark.parametrize("engine", ["hist", "sort", "csort"])
def test_disabled_library_reports_numpy_and_same_frame(engine, no_native):
    X, groups = _problem(seed=8, t=40)
    a = _run(X, groups, reference="p2", engine=engine)
    no_native()
    b = _run(X, groups, reference="p2", engine=engine)
    assert a.attrs["consume_path"]["numpy"] == 0
    assert b.attrs["consume_path"] == {"native": 0, "numpy": 1}
    _assert_native_equals_numpy(a, b)


def test_no_native_env_disables_the_library(monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setenv("ILLICO_TPU_NO_NATIVE", "1")
    assert not native.native_available()
    assert native.pvalue_tail_native(
        np.ones((2, 2)), np.zeros((2, 2)), np.ones(2), np.ones(2), True, True, "two-sided"
    ) is None


def test_pvalue_tail_native_matches_numpy():
    rng = np.random.RandomState(0)
    G, T = 5, 33
    nr = rng.randint(20, 400, (G, 1)).astype(np.float64)
    nt = rng.randint(20, 400, (G, 1)).astype(np.float64)
    U = np.floor(rng.rand(G, T) * nr * nt * 2) / 2
    tie = np.floor(rng.rand(G, T) * 1000)
    tie[0, 0] = ((nr + nt) ** 3 - (nr + nt))[0, 0]  # degenerate: all tied
    for alt in ("two-sided", "greater", "less"):
        for contin in (True, False):
            for tc in (True, False):
                got = pvalues_from_stats(U, tie, nr, nt, contin, tc, alt)
                want = pvalues_from_stats(U, tie, nr, nt, contin, tc, alt, prefer_native=False)
                # Uniformly random U reaches p ~ 1e-70, where libm's and
                # scipy's erfc differ by a few more ULPs than on real data.
                np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    assert pvalues_from_stats(U, tie, nr, nt)[0, 0] == 1.0
    # A 1-d sample-size vector broadcasts per column in numpy: not the native path.
    np.testing.assert_array_equal(
        pvalues_from_stats(U[:, :G], tie[:, :G], nr.ravel(), nt.ravel()),
        pvalues_from_stats(U[:, :G], tie[:, :G], nr.ravel(), nt.ravel(), prefer_native=False),
    )


# -- crafted buffers: JAX-packed and torch-packed, one consumer -------------------
def _spec_dict(spec):
    return {k: (shape, dtype, off, nbytes) for k, shape, dtype, off, nbytes in spec}


def _consume_both_packs(arrays, narrow, counts, ref_code, **split):
    """Pack ``arrays`` with the JAX package and with the port, consume both
    buffers with the port's native library, and return the (identical)
    result block."""
    G, T = next(v.shape for v in arrays.values() if v.ndim == 2)
    with jax.enable_x64(True):
        jbuf, jspec = jhe.pack_device_outputs({k: jnp.asarray(v) for k, v in arrays.items()}, narrow)
        jbuf = np.ascontiguousarray(np.asarray(jbuf))
    tbuf, tspec = wire.pack_device_outputs(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}, narrow
    )
    tbuf = tbuf.numpy()
    assert tspec == jspec
    np.testing.assert_array_equal(tbuf, jbuf)
    results = []
    for buf, spec in ((jbuf, jspec), (tbuf, tspec)):
        res = np.full((G, T, 3), np.nan)
        ok = native.consume_tile_native(
            buf, _spec_dict(spec), counts, ref_code, T, "two-sided", True, True, res, 0, **split
        )
        assert ok, "native consume unavailable for the crafted spec"
        results.append(res)
    np.testing.assert_array_equal(results[0], results[1])
    return results[1]


def test_native_decode_at_split_word_boundaries_ovo():
    G, T = 3, 4
    counts = np.array([1000.0, 700.0, 500.0])
    u2 = np.array([[0, 2, 4, 6], [2**24 - 1, 2**24 - 2, 2**16, 2], [1, 3, 2**24 - 1, 0]],
                  np.float64)
    tie_seg = np.array([
        [0, 2**40 - 1, 2**32 - 1, 2**32],
        [2**32 - 1, 0, 12345, 2**40 - 1],
        [2**33, 2**40 - 2, 1, 2**32 + 1],
    ], np.float64)
    tie_ref_col = np.array([2.0**52 - 1, 2.0**32 - 1, 0.0, 7.0])
    fc_sums = np.array([[65535, 0, 1, 2], [3, 65535, 4, 5], [6, 7, 65534, 8]], np.float64)
    arrays = {
        "U2": u2.astype(np.uint32), "tie_seg": tie_seg, "tie_ref_col": tie_ref_col,
        "fc_sums": fc_sums.astype(np.uint16), "overflow_cols": np.zeros(T, bool),
    }
    res = _consume_both_packs(arrays, {"U2": 3, "tie_seg": 5}, counts, 0)
    n_ref, n_tgt = counts[0], counts[:, None]
    U = n_ref * n_tgt - u2 / 2.0
    p = pvalues_from_stats(U, tie_ref_col[None] + tie_seg, np.full((G, 1), n_ref), n_tgt,
                           prefer_native=False)
    np.testing.assert_array_equal(res[..., 1], U)
    np.testing.assert_array_equal(res[..., 2], fold_change_from_summed_expr(fc_sums, counts, 0))
    np.testing.assert_allclose(res[..., 0], p, rtol=1e-12, atol=0.0)


def test_native_decode_at_split_word_boundaries_ovr():
    G, T = 3, 4
    counts = np.array([200.0, 5000.0, 300.0])
    r2 = np.array([[2**31 - 1, 2**31 - 2, 0, 2], [0, 0, 0, 0], [4, 2**30, 6, 2**31 - 1]],
                  np.float64)
    r2_split_col = np.array([2.0**52 - 1, 2.0**32 - 1, 2.0**32, 123456789.0])
    fc_sums = np.array([[65535, 1, 2, 3], [0, 0, 0, 0], [4, 5, 65534, 6]], np.float64)
    fc_split_col = np.array([2**32 - 1, 2**24, 0, 7], np.float64)
    tie_col = np.array([2.0**52 - 1, 2.0**32 - 1, 0.0, 2.0**33])
    arrays = {
        "R2": r2.astype(np.int32), "r2_split_col": r2_split_col,
        "fc_sums": fc_sums.astype(np.uint16), "fc_split_col": fc_split_col.astype(np.uint32),
        "tie_col": tie_col, "overflow_cols": np.zeros(T, bool),
    }
    res = _consume_both_packs(arrays, {}, counts, -1, fc_split_code=1, u2_split_code=1)
    r2_full, fc_full = r2.copy(), fc_sums.copy()
    r2_full[1], fc_full[1] = r2_split_col, fc_split_col
    n_tgt = counts[:, None]
    n_ref = counts.sum() - n_tgt
    U = n_ref * n_tgt + n_tgt * (n_tgt + 1.0) / 2.0 - r2_full / 2.0
    p = pvalues_from_stats(U, np.broadcast_to(tie_col[None], (G, T)), n_ref, n_tgt,
                           prefer_native=False)
    np.testing.assert_array_equal(res[..., 1], U)
    np.testing.assert_array_equal(res[..., 2], fold_change_from_summed_expr(fc_full, counts, -1))
    np.testing.assert_allclose(res[..., 0], p, rtol=1e-12, atol=0.0)


def test_native_decode_f96_tier_ovo():
    G, T = 3, 4
    counts = np.array([3_000_000.0, 900_000.0, 600_000.0])
    u2 = np.array([[0, 2, 4, 6], [2**24 - 1, 2**24 - 2, 2**16, 2], [1, 3, 2**24 - 1, 0]],
                  np.float64)
    n4m = 4_194_304.0
    tie_seg = np.array([
        [0.0, 2.0**63, 2.0**63 + 2048.0, 2.0**66],
        [n4m**3 - n4m, 2.0**64 + 4096.0, 1.0, 2.0**70],
        [2.0**63 - 1.0, 12345.0, 2.0**52 + 1.0, 3.0],
    ], np.float64)
    tie_ref_col = np.array([2.0**64, 2.0**63 - 2.0, 0.0, 2.0**66 + 2.0**20])
    fc_sums = np.array([  # f96 also carries signs and fractions (csort fc sums)
        [65535.25, 0.0, -1.5, 1.0 / 3.0],
        [3.0, -65535.75, 123456789.123456789, 5.0],
        [6.5, 7.0, 2.0**53 - 1.0, -8.25],
    ], np.float64)
    arrays = {
        "U2": u2.astype(np.uint32), "tie_seg": tie_seg, "tie_ref_col": tie_ref_col,
        "fc_sums": fc_sums, "overflow_cols": np.zeros(T, bool),
    }
    narrow = {"U2": 3, "tie_seg": 12, "tie_ref_col": 12, "fc_sums": 12}
    res = _consume_both_packs(arrays, narrow, counts, 0)
    n_ref, n_tgt = counts[0], counts[:, None]
    U = n_ref * n_tgt - u2 / 2.0
    p = pvalues_from_stats(U, tie_ref_col[None] + tie_seg, np.full((G, 1), n_ref), n_tgt,
                           prefer_native=False)
    np.testing.assert_array_equal(res[..., 1], U)
    np.testing.assert_array_equal(res[..., 2], fold_change_from_summed_expr(fc_sums, counts, 0))
    np.testing.assert_allclose(res[..., 0], p, rtol=1e-12, atol=0.0)


def test_unknown_encoding_falls_back_to_numpy():
    spec = {"U2": ((2, 2), np.dtype(np.int16), 0, 8)}
    with pytest.raises(ValueError, match="unsupported packed encoding"):
        native._encode_packed(np.zeros(8, np.uint8), *spec["U2"])
    full = {
        "U2": ((2, 2), np.dtype(np.int16), 0, 8),
        "fc_sums": ((2, 2), np.dtype(np.float32), 8, 16),
        "tie_seg": ((2, 2), np.dtype(np.float32), 24, 16),
        "tie_ref_col": ((2,), np.dtype(np.float32), 40, 8),
    }
    assert not native.consume_tile_native(
        np.zeros(48, np.uint8), full, np.ones(2), 0, 2, "two-sided", True, True,
        np.zeros((2, 2, 3)), 0,
    )
    assert not native.consume_tile_native(
        np.zeros(48, np.uint8), {}, np.ones(2), 0, 2, "two-sided", True, True,
        np.zeros((2, 2, 3)), 0,
    )


# -- the nnz-split consumer -----------------------------------------------------------
@pytest.mark.parametrize("fc_u8", [False, True])
def test_ksplit_native_consume_matches_numpy_and_jax_buffer(fc_u8):
    """An nnz-split tile with exceptions: the port's native consumer gives
    the same block from the JAX-packed and the torch-packed buffer, equal to
    the numpy path on the reconstructed statistics."""
    from illico_tpu_torch.ops import hist_engine as the
    from illico_tpu_torch.ops import rank_engine as tre
    from illico_tpu_torch.utils.groups import encode_and_count_groups

    x, info, jlayout = _ksplit_problem(seed=17, t=80, density=0.25)
    x[np.flatnonzero(info.encoded_groups == 5), 3] = 2.0  # exceptions
    x[np.flatnonzero(info.encoded_groups == 4)[:30], 9] = 30.0
    _, tinfo = encode_and_count_groups(np.array([f"g{i:03d}" for i in info.encoded_groups]), "g000")
    tlayout = tre.build_padded_layout(tinfo.perm, tinfo.indptr)
    tfn = the.make_hist_tile_fn(tlayout, ref_code=tinfo.ref_code, is_log1p=False,
                                device=torch.device("cpu"), fc_u8_hint=fc_u8)
    jfn = jhe.make_hist_tile_fn(jlayout, ref_code=info.ref_code, is_log1p=False,
                                interpret=True, fc_u8_hint=fc_u8)
    assert tfn._statics["nnz_split"] and tfn._statics["fc_u8"] is fc_u8
    tbuf = tfn(torch.from_numpy(x)).numpy()
    jbuf = np.ascontiguousarray(np.asarray(jfn(x)))  # packed at 128 columns
    counts = tinfo.counts.astype(np.float64)
    G, T = tinfo.n_groups, x.shape[1]
    blocks = []
    for buf, fn in ((tbuf, tfn), (jbuf, jfn)):
        res = np.full((G, T, 3), np.nan)
        assert native.consume_tile_native(
            buf, fn.find_spec(buf.size), counts, tinfo.ref_code, T, "two-sided", True, True,
            res, 0, fc_split_code=fn._statics["fc_split_code"],
        )
        blocks.append(res)
    np.testing.assert_array_equal(blocks[0], blocks[1])
    out = tfn.unpack(tbuf)
    raw = wire.unpack_host_buffer(tbuf, tfn._spec_cache[T])
    assert (raw["exc_key"] != wire._EXC_KEY_SENTINEL).any()
    fc_sums = np.asarray(out["fc_sums"], np.float64)[:, :T]
    fc_sums[tfn._statics["fc_split_code"]] = out["fc_split_col"][:T]
    n_ref, n_tgt = counts[tinfo.ref_code], counts[:, None]
    U = n_ref * n_tgt - out["U2"][:, :T] / 2.0
    tie = out["tie_ref_col"][None, :T] + out["tie_seg"][:, :T]
    p = pvalues_from_stats(U, tie, np.full((G, 1), n_ref), n_tgt, prefer_native=False)
    keep = np.arange(G) != tinfo.ref_code  # the reference row gets sentinels later
    np.testing.assert_array_equal(blocks[0][keep, :, 1], U[keep])
    np.testing.assert_array_equal(
        blocks[0][keep, :, 2], fold_change_from_summed_expr(fc_sums, counts, tinfo.ref_code)[keep]
    )
    np.testing.assert_allclose(blocks[0][keep, :, 0], p[keep], rtol=1e-14, atol=0)
