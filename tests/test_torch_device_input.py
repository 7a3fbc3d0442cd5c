"""``torch.Tensor`` inputs, the warm-up and the profiler hook, on the CPU.

A CPU tensor is host input (the dense handler on its numpy view).  A CUDA
tensor is device-resident input; its code path (``DeviceDenseDataHandler``:
column slices on the device, device-side sampling with one pull, each tile
dispatched one tile ahead of its consume, no staging) does not depend on the device being a CUDA
one, so these tests drive it with a CPU tensor by registering that handler
for ``torch.Tensor``.  Either way the frame equals the ``ndarray`` input's
exactly.
"""

import json
import os

import numpy as np
import pytest
import torch
from test_torch_csort import _routing_case

import illico_tpu_torch
from illico_tpu_torch import asymptotic_wilcoxon_arrays
from illico_tpu_torch.api import resolve_device
from illico_tpu_torch.models.wilcoxon import WilcoxonRunner
from illico_tpu_torch.utils.groups import encode_and_count_groups
from illico_tpu_torch.utils.registry import (
    DenseDataHandler,
    DeviceDenseDataHandler,
    data_handler_registry,
)

CPU = torch.device("cpu")


@pytest.fixture
def resident():
    """Treat every tensor as device-resident input, CPU tensors included."""
    saved = dict.__getitem__(data_handler_registry, torch.Tensor)
    data_handler_registry[torch.Tensor] = DeviceDenseDataHandler
    yield
    data_handler_registry[torch.Tensor] = saved


def _counts(seed=0, n=3000, t=300, g=6, hot=False, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.poisson(2.0, (n, t)).astype(dtype)
    x[rng.rand(n, t) < 0.6] = 0
    if hot:  # columns past the value table, outside the sampling windows
        x[rng.randint(0, n, 30), 60] = 700
        x[rng.randint(0, n, 30), 200] = 650
    groups = np.array([f"p{v}" for v in rng.randint(0, g, n)])
    return x, groups


def _run(X, groups, **kw):
    kw.setdefault("device", "cpu")
    return asymptotic_wilcoxon_arrays(X, groups, progress=False, **kw)


def _assert_same_frame(a, b):
    assert a.index.equals(b.index)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.attrs["engine"] == b.attrs["engine"]
    assert a.attrs["n_fallback_cols"] == b.attrs["n_fallback_cols"]


def test_registry_routes_tensors():
    x = torch.zeros((4, 3))
    h = data_handler_registry.get(x)
    assert isinstance(h, DenseDataHandler) and not getattr(h, "is_device", False)
    assert np.shares_memory(h.data, x.numpy())  # the zero-copy view
    with pytest.raises(ValueError, match="2-d"):
        data_handler_registry.get(torch.zeros(3))
    d = DeviceDenseDataHandler(torch.arange(12, dtype=torch.int16).reshape(3, 4))
    assert d.is_device and d.dtype == np.int16 and d.shape == (3, 4)
    assert d.footprint() == 24
    assert d.fetch_tile(1, 3).tolist() == [[1, 2], [5, 6], [9, 10]]
    assert d.fetch_columns([3, 0]).tolist() == [[3, 0], [7, 4], [11, 8]]


@pytest.mark.parametrize("reference", ["p0", None], ids=["ovo", "ovr"])
@pytest.mark.parametrize("case", ["hist", "hist-overflow", "sort", "int16", "float64"])
def test_cpu_tensor_gives_the_ndarray_frame(case, reference):
    x, groups = _counts(hot=case == "hist-overflow",
                        dtype={"int16": np.int16, "float64": np.float64}.get(case, np.float32))
    kw = dict(reference=reference, batch_size=128)  # 300 genes: tiles of 128, 128, 44
    if case == "sort":
        kw["engine"] = "sort"
    want = _run(x, groups, **kw)
    got = _run(torch.from_numpy(x), groups, **kw)
    _assert_same_frame(got, want)
    # float64 at 40% nonzero: host input takes the compact sort.
    assert got.attrs["engine"] == {"sort": "sort", "float64": "csort"}.get(case, "hist")
    if case == "hist-overflow":
        assert got.attrs["n_fallback_cols"] == 2


@pytest.mark.parametrize("reference", ["p0", None], ids=["ovo", "ovr"])
@pytest.mark.parametrize("case", ["hist", "hist-overflow", "sort", "log1p", "int16", "float64"])
def test_device_resident_path_gives_the_ndarray_frame(case, reference, resident):
    x, groups = _counts(hot=case == "hist-overflow",
                        dtype={"int16": np.int16, "float64": np.float64}.get(case, np.float32))
    kw = dict(reference=reference, batch_size=128)
    if case == "log1p":
        x = np.log1p(x).astype(np.float32)
        kw["is_log1p"] = True
    # A device-resident float64 matrix takes the sort engine (the compact
    # sort needs host input): hold it against host input through the same.
    want = _run(x, groups, **kw, **({"engine": "sort"} if case in ("sort", "float64") else {}))
    if case == "sort":
        kw["engine"] = "sort"
    got = _run(torch.from_numpy(x), groups, **kw)
    _assert_same_frame(got, want)
    st = got.attrs["stage_seconds"]
    assert st["fetch"] == 0.0  # no prefetch wait: the tiles are slices
    assert got.attrs["consume_path"] == {"native": 3, "numpy": 0}
    if case == "hist-overflow":
        assert got.attrs["n_fallback_cols"] == 2


@pytest.mark.parametrize("devices", [None, 2, (2, 1)], ids=["one", "gene-mesh", "cell-mesh"])
@pytest.mark.parametrize("reference", ["p0", None], ids=["ovo", "ovr"])
def test_device_resident_loop_consumes_one_tile_behind(reference, devices, resident,
                                                       monkeypatch):
    """The device-resident loop dispatches tile i+1 before it consumes tile
    i (so the host tail runs while the devices work), and consumes tile i
    before it dispatches tile i+2; under a gene mesh each shard's next
    tile is dispatched before its tile is consumed.  The frame equals the
    host-input frame bit for bit."""
    import illico_tpu_torch.native as native

    width = 128
    x, groups = _counts(seed=4, t=4 * width - 16, hot=True)  # 4 tiles, the last short
    kw = dict(reference=reference, engine="hist", batch_size=width, devices=devices)
    want = _run(x, groups, **kw)
    order = []
    fetch, consume = WilcoxonRunner._fetch, native.consume_tile_native

    def spy_fetch(self, lb, ub):
        order.append(("dispatch", lb))
        return fetch(self, lb, ub)

    def spy_consume(*args, **kwargs):
        order.append(("pull", args[9]))  # col0
        return consume(*args, **kwargs)

    monkeypatch.setattr(WilcoxonRunner, "_fetch", spy_fetch)
    monkeypatch.setattr(native, "consume_tile_native", spy_consume)
    got = _run(torch.from_numpy(x), groups, **kw)
    assert got.attrs["input_route"] == "device"
    _assert_same_frame(got, want)
    n_items = got.attrs["consume_path"]["native"]
    assert got.attrs["consume_path"]["numpy"] == 0
    assert len(order) == 2 * n_items and n_items >= 4
    at = {item: k for k, item in enumerate(order)}
    assert len(at) == len(order)  # each shard tile dispatched and consumed once
    for (kind, lb), k in at.items():
        if kind == "dispatch":
            continue
        tile, offset = divmod(lb, width)
        assert at[("dispatch", lb)] < k
        if tile + 1 < 4:  # the shard's next tile is on its device before this tail
            assert at[("dispatch", (tile + 1) * width + offset)] < k
        for (kind2, lb2), k2 in at.items():  # no tile two ahead before this tail
            if kind2 == "dispatch" and lb2 // width >= tile + 2:
                assert k < k2


def test_device_resident_refuses_csort_and_auto_skips_it(resident):
    x, groups = _routing_case("normalized-dense")
    with pytest.raises(ValueError, match="host-resident"):
        _run(torch.from_numpy(x), groups, engine="csort")
    # Host input of this data routes to csort; device-resident to sort.
    assert _run(x, groups).attrs["engine"] == "csort"
    got = _run(torch.from_numpy(x), groups)
    assert got.attrs["engine"] == "sort"
    want = _run(x, groups, engine="sort")
    np.testing.assert_array_equal(got.values, want.values)


@pytest.mark.parametrize("is_log1p", [False, True], ids=["raw", "log1p"])
@pytest.mark.parametrize("name", [
    "normalized-dense", "dense-sampled-density", "dense-above-threshold", "high-counts",
    "mid-band-counts", "few-overflow-columns",
])
def test_device_sampling_routes_as_host_sampling(name, is_log1p):
    """The inputs of tests/test_csort_routing.py (and their log1p images):
    sampling on the device sees what sampling on the host sees."""
    X, labels = _routing_case(name)
    x = np.ascontiguousarray(X.toarray() if hasattr(X, "toarray") else X)
    if is_log1p and not name.startswith(("normalized", "dense")):
        x = np.log1p(x).astype(np.float32)
    _, info = encode_and_count_groups(labels, None)
    host = WilcoxonRunner(DenseDataHandler(x), info, is_log1p=is_log1p, device=CPU)
    dev = WilcoxonRunner(DeviceDenseDataHandler(torch.from_numpy(x)), info,
                         is_log1p=is_log1p, device=CPU)
    assert dev.engine == {"csort": "sort"}.get(host.engine, host.engine)
    assert dev._sampled_conforms == host._sampled_conforms
    assert dev._sampled_overflow_frac == host._sampled_overflow_frac
    # Both size the value table from the whole windows' maximum.
    assert dev._sampled_vmax == host._sampled_vmax
    assert dev._v_buckets == host._v_buckets
    col_sum_d, col_nnz_d, rows_d = dev._sampled_colstats
    col_sum_h, col_nnz_h, rows_h = host._sampled_colstats
    assert rows_d == rows_h == x.shape[0]
    np.testing.assert_array_equal(col_nnz_d, col_nnz_h)
    np.testing.assert_allclose(col_sum_d, col_sum_h, rtol=1e-6)


def test_fc_u8_hint_from_device_sampling(resident):
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "ops"))
    from test_ksplit_wire import _ksplit_problem

    x, info, _ = _ksplit_problem(seed=21)
    labels = np.array([f"g{i:03d}" for i in info.encoded_groups])
    _, tinfo = encode_and_count_groups(labels, "g000")
    r = WilcoxonRunner(DeviceDenseDataHandler(torch.from_numpy(x)), tinfo, is_log1p=False,
                       device=CPU, engine="hist")
    assert r.tile_fn._statics["nnz_split"] and r.tile_fn._statics["fc_u8"]


def test_resolve_device_with_tensors(monkeypatch):
    assert resolve_device("cpu", torch.zeros((2, 2))) == CPU

    class FakeCuda:  # a tensor that says it lives on cuda:1
        is_cuda = True
        device = torch.device("cuda", 1)

    monkeypatch.setattr(torch, "Tensor", FakeCuda)
    assert resolve_device(None, FakeCuda()) == torch.device("cuda", 1)
    assert resolve_device("cuda", FakeCuda()) == torch.device("cuda", 1)
    assert resolve_device("cuda:1", FakeCuda()) == torch.device("cuda", 1)
    for other in ("cpu", "cuda:0"):
        with pytest.raises(ValueError, match="lives on cuda:1"):
            resolve_device(other, FakeCuda())


@pytest.mark.parametrize("engine", ["hist", "sort", "csort"])
@pytest.mark.parametrize("reference", ["p0", None], ids=["ovo", "ovr"])
def test_precompile_true_and_false_give_the_same_frame(engine, reference):
    x, groups = _counts(seed=2, n=1500, t=40)
    a = _run(x, groups, reference=reference, engine=engine, precompile=True)
    b = _run(x, groups, reference=reference, engine=engine, precompile=False)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.attrs["stage_seconds"]["precompile"] > 0.0
    assert b.attrs["stage_seconds"]["precompile"] == 0.0


def test_precompile_device_resident(resident):
    x, groups = _counts(seed=2, n=1500, t=40)
    a = _run(torch.from_numpy(x), groups, precompile=True)
    b = _run(x, groups, precompile=False)
    np.testing.assert_array_equal(a.values, b.values)


def test_profile_dir_writes_a_trace(tmp_path):
    x, groups = _counts(seed=3, n=800, t=20)
    out = tmp_path / "prof"
    a = _run(x, groups, reference="p1", profile_dir=str(out))
    b = _run(x, groups, reference="p1")
    np.testing.assert_array_equal(a.values, b.values)
    trace = out / "trace.json"
    assert trace.exists()
    events = json.loads(trace.read_text())["traceEvents"]
    assert len(events) > 0


@pytest.mark.cuda
def test_cuda_tensor_input_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device-resident input on the card")
    x, groups = _counts(hot=True)
    want = illico_tpu_torch.asymptotic_wilcoxon_arrays(x, groups, progress=False, batch_size=128)
    got = illico_tpu_torch.asymptotic_wilcoxon_arrays(
        torch.from_numpy(x).cuda(), groups, progress=False, batch_size=128
    )
    np.testing.assert_array_equal(got.values, want.values)
    assert got.attrs["stage_seconds"]["h2d"] == 0.0
    with pytest.raises(ValueError, match="lives on"):
        illico_tpu_torch.asymptotic_wilcoxon_arrays(
            torch.from_numpy(x).cuda(), groups, progress=False, device="cpu"
        )
