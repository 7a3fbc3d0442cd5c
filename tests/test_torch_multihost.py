"""The multi-process layer of the port, on the CPU.

Window math and window handlers against the JAX package's, the simulated
multi-host layout (every host's window inside one process, each on its own
slice of a pool of logical CPU shards) against the single-device frame, and
a real two-process run joined by ``torch.distributed`` (gloo) on localhost,
for which this file is its own worker:

    python tests/test_torch_multihost.py <address> <world> <rank> <out.npz> [device]
"""

import os
import sys

import numpy as np
import pandas as pd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _problem(n_cells=3000, n_genes=256, n_groups=6, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.poisson(2.0, (n_cells, n_genes)).astype(np.float32)
    x[rng.rand(n_cells, n_genes) < 0.6] = 0
    labels = np.array([f"p{v}" for v in rng.randint(0, n_groups, n_cells)])
    return x, labels


def _special_block(rank, n_groups=3, width=100):
    """A result block with full float64 mantissas, NaN and both infinities."""
    block = np.random.RandomState(100 + rank).standard_normal((n_groups, width, 3))
    block[0, 0] = [np.nan, np.inf, -np.inf]
    block[1, 1, 0] = 5e-324
    return block


def _worker(argv) -> int:
    """One process of the two-process run: the API frame of a 300-gene
    problem (two windows of 256 and 44 genes) and a gather of special
    values, written to ``out`` for the test to compare."""
    address, world, rank, out = argv[1], int(argv[2]), int(argv[3]), argv[4]
    device = argv[5] if len(argv) > 5 else "cpu"
    sys.path.insert(0, REPO)
    import illico_tpu_torch
    from illico_tpu_torch.io.h5ad import AnnDataLite
    from illico_tpu_torch.parallel import multihost as mh

    assert mh.initialize_distributed(address, world, rank) == (world, rank)
    assert mh.initialize_distributed() == (world, rank)  # a second call is safe
    x, labels = _problem(n_genes=300)
    adata = AnnDataLite(x, obs=pd.DataFrame({"group": labels}),
                        var=pd.DataFrame(index=[f"g{i}" for i in range(x.shape[1])]))
    frames = {}
    for tag, reference in (("ovo", "p0"), ("ovr", None)):
        df = illico_tpu_torch.asymptotic_wilcoxon_multihost(
            adata, is_log1p=False, group_keys="group", reference=reference, device=device)
        frames[tag] = df.values
    n_genes = 228  # windows [0, 128) and [128, 228)
    lb, ub = mh.host_gene_window(n_genes, world, rank)
    full = mh._allgather_blocks(lb, ub, _special_block(rank, width=ub - lb), n_genes, world)
    np.savez(out, gathered=full, **frames)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv))

import socket
import subprocess

import pytest
import torch
from scipy import sparse

import illico_tpu
import illico_tpu_torch
from illico_tpu.io.h5ad import AnnDataLite as JaxAnnDataLite
from illico_tpu.parallel import multihost as jmh
from illico_tpu_torch.io.h5ad import AnnDataLite, read_h5ad
from illico_tpu_torch.parallel.multihost import (
    ColumnWindowHandler,
    _assemble_blocks,
    _window_base,
    asymptotic_wilcoxon_multihost,
    host_gene_window,
    initialize_distributed,
    simulate_multihost,
    window_handler,
)
from illico_tpu_torch.utils.registry import (
    DeviceDenseDataHandler,
    data_handler_registry,
    ensure_backed_handlers,
)

CPU8 = [torch.device("cpu")] * 8


def _adata(x, labels):
    return AnnDataLite(
        x,
        obs=pd.DataFrame({"group": labels}),
        var=pd.DataFrame(index=[f"g{i}" for i in range(x.shape[1])]),
    )


def _single(adata, **kw):
    return illico_tpu_torch.asymptotic_wilcoxon(adata, device="cpu", progress=False, **kw)


# -- window math ------------------------------------------------------------------------


@pytest.mark.parametrize("n_genes", [1, 100, 129, 256, 8000])
@pytest.mark.parametrize("num_hosts", [1, 2, 3, 8])
def test_host_gene_window_equals_the_reference(n_genes, num_hosts):
    """The port keeps its own copy of the window math; it splits a gene axis
    exactly as the reference does."""
    assert _window_base(n_genes, num_hosts) == jmh._window_base(n_genes, num_hosts)
    windows = [host_gene_window(n_genes, num_hosts, h) for h in range(num_hosts)]
    assert windows == [jmh.host_gene_window(n_genes, num_hosts, h) for h in range(num_hosts)]
    assert windows[0][0] == 0 and windows[-1][1] == n_genes
    for (_, a_ub), (b_lb, _) in zip(windows, windows[1:]):
        assert a_ub == b_lb
    for lb, ub in windows:
        assert lb % 128 == 0 or lb == n_genes
        assert ub % 128 == 0 or ub == n_genes


def test_host_gene_window_validates_host_id():
    with pytest.raises(ValueError, match="host_id"):
        host_gene_window(100, 2, 2)
    assert host_gene_window(300, 2, 1, align=32) == jmh.host_gene_window(300, 2, 1, align=32)


# -- window handlers ------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["dense", "csr", "csc"])
def test_window_handler_matches_base_slices(fmt):
    x, _ = _problem(n_cells=500)
    X = {"dense": lambda a: a, "csr": sparse.csr_matrix, "csc": sparse.csc_matrix}[fmt](x)
    base = data_handler_registry.get(X)
    wh = window_handler(base, 128, 256)
    assert isinstance(wh, ColumnWindowHandler) and not wh.is_device
    assert wh.shape == (500, 128) and wh.dtype == base.dtype
    np.testing.assert_array_equal(np.asarray(wh.fetch_tile(0, 40)), x[:, 128:168])
    idx = np.array([0, 5, 5, 127, 64])
    np.testing.assert_array_equal(np.asarray(wh.fetch_columns(idx)), x[:, idx + 128])
    # The csort tiler's entry reads: tile-relative columns inside the window.
    v, r, c = wh.fetch_tile_entries(10, 30)
    dense = np.zeros((500, 20), np.float32)
    dense[r, c] = v
    np.testing.assert_array_equal(dense, x[:, 138:158])
    assert wh.density() == base.density()
    assert 0 < wh.footprint() <= base.footprint()
    assert wh.tile_footprint(16) == base.tile_footprint(16)
    wh.validate()


def test_window_handler_backed_reads_only_the_window(tmp_path):
    """A backed dataset windowed to [128, 256) never touches other columns."""
    ensure_backed_handlers()
    x, labels = _problem(n_cells=400)
    path = tmp_path / "w.h5ad"
    _adata(sparse.csc_matrix(x), labels).write_h5ad(path)
    backed = read_h5ad(path, backed="r")
    base = data_handler_registry.get(backed.X)
    reads = []
    inner = base.data.window_entries

    def spy(lb, ub):
        reads.append((lb, ub))
        return inner(lb, ub)

    base.data.window_entries = spy
    wh = window_handler(base, 128, 256)
    v, r, c = wh.fetch_tile_entries(10, 30)
    dense = np.zeros((400, 20), np.float32)
    dense[r, c] = v
    np.testing.assert_array_equal(dense, x[:, 138:158])
    assert reads == [(138, 158)]
    np.testing.assert_array_equal(np.asarray(wh.fetch_tile(10, 30)), x[:, 138:158])


def test_window_handler_bounds_and_data_attribute():
    x, _ = _problem(n_cells=100)
    base = data_handler_registry.get(x)
    with pytest.raises(ValueError, match="Window"):
        ColumnWindowHandler(base, 100, 300)
    # The un-offset base matrix must not leak out as ``.data``.
    with pytest.raises(AttributeError, match="window"):
        _ = ColumnWindowHandler(base, 0, 128).data


def test_window_handler_slices_a_device_resident_base():
    x, _ = _problem(n_cells=50)
    base = DeviceDenseDataHandler(torch.from_numpy(x))
    saved = dict.__getitem__(data_handler_registry, torch.Tensor)
    data_handler_registry[torch.Tensor] = DeviceDenseDataHandler
    try:
        wh = window_handler(base, 128, 200)
    finally:
        data_handler_registry[torch.Tensor] = saved
    assert isinstance(wh, DeviceDenseDataHandler) and wh.shape == (50, 72)
    assert torch.equal(wh.fetch_tile(0, 8), torch.from_numpy(x[:, 128:136]))


# -- block assembly ---------------------------------------------------------------------------


def test_assemble_blocks_detects_gaps():
    with pytest.raises(RuntimeError, match="cover"):
        _assemble_blocks([(0, 100, np.zeros((2, 100, 3)))], 2, 256)


def test_assemble_blocks_detects_overlap_with_matching_total():
    """Overlap + gap whose widths sum to exactly n_genes must still raise."""
    blocks = [
        (0, 128, np.zeros((2, 128, 3))),
        (100, 200, np.zeros((2, 100, 3))),
        (228, 256, np.zeros((2, 28, 3))),
    ]
    with pytest.raises(RuntimeError, match="tile"):
        _assemble_blocks(blocks, 2, 256)


def test_assemble_blocks_takes_any_order_and_padded_blocks():
    a, b = _special_block(0, width=128), _special_block(1, width=128)
    full = _assemble_blocks([(128, 228, b), (0, 128, a)], 3, 228)
    np.testing.assert_array_equal(full[:, :128], a)
    np.testing.assert_array_equal(full[:, 128:], b[:, :100])


# -- the simulated layout ----------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["hist", "sort", "csort"])
@pytest.mark.parametrize("reference", ["p0", None], ids=["ovo", "ovr"])
def test_simulate_multihost_matches_single_run(engine, reference):
    """2 simulated hosts x 4 logical devices == one single-device run, bit
    for bit, and == the JAX package's simulated run on its 8 virtual CPU
    devices (U exact, p within rtol 1e-12, fold change within rtol 1e-6)."""
    x, labels = _problem()
    adata = _adata(x, labels)
    kw = dict(is_log1p=False, group_keys="group", reference=reference, engine=engine)
    df_mh = simulate_multihost(adata, n_hosts=2, devices_per_host=4, devices=CPU8, **kw)
    pd.testing.assert_frame_equal(df_mh, _single(adata, **kw), check_exact=True)
    jadata = JaxAnnDataLite(x, obs=adata.obs, var=adata.var)
    if engine == "csort":
        # The reference's window handler has no entry reads for the csort
        # tiler, so its simulated run cannot take csort: hold the port to the
        # reference's single run there.
        want = illico_tpu.asymptotic_wilcoxon(jadata, progress=False, **kw)
    else:
        want = jmh.simulate_multihost(jadata, n_hosts=2, devices_per_host=4, **kw)
    assert df_mh.index.equals(want.index)
    np.testing.assert_array_equal(df_mh.statistic.values, want.statistic.values)
    np.testing.assert_allclose(df_mh.p_value.values, want.p_value.values, rtol=1e-12, atol=0)
    np.testing.assert_allclose(df_mh.fold_change.values, want.fold_change.values, rtol=1e-6)


def test_simulate_multihost_2d_local_mesh_matches_single_run():
    """Gene windows per host composed with cell-axis sharding inside each."""
    x, labels = _problem()
    adata = _adata(x, labels)
    kw = dict(is_log1p=False, group_keys="group", reference="p0", engine="hist")
    df_mh = simulate_multihost(
        adata, n_hosts=2, devices_per_host=4, devices=CPU8, local_mesh=(2, 2), **kw)
    pd.testing.assert_frame_equal(df_mh, _single(adata, **kw), check_exact=True)
    with pytest.raises(ValueError, match="only 4"):
        simulate_multihost(
            adata, n_hosts=2, devices_per_host=4, devices=CPU8, local_mesh=(4, 2), **kw)


def test_simulate_multihost_empty_trailing_window():
    """More hosts than 128-gene windows: trailing hosts contribute empty
    blocks and assembly still covers the axis."""
    x, labels = _problem(n_cells=800, n_genes=100)
    adata = _adata(x, labels)
    kw = dict(is_log1p=False, group_keys="group", reference="p0")
    df_mh = simulate_multihost(adata, n_hosts=4, devices_per_host=1, devices=CPU8, **kw)
    pd.testing.assert_frame_equal(df_mh, _single(adata, **kw), check_exact=True)


def test_simulate_multihost_backed_csc(tmp_path):
    """Out-of-core: each host streams only its window from the file."""
    x, labels = _problem(n_cells=600)
    path = tmp_path / "mh.h5ad"
    _adata(sparse.csc_matrix(x), labels).write_h5ad(path)
    backed = read_h5ad(path, backed="r")
    kw = dict(is_log1p=False, group_keys="group", reference="p0")
    df_mh = simulate_multihost(backed, n_hosts=2, devices_per_host=2, devices=CPU8, **kw)
    pd.testing.assert_frame_equal(df_mh, _single(backed, **kw), check_exact=True)


def test_simulate_multihost_rejects_oversubscription():
    x, labels = _problem(n_cells=100, n_genes=64)
    adata = _adata(x, labels)
    kw = dict(is_log1p=False, group_keys="group", reference="p0")
    with pytest.raises(ValueError, match="needs 10000 devices; only 8 exist"):
        simulate_multihost(adata, n_hosts=100, devices_per_host=100, devices=CPU8, **kw)
    # The default pool is the visible CUDA devices: none here.
    with pytest.raises(ValueError, match="only 0 exist"):
        simulate_multihost(adata, n_hosts=1, devices_per_host=1, **kw)


# -- the entry point -----------------------------------------------------------------------------


@pytest.mark.parametrize("local_mesh", [None, (2, 2)])
def test_multihost_entry_in_a_single_process(local_mesh):
    """asymptotic_wilcoxon_multihost == asymptotic_wilcoxon when the session
    is a single process; without a device and without CUDA it raises."""
    x, labels = _problem(n_cells=800, n_genes=64)
    adata = _adata(x, labels)
    kw = dict(is_log1p=False, group_keys="group", reference="p0")
    df_mh = illico_tpu_torch.asymptotic_wilcoxon_multihost(
        adata, device="cpu", local_mesh=local_mesh, **kw)
    pd.testing.assert_frame_equal(df_mh, _single(adata, **kw), check_exact=True)
    assert illico_tpu_torch.asymptotic_wilcoxon_multihost is asymptotic_wilcoxon_multihost
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asymptotic_wilcoxon_multihost(adata, **kw)


def test_initialize_distributed_without_a_cluster(monkeypatch):
    """No arguments and no launcher variables: a single-process no-op.  Any
    explicit argument signals a cluster, and half a configuration raises."""
    import torch.distributed as dist

    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() == (1, 0)
    assert initialize_distributed() == (1, 0)
    assert not dist.is_initialized()
    for kw in (dict(num_processes=2, process_id=0), dict(process_id=1),
               dict(coordinator_address="localhost:1"), dict(timeout=None)):
        with pytest.raises(ValueError, match="needs coordinator_address"):
            initialize_distributed(**kw)
    assert not dist.is_initialized()


# -- two real processes ----------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_two_processes(out_dir, device="cpu", timeout=240):
    """Start both ranks of this file's worker on localhost; returns their
    outputs.  Both are killed when the time limit expires."""
    address = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [os.path.join(str(out_dir), f"rank{r}.npz") for r in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), address, "2", str(r), outs[r], device],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-3000:] if r < len(logs) else ''}"
    return [np.load(o) for o in outs]


def test_two_gloo_processes_return_the_single_process_frame(tmp_path):
    """Two processes on localhost, each computing its gene window, joined by
    one gloo all-gather: identical frames, equal to the single-process one,
    and float64 blocks cross bit for bit (NaN, infinities and a subnormal
    included)."""
    rank0, rank1 = run_two_processes(tmp_path)
    x, labels = _problem(n_genes=300)
    adata = _adata(x, labels)
    for tag, reference in (("ovo", "p0"), ("ovr", None)):
        want = _single(adata, is_log1p=False, group_keys="group", reference=reference)
        np.testing.assert_array_equal(rank0[tag], rank1[tag])
        np.testing.assert_array_equal(rank0[tag], want.values)
    want = np.concatenate([_special_block(0, width=128), _special_block(1, width=100)], axis=1)
    for got in (rank0["gathered"], rank1["gathered"]):
        assert got.dtype == np.float64
        assert got.tobytes() == want.tobytes()
