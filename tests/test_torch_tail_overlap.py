"""``tail_overlap.py``: the named host spans and the trace's reading, on the CPU.

The spans wrap the package's functions from outside and are taken away after
the block; a profiled CPU call carries one "contract" span (the fused pass,
``hist_engine.hist_pass_contract``) and one "tail" span per tile.  The
reading of a crafted trace (two tiles, their launches,
kernels and tails, then the fallback) gives each tile's contraction end on
the card, each tail's start and the card's busy time under it, the first
tail's lead over the last contraction and the launch statistics.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import tail_overlap  # noqa: E402

from illico_tpu_torch import asymptotic_wilcoxon_arrays, native  # noqa: E402
from illico_tpu_torch.models.wilcoxon import WilcoxonRunner  # noqa: E402
from illico_tpu_torch.ops import hist_engine  # noqa: E402


def _wrapped_functions():
    return (hist_engine.hist_pass_contract, hist_engine.hist_contract,
            native.consume_tile_native, WilcoxonRunner._recompute_with_sort_engine)


def test_named_spans_mark_each_tile_and_are_taken_away(tmp_path):
    saved = _wrapped_functions()
    rng = np.random.default_rng(0)
    X = rng.poisson(1.0, (3000, 300)).astype(np.float32)
    labels = np.array([f"g{i}" for i in rng.integers(0, 5, 3000)])
    with tail_overlap.named_spans():
        df = asymptotic_wilcoxon_arrays(X, labels, reference="g0", device="cpu",
                                        progress=False, batch_size=128,
                                        profile_dir=str(tmp_path))
    assert _wrapped_functions() == saved
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    n_tiles = df.attrs["consume_path"]["native"]
    assert n_tiles == 3
    assert names.count("contract") == n_tiles and names.count("tail") == n_tiles
    with pytest.raises(RuntimeError, match="no device activity"):
        tail_overlap.overlap_from_trace(tmp_path / "trace.json")


def _span(name, ts, dur, cat="user_annotation", **args):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X", "args": args}


def test_overlap_from_a_crafted_trace(tmp_path):
    events = [
        # the warm-up's contraction, before the loop
        _span("contract", 0.0, 10.0),
        _span("cudaLaunchKernel", 1.0, 2.0, cat="cuda_runtime", correlation=1),
        _span("k", 3.0, 5.0, cat="kernel", correlation=1),
        # tile 0: two launches, one of them held 1,500 us by a full queue
        _span("contract", 100.0, 2000.0),
        _span("cudaLaunchKernel", 110.0, 5.0, cat="cuda_runtime", correlation=2),
        _span("cudaLaunchKernel", 200.0, 1500.0, cat="cuda_runtime", correlation=3),
        _span("k", 120.0, 400.0, cat="kernel", correlation=2),
        _span("k", 520.0, 1480.0, cat="kernel", correlation=3),  # ends at 2,000
        # tile 1
        _span("contract", 2200.0, 100.0),
        _span("cudaLaunchKernel", 2210.0, 5.0, cat="cuda_runtime", correlation=4),
        _span("k", 2210.0, 1790.0, cat="kernel", correlation=4),  # ends at 4,000
        _span("d2h", 4000.0, 100.0, cat="gpu_memcpy", correlation=5),
        # the tails: tile 0's while the card runs tile 1, tile 1's after it
        _span("tail", 2500.0, 1000.0),
        _span("tail", 4200.0, 1000.0),
        # the fallback's contraction-free sort chunks
        _span("fallback", 5300.0, 500.0),
        _span("contract", 5400.0, 10.0),  # not a loop tile: after the fallback began
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = tail_overlap.overlap_from_trace(path)
    t0 = got["tiles"]
    assert len(t0) == 2
    assert t0[0]["contract_launches"] == 2
    assert t0[0]["contract_launch_host_s"] == pytest.approx(1505e-6)
    assert t0[0]["contract_device_end_s"] == pytest.approx(2000e-6)
    assert t0[1]["contract_device_end_s"] == pytest.approx(4000e-6)
    assert t0[0]["tail_start_s"] == pytest.approx(2500e-6)
    assert t0[0]["tail_device_busy_s"] == pytest.approx(1000e-6)
    assert t0[1]["tail_device_busy_s"] == pytest.approx(0.0)
    assert got["first_tail_lead_s"] == pytest.approx(1500e-6)
    assert got["tail_host_s"] == pytest.approx(2000e-6)
    assert got["tail_device_busy_share"] == pytest.approx(0.5)
    assert got["launch"] == pytest.approx({"n": 4, "host_s": 1512e-6, "max_ms": 1.5,
                                           "n_over_1ms": 1, "host_s_over_1ms": 1500e-6})
    # device spans 3-8, 120-2000, 2210-4000, 4000-4100
    assert got["device_busy_s"] == pytest.approx((5 + 1880 + 1790 + 100) * 1e-6)
    assert got["trace_s"] == pytest.approx(5800e-6)


def test_frame_digest_tells_frames_apart():
    rng = np.random.default_rng(1)
    X = rng.poisson(1.0, (400, 20)).astype(np.float32)
    labels = np.array([f"g{i}" for i in rng.integers(0, 4, 400)])
    df = asymptotic_wilcoxon_arrays(X, labels, reference="g0", device="cpu", progress=False)
    assert tail_overlap.frame_digest(df) == tail_overlap.frame_digest(df.copy())
    flipped = df.copy()
    flipped.iloc[3, 0] = np.nextafter(flipped.iloc[3, 0], np.inf)  # one bit of one p-value
    assert tail_overlap.frame_digest(flipped) != tail_overlap.frame_digest(df)
    renamed = df.rename(index={"g1": "g9"}, level=0)
    assert tail_overlap.frame_digest(renamed) != tail_overlap.frame_digest(df)

