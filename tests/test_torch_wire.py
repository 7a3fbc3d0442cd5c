"""The port's packed result wire against the JAX package's, on the CPU.

The same statistics go through ``illico_tpu.ops.hist_engine``'s pack (XLA
on the CPU, x64 on) and through ``illico_tpu_torch.ops.wire``'s: the spec
tuples are equal, the buffers are byte-identical for every tier, either
package's unpack reads either buffer, and the three engines' packed
contracts produce the reference's bytes for the same tile.  Stated
exceptions, compared after decode: the nnz-split slope ``tie_base_col`` when
its fitting sums pass 2**53 (order of summation decides the last bit), and fc
sums of log1p data at rtol 1e-6 (``expm1`` differs by ULPs between the two
libraries).
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

from illico_tpu.ops import csort_engine as jcs  # noqa: E402
from illico_tpu.ops import hist_engine as jhe  # noqa: E402
from illico_tpu.ops import rank_engine as jre  # noqa: E402
from illico_tpu.utils.groups import encode_and_count_groups as j_encode  # noqa: E402
from illico_tpu_torch.ops import csort_engine as tcs  # noqa: E402
from illico_tpu_torch.ops import hist_engine as the  # noqa: E402
from illico_tpu_torch.ops import rank_engine as tre  # noqa: E402
from illico_tpu_torch.ops import wire  # noqa: E402
from illico_tpu_torch.utils.groups import encode_and_count_groups as t_encode  # noqa: E402

CPU = torch.device("cpu")


# -- layouts ------------------------------------------------------------------
def _k562_labels():
    """Group labels of the K562-essential population of
    tests/ops/test_wire_contract.py (seeded, no matrix)."""
    rng = np.random.RandomState(0)
    n_cells, n_groups = 300_000, 2_000
    labels = rng.randint(1, n_groups, n_cells)
    labels[rng.rand(n_cells) < 0.1] = 0
    return np.array([f"pert_{g}" if g else "non-targeting" for g in labels])


@pytest.fixture(scope="module")
def k562():
    labels = _k562_labels()
    _, jinfo = j_encode(labels, ref_group="non-targeting")
    _, tinfo = t_encode(labels, "non-targeting")
    return (
        jre.build_padded_layout(jinfo.perm, jinfo.indptr),
        tre.build_padded_layout(tinfo.perm, tinfo.indptr),
        jinfo,
    )


def _layouts_from_sizes(sizes, ref):
    labels = np.repeat(np.arange(len(sizes)), sizes)
    _, jinfo = j_encode(labels, ref)
    _, tinfo = t_encode(labels, ref)
    return (
        jre.build_padded_layout(jinfo.perm, jinfo.indptr),
        tre.build_padded_layout(tinfo.perm, tinfo.indptr),
        jinfo,
    )


@pytest.mark.parametrize("ref", ["ovo", "ovr"])
@pytest.mark.parametrize("kw", [{}, {"wire": False}, {"fc_u8_hint": True}],
                         ids=["wire", "mesh", "fc_u8"])
def test_statics_and_narrow_map_equal_reference_k562(k562, ref, kw):
    jlayout, tlayout, info = k562
    ref_code = info.ref_code if ref == "ovo" else -1
    want = jhe.hist_contract_statics(jlayout, ref_code, 128, **kw)
    got = the.hist_contract_statics(tlayout, ref_code, 128, **kw)
    assert got == want
    assert the._narrow_map(got) == jhe._narrow_map(want)
    assert the.hist_stat_bounds(tlayout, ref_code, 128) == jhe.hist_stat_bounds(
        jlayout, ref_code, 128
    )
    if not kw:
        # The snapshots of tests/ops/test_wire_contract.py.
        if ref == "ovo":
            assert (got["u2_dtype"], got["tie_dtype"], got["fc_dtype"]) == (
                "uint24", "u40", "uint16")
            assert got["nnz_split"] is True and got["fc_split_code"] == info.ref_code
        else:
            assert (got["u2_dtype"], got["fc_dtype"]) == ("int32", "uint16")
            assert got["u2_split_code"] == int(np.argmax(info.counts))
    if kw == {"wire": False}:
        assert got["u2_split_code"] == -1 and got["fc_split_code"] == -1
    # The port's own switch: False only ever turns the nnz-split wire off.
    off = the.hist_contract_statics(tlayout, ref_code, 128, nnz_split_hint=False, **kw)
    assert off == {**got, "nnz_split": False, "fc_u8": False}


@pytest.mark.parametrize("ref_code", [0, -1])
def test_statics_equal_reference_tall_f96(ref_code):
    indptr = np.array([0, 2_500_000, 5_000_000], dtype=np.int64)
    perm = np.arange(5_000_000, dtype=np.int32)
    jlayout = jre.build_padded_layout(perm, indptr)
    tlayout = tre.build_padded_layout(perm, indptr)
    for kw in ({}, {"wire": False}):
        want = jhe.hist_contract_statics(jlayout, ref_code, 128, **kw)
        got = the.hist_contract_statics(tlayout, ref_code, 128, **kw)
        assert got == want
        assert the._narrow_map(got) == jhe._narrow_map(want)
    assert the.hist_contract_statics(tlayout, ref_code, 128)["tiecol_dtype"] == "f96"


def test_statics_equal_reference_ksplit_engagement():
    """The cases of tests/ops/test_ksplit_wire.py::test_ksplit_engagement_conditions."""
    rng = np.random.RandomState(3)
    big = np.concatenate([np.zeros(8000, int), np.full(300, 1), 2 + np.arange(10).repeat(40)])
    rng.shuffle(big)
    small = np.concatenate([np.zeros(8000, int), 1 + np.arange(30).repeat(45)])
    for labels, engaged in ((small, True), (big, False)):
        names = np.array([f"g{v:03d}" for v in labels])
        _, jinfo = j_encode(names, "g000")
        _, tinfo = t_encode(names, "g000")
        jl = jre.build_padded_layout(jinfo.perm, jinfo.indptr)
        tl = tre.build_padded_layout(tinfo.perm, tinfo.indptr)
        for ref_code, kw in ((jinfo.ref_code, {}), (-1, {}), (jinfo.ref_code, {"wire": False})):
            want = jhe.hist_contract_statics(jl, ref_code, 128, **kw)
            assert the.hist_contract_statics(tl, ref_code, 128, **kw) == want
        assert the.hist_contract_statics(tl, tinfo.ref_code, 128)["nnz_split"] is engaged


@pytest.mark.parametrize("ref_code", [0, 2, -1])
@pytest.mark.parametrize("counts", [
    [2000, 1900, 2100, 2000, 2000], [60000, 130, 150, 90], [2_500_000, 2_500_000, 7],
    [3, 4, 5],
])
def test_csort_narrow_statics_equal_reference(counts, ref_code):
    counts = np.asarray(counts)
    want = jcs.csort_narrow_statics(counts, ref_code)
    assert tcs.csort_narrow_statics(counts, ref_code) == want
    g = counts.size
    for t_cols in (1, 2, 3, 4, 15, 16, 128):
        assert tcs._narrow_for(t_cols, g, want, ref_code) == jcs._narrow_for(
            t_cols, g, want, ref_code, True
        )
        jspec = jhe.build_pack_spec(
            jcs.rank_output_abstract(t_cols, g, ref_code, True, want),
            jcs._narrow_for(t_cols, g, want, ref_code, True),
        )
        tspec = the.build_pack_spec(
            tcs.rank_output_abstract(t_cols, g, ref_code, want),
            tcs._narrow_for(t_cols, g, want, ref_code),
        )
        assert tspec == jspec


def test_spec_size_collision_guard():
    a = wire.build_pack_spec({"U2": wire.Abstract((4, 16), np.dtype(np.int32))})
    b = wire.build_pack_spec({"U2": wire.Abstract((4, 32), np.dtype(np.int32))})
    cache = {16: a}
    wire.assert_spec_size_unique(cache, 32, b)
    cache[32] = b
    wire.assert_spec_size_unique(cache, 16, a)  # same key again: fine
    collide = wire.build_pack_spec({"R2": wire.Abstract((8, 8), np.dtype(np.int32))})
    with pytest.raises(AssertionError, match="size collision"):
        wire.assert_spec_size_unique(cache, 8, collide)
    find_spec, match = wire.spec_lookup(cache)
    assert find_spec(wire.spec_total_bytes(b))["U2"][0] == (4, 32)
    assert find_spec(7) is None
    with pytest.raises(ValueError, match="No pack spec"):
        match(np.zeros(7, np.uint8))


def test_pack_count_alignment_guard():
    with pytest.raises(ValueError, match="divisible by 4"):
        wire.build_pack_spec({"tie_seg": torch.zeros((3, 1), dtype=torch.float64)}, {"tie_seg": 5})
    with pytest.raises(ValueError, match="divisible by 2"):
        wire.build_pack_spec({"U2": torch.zeros((3, 1), dtype=torch.uint32)}, {"U2": 3})
    with pytest.raises(ValueError, match="unsupported"):
        wire.build_pack_spec({"U2": torch.zeros((4, 1), dtype=torch.int32)}, {"U2": 3})


# -- pack_device_outputs: byte identity, every tier ------------------------------
def _to_torch(a: np.ndarray):
    """Tensor of a numpy array, the unsigned 16/32-bit dtypes included."""
    return torch.from_numpy(np.ascontiguousarray(a))


def _pack_both(arrays: dict, narrow):
    with jax.enable_x64(True):
        jbuf, jspec = jhe.pack_device_outputs({k: jnp.asarray(v) for k, v in arrays.items()}, narrow)
        jbuf = np.asarray(jbuf)
    tbuf, tspec = wire.pack_device_outputs({k: _to_torch(v) for k, v in arrays.items()}, narrow)
    return jbuf, jspec, tbuf.numpy(), tspec


def _fuzz_dict(rng, g, t):
    def draw(bound, shape):
        u = rng.randint(0, 4, size=shape)
        lo = np.choose(u, [0, 1, 2**32 - 2, 2**32 - 1])
        hi = rng.randint(0, max(1, int(bound // 2**32) + 1), size=shape)
        v = np.minimum(hi.astype(np.float64) * 2.0**32 + lo, bound - 1)
        mix = rng.rand(*shape) < 0.5
        return np.where(mix, np.floor(rng.rand(*shape) * bound), v).astype(np.float64)

    out = {
        "a_f64": draw(2.0**52, (g, t)),
        "b_f48": draw(2.0**48, (g, t)),
        "c_u40": draw(2.0**40, (g, t)),
        "d_u24": rng.randint(0, 2**24, (g, t)).astype(np.uint32),
        "e_i32": rng.randint(0, 2**31 - 1, (g, t), np.int64).astype(np.int32),
        "f_u16": rng.randint(0, 2**16, (g, t)).astype(np.uint16),
        "g_f32": rng.rand(t).astype(np.float32),
        "h_bool": rng.rand(t) < 0.5,
        "i_f96": draw(2.0**70, (g, t)) * rng.choice([1.0, -1.0, 1 / 3], (g, t)),
        "j_u8": rng.randint(0, 256, (g, t)).astype(np.uint8),
        "k_u32": rng.randint(0, 2**32, (g, t), np.int64).astype(np.uint32),
    }
    narrow = {"b_f48": 6, "c_u40": 5, "d_u24": 3, "i_f96": 12}
    if (g * t) % 4:
        narrow.pop("c_u40")
        if (g * t) % 2:
            narrow.pop("b_f48")
            narrow.pop("d_u24")
    return out, narrow


@pytest.mark.parametrize("trial", range(8))
def test_pack_fuzz_all_tiers_byte_identical(trial):
    """The fuzz of tests/ops/test_hist_engine.py::test_pack_unpack_fuzz_all_tiers,
    with the f96, uint8 and plain uint32 tiers added, through both packs."""
    rng = np.random.RandomState(42 + trial)
    g, t = rng.choice([1, 2, 3, 5]), rng.choice([4, 8, 12, 7])
    arrays, narrow = _fuzz_dict(rng, int(g), int(t))
    jbuf, jspec, tbuf, tspec = _pack_both(arrays, narrow)
    assert tspec == jspec
    np.testing.assert_array_equal(tbuf, jbuf)
    # Either package's unpack reads the bytes alike, and returns the input.
    back_t = wire.unpack_host_buffer(tbuf, tspec)
    back_j = jhe.unpack_host_buffer(jbuf, jspec)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back_t[k], back_j[k], err_msg=k)
        np.testing.assert_array_equal(back_t[k], v, err_msg=k)
        assert back_t[k].dtype == v.dtype


SPECIAL = np.array([
    0.0, -0.0, 5e-324, 2.2250738585072014e-308, 1.0, -2.5, 1.0 / 3.0, 2.0**53,
    2.0**53 + 2.0, 2.0**63 - 1024.0, 2.0**63, 3.0 * 2.0**64, -(2.0**63) - 4096.0,
    np.nan, np.inf, -np.inf, 1e300, -1e-300, 123456789.123456789, 2.0**-20,
], np.float64)


@pytest.mark.parametrize("wb", [12, 8, 6, 5], ids=["f96", "hilo", "f48", "u40"])
def test_pack_special_values_byte_identical(wb):
    """Zero, -0.0, a subnormal, 2**53, 2**63 - 1024, values past 2**63, a
    non-integer negative, NaN and both infinities: the same bytes as the
    reference in the f96 tier (where they are all carried) and in the
    word-split tiers (where values outside the tier's range are garbage,
    but the same garbage)."""
    arrays = {"t": SPECIAL.copy()}
    narrow = {} if wb == 8 else {"t": wb}
    jbuf, jspec, tbuf, tspec = _pack_both(arrays, narrow)
    assert tspec == jspec
    np.testing.assert_array_equal(tbuf, jbuf)
    if wb == 12:
        got = wire.unpack_host_buffer(tbuf, tspec)["t"]
        want = SPECIAL.copy()
        want[np.isnan(want)] = 0.0  # a NaN mantissa is 0
        want[np.abs(want) < 2.2250738585072014e-308] = 0.0  # zeros and the flushed subnormal
        np.testing.assert_array_equal(got, want)
        assert not np.signbit(got[1])  # -0.0 travels as +0.0


def test_f96_roundtrip_bitfaithful():
    """The points of tests/ops/test_wire_contract.py::test_f96_triple_roundtrip_bitfaithful."""
    n4m = 4_194_304.0
    vals = np.array([
        0.0, 1.0, 2.0**63, 2.0**63 + 2048.0, 2.0**66, n4m**3 - n4m,
        float(np.float64(2**63 - 1)), 2.0**52 + 1.0, 2.0**53 - 1.0,
        1.0 / 3.0, 2.0**92, 2.0**-20, 123456789.123456789,
        np.pi * 2.0**40, np.log1p(7.0), 2.0**93 - 2.0**40,
    ], dtype=np.float64)
    arr = np.tile(vals, 4).reshape(4, -1)
    jbuf, jspec, tbuf, tspec = _pack_both({"t": arr}, {"t": 12})
    np.testing.assert_array_equal(tbuf, jbuf)
    np.testing.assert_array_equal(wire.unpack_host_buffer(tbuf, tspec)["t"], arr)
    np.testing.assert_array_equal(jhe.unpack_host_buffer(tbuf, jspec)["t"], arr)


# -- hist_contract(pack=True): byte identity on the same histogram ---------------
def _hist(x, tlayout, v_buckets=128):
    arrs = the.prepare_hist_inputs(tlayout, v_buckets, False, CPU)
    hist = the.hist_pass(torch.from_numpy(x), arrs["perm"], arrs["indptr"], arrs["order"],
                         arrs["table"], is_log1p=False)
    return hist, arrs["ppg"]


def _contract_both(hist, ppg, n_pad, statics, pack):
    kw = {k: v for k, v in statics.items() if k != "compute_fc"}
    got = the.hist_contract(hist, ppg, n_pad=n_pad, pack=pack, **kw)
    with jax.enable_x64(True):
        want = jhe.hist_contract(
            jnp.asarray(hist.numpy()), jnp.asarray(ppg.numpy()), n_pad=n_pad,
            is_log1p=False, pack=pack, **statics,
        )
    return got, want


def _decoded(buf, spec, counts, ref_code):
    out = wire.unpack_host_buffer(buf, spec)
    if "k" in out:
        out = wire.reconstruct_ksplit(out, counts, ref_code)
    return out


def _check_contract(x, tlayout, ref_code, statics, expect=None):
    """Packed bytes equal the reference's; the unpacked dicts agree in
    keys, dtypes and values; the spec table matches the real outputs; and
    the packed statistics decode to the float64 contract's, bit for bit."""
    hist, ppg = _hist(x, tlayout)
    n_pad = float(tlayout.n_pad)
    tbuf, jbuf = _contract_both(hist, ppg, n_pad, statics, True)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    tout, jout = _contract_both(hist, ppg, n_pad, statics, False)
    assert tout.keys() == jout.keys()
    for k, w in jout.items():
        g = tout[k].numpy()
        assert g.dtype == np.asarray(w).dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
    abstract = the.hist_contract_abstract(tlayout.n_groups, x.shape[1], statics)
    assert {k: (tuple(v.shape), wire._np_dtype(v.dtype)) for k, v in tout.items()} == {
        k: (v.shape, v.dtype) for k, v in abstract.items()
    }
    spec = the.build_pack_spec(abstract, the._narrow_map(statics))
    assert spec == jhe.build_pack_spec(jout, jhe._narrow_map(statics))
    # Decoded statistics against the plain float64 contract (tolerance 0).
    plain = the.hist_contract(hist, ppg, n_pad=n_pad, ref_code=ref_code)
    counts = the.real_rows_per_group(tlayout)
    dec = _decoded(tbuf.numpy(), spec, counts, ref_code)
    for key, split in (("fc_sums", "fc_split_code"), ("R2", "u2_split_code")):
        if statics.get(split, -1) >= 0 and key in dec:
            dec[key] = np.asarray(dec[key], np.float64)
            dec[key][statics[split]] = dec["fc_split_col" if key == "fc_sums" else "r2_split_col"]
    keep = ~dec["overflow_cols"]
    for k, w in plain.items():
        if k == "overflow_cols":
            continue
        np.testing.assert_array_equal(
            np.asarray(dec[k], np.float64)[..., keep], w.numpy()[..., keep], err_msg=k
        )
    if expect is not None:
        expect(wire.unpack_host_buffer(tbuf.numpy(), spec))
    return dec


def test_hist_contract_packed_ovo_standard_and_forced_f96():
    rng = np.random.RandomState(1)
    jlayout, tlayout, info = _layouts_from_sizes((400, 150, 30, 20), 0)
    x = rng.poisson(1.0, (600, 16)).astype(np.float32)
    statics = the.hist_contract_statics(tlayout, info.ref_code, 128)
    assert statics == jhe.hist_contract_statics(jlayout, info.ref_code, 128)
    assert not statics["nnz_split"]
    _check_contract(x, tlayout, info.ref_code, statics)
    forced = {**statics, "tie_dtype": "f96", "tiecol_dtype": "f96", "u2_dtype": "f48"}
    _check_contract(x, tlayout, info.ref_code, forced)


@pytest.mark.parametrize("sizes", [(400, 150, 30, 20), (600, 22, 18, 15), (40000, 120, 110)])
def test_hist_contract_packed_ovr_row_split(sizes):
    rng = np.random.RandomState(2)
    jlayout, tlayout, info = _layouts_from_sizes(sizes, None)
    x = rng.poisson(1.0, (sum(sizes), 8)).astype(np.float32)
    x[rng.randint(0, sum(sizes), 5), 3] = 500.0  # off the table: an overflow column
    statics = the.hist_contract_statics(tlayout, -1, 128)
    assert statics == jhe.hist_contract_statics(jlayout, -1, 128)
    if sizes[0] == 40000:
        assert statics["u2_split_code"] == 0 and statics["fc_split_code"] == 0
    dec = _check_contract(x, tlayout, -1, statics)
    assert dec["overflow_cols"].tolist() == [False] * 3 + [True] + [False] * 4


@pytest.mark.parametrize("fc_u8", [False, True])
@pytest.mark.parametrize("case", ["plain", "exceptions", "slots_overflow"])
def test_hist_contract_packed_nnz_split(case, fc_u8):
    seed = {"plain": 0, "exceptions": 7, "slots_overflow": 11}[case]
    x, info, _ = _ksplit_problem(seed=seed, density=0.12 if case == "plain" else 0.25)
    _, tinfo = t_encode(np.array([f"g{i:03d}" for i in info.encoded_groups]), "g000")
    tlayout = tre.build_padded_layout(tinfo.perm, tinfo.indptr)
    if case == "exceptions":
        x[np.flatnonzero(info.encoded_groups == 5), 3] = 2.0
        x[np.flatnonzero(info.encoded_groups == 9)[:44], 3] = 2.0
        x[np.flatnonzero(info.encoded_groups == 4)[:30], 9] = 30.0  # fc_res > 255
    if case == "slots_overflow":
        for g in range(1, 28):
            x[np.flatnonzero(info.encoded_groups == g), 5] = 2.0
    statics = the.hist_contract_statics(tlayout, tinfo.ref_code, 128, fc_u8_hint=fc_u8)
    assert statics["nnz_split"] is True and statics["fc_u8"] is fc_u8

    def expect(raw):
        used = (raw["exc_key"] != wire._EXC_KEY_SENTINEL).sum(axis=0)
        assert ("fc_res" in raw) is fc_u8 and ("fc_sums" in raw) is not fc_u8
        if case == "plain":
            assert not raw["overflow_cols"].any()
        if case == "exceptions":
            assert used[3] > 0 and not raw["overflow_cols"].any()
            if fc_u8:
                assert ((raw["exc_key"] >> wire._EXC_AID_SHIFT) == 2).any()
        if case == "slots_overflow":
            assert used[5] == wire.NNZ_SPLIT_SLOTS and raw["overflow_cols"][5]
            assert not raw["overflow_cols"][:5].any()

    _check_contract(x, tlayout, tinfo.ref_code, statics, expect)


def test_nnz_split_slope_past_2_53_decodes_equal():
    """With the slope's fitting sums past 2**53 the two packages may round
    ``tie_base_col`` apart by one; the decoded statistics are equal all the
    same, because the residual is exact against whichever slope was sent."""
    hist = torch.zeros((3, 4, 4), dtype=torch.float32)
    hist[0, 0] = 3_000_000.0  # reference: zeros only
    hist[1, 2] = torch.tensor([200.0, 250.0, 255.0, 7.0])
    hist[1, 3] = torch.tensor([55.0, 5.0, 0.0, 1.0])
    hist[2, 1] = torch.tensor([255.0, 3.0, 100.0, 90.0])
    hist[0, 2] = torch.tensor([2_000_000.0, 1_500_000.0, 900_000.0, 10.0])
    ppg = torch.zeros(3, dtype=torch.int32)
    counts = np.array([6_000_000.0, 300.0, 300.0])
    statics = dict(ref_code=0, compute_fc=True, u2_dtype="float64", fc_dtype="float64",
                   tie_dtype="f48", tiecol_dtype="f96", fc_split_code=-1,
                   u2_split_code=-1, nnz_split=True, fc_u8=False)
    tbuf, jbuf = _contract_both(hist, ppg, 0.0, statics, True)
    tout, jout = _contract_both(hist, ppg, 0.0, statics, False)
    spec = the.build_pack_spec(tout, the._narrow_map(statics))
    got = wire.reconstruct_ksplit(wire.unpack_host_buffer(tbuf.numpy(), spec), counts, 0)
    want = jhe.reconstruct_ksplit(
        jhe.unpack_host_buffer(np.asarray(jbuf), jhe.build_pack_spec(jout, jhe._narrow_map(statics))),
        counts, 0,
    )
    for k in ("U2", "tie_seg", "fc_sums", "tie_ref_col"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("mode", ["ovo", "ovr"])
def test_hist_tile_fn_packed_width_and_unpack(mode):
    """The tile function packs at the tile's width rounded up to 4 columns,
    for any group count, and its unpack gives the unpacked contract."""
    rng = np.random.RandomState(5)
    sizes = (700, 23, 19, 15, 11)
    _, tlayout, info = _layouts_from_sizes(sizes, 0 if mode == "ovo" else None)
    x = rng.poisson(1.0, (sum(sizes), 15)).astype(np.float32)
    assert the.packed_width(15) == 16 and the.packed_width(16) == 16
    fn = the.make_hist_tile_fn(tlayout, ref_code=info.ref_code, is_log1p=False, device=CPU)
    marks = []
    buf = fn(torch.from_numpy(x), marks.append).numpy()
    assert marks == ["kernel", "contract"]
    assert list(fn._spec_cache) == [16]  # keyed by the packed width
    assert buf.size == wire.spec_total_bytes(fn._spec_cache[16])
    assert fn.find_spec(buf.size)["overflow_cols"][0] == (16,)
    got = fn.unpack(buf)
    plain = the.make_hist_tile_fn(
        tlayout, ref_code=info.ref_code, is_log1p=False, device=CPU, pack=False
    )(torch.from_numpy(x))
    st = fn._statics
    for key, split, col in (("fc_sums", "fc_split_code", "fc_split_col"),
                            ("R2", "u2_split_code", "r2_split_col")):
        if st[split] >= 0 and key in got:
            got[key] = np.asarray(got[key], np.float64)
            got[key][st[split]] = got[col]
    for k, w in plain.items():
        np.testing.assert_array_equal(
            np.asarray(got[k], np.float64)[..., :15], w.numpy().astype(np.float64), err_msg=k
        )
    assert not got["overflow_cols"][15:].any()


def _unpacked(fn, buf):
    """A hist tile function's unpacked dict with the split rows patched back
    into ``fc_sums`` and ``R2``, as float64."""
    got = {k: np.asarray(v) for k, v in fn.unpack(buf).items()}
    st = fn._statics
    for key, split, col in (("fc_sums", "fc_split_code", "fc_split_col"),
                            ("R2", "u2_split_code", "r2_split_col")):
        if st[split] >= 0 and key in got:
            got[key] = got[key].astype(np.float64)
            got[key][st[split]] = got[col]
    return got


@pytest.mark.parametrize("widths", [(2048, 2046), (1024, 1022)], ids=["2048_2046", "1024_1022"])
@pytest.mark.parametrize("mode", ["ovo", "ovr", "nnz_split"])
def test_hist_tiles_whose_widths_pack_equal_unpack_to_their_own_dicts(widths, mode):
    """A full tile and a short last one whose widths round up to the same
    packed width share one spec (the cache is keyed by the packed width),
    pack to the same byte count, and each unpacks to its own statistics,
    with zero pad columns."""
    rng = np.random.RandomState(9)
    sizes = {"ovo": (300, 40, 30, 20), "ovr": (300, 40, 30, 20),
             "nnz_split": (4000, 60, 50, 40)}[mode]
    _, tlayout, info = _layouts_from_sizes(sizes, None if mode == "ovr" else 0)
    x = rng.poisson(0.5, (sum(sizes), widths[0])).astype(np.float32)
    kw = dict(ref_code=info.ref_code, is_log1p=False, device=CPU)
    fn = the.make_hist_tile_fn(tlayout, **kw)
    plain_fn = the.make_hist_tile_fn(tlayout, pack=False, **kw)
    assert fn._statics["nnz_split"] is (mode == "nnz_split")
    tiles = {w: torch.from_numpy(np.ascontiguousarray(x[:, :w])) for w in widths}
    bufs = {w: fn(tiles[w]).numpy() for w in widths}
    assert list(fn._spec_cache) == [the.packed_width(widths[1])] == [widths[0]]
    assert bufs[widths[0]].size == bufs[widths[1]].size
    for w in widths:
        got = _unpacked(fn, bufs[w])
        assert not got["overflow_cols"].any()
        for k, want in plain_fn(tiles[w]).items():
            g = np.asarray(got[k], np.float64)[..., :w]
            np.testing.assert_array_equal(g, want.numpy().astype(np.float64), err_msg=k)
        # On the wire the pad columns are zero.
        for k, v in wire.unpack_host_buffer(bufs[w], fn._spec_cache[widths[0]]).items():
            assert v.shape[-1] == widths[0] and not v[..., w:].any(), k


# -- packed rank and csort wires ---------------------------------------------------
def _rank_problem(seed, is_log1p):
    rng = np.random.RandomState(seed)
    labels = np.concatenate([np.zeros(900, int), 1 + np.arange(6).repeat(50)])
    rng.shuffle(labels)
    x = rng.poisson(2.0, (labels.size, 16)).astype(np.float32)
    x[rng.rand(*x.shape) < 0.6] = 0
    if is_log1p:
        x = np.log1p(x).astype(np.float32)
    return x, np.array([f"g{v}" for v in labels])


def _assert_rank_buffers(tbuf, jbuf, spec, is_log1p):
    if not is_log1p:
        np.testing.assert_array_equal(tbuf, jbuf)
        return
    got, want = wire.unpack_host_buffer(tbuf, spec), wire.unpack_host_buffer(jbuf, spec)
    for k in want:
        if k == "fc_sums":  # expm1 differs by ULPs between torch and XLA
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("is_log1p", [False, True], ids=["raw", "log1p"])
@pytest.mark.parametrize("ref", ["g0", None], ids=["ovo", "ovr"])
def test_packed_rank_wire_matches_reference(ref, is_log1p):
    x, labels = _rank_problem(3, is_log1p)
    _, jinfo = j_encode(labels, ref)
    _, tinfo = t_encode(labels, ref)
    jfn = jre.make_tile_fn(jre.build_padded_layout(jinfo.perm, jinfo.indptr),
                           ref_code=jinfo.ref_code, is_log1p=is_log1p, pack=True)
    tfn = tre.make_tile_fn(tre.build_padded_layout(tinfo.perm, tinfo.indptr),
                           ref_code=tinfo.ref_code, is_log1p=is_log1p, device=CPU, pack=True)
    jbuf = np.asarray(jfn(jnp.asarray(x)))
    tbuf = tfn(torch.from_numpy(x)).numpy()
    assert tfn._spec_cache[16] == jfn._spec_cache[16]
    assert tfn.find_spec(tbuf.size).keys() == jfn.find_spec(jbuf.size).keys()
    _assert_rank_buffers(tbuf, jbuf, tfn._spec_cache[16], is_log1p)
    assert not tfn.unpack(tbuf)["overflow_cols"].any()


@pytest.mark.parametrize("is_log1p", [False, True], ids=["raw", "log1p"])
@pytest.mark.parametrize("ref", ["g0", None], ids=["ovo", "ovr"])
def test_packed_csort_wire_matches_reference(ref, is_log1p):
    x, labels = _rank_problem(4, is_log1p)
    x = (x / np.float32(3.7)).astype(np.float32) if not is_log1p else x
    _, jinfo = j_encode(labels, ref)
    _, tinfo = t_encode(labels, ref)
    r, c = np.nonzero(x)
    tiles = [
        mod.compact_from_entries(x[r, c], r, c, 16, info.encoded_groups, info.n_groups,
                                 need_grp=ref is not None)
        for mod, info in ((jcs, jinfo), (tcs, tinfo))
    ]
    jfn = jcs.make_csort_tile_fn(jinfo, ref_code=jinfo.ref_code, is_log1p=is_log1p)
    tfn = tcs.make_csort_tile_fn(tinfo, ref_code=tinfo.ref_code, is_log1p=is_log1p, device=CPU)
    jbuf = np.asarray(jfn(tiles[0]))
    tbuf = tfn(tiles[1]).numpy()
    assert tfn._spec_cache[16] == jfn._spec_cache[16]
    direct = tcs.csort_stats_tile(
        torch.from_numpy(tiles[1].vals),
        None if tiles[1].grp is None else torch.from_numpy(tiles[1].grp.astype(np.int32)),
        torch.from_numpy(tiles[1].indptr), torch.from_numpy(tinfo.counts),
        ref_code=tinfo.ref_code, is_log1p=is_log1p, n_total=tinfo.n_cells, pack=True,
        **tcs.csort_narrow_statics(tinfo.counts, tinfo.ref_code),
    )
    np.testing.assert_array_equal(direct.numpy(), tbuf)
    if not is_log1p:
        # Non-integer float32 sums: equal after decode (the float64
        # accumulation order differs), every other statistic byte for byte.
        got = wire.unpack_host_buffer(tbuf, tfn._spec_cache[16])
        want = wire.unpack_host_buffer(jbuf, tfn._spec_cache[16])
        for k in want:
            if k == "fc_sums":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    else:
        _assert_rank_buffers(tbuf, jbuf, tfn._spec_cache[16], True)
    want_keys = {k: (s[0], s[1]) for k, s in jfn.find_spec(jbuf.size).items()}
    assert {k: (s[0], s[1]) for k, s in tfn.find_spec(tbuf.size).items()} == want_keys


def test_modules_reexport_the_wire():
    """The reference keeps the wire in ops/hist_engine.py; the port's
    hist_engine re-exports every name of it."""
    for name in ("_WIRE_RANK", "_WIRE_COUNT_ALIGN", "_narrow_bytes", "_wire_bytes",
                 "_F96_EXP_BIAS", "build_pack_spec", "spec_total_bytes",
                 "assert_spec_size_unique", "unpack_host_buffer", "reconstruct_ksplit",
                 "_pick_exact_dtype", "_pick_split_dtype", "_DTYPE_WIRE_BYTES",
                 "NNZ_SPLIT_SLOTS", "_TIE_RES_BIAS", "_EXC_KEY_SENTINEL", "_EXC_AID_SHIFT",
                 "_narrow_map", "hist_stat_bounds", "hist_contract_statics",
                 "pack_device_outputs", "_split_hi_lo_words", "_split_mantexp_words"):
        assert hasattr(the, name), name
        if hasattr(jhe, name) and not callable(getattr(jhe, name)):
            assert getattr(the, name) == getattr(jhe, name), name
    for bound in (0.0, 2.0**16 - 1, 2.0**16, 2.0**24, 2.0**31, 2.0**40, 2.0**48, 2.0**63, 1e30):
        assert the._pick_exact_dtype(bound) == jhe._pick_exact_dtype(bound)
        assert the._pick_split_dtype(bound) == jhe._pick_split_dtype(bound)
