"""The packed result wire: one ``uint8`` buffer per tile.

Port of the wire of ``illico_tpu.ops.hist_engine`` (its layout rules, the
device-side pack and the host-side unpack).  The statistics of a tile leave
the device as ONE buffer: every array is narrowed to the fewest bytes its
static bound allows and laid out at fixed offsets (:func:`build_pack_spec`),
so a tile costs one device-to-host copy and the native consumer
(:mod:`illico_tpu_torch.native`) reads the statistics in place.  The spec
tuples carry numpy dtypes and the packed bytes equal the reference
package's, tier for tier, so either package's consumer reads either
package's buffer.

The pack (:func:`pack_device_outputs`) is plain tensor code that runs on the
tensors' device; the unpack (:func:`unpack_host_buffer`) is numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "Abstract",
    "NNZ_SPLIT_SLOTS",
    "assert_spec_size_unique",
    "build_pack_spec",
    "pack_device_outputs",
    "reconstruct_ksplit",
    "spec_lookup",
    "spec_total_bytes",
    "unpack_host_buffer",
]

# Wire-order rank by bytes per element: every block starts aligned to its
# word size.  The 12-byte mantissa/exponent triple first (three 4-byte
# blocks); 8- and 4-byte encodings next; the 6-byte split next (uint32 block +
# uint16 block; an even element count keeps 4-byte alignment behind it); the
# 5-byte split (uint32 + uint8; element counts divisible by 4); the 3-byte
# split (uint16 + uint8; even counts); 2-byte and single-byte entries last.
_WIRE_RANK = {12: -1, 8: 0, 4: 1, 6: 2, 5: 3, 3: 4, 2: 5, 1: 6}

# Element-count divisibility that keeps every later block aligned.
_WIRE_COUNT_ALIGN = {6: 2, 5: 4, 3: 2}

_F96_EXP_BIAS = 2048  # frexp exponents span [-1074, 1024]; the bias keeps them unsigned
# Exponent words of the values frexp does not describe, as the reference's
# scaling ladder leaves them: zero takes every up-scaling step, an infinity
# every down-scaling step, a NaN none.
_F96_EXP_ZERO = _F96_EXP_BIAS - 1483
_F96_EXP_INF = 53 + 1536 + _F96_EXP_BIAS
_F96_EXP_NAN = 53 + _F96_EXP_BIAS
_F64_MIN_NORMAL = 2.2250738585072014e-308
_INT64_MAX = 2**63 - 1

_TORCH_TO_NP = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.int16: np.int16, torch.uint16: np.uint16, torch.int32: np.int32,
    torch.uint32: np.uint32, torch.int64: np.int64, torch.float16: np.float16,
    torch.float32: np.float32, torch.float64: np.float64,
}


def _np_dtype(dtype) -> np.dtype:
    """numpy dtype of a torch or numpy dtype (pack specs carry numpy's)."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(_TORCH_TO_NP[dtype])
    return np.dtype(dtype)


class Abstract(NamedTuple):
    """Shape and dtype of an array that is not computed: all that
    :func:`build_pack_spec` needs to lay a buffer out."""

    shape: tuple
    dtype: np.dtype


def _narrow_bytes(key, dtype: np.dtype, narrow) -> int | None:
    """Wire-byte override for ``key``, or None for the natural width.
    ``narrow`` maps keys to wire bytes; a plain set of keys takes each
    dtype's default narrow width (float64 -> 6, uint32 -> 3)."""
    if isinstance(narrow, (set, frozenset)):
        if key not in narrow:
            return None
        return 6 if dtype.itemsize == 8 else 3 if dtype == np.uint32 else None
    return narrow.get(key)


def _wire_bytes(key, dtype: np.dtype, narrow) -> int:
    if dtype == np.bool_:
        return 1
    wb = _narrow_bytes(key, dtype, narrow)
    if wb is not None:
        if dtype.itemsize == 8 and wb in (5, 6, 12):
            return wb
        if dtype == np.uint32 and wb == 3:
            return 3
        raise ValueError(
            f"narrow encoding {wb}B unsupported for dtype {dtype} (key {key!r})"
        )
    return dtype.itemsize


def _int32_bytes(words):
    """Little-endian bytes of the low 32 bits of int64 ``words``."""
    return words.to(torch.int32).contiguous().view(torch.uint8).reshape(-1)


def _int16_bytes(words):
    """Little-endian bytes of the low 16 bits of int64 ``words``."""
    return words.to(torch.int16).contiguous().view(torch.uint8).reshape(-1)


def _as_int64(v):
    """int64 values of an integer tensor; the unsigned 16- and 32-bit ones
    (which have few device ops) are read through their signed views."""
    if v.dtype == torch.uint32:
        return v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if v.dtype == torch.uint16:
        return v.view(torch.int16).to(torch.int64) & 0xFFFF
    return v.to(torch.int64)


def to_wire_dtype(x, name: str):
    """Cast exact, in-range integer float64 ``x`` to the device dtype named
    ``name``.  Unsigned 16/32-bit tensors are views of the wrapped signed
    cast, whose low bytes are the wanted word."""
    if name == "int32":
        return x.to(torch.int32)
    if name == "uint8":
        return x.to(torch.uint8)
    if name == "uint16":
        return x.to(torch.int32).to(torch.int16).view(torch.uint16)
    if name == "uint32":
        return x.to(torch.int64).to(torch.int32).view(torch.uint32)
    if name == "float64":
        return x
    raise ValueError(f"no device dtype {name!r}")


def _split_mantexp_words(v):
    """(lo, hi, exp) 32-bit words, as int64 tensors, carrying a float64 bit
    for bit at any magnitude and sign (the 12-byte "f96" tier).

    ``|v| = m * 2**e`` by ``frexp`` (m in [0.5, 1)); ``m * 2**53`` is an
    integer below 2**53.  The exponent word carries ``e + _F96_EXP_BIAS``
    with the sign (``v < 0``, so -0.0 travels as +0.0) in bit 31.  Decode:
    ``sign * (hi * 2**32 + lo) * 2**(exp - bias - 53)``.

    The words equal those of the reference's scaling ladder, its corner
    cases included: zero is ``(0, 0, bias - 1483)``; a subnormal is flushed
    to that zero; an infinity saturates the mantissa to the largest int64
    (and decodes as infinity); a NaN has mantissa 0 and decodes as 0.0.
    """
    av = v.abs()
    normal = torch.isfinite(av) & (av >= _F64_MIN_NORMAL)
    m, e = torch.frexp(torch.where(normal, av, 1.0))
    mi = torch.where(normal, m * 2.0**53, 0.0).to(torch.int64)
    is_inf = torch.isinf(av)
    mi = torch.where(is_inf, _INT64_MAX, mi)
    ew = torch.where(normal, e.to(torch.int64) + _F96_EXP_BIAS, _F96_EXP_ZERO)
    ew = torch.where(is_inf, _F96_EXP_INF, ew)
    ew = torch.where(torch.isnan(av), _F96_EXP_NAN, ew)
    ew = ew | torch.where(v < 0, 1 << 31, 0)
    return mi & 0xFFFFFFFF, mi >> 32, ew


def _split_hi_lo_words(v):
    """(hi, lo) 32-bit words, as int64 tensors, of an integer-valued float64
    (or of an integer tensor): the int64 cast, then shift and mask.

    Bit-faithful below 2**63; at or above it the cast saturates and the
    decoded value is wrong, so callers bound their statistics below 2**63 or
    ship them on the f96 tier.  The cast is pinned where C leaves it open,
    to what the reference's compiler does: NaN gives 0, values past either
    end saturate.
    """
    if not v.is_floating_point():
        u = _as_int64(v)
    else:
        u = torch.nan_to_num(v, nan=0.0).clamp(-(2.0**63), 2.0**63 - 1024.0)
        u = torch.where(v >= 2.0**63, _INT64_MAX, u.to(torch.int64))
    return u >> 32, u & 0xFFFFFFFF


def pack_device_outputs(out: dict, narrow=frozenset()):
    """Bit-pack a dict of tensors into one 1-D uint8 tensor on their device.

    Returns ``(buffer, spec)``; spec is ``[(key, shape, numpy dtype, offset,
    nbytes)]`` and :func:`unpack_host_buffer` inverts it.  Wider encodings
    come first so every offset stays aligned for host views.  The encoding of
    an entry follows from ``nbytes / size``: 12 = the (lo, hi, exp) words of
    :func:`_split_mantexp_words`; 8 = (hi, lo) uint32 word blocks; 6 =
    uint32 lo block + uint16 hi block (values < 2**48); 5 = uint32 lo block +
    uint8 hi block (< 2**40); 3 = uint16 lo block + uint8 hi block (uint32
    values < 2**24); natural width otherwise.  ``narrow`` maps keys to
    their wire bytes.  Words are little-endian, as on every host this runs
    on.
    """
    spec = build_pack_spec(out, narrow)
    parts = []
    for k, _shape, dtype, _off, _nbytes in spec:
        v = out[k]
        wb = _wire_bytes(k, dtype, narrow)
        if dtype == np.bool_:
            b = v.to(torch.uint8)
        elif dtype.itemsize == 8 and wb == 12:
            b = torch.cat([_int32_bytes(w) for w in _split_mantexp_words(v)])
        elif dtype.itemsize == 8 and wb in (5, 6):
            hi, lo = _split_hi_lo_words(v)
            hi_bytes = hi.to(torch.uint8).reshape(-1) if wb == 5 else _int16_bytes(hi)
            b = torch.cat([_int32_bytes(lo), hi_bytes])
        elif dtype == np.uint32 and wb == 3:
            u = _as_int64(v)
            b = torch.cat([_int16_bytes(u & 0xFFFF), (u >> 16).to(torch.uint8).reshape(-1)])
        elif dtype.itemsize == 8:
            hi, lo = _split_hi_lo_words(v)
            b = torch.cat([_int32_bytes(hi), _int32_bytes(lo)])
        elif dtype == np.uint8:
            b = v
        else:
            b = v.contiguous().view(torch.uint8)
        parts.append(b.reshape(-1))
    return torch.cat(parts), spec


def build_pack_spec(out: dict, narrow=frozenset()) -> list:
    """Offsets and encodings for :func:`pack_device_outputs`.

    ``out`` values only need ``.shape`` and ``.dtype`` (torch or numpy), so
    the spec is derived without running the computation.
    """
    items = sorted(
        out.items(),
        key=lambda kv: (_WIRE_RANK[_wire_bytes(kv[0], _np_dtype(kv[1].dtype), narrow)], kv[0]),
    )
    spec, off = [], 0
    for k, v in items:
        dtype = _np_dtype(v.dtype)
        wb = _wire_bytes(k, dtype, narrow)
        size = int(np.prod(v.shape))
        align = _WIRE_COUNT_ALIGN.get(wb, 1)
        if size % align:
            raise ValueError(
                f"{wb}-byte encoding of '{k}' needs an element count "
                f"divisible by {align} (got {size}) to keep later blocks "
                "aligned."
            )
        nbytes = size * wb
        spec.append((k, tuple(v.shape), dtype, off, nbytes))
        off += nbytes
    return spec


def spec_total_bytes(spec) -> int:
    """Total packed-buffer size of a pack spec."""
    _, _, _, off, nbytes = spec[-1]
    return off + nbytes


def assert_spec_size_unique(spec_cache: dict, key, spec) -> None:
    """Guard the size-keyed spec lookup before caching ``spec``.

    Packed buffers are identified by their total byte size alone; two cached
    specs sharing a size would silently mis-decode one of them.  Within one
    runner sizes are linear in the tile width, so collisions cannot happen;
    this makes a future wire change that breaks the invariant fail loudly.
    """
    total = spec_total_bytes(spec)
    for other_key, other in spec_cache.items():
        if other_key != key and spec_total_bytes(other) == total:
            raise AssertionError(
                f"pack-spec size collision: specs for tile widths "
                f"{other_key!r} and {key!r} both pack to {total} bytes; "
                "find_spec's size-keyed lookup would mis-decode one of "
                "them. Change the wire layout so sizes stay distinct."
            )


def spec_lookup(spec_cache: dict):
    """``(find_spec, match)`` over a tile-width -> spec cache.

    ``find_spec(n)`` gives ``key -> (shape, dtype, offset, nbytes)`` of the
    cached spec that packs to ``n`` bytes, or None; ``match(buf)`` gives the
    spec list for a host buffer, or raises."""

    def by_size(buf_size: int):
        for spec in spec_cache.values():
            if spec_total_bytes(spec) == buf_size:
                return spec
        return None

    def find_spec(buf_size: int) -> dict | None:
        spec = by_size(buf_size)
        return None if spec is None else {k: (s, d, o, n) for (k, s, d, o, n) in spec}

    def match(buf):
        spec = by_size(buf.size)
        if spec is None:
            raise ValueError(
                f"No pack spec matches buffer of {buf.size} bytes; "
                "call the tile function first."
            )
        return spec

    return find_spec, match


def unpack_host_buffer(buf, spec) -> dict:
    """Invert :func:`pack_device_outputs` on the host (numpy; views where
    possible)."""
    buf = np.asarray(buf)
    out = {}
    for k, shape, dtype, off, nbytes in spec:
        v = buf[off : off + nbytes]
        size = int(np.prod(shape)) if shape else 1
        if dtype == np.bool_:
            out[k] = (v != 0).reshape(shape)
        elif dtype.itemsize == 8 and nbytes == 12 * size:
            lo = v[: 4 * size].view(np.uint32).astype(np.int64)
            hi = v[4 * size : 8 * size].view(np.uint32).astype(np.int64)
            ew = v[8 * size :].view(np.uint32)
            m = ((hi << 32) | lo).astype(np.float64)
            e = (ew & np.uint32(0x7FFFFFFF)).astype(np.int64) - _F96_EXP_BIAS
            val = np.ldexp(m, e - 53)
            val[(ew >> 31) != 0] *= -1.0
            out[k] = val.astype(dtype).reshape(shape)
        elif dtype.itemsize == 8 and nbytes in (5 * size, 6 * size):
            lo = v[: 4 * size].view(np.uint32)
            hi = v[4 * size :] if nbytes == 5 * size else v[4 * size :].view(np.uint16)
            out[k] = (
                hi.astype(np.float64) * 2.0**32 + lo.astype(np.float64)
            ).astype(dtype).reshape(shape)
        elif dtype == np.uint32 and nbytes == 3 * size:
            lo = v[: 2 * size].view(np.uint16)
            hi = v[2 * size :]
            out[k] = (hi.astype(np.uint32) << 16 | lo.astype(np.uint32)).reshape(shape)
        elif dtype.itemsize == 8:
            words = v.view(np.uint32)
            n = nbytes // 8
            out[k] = (
                words[:n].astype(np.float64) * 2.0**32 + words[n:].astype(np.float64)
            ).astype(dtype).reshape(shape)
        else:
            out[k] = v.view(dtype).reshape(shape)
    return out


# --- nnz-split ("ksplit") OVO wire ----------------------------------------------
# The OVO tie term is the wire's widest tier (u40/f48) because the zero
# bucket couples every (group, column) statistic to the reference group's
# (large) zero count.  Shipping the per-(group, column) NONZERO count k
# instead lets the host rebuild the zero-bucket algebra in closed form, so
# only nonzero-bucket residuals cross the wire, in narrow tiers sized to their
# typical spread, with the rare violators carried exactly in a small
# per-column exception buffer:
#
#   k        (G, T) uint8   nonzeros per (group, column); k <= n_g < 256,
#                           statically proven at engagement
#   u2_res   (G, T) uint16  U2_nz = sum_{v>=1} h*(2*Anz_excl + a)
#   tie_res  (G, T) u24     tie_nz - D[j]*k + 2^23, where tie_nz is the
#                           nonzero-bucket tie term and D[j] a per-column
#                           integer slope fit on the device
#   exc_key / exc_val       (S, T) slots carrying (array, group) -> exact
#                           value for entries outside their narrow range;
#                           columns with > S violators fall back to the
#                           exact sort engine via overflow_cols
#
# Host reconstruction (exact-integer float64, in numpy and in C++):
#   a0 = R - ref_nnz[j]; h0 = n_g - k
#   U2      = a0*(n_g + k) + U2_nz
#   tie_seg = 3*a0*h0*(a0 + h0) + h0^3 - h0 + D[j]*k + resid
NNZ_SPLIT_SLOTS = 24
_TIE_RES_BIAS = float(2**23)
_EXC_KEY_SENTINEL = np.uint32(0xFFFFFFFF)
_EXC_AID_SHIFT = 24  # key = (array id << 24) | group


def reconstruct_ksplit(out: dict, counts: np.ndarray, ref_code: int) -> dict:
    """Standard contract dict (U2/tie_seg/...) from an nnz-split wire dict.

    Exact-integer float64 throughout: a0/h0 products are bounded by the
    engagement gate's tie bound < 2^48, D*k < 2^48 by the device clamp, and
    exception values arrive bit for bit on the f96 tier.  Reference
    self-rows come back zeroed (the consumer writes sentinels there).
    """
    k = out["k"].astype(np.float64)  # (G, T)
    u2_nz = out["u2_res"].astype(np.float64)
    resid = out["tie_res"].astype(np.float64) - _TIE_RES_BIAS
    fc_res = out["fc_res"].astype(np.float64) if "fc_res" in out else None
    keys = np.asarray(out["exc_key"])
    s_idx, col_idx = np.nonzero(keys != _EXC_KEY_SENTINEL)
    if s_idx.size:
        kv = keys[s_idx, col_idx]
        v = np.asarray(out["exc_val"], np.float64)[s_idx, col_idx]
        aid = kv >> _EXC_AID_SHIFT
        gid = (kv & np.uint32((1 << _EXC_AID_SHIFT) - 1)).astype(np.int64)
        m = aid == 0
        u2_nz[gid[m], col_idx[m]] = v[m]
        m = aid == 1
        resid[gid[m], col_idx[m]] = v[m]
        if fc_res is not None:
            m = aid == 2
            fc_res[gid[m], col_idx[m]] = v[m]
    cts = np.asarray(counts, np.float64)
    a0 = cts[ref_code] - out["ref_nnz_col"].astype(np.float64)  # (T,)
    d = np.asarray(out["tie_base_col"], np.float64)
    n_g = cts[:, None]
    h0 = n_g - k
    u2 = a0[None, :] * (n_g + k) + u2_nz
    tie_seg = (
        3.0 * a0[None, :] * h0 * (a0[None, :] + h0)
        + h0 * h0 * h0
        - h0
        + d[None, :] * k
        + resid
    )
    u2[ref_code] = 0.0
    tie_seg[ref_code] = 0.0
    res = {
        key: val
        for key, val in out.items()
        if key not in (
            "k", "u2_res", "tie_res", "fc_res", "ref_nnz_col",
            "tie_base_col", "exc_key", "exc_val",
        )
    }
    res["U2"] = u2
    res["tie_seg"] = tie_seg
    if fc_res is not None:
        # fc_sums = fc_res + k; the reference row rides fc_split_col (the
        # consumer patches it in), so its zero here is correct.
        res["fc_sums"] = fc_res + k
    return res


def _pick_exact_dtype(bound: float) -> str:
    """Narrowest dtype holding every integer in [0, bound] exactly.  The
    per-(group, column) statistics are exact integers with static bounds
    known from the group sizes, so they leave the device in 2-4 bytes
    instead of 8 whenever the bound allows."""
    if bound < 2.0**16:
        return "uint16"
    if bound < 2.0**24:
        return "uint24"  # uint32 on the device, 3 bytes on the wire
    if bound < 2.0**31:
        return "int32"
    return "float64"


_DTYPE_WIRE_BYTES = {
    "uint16": 2, "uint24": 3, "int32": 4, "u40": 5, "f48": 6, "float64": 8,
    "f96": 12,
}

# Device dtype of each wire tier: "uint24"/"u40"/"f48"/"f96" are encodings.
_DEV_DTYPE = {"uint24": "uint32", "u40": "float64", "f48": "float64", "f96": "float64"}


def _pick_split_dtype(bound: float) -> str:
    """Narrowest exact wire encoding, the split-float64 tiers included:
    "u40" (uint32 lo + uint8 hi, 5 bytes) and "f48" (uint32 lo + uint16 hi,
    6 bytes) for OVO tie increments and OVR rank sums that exceed int32 but
    sit far below 2**48.  Bounds at or past 2**63 (tie sums of datasets
    beyond 2**21 cells) take the 12-byte "f96" tier, which carries a float64
    bit for bit at any magnitude (the int64 word split cannot, see
    :func:`_split_hi_lo_words`)."""
    d = _pick_exact_dtype(bound)
    if d != "float64":
        return d
    if bound < 2.0**40:
        return "u40"
    if bound < 2.0**48:
        return "f48"
    if bound < 2.0**63:
        return "float64"
    return "f96"


def _narrow_map(statics: dict) -> dict:
    """Wire-narrowing map (key -> wire bytes) implied by contract statics."""
    narrow = {}
    if statics.get("nnz_split"):
        # The biased tie residual narrows (uint32 -> 3 bytes); exception
        # values ride the f96 triple (signed, any magnitude).
        narrow["tie_res"] = 3
        narrow["exc_val"] = 12
        if (
            not statics.get("fc_u8")
            and statics["fc_dtype"] == "uint24"
            and statics.get("compute_fc", True)
        ):
            narrow["fc_sums"] = 3
        return narrow
    tie_wb = _DTYPE_WIRE_BYTES[statics.get("tie_dtype", "float64")]
    if statics["ref_code"] != -1 and tie_wb in (3, 5, 6, 12):
        narrow["tie_seg"] = tie_wb
    # Per-column tie scalars (tie_col / tie_ref_col) exceed the int64 word
    # split past 2**63: ship the f96 triple there (negligible bytes, (T,)).
    if _DTYPE_WIRE_BYTES[statics.get("tiecol_dtype", "float64")] == 12:
        narrow["tie_col" if statics["ref_code"] == -1 else "tie_ref_col"] = 12
    u2_wb = _DTYPE_WIRE_BYTES[statics["u2_dtype"]]
    if u2_wb in (3, 5, 6, 12):
        narrow["R2" if statics["ref_code"] == -1 else "U2"] = u2_wb
    if statics["fc_dtype"] == "uint24" and statics.get("compute_fc", True):
        narrow["fc_sums"] = 3
    return narrow
