"""Native (C++) host kernels, loaded via ctypes: the statistical tail and
the in-RAM CSR's scans.

Port of ``illico_tpu.native``, plus the CSR scans.  ``csrc/tail.cpp`` and
``csrc/csr_scan.cpp`` are compiled at first use into one library with the
system C++ compiler (``CXX``, else ``g++`` or ``c++``; ``-O2``, no
fast-math; OpenMP first, a plain build second) in ``illico_tpu_torch/_build/``,
keyed by a hash of both sources (:func:`build_tag`) and moved into place
atomically, then loaded with ``ctypes``.  Compilation is best-effort for
callers: without a compiler they fall back to the numpy implementations in
:mod:`illico_tpu_torch.stats`, in the runner and in
``utils/registry.CSRDataHandler``; the runner reports which path each tile
took (``consume_path``) and :data:`csr_scan_calls` counts the CSR scans by
path.  ``ILLICO_TPU_NO_NATIVE=1`` disables the library.

The consume loop runs on :func:`tail_threads` OpenMP threads (bit-equal at
any count): by default the cores this process may use, less the threads
that run beside it; ``ILLICO_TPU_TAIL_THREADS`` sets the count.  A CSR scan
runs on :func:`scan_threads` threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from illico_tpu_torch.utils.log import logger

__all__ = [
    "BUILD_INFO",
    "CSR_GATHER_DTYPES",
    "build_tag",
    "consume_tile_native",
    "count_csr_scan",
    "csr_check_sorted_native",
    "csr_gather_window_native",
    "csr_index_dtypes_ok",
    "csr_scan_calls",
    "native_available",
    "openmp_enabled",
    "pvalue_tail_native",
    "scan_threads",
    "single_scan_thread",
    "tail_threads",
]

_PKG = Path(__file__).resolve().parents[1]
_SOURCES = (_PKG / "csrc" / "tail.cpp", _PKG / "csrc" / "csr_scan.cpp")
BUILD_DIR = _PKG / "_build"
_LIB = None
_TRIED = False
_LOCK = threading.Lock()
# The compiler command of the build this process made in BUILD_DIR (empty
# when the library was already built) and the loaded library's path.
BUILD_INFO: dict = {"command": "", "path": ""}

_ALTERNATIVES = {"two-sided": 0, "greater": 1, "less": 2}


def build_tag() -> str:
    """Hash of every source of the library: a change to either rebuilds it."""
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(hashlib.sha256(src.read_bytes()).digest())
    return h.hexdigest()[:16]


def _build(plain: bool = False, build_dir: Path | None = None) -> Path | None:
    """Path of the built library, compiling it if it is not there; None on
    any failure (unreadable source, read-only directory, no compiler), which
    leaves the caller on the numpy path."""
    tmp = None
    try:
        tag = build_tag()
        # Plain (no-OpenMP) rebuilds get a distinct name: at the canonical
        # path they would turn ILLICO_TPU_TAIL_THREADS into a no-op for
        # every later process that finds the file.
        suffix = "_plain" if plain else ""
        out_dir = BUILD_DIR if build_dir is None else Path(build_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        out = out_dir / f"illico_tail_{tag}{suffix}.so"
        if out.exists():
            return out
        # Compile to a process-private path and move it into place
        # atomically: concurrent compiles or a killed one must never
        # leave a truncated library at the final path.
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        # OpenMP first (the consume loop over groups parallelizes bit for
        # bit): with $CXX, then with the compilers on PATH, since a
        # toolchain named by CXX may lack its OpenMP runtime where the
        # system's has it.  A plain build last.
        compilers = list(dict.fromkeys(
            c for c in (os.environ.get("CXX"), "g++", "c++") if c
        ))
        attempts = [] if plain else [(c, ["-fopenmp"]) for c in compilers]
        attempts += [(c, []) for c in compilers]
        for i, (cxx, extra) in enumerate(attempts):
            cmd = [
                cxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                *map(str, _SOURCES), "-o", str(tmp), "-lm", *extra,
            ]
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
                break
            except Exception:  # noqa: BLE001
                if i == len(attempts) - 1:
                    raise
        os.replace(tmp, out)
        if build_dir is None:
            BUILD_INFO["command"] = " ".join(cmd)
        return out
    except Exception as e:  # noqa: BLE001 - best-effort by contract
        logger.debug("native tail build failed: %s", e)
        try:
            if tmp is not None and tmp.exists():
                tmp.unlink()
        except OSError:
            pass
        return None


def _load_from(build_dir: Path | None = None):
    """Build (if needed) and bind the library in ``build_dir``; a cached
    file that does not load (truncated, or linked against an OpenMP runtime
    this host lacks) is dropped and rebuilt, the second time without
    OpenMP."""
    path = _build(build_dir=build_dir)
    if path is None:
        return None
    try:
        lib = _bind(path)
    except OSError as e:
        logger.warning(
            "native tail load failed (%s); rebuilding it", e
        )
        lib = None
        for plain in (False, True):
            try:
                Path(path).unlink()
            except OSError:
                pass
            path = _build(plain=plain, build_dir=build_dir)
            if path is None:
                break
            try:
                lib = _bind(path)
                break
            except OSError as e2:
                logger.debug("native tail reload failed: %s", e2)
    if lib is not None and build_dir is None:
        BUILD_INFO["path"] = str(path)
    return lib


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("ILLICO_TPU_NO_NATIVE"):  # escape hatch / testing
            return None
        _LIB = _load_from()
        return _LIB


def _bind(path: Path):
    """dlopen + declare the ctypes signatures (raises OSError on failure)."""
    lib = ctypes.CDLL(str(path))
    lib.illico_openmp.restype = ctypes.c_int32
    lib.illico_openmp.argtypes = []
    fn = lib.illico_pvalue_tail
    fn.restype = None
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # U
        ctypes.POINTER(ctypes.c_double),  # tie
        ctypes.POINTER(ctypes.c_double),  # n_ref
        ctypes.POINTER(ctypes.c_double),  # n_tgt
        ctypes.c_int64,                   # n_groups
        ctypes.c_int64,                   # n_cols
        ctypes.c_int32,                   # alternative
        ctypes.c_int32,                   # use_continuity
        ctypes.c_int32,                   # tie_correct
        ctypes.POINTER(ctypes.c_double),  # p_out
        ctypes.c_int32,                   # n_threads
    ]
    ck = lib.illico_consume_tile_ksplit
    ck.restype = None
    ck.argtypes = [
        ctypes.c_void_p,                  # k (uint8)
        ctypes.c_void_p, ctypes.c_int32,  # u2_res
        ctypes.c_void_p, ctypes.c_int32,  # tie_res
        ctypes.c_void_p, ctypes.c_int32,  # fc_sums / fc_res
        ctypes.c_int32,                   # fc_is_res
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,  # fc_split_col
        ctypes.c_void_p, ctypes.c_int32,  # tie_ref_col
        ctypes.c_void_p, ctypes.c_int32,  # ref_nnz_col
        ctypes.c_void_p, ctypes.c_int32,  # tie_base_col
        ctypes.c_void_p,                  # exc_key (uint32)
        ctypes.c_void_p, ctypes.c_int32,  # exc_val
        ctypes.c_int64,                   # n_exc
        ctypes.POINTER(ctypes.c_double),  # counts
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # G, T, w
        ctypes.c_int64,                   # ref_code
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # alt/contin/tie
        ctypes.POINTER(ctypes.c_double),  # results
        ctypes.c_int64, ctypes.c_int64,   # col0, n_genes
        ctypes.POINTER(ctypes.c_double),  # col_scratch
        ctypes.c_int32,                   # n_threads
    ]
    ct = lib.illico_consume_tile
    ct.restype = None
    ct.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,  # u2, dtype
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,  # u2_split_col
        ctypes.c_void_p, ctypes.c_int32,  # fc_sums, dtype
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,  # fc_split_col
        ctypes.c_void_p, ctypes.c_int32,  # tie_seg, dtype
        ctypes.c_void_p, ctypes.c_int32,  # tie_col, dtype
        ctypes.POINTER(ctypes.c_double),  # counts
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # G, T, w
        ctypes.c_int64,                   # ref_code
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # alt/contin/tie
        ctypes.POINTER(ctypes.c_double),  # results
        ctypes.c_int64, ctypes.c_int64,   # col0, n_genes
        ctypes.POINTER(ctypes.c_double),  # col_scratch
        ctypes.c_int32,                   # n_threads
    ]
    cs = lib.illico_csr_check_sorted
    cs.restype = ctypes.c_int64
    cs.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # indptr, indices
        ctypes.c_int64, ctypes.c_int64,    # n_rows, nnz (len(indices))
        ctypes.c_int32, ctypes.c_int32,    # idx64, ptr64
        ctypes.c_int32,                    # n_threads
    ]
    gw = lib.illico_csr_gather_window
    gw.restype = ctypes.c_int32
    gw.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # indptr, indices, data
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,     # n_rows, lb, ub
        ctypes.c_void_p, ctypes.c_int32,                    # out, dtype code
        ctypes.c_int32, ctypes.c_int32,                     # idx64, ptr64
        ctypes.c_int32,                                     # n_threads
    ]
    return lib


# dtype encodings of illico_consume_tile (keep in sync with csrc/tail.cpp)
(_DT_F32, _DT_I32, _DT_F64_HILO, _DT_F64, _DT_U16, _DT_F48, _DT_U24,
 _DT_U32, _DT_U40, _DT_F96, _DT_U8) = range(11)


def _encode_packed(buf: np.ndarray, shape, dtype: np.dtype, off: int, nbytes: int):
    """(pointer, dtype code) for one packed-buffer region.

    Raises ValueError for encodings this build does not know; callers
    fall back to the numpy consume path.  (An unrecognized block must never
    fall through to another tier's decode: it would corrupt the statistics
    silently.)
    """
    ptr = buf.ctypes.data + off
    size = int(np.prod(shape)) if shape else 1
    if dtype == np.float32 and nbytes == 4 * size:
        return ptr, _DT_F32
    if dtype == np.int32 and nbytes == 4 * size:
        return ptr, _DT_I32
    if dtype == np.uint16 and nbytes == 2 * size:
        return ptr, _DT_U16
    if dtype == np.uint8 and nbytes == size:
        return ptr, _DT_U8
    if dtype == np.uint32:
        if nbytes == 3 * size:
            return ptr, _DT_U24
        if nbytes == 4 * size:
            return ptr, _DT_U32
    if dtype == np.float64:
        if nbytes == 6 * size:
            return ptr, _DT_F48
        if nbytes == 5 * size:
            return ptr, _DT_U40
        if nbytes == 12 * size:
            return ptr, _DT_F96
        if nbytes == 8 * size:
            return ptr, _DT_F64_HILO
    raise ValueError(
        f"unsupported packed encoding: dtype {dtype}, {nbytes} bytes for "
        f"{size} elements"
    )


def consume_tile_native(
    buf: np.ndarray,
    spec: dict,
    counts: np.ndarray,
    ref_code: int,
    w: int,
    alternative: str,
    use_continuity: bool,
    tie_correct: bool,
    results: np.ndarray,
    col0: int,
    fc_split_code: int = -1,
    u2_split_code: int = -1,
    n_threads: int | None = None,
) -> bool:
    """Fused consume of one packed tile buffer into ``results``.

    ``spec`` maps key -> (shape, dtype, offset, nbytes) for the packed
    buffer (any engine's layout); ``results`` is the (G, n_genes, 3) float64
    output.  ``fc_split_code >= 0`` marks the group whose expression-sum row
    travels as the separate per-column ``fc_split_col`` array.
    ``n_threads`` threads share the groups (default :func:`tail_threads`).
    Returns False when the native library (or a needed key) is unavailable
    so the caller can fall back to numpy.
    """
    lib = _load()
    if lib is None or alternative not in _ALTERNATIVES:
        return False
    if n_threads is None:
        n_threads = tail_threads()
    if "k" in spec:  # nnz-split OVO wire
        return _consume_ksplit(
            lib, buf, spec, counts, ref_code, w, alternative,
            use_continuity, tie_correct, results, col0, fc_split_code, n_threads,
        )
    is_ovr = ref_code < 0
    u2_key = "R2" if is_ovr else "U2"
    tie_col_key = "tie_col" if is_ovr else "tie_ref_col"
    needed = {u2_key, "fc_sums", tie_col_key} | (set() if is_ovr else {"tie_seg"})
    if not needed <= spec.keys():
        return False
    if fc_split_code >= 0 and "fc_split_col" not in spec:
        return False
    if u2_split_code >= 0 and "r2_split_col" not in spec:
        return False
    if not (buf.flags.c_contiguous and results.flags.c_contiguous):
        return False

    G, T = spec[u2_key][0]
    counts = np.ascontiguousarray(counts, dtype=np.float64)
    scratch = np.empty(max(int(w), 1), np.float64)
    dp = ctypes.POINTER(ctypes.c_double)

    def enc(key):
        shape, dtype, off, nbytes = spec[key]
        return _encode_packed(buf, shape, dtype, off, nbytes)

    try:
        u2_p, u2_d = enc(u2_key)
        fc_p, fc_d = enc("fc_sums")
        tc_p, tc_d = enc(tie_col_key)
        if u2_split_code >= 0:
            us_p, us_d = enc("r2_split_col")
        else:
            us_p, us_d = 0, _DT_F64_HILO
        if fc_split_code >= 0:
            fs_p, fs_d = enc("fc_split_col")
        else:
            fs_p, fs_d = 0, _DT_U32
        if is_ovr:
            ts_p, ts_d = 0, _DT_F64_HILO
        else:
            ts_p, ts_d = enc("tie_seg")
    except ValueError:
        # A spec dtype this build does not know (e.g. a newer wire tier):
        # degrade to the numpy consume path per the fallback contract.
        return False

    lib.illico_consume_tile(
        ctypes.c_void_p(u2_p), ctypes.c_int32(u2_d),
        ctypes.c_void_p(us_p), ctypes.c_int32(us_d),
        ctypes.c_int64(u2_split_code),
        ctypes.c_void_p(fc_p), ctypes.c_int32(fc_d),
        ctypes.c_void_p(fs_p), ctypes.c_int32(fs_d),
        ctypes.c_int64(fc_split_code),
        ctypes.c_void_p(ts_p), ctypes.c_int32(ts_d),
        ctypes.c_void_p(tc_p), ctypes.c_int32(tc_d),
        counts.ctypes.data_as(dp),
        ctypes.c_int64(G), ctypes.c_int64(T), ctypes.c_int64(w),
        ctypes.c_int64(ref_code),
        ctypes.c_int32(_ALTERNATIVES[alternative]),
        ctypes.c_int32(1 if use_continuity else 0),
        ctypes.c_int32(1 if tie_correct else 0),
        results.ctypes.data_as(dp),
        ctypes.c_int64(col0), ctypes.c_int64(results.shape[1]),
        scratch.ctypes.data_as(dp),
        ctypes.c_int32(n_threads),
    )
    return True


def _consume_ksplit(
    lib, buf, spec, counts, ref_code, w, alternative, use_continuity,
    tie_correct, results, col0, fc_split_code, n_threads,
) -> bool:
    """Dispatch the nnz-split OVO wire to illico_consume_tile_ksplit."""
    needed = {
        "k", "u2_res", "tie_res", "tie_ref_col", "ref_nnz_col",
        "tie_base_col", "exc_key", "exc_val",
    }
    fc_is_res = "fc_res" in spec
    needed.add("fc_res" if fc_is_res else "fc_sums")
    if not needed <= spec.keys() or ref_code < 0:
        return False
    if fc_split_code >= 0 and "fc_split_col" not in spec:
        return False
    if not (buf.flags.c_contiguous and results.flags.c_contiguous):
        return False

    G, T = spec["k"][0]
    n_exc = spec["exc_key"][0][0]
    counts = np.ascontiguousarray(counts, dtype=np.float64)
    scratch = np.empty(max(int(w), 1), np.float64)
    dp = ctypes.POINTER(ctypes.c_double)

    def enc(key):
        shape, dtype, off, nbytes = spec[key]
        return _encode_packed(buf, shape, dtype, off, nbytes)

    try:
        k_shape, k_dtype, k_off, k_nbytes = spec["k"]
        if k_dtype != np.uint8 or k_nbytes != int(np.prod(k_shape)):
            return False
        u2_p, u2_d = enc("u2_res")
        tr_p, tr_d = enc("tie_res")
        fc_p, fc_d = enc("fc_res" if fc_is_res else "fc_sums")
        tc_p, tc_d = enc("tie_ref_col")
        rn_p, rn_d = enc("ref_nnz_col")
        tb_p, tb_d = enc("tie_base_col")
        ek_shape, ek_dtype, ek_off, ek_nbytes = spec["exc_key"]
        if ek_dtype != np.uint32 or ek_nbytes != 4 * int(np.prod(ek_shape)):
            return False
        ev_p, ev_d = enc("exc_val")
        if fc_split_code >= 0:
            fs_p, fs_d = enc("fc_split_col")
        else:
            fs_p, fs_d = 0, _DT_U32
    except ValueError:
        return False

    lib.illico_consume_tile_ksplit(
        ctypes.c_void_p(buf.ctypes.data + k_off),
        ctypes.c_void_p(u2_p), ctypes.c_int32(u2_d),
        ctypes.c_void_p(tr_p), ctypes.c_int32(tr_d),
        ctypes.c_void_p(fc_p), ctypes.c_int32(fc_d),
        ctypes.c_int32(1 if fc_is_res else 0),
        ctypes.c_void_p(fs_p), ctypes.c_int32(fs_d),
        ctypes.c_int64(fc_split_code),
        ctypes.c_void_p(tc_p), ctypes.c_int32(tc_d),
        ctypes.c_void_p(rn_p), ctypes.c_int32(rn_d),
        ctypes.c_void_p(tb_p), ctypes.c_int32(tb_d),
        ctypes.c_void_p(buf.ctypes.data + ek_off),
        ctypes.c_void_p(ev_p), ctypes.c_int32(ev_d),
        ctypes.c_int64(n_exc),
        counts.ctypes.data_as(dp),
        ctypes.c_int64(G), ctypes.c_int64(T), ctypes.c_int64(w),
        ctypes.c_int64(ref_code),
        ctypes.c_int32(_ALTERNATIVES[alternative]),
        ctypes.c_int32(1 if use_continuity else 0),
        ctypes.c_int32(1 if tie_correct else 0),
        results.ctypes.data_as(dp),
        ctypes.c_int64(col0), ctypes.c_int64(results.shape[1]),
        scratch.ctypes.data_as(dp),
        ctypes.c_int32(n_threads),
    )
    return True


def tail_threads(busy: int = 0) -> int:
    """Thread count for the native consume loop (bit-exact at any value).

    ``ILLICO_TPU_TAIL_THREADS`` when it holds an integer (at least 1 is
    used).  Otherwise the cores this process may run on
    (``os.sched_getaffinity``, else ``os.cpu_count``) less ``busy``
    threads that work beside the tail (the prefetch threads of host input),
    and at least 1.  The reference package defaults to 1 thread, chosen for
    a one-core host.
    """
    try:
        return max(1, int(os.environ["ILLICO_TPU_TAIL_THREADS"]))
    except (KeyError, ValueError):
        pass
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        cores = os.cpu_count() or 1
    return max(1, cores - busy)


def native_available() -> bool:
    return _load() is not None


def openmp_enabled() -> bool:
    """Was the loaded library built with OpenMP?  Without it the consume
    loop runs on one thread whatever :func:`tail_threads` says.  False when
    no library is loaded."""
    lib = _load()
    return lib is not None and bool(lib.illico_openmp())


def pvalue_tail_native(
    U: np.ndarray,
    tie_sum: np.ndarray,
    n_ref: np.ndarray,
    n_tgt: np.ndarray,
    use_continuity: bool,
    tie_correct: bool,
    alternative: str,
    out: np.ndarray | None = None,
    n_threads: int | None = None,
) -> np.ndarray | None:
    """Fused p-value tail on ``n_threads`` threads (default
    :func:`tail_threads`); returns None if the native library is
    unavailable."""
    lib = _load()
    if lib is None or alternative not in _ALTERNATIVES:
        return None
    U = np.ascontiguousarray(U, dtype=np.float64)
    G, T = U.shape
    tie_sum = np.ascontiguousarray(np.broadcast_to(tie_sum, U.shape), np.float64)
    n_ref = np.ascontiguousarray(np.broadcast_to(np.asarray(n_ref, np.float64).reshape(-1), (G,)))
    n_tgt = np.ascontiguousarray(np.broadcast_to(np.asarray(n_tgt, np.float64).reshape(-1), (G,)))
    if out is None:
        out = np.empty_like(U)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.illico_pvalue_tail(
        U.ctypes.data_as(dp),
        tie_sum.ctypes.data_as(dp),
        n_ref.ctypes.data_as(dp),
        n_tgt.ctypes.data_as(dp),
        ctypes.c_int64(G),
        ctypes.c_int64(T),
        ctypes.c_int32(_ALTERNATIVES[alternative]),
        ctypes.c_int32(1 if use_continuity else 0),
        ctypes.c_int32(1 if tie_correct else 0),
        out.ctypes.data_as(dp),
        ctypes.c_int32(tail_threads() if n_threads is None else n_threads),
    )
    return out


# -- the in-RAM CSR's scans (csrc/csr_scan.cpp) -------------------------------
# Value dtypes of illico_csr_gather_window, in the order of its dtype codes
# (keep in sync with csr_scan.cpp's GatherDtype).
CSR_GATHER_DTYPES = tuple(np.dtype(t) for t in (
    np.int8, np.uint8, np.int16, np.uint16, np.int32, np.int64, np.float32, np.float64,
))
_CSR_INDEX_DTYPES = (np.dtype(np.int32), np.dtype(np.int64))

# Calls of the CSR scans by path: the native entry points below count
# themselves, ``utils/registry.CSRDataHandler``'s plain bodies count theirs
# (:func:`count_csr_scan`).  Callers zero the counts and read them to assert
# which path ran.
csr_scan_calls = dict.fromkeys(("check_native", "check_plain", "gather_native", "gather_plain"), 0)
_CALLS_LOCK = threading.Lock()
_SCAN = threading.local()


def count_csr_scan(key: str) -> None:
    with _CALLS_LOCK:
        csr_scan_calls[key] += 1


def single_scan_thread() -> None:
    """Run the CSR scans of the calling thread on one thread each: for
    threads that run several scans side by side (the runner's prefetch
    threads; a ``ThreadPoolExecutor`` initializer)."""
    _SCAN.threads = 1


def scan_threads() -> int:
    """Threads of one CSR scan: 1 on a thread that called
    :func:`single_scan_thread`, else :func:`tail_threads` (nothing else
    runs beside the index check and the runner's sample)."""
    return getattr(_SCAN, "threads", None) or tail_threads()


def csr_index_dtypes_ok(indptr: np.ndarray, indices: np.ndarray) -> bool:
    """Are both index arrays int32 or int64 in the machine's byte order?"""
    return indptr.dtype in _CSR_INDEX_DTYPES and indices.dtype in _CSR_INDEX_DTYPES


def _csr_lib(indptr, indices):
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is not available")
    if not csr_index_dtypes_ok(indptr, indices):
        raise ValueError(f"index dtypes {indptr.dtype}, {indices.dtype}: int32 or int64 only")
    return lib


def csr_check_sorted_native(
    indptr: np.ndarray, indices: np.ndarray, n_threads: int | None = None,
) -> int:
    """First row of a CSR whose column indices decrease within the row, or
    -1.  Equal neighbours (duplicates) pass, and so does a drop where a row
    begins; empty rows anywhere pass.  Raises where the library is not
    loaded or an index array is neither int32 nor int64."""
    indptr, indices = np.ascontiguousarray(indptr), np.ascontiguousarray(indices)
    lib = _csr_lib(indptr, indices)
    count_csr_scan("check_native")
    return int(lib.illico_csr_check_sorted(
        ctypes.c_void_p(indptr.ctypes.data), ctypes.c_void_p(indices.ctypes.data),
        ctypes.c_int64(indptr.size - 1), ctypes.c_int64(indices.size),
        ctypes.c_int32(indices.dtype.itemsize == 8), ctypes.c_int32(indptr.dtype.itemsize == 8),
        ctypes.c_int32(scan_threads() if n_threads is None else n_threads),
    ))


def csr_gather_window_native(
    indptr: np.ndarray, indices: np.ndarray, data: np.ndarray, lb: int, ub: int,
    n_threads: int | None = None,
) -> np.ndarray:
    """Dense C-order ``(n_rows, ub - lb)`` window of a CSR in the data's
    dtype, one binary search per row: equal bit for bit to
    ``csr[:, lb:ub].tocsc().toarray(out=zeros)``, duplicates summed in
    storage order.  Every row's indices must be sorted
    (:func:`csr_check_sorted_native`).  Raises where the library is not
    loaded or for dtypes outside :data:`CSR_GATHER_DTYPES` and int32/int64
    indices."""
    indptr, indices = np.ascontiguousarray(indptr), np.ascontiguousarray(indices)
    data = np.ascontiguousarray(data)
    lib = _csr_lib(indptr, indices)
    if data.dtype not in CSR_GATHER_DTYPES:
        raise ValueError(f"value dtype {data.dtype} is not gathered natively")
    if not 0 <= lb <= ub:
        raise ValueError(f"window [{lb}, {ub})")
    n_rows = indptr.size - 1
    out = np.zeros((n_rows, ub - lb), data.dtype)
    count_csr_scan("gather_native")
    rc = lib.illico_csr_gather_window(
        ctypes.c_void_p(indptr.ctypes.data), ctypes.c_void_p(indices.ctypes.data),
        ctypes.c_void_p(data.ctypes.data),
        ctypes.c_int64(n_rows), ctypes.c_int64(lb), ctypes.c_int64(ub),
        ctypes.c_void_p(out.ctypes.data), ctypes.c_int32(CSR_GATHER_DTYPES.index(data.dtype)),
        ctypes.c_int32(indices.dtype.itemsize == 8), ctypes.c_int32(indptr.dtype.itemsize == 8),
        ctypes.c_int32(scan_threads() if n_threads is None else n_threads),
    )
    if rc:
        raise ValueError(f"the library does not gather dtype {data.dtype}")
    return out
