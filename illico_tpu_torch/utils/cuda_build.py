"""Build and load the hand-written CUDA kernels (``illico_tpu_torch/csrc``).

Each ``csrc/<stem>.cu`` has a plain C entry point and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``illico_tpu_torch/_build/<stem>-<hash>.so``
at first use, keyed on a hash of the source and the flags, then loaded with
``ctypes``.  Nothing here runs at import time: the package imports on hosts
without ``nvcc`` or a GPU, where only the kernels' plain torch versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load_library", "build_libraries", "BUILD_INFO"]

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# stem -> {"seconds": build wall time (0.0 when cached), "log": nvcc stderr}
BUILD_INFO: dict[str, dict] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); it is needed "
        "to build the CUDA kernels in illico_tpu_torch/csrc."
    )


def _target(stem: str) -> Path:
    src = SRC_DIR / f"{stem}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def build_libraries(stems) -> None:
    """Compile every stem not yet built, one ``nvcc`` process each, all
    started together; raises with nvcc's output if any build fails."""
    todo = [(s, _target(s)) for s in stems if not _target(s).exists()]
    for s in stems:
        BUILD_INFO.setdefault(s, {"seconds": 0.0, "log": ""})
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for stem, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{stem}.cu")]
        procs.append((stem, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for stem, so, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{log}")
            continue
        os.replace(tmp, so)
        BUILD_INFO[stem] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<stem>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            build_libraries([stem])
            lib = _LIBS[stem] = ctypes.CDLL(str(_target(stem)))
        return lib
