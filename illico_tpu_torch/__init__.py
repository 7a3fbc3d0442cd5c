"""illico_tpu_torch — asymptotic Wilcoxon rank-sum tests on PyTorch and CUDA.

The PyTorch port of ``illico_tpu``: same public API and output DataFrame,
same numerical contract (U exact, p within 1e-12 of
``scipy.stats.mannwhitneyu``, fold change within 1e-6).  It imports torch and
never jax, nor anything of ``illico_tpu``.  Computation runs on a CUDA
device by default; the histogram engine's kernel is hand-written CUDA C++
(``csrc/hist_kernel.cu``) built by ``nvcc`` at first use.
"""

from illico_tpu_torch.api import asymptotic_wilcoxon, asymptotic_wilcoxon_arrays

__all__ = [
    "asymptotic_wilcoxon",
    "asymptotic_wilcoxon_arrays",
    "asymptotic_wilcoxon_multihost",
    "enable_compilation_cache",
]
__version__ = "0.1.8"


def __getattr__(name):
    # Lazy: a plain single-process import does not load the multi-process
    # layer.
    if name == "asymptotic_wilcoxon_multihost":
        from illico_tpu_torch.parallel.multihost import asymptotic_wilcoxon_multihost

        return asymptotic_wilcoxon_multihost
    raise AttributeError(f"module 'illico_tpu_torch' has no attribute {name!r}")


def enable_compilation_cache(path: str | None = None) -> str:
    """Build the package's libraries ahead of a run, into a directory that
    later processes reuse; returns that directory.

    ``path`` (default: the ``ILLICO_TPU_COMPILE_CACHE`` variable, else
    ``illico_tpu_torch/_build/``) becomes the directory the native tail and
    the CUDA kernels are built into and loaded from for the rest of the
    process.  The native tail is built now; every ``csrc/*.cu`` is built now
    when ``nvcc`` and a CUDA device are there, and an ``nvcc`` failure
    raises.  Without ``nvcc`` only the tail is built, and the log line says
    so.  Call it before first use: once a library has been loaded from
    another directory it raises ``RuntimeError``.
    """
    import os
    from pathlib import Path

    import torch

    import illico_tpu_torch.native as native
    from illico_tpu_torch.utils import cuda_build
    from illico_tpu_torch.utils.log import logger

    if path is None:
        path = os.environ.get("ILLICO_TPU_COMPILE_CACHE", str(cuda_build.BUILD_DIR))
    target = Path(path).resolve()
    loaded = [native.BUILD_INFO["path"], *(lib._name for lib in cuda_build._LIBS.values())]
    elsewhere = [p for p in loaded if p and Path(p).resolve().parent != target]
    if elsewhere:
        raise RuntimeError(
            f"enable_compilation_cache({str(target)!r}) must be called before "
            f"first use: already loaded {elsewhere}."
        )
    target.mkdir(parents=True, exist_ok=True)
    native.BUILD_DIR = cuda_build.BUILD_DIR = target
    tail = native.native_available()
    try:
        cuda_build._nvcc()
        have_nvcc = True
    except RuntimeError:
        have_nvcc = False
    stems = []
    if have_nvcc and torch.cuda.is_available():
        stems = sorted(p.stem for p in cuda_build.SRC_DIR.glob("*.cu"))
        cuda_build.build_libraries(stems)
    logger.info(
        "Build cache %s: native tail %s; CUDA kernels %s.",
        target, "built" if tail else "NOT built (no C++ compiler, or disabled)",
        f"built {stems}" if stems else "not built (needs nvcc and a CUDA device)",
    )
    return str(target)
