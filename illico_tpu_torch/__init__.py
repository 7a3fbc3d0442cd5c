"""illico_tpu_torch — asymptotic Wilcoxon rank-sum tests on PyTorch and CUDA.

The PyTorch port of ``illico_tpu``: same public API and output DataFrame,
same numerical contract (U exact, p within 1e-12 of
``scipy.stats.mannwhitneyu``, fold change within 1e-6).  It imports torch and
never jax, nor anything of ``illico_tpu``.  Computation runs on a CUDA
device by default; the histogram engine's kernel is hand-written CUDA C++
(``csrc/hist_kernel.cu``) built by ``nvcc`` at first use.
"""

from illico_tpu_torch.api import asymptotic_wilcoxon, asymptotic_wilcoxon_arrays

__all__ = ["asymptotic_wilcoxon", "asymptotic_wilcoxon_arrays"]
__version__ = "0.1.8"
