"""cggp_tpu_torch — the PyTorch / NVIDIA H100 port of ``cggp_tpu``.

A second package beside the JAX reference.  It imports ``torch`` and numpy
only — never ``jax`` and never ``cggp_tpu`` — and keeps the JAX package's
module names so each function's counterpart is easy to find.  The TPU's
Pallas kernels on the ported path are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use (``_build.py``) and loaded
with ``ctypes``.

Ported so far (the serving slice): kernels, the Gaussian likelihood, the
Cholesky ClusterGP oracle, the dense forward CG solver with its
``"xla"``/``"pallas"``/``"pallas_resident"`` routes, ``CGGP.posterior``
(``"cg"``/``"chol"``) and ``predict_in_batches``.

Entry points default to ``device="cuda"`` and raise when no card is present
unless the caller asks for ``device="cpu"``; they never fall back quietly.
"""

from cggp_tpu_torch.config import default_float, require_ieee_fp32_matmul, resolve_device

__version__ = "0.1.0"

__all__ = ["default_float", "require_ieee_fp32_matmul", "resolve_device", "__version__"]
