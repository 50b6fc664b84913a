"""cggp_tpu_torch — the PyTorch / NVIDIA H100 port of ``cggp_tpu``.

A second package beside the JAX reference.  It imports ``torch`` and numpy
only — never ``jax`` and never ``cggp_tpu`` — and keeps the JAX package's
module names so each function's counterpart is easy to find.  The TPU's
Pallas kernels on the ported path are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use (``_build.py``) and loaded
with ``ctypes``.

Ported so far: kernels, the Gaussian likelihood, the Cholesky ClusterGP
oracle (serving and ELBO), the dense CG solver with its
``"xla"``/``"pallas"``/``"pallas_resident"`` routes, its preconditioners and
its hand-written backward pass (another CG solve on the same route), the
dense logdet estimators, the dense CGGP training step (fused ELBO,
``precondition`` None/pivchol/chol/auto, capacity padding) with
``make_adam_step`` (``optax.adam``'s update), ``CGGP.posterior``
(``"cg"``/``"chol"``/``"auto"``) and ``predict_in_batches``; the matrix-free
``ImplicitCGGP`` serving path with the pivoted-Cholesky spectral
preconditioner and the fused Gram-matvec kernel; inducing-point selection
(the cover tree with its native C++ build, k-means on the device, OIPS,
greedy, uniform, the update functions and re-clustering) and the training
loop (``make_adam_multi_step``, ``train_using_adam_and_update``, the
monitor and its callbacks); matrix-free ``ImplicitCGGP`` training (its
custom-backward solve, the matrix-free logdets, the RFF preconditioner)
and the config-dir / posterior store; and the exact GP: the dense ``GPR``
and the matrix-free ``IterGPR`` (fused and chunked marginal likelihood,
posterior and serving, through B3 with ``use_pallas=True``), with
``train_full_batch_adam``, ``train_chunked_adam`` and data-bound
``predict_in_batches``; LOVE serving and the mixed-precision CG family;
the baselines ``SGPR`` and ``LpSVGP``, ``PathwiseClusterGP`` with the
pathwise serving cache and ``rff_sample``, the four L-BFGS trainers
(scipy's L-BFGS-B and ``optax.lbfgs``'s, ported), and ``data.py``'s
loaders with ``Config``.

Entry points default to ``device="cuda"`` and raise when no card is present
unless the caller asks for ``device="cpu"``; they never fall back quietly.
"""

from cggp_tpu_torch.config import (Config, default_config, default_float,
                                   require_ieee_fp32_matmul, resolve_device,
                                   set_default_config)

__version__ = "0.1.0"

__all__ = ["Config", "default_config", "set_default_config", "default_float",
           "require_ieee_fp32_matmul", "resolve_device", "__version__"]
