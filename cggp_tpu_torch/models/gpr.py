"""Exact GP regression by a dense Cholesky factor (port of
``cggp_tpu/models/gpr.py``): O(N^3), the oracle of the matrix-free
:class:`~cggp_tpu_torch.models.itergpr.IterGPR`.

The training data are bound per call (``posterior(params, data)``,
``predict_f(params, data, x_new)``), as in the JAX package, and are moved
to the parameters' device and dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cggp_tpu_torch.config import DeviceLike, default_float, resolve_device
from cggp_tpu_torch.models.base import GaussianLikelihood
from cggp_tpu_torch.models.clustergp import _as_tensor
from cggp_tpu_torch.ops.kernels import Kernel
from cggp_tpu_torch.ops.linalg import add_diagonal


def data_like_params(params: Dict, x, y=None):
    """``x`` (and ``y``) as tensors on the parameters' device in their dtype."""
    ref = params["likelihood"]["variance"]
    x = _as_tensor(x, ref.dtype, ref.device)
    return x if y is None else (x, _as_tensor(y, ref.dtype, ref.device))


def init_gp_params(kernel: Kernel, likelihood: GaussianLikelihood, input_dim: int,
                   variance: float, lengthscales, noise_variance: float,
                   dtype: Optional[torch.dtype], device: DeviceLike) -> Dict:
    """``{"kernel", "likelihood"}`` parameters (unit lengthscales unless
    given), the tree of the exact GP models in both packages."""
    dtype = default_float() if dtype is None else dtype
    device = resolve_device(device)
    if lengthscales is None:
        lengthscales = np.ones((input_dim,))
    return {"kernel": kernel.init_params(variance, lengthscales, dtype=dtype, device=device),
            "likelihood": likelihood.init_params(noise_variance, dtype=dtype, device=device)}


@dataclasses.dataclass(frozen=True)
class GPR:
    """Exact GPR: one Cholesky factor of ``K(X, X) + sigma^2 I``."""

    kernel: Kernel
    likelihood: GaussianLikelihood = GaussianLikelihood()

    def init_params(self, input_dim: int, variance: float = 1.0, lengthscales=None,
                    noise_variance: float = 0.1, dtype: Optional[torch.dtype] = None,
                    device: DeviceLike = None) -> Dict:
        return init_gp_params(self.kernel, self.likelihood, input_dim, variance, lengthscales,
                              noise_variance, dtype, device)

    def _factor(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        noise = self.likelihood.variance(params["likelihood"])
        k = add_diagonal(self.kernel.K(params["kernel"], x), noise * torch.ones_like(x[:, 0]))
        return torch.linalg.cholesky(k)

    def log_marginal_likelihood(self, params: Dict, data: Tuple) -> torch.Tensor:
        x, y = data_like_params(params, *data)
        n = x.shape[0]
        chol = self._factor(params, x)
        alpha = torch.cholesky_solve(y, chol)
        quad = torch.sum(y * alpha)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
        return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))

    # In the reference CLI, GPR's objective plays the role of the ELBO.
    def maximum_log_likelihood_objective(self, params: Dict, data: Tuple) -> torch.Tensor:
        return self.log_marginal_likelihood(params, data)

    def training_loss(self, params: Dict, data: Tuple) -> torch.Tensor:
        return -self.log_marginal_likelihood(params, data)

    # -- cached serving: the factor once per parameters ------------------------

    def posterior(self, params: Dict, data: Tuple) -> "GPRPosterior":
        x, y = data_like_params(params, *data)
        chol = self._factor(params, x)
        return GPRPosterior(kernel_params=params["kernel"], x_train=x, chol=chol,
                            nu=torch.cholesky_solve(y, chol))

    def posterior_mean(self, post: "GPRPosterior", x_new: torch.Tensor) -> torch.Tensor:
        return self.kernel.K(post.kernel_params, post.x_train, x_new).T @ post.nu

    def posterior_predict(self, post: "GPRPosterior", x_new: torch.Tensor,
                          full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        kp = post.kernel_params
        kmn = self.kernel.K(kp, post.x_train, x_new)  # [N, T]
        a = torch.linalg.solve_triangular(post.chol, kmn, upper=False)
        if full_cov:
            var = (self.kernel.K(kp, x_new) - a.T @ a)[None, ...]
        else:
            var = (self.kernel.K_diag(kp, x_new) - torch.sum(torch.square(a), dim=0))[:, None]
        return kmn.T @ post.nu, var

    def predict_f(self, params: Dict, data: Tuple, x_new: torch.Tensor,
                  full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.posterior_predict(self.posterior(params, data), x_new, full_cov=full_cov)


class GPRPosterior(NamedTuple):
    """Serving cache of :meth:`GPR.posterior`, with the JAX package's fields
    in its order."""

    kernel_params: Dict
    x_train: torch.Tensor  # [N, D]
    chol: torch.Tensor  # [N, N] lower Cholesky of Knn + noise I
    nu: torch.Tensor  # [N, 1] = (Knn + noise I)^{-1} y
