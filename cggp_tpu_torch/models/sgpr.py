"""Titsias SGPR, the collapsed sparse-GP bound (port of
``cggp_tpu/models/sgpr.py``): the baseline the reference trains with
L-BFGS over the full training set.

The training data are bound per call (``elbo(params, data)``,
``posterior(params, data)``, ``predict_f(params, data, x_new)``) and moved
to the inducing points' device and dtype.  The serving cache
:class:`SGPRPosterior` binds the training set once: both Cholesky factors
and one weight vector ``nu``, so a batch's mean is one skinny product and
its variance two triangular solves.
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


def _lower_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(chol, rhs, upper=False)


@dataclasses.dataclass(frozen=True)
class SGPR:
    """Sparse GP regression with the collapsed Titsias bound; ``jitter`` is
    added to ``Kuu``'s diagonal."""

    kernel: Kernel
    likelihood: GaussianLikelihood = GaussianLikelihood()
    jitter: float = 1e-6

    def init_params(self, inducing_points, variance: float = 1.0, lengthscales=None,
                    noise_variance: float = 0.1, dtype: Optional[torch.dtype] = None,
                    device: DeviceLike = None) -> Dict:
        dtype = default_float() if dtype is None else dtype
        device = resolve_device(device)
        z = _as_tensor(inducing_points, dtype, device)
        if lengthscales is None:
            lengthscales = np.ones((z.shape[-1],))
        return {
            "kernel": self.kernel.init_params(variance, lengthscales, dtype=dtype, device=device),
            "likelihood": self.likelihood.init_params(noise_variance, dtype=dtype, device=device),
            "inducing_points": z,
        }

    @staticmethod
    def _data(params: Dict, data):
        z = params["inducing_points"]
        x, y = data
        return _as_tensor(x, z.dtype, z.device), _as_tensor(y, z.dtype, z.device)

    def _common(self, params: Dict, x: torch.Tensor):
        kp = params["kernel"]
        z = params["inducing_points"]
        kuu = add_diagonal(self.kernel.K(kp, z),
                           self.jitter * torch.ones(z.shape[0], dtype=z.dtype, device=z.device))
        kuf = self.kernel.K(kp, z, x)  # [M, N]
        return kp, z, kuu, kuf, torch.linalg.cholesky(kuu)

    def _factors(self, params: Dict, x: torch.Tensor, y: torch.Tensor):
        """``(kp, z, chol_uu, a, aat, chol_b, c)`` of the collapsed bound:
        ``A = Luu^-1 Kuf / sigma``, ``B = A A^T + I``, ``c = Lb^-1 A y / sigma``."""
        sigma = torch.sqrt(self.likelihood.variance(params["likelihood"]))
        kp, z, _kuu, kuf, chol_uu = self._common(params, x)
        a = _lower_solve(chol_uu, kuf) / sigma  # [M, N]
        aat = a @ a.T
        chol_b = torch.linalg.cholesky(
            aat + torch.eye(z.shape[0], dtype=z.dtype, device=z.device))
        c = _lower_solve(chol_b, a @ y) / sigma
        return kp, z, chol_uu, a, aat, chol_b, c

    def elbo(self, params: Dict, data) -> torch.Tensor:
        x, y = self._data(params, data)
        n = x.shape[0]
        noise = self.likelihood.variance(params["likelihood"])
        kp, _z, _chol_uu, _a, aat, chol_b, c = self._factors(params, x, y)
        kdiag_sum = torch.sum(self.kernel.K_diag(kp, x))

        bound = -0.5 * n * math.log(2.0 * math.pi)
        bound = bound - torch.sum(torch.log(torch.diagonal(chol_b)))
        bound = bound - 0.5 * n * torch.log(noise)
        bound = bound - 0.5 * torch.sum(torch.square(y)) / noise
        bound = bound + 0.5 * torch.sum(torch.square(c))
        bound = bound - 0.5 * kdiag_sum / noise
        return bound + 0.5 * torch.trace(aat)

    def training_loss(self, params: Dict, data) -> torch.Tensor:
        return -self.elbo(params, data)

    # -- cached serving: the training set bound once ---------------------------

    def posterior(self, params: Dict, data) -> "SGPRPosterior":
        """Both factors and ``nu = Luu^-T Lb^-T c``, so the cached mean is
        ``K(x, Z) @ nu`` with no solve."""
        x, y = self._data(params, data)
        kp, z, chol_uu, _a, _aat, chol_b, c = self._factors(params, x, y)
        nu = torch.linalg.solve_triangular(
            chol_uu.T, torch.linalg.solve_triangular(chol_b.T, c, upper=True), upper=True)
        return SGPRPosterior(kernel_params=kp, inducing_points=z, chol_uu=chol_uu,
                             chol_b=chol_b, nu=nu)

    def posterior_mean(self, post: "SGPRPosterior", x_new: torch.Tensor) -> torch.Tensor:
        return self.kernel.K(post.kernel_params, post.inducing_points, x_new).T @ post.nu

    def _predictive(self, kp, x_new, tmp1, tmp2, mu, full_cov: bool):
        if full_cov:
            var = (self.kernel.K(kp, x_new) + tmp2.T @ tmp2 - tmp1.T @ tmp1)[None, ...]
        else:
            var = (self.kernel.K_diag(kp, x_new) + torch.sum(torch.square(tmp2), 0)
                   - torch.sum(torch.square(tmp1), 0))[:, None]
        return mu, var

    def posterior_predict(self, post: "SGPRPosterior", x_new: torch.Tensor,
                          full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        kp = post.kernel_params
        kus = self.kernel.K(kp, post.inducing_points, x_new)  # [M, T]
        tmp1 = _lower_solve(post.chol_uu, kus)
        tmp2 = _lower_solve(post.chol_b, tmp1)
        return self._predictive(kp, x_new, tmp1, tmp2, kus.T @ post.nu, full_cov)

    def predict_f(self, params: Dict, data, x_new: torch.Tensor,
                  full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uncached prediction: the factors rebuilt, the mean ``tmp2^T c``."""
        x, y = self._data(params, data)
        kp, z, chol_uu, _a, _aat, chol_b, c = self._factors(params, x, y)
        kus = self.kernel.K(kp, z, x_new)  # [M, T]
        tmp1 = _lower_solve(chol_uu, kus)
        tmp2 = _lower_solve(chol_b, tmp1)
        return self._predictive(kp, x_new, tmp1, tmp2, tmp2.T @ c, full_cov)


class SGPRPosterior(NamedTuple):
    """Serving cache of :meth:`SGPR.posterior`, with the JAX package's fields
    in its order."""

    kernel_params: Dict
    inducing_points: torch.Tensor  # [M, D]
    chol_uu: torch.Tensor  # [M, M] lower Cholesky of Kuu + jitter I
    chol_b: torch.Tensor  # [M, M] lower Cholesky of B = A A^T + I
    nu: torch.Tensor  # [M, 1] = Luu^-T Lb^-T c
