"""Shared model machinery (port of ``cggp_tpu/models/base.py``): the Gaussian
likelihood, minibatch scaling, the Cholesky serving cache and the
chol-or-CG conditioning policy."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

from cggp_tpu_torch.config import DeviceLike, default_float, resolve_device
from cggp_tpu_torch.ops.bijectors import positive

_LOG2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class GaussianLikelihood:
    """Gaussian likelihood with positive variance (GPflow's closed forms for
    the ELBO's expected log-likelihood and the predictive log density)."""

    positive_lower: float = 1e-6

    @property
    def bijector(self):
        return positive(self.positive_lower)

    def init_params(self, variance: float = 0.1, dtype: Optional[torch.dtype] = None,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        dtype = default_float() if dtype is None else dtype
        value = torch.as_tensor(variance, dtype=dtype, device=resolve_device(device))
        return {"variance": self.bijector.inverse(value)}

    def variance(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.bijector.forward(params["variance"])

    def variational_expectations(self, params, f_mean: torch.Tensor, f_var: torch.Tensor,
                                 y: torch.Tensor) -> torch.Tensor:
        """``E_q[log N(y | f, sigma^2)]`` per data point."""
        noise = self.variance(params)
        return -0.5 * (_LOG2PI + torch.log(noise) + (torch.square(y - f_mean) + f_var) / noise)

    def predict_log_density(self, params, f_mean: torch.Tensor, f_var: torch.Tensor,
                            y: torch.Tensor) -> torch.Tensor:
        """``log N(y | f_mean, f_var + sigma^2)`` per data point."""
        total_var = f_var + self.variance(params)
        return -0.5 * (_LOG2PI + torch.log(total_var) + torch.square(y - f_mean) / total_var)


def minibatch_scale(num_data: Optional[int], batch_size: int, dtype: torch.dtype) -> torch.Tensor:
    """``N / batch`` ELBO scale in ``dtype`` (1 without ``num_data``), as a
    0-d CPU tensor, which multiplies a tensor on any device."""
    if num_data is None:
        return torch.tensor(1.0, dtype=dtype)
    return torch.tensor(num_data, dtype=dtype) / torch.tensor(batch_size, dtype=dtype)


class CholPosterior(NamedTuple):
    """Serving cache of the Cholesky-family models: the [M, M] factor of
    ``Kmm + diag(var)`` and the predictive weights ``nu``."""

    kernel_params: Dict
    inducing_points: torch.Tensor  # [M, D]
    chol: torch.Tensor  # [M, M] lower Cholesky of Kmm + diag(var)
    nu: torch.Tensor  # [M, 1]: mean(x) = K(x, Z) @ nu


# kappa * eps must stay below this for a one-shot fp32 Cholesky serving
# factorization to be trustworthy (same margin as the JAX package).
CHOL_KAPPA_EPS_MARGIN = 0.1


def chol_or_cg_from_eigs(eig_min, eig_max, dtype: torch.dtype,
                         margin: float = CHOL_KAPPA_EPS_MARGIN) -> str:
    """Serving-solver policy from extremal-eigenvalue estimates: ``"chol"``
    iff the estimated ``kappa * eps(dtype)`` is safely below 1.  A
    non-finite estimate means poisoned inputs, not ill-conditioning: defer
    to ``"chol"`` so the serving-time non-finite-factor guard reports it."""
    info = torch.finfo(dtype)
    kappa = float(eig_max) / max(float(eig_min), info.tiny)
    if not math.isfinite(kappa):
        return "chol"
    return "chol" if kappa * info.eps <= margin else "cg"
