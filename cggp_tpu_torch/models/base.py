"""Shared model machinery (port of ``cggp_tpu/models/base.py``)."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

from cggp_tpu_torch.config import DeviceLike, default_float, resolve_device
from cggp_tpu_torch.ops.bijectors import positive


@dataclasses.dataclass(frozen=True)
class GaussianLikelihood:
    """Gaussian likelihood with positive variance.  Its ELBO and log-density
    terms arrive with the training slice; serving needs only the variance."""

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
