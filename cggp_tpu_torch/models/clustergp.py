"""ClusterGP — Cluster-Dirichlet GP with Cholesky solves (port of
``cggp_tpu/models/clustergp.py``).

Non-trainable ``pseudo_u`` (cluster y-means) and ``cluster_counts``;
``diag_variance = likelihood_variance / counts`` is derived, not learned.
Its ``predict_f`` is the Cholesky oracle the CG serving path is held
against.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cggp_tpu_torch.config import DeviceLike, default_float, resolve_device
from cggp_tpu_torch.models.base import GaussianLikelihood
from cggp_tpu_torch.ops.kernels import Kernel
from cggp_tpu_torch.ops.linalg import add_diagonal


def _as_tensor(value, dtype, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(value), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class ClusterGP:
    kernel: Kernel
    likelihood: GaussianLikelihood = GaussianLikelihood()
    num_data: Optional[int] = None

    def init_params(self, inducing_points, variance: float = 1.0,
                    lengthscales=None, noise_variance: float = 0.1,
                    pseudo_u=None, cluster_counts=None,
                    dtype: Optional[torch.dtype] = None,
                    device: DeviceLike = None) -> Dict:
        dtype = default_float() if dtype is None else dtype
        device = resolve_device(device)
        z = _as_tensor(inducing_points, dtype, device)
        m = z.shape[0]
        if lengthscales is None:
            lengthscales = np.ones((z.shape[-1],))
        u = torch.zeros((m, 1), dtype=dtype, device=device) if pseudo_u is None \
            else _as_tensor(pseudo_u, dtype, device)
        counts = torch.ones((m, 1), dtype=dtype, device=device) if cluster_counts is None \
            else _as_tensor(cluster_counts, dtype, device)
        return {
            "kernel": self.kernel.init_params(variance, lengthscales, dtype=dtype, device=device),
            "likelihood": self.likelihood.init_params(noise_variance, dtype=dtype, device=device),
            "inducing_points": z,
            "pseudo_u": u,
            "cluster_counts": counts,
        }

    def diag_variance(self, params: Dict) -> torch.Tensor:
        return self.likelihood.variance(params["likelihood"]) / params["cluster_counts"]

    def predict_f(self, params: Dict, x_new: torch.Tensor,
                  full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        kp = params["kernel"]
        z = params["inducing_points"]
        var = self.diag_variance(params)

        kmm = self.kernel.K(kp, z)
        kmn = self.kernel.K(kp, z, x_new)
        chol = torch.linalg.cholesky(add_diagonal(kmm, var[:, 0]))
        kuu_inv_u = torch.cholesky_solve(params["pseudo_u"], chol)
        a = torch.linalg.solve_triangular(chol, kmn, upper=False)

        if full_cov:
            knn = self.kernel.K(kp, x_new)
            fvar = (knn - a.T @ a)[None, ...]
        else:
            knn = self.kernel.K_diag(kp, x_new)
            fvar = (knn - torch.sum(torch.square(a), dim=0))[:, None]
        return kmn.T @ kuu_inv_u, fvar
