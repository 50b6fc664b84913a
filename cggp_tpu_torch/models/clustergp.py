"""ClusterGP — Cluster-Dirichlet GP with Cholesky solves (port of
``cggp_tpu/models/clustergp.py``).

Non-trainable ``pseudo_u`` (cluster y-means) and ``cluster_counts``;
``diag_variance = likelihood_variance / counts`` is derived, not learned.
Its ``predict_f`` and ``elbo`` are the Cholesky oracle the CG serving and
training paths are held against.  Serving: :meth:`ClusterGP.posterior`
factorizes ``Kmm + diag(var)`` once into a :class:`CholPosterior`;
:meth:`posterior_mean` is then one skinny product a batch and
:meth:`posterior_predict` one triangular solve.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cggp_tpu_torch.config import DeviceLike, default_float, resolve_device
from cggp_tpu_torch.models.base import CholPosterior, GaussianLikelihood, minibatch_scale
from cggp_tpu_torch.ops.kernels import Kernel
from cggp_tpu_torch.ops.linalg import add_diagonal


def _as_tensor(value, dtype, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(dtype=dtype, device=device)
    return torch.as_tensor(np.array(value), dtype=dtype, device=device)  # a writable copy


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

    def trainable_mask(self, params: Dict, trainable_inducing_points: bool = False,
                       trainable_pseudo_u: bool = False) -> Dict:
        """Only the kernel and the likelihood train by default; the mask has
        ``params``' structure with a bool per leaf."""

        def all_true(node):
            return {k: all_true(v) for k, v in node.items()} if isinstance(node, dict) else True

        mask = all_true(params)
        mask["inducing_points"] = trainable_inducing_points
        mask["pseudo_u"] = trainable_pseudo_u
        mask["cluster_counts"] = False
        return mask

    def diag_variance(self, params: Dict) -> torch.Tensor:
        return self.likelihood.variance(params["likelihood"]) / params["cluster_counts"]

    def assign_clusters(self, params: Dict, iv, means, counts) -> Dict:
        """``params`` with a new inducing state (a re-clustering's ``(Z, u,
        counts)``), in the parameters' dtype and on their device."""
        z = params["inducing_points"]
        new = dict(params)
        new["inducing_points"] = _as_tensor(iv, z.dtype, z.device)
        new["pseudo_u"] = _as_tensor(means, z.dtype, z.device)
        new["cluster_counts"] = _as_tensor(counts, z.dtype, z.device)
        return new

    def prior_kl(self, params: Dict) -> torch.Tensor:
        kp = params["kernel"]
        z = params["inducing_points"]
        u = params["pseudo_u"]
        var = self.diag_variance(params)

        kmm = self.kernel.K(kp, z)  # jitter = 0
        chol = torch.linalg.cholesky(add_diagonal(kmm, var[:, 0]))
        kzz_lambda_inv_u = torch.cholesky_solve(u, chol)

        quad = torch.sum((kmm @ kzz_lambda_inv_u) * kzz_lambda_inv_u)
        trace = torch.trace(torch.cholesky_solve(kmm, chol))
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
        const = torch.sum(torch.log(var))
        return 0.5 * (quad - trace + logdet - const)

    def elbo(self, params: Dict, data: Tuple[torch.Tensor, torch.Tensor],
             key=None) -> torch.Tensor:
        del key
        x, y = data
        kl = self.prior_kl(params)
        f_mean, f_var = self.predict_f(params, x, full_cov=False)
        var_exp = self.likelihood.variational_expectations(params["likelihood"], f_mean, f_var, y)
        return torch.sum(var_exp) * minibatch_scale(self.num_data, x.shape[0], kl.dtype) - kl

    def training_loss(self, params: Dict, data: Tuple[torch.Tensor, torch.Tensor],
                      key=None) -> torch.Tensor:
        return -self.elbo(params, data, key)

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

    # -- cached serving -----------------------------------------------------------

    def posterior(self, params: Dict) -> CholPosterior:
        """The params-only serving cache: the Cholesky factor of ``Kmm +
        diag(var)`` and ``nu = (Kmm + diag(var))^{-1} u``, built once."""
        kp = params["kernel"]
        z = params["inducing_points"]
        var = self.diag_variance(params)
        chol = torch.linalg.cholesky(add_diagonal(self.kernel.K(kp, z), var[:, 0]))
        nu = torch.cholesky_solve(params["pseudo_u"], chol)
        return CholPosterior(kernel_params=kp, inducing_points=z, chol=chol, nu=nu)

    def posterior_mean(self, post: CholPosterior, x_new: torch.Tensor) -> torch.Tensor:
        """Cache-served mean: one [M, T] kernel block and a skinny product."""
        kmn = self.kernel.K(post.kernel_params, post.inducing_points, x_new)
        return kmn.T @ post.nu

    def posterior_predict(self, post: CholPosterior, x_new: torch.Tensor,
                          full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cache-served mean and variance: one triangular solve a batch."""
        kp = post.kernel_params
        kmn = self.kernel.K(kp, post.inducing_points, x_new)  # [M, T]
        a = torch.linalg.solve_triangular(post.chol, kmn, upper=False)
        if full_cov:
            fvar = (self.kernel.K(kp, x_new) - a.T @ a)[None, ...]
        else:
            fvar = (self.kernel.K_diag(kp, x_new) - torch.sum(torch.square(a), dim=0))[:, None]
        return kmn.T @ post.nu, fvar
