"""LpSVGP — SVGP with the subspace inducing parameterisation of Panos,
Dellaportas and Titsias (2018) (port of ``cggp_tpu/models/lpsvgp.py``).

The trainables are the free variational mean ``nu`` and a positive
``diag_variance`` (``raw_diag_variance`` through ``positive(positive_lower)``);
the KL uses a Cholesky factor of ``Kmm + diag(var)``:

    KL = 1/2 ( nu^T Kmm nu - tr((Kmm + L)^-1 Kmm) + logdet(Kmm + L) - sum log var )

and ``predict_f`` gives ``mu = Kmn^T nu``, ``var = Knn - sum(A^2)`` with
``A = L^-1 Kmn``.  The ELBO scales its minibatch sum by ``num_data / B``.
Serving: :meth:`LpSVGP.posterior` factorises once into a
:class:`~cggp_tpu_torch.models.base.CholPosterior` (``nu`` is already the
mean's weight vector).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cggp_tpu_torch.config import DeviceLike, default_float, resolve_device
from cggp_tpu_torch.models.base import CholPosterior, GaussianLikelihood, minibatch_scale
from cggp_tpu_torch.models.clustergp import _as_tensor
from cggp_tpu_torch.ops.bijectors import positive
from cggp_tpu_torch.ops.kernels import Kernel
from cggp_tpu_torch.ops.linalg import add_diagonal


@dataclasses.dataclass(frozen=True)
class LpSVGP:
    kernel: Kernel
    likelihood: GaussianLikelihood = GaussianLikelihood()
    num_data: Optional[int] = None
    positive_lower: float = 1e-6  # the bijector of diag_variance

    @property
    def _var_bijector(self):
        return positive(self.positive_lower)

    def init_params(self, inducing_points, variance: float = 1.0, lengthscales=None,
                    noise_variance: float = 0.1, nu=None, diag_variance=None,
                    dtype: Optional[torch.dtype] = None, device: DeviceLike = None) -> Dict:
        """``nu`` defaults to zeros and ``diag_variance`` to 1e-4 (the
        reference's init), both [M, 1]."""
        dtype = default_float() if dtype is None else dtype
        device = resolve_device(device)
        z = _as_tensor(inducing_points, dtype, device)
        m = z.shape[0]
        if lengthscales is None:
            lengthscales = np.ones((z.shape[-1],))
        nu = torch.zeros((m, 1), dtype=dtype, device=device) if nu is None \
            else _as_tensor(nu, dtype, device)
        var = 1e-4 * torch.ones((m, 1), dtype=dtype, device=device) if diag_variance is None \
            else _as_tensor(diag_variance, dtype, device)
        return {
            "kernel": self.kernel.init_params(variance, lengthscales, dtype=dtype, device=device),
            "likelihood": self.likelihood.init_params(noise_variance, dtype=dtype, device=device),
            "inducing_points": z,
            "nu": nu,
            "raw_diag_variance": self._var_bijector.inverse(var),
        }

    def trainable_mask(self, params: Dict, trainable_inducing_points: bool = False,
                       trainable_pseudo_u: bool = False) -> Dict:
        """Everything trains but the inducing points (by default): ``nu`` is
        the free variational mean, so ``trainable_pseudo_u`` (accepted for a
        uniform interface) has nothing to free."""
        del trainable_pseudo_u

        def all_true(node):
            return {k: all_true(v) for k, v in node.items()} if isinstance(node, dict) else True

        mask = all_true(params)
        mask["inducing_points"] = trainable_inducing_points
        return mask

    def diag_variance(self, params: Dict) -> torch.Tensor:
        return self._var_bijector.forward(params["raw_diag_variance"])

    def _chol(self, kp, z, var):
        kmm = self.kernel.K(kp, z)  # jitter = 0
        return kmm, torch.linalg.cholesky(add_diagonal(kmm, var[:, 0]))

    def prior_kl(self, params: Dict) -> torch.Tensor:
        nu = params["nu"]
        var = self.diag_variance(params)
        kmm, chol = self._chol(params["kernel"], params["inducing_points"], var)
        quad = torch.sum(nu * (kmm @ nu))
        trace = torch.trace(torch.cholesky_solve(kmm, chol))
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol))) - torch.sum(torch.log(var))
        return 0.5 * (quad - trace + logdet)

    def _predict(self, kp, z, chol, nu, x_new, full_cov: bool):
        kmn = self.kernel.K(kp, z, x_new)  # [M, T]
        a = torch.linalg.solve_triangular(chol, kmn, upper=False)
        if full_cov:
            fvar = (self.kernel.K(kp, x_new) - a.T @ a)[None, ...]
        else:
            fvar = (self.kernel.K_diag(kp, x_new) - torch.sum(torch.square(a), dim=0))[:, None]
        return kmn.T @ nu, fvar

    def predict_f(self, params: Dict, x_new: torch.Tensor,
                  full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        kp, z = params["kernel"], params["inducing_points"]
        _kmm, chol = self._chol(kp, z, self.diag_variance(params))
        return self._predict(kp, z, chol, params["nu"], x_new, full_cov)

    # -- cached serving: the factor once per parameters -------------------------

    def posterior(self, params: Dict) -> CholPosterior:
        kp, z = params["kernel"], params["inducing_points"]
        _kmm, chol = self._chol(kp, z, self.diag_variance(params))
        return CholPosterior(kernel_params=kp, inducing_points=z, chol=chol, nu=params["nu"])

    def posterior_mean(self, post: CholPosterior, x_new: torch.Tensor) -> torch.Tensor:
        return self.kernel.K(post.kernel_params, post.inducing_points, x_new).T @ post.nu

    def posterior_predict(self, post: CholPosterior, x_new: torch.Tensor,
                          full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._predict(post.kernel_params, post.inducing_points, post.chol, post.nu,
                             x_new, full_cov)

    def elbo(self, params: Dict, data, key=None) -> torch.Tensor:
        """The minibatch ELBO (deterministic: ``key`` is ignored)."""
        del key
        x, y = data
        kl = self.prior_kl(params)
        f_mean, f_var = self.predict_f(params, x, full_cov=False)
        var_exp = self.likelihood.variational_expectations(params["likelihood"], f_mean, f_var, y)
        return torch.sum(var_exp) * minibatch_scale(self.num_data, x.shape[0], kl.dtype) - kl

    def training_loss(self, params: Dict, data, key=None) -> torch.Tensor:
        return -self.elbo(params, data, key)
