"""CGGP (CLI name "cdgp") — ClusterGP with the Cholesky replaced by CG
(port of ``cggp_tpu/models/cggp.py``, serving slice).

The injected :class:`ConjugateGradient` solves ``(Kmm + Lambda)^{-1} u`` and
``(Kmm + Lambda)^{-1} Kmn``; ``Kmm`` is built with jitter 0 — conditioning
comes from ``Lambda = noise / counts``.

This slice serves: :meth:`CGGP.predict_f` (uncached, one fused CG solve),
:meth:`CGGP.posterior` with ``solver="cg"`` or ``"chol"``,
:meth:`posterior_mean` and :meth:`posterior_predict`.  Training
(the fused ELBO and its probes), preconditioning, capacity padding and the
``"auto"``/``"lanczos"`` serving solvers raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from cggp_tpu_torch.models.clustergp import ClusterGP
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.ops.linalg import add_diagonal


@dataclasses.dataclass(frozen=True)
class CGGP(ClusterGP):
    """CG-powered ClusterGP; ``conjugate_gradient`` is the pluggable solver."""

    conjugate_gradient: ConjugateGradient = None  # type: ignore[assignment]
    precondition: Optional[str] = None

    def __post_init__(self):
        if self.conjugate_gradient is None:
            raise ValueError("CGGP requires a ConjugateGradient instance")
        if self.precondition is not None:
            raise NotImplementedError(
                f"precondition={self.precondition!r}: preconditioned CG arrives "
                "with the training slice of the port; use precondition=None")

    def init_params(self, inducing_points, pseudo_u=None, cluster_counts=None,
                    capacity: Optional[int] = None, **kwargs) -> Dict:
        if capacity is not None:
            raise NotImplementedError(
                "capacity padding (inducing_mask) arrives with the training "
                "slice of the port")
        return super().init_params(inducing_points, pseudo_u=pseudo_u,
                                   cluster_counts=cluster_counts, **kwargs)

    def predict_f(self, params: Dict, x_new: torch.Tensor,
                  full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uncached prediction: ``[u | Kmn]`` solved in one row-block CG."""
        kp = params["kernel"]
        z = params["inducing_points"]
        u = params["pseudo_u"]
        kmn = self.kernel.K(kp, z, x_new)  # [M, T]
        kmm_lambda = add_diagonal(self.kernel.K(kp, z), self.diag_variance(params)[:, 0])
        solved = self.conjugate_gradient(kmm_lambda, torch.cat([u, kmn], dim=-1))
        p_out = u.shape[-1]  # multi-output pseudo_u contributes P columns
        inv_u, inv_kmn = solved[:, :p_out], solved[:, p_out:]
        if full_cov:
            knn = self.kernel.K(kp, x_new)
            fvar = (knn - kmn.T @ inv_kmn)[None, ...]
        else:
            knn = self.kernel.K_diag(kp, x_new)
            fvar = (knn - torch.sum(kmn * inv_kmn, dim=0))[:, None]
        return kmn.T @ inv_u, fvar

    def posterior(self, params: Dict, solver: str = "auto") -> "CGGPPosterior":
        """Everything that depends only on ``params``: ``nu = (Kmm +
        Lambda)^{-1} u`` and either the system matrix (``solver="cg"``: each
        batch solves its ``Kmn`` block by CG) or its Cholesky factor
        (``solver="chol"``: two triangular solves per batch).

        A failed factorization leaves a NaN factor, as ``jnp.linalg.cholesky``
        does, so the serving guard in ``predict_in_batches`` can report it."""
        if solver not in ("auto", "chol", "cg", "lanczos"):
            raise ValueError(f"unknown posterior solver: {solver!r}")
        if solver in ("auto", "lanczos"):
            raise NotImplementedError(
                f"posterior(solver={solver!r}) needs the Lanczos estimates of a "
                "later slice of the port; pass solver='cg' or 'chol'")
        kp = params["kernel"]
        z = params["inducing_points"]
        u = params["pseudo_u"]
        kmm_lambda = add_diagonal(self.kernel.K(kp, z), self.diag_variance(params)[:, 0])
        if solver == "chol":
            chol, info = torch.linalg.cholesky_ex(kmm_lambda)
            chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
            nu = torch.cholesky_solve(u, chol)
            return CGGPPosterior(kernel_params=kp, inducing_points=z, kmm_lambda=None,
                                 nu=nu, chol=chol)
        nu = self.conjugate_gradient(kmm_lambda, u)
        return CGGPPosterior(kernel_params=kp, inducing_points=z, kmm_lambda=kmm_lambda,
                             nu=nu, chol=None)

    def posterior_mean(self, post: "CGGPPosterior", x_new: torch.Tensor) -> torch.Tensor:
        """CG-free serving mean: ``K(x, Z) @ nu``."""
        kmn = self.kernel.K(post.kernel_params, post.inducing_points, x_new)
        return kmn.T @ post.nu

    def posterior_predict(self, post: "CGGPPosterior", x_new: torch.Tensor,
                          full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and variance from the cache: the [M, T] ``Kmn`` block through
        two triangular solves (``"chol"``) or one CG solve (``"cg"``)."""
        kp = post.kernel_params
        kmn = self.kernel.K(kp, post.inducing_points, x_new)  # [M, T]
        if post.chol is not None:
            inv_kmn = torch.cholesky_solve(kmn, post.chol)
        else:
            inv_kmn = self.conjugate_gradient(post.kmm_lambda, kmn)
        if full_cov:
            knn = self.kernel.K(kp, x_new)
            fvar = (knn - kmn.T @ inv_kmn)[None, ...]
        else:
            knn = self.kernel.K_diag(kp, x_new)
            fvar = (knn - torch.sum(kmn * inv_kmn, dim=0))[:, None]
        return kmn.T @ post.nu, fvar


class CGGPPosterior(NamedTuple):
    """Serving cache produced by :meth:`CGGP.posterior`."""

    kernel_params: Dict
    inducing_points: torch.Tensor
    kmm_lambda: Optional[torch.Tensor]  # [M, M] = Kmm + diag(Lambda); None on chol
    nu: torch.Tensor  # [M, 1] = (Kmm + Lambda)^{-1} pseudo_u
    chol: Optional[torch.Tensor] = None  # [M, M] lower Cholesky of Kmm + Lambda
