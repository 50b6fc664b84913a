"""PathwiseClusterGP — the pathwise (Matheron) sampling ELBO, and the
pathwise serving cache (port of ``cggp_tpu/models/pathwise.py``).

Prior samples at ``[X; Z]`` come from random Fourier features, the noise
``eps ~ N(0, Lambda)`` is drawn per sample, the pathwise weights are
``(Kzz + Lambda)^-1 (u - f_z - eps)`` and a posterior sample is the prior
plus ``Kzx^T weights``; the likelihood term is a Monte-Carlo Gaussian
log-density.

Randomness comes from one ``torch.Generator`` where JAX takes a key, drawn
in one fixed order by both the per-call sampler and the cache: the
frequencies theta, then the [S, 2L] basis weights w, then the [S, M, 1]
noise eps.  So for the same generator state the cache holds the same
functions :meth:`PathwiseClusterGP.pathwise_samples` samples.  The draws
go through ``ops.rff.basis_theta_parameter`` and ``ops.rff.standard_normal``,
looked up when a call runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

from cggp_tpu_torch.models.base import minibatch_scale
from cggp_tpu_torch.models.clustergp import ClusterGP
from cggp_tpu_torch.ops import rff as rff_ops
from cggp_tpu_torch.ops.linalg import add_diagonal, pad_rows_to_blocks


class PathwisePosterior(NamedTuple):
    """Serving cache of ``num_samples`` posterior function draws, each
    ``f_s(x) = Phi(x) w_s + k(x, Z) weights_s``: evaluable at any points by
    two skinny products, with no solve.  The JAX package's fields in its
    order:

    - ``theta`` [L, D]: the RFF prior's frequencies
    - ``w`` [S, 2L]: each sample's basis weights
    - ``basis_scale``: 0-d ``sqrt(kernel_variance / L)``
    - ``weights`` [S, M]: the pathwise correction weights
    - ``inducing_mask`` [M] or None: capacity padding (pad rows carry zero
      weight, so a padded cache serves like the unpadded one)
    """

    kernel_params: Dict
    inducing_points: torch.Tensor  # [M, D]
    theta: torch.Tensor  # [L, D]
    w: torch.Tensor  # [S, 2L]
    basis_scale: torch.Tensor  # 0-d
    weights: torch.Tensor  # [S, M]
    inducing_mask: Optional[torch.Tensor] = None


def _noise(generator: torch.Generator, lambda_diag: torch.Tensor, num_samples: int):
    """``eps ~ N(0, Lambda)``, one [M] draw per sample, as [S, M, 1]."""
    normal = rff_ops.standard_normal(generator, (num_samples, lambda_diag.shape[0], 1),
                                     lambda_diag.dtype, lambda_diag.device)
    return torch.sqrt(lambda_diag)[None, :, None] * normal


def build_pathwise_posterior(model, params: Dict, key: torch.Generator, num_bases: int = 512,
                             num_samples: int = 8, solver: str = "chol") -> PathwisePosterior:
    """A :class:`PathwisePosterior` for any ClusterGP-family model
    (``PathwiseClusterGP``, ``ClusterGP``, ``CGGP``): one prior evaluation
    at Z and one solve of ``Kzz + Lambda`` against all ``num_samples``
    right-hand sides, drawn from ``key`` as ``pathwise_samples`` draws.

    ``solver="chol"`` factorises once; ``"cg"`` runs the batched solve
    through the model's own CG (``model.conjugate_gradient``, so on its
    ``matvec_impl`` route) under ``model._build_preconditioner`` (the
    ``"rff"`` sketch from a generator seeded 0)."""
    if solver not in ("chol", "cg"):
        raise ValueError(f"unknown pathwise posterior solver: {solver!r}")
    kp = params["kernel"]
    z = params["inducing_points"]
    u = params["pseudo_u"]
    if u.ndim != 2 or u.shape[1] != 1:
        # The cache keeps one weight row per sample ([S, M]): a multi-output
        # pseudo_u [M, P > 1] would broadcast u.T [P, M] against the [S, M]
        # prior draws and mix outputs across samples.
        raise ValueError("build_pathwise_posterior supports single-output pseudo_u [M, 1]; "
                         f"got {tuple(u.shape)}. Use pathwise_samples for multi-output.")
    lambda_diag = model.diag_variance(params)[:, 0]
    mask_of = getattr(model, "_mask_of", None)
    mask = mask_of(params) if mask_of is not None else None

    theta = rff_ops.basis_theta_parameter(model.kernel, kp, num_bases, key, ndim=z.shape[-1])
    basis_scale = torch.sqrt(model.kernel.variance(kp) / num_bases)
    w = rff_ops.standard_normal(key, (num_samples, 2 * num_bases), z.dtype, z.device)
    eps = _noise(key, lambda_diag, num_samples)[..., 0]

    prior_fz = w @ (rff_ops.basis_vectors(z, theta) * basis_scale).T  # [S, M]
    b = u.T - prior_fz - eps  # [S, M]
    if mask is not None:
        b = b * mask[None, :]
        kzz = model._masked_kmm(kp, z, mask)
    else:
        kzz = model.kernel.K(kp, z)  # jitter = 0
    kzz_lambda = add_diagonal(kzz, lambda_diag)
    if solver == "cg":
        cg = getattr(model, "conjugate_gradient", None)
        if cg is None:
            raise ValueError("solver='cg' needs a CG-powered model (CGGP); "
                             f"{type(model).__name__} has no conjugate_gradient")
        build_precond = getattr(model, "_build_preconditioner", None)
        precond = None if build_precond is None else build_precond(
            kp, z, kzz, lambda_diag[:, None])
        weights = cg(kzz_lambda, b.T, preconditioner=precond).T  # [S, M]
    else:
        weights = torch.cholesky_solve(b.T, torch.linalg.cholesky(kzz_lambda)).T  # [S, M]
    if mask is not None:
        weights = weights * mask[None, :]
    return PathwisePosterior(kernel_params=kp, inducing_points=z, theta=theta, w=w,
                             basis_scale=basis_scale, weights=weights, inducing_mask=mask)


def pathwise_samples_at(model, post: PathwisePosterior, x_new: torch.Tensor) -> torch.Tensor:
    """The cached posterior function samples at ``x_new``: [S, B, 1], the
    prior ``Phi(x) w^T`` plus the correction ``weights @ K(Z, x)``."""
    phi = rff_ops.basis_vectors(x_new, post.theta) * post.basis_scale  # [B, 2L]
    prior = post.w @ phi.T  # [S, B]
    if post.inducing_mask is not None:
        kmn = model._masked_kmn(post.kernel_params, post.inducing_points, x_new,
                                post.inducing_mask)
    else:
        kmn = model.kernel.K(post.kernel_params, post.inducing_points, x_new)
    return (prior + post.weights @ kmn)[..., None]


def pathwise_samples_scan(model, post: PathwisePosterior, x: torch.Tensor,
                          batch_size: int = 8192) -> torch.Tensor:
    """The samples over a whole dataset: the fixed-size row blocks of
    :func:`~cggp_tpu_torch.ops.linalg.pad_rows_to_blocks`, each through
    :func:`pathwise_samples_at`, stacked on the device with no host read
    between blocks (the JAX package's ``lax.map`` sweep).  [S, N, 1]."""
    n = x.shape[0]
    blocks = pad_rows_to_blocks(x, min(int(batch_size), n))
    out = torch.stack([pathwise_samples_at(model, post, xb) for xb in blocks])
    out = out.movedim(0, 1).reshape(out.shape[1], -1, out.shape[-1])  # [S, blocks * B, 1]
    return out[:, :n]


@dataclasses.dataclass(frozen=True)
class PathwiseClusterGP(ClusterGP):
    num_bases: int = 512
    num_samples: int = 8

    def pathwise_samples(self, params: Dict, sample_at: torch.Tensor, key: torch.Generator,
                         num_bases: Optional[int] = None,
                         num_samples: Optional[int] = None) -> torch.Tensor:
        """Posterior samples at ``sample_at``: [S, N, 1], with a fresh prior
        and one Cholesky factor of ``Kzz + Lambda`` per call."""
        num_bases = num_bases or self.num_bases
        num_samples = num_samples or self.num_samples
        kp = params["kernel"]
        z = params["inducing_points"]
        u = params["pseudo_u"]
        lambda_diag = self.diag_variance(params)[:, 0]

        n = sample_at.shape[0]
        prior = rff_ops.rff_sample(torch.cat([sample_at, z], dim=0), self.kernel, kp,
                                   num_bases, key, num_samples=num_samples)[..., None]
        prior_fx, prior_fz = prior[:, :n], prior[:, n:]  # [S, N, 1], [S, M, 1]
        eps = _noise(key, lambda_diag, num_samples)

        kzz = self.kernel.K(kp, z)  # jitter = 0
        kzx = self.kernel.K(kp, z, sample_at)  # [M, N]
        chol = torch.linalg.cholesky(add_diagonal(kzz, lambda_diag))
        solve_against = (u[None, ...] - prior_fz - eps)  # [S, M, P]
        weights = torch.cholesky_solve(solve_against, chol)  # [S, M, P]
        return prior_fx + torch.einsum("mn,smo->sno", kzx, weights)

    def pathwise_posterior(self, params: Dict, key: torch.Generator,
                           num_bases: Optional[int] = None, num_samples: Optional[int] = None,
                           solver: str = "chol") -> PathwisePosterior:
        """The serving cache of :func:`build_pathwise_posterior`."""
        return build_pathwise_posterior(self, params, key,
                                        num_bases=num_bases or self.num_bases,
                                        num_samples=num_samples or self.num_samples,
                                        solver=solver)

    def compute_likelihood_term(self, params: Dict, data, key: torch.Generator,
                                num_bases: Optional[int] = None,
                                num_samples: Optional[int] = None) -> torch.Tensor:
        x, y = data
        num_samples = num_samples or self.num_samples
        samples = self.pathwise_samples(params, x, key, num_bases, num_samples)
        noise = self.likelihood.variance(params["likelihood"])
        lik = torch.sum(torch.square(y[None, ...] - samples)) / (noise * num_samples)
        const = y.shape[0] * torch.log(2.0 * math.pi * noise)
        return -0.5 * (lik + const)

    def elbo(self, params: Dict, data, key: Optional[torch.Generator] = None) -> torch.Tensor:
        if key is None:
            raise ValueError("PathwiseClusterGP.elbo requires a generator (key) for its samples")
        x, _ = data
        kl = self.prior_kl(params)  # the Cholesky KL of ClusterGP
        likelihood = self.compute_likelihood_term(params, data, key)
        return likelihood * minibatch_scale(self.num_data, x.shape[0], kl.dtype) - kl

    def training_loss(self, params: Dict, data,
                      key: Optional[torch.Generator] = None) -> torch.Tensor:
        return -self.elbo(params, data, key)
