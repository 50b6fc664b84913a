"""Random Fourier features (port of ``cggp_tpu/ops/rff.py``): the sketch, the
preconditioner and prior samples.

Spectral sampling: for the squared-exponential kernel the spectral density
is a diagonal Gaussian with standard deviation ``1 / lengthscale``; for
Matern-nu/2 it is a multivariate Student-t, a Gaussian scaled by
``sqrt(nu / chi2(nu))``.  The feature map is ``Phi(x) = [cos(x theta^T),
sin(x theta^T)]`` of shape [N, 2L], and ``U = sqrt(variance / L) * Phi``
gives ``U U^T ~= K``.

Randomness comes from an explicit ``torch.Generator`` where JAX takes a
PRNG key.  torch's gamma sampler takes no generator, so ``chi2(nu)`` is
drawn as the sum of ``nu`` squared standard normals, exact for the integer
``nu`` of Matern 1/2, 3/2 and 5/2 (nu = 1, 3, 5).  The draws are the
port's own: the same generator seed does not give the JAX package's
frequencies.  :func:`rff_sample` draws theta first, then the [S, 2L]
weights, from the one generator (JAX splits its key into the two).
"""

from __future__ import annotations

from typing import Optional

import torch

from cggp_tpu_torch.ops.cg import SpectralPreconditioner
from cggp_tpu_torch.ops.kernels import Kernel, KernelParams

_SMOOTHNESS = {"matern12": 1, "matern32": 3, "matern52": 5}


def standard_normal(generator: torch.Generator, shape, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """``N(0, 1)`` draws of ``shape`` from ``generator`` (on its own
    device), returned on ``device`` in ``dtype``."""
    return torch.randn(tuple(shape), generator=generator, device=generator.device,
                       dtype=dtype).to(device)


def basis_theta_parameter(kernel: Kernel, params: KernelParams, num_bases: int,
                          generator: torch.Generator, ndim: Optional[int] = None) -> torch.Tensor:
    """``num_bases`` spectral frequencies theta [L, D] of a stationary
    kernel, drawn from ``generator`` (on its device) and returned on the
    lengthscales' device in their dtype."""
    lengthscales = kernel.lengthscales(params)
    if lengthscales.ndim == 0:
        if ndim is None:
            raise ValueError("Scalar lengthscale needs an explicit input dimension `ndim`")
        lengthscales = lengthscales.expand(ndim)
    scale = 1.0 / lengthscales
    dtype, dim = scale.dtype, scale.shape[-1]

    def normal(*shape):
        return standard_normal(generator, shape, dtype, scale.device)

    if kernel.name == "se":
        return normal(num_bases, dim) * scale[None, :]
    nu = _SMOOTHNESS.get(kernel.name)
    if nu is None:
        raise ValueError(f"RFF sampling not supported for kernel {kernel.name!r}")
    eps = normal(num_bases, dim) * scale[None, :]
    chi2 = torch.sum(torch.square(normal(num_bases, nu)), dim=-1)  # chi2(nu), nu integer
    return torch.sqrt(nu / chi2)[:, None] * eps


def basis_vectors(inputs: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """``Phi(x) = [cos(x theta^T), sin(x theta^T)]``: [N, D] x [L, D] -> [N, 2L]."""
    x_theta = inputs @ theta.T
    return torch.cat([torch.cos(x_theta), torch.sin(x_theta)], dim=-1)


def rff_basis(inputs: torch.Tensor, kernel: Kernel, params: KernelParams, num_bases: int,
              generator: torch.Generator) -> torch.Tensor:
    """Scaled feature matrix ``U`` [N, 2L] with ``U U^T ~= K(inputs, inputs)``."""
    theta = basis_theta_parameter(kernel, params, num_bases, generator, ndim=inputs.shape[-1])
    return basis_vectors(inputs, theta) * torch.sqrt(kernel.variance(params) / num_bases)


def rff_preconditioner(kernel: Kernel, params: KernelParams, z: torch.Tensor, lam: torch.Tensor,
                       num_bases: int, generator: torch.Generator) -> SpectralPreconditioner:
    """Low-rank RFF preconditioner for CG on ``K(Z, Z) + diag(lam)``: the
    exact inverse of ``U U^T + diag(lam)`` for ``U`` from
    :func:`rff_basis`, through the cancellation-free
    :class:`SpectralPreconditioner`.  A solver state, not a trainable:
    build it from detached inputs whenever the kernel or Z change."""
    factor = rff_basis(z, kernel, params, num_bases, generator)  # [M, 2L]
    return SpectralPreconditioner(factor, lam.reshape(-1))


def rff_sample(inputs: torch.Tensor, kernel: Kernel, params: KernelParams, num_bases: int,
               generator: torch.Generator, num_samples: int = 1) -> torch.Tensor:
    """Prior GP samples at ``inputs``: ``w @ U^T`` of shape [num_samples, N]
    for ``U`` from :func:`rff_basis` and ``w ~ N(0, I_{2L})``, both drawn
    from ``generator``, theta first."""
    bases = rff_basis(inputs, kernel, params, num_bases, generator)  # [N, 2L]
    weights = standard_normal(generator, (num_samples, bases.shape[-1]), bases.dtype,
                              bases.device)
    return weights @ bases.T
