"""Plain PyTorch reference of the CDGP objective and serving posterior.

What this computes, for a Matern-3/2 kernel with ARD lengthscales, a
Gaussian likelihood and a cluster inducing set ``(Z, u, counts)``:

* ``A = K(Z, Z) + diag(noise / counts)``;
* the ELBO of one batch ``(x, y)`` with trace probes ``T`` and log-det
  probes ``L`` ([M, P] each): ``N / B * sum E_q[log N(y | f, noise)] - KL``,
  ``KL = 0.5 (u' A^-1 K A^-1 u - tr_T(A^-1 K) + logdet_L - sum log lam)``,
  where ``tr_T(X) = sum(T * X T) / P`` and ``logdet_L`` is zero-valued with
  the gradient ``dA -> sum(A^-1 L * dA L) / P`` (the paper's "zero logdet");
* the predictive mean ``K(x, Z) A^-1 u`` and variance ``k(x, x) -
  K(x, Z) A^-1 K(Z, x)``;
* Adam (``optax.adam``'s update) on the raw (softplus-inverse) kernel
  variance, lengthscales and noise variance.

Every solve is exact (LU), every product through :func:`mm`.  At
``precision="float64"`` everything runs in float64.  ``precision="tf32"``
is the control: float32 with both operands of every product rounded to
TF32 (10 explicit mantissa bits) first, what the tensor cores compute when
TF32 is switched on.  Nothing here imports the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

POSITIVE_LOWER = 1e-6
LOG_2PI = math.log(2.0 * math.pi)
R2_FLOOR = 1e-36
PRECISIONS = ("float64", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; choose from {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to the nearest TF32 value (ties away from
    zero, as ``cvt.rna.tf32.f32``)."""
    bits = t.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return torch.matmul(round_tf32(a), round_tf32(b))
    return torch.matmul(a, b)


def positive(raw: torch.Tensor) -> torch.Tensor:
    """Softplus plus the lower bound, the parameters' constraint."""
    return torch.nn.functional.softplus(raw) + POSITIVE_LOWER


def positive_inverse(value: torch.Tensor) -> torch.Tensor:
    shifted = value - POSITIVE_LOWER
    return shifted + torch.log(-torch.expm1(-shifted))


def matern32(variance, lengthscales, x, z, precision: str) -> torch.Tensor:
    """``K(x, z)`` [N, M], distances as ``|x|^2 + |z|^2 - 2 x z'``."""
    xs, zs = x / lengthscales, z / lengthscales
    r2 = (torch.sum(xs * xs, dim=1, keepdim=True) + torch.sum(zs * zs, dim=1)[None, :]
          - 2.0 * mm(xs, zs.T, precision)).clamp_min(0.0)
    r = torch.sqrt(r2.clamp_min(R2_FLOOR))
    return variance * (1.0 + math.sqrt(3.0) * r) * torch.exp(-math.sqrt(3.0) * r)


def init_raw(kernel_variance, lengthscales, noise_variance, precision: str,
             device) -> Dict[str, torch.Tensor]:
    """Raw parameters from the constrained initial values."""
    dtype = dtype_of(precision)

    def raw(v):
        return positive_inverse(torch.as_tensor(v, device=device).to(dtype))

    return {"kernel_variance": raw(kernel_variance), "lengthscales": raw(lengthscales),
            "noise_variance": raw(noise_variance)}


def system(raw: Dict, z, counts, precision: str):
    variance, ell = positive(raw["kernel_variance"]), positive(raw["lengthscales"])
    noise = positive(raw["noise_variance"])
    kmm = matern32(variance, ell, z, z, precision)
    lam = noise / counts[:, 0]
    return variance, ell, noise, kmm, lam


def neg_elbo(raw: Dict, z, u, counts, x, y, trace_probes, logdet_probes, num_data: int,
             precision: str) -> torch.Tensor:
    """The training loss, minus the ELBO, in ``precision``; inputs are cast."""
    dtype = dtype_of(precision)
    z, u, counts, x, y, t, ld = (v.to(dtype) for v in (z, u, counts, x, y, trace_probes,
                                                        logdet_probes))
    variance, ell, noise, kmm, lam = system(raw, z, counts, precision)
    a = kmm + torch.diag(lam)
    kmn = matern32(variance, ell, z, x, precision)  # [M, B]
    p = t.shape[1]
    solved = torch.linalg.solve(a, torch.cat([u, t, ld, kmn], dim=1))
    inv_u, inv_t = solved[:, :1], solved[:, 1:1 + p]
    inv_ld, inv_kmn = solved[:, 1 + p:1 + 2 * p], solved[:, 1 + 2 * p:]
    trace = torch.sum(inv_t * mm(kmm, t, precision)) / p
    quad = torch.sum(mm(kmm, inv_u, precision) * inv_u)
    surrogate = torch.sum(inv_ld.detach() * mm(a, ld, precision)) / p
    logdet = surrogate - surrogate.detach()
    kl = 0.5 * (quad - trace + logdet - torch.sum(torch.log(lam)))
    f_mean = mm(kmn.T, inv_u, precision)
    f_var = (variance - torch.sum(kmn * inv_kmn, dim=0))[:, None]
    var_exp = -0.5 * (LOG_2PI + torch.log(noise) + ((y - f_mean) ** 2 + f_var) / noise)
    return -(torch.sum(var_exp) * (num_data / x.shape[0]) - kl)


def adam_trajectory(raw: Dict, batches, z, u, counts, num_data: int, lr: float,
                    precision: str, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Adam from ``raw`` over ``batches`` of ``(x, y, trace_probes,
    logdet_probes)``; yields ``(loss, gradients, parameters after the
    step)`` step by step."""
    params = {k: v.detach().clone() for k, v in raw.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    for count, (x, y, t, ld) in enumerate(batches, start=1):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = neg_elbo(live, z, u, counts, x, y, t, ld, num_data, precision)
        grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
        for k, g in grads.items():
            mu[k] = (1 - b1) * g + b1 * mu[k]
            nu[k] = (1 - b2) * g * g + b2 * nu[k]
            m_hat = mu[k] / (1.0 - b1 ** count)
            v_hat = nu[k] / (1.0 - b2 ** count)
            params[k] = params[k] - lr * m_hat / (torch.sqrt(v_hat) + eps)
        yield float(loss.detach()), {k: g.detach() for k, g in grads.items()}, params


def adam_steps(raw: Dict, batches: Sequence, z, u, counts, num_data: int, lr: float,
               precision: str):
    """Adam from ``raw`` over ``batches``; returns the losses, the first
    step's gradients and the parameters after the last step."""
    losses, first_grads, params = [], None, raw
    for loss, grads, params in adam_trajectory(raw, batches, z, u, counts, num_data, lr,
                                               precision):
        losses.append(loss)
        first_grads = grads if first_grads is None else first_grads
    return losses, first_grads, params


def predict(raw: Dict, z, u, counts, x, precision: str, block: int = 16384):
    """Predictive mean [T, 1] and variance [T, 1] at ``x``, in row blocks."""
    dtype = dtype_of(precision)
    z, u, counts = (v.to(dtype) for v in (z, u, counts))
    with torch.no_grad():
        variance, ell, _noise, kmm, lam = system(raw, z, counts, precision)
        lu = torch.linalg.lu_factor(kmm + torch.diag(lam))
        nu = torch.linalg.lu_solve(*lu, u)
        means, variances = [], []
        for s in range(0, x.shape[0], block):
            kmn = matern32(variance, ell, z, x[s:s + block].to(dtype), precision)
            inv_kmn = torch.linalg.lu_solve(*lu, kmn)
            means.append(mm(kmn.T, nu, precision))
            variances.append((variance - torch.sum(kmn * inv_kmn, dim=0))[:, None])
    return torch.cat(means), torch.cat(variances)
