"""OIPS, greedy max-variance and uniform selection (port of
``cggp_tpu/selection/points.py``).

Each is a loop over a fixed budget on the inputs' device with fixed-size
buffers, as the JAX package's ``lax.fori_loop``s are; nothing is read back
to the host inside a loop.

* :func:`oips` scans the points in order and accepts point i when
  ``max_j k(x_i, Z_j) < rho * k(x_i, x_i)``; the accepted count is read once
  at the end to trim the buffer.
* :func:`greedy_selection` is the conditional-variance greedy rule with a
  partial-Cholesky row buffer, over a random permutation of the points.
* :func:`uniform` takes a subset without replacement.

Random permutations come from :func:`permutation` on a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cggp_tpu_torch.ops.kernels import Kernel


def permutation(key: torch.Generator, n: int) -> torch.Tensor:
    """A random permutation of ``range(n)`` (int64) on the generator's device."""
    return torch.randperm(n, generator=key, device=key.device)


def oips(kernel: Kernel, params, inputs: torch.Tensor, rho: float,
         max_points: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online inducing-point selection; returns ``(Z [m, D], indices [m])``.

    Point-at-a-time, so N small steps on the device: meant for selections
    at update time, not for the data sizes the cover tree handles."""
    n = inputs.shape[0]
    max_points = int(max_points)
    device = inputs.device
    kxx = kernel.K_diag(params, inputs)
    start = torch.argmax(kxx)
    z_idx = torch.zeros(max_points, dtype=torch.int64, device=device)
    z_idx[0] = start
    count = torch.ones((), dtype=torch.int64, device=device)
    slots = torch.arange(max_points, device=device)
    neg_inf = torch.full((), float("-inf"), dtype=inputs.dtype, device=device)
    with torch.no_grad():
        for i in range(n):
            k_row = kernel.K(params, inputs[i:i + 1], inputs[z_idx])[0]
            weight = torch.max(torch.where(slots < count, k_row, neg_inf))
            accept = (weight < rho * kxx[i]) & (count < max_points) & (start != i)
            slot = torch.clamp(count, max=max_points - 1)
            z_idx = torch.where(accept & (slots == slot), torch.full_like(z_idx, i), z_idx)
            count = count + accept.to(count.dtype)
    indices = z_idx[:int(count)]
    return inputs[indices], indices


def greedy_selection(kernel: Kernel, params, inputs: torch.Tensor, max_points: int,
                     key: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy conditional-variance selection; returns ``(Z, indices)``.
    A picked index is excluded from every later pick (its residual set to
    -inf), so no point is chosen twice once the residuals reach rounding
    noise."""
    n = inputs.shape[0]
    m = min(int(max_points), n)
    perm = permutation(key, n).to(inputs.device)
    x = inputs[perm]
    di = kernel.K_diag(params, x).clone()
    ci = torch.zeros((m, n), dtype=x.dtype, device=x.device)
    inds = torch.zeros(m, dtype=torch.int64, device=x.device)
    inds[0] = torch.argmax(di)
    with torch.no_grad():
        for t in range(1, m):
            j = inds[t - 1]
            dj = torch.sqrt(torch.clamp(di[j], min=1e-36))
            cj = ci[:, j]  # rows >= t are zero, so the product is exact
            k_col = kernel.K(params, x, x[j][None, :])[:, 0]
            ei = (k_col - ci.T @ cj) / dj
            ci[t - 1] = ei
            di = di - ei * ei
            di[j] = float("-inf")
            inds[t] = torch.argmax(di)
    picked = perm[inds]
    return inputs[picked], picked


def uniform(inputs: torch.Tensor, max_points: int,
            key: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """A uniform subset without replacement: the first ``max_points`` of a
    random permutation."""
    indices = permutation(key, inputs.shape[0])[:int(max_points)].to(inputs.device)
    return inputs[indices], indices
