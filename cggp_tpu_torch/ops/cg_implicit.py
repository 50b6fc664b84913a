"""Matrix-free CG on ``Kuu + diag(lam)``: the Gram matrix never exists (port
of ``cggp_tpu/ops/cg_implicit.py``, forward solve).

* :func:`blocked_kuu_matvec` — the plain route: a loop over [block, M]
  kernel panels, each contracted with ``torch.matmul``; peak extra memory
  one panel.
* ``use_pallas=True`` — every solve matvec through kernel B3
  (:func:`cggp_tpu_torch.ops.pallas_gram.kuu_matvec`).
* :func:`pivoted_cholesky_kernel` — the preconditioner factor from one
  kernel row per pivot.

Gradients through the solve (the JAX custom backward: a second
matrix-free solve plus one VJP of the blocked matvec) arrive with the
matrix-free training slice; :func:`make_implicit_cg`'s solve raises
``NotImplementedError`` when asked to differentiate.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cggp_tpu_torch.ops.cg import CGStats, cg_loop, precond_apply_or_identity
from cggp_tpu_torch.ops.kernels import Kernel
from cggp_tpu_torch.ops.linalg import pivoted_cholesky_matfree
from cggp_tpu_torch.ops.pallas_gram import kuu_matvec


def pad_inducing(z: torch.Tensor, lam: torch.Tensor, multiple: int,
                 *rhs_arrays: torch.Tensor) -> Tuple:
    """Pad ``(Z, lam, rhs...)`` so M divides ``multiple``.

    Pads sit at ``1e6 * (1 + k)`` in every coordinate, so their kernel
    values against real points underflow to 0; lam pads are 1 and rhs pads
    0.  The inducing mask, not the placement, keeps pads exactly decoupled
    (:func:`blocked_kuu_matvec`)."""
    m = z.shape[0]
    rem = (-m) % multiple
    if rem == 0:
        return (z, lam, *rhs_arrays)
    far = 1.0e6 * (1.0 + torch.arange(1, rem + 1, dtype=z.dtype, device=z.device))[:, None]
    z_pad = torch.cat([z, far.expand(rem, z.shape[-1])], dim=0)
    lam_pad = torch.cat([lam.reshape(-1), torch.ones((rem,), dtype=lam.dtype, device=lam.device)])
    padded_rhs = tuple(
        torch.cat([r, torch.zeros((*r.shape[:-1], rem), dtype=r.dtype, device=r.device)], dim=-1)
        for r in rhs_arrays)
    return (z_pad, lam_pad, *padded_rhs)


def pivoted_cholesky_kernel(kernel: Kernel, kp, z: torch.Tensor, rank: int,
                            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Matrix-free pivoted-Cholesky factor ``[M, rank]`` of ``K(Z, Z)``: each
    step evaluates one kernel row.  ``mask`` (1 real / 0 pad) zeroes pad
    entries of the pivot diagonal and of each row, so no column is spent on
    a pad."""
    if mask is not None:
        mask = mask.reshape(-1)

    def row_fn(pivot):
        row = kernel.K(kp, z.index_select(0, pivot), z)[0]
        return row if mask is None else row * mask

    diag = kernel.K_diag(kp, z)
    diag = diag.clone() if mask is None else diag * mask
    return pivoted_cholesky_matfree(row_fn, diag, rank)


def blocked_kuu_matvec(kernel: Kernel, kp, z: torch.Tensor, lam: torch.Tensor,
                       p: torch.Tensor, block: int = 2048,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``p @ (K(Z,Z) + diag(lam))`` over [block, M] row panels; ``p`` is
    [R, M].  M must be a multiple of ``block`` or at most ``block``.
    ``mask`` (1 real / 0 pad) zeroes the kernel coupling of pad rows and
    columns before the diagonal add, so the padded system is exactly
    block-diagonal."""
    m = z.shape[0]
    lam = lam.reshape(-1)
    if mask is not None:
        mask = mask.reshape(-1)
    if m <= block:
        a = kernel.K(kp, z)
        if mask is not None:
            a = a * (mask[:, None] * mask[None, :])
        return torch.matmul(p, a) + p * lam[None, :]
    if m % block:
        raise ValueError(f"M = {m} is not a multiple of block = {block}")
    out = torch.zeros_like(p)
    for start in range(0, m, block):
        a_rows = kernel.K(kp, z[start:start + block], z)  # [block, M] on the fly
        if mask is not None:
            a_rows = a_rows * (mask[start:start + block, None] * mask[None, :])
        out = out + torch.matmul(p[:, start:start + block], a_rows)
    return out + p * lam[None, :]


def _requires_grad(*items) -> bool:
    tensors = []
    for item in items:
        if isinstance(item, dict):
            tensors.extend(item.values())
        elif isinstance(item, (tuple, list)):
            tensors.extend(item)
        elif item is not None:
            tensors.append(item)
    return any(t.requires_grad for t in tensors)


def make_implicit_cg(kernel: Kernel, error_threshold: float, max_iterations: int,
                     max_steps_cycle: Optional[int] = None, block: int = 2048,
                     use_pallas: bool = False, relative_threshold: bool = False):
    """Build ``solve(kp, z, lam, rhs [R, M], precond_state=(), mask=None) ->
    (solution, CGStats)``.

    ``use_pallas=True`` runs every solve matvec through kernel B3 in
    float32 (cast back to the caller's dtype, as the JAX route does); else
    :func:`blocked_kuu_matvec`.  B3 is unmasked; a mask composes around it
    exactly (mask in {0, 1}):

        masked(p) = mask * kuu_matvec(p * mask) + p * lam * (1 - mask)

    — premasking kills pad columns, postmasking kills pad rows (including
    each pad's kernel diagonal), and the last term restores the pads' lam.
    The pads' far placement only keeps their kernel values finite."""
    if max_steps_cycle is None:
        max_steps_cycle = max_iterations + 1

    def make_matvec(kp, z, lam, mask):
        if not use_pallas:
            return lambda p: blocked_kuu_matvec(kernel, kp, z, lam, p, block=block, mask=mask)
        # Hoisted out of the loop: the scaled points, lam and the variance
        # stay on the device for every step.
        z32 = (z / kernel.lengthscales(kp)).to(torch.float32).contiguous()
        lam_flat = lam.reshape(-1)
        lam32 = lam_flat.to(torch.float32).contiguous()
        var32 = kernel.variance(kp).to(torch.float32).reshape(1).contiguous()

        def fused(p):
            return kuu_matvec(z32, lam32, p.to(torch.float32).contiguous(), var32,
                              kernel.name).to(p.dtype)

        if mask is None:
            return fused
        pad_lam = (lam_flat * (1.0 - mask))[None, :]
        return lambda p: fused(p * mask[None, :]) * mask[None, :] + p * pad_lam

    def solve(kp, z, lam, rhs, precond_state=(), mask=None) -> Tuple[torch.Tensor, CGStats]:
        if torch.is_grad_enabled() and _requires_grad(kp, z, lam, rhs, precond_state):
            raise NotImplementedError(
                "gradients through the matrix-free CG solve (its custom backward "
                "pass) arrive with the matrix-free training slice of the port; call under "
                "torch.no_grad()")
        if mask is not None:
            mask = mask.reshape(-1)
        return cg_loop(make_matvec(kp, z, lam, mask), precond_apply_or_identity,
                       precond_state, rhs, torch.zeros_like(rhs),
                       error_threshold=error_threshold, max_iterations=max_iterations,
                       max_steps_cycle=max_steps_cycle, relative_threshold=relative_threshold)

    return solve
