"""Matrix-free CG on ``Kuu + diag(lam)``: the Gram matrix never exists (port
of ``cggp_tpu/ops/cg_implicit.py``).

* :func:`blocked_kuu_matvec` — the plain route: a loop over [block, M]
  kernel panels, each contracted with ``torch.matmul``; differentiable, and
  under autograd each panel is recomputed in the backward pass
  (``torch.utils.checkpoint``), so peak saved memory stays one panel.
* ``use_pallas=True`` — every solve matvec through kernel B3
  (:func:`cggp_tpu_torch.ops.pallas_gram.kuu_matvec`).
* :func:`pivoted_cholesky_kernel` — the preconditioner factor from one
  kernel row per pivot; :func:`kernel_precond_state` — the spectral
  preconditioner state from it or from an RFF sketch.
* :func:`make_implicit_cg` — the solve with JAX's custom backward pass
  (:class:`_ImplicitSolve`): a second matrix-free solve of the cotangent on
  the same route (B3 included) under the same preconditioner state, then
  one VJP of :func:`blocked_kuu_matvec` at the solution,

      kp_bar, z_bar, lam_bar = -vjp((kp, z, lam) -> solution @ A)(w),  b_bar = w.

  The VJP is plain torch on every route, as in JAX (no kernel computes it).
  Every solve, forward or backward, runs through :func:`_implicit_cg_impl`,
  looked up by name, and is a ``cggp.cg.solve`` span while tracing is on
  (:mod:`cggp_tpu_torch.tracing`); the VJP is a ``cggp.cg.vjp`` span.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from cggp_tpu_torch import tracing
from cggp_tpu_torch.ops.cg import (CGStats, cg_loop, precond_apply_or_identity,
                                   agreed_stop_of, current_agreement,
                                   spectral_precond_state)
from cggp_tpu_torch.ops.kernels import Kernel
from cggp_tpu_torch.ops.linalg import pivoted_cholesky_matfree
from cggp_tpu_torch.ops.pallas_gram import kuu_matvec
from cggp_tpu_torch.ops.rff import rff_basis


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


def kernel_precond_state(kernel: Kernel, kp, z: torch.Tensor, lam: torch.Tensor,
                         mask: Optional[torch.Tensor], precondition: Optional[str],
                         rank: int, seed: int = 0):
    """The solver state of ``K(Z, Z) + diag(lam)``'s spectral preconditioner,
    built from detached inputs (it changes step counts, never solutions or
    gradients); ``()`` is the identity.  ``"pivchol"`` factors ``K(Z, Z)``
    with :func:`pivoted_cholesky_kernel` (masked: no column is spent on a
    pad); ``"rff"`` sketches it with ``rank`` random-Fourier bases drawn from
    a generator seeded ``seed``, the pad rows zeroed (they sit at huge
    coordinates where cos/sin are not small)."""
    if precondition is None:
        return ()
    with torch.no_grad(), tracing.span("cggp.precond.build", z.device, m=int(z.shape[0]),
                                       mode=precondition, rank=int(rank)):
        kp, z, lam = {k: v.detach() for k, v in kp.items()}, z.detach(), lam.detach()
        if mask is not None:
            mask = mask.detach().reshape(-1)
        if precondition == "pivchol":
            factor = pivoted_cholesky_kernel(kernel, kp, z, rank, mask=mask)
        elif precondition == "rff":
            gen = torch.Generator(device=z.device).manual_seed(int(seed))
            factor = rff_basis(z, kernel, kp, rank, gen)  # [M, 2L]
            if mask is not None:
                factor = factor * mask[:, None]
        else:
            raise ValueError(f"unknown precondition mode: {precondition!r}")
        return spectral_precond_state(factor, lam)


def _kuu_panel(kernel: Kernel, kp, z: torch.Tensor, mask: Optional[torch.Tensor],
               z_blk: torch.Tensor, p_blk: torch.Tensor,
               mask_blk: Optional[torch.Tensor]) -> torch.Tensor:
    """One panel's share ``p_blk @ K(z_blk, Z)`` (masked), [R, M]."""
    a_rows = kernel.K(kp, z_blk, z)  # [block, M] on the fly
    if mask is not None:
        a_rows = a_rows * (mask_blk[:, None] * mask[None, :])
    return torch.matmul(p_blk, a_rows)


def blocked_kuu_matvec(kernel: Kernel, kp, z: torch.Tensor, lam: torch.Tensor,
                       p: torch.Tensor, block: int = 2048,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``p @ (K(Z,Z) + diag(lam))`` over [block, M] row panels; ``p`` is
    [R, M].  M must be a multiple of ``block`` or at most ``block``.
    ``mask`` (1 real / 0 pad) zeroes the kernel coupling of pad rows and
    columns before the diagonal add, so the padded system is exactly
    block-diagonal.

    Differentiable in ``kp``, ``z``, ``lam`` and ``p``.  When autograd
    records, each panel runs under ``torch.utils.checkpoint``: the backward
    pass rebuilds it instead of keeping it, so the saved state is the
    inputs, not the [M, M] Gram matrix the panels add up to."""
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
    recorded = torch.is_grad_enabled() and any(
        t.requires_grad for t in (z, p, *kp.values()))
    out = torch.zeros_like(p)
    for start in range(0, m, block):
        args = (kernel, kp, z, mask, z[start:start + block], p[:, start:start + block],
                None if mask is None else mask[start:start + block])
        if recorded:
            out = out + checkpoint(_kuu_panel, *args, use_reentrant=False)
        else:
            out = out + _kuu_panel(*args)
    return out + p * lam[None, :]


def matvec_vjp(matvec, kp, z: torch.Tensor, lam: torch.Tensor, mask: Optional[torch.Tensor],
               rows: torch.Tensor, cotangent: torch.Tensor, needs: Tuple[bool, ...]):
    """The VJP of ``matvec(kp, z, lam, mask, rows)`` (``rows`` held
    constant) with ``cotangent``: ``(kp grads..., z grad, lam grad)`` in
    ``kp``'s order, ``None`` where ``needs`` (same order) is false and a
    zero tensor where the matvec does not reach an input."""
    live = [t.detach().requires_grad_(need) for t, need in zip((*kp.values(), z, lam), needs)]
    wanted = [t for t, need in zip(live, needs) if need]
    if not wanted:
        return (None,) * len(needs)
    with torch.enable_grad():
        kp_live = dict(zip(kp.keys(), live[:len(kp)]))
        out = matvec(kp_live, live[-2], live[-1], mask, rows.detach())
        grads = iter(torch.autograd.grad(out, wanted, grad_outputs=cotangent,
                                         allow_unused=True))
    result = []
    for t, need in zip(live, needs):
        g = next(grads) if need else None
        result.append(torch.zeros_like(t) if need and g is None else g)
    return tuple(result)


def _implicit_cg_impl(matvec, precond_state, rhs: torch.Tensor, error_threshold: float,
                      max_iterations: int, max_steps_cycle: int,
                      relative_threshold: bool) -> Tuple[torch.Tensor, CGStats]:
    """One matrix-free CG solve from ``v0 = 0``.  The forward and the
    backward solves of :func:`make_implicit_cg` both call it through this
    module's namespace; a ``cggp.cg.solve`` span while tracing is on."""
    if not tracing.ON:
        return _implicit_solve(matvec, precond_state, rhs, error_threshold, max_iterations,
                               max_steps_cycle, relative_threshold)
    with tracing.solve_span(rhs, rhs.shape[-1], "matrix-free") as span:
        solution, stats = _implicit_solve(matvec, precond_state, rhs, error_threshold,
                                          max_iterations, max_steps_cycle, relative_threshold)
        span.attrs["steps"] = stats.steps
    return solution, stats


def _implicit_solve(matvec, precond_state, rhs: torch.Tensor, error_threshold: float,
                    max_iterations: int, max_steps_cycle: int,
                    relative_threshold: bool) -> Tuple[torch.Tensor, CGStats]:
    return cg_loop(matvec, precond_apply_or_identity, precond_state, rhs, torch.zeros_like(rhs),
                   error_threshold=error_threshold, max_iterations=max_iterations,
                   max_steps_cycle=max_steps_cycle, relative_threshold=relative_threshold)


class _ImplicitSolve(torch.autograd.Function):
    """The matrix-free solve with JAX's custom backward (``cg_implicit.py``
    ``solve_bwd``): the cotangent solved again through ``solver.run`` (the
    same route and the same detached preconditioner state), then the VJP of
    the blocked matvec at the solution, negated; the panels are rebuilt one
    at a time, so no [M, M] buffer is held.  The kernel parameters
    come in as separate tensors after ``z`` and ``lam``; ``needs_input_grad``
    decides which gradients are built.  The mask and the preconditioner
    state get none; the stats are not differentiable."""

    @staticmethod
    def forward(ctx, solver, kp_names, mask, precond_state, rhs, z, lam, *kp_values):
        kp = dict(zip(kp_names, kp_values))
        solution, stats = solver.run(kp, z, lam, mask, rhs, precond_state)
        ctx.solver, ctx.kp_names, ctx.mask, ctx.precond_state = (solver, kp_names, mask,
                                                                  precond_state)
        ctx.agree = current_agreement()
        ctx.save_for_backward(solution, z, lam, *kp_values)
        ctx.mark_non_differentiable(stats.steps, stats.error, stats.converged)
        return solution, stats.steps, stats.error, stats.converged

    @staticmethod
    @once_differentiable
    def backward(ctx, dx, *_stat_grads):
        solution, z, lam, *kp_values = ctx.saved_tensors
        kp = dict(zip(ctx.kp_names, kp_values))
        solver = ctx.solver
        with agreed_stop_of(ctx.agree):
            w, _ = solver.run(kp, z, lam, ctx.mask, dx, ctx.precond_state)
        needs = (*ctx.needs_input_grad[7:], ctx.needs_input_grad[5], ctx.needs_input_grad[6])
        with tracing.span("cggp.cg.vjp", z.device, rows=int(solution.shape[-2]),
                          m=int(z.shape[0])):
            grads = matvec_vjp(solver.blocked, kp, z, lam, ctx.mask, solution, w, needs)
        kp_bar, z_bar, lam_bar = grads[:-2], grads[-2], grads[-1]
        neg = [None if g is None else -g for g in (z_bar, lam_bar, *kp_bar)]
        return (None, None, None, None, w if ctx.needs_input_grad[4] else None, *neg)


class _Solver:
    """A route of :func:`make_implicit_cg`: the matvec it builds and the
    limits of its loop."""

    def __init__(self, kernel: Kernel, block: int, use_pallas: bool, error_threshold: float,
                 max_iterations: int, max_steps_cycle: int, relative_threshold: bool):
        self.kernel, self.block, self.use_pallas = kernel, block, use_pallas
        self.limits = (float(error_threshold), int(max_iterations), int(max_steps_cycle),
                       bool(relative_threshold))

    def blocked(self, kp, z, lam, mask, rows):
        """The plain route's matvec, differentiable (the VJP's on both routes)."""
        return blocked_kuu_matvec(self.kernel, kp, z, lam, rows, block=self.block, mask=mask)

    def matvec(self, kp, z, lam, mask):
        kernel = self.kernel
        if not self.use_pallas:
            return lambda p: self.blocked(kp, z, lam, mask, p)
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

    def run(self, kp, z, lam, mask, rhs, precond_state) -> Tuple[torch.Tensor, CGStats]:
        with torch.no_grad():
            return _implicit_cg_impl(self.matvec(kp, z, lam, mask), precond_state, rhs,
                                     *self.limits)


def make_implicit_cg(kernel: Kernel, error_threshold: float, max_iterations: int,
                     max_steps_cycle: Optional[int] = None, block: int = 2048,
                     use_pallas: bool = False, relative_threshold: bool = False):
    """Build ``solve(kp, z, lam, rhs [R, M], precond_state=(), mask=None) ->
    (solution, CGStats)``, differentiable in ``kp``, ``z``, ``lam`` and
    ``rhs`` through :class:`_ImplicitSolve`.

    ``use_pallas=True`` runs every matvec of the forward and the backward
    solve through kernel B3 in float32 (cast back to the caller's dtype, as
    the JAX route does); else :func:`blocked_kuu_matvec`.  The gradient's
    matvec VJP is the blocked route's on both.  B3 is unmasked; a mask
    composes around it exactly (mask in {0, 1}):

        masked(p) = mask * kuu_matvec(p * mask) + p * lam * (1 - mask)

    — premasking kills pad columns, postmasking kills pad rows (including
    each pad's kernel diagonal), and the last term restores the pads' lam.
    The pads' far placement only keeps their kernel values finite."""
    if max_steps_cycle is None:
        max_steps_cycle = max_iterations + 1
    solver = _Solver(kernel, block, use_pallas, error_threshold, max_iterations,
                     max_steps_cycle, relative_threshold)

    def solve(kp, z, lam, rhs, precond_state=(), mask=None) -> Tuple[torch.Tensor, CGStats]:
        if mask is not None:
            mask = mask.detach().reshape(-1)
        names = tuple(kp)
        solution, steps, error, converged = _ImplicitSolve.apply(
            solver, names, mask, precond_state, rhs, z, lam, *(kp[k] for k in names))
        return solution, CGStats(steps=steps, error=error, converged=converged)

    # The route's matvec builder, ``route_matvec(kp, z, lam, mask) -> (rows ->
    # rows @ A)``: B3 with ``use_pallas``, else the blocked route.
    solve.route_matvec = solver.matvec
    return solve
