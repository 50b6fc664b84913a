"""Row-sharded conjugate gradients over the rank mesh (port of
``cggp_tpu/parallel/sharded_cg.py``).

Each rank owns a row block of the system and builds it on the fly:

    (p @ A)[*, :] = sum_d  p[:, rows_d] @ A[rows_d, :]        (all_reduce over d)

with ``A[rows_d, :] = K(Z[rows_d], Z) * mask + diag(lam)[rows_d, :]``
([M / d, M] on each rank; the whole Gram matrix exists on no rank).  The
local product runs in IEEE fp32 or fp64 (TF32 off, JAX's
``Precision.HIGHEST``), then one ``all_reduce(SUM)``; the [R, M] CG state
stays replicated.  The stop flag is all-reduced (MAX) before the host reads
it, so every rank takes one decision and the same number of steps.

Differentiation, as in JAX: the backward pass is a second sharded solve of
the cotangent, ``w = A^{-1} v_bar``, then the VJP of ``theta -> solution @
A(theta)`` at ``w``: each rank takes the VJP of its own row block (rebuilt
in chunks of rows, so the kernel's intermediates never span the whole
block) and the partial gradients of the kernel parameters, ``z`` and
``lam`` are all-reduced (SUM).  Every rank calls with the same arguments and gets the
same replicated result.

Requires M divisible by the mesh size: :func:`pad_inducing` pads with
far-away points behind a mask that decouples them exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from cggp_tpu_torch.ops.cg import (CGStats, agreed_stop, cg_loop, precond_apply_or_identity,
                                   spectral_precond_state)  # noqa: F401 (re-export)
from cggp_tpu_torch.ops.cg_implicit import (_ImplicitSolve, pad_inducing,  # noqa: F401
                                            pivoted_cholesky_kernel)
from cggp_tpu_torch.ops.kernels import Kernel
from cggp_tpu_torch.ops.logdet import slq_value_rows
from cggp_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, agree_max, all_reduce_sum


def _row_block(mesh: Mesh, m: int) -> Tuple[int, int]:
    """``(offset, rows)`` of this rank's block of an M-row system."""
    if m % mesh.size != 0:
        raise ValueError(f"sharded system: M = {m} does not divide over the {mesh.size}-rank "
                         "mesh (pad it with pad_inducing)")
    mb = m // mesh.size
    return mesh.rank * mb, mb


# Rows of a row block whose VJP is taken at once: the kernel's intermediates
# of a chunk stay near 2^26 elements (512 MB in fp64) whatever M is.
_VJP_CHUNK_ELEMENTS = 1 << 26


def _local_rows(kernel: Kernel, kp, z: torch.Tensor, lam: torch.Tensor, mesh: Mesh,
                mask: Optional[torch.Tensor] = None, rows: Optional[Tuple[int, int]] = None):
    """This rank's row block of ``K(Z, Z) * mask + diag(lam)``: ``(a_rows [M/d,
    M], offset, M/d)``; with ``rows = (r0, r1)`` only the block's rows r0 to
    r1 (``a_rows [r1 - r0, M]``, ``offset`` then the first row's index).
    ``mask`` (1 real, 0 pad) zeroes the pads' kernel coupling before the
    diagonal is added, so the padded system is exactly block-diagonal at
    any lengthscale."""
    offset, mb = _row_block(mesh, z.shape[0])
    if rows is not None:
        offset, mb = offset + rows[0], rows[1] - rows[0]
    a_rows = kernel.K(kp, z[offset:offset + mb], z)  # [mb, M], built on the fly
    if mask is not None:
        mask = mask.reshape(-1)
        a_rows = a_rows * (mask[offset:offset + mb, None] * mask[None, :])
    a_rows = a_rows.clone()
    a_rows.diagonal(offset=offset).add_(lam.reshape(-1)[offset:offset + mb])
    return a_rows, offset, mb


def _local_matvec(a_rows: torch.Tensor, offset: int, mb: int, mesh: Mesh):
    """``p -> p @ A`` from this rank's rows: the local product, then one
    all-reduce."""

    def matvec(p: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(mesh, torch.matmul(p[..., offset:offset + mb], a_rows))

    return matvec


class _ShardedMatvec(torch.autograd.Function):
    """``all_reduce(local(rows, z, lam, *kp))``, differentiable: the VJP of
    this rank's block at the (replicated) cotangent, taken chunk by chunk of
    its rows (``local(..., rows=(r0, r1))`` is a chunk's share of the
    product), each partial gradient all-reduced, so every rank gets the
    whole gradient."""

    @staticmethod
    def forward(ctx, local, mesh, chunks, *inputs):
        ctx.local, ctx.mesh, ctx.chunks = local, mesh, chunks
        ctx.save_for_backward(*inputs)
        with torch.no_grad():
            return all_reduce_sum(mesh, local(*inputs))

    @staticmethod
    @once_differentiable
    def backward(ctx, w):
        inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        live = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
        wanted = [t for t, need in zip(live, needs) if need]
        total = [None] * len(wanted)
        if wanted:
            for rows in ctx.chunks:
                with torch.enable_grad():
                    grads = torch.autograd.grad(ctx.local(*live, rows=rows), wanted,
                                                grad_outputs=w, allow_unused=True)
                total = [g if t is None else (t if g is None else t + g)
                         for t, g in zip(total, grads)]
        totals = iter(total)
        out = []
        for t, need in zip(live, needs):
            if not need:
                out.append(None)
                continue
            g = next(totals)
            out.append(all_reduce_sum(ctx.mesh, torch.zeros_like(t) if g is None else g))
        return (None, None, None, *out)


def _vjp_chunks(mesh: Mesh, m: int):
    """The row ranges of this rank's block whose VJPs are taken one at a time."""
    _, mb = _row_block(mesh, m)
    step = max(1, _VJP_CHUNK_ELEMENTS // max(m, 1))
    return tuple((r0, min(mb, r0 + step)) for r0 in range(0, mb, step))


def make_sharded_matvec(kernel: Kernel, mesh: Mesh, axis_name: str = DATA_AXIS):
    """Replicated-in, replicated-out ``p @ (K(Z, Z) * mask + diag(lam))``:
    ``matvec(kp, z, lam, mask, p)``, each rank's row block built on the
    fly, one all-reduce a call; differentiable in ``p``, ``z``, ``lam`` and
    the kernel parameters."""
    del axis_name

    def matvec(kp, z, lam, mask, p):
        names = tuple(kp)
        mask = None if mask is None else mask.detach()

        def local(p_, z_, lam_, *kp_values, rows=None):
            a_rows, offset, mb = _local_rows(kernel, dict(zip(names, kp_values)), z_, lam_,
                                             mesh, mask, rows)
            return torch.matmul(p_[..., offset:offset + mb], a_rows)

        return _ShardedMatvec.apply(local, mesh, _vjp_chunks(mesh, z.shape[0]), p, z, lam,
                                    *(kp[k] for k in names))

    return matvec


def make_sharded_slq_value(kernel: Kernel, mesh: Mesh, lanczos_iters: int,
                           axis_name: str = DATA_AXIS):
    """Stochastic-Lanczos-quadrature logdet value of the sharded system:
    ``slq(kp, z, lam, mask, probes [P, M]) -> scalar`` (replicated), the
    row block built once for every Lanczos step, one all-reduce a step.
    Probes must be masked (zero on pads)."""
    del axis_name

    def slq(kp, z, lam, mask, probes):
        with torch.no_grad():
            a_rows, offset, mb = _local_rows(kernel, {k: v.detach() for k, v in kp.items()},
                                             z.detach(), lam.detach(), mesh,
                                             None if mask is None else mask.detach())
            return slq_value_rows(_local_matvec(a_rows, offset, mb, mesh), probes.detach(),
                                  lanczos_iters)

    return slq


def _sharded_cg_impl(matvec, precond_state, rhs: torch.Tensor, mesh: Mesh,
                     error_threshold: float, max_iterations: int, max_steps_cycle: int,
                     relative_threshold: bool) -> Tuple[torch.Tensor, CGStats]:
    """One sharded CG solve from ``v0 = 0``, the stop flag agreed by a MAX
    all-reduce (the forward and the backward solves both call it through
    this module's namespace)."""
    with agreed_stop(lambda flag: agree_max(mesh, flag)):
        return cg_loop(matvec, precond_apply_or_identity, precond_state, rhs,
                       torch.zeros_like(rhs), error_threshold=error_threshold,
                       max_iterations=max_iterations, max_steps_cycle=max_steps_cycle,
                       relative_threshold=relative_threshold)


class _ShardedSolver:
    """The sharded route for ``ops.cg_implicit._ImplicitSolve``: ``run`` is
    the solve, ``blocked`` the differentiable matvec its VJP takes."""

    def __init__(self, kernel: Kernel, mesh: Mesh, error_threshold: float, max_iterations: int,
                 max_steps_cycle: int, relative_threshold: bool):
        self.kernel, self.mesh = kernel, mesh
        self.limits = (float(error_threshold), int(max_iterations), int(max_steps_cycle),
                       bool(relative_threshold))
        self.blocked = make_sharded_matvec(kernel, mesh)

    def matvec(self, kp, z, lam, mask):
        """The loop's ``p -> p @ A``, this rank's rows built once."""
        with torch.no_grad():
            a_rows, offset, mb = _local_rows(self.kernel, {k: v.detach() for k, v in kp.items()},
                                             z.detach(), lam.detach(), self.mesh, mask)
        return _local_matvec(a_rows, offset, mb, self.mesh)

    def run(self, kp, z, lam, mask, rhs, precond_state) -> Tuple[torch.Tensor, CGStats]:
        with torch.no_grad():
            return _sharded_cg_impl(self.matvec(kp, z, lam, mask), precond_state, rhs,
                                    self.mesh, *self.limits)


def make_sharded_cg(kernel: Kernel, mesh: Mesh, error_threshold: float, max_iterations: int,
                    max_steps_cycle: Optional[int] = None, axis_name: str = DATA_AXIS,
                    relative_threshold: bool = False):
    """A differentiable sharded solver ``solve(kp, z, lam, rhs [m, M],
    precond_state=(), mask=None) -> (solution [m, M], CGStats)``: ``z`` the
    inducing inputs (M divisible by the mesh size), ``lam`` the diagonal,
    ``rhs`` row-batched right-hand sides, all replicated."""
    del axis_name
    if max_steps_cycle is None:
        max_steps_cycle = max_iterations + 1
    solver = _ShardedSolver(kernel, mesh, error_threshold, max_iterations, max_steps_cycle,
                            relative_threshold)

    def solve(kp, z, lam, rhs, precond_state=(), mask=None) -> Tuple[torch.Tensor, CGStats]:
        if mask is None:
            # No pads declared: every point is real.
            mask = torch.ones(z.shape[0], dtype=z.dtype, device=z.device)
        mask = mask.detach().reshape(-1)
        names = tuple(kp)
        solution, steps, error, converged = _ImplicitSolve.apply(
            solver, names, mask, precond_state, rhs, z, lam.reshape(-1), *(kp[k] for k in names))
        return solution, CGStats(steps=steps, error=error, converged=converged)

    # The route's matvec builder (the LOVE cache and the serving resolver).
    solve.route_matvec = solver.matvec
    return solve


class ShardedKuuSolver:
    """Column-convention facade over :func:`make_sharded_cg` with the call
    shape of :class:`~cggp_tpu_torch.ops.cg.ConjugateGradient`."""

    def __init__(self, kernel: Kernel, mesh: Mesh, error_threshold: float, max_iterations: int,
                 max_steps_cycle: Optional[int] = None, axis_name: str = DATA_AXIS,
                 relative_threshold: bool = False):
        self.kernel = kernel
        self.mesh = mesh
        self.num_devices = mesh.size
        self._solve = make_sharded_cg(kernel, mesh, error_threshold, max_iterations,
                                      max_steps_cycle, axis_name,
                                      relative_threshold=relative_threshold)

    def solve_with_stats(self, kp, z: torch.Tensor, lam: torch.Tensor, rhs: torch.Tensor,
                         precond_state=(), mask: Optional[torch.Tensor] = None):
        """``rhs`` is [M, m] column-major like the dense facade; ``mask``
        marks real (1) and pad (0) inducing points."""
        solution, stats = self._solve(kp, z, lam.reshape(-1), rhs.T, precond_state, mask=mask)
        return solution.T, stats

    def __call__(self, kp, z: torch.Tensor, lam: torch.Tensor, rhs: torch.Tensor,
                 precond_state=(), mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.solve_with_stats(kp, z, lam, rhs, precond_state, mask=mask)[0]
