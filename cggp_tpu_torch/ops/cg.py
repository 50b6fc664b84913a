"""Batched conjugate gradients, forward solve (port of ``cggp_tpu/ops/cg.py``).

Semantics kept from the JAX solver:

* stop when all ``0.5 ||r||^2 <= threshold`` (absolute, or relative to each
  row's ``0.5 ||b||^2``) or ``i == max_iterations``;
* both curvature guards: ``gamma = 0`` when ``p.pA <= 1e-16``, and the
  search direction restarts from ``r`` when ``p.pA < -1e-16`` (indefinite)
  or the old ``r.r <= 1e-16``;
* the association ``(p * new_rz) / rz``;
* the exact-residual restart every ``max_steps_cycle`` iterations;
* ``CGStats(steps, error=0.5 * rz, converged)``.

``matvec_impl`` routes of the dense solver in this slice: ``"xla"`` (plain
IEEE matmul), ``"pallas"`` (kernel B1 for every matvec) and
``"pallas_resident"`` (kernel B2 for the whole solve, under the JAX
package's eligibility rule, else the ``"xla"`` loop exactly as JAX falls
back).  The loop of ``"xla"``/``"pallas"`` reads its stop rule on the host
once per iteration; ``"pallas_resident"`` decides on the device and the
call returns without a host read.

Not in this slice, each raising ``NotImplementedError``: other
``matvec_impl`` values (``"xla_high"``, ``"xla_bf16"``, ``"bf16_ir"``,
``"bf16_ru"``), compensated dots, preconditioners other than the identity,
gradients through the solve (the custom backward pass) and chunked solves.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from cggp_tpu_torch.ops.pallas_cg import pallas_cg_solve
from cggp_tpu_torch.ops.pallas_matvec import pallas_matvec

MATVEC_IMPLS = ("xla", "pallas", "pallas_resident")
_JAX_ONLY_IMPLS = ("xla_high", "xla_bf16", "bf16_ir", "bf16_ru")
_MIN_FLOAT = 1e-16


class CGStats(NamedTuple):
    steps: torch.Tensor  # int32 iterations executed
    error: torch.Tensor  # 0.5 * final rz, [m, 1]
    converged: Optional[torch.Tensor] = None  # bool: stop rule met at exit


def _standard_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1, keepdim=True)


class EyePreconditioner:
    """Identity: ``z = r``, ``rz = ||r||^2`` — the only preconditioner of
    this slice, applied inline by :func:`cg_loop`."""

    state: tuple = ()

    def __init__(self, dot: str = "standard"):
        if dot != "standard":
            raise NotImplementedError(
                f"dot={dot!r}: compensated inner products arrive with a later "
                "slice of the port (the CG solver family)")


def _check_supported(matvec_impl: str, dot: str, preconditioner) -> None:
    if matvec_impl not in MATVEC_IMPLS:
        later = ("a later slice of the port (mixed-precision CG routes)"
                 if matvec_impl in _JAX_ONLY_IMPLS else "no slice: unknown route")
        raise NotImplementedError(
            f"matvec_impl={matvec_impl!r} is not ported; supported: {MATVEC_IMPLS}; "
            f"{later}")
    if dot != "standard":
        raise NotImplementedError(
            f"dot={dot!r}: compensated inner products arrive with a later slice "
            "of the port (the CG solver family)")
    if preconditioner is not None and not isinstance(preconditioner, EyePreconditioner):
        raise NotImplementedError(
            f"{type(preconditioner).__name__}: preconditioners arrive with the "
            "training slice of the port; this slice solves unpreconditioned")


def cg_loop(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    v0: torch.Tensor,
    *,
    error_threshold: float,
    max_iterations: int,
    max_steps_cycle: int,
    relative_threshold: bool = False,
) -> Tuple[torch.Tensor, CGStats]:
    """Run CG on ``v A = b`` (row convention); ``matvec(p)`` returns ``p @ A``.
    The preconditioner is the identity (``z = r``)."""
    dtype, device = v0.dtype, v0.device
    zero = torch.zeros((), dtype=dtype, device=device)
    threshold = torch.tensor(error_threshold, dtype=dtype, device=device)
    if relative_threshold:
        threshold = threshold * 0.5 * torch.sum(torch.square(b), dim=-1, keepdim=True)
    never_restart = max_steps_cycle > max_iterations

    def over_threshold(r):
        return bool(torch.any(0.5 * torch.sum(torch.square(r), dim=-1, keepdim=True) > threshold))

    v = v0
    r = b - matvec(v0)
    rz = _standard_dot(r, r)
    p = r
    i = 0
    while i < max_iterations and over_threshold(r):
        pa = matvec(p)
        denom = _standard_dot(p, pa)
        indefinite = denom < -_MIN_FLOAT
        gamma = torch.where(denom <= _MIN_FLOAT, zero, rz / denom)
        v = v + gamma * p
        reset = not never_restart and i % max_steps_cycle == max_steps_cycle - 1
        r = b - matvec(v) if reset else r - gamma * pa
        new_rz = _standard_dot(r, r)
        if reset:
            p = r
        else:
            p = r + torch.where(indefinite | (rz <= _MIN_FLOAT), zero, p * new_rz / rz)
        rz = new_rz
        i += 1
    final_r_sq = torch.sum(torch.square(r), dim=-1, keepdim=True)
    converged = torch.logical_not(torch.any(0.5 * final_r_sq > threshold))
    steps = torch.tensor(i, dtype=torch.int32, device=device)
    return v, CGStats(steps=steps, error=0.5 * rz, converged=converged)


def _cg_dense_impl(error_threshold: float, max_iterations: int, max_steps_cycle: int,
                   matvec_impl: str, relative: bool, matrix: torch.Tensor,
                   rhs: torch.Tensor, v0: torch.Tensor) -> Tuple[torch.Tensor, CGStats]:
    if matvec_impl == "pallas_resident":
        # The JAX eligibility rule (identity preconditioner and standard dot
        # hold for every solve this slice accepts): no restart and an
        # absolute threshold; anything else takes the "xla" loop, as in JAX.
        if max_steps_cycle > max_iterations and not relative:
            # v0 enters through the shifted system (v0 + d) A = b.
            shifted_rhs = rhs - torch.matmul(v0, matrix)
            delta, steps = pallas_cg_solve(
                matrix.to(torch.float32).contiguous(),
                shifted_rhs.to(torch.float32).contiguous(),
                error_threshold, max_iterations)
            solution = v0 + delta.to(rhs.dtype)
            residual = rhs - torch.matmul(solution, matrix)
            error = 0.5 * torch.sum(torch.square(residual), dim=-1, keepdim=True)
            # The kernel's stop rule runs on the recursive residual; an early
            # exit (steps < cap) means that rule was met, whatever drift the
            # exact residual shows.
            converged = torch.logical_or(
                steps < max_iterations,
                torch.logical_not(torch.any(error > error_threshold)))
            return solution, CGStats(steps=steps, error=error, converged=converged)
        matvec_impl = "xla"

    if matvec_impl == "pallas":
        matrix32 = matrix.to(torch.float32).contiguous()

        def matvec(q):
            return pallas_matvec(q.to(torch.float32).contiguous(), matrix32).to(q.dtype)
    else:
        def matvec(q):
            return torch.matmul(q, matrix)

    return cg_loop(matvec, rhs, v0, error_threshold=error_threshold,
                   max_iterations=max_iterations, max_steps_cycle=max_steps_cycle,
                   relative_threshold=relative)


def conjugate_gradient(
    matrix: torch.Tensor,
    rhs: torch.Tensor,
    initial_solution: torch.Tensor,
    error_threshold: float,
    preconditioner: Optional[EyePreconditioner] = None,
    max_iterations: Optional[int] = None,
    max_steps_cycle: int = 100,
    dot: str = "standard",
    matvec_impl: str = "xla",
    relative_threshold: bool = False,
) -> Tuple[torch.Tensor, CGStats]:
    """Solve ``v A = b`` for a batch of row right-hand sides.

    Args:
        matrix: symmetric PD ``A`` [n, n].
        rhs: right-hand sides as rows [m, n].
        initial_solution: initial iterate [m, n].
        error_threshold: stop when all ``0.5 ||r_i||^2 <= threshold``.
    Returns:
        ``(solution [m, n], CGStats(steps, error, converged))``.
    """
    _check_supported(matvec_impl, dot, preconditioner)
    if torch.is_grad_enabled() and (matrix.requires_grad or rhs.requires_grad
                                    or initial_solution.requires_grad):
        raise NotImplementedError(
            "gradients through the CG solve (its custom backward pass) arrive "
            "with the training slice of the port; call under torch.no_grad()")
    if max_iterations is None:
        max_iterations = matrix.shape[-1]
    return _cg_dense_impl(float(error_threshold), int(max_iterations), int(max_steps_cycle),
                          matvec_impl, bool(relative_threshold), matrix, rhs, initial_solution)


class ConjugateGradient:
    """Column-major facade: callable on ``(matrix [n, n], rhs [n, m])``.

    Transposes to the internal row convention, uses a zero initial solution,
    defaults ``max_iterations = n`` and ``max_steps_cycle = max_iterations +
    1`` (never restart), and returns the [n, m] solution.
    """

    def __init__(
        self,
        error_threshold: float,
        preconditioner: Optional[EyePreconditioner] = None,
        max_iterations: Optional[int] = None,
        max_steps_cycle: Optional[int] = None,
        dot: str = "standard",
        matvec_impl: str = "xla",
        relative_threshold: bool = False,
    ):
        _check_supported(matvec_impl, dot, preconditioner)
        self.error_threshold = error_threshold
        self.preconditioner = preconditioner if preconditioner is not None else EyePreconditioner()
        self.max_iterations = max_iterations
        self.max_steps_cycle = max_steps_cycle
        self.dot = dot
        self.matvec_impl = matvec_impl
        self.relative_threshold = relative_threshold

    def solve_with_stats(
        self, matrix: torch.Tensor, rhs: torch.Tensor,
        initial_solution: Optional[torch.Tensor] = None,
        preconditioner: Optional[EyePreconditioner] = None,
    ) -> Tuple[torch.Tensor, CGStats]:
        rhs_t = rhs.T
        v0 = torch.zeros_like(rhs_t) if initial_solution is None else initial_solution.T
        max_iterations = self.max_iterations
        if max_iterations is None:
            max_iterations = matrix.shape[-1]
        max_steps_cycle = self.max_steps_cycle
        if max_steps_cycle is None:
            max_steps_cycle = max_iterations + 1  # never restart inside the run
        solution, stats = conjugate_gradient(
            matrix, rhs_t, v0, self.error_threshold,
            preconditioner=preconditioner or self.preconditioner,
            max_iterations=max_iterations, max_steps_cycle=max_steps_cycle,
            dot=self.dot, matvec_impl=self.matvec_impl,
            relative_threshold=self.relative_threshold,
        )
        return solution.T, stats

    def __call__(self, matrix: torch.Tensor, rhs: torch.Tensor,
                 initial_solution: Optional[torch.Tensor] = None,
                 preconditioner: Optional[EyePreconditioner] = None) -> torch.Tensor:
        solution, _stats = self.solve_with_stats(matrix, rhs, initial_solution,
                                                 preconditioner=preconditioner)
        return solution
