"""Batched preconditioned conjugate gradients with a hand-written backward
pass (port of ``cggp_tpu/ops/cg.py``).

Semantics kept from the JAX solver:

* stop when all ``0.5 ||r||^2 <= threshold`` (absolute, or relative to each
  row's ``0.5 ||b||^2``) or ``i == max_iterations``;
* both curvature guards: ``gamma = 0`` when ``p.pA <= 1e-16``, and the
  search direction restarts from ``z`` when ``p.pA < -1e-16`` (indefinite)
  or the old ``r.z <= 1e-16``;
* the association ``(p * new_rz) / rz``;
* the exact-residual restart every ``max_steps_cycle`` iterations;
* the preconditioner protocol ``apply(state, vec, mat) -> (z, r.z)``;
* ``CGStats(steps, error=0.5 * rz, converged)``;
* the backward pass is another CG solve on the same route:
  ``db = A^{-1} dx`` (``v0 = 0``), ``dA = -solution^T db``, ``dv0 = 0`` and
  no gradient to the preconditioner state (:class:`_CGDense`);
* ``dot="compensated"``: the CG's inner products with compensated
  accumulation (``ops/linalg.compensated_dot``; JAX runs Kahan's recurrence,
  the port a pairwise two-sum of the same accuracy).

``matvec_impl`` routes of the dense solver (:data:`MATVEC_IMPLS`):

* ``"xla"``: the plain IEEE matmul (TF32 off);
* ``"pallas"``: kernel B1 for every matvec, under any preconditioner;
* ``"pallas_resident"``: kernel B2 for the whole solve, under the JAX
  package's eligibility rule (identity preconditioner, standard dot, no
  restart, absolute threshold), else the ``"xla"`` loop exactly as JAX falls
  back;
* ``"xla_high"``: JAX's ``Precision.HIGH``, a multi-pass reduced-precision
  product near fp32 accuracy.  On the card a float32 system runs through
  B1, itself a 3xTF32 product near fp32 accuracy (no global TF32 switch is
  touched); elsewhere, as JAX's HIGH on the CPU, the plain product;
* ``"xla_bf16"``: every matvec on a bf16 copy of A's off-diagonal with the
  diagonal in fp32 (:func:`_bf16_diagsplit_matvec`), half the bytes of A a
  step, no refinement: it floors at a relative residual of ~1e-2..1e-3.
  Its ``converged`` reads the true residual at exit (one full-precision
  matvec), not the bf16 recursion's, which JAX's flag reads;
* ``"bf16_ir"`` / ``"bf16_ru"``: the bf16 matvec inside iterative
  refinement (:func:`ir_cg_loop`) or drift-adaptive reliable updates
  (:func:`mixed_cg_loop`), each anchored on exact fp32 residuals.  Out of
  their envelope (bf16 rounding of A at or above ``lambda_min``) they stall;
  :meth:`ConjugateGradient.check_bf16_envelope` warns and resolves such a
  system to ``"xla_high"``.

The bf16 product asks for fp32 output (``torch.mm(..., out_dtype=
torch.float32)``, JAX's ``preferred_element_type``); where a build lacks
that op on the card the route raises.  On the CPU the bf16 operands are
widened to fp32 first, which gives the same exact products.

The loops of every route but ``"pallas_resident"`` read their stop rule on
the host once per iteration; B2 decides on the device and the call returns
without a host read.  :meth:`ConjugateGradient.solve_chunked` runs a solve
in host-driven chunks (residual replacement with the direction carried).

Preconditioners: :class:`EyePreconditioner`, :class:`BlockPreconditioner`,
:class:`NystromPreconditioner`, :class:`SpectralPreconditioner`,
:class:`CholPreconditioner` (a factor that is not finite falls back to
``W = I``, as in JAX) and :func:`pivoted_cholesky_preconditioner`.
"""

from __future__ import annotations

import warnings
import weakref
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from cggp_tpu_torch.ops.linalg import compensated_dot, pivoted_cholesky
from cggp_tpu_torch.ops.pallas_cg import pallas_cg_solve
from cggp_tpu_torch.ops.pallas_matvec import pallas_matvec

MATVEC_IMPLS = ("xla", "pallas", "pallas_resident", "xla_high", "xla_bf16", "bf16_ir",
                "bf16_ru")
_DOTS = ("standard", "compensated")
_MIN_FLOAT = 1e-16


class CGState(NamedTuple):
    """Loop-carried state of :func:`cg_loop`."""

    i: int  # iterations executed
    v: torch.Tensor  # current solution, [m, n]
    r: torch.Tensor  # residual, [m, n]
    p: torch.Tensor  # search direction, [m, n]
    rz: torch.Tensor  # preconditioned inner product r^T z, [m, 1]


class CGStats(NamedTuple):
    steps: torch.Tensor  # int32 iterations executed
    error: torch.Tensor  # 0.5 * final rz, [m, 1]
    converged: Optional[torch.Tensor] = None  # bool: stop rule met at exit


def _standard_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1, keepdim=True)


def _kahan_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return compensated_dot(a, b, keepdim=True)


_DOT_FNS = {"standard": _standard_dot, "compensated": _kahan_dot}


def _cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where the factorization fails (as
    ``jnp.linalg.cholesky`` gives), without a host read of the info flag."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], chol, torch.full_like(chol, float("nan")))


# ---------------------------------------------------------------------------
# Preconditioners: ``apply(state, vec, mat) -> (z, r.z)`` and ``state``
# ---------------------------------------------------------------------------


class EyePreconditioner:
    """Identity: ``z = r``, ``rz = ||r||^2`` (state ``()``)."""

    state: tuple = ()

    def __init__(self, dot: str = "standard"):
        if dot not in _DOT_FNS:
            raise ValueError(f"unknown dot: {dot!r}; choose from {_DOTS}")
        dot_fn = _DOT_FNS[dot]

        def apply(state, vec: torch.Tensor, mat=None) -> Tuple[torch.Tensor, torch.Tensor]:
            del state, mat
            return vec, dot_fn(vec, vec)

        self.apply = apply

    def __call__(self, vec: torch.Tensor, mat=None) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.apply(self.state, vec, mat)


class BlockPreconditioner:
    """Block-Jacobi: per-block Cholesky solves against the system matrix.

    ``block_indices`` [num_blocks, block_size] must partition the index
    range (each index in exactly one block); every block is factorized in
    one batched call."""

    def __init__(self, block_indices):
        self.state = (torch.as_tensor(block_indices, dtype=torch.long),)

    @staticmethod
    def apply(state, vec: torch.Tensor, mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        (block_indices,) = state
        idx = block_indices.to(vec.device)
        a = mat[idx[:, :, None], idx[:, None, :]]  # [nb, bs, bs]
        b = vec[:, idx].permute(1, 2, 0)  # [nb, bs, m]
        blocks = torch.cholesky_solve(b, _cholesky_or_nan(a))  # [nb, bs, m]
        m = vec.shape[0]
        z = torch.zeros_like(vec)
        z[:, idx.reshape(-1)] = blocks.permute(2, 0, 1).reshape(m, -1)
        return z, _standard_dot(z, vec)

    def __call__(self, vec: torch.Tensor, mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.apply(self.state, vec, mat)


class NystromPreconditioner:
    """Low-rank + diagonal Woodbury preconditioner: the exact inverse of
    ``U U^T + diag(lam)`` for an [n, k] factor ``U``,

        z^T = D^{-1} r^T - D^{-1} U (I_k + U^T D^{-1} U)^{-1} U^T D^{-1} r^T

    with the [k, k] Cholesky taken once at construction."""

    def __init__(self, factor: torch.Tensor, lam: torch.Tensor):
        lam = lam.reshape(-1)
        d_inv = 1.0 / lam
        ud = factor * d_inv[:, None]  # D^{-1} U, [n, k]
        k = factor.shape[-1]
        small = torch.eye(k, dtype=factor.dtype, device=factor.device) + factor.T @ ud
        self.state = (ud, _cholesky_or_nan(small), d_inv)

    @staticmethod
    def apply(state, vec: torch.Tensor, mat=None) -> Tuple[torch.Tensor, torch.Tensor]:
        del mat
        ud, chol, d_inv = state
        vd = vec * d_inv[None, :]
        w = vec @ ud  # [m, k]
        w = torch.cholesky_solve(w.T, chol).T
        z = vd - w @ ud.T
        return z, _standard_dot(z, vec)

    def __call__(self, vec: torch.Tensor, mat=None) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.apply(self.state, vec, mat)


class SpectralPreconditioner:
    """Cancellation-free low-rank+diagonal preconditioner: the exact
    inverse of ``U U^T + diag(lam)`` in a form that stays SPD in fp32.

    Construction diagonalizes the whitened factor ``W = D^{-1/2} U``:
    QR first (``Q`` orthonormal to machine precision however ill-conditioned
    ``W`` is), then ``eigh`` of ``R R^T`` under a relative ridge, giving

        (U U^T + D)^{-1} = D^{-1/2} [ (I - Q Q^T) + Q diag(1/(1+s2)) Q^T ] D^{-1/2}

    The apply re-orthogonalizes the projection once (twice is enough) and
    accumulates ``r^T z`` as ``||y_perp||^2 + sum(w t^2)``, positive by
    construction.  Cost per apply: four skinny [m, n] x [n, k] matmuls."""

    def __init__(self, factor: torch.Tensor, lam: torch.Tensor):
        lam = lam.reshape(-1).to(factor.dtype)
        d_inv_sqrt = torch.rsqrt(lam)
        w_fac = factor * d_inv_sqrt[:, None]  # D^{-1/2} U, [n, k]
        q, r_fac = torch.linalg.qr(w_fac)
        small = torch.matmul(r_fac, r_fac.T)  # [k, k] = Q^T W W^T Q
        k = small.shape[-1]
        eps = torch.finfo(factor.dtype).eps
        ridge = 10.0 * eps * torch.clamp(torch.trace(small) / k, min=1.0)
        eye = torch.eye(k, dtype=factor.dtype, device=factor.device)
        s2, v = torch.linalg.eigh(small + ridge * eye)
        s2 = torch.clamp(s2 - ridge, min=0.0)
        q = torch.matmul(q, v)  # still orthonormal (V orthogonal)
        weights = 1.0 / (1.0 + s2)
        self.state = (q, weights, d_inv_sqrt)

    @staticmethod
    def apply(state, vec: torch.Tensor, mat=None) -> Tuple[torch.Tensor, torch.Tensor]:
        del mat
        q, weights, d_inv_sqrt = state
        y = vec * d_inv_sqrt[None, :]  # [m, n]
        t = torch.matmul(y, q)  # [m, k]
        y_perp = y - torch.matmul(t, q.T)
        # Re-orthogonalize: after this, Q^T y_perp ~ 0 to working precision
        # even when y lies almost entirely inside span(Q).
        t2 = torch.matmul(y_perp, q)
        y_perp = y_perp - torch.matmul(t2, q.T)
        wt = t * weights[None, :]
        z = (y_perp + torch.matmul(wt, q.T)) * d_inv_sqrt[None, :]
        rz = torch.sum(torch.square(y_perp), dim=-1, keepdim=True) + torch.sum(
            wt * t, dim=-1, keepdim=True)
        return z, rz

    def __call__(self, vec: torch.Tensor, mat=None) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.apply(self.state, vec, mat)


class CholPreconditioner:
    """Exact-factor preconditioner: PCG becomes iterative refinement.

    Factorizes ``A = matrix + diag(lam)`` once and keeps the triangular
    inverse ``W = L^{-1}``; the apply is ``z = r W^T W``, ``rz = ||r W^T||^2``
    (two [R, M] x [M, M] products), SPD by construction however rounding
    degraded the factor.  A factorization that fails, or a ``W`` that is
    not finite, gives ``W = I`` (plain CG): a training step is never
    poisoned by a bad factor.  Decided on the device (``cholesky_ex`` and
    ``torch.where``), with no host read.  The state is ``{"chol_w": W}``."""

    def __init__(self, matrix: torch.Tensor, lam: torch.Tensor):
        lam = lam.reshape(-1).to(matrix.dtype)
        a = matrix + torch.diag(lam)
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        chol, info = torch.linalg.cholesky_ex(a)
        w = torch.linalg.solve_triangular(chol, eye, upper=False)
        ok = torch.logical_and(info == 0, torch.all(torch.isfinite(w)))
        self.state = {"chol_w": torch.where(ok, w, eye)}

    @staticmethod
    def apply(state, vec: torch.Tensor, mat=None) -> Tuple[torch.Tensor, torch.Tensor]:
        del mat
        w = state["chol_w"]
        y = torch.matmul(vec, w.T)  # [R, M] = (L^{-1} r^T)^T
        z = torch.matmul(y, w)
        return z, torch.sum(torch.square(y), dim=-1, keepdim=True)

    def __call__(self, vec: torch.Tensor, mat=None) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.apply(self.state, vec, mat)


def spectral_precond_state(factor: torch.Tensor, lam: torch.Tensor):
    """The :class:`SpectralPreconditioner` state ``(q, weights, d_inv_sqrt)``."""
    return SpectralPreconditioner(factor, lam).state


def pivoted_cholesky_preconditioner(matrix: torch.Tensor, lam: torch.Tensor,
                                    rank: int) -> SpectralPreconditioner:
    """Rank-``rank`` pivoted-Cholesky preconditioner for ``matrix +
    diag(lam)``: the greedy largest-diagonal factor ``matrix ~= L L^T``
    wrapped in the stable SPD apply of :class:`SpectralPreconditioner`."""
    return SpectralPreconditioner(pivoted_cholesky(matrix, rank), lam)


def precond_apply_or_identity(state, vec: torch.Tensor, mat=None) -> Tuple[torch.Tensor,
                                                                            torch.Tensor]:
    """Identity when ``state`` is the empty tuple, else the
    :class:`SpectralPreconditioner` apply; returns ``(z, r.z)``."""
    if state == ():
        return vec, torch.sum(torch.square(vec), dim=-1, keepdim=True)
    return SpectralPreconditioner.apply(state, vec, mat)


def _check_supported(matvec_impl: str, dot: str) -> None:
    if matvec_impl not in MATVEC_IMPLS:
        raise NotImplementedError(
            f"matvec_impl={matvec_impl!r} is no route of the port or of the JAX package; "
            f"supported: {MATVEC_IMPLS}")
    if dot not in _DOTS:
        raise ValueError(f"unknown dot: {dot!r}; choose from {_DOTS}")


# ---------------------------------------------------------------------------
# Core loop
# ---------------------------------------------------------------------------


def _row_sq(r: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(r), dim=-1, keepdim=True)


def _targets(b: torch.Tensor, error_threshold: float, relative: bool) -> torch.Tensor:
    threshold = torch.tensor(error_threshold, dtype=b.dtype, device=b.device)
    return threshold * 0.5 * _row_sq(b) if relative else threshold


def cg_loop(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    precond_apply: Callable,
    precond_state,
    b: torch.Tensor,
    v0: torch.Tensor,
    *,
    error_threshold: float,
    max_iterations: int,
    max_steps_cycle: int,
    mat_for_precond: Optional[torch.Tensor] = None,
    relative_threshold: bool = False,
    p0: Optional[torch.Tensor] = None,
    return_state: bool = False,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = _standard_dot,
    iteration_budget: Optional[int] = None,
):
    """Run PCG on ``v A = b`` (row convention); ``matvec(p)`` returns ``p @ A``
    and ``precond_apply(precond_state, r, mat_for_precond)`` returns
    ``(z, r.z)``.  The stop rule reads the unpreconditioned residual ``r``;
    ``dot`` takes the curvature ``p.pA``.  ``iteration_budget`` caps the
    iterations below ``max_iterations`` (the refinement loop's remaining
    budget), leaving the restart rule, which reads ``max_iterations``, as it
    is.

    ``p0`` carries a search direction in from an earlier run (residual
    replacement): the residual is still re-anchored on the true ``b - v0 A``,
    but the first direction is ``p0`` instead of ``z``.  ``return_state=True``
    returns ``(v, stats, final CGState)``, so the next run can resume from
    ``state.v`` and ``state.p``."""
    dtype, device = v0.dtype, v0.device
    zero = torch.zeros((), dtype=dtype, device=device)
    threshold = _targets(b, error_threshold, relative_threshold)
    never_restart = max_steps_cycle > max_iterations
    cap = max_iterations if iteration_budget is None else min(max_iterations,
                                                              int(iteration_budget))

    def over_threshold(r):
        return bool(torch.any(0.5 * _row_sq(r) > threshold))

    r = b - matvec(v0)
    z, rz = precond_apply(precond_state, r, mat_for_precond)
    state = CGState(0, v0, r, z if p0 is None else p0, rz)
    while state.i < cap and over_threshold(state.r):
        pa = matvec(state.p)
        denom = dot(state.p, pa)
        indefinite = denom < -_MIN_FLOAT
        gamma = torch.where(denom <= _MIN_FLOAT, zero, state.rz / denom)
        v = state.v + gamma * state.p
        reset = not never_restart and state.i % max_steps_cycle == max_steps_cycle - 1
        r = b - matvec(v) if reset else state.r - gamma * pa
        z, new_rz = precond_apply(precond_state, r, mat_for_precond)
        if reset:
            p = z
        else:
            p = z + torch.where(indefinite | (state.rz <= _MIN_FLOAT), zero,
                                state.p * new_rz / state.rz)
        state = CGState(state.i + 1, v, r, p, new_rz)
    converged = torch.logical_not(torch.any(0.5 * _row_sq(state.r) > threshold))
    steps = torch.tensor(state.i, dtype=torch.int32, device=device)
    stats = CGStats(steps=steps, error=0.5 * state.rz, converged=converged)
    if return_state:
        return state.v, stats, state
    return state.v, stats


def ir_cg_loop(
    matvec_hi: Callable[[torch.Tensor], torch.Tensor],
    matvec_lo: Callable[[torch.Tensor], torch.Tensor],
    precond_apply: Callable,
    precond_state,
    b: torch.Tensor,
    v0: torch.Tensor,
    *,
    error_threshold: float,
    max_iterations: int,
    inner_rtol: float = 1e-2,
    max_outer: int = 8,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = _standard_dot,
    mat_for_precond: Optional[torch.Tensor] = None,
    relative_threshold: bool = False,
) -> Tuple[torch.Tensor, CGStats]:
    """Mixed-precision CG by iterative refinement: each outer cycle takes
    the exact residual ``b - v A`` through ``matvec_hi``, then an inner CG
    on the cheap ``matvec_lo`` (a bf16 copy of A: half the bytes a step)
    solves the correction to ``inner_rtol`` relative (on ``0.5 ||r||^2``)
    from the remaining iteration budget.  Stops when the exact residual
    meets the rule, after ``max_outer`` cycles or when ``max_iterations``
    inner iterations are spent; ``steps`` counts the inner iterations."""
    threshold = _targets(b, error_threshold, relative_threshold)

    def unconverged(r):
        return bool(torch.any(0.5 * _row_sq(r) > threshold))

    v = v0
    r = b - matvec_hi(v0)
    outer, total_inner = 0, 0
    while unconverged(r) and outer < max_outer and total_inner < max_iterations:
        d, inner = cg_loop(matvec_lo, precond_apply, precond_state, r, torch.zeros_like(r),
                           error_threshold=inner_rtol, max_iterations=max_iterations,
                           max_steps_cycle=max_iterations + 1, mat_for_precond=mat_for_precond,
                           relative_threshold=True, dot=dot,
                           iteration_budget=max_iterations - total_inner)
        v = v + d
        r = b - matvec_hi(v)  # the exact residual: refinement's anchor
        outer += 1
        total_inner += int(inner.steps)
    error = 0.5 * _row_sq(r)
    converged = torch.logical_not(torch.any(error > threshold))
    steps = torch.tensor(total_inner, dtype=torch.int32, device=v0.device)
    return v, CGStats(steps=steps, error=error, converged=converged)


def mixed_cg_loop(
    matvec_hi: Callable[[torch.Tensor], torch.Tensor],
    matvec_lo: Callable[[torch.Tensor], torch.Tensor],
    precond_apply: Callable,
    precond_state,
    b: torch.Tensor,
    v0: torch.Tensor,
    *,
    error_threshold: float,
    max_iterations: int,
    refresh_every: int = 32,
    drift_drop: float = 1e-2,
    stall_ratio: float = 0.25,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = _standard_dot,
    mat_for_precond: Optional[torch.Tensor] = None,
    relative_threshold: bool = False,
) -> Tuple[torch.Tensor, CGStats]:
    """CG on the cheap ``matvec_lo`` with drift-adaptive exact-residual
    replacement (reliable updates): one continuous recurrence whose cycle
    ends when the recursive residual's sum of squares has dropped by
    ``drift_drop`` since the cycle's exact anchor, when it meets the stop
    rule, or after ``refresh_every`` steps; the residual is then replaced
    by the exact ``b - v A`` (``matvec_hi``), and the momentum kept unless
    the cycle cut the exact sum of squares by less than ``stall_ratio``
    (then a steepest-descent restart).  Convergence is confirmed on the
    exact residual."""
    dtype, device = v0.dtype, v0.device
    zero = torch.zeros((), dtype=dtype, device=device)
    threshold = _targets(b, error_threshold, relative_threshold)

    def step(state: CGState) -> CGState:
        pa = matvec_lo(state.p)
        denom = dot(state.p, pa)
        indefinite = denom < -_MIN_FLOAT
        gamma = torch.where(denom <= _MIN_FLOAT, zero, state.rz / denom)
        v = state.v + gamma * state.p
        r = state.r - gamma * pa
        z, new_rz = precond_apply(precond_state, r, mat_for_precond)
        p = z + torch.where(indefinite | (state.rz <= _MIN_FLOAT), zero,
                            state.p * new_rz / state.rz)
        return CGState(state.i + 1, v, r, p, new_rz)

    r0 = b - matvec_hi(v0)
    z0, rz0 = precond_apply(precond_state, r0, mat_for_precond)
    state = CGState(0, v0, r0, z0, rz0)
    prev_err_sum = torch.sum(torch.square(r0))
    while state.i < max_iterations and bool(torch.any(0.5 * _row_sq(state.r) > threshold)):
        start_err_sum = torch.sum(torch.square(state.r))  # exact here: the drift anchor
        cycle_cap = min(state.i + refresh_every, max_iterations)
        while state.i < cycle_cap:
            go = torch.logical_and(torch.any(0.5 * _row_sq(state.r) > threshold),
                                   torch.sum(torch.square(state.r)) > drift_drop * start_err_sum)
            if not bool(go):
                break
            state = step(state)
        r = b - matvec_hi(state.v)  # reliable update: the exact residual
        z, new_rz = precond_apply(precond_state, r, mat_for_precond)
        exact_err_sum = torch.sum(torch.square(r))
        stalled = exact_err_sum > stall_ratio * prev_err_sum
        keep = torch.logical_and(torch.logical_not(stalled), state.rz > _MIN_FLOAT)
        p = z + torch.where(keep, state.p * new_rz / state.rz, zero)
        state = CGState(state.i, state.v, r, p, new_rz)
        prev_err_sum = exact_err_sum
    error = 0.5 * _row_sq(state.r)
    converged = torch.logical_not(torch.any(error > threshold))
    steps = torch.tensor(state.i, dtype=torch.int32, device=device)
    return state.v, CGStats(steps=steps, error=error, converged=converged)


# ---------------------------------------------------------------------------
# Dense-matrix CG with a hand-written backward pass
# ---------------------------------------------------------------------------


def _bf16_diagsplit_matvec(matrix: torch.Tensor):
    """Half-width matvec that keeps A's diagonal in full precision:
    ``A = offdiag(A)_bf16 + diag(A)``.  Rounding the diagonal to bf16 would
    erase a small SPD shift (Lambda ~ 2e-4 on diagonal entries ~1 rounds to
    exactly 1).  The bf16 product is summed into fp32 (JAX's
    ``preferred_element_type``): ``torch.mm(..., out_dtype=torch.float32)``
    on the card, which raises where the build lacks it; on the CPU the bf16
    operands widened to fp32, the same exact products summed in fp32."""
    diag = torch.diagonal(matrix).clone()
    matrix_bf16 = matrix.to(torch.bfloat16)
    matrix_bf16.diagonal().zero_()
    on_cpu = matrix.device.type == "cpu"
    if on_cpu:
        matrix_lo = matrix_bf16.to(torch.float32)
        del matrix_bf16

    def matvec(p: torch.Tensor) -> torch.Tensor:
        p_bf16 = p.to(torch.bfloat16)
        if on_cpu:
            out = torch.matmul(p_bf16.to(torch.float32), matrix_lo)
        else:
            out = torch.mm(p_bf16, matrix_bf16, out_dtype=torch.float32)
        return out.to(matrix.dtype) + p * diag[None, :]

    return matvec


def _matvec_high(matrix: torch.Tensor):
    """JAX's ``Precision.HIGH`` product: B1 (3xTF32) on a float32 system on
    the card, else the plain product."""
    if matrix.is_cuda and matrix.dtype == torch.float32:
        matrix32 = matrix.contiguous()

        def matvec(q):
            return pallas_matvec(q.to(torch.float32).contiguous(), matrix32)
    else:
        def matvec(q):
            return torch.matmul(q, matrix)
    return matvec


def _cg_dense_impl(precond_apply: Callable, error_threshold: float, max_iterations: int,
                   max_steps_cycle: int, dot_name: str, matvec_impl: str, relative: bool,
                   matrix: torch.Tensor, rhs: torch.Tensor, v0: torch.Tensor,
                   precond_state) -> Tuple[torch.Tensor, CGStats]:
    _check_supported(matvec_impl, dot_name)
    if matvec_impl == "pallas_resident":
        # The JAX eligibility rule: the whole solve runs in B2 only for the
        # identity preconditioner, the standard dot, no restart and an
        # absolute threshold; anything else takes the "xla" loop, as in JAX.
        eligible = (precond_state == () and dot_name == "standard"
                    and max_steps_cycle > max_iterations and not relative)
        if eligible:
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

    dot = _DOT_FNS[dot_name]
    if matvec_impl in ("bf16_ir", "bf16_ru"):
        # The hot loop streams a bf16 copy of A while exact residuals keep
        # the reachable threshold at fp32 level; out of the envelope
        # (check_bf16_envelope) the refinement stalls with finite iterates
        # and converged=False.
        def matvec_hi(q):
            return torch.matmul(q, matrix)

        loop = mixed_cg_loop if matvec_impl == "bf16_ru" else ir_cg_loop
        return loop(matvec_hi, _bf16_diagsplit_matvec(matrix), precond_apply, precond_state,
                    rhs, v0, error_threshold=error_threshold, max_iterations=max_iterations,
                    dot=dot, mat_for_precond=matrix, relative_threshold=relative)

    if matvec_impl == "pallas":
        matrix32 = matrix.to(torch.float32).contiguous()

        def matvec(q):
            return pallas_matvec(q.to(torch.float32).contiguous(), matrix32).to(q.dtype)
    elif matvec_impl == "xla_bf16":
        matvec = _bf16_diagsplit_matvec(matrix)
    elif matvec_impl == "xla_high":
        matvec = _matvec_high(matrix)
    else:
        def matvec(q):
            return torch.matmul(q, matrix)

    solution, stats = cg_loop(matvec, precond_apply, precond_state, rhs, v0,
                              error_threshold=error_threshold, max_iterations=max_iterations,
                              max_steps_cycle=max_steps_cycle, mat_for_precond=matrix,
                              relative_threshold=relative, dot=dot)
    if matvec_impl == "xla_bf16":
        # The recursion's residual is the bf16 system's, which keeps falling
        # past the true residual's floor: the flag reads the true residual
        # (one full-precision matvec), where JAX's reads the recursive one.
        true_r = rhs - torch.matmul(solution, matrix)
        converged = torch.logical_not(torch.any(
            0.5 * _row_sq(true_r) > _targets(rhs, error_threshold, relative)))
        stats = stats._replace(converged=converged)
    return solution, stats


class _CGDense(torch.autograd.Function):
    """``_cg_dense_impl`` with JAX's custom backward pass: another CG solve
    on the same route (B2 or B1 run again), ``db = A^{-1} dx`` from ``v0 =
    0`` and ``dA = -solution^T db`` (not symmetrised, as in JAX).  ``v0`` and
    the preconditioner state get no gradient; the stats are not
    differentiable."""

    @staticmethod
    def forward(ctx, config, matrix, rhs, v0, precond_state):
        precond_apply = config[0]
        solution, stats = _cg_dense_impl(precond_apply, *config[1:], matrix, rhs, v0,
                                         precond_state)
        ctx.config = config
        ctx.precond_state = precond_state
        ctx.save_for_backward(matrix, solution)
        ctx.mark_non_differentiable(stats.steps, stats.error, stats.converged)
        return solution, stats.steps, stats.error, stats.converged

    @staticmethod
    @once_differentiable
    def backward(ctx, dx, *_stat_grads):
        matrix, solution = ctx.saved_tensors
        db, _ = _cg_dense_impl(ctx.config[0], *ctx.config[1:], matrix, dx,
                               torch.zeros_like(dx), ctx.precond_state)
        da = -solution.T @ db if ctx.needs_input_grad[1] else None
        return None, da, db, None, None


def conjugate_gradient(
    matrix: torch.Tensor,
    rhs: torch.Tensor,
    initial_solution: torch.Tensor,
    error_threshold: float,
    preconditioner=None,
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
        preconditioner: an object with ``.apply(state, vec, mat)`` and
            ``.state``; None is the identity.
    Returns:
        ``(solution [m, n], CGStats(steps, error, converged))``, the
        solution differentiable with respect to ``matrix`` and ``rhs``
        through :class:`_CGDense`; the stats carry no gradient.
    """
    _check_supported(matvec_impl, dot)
    if preconditioner is None:
        preconditioner = EyePreconditioner()
    if not (hasattr(preconditioner, "apply") and hasattr(preconditioner, "state")):
        raise TypeError(f"{type(preconditioner).__name__} is not a preconditioner: it needs "
                        "apply(state, vec, mat) and state")
    if max_iterations is None:
        max_iterations = matrix.shape[-1]
    config = _cg_config(preconditioner, error_threshold, max_iterations, max_steps_cycle, dot,
                        matvec_impl, relative_threshold)
    solution, steps, error, converged = _CGDense.apply(config, matrix, rhs, initial_solution,
                                                       preconditioner.state)
    return solution, CGStats(steps=steps, error=error, converged=converged)


def _cg_config(preconditioner, error_threshold, max_iterations, max_steps_cycle, dot,
               matvec_impl, relative_threshold) -> tuple:
    """A solve's static configuration, as :class:`_CGDense` and the log-det
    estimators take it: ``(apply, threshold, max_iterations,
    max_steps_cycle, dot, matvec_impl, relative)``."""
    return (preconditioner.apply, float(error_threshold), int(max_iterations),
            int(max_steps_cycle), dot, matvec_impl, bool(relative_threshold))


class ConjugateGradient:
    """Column-major facade: callable on ``(matrix [n, n], rhs [n, m])``.

    Transposes to the internal row convention, uses a zero initial solution,
    defaults ``max_iterations = n`` and ``max_steps_cycle = max_iterations +
    1`` (never restart), and returns the [n, m] solution.
    """

    def __init__(
        self,
        error_threshold: float,
        preconditioner=None,
        max_iterations: Optional[int] = None,
        max_steps_cycle: Optional[int] = None,
        dot: str = "standard",
        matvec_impl: str = "xla",
        relative_threshold: bool = False,
    ):
        _check_supported(matvec_impl, dot)
        self.error_threshold = error_threshold
        self.preconditioner = preconditioner if preconditioner is not None else EyePreconditioner()
        self.max_iterations = max_iterations
        self.max_steps_cycle = max_steps_cycle
        self.dot = dot
        self.matvec_impl = matvec_impl
        self.relative_threshold = relative_threshold

    def limits(self, n: int) -> Tuple[int, int]:
        """``(max_iterations, max_steps_cycle)`` for an [n, n] system: ``n``
        and ``max_iterations + 1`` (never restart inside the run) unless
        set."""
        max_iterations = self.max_iterations if self.max_iterations is not None else n
        max_steps_cycle = (self.max_steps_cycle if self.max_steps_cycle is not None
                           else max_iterations + 1)
        return max_iterations, max_steps_cycle

    # Off-diagonal bf16 rounding unit: the diag-split matvec keeps the
    # diagonal in fp32, so the perturbation is eps_bf16 * max|A_offdiag|.
    _BF16_EPS = 2.0 ** -8

    def check_bf16_envelope(self, matrix: torch.Tensor) -> str:
        """The route to use for ``matrix``: the configured one, except that
        a ``"bf16_ir"`` / ``"bf16_ru"`` system whose bf16 perturbation
        ``eps_bf16 * max|A_offdiag|`` reaches the Lanczos estimate of
        ``lambda_min`` (64 matvecs from a normal start seeded 0, through
        :func:`~cggp_tpu_torch.ops.logdet.lanczos_extremal_eigs`) resolves
        to ``"xla_high"`` with a ``RuntimeWarning``: there the refinement
        would stall below fp32 accuracy.  The verdict for the last matrix
        is kept, so repeated solves against it pay the estimate once."""
        if self.matvec_impl not in ("bf16_ir", "bf16_ru"):
            return self.matvec_impl
        memo = getattr(self, "_bf16_memo", None)
        if memo is not None and memo[0]() is matrix:
            return memo[1]
        from cggp_tpu_torch.ops import logdet

        n = matrix.shape[-1]
        with torch.no_grad():
            gen = torch.Generator(device=matrix.device).manual_seed(0)
            eig_min, _eig_max = logdet.lanczos_extremal_eigs(matrix.detach(), gen,
                                                             num_iters=min(64, n))
            offdiag = matrix.detach().clone()
            offdiag.diagonal().zero_()
            offdiag_scale = float(torch.max(torch.abs(offdiag)))
            del offdiag
        perturbation = self._BF16_EPS * offdiag_scale
        if perturbation >= float(eig_min):
            warnings.warn(
                f"matvec_impl={self.matvec_impl!r} is outside its convergence envelope for "
                f"this system (bf16 perturbation ~{perturbation:.2e} >= estimated lambda_min "
                f"{float(eig_min):.2e}): the mixed-precision loop would stall below fp32 "
                "accuracy. Falling back to 'xla_high' for this solve.", RuntimeWarning)
            resolved = "xla_high"
        else:
            resolved = self.matvec_impl
        self._bf16_memo = (weakref.ref(matrix), resolved)  # keeps no system alive
        return resolved

    def solve_with_stats(
        self, matrix: torch.Tensor, rhs: torch.Tensor,
        initial_solution: Optional[torch.Tensor] = None,
        preconditioner=None,
    ) -> Tuple[torch.Tensor, CGStats]:
        rhs_t = rhs.T
        v0 = torch.zeros_like(rhs_t) if initial_solution is None else initial_solution.T
        max_iterations, max_steps_cycle = self.limits(matrix.shape[-1])
        solution, stats = conjugate_gradient(
            matrix, rhs_t, v0, self.error_threshold,
            preconditioner=preconditioner or self.preconditioner,
            max_iterations=max_iterations, max_steps_cycle=max_steps_cycle,
            dot=self.dot, matvec_impl=self.check_bf16_envelope(matrix),
            relative_threshold=self.relative_threshold,
        )
        return solution.T, stats

    def __call__(self, matrix: torch.Tensor, rhs: torch.Tensor,
                 initial_solution: Optional[torch.Tensor] = None,
                 preconditioner=None) -> torch.Tensor:
        solution, _stats = self.solve_with_stats(matrix, rhs, initial_solution,
                                                 preconditioner=preconditioner)
        return solution

    def solve_chunked(self, matrix: torch.Tensor, rhs: torch.Tensor,
                      chunk_iterations: int = 64, max_chunks: int = 64,
                      preconditioner=None) -> Tuple[torch.Tensor, CGStats]:
        """Host-driven CG in chunks of at most ``chunk_iterations`` steps
        (column convention, like ``__call__``), for bounded work per call.

        On the ``"xla"`` and ``"xla_high"`` routes each chunk re-anchors on
        the true residual ``b - v A`` and carries the search direction in
        (residual replacement, :func:`_dense_chunk`); a carried chunk whose
        summed residual grows is dropped and redone fresh from the same
        anchor.  The other routes restart a facade solve on the true
        residual each chunk (their loops anchor themselves).  ``steps`` is
        an upper bound (``chunks * chunk_iterations`` on the carried path:
        a last chunk that stops early is not seen from out here);
        ``converged`` and ``error`` come from the true-residual anchors."""
        b_norm2 = 0.5 * torch.sum(torch.square(rhs), dim=0)
        threshold = torch.tensor(self.error_threshold, dtype=rhs.dtype, device=rhs.device)
        target = threshold * b_norm2 if self.relative_threshold else threshold.expand_as(b_norm2)
        resolved_impl = self.check_bf16_envelope(matrix)
        if resolved_impl in ("xla", "xla_high"):
            precond = preconditioner or self.preconditioner or EyePreconditioner(self.dot)
            rhs_rows = rhs.T
            v = torch.zeros_like(rhs_rows)
            p = None
            err = b_norm2
            chunks = 0
            for _ in range(max_chunks):
                if bool(torch.all(err <= target)):
                    break
                err_sum = float(torch.sum(err))
                v_new, p_new, err_new = _dense_chunk(
                    precond.apply, chunk_iterations, float(self.error_threshold),
                    bool(self.relative_threshold), self.dot, matrix, rhs_rows, v, p,
                    precond.state)
                chunks += 1
                if p is not None and float(torch.sum(err_new)) > err_sum:
                    p = None
                    continue
                v, p, err = v_new, p_new, err_new
            converged = bool(torch.all(err <= target))
            return v.T, CGStats(steps=torch.tensor(chunks * chunk_iterations),
                                error=err[:, None], converged=torch.tensor(converged))
        solution = torch.zeros_like(rhs)
        chunk_solver = ConjugateGradient(
            float(torch.min(target)), preconditioner=preconditioner or self.preconditioner,
            max_iterations=chunk_iterations, dot=self.dot, matvec_impl=resolved_impl,
            relative_threshold=False)
        total_steps = 0
        exhausted = True
        for _ in range(max_chunks):
            residual = rhs - matrix @ solution
            err = 0.5 * torch.sum(torch.square(residual), dim=0)
            if bool(torch.all(err <= target)):
                exhausted = False
                break
            delta, stats = chunk_solver.solve_with_stats(matrix, residual)
            solution = solution + delta
            total_steps += int(stats.steps)
        if exhausted:
            # The last correction is not yet in err: take the residual again.
            residual = rhs - matrix @ solution
            err = 0.5 * torch.sum(torch.square(residual), dim=0)
        converged = bool(torch.all(err <= target))
        return solution, CGStats(steps=torch.tensor(total_steps), error=err[:, None],
                                 converged=torch.tensor(converged))


def _dense_chunk(precond_apply, chunk_iterations: int, error_threshold: float, relative: bool,
                 dot_name: str, matrix: torch.Tensor, rhs_rows: torch.Tensor, v: torch.Tensor,
                 p0: Optional[torch.Tensor], precond_state):
    """One residual-replacement CG chunk on a dense system (row
    convention): the entry re-anchors on the true residual and ``p0``
    (``None``: a fresh start) carries the direction in.  Returns ``(v, p,
    0.5 ||r||^2`` per row``)``."""
    with torch.no_grad():
        v_out, _stats, state = cg_loop(
            lambda q: torch.matmul(q, matrix), precond_apply, precond_state, rhs_rows, v,
            error_threshold=error_threshold, max_iterations=chunk_iterations,
            max_steps_cycle=chunk_iterations + 1, mat_for_precond=matrix,
            relative_threshold=relative, p0=p0, return_state=True, dot=_DOT_FNS[dot_name])
    return v_out, state.p, 0.5 * torch.sum(torch.square(state.r), dim=-1)
