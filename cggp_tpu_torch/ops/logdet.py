"""Log-determinant estimators built on CG (port of ``cggp_tpu/ops/logdet.py``,
the dense estimators).

* :func:`eval_logdet` — the reference semantics: the *value* is the
  constant 0 and only the gradient is defined, ``d logdet / dA = A^{-1}``,
  by CG against the identity or by a Rademacher/Hutchinson estimate.
* :func:`eval_logdet_from_solves` — the same Hutchinson gradient from probe
  solutions the caller already has (the fused ELBO's): no extra CG solve.
* :func:`slq_logdet` — a stochastic Lanczos quadrature *value* with the same
  CG-probe gradient.
* :func:`lanczos_extremal_eigs` — extremal Ritz values, for the
  chol-or-CG conditioning policies.
* The estimators over an implicit operator (no [M, M] argument), for the
  matrix-free model: :func:`make_matfree_logdet_from_solves`,
  :func:`make_matfree_eval_logdet` and :func:`make_matfree_slq_logdet`,
  whose gradients are the Hutchinson VJP of the model's matvec, and the
  batched row Lanczos behind the SLQ value (:func:`lanczos_tridiag_rows`,
  :func:`slq_value_rows`).

Randomness comes from a ``torch.Generator`` where JAX takes a PRNG key;
:func:`rademacher` draws on the generator's device.  Callers look it up by
name when they run, so tests can substitute the JAX package's probes.

* The LOVE serving cache (Pleiss et al. 2018, matrix-free): a rank-k
  Lanczos decomposition of the system from one seed row
  (:func:`love_seed_row`) gives ``R`` [k, M] with ``x^T A^{-1} x ~=
  ||R x||^2`` (:func:`lanczos_quad_cache_rows`), and
  :func:`love_variance` turns a batch's cross-kernel rows into
  conservative predictive variances with two skinny products.
* :func:`lanczos_extremal_eigs_rows` — the extremal Ritz values through a
  row-convention matvec.

Normal start vectors come from :func:`normal_draw` (the JAX package draws
them from ``PRNGKey(0)``), also looked up by name, so tests can substitute
JAX's draws.

The host-chunked names (``lanczos_tridiag_rows_chunked``,
``slq_value_rows_chunked``, ``lanczos_quad_cache_rows_chunked``) are the
same functions: in eager torch every Lanczos step is a dispatch of its own
already.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from torch.autograd.function import once_differentiable

from cggp_tpu_torch import tracing
from cggp_tpu_torch.ops.cg import ConjugateGradient, _cg_config, _cg_dense_impl
from cggp_tpu_torch.ops.cg_implicit import matvec_vjp


def rademacher(generator: torch.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    """+-1 probes in ``dtype``, drawn from ``generator`` on its device."""
    bits = torch.randint(0, 2, tuple(shape), generator=generator, device=generator.device)
    return (2 * bits - 1).to(dtype)


def normal_draw(generator: torch.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    """Standard normal draws in ``dtype`` from ``generator``, on its device."""
    return torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=dtype)


def _logdet_grad(df, matrix, probes, precond_apply, precond_state, threshold,
                 max_iterations, max_steps_cycle, dot_name,
                 matvec_impl="xla", relative=False):
    """Shared backward rule: ``df * A^{-1}`` (dense, or probe-estimated), with
    the caller's solver configuration."""
    n = matrix.shape[-1]
    if probes is None:
        eye = torch.eye(n, dtype=matrix.dtype, device=matrix.device)
        inv, _ = _cg_dense_impl(precond_apply, threshold, max_iterations, max_steps_cycle,
                                dot_name, matvec_impl, relative, matrix, eye,
                                torch.zeros_like(eye), precond_state)
        # A row-convention solve of the identity is A^{-T}; transposed as in
        # the reference, though A is symmetric.
        return df * inv.T
    num_probes = probes.shape[-1]
    rv = df * probes  # [n, P]
    lv, _ = _cg_dense_impl(precond_apply, threshold, max_iterations, max_steps_cycle,
                           dot_name, matvec_impl, relative, matrix, probes.T,
                           torch.zeros_like(probes.T), precond_state)  # [P, n]
    return (lv.T @ rv.T) / num_probes


class _EvalLogdet(torch.autograd.Function):
    """Value 0; gradient :func:`_logdet_grad` (identity or probes)."""

    @staticmethod
    def forward(ctx, config, use_probes, matrix, probes, precond_state):
        ctx.config = config
        ctx.use_probes = use_probes
        ctx.precond_state = precond_state
        ctx.save_for_backward(matrix, probes)
        return torch.zeros((), dtype=matrix.dtype, device=matrix.device)

    @staticmethod
    def backward(ctx, df):
        matrix, probes = ctx.saved_tensors
        precond_apply, threshold, max_iterations, max_steps_cycle, dot_name, \
            matvec_impl, relative = ctx.config
        da = _logdet_grad(df, matrix, probes if ctx.use_probes else None, precond_apply,
                          ctx.precond_state, threshold, max_iterations, max_steps_cycle,
                          dot_name, matvec_impl, relative)
        return None, None, da, None, None


def _cg_static(cg: ConjugateGradient, n: int, preconditioner=None):
    """The estimators' solver configuration: ``(apply, threshold,
    max_iterations, max_steps_cycle, dot, matvec_impl, relative, state)``.
    ``preconditioner`` overrides the facade's own, so the gradient's solves
    run under the training step's preconditioner."""
    pre = preconditioner if preconditioner is not None else cg.preconditioner
    return (*_cg_config(pre, cg.error_threshold, *cg.limits(n), cg.dot, cg.matvec_impl,
                        cg.relative_threshold), pre.state)


def eval_logdet(matrix: torch.Tensor, cg: ConjugateGradient, num_probes: Optional[int] = None,
                key: Optional[torch.Generator] = None, preconditioner=None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero-valued log-det whose gradient is ``A^{-1}`` by CG: against the
    identity with ``num_probes=None``, else from ``num_probes`` Rademacher
    probes drawn from ``key``.  ``mask`` [n] zeroes probe entries at the pad
    rows of a capacity-padded system (probes only)."""
    n = matrix.shape[-1]
    *config, state = _cg_static(cg, n, preconditioner)
    if num_probes is None:
        if mask is not None:
            raise ValueError("eval_logdet(mask=...) requires num_probes — the "
                             "identity-solve gradient would re-couple the pad rows")
        probes = torch.zeros((n, 1), dtype=matrix.dtype, device=matrix.device)  # unused
        use_probes = False
    else:
        if key is None:
            raise ValueError("eval_logdet with num_probes requires an explicit generator")
        probes = rademacher(key, (n, num_probes), matrix.dtype)
        if mask is not None:
            probes = probes * mask[:, None]
        use_probes = True
    return _EvalLogdet.apply(tuple(config), use_probes, matrix, probes, state)


class _EvalLogdetFromSolves(torch.autograd.Function):
    @staticmethod
    def forward(ctx, matrix, probes, solved_probes):
        ctx.save_for_backward(probes, solved_probes)
        # One zero per system: 0-d, or [G] for a gang's stacked systems.
        return torch.zeros(probes.shape[:-2], dtype=probes.dtype, device=probes.device)

    @staticmethod
    def backward(ctx, df):
        probes, solved_probes = ctx.saved_tensors
        da = (df[..., None, None] / probes.shape[-1]) * (solved_probes @ probes.mT)
        return da, None, None


def eval_logdet_from_solves(matrix: torch.Tensor, probes: torch.Tensor,
                            solved_probes: torch.Tensor) -> torch.Tensor:
    """Zero-valued log-det whose gradient reuses precomputed probe solves
    ``solved_probes = A^{-1} probes`` ([n, P] columns, taken as constants):
    ``dA = df * solved_probes probes^T / P``, with zero extra CG loops."""
    return _EvalLogdetFromSolves.apply(matrix, probes, solved_probes.detach())


# ---------------------------------------------------------------------------
# Stochastic Lanczos quadrature
# ---------------------------------------------------------------------------


def _lanczos_tridiag(matrix: torch.Tensor, v0: torch.Tensor, num_iters: int):
    """Lanczos with full reorthogonalisation (two passes); returns
    ``(alphas [k], betas [k - 1])``."""
    n = matrix.shape[-1]
    v0 = v0 / torch.linalg.vector_norm(v0)
    basis = torch.zeros((num_iters, n), dtype=matrix.dtype, device=matrix.device)
    basis[0] = v0
    alphas = torch.zeros((num_iters,), dtype=matrix.dtype, device=matrix.device)
    betas = torch.zeros((num_iters,), dtype=matrix.dtype, device=matrix.device)
    for i in range(num_iters):
        v = basis[i]
        w = matrix @ v
        alpha = torch.dot(w, v)
        w = w - alpha * v
        for _ in range(2):
            w = w - basis.T @ (basis @ w)
        beta = torch.linalg.vector_norm(w)
        safe_beta = torch.where(beta > 0, beta, torch.ones_like(beta))
        if i + 1 < num_iters:
            basis[i + 1] = torch.where(beta > 0, w / safe_beta, torch.zeros_like(w))
        alphas[i] = alpha
        betas[i] = beta
    return alphas, betas[:-1]


def _tridiag(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    return torch.diag(alphas) + torch.diag(betas, 1) + torch.diag(betas, -1)


def _slq_value(matrix: torch.Tensor, probes: torch.Tensor, lanczos_iters: int) -> torch.Tensor:
    """SLQ estimate of ``logdet(A)`` from probes [n, P], each probe's
    quadrature weighted by its own ``||z||^2`` (``n`` for full Rademacher
    probes; masked probes target the real submatrix)."""
    tiny = torch.finfo(matrix.dtype).tiny
    per_probe = []
    for j in range(probes.shape[-1]):
        z = probes[:, j]
        alphas, betas = _lanczos_tridiag(matrix, z, lanczos_iters)
        evals, evecs = tracing.host_read(_tridiag(alphas, betas), torch.linalg.eigh)
        evals = torch.clamp(evals, min=tiny)
        weights = torch.square(evecs[0, :])
        per_probe.append(torch.sum(z * z) * torch.sum(weights * torch.log(evals)))
    return torch.mean(torch.stack(per_probe))


class _SLQLogdet(torch.autograd.Function):
    """Value :func:`_slq_value`; gradient the CG-probe estimate."""

    @staticmethod
    def forward(ctx, config, lanczos_iters, matrix, probes, precond_state):
        ctx.config = config
        ctx.precond_state = precond_state
        ctx.save_for_backward(matrix, probes)
        return _slq_value(matrix, probes, lanczos_iters)

    @staticmethod
    def backward(ctx, df):
        matrix, probes = ctx.saved_tensors
        precond_apply, threshold, max_iterations, max_steps_cycle, dot_name, \
            matvec_impl, relative = ctx.config
        da = _logdet_grad(df, matrix, probes, precond_apply, ctx.precond_state, threshold,
                          max_iterations, max_steps_cycle, dot_name, matvec_impl, relative)
        return None, None, da, None, None


def slq_logdet(matrix: torch.Tensor, cg: ConjugateGradient, num_probes: int,
               key: torch.Generator, lanczos_iters: int = 25, preconditioner=None,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stochastic-Lanczos-quadrature log-det value with the CG-probe
    gradient of :func:`eval_logdet`.  ``mask`` [n] (1 real / 0 pad) zeroes
    probe entries at pad rows, so value and gradient target the real
    submatrix of a capacity-padded system."""
    n = matrix.shape[-1]
    *config, state = _cg_static(cg, n, preconditioner)
    probes = rademacher(key, (n, num_probes), matrix.dtype)
    if mask is not None:
        probes = probes * mask[:, None]
    return _SLQLogdet.apply(tuple(config), int(lanczos_iters), matrix, probes, state)


def lanczos_extremal_eigs(matrix: torch.Tensor, key: torch.Generator, num_iters: int = 64):
    """Estimates ``(eig_min, eig_max)`` of a symmetric PSD matrix from the
    extremal Ritz values of a ``num_iters``-step Lanczos run from a normal
    start vector drawn from ``key``: ``eig_min`` over-, ``eig_max``
    under-estimated, percent-level after a few dozen steps on kernel
    spectra.  Returns two 0-d tensors on the matrix's device."""
    n = matrix.shape[-1]
    v0 = normal_draw(key, (n,), matrix.dtype)
    alphas, betas = _lanczos_tridiag(matrix, v0, num_iters)
    return _ritz_extremes(alphas, betas)


def _ritz_extremes(alphas: torch.Tensor, betas: torch.Tensor):
    """``(eig_min, eig_max)`` Ritz estimates from Lanczos (alphas [k], betas
    [k - 1]).  Rows after an early termination (beta == 0) are filled with a
    Rayleigh quotient on the diagonal, so they are never extremal."""
    bad = torch.cat([torch.zeros((1,), dtype=torch.bool, device=betas.device), betas <= 0.0])
    used = torch.cumsum(bad.to(torch.int32), dim=0) == 0
    diag = torch.where(used, alphas, alphas[0])
    off = torch.where(used[1:], betas, torch.zeros_like(betas))
    evs = tracing.host_read(_tridiag(diag, off), torch.linalg.eigvalsh)
    return evs[0], evs[-1]


# ---------------------------------------------------------------------------
# Estimators over an implicit operator (no [M, M] matrix argument), for the
# matrix-free model (models/rowcg.py).  Conventions:
#   matvec(kp, z, lam, mask, rows [R, M]) -> rows @ (K(Z,Z)*mask + diag(lam))
#   solve(kp, z, lam, rows, precond_state, mask) -> (solution_rows, stats)
#   precond_state_fn(kp, z, lam, mask) -> solver state (() = identity)
# Each returns ``logdet(kp, z, lam, mask, probes[, solved])``, differentiable
# in the kernel parameters, ``z`` and ``lam``; probes are [P, M] rows.
# ---------------------------------------------------------------------------


class _MatfreeLogdet(torch.autograd.Function):
    """Value ``spec.value(kp, z, lam, mask, probes)`` (0 or SLQ); gradient
    ``vjp(matvec at probes)(solved * df / P)`` (Hutchinson), with ``solved``
    given (already solved probes, constants) or solved in the backward pass
    under ``spec.precond_state_fn``'s state."""

    @staticmethod
    def forward(ctx, spec, kp_names, mask, probes, solved, z, lam, *kp_values):
        kp = dict(zip(kp_names, kp_values))
        ctx.spec, ctx.kp_names, ctx.mask, ctx.solved = spec, kp_names, mask, solved
        ctx.save_for_backward(probes, z, lam, *kp_values)
        if spec.value is None:
            return torch.zeros((), dtype=probes.dtype, device=probes.device)
        return spec.value(kp, z, lam, mask, probes)

    @staticmethod
    @once_differentiable
    def backward(ctx, df):
        probes, z, lam, *kp_values = ctx.saved_tensors
        kp = dict(zip(ctx.kp_names, kp_values))
        spec, mask = ctx.spec, ctx.mask
        solved = ctx.solved
        if solved is None:
            state = () if spec.precond_state_fn is None else spec.precond_state_fn(kp, z, lam,
                                                                                   mask)
            solved, _ = spec.solve(kp, z, lam, probes, state, mask)  # rows of A^{-1} p
        w = solved * (df / probes.shape[0])
        # d logdet / d theta = tr(A^{-1} dA/dtheta) ~= (1/P) sum_p solved_p^T dA probe_p
        needs = (*ctx.needs_input_grad[7:], ctx.needs_input_grad[5], ctx.needs_input_grad[6])
        grads = matvec_vjp(spec.matvec, kp, z, lam, mask, probes, w, needs)
        return (None, None, None, None, None, grads[-2], grads[-1], *grads[:-2])


class _MatfreeSpec:
    def __init__(self, matvec, value=None, solve=None, precond_state_fn=None):
        self.matvec, self.value, self.solve = matvec, value, solve
        self.precond_state_fn = precond_state_fn


def _apply_matfree(spec, kp, z, lam, mask, probes, solved=None):
    names = tuple(kp)
    if mask is not None:
        mask = mask.detach()
    return _MatfreeLogdet.apply(spec, names, mask, probes.detach(),
                                None if solved is None else solved.detach(), z, lam,
                                *(kp[k] for k in names))


def make_matfree_logdet_from_solves(matvec):
    """Zero-valued logdet whose gradient reuses already-solved probes
    (``solved = A^{-1} probes`` rows from a fused solve, taken as
    constants): ``theta_bar = df / P * vjp(matvec at probes)(solved)``, no
    extra CG loop."""
    spec = _MatfreeSpec(matvec)

    def logdet(kp, z, lam, mask, probes, solved):
        return _apply_matfree(spec, kp, z, lam, mask, probes, solved)

    return logdet


def make_matfree_eval_logdet(matvec, solve, precond_state_fn=None):
    """Zero-valued logdet over the implicit matrix; the gradient is the
    Rademacher/CG trace estimator: a matrix-free solve of the probes in the
    backward pass, under ``precond_state_fn``'s state (the identity without
    it), and one VJP of the matvec."""
    spec = _MatfreeSpec(matvec, solve=solve, precond_state_fn=precond_state_fn)

    def logdet(kp, z, lam, mask, probes):
        return _apply_matfree(spec, kp, z, lam, mask, probes)

    return logdet


def make_matfree_slq_logdet(slq_value, matvec, solve, precond_state_fn=None):
    """SLQ logdet value over the implicit matrix (``slq_value(kp, z, lam,
    mask, probes [P, M]) -> scalar``, e.g. :func:`slq_value_rows` over the
    model's matvec), with the gradient of :func:`make_matfree_eval_logdet`."""
    spec = _MatfreeSpec(matvec, value=slq_value, solve=solve,
                        precond_state_fn=precond_state_fn)

    def logdet(kp, z, lam, mask, probes):
        return _apply_matfree(spec, kp, z, lam, mask, probes)

    return logdet


def lanczos_tridiag_rows(matvec_rows, v0_rows: torch.Tensor, num_iters: int,
                         return_basis: bool = False):
    """Batched matrix-free Lanczos with full reorthogonalisation (twice).

    ``matvec_rows`` maps [P, M] rows to ``v @ A`` rows; all P start vectors
    advance together, one matvec a step.  Returns ``(alphas [k, P], betas
    [k - 1, P])``, and with ``return_basis`` also the orthonormal basis
    ``[k, P, M]`` (zero rows past an early termination)."""
    p, m = v0_rows.shape
    dtype, device = v0_rows.dtype, v0_rows.device
    norms = torch.linalg.vector_norm(v0_rows, dim=-1, keepdim=True)
    v0 = v0_rows / torch.where(norms > 0, norms, torch.ones_like(norms))
    basis = torch.zeros((num_iters, p, m), dtype=dtype, device=device)
    basis[0] = v0
    alphas = torch.zeros((num_iters, p), dtype=dtype, device=device)
    betas = torch.zeros((num_iters, p), dtype=dtype, device=device)
    for i in range(num_iters):
        v = basis[i]
        w = matvec_rows(v)
        alpha = torch.sum(w * v, dim=-1)
        w = w - alpha[:, None] * v
        # Unfilled basis rows are zero, so projecting on them is a no-op.
        for _ in range(2):
            coef = torch.einsum("kpm,pm->kp", basis, w)
            w = w - torch.einsum("kp,kpm->pm", coef, basis)
        beta = torch.linalg.vector_norm(w, dim=-1)
        safe = torch.where(beta > 0, beta, torch.ones_like(beta))
        if i + 1 < num_iters:
            basis[i + 1] = torch.where((beta > 0)[:, None], w / safe[:, None],
                                       torch.zeros_like(w))
        alphas[i] = alpha
        betas[i] = beta
    if return_basis:
        return alphas, betas[:-1], basis
    return alphas, betas[:-1]


def slq_value_rows(matvec_rows, probes_rows: torch.Tensor, lanczos_iters: int) -> torch.Tensor:
    """SLQ ``logdet`` estimate from row probes [P, M] through a matvec.  Each
    probe is weighted by its own ``||z_p||^2``, so masked probes (zero on
    pads) estimate the log-det of the real submatrix: their Krylov space
    never leaves the real coordinates."""
    alphas, betas = lanczos_tridiag_rows(matvec_rows, probes_rows, lanczos_iters)
    return _slq_from_tridiag(alphas, betas, probes_rows)


def love_seed_row(u_row: torch.Tensor, mask_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Krylov seed of the LOVE cache: the cache's own right-hand side
    ``u_row`` [1, M] (pre-masked if padded), or, where that row is all
    zero (a hyperparameters-only config dir) and would give a zero basis
    and prior variances, a normal row from a generator seeded 0
    (:func:`normal_draw`) times ``mask_row`` [1, M], so the Krylov space
    never leaves the real coordinates.  The norm is decided on the device:
    no host read."""
    u_row = u_row.detach()
    gen = torch.Generator(device=u_row.device).manual_seed(0)
    fallback = normal_draw(gen, u_row.shape, u_row.dtype)
    if mask_row is not None:
        fallback = fallback * mask_row.detach()
    return torch.where(torch.linalg.vector_norm(u_row) > 0.0, u_row, fallback)


def love_variance(lanczos_r: torch.Tensor, kmn_rows: torch.Tensor, knn: torch.Tensor,
                  full_cov: bool):
    """Predictive (co)variance from a LOVE cache: ``quad(x) ~= ||R k(x)||^2``
    with ``R`` [k, M], an under-estimate of the exact quadratic form, so
    the variance is a conservative over-estimate.  ``kmn_rows`` [T, M]
    (dense callers pass ``kmn.T``); ``knn`` the [T] kernel diagonal, or the
    [T, T] block with ``full_cov``.  Returns [T, 1], or [1, T, T]."""
    rk = lanczos_r @ kmn_rows.T  # [k, T]
    if full_cov:
        return (knn - rk.T @ rk)[None, ...]
    return (knn - torch.sum(torch.square(rk), dim=0))[:, None]


def lanczos_quad_cache_rows(matvec_rows, start_row: torch.Tensor, rank: int) -> torch.Tensor:
    """Rank-``k`` quadratic-form cache of ``A^{-1}`` (LOVE serving, done
    matrix-free): from a k-step Lanczos decomposition ``A ~ Q^T T Q`` (Q
    [k, M] orthonormal rows) returns ``R = L_T^{-1} Q``, ``T = L_T L_T^T``,
    so ``x^T A^{-1} x ~= ||R x||^2``.  The Gauss-quadrature estimate
    under-approximates the quadratic form of an SPD ``A``, converging as
    ``rank`` grows, exact at ``rank = M``.  ``start_row`` [1, M] seeds the
    Krylov space (:func:`love_seed_row`); ``rank`` matvecs."""
    alphas, betas, basis = lanczos_tridiag_rows(matvec_rows, start_row, rank,
                                                return_basis=True)
    return _love_cache_from_tridiag(alphas, betas, basis)


def _love_cache_from_tridiag(alphas: torch.Tensor, betas: torch.Tensor,
                             basis: torch.Tensor) -> torch.Tensor:
    """``R = L_T^{-1} Q`` from a one-seed Lanczos decomposition.  Past the
    Krylov space's exhaustion beta is reorthogonalisation residue, not an
    exact zero, and the basis rows after it are normalised noise that would
    corrupt T and R (rank above the dimension inflated quadratic forms 1.7x
    in the JAX package before this cut): cut at ``sqrt(eps) * max(max|a|,
    max b)``, give T an identity block there and zero those basis rows, so
    their R rows vanish."""
    a, b = alphas[:, 0], betas[:, 0]
    q = basis[:, 0, :]  # [k, M]
    dtype = q.dtype
    tol = math.sqrt(torch.finfo(dtype).eps) * torch.maximum(
        torch.max(torch.abs(a)), torch.max(b) if b.numel() else torch.zeros_like(a[0]))
    bad = torch.cat([torch.zeros((1,), dtype=torch.bool, device=a.device), b <= tol])
    used = torch.cumsum(bad.to(torch.int32), dim=0) == 0
    q = torch.where(used[:, None], q, torch.zeros_like(q))
    diag = torch.where(used, a, torch.ones_like(a))
    off = torch.where(used[1:], b, torch.zeros_like(b))
    t = _tridiag(diag, off)
    chol = tracing.host_read(t, torch.linalg.cholesky)
    return torch.linalg.solve_triangular(chol, q, upper=False)  # [k, M]


# The JAX package's host-chunked Lanczos (one bounded dispatch a step) runs
# the same recurrence, so the same numbers: in eager torch they are these.
lanczos_tridiag_rows_chunked = lanczos_tridiag_rows
slq_value_rows_chunked = slq_value_rows
lanczos_quad_cache_rows_chunked = lanczos_quad_cache_rows


def lanczos_extremal_eigs_rows(matvec_rows, key: torch.Generator, n: int, dtype,
                               num_iters: int = 64, mask: Optional[torch.Tensor] = None):
    """Matrix-free :func:`lanczos_extremal_eigs` through a row-convention
    matvec (``[1, M] -> v @ A``), from a normal start row drawn from
    ``key``; ``mask`` keeps the Krylov space (and so the estimate) inside
    the real coordinates of a padded system."""
    v0 = normal_draw(key, (1, n), dtype)
    if mask is not None:
        v0 = v0 * mask.reshape(1, -1)
    alphas, betas = lanczos_tridiag_rows(matvec_rows, v0, num_iters)
    return _ritz_extremes(alphas[:, 0], betas[:, 0])


def _slq_from_tridiag(alphas: torch.Tensor, betas: torch.Tensor,
                      probes_rows: torch.Tensor) -> torch.Tensor:
    """Gauss-quadrature logdet from per-probe tridiagonals (alphas [k, P],
    betas [k - 1, P])."""
    a, b = alphas.T, betas.T  # [P, k], [P, k - 1]
    t = torch.diag_embed(a) + torch.diag_embed(b, 1) + torch.diag_embed(b, -1)
    evals, evecs = tracing.host_read(t, torch.linalg.eigh)
    evals = torch.clamp(evals, min=torch.finfo(probes_rows.dtype).tiny)
    quad = torch.sum(torch.square(evecs[:, 0, :]) * torch.log(evals), dim=-1)  # [P]
    scale = torch.sum(torch.square(probes_rows), dim=-1)  # ||z_p||^2
    return torch.mean(scale * quad)
