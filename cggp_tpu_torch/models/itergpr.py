"""IterGPR: exact GP regression by matrix-free CG (port of
``cggp_tpu/models/itergpr.py``).

The exact posterior of :class:`~cggp_tpu_torch.models.gpr.GPR`, with every
factorization of the [N, N] system ``K(X, X) + sigma^2 I`` replaced by the
matrix-free machinery, so the system is never built:

* solves: :func:`~cggp_tpu_torch.ops.cg_implicit.make_implicit_cg` — CG
  over [block, N] kernel panels built on the fly, or every matvec through
  kernel B3 with ``use_pallas=True``; its backward pass is a second solve
  on the same route;
* the log marginal likelihood: the quadratic term through the solve's
  custom backward, the log-det gradient by Hutchinson from the probe rows
  solved in the same fused ``[y | probes]`` solve, and with
  ``logdet_variant="slq"`` a stochastic Lanczos quadrature value over the
  blocked matvec with its inputs detached (``"zero"`` keeps the reference's
  value-free convention);
* preconditioning: the matrix-free pivoted Cholesky of ``K(X, X)`` or an
  RFF sketch, in the spectral form;
* serving: :meth:`IterGPR.posterior` caches ``alpha = (K + sigma^2 I)^{-1}
  y``; the mean is one skinny product per batch and the variance one solve
  of the [T, N] cross-kernel rows, or with ``solver="lanczos"`` two skinny
  products with the LOVE cache of rank ``serving_lanczos_rank`` (built
  through the solve route's matvec, B3 under ``use_pallas``, from the
  masked first target row).

The chunked family (:meth:`IterGPR.log_marginal_likelihood_chunked`,
:meth:`IterGPR.posterior_chunked`, :meth:`IterGPR.posterior_predict_chunked`)
runs residual-replacement CG in host-driven chunks on the blocked matvec,
the search direction carried from chunk to chunk.

N is padded to the panel height's multiple with exactly decoupled pad rows
(:func:`~cggp_tpu_torch.ops.cg_implicit.pad_inducing` and a mask).  Random
draws come from a ``torch.Generator`` where JAX takes a PRNG key.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from cggp_tpu_torch.config import DeviceLike
from cggp_tpu_torch.models.base import GaussianLikelihood
from cggp_tpu_torch.models.clustergp import _as_tensor
from cggp_tpu_torch.models.gpr import data_like_params, init_gp_params
from cggp_tpu_torch.ops.cg import cg_loop, precond_apply_or_identity
from cggp_tpu_torch.ops.cg_implicit import (blocked_kuu_matvec, kernel_precond_state,
                                            make_implicit_cg, pad_inducing)
from cggp_tpu_torch.ops.kernels import Kernel
from cggp_tpu_torch.ops.logdet import (lanczos_quad_cache_rows, love_seed_row, love_variance,
                                       make_matfree_logdet_from_solves, rademacher,
                                       slq_value_rows, slq_value_rows_chunked)


def _detached(kp: Dict) -> Dict:
    return {k: v.detach() for k, v in kp.items()}


def _chunked_mll_parts(model: "IterGPR", chunk_iterations: int):
    """The chunked path's pieces ``(solve_chunk, grad_fn)``, both on the
    blocked matvec (the JAX package keeps a cache of jitted programs here;
    eager torch has nothing to compile).

    ``solve_chunk(kp, x_pad, lam, mask, rhs, v, p, precond_state)`` runs
    ``chunk_iterations`` CG steps from ``v`` with the residual re-anchored
    on the true ``rhs - v A`` and the direction ``p`` carried in (``None``:
    a restart), returning ``(v, p, 0.5 ||r||^2 per row)``.  ``grad_fn`` is
    the gradient in the kernel and likelihood parameters of the one-matvec
    surrogate ``-0.5 sum(weights * (rows @ A))``."""

    def solve_chunk(kp, x_pad, lam, mask, rhs, v, p, precond_state=()):
        with torch.no_grad():
            v_out, _stats, state = cg_loop(
                lambda q: model._matvec(kp, x_pad, lam, mask, q), precond_apply_or_identity,
                precond_state, rhs, v, error_threshold=model.error_threshold,
                max_iterations=chunk_iterations, max_steps_cycle=chunk_iterations + 1,
                relative_threshold=model.relative_threshold, p0=p, return_state=True)
        return v_out, state.p, 0.5 * torch.sum(torch.square(state.r), dim=-1)

    def grad_fn(kp, lik, x_pad, mask, rows, weights):
        kp_live = {k: v.detach().requires_grad_() for k, v in kp.items()}
        lik_live = {k: v.detach().requires_grad_() for k, v in lik.items()}
        leaves = [*kp_live.values(), *lik_live.values()]
        with torch.enable_grad():
            noise = model.likelihood.variance(lik_live)
            lam_full = torch.where(mask > 0, noise, torch.ones((), dtype=rows.dtype,
                                                                device=rows.device))
            out = model._matvec(kp_live, x_pad, lam_full, mask, rows)
            grads = torch.autograd.grad(-0.5 * torch.sum(weights * out), leaves,
                                        allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        return dict(zip(kp_live, grads[:len(kp_live)])), dict(zip(lik_live, grads[len(kp_live):]))

    return solve_chunk, grad_fn


def _chunked_restart_solve(model: "IterGPR", kp, x_pad, lam, mask, rhs, state, solve_chunk,
                           max_chunks: int):
    """Host-driven residual-replacement CG to the model's stop rule, shared by
    the chunked MLL, posterior and serving.  Each round re-anchors on the true
    residual and runs ``chunk_iterations`` steps with the direction carried
    from the round before (the convergence of unrestarted CG; a plain restart
    pays a momentum penalty near tight targets).  A round whose summed
    residual grows is dropped and redone fresh from the same anchor (a
    carried direction that shrank to noise can make ``gamma`` explode), so
    the residual never grows.  Returns ``(v, err, converged, chunks)``,
    ``err`` the last round's recurrence residual."""
    b_norm2 = 0.5 * torch.sum(torch.square(rhs), dim=-1)
    threshold = torch.tensor(model.error_threshold, dtype=rhs.dtype, device=rhs.device)
    target = threshold * b_norm2 if model.relative_threshold else threshold.expand_as(b_norm2)
    v = torch.zeros_like(rhs)
    p = None
    err = b_norm2  # the entry residual of the first round, from v = 0
    chunks = 0
    for _ in range(max_chunks):
        if bool(torch.all(err <= target)):
            break
        err_sum = float(torch.sum(err))
        v_new, p_new, err_new = solve_chunk(kp, x_pad, lam, mask, rhs, v, p, state)
        chunks += 1
        if p is not None and float(torch.sum(err_new)) > err_sum:
            p = None
            continue
        v, p, err = v_new, p_new, err_new
    return v, err, bool(torch.all(err <= target)), chunks


@dataclasses.dataclass(frozen=True)
class IterGPR:
    """Exact GPR whose linear algebra is matrix-free CG on ``K + sigma^2 I``.

    ``block`` is the height of the blocked route's Gram row panels (peak
    extra memory one [block, N] panel).  The log-det probes are Rademacher
    rows drawn from the generator ``key`` of :meth:`log_marginal_likelihood`,
    or explicit ``probes`` rows: ``sqrt(N) I`` makes the Hutchinson gradient
    and the SLQ value exact, and a fixed set makes the objective
    deterministic."""

    kernel: Kernel
    likelihood: GaussianLikelihood = GaussianLikelihood()
    error_threshold: float = 1e-10
    max_cg_iterations: int = 1000
    num_probes: int = 8
    # "slq": a stochastic Lanczos quadrature log-det value; "zero": the
    # reference's gradient-only convention (the value omits the log-det).
    logdet_variant: str = "slq"
    slq_lanczos_iters: int = 25
    precondition: Optional[str] = "pivchol"  # None | "pivchol" | "rff"
    precond_rank: int = 128
    precond_seed: int = 0  # the rff sketch's generator seed (fixed)
    relative_threshold: bool = True
    block: int = 4096
    use_pallas: bool = False
    # Rank of the opt-in posterior(solver="lanczos") LOVE serving cache
    # (conservative variances, exact at rank = N; never picked by "auto").
    serving_lanczos_rank: int = 128

    def __post_init__(self):
        if self.logdet_variant not in ("zero", "slq"):
            raise ValueError(f"unknown logdet_variant: {self.logdet_variant!r}")
        solve = make_implicit_cg(
            self.kernel, self.error_threshold, self.max_cg_iterations, block=self.block,
            use_pallas=self.use_pallas, relative_threshold=self.relative_threshold)
        object.__setattr__(self, "_solve", solve)
        object.__setattr__(self, "_route_matvec", solve.route_matvec)

        def matvec(kp, x, lam, mask, rows):
            return blocked_kuu_matvec(self.kernel, kp, x, lam, rows, block=self.block, mask=mask)

        def slq_value(kp, x, lam, mask, probes):
            return slq_value_rows(lambda v: matvec(kp, x, lam, mask, v), probes,
                                  self.slq_lanczos_iters)

        object.__setattr__(self, "_matvec", matvec)
        object.__setattr__(self, "_slq_value", slq_value)
        # The gradient reuses the probe rows solved in the fused solve.
        object.__setattr__(self, "_logdet_from_solves", make_matfree_logdet_from_solves(matvec))

    # -- parameters (the dense GPR's tree) --------------------------------------

    def init_params(self, input_dim: int, variance: float = 1.0, lengthscales=None,
                    noise_variance: float = 0.1, dtype: Optional[torch.dtype] = None,
                    device: DeviceLike = None) -> Dict:
        return init_gp_params(self.kernel, self.likelihood, input_dim, variance, lengthscales,
                              noise_variance, dtype, device)

    # -- system assembly ---------------------------------------------------------

    def _pad_multiple_for(self, n: int) -> int:
        # blocked_kuu_matvec takes n <= block in one panel; above that the
        # panel height must divide N.
        return self.block if n > self.block else 1

    def _padded_system(self, params: Dict, x, y=None):
        """``(x_pad, lam_pad, mask [N_pad], y_rows [Q, N_pad] or None)``, the
        inputs moved to the parameters' device and dtype.

        ``lam = sigma^2`` on real rows (differentiable in the noise) and 1 on
        pads; the mask zeroes the pads' kernel rows and columns, so pads are
        exactly decoupled in every solve, matvec and probe."""
        x = data_like_params(params, x)
        n = x.shape[0]
        noise = self.likelihood.variance(params["likelihood"])
        lam = noise * torch.ones((n,), dtype=x.dtype, device=x.device)
        mult = self._pad_multiple_for(n)
        ones_row = torch.ones((1, n), dtype=x.dtype, device=x.device)
        if y is None:
            x_pad, lam_pad, mask_row = pad_inducing(x, lam, mult, ones_row)
            return x_pad, lam_pad, mask_row[0], None
        y = data_like_params(params, y)
        x_pad, lam_pad, y_rows, mask_row = pad_inducing(x, lam, mult, y.T, ones_row)
        return x_pad, lam_pad, mask_row[0], y_rows

    def _precond_state(self, kp, x, lam, mask=None):
        """The solver state (``()`` = identity), from detached inputs: the
        preconditioner changes step counts, never solutions or gradients."""
        return kernel_precond_state(self.kernel, kp, x, lam, mask, self.precondition,
                                    self.precond_rank, self.precond_seed)

    def _probe_rows(self, probes, key, x_pad: torch.Tensor, mask: torch.Tensor,
                    what: str) -> torch.Tensor:
        """The masked [P, N_pad] probe rows: drawn at ``N_pad`` from ``key``, or
        the caller's, zero-padded from N columns when they are real-N."""
        n_pad = x_pad.shape[0]
        if probes is None:
            if key is None:
                raise ValueError(f"{what} requires a PRNG key (a torch.Generator) or explicit "
                                 "probes for the log-det estimator")
            probes = rademacher(key, (self.num_probes, n_pad), x_pad.dtype).to(x_pad.device)
        else:
            probes = _as_tensor(probes, x_pad.dtype, x_pad.device)
            if probes.shape[-1] != n_pad:
                # Zero entries keep the decoupled pads out of the estimate.
                probes = torch.cat([probes, probes.new_zeros((probes.shape[0],
                                                              n_pad - probes.shape[-1]))], -1)
        return probes * mask[None, :]

    # -- objective ---------------------------------------------------------------

    def log_marginal_likelihood(self, params: Dict, data: Tuple,
                                key: Optional[torch.Generator] = None,
                                probes=None) -> torch.Tensor:
        """``-0.5 (y^T K^-1 y + logdet K + N log 2 pi)`` with ``K = K(X, X) +
        sigma^2 I``: one fused CG solve of ``[y | probes]`` (the panel build
        dominates a matvec, so batching rows amortizes it), the log-det
        gradient from the solved probes (no extra solve) and, for ``"slq"``,
        the SLQ value with its inputs detached, so no panel is kept for the
        backward pass.  ``probes`` ([P, N] or [P, N_pad] rows) replace the
        draw from ``key``."""
        x, y = data
        n = x.shape[0]
        kp = params["kernel"]
        x_pad, lam, mask, y_rows = self._padded_system(params, x, y)
        q = y_rows.shape[0]
        state = self._precond_state(kp, x_pad, lam, mask)
        probes = self._probe_rows(probes, key, x_pad, mask, "IterGPR.log_marginal_likelihood")
        solved, _ = self._solve(kp, x_pad, lam, torch.cat([y_rows, probes], dim=0), state, mask)
        alpha = solved[:q]
        solved_probes = solved[q:].detach()
        quad = torch.sum(alpha * y_rows)
        logdet = self._logdet_from_solves(kp, x_pad, lam, mask, probes, solved_probes)
        if self.logdet_variant == "slq":
            with torch.no_grad():
                value = self._slq_value(_detached(kp), x_pad.detach(), lam.detach(), mask,
                                        probes.detach())
            logdet = logdet + value
        return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))

    # In the reference CLI, GPR's objective plays the role of the ELBO.
    def maximum_log_likelihood_objective(self, params: Dict, data: Tuple, key=None,
                                         probes=None) -> torch.Tensor:
        return self.log_marginal_likelihood(params, data, key=key, probes=probes)

    def training_loss(self, params: Dict, data: Tuple, key: Optional[torch.Generator] = None,
                      probes=None) -> torch.Tensor:
        return -self.log_marginal_likelihood(params, data, key=key, probes=probes)

    def log_marginal_likelihood_chunked(
        self, params: Dict, data: Tuple, key: Optional[torch.Generator] = None, probes=None,
        chunk_iterations: int = 8, max_chunks: int = 64, logdet_value: Optional[str] = None,
    ) -> Tuple[torch.Tensor, Dict, Dict]:
        """The MLL value and its gradient from host-driven chunks of at most
        ``chunk_iterations`` CG steps, on the blocked matvec:

        - ``alpha`` and the probe solves by :func:`_chunked_restart_solve`;
        - the gradient is the fused path's estimator, ``dMLL = -0.5(-alpha^T
          dK alpha + mean_p s_p^T dK p)``, as the gradient of one matvec's
          surrogate with ``alpha`` and the solved probes held constant;
        - ``logdet_value`` (default the model's ``logdet_variant``):
          ``"zero"`` omits the log-det value, ``"slq"`` adds the SLQ value
          (:func:`~cggp_tpu_torch.ops.logdet.slq_value_rows_chunked`).

        Returns ``(value, grads, info)``, ``info = {"chunks", "converged",
        "rel_residual"}``."""
        variant = self.logdet_variant if logdet_value is None else logdet_value
        if variant not in ("zero", "slq"):
            raise ValueError(f"unknown logdet_value: {variant!r}")
        x, y = data
        n = x.shape[0]
        kp = _detached(params["kernel"])
        with torch.no_grad():
            x_pad, lam, mask, y_rows = self._padded_system(params, x, y)
            q = y_rows.shape[0]
            probes = self._probe_rows(probes, key, x_pad, mask,
                                      "IterGPR.log_marginal_likelihood_chunked")
            solve_chunk, grad_fn = _chunked_mll_parts(self, chunk_iterations)
            state = self._precond_state(kp, x_pad, lam, mask)
            rhs = torch.cat([y_rows, probes], dim=0)
            v, err, converged, chunks = _chunked_restart_solve(
                self, kp, x_pad, lam, mask, rhs, state, solve_chunk, max_chunks)
            b_norm2 = 0.5 * torch.sum(torch.square(rhs), dim=-1)
            alpha, solved_probes = v[:q], v[q:]
            quad = float(torch.sum(alpha * y_rows))
            logdet = 0.0
            if variant == "slq":
                logdet = float(slq_value_rows_chunked(
                    lambda rows: self._matvec(kp, x_pad, lam, mask, rows), probes,
                    self.slq_lanczos_iters))
            value = torch.tensor(-0.5 * (quad + logdet + n * math.log(2.0 * math.pi)),
                                 dtype=x_pad.dtype, device=x_pad.device)
            # Rows [alpha | solved probes], cotangent weights [-alpha | probes / P].
            rows = torch.cat([alpha, solved_probes], dim=0)
            weights = torch.cat([-alpha, probes / probes.shape[0]], dim=0)
        g_kp, g_lik = grad_fn(kp, params["likelihood"], x_pad, mask, rows, weights)
        info = {"chunks": chunks, "converged": converged,
                "rel_residual": float(torch.max(torch.sqrt(err / torch.clamp(b_norm2,
                                                                          min=1e-30))))}
        return value, {"kernel": g_kp, "likelihood": g_lik}, info

    # -- serving (the posterior cache; the twin of GPR.posterior) ----------------

    def _love_rows(self, kp, x_pad, lam, mask, y_rows, matvec_rows=None) -> torch.Tensor:
        """The LOVE cache ``R`` [k, N_pad]: ``k = min(serving_lanczos_rank,
        N_pad)`` Lanczos steps through ``matvec_rows``, by default the solve
        route's matvec (B3 under ``use_pallas``; the JAX package takes the
        blocked matvec here, the same operator), seeded with the masked
        first target row."""
        with torch.no_grad():
            if matvec_rows is None:
                matvec_rows = self._route_matvec(kp, x_pad, lam, mask)
            rank = min(int(self.serving_lanczos_rank), int(x_pad.shape[0]))
            return lanczos_quad_cache_rows(matvec_rows, love_seed_row(y_rows[:1], mask[None, :]),
                                           rank)

    def posterior(self, params: Dict, data: Tuple, solver: str = "cg") -> "IterGPRPosterior":
        """One CG solve for ``alpha``; the cache then serves means with no
        solve and variances with one [T, N] solve per batch, or with
        ``solver="lanczos"`` from the LOVE rows of :meth:`_love_rows` (two
        skinny products a batch, conservative, exact at rank = N).
        ``"auto"`` is ``"cg"``."""
        if solver not in ("auto", "cg", "lanczos"):
            raise ValueError(f"unknown posterior solver: {solver!r}")
        x, y = data
        kp = params["kernel"]
        x_pad, lam, mask, y_rows = self._padded_system(params, x, y)
        state = self._precond_state(kp, x_pad, lam, mask)
        alpha, _ = self._solve(kp, x_pad, lam, y_rows, state, mask)
        lanczos_r = (self._love_rows(kp, x_pad, lam, mask, y_rows) if solver == "lanczos"
                     else None)
        return IterGPRPosterior(kernel_params=kp, x_train=x_pad, lam=lam, mask=mask,
                                alpha=alpha, precond_state=state, lanczos_r=lanczos_r)

    def posterior_chunked(self, params: Dict, data: Tuple, solver: str = "cg",
                          chunk_iterations: int = 8,
                          max_chunks: int = 64) -> "IterGPRPosterior":
        """:meth:`posterior` with the ``alpha`` solve in host-driven chunks on
        the blocked matvec; the same cache (with ``solver="lanczos"`` also
        the LOVE rows, one Lanczos step a dispatch already).  Warns when the
        chunk budget runs out before the stop rule is met."""
        if solver not in ("auto", "cg", "lanczos"):
            raise ValueError(f"unknown posterior solver: {solver!r}")
        x, y = data
        kp = _detached(params["kernel"])
        with torch.no_grad():
            x_pad, lam, mask, y_rows = self._padded_system(params, x, y)
            solve_chunk, _ = _chunked_mll_parts(self, chunk_iterations)
            state = self._precond_state(kp, x_pad, lam, mask)
            alpha, err, converged, chunks = _chunked_restart_solve(
                self, kp, x_pad, lam, mask, y_rows, state, solve_chunk, max_chunks)
        if not converged:
            warnings.warn(f"posterior_chunked: alpha solve unconverged after {chunks} chunks "
                          f"(max residual err {float(torch.max(err)):.3e}) — raise "
                          "max_chunks/chunk_iterations or loosen error_threshold",
                          RuntimeWarning)
        lanczos_r = None
        if solver == "lanczos":
            lanczos_r = self._love_rows(kp, x_pad, lam, mask, y_rows,
                                        lambda rows: self._matvec(kp, x_pad, lam, mask, rows))
        return IterGPRPosterior(kernel_params=kp, x_train=x_pad, lam=lam, mask=mask,
                                alpha=alpha, precond_state=state, lanczos_r=lanczos_r)

    def posterior_mean(self, post: "IterGPRPosterior", x_new: torch.Tensor) -> torch.Tensor:
        kmn = self.kernel.K(post.kernel_params, x_new, post.x_train)
        return (kmn * post.mask[None, :]) @ post.alpha.T  # [T, Q]

    def _predictive(self, post: "IterGPRPosterior", x_new, kmn, inv_kmn, full_cov: bool):
        kp = post.kernel_params
        if full_cov:
            var = (self.kernel.K(kp, x_new) - kmn @ inv_kmn.T)[None, ...]
        else:
            var = (self.kernel.K_diag(kp, x_new) - torch.sum(kmn * inv_kmn, dim=-1))[:, None]
        return kmn @ post.alpha.T, var

    def posterior_predict(self, post: "IterGPRPosterior", x_new: torch.Tensor,
                          full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and variance: one solve of the [T, N] rows ``K(x_new, X)``,
        or with a LOVE cache two skinny products."""
        kp = post.kernel_params
        kmn = self.kernel.K(kp, x_new, post.x_train) * post.mask[None, :]  # [T, N]
        if post.lanczos_r is not None:
            knn = self.kernel.K(kp, x_new) if full_cov else self.kernel.K_diag(kp, x_new)
            return kmn @ post.alpha.T, love_variance(post.lanczos_r, kmn, knn, full_cov)
        inv_kmn, _ = self._solve(kp, post.x_train, post.lam, kmn, post.precond_state,
                                 post.mask)
        return self._predictive(post, x_new, kmn, inv_kmn, full_cov)

    def posterior_predict_chunked(self, post: "IterGPRPosterior", x_new: torch.Tensor,
                                  chunk_iterations: int = 8, max_chunks: int = 64,
                                  full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`posterior_predict` with the [T, N] solve in host-driven
        chunks on the blocked matvec; warns on an exhausted budget."""
        if post.lanczos_r is not None:
            return self.posterior_predict(post, x_new, full_cov=full_cov)
        kp = _detached(post.kernel_params)
        with torch.no_grad():
            solve_chunk, _ = _chunked_mll_parts(self, chunk_iterations)
            kmn = self.kernel.K(kp, x_new, post.x_train) * post.mask[None, :]
            inv_kmn, err, converged, chunks = _chunked_restart_solve(
                self, kp, post.x_train, post.lam, post.mask, kmn, post.precond_state,
                solve_chunk, max_chunks)
            if not converged:
                warnings.warn(f"posterior_predict_chunked: variance solve unconverged after "
                              f"{chunks} chunks (max residual err {float(torch.max(err)):.3e})",
                              RuntimeWarning)
            return self._predictive(post, x_new, kmn, inv_kmn, full_cov)

    def predict_f(self, params: Dict, data: Tuple, x_new: torch.Tensor,
                  full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dense GPR's signature (the training data bound per call)."""
        return self.posterior_predict(self.posterior(params, data), x_new, full_cov=full_cov)


class IterGPRPosterior(NamedTuple):
    """Serving cache of :meth:`IterGPR.posterior`, with the JAX package's
    fields in its order."""

    kernel_params: Dict
    x_train: torch.Tensor  # [N_pad, D] (pads decoupled)
    lam: torch.Tensor  # [N_pad] = sigma^2 on real rows, 1 on pads
    mask: torch.Tensor  # [N_pad] 1 real / 0 pad
    alpha: torch.Tensor  # [Q, N_pad] rows = ((K + sigma^2 I)^{-1} y)^T
    precond_state: Tuple  # () = identity, else the SpectralPreconditioner state
    lanczos_r: Optional[torch.Tensor] = None  # [k, N_pad] LOVE cache (solver="lanczos")
