"""CGGP over an implicit ``Kuu + diag(lam)`` (port of
``cggp_tpu/models/rowcg.py``).

The model is expressed against hooks a subclass wires in its
``__post_init__`` (frozen dataclass, so via ``object.__setattr__``):

    _solve(kp, z, lam, rhs [R, M], precond_state, mask) -> (solution, CGStats)
    _matvec(kp, z, lam, mask, rows [R, M]) -> rows @ (K*mask + diag(lam))
    _route_matvec(kp, z, lam, mask) -> (rows -> rows @ A) on the solve's route
    _slq_value(kp, z, lam, mask, probes [P, M]) -> scalar   (logdet="slq")
    _pad_multiple_for(m) -> int   (inducing count padded to this multiple)

Everything is row-convention ([R, M] right-hand sides).  M is padded with
:func:`cggp_tpu_torch.ops.cg_implicit.pad_inducing` and an
``inducing_mask`` parameter keeps the pads exact no-ops (masked kernel
coupling, masked probes, masked KL constant).

Training: :meth:`RowSolveCGGP.elbo` fuses ``[u | trace probes | logdet
probes | Kmn]`` into one solve whose backward pass is a second solve on the
same route (``ops/cg_implicit.py``); the KL matvecs and the logdet
gradients are the differentiable blocked matvec (``ops/logdet.py``'s
matrix-free estimators; ``logdet_variant="slq"`` adds a Lanczos value).
Probes are drawn in order from the one generator ``key``: trace probes,
then logdet probes.  Also :meth:`prior_kl`, :meth:`cg_stats`,
:meth:`precond_state` (chunk-frozen preconditioning), the pivoted-Cholesky
and ``"rff"`` preconditioners (the sketch from a generator seeded
``precond_seed``, fixed across steps), and re-clustering through
:meth:`assign_clusters` (re-padded to the pad multiple) and
:meth:`assign_clusters_device` (fixed capacity).

Serving: ``predict_f``, ``posterior(solver="cg")`` (``"auto"`` resolves to
``"cg"``) or ``posterior(solver="lanczos")`` (the LOVE cache of rank
``serving_lanczos_rank``, built through the solve route's matvec — B3 under
``use_pallas`` — from the masked ``u``, so the basis never leaves the real
coordinates), ``posterior_mean`` and ``posterior_predict``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from cggp_tpu_torch.models.base import minibatch_scale
from cggp_tpu_torch.models.clustergp import ClusterGP, _as_tensor
from cggp_tpu_torch.ops.cg import CGStats
from cggp_tpu_torch.ops.cg_implicit import kernel_precond_state, pad_inducing
from cggp_tpu_torch.ops.logdet import (lanczos_quad_cache_rows, love_seed_row, love_variance,
                                       make_matfree_eval_logdet,
                                       make_matfree_logdet_from_solves,
                                       make_matfree_slq_logdet, rademacher)


@dataclasses.dataclass(frozen=True)
class RowSolveCGGP(ClusterGP):
    """CGGP over an implicit (never materialised) ``Kuu + diag(lam)``."""

    error_threshold: float = 1e-8
    max_cg_iterations: int = 100
    num_probes: int = 5
    # Per-step preconditioning of the fused solve: "pivchol" builds the
    # [M, k] factor from per-pivot kernel rows, "rff" from a random-Fourier
    # sketch of Kuu (L = precond_rank bases, rank 2L) drawn from a generator
    # seeded precond_seed, the same sketch every step.
    precondition: Optional[str] = None  # None | "pivchol" | "rff"
    precond_rank: int = 128
    precond_seed: int = 0
    # Scale each row's stop target by its own norm (ops.cg.cg_loop).
    relative_threshold: bool = False
    # "zero": the reference semantics (the ELBO value omits the logdet, its
    # gradient is exact); "slq": a matrix-free Lanczos quadrature value.
    logdet_variant: str = "zero"  # "zero" | "slq"
    slq_lanczos_iters: int = 25
    # Rank of the opt-in posterior(solver="lanczos") LOVE serving cache:
    # variances are conservative over-estimates, exact at rank = M, so
    # "auto" never picks it.
    serving_lanczos_rank: int = 128

    def _wire_logdets(self) -> None:
        """Call at the end of the subclass ``__post_init__`` (after
        ``_solve``, ``_matvec`` and ``_slq_value`` exist)."""
        object.__setattr__(self, "_logdet",
                           make_matfree_eval_logdet(self._matvec, self._solve,
                                                    self._precond_state))
        object.__setattr__(self, "_logdet_from_solves",
                           make_matfree_logdet_from_solves(self._matvec))
        if self.logdet_variant not in ("zero", "slq"):
            raise ValueError(f"unknown logdet_variant: {self.logdet_variant!r}")
        if self.logdet_variant == "slq":
            object.__setattr__(self, "_slq_logdet",
                               make_matfree_slq_logdet(self._slq_value, self._matvec,
                                                       self._solve, self._precond_state))

    def _pad_multiple_for(self, m: int) -> int:
        raise NotImplementedError

    def _precond_state(self, kp, z, lam, mask=None):
        """Solver-state tuple for the solve, built from detached inputs;
        ``()`` = identity."""
        return kernel_precond_state(self.kernel, kp, z, lam, mask, self.precondition,
                                    self.precond_rank, self.precond_seed)

    def precond_state(self, params: Dict):
        """The solver state for ``elbo(precond_override=...)`` (chunk-frozen
        preconditioning): converged solves are the same, but a stale factor
        may need more iterations.  The rff sketch here is seeded by
        ``precond_seed``."""
        lam = self.diag_variance(params)[:, 0]
        return self._precond_state(params["kernel"], params["inducing_points"], lam,
                                   params["inducing_mask"][:, 0])

    # -- parameters ----------------------------------------------------------

    def init_params(self, inducing_points, pseudo_u=None, cluster_counts=None,
                    capacity: Optional[int] = None, **kwargs) -> Dict:
        """``capacity`` pins the padded inducing dimension to a fixed size >=
        the real count (a multiple of the model's pad multiple)."""
        params = super().init_params(inducing_points, pseudo_u=pseudo_u,
                                     cluster_counts=cluster_counts, **kwargs)
        m_real = params["inducing_points"].shape[0]
        if capacity is None:
            multiple = self._pad_multiple_for(m_real)
        else:
            capacity = int(capacity)
            if capacity < m_real:
                raise ValueError(f"capacity {capacity} < real inducing count {m_real}")
            if capacity % self._pad_multiple_for(capacity) != 0:
                raise ValueError(f"capacity {capacity} must be a multiple of "
                                 f"{self._pad_multiple_for(capacity)}")
            multiple = capacity
        # Padded counts of 1 give lam = noise there; the mask decouples pads.
        (params["inducing_points"], params["pseudo_u"], params["cluster_counts"],
         params["inducing_mask"]) = self._padded(params["inducing_points"], params["pseudo_u"],
                                                 params["cluster_counts"], multiple)
        return params

    def trainable_mask(self, params: Dict, trainable_inducing_points: bool = False,
                       trainable_pseudo_u: bool = False) -> Dict:
        mask = super().trainable_mask(params, trainable_inducing_points,
                                      trainable_pseudo_u=trainable_pseudo_u)
        mask["inducing_mask"] = False
        return mask

    def _padded(self, z, u, counts, multiple: int):
        """``(Z, u, counts, mask)`` padded to ``multiple`` by
        :func:`pad_inducing` (pad counts 1, mask 0)."""
        m = z.shape[0]
        ones = torch.ones((1, m), dtype=z.dtype, device=z.device)
        z, _lam, u_t, counts_t, mask_t = pad_inducing(z, ones[0], multiple, u.T, counts.T, ones)
        counts = counts_t.T
        return z, u_t.T, torch.where(counts == 0.0, torch.ones_like(counts), counts), mask_t.T

    def assign_clusters(self, params: Dict, iv, means, counts) -> Dict:
        """Re-cluster and re-pad: the new M is padded to the model's pad
        multiple again (not to the old size) and the mask follows the new
        real count."""
        z_old = params["inducing_points"]
        dtype, device = z_old.dtype, z_old.device
        iv = _as_tensor(iv, dtype, device)
        z, u, counts, mask = self._padded(iv, _as_tensor(means, dtype, device),
                                          _as_tensor(counts, dtype, device),
                                          self._pad_multiple_for(iv.shape[0]))
        new = dict(params)
        new.update(inducing_points=z, pseudo_u=u, cluster_counts=counts, inducing_mask=mask)
        return new

    def assign_clusters_device(self, params: Dict, z, u, counts, mask) -> Dict:
        """Fixed-capacity re-clustering swap: a dict update with no shape
        change.  The params must come from ``init_params(capacity=...)`` of
        the same capacity; pads follow :func:`pad_inducing` (far points,
        count 1, u 0, mask 0)."""
        if tuple(z.shape) != tuple(params["inducing_points"].shape):
            raise ValueError(f"capacity mismatch: new Z {tuple(z.shape)} vs params "
                             f"{tuple(params['inducing_points'].shape)} — build params with "
                             "init_params(capacity=...) matching the recluster capacity")
        new = dict(params)
        new["inducing_points"] = z
        new["pseudo_u"] = _as_tensor(u, z.dtype, z.device)
        new["cluster_counts"] = _as_tensor(counts, z.dtype, z.device)
        new["inducing_mask"] = _as_tensor(mask, z.dtype, z.device)
        return new

    # -- objectives --------------------------------------------------------------

    def prior_kl(self, params: Dict, key: torch.Generator) -> torch.Tensor:
        """The KL term: ``[u | trace probes]`` in one solve, the quadratic and
        trace terms through one blocked matvec, the logdet (zero-valued or
        SLQ) on independent probes.  Probes from ``key``: trace, then
        logdet."""
        kp = params["kernel"]
        z = params["inducing_points"]
        u = params["pseudo_u"]
        var = self.diag_variance(params)
        lam = var[:, 0]
        m, dtype = z.shape[0], z.dtype
        mask = params["inducing_mask"].detach()[:, 0]
        p_out = u.shape[-1]  # multi-output pseudo_u contributes P_out rows
        probes = rademacher(key, (self.num_probes, m), dtype) * mask[None, :]
        solved, _ = self._solve(kp, z, lam, torch.cat([u.T, probes], dim=0),
                                self._precond_state(kp, z, lam, mask), mask)
        nu, solved_probes = solved[:p_out], solved[p_out:]
        # One matvec for [nu | probes]: the panel builds dominate it.
        kmm_rows = self._matvec(kp, z, torch.zeros_like(lam), mask,
                                torch.cat([nu, probes], dim=0))
        quad = torch.sum(kmm_rows[:p_out] * nu)
        trace = torch.sum(solved_probes * kmm_rows[p_out:]) / self.num_probes
        logdet_probes = rademacher(key, (self.num_probes, m), dtype) * mask[None, :]
        if self.logdet_variant == "slq":
            logdet = self._slq_logdet(kp, z, lam, mask, logdet_probes)
        else:
            logdet = self._logdet(kp, z, lam, mask, logdet_probes)
        const = torch.sum(mask * torch.log(lam))
        return 0.5 * (quad - trace + logdet - const)

    def elbo(self, params: Dict, data: Tuple[torch.Tensor, torch.Tensor],
             key: Optional[torch.Generator] = None, precond_override=None) -> torch.Tensor:
        """ELBO with one fused solve a step: rows ``[u | trace probes |
        logdet probes | Kmn(batch)]`` go through one CG (and so one backward
        solve), and the logdet gradient reuses this solve's probe
        solutions.  ``precond_override`` (a state from
        :meth:`precond_state`, or ``()`` for the identity) replaces the
        per-step factor build."""
        if key is None:
            raise ValueError(f"{type(self).__name__}.elbo requires a generator (key) for the "
                             "trace/logdet probes")
        x, y = data
        kp = params["kernel"]
        z = params["inducing_points"]
        u = params["pseudo_u"]
        var = self.diag_variance(params)
        lam = var[:, 0]
        m, dtype = z.shape[0], z.dtype
        p = self.num_probes
        mask = params["inducing_mask"].detach()[:, 0]
        use_slq = self.logdet_variant == "slq"
        probes = rademacher(key, (p, m), dtype) * mask[None, :]
        # SLQ draws its own probes for a Lanczos run of its own; only the
        # zero-valued variant solves its gradient probes in the fused block.
        logdet_probes = (torch.zeros((0, m), dtype=dtype, device=z.device) if use_slq
                         else rademacher(key, (p, m), dtype) * mask[None, :])
        n_ld = logdet_probes.shape[0]
        kmn = self.kernel.K(kp, x, z) * mask[None, :]  # [B, M] rows

        rhs = torch.cat([u.T, probes, logdet_probes, kmn], dim=0)
        precond = (self._precond_state(kp, z, lam, mask) if precond_override is None
                   else precond_override)
        solved, _ = self._solve(kp, z, lam, rhs, precond, mask)
        p_out = u.shape[-1]
        nu = solved[:p_out]
        solved_probes = solved[p_out:p_out + p]
        solved_logdet = solved[p_out + p:p_out + p + n_ld]
        inv_kmn = solved[p_out + p + n_ld:]

        # -- KL --
        zeros_lam = torch.zeros_like(lam)
        quad = torch.sum(self._matvec(kp, z, zeros_lam, mask, nu) * nu)
        trace = torch.sum(solved_probes * self._matvec(kp, z, zeros_lam, mask, probes)) / p
        if use_slq:
            slq_probes = rademacher(key, (p, m), dtype) * mask[None, :]
            logdet = self._slq_logdet(kp, z, lam, mask, slq_probes)
        else:
            logdet = self._logdet_from_solves(kp, z, lam, mask, logdet_probes, solved_logdet)
        const = torch.sum(mask * torch.log(lam))
        kl = 0.5 * (quad - trace + logdet - const)

        # -- data term --
        knn = self.kernel.K_diag(kp, x)
        f_var = (knn - torch.sum(kmn * inv_kmn, dim=-1))[:, None]
        f_mean = kmn @ nu.T
        var_exp = self.likelihood.variational_expectations(params["likelihood"], f_mean, f_var, y)
        return torch.sum(var_exp) * minibatch_scale(self.num_data, x.shape[0], kl.dtype) - kl

    def training_loss(self, params: Dict, data, key: Optional[torch.Generator] = None,
                      precond_override=None) -> torch.Tensor:
        return -self.elbo(params, data, key, precond_override=precond_override)

    def cg_stats(self, params: Dict, data, key: torch.Generator) -> CGStats:
        """Iterations and residual of the fused solve ``[u | 2P probes |
        Kmn]`` under the training step's preconditioner."""
        x, _y = data
        kp = params["kernel"]
        z = params["inducing_points"]
        u = params["pseudo_u"]
        lam = self.diag_variance(params)[:, 0]
        mask = params["inducing_mask"].detach()[:, 0]
        with torch.no_grad():
            probes = rademacher(key, (2 * self.num_probes, z.shape[0]), z.dtype) * mask[None, :]
            kmn = self.kernel.K(kp, x, z) * mask[None, :]
            _, stats = self._solve(kp, z, lam, torch.cat([u.T, probes, kmn], dim=0),
                                   self._precond_state(kp, z, lam, mask), mask)
        return stats

    # -- predict ---------------------------------------------------------------

    def predict_f(self, params: Dict, x_new: torch.Tensor,
                  full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uncached prediction: ``[u | Kmn]`` rows solved in one CG."""
        kp = params["kernel"]
        z = params["inducing_points"]
        u = params["pseudo_u"]
        lam = self.diag_variance(params)[:, 0]
        mask = params["inducing_mask"][:, 0]
        kmn = self.kernel.K(kp, x_new, z) * mask[None, :]  # [T, M] rows
        rhs = torch.cat([u.T, kmn], dim=0)  # [(P_out + T), M]
        solved, _ = self._solve(kp, z, lam, rhs, self._precond_state(kp, z, lam, mask), mask)
        p_out = u.shape[-1]  # multi-output pseudo_u contributes P_out rows
        inv_u, inv_kmn = solved[:p_out], solved[p_out:]
        if full_cov:
            knn = self.kernel.K(kp, x_new)
            fvar = (knn - kmn @ inv_kmn.T)[None, ...]
        else:
            knn = self.kernel.K_diag(kp, x_new)
            fvar = (knn - torch.sum(kmn * inv_kmn, dim=-1))[:, None]
        return kmn @ inv_u.T, fvar

    # -- cached serving ----------------------------------------------------------

    def resolve_serving_solver(self, params: Dict) -> str:
        """Eager ``"auto"`` resolution: always ``"cg"``, since the row models
        of the port serve matrix-free (the Cholesky-capable sharded model,
        with its Lanczos conditioning estimate, is not ported)."""
        return "cg"

    def _love_rows(self, kp, z, lam, mask, seed: torch.Tensor) -> torch.Tensor:
        """The LOVE cache ``R`` [k, M_pad] of the masked system, ``k =
        min(serving_lanczos_rank, M_pad)`` Lanczos steps through the solve
        route's matvec (B3 under ``use_pallas``; the JAX package takes the
        blocked matvec here, the same operator)."""
        with torch.no_grad():
            rank = min(int(self.serving_lanczos_rank), int(z.shape[0]))
            return lanczos_quad_cache_rows(self._route_matvec(kp, z, lam, mask),
                                           love_seed_row(seed, mask[None, :]), rank)

    def posterior(self, params: Dict, solver: str = "auto") -> "RowCGGPPosterior":
        """The params-only serving state: the u-solve ``nu`` and the
        preconditioner; ``posterior_predict`` then solves only the Kmn rows.
        ``"lanczos"`` also builds the LOVE rows (:meth:`_love_rows`, seeded
        with the masked ``u``), so a batch's variance is two skinny
        products, no solve.  ``"auto"`` is ``"cg"``."""
        if solver == "auto":
            solver = self.resolve_serving_solver(params)
        if solver == "chol":
            raise ValueError(
                f"{type(self).__name__} serves matrix-free; solver='chol' would "
                "materialise the [M, M] system this model exists to avoid — "
                "use 'cg' or 'auto'")
        if solver not in ("cg", "lanczos"):
            raise ValueError(f"unknown posterior solver: {solver!r}")
        kp = params["kernel"]
        z = params["inducing_points"]
        u = params["pseudo_u"]
        lam = self.diag_variance(params)[:, 0]
        mask = params["inducing_mask"][:, 0]
        precond_state = self._precond_state(kp, z, lam, mask)
        nu, _ = self._solve(kp, z, lam, u.T, precond_state, mask)
        lanczos_r = (self._love_rows(kp, z, lam, mask, (u * mask[:, None]).T)
                     if solver == "lanczos" else None)
        return RowCGGPPosterior(kernel_params=kp, inducing_points=z, lam=lam, mask=mask,
                                nu=nu, precond_state=precond_state, lanczos_r=lanczos_r)

    def posterior_mean(self, post: "RowCGGPPosterior", x_new: torch.Tensor) -> torch.Tensor:
        """CG-free serving mean: one skinny ``K(x, Z) @ nu`` product."""
        kmn = self.kernel.K(post.kernel_params, x_new, post.inducing_points)
        return (kmn * post.mask[None, :]) @ post.nu.T  # [T, 1]

    def posterior_predict(self, post: "RowCGGPPosterior", x_new: torch.Tensor,
                          full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and variance from the cache: one CG solve of the [T, M] Kmn
        rows (u-solve and preconditioner build amortized), or with a LOVE
        cache two skinny products."""
        kp = post.kernel_params
        z = post.inducing_points
        kmn = self.kernel.K(kp, x_new, z) * post.mask[None, :]  # [T, M]
        if post.lanczos_r is not None:
            knn = self.kernel.K(kp, x_new) if full_cov else self.kernel.K_diag(kp, x_new)
            return kmn @ post.nu.T, love_variance(post.lanczos_r, kmn, knn, full_cov)
        inv_kmn, _ = self._solve(kp, z, post.lam, kmn, post.precond_state, post.mask)
        if full_cov:
            knn = self.kernel.K(kp, x_new)
            fvar = (knn - kmn @ inv_kmn.T)[None, ...]
        else:
            knn = self.kernel.K_diag(kp, x_new)
            fvar = (knn - torch.sum(kmn * inv_kmn, dim=-1))[:, None]
        return kmn @ post.nu.T, fvar


class RowCGGPPosterior(NamedTuple):
    """Serving cache produced by :meth:`RowSolveCGGP.posterior`, with the JAX
    package's fields in its order."""

    kernel_params: Dict
    inducing_points: torch.Tensor  # [M_pad, D] (pads decoupled)
    lam: torch.Tensor  # [M_pad] = sigma^2 / counts
    mask: torch.Tensor  # [M_pad] 1 real / 0 pad
    nu: torch.Tensor  # [1, M_pad] row = ((Kmm + Lambda)^{-1} u)^T
    precond_state: Tuple  # () = identity, else SpectralPreconditioner state
    chol: Optional[torch.Tensor] = None  # always None: served matrix-free
    lanczos_r: Optional[torch.Tensor] = None  # [k, M_pad] LOVE cache (solver="lanczos")
