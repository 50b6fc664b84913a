"""CGGP (CLI name "cdgp") — ClusterGP with every Cholesky replaced by CG
(port of ``cggp_tpu/models/cggp.py``).

The injected :class:`ConjugateGradient` solves ``(Kmm + Lambda)^{-1} u``,
``(Kmm + Lambda)^{-1} Kmn`` and the probe systems; ``Kmm`` is built with
jitter 0 — conditioning comes from ``Lambda = noise / counts``.

Training: :meth:`CGGP.elbo` fuses every CG right-hand side of a step into
one ``[u | trace probes | logdet probes | Kmn]`` row-block solve, whose
backward pass is a second CG solve on the same route (``ops/cg.py``); the
trace term uses Rademacher probes and the log-det gradient reuses the
fused solve's probe solutions (``eval_logdet_from_solves``) or, with
``logdet_variant="slq"``, comes with a Lanczos quadrature value.  The
per-step preconditioner (``precondition=None | "rff" | "pivchol" | "chol" |
"auto"``) is rebuilt from the current hyperparameters, outside the
differentiated model; the ``"rff"`` sketch draws its frequencies from the
step's generator after the probes (a generator seeded 0 where no key is
given, as the JAX package uses ``PRNGKey(0)``).  ``init_params(capacity=...)``
pads the inducing set with exactly decoupled points behind an
``inducing_mask``.

Serving: :meth:`CGGP.predict_f` (one fused solve), :meth:`CGGP.posterior`
with ``solver="cg"``, ``"chol"``, ``"lanczos"`` (the LOVE cache of rank
``serving_lanczos_rank``: variances from two skinny products, conservative)
or ``"auto"`` (a Lanczos conditioning estimate picks ``"chol"`` or
``"cg"``, never ``"lanczos"``), :meth:`posterior_mean` and
:meth:`posterior_predict`.

Probes come from ``rademacher``, looked up in this module when a step runs,
drawn from a ``torch.Generator`` (``key``) on the parameters' device.

Re-clustering: :meth:`CGGP.assign_clusters` swaps in a host selection
(re-padded to the pinned capacity on capacity-padded params) and
:meth:`CGGP.assign_clusters_device` is the fixed-capacity swap.

Not ported yet: ``posterior_extend`` (ROADMAP Queue A item 10) is absent.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from cggp_tpu_torch.models.base import chol_or_cg_from_eigs, minibatch_scale
from cggp_tpu_torch.models.clustergp import ClusterGP, _as_tensor
from cggp_tpu_torch.ops.cg import (CGStats, CholPreconditioner, ConjugateGradient,
                                   SpectralPreconditioner, _cholesky_or_nan,
                                   pivoted_cholesky_preconditioner)
from cggp_tpu_torch.ops.cg_implicit import pad_inducing
from cggp_tpu_torch.ops.linalg import add_diagonal
from cggp_tpu_torch.ops.logdet import (eval_logdet, eval_logdet_from_solves,
                                       lanczos_extremal_eigs, lanczos_quad_cache_rows,
                                       love_seed_row, love_variance, rademacher, slq_logdet)
from cggp_tpu_torch.ops.rff import rff_preconditioner

# precondition="auto" picks the exact factor up to this M (the JAX package's
# cutoff: past it the O(M^3) build and the second [M, M] buffer outgrow the
# refinement's gain); above it, the low-rank pivoted Cholesky.
_CHOL_AUTO_MAX_M = 8192
# Serving "auto" never factorizes above this M.
_CHOL_SERVING_MAX_M = 16384
_PRECONDITIONS = (None, "rff", "pivchol", "chol", "auto")


@dataclasses.dataclass(frozen=True)
class CGGP(ClusterGP):
    """CG-powered ClusterGP; ``conjugate_gradient`` is the pluggable solver."""

    conjugate_gradient: ConjugateGradient = None  # type: ignore[assignment]
    num_probes: Optional[int] = 5
    logdet_variant: str = "zero"  # "zero" (reference semantics) | "slq"
    slq_lanczos_iters: int = 25
    fuse_kl_solves: bool = True
    # Rank of the opt-in posterior(solver="lanczos") LOVE serving cache.
    serving_lanczos_rank: int = 128
    precondition: Optional[str] = None  # None | "rff" | "pivchol" | "chol" | "auto"
    precond_rank: int = 128  # factor rank (for "rff": Fourier bases L, rank 2L)

    def __post_init__(self):
        if self.conjugate_gradient is None:
            raise ValueError("CGGP requires a ConjugateGradient instance")
        if self.precondition not in _PRECONDITIONS:
            raise ValueError(f"unknown precondition mode: {self.precondition!r}")

    # -- capacity padding / masking --------------------------------------------

    @staticmethod
    def _mask_of(params: Dict) -> Optional[torch.Tensor]:
        mask = params.get("inducing_mask")
        return None if mask is None else mask.detach()[:, 0]

    def _masked_kmm(self, kp, z, mask):
        """``K(Z, Z)`` with pad rows and columns zeroed (the pad block of
        ``Kmm + Lambda`` is then exactly ``diag(Lambda)``)."""
        kmm = self.kernel.K(kp, z)  # jitter = 0
        return kmm if mask is None else kmm * (mask[:, None] * mask[None, :])

    def _masked_kmn(self, kp, z, x, mask):
        kmn = self.kernel.K(kp, z, x)
        return kmn if mask is None else kmn * mask[:, None]

    def _pad_multiple_for(self, m: int) -> int:
        return 1  # the dense model takes any capacity

    def init_params(self, inducing_points, pseudo_u=None, cluster_counts=None,
                    capacity: Optional[int] = None, **kwargs) -> Dict:
        """``capacity`` pins the inducing dimension to a fixed size >= the
        real count, with pads behind an ``inducing_mask`` parameter."""
        params = super().init_params(inducing_points, pseudo_u=pseudo_u,
                                     cluster_counts=cluster_counts, **kwargs)
        if capacity is None:
            return params
        z = params["inducing_points"]
        m_real = z.shape[0]
        capacity = int(capacity)
        if capacity < m_real:
            raise ValueError(f"capacity {capacity} < real inducing count {m_real}")
        ones = torch.ones((1, m_real), dtype=z.dtype, device=z.device)
        z, _lam, u_t, counts_t, mask_t = pad_inducing(
            z, ones[0], capacity, params["pseudo_u"].T, params["cluster_counts"].T, ones)
        params["inducing_points"] = z
        params["pseudo_u"] = u_t.T
        counts = counts_t.T
        params["cluster_counts"] = torch.where(counts == 0.0, torch.ones_like(counts), counts)
        params["inducing_mask"] = mask_t.T
        return params

    def trainable_mask(self, params: Dict, *args, **kwargs) -> Dict:
        mask = super().trainable_mask(params, *args, **kwargs)
        if "inducing_mask" in mask:
            mask["inducing_mask"] = False
        return mask

    def assign_clusters(self, params: Dict, iv, means, counts) -> Dict:
        """Host re-clustering: ``params`` with a new ``(Z, u, counts)``.  On
        capacity-padded params the new selection is padded again to the same
        capacity (through :meth:`assign_clusters_device`), so the mask never
        goes stale against a Z of another shape."""
        if "inducing_mask" not in params:
            return super().assign_clusters(params, iv, means, counts)
        z_old = params["inducing_points"]
        capacity = z_old.shape[0]
        dtype, device = z_old.dtype, z_old.device
        iv = _as_tensor(iv, dtype, device)
        if iv.shape[0] > capacity:
            raise ValueError(
                f"re-clustered M={iv.shape[0]} exceeds the pinned capacity {capacity}; "
                "raise capacity at init_params or coarsen the selection")
        m = iv.shape[0]
        ones = torch.ones((1, m), dtype=dtype, device=device)
        z, _lam, u_t, counts_t, mask_t = pad_inducing(
            iv, ones[0], capacity, _as_tensor(means, dtype, device).T,
            _as_tensor(counts, dtype, device).T, ones)
        counts_p = counts_t.T
        return self.assign_clusters_device(
            params, z, u_t.T, torch.where(counts_p == 0.0, torch.ones_like(counts_p), counts_p),
            mask_t.T)

    def assign_clusters_device(self, params: Dict, z, u, counts, mask) -> Dict:
        """Fixed-capacity re-clustering swap: a dict update with no shape
        change, for capacity-padded params only."""
        if "inducing_mask" not in params:
            raise ValueError("assign_clusters_device needs capacity-padded params — "
                             "build them with init_params(capacity=...)")
        if tuple(z.shape) != tuple(params["inducing_points"].shape):
            raise ValueError(f"capacity mismatch: new Z {tuple(z.shape)} vs params "
                             f"{tuple(params['inducing_points'].shape)}")
        new = dict(params)
        new["inducing_points"] = z
        new["pseudo_u"] = _as_tensor(u, z.dtype, z.device)
        new["cluster_counts"] = _as_tensor(counts, z.dtype, z.device)
        new["inducing_mask"] = _as_tensor(mask, z.dtype, z.device)
        return new

    # -- preconditioning --------------------------------------------------------

    def _build_preconditioner(self, kp, z, kmm, var, key=None):
        """The per-step solver-state preconditioner (None when disabled),
        built from detached inputs: it is not part of the differentiated
        model.  ``key`` is the generator the ``"rff"`` sketch draws from (a
        generator seeded 0 on Z's device when None)."""
        mode = self.precondition
        if mode is None:
            return None
        if mode == "auto":
            mode = "chol" if z.shape[0] <= _CHOL_AUTO_MAX_M else "pivchol"
        with torch.no_grad():
            if mode == "rff":
                if key is None:
                    key = torch.Generator(device=z.device).manual_seed(0)
                return rff_preconditioner(self.kernel, {k: v.detach() for k, v in kp.items()},
                                          z.detach(), var[:, 0].detach(), self.precond_rank,
                                          key)
            if mode == "pivchol":
                return pivoted_cholesky_preconditioner(kmm.detach(), var[:, 0].detach(),
                                                       self.precond_rank)
            if mode == "chol":
                return CholPreconditioner(kmm.detach(), var[:, 0].detach())
        raise ValueError(f"unknown precondition mode: {self.precondition!r}")

    def _extremal_eigs(self, params: Dict):
        """Lanczos ``(eig_min, eig_max)`` of the (masked) ``Kmm + Lambda``,
        from a start vector seeded 0 on the parameters' device."""
        return self._eigs_of(self._system_matrix(params))

    def _system_matrix(self, params: Dict) -> torch.Tensor:
        """The (masked) ``Kmm + Lambda``, detached."""
        with torch.no_grad():
            kmm = self._masked_kmm(params["kernel"], params["inducing_points"],
                                   self._mask_of(params))
            return add_diagonal(kmm, self.diag_variance(params)[:, 0])

    @staticmethod
    def _eigs_of(kmm_lambda: torch.Tensor):
        gen = torch.Generator(device=kmm_lambda.device).manual_seed(0)
        return lanczos_extremal_eigs(kmm_lambda.detach(), gen,
                                     num_iters=min(64, kmm_lambda.shape[-1]))

    def resolve_precondition(self, params: Dict) -> Optional[str]:
        """``precondition="auto"`` resolved eagerly to ``"chol"`` or
        ``"pivchol"``: pivchol above ``_CHOL_AUTO_MAX_M``, else the exact
        factor where the Lanczos conditioning estimate says an fp32
        factorization is safe.  Other modes are returned as they are."""
        if self.precondition != "auto":
            return self.precondition
        z = params["inducing_points"]
        if z.shape[0] > _CHOL_AUTO_MAX_M:
            return "pivchol"
        eig_min, eig_max = self._extremal_eigs(params)
        return "chol" if chol_or_cg_from_eigs(eig_min, eig_max, z.dtype) == "chol" else "pivchol"

    def precond_state(self, params: Dict, key: Optional[torch.Generator] = None):
        """The solver-state for ``elbo(precond_override=...)``: ``()`` without
        a preconditioner, else the preconditioner's state."""
        kp = params["kernel"]
        z = params["inducing_points"]
        var = self.diag_variance(params)
        with torch.no_grad():
            kmm = self._masked_kmm(kp, z, self._mask_of(params))
        precond = self._build_preconditioner(kp, z, kmm, var, key)
        return () if precond is None else precond.state

    # -- objectives --------------------------------------------------------------

    def prior_kl(self, params: Dict, key: torch.Generator) -> torch.Tensor:
        kp = params["kernel"]
        z = params["inducing_points"]
        u = params["pseudo_u"]
        var = self.diag_variance(params)
        m, dtype = z.shape[0], z.dtype
        mask = self._mask_of(params)
        if mask is not None and self.num_probes is None:
            raise ValueError("capacity-padded CGGP requires num_probes (the identity-solve "
                             "trace/logdet path cannot mask pad rows)")

        kmm = self._masked_kmm(kp, z, mask)
        kmm_lambda = add_diagonal(kmm, var[:, 0])
        cg = self.conjugate_gradient
        # The "rff" sketch draws first here, then the trace and logdet probes.
        precond = self._build_preconditioner(kp, z, kmm, var, key)

        if self.num_probes is None:
            kmm_lambda_inv_u = cg(kmm_lambda, u, preconditioner=precond)
            kmm_lambda_inv_kmm = cg(kmm_lambda, kmm, preconditioner=precond)
            trace = torch.trace(kmm_lambda_inv_kmm)
            logdet_probes = None
        else:
            probes = rademacher(key, (m, self.num_probes), dtype)
            if mask is not None:
                probes = probes * mask[:, None]
            if self.fuse_kl_solves:
                solved = cg(kmm_lambda, torch.cat([u, probes], dim=-1), preconditioner=precond)
                kmm_lambda_inv_u = solved[:, :u.shape[-1]]
                kmm_lambda_inv_probes = solved[:, u.shape[-1]:]
            else:
                kmm_lambda_inv_u = cg(kmm_lambda, u, preconditioner=precond)
                kmm_lambda_inv_probes = cg(kmm_lambda, probes, preconditioner=precond)
            trace = torch.sum(kmm_lambda_inv_probes * (kmm @ probes)) / self.num_probes
            logdet_probes = self.num_probes

        quad = torch.sum((kmm @ kmm_lambda_inv_u) * kmm_lambda_inv_u)
        if self.logdet_variant == "slq":
            logdet = slq_logdet(kmm_lambda, cg, num_probes=logdet_probes or 8, key=key,
                                lanczos_iters=self.slq_lanczos_iters, preconditioner=precond,
                                mask=mask)
        else:
            logdet = eval_logdet(kmm_lambda, cg, num_probes=logdet_probes, key=key,
                                 preconditioner=precond, mask=mask)
        log_var = torch.log(var)
        const = torch.sum(log_var if mask is None else log_var * mask[:, None])
        return 0.5 * (quad - trace + logdet - const)

    def elbo(self, params: Dict, data: Tuple[torch.Tensor, torch.Tensor],
             key: Optional[torch.Generator] = None, precond_override=None) -> torch.Tensor:
        """ELBO with every CG right-hand side fused into one row-block solve
        ``[u | probes | logdet probes | Kmn]`` (and so one backward solve).

        ``precond_override`` (a state from :meth:`precond_state`, or ``()``
        for the identity) replaces the per-step preconditioner build."""
        if key is None:
            raise ValueError("CGGP.elbo requires a generator (key) for the trace/logdet probes")
        if self.num_probes is None or not self.fuse_kl_solves:
            if precond_override is not None:
                raise ValueError("precond_override is supported on the fused ELBO path only "
                                 "(num_probes set and fuse_kl_solves=True)")
            return self._elbo_unfused(params, data, key)

        x, y = data
        kp = params["kernel"]
        z = params["inducing_points"]
        u = params["pseudo_u"]
        var = self.diag_variance(params)
        m, dtype = z.shape[0], z.dtype
        mask = self._mask_of(params)

        kmm = self._masked_kmm(kp, z, mask)  # jitter = 0
        kmm_lambda = add_diagonal(kmm, var[:, 0])
        kmn = self._masked_kmn(kp, z, x, mask)  # [M, B]

        cg = self.conjugate_gradient
        p = self.num_probes
        probes = rademacher(key, (m, p), dtype)
        use_slq = self.logdet_variant == "slq"
        if use_slq:
            logdet_probes = torch.zeros((m, 0), dtype=dtype, device=z.device)
        else:
            # Independent probes for the logdet gradient, solved in the same
            # fused CG launch.
            logdet_probes = rademacher(key, (m, p), dtype)
        if mask is not None:
            probes = probes * mask[:, None]
            logdet_probes = logdet_probes * mask[:, None]

        if precond_override is None:
            # The "rff" sketch draws after the probes, in place of JAX's key_rff.
            precond = self._build_preconditioner(kp, z, kmm, var, key)
        else:
            precond = _precond_from_state(precond_override)

        rhs = torch.cat([u, probes, logdet_probes, kmn], dim=-1)
        solved = cg(kmm_lambda, rhs, preconditioner=precond)
        p_out = u.shape[-1]
        q = logdet_probes.shape[-1]
        inv_u = solved[:, :p_out]
        inv_probes = solved[:, p_out:p_out + p]
        inv_logdet_probes = solved[:, p_out + p:p_out + p + q]
        inv_kmn = solved[:, p_out + p + q:]

        trace = torch.sum(inv_probes * (kmm @ probes)) / p
        quad = torch.sum((kmm @ inv_u) * inv_u)
        if use_slq:
            logdet = slq_logdet(kmm_lambda, cg, num_probes=p, key=key,
                                lanczos_iters=self.slq_lanczos_iters, preconditioner=precond,
                                mask=mask)
        else:
            # The gradient reuses this launch's probe solutions (constants).
            logdet = eval_logdet_from_solves(kmm_lambda, logdet_probes, inv_logdet_probes)
        log_var = torch.log(var)
        const = torch.sum(log_var if mask is None else log_var * mask[:, None])
        kl = 0.5 * (quad - trace + logdet - const)

        knn = self.kernel.K_diag(kp, x)
        f_var = (knn - torch.sum(kmn * inv_kmn, dim=0))[:, None]
        f_mean = kmn.T @ inv_u
        var_exp = self.likelihood.variational_expectations(params["likelihood"], f_mean, f_var, y)
        return torch.sum(var_exp) * minibatch_scale(self.num_data, x.shape[0], kl.dtype) - kl

    def _elbo_unfused(self, params: Dict, data, key: torch.Generator) -> torch.Tensor:
        x, y = data
        kl = self.prior_kl(params, key)
        f_mean, f_var = self.predict_f(params, x, full_cov=False)
        var_exp = self.likelihood.variational_expectations(params["likelihood"], f_mean, f_var, y)
        return torch.sum(var_exp) * minibatch_scale(self.num_data, x.shape[0], kl.dtype) - kl

    def training_loss(self, params: Dict, data, key: Optional[torch.Generator] = None,
                      precond_override=None) -> torch.Tensor:
        return -self.elbo(params, data, key, precond_override=precond_override)

    def cg_stats(self, params: Dict, data, key: torch.Generator) -> CGStats:
        """Stats of the fused per-step solve ``[u | 2P probes | Kmn]`` under
        the training step's preconditioner."""
        x, _y = data
        kp = params["kernel"]
        z = params["inducing_points"]
        u = params["pseudo_u"]
        var = self.diag_variance(params)
        m = z.shape[0]
        mask = self._mask_of(params)
        with torch.no_grad():
            kmm = self._masked_kmm(kp, z, mask)
            kmm_lambda = add_diagonal(kmm, var[:, 0])
            kmn = self._masked_kmn(kp, z, x, mask)
            p = self.num_probes or 0
            probes = (rademacher(key, (m, 2 * p), z.dtype) if p
                      else torch.zeros((m, 0), dtype=z.dtype, device=z.device))
            if mask is not None:
                probes = probes * mask[:, None]
            precond = self._build_preconditioner(kp, z, kmm, var, key)
            _, stats = self.conjugate_gradient.solve_with_stats(
                kmm_lambda, torch.cat([u, probes, kmn], dim=-1), preconditioner=precond)
        return stats

    # -- prediction and serving ----------------------------------------------------

    def predict_f(self, params: Dict, x_new: torch.Tensor,
                  full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uncached prediction: ``[u | Kmn]`` solved in one row-block CG,
        under the training step's preconditioner."""
        kp = params["kernel"]
        z = params["inducing_points"]
        u = params["pseudo_u"]
        var = self.diag_variance(params)
        mask = self._mask_of(params)
        kmm = self._masked_kmm(kp, z, mask)
        kmn = self._masked_kmn(kp, z, x_new, mask)  # [M, T]
        kmm_lambda = add_diagonal(kmm, var[:, 0])
        precond = self._build_preconditioner(kp, z, kmm, var)
        solved = self.conjugate_gradient(kmm_lambda, torch.cat([u, kmn], dim=-1),
                                         preconditioner=precond)
        p_out = u.shape[-1]  # multi-output pseudo_u contributes P columns
        inv_u, inv_kmn = solved[:, :p_out], solved[:, p_out:]
        if full_cov:
            knn = self.kernel.K(kp, x_new)
            fvar = (knn - kmn.T @ inv_kmn)[None, ...]
        else:
            knn = self.kernel.K_diag(kp, x_new)
            fvar = (knn - torch.sum(kmn * inv_kmn, dim=0))[:, None]
        return kmn.T @ inv_u, fvar

    def resolve_serving_solver(self, params: Dict) -> str:
        """``solver="auto"`` resolved eagerly: ``"cg"`` above M = 16384, else
        ``"chol"`` where the Lanczos estimate of ``kappa * eps`` is safely
        below 1 (:func:`chol_or_cg_from_eigs`), else ``"cg"``."""
        return self._auto_serving_solver(self._system_matrix(params))

    def _auto_serving_solver(self, kmm_lambda: torch.Tensor) -> str:
        if kmm_lambda.shape[-1] > _CHOL_SERVING_MAX_M:
            return "cg"
        eig_min, eig_max = self._eigs_of(kmm_lambda)
        return chol_or_cg_from_eigs(eig_min, eig_max, kmm_lambda.dtype)

    def posterior(self, params: Dict, key: Optional[torch.Generator] = None,
                  solver: str = "auto") -> "CGGPPosterior":
        """Everything that depends only on ``params``: ``nu = (Kmm +
        Lambda)^{-1} u`` and either the system matrix with its
        preconditioner state (``solver="cg"``: each batch solves its ``Kmn``
        block by CG), its Cholesky factor (``solver="chol"``: two
        triangular solves per batch) or the LOVE cache (``solver=
        "lanczos"``: ``R`` [k, M] from ``k = min(serving_lanczos_rank, M)``
        Lanczos steps of ``[1, M] @ (Kmm + Lambda)`` seeded with ``u``, so a
        batch's variance is two skinny products, a conservative
        over-estimate exact at ``k = M``; the mean stays the CG ``nu``'s);
        ``"auto"`` picks ``"chol"`` or ``"cg"`` by the Lanczos conditioning
        estimate.  ``key`` is the generator of the ``"rff"`` sketch (seeded
        0 when None).

        A failed factorization leaves a NaN factor, as ``jnp.linalg.cholesky``
        does, so the serving guard in ``predict_in_batches`` can report it."""
        if solver not in ("auto", "chol", "cg", "lanczos"):
            raise ValueError(f"unknown posterior solver: {solver!r}")
        kp = params["kernel"]
        z = params["inducing_points"]
        u = params["pseudo_u"]
        var = self.diag_variance(params)
        mask = self._mask_of(params)
        kmm = self._masked_kmm(kp, z, mask)
        kmm_lambda = add_diagonal(kmm, var[:, 0])
        if solver == "auto":
            solver = self._auto_serving_solver(kmm_lambda)
        if solver == "chol":
            chol = _cholesky_or_nan(kmm_lambda)
            nu = torch.cholesky_solve(u, chol)
            return CGGPPosterior(kernel_params=kp, inducing_points=z, kmm_lambda=None,
                                 nu=nu, precond_state=(), chol=chol, inducing_mask=mask,
                                 lam=var[:, 0])
        precond = self._build_preconditioner(kp, z, kmm, var, key)
        nu = self.conjugate_gradient(kmm_lambda, u, preconditioner=precond)
        if solver == "lanczos":
            a = kmm_lambda.detach()
            rank = min(int(self.serving_lanczos_rank), int(z.shape[0]))
            with torch.no_grad():
                lanczos_r = lanczos_quad_cache_rows(lambda rows: torch.matmul(rows, a),
                                                    love_seed_row(u.T), rank)
            # No system matrix kept: the LOVE path never solves again.
            return CGGPPosterior(kernel_params=kp, inducing_points=z, kmm_lambda=None,
                                 nu=nu, precond_state=(), chol=None, lanczos_r=lanczos_r,
                                 inducing_mask=mask, lam=var[:, 0])
        return CGGPPosterior(kernel_params=kp, inducing_points=z, kmm_lambda=kmm_lambda,
                             nu=nu, precond_state=() if precond is None else precond.state,
                             chol=None, inducing_mask=mask, lam=var[:, 0])

    def posterior_mean(self, post: "CGGPPosterior", x_new: torch.Tensor) -> torch.Tensor:
        """CG-free serving mean: ``K(x, Z) @ nu``."""
        kmn = self._masked_kmn(post.kernel_params, post.inducing_points, x_new,
                               post.inducing_mask)
        return kmn.T @ post.nu

    def posterior_predict(self, post: "CGGPPosterior", x_new: torch.Tensor,
                          full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and variance from the cache: the [M, T] Kmn block through
        two triangular solves (``"chol"``), one CG solve (``"cg"``) or two
        skinny products with the LOVE rows (``"lanczos"``)."""
        kp = post.kernel_params
        kmn = self._masked_kmn(kp, post.inducing_points, x_new, post.inducing_mask)  # [M, T]
        if post.lanczos_r is not None:
            knn = self.kernel.K(kp, x_new) if full_cov else self.kernel.K_diag(kp, x_new)
            return kmn.T @ post.nu, love_variance(post.lanczos_r, kmn.T, knn, full_cov)
        if post.chol is not None:
            inv_kmn = torch.cholesky_solve(kmn, post.chol)
        else:
            inv_kmn = self.conjugate_gradient(post.kmm_lambda, kmn,
                                              preconditioner=_precond_from_state(
                                                  post.precond_state))
        if full_cov:
            knn = self.kernel.K(kp, x_new)
            fvar = (knn - kmn.T @ inv_kmn)[None, ...]
        else:
            knn = self.kernel.K_diag(kp, x_new)
            fvar = (knn - torch.sum(kmn * inv_kmn, dim=0))[:, None]
        return kmn.T @ post.nu, fvar


class CGGPPosterior(NamedTuple):
    """Serving cache produced by :meth:`CGGP.posterior`, with the JAX
    package's fields in its order."""

    kernel_params: Dict
    inducing_points: torch.Tensor
    kmm_lambda: Optional[torch.Tensor]  # [M, M] = Kmm + diag(Lambda); None on chol
    nu: torch.Tensor  # [M, 1] = (Kmm + Lambda)^{-1} pseudo_u
    precond_state: Tuple  # () identity, a 3-tuple Spectral state, a dict Chol state
    chol: Optional[torch.Tensor] = None  # [M, M] lower Cholesky of Kmm + Lambda
    lanczos_r: Optional[torch.Tensor] = None  # [k, M] LOVE quadratic-form cache ("lanczos")
    inducing_mask: Optional[torch.Tensor] = None  # [M] 1 real / 0 pad; None unpadded
    lam: Optional[torch.Tensor] = None  # [M] diagonal Lambda the cache was built with


class _StatePreconditioner:
    """A cached preconditioner state rewrapped for the CG facade: a
    :class:`CholPreconditioner` dict (``{"chol_w": W}``) or a
    :class:`SpectralPreconditioner` tuple."""

    def __init__(self, state):
        self.state = state
        self.apply = (CholPreconditioner.apply if isinstance(state, dict)
                      else SpectralPreconditioner.apply)

    def __call__(self, vec, mat=None):
        return self.apply(self.state, vec, mat)


def _precond_from_state(state):
    if isinstance(state, tuple) and state == ():
        return None
    return _StatePreconditioner(state)
