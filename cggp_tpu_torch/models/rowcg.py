"""CGGP over an implicit ``Kuu + diag(lam)`` (port of
``cggp_tpu/models/rowcg.py``, serving slice).

The model is expressed against hooks a subclass wires in its
``__post_init__`` (frozen dataclass, so via ``object.__setattr__``):

    _solve(kp, z, lam, rhs [R, M], precond_state, mask) -> (solution, CGStats)
    _matvec(kp, z, lam, mask, rows [R, M]) -> rows @ (K*mask + diag(lam))
    _pad_multiple_for(m) -> int   (inducing count padded to this multiple)

Everything is row-convention ([R, M] right-hand sides).  M is padded with
:func:`cggp_tpu_torch.ops.cg_implicit.pad_inducing` and an
``inducing_mask`` parameter keeps the pads exact no-ops.

This slice serves: ``init_params`` (padding, ``inducing_mask``,
``capacity``), the pivoted-Cholesky preconditioner, ``predict_f``,
``posterior(solver="cg")`` (``"auto"`` resolves to ``"cg"``),
``posterior_mean`` and ``posterior_predict``.  The ELBO, ``prior_kl``,
``cg_stats``, re-clustering, the logdet wiring, the ``"rff"``
preconditioner and ``"lanczos"`` serving raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from cggp_tpu_torch.models.clustergp import ClusterGP
from cggp_tpu_torch.ops.cg import spectral_precond_state
from cggp_tpu_torch.ops.cg_implicit import pad_inducing, pivoted_cholesky_kernel


def _training_slice(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} arrives with the matrix-free training slice of the port "
                               "(ROADMAP Queue A item 5)")


@dataclasses.dataclass(frozen=True)
class RowSolveCGGP(ClusterGP):
    """CGGP over an implicit (never materialised) ``Kuu + diag(lam)``."""

    error_threshold: float = 1e-8
    max_cg_iterations: int = 100
    precondition: Optional[str] = None  # None | "pivchol" | "rff"
    precond_rank: int = 128
    relative_threshold: bool = False
    logdet_variant: str = "zero"  # "zero" | "slq"

    def _wire_logdets(self) -> None:
        """Call at the end of the subclass ``__post_init__``.  Serving needs
        no logdet; the matrix-free logdet estimators arrive with training."""
        if self.logdet_variant not in ("zero", "slq"):
            raise ValueError(f"unknown logdet_variant: {self.logdet_variant!r}")
        if self.logdet_variant == "slq":
            raise _training_slice("logdet_variant='slq' (matrix-free Lanczos quadrature)")

    def _pad_multiple_for(self, m: int) -> int:
        raise NotImplementedError

    def _precond_state(self, kp, z, lam, mask=None):
        """Solver-state tuple for the solve; ``()`` = identity."""
        if self.precondition is None:
            return ()
        if self.precondition == "rff":
            raise NotImplementedError(
                "precondition='rff' (the random-Fourier sketch) arrives with a later "
                "slice of the port; use 'pivchol'")
        if self.precondition != "pivchol":
            raise ValueError(f"unknown precondition mode: {self.precondition!r}")
        # Pads keep the full constant K_diag; left unmasked, greedy pivoting
        # would burn columns on no-op directions.
        factor = pivoted_cholesky_kernel(self.kernel, kp, z, self.precond_rank, mask=mask)
        return spectral_precond_state(factor, lam)

    # -- parameters ----------------------------------------------------------

    def init_params(self, inducing_points, pseudo_u=None, cluster_counts=None,
                    capacity: Optional[int] = None, **kwargs) -> Dict:
        """``capacity`` pins the padded inducing dimension to a fixed size >=
        the real count (a multiple of the model's pad multiple)."""
        params = super().init_params(inducing_points, pseudo_u=pseudo_u,
                                     cluster_counts=cluster_counts, **kwargs)
        z = params["inducing_points"]
        m_real, dtype, device = z.shape[0], z.dtype, z.device
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
        ones = torch.ones((1, m_real), dtype=dtype, device=device)
        z, _lam, u_t, counts_t, mask_t = pad_inducing(
            z, ones[0], multiple, params["pseudo_u"].T, params["cluster_counts"].T, ones)
        params["inducing_points"] = z
        params["pseudo_u"] = u_t.T
        # Padded counts of 1 give lam = noise there; the mask decouples pads.
        counts = counts_t.T
        params["cluster_counts"] = torch.where(counts == 0.0, torch.ones_like(counts), counts)
        params["inducing_mask"] = mask_t.T
        return params

    # -- not in this slice ---------------------------------------------------

    def assign_clusters(self, *args, **kwargs):
        raise _training_slice("assign_clusters (re-clustering)")

    def assign_clusters_device(self, *args, **kwargs):
        raise _training_slice("assign_clusters_device (re-clustering)")

    def prior_kl(self, params: Dict, key=None):
        raise _training_slice("prior_kl (probes and the matrix-free logdet)")

    def elbo(self, params: Dict, data, key=None, precond_override=None):
        raise _training_slice("the fused ELBO")

    def cg_stats(self, params: Dict, data, key=None):
        raise _training_slice("cg_stats (probe solves)")

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

    def posterior(self, params: Dict, solver: str = "auto") -> "RowCGGPPosterior":
        """The params-only serving state: the u-solve ``nu`` and the
        preconditioner; ``posterior_predict`` then solves only the Kmn rows.
        ``"auto"`` is ``"cg"``."""
        if solver == "auto":
            solver = self.resolve_serving_solver(params)
        if solver == "chol":
            raise ValueError(
                f"{type(self).__name__} serves matrix-free; solver='chol' would "
                "materialise the [M, M] system this model exists to avoid — "
                "use 'cg' or 'auto'")
        if solver == "lanczos":
            raise NotImplementedError(
                "posterior(solver='lanczos') (the LOVE cache) arrives with a later "
                "slice of the port; pass solver='cg'")
        if solver != "cg":
            raise ValueError(f"unknown posterior solver: {solver!r}")
        kp = params["kernel"]
        z = params["inducing_points"]
        u = params["pseudo_u"]
        lam = self.diag_variance(params)[:, 0]
        mask = params["inducing_mask"][:, 0]
        precond_state = self._precond_state(kp, z, lam, mask)
        nu, _ = self._solve(kp, z, lam, u.T, precond_state, mask)
        return RowCGGPPosterior(kernel_params=kp, inducing_points=z, lam=lam, mask=mask,
                                nu=nu, precond_state=precond_state)

    def posterior_mean(self, post: "RowCGGPPosterior", x_new: torch.Tensor) -> torch.Tensor:
        """CG-free serving mean: one skinny ``K(x, Z) @ nu`` product."""
        kmn = self.kernel.K(post.kernel_params, x_new, post.inducing_points)
        return (kmn * post.mask[None, :]) @ post.nu.T  # [T, 1]

    def posterior_predict(self, post: "RowCGGPPosterior", x_new: torch.Tensor,
                          full_cov: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and variance from the cache: one CG solve of the [T, M] Kmn
        rows (u-solve and preconditioner build amortized)."""
        kp = post.kernel_params
        z = post.inducing_points
        kmn = self.kernel.K(kp, x_new, z) * post.mask[None, :]  # [T, M]
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
    lanczos_r: Optional[torch.Tensor] = None  # LOVE cache: always None (no "lanczos" solver)
