"""ImplicitCGGP: single-device CGGP that never materialises the [M, M] Gram
(port of ``cggp_tpu/models/implicit.py``).

Every ``Kuu`` operation goes through :mod:`cggp_tpu_torch.ops.cg_implicit`:

* solves: :func:`~cggp_tpu_torch.ops.cg_implicit.make_implicit_cg` (matvecs
  over [block, M] kernel panels, or kernel B3 with ``use_pallas=True``),
  differentiable through a second solve on the same route;
* the KL matvecs and the logdet gradients: the blocked matvec, each panel
  rebuilt in the backward pass;
* the SLQ logdet value: batched row Lanczos
  (:func:`~cggp_tpu_torch.ops.logdet.slq_value_rows`) over the blocked
  matvec;
* preconditioning: the matrix-free pivoted Cholesky or an RFF sketch.

M is padded to a multiple of ``block`` with exactly decoupled
pseudo-points.  Peak memory of a training step is O(block * M + R * M),
R = 1 + probes + batch.  Serving by LOVE (``posterior(solver="lanczos")``)
is not ported yet (:mod:`cggp_tpu_torch.models.rowcg`).
"""

from __future__ import annotations

import dataclasses

from cggp_tpu_torch.models.rowcg import RowCGGPPosterior, RowSolveCGGP
from cggp_tpu_torch.ops.cg_implicit import blocked_kuu_matvec, make_implicit_cg
from cggp_tpu_torch.ops.logdet import slq_value_rows

# The serving cache is the shared row-convention one (chol always None here).
ImplicitCGGPPosterior = RowCGGPPosterior


@dataclasses.dataclass(frozen=True)
class ImplicitCGGP(RowSolveCGGP):
    """Matrix-free CGGP for M beyond the [M, M] memory budget.

    ``block`` is the panel height of the plain route's Gram row blocks;
    ``use_pallas=True`` routes every forward and backward solve matvec
    through kernel B3 (the gradient's matvec VJP is the blocked route's)."""

    block: int = 2048
    use_pallas: bool = False

    def __post_init__(self):
        solve = make_implicit_cg(
            self.kernel, self.error_threshold, self.max_cg_iterations,
            block=self.block, use_pallas=self.use_pallas,
            relative_threshold=self.relative_threshold)
        object.__setattr__(self, "_solve", solve)
        object.__setattr__(self, "_route_matvec", solve.route_matvec)

        def matvec(kp, z, lam, mask, rows):
            return blocked_kuu_matvec(self.kernel, kp, z, lam, rows, block=self.block, mask=mask)

        object.__setattr__(self, "_matvec", matvec)

        def slq_value(kp, z, lam, mask, probes):
            return slq_value_rows(lambda v: matvec(kp, z, lam, mask, v), probes,
                                  self.slq_lanczos_iters)

        object.__setattr__(self, "_slq_value", slq_value)
        self._wire_logdets()

    def _pad_multiple_for(self, m: int) -> int:
        # blocked_kuu_matvec handles m <= block in one panel; above that M
        # must divide the panel height.
        return self.block if m > self.block else 1
