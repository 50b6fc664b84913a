"""ImplicitCGGP: single-device CGGP that never materialises the [M, M] Gram
(port of ``cggp_tpu/models/implicit.py``, serving slice).

Every ``Kuu`` operation goes through :mod:`cggp_tpu_torch.ops.cg_implicit`:
solves are :func:`~cggp_tpu_torch.ops.cg_implicit.make_implicit_cg` (matvecs
over [block, M] kernel panels, or kernel B3 with ``use_pallas=True``), and
the preconditioner is the matrix-free pivoted Cholesky.  M is padded to a
multiple of ``block`` with exactly decoupled pseudo-points.  The SLQ logdet
value (``_slq_value``) arrives with the matrix-free training slice.
"""

from __future__ import annotations

import dataclasses

from cggp_tpu_torch.models.rowcg import RowCGGPPosterior, RowSolveCGGP
from cggp_tpu_torch.ops.cg_implicit import blocked_kuu_matvec, make_implicit_cg

# The serving cache is the shared row-convention one (chol always None here).
ImplicitCGGPPosterior = RowCGGPPosterior


@dataclasses.dataclass(frozen=True)
class ImplicitCGGP(RowSolveCGGP):
    """Matrix-free CGGP for M beyond the [M, M] memory budget.

    ``block`` is the panel height of the plain route's Gram row blocks;
    ``use_pallas=True`` routes every solve matvec through kernel B3."""

    block: int = 2048
    use_pallas: bool = False

    def __post_init__(self):
        solve = make_implicit_cg(
            self.kernel, self.error_threshold, self.max_cg_iterations,
            block=self.block, use_pallas=self.use_pallas,
            relative_threshold=self.relative_threshold)
        object.__setattr__(self, "_solve", solve)

        def matvec(kp, z, lam, mask, rows):
            return blocked_kuu_matvec(self.kernel, kp, z, lam, rows, block=self.block, mask=mask)

        object.__setattr__(self, "_matvec", matvec)
        self._wire_logdets()

    def _pad_multiple_for(self, m: int) -> int:
        # blocked_kuu_matvec handles m <= block in one panel; above that M
        # must divide the panel height.
        return self.block if m > self.block else 1
