"""ShardedIterGPR: exact GP regression with the [N, N] system row-sharded
over the rank mesh (port of ``cggp_tpu/parallel/itergpr.py``).

Each rank owns a row block of ``K(X, X) + sigma^2 I`` built on the fly (the
system exists whole on no rank) and every CG or Lanczos step reduces with
one all-reduce: the machinery of :mod:`cggp_tpu_torch.parallel.sharded_cg`
pointed at the training inputs.  All objective and serving math is
:class:`~cggp_tpu_torch.models.itergpr.IterGPR`'s; this class re-wires its
solver hooks to the sharded ones and pads N to the mesh multiple (pads
masked, exactly decoupled).
"""

from __future__ import annotations

import dataclasses

from cggp_tpu_torch.models.itergpr import IterGPR, IterGPRPosterior  # noqa: F401
from cggp_tpu_torch.ops.logdet import make_matfree_logdet_from_solves
from cggp_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from cggp_tpu_torch.parallel.sharded_cg import (make_sharded_cg, make_sharded_matvec,
                                                make_sharded_slq_value)

# The serving cache is the shared one (alpha row + preconditioner state).
ShardedIterGPRPosterior = IterGPRPosterior


@dataclasses.dataclass(frozen=True)
class ShardedIterGPR(IterGPR):
    """IterGPR with the N axis sharded over a rank mesh.

    ``block`` / ``use_pallas`` are inherited but unused: each rank's row
    block is its panel (N / d rows), as in the JAX package."""

    mesh: Mesh = None  # type: ignore[assignment]
    axis_name: str = DATA_AXIS

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError("ShardedIterGPR requires a mesh (make_mesh())")
        if self.logdet_variant not in ("zero", "slq"):
            raise ValueError(f"unknown logdet_variant: {self.logdet_variant!r}")
        solve = make_sharded_cg(self.kernel, self.mesh, self.error_threshold,
                                self.max_cg_iterations, axis_name=self.axis_name,
                                relative_threshold=self.relative_threshold)
        matvec = make_sharded_matvec(self.kernel, self.mesh, self.axis_name)
        object.__setattr__(self, "_solve", solve)
        object.__setattr__(self, "_route_matvec", solve.route_matvec)
        object.__setattr__(self, "_matvec", matvec)
        object.__setattr__(self, "_slq_value",
                           make_sharded_slq_value(self.kernel, self.mesh, self.slq_lanczos_iters,
                                                  self.axis_name))
        object.__setattr__(self, "_logdet_from_solves", make_matfree_logdet_from_solves(matvec))

    def _pad_multiple_for(self, n: int) -> int:
        return self.mesh.size
