"""ShardedCGGP: the CGGP with every ``Kuu`` operation row-sharded over the
rank mesh (port of ``cggp_tpu/parallel/model.py``).

The inducing count M scales across ranks: every CG solve and Gram matvec
goes through :mod:`cggp_tpu_torch.parallel.sharded_cg` (each rank builds its
[M / d, M] row block; one all-reduce a matvec), while the [*, M] state and
the data terms stay replicated.  All objective and serving math is
:class:`~cggp_tpu_torch.models.rowcg.RowSolveCGGP`'s, shared with the
single-device matrix-free ``ImplicitCGGP``; this class wires the sharded
hooks and pads M to a multiple of the mesh size.  Serving may also
factorize the masked ``Kmm + Lambda`` once (``posterior(solver="chol")``),
a replica on every rank.
"""

from __future__ import annotations

import dataclasses

from cggp_tpu_torch.models.rowcg import RowCGGPPosterior, RowSolveCGGP
from cggp_tpu_torch.ops.logdet import (  # noqa: F401 (the JAX package's aliases)
    make_matfree_eval_logdet as make_sharded_eval_logdet,
    make_matfree_logdet_from_solves as make_sharded_logdet_from_solves,
    make_matfree_slq_logdet as make_sharded_slq_logdet,
)
from cggp_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from cggp_tpu_torch.parallel.sharded_cg import (make_sharded_cg, make_sharded_matvec,
                                                make_sharded_slq_value)

# The serving cache is the shared row-convention one.
ShardedCGGPPosterior = RowCGGPPosterior


@dataclasses.dataclass(frozen=True)
class ShardedCGGP(RowSolveCGGP):
    """CGGP with M sharded over a rank mesh (:func:`~cggp_tpu_torch.parallel.make_mesh`).

    ``init_params`` pads (Z, u, counts) so M divides the mesh size; see
    :class:`RowSolveCGGP` for the shared fields."""

    mesh: Mesh = None  # type: ignore[assignment]
    axis_name: str = DATA_AXIS

    _supports_chol_serving = True
    _solve_takes_every_row = True

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError("ShardedCGGP requires a mesh")
        solve = make_sharded_cg(self.kernel, self.mesh, self.error_threshold,
                                self.max_cg_iterations, axis_name=self.axis_name,
                                relative_threshold=self.relative_threshold)
        object.__setattr__(self, "_solve", solve)
        object.__setattr__(self, "_route_matvec", solve.route_matvec)
        object.__setattr__(self, "_matvec",
                           make_sharded_matvec(self.kernel, self.mesh, self.axis_name))
        object.__setattr__(self, "_slq_value",
                           make_sharded_slq_value(self.kernel, self.mesh, self.slq_lanczos_iters,
                                                  axis_name=self.axis_name))
        self._wire_logdets()

    @property
    def num_devices(self) -> int:
        return self.mesh.size

    def _pad_multiple_for(self, m: int) -> int:
        return self.mesh.size
