"""Scale-out over a mesh of ranks, one device each, over
``torch.distributed`` (port of ``cggp_tpu/parallel``).

* :mod:`cggp_tpu_torch.parallel.mesh` — the rank mesh, sharding helpers and
  collectives.
* :mod:`cggp_tpu_torch.parallel.data_parallel` — data-parallel losses,
  serving and training steps: batch rows sharded over the ranks, each
  rank the data term of its rows, parameters replicated.
* :mod:`cggp_tpu_torch.parallel.sharded_cg` — CG whose ``p @ (Kuu + Lambda)``
  matvec is summed from row blocks of the Gram matrix built on each rank
  and all-reduced, so ``Kuu`` is never whole on any device.
* :class:`ShardedCGGP` and :class:`ShardedIterGPR` — the models over it.
"""

from cggp_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
from cggp_tpu_torch.parallel.data_parallel import (
    make_data_parallel_loss,
    make_data_parallel_predict,
)
from cggp_tpu_torch.parallel.sharded_cg import (
    make_sharded_cg,
    pad_inducing,
    pivoted_cholesky_kernel,
    spectral_precond_state,
    ShardedKuuSolver,
)
from cggp_tpu_torch.parallel.model import (
    ShardedCGGP,
    ShardedCGGPPosterior,
    make_sharded_eval_logdet,
)
from cggp_tpu_torch.parallel.itergpr import ShardedIterGPR, ShardedIterGPRPosterior

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "make_data_parallel_loss",
    "make_data_parallel_predict",
    "pad_inducing",
    "make_sharded_cg",
    "pivoted_cholesky_kernel",
    "spectral_precond_state",
    "ShardedKuuSolver",
    "ShardedCGGP",
    "ShardedCGGPPosterior",
    "ShardedIterGPR",
    "ShardedIterGPRPosterior",
    "make_sharded_eval_logdet",
]
