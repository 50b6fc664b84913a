"""Data-parallel training and serving steps over the rank mesh (port of
``cggp_tpu/parallel/data_parallel.py``).

Batch rows arrive sharded (:func:`~cggp_tpu_torch.parallel.mesh.shard_batch`,
each rank its block); parameters are replicated.

* Serving (:func:`make_data_parallel_predict`): each rank predicts its own
  query rows, outputs stay row-sharded.  A CG solve inside takes its stop
  decision from every rank (``ops.cg.agreed_stop``, a MAX all-reduce of the
  over-threshold flag), so each rank runs the steps the single-device solve
  of all the rows runs.
* Training (:func:`make_data_parallel_loss`,
  :func:`make_data_parallel_train_step`): the objective runs under a row
  shard (``models.base.row_shard``).  The ELBO that claims it (``CGGP``
  and the row-solve CGGPs) evaluates its data term on this rank's rows,
  counts its replicated terms (the KL) once, and totals the value and the
  gradients over the ranks, so the Adam update is the same on every rank.
  The dense and matrix-free models solve ``[u | probes | Kmn(its rows)]``
  on each rank, the stop decisions agreed; ``ShardedCGGP``, whose ranks
  hold row blocks of one system, gathers the batch's rows for its solve's
  right-hand sides (as the JAX package's ``shard_map`` takes them
  replicated) and keeps only the likelihood terms of its rows.  An
  objective that does not claim the shard is refused (``ValueError``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from cggp_tpu_torch.models.base import RowShard, row_shard
from cggp_tpu_torch.ops.cg import agreed_stop
from cggp_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, agree_max, all_gather_rows,
                                          sum_grads, total)


def _row_shard_of(mesh: Mesh) -> RowShard:
    return RowShard(size=mesh.size, rank=mesh.rank,
                    gather_rows=lambda t: all_gather_rows(mesh, t),
                    total=lambda t: total(mesh, t),
                    sum_grads=lambda tree: sum_grads(mesh, tree))


def make_data_parallel_loss(loss_fn: Callable, mesh: Mesh,
                            axis_name: str = DATA_AXIS) -> Callable:
    """``loss(params, (x_rows, y_rows), key)`` from this rank's batch rows
    (every rank's block of one batch, of equal size): ``loss_fn``'s value
    on the whole batch, the same on every rank, each rank computing the
    data term of its rows; its gradients are totalled over the ranks."""
    del axis_name
    shard = _row_shard_of(mesh)

    def loss(params, batch, key):
        with row_shard(shard) as claimed, agreed_stop(lambda flag: agree_max(mesh, flag)):
            value = loss_fn(params, batch, key)
        if not claimed:
            raise ValueError(
                "make_data_parallel_loss: the objective did not split its data term over the "
                "ranks (CGGP, ImplicitCGGP and ShardedCGGP ELBOs do)")
        return value

    return loss


def make_data_parallel_predict(predict_fn: Callable, mesh: Mesh,
                               axis_name: str = DATA_AXIS) -> Callable:
    """``predict(params, x_rows) -> (mean, var)`` of this rank's query rows
    (outputs row-sharded), every CG stop decision agreed across the ranks."""
    del axis_name

    def predict(params, x_rows):
        with agreed_stop(lambda flag: agree_max(mesh, flag)):
            return predict_fn(params, x_rows)

    return predict


def make_data_parallel_train_step(loss_fn: Callable, optimizer, mesh: Mesh,
                                  trainable_mask: Optional[Dict] = None,
                                  axis_name: str = DATA_AXIS) -> Callable:
    """``step(params, opt_state, (x_rows, y_rows), key) -> (params, opt_state,
    loss)``: :func:`~cggp_tpu_torch.training.optimize.make_adam_step` of the
    data-parallel loss, replicated on every rank."""
    from cggp_tpu_torch.training.optimize import make_adam_step

    return make_adam_step(make_data_parallel_loss(loss_fn, mesh, axis_name), optimizer,
                          trainable_mask)
