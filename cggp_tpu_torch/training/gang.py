"""Gang training: G same-shape model replicas trained together (port of
``cggp_tpu/training/gang.py``).

A grid sweep (seeds x learning rates x inits at a fixed inducing count)
stacks its replicas on a leading gang axis G: parameters, Adam moments and
the per-member learning rates are [G, ...] tensors, and one step runs every
member.  The contract is the JAX package's: gang training changes the
schedule, never the math.  A member fed the same generator and index
stream as a solo :func:`~cggp_tpu_torch.training.optimize.make_adam_multi_step`
run reproduces its trajectory.

What runs batched.  ``loss_fn(params_G, batch_G, keys)`` gets the stacked
parameters, the members' batches ``(x [G, B, D], y [G, B, P])`` and a list
of G generators, and returns [G] losses; ``CGGP.training_loss`` does so
(its fused ELBO as one gang solve under no preconditioner, the exact
factor or pivoted Cholesky, the factors built batched; ``models/cggp.py``).  For any other loss,
:func:`per_member` runs the members one at a time.  The gang CG
(``ops/cg.py``) runs until every member's stop rule holds; a member that
has stopped keeps its state, as JAX's batched ``while_loop`` selects the old
carry, so it gets its solo iterates.  On the card the ``"pallas"`` and
``"xla_high"`` routes run each matvec of the gang as one B1 launch (the
gang on the kernel's grid), ``"xla"`` as one batched IEEE fp32 matmul, and
``"pallas_resident"`` one B2 launch per member and solve.

Per-model learning rates replace ``optax.inject_hyperparams``: the rate is a
[G] tensor of the optimizer state, broadcast into each leaf's update.

Over a mesh (:func:`shard_gang`, ``train_gang_adam(mesh=...)``) each rank
trains its G / W block of the gang with no collective during training; the
trained members are gathered at the end, so every rank returns all of them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cggp_tpu_torch.training.batching import minibatch_index_iterator, seed_from
from cggp_tpu_torch.training.optimize import (Adam, AdamState, _leaves, _mask_grads,
                                              _tree_map, _unflatten_like)

GANG_AXIS = "gang"


def stack_pytrees(trees: Sequence):
    """Stack same-structure dicts of tensors along a new leading gang axis."""
    if not trees:
        raise ValueError("stack_pytrees: need at least one pytree")
    return _tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def unstack_pytree(tree, size: int) -> List:
    """Split a gang-stacked dict back into ``size`` per-model dicts."""
    return [_tree_map(lambda x: x[g], tree) for g in range(size)]


def shard_gang(mesh, tree):
    """This rank's block of a gang-stacked dict: leaves whose leading size
    divides the mesh size are cut to rows ``[r G / W, (r + 1) G / W)``, the
    others kept whole (replicated), as the JAX package replicates them."""
    n, r = mesh.size, mesh.rank

    def _take(x):
        x = torch.as_tensor(x)
        if x.dim() >= 1 and x.shape[0] % n == 0:
            block = x.shape[0] // n
            return x[r * block:(r + 1) * block]
        return x

    return _tree_map(_take, tree)


class GangAdamState(NamedTuple):
    count: int  # steps taken (the same for every member)
    mu: Dict  # first moments, [G, ...] leaves
    nu: Dict  # second moments
    learning_rate: torch.Tensor  # [G], each member's own rate


class GangAdam(NamedTuple):
    """``optax.adam`` with the learning rate read from the state ([G]):
    :class:`~cggp_tpu_torch.training.optimize.Adam`'s update at rate 1,
    scaled by each member's rate (the same bits as that member's solo
    update: negation and the unit rate are exact)."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def update(self, grads: Dict, state: GangAdamState, params=None):
        unit, inner = Adam(1.0, self.b1, self.b2, self.eps).update(
            grads, AdamState(state.count, state.mu, state.nu), params)

        def scaled(u):
            return u * state.learning_rate.to(u.dtype).reshape((-1,) + (1,) * (u.dim() - 1))

        return (_tree_map(scaled, unit),
                GangAdamState(inner.count, inner.mu, inner.nu, state.learning_rate))


def init_gang_adam(params_list: Sequence[Dict],
                   learning_rates: Sequence[float]) -> Tuple[GangAdam, GangAdamState]:
    """Adam with per-model learning rates: ``(optimizer, stacked state)``, the
    state's ``learning_rate`` a [G] tensor on the parameters' device."""
    if len(params_list) != len(learning_rates):
        raise ValueError(f"init_gang_adam: {len(params_list)} param sets vs "
                         f"{len(learning_rates)} learning rates")
    stacked = stack_pytrees(params_list)
    first = _leaves(stacked)[0]
    rates = torch.as_tensor(np.asarray(learning_rates, dtype=np.float64),
                            device=first.device).to(first.dtype)
    state = GangAdamState(count=0, mu=_tree_map(torch.zeros_like, stacked),
                          nu=_tree_map(torch.zeros_like, stacked), learning_rate=rates)
    return GangAdam(), state


def gang_index_chunks(key, n: int, batch_size: int, chunk: int, gang: int, device=None):
    """Infinite stream of [chunk, G, batch] int64 index blocks: G independent
    epoch-permutation streams (distinct grid cells must not share minibatch
    noise), interleaved per step.  Member g's stream is
    :func:`~cggp_tpu_torch.training.batching.minibatch_index_iterator` of the
    g-th seed drawn from ``key`` (a generator; an int is taken as the first
    member's seed, the others following it)."""
    if isinstance(key, torch.Generator):
        seeds = [seed_from(key) for _ in range(gang)]
    else:
        seeds = [int(key) + g for g in range(gang)]
    iterators = [minibatch_index_iterator(s, n, batch_size, chunk, device=device)
                 for s in seeds]
    while True:
        yield torch.stack([next(it) for it in iterators], dim=1)


def per_member(loss_fn: Callable) -> Callable:
    """A gang loss from a one-model ``loss_fn(params, batch, key)``: the
    members run one at a time and their losses are stacked."""

    def gang_loss(params, batch, keys):
        x, y = batch
        return torch.stack([loss_fn(_tree_map(lambda t: t[g], params), (x[g], y[g]), k)
                            for g, k in enumerate(keys)])

    return gang_loss


def make_adam_gang_multi_step(loss_fn: Callable, optimizer: GangAdam, data,
                              trainable_mask: Optional[Dict] = None):
    """``gang_multi_step(params_G, opt_state_G, idx_chunk [K, G, B], keys) ->
    (params_G, opt_state_G, losses [K, G])``: K Adam steps of every member,
    each on the members' batches gathered on the data's device, every
    member's probes drawn in order from its own generator ``keys[g]``.

    The step body is :func:`~cggp_tpu_torch.training.optimize.make_adam_step`'s:
    gradients of the summed member losses (members are independent, so each
    gets its own gradient), masked by ``trainable_mask`` (shared by the
    gang), then the per-member-rate Adam update."""
    x, y = data

    def gang_multi_step(params: Dict, opt_state: GangAdamState, idx_chunk: torch.Tensor, keys):
        keys = list(keys)
        losses = []
        for idx in idx_chunk.to(x.device):  # [G, B] rows as views: no host read
            batch = (x[idx], y[idx])
            leaves = [leaf.detach().requires_grad_() for leaf in _leaves(params)]
            live = _unflatten_like(params, leaves)
            loss = loss_fn(live, batch, keys)
            grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
            grads = [torch.zeros_like(leaf) if g is None else g for leaf, g in zip(leaves, grads)]
            grads = _mask_grads(_unflatten_like(params, grads), trainable_mask)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = _tree_map(lambda p, u: (p.detach() + u).to(p.dtype), params, updates)
            losses.append(loss.detach())
        return params, opt_state, torch.stack(losses)

    return gang_multi_step


def make_gang_predict(model):
    """``gang_predict(params_G, x [n, D]) -> (mu [G, n, P], var [G, n, 1])``:
    ``predict_f`` of every grid cell on one shared query block, member by
    member.  Variational models only (``predict_f(params, x)``)."""

    def gang_predict(params, xb):
        size = _leaves(params)[0].shape[0]
        outs = [model.predict_f(_tree_map(lambda t: t[g], params), xb) for g in range(size)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    return gang_predict


def gang_eval_rmse_nlpd(model, params_stack, test_data,
                        batch_size: int = 4096) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cell test RMSE and NLPD for a trained gang, accumulated on the
    device (one host read at the end).  Returns ``(rmse [G], nlpd [G])``."""
    x_test, y_test = test_data
    ref = _leaves(params_stack)[0]
    x_test = torch.as_tensor(x_test, dtype=ref.dtype, device=ref.device)
    y_test = torch.as_tensor(y_test, dtype=ref.dtype, device=ref.device)
    n = int(x_test.shape[0])
    predict = make_gang_predict(model)
    size = ref.shape[0]
    sq_total = lpd_total = None
    with torch.no_grad():
        for start in range(0, n, batch_size):
            xb = x_test[start:start + batch_size]
            yb = y_test[start:start + batch_size]
            mu, var = predict(params_stack, xb)  # [G, b, P]
            lpd = torch.stack([
                model.likelihood.predict_log_density(
                    _tree_map(lambda t: t[g], params_stack["likelihood"]), mu[g], var[g], yb)
                for g in range(size)])
            sq = torch.sum(torch.square(yb[None] - mu), dim=(1, 2))
            lpd = torch.sum(lpd.reshape(size, -1), dim=1)
            sq_total = sq if sq_total is None else sq_total + sq
            lpd_total = lpd if lpd_total is None else lpd_total + lpd
    rmse = np.sqrt(sq_total.cpu().numpy() / n)
    nlpd = -lpd_total.cpu().numpy() / n
    return rmse, nlpd


def train_gang_adam(params_list: Sequence[Dict], loss_fn: Callable, data, iterations: int,
                    batch_size: int, learning_rates, key: torch.Generator,
                    trainable_mask: Optional[Dict] = None, steps_per_call: int = 25,
                    mesh=None) -> Tuple[List[Dict], np.ndarray]:
    """Train G same-shape replicas together; returns ``(per-model params list,
    losses [iterations, G])``.

    ``learning_rates`` is a scalar (shared) or a length-G sequence.  Member g
    takes its index stream and its probe generator from the g-th draws of
    ``key`` (a generator on the data's device): the g-th index seed, then
    the g-th probe seed, so the streams do not depend on a mesh.  ``loss_fn``
    follows :func:`make_adam_gang_multi_step` (wrap a one-model loss in
    :func:`per_member`).  With a ``mesh`` each rank trains its G / W block
    (:func:`shard_gang`; G must be a multiple of the mesh size) with no
    collective, and the members and losses are gathered at the end.
    """
    gang = len(params_list)
    if np.ndim(learning_rates) == 0:
        learning_rates = [float(learning_rates)] * gang
    optimizer, opt_state = init_gang_adam(params_list, learning_rates)
    params = stack_pytrees(params_list)
    x, y = data
    n = int(x.shape[0])
    index_seeds = [seed_from(key) for _ in range(gang)]
    probe_seeds = [seed_from(key) for _ in range(gang)]
    members = list(range(gang))
    if mesh is not None:
        if gang % mesh.size != 0:
            raise ValueError(f"train_gang_adam: a gang of {gang} does not divide over the "
                             f"{mesh.size}-rank mesh")
        params = shard_gang(mesh, params)
        opt_state = GangAdamState(opt_state.count, shard_gang(mesh, opt_state.mu),
                                  shard_gang(mesh, opt_state.nu),
                                  shard_gang(mesh, opt_state.learning_rate))
        block = gang // mesh.size
        members = members[mesh.rank * block:(mesh.rank + 1) * block]
    keys = [torch.Generator(device=x.device).manual_seed(probe_seeds[g]) for g in members]
    streams = [minibatch_index_iterator(index_seeds[g], n, batch_size, steps_per_call,
                                        device=x.device) for g in members]
    multi_step = make_adam_gang_multi_step(loss_fn, optimizer, (x, y), trainable_mask)
    loss_rows = []
    done = 0
    while done < iterations:
        k = min(steps_per_call, iterations - done)
        idx = torch.stack([next(s) for s in streams], dim=1)[:k]
        params, opt_state, losses = multi_step(params, opt_state, idx, keys)
        loss_rows.append(losses)
        done += k
    losses = torch.cat(loss_rows, dim=0)
    if mesh is not None:
        from cggp_tpu_torch.parallel.mesh import all_gather_rows

        params = _tree_map(lambda t: all_gather_rows(mesh, t)
                           if t.dim() >= 1 and t.shape[0] == len(members) else t, params)
        losses = all_gather_rows(mesh, losses.mT.contiguous()).mT
    all_losses = losses.cpu().numpy()
    if not np.all(np.isfinite(all_losses[-1])):
        raise FloatingPointError(f"non-finite final gang losses: {all_losses[-1]}")
    return unstack_pytree(params, gang), all_losses
