"""Trainers, monitor callbacks and batched serving (port of
``cggp_tpu/training/optimize.py``, one device).

* :func:`make_adam_step` — one optimizer step: the loss and its gradient
  by autograd, non-trainable leaves' gradients multiplied by zero through a
  boolean mask tree, then the update of :func:`adam`, which is
  ``optax.adam``'s (bias-corrected moments, ``eps`` outside the square
  root) with explicit state.  Nothing is read back to the host.
* :func:`make_adam_multi_step` — K such steps in one Python call: batches
  gathered on the device from a ``[K, B]`` index tensor, the probes of
  every step drawn in order from the one generator, the losses returned as
  a ``[K]`` tensor; the host reads nothing of its own (a solver route may
  still read its stop rule, as ``"pallas"`` does).  ``precond_fn`` freezes
  the CG preconditioner for the chunk.
* :func:`train_using_adam_and_update` — the full Adam loop: host
  re-clustering through ``update_fn`` (the optimizer state re-initialised
  when a shape changes), the trainable mask, ``steps_per_call`` chunks,
  monitor steps and scalar records, the preconditioner-mode resolver with
  one step per mode, and ``torch.profiler`` windows.
* Monitor callbacks: :func:`make_metrics_callback` (test RMSE and NLPD,
  train ELBO), :func:`make_cg_stats_callback`, :func:`make_param_callback`
  and :func:`create_monitor`.  Where the JAX package uses a fixed PRNG key
  the port seeds a fresh generator on the parameters' device for every call
  (seed 0 unless the caller gives one; the CG statistics fold the step into
  it), so a repeated call gives the same number.
* :func:`train_full_batch_adam` and :func:`train_chunked_adam` — full-batch
  Adam for the exact GP's marginal likelihood (a fresh generator every
  step), the second over an evaluator that returns the gradients itself
  (``IterGPR.log_marginal_likelihood_chunked``).
* :func:`predict_in_batches` — the posterior cache is built once (from the
  parameters, or from the parameters and ``train_data`` for the
  data-bound ``GPR`` and ``IterGPR``); every fixed-size batch then runs the
  model's ``posterior_predict`` (``posterior_predict_chunked`` with
  ``chunk_iterations > 0``) and the results are concatenated on the device.
  The loop itself reads nothing back to the host, so batches queue back to
  back on the card; whether a batch's CG reads its stop rule on the host is
  the solver route's business (``"pallas_resident"`` does not).
  ``posterior_solver="auto"`` is resolved through the model's
  ``resolve_serving_solver``; an auto-picked Cholesky factor that is not
  finite falls back to ``"cg"`` with a warning, an explicit ``"chol"``
  request raises.  ``scan="auto"`` sends solve-free caches (Cholesky, LOVE,
  or ``mean_only``) through :func:`posterior_predict_scan`, the blocks of
  ``ops.linalg.pad_rows_to_blocks`` with no host read between them (the
  JAX package's one-dispatch ``lax.map`` sweep); ``batch_size="auto"``
  sizes the loop's batch by :func:`auto_serving_batch_size`;
  ``use_posterior=False`` (or a model without a matching cache) runs
  ``predict_f`` on every batch.

* L-BFGS: :func:`train_using_lbfgs_and_update` (scipy's L-BFGS-B over
  the raveled trainable leaves, ``update_fn`` and the monitor in its
  callback), :func:`train_using_device_lbfgs` (``optax.lbfgs``'s two-loop
  recursion and zoom line search, the vectors on the device and the line
  search's decisions on the host) and the two vanilla variants.

Not ported yet, each raising ``NotImplementedError`` where it is a switch
of a ported function: ``mesh`` training and serving (ROADMAP Queue A item
12) and ``recluster_fn`` (device re-clustering inside a chunk, item 10).
"""

from __future__ import annotations

import inspect
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cggp_tpu_torch.ops.linalg import pad_rows_to_blocks
from cggp_tpu_torch.training.batching import (batched_indices, minibatch_index_iterator,
                                              seed_from)
from cggp_tpu_torch.training.monitor import Monitor


def _expand_trainable_mask(mask, params):
    """A full boolean tree matching ``params`` from a possibly-prefix mask: a
    single bool freezes or frees the whole subtree under it."""
    if isinstance(mask, bool):
        if isinstance(params, dict):
            return {k: _expand_trainable_mask(mask, v) for k, v in params.items()}
        return mask
    return {k: _expand_trainable_mask(mask[k], params[k]) for k in params}


def _mask_grads(grads: Dict, mask: Optional[Dict]) -> Dict:
    """Gradients times their leaf's bool (a frozen NaN gradient stays NaN)."""
    if mask is None:
        return grads
    return _tree_map(lambda g, m: g * float(m), grads, _expand_trainable_mask(mask, grads))


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


class AdamState(NamedTuple):
    count: int  # steps taken
    mu: Dict  # first moments, params' tree
    nu: Dict  # second moments


class Adam(NamedTuple):
    """``optax.adam(learning_rate, b1, b2, eps)`` as ``init``/``update``
    over a parameter dict of tensors."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Dict) -> AdamState:
        return AdamState(count=0, mu=_tree_map(torch.zeros_like, params),
                         nu=_tree_map(torch.zeros_like, params))

    def update(self, grads: Dict, state: AdamState, params=None):
        """``(updates, new_state)``; the updates are added to the params."""
        del params
        count = state.count + 1
        mu = _tree_map(lambda g, t: (1 - self.b1) * g + self.b1 * t, grads, state.mu)
        nu = _tree_map(lambda g, t: (1 - self.b2) * g ** 2 + self.b2 * t, grads, state.nu)

        def bias_corrected(t, decay):
            return t / (1.0 - decay ** count)  # a host scalar: no device copy

        updates = _tree_map(
            lambda m, v: -self.learning_rate * (
                bias_corrected(m, self.b1) / (torch.sqrt(bias_corrected(v, self.b2)) + self.eps)),
            mu, nu)
        return updates, AdamState(count=count, mu=mu, nu=nu)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Adam:
    return Adam(float(learning_rate), b1, b2, eps)


def make_adam_step(loss_fn: Callable, optimizer: Adam, trainable_mask: Optional[Dict] = None):
    """``step(params, opt_state, batch, key) -> (params, opt_state, loss)``:
    ``loss_fn(params, batch, key)`` and its gradient with respect to every
    leaf (a leaf the loss does not reach gets zeros), the gradients masked
    by ``trainable_mask``, then ``optimizer``'s update.  ``loss`` is a 0-d
    tensor on the parameters' device."""

    def step(params: Dict, opt_state: AdamState, batch, key):
        leaves = [leaf.detach().requires_grad_() for leaf in _leaves(params)]
        live = _unflatten_like(params, leaves)
        loss = loss_fn(live, batch, key)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(leaf) if g is None else g for leaf, g in zip(leaves, grads)]
        grads = _mask_grads(_unflatten_like(params, grads), trainable_mask)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        new_params = _tree_map(lambda p, u: (p.detach() + u).to(p.dtype), params, updates)
        return new_params, opt_state, loss.detach()

    return step


def make_adam_multi_step(loss_fn: Callable, optimizer: Adam, data, trainable_mask=None,
                         precond_fn=None, recluster_fn=None):
    """``step(params, opt_state, idx_chunk, key) -> (params, opt_state,
    losses)``: one Adam step (:func:`make_adam_step`) per row of the
    ``[K, B]`` index tensor ``idx_chunk``, each on the batch gathered on the
    data's device, with every step's probes drawn in order from the one
    generator ``key``; ``losses`` is a ``[K]`` tensor on the device.

    ``precond_fn(params) -> state`` builds the CG preconditioner once per
    call from the chunk's entry parameters and reuses it for all K steps;
    ``loss_fn`` then takes ``(params, batch, key, precond_state)``
    (``CGGP.precond_state`` and ``training_loss(precond_override=...)``)."""
    if recluster_fn is not None:
        raise NotImplementedError(
            "recluster_fn (device re-clustering inside a K-step chunk) arrives with the "
            "device-selection slice of the port (ROADMAP Queue A item 10); re-cluster between "
            "chunks with train_using_adam_and_update(update_fn=...)")
    x, y = data

    def multi_step(params: Dict, opt_state: AdamState, idx_chunk: torch.Tensor, key):
        if precond_fn is not None:
            precond = precond_fn(params)

            def step_loss(p, batch, k):
                return loss_fn(p, batch, k, precond)
        else:
            step_loss = loss_fn
        step = make_adam_step(step_loss, optimizer, trainable_mask)
        losses = []
        for idx in idx_chunk.to(x.device):  # rows as views: no host read
            batch = (x.index_select(0, idx), y.index_select(0, idx))
            params, opt_state, loss = step(params, opt_state, batch, key)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return multi_step


def _tree_shapes(params: Dict):
    return _tree_map(lambda leaf: tuple(leaf.shape), params)


class _Profiler:
    """A ``torch.profiler`` window written to ``profile_dir`` as a Chrome
    trace when it stops (device activity traced for CUDA data)."""

    def __init__(self, profile_dir, cuda: bool):
        from torch.profiler import ProfilerActivity, profile

        self.profile_dir = Path(profile_dir)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._prof = profile(activities=activities)
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()
        self.profile_dir.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.profile_dir / "trace.json"))


def train_using_adam_and_update(
    params: Dict,
    loss_fn: Callable,
    data,
    iterations: int,
    batch_size: int,
    learning_rate: float,
    key: torch.Generator,
    update_fn: Optional[Callable[[Dict], Dict]] = None,
    update_during_training: bool = True,
    trainable_mask: Optional[Dict] = None,
    monitor: Optional[Monitor] = None,
    profile_dir: Optional[str] = None,
    profile_steps: Tuple[int, int] = (2, 6),
    scalar_record_step: int = 1,
    steps_per_call: int = 1,
    mesh=None,
    precond_fn=None,
    recluster_fn=None,
    precond_resolver=None,
    loss_fn_for_mode=None,
    resolve_every: int = 1,
    initial_mode=None,
    on_mode_change=None,
) -> Dict:
    """Adam training with an optional host inducing-point update; returns the
    trained parameters.

    The batch stream's seed is one draw from ``key`` (a ``torch.Generator``
    on the data's device); every step's probes come from ``key`` after it.

    * Every call runs ``K = steps_per_call`` steps (at least 1) through
      :func:`make_adam_multi_step`: ``update_fn`` and the monitor run once
      per chunk, ``iterations`` rounds up to a multiple of K, and the
      monitor's step label is the chunk's first step (its values describe
      the state after the chunk).  ``precond_fn`` (chunk-frozen
      preconditioning) needs ``steps_per_call > 1``.
    * ``update_fn(params) -> params`` runs on the host before each chunk
      while ``update_during_training``; when it changes any shape (the
      cover tree changed M) the optimizer state is re-initialised.
    * The monitor gets ``train/loss`` and ``train/step_time_ms`` every
      ``scalar_record_step`` steps (the loss is read on the host only then)
      and runs its callbacks on every chunk's label.
    * ``precond_resolver(params) -> mode`` with ``loss_fn_for_mode(mode)``:
      the mode is resolved at the start (or taken from ``initial_mode``) and
      again after every ``resolve_every``-th ``update_fn`` call; each mode's
      step is built once and cached; ``on_mode_change(mode)`` fires on every
      swap.  ``loss_fn`` is ignored when a resolver is given.
    * ``profile_dir``: the chunks that overlap steps ``profile_steps[0]``
      to ``profile_steps[1]`` are traced with ``torch.profiler`` (the JAX
      package's window rule); the window opens once a run.
    """
    data_seed = seed_from(key)
    optimizer = adam(learning_rate)
    opt_state = optimizer.init(params)

    if precond_resolver is not None:
        if loss_fn_for_mode is None:
            raise ValueError(
                "precond_resolver requires loss_fn_for_mode (the factory that builds the "
                "concrete-mode loss the step runs)")
        if mesh is not None or precond_fn is not None:
            raise ValueError(
                "precond_resolver composes with the plain Adam paths only (not mesh "
                "data-parallel steps or chunk-frozen precond_fn)")
        if resolve_every < 1:
            raise ValueError("resolve_every must be >= 1")
        current_mode = initial_mode if initial_mode is not None else precond_resolver(params)
    else:
        current_mode = None

    if precond_fn is not None and steps_per_call <= 1:
        raise ValueError(
            "precond_fn (chunk-frozen preconditioning) requires steps_per_call > 1 — at one "
            "step per call it is identical to the model's own per-step build, just with a "
            "different loss_fn signature")
    if recluster_fn is not None:
        raise NotImplementedError(
            "recluster_fn (device re-clustering inside a K-step chunk) arrives with the "
            "device-selection slice of the port (ROADMAP Queue A item 10); use update_fn")
    if mesh is not None:
        raise NotImplementedError("mesh (data-parallel) training arrives with the parallel "
                                  "slice of the port (ROADMAP Queue A item 12)")

    x = data[0]
    k = max(int(steps_per_call), 1)
    step_cache: Dict = {}

    def step_for(mode):
        """The K-step call of ``mode``'s loss, built once per mode."""
        if mode not in step_cache:
            fn = loss_fn if mode is None else loss_fn_for_mode(mode)
            step_cache[mode] = make_adam_multi_step(fn, optimizer, data, trainable_mask,
                                                    precond_fn=precond_fn)
        return step_cache[mode]

    multi_step = step_for(current_mode)
    idx_chunks = minibatch_index_iterator(data_seed, x.shape[0], batch_size, k, device=x.device)
    num_chunks = -(-int(iterations) // k)
    record_chunks = max(int(scalar_record_step) // k, 1)
    profiler, profiled = None, False
    for chunk_i in range(num_chunks):
        # The monitor's label is the chunk's FIRST step, a multiple of K,
        # so a record_step that is a multiple of K stays reachable.
        iteration = chunk_i * k
        if profile_dir is not None and not profiled and iteration + k > profile_steps[0]:
            profiler, profiled = _Profiler(profile_dir, x.is_cuda), True
        if update_fn is not None and update_during_training:
            shapes_before = _tree_shapes(params)
            params = update_fn(params)
            if _tree_shapes(params) != shapes_before:
                opt_state = optimizer.init(params)
            if precond_resolver is not None and chunk_i % resolve_every == 0:
                new_mode = precond_resolver(params)
                if new_mode != current_mode:
                    current_mode = new_mode
                    multi_step = step_for(new_mode)
                    if on_mode_change is not None:
                        on_mode_change(new_mode)
        idx_chunk = next(idx_chunks)
        t0 = time.perf_counter()
        params, opt_state, losses = multi_step(params, opt_state, idx_chunk, key)
        if monitor is not None:
            # Reading the loss waits for the device: only on record chunks.
            if chunk_i % record_chunks == 0:
                loss_value = float(losses[-1])
                dt_ms = (time.perf_counter() - t0) * 1e3 / k
                monitor.add_scalar("train/step_time_ms", dt_ms, iteration)
                monitor.add_scalar("train/loss", loss_value, iteration)
            monitor(iteration, params)
        if profiler is not None and iteration + k > profile_steps[1]:
            profiler.stop()
            profiler = None
    if profiler is not None:
        profiler.stop()
    if monitor is not None:
        monitor.flush()
    return params


def _step_generator(key: torch.Generator, device: torch.device) -> torch.Generator:
    """A fresh generator on ``device`` seeded by one draw from ``key``: the
    port's counterpart of a ``jax.random.split``."""
    return _fixed_generator(device, seed_from(key))


def train_full_batch_adam(params: Dict, loss_fn: Callable, iterations: int,
                          learning_rate: float = 0.05, key: Optional[torch.Generator] = None,
                          monitor: Optional[Monitor] = None,
                          trainable_mask: Optional[Dict] = None) -> Dict:
    """Full-batch Adam with a fresh generator every step, for objectives that
    are stochastic estimators over the whole training set (``IterGPR``'s
    marginal likelihood, whose log-det probes are drawn per step; it does not
    decompose over rows).  ``loss_fn(params, generator)``; each step's
    generator sits on the parameters' device, seeded by one draw from ``key``
    (a ``torch.Generator``; without one, a generator seeded 0).  Steps
    through :func:`make_adam_step`; the monitor gets ``train/loss`` and runs
    its callbacks every step."""
    optimizer = adam(learning_rate)
    opt_state = optimizer.init(params)
    if key is None:
        key = torch.Generator().manual_seed(0)
    device = _leaves(params)[0].device
    step = make_adam_step(lambda p, _batch, k: loss_fn(p, k), optimizer, trainable_mask)
    for i in range(int(iterations)):
        params, opt_state, loss = step(params, opt_state, None, _step_generator(key, device))
        if monitor is not None:
            monitor.add_scalar("train/loss", float(loss), i)
            monitor(i, params)
    if monitor is not None:
        monitor.flush()
    return params


def train_chunked_adam(params: Dict, value_grad_fn: Callable, iterations: int,
                       learning_rate: float = 0.05, key: Optional[torch.Generator] = None,
                       monitor: Optional[Monitor] = None,
                       trainable_mask: Optional[Dict] = None) -> Dict:
    """Adam over an evaluator that returns the marginal likelihood and its
    gradients itself, ``value_grad_fn(params, generator) -> (mll, grads,
    info)`` (``IterGPR.log_marginal_likelihood_chunked``, host-driven
    chunks): the trainer ascends the MLL.  Generators as in
    :func:`train_full_batch_adam`.  Steps whose ``info["converged"]`` is
    false are counted and reported in one ``RuntimeWarning`` at the end."""
    optimizer = adam(learning_rate)
    opt_state = optimizer.init(params)
    if key is None:
        key = torch.Generator().manual_seed(0)
    device = _leaves(params)[0].device
    unconverged = 0
    for i in range(int(iterations)):
        value, grads, info = value_grad_fn(params, _step_generator(key, device))
        if not info.get("converged", True):
            unconverged += 1
        grads = _mask_grads(_tree_map(lambda g: -g, grads), trainable_mask)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = _tree_map(lambda p, u: (p.detach() + u).to(p.dtype), params, updates)
        if monitor is not None:
            monitor.add_scalar("train/loss", -float(value), i)
            monitor(i, params)
    if monitor is not None:
        monitor.flush()
    if unconverged:
        warnings.warn(f"train_chunked_adam: {unconverged}/{int(iterations)} steps hit the chunk "
                      "budget unconverged — raise max_chunks/chunk_iterations or loosen the CG "
                      "target", RuntimeWarning)
    return params


# ---------------------------------------------------------------------------
# L-BFGS
# ---------------------------------------------------------------------------


def _sorted_items(tree):
    """``(path, leaf)`` pairs in sorted-key order, the order in which
    ``jax.flatten_util.ravel_pytree`` lays a dict of arrays out."""
    if isinstance(tree, dict):
        return [(f"{k}/{path}" if path else str(k), leaf) for k in sorted(tree)
                for path, leaf in _sorted_items(tree[k])]
    return [("", tree)]


def _ravel(tree) -> Tuple[torch.Tensor, Callable]:
    """``(flat, unravel)``: the leaves raveled in ``ravel_pytree``'s order
    into one detached vector, and the map from such a vector back to the
    tree (each leaf a view of it, so gradients flow, in its leaf's dtype)."""
    items = _sorted_items(tree)
    flat = torch.cat([leaf.detach().reshape(-1) for _, leaf in items])
    sizes = [leaf.numel() for _, leaf in items]

    def unravel(vec: torch.Tensor):
        parts = {path: part.reshape(leaf.shape).to(leaf.dtype)
                 for (path, leaf), part in zip(items, torch.split(vec, sizes))}

        def rebuild(node, prefix):
            if isinstance(node, dict):
                return {k: rebuild(v, f"{prefix}{k}/") for k, v in node.items()}
            return parts[prefix[:-1]]

        return rebuild(tree, "")

    return flat, unravel


def _flat_mask(trainable_mask: Optional[Dict], params: Dict, flat: torch.Tensor) -> torch.Tensor:
    """The trainable mask raveled like the parameters, as a bool vector."""
    if trainable_mask is None:
        return torch.ones_like(flat, dtype=torch.bool)
    expanded = _expand_trainable_mask(trainable_mask, params)
    return torch.cat([torch.full((leaf.numel(),), bool(m), dtype=torch.bool, device=flat.device)
                      for (_, leaf), (_, m) in zip(_sorted_items(params),
                                                   _sorted_items(expanded))])


def _flat_value_and_grad(loss_fn: Callable, unravel: Callable, x: torch.Tensor):
    """``loss_fn(unravel(x))`` and its gradient with respect to ``x`` (zeros
    where the loss does not reach), both detached."""
    xv = x.detach().requires_grad_()
    loss = loss_fn(unravel(xv))
    (grad,) = torch.autograd.grad(loss, xv, allow_unused=True)
    return loss.detach(), torch.zeros_like(x) if grad is None else grad


def train_using_lbfgs_and_update(params: Dict, loss_fn: Callable, max_iterations: int,
                                 update_fn: Optional[Callable[[Dict], Dict]] = None,
                                 trainable_mask: Optional[Dict] = None,
                                 monitor: Optional[Monitor] = None) -> Dict:
    """scipy's L-BFGS-B over the raveled trainable leaves, the JAX
    package's trainer: ``loss_fn(params)`` (deterministic) and its gradient
    by autograd on the parameters' device, one host read of both per
    evaluation, in float64 on the host.  Frozen leaves are carried outside
    the vector (their gradients zeroed), so ``update_fn`` may change them
    between iterations; ``update_fn(params) -> params`` and then
    ``monitor(iteration, params)`` run in scipy's callback after every
    iteration, and the monitor is flushed at the end.  ``update_fn`` must
    not change a shape."""
    from scipy.optimize import minimize

    if max_iterations <= 0:
        return params
    flat0, unravel = _ravel(params)
    mask_flat = _flat_mask(trainable_mask, params, flat0)
    state = {"params": params, "iteration": 0}

    def merged(x64) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x64), dtype=flat0.dtype, device=flat0.device)
        return torch.where(mask_flat, x, _ravel(state["params"])[0])

    def objective(x64):
        loss, grad = _flat_value_and_grad(loss_fn, unravel, merged(x64))
        grad = torch.where(mask_flat, grad, torch.zeros_like(grad))
        host = torch.cat([loss.reshape(1).to(grad.dtype), grad]).cpu().double().numpy()
        return float(host[0]), host[1:]

    def callback(x64):
        state["params"] = unravel(merged(x64))
        if update_fn is not None:
            state["params"] = update_fn(state["params"])
        if monitor is not None:
            monitor(state["iteration"], state["params"])
        state["iteration"] += 1

    result = minimize(objective, flat0.cpu().double().numpy(), jac=True, method="L-BFGS-B",
                      options={"maxiter": int(max_iterations)}, callback=callback)
    final = unravel(merged(result.x))
    if monitor is not None:
        monitor.flush()
    return final


# optax.scale_by_zoom_linesearch's constants at optax.lbfgs's defaults
# (optax 0.2.6): max_linesearch_steps, slope_rtol, curv_rtol,
# approx_dec_rtol, stepsize_precision and increase_factor.
_LS_MAX_STEPS = 20
_LS_SLOPE_RTOL = 1e-4
_LS_CURV_RTOL = 0.9
_LS_APPROX_DEC_RTOL = 1e-6
_LS_STEPSIZE_PRECISION = 1e-5
_LS_INCREASE_FACTOR = 2.0


def _nan_max(a, b):
    return np.float64(np.nan) if np.isnan(a) or np.isnan(b) else np.float64(max(a, b))


def _nan_min(a, b):
    return np.float64(np.nan) if np.isnan(a) or np.isnan(b) else np.float64(min(a, b))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through ``(a, fa)`` with slope
    ``fpa`` at ``a``, ``(b, fb)`` and ``(c, fc)``; NaN when there is none."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0, v1 = fb - fa - fpa * db, fc - fa - fpa * dc
    big_a = (dc ** 2 * v0 - db ** 2 * v1) / denom
    big_b = (-(dc ** 3) * v0 + db ** 3 * v1) / denom
    radical = big_b * big_b - 3.0 * big_a * fpa
    return a + (-big_b + np.sqrt(radical)) / (3.0 * big_a)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through ``(a, fa)`` with slope
    ``fpa`` and ``(b, fb)``."""
    db = b - a
    return a - fpa / (2.0 * ((fb - fa - fpa * db) / db ** 2))


def _zoom_linesearch(evaluate: Callable, value_init, slope_init):
    """``optax.zoom_linesearch``'s interval search and zoom (Nocedal and
    Wright, Algorithms 3.5 and 3.6, with Hager and Zhang's approximate
    decrease), on host float64 scalars.  ``evaluate(stepsize) -> (value,
    slope)`` evaluates the objective along the direction.  Returns the
    stepsize."""
    f64 = np.float64
    inf = f64(np.inf)

    def decrease_error(stepsize, value, slope):
        err = value - value_init - _LS_SLOPE_RTOL * stepsize * slope_init
        approx = slope - (2 * _LS_SLOPE_RTOL - 1.0) * slope_init
        approx = _nan_max(approx, value - value_init - _LS_APPROX_DEC_RTOL * abs(value_init))
        err = _nan_max(_nan_min(approx, err), 0.0)
        return inf if np.isnan(err) else err

    def curvature_error(slope):
        err = _nan_max(abs(slope) - _LS_CURV_RTOL * abs(slope_init), 0.0)
        return inf if np.isnan(err) else err

    st = {"count": 0, "stepsize": f64(0.0), "value": value_init, "slope": slope_init,
          "decrease_error": inf, "interval_found": False, "done": False, "failed": False,
          "low": f64(0.0), "value_low": value_init, "slope_low": slope_init,
          "high": f64(0.0), "value_high": value_init, "slope_high": slope_init,
          "cubic_ref": f64(0.0), "value_cubic_ref": value_init,
          "safe_stepsize": f64(0.0), "safe_value": value_init}

    def search_interval():
        prev = (st["stepsize"], st["value"], st["slope"])
        new = f64(1.0) if st["count"] == 0 else _LS_INCREASE_FACTOR * prev[0]
        value, slope = evaluate(new)
        dec, curv = decrease_error(new, value, slope), curvature_error(slope)
        error = _nan_max(dec, curv)
        if dec <= 0.0:
            st.update(safe_stepsize=new, safe_value=value)
        set_high_to_new = dec > 0.0 or (value >= prev[1] and st["count"] > 0)
        set_low_to_new = slope >= 0.0 and not set_high_to_new
        low, high = ((new, value, slope), prev) if set_low_to_new else (prev, (new, value, slope))
        done = error <= 0.0
        st.update(count=st["count"] + 1, stepsize=new, value=value, slope=slope,
                  decrease_error=dec,
                  interval_found=set_high_to_new or set_low_to_new or done, done=done,
                  failed=st["count"] + 1 >= _LS_MAX_STEPS and not done,
                  low=low[0], value_low=low[1], slope_low=low[2],
                  high=high[0], value_high=high[1], slope_high=high[2],
                  cubic_ref=low[0], value_cubic_ref=low[1])

    def zoom():
        low, value_low, slope_low = st["low"], st["value_low"], st["slope_low"]
        high, value_high, slope_high = st["high"], st["value_high"], st["slope_high"]
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
        too_small = delta <= _LS_STEPSIZE_PRECISION
        cubic = _cubicmin(low, value_low, slope_low, high, value_high, st["cubic_ref"],
                          st["value_cubic_ref"])
        quad = _quadmin(low, value_low, slope_low, high, value_high)
        if left + cubic_chk < cubic < right - cubic_chk:
            middle = cubic
        elif left + quad_chk < quad < right - quad_chk:
            middle = quad
        else:
            middle = (low + high) / 2.0
        value, slope = evaluate(middle)
        dec, curv = decrease_error(middle, value, slope), curvature_error(slope)
        if dec <= 0.0 and value < st["safe_value"]:
            st.update(safe_stepsize=middle, safe_value=value)
        done = _nan_max(dec, curv) <= 0.0
        set_high_to_middle = dec > 0.0 or value >= value_low
        set_high_to_low = slope * (high - low) >= 0.0 and not set_high_to_middle
        if set_high_to_middle:
            st.update(high=middle, value_high=value, slope_high=slope)
        elif set_high_to_low:
            st.update(high=low, value_high=value_low, slope_high=slope_low)
        if not set_high_to_middle:
            st.update(low=middle, value_low=value, slope_low=slope)
        if set_high_to_middle or set_high_to_low:
            st.update(cubic_ref=high, value_cubic_ref=value_high)
        else:
            st.update(cubic_ref=low, value_cubic_ref=value_low)
        failed = (st["count"] + 1 >= _LS_MAX_STEPS
                  or (too_small and st["safe_stepsize"] > 0.0)) and not done
        st.update(count=st["count"] + 1, stepsize=middle, value=value, slope=slope,
                  decrease_error=dec, done=done, failed=failed)

    with np.errstate(all="ignore"):
        while not (st["done"] or st["failed"]):
            zoom() if st["interval_found"] else search_interval()
            if st["failed"] and (st["safe_stepsize"] > 0.0 or np.isinf(st["decrease_error"])):
                st.update(stepsize=st["safe_stepsize"], value=st["safe_value"])
    return st["stepsize"]


def _lbfgs_direction(grad: torch.Tensor, mem: Dict, memory_size: int,
                     x: torch.Tensor) -> torch.Tensor:
    """``optax.scale_by_lbfgs(memory_size, scale_init_precond=True)``: the
    memory updated with this iterate's ``(x, grad)`` differences, then the
    two-loop recursion ``P_k grad`` on the device (``mem`` is updated in
    place)."""
    count = mem["count"]
    memory_idx, prev_idx = count % memory_size, (count - 1) % memory_size
    if count > 0:
        dp, du = x - mem["x"], grad - mem["g"]
        vdot = torch.dot(du, dp)
        weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
        den = torch.dot(du, du)
        scale = torch.where(den > 0.0, vdot / den, torch.ones_like(den))
    else:
        dp = du = torch.zeros_like(x)
        weight = torch.zeros((), dtype=x.dtype, device=x.device)
        scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
    mem["dp"][prev_idx] = dp
    mem["du"][prev_idx] = du
    mem["rho"][prev_idx] = weight
    indices = [(memory_idx + i) % memory_size for i in range(memory_size)]
    vec, alphas = grad, {}
    for idx in reversed(indices):
        alphas[idx] = mem["rho"][idx] * torch.dot(mem["dp"][idx], vec)
        vec = vec + (-alphas[idx]) * mem["du"][idx]
    vec = scale * vec
    for idx in indices:
        beta = mem["rho"][idx] * torch.dot(mem["du"][idx], vec)
        vec = vec + (alphas[idx] - beta) * mem["dp"][idx]
    mem.update(count=count + 1, x=x, g=grad)
    return vec


def train_using_device_lbfgs(params: Dict, loss_fn: Callable, max_iterations: int,
                             trainable_mask: Optional[Dict] = None,
                             monitor: Optional[Monitor] = None, record_step: int = 50,
                             memory_size: int = 10) -> Dict:
    """L-BFGS on the parameters' device: ``optax.lbfgs(memory_size)`` as
    optax 0.2.6 defines it, the JAX package's device trainer.  Each
    iteration takes the loss and its gradient (frozen leaves' gradients
    multiplied by zero), the two-loop direction with the scaled-identity
    start (``min(1, 1 / |g|)`` at the first iteration), then
    ``scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy="one")`` along it, whose evaluations take the
    unmasked gradient as optax's ``value_fn`` does.  The vectors stay on
    the device; the line search decides on the host in float64, from one
    host read of ``(value, slope)`` at the start and one per line-search
    evaluation (JAX decides inside its ``lax.scan``).  The monitor fires
    after every ``record_step`` iterations and at the end, labelled by the
    iterations done, then is flushed.  So each evaluation costs one host
    read, and with ``record_step=1`` the evaluations between two monitor
    calls are one plus that iteration's line-search steps."""
    if max_iterations <= 0:
        return params
    x, unravel = _ravel(params)
    mask_flat = None if trainable_mask is None else \
        _flat_mask(trainable_mask, params, x).to(x.dtype)
    mem = {"count": 0, "x": torch.zeros_like(x), "g": torch.zeros_like(x),
           "dp": torch.zeros((memory_size,) + tuple(x.shape), dtype=x.dtype, device=x.device),
           "du": torch.zeros((memory_size,) + tuple(x.shape), dtype=x.dtype, device=x.device),
           "rho": torch.zeros(memory_size, dtype=x.dtype, device=x.device)}
    chunk = max(1, min(int(record_step), int(max_iterations)))

    def evaluate(point):
        return _flat_value_and_grad(loss_fn, unravel, point)

    def read_value_and_slope(value, grad, direction):
        """One host read: the loss and its slope along ``direction``."""
        pair = torch.stack([value.to(grad.dtype), torch.dot(grad, direction)]).cpu().double()
        return np.float64(pair[0]), np.float64(pair[1])

    for done in range(1, int(max_iterations) + 1):
        value, grad = evaluate(x)
        if mask_flat is not None:
            grad = grad * mask_flat
        updates = -1.0 * _lbfgs_direction(grad, mem, memory_size, x)
        stepsize = _zoom_linesearch(
            lambda s: read_value_and_slope(*evaluate(x + float(s) * updates), updates),
            *read_value_and_slope(value, grad, updates))
        x = x + float(stepsize) * updates
        if monitor is not None and (done % chunk == 0 or done == max_iterations):
            monitor(done, unravel(x))
    if monitor is not None:
        monitor.flush()
    return unravel(x)


def train_vanilla_using_lbfgs(params: Dict, loss_fn: Callable, max_iterations: int,
                              trainable_mask: Optional[Dict] = None) -> Dict:
    """Plain L-BFGS: :func:`train_using_lbfgs_and_update` with no update
    and no monitor."""
    return train_using_lbfgs_and_update(params, loss_fn, max_iterations,
                                        trainable_mask=trainable_mask)


def train_vanilla_using_lbfgs_and_standard_ip_update(params: Dict, loss_fn: Callable,
                                                     clustering_fn: Callable,
                                                     max_iterations: int,
                                                     trainable_mask: Optional[Dict] = None
                                                     ) -> Dict:
    """L-BFGS that assigns the inducing inputs Z from ``clustering_fn()``
    (an array or tensor of Z's shape) after every iteration.  Z is excluded
    from the L-BFGS vector: it is assigned, not optimised.  Re-clustering
    every step can converge to poor local minima, as the reference warns."""

    def update_fn(p: Dict) -> Dict:
        z = p["inducing_points"]
        return {**p, "inducing_points": _like(clustering_fn(), z)}

    mask = _expand_trainable_mask(True, params) if trainable_mask is None \
        else dict(trainable_mask)
    mask["inducing_points"] = False
    return train_using_lbfgs_and_update(params, loss_fn, max_iterations, update_fn=update_fn,
                                        trainable_mask=mask)


# ---------------------------------------------------------------------------
# Monitor callbacks
# ---------------------------------------------------------------------------


def _seed_of(key) -> int:
    """A callback's base seed: 0 for None, a generator's initial seed, or
    the int given."""
    if key is None:
        return 0
    if isinstance(key, torch.Generator):
        return int(key.initial_seed())
    return int(key)


def _fixed_generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _fold_in(seed: int, step: int) -> int:
    """A seed of ``(seed, step)``, the counterpart of ``jax.random.fold_in``."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0])


def _like(t, ref: torch.Tensor) -> torch.Tensor:
    """``t`` (tensor or array) on ``ref``'s device in its dtype."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    return t.to(device=ref.device, dtype=ref.dtype)


def _takes_key(model) -> bool:
    try:
        return "key" in inspect.signature(model.elbo).parameters
    except (TypeError, ValueError):
        return False


def bind_predict_fn(model, train_data):
    """Uniform ``predict(params, x) -> (mean, var)`` over models whose
    ``predict_f`` takes the parameters only and those that also need the
    training set (``predict_f(params, data, x_new)``)."""
    if "data" in inspect.signature(model.predict_f).parameters:
        return lambda params, x: model.predict_f(params, train_data, x, full_cov=False)
    return lambda params, x: model.predict_f(params, x, full_cov=False)


def make_metrics_callback(model, train_data, test_data, batch_size: int = 4096, key=None,
                          check_numerics: bool = True) -> Callable:
    """``metrics_fn(step, params) -> {"test/rmse", "test/nlpd", "train/elbo"}``:
    test RMSE and NLPD over ``test_data`` in batches of ``batch_size``
    (summed on the device, read once), and the ELBO of the first
    ``batch_size`` training points with probes from a generator seeded
    ``key`` (default 0) on the parameters' device, fresh for every call.
    A non-finite ELBO raises ``FloatingPointError`` when ``check_numerics``."""
    x_test, y_test = test_data
    n_test = x_test.shape[0]
    predict_f = bind_predict_fn(model, train_data)
    seed = _seed_of(key)

    def metrics_fn(step: int, params: Dict) -> Dict:
        z = params["inducing_points"]
        xt, yt = _like(x_test, z), _like(y_test, z)
        sq_err_total = lpd_total = 0.0
        with torch.no_grad():
            for idx in batched_indices(n_test, batch_size):
                xb, yb = xt[idx[0]:idx[-1] + 1], yt[idx[0]:idx[-1] + 1]
                f_mean, f_var = predict_f(params, xb)
                lpd = model.likelihood.predict_log_density(params["likelihood"], f_mean,
                                                           f_var, yb)
                sq_err_total = sq_err_total + torch.sum((yb - f_mean) ** 2)
                lpd_total = lpd_total + torch.sum(lpd)
            rmse = float(torch.sqrt(sq_err_total / n_test))
            nlpd = float(-lpd_total / n_test)
            x_train, y_train = train_data
            n_eval = min(x_train.shape[0], batch_size)
            batch = (_like(x_train[:n_eval], z), _like(y_train[:n_eval], z))
            if _takes_key(model):
                elbo = float(model.elbo(params, batch, _fixed_generator(z.device, seed)))
            else:
                elbo = float(model.elbo(params, batch))
        if check_numerics and not np.isfinite(elbo):
            raise FloatingPointError(f"non-finite ELBO at step {step}: {elbo}")
        return {"test/rmse": rmse, "test/nlpd": nlpd, "train/elbo": elbo}

    return metrics_fn


def make_cg_stats_callback(model, data, batch_size: int = 2048, key=None) -> Callable:
    """Monitor callback logging the CG steps and residual of the model's
    training solve on the first ``batch_size`` points (probes from a seed of
    ``(key, step)``, ``key`` default 0), and flagging unconverged solves:
    ``cg/unconverged`` is the solver's own ``converged`` flag negated where
    the stats carry it (exact, no false positive on a solve that converges
    on its last permitted step), else ``steps >= cap``.  A warning is
    emitted on every converged-to-unconverged transition."""
    x, y = data
    n_eval = min(x.shape[0], batch_size)
    x_eval, y_eval = x[:n_eval], y[:n_eval]
    base_seed = _seed_of(key)
    if hasattr(model, "conjugate_gradient"):
        cap = model.conjugate_gradient.max_iterations  # may be None (=> M)
    else:
        cap = getattr(model, "max_cg_iterations", None)
    was_unconverged = [False]

    def cg_stats_fn(step: int, params: Dict) -> Dict:
        z = params["inducing_points"]
        batch = (_like(x_eval, z), _like(y_eval, z))
        stats = model.cg_stats(params, batch,
                               _fixed_generator(z.device, _fold_in(base_seed, step)))
        steps = int(stats.steps)
        max_error = float(torch.max(stats.error))
        limit = cap if cap is not None else z.shape[0]
        if getattr(stats, "converged", None) is not None:
            unconverged = not bool(stats.converged)
        else:
            unconverged = steps >= int(limit)
        newly = unconverged and not was_unconverged[0]
        was_unconverged[0] = unconverged
        if newly:
            how = (f"hit max_iterations={limit}" if steps >= int(limit)
                   else f"stopped after {steps} iterations (cap {limit})")
            warnings.warn(
                f"CG solve {how} without converging at step {step} (residual "
                f"0.5*rz={max_error:.3e}). Results may be silently inaccurate — raise "
                "max_iterations, enable relative_threshold, or add a preconditioner.",
                RuntimeWarning, stacklevel=2)
        return {"cg/steps": steps, "cg/max_error": max_error,
                "cg/unconverged": int(unconverged)}

    return cg_stats_fn


def make_param_callback(model) -> Callable:
    """Constrained kernel and likelihood parameters, as numpy values."""

    def param_fn(step: int, params: Dict) -> Dict:
        del step
        out = {}
        for name, value in model.kernel.constrained(params["kernel"]).items():
            value = value.detach().cpu().numpy()
            if value.ndim == 0:
                out[f"kernel/{name}"] = value
            else:
                for i, v in enumerate(value.reshape(-1)):
                    out[f"kernel/{name}[{i}]"] = np.asarray(v)
        out["likelihood/variance"] = (
            model.likelihood.variance(params["likelihood"]).detach().cpu().numpy())
        return out

    return param_fn


def create_monitor(logdir: Optional[str], metrics_fn: Optional[Callable] = None,
                   param_fn: Optional[Callable] = None, record_step: int = 100,
                   use_tensorboard: bool = True) -> Monitor:
    """The standard monitor: ``metrics`` and ``params`` callbacks every
    ``record_step`` steps."""
    monitor = Monitor(logdir, use_tensorboard=use_tensorboard)
    if metrics_fn is not None:
        monitor.add_callback("metrics", metrics_fn, record_step=record_step)
    if param_fn is not None:
        monitor.add_callback("params", param_fn, record_step=record_step)
    return monitor


def _posterior_takes_data(model) -> bool:
    """Data-bound models (``GPR``, ``IterGPR``) bind the training set into
    the cache, ``posterior(params, data)``; the variational ones are
    params-only."""
    return "data" in inspect.signature(model.posterior).parameters


def _posterior_serves_via_cg(post) -> bool:
    """True when a cache's mean-and-variance batch runs a CG solve: its
    solver fields exist and are all unset (the CGGP / RowCGGP ``"cg"``
    caches, an ``IterGPR`` cache without a LOVE cache).  Caches without
    those fields (``GPR``) or with a factor are solve-free."""
    has_solver_fields = hasattr(post, "chol") or hasattr(post, "lanczos_r")
    return (has_solver_fields and getattr(post, "chol", None) is None
            and getattr(post, "lanczos_r", None) is None)


def auto_serving_batch_size(m: int, n: int, floor: int = 8192, cap: int = 65536,
                            block_budget: int = 2 ** 27) -> int:
    """The serving loop's batch for ``batch_size="auto"``, the JAX package's
    rule: the largest power-of-two ``T`` with ``m * T <= block_budget`` (the
    [M, T] kernel block), clamped to ``[floor, cap]`` and to the dataset
    size ``n``, so a small dataset serves as one exact-size block."""
    t = block_budget // max(int(m), 1)
    t = 1 << max(t.bit_length() - 1, 0)  # power-of-two floor
    t = max(floor, min(t, cap))
    return min(t, max(int(n), 1))


def _serving_system_rows(model, params: Dict, train_data) -> Optional[int]:
    """Rows M of the per-batch serving system: the inducing count of the
    sparse families, the training size of the data-bound exact models;
    ``None`` where neither is known."""
    z = params.get("inducing_points") if hasattr(params, "get") else None
    if z is not None:
        return int(z.shape[0])
    if train_data is not None:
        return int(train_data[0].shape[0])
    return None


def posterior_predict_scan(model, post, x, batch_size: int = 8192, mean_only: bool = False,
                           mesh=None):
    """Whole-dataset serving from a built posterior cache as one sweep: the
    fixed-size row blocks of :func:`~cggp_tpu_torch.ops.linalg.pad_rows_to_blocks`
    (the tail padded with copies of row 0), each through the model's
    ``posterior_predict`` (``posterior_mean`` with ``mean_only``), stacked
    on the device with no host read between blocks; the JAX package's
    ``lax.map`` program.  A CG cache (no Cholesky factor and no LOVE rows)
    warns: its solves read their stop rule on the host every step, so the
    sweep is no freer of host reads than :func:`predict_in_batches`' loop.
    Returns ``(mean [N, P], var [N, 1])``, or ``(mean, None)``."""
    if mesh is not None:
        raise NotImplementedError("posterior_predict_scan: mesh serving arrives with the "
                                  "parallel slice of the port (ROADMAP Queue A item 12)")
    if not mean_only and _posterior_serves_via_cg(post):
        warnings.warn("posterior_predict_scan: this posterior serves through CG (no chol/LOVE "
                      "cache): each block's solve reads its stop rule on the host, so the "
                      "sweep saves nothing over predict_in_batches' loop", RuntimeWarning)
    n = x.shape[0]
    blocks = pad_rows_to_blocks(x, min(int(batch_size), n))
    if mean_only:
        mu = torch.stack([model.posterior_mean(post, xb) for xb in blocks])
        return mu.reshape(-1, mu.shape[-1])[:n], None
    outs = [model.posterior_predict(post, xb, full_cov=False) for xb in blocks]
    mu = torch.stack([m for m, _ in outs])
    var = torch.stack([v for _, v in outs])
    return mu.reshape(-1, mu.shape[-1])[:n], var.reshape(-1, var.shape[-1])[:n]


def predict_in_batches(model, params: Dict, x, batch_size=8192,
                       train_data=None, mean_only: bool = False,
                       use_posterior: bool = True, posterior_solver: str = "auto",
                       mesh=None, scan: object = "auto", posterior=None,
                       chunk_iterations: int = 0):
    """Posterior ``(mean [N, P], var [N, 1])`` over ``x`` in batches of
    ``batch_size`` rows (``(mean, None)`` with ``mean_only``).

    The posterior cache applies when ``use_posterior`` is on and the
    model's ``posterior`` matches what the caller gives: params-only models
    without ``train_data``, the data-bound ones (``GPR``, ``IterGPR``) with
    it, as the JAX package decides by the signature of ``posterior``.  It
    is built once, or ``posterior`` serves from a prebuilt cache.  Without
    a cache every batch runs ``predict_f`` (with ``train_data`` where the
    model's ``predict_f`` takes it); ``mean_only``, ``scan=True`` and
    ``posterior`` then raise ``ValueError``, as in the JAX package.

    ``x`` (tensor or array) is moved to the parameters' device and dtype;
    the last batch is padded with copies of row 0 and the padding dropped.
    ``batch_size="auto"`` takes :func:`auto_serving_batch_size` of the
    serving system's rows for the loop and keeps 8192 for the scan.  A
    Cholesky cache of a model with a solver choice whose factor is not
    finite raises ``FloatingPointError`` on an explicit ``"chol"`` (or a
    prebuilt cache) and falls back to ``"cg"`` with a warning on an
    auto-picked one.  With ``chunk_iterations > 0`` a CG cache of a model
    with ``posterior_predict_chunked`` serves its mean and variance batches
    through it.  ``scan``: ``"auto"`` sends solve-free caches (Cholesky,
    LOVE, or ``mean_only``) through :func:`posterior_predict_scan`,
    ``True`` every cache, ``False`` none."""
    if mesh is not None:
        raise NotImplementedError("predict_in_batches: mesh serving arrives with the parallel "
                                  "slice of the port (ROADMAP Queue A item 12)")
    takes_data = hasattr(model, "posterior") and _posterior_takes_data(model)
    posterior_capable = (use_posterior and hasattr(model, "posterior")
                         and (train_data is not None) == takes_data)
    if mean_only and not posterior_capable:
        raise ValueError("mean_only serving needs a posterior()-capable model")
    if scan is True and not posterior_capable:
        raise ValueError("scan=True needs the posterior-cache path (use_posterior=True, a "
                         "posterior()-capable model, matching train_data)")
    if posterior is not None and not posterior_capable:
        raise ValueError("posterior= injection needs the posterior-cache path "
                         "(use_posterior=True, a posterior()-capable model, matching "
                         "train_data)")

    if posterior_capable:
        ref = params["likelihood"]["variance"] if takes_data else params["inducing_points"]
    else:
        ref = next(iter(params["kernel"].values()))
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    x = x.to(device=ref.device, dtype=ref.dtype)
    n = x.shape[0]
    scan_batch = batch_size
    if batch_size == "auto":
        m_rows = _serving_system_rows(model, params, train_data)
        batch_size = 8192 if m_rows is None else auto_serving_batch_size(m_rows, n)
        scan_batch = 8192
    batch_size = min(int(batch_size), n)
    scan_batch = min(int(scan_batch), n)
    num_batches = -(-n // batch_size)
    pad = num_batches * batch_size - n
    if pad:
        x_pad = torch.cat([x, x[:1].expand(pad, x.shape[-1])], dim=0)
    else:
        x_pad = x
    batches = [x_pad[i * batch_size:(i + 1) * batch_size] for i in range(num_batches)]

    if not posterior_capable:
        if train_data is None:
            def predict_f(p, xb):
                return model.predict_f(p, xb, full_cov=False)
        else:
            predict_f = bind_predict_fn(model, train_data)
        outs = [predict_f(params, xb) for xb in batches]
        return (torch.cat([m for m, _ in outs])[:n], torch.cat([v for _, v in outs])[:n])

    takes_solver = "solver" in inspect.signature(model.posterior).parameters
    requested_solver = posterior_solver
    if posterior is not None:
        # A prebuilt cache: its own solver fields decide the routing.
        requested_solver = ("chol" if getattr(posterior, "chol", None) is not None
                            else "lanczos" if getattr(posterior, "lanczos_r", None) is not None
                            else "cg")
    elif posterior_solver == "auto" and takes_solver:
        # Resolved eagerly through the model's own rule where it has one
        # (the Lanczos conditioning estimate of the dense CGGP; "cg" for the
        # matrix-free row models).
        resolver = getattr(model, "resolve_serving_solver", None)
        if resolver is not None:
            posterior_solver = resolver(params)

    def build(solver):
        kw = {"solver": solver} if takes_solver else {}
        return model.posterior(params, train_data, **kw) if takes_data \
            else model.posterior(params, **kw)

    post = build(posterior_solver) if posterior is None else posterior
    chol = getattr(post, "chol", None)
    if takes_solver and chol is not None and \
            not bool(torch.all(torch.isfinite(torch.diagonal(chol)))):
        # One host check per cache build, never per batch: an explicit (or
        # prebuilt) chol cache raises, an auto-picked one falls back to CG.
        if requested_solver != "auto":
            raise FloatingPointError(
                "posterior(solver='chol'): non-finite Cholesky factor — Kmm+Lambda "
                "is too ill-conditioned for a raw factorization; use "
                "posterior_solver='cg'")
        warnings.warn("posterior(solver='auto'): Cholesky factor is non-finite "
                      "(ill-conditioned Kmm+Lambda); falling back to CG serving",
                      RuntimeWarning)
        post = build("cg")

    if chunk_iterations > 0 and not mean_only and hasattr(model, "posterior_predict_chunked") \
            and _posterior_serves_via_cg(post):
        outs = [model.posterior_predict_chunked(post, xb, chunk_iterations=chunk_iterations)
                for xb in batches]
        return torch.cat([m for m, _ in outs])[:n], torch.cat([v for _, v in outs])[:n]
    solve_free = mean_only or not _posterior_serves_via_cg(post)
    if scan is True or (scan == "auto" and solve_free):
        return posterior_predict_scan(model, post, x, batch_size=scan_batch,
                                      mean_only=mean_only)
    if mean_only:
        means = [model.posterior_mean(post, xb) for xb in batches]
        return torch.cat(means)[:n], None
    outs = [model.posterior_predict(post, xb) for xb in batches]
    return torch.cat([m for m, _ in outs])[:n], torch.cat([v for _, v in outs])[:n]
