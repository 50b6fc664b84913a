"""Training steps and batched serving (port of ``cggp_tpu/training/optimize.py``,
one device).

* :func:`make_adam_step` — one optimizer step: the loss and its gradient
  by autograd, non-trainable leaves' gradients multiplied by zero through a
  boolean mask tree, then the update of :func:`adam`, which is
  ``optax.adam``'s (bias-corrected moments, ``eps`` outside the square
  root) with explicit state.  Nothing is read back to the host.
* :func:`predict_in_batches` — the posterior cache is built once; every
  fixed-size batch then runs the model's ``posterior_predict`` and the
  results are concatenated on the device.  The loop itself reads nothing
  back to the host, so batches queue back to back on the card; whether a
  batch's CG reads its stop rule on the host is the solver route's business
  (``"pallas_resident"`` does not).  ``posterior_solver="auto"`` is
  resolved through the model's ``resolve_serving_solver``; an auto-picked
  Cholesky factor that is not finite falls back to ``"cg"`` with a warning,
  an explicit ``"chol"`` request raises.

Not ported yet, each raising ``NotImplementedError`` where it is a switch
of a ported function: ``batch_size="auto"``, the one-dispatch scan route,
mesh serving, chunked CG serving, serving without the posterior cache and
data-bound models; the K-step trainer, L-BFGS and the monitor (ROADMAP
Queue A items 2 and 9).
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch


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


def _not_in_slice(what: str) -> NotImplementedError:
    return NotImplementedError(f"predict_in_batches: {what} arrives with a later slice of the port")


def predict_in_batches(model, params: Dict, x, batch_size=8192,
                       train_data=None, mean_only: bool = False,
                       use_posterior: bool = True, posterior_solver: str = "auto",
                       mesh=None, scan: object = "auto", posterior=None,
                       chunk_iterations: int = 0):
    """Posterior ``(mean [N, P], var [N, 1])`` over ``x`` in batches of
    ``batch_size`` rows (``(mean, None)`` with ``mean_only``).

    ``x`` (tensor or array) is moved to the parameters' device and dtype;
    the last batch is padded with copies of row 0 and the padding dropped.
    ``posterior`` serves from a prebuilt cache instead of building one.
    A Cholesky cache whose factor is not finite raises
    ``FloatingPointError``, as an explicit ``"chol"`` request does in the
    JAX package."""
    if batch_size == "auto":
        raise _not_in_slice('batch_size="auto"')
    if train_data is not None or not use_posterior or not hasattr(model, "posterior"):
        raise _not_in_slice("serving without a params-only posterior cache")
    if mesh is not None:
        raise _not_in_slice("mesh serving")
    if scan is True:
        raise _not_in_slice("the one-dispatch scan route")
    if chunk_iterations:
        raise _not_in_slice("chunked CG serving")

    z = params["inducing_points"]
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    x = x.to(device=z.device, dtype=z.dtype)
    n = x.shape[0]
    batch_size = min(int(batch_size), n)
    num_batches = -(-n // batch_size)
    pad = num_batches * batch_size - n
    if pad:
        x = torch.cat([x, x[:1].expand(pad, x.shape[-1])], dim=0)

    requested_solver = posterior_solver
    if posterior is None and posterior_solver == "auto":
        # Resolved eagerly through the model's own rule where it has one
        # (the Lanczos conditioning estimate of the dense CGGP; "cg" for the
        # matrix-free row models).
        resolver = getattr(model, "resolve_serving_solver", None)
        if resolver is not None:
            posterior_solver = resolver(params)
    post = model.posterior(params, solver=posterior_solver) if posterior is None else posterior
    if post.chol is not None and not bool(torch.all(torch.isfinite(torch.diagonal(post.chol)))):
        # One host check per cache build, never per batch: an explicit (or
        # prebuilt) chol cache raises, an auto-picked one falls back to CG.
        if requested_solver != "auto" or posterior is not None:
            raise FloatingPointError(
                "posterior(solver='chol'): non-finite Cholesky factor — Kmm+Lambda "
                "is too ill-conditioned for a raw factorization; use "
                "posterior_solver='cg'")
        warnings.warn("posterior(solver='auto'): Cholesky factor is non-finite "
                      "(ill-conditioned Kmm+Lambda); falling back to CG serving",
                      RuntimeWarning)
        post = model.posterior(params, solver="cg")

    batches = [x[i * batch_size:(i + 1) * batch_size] for i in range(num_batches)]
    if mean_only:
        means = [model.posterior_mean(post, xb) for xb in batches]
        return torch.cat(means)[:n], None
    means, variances = [], []
    for xb in batches:
        mu, var = model.posterior_predict(post, xb)
        means.append(mu)
        variances.append(var)
    return torch.cat(means)[:n], torch.cat(variances)[:n]
