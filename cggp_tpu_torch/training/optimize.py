"""Batched serving (port of ``predict_in_batches`` from
``cggp_tpu/training/optimize.py``, one device).

The posterior cache is built once; every fixed-size batch then runs the
model's ``posterior_predict`` and the results are concatenated on the
device.  The loop itself reads nothing back to the host, so batches queue
back to back on the card; whether a batch's CG reads its stop rule on the
host is the solver route's business (``"pallas_resident"`` does not).

Not in this slice, each raising ``NotImplementedError``: ``batch_size=
"auto"``, the one-dispatch scan route, mesh serving, chunked CG serving,
serving without the posterior cache and data-bound models.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


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

    post = model.posterior(params, solver=posterior_solver) if posterior is None else posterior
    if post.chol is not None and not bool(torch.all(torch.isfinite(torch.diagonal(post.chol)))):
        # One host check per cache build, never per batch.  Every chol cache
        # of this slice is an explicit request ("auto" is not ported).
        raise FloatingPointError(
            "posterior(solver='chol'): non-finite Cholesky factor — Kmm+Lambda "
            "is too ill-conditioned for a raw factorization; use "
            "posterior_solver='cg'")

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
