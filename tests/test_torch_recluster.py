"""Port parity for fused in-training re-clustering: ``make_adam_multi_step``
and ``train_using_adam_and_update`` with ``recluster_fn`` (the device
delta-net's fixed-capacity update, ``make_device_recluster_fn``) of
``cggp_tpu_torch`` against ``cggp_tpu`` on the CPU, in float64.

Both packages train capacity-padded ``ImplicitCGGP`` (the blocked route,
``use_pallas=False`` on both sides) and dense ``CGGP`` from the same
parameters on the same batches, with the same probes: the port's
``rademacher`` returns JAX's draws from the keys JAX's K-step call splits.
The re-selection runs at the top of every K = 2 chunk, under the euclidean
and the covariance metric (which reads the live kernel parameters): the
losses and the trained parameters agree at 1e-8, and the host variant (the
same update between chunks) gives bitwise the fused chunk's parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cggp_tpu_torch.models.cggp as tcggp_module
import cggp_tpu_torch.models.rowcg as trowcg_module
import cggp_tpu_torch.training.optimize as toptimize
from cggp_tpu.models.cggp import CGGP as JaxCGGP
from cggp_tpu.models.implicit import ImplicitCGGP as JaxImplicitCGGP
from cggp_tpu.ops import kernels as jkernels
from cggp_tpu.ops.cg import ConjugateGradient as JaxConjugateGradient
from cggp_tpu.selection.covernet import (covernet_update_inducing_parameters as jax_covernet,
                                         make_device_recluster_fn as jax_recluster_fn)
from cggp_tpu.training import optimize as joptimize
from cggp_tpu_torch.models.cggp import CGGP
from cggp_tpu_torch.models.implicit import ImplicitCGGP
from cggp_tpu_torch.ops import kernels as tkernels
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.selection.covernet import make_device_recluster_fn
from cggp_tpu_torch.training import adam, make_adam_multi_step, train_using_adam_and_update
from cggp_tpu_torch.utils.store import params_from_numpy

torch.set_num_threads(1)

N, P, K, B, CAPACITY = 160, 3, 2, 24, 48
RTOL = 1e-8  # float64 CG at 1e-14 on both sides, the same batches and probes


def _data():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (N, 2))
    y = np.sin(2 * x[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    return x, y


X, Y = _data()


class JaxDraws:
    """The port's ``rademacher``: JAX's draw from ``split(key)[index]``."""

    def __init__(self, splits):
        self.queue, self.splits = [], splits

    def elbo(self, key):
        self.queue += [(key, 0), (key, 1)]

    def __call__(self, gen, shape, dtype):
        key, index = self.queue.pop(0)
        draw = jax.random.rademacher(jax.random.split(key, self.splits)[index], tuple(shape),
                                     dtype=jnp.float64)
        return torch.as_tensor(np.array(draw)).to(dtype)


def _pair(model_name):
    if model_name == "implicit":
        common = dict(num_data=N, num_probes=P, error_threshold=1e-14, max_cg_iterations=96,
                      block=16)
        return (JaxImplicitCGGP(kernel=jkernels.Matern32(), **common),
                ImplicitCGGP(kernel=tkernels.Matern32(), **common), trowcg_module, 2)
    common = dict(num_data=N, num_probes=P)
    return (JaxCGGP(kernel=jkernels.Matern32(), conjugate_gradient=JaxConjugateGradient(1e-16),
                    **common),
            CGGP(kernel=tkernels.Matern32(), conjugate_gradient=ConjugateGradient(1e-16),
                 **common), tcggp_module, 3)


def _params(jmodel):
    z, u, c = jax_covernet((jnp.asarray(X), jnp.asarray(Y)), 0.5, lloyds=0)
    jparams = jmodel.init_params(z, pseudo_u=u, cluster_counts=c, capacity=CAPACITY,
                                 lengthscales=np.array([0.6, 0.8]), noise_variance=0.3,
                                 dtype=jnp.float64)
    return jparams, params_from_numpy(jparams, device="cpu")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


CASES = [("implicit", "euclidean", 0.4), ("implicit", "covariance", 0.5),
         ("dense", "euclidean", 0.4)]


@pytest.mark.parametrize("model_name,distance,res", CASES,
                         ids=["implicit_euclid", "implicit_covariance", "dense_euclid"])
def test_fused_recluster_chunks_match_jax(model_name, distance, res, monkeypatch):
    jmodel, tmodel, module, splits = _pair(model_name)
    draws = JaxDraws(splits)
    monkeypatch.setattr(module, "rademacher", draws)
    jparams, tparams = _params(jmodel)
    jre = jax_recluster_fn(jmodel, (jnp.asarray(X), jnp.asarray(Y)), res, CAPACITY,
                           distance_type=distance)
    tre = make_device_recluster_fn(tmodel, (torch.as_tensor(X), torch.as_tensor(Y)), res,
                                   CAPACITY, distance_type=distance)
    jstep = jax.jit(joptimize.make_adam_multi_step(
        jmodel.training_loss, optax.adam(0.01), (jnp.asarray(X), jnp.asarray(Y)),
        jmodel.trainable_mask(jparams), recluster_fn=jre))
    tstep = make_adam_multi_step(tmodel.training_loss, adam(0.01),
                                 (torch.as_tensor(X), torch.as_tensor(Y)),
                                 tmodel.trainable_mask(tparams), recluster_fn=tre)
    plain = make_adam_multi_step(tmodel.training_loss, adam(0.01),
                                 (torch.as_tensor(X), torch.as_tensor(Y)),
                                 tmodel.trainable_mask(tparams))
    jp, jopt = jparams, optax.adam(0.01).init(jparams)
    tp, topt = tparams, adam(0.01).init(tparams)
    key = jax.random.PRNGKey(11)
    idx = np.random.default_rng(1).integers(0, N, (2, K, B))
    m_real = []
    for chunk in idx:
        for _ in range(2):  # the fused call, then the host variant's
            sub = key
            for _ in range(K):
                sub, step_key = jax.random.split(sub)
                draws.elbo(step_key)
        # The host variant: the same update between calls, then a plain call.
        hp, hopt, hlosses = plain(tre(tp), topt, torch.as_tensor(chunk), torch.Generator())
        jp, jopt, jlosses = jstep(jp, jopt, jnp.asarray(chunk), key)
        tp, topt, tlosses = tstep(tp, topt, torch.as_tensor(chunk), torch.Generator())
        key = jax.random.split(key)[0]
        np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=RTOL)
        assert torch.equal(hlosses, tlosses)
        for name, got in _flat(hp).items():
            np.testing.assert_array_equal(got, _flat(tp)[name], err_msg=name)
        m_real.append(int(tp["inducing_mask"].sum()))
    assert not draws.queue
    for name, want in _flat(jp).items():
        np.testing.assert_allclose(_flat(tp)[name], want, rtol=RTOL, atol=1e-12, err_msg=name)
    assert all(8 < m < CAPACITY for m in m_real)
    assert tp["inducing_points"].shape == (CAPACITY, 2)


def test_trainer_with_recluster_fn_matches_jax(monkeypatch):
    jmodel, tmodel, module, splits = _pair("implicit")
    draws = JaxDraws(splits)
    monkeypatch.setattr(module, "rademacher", draws)
    jparams, tparams = _params(jmodel)
    iterations = 4
    key = jax.random.PRNGKey(5)
    # JAX's trainer: one split for the batch seed, one per chunk, K per chunk.
    k_trainer, data_key = jax.random.split(key)
    seed = int(jax.random.randint(data_key, (), 0, np.iinfo(np.int32).max))
    for _ in range(iterations // K):
        k_trainer, sub = jax.random.split(k_trainer)
        for _ in range(K):
            sub, step_key = jax.random.split(sub)
            draws.elbo(step_key)
    monkeypatch.setattr(toptimize, "seed_from", lambda gen: seed)
    jout = joptimize.train_using_adam_and_update(
        jparams, jmodel.training_loss, (jnp.asarray(X), jnp.asarray(Y)), iterations, B, 0.01,
        key, trainable_mask=jmodel.trainable_mask(jparams), steps_per_call=K,
        recluster_fn=jax_recluster_fn(jmodel, (jnp.asarray(X), jnp.asarray(Y)), 0.5, CAPACITY,
                                      distance_type="covariance"))
    tout = train_using_adam_and_update(
        tparams, tmodel.training_loss, (torch.as_tensor(X), torch.as_tensor(Y)), iterations,
        B, 0.01, torch.Generator(), trainable_mask=tmodel.trainable_mask(tparams),
        steps_per_call=K,
        recluster_fn=make_device_recluster_fn(tmodel, (torch.as_tensor(X), torch.as_tensor(Y)),
                                              0.5, CAPACITY, distance_type="covariance"))
    assert not draws.queue
    for name, want in _flat(jout).items():
        np.testing.assert_allclose(_flat(tout)[name], want, rtol=RTOL, atol=1e-12, err_msg=name)
