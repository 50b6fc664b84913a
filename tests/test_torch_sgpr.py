"""Port parity for ``models/sgpr.py``: the collapsed Titsias bound of
``cggp_tpu_torch``'s ``SGPR`` and its gradients against ``cggp_tpu``'s for
every kernel, the bound and the predictions at full inducing against the
exact ``GPR`` (as ``tests/test_models.py`` checks the JAX package), the
data-bound serving cache against JAX's, and ``predict_in_batches`` on it.
Float64 on the CPU; both packages get the same numpy inputs and JAX's
parameters carried across by ``params_from_numpy``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cggp_tpu.models.gpr import GPR as JaxGPR
from cggp_tpu.models.sgpr import SGPR as JaxSGPR
from cggp_tpu.ops import kernels as jkernels
from cggp_tpu_torch.models import GPR, SGPR, SGPRPosterior
from cggp_tpu_torch.ops import kernels as tkernels
from cggp_tpu_torch.training import predict_in_batches
from cggp_tpu_torch.utils.store import flatten_params, params_from_numpy

torch.set_num_threads(1)

N, M, D = 200, 20, 2
KERNELS = ["se", "matern12", "matern32", "matern52"]
JAX_KERNELS = {"se": jkernels.SquaredExponential, "matern12": jkernels.Matern12,
               "matern32": jkernels.Matern32, "matern52": jkernels.Matern52}
TORCH_KERNELS = {"se": tkernels.SquaredExponential, "matern12": tkernels.Matern12,
                 "matern32": tkernels.Matern32, "matern52": tkernels.Matern52}


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, D))
    y = np.sin(2 * x[:, :1]) * np.cos(x[:, 1:]) + 0.1 * rng.standard_normal((n, 1))
    return x, y, rng.uniform(-2.2, 2.2, (15, D))


def _pair(name, z, jitter=1e-6):
    jmodel = JaxSGPR(kernel=JAX_KERNELS[name](), jitter=jitter)
    tmodel = SGPR(kernel=TORCH_KERNELS[name](), jitter=jitter)
    jparams = jmodel.init_params(jnp.asarray(z), lengthscales=np.array([0.7, 1.3]),
                                 variance=1.2, noise_variance=0.05, dtype=jnp.float64)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, tmodel, tparams


def _port_value_and_grads(fn, params):
    """``fn(params)`` and its gradient with respect to every leaf, by the
    leaves' slash-joined names."""
    live = {k: ({kk: vv.detach().clone().requires_grad_() for kk, vv in v.items()}
                if isinstance(v, dict) else v.detach().clone().requires_grad_())
            for k, v in params.items()}
    named = [(f"{k}/{kk}", vv) for k, v in live.items() if isinstance(v, dict)
             for kk, vv in v.items()] + [(k, v) for k, v in live.items()
                                         if not isinstance(v, dict)]
    value = fn(live)
    grads = torch.autograd.grad(value, [t for _, t in named])
    return float(value.detach()), {name: g.numpy() for (name, _), g in zip(named, grads)}


# Measured with inducing points drawn apart from the data: the bound within
# 2.1e-15 relative of JAX's, each gradient within 2.1e-13 of its largest
# entry (se's inducing-point gradient).  Held at 1e-10.  With inducing
# points 0.01 from training inputs ("near"), matern12's gradients through
# r = sqrt(|x|^2 + |z|^2 - 2 x.z) at r ~ 0.01 are 1.5e-8 (Z) and 5.7e-9
# (lengthscales) apart: each package rounds the cancelling distance in its
# own order, and 1/r magnifies it.  Held at 1e-7 there; the other kernels
# stay within 4.0e-13 and are held at 1e-10.
RTOL = 1e-10
RTOL_NEAR_MATERN12 = 1e-7


def _inducing(x, layout):
    if layout == "apart":
        return np.random.default_rng(1).uniform(-2, 2, (M, D))
    return x[::N // M][:M] + 0.01


@pytest.mark.parametrize("layout", ["apart", "near"])
@pytest.mark.parametrize("name", KERNELS)
def test_elbo_and_gradients_match_jax(name, layout):
    x, y, _ = _data()
    jmodel, jparams, tmodel, tparams = _pair(name, _inducing(x, layout))
    want, want_grads = jax.value_and_grad(
        lambda p: jmodel.elbo(p, (jnp.asarray(x), jnp.asarray(y))))(jparams)
    got, got_grads = _port_value_and_grads(
        lambda p: tmodel.elbo(p, (torch.as_tensor(x), torch.as_tensor(y))), tparams)
    np.testing.assert_allclose(got, float(want), rtol=RTOL)
    want_flat = flatten_params(jax.tree_util.tree_map(np.asarray, want_grads))
    assert set(got_grads) == set(want_flat)
    rtol = RTOL_NEAR_MATERN12 if (name, layout) == ("matern12", "near") else RTOL
    for k, g in got_grads.items():
        np.testing.assert_allclose(g, want_flat[k], rtol=rtol,
                                   atol=rtol * np.abs(want_flat[k]).max(), err_msg=k)
    # training_loss is the negated bound; numpy data is moved to the params.
    assert float(tmodel.training_loss(tparams, (x, y))) == pytest.approx(-got, rel=1e-15)


def test_bound_tight_and_predictions_exact_at_full_inducing():
    """With Z = X (and jitter 1e-10) the bound equals the exact GPR marginal
    likelihood and the predictions equal GPR's (``tests/test_models.py``)."""
    x, y, xq = _data(n=50)
    kernel = tkernels.SquaredExponential()
    gpr, sgpr = GPR(kernel), SGPR(kernel, jitter=1e-10)
    p_gpr = gpr.init_params(D, lengthscales=[1.0, 1.0], noise_variance=0.1, dtype=torch.float64,
                            device="cpu")
    p_sgpr = sgpr.init_params(x, lengthscales=[1.0, 1.0], noise_variance=0.1,
                              dtype=torch.float64, device="cpu")
    data = (torch.as_tensor(x), torch.as_tensor(y))
    lml = float(gpr.log_marginal_likelihood(p_gpr, data))
    bound = float(sgpr.elbo(p_sgpr, data))
    assert bound <= lml + 1e-6
    np.testing.assert_allclose(bound, lml, rtol=1e-5)
    mu_g, var_g = gpr.predict_f(p_gpr, data, torch.as_tensor(xq))
    mu_s, var_s = sgpr.predict_f(p_sgpr, data, torch.as_tensor(xq))
    np.testing.assert_allclose(mu_s.numpy(), mu_g.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(var_s.numpy(), var_g.numpy(), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("name", ["se", "matern32"])
@pytest.mark.parametrize("full_cov", [False, True])
def test_posterior_cache_and_predictions_match_jax(name, full_cov):
    x, y, xq = _data()
    z = x[:M]
    jmodel, jparams, tmodel, tparams = _pair(name, z)
    jdata = (jnp.asarray(x), jnp.asarray(y))
    jpost = jmodel.posterior(jparams, jdata)
    tpost = tmodel.posterior(tparams, (x, y))
    assert isinstance(tpost, SGPRPosterior) and tpost._fields == jpost._fields
    # Measured: the cache within 7.2e-11 of JAX's (se's nu: Kuu + 1e-6 I at
    # Z = X[:20] is ill-conditioned; matern32's within 2.5e-14), the
    # predictions within 4.8e-14.
    for field in ("chol_uu", "chol_b", "nu"):
        np.testing.assert_allclose(getattr(tpost, field).numpy(), np.asarray(getattr(jpost, field)),
                                   rtol=1e-10, atol=1e-12, err_msg=field)
    tq, jq = torch.as_tensor(xq), jnp.asarray(xq)
    for got, want in zip(tmodel.posterior_predict(tpost, tq, full_cov=full_cov),
                         jmodel.posterior_predict(jpost, jq, full_cov=full_cov)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
    for got, want in zip(tmodel.predict_f(tparams, (x, y), tq, full_cov=full_cov),
                         jmodel.predict_f(jparams, jdata, jq, full_cov=full_cov)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tmodel.posterior_mean(tpost, tq).numpy(),
                               np.asarray(jmodel.posterior_mean(jpost, jq)), rtol=1e-10,
                               atol=1e-12)


def test_predict_in_batches_serves_the_data_bound_cache():
    x, y, _ = _data()
    xq = np.random.default_rng(3).uniform(-2, 2, (37, D))
    _, _, tmodel, tparams = _pair("matern32", x[:M])
    mean, var = predict_in_batches(tmodel, tparams, xq, batch_size=8, train_data=(x, y))
    want_mean, want_var = tmodel.predict_f(tparams, (x, y), torch.as_tensor(xq))
    np.testing.assert_allclose(mean.numpy(), want_mean.numpy(), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(var.numpy(), want_var.numpy(), rtol=1e-12, atol=1e-13)
    mean_only, none = predict_in_batches(tmodel, tparams, xq, batch_size=8, train_data=(x, y),
                                         mean_only=True)
    assert none is None
    np.testing.assert_allclose(mean_only.numpy(), want_mean.numpy(), rtol=1e-12, atol=1e-13)
    # Without a cache every batch runs predict_f with the training data.
    uncached = predict_in_batches(tmodel, tparams, xq, batch_size=8, train_data=(x, y),
                                  use_posterior=False)
    np.testing.assert_allclose(uncached[0].numpy(), want_mean.numpy(), rtol=1e-12, atol=1e-13)
