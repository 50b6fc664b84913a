"""Port parity for ``models/lpsvgp.py``: ``LpSVGP``'s prior KL against the
dense formula and against ``cggp_tpu``'s, the minibatch-scaled ELBO and
its gradients, the trainable mask, and the Cholesky serving cache with
``posterior_predict`` (``full_cov`` both ways) against JAX's.  Float64 on
the CPU; JAX's parameters carried across by ``params_from_numpy``, with a
non-zero ``nu`` and a spread of ``diag_variance`` so every term counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cggp_tpu.models.lpsvgp import LpSVGP as JaxLpSVGP
from cggp_tpu.ops import kernels as jkernels
from cggp_tpu_torch.models import CholPosterior, LpSVGP
from cggp_tpu_torch.ops import kernels as tkernels
from cggp_tpu_torch.training import predict_in_batches
from cggp_tpu_torch.utils.store import flatten_params, params_from_numpy

torch.set_num_threads(1)

N, M, D, NUM_DATA = 64, 12, 2, 1000


def _setup(name="matern32"):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1.5, 1.5, (N, D))
    y = np.cos(2 * x[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    z = rng.uniform(-1.5, 1.5, (M, D))
    nu = rng.standard_normal((M, 1))
    var = rng.uniform(1e-3, 0.2, (M, 1))
    jk = {"se": jkernels.SquaredExponential, "matern32": jkernels.Matern32}[name]()
    tk = {"se": tkernels.SquaredExponential, "matern32": tkernels.Matern32}[name]()
    jmodel, tmodel = JaxLpSVGP(jk, num_data=NUM_DATA), LpSVGP(tk, num_data=NUM_DATA)
    jparams = jmodel.init_params(jnp.asarray(z), lengthscales=np.array([0.6, 0.9]),
                                 noise_variance=0.07, nu=nu, diag_variance=var,
                                 dtype=jnp.float64)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return x, y, jmodel, jparams, tmodel, tparams


def test_init_params_and_trainable_mask_match_jax():
    _, _, jmodel, jparams, tmodel, tparams = _setup()
    fresh = tmodel.init_params(np.asarray(jparams["inducing_points"]), dtype=torch.float64,
                               device="cpu")
    jfresh = jmodel.init_params(jparams["inducing_points"], dtype=jnp.float64)
    for name, value in flatten_params(jax.tree_util.tree_map(np.asarray, jfresh)).items():
        np.testing.assert_allclose(flatten_params(fresh)[name], value, rtol=1e-15, err_msg=name)
    np.testing.assert_allclose(tmodel.diag_variance(fresh).numpy(), 1e-4, rtol=1e-12)
    for kwargs in ({}, {"trainable_inducing_points": True}, {"trainable_pseudo_u": True}):
        assert tmodel.trainable_mask(tparams, **kwargs) == \
            jax.tree_util.tree_map(bool, jmodel.trainable_mask(jparams, **kwargs))
    mask = tmodel.trainable_mask(tparams)
    assert mask["nu"] is True and mask["raw_diag_variance"] is True
    assert mask["inducing_points"] is False


def test_prior_kl_against_the_dense_formula_and_jax():
    _, _, jmodel, jparams, tmodel, tparams = _setup()
    kl = float(tmodel.prior_kl(tparams))
    kp, z, nu = tparams["kernel"], tparams["inducing_points"], tparams["nu"]
    var = tmodel.diag_variance(tparams)[:, 0]
    kmm = tmodel.kernel.K(kp, z)
    k = kmm + torch.diag(var)
    dense = 0.5 * (float(nu.T @ kmm @ nu) - float(torch.trace(torch.linalg.solve(k, kmm)))
                   + float(torch.logdet(k)) - float(torch.sum(torch.log(var))))
    # Measured: 1.5e-16 relative from the dense formula, equal to JAX's.
    np.testing.assert_allclose(kl, dense, rtol=1e-12)
    np.testing.assert_allclose(kl, float(jmodel.prior_kl(jparams)), rtol=1e-12)


@pytest.mark.parametrize("name", ["se", "matern32"])
def test_minibatch_elbo_and_gradients_match_jax(name):
    x, y, jmodel, jparams, tmodel, tparams = _setup(name)
    want, want_grads = jax.value_and_grad(
        lambda p: jmodel.elbo(p, (jnp.asarray(x), jnp.asarray(y))))(jparams)
    live = {k: ({kk: vv.clone().requires_grad_() for kk, vv in v.items()}
                if isinstance(v, dict) else v.clone().requires_grad_())
            for k, v in tparams.items()}
    got = tmodel.elbo(live, (torch.as_tensor(x), torch.as_tensor(y)), key=None)
    got_value = float(got.detach())
    names = sorted(flatten_params(live))
    leaves = [live[n.split("/")[0]][n.split("/")[1]] if "/" in n else live[n] for n in names]
    grads = dict(zip(names, torch.autograd.grad(got, leaves)))
    # Measured: the ELBO within 2.2e-16 relative of JAX's, every gradient
    # within 2.9e-15 of its largest entry.  Held at 1e-10.
    np.testing.assert_allclose(got_value, float(want), rtol=1e-10)
    for n, g in flatten_params(jax.tree_util.tree_map(np.asarray, want_grads)).items():
        np.testing.assert_allclose(grads[n].numpy(), g, rtol=1e-10, atol=1e-10 * np.abs(g).max(),
                                   err_msg=n)
    # The minibatch scale: the expected log-likelihood counts NUM_DATA / N.
    kl = float(tmodel.prior_kl(tparams))
    f_mean, f_var = tmodel.predict_f(tparams, torch.as_tensor(x))
    var_exp = float(torch.sum(tmodel.likelihood.variational_expectations(
        tparams["likelihood"], f_mean, f_var, torch.as_tensor(y))))
    np.testing.assert_allclose(got_value, var_exp * NUM_DATA / N - kl, rtol=1e-13)
    assert float(tmodel.training_loss(tparams, (torch.as_tensor(x), torch.as_tensor(y)))) == \
        pytest.approx(-got_value, rel=1e-15)


@pytest.mark.parametrize("full_cov", [False, True])
def test_posterior_cache_matches_jax(full_cov):
    x, _, jmodel, jparams, tmodel, tparams = _setup()
    jpost, tpost = jmodel.posterior(jparams), tmodel.posterior(tparams)
    assert isinstance(tpost, CholPosterior) and tpost._fields == jpost._fields
    np.testing.assert_allclose(tpost.chol.numpy(), np.asarray(jpost.chol), rtol=1e-12,
                               atol=1e-14)
    tq, jq = torch.as_tensor(x[:17]), jnp.asarray(x[:17])
    # Measured: within 3.7e-15 of JAX's.
    for got, want in zip(tmodel.posterior_predict(tpost, tq, full_cov=full_cov),
                         jmodel.posterior_predict(jpost, jq, full_cov=full_cov)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-13)
    for got, want in zip(tmodel.predict_f(tparams, tq, full_cov=full_cov),
                         jmodel.predict_f(jparams, jq, full_cov=full_cov)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(tmodel.posterior_mean(tpost, tq).numpy(),
                               np.asarray(jmodel.posterior_mean(jpost, jq)), rtol=1e-12,
                               atol=1e-13)
    mean, var = predict_in_batches(tmodel, tparams, x, batch_size=16)
    want_mean, want_var = tmodel.predict_f(tparams, torch.as_tensor(x))
    np.testing.assert_allclose(mean.numpy(), want_mean.numpy(), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(var.numpy(), want_var.numpy(), rtol=1e-12, atol=1e-13)
