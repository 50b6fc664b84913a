"""Port parity for ``ops/rff.py::rff_sample`` and ``models/pathwise.py``:
prior samples, ``PathwiseClusterGP.pathwise_samples`` and its ELBO (with
gradients), and the pathwise serving cache (``build_pathwise_posterior``
with ``"chol"`` and ``"cg"``, ``pathwise_samples_at``,
``pathwise_samples_scan``) against ``cggp_tpu``'s, float64 on the CPU.

The two packages draw from different generators, so the JAX tests' random
draws are patched into the port: ``ops.rff.basis_theta_parameter`` returns
JAX's frequencies and ``ops.rff.standard_normal`` JAX's basis weights w
[S, 2L] and noise eps [S, M, 1], each drawn from the keys JAX's functions
split.  Without the patch the port's own properties are checked, mirroring
``tests/test_pathwise_posterior.py``: the cache and the per-call path
agree for one generator seed, the scan equals the direct evaluation, a
capacity-padded cache serves like the dense one, the refusals, and the
sample moments match ``ClusterGP``'s closed form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cggp_tpu_torch.ops.rff as trff
from cggp_tpu.models import PathwiseClusterGP as JaxPathwiseClusterGP
from cggp_tpu.models import build_pathwise_posterior as jax_build_pathwise_posterior
from cggp_tpu.models import pathwise_samples_at as jax_pathwise_samples_at
from cggp_tpu.ops import kernels as jkernels
from cggp_tpu.ops import rff as jrff
from cggp_tpu_torch.models import (CGGP, ClusterGP, PathwiseClusterGP, PathwisePosterior,
                                   build_pathwise_posterior, pathwise_samples_at,
                                   pathwise_samples_scan)
from cggp_tpu_torch.ops import kernels as tkernels
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.utils.store import flatten_params, params_from_numpy

torch.set_num_threads(1)

N, M, D = 40, 12, 2
KERNELS = {"se": (jkernels.SquaredExponential, tkernels.SquaredExponential),
           "matern32": (jkernels.Matern32, tkernels.Matern32)}


def _setup(n=N, m=M, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, D))
    y = np.sin(2 * x[:, :1]) + 0.1 * rng.standard_normal((n, 1))
    z = x[:m]
    u = rng.standard_normal((m, 1))
    counts = rng.integers(1, 9, (m, 1)).astype(np.float64)
    return x, y, z, u, counts


def _pathwise_pair(name="matern32", num_bases=32, num_samples=5, n=N):
    x, y, z, u, counts = _setup(n=n)
    jk, tk = KERNELS[name]
    common = dict(num_data=4 * n, num_bases=num_bases, num_samples=num_samples)
    jmodel, tmodel = JaxPathwiseClusterGP(jk(), **common), PathwiseClusterGP(tk(), **common)
    jparams = jmodel.init_params(jnp.asarray(z), noise_variance=0.05, pseudo_u=u,
                                 cluster_counts=counts, lengthscales=np.array([0.5, 0.8]),
                                 dtype=jnp.float64)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return x, y, jmodel, jparams, tmodel, tparams


def _jax_draws(jmodel, jparams, key, num_bases, num_samples):
    """JAX's theta, w and eps normals, from the keys its pathwise functions
    split: (prior, eps), then (theta, w) from prior."""
    key_prior, key_eps = jax.random.split(key)
    key_theta, key_w = jax.random.split(key_prior)
    z = jparams["inducing_points"]
    theta = jrff.basis_theta_parameter(jmodel.kernel, jparams["kernel"], num_bases, key_theta,
                                       ndim=z.shape[-1])
    w = jax.random.normal(key_w, (num_samples, 2 * num_bases), dtype=z.dtype)
    eps = jax.random.normal(key_eps, (num_samples, z.shape[0], 1), dtype=z.dtype)
    ell = jmodel.kernel.lengthscales(jparams["kernel"])
    return np.asarray(theta), np.asarray(ell), np.asarray(w), np.asarray(eps)


def _patch_draws(monkeypatch, theta, lengthscales, *normals):
    """The port's draws replaced by the given arrays: the frequencies
    ``theta`` (drawn at ``lengthscales``) rescaled to the lengthscales of
    the call, so they stay a differentiable function of them as the draws
    are; the normals picked by shape."""
    unit = torch.as_tensor(theta * np.asarray(lengthscales))
    by_shape = {tuple(a.shape): a for a in normals}
    monkeypatch.setattr(trff, "basis_theta_parameter",
                        lambda kernel, params, num_bases, generator, ndim=None:
                        unit / kernel.lengthscales(params))
    monkeypatch.setattr(trff, "standard_normal",
                        lambda generator, shape, dtype, device:
                        torch.as_tensor(by_shape[tuple(shape)], dtype=dtype, device=device))


@pytest.mark.parametrize("name", ["se", "matern32"])
def test_rff_sample_matches_jax(monkeypatch, name):
    x, _, jmodel, jparams, _, tparams = _pathwise_pair(name)
    key = jax.random.PRNGKey(4)
    want = jrff.rff_sample(jnp.asarray(x), jmodel.kernel, jparams["kernel"], 64, key,
                           num_samples=3)
    key_theta, key_w = jax.random.split(key)
    theta = jrff.basis_theta_parameter(jmodel.kernel, jparams["kernel"], 64, key_theta, ndim=D)
    w = jax.random.normal(key_w, (3, 128), dtype=jnp.float64)
    _patch_draws(monkeypatch, np.asarray(theta),
                 np.asarray(jmodel.kernel.lengthscales(jparams["kernel"])), np.asarray(w))
    got = trff.rff_sample(torch.as_tensor(x), KERNELS[name][1](), tparams["kernel"], 64,
                          torch.Generator(), num_samples=3)
    assert got.shape == (3, N)
    # Measured: 1.3e-15 apart.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-13)


def test_rff_sample_draws_theta_then_weights_from_one_generator():
    """Unpatched: the same seed gives the same samples; theta comes first,
    so drawing theta alone from the seed reproduces rff_sample's features."""
    _, _, _, _, tmodel, tparams = _pathwise_pair()
    xs = torch.linspace(-1, 1, 9, dtype=torch.float64)[:, None].repeat(1, D)
    a = trff.rff_sample(xs, tmodel.kernel, tparams["kernel"], 16, torch.Generator().manual_seed(3),
                        num_samples=4)
    b = trff.rff_sample(xs, tmodel.kernel, tparams["kernel"], 16, torch.Generator().manual_seed(3),
                        num_samples=4)
    assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(3)
    bases = trff.rff_basis(xs, tmodel.kernel, tparams["kernel"], 16, gen)
    w = torch.randn((4, 32), generator=gen, dtype=torch.float64)
    torch.testing.assert_close(a, w @ bases.T, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["se", "matern32"])
def test_pathwise_samples_elbo_and_gradients_match_jax(monkeypatch, name):
    x, y, jmodel, jparams, tmodel, tparams = _pathwise_pair(name)
    key = jax.random.PRNGKey(11)
    _patch_draws(monkeypatch, *_jax_draws(jmodel, jparams, key, 32, 5))
    want_samples = jmodel.pathwise_samples(jparams, jnp.asarray(x), key)
    got_samples = tmodel.pathwise_samples(tparams, torch.as_tensor(x), torch.Generator())
    assert got_samples.shape == (5, N, 1)
    # Measured: the samples within 4.0e-14, the ELBO within 5.5e-15
    # relative, each gradient within 4.4e-14 of its largest entry.
    np.testing.assert_allclose(got_samples.numpy(), np.asarray(want_samples), rtol=1e-10,
                               atol=1e-12)
    jdata = (jnp.asarray(x), jnp.asarray(y))
    want, want_grads = jax.value_and_grad(lambda p: jmodel.elbo(p, jdata, key))(jparams)
    live = {k: ({kk: vv.clone().requires_grad_() for kk, vv in v.items()}
                if isinstance(v, dict) else v.clone().requires_grad_())
            for k, v in tparams.items()}
    got = tmodel.elbo(live, (torch.as_tensor(x), torch.as_tensor(y)), torch.Generator())
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-10)
    names = sorted(flatten_params(live))
    leaves = [live[n.split("/")[0]][n.split("/")[1]] if "/" in n else live[n] for n in names]
    grads = dict(zip(names, torch.autograd.grad(got, leaves)))
    for n, g in flatten_params(jax.tree_util.tree_map(np.asarray, want_grads)).items():
        np.testing.assert_allclose(grads[n].numpy(), g, rtol=1e-10,
                                   atol=1e-10 * max(np.abs(g).max(), 1e-300), err_msg=n)
    loss = tmodel.training_loss(tparams, (torch.as_tensor(x), torch.as_tensor(y)),
                                torch.Generator())
    np.testing.assert_allclose(float(loss), -float(want), rtol=1e-10)


def test_pathwise_cache_matches_jax(monkeypatch):
    x, _, jmodel, jparams, tmodel, tparams = _pathwise_pair("se", num_bases=24, num_samples=6)
    key = jax.random.PRNGKey(5)
    _patch_draws(monkeypatch, *_jax_draws(jmodel, jparams, key, 24, 6))
    jpost = jax_build_pathwise_posterior(jmodel, jparams, key, num_bases=24, num_samples=6)
    tpost = build_pathwise_posterior(tmodel, tparams, torch.Generator(), num_bases=24,
                                     num_samples=6)
    assert isinstance(tpost, PathwisePosterior) and tpost._fields == jpost._fields
    for field in ("theta", "w", "basis_scale", "weights"):
        np.testing.assert_allclose(getattr(tpost, field).numpy(), np.asarray(getattr(jpost, field)),
                                   rtol=1e-10, atol=1e-12, err_msg=field)
    assert tpost.inducing_mask is None and jpost.inducing_mask is None
    np.testing.assert_allclose(pathwise_samples_at(tmodel, tpost, torch.as_tensor(x)).numpy(),
                               np.asarray(jax_pathwise_samples_at(jmodel, jpost, jnp.asarray(x))),
                               rtol=1e-10, atol=1e-12)


def test_cached_samples_equal_the_per_call_path():
    """One generator seed: the cache holds the functions pathwise_samples
    draws (theta, w, eps in the same order), so the cache at the per-call
    points reproduces the per-call draws."""
    x, _, _, _, tmodel, tparams = _pathwise_pair("se", num_bases=64, num_samples=6)
    direct = tmodel.pathwise_samples(tparams, torch.as_tensor(x), torch.Generator().manual_seed(11))
    post = tmodel.pathwise_posterior(tparams, torch.Generator().manual_seed(11))
    cached = pathwise_samples_at(tmodel, post, torch.as_tensor(x))
    # Measured: 2.9e-14 apart.
    np.testing.assert_allclose(cached.numpy(), direct.numpy(), rtol=1e-9, atol=1e-10)
    other = tmodel.pathwise_posterior(tparams, torch.Generator().manual_seed(12))
    assert not torch.allclose(other.w, post.w)


def _cggp(threshold=1e-16):
    return CGGP(kernel=tkernels.Matern32(),
                conjugate_gradient=ConjugateGradient(threshold, max_iterations=200),
                num_data=N, num_probes=2)


def test_cg_weights_match_chol_weights_on_the_xla_route():
    x, _, z, u, counts = _setup()
    model = _cggp()
    params = model.init_params(z, noise_variance=0.05, pseudo_u=u, cluster_counts=counts,
                               dtype=torch.float64, device="cpu")
    post_chol = build_pathwise_posterior(model, params, torch.Generator().manual_seed(3),
                                         num_bases=64, num_samples=5, solver="chol")
    post_cg = build_pathwise_posterior(model, params, torch.Generator().manual_seed(3),
                                       num_bases=64, num_samples=5, solver="cg")
    assert torch.equal(post_cg.w, post_chol.w) and torch.equal(post_cg.theta, post_chol.theta)
    # The JAX package's test and tolerance at absolute threshold 1e-16.
    # Measured: weights 1.2e-9 apart, samples 2.6e-9 (JAX's own, on its
    # draws: 1.4e-9 and 2.9e-9).  At JAX's 1e-14 these draws stop 2.2e-8
    # from the factor, JAX's 9.0e-9: each within its stop rule.
    np.testing.assert_allclose(post_cg.weights.numpy(), post_chol.weights.numpy(), rtol=1e-7,
                               atol=1e-9)
    xq = torch.as_tensor(x)
    np.testing.assert_allclose(pathwise_samples_at(model, post_cg, xq).numpy(),
                               pathwise_samples_at(model, post_chol, xq).numpy(),
                               rtol=1e-7, atol=1e-8)


def test_scan_matches_the_direct_evaluation():
    x, _, _, _, tmodel, tparams = _pathwise_pair("matern32", num_bases=32, num_samples=4, n=50)
    post = tmodel.pathwise_posterior(tparams, torch.Generator().manual_seed(5))
    xq = torch.as_tensor(x)
    direct = pathwise_samples_at(tmodel, post, xq)
    for batch_size in (16, 50, 64):  # a ragged tail, one block, one padded block
        swept = pathwise_samples_scan(tmodel, post, xq, batch_size=batch_size)
        assert swept.shape == direct.shape == (4, 50, 1)
        np.testing.assert_allclose(swept.numpy(), direct.numpy(), rtol=1e-12, atol=1e-13)
    # Blocks of the same shape as a per-batch loop: bitwise equal.
    per_batch = torch.cat([pathwise_samples_at(tmodel, post, xq[i:i + 16])
                           for i in range(0, 48, 16)], dim=1)
    assert torch.equal(pathwise_samples_scan(tmodel, post, xq[:48], batch_size=16), per_batch)


def test_capacity_padded_cache_serves_like_the_dense_one(monkeypatch):
    """Capacity padding (M = 12 padded to 20): pad rows carry exactly zero
    weight.  With the padded cache's noise draw equal to the dense cache's
    on the real rows (the draws are patched, the pad rows' noise zero), the
    two caches serve the same samples."""
    x, _, z, u, counts = _setup()
    model = _cggp()
    dense = model.init_params(z, noise_variance=0.05, pseudo_u=u, cluster_counts=counts,
                              dtype=torch.float64, device="cpu")
    padded = model.init_params(z, noise_variance=0.05, pseudo_u=u, cluster_counts=counts,
                               capacity=20, dtype=torch.float64, device="cpu")
    assert padded["inducing_points"].shape[0] == 20
    gen = torch.Generator().manual_seed(8)
    theta = trff.basis_theta_parameter(model.kernel, dense["kernel"], 64, gen, ndim=D).numpy()
    ell = model.kernel.lengthscales(dense["kernel"]).numpy()
    w = torch.randn((4, 128), generator=gen, dtype=torch.float64).numpy()
    eps = torch.randn((4, M, 1), generator=gen, dtype=torch.float64).numpy()
    eps_padded = np.concatenate([eps, np.zeros((4, 8, 1))], axis=1)
    xq = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (20, D)))
    outs = []
    for params, noise in ((dense, eps), (padded, eps_padded)):
        _patch_draws(monkeypatch, theta, ell, w, noise)
        for solver in ("chol", "cg"):
            post = build_pathwise_posterior(model, params, torch.Generator(), num_bases=64,
                                            num_samples=4, solver=solver)
            outs.append((post, pathwise_samples_at(model, post, xq)))
    (_, d_chol), (_, d_cg), (p_chol, s_chol), (p_cg, s_cg) = outs
    for post in (p_chol, p_cg):
        assert post.inducing_mask is not None
        assert torch.equal(post.weights[:, M:], torch.zeros_like(post.weights[:, M:]))
    # Measured: the padded "chol" cache 1.5e-14 from the dense one, the
    # padded "cg" cache bitwise the dense one (the same CG steps); the "cg"
    # caches 5.9e-9 from the "chol" ones (the stop rule at 1e-16).
    for got, want in ((s_chol, d_chol), (s_cg, d_cg)):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(s_cg.numpy(), s_chol.numpy(), rtol=1e-7, atol=1e-8)


def test_refusals():
    _, _, z, u, counts = _setup()
    model = PathwiseClusterGP(tkernels.SquaredExponential(), num_data=N)
    multi = model.init_params(z, noise_variance=0.05, pseudo_u=np.concatenate([u, 2 * u], 1),
                              cluster_counts=counts, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="single-output"):
        build_pathwise_posterior(model, multi, torch.Generator())
    # The per-call path takes multi-output pseudo_u.
    assert model.pathwise_samples(multi, torch.as_tensor(z), torch.Generator(),
                                  num_samples=3).shape == (3, M, 2)
    params = model.init_params(z, noise_variance=0.05, pseudo_u=u, cluster_counts=counts,
                               dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="conjugate_gradient"):
        build_pathwise_posterior(model, params, torch.Generator(), solver="cg")
    with pytest.raises(ValueError, match="solver"):
        build_pathwise_posterior(model, params, torch.Generator(), solver="lanczos")
    with pytest.raises(ValueError, match="generator"):
        model.elbo(params, (torch.as_tensor(z), torch.as_tensor(u)))


def test_cached_sample_moments_match_clustergp():
    """Many cached draws at held-out points reproduce ClusterGP's
    closed-form posterior moments (the JAX package's test, its sizes and
    tolerance: 4000 samples of 6000 bases, 0.08)."""
    _, _, z, u, counts = _setup()
    kernel = tkernels.SquaredExponential()
    model = PathwiseClusterGP(kernel, num_data=N, num_bases=6000, num_samples=4000)
    params = model.init_params(z, noise_variance=0.05, pseudo_u=u, cluster_counts=counts,
                               dtype=torch.float64, device="cpu")
    x_new = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (25, D)))
    post = model.pathwise_posterior(params, torch.Generator().manual_seed(3))
    samples = pathwise_samples_at(model, post, x_new).numpy()
    mu, var = ClusterGP(kernel, num_data=N).predict_f(params, x_new)
    # Measured: mean and variance 0.0061 from the closed form.
    np.testing.assert_allclose(samples.mean(axis=0), mu.numpy(), atol=0.08)
    np.testing.assert_allclose(samples.var(axis=0), var.numpy(), atol=0.08)
