"""Port parity for the rest of ``predict_in_batches``: ``ClusterGP``'s
Cholesky serving cache, ``batch_size="auto"`` (``auto_serving_batch_size``
and ``_serving_system_rows``), ``use_posterior=False`` (``predict_f`` per
batch) and the one-sweep scan route (``posterior_predict_scan``), against
``cggp_tpu`` on the CPU in float64, parameters carried by
``params_from_numpy``.

Tolerances: Cholesky caches agree to rounding (1e-10 on means and
variances of order 1); CG-served outputs at absolute 1e-16 each lie within
``sqrt(2e-16) / 0.125 ~ 1.1e-7`` of the exact solve (Lambda >= 0.125) and
measured ~1e-9 apart across the packages, held at 1e-8, as
``tests/test_torch_cggp_serving.py`` holds them; the scan and the loop of
the port run the same operations on the same rows and are held bitwise
equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cggp_tpu.data import synthetic as jax_synthetic
from cggp_tpu.models.cggp import CGGP as JaxCGGP
from cggp_tpu.models.clustergp import ClusterGP as JaxClusterGP
from cggp_tpu.models.itergpr import IterGPR as JaxIterGPR
from cggp_tpu.ops.cg import ConjugateGradient as JaxConjugateGradient
from cggp_tpu.ops.kernels import Matern32 as JaxMatern32
from cggp_tpu.training import optimize as joptimize
from cggp_tpu.utils.store import save_posterior as jax_save_posterior
from cggp_tpu_torch.models import CGGP, ClusterGP, CholPosterior, IterGPR
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.ops.kernels import Matern32
from cggp_tpu_torch.training import optimize as toptimize
from cggp_tpu_torch.utils.store import load_posterior, params_from_numpy, save_posterior

torch.set_num_threads(1)

M, N_QUERY, BATCH = 40, 100, 48  # 100 = 2 full batches + a padded one
CG64 = 1e-16


def _problem(seed=0):
    (x, y), (xt, _) = jax_synthetic(n=600, dim=3, seed=seed)
    rng = np.random.default_rng(seed)
    z = x[rng.choice(x.shape[0], M, replace=False)]
    u = y[rng.choice(y.shape[0], M, replace=False)]
    counts = rng.integers(1, 5, (M, 1)).astype(np.float64)
    return z, u, counts, xt[:N_QUERY]


def _cluster():
    z, u, counts, xq = _problem()
    jmodel, tmodel = JaxClusterGP(kernel=JaxMatern32()), ClusterGP(kernel=Matern32())
    jparams = jmodel.init_params(z, pseudo_u=u, cluster_counts=counts, noise_variance=0.5,
                                 dtype=jnp.float64)
    return jmodel, jparams, tmodel, params_from_numpy(jparams, device="cpu"), xq


def _cggp():
    z, u, counts, xq = _problem()
    jmodel = JaxCGGP(kernel=JaxMatern32(), conjugate_gradient=JaxConjugateGradient(CG64),
                     num_data=400)
    tmodel = CGGP(kernel=Matern32(), conjugate_gradient=ConjugateGradient(CG64), num_data=400)
    jparams = jmodel.init_params(z, pseudo_u=u, cluster_counts=counts, noise_variance=0.5,
                                 dtype=jnp.float64)
    return jmodel, jparams, tmodel, params_from_numpy(jparams, device="cpu"), xq


@pytest.mark.parametrize("full_cov", [False, True])
def test_clustergp_cache_matches_jax_and_its_predict_f(full_cov):
    jmodel, jparams, tmodel, tparams, xq = _cluster()
    jpost, tpost = jmodel.posterior(jparams), tmodel.posterior(tparams)
    assert isinstance(tpost, CholPosterior) and tpost._fields == jpost._fields
    for name in ("chol", "nu"):
        np.testing.assert_allclose(getattr(tpost, name).numpy(), np.asarray(getattr(jpost, name)),
                                   rtol=0, atol=1e-10)
    tx = torch.as_tensor(xq)
    got = tmodel.posterior_predict(tpost, tx, full_cov=full_cov)
    want = jmodel.posterior_predict(jpost, jnp.asarray(xq), full_cov=full_cov)
    uncached = tmodel.predict_f(tparams, tx, full_cov=full_cov)
    for g, w, u in zip(got, want, uncached):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)
        np.testing.assert_allclose(g.numpy(), u.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tmodel.posterior_mean(tpost, tx).numpy(), got[0].numpy(),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["loop", "scan", "mean_only", "uncached"])
def test_clustergp_serves_through_predict_in_batches(mode):
    jmodel, jparams, tmodel, tparams, xq = _cluster()
    kw = {"loop": {"scan": False}, "scan": {}, "mean_only": {"mean_only": True},
          "uncached": {"use_posterior": False}}[mode]
    got = toptimize.predict_in_batches(tmodel, tparams, xq, batch_size=BATCH, **kw)
    want = joptimize.predict_in_batches(jmodel, jparams, jnp.asarray(xq), batch_size=BATCH, **kw)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert tuple(g.shape) == (N_QUERY, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)


def test_clustergp_cache_round_trips_through_the_store(tmp_path):
    jmodel, jparams, tmodel, tparams, xq = _cluster()
    jax_save_posterior(tmp_path / "jax", jmodel.posterior(jparams))
    post = load_posterior(tmp_path / "jax", device="cpu")
    assert isinstance(post, CholPosterior)
    save_posterior(tmp_path / "port", post)
    again = load_posterior(tmp_path / "port", device="cpu")
    got = tmodel.posterior_predict(again, torch.as_tensor(xq))
    want = tmodel.posterior_predict(tmodel.posterior(tparams), torch.as_tensor(xq))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-12)


def test_auto_serving_batch_size_matches_jax():
    for m in (1, 40, 989, 1024, 4096, 10240, 16384, 131_072, 262_144, 10 ** 6):
        for n in (1, 100, 8191, 8192, 50_000, 10 ** 6):
            assert toptimize.auto_serving_batch_size(m, n) == \
                joptimize.auto_serving_batch_size(m, n), (m, n)
    assert toptimize.auto_serving_batch_size(0, 10 ** 6) == \
        joptimize.auto_serving_batch_size(0, 10 ** 6)


def test_serving_system_rows_matches_jax():
    _, jparams, _, tparams, xq = _cggp()
    assert toptimize._serving_system_rows(None, tparams, None) == M == \
        joptimize._serving_system_rows(None, jparams, None)
    gp = {"kernel": tparams["kernel"], "likelihood": tparams["likelihood"]}
    assert toptimize._serving_system_rows(None, gp, (xq, xq[:, :1])) == N_QUERY
    assert toptimize._serving_system_rows(None, gp, None) is None


@pytest.mark.parametrize("solver", ["cg", "chol", "lanczos"])
def test_batch_size_auto_matches_jax(solver):
    jmodel, jparams, tmodel, tparams, xq = _cggp()
    got = toptimize.predict_in_batches(tmodel, tparams, xq, batch_size="auto",
                                       posterior_solver=solver)
    want = joptimize.predict_in_batches(jmodel, jparams, jnp.asarray(xq), batch_size="auto",
                                        posterior_solver=solver)
    fixed = toptimize.predict_in_batches(tmodel, tparams, xq, batch_size=N_QUERY,
                                         posterior_solver=solver)
    for g, w, f in zip(got, want, fixed):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-8)
        np.testing.assert_array_equal(g.numpy(), f.numpy())  # one exact-size block


@pytest.mark.parametrize("family", ["cggp", "itergpr"])
def test_use_posterior_false_matches_the_cache_and_jax(family):
    if family == "cggp":
        jmodel, jparams, tmodel, tparams, xq = _cggp()
        train = {}
    else:
        rng = np.random.default_rng(3)
        x = rng.uniform(-1.5, 1.5, (120, 3))
        y = np.sin(x.sum(-1, keepdims=True))
        xq = rng.uniform(-1.5, 1.5, (N_QUERY, 3))
        kw = dict(error_threshold=1e-14, relative_threshold=False, max_cg_iterations=500,
                  block=64, precondition=None)
        jmodel, tmodel = JaxIterGPR(kernel=JaxMatern32(), **kw), IterGPR(kernel=Matern32(), **kw)
        jparams = jmodel.init_params(3, noise_variance=0.1, dtype=jnp.float64)
        tparams = params_from_numpy(jparams, device="cpu")
        train = {"train_data": (x, y)}
        jtrain = {"train_data": (jnp.asarray(x), jnp.asarray(y))}
    got = toptimize.predict_in_batches(tmodel, tparams, xq, batch_size=BATCH,
                                       use_posterior=False, **train)
    want = joptimize.predict_in_batches(jmodel, jparams, jnp.asarray(xq), batch_size=BATCH,
                                        use_posterior=False,
                                        **(jtrain if family == "itergpr" else {}))
    cached = toptimize.predict_in_batches(tmodel, tparams, xq, batch_size=BATCH,
                                          posterior_solver="cg", **train)
    # IterGPR's noise 0.1 bounds its solves' error by sqrt(2e-14) / 0.1 ~ 1.4e-6
    # (measured 1.2e-8): held at 1e-7.
    tol = 1e-8 if family == "cggp" else 1e-7
    for g, w, c in zip(got, want, cached):
        assert tuple(g.shape) == (N_QUERY, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("solver,mean_only", [("chol", False), ("lanczos", False),
                                              ("cg", True), ("cg", False)])
def test_scan_route_equals_the_loop_and_jax(solver, mean_only):
    """scan="auto" takes the sweep for solve-free caches (and mean_only);
    scan=True forces it on a CG cache, which warns, as in JAX."""
    jmodel, jparams, tmodel, tparams, xq = _cggp()
    post = tmodel.posterior(tparams, solver=solver)
    jpost = jmodel.posterior(jparams, solver=solver)
    loop = toptimize.predict_in_batches(tmodel, tparams, xq, batch_size=BATCH, scan=False,
                                        posterior=post, mean_only=mean_only)
    forced = solver == "cg" and not mean_only
    if forced:
        with pytest.warns(RuntimeWarning, match="CG"):
            sweep = toptimize.posterior_predict_scan(tmodel, post, torch.as_tensor(xq),
                                                     batch_size=BATCH)
        with pytest.warns(RuntimeWarning, match="CG"):
            routed = toptimize.predict_in_batches(tmodel, tparams, xq, batch_size=BATCH,
                                                  scan=True, posterior=post)
    else:
        sweep = toptimize.posterior_predict_scan(tmodel, post, torch.as_tensor(xq),
                                                 batch_size=BATCH, mean_only=mean_only)
        routed = toptimize.predict_in_batches(tmodel, tparams, xq, batch_size=BATCH,
                                              posterior=post, mean_only=mean_only)
    want = joptimize.posterior_predict_scan(jmodel, jpost, jnp.asarray(xq), batch_size=BATCH,
                                            mean_only=mean_only)
    for s, r, lp, w in zip(sweep, routed, loop, want):
        if w is None:
            assert s is None and r is None and lp is None
            continue
        assert tuple(s.shape) == (N_QUERY, 1)
        np.testing.assert_array_equal(s.numpy(), lp.numpy())
        np.testing.assert_array_equal(r.numpy(), lp.numpy())
        np.testing.assert_allclose(s.numpy(), np.asarray(w), rtol=0, atol=1e-8)


def test_serving_switch_errors_match_jax():
    """What both packages refuse: mean_only, scan=True and a prebuilt cache
    without the cache path (ValueError); mesh serving stays unported and
    names its queue item."""
    jmodel, jparams, tmodel, tparams, xq = _cggp()
    post = tmodel.posterior(tparams, solver="chol")
    for kw in ({"mean_only": True}, {"scan": True}, {"posterior": post}):
        with pytest.raises(ValueError):
            toptimize.predict_in_batches(tmodel, tparams, xq, use_posterior=False, **kw)
        jkw = dict(kw, posterior=jmodel.posterior(jparams, solver="chol")) \
            if "posterior" in kw else kw
        with pytest.raises(ValueError):
            joptimize.predict_in_batches(jmodel, jparams, jnp.asarray(xq), use_posterior=False,
                                         **jkw)
    with pytest.raises(NotImplementedError, match="item 12"):
        toptimize.predict_in_batches(tmodel, tparams, xq, mesh=object())
    with pytest.raises(NotImplementedError, match="item 12"):
        toptimize.posterior_predict_scan(tmodel, post, torch.as_tensor(xq), mesh=object())
