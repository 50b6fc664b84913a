"""Port parity for streaming ingestion: ``CGGP.posterior_extend`` and
``make_streaming_ingest_fn`` of ``cggp_tpu_torch`` against ``cggp_tpu`` on
the CPU, in float64, on the same numpy inputs, at the tolerances of the
JAX package's own ``tests/test_streaming.py``:

* a Cholesky cache on a pure centre append: the factor within 1e-9 of JAX's
  and of the rebuild, ``nu`` 1e-8, served values 1e-10;
* a CG cache under Lambda drift, for the identity, pivoted-Cholesky and
  exact-factor states (the last border-extended): the system block 1e-12,
  served values 5e-6 from JAX's, the rebuild's and a dense solve; the
  warm-started solve also through the ``"pallas"`` and ``"pallas_resident"``
  routes in float32 (their plain versions on the CPU, JAX's kernels in
  interpret mode);
* ``nu`` refreshed without growth, multi-column ``nu``, three rounds of
  extend-merge-extend, and the refusals in JAX's order with JAX's messages;
* the ingest of capacity-padded params: the dense model's chol and cg
  caches and ``ImplicitCGGP``'s cg cache served as JAX's (1e-8; 5e-6 for
  the CG caches), capacity saturation, and the refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cggp_tpu.models import CGGP as JaxCGGP
from cggp_tpu.models.implicit import ImplicitCGGP as JaxImplicitCGGP
from cggp_tpu.ops.cg import ConjugateGradient as JaxConjugateGradient
from cggp_tpu.ops.kernels import Matern32 as JaxMatern32
from cggp_tpu.selection.covernet import (covernet_extend_update as jax_extend_update,
                                         covernet_update_inducing_parameters as jax_covernet)
from cggp_tpu.training.optimize import make_streaming_ingest_fn as jax_ingest_fn
from cggp_tpu_torch.models.cggp import CGGP
from cggp_tpu_torch.models.implicit import ImplicitCGGP
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.ops.kernels import Matern32
from cggp_tpu_torch.selection.covernet import (covernet_extend_update,
                                               covernet_update_inducing_parameters)
from cggp_tpu_torch.training import make_streaming_ingest_fn
from cggp_tpu_torch.utils.store import params_from_numpy

torch.set_num_threads(1)


def _models(precondition, threshold=1e-14, relative=True, impl="xla"):
    common = dict(num_data=250, num_probes=3, precondition=precondition, precond_rank=8)
    return (JaxCGGP(kernel=JaxMatern32(), conjugate_gradient=JaxConjugateGradient(
                threshold, relative_threshold=relative, matvec_impl=impl), **common),
            CGGP(kernel=Matern32(), conjugate_gradient=ConjugateGradient(
                threshold, relative_threshold=relative, matvec_impl=impl), **common))


def _setup(res=0.45, seed=0):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-1, 1, (160, 2))
    x2 = rng.uniform(-1.6, 1.6, (90, 2))  # partly outside: the net grows
    y1, y2 = np.sin(2.0 * x1[:, :1]), np.sin(2.0 * x2[:, :1])
    z1, u1, c1 = jax_covernet((jnp.asarray(x1), jnp.asarray(y1)), res, lloyds=0)
    z2, u2, c2 = jax_extend_update(z1, u1, c1, (jnp.asarray(x2), jnp.asarray(y2)), res)
    xq = rng.uniform(-1.5, 1.5, (37, 2))
    return (x1, y1), (x2, y2), tuple(map(np.asarray, (z1, u1, c1))), \
        tuple(map(np.asarray, (z2, u2, c2))), xq


def _both(jmodel, tmodel, z, u, c, **kw):
    jparams = jmodel.init_params(jnp.asarray(z), pseudo_u=jnp.asarray(u),
                                 cluster_counts=jnp.asarray(c), dtype=jnp.float64, **kw)
    return jparams, params_from_numpy(jparams, device="cpu")


def _assign(jmodel, tmodel, jparams, tparams, z, u, c):
    return (jmodel.assign_clusters(jparams, jnp.asarray(z), jnp.asarray(u), jnp.asarray(c)),
            tmodel.assign_clusters(tparams, torch.as_tensor(z), torch.as_tensor(u),
                                   torch.as_tensor(c)))


def _served(model, post, xq):
    x = torch.as_tensor(xq) if isinstance(model, (CGGP, ImplicitCGGP)) else jnp.asarray(xq)
    return [np.asarray(t) for t in model.posterior_predict(post, x)]


def test_covernet_extend_update_matches_jax():
    (_x1, _y1), (x2, y2), (z1, u1, c1), (z2, u2, c2), _ = _setup()
    got = covernet_extend_update(torch.as_tensor(z1), torch.as_tensor(u1), torch.as_tensor(c1),
                                 (torch.as_tensor(x2), torch.as_tensor(y2)), 0.45)
    assert got[0].shape[0] > z1.shape[0]
    for g, w in zip(got, (z2, u2, c2)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)


def test_posterior_extend_chol_pure_append_matches_jax():
    _, _, (z1, u1, c1), (z2, _u2, _c2), xq = _setup()
    m1, m2 = z1.shape[0], z2.shape[0]
    jmodel, tmodel = _models(None)
    jp1, tp1 = _both(jmodel, tmodel, z1, u1, c1)
    u_app = np.concatenate([u1, np.zeros((m2 - m1, 1))])
    c_app = np.concatenate([c1, np.ones((m2 - m1, 1))])
    jp2, tp2 = _assign(jmodel, tmodel, jp1, tp1, z2, u_app, c_app)
    jpost = jmodel.posterior_extend(jmodel.posterior(jp1, solver="chol"), jp2)
    tpost = tmodel.posterior_extend(tmodel.posterior(tp1, solver="chol"), tp2)
    ref = tmodel.posterior(tp2, solver="chol")
    assert tpost.chol is not None and tpost.kmm_lambda is None
    for want in (np.asarray(jpost.chol), ref.chol.numpy()):
        np.testing.assert_allclose(tpost.chol.numpy(), want, rtol=1e-9, atol=1e-12)
    for want in (np.asarray(jpost.nu), ref.nu.numpy()):
        np.testing.assert_allclose(tpost.nu.numpy(), want, rtol=1e-8, atol=1e-12)
    for got, want in zip(_served(tmodel, tpost, xq), _served(jmodel, jpost, xq)):
        np.testing.assert_allclose(got, want, atol=1e-10)
    for got, want in zip(_served(tmodel, tpost, xq), _served(tmodel, ref, xq)):
        np.testing.assert_allclose(got, want, atol=1e-10)


@pytest.mark.parametrize("precondition", [None, "pivchol", "chol"])
def test_posterior_extend_cg_with_lambda_drift_matches_jax(precondition):
    _, _, (z1, u1, c1), (z2, u2, c2), xq = _setup()
    assert np.all(c2[:z1.shape[0]] >= c1) and not np.all(c2[:z1.shape[0]] == c1)
    jmodel, tmodel = _models(precondition)
    jp1, tp1 = _both(jmodel, tmodel, z1, u1, c1)
    jp2, tp2 = _assign(jmodel, tmodel, jp1, tp1, z2, u2, c2)
    jpost = jmodel.posterior_extend(jmodel.posterior(jp1, solver="cg"), jp2)
    tpost = tmodel.posterior_extend(tmodel.posterior(tp1, solver="cg"), tp2)
    ref = tmodel.posterior(tp2, solver="cg")
    np.testing.assert_allclose(tpost.kmm_lambda.numpy(), ref.kmm_lambda.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(tpost.kmm_lambda.numpy(), np.asarray(jpost.kmm_lambda),
                               rtol=1e-12, atol=1e-12)
    assert type(tpost.precond_state) is type(jpost.precond_state)
    if precondition == "chol":  # the border-extended W: JAX's algebra
        np.testing.assert_allclose(tpost.precond_state["chol_w"].numpy(),
                                   np.asarray(jpost.precond_state["chol_w"]), rtol=1e-9,
                                   atol=1e-10)
    served = _served(tmodel, tpost, xq)
    for want in (_served(jmodel, jpost, xq), _served(tmodel, ref, xq)):
        for got, w in zip(served, want):
            np.testing.assert_allclose(got, w, atol=5e-6)
    kp = tp2["kernel"]
    a = tmodel.kernel.K(kp, tp2["inducing_points"]) + torch.diag(tmodel.diag_variance(tp2)[:, 0])
    mu = tmodel.kernel.K(kp, tp2["inducing_points"], torch.as_tensor(xq)).T @ \
        torch.linalg.solve(a, tp2["pseudo_u"])
    np.testing.assert_allclose(served[0], mu.numpy(), atol=5e-6)


@pytest.mark.parametrize("impl", ["pallas", "pallas_resident"])
def test_posterior_extend_on_the_kernel_routes(impl):
    # In float32, as the kernels compute: B1 under the border-extended exact
    # factor at relative 1e-5 (the streaming production solve) and B2 with
    # no preconditioner at absolute 1e-8 through the shifted system
    # (v0 + d) A = b.  On the CPU each runs its plain version, JAX its Pallas
    # kernel in interpret mode.  fp32 CG runs that sum in other orders part
    # by ~1e-5 before they stop (measured 5e-7 and 1.8e-5), so the packages
    # are held to 1e-4 of each other, and the port to twice JAX's own gap
    # from a float64 solve of the extended system (plus 1e-5).
    _, _, (z1, u1, c1), (z2, u2, c2), xq = _setup()
    precondition, threshold, relative = (("chol", 1e-5, True) if impl == "pallas"
                                         else (None, 1e-8, False))
    jmodel, tmodel = _models(precondition, threshold, relative, impl)
    f32 = [a.astype(np.float32) for a in (z1, u1, c1, z2, u2, c2)]
    jp1 = jmodel.init_params(*map(jnp.asarray, f32[:1]), pseudo_u=jnp.asarray(f32[1]),
                             cluster_counts=jnp.asarray(f32[2]), dtype=jnp.float32)
    tp1 = params_from_numpy(jp1, device="cpu")
    jp2 = jmodel.assign_clusters(jp1, *map(jnp.asarray, f32[3:]))
    tp2 = tmodel.assign_clusters(tp1, *map(torch.as_tensor, f32[3:]))
    xq32 = xq.astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jpost = jmodel.posterior_extend(jmodel.posterior(jp1, solver="cg"), jp2)
        jmean = np.asarray(jmodel.posterior_predict(jpost, jnp.asarray(xq32))[0])
    post1 = tmodel.posterior(tp1, solver="cg")
    tpost = tmodel.posterior_extend(post1, tp2)
    tmean = tmodel.posterior_predict(tpost, torch.as_tensor(xq32))[0].numpy()
    np.testing.assert_allclose(tmean, jmean, atol=1e-4)

    kp = {k: v.double() for k, v in tp2["kernel"].items()}
    z = tp2["inducing_points"].double()
    lam = tmodel.diag_variance(tp2)[:, 0].double()
    a = tmodel.kernel.K(kp, z) + torch.diag(lam)
    exact = (tmodel.kernel.K(kp, z, torch.as_tensor(xq)).T @
             torch.linalg.solve(a, tp2["pseudo_u"].double())).numpy()
    assert np.abs(tmean - exact).max() <= 2 * np.abs(jmean - exact).max() + 1e-5

    # The warm start takes no more steps than a cold solve of the system.
    from cggp_tpu_torch.models.cggp import _precond_from_state
    nu0 = torch.cat([post1.nu, post1.nu.new_zeros((z2.shape[0] - z1.shape[0], 1))])
    cg, pre = tmodel.conjugate_gradient, _precond_from_state(tpost.precond_state)
    _, warm = cg.solve_with_stats(tpost.kmm_lambda, tp2["pseudo_u"], nu0, preconditioner=pre)
    _, cold = cg.solve_with_stats(tpost.kmm_lambda, tp2["pseudo_u"], preconditioner=pre)
    assert bool(warm.converged) and int(warm.steps) <= int(cold.steps)


def test_posterior_extend_nu_refresh_without_growth_matches_jax():
    _, _, (z1, u1, c1), _, _ = _setup()
    rng = np.random.default_rng(1)
    xq = rng.uniform(-1, 1, (21, 2))
    jmodel, tmodel = _models("chol")
    jp1, tp1 = _both(jmodel, tmodel, z1, u1, c1)
    jp2, tp2 = _assign(jmodel, tmodel, jp1, tp1, z1, u1 + 0.1, c1 + 1.0)
    tpost = tmodel.posterior_extend(tmodel.posterior(tp1, solver="cg"), tp2)
    jpost = jmodel.posterior_extend(jmodel.posterior(jp1, solver="cg"), jp2)
    ref = tmodel.posterior(tp2, solver="cg")
    for want in (_served(jmodel, jpost, xq), _served(tmodel, ref, xq)):
        for got, w in zip(_served(tmodel, tpost, xq), want):
            np.testing.assert_allclose(got, w, atol=1e-8)
    # A Cholesky cache, Lambda unchanged, u changed: the factor reused.
    jpu, tpu = _assign(jmodel, tmodel, jp1, tp1, z1, u1 + 0.5, c1)
    post_c = tmodel.posterior(tp1, solver="chol")
    got = tmodel.posterior_extend(post_c, tpu)
    assert got.chol is post_c.chol
    for want in (tmodel.posterior(tpu, solver="chol").nu.numpy(),
                 np.asarray(jmodel.posterior_extend(jmodel.posterior(jp1, solver="chol"),
                                                    jpu).nu)):
        np.testing.assert_allclose(got.nu.numpy(), want, rtol=1e-9, atol=1e-12)


def test_posterior_extend_refusals_match_jax():
    _, _, (z1, u1, c1), (z2, u2, c2), _ = _setup()
    jmodel, tmodel = _models("chol")
    jp1, tp1 = _both(jmodel, tmodel, z1, u1, c1)
    jp2, tp2 = _assign(jmodel, tmodel, jp1, tp1, z2, u2, c2)
    jpad, tpad = _both(jmodel, tmodel, z1, u1, c1, capacity=z1.shape[0] + 8)

    def cases(model, p1, p2, pad, is_jax):
        moved = dict(p2)
        kernel = dict(p2["kernel"])
        if is_jax:
            kernel = jax.tree_util.tree_map(lambda a: a + 0.1, kernel)
            moved["inducing_points"] = p2["inducing_points"].at[0, 0].add(0.5)
        else:
            kernel = {k: v + 0.1 for k, v in kernel.items()}
            moved["inducing_points"] = p2["inducing_points"].clone()
            moved["inducing_points"][0, 0] += 0.5
        return [
            (model.posterior(p1, solver="chol"), p2, "Lambda drifted"),
            (model.posterior(p1, solver="cg"), dict(p2, kernel=kernel), "kernel hyperparameters"),
            (model.posterior(p1, solver="cg"), moved, "unchanged prefix"),
            (model.posterior(p1, solver="lanczos"), p2, "lanczos"),
            (model.posterior(pad, solver="cg"), p2, "unpadded"),
        ]

    for (jpost, jparams, match), (tpost, tparams, tmatch) in zip(
            cases(jmodel, jp1, jp2, jpad, True), cases(tmodel, tp1, tp2, tpad, False)):
        messages = []
        for model, post, params in ((jmodel, jpost, jparams), (tmodel, tpost, tparams)):
            with pytest.raises(ValueError, match=match) as err:
                model.posterior_extend(post, params)
            messages.append(str(err.value))
        assert messages[0] == messages[1]


def test_posterior_extend_multicolumn_nu_and_rounds_match_jax():
    _, _, (z1, u1, c1), (z2, u2, c2), xq = _setup()
    jmodel, tmodel = _models(None)
    u1w, u2w = np.concatenate([u1, 2 * u1], 1), np.concatenate([u2, 2 * u2], 1)
    jp1, tp1 = _both(jmodel, tmodel, z1, u1w, c1)
    jp2, tp2 = _assign(jmodel, tmodel, jp1, tp1, z2, u2w, c2)
    tpost = tmodel.posterior_extend(tmodel.posterior(tp1, solver="cg"), tp2)
    jpost = jmodel.posterior_extend(jmodel.posterior(jp1, solver="cg"), jp2)
    assert tpost.nu.shape == (z2.shape[0], 2)
    np.testing.assert_allclose(tpost.nu.numpy(), np.asarray(jpost.nu), atol=5e-6)

    # Three rounds of net growth, merge and extension, each served as the
    # rebuild serves (JAX's streaming pipeline test, at its 1e-7).
    rng = np.random.default_rng(2)
    res = 0.5
    jmodel, tmodel = _models("chol")
    x0 = rng.uniform(-0.8, 0.8, (120, 2))
    z, u, c = (a.numpy() for a in covernet_update_inducing_parameters(
        (torch.as_tensor(x0), torch.as_tensor(np.sin(2 * x0[:, :1]))), res, lloyds=0))
    _, params = _both(jmodel, tmodel, z, u, c)
    post = tmodel.posterior(params, solver="cg")
    lo = 0.8
    zt, ut, ct = (torch.as_tensor(a) for a in (z, u, c))
    for _ in range(3):
        hi = lo + 0.4
        xb = torch.as_tensor(rng.uniform(-hi, hi, (70, 2)))
        zt, ut, ct = covernet_extend_update(zt, ut, ct, (xb, torch.sin(2 * xb[:, :1])), res)
        params = tmodel.assign_clusters(params, zt, ut, ct)
        post = tmodel.posterior_extend(post, params)
        ref = tmodel.posterior(params, solver="cg")
        for got, want in zip(_served(tmodel, post, xq), _served(tmodel, ref, xq)):
            np.testing.assert_allclose(got, want, atol=1e-7)
        lo = hi


@pytest.mark.parametrize("solver", ["chol", "cg"])
def test_streaming_ingest_matches_jax(solver):
    rng = np.random.default_rng(3)
    res, cap = 0.5, 64
    x0 = rng.uniform(-0.8, 0.8, (120, 2))
    z, u, c = map(np.asarray, jax_covernet((jnp.asarray(x0), jnp.asarray(np.sin(2 * x0[:, :1]))),
                                           res, lloyds=0))
    jmodel, tmodel = _models("chol")
    jparams, tparams = _both(jmodel, tmodel, z, u, c, capacity=cap)
    jingest = jax_ingest_fn(jmodel, res, posterior_solver=solver)
    tingest = make_streaming_ingest_fn(tmodel, res, posterior_solver=solver)
    xq = rng.uniform(-1.8, 1.8, (23, 2))
    lo, counts = 0.8, []
    for _ in range(3):
        hi = lo + 0.4
        xb = rng.uniform(-hi, hi, (64, 2))
        yb = np.sin(2.0 * xb[:, :1])
        jparams, jpost = jingest(jparams, jnp.asarray(xb), jnp.asarray(yb))
        tparams, tpost = tingest(tparams, torch.as_tensor(xb), torch.as_tensor(yb))
        for leaf in ("inducing_points", "pseudo_u", "cluster_counts", "inducing_mask"):
            np.testing.assert_allclose(tparams[leaf].numpy(), np.asarray(jparams[leaf]),
                                       rtol=1e-12, atol=1e-12, err_msg=leaf)
        assert tparams["inducing_points"].shape == (cap, 2)
        counts.append(int(tparams["inducing_mask"].sum()))
        for got, want in zip(_served(tmodel, tpost, xq), _served(jmodel, jpost, xq)):
            np.testing.assert_allclose(got, want, atol=1e-8 if solver == "chol" else 5e-6)
        lo = hi
    assert counts == sorted(counts) and counts[-1] < cap
    with pytest.raises(ValueError, match="capacity-padded"):
        tingest(params_from_numpy(jmodel.init_params(jnp.asarray(z), dtype=jnp.float64),
                                  device="cpu"), torch.as_tensor(xq), torch.zeros((23, 1)))
    with pytest.raises(ValueError, match="auto"):
        make_streaming_ingest_fn(tmodel, res, posterior_solver="auto")


def test_streaming_ingest_saturates_and_serves_implicit_as_jax():
    rng = np.random.default_rng(4)
    x0 = rng.uniform(-1, 1, (40, 2))
    z, u, c = map(np.asarray, jax_covernet((jnp.asarray(x0), jnp.asarray(np.sin(x0[:, :1]))),
                                           0.5, lloyds=0))
    m0 = z.shape[0]
    jmodel, tmodel = _models("chol")
    _, tparams = _both(jmodel, tmodel, z, u, c, capacity=m0 + 4)
    xb = torch.as_tensor(rng.uniform(-1, 1, (50, 2)))
    out, _post = make_streaming_ingest_fn(tmodel, 0.05)(tparams, xb, torch.sin(xb[:, :1]))
    assert int(out["inducing_mask"].sum()) == m0 + 4  # saturated, not an error
    np.testing.assert_array_equal(out["inducing_points"][:m0].numpy(), z)

    # The masked matrix-free model through the same ingest, "cg" cache.
    res, cap = 0.5, 24
    x0 = rng.uniform(-0.8, 0.8, (96, 2))
    z, u, c = map(np.asarray, jax_covernet((jnp.asarray(x0), jnp.asarray(np.sin(2 * x0[:, :1]))),
                                           res, lloyds=0))
    xb = rng.uniform(-1.3, 1.3, (64, 2))
    yb = np.sin(2.0 * xb[:, :1])
    xq = rng.uniform(-1.2, 1.2, (19, 2))
    jmodel = JaxImplicitCGGP(kernel=JaxMatern32(), num_data=96, num_probes=3,
                             error_threshold=1e-14, max_cg_iterations=cap)
    tmodel = ImplicitCGGP(kernel=Matern32(), num_data=96, num_probes=3, error_threshold=1e-14,
                          max_cg_iterations=cap)
    jparams, tparams = _both(jmodel, tmodel, z, u, c, capacity=cap)
    jparams, jpost = jax_ingest_fn(jmodel, res, posterior_solver="cg")(
        jparams, jnp.asarray(xb), jnp.asarray(yb))
    tparams, tpost = make_streaming_ingest_fn(tmodel, res, posterior_solver="cg")(
        tparams, torch.as_tensor(xb), torch.as_tensor(yb))
    assert int(tparams["inducing_mask"].sum()) == int(jparams["inducing_mask"].sum())
    for got, want in zip(_served(tmodel, tpost, xq), _served(jmodel, jpost, xq)):
        np.testing.assert_allclose(got, want, atol=5e-6)
