"""Port parity for the serving slice as a whole: CGGP.posterior ("cg" and
"chol"), posterior_predict, posterior_mean and predict_in_batches of
cggp_tpu_torch against cggp_tpu on the CPU, with parameters carried from
the JAX package by params_from_numpy.  The JAX kernels of the "pallas" and
"pallas_resident" routes run in Pallas interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cggp_tpu.data import synthetic as jax_synthetic
from cggp_tpu.models.cggp import CGGP as JaxCGGP
from cggp_tpu.ops.cg import ConjugateGradient as JaxConjugateGradient
from cggp_tpu.ops.kernels import Matern32 as JaxMatern32
from cggp_tpu.training.optimize import predict_in_batches as jax_predict_in_batches
from cggp_tpu.utils.store import save_config_dir
from cggp_tpu_torch.data import synthetic
from cggp_tpu_torch.models.cggp import CGGP
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.ops.kernels import Matern32
from cggp_tpu_torch.training.optimize import predict_in_batches
from cggp_tpu_torch.utils.store import load_config_dir, params_from_numpy

torch.set_num_threads(1)

M, N_QUERY, BATCH = 40, 100, 48  # 100 = 2 full batches + a padded one


def _problem(seed=0):
    """Inducing set, cluster state and queries from the synthetic data.
    noise 0.5 over counts 1..4 puts Lambda >= 0.125, so Kmm + Lambda has
    lambda_min >= 0.125 and CG converges in a few dozen steps."""
    (x, y), (xt, _) = jax_synthetic(n=600, dim=3, seed=seed)
    rng = np.random.default_rng(seed)
    z = x[rng.choice(x.shape[0], M, replace=False)]
    u = y[rng.choice(y.shape[0], M, replace=False)]
    counts = rng.integers(1, 5, (M, 1)).astype(np.float64)
    return z, u, counts, xt[:N_QUERY]


def _models(impl, threshold, dtype):
    jmodel = JaxCGGP(kernel=JaxMatern32(), conjugate_gradient=JaxConjugateGradient(
        threshold, matvec_impl=impl), num_data=400)
    tmodel = CGGP(kernel=Matern32(), conjugate_gradient=ConjugateGradient(
        threshold, matvec_impl=impl), num_data=400)
    z, u, counts, xq = _problem()
    jparams = jmodel.init_params(z, pseudo_u=u, cluster_counts=counts, noise_variance=0.5,
                                 dtype=dtype)
    tparams = params_from_numpy(jparams, device="cpu")
    return jmodel, jparams, tmodel, tparams, xq


def _serve_both(impl, threshold, dtype, solver="cg"):
    jmodel, jparams, tmodel, tparams, xq = _models(impl, threshold, dtype)
    with pltpu.force_tpu_interpret_mode():
        jpost = jmodel.posterior(jparams, solver=solver)
        jpred = jmodel.posterior_predict(jpost, jnp.asarray(xq, dtype))
        jmean = jmodel.posterior_mean(jpost, jnp.asarray(xq, dtype))
        jbatched = jax_predict_in_batches(jmodel, jparams, jnp.asarray(xq, dtype),
                                          batch_size=BATCH, posterior_solver=solver)
    tpost = tmodel.posterior(tparams, solver=solver)
    tx = torch.as_tensor(np.asarray(xq, dtype))
    tpred = tmodel.posterior_predict(tpost, tx)
    tmean = tmodel.posterior_mean(tpost, tx)
    tbatched = predict_in_batches(tmodel, tparams, tx, batch_size=BATCH, posterior_solver=solver)
    pairs = {
        "nu": (tpost.nu, jpost.nu),
        "mean": (tpred[0], jpred[0]), "var": (tpred[1], jpred[1]),
        "posterior_mean": (tmean, jmean),
        "batched_mean": (tbatched[0], jbatched[0]), "batched_var": (tbatched[1], jbatched[1]),
    }
    return {k: (t.numpy(), np.asarray(j)) for k, (t, j) in pairs.items()}


def _assert_pairs(pairs, atol):
    for name, (got, want) in pairs.items():
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


# float64 CG at threshold 1e-16 (just above where the reference's absolute
# 1e-16 curvature guard would stall it): each solve stops within
# sqrt(2e-16) / 0.125 ~ 1.1e-7 of the exact one; the two packages' outputs
# measured ~1e-9 apart, held here at 1e-8.
CG64 = 1e-16


def test_serving_cg_float64_xla_matches_jax():
    pairs = _serve_both("xla", CG64, jnp.float64)
    _assert_pairs(pairs, atol=1e-8)
    assert (pairs["var"][0] >= 0).all()


@pytest.mark.parametrize("impl", ["pallas_resident", "pallas"])
def test_serving_cg_float32_kernel_routes_match_jax(impl):
    # float32 at threshold 1e-8: 0.5 |r|^2 <= 1e-8 pins each solve within
    # sqrt(2e-8) / 0.125 ~ 1.1e-3 of the exact one; the outputs measured
    # <= 4e-5 apart, held here at 2e-4.
    pairs = _serve_both(impl, 1e-8, jnp.float32)
    _assert_pairs(pairs, atol=2e-4)
    assert all(got.dtype == np.float32 for got, _ in pairs.values())


def test_serving_chol_matches_jax():
    # Two triangular solves of a float64 system with kappa ~ 20: roundoff
    # (measured <= 4e-15).
    pairs = _serve_both("xla", CG64, jnp.float64, solver="chol")
    _assert_pairs(pairs, atol=1e-12)


def test_cg_and_chol_posteriors_agree():
    cg = _serve_both("xla", CG64, jnp.float64)
    chol = _serve_both("xla", CG64, jnp.float64, solver="chol")
    for name in ("mean", "var", "batched_mean", "batched_var"):
        # within the CG stop rule's 1.1e-7 (see CG64)
        np.testing.assert_allclose(cg[name][0], chol[name][0], rtol=0, atol=1e-7, err_msg=name)


def test_synthetic_matches_jax():
    for kwargs in ({}, {"n": 777, "dim": 3, "seed": 5, "noise": 0.3}):
        (x, y), (xt, yt) = synthetic(**kwargs)
        (jx, jy), (jxt, jyt) = jax_synthetic(**kwargs)
        for got, want in ((x, jx), (y, jy), (xt, jxt), (yt, jyt)):
            np.testing.assert_array_equal(got, want)


def test_config_dir_written_by_jax_serves_in_the_port(tmp_path):
    jmodel, jparams, tmodel, _, xq = _models("xla", CG64, jnp.float64)
    save_config_dir(tmp_path, jparams, {"model": "cdgp"})
    flat, info = load_config_dir(tmp_path)
    assert info == {"model": "cdgp"} and "kernel/lengthscales" in flat
    tparams = params_from_numpy(flat, device="cpu", dtype=torch.float64)
    want = jmodel.predict_f(jparams, jnp.asarray(xq))  # one fused [u | Kmn] CG solve
    got = tmodel.predict_f(tparams, torch.as_tensor(xq))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-8)


@pytest.mark.parametrize("call", ["solver_auto", "solver_lanczos", "precondition", "capacity",
                                  "batch_auto", "scan", "mesh"])
def test_unported_switches_raise(call):
    _, _, tmodel, tparams, xq = _models("xla", 1e-10, jnp.float64)
    x = torch.as_tensor(xq)
    with pytest.raises(NotImplementedError):
        if call == "solver_auto":
            tmodel.posterior(tparams)
        elif call == "solver_lanczos":
            tmodel.posterior(tparams, solver="lanczos")
        elif call == "precondition":
            CGGP(kernel=Matern32(), conjugate_gradient=ConjugateGradient(1e-6),
                 precondition="pivchol")
        elif call == "capacity":
            tmodel.init_params(tparams["inducing_points"], capacity=64, device="cpu")
        elif call == "batch_auto":
            predict_in_batches(tmodel, tparams, x, batch_size="auto", posterior_solver="cg")
        elif call == "scan":
            predict_in_batches(tmodel, tparams, x, scan=True, posterior_solver="chol")
        else:
            predict_in_batches(tmodel, tparams, x, mesh=object(), posterior_solver="cg")
    with pytest.raises(ValueError):
        tmodel.posterior(tparams, solver="cholesky")


def test_non_finite_cholesky_factor_raises():
    _, _, tmodel, tparams, xq = _models("xla", 1e-10, jnp.float64)
    tparams["cluster_counts"] = -tparams["cluster_counts"]  # Lambda < 0: Kmm + Lambda indefinite
    with pytest.raises(FloatingPointError):
        predict_in_batches(tmodel, tparams, torch.as_tensor(xq), posterior_solver="chol")


def test_mean_only_serving():
    _, _, tmodel, tparams, xq = _models("xla", CG64, jnp.float64)
    x = torch.as_tensor(xq)
    mean, var = predict_in_batches(tmodel, tparams, x, batch_size=BATCH, mean_only=True,
                                   posterior_solver="cg")
    assert var is None
    full_mean, _ = predict_in_batches(tmodel, tparams, x, batch_size=BATCH, posterior_solver="cg")
    np.testing.assert_allclose(mean.numpy(), full_mean.numpy(), rtol=0, atol=1e-12)


def test_serving_threshold_converges_at_m989():
    """The absolute threshold chip_smoke.py serves with (1e-8) is met by
    JAX's fp32 "xla" route at the full serving shape (M = 989 cover-tree
    selection of synthetic(n=435_000, dim=3, seed=0), Matern32 at init
    parameters) well before max_iterations = M, for the pseudo-u solve and
    64 query rows; the port's fp32 "xla" route takes as many steps."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import CG_THRESHOLD

    with np.load(Path(__file__).resolve().parent.parent / "benchmarks"
                 / "e2e_selection_covertree.npz") as sel:
        iv, u, counts = sel["iv"], sel["u"], sel["counts"]
    (x_train, _), (x_test, _) = synthetic(n=435_000, dim=3, seed=0)
    jmodel = JaxCGGP(kernel=JaxMatern32(), conjugate_gradient=JaxConjugateGradient(
        CG_THRESHOLD), num_data=x_train.shape[0])
    jparams = jmodel.init_params(iv, pseudo_u=u, cluster_counts=counts, dtype=jnp.float32)
    tparams = params_from_numpy(jparams, device="cpu")
    tmodel = CGGP(kernel=Matern32(), conjugate_gradient=ConjugateGradient(CG_THRESHOLD),
                  num_data=x_train.shape[0])
    m = iv.shape[0]
    jpost = jmodel.posterior(jparams, solver="cg")
    tpost = tmodel.posterior(tparams, solver="cg")
    xq = x_test[:64].astype(np.float32)
    jkmn = jmodel.kernel.K(jparams["kernel"], jparams["inducing_points"], jnp.asarray(xq))
    tkmn = tmodel.kernel.K(tparams["kernel"], tparams["inducing_points"], torch.as_tensor(xq))
    for jrhs, trhs in ((jparams["pseudo_u"], tparams["pseudo_u"]), (jkmn, tkmn)):
        _, jstats = jmodel.conjugate_gradient.solve_with_stats(jpost.kmm_lambda, jrhs)
        _, tstats = tmodel.conjugate_gradient.solve_with_stats(tpost.kmm_lambda, trhs)
        print(f"M={m}: JAX steps {int(jstats.steps)}, port steps {int(tstats.steps)}")
        assert bool(jstats.converged) and int(jstats.steps) < m // 3
        assert bool(tstats.converged)
        # fp32 step counts near convergence scatter by a few (see
        # test_torch_pallas_cg.py); 3 % of ~200-250 steps.
        assert abs(int(tstats.steps) - int(jstats.steps)) <= 8
