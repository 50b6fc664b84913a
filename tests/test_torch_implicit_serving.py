"""Port parity for the matrix-free serving slice as a whole: ImplicitCGGP's
predict_f, posterior(solver="cg"), posterior_mean, posterior_predict (diag
and full_cov) and predict_in_batches of cggp_tpu_torch against cggp_tpu on
the CPU, on a padded system (m = 50, block = 32 -> 64), with parameters
carried from the JAX package by params_from_numpy.  The JAX kernel of the
use_pallas route runs in Pallas interpret mode, as the JAX package's own
test of that route runs it (tests/test_implicit_model.py).  Also the
committed cover-tree selection chip_smoke.py serves at M = 9576."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cggp_tpu.ops.pallas_gram as jax_pallas_gram
from cggp_tpu.data import synthetic as jax_synthetic
from cggp_tpu.models.implicit import ImplicitCGGP as JaxImplicitCGGP
from cggp_tpu.ops.kernels import Matern32 as JaxMatern32
from cggp_tpu.training.optimize import predict_in_batches as jax_predict_in_batches
from cggp_tpu_torch.models.implicit import ImplicitCGGP
from cggp_tpu_torch.ops.kernels import Matern32
from cggp_tpu_torch.ops.pallas_gram import gram_matvec, kuu_matvec
from cggp_tpu_torch.training.optimize import predict_in_batches
from cggp_tpu_torch.utils.store import params_from_numpy

torch.set_num_threads(1)

M, BLOCK, N_QUERY, BATCH = 50, 32, 70, 32  # 70 = 2 full batches + a padded one
SELECTION = (Path(__file__).resolve().parent.parent / "cggp_tpu_torch" / "assets"
             / "selection_covertree_r015.npz")


@pytest.fixture
def jax_interpret_gram(monkeypatch):
    """Run the JAX use_pallas route's kernel in interpret mode with blocks
    that fit m = 64 (as tests/test_implicit_model.py does)."""
    orig = jax_pallas_gram.kuu_matvec

    def interpreted(z_scaled, lam, p, variance, kernel_name="se", **kw):
        kw.update(interpret=True, block_n=16, block_m=16)
        return orig(z_scaled, lam, p, variance, kernel_name, **kw)

    monkeypatch.setattr(jax_pallas_gram, "kuu_matvec", interpreted)


def _problem(seed=0):
    """Inducing set, cluster state and queries from the synthetic data;
    noise 0.5 over counts 1..4 puts Lambda >= 0.125."""
    (x, y), (xt, _) = jax_synthetic(n=600, dim=3, seed=seed)
    rng = np.random.default_rng(seed)
    z = x[rng.choice(x.shape[0], M, replace=False)]
    u = y[rng.choice(y.shape[0], M, replace=False)]
    counts = rng.integers(1, 5, (M, 1)).astype(np.float64)
    return z, u, counts, xt[:N_QUERY]


def _models(precondition, use_pallas, threshold, dtype, relative=False):
    kw = dict(num_data=400, error_threshold=threshold, max_cg_iterations=200, block=BLOCK,
              precondition=precondition, precond_rank=8, use_pallas=use_pallas,
              relative_threshold=relative)
    jmodel = JaxImplicitCGGP(kernel=JaxMatern32(), **kw)
    tmodel = ImplicitCGGP(kernel=Matern32(), **kw)
    z, u, counts, xq = _problem()
    jparams = jmodel.init_params(z, pseudo_u=u, cluster_counts=counts, noise_variance=0.5,
                                 dtype=dtype)
    tparams = params_from_numpy(jparams, device="cpu")
    return jmodel, jparams, tmodel, tparams, xq


def _serve_both(precondition, use_pallas, threshold, dtype, relative=False):
    jmodel, jparams, tmodel, tparams, xq = _models(precondition, use_pallas, threshold,
                                                   dtype, relative)
    jx = jnp.asarray(xq, dtype)
    tx = torch.as_tensor(np.asarray(xq, dtype))
    before = (gram_matvec.launches, kuu_matvec.launches)
    jpost = jmodel.posterior(jparams, solver="cg")
    tpost = tmodel.posterior(tparams, solver="cg")
    pairs = {"nu": (tpost.nu, jpost.nu)}
    for name, t, j in (("predict_f", tmodel.predict_f(tparams, tx),
                        jmodel.predict_f(jparams, jx)),
                       ("predict", tmodel.posterior_predict(tpost, tx),
                        jmodel.posterior_predict(jpost, jx)),
                       ("predict_full_cov", tmodel.posterior_predict(tpost, tx, full_cov=True),
                        jmodel.posterior_predict(jpost, jx, full_cov=True)),
                       ("batched", predict_in_batches(tmodel, tparams, tx, batch_size=BATCH,
                                                      posterior_solver="cg"),
                        jax_predict_in_batches(jmodel, jparams, jx, batch_size=BATCH,
                                               posterior_solver="cg"))):
        pairs[f"{name}_mean"] = (t[0], j[0])
        pairs[f"{name}_var"] = (t[1], j[1])
    pairs["posterior_mean"] = (tmodel.posterior_mean(tpost, tx), jmodel.posterior_mean(jpost, jx))
    assert (gram_matvec.launches, kuu_matvec.launches) == before  # nothing launched on the CPU
    return {k: (t.numpy(), np.asarray(j)) for k, (t, j) in pairs.items()}


def _assert_pairs(pairs, **tol):
    for name, (got, want) in pairs.items():
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, err_msg=name, **tol)


@pytest.mark.parametrize("precondition", [None, "pivchol"])
def test_implicit_serving_float64_matches_jax(precondition):
    # float64 CG at the absolute threshold 1e-16 (just above the reference's
    # curvature-guard stall): each solve stops within sqrt(2e-16) / 0.125 ~
    # 1.1e-7 of the exact one; the two packages' outputs sit within 1e-8.
    pairs = _serve_both(precondition, False, 1e-16, jnp.float64)
    _assert_pairs(pairs, rtol=0, atol=1e-8)
    assert (pairs["predict_var"][0] >= 0).all()
    assert pairs["nu"][0].shape == (1, 64) and (pairs["nu"][0][:, M:] == 0).all()


@pytest.mark.parametrize("precondition", [None, "pivchol"])
def test_implicit_serving_float32_kernel_route_matches_jax_interpret(precondition,
                                                                     jax_interpret_gram):
    # Both packages' use_pallas routes in float32: the same tolerance the JAX
    # package holds its kernel route to against its blocked route
    # (tests/test_implicit_model.py), at a relative threshold float32 CG meets.
    pairs = _serve_both(precondition, True, 1e-10, jnp.float32, relative=True)
    _assert_pairs(pairs, rtol=1e-4, atol=1e-5)
    assert all(got.dtype == np.float32 for got, _ in pairs.values())


def test_init_params_pads_and_masks_like_jax():
    jmodel, jparams, tmodel, _, _ = _models(None, False, 1e-8, jnp.float64)
    z, u, counts, _ = _problem()
    tparams = tmodel.init_params(z, pseudo_u=u, cluster_counts=counts, noise_variance=0.5,
                                 dtype=torch.float64, device="cpu")
    carried = params_from_numpy(jparams, device="cpu")
    for key in ("inducing_points", "pseudo_u", "cluster_counts", "inducing_mask"):
        np.testing.assert_array_equal(tparams[key].numpy(), np.asarray(jparams[key]), key)
        assert torch.equal(carried[key], tparams[key]), key
    assert tparams["inducing_mask"].shape == (64, 1) and float(tparams["inducing_mask"].sum()) == M
    with_capacity = tmodel.init_params(z, pseudo_u=u, cluster_counts=counts, capacity=96,
                                       dtype=torch.float64, device="cpu")
    want = jmodel.init_params(z, pseudo_u=u, cluster_counts=counts, capacity=96,
                              dtype=jnp.float64)
    np.testing.assert_array_equal(with_capacity["inducing_points"].numpy(),
                                  np.asarray(want["inducing_points"]))
    for capacity in (40, 100):  # below the real count; not a block multiple
        with pytest.raises(ValueError):
            tmodel.init_params(z, capacity=capacity, device="cpu")


def test_auto_resolves_to_cg_and_chol_is_refused():
    _, _, tmodel, tparams, xq = _models("pivchol", False, 1e-16, jnp.float64)
    x = torch.as_tensor(xq)
    assert tmodel.resolve_serving_solver(tparams) == "cg"
    auto = predict_in_batches(tmodel, tparams, x, batch_size=BATCH)  # posterior_solver="auto"
    cg = predict_in_batches(tmodel, tparams, x, batch_size=BATCH, posterior_solver="cg")
    for a, b in zip(auto, cg):
        assert torch.equal(a, b)
    assert tmodel.posterior(tparams).chol is None  # "auto" -> "cg"
    with pytest.raises(ValueError, match="matrix-free"):
        tmodel.posterior(tparams, solver="chol")
    with pytest.raises(ValueError, match="matrix-free"):
        predict_in_batches(tmodel, tparams, x, posterior_solver="chol")
    with pytest.raises(ValueError):
        tmodel.posterior(tparams, solver="cholesky")


@pytest.mark.parametrize("call", ["lanczos", "rff", "elbo", "prior_kl", "cg_stats",
                                  "assign_clusters", "slq", "backward"])
def test_unported_parts_raise(call):
    """Named for the refusals of the serving slice; every case is ported now
    and runs here on the same padded system (their parity with JAX is
    tests/test_torch_implicit_training.py's, LOVE's
    tests/test_torch_love.py's)."""
    _, _, tmodel, tparams, xq = _models(None, False, 1e-10, jnp.float64)
    x = torch.as_tensor(xq)
    data = (x, x[:, :1])
    gen = torch.Generator().manual_seed(0)
    if call == "lanczos":
        # LOVE serving (it raised here before): exact means, variances at or
        # above the CG cache's (rank 64 = M_pad: the masked Krylov space
        # exhausts at the 50 real points, so they agree at 1e-8).
        love = tmodel.posterior(tparams, solver="lanczos")
        assert tuple(love.lanczos_r.shape) == (64, 64)
        got = tmodel.posterior_predict(love, x)
        want = tmodel.posterior_predict(tmodel.posterior(tparams, solver="cg"), x)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-8)
    elif call == "rff":
        rff = ImplicitCGGP(kernel=Matern32(), num_data=400, error_threshold=1e-16,
                           max_cg_iterations=200, block=BLOCK, precondition="rff",
                           precond_rank=8)
        exact = ImplicitCGGP(kernel=Matern32(), num_data=400, error_threshold=1e-16,
                             max_cg_iterations=200, block=BLOCK)
        np.testing.assert_allclose(rff.posterior(tparams, solver="cg").nu.numpy(),
                                   exact.posterior(tparams, solver="cg").nu.numpy(),
                                   rtol=0, atol=1e-8)
    elif call == "elbo":
        with pytest.raises(ValueError, match="generator"):
            tmodel.elbo(tparams, data)
        assert np.isfinite(float(tmodel.elbo(tparams, data, gen)))
    elif call == "prior_kl":
        assert np.isfinite(float(tmodel.prior_kl(tparams, gen)))
    elif call == "cg_stats":
        stats = tmodel.cg_stats(tparams, data, gen)
        assert bool(stats.converged) and 0 < int(stats.steps) < 200
    elif call == "assign_clusters":
        z, u, counts, _ = _problem(seed=1)
        new = tmodel.assign_clusters(tparams, z[:40], u[:40], counts[:40])
        assert new["inducing_points"].shape == (64, 3)  # 40 re-padded to the block multiple
        assert float(new["inducing_mask"].sum()) == 40
    elif call == "slq":
        slq = ImplicitCGGP(kernel=Matern32(), num_data=400, error_threshold=1e-10,
                           max_cg_iterations=200, block=BLOCK, logdet_variant="slq")
        assert np.isfinite(float(slq.elbo(tparams, data, gen)))
    else:
        ell = tparams["kernel"]["lengthscales"].clone().requires_grad_()
        live = {**tparams, "kernel": {**tparams["kernel"], "lengthscales": ell}}
        (grad,) = torch.autograd.grad(tmodel.posterior(live, solver="cg").nu.sum(), [ell])
        assert grad.shape == ell.shape and bool(torch.isfinite(grad).all())
    with pytest.raises(ValueError):
        ImplicitCGGP(kernel=Matern32(), logdet_variant="exact")


def test_committed_selection_metadata_and_separation():
    """The cover tree's guarantee: centres at least the resolution apart
    (checked in float64 through |a|^2 + |b|^2 - 2 a.b, whose roundoff at
    these magnitudes is ~1e-15)."""
    with np.load(SELECTION) as sel:
        meta = {k: float(sel[k]) for k in ("n", "dim", "seed", "res")}
        iv, u, counts = sel["iv"], sel["u"], sel["counts"]
    assert meta == {"n": 435_000.0, "dim": 3.0, "seed": 0.0, "res": 0.15}
    assert iv.shape == (9576, 3) and u.shape == (9576, 1) and counts.shape == (9576, 1)
    assert iv.dtype == u.dtype == counts.dtype == np.float32
    assert (counts >= 1).all() and float(counts.sum()) == 291_450  # the train split
    pts = iv.astype(np.float64)
    sq = np.sum(pts**2, axis=-1)
    closest = np.inf
    for start in range(0, pts.shape[0], 2048):
        block = pts[start:start + 2048]
        d2 = sq[start:start + 2048, None] + sq[None, :] - 2.0 * block @ pts.T
        d2[np.arange(block.shape[0]), start + np.arange(block.shape[0])] = np.inf
        closest = min(closest, float(d2.min()))
    assert np.sqrt(closest) >= 0.15
