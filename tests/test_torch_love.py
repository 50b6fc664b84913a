"""Port parity for LOVE serving (``posterior(solver="lanczos")``): the rank-k
Lanczos quadratic-form cache of ``ops/logdet.py`` and its use in the dense
``CGGP``, the matrix-free ``ImplicitCGGP`` and the exact ``IterGPR``,
against ``cggp_tpu`` on the CPU in float64, with parameters carried from the
JAX package by ``params_from_numpy``.

Tolerances: both packages run the same recurrence (full
reorthogonalisation, twice) on the same fp64 operator, so caches and served
variances agree to rounding: 1e-9 absolute on variances of order 1 and on
the rows of ``R``.  The means come from each package's own CG solve of
``nu`` (or ``alpha``) at absolute 1e-14, whose trajectories differ in
rounding: measured 1.9e-9 apart, held at 1e-7.  At rank = M the cache is
exact: ``||R k||^2`` equals ``k^T A^{-1} k`` (and the variances the
Cholesky ones) at 1e-8.  Below it
the Gauss quadrature under-estimates, so LOVE variances lie at or above the
exact ones (conservative) less 1e-10 of rounding.  Where the port's
``use_pallas`` route runs kernel B3's plain version (float32 on the CPU),
its variances are held to the JAX package's at 1e-4 (the float32 operator's
error carried through 20 Lanczos steps).  JAX's ``PRNGKey(0)`` start
vector is patched into the port's ``normal_draw`` where the zero-seed
fallback runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cggp_tpu.ops.pallas_gram as jax_pallas_gram
import cggp_tpu_torch.ops.logdet as tlogdet
from cggp_tpu.data import synthetic as jax_synthetic
from cggp_tpu.models.cggp import CGGP as JaxCGGP
from cggp_tpu.models.gpr import GPR as JaxGPR
from cggp_tpu.models.implicit import ImplicitCGGP as JaxImplicitCGGP
from cggp_tpu.models.itergpr import IterGPR as JaxIterGPR
from cggp_tpu.ops import logdet as jlogdet
from cggp_tpu.ops.cg import ConjugateGradient as JaxConjugateGradient
from cggp_tpu.ops.kernels import Matern32 as JaxMatern32
from cggp_tpu.training.optimize import predict_in_batches as jax_predict_in_batches
from cggp_tpu.utils.store import save_posterior as jax_save_posterior
from cggp_tpu_torch.models import CGGP, ImplicitCGGP, IterGPR
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.ops.kernels import Matern32
from cggp_tpu_torch.training.optimize import predict_in_batches
from cggp_tpu_torch.utils.store import load_posterior, params_from_numpy, save_posterior

torch.set_num_threads(1)

M, N_QUERY = 48, 40
ATOL = 1e-9
MEAN_ATOL = 1e-7
EXACT_RTOL = 1e-8


def _spd(m, seed=0, lam=0.1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (m, 3))
    r2 = np.sum((x[:, None] - x[None]) ** 2, -1) / 0.5 ** 2
    r = np.sqrt(3 * r2)
    return (1 + r) * np.exp(-r) + lam * np.eye(m), rng


def _jax_normal(shape, dtype):
    return torch.as_tensor(np.array(jax.random.normal(jax.random.PRNGKey(0), shape, dtype)))


@pytest.fixture
def jax_start(monkeypatch):
    """The port's normal start vectors replaced by JAX's PRNGKey(0) draws."""
    monkeypatch.setattr(tlogdet, "normal_draw",
                        lambda gen, shape, dtype: _jax_normal(tuple(shape), jnp.float64))


# -- the cache itself ---------------------------------------------------------------


@pytest.mark.parametrize("rank", [12, M, M + 16])
def test_love_cache_matches_jax_and_is_exact_at_full_rank(rank):
    """rank < M: R against JAX's; rank = M: exact quadratic forms; rank > M:
    the early-termination cut (JAX measured 1.7x inflated forms without it)
    keeps them exact and R's surplus rows zero."""
    a, rng = _spd(M)
    start = rng.standard_normal((1, M))
    probes = rng.standard_normal((M, 6))
    want = np.asarray(jlogdet.lanczos_quad_cache_rows(lambda r: r @ jnp.asarray(a),
                                                      jnp.asarray(start), rank))
    got = tlogdet.lanczos_quad_cache_rows(lambda r: r @ torch.as_tensor(a),
                                          torch.as_tensor(start), rank).numpy()
    assert got.shape == (rank, M)
    exact = np.sum(probes * np.linalg.solve(a, probes), 0)
    quad_got = np.sum((got @ probes) ** 2, 0)
    quad_want = np.sum((want @ probes) ** 2, 0)
    np.testing.assert_allclose(quad_got, quad_want, rtol=1e-9)
    assert np.all(quad_got <= exact * (1 + 1e-10))  # Gauss quadrature under-estimates
    if rank < M:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    else:
        np.testing.assert_allclose(quad_got, exact, rtol=EXACT_RTOL)
    if rank > M:
        assert np.all(got[M:] == 0.0)


def test_love_variance_and_seed_row_match_jax(jax_start):
    a, rng = _spd(M)
    r = rng.standard_normal((7, M))
    kmn_rows = rng.standard_normal((5, M))
    knn_diag = rng.uniform(1, 2, 5)
    knn_full = np.diag(knn_diag) + 0.01
    for knn, full in ((knn_diag, False), (knn_full, True)):
        want = np.asarray(jlogdet.love_variance(jnp.asarray(r), jnp.asarray(kmn_rows),
                                                jnp.asarray(knn), full))
        got = tlogdet.love_variance(torch.as_tensor(r), torch.as_tensor(kmn_rows),
                                    torch.as_tensor(knn), full).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    u = rng.standard_normal((1, M))
    mask = (np.arange(M) < M - 5).astype(np.float64)[None, :]
    for row, m in ((u, None), (np.zeros((1, M)), None), (np.zeros((1, M)), mask)):
        want = np.asarray(jlogdet.love_seed_row(jnp.asarray(row),
                                                None if m is None else jnp.asarray(m)))
        got = tlogdet.love_seed_row(torch.as_tensor(row),
                                    None if m is None else torch.as_tensor(m)).numpy()
        np.testing.assert_array_equal(got, want)


def test_lanczos_extremal_eigs_rows_matches_jax(jax_start):
    a, _ = _spd(M)
    mask = (np.arange(M) < M - 8).astype(np.float64)
    am = a * mask[:, None] * mask[None, :] + np.diag(0.1 * (1 - mask))
    want = jlogdet.lanczos_extremal_eigs_rows(lambda r: r @ jnp.asarray(am),
                                              jax.random.PRNGKey(0), M, jnp.float64,
                                              num_iters=20, mask=jnp.asarray(mask))
    got = tlogdet.lanczos_extremal_eigs_rows(lambda r: r @ torch.as_tensor(am),
                                             torch.Generator(), M, torch.float64,
                                             num_iters=20, mask=torch.as_tensor(mask))
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-10)


# -- the dense CGGP -----------------------------------------------------------------


def _dense_models(rank, zero_u=False):
    (x, y), (xt, _) = jax_synthetic(n=600, dim=3, seed=0)
    rng = np.random.default_rng(0)
    z = x[rng.choice(x.shape[0], M, replace=False)]
    u = np.zeros((M, 1)) if zero_u else y[rng.choice(y.shape[0], M, replace=False)]
    counts = rng.integers(1, 5, (M, 1)).astype(np.float64)
    kw = dict(num_data=400, serving_lanczos_rank=rank)
    jmodel = JaxCGGP(kernel=JaxMatern32(), conjugate_gradient=JaxConjugateGradient(1e-14),
                     **kw)
    tmodel = CGGP(kernel=Matern32(), conjugate_gradient=ConjugateGradient(1e-14), **kw)
    jparams = jmodel.init_params(z, pseudo_u=u, cluster_counts=counts, noise_variance=0.5,
                                 dtype=jnp.float64)
    return jmodel, jparams, tmodel, params_from_numpy(jparams, device="cpu"), xt[:N_QUERY]


@pytest.mark.parametrize("rank,zero_u", [(16, False), (M, False), (16, True)])
def test_dense_love_posterior_matches_jax(rank, zero_u, jax_start):
    jmodel, jparams, tmodel, tparams, xq = _dense_models(rank, zero_u)
    jpost = jmodel.posterior(jparams, solver="lanczos")
    tpost = tmodel.posterior(tparams, solver="lanczos")
    assert tpost.kmm_lambda is None and tpost.chol is None and tpost.precond_state == ()
    assert tuple(tpost.lanczos_r.shape) == (rank, M)
    np.testing.assert_allclose(tpost.lanczos_r.numpy(), np.asarray(jpost.lanczos_r),
                               rtol=0, atol=ATOL)
    chol = tmodel.posterior(tparams, solver="chol")
    for full_cov in (False, True):
        want = jmodel.posterior_predict(jpost, jnp.asarray(xq), full_cov=full_cov)
        got = tmodel.posterior_predict(tpost, torch.as_tensor(xq), full_cov=full_cov)
        exact = tmodel.posterior_predict(chol, torch.as_tensor(xq), full_cov=full_cov)
        for g, w, tol in zip(got, want, (MEAN_ATOL, ATOL)):
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)
        np.testing.assert_allclose(got[0].numpy(), exact[0].numpy(), rtol=0, atol=MEAN_ATOL)
        var, var_exact = got[1].numpy(), exact[1].numpy()
        if full_cov:
            var, var_exact = np.diagonal(var[0]), np.diagonal(var_exact[0])
        if rank == M and not zero_u:
            np.testing.assert_allclose(var, var_exact, rtol=0, atol=EXACT_RTOL)
        assert np.all(var >= var_exact - 1e-10)  # conservative


def test_dense_love_serves_through_predict_in_batches():
    """The LOVE cache is solve-free, so scan="auto" takes the sweep; the
    loop and the sweep give the same numbers, and JAX's."""
    jmodel, jparams, tmodel, tparams, xq = _dense_models(20)
    want = jax_predict_in_batches(jmodel, jparams, jnp.asarray(xq), batch_size=16,
                                  posterior_solver="lanczos")
    scan = predict_in_batches(tmodel, tparams, xq, batch_size=16, posterior_solver="lanczos")
    loop = predict_in_batches(tmodel, tparams, xq, batch_size=16, posterior_solver="lanczos",
                              scan=False)
    for s, lp, w, tol in zip(scan, loop, want, (MEAN_ATOL, ATOL)):
        assert tuple(s.shape) == (N_QUERY, 1)
        np.testing.assert_array_equal(s.numpy(), lp.numpy())
        np.testing.assert_allclose(s.numpy(), np.asarray(w), rtol=0, atol=tol)


# -- ImplicitCGGP (padded) -------------------------------------------------------------


@pytest.fixture
def jax_interpret_gram(monkeypatch):
    orig = jax_pallas_gram.kuu_matvec

    def interpreted(z_scaled, lam, p, variance, kernel_name="se", **kw):
        kw.update(interpret=True, block_n=16, block_m=16)
        return orig(z_scaled, lam, p, variance, kernel_name, **kw)

    monkeypatch.setattr(jax_pallas_gram, "kuu_matvec", interpreted)


def _implicit_models(rank, use_pallas=False, zero_u=False):
    (x, y), (xt, _) = jax_synthetic(n=600, dim=3, seed=0)
    rng = np.random.default_rng(1)
    m = 50  # padded to 64 with block 32
    z = x[rng.choice(x.shape[0], m, replace=False)]
    u = np.zeros((m, 1)) if zero_u else y[rng.choice(y.shape[0], m, replace=False)]
    counts = rng.integers(1, 5, (m, 1)).astype(np.float64)
    kw = dict(num_data=400, error_threshold=1e-14, max_cg_iterations=300, block=32,
              use_pallas=use_pallas, serving_lanczos_rank=rank)
    jmodel = JaxImplicitCGGP(kernel=JaxMatern32(), **kw)
    tmodel = ImplicitCGGP(kernel=Matern32(), **kw)
    jparams = jmodel.init_params(z, pseudo_u=u, cluster_counts=counts, noise_variance=0.5,
                                 dtype=jnp.float64)
    return jmodel, jparams, tmodel, params_from_numpy(jparams, device="cpu"), xt[:N_QUERY]


def _oracle_variance(tparams, xq):
    """The fp64 Cholesky posterior variance over the real inducing points."""
    from cggp_tpu_torch.models import ClusterGP
    mask = tparams["inducing_mask"][:, 0] > 0
    real = {**tparams, "inducing_points": tparams["inducing_points"][mask],
            "pseudo_u": tparams["pseudo_u"][mask],
            "cluster_counts": tparams["cluster_counts"][mask]}
    model = ClusterGP(kernel=Matern32())
    return model.posterior_predict(model.posterior(real), torch.as_tensor(xq))


@pytest.mark.parametrize("rank,zero_u", [(10, False), (64, False), (10, True)])
def test_implicit_love_posterior_matches_jax(rank, zero_u, jax_start):
    """Rank 64 is the padded M: the Krylov space of the masked seed exhausts
    at the 50 real points, so the cut leaves an exact cache.  R's pad
    columns are exactly zero."""
    jmodel, jparams, tmodel, tparams, xq = _implicit_models(rank, zero_u=zero_u)
    jpost = jmodel.posterior(jparams, solver="lanczos")
    tpost = tmodel.posterior(tparams, solver="lanczos")
    r = tpost.lanczos_r.numpy()
    pads = tparams["inducing_mask"][:, 0].numpy() == 0
    assert r.shape == (rank, 64) and pads.sum() == 14
    assert np.all(r[:, pads] == 0.0)
    np.testing.assert_allclose(r, np.asarray(jpost.lanczos_r), rtol=0, atol=ATOL)
    chol_mean, chol_var = _oracle_variance(tparams, xq)
    for full_cov in (False, True):
        want = jmodel.posterior_predict(jpost, jnp.asarray(xq), full_cov=full_cov)
        got = tmodel.posterior_predict(tpost, torch.as_tensor(xq), full_cov=full_cov)
        for g, w, tol in zip(got, want, (MEAN_ATOL, ATOL)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)
    var = got[1].numpy()[0].diagonal()
    np.testing.assert_allclose(got[0].numpy(), chol_mean.numpy(), rtol=0, atol=MEAN_ATOL)
    if rank == 64 and not zero_u:
        np.testing.assert_allclose(var, chol_var.numpy()[:, 0], rtol=0, atol=EXACT_RTOL)
    assert np.all(var >= chol_var.numpy()[:, 0] - 1e-10)


def test_implicit_love_kernel_route(jax_interpret_gram):
    """use_pallas=True: the port builds the cache through the solve route's
    matvec (kernel B3's plain version here, float32), JAX through its
    blocked fp64 matvec; the variances agree at 1e-4 and the pads stay
    exactly zero."""
    jmodel, jparams, tmodel, tparams, xq = _implicit_models(20, use_pallas=True)
    jpost = jmodel.posterior(jparams, solver="lanczos")
    tpost = tmodel.posterior(tparams, solver="lanczos")
    pads = tparams["inducing_mask"][:, 0].numpy() == 0
    assert np.all(tpost.lanczos_r.numpy()[:, pads] == 0.0)
    want = jmodel.posterior_predict(jpost, jnp.asarray(xq))
    got = tmodel.posterior_predict(tpost, torch.as_tensor(xq))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


# -- IterGPR -----------------------------------------------------------------------


def _itergpr_models(rank):
    rng = np.random.default_rng(3)
    n = 200  # padded to 256 with block 64
    x = rng.uniform(-1.5, 1.5, (n, 3))
    y = np.sin(x.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((n, 1))
    xq = rng.uniform(-1.5, 1.5, (N_QUERY, 3))
    kw = dict(error_threshold=1e-14, relative_threshold=False, max_cg_iterations=800,
              block=64, precondition=None, serving_lanczos_rank=rank)
    jmodel = JaxIterGPR(kernel=JaxMatern32(), **kw)
    tmodel = IterGPR(kernel=Matern32(), **kw)
    jparams = jmodel.init_params(3, noise_variance=0.1, lengthscales=np.array([0.5, 0.6, 0.7]),
                                 dtype=jnp.float64)
    return jmodel, jparams, tmodel, params_from_numpy(jparams, device="cpu"), (x, y), xq


@pytest.mark.parametrize("rank,chunked", [(24, False), (24, True), (256, False)])
def test_itergpr_love_matches_jax_and_dense_gpr(rank, chunked):
    """Rank 256 = N_pad: the Krylov space exhausts at the 200 real points
    and the cache is exact (variances equal the dense GPR's at 1e-8)."""
    jmodel, jparams, tmodel, tparams, (x, y), xq = _itergpr_models(rank)
    jdata = (jnp.asarray(x), jnp.asarray(y))
    if chunked:
        jpost = jmodel.posterior_chunked(jparams, jdata, solver="lanczos")
        tpost = tmodel.posterior_chunked(tparams, (x, y), solver="lanczos")
    else:
        jpost = jmodel.posterior(jparams, jdata, solver="lanczos")
        tpost = tmodel.posterior(tparams, (x, y), solver="lanczos")
    r = tpost.lanczos_r.numpy()
    assert r.shape == (rank, 256) and np.all(r[:, 200:] == 0.0)
    np.testing.assert_allclose(r, np.asarray(jpost.lanczos_r), rtol=0, atol=ATOL)
    dense = JaxGPR(kernel=JaxMatern32())
    dmean, dvar = dense.predict_f(jparams, jdata, jnp.asarray(xq))
    for full_cov in (False, True):
        want = jmodel.posterior_predict(jpost, jnp.asarray(xq), full_cov=full_cov)
        got = tmodel.posterior_predict(tpost, torch.as_tensor(xq), full_cov=full_cov)
        for g, w, tol in zip(got, want, (MEAN_ATOL, ATOL)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)
    var = got[1].numpy()[0].diagonal()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(dmean), rtol=0, atol=MEAN_ATOL)
    if rank == 256:
        np.testing.assert_allclose(var, np.asarray(dvar)[:, 0], rtol=0, atol=EXACT_RTOL)
    assert np.all(var >= np.asarray(dvar)[:, 0] - 1e-10)
    # A LOVE cache is solve-free: predict_in_batches sweeps it.
    got_b = predict_in_batches(tmodel, tparams, xq, batch_size=16, train_data=(x, y),
                               posterior=tpost)
    np.testing.assert_allclose(got_b[1].numpy()[:, 0], var, rtol=0, atol=1e-12)


# -- the store ---------------------------------------------------------------------


@pytest.mark.parametrize("family", ["dense", "implicit", "itergpr"])
def test_jax_love_cache_loads_and_serves_in_the_port(family, tmp_path):
    if family == "dense":
        jmodel, jparams, tmodel, tparams, xq = _dense_models(16)
        jpost = jmodel.posterior(jparams, solver="lanczos")
    elif family == "implicit":
        jmodel, jparams, tmodel, tparams, xq = _implicit_models(16)
        jpost = jmodel.posterior(jparams, solver="lanczos")
    else:
        jmodel, jparams, tmodel, tparams, (x, y), xq = _itergpr_models(16)
        jpost = jmodel.posterior(jparams, (jnp.asarray(x), jnp.asarray(y)), solver="lanczos")
    jax_save_posterior(tmp_path / "jax", jpost)
    post = load_posterior(tmp_path / "jax", device="cpu")
    assert post.lanczos_r is not None and tuple(post.lanczos_r.shape) == jpost.lanczos_r.shape
    want = jmodel.posterior_predict(jpost, jnp.asarray(xq))
    got = tmodel.posterior_predict(post, torch.as_tensor(xq))
    for g, w in zip(got, want):  # the same cache: rounding only
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    save_posterior(tmp_path / "port", post)
    again = load_posterior(tmp_path / "port", device="cpu")
    np.testing.assert_array_equal(again.lanczos_r.numpy(), post.lanczos_r.numpy())
