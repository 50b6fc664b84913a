"""Port parity: kernels, bijectors and the Cholesky oracle of cggp_tpu_torch
against cggp_tpu, in float64 on the CPU (same numpy inputs to both)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cggp_tpu.models.clustergp import ClusterGP as JaxClusterGP
from cggp_tpu.ops import kernels as jk
from cggp_tpu.ops.bijectors import positive as jax_positive
from cggp_tpu_torch.models.clustergp import ClusterGP
from cggp_tpu_torch.ops import kernels as tk
from cggp_tpu_torch.ops.bijectors import positive
from cggp_tpu_torch.utils.store import params_from_numpy

torch.set_num_threads(1)

KERNELS = ["se", "matern12", "matern32", "matern52"]
# float64 on both sides: the only differences are summation orders inside
# the [N, D] x [D, M] cross term, so agreement is at float64 roundoff.
RTOL, ATOL = 1e-12, 1e-13


def _points(seed, n, m, d=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, (n, d))
    z = np.concatenate([x[:4], rng.uniform(-2.0, 2.0, (m - 4, d))])  # r = 0 pairs
    ell = rng.uniform(0.5, 1.5, (d,))
    return x, z, ell


def test_scaled_squared_distance_matches_jax():
    x, z, _ = _points(0, 64, 40)
    want = np.asarray(jk.scaled_squared_distance(jnp.asarray(x), jnp.asarray(z)))
    got = tk.scaled_squared_distance(torch.as_tensor(x), torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[:4, :4].diagonal() == 0.0).all()  # clamped at 0, never negative


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_value_from_r2_matches_jax(name):
    r2 = np.concatenate([[0.0, 1e-40, 1e-12], np.random.default_rng(1).uniform(0, 9, 61)])
    want = np.asarray(jk.kernel_value_from_r2(name, jnp.asarray(r2), jnp.asarray(1.7)))
    got = tk.kernel_value_from_r2(name, torch.as_tensor(r2), torch.tensor(1.7, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", KERNELS)
def test_gram_and_diag_match_jax(name):
    # At r = 0 the cross term leaves r2 at float64 roundoff (~1e-15) with a
    # package-dependent sign; matern12's exp(-sqrt(r2)) turns that into
    # ~sqrt(1e-15) = 3e-8.  The smooth kernels keep the float64 tolerance.
    atol = 2e-7 if name == "matern12" else ATOL
    x, z, ell = _points(2, 50, 30)
    jkern, tkern = jk.kernel_by_name(name), tk.kernel_by_name(name)
    jparams = jkern.init_params(variance=0.8, lengthscales=ell, dtype=jnp.float64)
    tparams = params_from_numpy(jparams, device="cpu")
    for args in [(x, z), (z, None)]:
        jargs = [None if a is None else jnp.asarray(a) for a in args]
        targs = [None if a is None else torch.as_tensor(a) for a in args]
        np.testing.assert_allclose(tkern.K(tparams, *targs).numpy(),
                                   np.asarray(jkern.K(jparams, *jargs)), rtol=RTOL, atol=atol)
    np.testing.assert_allclose(tkern.K_diag(tparams, torch.as_tensor(x)).numpy(),
                               np.asarray(jkern.K_diag(jparams, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


def test_kernel_init_params_match_jax():
    _, _, ell = _points(3, 8, 8)
    jparams = jk.Matern32().init_params(variance=2.5, lengthscales=ell, dtype=jnp.float64)
    tparams = tk.Matern32().init_params(variance=2.5, lengthscales=ell, dtype=torch.float64,
                                        device="cpu")
    for key in ("variance", "lengthscales"):
        np.testing.assert_allclose(tparams[key].numpy(), np.asarray(jparams[key]),
                                   rtol=1e-13, atol=0)


def test_kernel_by_name_and_validation():
    assert tk.kernel_by_name("RBF") == tk.SquaredExponential()
    with pytest.raises(ValueError):
        tk.kernel_by_name("cosine")
    with pytest.raises(ValueError):
        tk.Kernel("cosine")


@pytest.mark.parametrize("lower", [0.0, 1e-6])
def test_positive_forward_inverse_match_jax(lower):
    y = np.array([1e-30, 1e-6, 3e-6, 0.1, 1.0, 30.0, 1e3])
    jb, tb = jax_positive(lower), positive(lower)
    raw = tb.inverse(torch.as_tensor(y))
    np.testing.assert_allclose(raw.numpy(), np.asarray(jb.inverse(jnp.asarray(y))),
                               rtol=1e-12, atol=1e-300)
    x = np.linspace(-40.0, 40.0, 33)
    np.testing.assert_allclose(tb.forward(torch.as_tensor(x)).numpy(),
                               np.asarray(jb.forward(jnp.asarray(x))), rtol=1e-13, atol=0)


def test_clustergp_predict_f_matches_jax():
    """The Cholesky oracle: ClusterGP.predict_f, mean and both variances."""
    rng = np.random.default_rng(4)
    z = rng.uniform(-2, 2, (24, 2))
    u = rng.standard_normal((24, 1))
    counts = rng.integers(1, 40, (24, 1)).astype(np.float64)
    x = rng.uniform(-2, 2, (40, 2))
    jmodel = JaxClusterGP(kernel=jk.Matern32())
    jparams = jmodel.init_params(z, pseudo_u=u, cluster_counts=counts, dtype=jnp.float64)
    tmodel = ClusterGP(kernel=tk.Matern32())
    tparams = params_from_numpy(jparams, device="cpu")
    for full_cov in (False, True):
        jm, jv = jmodel.predict_f(jparams, jnp.asarray(x), full_cov=full_cov)
        tm, tv = tmodel.predict_f(tparams, torch.as_tensor(x), full_cov=full_cov)
        # Cholesky solves of a kappa ~1e4 system: float64 roundoff times kappa.
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("eigs", [(1e-3, 10.0), (1e-7, 10.0), (0.0, 1.0), (float("nan"), 1.0)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_chol_or_cg_from_eigs_matches_jax(eigs, dtype):
    from cggp_tpu.models.base import chol_or_cg_from_eigs as jax_policy
    from cggp_tpu_torch.models.base import chol_or_cg_from_eigs

    assert chol_or_cg_from_eigs(*eigs, getattr(torch, dtype)) == jax_policy(*eigs, getattr(jnp, dtype))
