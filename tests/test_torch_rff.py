"""The random-Fourier-feature preconditioner of the port (``ops/rff.py``):
the feature map and the scaled sketch against ``cggp_tpu.ops.rff`` given the
same frequencies, the port's own frequency draws against their spectral
densities, and ``precondition="rff"`` on the dense ``CGGP`` and on
``ImplicitCGGP`` leaving converged ELBOs where the unpreconditioned solves
put them (the JAX package's own check, rtol 1e-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from cggp_tpu.ops import kernels as jkernels
from cggp_tpu.ops import rff as jax_rff
from cggp_tpu_torch.models.cggp import CGGP
from cggp_tpu_torch.models.implicit import ImplicitCGGP
from cggp_tpu_torch.ops import kernels as tkernels
from cggp_tpu_torch.ops.cg import ConjugateGradient, SpectralPreconditioner
from cggp_tpu_torch.ops.rff import (basis_theta_parameter, basis_vectors, rff_basis,
                                    rff_preconditioner)

torch.set_num_threads(1)

KERNELS = ["se", "matern12", "matern32", "matern52"]
NU = {"matern12": 1, "matern32": 3, "matern52": 5}


def _kernel_pair(name, lengthscales=(0.7, 1.9, 1.1), variance=1.3):
    tk = tkernels.Kernel(name=name)
    jk = jkernels.Kernel(name=name)
    tkp = tk.init_params(variance, np.array(lengthscales), dtype=torch.float64, device="cpu")
    jkp = {k: jnp.asarray(v.numpy()) for k, v in tkp.items()}
    return tk, tkp, jk, jkp


@pytest.mark.parametrize("name", KERNELS)
def test_basis_vectors_and_rff_basis_match_jax_given_the_same_frequencies(name, monkeypatch):
    tk, tkp, jk, jkp = _kernel_pair(name)
    x = np.random.default_rng(0).uniform(-2, 2, (40, 3))
    theta = jax_rff.basis_theta_parameter(jk, jkp, 16, jax.random.PRNGKey(1))
    np.testing.assert_allclose(basis_vectors(torch.as_tensor(x), torch.as_tensor(
        np.array(theta))).numpy(), np.asarray(jax_rff.basis_vectors(jnp.asarray(x), theta)),
        rtol=0, atol=1e-13)
    import cggp_tpu_torch.ops.rff as trff_module

    monkeypatch.setattr(trff_module, "basis_theta_parameter",
                        lambda *args, **kw: torch.as_tensor(np.array(theta)))
    got = rff_basis(torch.as_tensor(x), tk, tkp, 16, torch.Generator())
    want = jax_rff.rff_basis(jnp.asarray(x), jk, jkp, 16, jax.random.PRNGKey(1))
    assert got.shape == (40, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-13)
    z = torch.as_tensor(x[:10])
    lam = torch.full((10,), 0.3, dtype=torch.float64)
    pre = rff_preconditioner(tk, tkp, z, lam, 16, torch.Generator())
    assert isinstance(pre, SpectralPreconditioner)
    jpre = jax_rff.rff_preconditioner(jk, jkp, jnp.asarray(x[:10]), jnp.asarray(lam.numpy()), 16,
                                      jax.random.PRNGKey(1))
    r = torch.randn(4, 10, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    want_z = jpre.apply(jpre.state, jnp.asarray(r.numpy()), None)[0]
    np.testing.assert_allclose(pre(r)[0].numpy(), np.asarray(want_z), rtol=1e-10, atol=1e-12)


# 20,000 frequencies per kernel.  Each coordinate times its lengthscale is
# standard normal (se) or Student-t with nu = 1, 3, 5 degrees of freedom
# (Matern nu/2).  Dvoretzky-Kiefer-Wolfowitz: the empirical CDF's largest
# gap from the true one exceeds sqrt(ln(2 / a) / (2 n)) with probability at
# most a; at a = 1e-6 that is 0.0190.  For se and Matern 5/2 (a finite
# fourth moment) the sample mean and variance too, at 5 standard errors:
# the mean within 5 sqrt(var / n), the variance within 5 sqrt((m4 - var^2) /
# n) (m4 = 3 for the normal, 25 for t_5, whose variance is 5/3).
N_DRAWS = 20_000
DKW_BOUND = np.sqrt(np.log(2 / 1e-6) / (2 * N_DRAWS))
MOMENTS = {"se": (1.0, 3.0), "matern52": (5.0 / 3.0, 25.0)}


@pytest.mark.parametrize("name", KERNELS)
def test_frequency_draws_follow_the_spectral_density(name):
    tk, tkp, _, _ = _kernel_pair(name)
    theta = basis_theta_parameter(tk, tkp, N_DRAWS, torch.Generator().manual_seed(7))
    assert theta.shape == (N_DRAWS, 3) and theta.dtype == torch.float64
    scaled = (theta * tk.lengthscales(tkp)).numpy()
    dist = stats.norm() if name == "se" else stats.t(df=NU[name])
    for j in range(3):
        gap = stats.kstest(scaled[:, j], dist.cdf).statistic
        assert gap <= DKW_BOUND, (j, gap)
    if name in MOMENTS:
        var, m4 = MOMENTS[name]
        assert np.abs(scaled.mean(axis=0)).max() <= 5 * np.sqrt(var / N_DRAWS)
        assert np.abs(scaled.var(axis=0) - var).max() <= 5 * np.sqrt((m4 - var ** 2) / N_DRAWS)
    # One generator seed, one draw; a scalar lengthscale needs ndim.
    again = basis_theta_parameter(tk, tkp, N_DRAWS, torch.Generator().manual_seed(7))
    assert torch.equal(theta, again)
    scalar = {"variance": tkp["variance"], "lengthscales": tkp["lengthscales"][0]}
    with pytest.raises(ValueError, match="ndim"):
        basis_theta_parameter(tk, scalar, 4, torch.Generator())
    assert basis_theta_parameter(tk, scalar, 4, torch.Generator(), ndim=2).shape == (4, 2)


def _problem(m=24, n=60):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (n, 2))
    y = np.sin(2 * x[:, :1]) + 0.1 * rng.standard_normal((n, 1))
    counts = rng.integers(1, 6, (m, 1)).astype(np.float64)
    return x[:m], rng.standard_normal((m, 1)), counts, (torch.as_tensor(x), torch.as_tensor(y))


def test_dense_cggp_rff_elbo_equals_the_unpreconditioned_one():
    iv, u, counts, data = _problem()
    values = {}
    for precondition in (None, "rff"):
        model = CGGP(kernel=tkernels.Matern32(), num_data=60, num_probes=4,
                     precondition=precondition, precond_rank=8,
                     conjugate_gradient=ConjugateGradient(1e-16, max_iterations=200))
        params = model.init_params(iv, pseudo_u=u, cluster_counts=counts, dtype=torch.float64,
                                   device="cpu")
        # The sketch draws after the probes: the probes stay the same.
        values[precondition] = float(model.elbo(params, data, torch.Generator().manual_seed(1)))
        if precondition:
            assert model.precond_state(params)[0].shape == (24, 16)  # rank 2L
    assert values["rff"] == pytest.approx(values[None], rel=1e-7)


def test_implicit_rff_elbo_equals_the_unpreconditioned_one():
    iv, u, counts, data = _problem()
    values, states = {}, {}
    for precondition in (None, "rff"):
        model = ImplicitCGGP(kernel=tkernels.Matern32(), num_data=60, num_probes=4,
                             error_threshold=1e-16, max_cg_iterations=200, block=8,
                             precondition=precondition, precond_rank=8)
        params = model.init_params(iv, pseudo_u=u, cluster_counts=counts, dtype=torch.float64,
                                   device="cpu")
        values[precondition] = float(model.elbo(params, data, torch.Generator().manual_seed(1)))
        states[precondition] = model.precond_state(params)
    assert values["rff"] == pytest.approx(values[None], rel=1e-7)
    # A fixed sketch (precond_seed), the same every step.
    again = ImplicitCGGP(kernel=tkernels.Matern32(), precondition="rff", precond_rank=8,
                         block=8).precond_state(params)
    for a, b in zip(states["rff"], again):
        assert torch.equal(a, b)
