"""Port parity for the dense log-det estimators (``cggp_tpu_torch/ops/logdet.py``)
against the JAX package's on the same numpy inputs and the same Rademacher
probes: ``eval_logdet`` (identity and probes, masked), ``eval_logdet_from_solves``,
``slq_logdet`` (value and gradient) and ``lanczos_extremal_eigs`` (against
``eigvalsh``).  The port's ``rademacher`` is replaced, where the estimators
look it up, by one that returns the arrays ``jax.random.rademacher`` draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cggp_tpu.ops import logdet as jlogdet
from cggp_tpu.ops.cg import ConjugateGradient as JaxConjugateGradient
from cggp_tpu.ops.kernels import Matern32 as JaxMatern32
from cggp_tpu_torch.ops import logdet as tlogdet
from cggp_tpu_torch.ops.cg import ConjugateGradient

torch.set_num_threads(1)

N, P = 20, 4
THRESHOLD = 1e-16  # float64, just above the reference's 1e-16 curvature guard


def _matrix():
    """``K + diag(lam)``: Matern32 at lengthscale 0.8 over 20 points in
    [-2, 2]^3, lam in [0.1, 0.4]; lambda_min >= 0.1."""
    rng = np.random.default_rng(5)
    z = rng.uniform(-2.0, 2.0, (N, 3))
    kernel = JaxMatern32()
    k = np.asarray(kernel.K(kernel.init_params(1.0, 0.8 * np.ones(3), dtype=jnp.float64),
                            jnp.asarray(z)))
    return k + np.diag(rng.uniform(0.1, 0.4, N))


def _jax_probes(key, num_probes=P):
    return np.array(jax.random.rademacher(key, (N, num_probes), dtype=jnp.float64))


@pytest.fixture
def fed_probes(monkeypatch):
    """Make the port's estimators draw the given arrays, in call order."""

    def feed(*arrays):
        queue = [torch.as_tensor(np.array(a)) for a in arrays]
        monkeypatch.setattr(tlogdet, "rademacher", lambda gen, shape, dtype: queue.pop(0))
        return queue

    return feed


def _grad_jax(fn, a):
    value, grad = jax.value_and_grad(fn)(jnp.asarray(a))
    return float(value), np.asarray(grad)


def _grad_torch(fn, a):
    t = torch.as_tensor(a).requires_grad_()
    value = fn(t)
    value.backward()
    return float(value.detach()), t.grad.numpy()


# Two float64 CG runs at 1e-16 on this system: measured <= 3e-16 apart
# relative to the largest gradient entry; held at 1e-10.
GRAD_RTOL = 1e-10


def _assert_close(got, want, rtol=GRAD_RTOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("num_probes,masked", [(None, False), (P, False), (P, True)])
def test_eval_logdet_matches_jax(fed_probes, num_probes, masked):
    a = _matrix()
    key = jax.random.PRNGKey(3)
    mask = (np.arange(N) < N - 3).astype(np.float64) if masked else None
    queue = fed_probes(_jax_probes(key)) if num_probes else fed_probes()

    def jfn(m):
        return 2.0 * jlogdet.eval_logdet(m, JaxConjugateGradient(THRESHOLD), num_probes=num_probes,
                                         key=key, mask=None if mask is None else jnp.asarray(mask))

    def tfn(m):
        return 2.0 * tlogdet.eval_logdet(m, ConjugateGradient(THRESHOLD), num_probes=num_probes,
                                         key=torch.Generator(),
                                         mask=None if mask is None else torch.as_tensor(mask))

    jval, jgrad = _grad_jax(jfn, a)
    tval, tgrad = _grad_torch(tfn, a)
    assert jval == tval == 0.0 and not queue
    _assert_close(tgrad, jgrad)
    if num_probes is None:  # the exact gradient 2 A^{-1}, within the stop rule's
        # 2 sqrt(2e-16) / 0.1 ~ 3e-7 (measured 1e-8)
        np.testing.assert_allclose(tgrad, 2.0 * np.linalg.inv(a), rtol=0, atol=1e-6)


def test_eval_logdet_refusals():
    a = torch.as_tensor(_matrix())
    with pytest.raises(ValueError, match="num_probes"):
        tlogdet.eval_logdet(a, ConjugateGradient(THRESHOLD), mask=torch.ones(N))
    with pytest.raises(ValueError, match="generator"):
        tlogdet.eval_logdet(a, ConjugateGradient(THRESHOLD), num_probes=P)


def test_eval_logdet_from_solves_matches_jax():
    a = _matrix()
    probes = _jax_probes(jax.random.PRNGKey(4))
    solved = np.linalg.solve(a, probes)
    jval, jgrad = _grad_jax(lambda m: 3.0 * jlogdet.eval_logdet_from_solves(
        m, jnp.asarray(probes), jnp.asarray(solved)), a)
    tval, tgrad = _grad_torch(lambda m: 3.0 * tlogdet.eval_logdet_from_solves(
        m, torch.as_tensor(probes), torch.as_tensor(solved)), a)
    assert jval == tval == 0.0
    # One product of the same float64 arrays: roundoff.
    np.testing.assert_allclose(tgrad, jgrad, rtol=0, atol=1e-14)
    np.testing.assert_allclose(tgrad, 3.0 * solved @ probes.T / P, rtol=0, atol=1e-14)


@pytest.mark.parametrize("masked", [False, True])
def test_slq_logdet_matches_jax(fed_probes, masked):
    a = _matrix()
    key = jax.random.PRNGKey(6)
    mask = (np.arange(N) < N - 3).astype(np.float64) if masked else None
    fed_probes(_jax_probes(key))

    def jfn(m):
        return jlogdet.slq_logdet(m, JaxConjugateGradient(THRESHOLD), num_probes=P, key=key,
                                  lanczos_iters=12,
                                  mask=None if mask is None else jnp.asarray(mask))

    def tfn(m):
        return tlogdet.slq_logdet(m, ConjugateGradient(THRESHOLD), num_probes=P,
                                  key=torch.Generator(), lanczos_iters=12,
                                  mask=None if mask is None else torch.as_tensor(mask))

    jval, jgrad = _grad_jax(jfn, a)
    tval, tgrad = _grad_torch(tfn, a)
    # The same Lanczos recurrence and 12 x 12 eigh in float64: measured
    # 1.5e-15 apart; held at 1e-12 relative.
    assert tval == pytest.approx(jval, rel=1e-12)
    _assert_close(tgrad, jgrad)


def test_lanczos_tridiag_matches_jax():
    a = _matrix()
    v0 = np.random.default_rng(7).standard_normal(N)
    jal, jbe = jlogdet._lanczos_tridiag(jnp.asarray(a), jnp.asarray(v0), 15)
    tal, tbe = tlogdet._lanczos_tridiag(torch.as_tensor(a), torch.as_tensor(v0), 15)
    # Full reorthogonalisation keeps the float64 recurrences ~1e-15 apart.
    np.testing.assert_allclose(tal.numpy(), np.asarray(jal), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tbe.numpy(), np.asarray(jbe), rtol=0, atol=1e-12)


@pytest.mark.parametrize("num_iters", [8, N])
def test_lanczos_extremal_eigs_against_eigvalsh(num_iters):
    a = _matrix()
    exact = np.linalg.eigvalsh(a)
    lo, hi = tlogdet.lanczos_extremal_eigs(torch.as_tensor(a),
                                           torch.Generator().manual_seed(0), num_iters=num_iters)
    lo, hi = float(lo), float(hi)
    # Ritz values lie inside the spectrum (roundoff aside).  After 8 steps
    # on this 20 x 20 spectrum both ends within 1e-3 relative (measured
    # 1.9e-5 for eig_min, 1.2e-6 for eig_max); after 20 steps (the whole
    # Krylov space) within 1e-8 (measured 1.2e-15).
    assert exact[0] - 1e-10 <= lo and hi <= exact[-1] + 1e-10
    rtol = 1e-8 if num_iters == N else 1e-3
    np.testing.assert_allclose([lo, hi], [exact[0], exact[-1]], rtol=rtol)


def test_ritz_extremes_after_early_termination_matches_jax():
    # A Krylov space exhausted after 3 steps (beta = 0): the unused rows take
    # a Rayleigh quotient on the diagonal in both packages.
    alphas = np.array([2.0, 1.0, 3.0, 0.0, 0.0])
    betas = np.array([0.5, 0.4, 0.0, 0.0])
    jlo, jhi = jlogdet._ritz_extremes(jnp.asarray(alphas), jnp.asarray(betas))
    tlo, thi = tlogdet._ritz_extremes(torch.as_tensor(alphas), torch.as_tensor(betas))
    np.testing.assert_allclose([float(tlo), float(thi)], [float(jlo), float(jhi)], rtol=1e-14)


def test_rademacher_draws_signs_on_the_generators_device():
    gen = torch.Generator().manual_seed(0)
    probes = tlogdet.rademacher(gen, (500, 3), torch.float32)
    assert probes.dtype == torch.float32 and probes.shape == (500, 3)
    assert set(np.unique(probes.numpy())) == {-1.0, 1.0}
    again = tlogdet.rademacher(torch.Generator().manual_seed(0), (500, 3), torch.float32)
    assert torch.equal(probes, again)
