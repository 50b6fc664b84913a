"""Port parity for kernel B2 (``pallas_cg_solve``) and the CG solver routes:
the port on CPU tensors against the JAX package, whose Pallas kernels run in
interpret mode.  The CUDA kernel itself is held against its plain version on
the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cggp_tpu.ops.cg import ConjugateGradient as JaxConjugateGradient
from cggp_tpu.ops.kernels import SquaredExponential as JaxSE
from cggp_tpu.ops.linalg import add_diagonal as jax_add_diagonal
from cggp_tpu.ops.pallas_cg import pallas_cg_solve as jax_pallas_cg_solve
from cggp_tpu_torch.ops.cg import ConjugateGradient, EyePreconditioner, conjugate_gradient
from cggp_tpu_torch.ops.pallas_cg import pallas_cg_solve

torch.set_num_threads(1)


def _system(seed, m=70, r=5, dtype=np.float32):
    """An SE Gram matrix plus a diagonal shift (as tests/test_pallas_cg.py)."""
    rng = np.random.default_rng(seed)
    kernel = JaxSE()
    kp = kernel.init_params(dtype=jnp.float64)
    z = jnp.asarray(rng.uniform(-1, 1, (m, 2)))
    lam = jnp.asarray(rng.uniform(0.2, 0.6, (m,)))
    a = np.asarray(jax_add_diagonal(kernel.K(kp, z), lam)).astype(dtype)
    rhs = rng.standard_normal((r, m)).astype(dtype)
    return a, rhs


# CG amplifies rounding: on these systems two correct fp32 (or fp64) runs
# whose sums differ only in order drift apart ~10x per iteration before the
# iterates converge (measured against a numpy CG of the same recurrence).
# So iterates are compared once converged, within what the stop rule pins:
# 0.5 |r|^2 <= thr puts each solution within sqrt(2 thr) / lambda_min of the
# exact one, and lambda_min >= 0.2 here (a PSD Gram plus a shift >= 0.2).
# An early stop is held to the stop rule and the step count instead.
# Thresholds stay >= 1e-16: below that the reference's absolute 1e-16
# curvature guard (gamma = 0 once p.pA <= 1e-16) stalls both packages.


def _cg_tol(threshold):
    return 2.0 * np.sqrt(2.0 * threshold) / 0.2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pallas_cg_solve_matches_jax_interpret(seed):
    a, rhs = _system(seed)
    want, want_steps = jax_pallas_cg_solve(jnp.asarray(a), jnp.asarray(rhs), 1e-10, 256,
                                           interpret=True)
    got, got_steps = pallas_cg_solve(torch.as_tensor(a), torch.as_tensor(rhs), 1e-10, 256)
    assert got_steps.dtype == torch.int32 and got_steps.shape == ()
    # The sums run in other orders (JAX pads M to 128), which can move the
    # last stop-rule test by one iteration.
    assert abs(int(got_steps) - int(want_steps)) <= 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=_cg_tol(1e-10))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pallas_cg_solve_early_stop_matches_jax_interpret(seed):
    a, rhs = _system(seed)
    _, want_steps = jax_pallas_cg_solve(jnp.asarray(a), jnp.asarray(rhs), 1e-2, 256,
                                        interpret=True)
    got, got_steps = pallas_cg_solve(torch.as_tensor(a), torch.as_tensor(rhs), 1e-2, 256)
    assert abs(int(got_steps) - int(want_steps)) <= 1
    # The stop rule held on the recursive residual; the true residual of the
    # returned solution sits within fp32 drift of it.
    residual = rhs.astype(np.float64) - got.numpy().astype(np.float64) @ a
    assert (0.5 * np.sum(residual ** 2, axis=-1)).max() <= 1.01e-2


def test_pallas_cg_solve_threshold_stops_early():
    a, rhs = (torch.as_tensor(t) for t in _system(0))
    _, loose = pallas_cg_solve(a, rhs, 1e-2, 256)
    _, tight = pallas_cg_solve(a, rhs, 1e-10, 256)
    assert 0 < int(loose) < int(tight) <= 256


def test_pallas_cg_solve_cap_and_zero_rows():
    a, rhs = _system(3, m=40, r=4)
    rhs[1] = 0.0  # a zero row stays zero and never holds the others back
    want, want_steps = jax_pallas_cg_solve(jnp.asarray(a), jnp.asarray(rhs), 1e-12, 7,
                                           interpret=True)
    got, got_steps = pallas_cg_solve(torch.as_tensor(a), torch.as_tensor(rhs), 1e-12, 7)
    assert int(got_steps) == int(want_steps) == 7
    assert not got[1].any()
    # Seven unconverged fp32 iterations: rounding drift ~1e-7 * 10^5 (see above).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2, atol=1e-2)


def test_pallas_cg_solve_refuses_bad_operands():
    a, rhs = (torch.as_tensor(t) for t in _system(0, m=16, r=2))
    with pytest.raises(TypeError):
        pallas_cg_solve(a.double(), rhs.double(), 1e-6, 10)
    with pytest.raises(ValueError):
        pallas_cg_solve(a, rhs[:, :8].contiguous(), 1e-6, 10)
    with pytest.raises(ValueError):
        pallas_cg_solve(a, rhs.T, 1e-6, 10)


# ConjugateGradient routes: (matvec_impl, dtype, threshold, relative).
ROUTES = [
    ("xla", np.float64, 1e-16, False),
    ("xla", np.float32, 1e-8, False),
    ("pallas", np.float32, 1e-8, False),
    ("pallas_resident", np.float32, 1e-8, False),
    # Not eligible for the resident kernel (relative threshold): both
    # packages take the "xla" loop.  0.5 |b|^2 <= 8 here, so the absolute
    # target stays <= 8e-16.
    ("pallas_resident", np.float64, 1e-16, True),
]


@pytest.mark.parametrize("impl,dtype,threshold,relative", ROUTES)
def test_conjugate_gradient_routes_match_jax(impl, dtype, threshold, relative):
    a, rhs = _system(5, m=40, r=3, dtype=dtype)
    cols = rhs.T.copy()  # the facade is column-major: [n, m]
    jcg = JaxConjugateGradient(threshold, matvec_impl=impl, relative_threshold=relative,
                               max_iterations=80)
    with pltpu.force_tpu_interpret_mode():
        want, want_stats = jcg.solve_with_stats(jnp.asarray(a), jnp.asarray(cols))
    tcg = ConjugateGradient(threshold, matvec_impl=impl, relative_threshold=relative,
                            max_iterations=80)
    got, stats = tcg.solve_with_stats(torch.as_tensor(a), torch.as_tensor(cols))
    assert got.dtype == torch.as_tensor(cols).dtype
    tol = _cg_tol(threshold * (8.0 if relative else 1.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)
    assert abs(int(stats.steps) - int(want_stats.steps)) <= 1  # see the kernel test
    assert bool(stats.converged) == bool(want_stats.converged)
    np.testing.assert_allclose(stats.error.numpy(), np.asarray(want_stats.error),
                               rtol=0.5, atol=threshold)
    if relative:  # the ineligible solve took the port's own "xla" loop
        xla, _ = ConjugateGradient(threshold, relative_threshold=True,
                                   max_iterations=80).solve_with_stats(
            torch.as_tensor(a), torch.as_tensor(cols))
        assert torch.equal(got, xla)


def test_conjugate_gradient_restart_and_initial_solution_match_jax():
    """max_steps_cycle < max_iterations (the exact-residual restart, which
    also makes "pallas_resident" ineligible) and a nonzero v0."""
    from cggp_tpu.ops.cg import conjugate_gradient as jax_conjugate_gradient

    a, rhs = _system(6, m=30, r=2, dtype=np.float64)
    v0 = np.random.default_rng(6).standard_normal(rhs.shape)
    want, want_stats = jax_conjugate_gradient(jnp.asarray(a), jnp.asarray(rhs), jnp.asarray(v0),
                                              1e-16, max_iterations=60, max_steps_cycle=7,
                                              matvec_impl="pallas_resident")
    got, stats = conjugate_gradient(torch.as_tensor(a), torch.as_tensor(rhs), torch.as_tensor(v0),
                                    1e-16, max_iterations=60, max_steps_cycle=7,
                                    matvec_impl="pallas_resident")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=_cg_tol(1e-16))
    assert abs(int(stats.steps) - int(want_stats.steps)) <= 1


def test_pallas_resident_initial_solution_matches_jax():
    """The shifted system (v0 + d) A = b of the resident route, at a
    threshold well above where fp32 CG stagnates on this system (near that
    floor the two packages' step counts scatter by +-2)."""
    from cggp_tpu.ops.cg import conjugate_gradient as jax_conjugate_gradient

    a, rhs = _system(7, m=40, r=3)
    v0 = (0.1 * np.random.default_rng(7).standard_normal(rhs.shape)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, want_stats = jax_conjugate_gradient(
            jnp.asarray(a), jnp.asarray(rhs), jnp.asarray(v0), 1e-6, max_iterations=80,
            max_steps_cycle=81, matvec_impl="pallas_resident")
    got, stats = conjugate_gradient(torch.as_tensor(a), torch.as_tensor(rhs), torch.as_tensor(v0),
                                    1e-6, max_iterations=80, max_steps_cycle=81,
                                    matvec_impl="pallas_resident")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=_cg_tol(1e-6))
    assert abs(int(stats.steps) - int(want_stats.steps)) <= 1
    assert bool(stats.converged) == bool(want_stats.converged)


@pytest.mark.parametrize("kwargs", [
    {"matvec_impl": "xla_high"},
    {"matvec_impl": "bf16_ir"},
    {"matvec_impl": "typo"},
    {"dot": "compensated"},
    {"preconditioner": object()},
])
def test_unported_switches_raise(kwargs):
    with pytest.raises(NotImplementedError):
        ConjugateGradient(1e-6, **kwargs)


def test_gradients_through_cg_raise():
    a, rhs = (torch.as_tensor(t, dtype=torch.float64) for t in _system(0, m=8, r=1))
    a.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        conjugate_gradient(a, rhs, torch.zeros_like(rhs), 1e-8)
    with torch.no_grad():
        conjugate_gradient(a, rhs, torch.zeros_like(rhs), 1e-8)
    assert EyePreconditioner().state == ()
