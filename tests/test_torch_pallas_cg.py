"""Port parity for kernel B2 (``pallas_cg_solve``) and the CG solver routes:
the port on CPU tensors against the JAX package, whose Pallas kernels run in
interpret mode, and the 3xTF32 emulation of the kernel's tiled path
(``pallas_cg_solve_3xtf32_emulated``) against the same.  The CUDA kernel
itself is held against its plain version on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cggp_tpu.ops.cg import ConjugateGradient as JaxConjugateGradient
from cggp_tpu.ops.kernels import SquaredExponential as JaxSE
from cggp_tpu.ops.linalg import add_diagonal as jax_add_diagonal
from cggp_tpu.ops.pallas_cg import pallas_cg_solve as jax_pallas_cg_solve
from cggp_tpu_torch.ops.cg import ConjugateGradient, conjugate_gradient
from cggp_tpu_torch import tracing
from cggp_tpu_torch.ops.pallas_cg import (PATHS, pallas_cg_solve,
                                           pallas_cg_solve_3xtf32_emulated)

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


# The 3xTF32 emulation against JAX interpret: (m, r, threshold,
# max_iterations, rhs).  Twelve converged solves at the serving threshold
# 1e-8, an early stop, a zero cap and an all-zero rhs.
EMULATION_CASES = ([(m, r, 1e-8, 512, "normal") for m in (33, 130, 257) for r in (1, 5, 9, 130)]
                   + [(130, 9, 1e-2, 512, "normal"), (130, 9, 1e-8, 0, "normal"),
                      (130, 9, 1e-8, 512, "zero")])


@pytest.mark.parametrize("m,r,threshold,max_iterations,rhs_kind", EMULATION_CASES)
def test_pallas_cg_solve_3xtf32_emulated_matches_jax_interpret(m, r, threshold, max_iterations,
                                                               rhs_kind):
    a, rhs = _system(m + r, m=m, r=r)
    if rhs_kind == "zero":
        rhs[:] = 0.0
    want, want_steps = jax_pallas_cg_solve(jnp.asarray(a), jnp.asarray(rhs), threshold,
                                           max_iterations, interpret=True)
    got, got_steps = pallas_cg_solve_3xtf32_emulated(torch.as_tensor(a), torch.as_tensor(rhs),
                                                     threshold, max_iterations)
    want = np.asarray(want)
    assert got_steps.dtype == torch.int32 and got_steps.shape == () and got.shape == (r, m)
    if max_iterations == 0 or rhs_kind == "zero":
        # No step is taken (the cap, or every row already meets the stop
        # rule): both return v0 = 0 exactly.
        assert int(got_steps) == int(want_steps) == 0
        assert not got.any() and not want.any()
        return
    if threshold >= 1e-2:
        # An early stop, far above fp32 rounding: the same step (or one
        # apart), and the stop rule holds for the returned solution.
        assert abs(int(got_steps) - int(want_steps)) <= 1
        residual = rhs.astype(np.float64) - got.numpy().astype(np.float64) @ a
        assert (0.5 * np.sum(residual ** 2, axis=-1)).max() <= 1.01 * threshold
        return
    # Converged at 1e-8: fp32 CG runs whose sums differ in order cross the
    # threshold a few steps apart on these systems (the plain fp32 loop and
    # JAX interpret, over these twelve shapes with two seeds each: up to 5
    # steps of ~40), so the steps are held to max(3, 15 %) of JAX's, and
    # both solutions to the stop rule's bound of the fp64 solve and so of
    # each other.
    assert abs(int(got_steps) - int(want_steps)) <= max(3, 0.15 * int(want_steps))
    exact = np.linalg.solve(a.astype(np.float64), rhs.astype(np.float64).T).T
    tol = _cg_tol(threshold)
    assert np.abs(got.numpy() - exact).max() <= tol and np.abs(want - exact).max() <= tol
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_pallas_cg_solve_3xtf32_emulated_pseudo_u_matches_jax_at_m989():
    """The full pseudo-u solve of the dense serving workload (the committed
    M = 989 selection, Matern32 at init parameters, absolute threshold
    1e-8): JAX's pallas_cg_solve in interpret mode takes 255 steps, the
    emulation 250, the plain fp32 loop 249 (on a CPU); the steps are held
    to max(3, 2 %) of JAX's and the solution to chip_smoke.py's B2 gate,
    2e-3 of max |v|."""
    from cggp_tpu_torch.data import synthetic
    from cggp_tpu_torch.models.cggp import CGGP
    from cggp_tpu_torch.ops.kernels import Matern32
    from cggp_tpu_torch.ops.linalg import add_diagonal

    root = Path(__file__).resolve().parent.parent
    with np.load(root / "benchmarks" / "e2e_selection_covertree.npz") as sel:
        iv, u, counts = sel["iv"], sel["u"], sel["counts"]
    (x_train, _), _ = synthetic(n=435_000, dim=3, seed=0)
    model = CGGP(kernel=Matern32(), num_data=x_train.shape[0],
                 conjugate_gradient=ConjugateGradient(1e-8))
    params = model.init_params(iv, pseudo_u=u, cluster_counts=counts, dtype=torch.float32,
                               device="cpu")
    a = add_diagonal(Matern32().K(params["kernel"], params["inducing_points"]),
                     model.diag_variance(params)[:, 0]).contiguous()
    b = params["pseudo_u"].T.contiguous()
    m = a.shape[0]
    assert m == 989
    want, want_steps = jax_pallas_cg_solve(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), 1e-8,
                                           m, interpret=True)
    got, got_steps = pallas_cg_solve_3xtf32_emulated(a, b, 1e-8, m)
    assert int(want_steps) == 255
    assert abs(int(got_steps) - int(want_steps)) <= max(3, 0.02 * int(want_steps))
    exact = np.linalg.solve(a.double().numpy(), b.double().numpy().T).T
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-3 * np.abs(exact).max()


def test_pallas_cg_solve_refuses_bad_operands():
    a, rhs = (torch.as_tensor(t) for t in _system(0, m=16, r=2))
    with pytest.raises(TypeError):
        pallas_cg_solve(a.double(), rhs.double(), 1e-6, 10)
    with pytest.raises(ValueError):
        pallas_cg_solve(a, rhs[:, :8].contiguous(), 1e-6, 10)
    with pytest.raises(ValueError):
        pallas_cg_solve(a, rhs.T, 1e-6, 10)



def test_launches_by_path_counts_kernel_launches_only():
    """One counter per plan path, beside the total; the plain loop that CPU
    tensors take launches nothing, so it counts nothing and records no path
    on the solve's span."""
    assert PATHS == ("tiled", "small_resident", "small_streamed")
    assert set(pallas_cg_solve.launches_by_path) == set(PATHS)
    before = dict(pallas_cg_solve.launches_by_path), pallas_cg_solve.launches
    a, rhs = (torch.as_tensor(t) for t in _system(0, m=16, r=2))
    with tracing.recording() as rec:
        with tracing.solve_span(rhs, 16, "pallas_resident") as span:
            _, steps = pallas_cg_solve(a, rhs, 1e-6, 10)
            span.attrs["steps"] = steps
    assert (dict(pallas_cg_solve.launches_by_path), pallas_cg_solve.launches) == before
    assert rec.summary()["solve_paths"] == {}

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
    {"matvec_impl": "xla_bf16"},
])
def test_unported_switches_raise(kwargs):
    """Named for the refusals of the first slices: only a route neither
    package has still raises.  The mixed-precision routes and the
    compensated dot are ported (their parity with JAX is
    tests/test_torch_solver_family.py's): each solves a system well inside
    the bf16 envelope (lambda = 0.5) to its rule, xla_bf16 (no refinement;
    its flag reads the true residual) to a rule above its floor (relative
    1e-2 on 0.5 |r|^2), and lands within that rule's distance of the exact
    solution (|r| / lambda_min)."""
    if kwargs.get("matvec_impl") == "typo":
        with pytest.raises(NotImplementedError):
            ConjugateGradient(1e-6, **kwargs)
        return
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (64, 3))
    r = np.sqrt(3 * np.sum((x[:, None] - x[None]) ** 2, -1))
    a = (1 + r) * np.exp(-r) + 0.5 * np.eye(64)
    b = rng.standard_normal((64, 3))
    rel = 1e-2 if kwargs.get("matvec_impl") == "xla_bf16" else 1e-12
    cg = ConjugateGradient(rel, relative_threshold=True, **kwargs)
    got, stats = cg.solve_with_stats(torch.as_tensor(a), torch.as_tensor(b))
    assert bool(stats.converged)
    exact = np.linalg.solve(a, b)
    bound = np.sqrt(2 * rel * 0.5 * np.sum(b ** 2, 0)) / 0.5
    assert np.all(np.linalg.norm(got.numpy() - exact, axis=0) <= bound)
