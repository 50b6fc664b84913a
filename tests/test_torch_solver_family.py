"""Port parity for the rest of the CG solver family and its helpers, against
``cggp_tpu`` on the CPU: the mixed-precision routes (``xla_high``,
``xla_bf16``, ``bf16_ir``, ``bf16_ru``) and the loops behind them
(``ir_cg_loop``, ``mixed_cg_loop``), ``dot="compensated"``, the bf16
envelope check, ``solve_chunked``, the compensated sums, the bordered
factor updates, ``pad_rows_to_blocks`` and ``ops/distance.py``.

Systems: ``bench.py``'s dense CG system cut to M = 256 (Matern32 over 8
dimensions at unit lengthscales, Lambda uniform in [0.05, 0.5], 4
right-hand sides), float32 as the bf16 routes are meant to run.

Tolerances.
* Solutions: within the distance the stop rule allows from the float64
  solve, ``2 sqrt(threshold) |b| / lambda_min`` per column (relative rule;
  the 2 covers a recursive residual's drift from the true one).
* CG steps: each package solves the system and five symmetric
  reorderings of it (the same system summed in other orders); the port's
  range of counts must meet JAX's range widened by max(3, 5 %).  One
  ordering's count is no yardstick: on this system (kappa ~ 2e3) JAX's own
  fp32 count moves by several steps under a reordering alone, and its bf16
  loops' adaptive rules move it further.
* ``xla_bf16``: finite iterates and an honest ``converged``, True exactly
  where the true residual meets the rule (JAX's flag reads the bf16
  recursion's residual; see ``ops/cg.py``).
* Float64 loop tests (``ir_cg_loop`` / ``mixed_cg_loop`` with a perturbed
  float64 "cheap" operator): the same spreads; solutions within the stop
  rule's distance.
* Compensated sums of float32 data: within 2 ulps of the float64 sum plus
  ``log2(n) eps^2 sum |x|`` (Kahan's bound), and JAX's within the same.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cggp_tpu_torch.ops.logdet as tlogdet
from cggp_tpu.ops import cg as jcg
from cggp_tpu.ops import distance as jdistance
from cggp_tpu.ops import linalg as jlinalg
from cggp_tpu.ops.kernels import Matern32 as JaxMatern32
from cggp_tpu_torch.ops import cg as tcg
from cggp_tpu_torch.ops import distance as tdistance
from cggp_tpu_torch.ops import linalg as tlinalg
from cggp_tpu_torch.ops.kernels import Matern32
from cggp_tpu_torch.utils.store import params_from_numpy

torch.set_num_threads(1)

M, RHS = 256, 4
EPS32 = float(np.finfo(np.float32).eps)


def _system(lam=(0.05, 0.5), m=M, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (m, d)).astype(np.float32)
    kern = JaxMatern32()
    kp = kern.init_params(1.0, np.ones(d, np.float32), dtype=jnp.float32)
    a = np.asarray(kern.K(kp, jnp.asarray(x))) + np.diag(rng.uniform(*lam, m))
    b = rng.standard_normal((m, RHS))
    return a.astype(np.float32), b.astype(np.float32)


A32, B32 = _system()
EXACT = np.linalg.solve(A32.astype(np.float64), B32.astype(np.float64))
LAMBDA_MIN = float(np.linalg.eigvalsh(A32.astype(np.float64))[0])


def _bound(rel, b=B32):
    return 2.0 * np.sqrt(rel) * np.linalg.norm(b.astype(np.float64), axis=0) / LAMBDA_MIN


ORDERINGS = 6


def _orderings(m=M):
    """The identity and symmetric reorderings: the same system, summed in
    other orders."""
    return [np.arange(m)] + [np.random.default_rng(s).permutation(m)
                             for s in range(1, ORDERINGS)]


def _both_steps(jax_solve, port_solve, arrays):
    """Each package's steps over the orderings of ``arrays`` (each permuted
    along its system axes), and both packages' unpermuted outputs."""
    jsteps, tsteps, first = [], [], None
    for perm in _orderings(arrays[0].shape[0]):
        permuted = [x[perm][:, perm] if x.ndim == 2 and x.shape[0] == x.shape[1] == M
                    else x[perm] for x in arrays]
        jout = jax_solve(*[jnp.asarray(x) for x in permuted])
        tout = port_solve(*[torch.as_tensor(np.ascontiguousarray(x)) for x in permuted])
        jsteps.append(int(jout[1].steps))
        tsteps.append(int(tout[1].steps))
        if first is None:
            first = (jout, tout)
    return first, jsteps, tsteps


def _overlap(tsteps, jsteps):
    """The port's spread meets JAX's, widened by max(3, 5 %)."""
    lo, hi = min(jsteps), max(jsteps)
    return (min(tsteps) <= hi + max(3, 0.05 * hi)) and (max(tsteps) >= lo - max(3, 0.05 * lo))


def _route_solvers(impl, rel, dot="standard", chunked=False):
    kw = dict(relative_threshold=True, matvec_impl=impl, dot=dot, max_iterations=1000)
    jcg_, tcg_ = jcg.ConjugateGradient(rel, **kw), tcg.ConjugateGradient(rel, **kw)
    if chunked:
        return (lambda a, b: jcg_.solve_chunked(a, b, chunk_iterations=8),
                lambda a, b: tcg_.solve_chunked(a, b, chunk_iterations=8))
    # JAX's production path is jitted (the envelope check passes through).
    return jax.jit(jcg_.solve_with_stats), tcg_.solve_with_stats


@pytest.mark.parametrize("impl,dot", [("xla", "standard"), ("xla", "compensated"),
                                      ("xla_high", "standard"), ("bf16_ir", "standard"),
                                      ("bf16_ru", "standard")])
@pytest.mark.parametrize("rel", [1e-4, 1e-6])
def test_route_matches_jax(impl, dot, rel):
    ((jx, jstats), (got, stats)), jsteps, tsteps = _both_steps(
        *_route_solvers(impl, rel, dot), (A32, B32))
    assert got.dtype == torch.float32
    assert bool(stats.converged) and bool(jstats.converged)
    assert _overlap(tsteps, jsteps), (tsteps, jsteps)
    err = np.linalg.norm(got.numpy().astype(np.float64) - EXACT, axis=0)
    jerr = np.linalg.norm(np.asarray(jx, np.float64) - EXACT, axis=0)
    assert np.all(err <= _bound(rel)) and np.all(jerr <= _bound(rel))


@pytest.mark.parametrize("rel", [1e-2, 1e-6])
def test_xla_bf16_floors_and_reports_honestly(rel):
    """No refinement: the bf16 recursion's residual keeps falling while the
    true one floors; ``converged`` reads the true residual."""
    ((jx, jstats), (got, stats)), jsteps, tsteps = _both_steps(
        *_route_solvers("xla_bf16", rel), (A32, B32))
    assert bool(torch.all(torch.isfinite(got)))
    assert _overlap(tsteps, jsteps), (tsteps, jsteps)
    b64 = B32.astype(np.float64)

    def meets(x):
        true_r = b64 - A32.astype(np.float64) @ np.asarray(x, np.float64)
        return bool(np.all(0.5 * np.sum(true_r ** 2, 0) <= rel * 0.5 * np.sum(b64 ** 2, 0)))

    assert bool(stats.converged) == meets(got.numpy())
    assert meets(got.numpy()) == (rel == 1e-2)  # the floor lies between the two targets
    # JAX's flag reads the bf16 recursion: True below the true floor too.
    assert bool(jstats.converged) and meets(jx) == (rel == 1e-2)


def _loop_problem():
    """A float64 system and a symmetric perturbation of it as the cheap
    operator (relative 1e-3, well inside the refinement's envelope)."""
    a = A32.astype(np.float64)
    e = np.random.default_rng(3).standard_normal((M, M)) * 1e-3
    return a, a + (e + e.T) / 2 * np.abs(a).max() / np.sqrt(M), B32.T.astype(np.float64)


@pytest.mark.parametrize("loop", ["ir_cg_loop", "mixed_cg_loop"])
@pytest.mark.parametrize("rel", [1e-6, 1e-10])
def test_mixed_precision_loops_match_jax(loop, rel):
    a, a_lo, b = _loop_problem()

    def jax_solve(a, a_lo, b):
        return getattr(jcg, loop)(lambda p: p @ a, lambda p: p @ a_lo,
                                  jcg.EyePreconditioner().apply, (), b.T, jnp.zeros_like(b.T),
                                  error_threshold=rel, max_iterations=1000,
                                  relative_threshold=True)

    def port_solve(a, a_lo, b):
        return getattr(tcg, loop)(lambda p: p @ a, lambda p: p @ a_lo,
                                  tcg.EyePreconditioner().apply, (), b.T, torch.zeros_like(b.T),
                                  error_threshold=rel, max_iterations=1000,
                                  relative_threshold=True)

    (jrun, (got, stats)), jsteps, tsteps = _both_steps(jax.jit(jax_solve), port_solve,
                                                       (a, a_lo, b.T))
    assert _overlap(tsteps, jsteps), (tsteps, jsteps)
    assert bool(stats.converged) and bool(jrun[1].converged)
    exact = np.linalg.solve(a, b.T).T
    bound = np.sqrt(rel) * np.linalg.norm(b, axis=1) / LAMBDA_MIN
    for v in (got.numpy(), np.asarray(jrun[0])):
        assert np.all(np.linalg.norm(v - exact, axis=1) <= bound)


def test_ir_loop_keeps_to_the_iteration_budget():
    a, a_lo, b = _loop_problem()
    ta, ta_lo = torch.as_tensor(a), torch.as_tensor(a_lo)
    _, stats = tcg.ir_cg_loop(lambda p: p @ ta, lambda p: p @ ta_lo,
                              tcg.EyePreconditioner().apply, (), torch.as_tensor(b),
                              torch.zeros_like(torch.as_tensor(b)), error_threshold=1e-14,
                              max_iterations=25, relative_threshold=True)
    assert int(stats.steps) <= 25 and not bool(stats.converged)


def _envelope_case(lam):
    a, _ = _system(lam=(lam, lam) if np.isscalar(lam) else lam, d=3)
    return a


@pytest.mark.parametrize("impl", ["bf16_ir", "bf16_ru"])
def test_bf16_envelope_check(impl, monkeypatch):
    """Inside the envelope (Lambda >= 0.05) the route stays; at Lambda = 2e-4
    the bf16 perturbation (2^-8 max|A_offdiag| ~ 3.9e-3) exceeds lambda_min:
    both packages warn and resolve to "xla_high".  JAX's PRNGKey(0) start
    vector is patched in, so the Lanczos estimates agree."""
    monkeypatch.setattr(tlogdet, "normal_draw", lambda gen, shape, dtype: torch.as_tensor(
        np.array(jax.random.normal(jax.random.PRNGKey(0), tuple(shape), jnp.float32))).to(dtype))
    for lam, want in (((0.05, 0.5), impl), (2e-4, "xla_high")):
        a = _envelope_case(lam)
        jsolver = jcg.ConjugateGradient(1e-6, matvec_impl=impl)
        tsolver = tcg.ConjugateGradient(1e-6, matvec_impl=impl)
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            jgot = jsolver.check_bf16_envelope(jnp.asarray(a))
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            tgot = tsolver.check_bf16_envelope(torch.as_tensor(a))
            again = tsolver.check_bf16_envelope(torch.as_tensor(a))  # another object
        assert jgot == tgot == again == want
        warned = [w for w in tw if issubclass(w.category, RuntimeWarning)]
        assert len(warned) == (2 if want == "xla_high" else 0)
        assert len([w for w in jw if issubclass(w.category, RuntimeWarning)]) == len(warned) // 2
    # A fallen-back solve runs on "xla_high" and converges.
    a = torch.as_tensor(_envelope_case(2e-4))
    with pytest.warns(RuntimeWarning, match="xla_high"):
        _, stats = tcg.ConjugateGradient(1e-6, relative_threshold=True, matvec_impl=impl,
                                         max_iterations=2000).solve_with_stats(
            a, torch.as_tensor(B32))
    assert bool(stats.converged)


def test_bf16_envelope_on_the_cover_tree_training_system():
    """The committed e2e selection (M = 989) at init parameters, Lambda =
    0.1 / counts >= 1.8e-4: its Lanczos lambda_min estimate (1.7e-2) exceeds
    the rule's bf16 perturbation (3.9e-3), so both packages keep the bf16
    route (though the bf16 rounding's 2-norm, 2.1e-2, does not)."""
    from pathlib import Path

    from cggp_tpu_torch.models import CGGP
    from cggp_tpu_torch.ops.linalg import add_diagonal

    sel = np.load(Path(__file__).resolve().parent.parent / "benchmarks"
                  / "e2e_selection_covertree.npz")
    model = CGGP(kernel=Matern32(), conjugate_gradient=tcg.ConjugateGradient(1e-8))
    params = model.init_params(sel["iv"], pseudo_u=sel["u"], cluster_counts=sel["counts"],
                               dtype=torch.float32, device="cpu")
    a = add_diagonal(Matern32().K(params["kernel"], params["inducing_points"]),
                     model.diag_variance(params)[:, 0])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want = jcg.ConjugateGradient(1e-6, matvec_impl="bf16_ir").check_bf16_envelope(
            jnp.asarray(a.numpy()))
        got = tcg.ConjugateGradient(1e-6, matvec_impl="bf16_ir").check_bf16_envelope(a)
    assert got == want == "bf16_ir"
    # Yet the bf16 rounding's 2-norm exceeds lambda_min, which the rule's
    # eps_bf16 * max|A_offdiag| does not see (ROADMAP Queue C).
    a64 = a.double()
    rounded = a.to(torch.bfloat16).double()
    rounded.diagonal().copy_(a64.diagonal())
    lam_min = float(torch.linalg.eigvalsh(a64)[0])
    rule = 2.0 ** -8 * float((a64 - torch.diag(a64.diagonal())).abs().max())
    assert rule < lam_min < float(torch.linalg.matrix_norm(rounded - a64, 2))


@pytest.mark.parametrize("impl", ["xla", "bf16_ir"])
def test_solve_chunked_matches_jax(impl):
    """``steps`` is an upper bound on the carried path, so only
    ``converged`` and the solution are compared, and the steps' spreads."""
    rel = 1e-6
    ((jx, jstats), (got, stats)), jsteps, tsteps = _both_steps(
        *_route_solvers(impl, rel, chunked=True), (A32, B32))
    assert bool(stats.converged) == bool(jstats.converged) is True
    assert tuple(stats.error.shape) == (RHS, 1)
    for v in (got.numpy(), np.asarray(jx)):
        assert np.all(np.linalg.norm(v.astype(np.float64) - EXACT, axis=0) <= _bound(rel))
    if impl == "xla":
        assert all(k % 8 == 0 for k in tsteps)
    assert _overlap(tsteps, jsteps), (tsteps, jsteps)


# -- helpers ------------------------------------------------------------------------


def test_compensated_sum_and_dot_against_fp64_and_jax():
    rng = np.random.default_rng(7)
    n = 1000
    # Wide dynamic range with heavy cancellation: plain fp32 sums lose digits.
    x = (rng.standard_normal((6, n)) * 10.0 ** rng.uniform(-4, 4, (6, n))).astype(np.float32)
    y = rng.standard_normal((6, n)).astype(np.float32)
    exact_sum = x.astype(np.float64).sum(-1)
    prod = (x * y).astype(np.float32)  # the fp32 products both packages sum
    exact_dot = prod.astype(np.float64).sum(-1)
    got_sum = tlinalg.compensated_sum(torch.as_tensor(x)).numpy().astype(np.float64)
    got_dot = tlinalg.compensated_dot(torch.as_tensor(x), torch.as_tensor(y))[:, 0].numpy()
    jsum = np.asarray(jlinalg.compensated_sum(jnp.asarray(x))).astype(np.float64)
    jdot = np.asarray(jlinalg.compensated_dot(jnp.asarray(x), jnp.asarray(y)))[:, 0]
    for got, want, data in ((got_sum, exact_sum, x), (got_dot, exact_dot, prod),
                            (jsum, exact_sum, x), (jdot, exact_dot, prod)):
        tol = 2 * EPS32 * np.abs(want) + np.log2(n) * EPS32 ** 2 * np.abs(data).astype(
            np.float64).sum(-1)
        assert np.all(np.abs(got.astype(np.float64) - want) <= tol)
    plain = torch.as_tensor(x).sum(-1).numpy().astype(np.float64)
    assert np.abs(plain - exact_sum).max() > np.abs(got_sum - exact_sum).max()
    # keepdim over another axis, and two_sum's exactness.
    ks = tlinalg.compensated_sum(torch.as_tensor(x), dim=0, keepdim=True)
    assert tuple(ks.shape) == (1, n)
    a, b = torch.tensor([1e8], dtype=torch.float32), torch.tensor([1.0 + 2 ** -20],
                                                                   dtype=torch.float32)
    s, e = tlinalg.two_sum(a, b)
    assert float(s.double() + e.double()) == float(a.double() + b.double())


def test_bordered_cholesky_updates_against_a_full_factor_and_jax():
    a = A32.astype(np.float64)[:96, :96]
    m = 80
    l11 = np.linalg.cholesky(a[:m, :m])
    got = tlinalg.chol_extend(torch.as_tensor(l11), torch.as_tensor(a[m:, :m]),
                              torch.as_tensor(a[m:, m:])).numpy()
    want = np.asarray(jlinalg.chol_extend(jnp.asarray(l11), jnp.asarray(a[m:, :m]),
                                          jnp.asarray(a[m:, m:])))
    np.testing.assert_allclose(got, np.linalg.cholesky(a), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    w11 = np.linalg.inv(l11)
    tw = tlinalg.triangular_inv_extend(torch.as_tensor(w11), torch.as_tensor(got[m:, :m]),
                                       torch.as_tensor(got[m:, m:])).numpy()
    jw = np.asarray(jlinalg.triangular_inv_extend(jnp.asarray(w11), jnp.asarray(got[m:, :m]),
                                                  jnp.asarray(got[m:, m:])))
    np.testing.assert_allclose(tw, np.linalg.inv(got), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-12)
    # A Schur complement that is not positive definite gives a NaN block.
    bad = tlinalg.chol_extend(torch.as_tensor(l11), torch.as_tensor(a[m:, :m]),
                              torch.as_tensor(-a[m:, m:])).numpy()
    assert np.isnan(bad[m:, m:]).any() and np.isfinite(bad[:m, :m]).all()


@pytest.mark.parametrize("n,block", [(10, 4), (8, 4), (3, 8), (0, 4), (5, 0)])
def test_pad_rows_to_blocks_matches_jax(n, block):
    x = np.arange(n * 3, dtype=np.float64).reshape(n, 3)
    got = tlinalg.pad_rows_to_blocks(torch.as_tensor(x), block).numpy()
    want = np.asarray(jlinalg.pad_rows_to_blocks(jnp.asarray(x), block))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", list(tdistance.DistanceType))
def test_distance_functions_match_jax(kind):
    assert tdistance.DistanceType == jdistance.DistanceType
    kern = JaxMatern32()
    jkp = kern.init_params(1.3, np.array([0.5, 0.8, 1.1]), dtype=jnp.float64)
    tkp = params_from_numpy(jkp, device="cpu")
    rng = np.random.default_rng(2)
    x, y = rng.standard_normal((2, 50, 3))
    want = jdistance.create_distance_fn(kern, jkp, kind)((jnp.asarray(x), jnp.asarray(y)))
    got = tdistance.create_distance_fn(Matern32(), tkp, kind)((torch.as_tensor(x),
                                                                torch.as_tensor(y)))
    assert tuple(got.shape) == (50,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
