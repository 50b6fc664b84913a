"""Port parity for the differentiable dense CG solve: the port's autograd
Function (``_CGDense``: forward ``_cg_dense_impl``, backward a second CG
solve on the same route) against ``jax.vjp`` of the JAX package's
``conjugate_gradient`` on the same numpy inputs, on each route and under
each preconditioner; a ``gradcheck`` of the Function; the Cholesky
preconditioner's fall-back to the identity.  The JAX kernels of the
``"pallas"`` and ``"pallas_resident"`` routes run in Pallas interpret mode;
the port's run their plain versions on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cggp_tpu.ops import cg as jcg
from cggp_tpu.ops.kernels import Matern32 as JaxMatern32
from cggp_tpu_torch.ops import cg as tcg

torch.set_num_threads(1)

M, R, RANK = 24, 3, 6
ROUTES = ("xla", "pallas", "pallas_resident")
PRECONDITIONERS = ("eye", "block", "nystrom", "chol", "pivchol", "spectral")


def _system(dtype):
    """``K + diag(lam)`` from Matern32 at lengthscale 0.7 over 24 points in
    [-2, 2]^3, lam in [0.1, 0.4] (lambda_min >= 0.1), rows ``b`` and a
    cotangent ``dx`` from a seeded generator, plus a rank-6 factor of K."""
    rng = np.random.default_rng(0)
    z = rng.uniform(-2.0, 2.0, (M, 3))
    kernel = JaxMatern32()
    kp = kernel.init_params(1.0, 0.7 * np.ones(3), dtype=jnp.float64)
    k = np.asarray(kernel.K(kp, jnp.asarray(z)))
    lam = rng.uniform(0.1, 0.4, M)
    b = rng.standard_normal((R, M))
    dx = rng.standard_normal((R, M))
    factor = np.linalg.cholesky(k + 1e-9 * np.eye(M))[:, :RANK]
    blocks = rng.permutation(M).reshape(4, 6)
    cast = np.float64 if dtype == "float64" else np.float32
    return {"k": k.astype(cast), "lam": lam.astype(cast), "a": (k + np.diag(lam)).astype(cast),
            "b": b.astype(cast), "dx": dx.astype(cast), "factor": factor.astype(cast),
            "blocks": blocks}


def _preconditioners(name, s):
    """The same preconditioner in both packages."""
    if name == "eye":
        return jcg.EyePreconditioner(), tcg.EyePreconditioner()
    if name == "block":
        return jcg.BlockPreconditioner(s["blocks"]), tcg.BlockPreconditioner(s["blocks"])
    if name == "nystrom":
        return (jcg.NystromPreconditioner(jnp.asarray(s["factor"]), jnp.asarray(s["lam"])),
                tcg.NystromPreconditioner(torch.as_tensor(s["factor"]), torch.as_tensor(s["lam"])))
    if name == "chol":
        return (jcg.CholPreconditioner(jnp.asarray(s["k"]), jnp.asarray(s["lam"])),
                tcg.CholPreconditioner(torch.as_tensor(s["k"]), torch.as_tensor(s["lam"])))
    if name == "pivchol":
        return (jcg.pivoted_cholesky_preconditioner(jnp.asarray(s["k"]), jnp.asarray(s["lam"]),
                                                    RANK),
                tcg.pivoted_cholesky_preconditioner(torch.as_tensor(s["k"]),
                                                    torch.as_tensor(s["lam"]), RANK))
    return (jcg.SpectralPreconditioner(jnp.asarray(s["factor"]), jnp.asarray(s["lam"])),
            tcg.SpectralPreconditioner(torch.as_tensor(s["factor"]), torch.as_tensor(s["lam"])))


def _both(route, precond, dtype, threshold):
    s = _system(dtype)
    jpre, tpre = _preconditioners(precond, s)
    kw = dict(max_iterations=3 * M, max_steps_cycle=3 * M + 1, matvec_impl=route)

    def jax_solve(a, b):
        return jcg.conjugate_gradient(a, b, jnp.zeros_like(b), threshold, preconditioner=jpre,
                                      **kw)

    @jax.jit  # one compile for the forward and backward solves
    def jax_vjp(a, b, dx):
        sol, vjp, stats = jax.vjp(jax_solve, a, b, has_aux=True)
        return sol, stats, *vjp(dx)

    with pltpu.force_tpu_interpret_mode():
        jsol, jstats, jda, jdb = jax_vjp(jnp.asarray(s["a"]), jnp.asarray(s["b"]),
                                         jnp.asarray(s["dx"]))
    a = torch.as_tensor(s["a"]).requires_grad_()
    b = torch.as_tensor(s["b"]).requires_grad_()
    tsol, tstats = tcg.conjugate_gradient(a, b, torch.zeros_like(b), threshold,
                                          preconditioner=tpre, **kw)
    tsol.backward(torch.as_tensor(s["dx"]))
    return {"solution": (tsol.detach().numpy(), np.asarray(jsol)),
            "dA": (a.grad.numpy(), np.asarray(jda)), "db": (b.grad.numpy(), np.asarray(jdb)),
            "steps": (int(tstats.steps), int(jstats.steps)),
            "converged": (bool(tstats.converged), bool(jstats.converged))}


@pytest.mark.parametrize("precond", PRECONDITIONERS)
@pytest.mark.parametrize("route", ROUTES)
def test_cg_vjp_matches_jax(route, precond):
    if route == "xla":
        # float64 at 1e-16, just above where the reference's absolute 1e-16
        # curvature guard stalls CG: the two packages' solutions and VJPs
        # measured <= 3.2e-14 apart relative to their largest entry, with
        # equal steps; held at 1e-10.
        dtype, threshold, rtol, max_steps_gap = "float64", 1e-16, 1e-10, 0
    else:
        # The kernel routes compute the matvec (B1) or the whole solve (B2)
        # in float32 in both packages, at 1e-8: measured <= 1.9e-6 apart
        # relative, with equal steps; held at 1e-4 and a step, since two
        # float32 loops summing in other orders may cross the threshold a
        # step apart.
        dtype, threshold, rtol, max_steps_gap = "float32", 1e-8, 1e-4, 1
    out = _both(route, precond, dtype, threshold)
    for name in ("solution", "dA", "db"):
        got, want = out[name]
        assert got.shape == want.shape and np.isfinite(got).all(), name
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale, err_msg=name)
    assert abs(out["steps"][0] - out["steps"][1]) <= max_steps_gap, out["steps"]
    assert out["converged"][0] and out["converged"][1]


def test_cg_vjp_is_not_symmetrised_and_db_is_a_solve():
    # dA = -solution^T db exactly (JAX does not symmetrise it), db = A^{-1} dx.
    s = _system("float64")
    a = torch.as_tensor(s["a"]).requires_grad_()
    b = torch.as_tensor(s["b"]).requires_grad_()
    sol, _ = tcg.conjugate_gradient(a, b, torch.zeros_like(b), 1e-16, max_iterations=3 * M)
    sol.backward(torch.as_tensor(s["dx"]))
    db = np.linalg.solve(s["a"], s["dx"].T).T
    # The stop rule 0.5 |r|^2 <= 1e-16 leaves db within sqrt(2e-16) / 0.1
    # ~ 1.4e-7 of the exact solve.
    np.testing.assert_allclose(b.grad.numpy(), db, rtol=0, atol=1.5e-7)
    np.testing.assert_allclose(a.grad.numpy(), -sol.detach().numpy().T @ b.grad.numpy(),
                               rtol=0, atol=1e-14)
    assert not np.allclose(a.grad.numpy(), a.grad.numpy().T)


def test_cg_facade_gradients_match_jax():
    # The column-major facade under a Cholesky preconditioner, gradient of a
    # scalar of the solution with respect to the matrix and the rhs columns.
    s = _system("float64")
    jpre, tpre = _preconditioners("chol", s)

    def jloss(a, b):
        return jnp.sum(jnp.sin(jcg.ConjugateGradient(1e-16, preconditioner=jpre)(a, b)))

    jga, jgb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(s["a"]), jnp.asarray(s["b"].T))
    a = torch.as_tensor(s["a"]).requires_grad_()
    b = torch.as_tensor(s["b"].T.copy()).requires_grad_()
    torch.sum(torch.sin(tcg.ConjugateGradient(1e-16, preconditioner=tpre)(a, b))).backward()
    # One refinement step of an exact factor on each side: roundoff apart.
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jga), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jgb), rtol=0, atol=1e-12)


@pytest.mark.parametrize("precond", ["eye", "chol"])
def test_cg_function_gradcheck(precond):
    # The solve of a symmetric PD matrix parametrised as (S + S^T) / 2 + 2 I
    # (a perturbation of one entry of A alone would leave A unsymmetric,
    # where CG does not solve).  float64 at 1e-24 with 3M steps: the solution
    # is exact to roundoff, so finite differences at eps 1e-6 hold to
    # gradcheck's tight defaults (atol 1e-5, rtol 1e-3) with atol 1e-8.
    rng = np.random.default_rng(1)
    n = 6
    g = rng.standard_normal((n, n))
    s0 = torch.as_tensor(g @ g.T / n, dtype=torch.float64).requires_grad_()
    b0 = torch.as_tensor(rng.standard_normal((2, n))).requires_grad_()

    def solve(s, b):
        a = 0.5 * (s + s.T) + 2.0 * torch.eye(n, dtype=torch.float64)
        pre = None
        if precond == "chol":
            with torch.no_grad():
                pre = tcg.CholPreconditioner(a.detach(), torch.zeros(n, dtype=torch.float64))
        sol, _ = tcg.conjugate_gradient(a, b, torch.zeros_like(b), 1e-24, preconditioner=pre,
                                        max_iterations=3 * n, max_steps_cycle=3 * n + 1)
        return sol

    assert torch.autograd.gradcheck(solve, (s0, b0), eps=1e-6, atol=1e-8, rtol=1e-6)


def test_cg_stats_are_not_differentiable():
    s = _system("float64")
    a = torch.as_tensor(s["a"]).requires_grad_()
    sol, stats = tcg.conjugate_gradient(a, torch.as_tensor(s["b"]),
                                        torch.zeros((R, M), dtype=torch.float64), 1e-12)
    assert sol.requires_grad
    assert not (stats.steps.requires_grad or stats.error.requires_grad
                or stats.converged.requires_grad)
    with torch.no_grad():
        sol, _ = tcg.conjugate_gradient(a, torch.as_tensor(s["b"]),
                                        torch.zeros((R, M), dtype=torch.float64), 1e-12)
    assert not sol.requires_grad


def test_chol_preconditioner_falls_back_to_identity_on_an_indefinite_matrix():
    # lam = -2 makes K + diag(lam) indefinite: the factorization fails and
    # both packages keep W = I, without an exception, and CG then runs
    # unpreconditioned on an SPD system given in its place.
    s = _system("float64")
    lam = -2.0 * np.ones(M)
    jstate = jcg.CholPreconditioner(jnp.asarray(s["k"]), jnp.asarray(lam)).state["chol_w"]
    tpre = tcg.CholPreconditioner(torch.as_tensor(s["k"]), torch.as_tensor(lam))
    np.testing.assert_array_equal(np.asarray(jstate), np.eye(M))
    np.testing.assert_array_equal(tpre.state["chol_w"].numpy(), np.eye(M))
    a = torch.as_tensor(s["a"])
    b = torch.as_tensor(s["b"])
    got, gstats = tcg.conjugate_gradient(a, b, torch.zeros_like(b), 1e-16, preconditioner=tpre)
    want, wstats = tcg.conjugate_gradient(a, b, torch.zeros_like(b), 1e-16)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert int(gstats.steps) == int(wstats.steps)


def test_a_non_preconditioner_is_refused():
    s = _system("float64")
    b = torch.as_tensor(s["b"])
    with pytest.raises(TypeError, match="not a preconditioner"):
        tcg.conjugate_gradient(torch.as_tensor(s["a"]), b, torch.zeros_like(b), 1e-8,
                               preconditioner=object())
