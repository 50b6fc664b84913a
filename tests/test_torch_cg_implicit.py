"""Port parity for the matrix-free CG family in float64: pad_inducing,
blocked_kuu_matvec, the pivoted Cholesky (dense and matrix-free), the
spectral preconditioner and make_implicit_cg's forward solve, against the
JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cggp_tpu.ops.cg import SpectralPreconditioner as JaxSpectral
from cggp_tpu.ops.cg import spectral_precond_state as jax_spectral_state
from cggp_tpu.ops.cg_implicit import blocked_kuu_matvec as jax_blocked_kuu_matvec
from cggp_tpu.ops.cg_implicit import make_implicit_cg as jax_make_implicit_cg
from cggp_tpu.ops.cg_implicit import pad_inducing as jax_pad_inducing
from cggp_tpu.ops.cg_implicit import pivoted_cholesky_kernel as jax_pivoted_cholesky_kernel
from cggp_tpu.ops.kernels import kernel_by_name as jax_kernel_by_name
from cggp_tpu.ops.linalg import pivoted_cholesky as jax_pivoted_cholesky
from cggp_tpu_torch.ops.cg import SpectralPreconditioner, precond_apply_or_identity
from cggp_tpu_torch.ops.cg import spectral_precond_state
from cggp_tpu_torch.ops.cg_implicit import (
    blocked_kuu_matvec,
    make_implicit_cg,
    pad_inducing,
    pivoted_cholesky_kernel,
)
from cggp_tpu_torch.ops.kernels import kernel_by_name
from cggp_tpu_torch.ops.linalg import pivoted_cholesky

torch.set_num_threads(1)

# Both packages run the same float64 operations; sums differ only in order.
TOL = dict(rtol=1e-10, atol=1e-10)
M_REAL, BLOCK = 50, 32  # padded to 64: two panels, 14 pads


def _t(a):
    return torch.as_tensor(np.array(a))  # a writable copy


def _problem(kernel_name="matern32", seed=0):
    """Inducing points padded to a block multiple, lam = noise / counts, a
    row right-hand side block and both packages' kernel parameters."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1.5, 1.5, (M_REAL, 3))
    lam = 0.5 / rng.integers(1, 5, M_REAL).astype(np.float64)
    rhs = rng.standard_normal((4, M_REAL))
    # Lengthscales of about a quarter of the box keep Kmm + Lambda well
    # conditioned, so two float64 CG runs whose matvec sums differ in order
    # stay within 1e-10 of each other to the last step (measured <= 3e-11
    # unpreconditioned; at lengthscales ~1 the unpreconditioned runs drift
    # ~2e-9 apart before they converge, with the same step counts).
    ell = rng.uniform(0.4, 0.6, 3)
    ones = np.ones((1, M_REAL))
    z_pad, lam_pad, rhs_pad, mask = (np.asarray(a) for a in jax_pad_inducing(
        jnp.asarray(z), jnp.asarray(lam), BLOCK, jnp.asarray(rhs), jnp.asarray(ones)))
    jkernel = jax_kernel_by_name(kernel_name)
    jkp = jkernel.init_params(variance=1.3, lengthscales=ell, dtype=jnp.float64)
    tkernel = kernel_by_name(kernel_name)
    tkp = {k: _t(v) for k, v in jkp.items()}
    return dict(z=z, lam=lam, rhs=rhs, z_pad=z_pad, lam_pad=lam_pad, rhs_pad=rhs_pad,
                mask=mask[0], jkernel=jkernel, jkp=jkp, tkernel=tkernel, tkp=tkp)


def test_pad_inducing_matches_jax():
    pr = _problem()
    got = pad_inducing(_t(pr["z"]), _t(pr["lam"]), BLOCK, _t(pr["rhs"]),
                       torch.ones((1, M_REAL), dtype=torch.float64))
    want = (pr["z_pad"], pr["lam_pad"], pr["rhs_pad"], pr["mask"][None, :])
    assert got[0].shape == (64, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # Already a multiple: returned as given.
    same = pad_inducing(_t(pr["z_pad"]), _t(pr["lam_pad"]), BLOCK)
    assert same[0].shape == (64, 3)


@pytest.mark.parametrize("block", [64, BLOCK])  # m <= block (one panel), m > block
@pytest.mark.parametrize("masked", [False, True])
def test_blocked_kuu_matvec_matches_jax(block, masked):
    pr = _problem()
    mask = pr["mask"] if masked else None
    # Zero at the pads, as every solve's right-hand side is: the pads' own
    # self-distances are float64 cancellation noise (|z|^2 ~ 1e14), so an
    # unmasked pad-pad kernel value is not a number either package defines.
    p = np.random.default_rng(1).standard_normal((3, 64)) * pr["mask"]
    want = jax_blocked_kuu_matvec(pr["jkernel"], pr["jkp"], jnp.asarray(pr["z_pad"]),
                                  jnp.asarray(pr["lam_pad"]), jnp.asarray(p), block=block,
                                  mask=None if mask is None else jnp.asarray(mask))
    got = blocked_kuu_matvec(pr["tkernel"], pr["tkp"], _t(pr["z_pad"]), _t(pr["lam_pad"]),
                             _t(p), block=block, mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_blocked_kuu_matvec_refuses_a_ragged_panel():
    pr = _problem()
    with pytest.raises(ValueError):
        blocked_kuu_matvec(pr["tkernel"], pr["tkp"], _t(pr["z"]), _t(pr["lam"]),
                           torch.zeros((1, M_REAL), dtype=torch.float64), block=BLOCK)


@pytest.mark.parametrize("rank", [8, 70])  # 70 > M = 64: exhausted pivots give zero columns
def test_pivoted_cholesky_dense_matches_jax(rank):
    pr = _problem()
    k = np.asarray(pr["jkernel"].K(pr["jkp"], jnp.asarray(pr["z"])))
    want = np.asarray(jax_pivoted_cholesky(jnp.asarray(k), rank))
    got = pivoted_cholesky(_t(k), rank)
    assert got.shape == (M_REAL, rank)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kernel_name", ["se", "matern12", "matern32", "matern52"])
@pytest.mark.parametrize("masked", [False, True])
def test_pivoted_cholesky_kernel_matches_jax(kernel_name, masked):
    pr = _problem(kernel_name)
    mask = pr["mask"] if masked else None
    z = pr["z_pad"] if masked else pr["z"]
    want = np.asarray(jax_pivoted_cholesky_kernel(
        pr["jkernel"], pr["jkp"], jnp.asarray(z), 16,
        mask=None if mask is None else jnp.asarray(mask)))
    got = pivoted_cholesky_kernel(pr["tkernel"], pr["tkp"], _t(z), 16,
                                  mask=None if mask is None else _t(mask))
    # Each pivot row holds a coincident pair, where r2 is float64 roundoff;
    # Matern12's exp(-sqrt(r2)) turns that into ~1e-8 (sqrt of eps) and the
    # factor's entries at earlier pivots into ~1e-7 noise in either package.
    atol = 2e-7 if kernel_name == "matern12" else TOL["atol"]
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL["rtol"], atol=atol)
    if masked:  # no column is spent on a pad
        assert np.all(got.numpy()[pr["mask"] == 0] == 0)


def _spectral_states(pr, rank=12):
    factor = np.asarray(jax_pivoted_cholesky_kernel(
        pr["jkernel"], pr["jkp"], jnp.asarray(pr["z_pad"]), rank, mask=jnp.asarray(pr["mask"])))
    jstate = jax_spectral_state(jnp.asarray(factor), jnp.asarray(pr["lam_pad"]))
    tstate = spectral_precond_state(_t(factor), _t(pr["lam_pad"]))
    return jstate, tstate


def test_spectral_preconditioner_apply_matches_jax():
    pr = _problem()
    jstate, tstate = _spectral_states(pr)
    vec = np.random.default_rng(2).standard_normal((5, 64))
    jz, jrz = JaxSpectral.apply(jstate, jnp.asarray(vec), None)
    tz, trz = SpectralPreconditioner.apply(tstate, _t(vec))
    # The state itself may differ in the signs of Q's columns (QR and eigh
    # conventions); the operator it applies may not.
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(trz.numpy(), np.asarray(jrz), **TOL)
    assert (trz.numpy() > 0).all()
    tz2, trz2 = precond_apply_or_identity(tstate, _t(vec))
    assert torch.equal(tz2, tz) and torch.equal(trz2, trz)
    z_id, rz_id = precond_apply_or_identity((), _t(vec))
    assert torch.equal(z_id, _t(vec))
    np.testing.assert_allclose(rz_id.numpy()[:, 0], (vec**2).sum(-1), rtol=1e-14)


def test_spectral_preconditioner_is_the_inverse_of_the_low_rank_operator():
    rng = np.random.default_rng(3)
    u = rng.standard_normal((20, 4))
    lam = rng.uniform(0.2, 1.0, 20)
    pre = SpectralPreconditioner(_t(u), _t(lam))
    vec = rng.standard_normal((2, 20))
    z, _ = pre(_t(vec))
    want = np.linalg.solve(u @ u.T + np.diag(lam), vec.T).T
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("precondition", [False, True])
@pytest.mark.parametrize("relative,threshold", [(False, 1e-16), (True, 1e-16)])
def test_make_implicit_cg_forward_matches_jax(precondition, relative, threshold):
    """Same solution, the same number of steps and the same converged flag.
    The thresholds sit just above where the reference's absolute 1e-16
    curvature guard would stall CG (tests/test_torch_pallas_cg.py)."""
    pr = _problem()
    jstate, tstate = _spectral_states(pr) if precondition else ((), ())
    jsolve = jax_make_implicit_cg(pr["jkernel"], threshold, 200, block=BLOCK,
                                  relative_threshold=relative)
    tsolve = make_implicit_cg(pr["tkernel"], threshold, 200, block=BLOCK,
                              relative_threshold=relative)
    jsol, jstats = jsolve(pr["jkp"], jnp.asarray(pr["z_pad"]), jnp.asarray(pr["lam_pad"]),
                          jnp.asarray(pr["rhs_pad"]), jstate, jnp.asarray(pr["mask"]))
    tsol, tstats = tsolve(pr["tkp"], _t(pr["z_pad"]), _t(pr["lam_pad"]), _t(pr["rhs_pad"]),
                          tstate, _t(pr["mask"]))
    np.testing.assert_allclose(tsol.numpy(), np.asarray(jsol), **TOL)
    assert int(tstats.steps) == int(jstats.steps)
    assert bool(tstats.converged) == bool(jstats.converged)
    assert bool(tstats.converged) and int(tstats.steps) < 200
    assert np.all(tsol.numpy()[:, pr["mask"] == 0] == 0)  # pads exactly decoupled


def test_make_implicit_cg_refuses_to_differentiate():
    """Named for the refusal it checked before the solve had its custom
    backward pass; it now holds that backward pass against JAX's: the
    gradient of ``sum(solution * c)`` with respect to the kernel parameters,
    Z, lam and the right-hand side, on both routes' plain versions, under
    the pivoted-Cholesky state, and ``torch.no_grad`` still solves."""
    import jax

    pr = _problem()
    cot = np.random.default_rng(9).standard_normal(pr["rhs_pad"].shape)
    jmask = jnp.asarray(pr["mask"])
    jstate = jax_spectral_state(jax_pivoted_cholesky_kernel(
        pr["jkernel"], pr["jkp"], jnp.asarray(pr["z_pad"]), 8, mask=jmask),
        jnp.asarray(pr["lam_pad"]))
    jsolve = jax_make_implicit_cg(pr["jkernel"], 1e-16, 200, block=BLOCK)

    def jloss(kp, z, lam, rhs):
        return jnp.sum(jsolve(kp, z, lam, rhs, jstate, jmask)[0] * jnp.asarray(cot))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        pr["jkp"], jnp.asarray(pr["z_pad"]), jnp.asarray(pr["lam_pad"]),
        jnp.asarray(pr["rhs_pad"]))
    tstate = tuple(_t(a) for a in jstate)
    for use_pallas in (False, True):  # the kernel route's plain version on the CPU
        solve = make_implicit_cg(pr["tkernel"], 1e-16, 200, block=BLOCK, use_pallas=use_pallas)
        kp = {k: v.clone().requires_grad_() for k, v in pr["tkp"].items()}
        z, lam, rhs = (_t(pr[k]).requires_grad_() for k in ("z_pad", "lam_pad", "rhs_pad"))
        loss = torch.sum(solve(kp, z, lam, rhs, tstate, _t(pr["mask"]))[0] * _t(cot))
        got = torch.autograd.grad(loss, [*kp.values(), z, lam, rhs])
        flat_want = [want[0][k] for k in kp] + list(want[1:])
        # Relative to each gradient's largest entry: float64 on the plain
        # route measured <= 4.7e-10 (two CG solves and a VJP), held at 1e-8;
        # the kernel route's matvecs run in float32, measured <= 2.4e-6,
        # held at 1e-4.
        for g, w in zip(got, flat_want):
            w = np.asarray(w)
            rtol = 1e-4 if use_pallas else 1e-8
            assert np.abs(g.numpy() - w).max() <= rtol * np.abs(w).max()
        with torch.no_grad():
            sol, stats = solve(kp, z, lam, rhs, tstate, _t(pr["mask"]))
        assert not sol.requires_grad and bool(stats.converged)
