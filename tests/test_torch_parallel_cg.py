"""Port parity for the row-sharded CG of ``cggp_tpu_torch.parallel``
(``sharded_cg.py``): ``make_sharded_cg`` (solutions, step counts,
gradients, pads), ``ShardedKuuSolver``, the SLQ value and the sharded
model's logdet estimators, each at world sizes 2 and 4 over gloo against
the JAX package's function on a virtual CPU mesh of the same size, on the
same numpy inputs and probes.  The ranks run in spawned processes
(``torch_dist_helpers``); each world runs all of a test's cases once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cggp_tpu.ops.kernels import SquaredExponential
from cggp_tpu.ops.linalg import add_diagonal
from cggp_tpu.parallel import (ShardedCGGP, ShardedKuuSolver, make_mesh, make_sharded_cg,
                               pad_inducing)
from cggp_tpu.parallel.sharded_cg import make_sharded_slq_value
from torch_dist_helpers import start_world

WORLDS = (2, 4)


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _system(seed, m=32, d=2):
    rng = np.random.default_rng(seed)
    kernel = SquaredExponential()
    kp = kernel.init_params(variance=1.3, lengthscales=np.full(d, 0.7))
    z = rng.uniform(-1, 1, (m, d))
    lam = rng.uniform(0.1, 0.5, (m,))
    rhs = rng.standard_normal((3, m))
    return kernel, kp, z, lam, rhs


def _args(kp, z, lam, kernel="se", **kw):
    return dict(kernel=kernel, kp=_tree(kp), z=np.asarray(z), lam=np.asarray(lam), **kw)


def _inputs(world):
    """Every case's numpy inputs at one world size: ``(cases, extras)``."""
    cases, extra = [], {}
    _, kp, z, lam, rhs = _system(0)
    cases.append(("solve", _args(kp, z, lam, rhs=rhs, threshold=1e-14, max_iter=64)))
    _, kp, z, lam, rhs = _system(1, m=16)
    cases.append(("solve_grads", _args(kp, z, lam, rhs=rhs, threshold=1e-14, max_iter=64)))
    # pads: M = 13 padded to the world multiple, with and without the mask
    kernel, kp, z, lam, rhs = _system(2, m=13)
    z_p, lam_p, rhs_p = (np.asarray(a) for a in pad_inducing(
        jnp.asarray(z), jnp.asarray(lam), world, jnp.asarray(rhs)))
    extra["pad"] = (kp, z, lam, rhs)
    cases.append(("pad", dict(_case="solve", **_args(kp, z_p, lam_p, rhs=rhs_p, threshold=1e-14,
                                                     max_iter=64))))
    kp_huge = kernel.init_params(variance=1.3, lengthscales=np.full(2, 1.0e6))
    lam_h = np.random.default_rng(3).uniform(0.5, 1.0, (13,))
    z_h, lam_hp, rhs_h = (np.asarray(a) for a in pad_inducing(
        jnp.asarray(z), jnp.asarray(lam_h), world, jnp.asarray(rhs)))
    mask = np.concatenate([np.ones(13), np.zeros(z_h.shape[0] - 13)])
    for name, kw in (("pad_huge", dict(mask=mask)), ("pad_huge_unmasked", {})):
        cases.append((name, dict(_case="solve", **kw, **_args(kp_huge, z_h, lam_hp, rhs=rhs_h,
                                                              threshold=1e-14, max_iter=64))))
    _, kp, z, lam, rhs = _system(4, m=24)
    cases.append(("solve_state_bitwise", _args(kp, z, lam, rhs=rhs, threshold=1e-12,
                                               max_iter=64)))
    _, kp, z, lam, rhs = _system(5, m=16)
    cases.append(("kuu_solver", _args(kp, z, lam, rhs_cols=rhs.T, threshold=1e-14, max_iter=64)))
    # SLQ values: exact quadrature at iters = m, then with pads
    _, kp, z, lam, _ = _system(0, m=16)  # the JAX package's test system
    probes = np.asarray(jax.random.rademacher(jax.random.PRNGKey(7), (64, 16), dtype=jnp.float64))
    cases.append(("slq", _args(kp, z, lam, mask=np.ones(16), probes=probes, iters=16)))
    _, kp, z, lam, _ = _system(8, m=13)
    z_p, lam_p = (np.asarray(a) for a in pad_inducing(jnp.asarray(z), jnp.asarray(lam), world))
    mask = np.concatenate([np.ones(13), np.zeros(z_p.shape[0] - 13)])
    probes = np.asarray(jax.random.rademacher(jax.random.PRNGKey(8), (48, z_p.shape[0]),
                                              dtype=jnp.float64)) * mask[None, :]
    cases.append(("slq_pads", dict(_case="slq", **_args(kp, z_p, lam_p, mask=mask, probes=probes,
                                                        iters=13))))
    # the sharded model's logdet estimators (zero-valued and SLQ)
    _, kp, z, lam, _ = _system(9, m=16)
    probes = np.asarray(jax.random.rademacher(jax.random.PRNGKey(1), (192, 16),
                                              dtype=jnp.float64))
    for variant in ("zero", "slq"):
        kw = dict(num_data=10, num_probes=192, error_threshold=1e-14, max_cg_iterations=64)
        if variant == "slq":
            kw.update(logdet_variant="slq", slq_lanczos_iters=16)
        cases.append((f"logdet_{variant}", dict(_case="logdet_grad", variant=variant, model_kw=kw,
                                                **_args(kp, z, lam, probes=probes))))
    return cases, extra


def _dense_solve(kp, z, lam, rhs):
    a = add_diagonal(SquaredExponential().K(kp, jnp.asarray(z)), jnp.asarray(lam))
    return np.linalg.solve(np.asarray(a), np.asarray(rhs).T).T


def _references(world, cases, extra):
    """The JAX package's values of every case on a virtual mesh of ``world``
    devices (each call jitted)."""
    mesh = make_mesh(world)
    kernel = SquaredExponential()
    args = dict(cases)
    ref = {}

    def jsolve(a, threshold=1e-14, max_iter=64, mask=None):
        fn = make_sharded_cg(kernel, mesh, threshold, max_iter)
        sol, stats = jax.jit(lambda kp, z, lam, rhs, m: fn(kp, z, lam, rhs, mask=m))(
            a["kp"], a["z"], a["lam"], a["rhs"], mask)
        return np.asarray(sol), int(stats.steps)

    a = args["solve"]
    ref["solve"] = (*jsolve(a), _dense_solve(a["kp"], a["z"], a["lam"], a["rhs"]))
    ref["solve_lambda_min"] = float(np.linalg.eigvalsh(np.asarray(add_diagonal(
        kernel.K(a["kp"], jnp.asarray(a["z"])), jnp.asarray(a["lam"]))))[0])
    a = args["solve_grads"]
    fn = make_sharded_cg(kernel, mesh, 1e-14, 64)
    g = jax.jit(jax.grad(lambda kp, z, lam: jnp.sum(jnp.square(fn(kp, z, lam, a["rhs"])[0])),
                         argnums=(0, 1, 2)))(a["kp"], a["z"], a["lam"])
    ref["solve_grads"] = {"z": np.asarray(g[1]), "lam": np.asarray(g[2]),
                          **{f"kernel/{k}": np.asarray(v) for k, v in g[0].items()}}
    ref["pad"] = (jsolve(args["pad"])[0], _dense_solve(*extra["pad"]))
    ref["pad_huge"] = (jsolve(args["pad_huge"], mask=args["pad_huge"]["mask"])[0],
                       jsolve(args["pad_huge_unmasked"])[0])
    a = args["kuu_solver"]
    solver = ShardedKuuSolver(kernel, mesh, 1e-14, 64)
    ref["kuu_solver"] = np.asarray(jax.jit(solver.__call__)(a["kp"], a["z"], a["lam"],
                                                             a["rhs_cols"]))
    for name in ("slq", "slq_pads"):
        a = args[name]
        slq = make_sharded_slq_value(kernel, mesh, a["iters"])
        ref[name] = float(jax.jit(slq)(a["kp"], a["z"], a["lam"], a["mask"], a["probes"]))
    a = args["slq"]
    ref["slq_truth"] = float(np.linalg.slogdet(np.asarray(add_diagonal(
        kernel.K(a["kp"], jnp.asarray(a["z"])), jnp.asarray(a["lam"]))))[1])
    for variant in ("zero", "slq"):
        a = args[f"logdet_{variant}"]
        jmodel = ShardedCGGP(kernel=kernel, mesh=mesh, **a["model_kw"])
        fn = jmodel._slq_logdet if variant == "slq" else jmodel._logdet
        m = len(a["z"])
        value, grad = jax.jit(jax.value_and_grad(
            lambda kp_: fn(kp_, jnp.asarray(a["z"]), jnp.asarray(a["lam"]), jnp.ones(m),
                           jnp.asarray(a["probes"]))))(a["kp"])
        ref[f"logdet_{variant}"] = {"value": float(value),
                                    **{f"kernel/{k}": np.asarray(v) for k, v in grad.items()}}
    return ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case of this file on each world size, ``runs[world]`` the ranks'
    results, beside the JAX package's ``refs[world]`` (computed while the
    ranks run)."""
    inputs = {world: _inputs(world) for world in WORLDS}
    started = {world: start_world(tmp_path_factory.mktemp(f"cg{world}"), world,
                                  inputs[world][0]) for world in WORLDS}
    refs = {world: _references(world, *inputs[world]) for world in WORLDS}
    return {world: started[world].results() for world in WORLDS}, refs


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cg_matches_jax_and_dense_solve(worlds, world):
    """fp64, stop rule 0.5 |r|^2 <= 1e-14: the solution within the rule's
    own bound of the dense solve, |x - x*| <= |r| / lambda_min = sqrt(2e-14)
    / lambda_min, and within twice it of JAX's (the two stop where their
    residuals cross the rule, which reduction order moves by a step); the
    steps within max(3, 5 %) of JAX's."""
    runs, refs = worlds
    got = runs[world][0]["solve"]
    jsol, jsteps, dense = refs[world]["solve"]
    bound = np.sqrt(2e-14) / refs[world]["solve_lambda_min"]
    np.testing.assert_allclose(got["solution"], dense, atol=bound, rtol=0)
    np.testing.assert_allclose(got["solution"], jsol, atol=2 * bound, rtol=0)
    assert abs(got["steps"] - jsteps) <= max(3, 0.05 * jsteps) and got["converged"]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cg_gradients_match_jax(worlds, world):
    """The backward solve and the all-reduced row-block VJP: gradients of
    sum(solution^2) within rtol 1e-5 / atol 1e-7 of JAX's (the tolerance
    JAX holds its sharded gradients to against the dense ones)."""
    runs, refs = worlds
    got = runs[world][0]["solve_grads"]
    for name, want in refs[world]["solve_grads"].items():
        np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_pad_inducing_is_exact_noop(worlds, world):
    """M = 13 padded to the world multiple: real entries equal the unpadded
    dense solve (1e-8) and JAX's (1e-10), padded entries 0 (1e-12)."""
    runs, refs = worlds
    got = runs[world][0]["pad"]["solution"]
    jsol, dense = refs[world]["pad"]
    np.testing.assert_allclose(got, jsol, atol=1e-10)
    np.testing.assert_allclose(got[:, :13], dense, atol=1e-8)
    np.testing.assert_allclose(got[:, 13:], 0.0, atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_pad_inducing_exact_with_huge_lengthscale(worlds, world):
    """At a lengthscale of 1e6 the mask keeps pads exactly 0 and real
    entries at JAX's (rtol 1e-8); without it the pads re-couple, as in JAX."""
    runs, refs = worlds
    masked = runs[world][0]["pad_huge"]["solution"]
    unmasked = runs[world][0]["pad_huge_unmasked"]["solution"]
    jmasked, junmasked = refs[world]["pad_huge"]
    np.testing.assert_allclose(masked, jmasked, rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(masked[:, 13:], 0.0)
    assert np.abs(unmasked[:, 13:]).max() > 1e-6
    np.testing.assert_allclose(unmasked, junmasked, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cg_state_bitwise_equal_on_every_rank(worlds, world):
    """The solution, residual and step count of a solve, all-gathered after
    it: every rank holds the same bits (one stop decision, replicated
    state), and each rank's own copy is the same too."""
    runs, _ = worlds
    first = runs[world][0]["solve_state_bitwise"]["copies"]
    for rank in range(world):
        res = runs[world][rank]["solve_state_bitwise"]
        assert res["equal"]
        np.testing.assert_array_equal(res["copies"], first)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_kuu_solver_matches_jax(worlds, world):
    """The column-convention facade: JAX's solution within 1e-10."""
    runs, refs = worlds
    np.testing.assert_allclose(runs[world][0]["kuu_solver"], refs[world]["kuu_solver"],
                               atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_slq_value_matches_jax_and_truth(worlds, world):
    """Same probes: JAX's SLQ value within rtol 1e-10; at iters = m within
    Hutchinson error of the true slogdet (rtol 0.15, atol 0.3, JAX's)."""
    runs, refs = worlds
    jval, truth = refs[world]["slq"], refs[world]["slq_truth"]
    got = runs[world][0]["slq"]
    np.testing.assert_allclose(got, jval, rtol=1e-10)
    np.testing.assert_allclose(got, truth, rtol=0.15, atol=0.3)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_slq_value_with_pads(worlds, world):
    """Masked probes on the padded system: JAX's value within rtol 1e-10."""
    runs, refs = worlds
    np.testing.assert_allclose(runs[world][0]["slq_pads"], refs[world]["slq_pads"], rtol=1e-10)


@pytest.mark.parametrize("variant", ["zero", "slq"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_logdet_estimators_match_jax(worlds, world, variant):
    """``ShardedCGGP._logdet`` / ``_slq_logdet`` with 192 shared probes:
    value (rtol 1e-9) and kernel gradients (rtol 1e-7, atol 1e-9) as JAX's."""
    runs, refs = worlds
    got = runs[world][0][f"logdet_{variant}"]
    for name, want in refs[world][f"logdet_{variant}"].items():
        np.testing.assert_allclose(got[name], want, rtol=1e-7 if name != "value" else 1e-9,
                                   atol=1e-9, err_msg=name)
