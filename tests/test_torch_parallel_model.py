"""Port parity for ``ShardedCGGP`` and ``ShardedIterGPR`` of
``cggp_tpu_torch.parallel``: prediction, the serving caches, the KL and the
fused ELBO with their gradients, preconditioning, the SLQ variant,
re-clustering, multi-output, the resolver and the exact GP, at world size
2 over gloo (the main model, the padding and the exact GP also at 4)
against the JAX package's model on a virtual CPU mesh of the same size.
Both packages take the JAX package's padded parameters and the same probes
(the port's ``rademacher`` returns JAX's draws from the keys JAX's model
splits).  The ranks run in spawned processes (``torch_dist_helpers``), one
world per size for the whole file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cggp_tpu.models import ClusterGP, GPR
from cggp_tpu.ops.kernels import Matern32, SquaredExponential
from cggp_tpu.ops.linalg import add_diagonal
from cggp_tpu.parallel import ShardedCGGP, ShardedIterGPR, make_mesh
from cggp_tpu.selection.update import labels_update_inducing_parameters
from torch_dist_helpers import start_world

WORLDS = (2, 4)
# World 4 runs the main model and the exact GP; world 2 every case.
LIGHT = ("main", "itergpr", "init_padded")
# Port against JAX on a CG route stopped at 0.5 |r|^2 <= 1e-14: the two stop
# where their residuals cross the rule, which the order of the reductions
# moves, so they agree to the tolerance JAX holds its sharded model to
# against the dense Cholesky ClusterGP.
CG_GAP = 1e-6
# The objectives (~1e3 here) through the same solves: relative 1e-7.
OBJ_RTOL = 1e-7


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rad(key, shape):
    return np.asarray(jax.random.rademacher(key, shape, dtype=jnp.float64))


def _elbo_probes(key, p, m):
    """The draws of ``RowSolveCGGP.elbo`` / ``prior_kl``: trace probes from
    ``split(key)[0]``, logdet (or SLQ) probes from ``split(key)[1]``."""
    k1, k2 = jax.random.split(key)
    return [_rad(k1, (p, m)), _rad(k2, (p, m))]


def _cluster(seed, m=13, n=96, d=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d))
    y = np.sin(2 * x[:, :1]) + 0.1 * rng.standard_normal((n, 1))
    counts = rng.integers(1, 9, (m, 1)).astype(np.float64)
    u = rng.standard_normal((m, 1))
    return x, y, counts, u


BASE = dict(num_data=96, num_probes=4, error_threshold=1e-14, max_cg_iterations=64)


class Case:
    """One model's inputs: the JAX model on the world's mesh, its padded
    parameters, and the port's list of operations with their probes."""

    def __init__(self, mesh, kernel, model_kw, params):
        self.model = ShardedCGGP(kernel=kernel, mesh=mesh, **model_kw)
        self.kernel_name = kernel.name
        self.model_kw, self.params, self.ops = model_kw, params, []

    def port(self):
        return dict(_case="model_ops", kernel=self.kernel_name, model_kw=self.model_kw,
                    params=_tree(self.params), ops=self.ops)


def _inputs(world):
    mesh = make_mesh(world)
    cases = {}
    x, y, counts, u = _cluster(0)
    m_pad = -(-13 // world) * world
    main = Case(mesh, Matern32(), BASE, ShardedCGGP(
        kernel=Matern32(), mesh=mesh, **BASE).init_params(x[:13], pseudo_u=u,
                                                          cluster_counts=counts))
    xq = x[:17]
    key = jax.random.PRNGKey(3)
    main.ops += [("predict", "predict_f", dict(x=x)),
                 ("full_cov", "predict_f", dict(x=xq, full_cov=True)),
                 ("post_auto", "posterior", dict(solver="auto", x=x)),
                 ("post_cg", "posterior", dict(solver="cg", x=x)),
                 ("post_chol_cov", "posterior", dict(solver="chol", x=xq, full_cov=True)),
                 ("post_cg_cov", "posterior", dict(solver="cg", x=xq, full_cov=True)),
                 ("batches", "predict_in_batches", dict(x=x, batch_size=32, mean_only=True)),
                 ("elbo", "elbo", dict(x=x, y=y, probes=_elbo_probes(key, 4, m_pad))),
                 ("kl", "prior_kl", dict(probes=_elbo_probes(key, 4, m_pad))),
                 ("grads", "loss_grads", dict(x=x, y=y, probes=_elbo_probes(
                     jax.random.PRNGKey(4), 4, m_pad)))]
    cases["main"] = (main, (x, y))
    # 256 probes: the KL against the dense KL less its logdet term
    kl = Case(mesh, Matern32(), dict(BASE, num_probes=256), main.params)
    kl.ops.append(("kl", "prior_kl", dict(probes=_elbo_probes(jax.random.PRNGKey(0), 256,
                                                              m_pad))))
    cases["kl256"] = (kl, None)
    # SLQ: the ELBO value near the Cholesky ELBO, its parts and gradients
    slq_kw = dict(BASE, num_probes=128, logdet_variant="slq", slq_lanczos_iters=13)
    slq = Case(mesh, Matern32(), slq_kw, main.params)
    key = jax.random.PRNGKey(11)
    slq.ops += [("elbo", "elbo", dict(x=x, y=y, probes=_elbo_probes(key, 128, m_pad))),
                ("kl", "prior_kl", dict(probes=_elbo_probes(key, 128, m_pad))),
                ("predict", "predict_f", dict(x=x)),
                ("grads", "loss_grads", dict(x=x, y=y, probes=_elbo_probes(key, 128, m_pad)))]
    cases["slq"] = (slq, (x, y))
    # preconditioning (pivchol, rff) against the plain model
    rng = np.random.default_rng(5)
    xp = rng.uniform(-1, 1, (64, 2))
    yp = np.sin(2 * xp[:, :1]) + 0.1 * rng.standard_normal((64, 1))
    cp = rng.integers(1, 9, (9, 1)).astype(np.float64)
    up = rng.standard_normal((9, 1))
    m9 = -(-9 // world) * world
    for name, kw in (("plain", {}), ("pivchol", dict(precondition="pivchol", precond_rank=8)),
                     ("rff", dict(precondition="rff", precond_rank=16))):
        mkw = dict(num_data=64, num_probes=2, error_threshold=1e-14, max_cg_iterations=64, **kw)
        c = Case(mesh, Matern32(), mkw, ShardedCGGP(kernel=Matern32(), mesh=mesh, **mkw)
                 .init_params(xp[:9], pseudo_u=up, cluster_counts=cp))
        key = jax.random.PRNGKey(5)
        c.ops += [("elbo", "elbo", dict(x=xp, y=yp, probes=_elbo_probes(key, 2, m9))),
                  ("grads", "loss_grads", dict(x=xp, y=yp, probes=_elbo_probes(key, 2, m9))),
                  ("steps", "cg_stats", dict(x=xp, y=yp, probes=[_rad(key, (4, m9))]))]
        cases[f"pre_{name}"] = (c, (xp, yp))
    # re-clustering to another non-divisible M
    iv, uu, cc = (np.asarray(a) for a in labels_update_inducing_parameters(
        (jnp.asarray(x), jnp.asarray(y)), jnp.asarray(x[:10])))
    main.ops.append(("assign", "assign_clusters", dict(iv=iv, u=uu, counts=cc, x=x[:8])))
    # multi-output: u of 3 columns
    rng = np.random.default_rng(7)
    xm = rng.uniform(-1, 1, (96, 2))
    ym = rng.standard_normal((96, 3))
    um = rng.standard_normal((13, 3))
    cm = rng.integers(1, 6, (13, 1)).astype(np.float64)
    mkw = dict(BASE, num_probes=3)
    multi = Case(mesh, Matern32(), mkw, ShardedCGGP(kernel=Matern32(), mesh=mesh, **mkw)
                 .init_params(xm[:13], pseudo_u=um, cluster_counts=cm))
    multi.ops += [("predict", "predict_f", dict(x=xm[:20])),
                  ("grads", "loss_grads", dict(x=xm, y=ym, probes=_elbo_probes(
                      jax.random.PRNGKey(0), 3, m_pad))),
                  ("post_cg", "posterior", dict(solver="cg", x=xm[:20])),
                  ("post_chol", "posterior", dict(solver="chol", x=xm[:20]))]
    cases["multi"] = (multi, (xm, ym, um, cm))
    # LOVE serving at rank >= M
    rng = np.random.default_rng(8)
    xl = rng.uniform(-1, 1, (100, 2))
    ul = rng.standard_normal((20, 1)) * 0.3
    lkw = dict(num_data=100, error_threshold=1e-13, max_cg_iterations=80,
               serving_lanczos_rank=24)
    love = Case(mesh, Matern32(), lkw, ShardedCGGP(kernel=Matern32(), mesh=mesh, **lkw)
                .init_params(xl[:20], noise_variance=0.1, pseudo_u=ul,
                             cluster_counts=jnp.full((20, 1), 3.0)))
    xlq = rng.uniform(-1, 1, (30, 2))
    love.ops += [("cg", "posterior", dict(solver="cg", x=xlq)),
                 ("lanczos", "posterior", dict(solver="lanczos", x=xlq))]
    cases["love"] = (love, None)
    # the serving resolver: a well- and an ill-conditioned fp32 system
    rng = np.random.default_rng(9)
    for name, (ls, cs) in (("resolve_chol", (0.5, 1.0)), ("resolve_cg", (8.0, 1.0e4))):
        xr = rng.uniform(-1, 1, (128, 2)).astype(np.float32)
        rkw = dict(num_data=128, num_probes=2, error_threshold=1e-6, max_cg_iterations=96,
                   relative_threshold=True)
        c = Case(mesh, SquaredExponential(), rkw, ShardedCGGP(
            kernel=SquaredExponential(), mesh=mesh, **rkw).init_params(
            jnp.asarray(xr[:24]), lengthscales=jnp.full(2, ls, jnp.float32), noise_variance=0.1,
            pseudo_u=jnp.asarray(rng.standard_normal((24, 1)), jnp.float32),
            cluster_counts=jnp.full((24, 1), cs, jnp.float32), dtype=jnp.float32))
        c.ops.append(("solver", "resolve_serving_solver", {}))
        if name == "resolve_cg":
            c.ops.append(("served", "posterior", dict(
                solver="cg", x=rng.uniform(-1, 1, (16, 2)).astype(np.float32))))
        cases[name] = (c, None)
    return mesh, cases


def _port_cases(cases, world):
    out = [(name, c.port()) for name, (c, _) in cases.items()]
    x, y, counts, u = _cluster(0)
    out.append(("init_padded", dict(kernel="matern32", model_kw=BASE, z=x[:13], u=u,
                                    counts=counts, init_kw={})))
    # ShardedIterGPR: N = 52 padded to the world multiple, SLQ at iters = N
    rng = np.random.default_rng(12)
    xi = rng.uniform(-1.5, 1.5, (52, 2))
    yi = np.sin(xi.sum(-1, keepdims=True)) + 0.1 * rng.normal(size=(52, 1))
    out.append(("itergpr", dict(_case="itergpr", x=xi, y=yi,
                                xq=rng.uniform(-1.5, 1.5, (24, 2)))))
    return out if world == 2 else [case for case in out if case[0] in LIGHT]


def _jax_model_ref(case, data):
    model, params, refs = case.model, case.params, {}
    for label, op, kw in case.ops:
        if op == "predict_f":
            refs[label] = _tree(jax.jit(model.predict_f, static_argnames="full_cov")(
                params, jnp.asarray(kw["x"]), full_cov=kw.get("full_cov", False)))
        elif op == "posterior":
            post = jax.jit(model.posterior, static_argnames="solver")(params,
                                                                      solver=kw["solver"])
            mu, var = jax.jit(model.posterior_predict, static_argnames="full_cov")(
                post, jnp.asarray(kw["x"]), full_cov=kw.get("full_cov", False))
            refs[label] = {"chol": post.chol is not None, "mu": np.asarray(mu),
                           "var": np.asarray(var)}
        elif op in ("elbo", "prior_kl", "loss_grads", "cg_stats"):
            pass  # computed below from the keys the probes came from
        elif op == "resolve_serving_solver":
            refs[label] = model.resolve_serving_solver(params)
    return refs


def _references(world, mesh, cases):
    refs = {}
    main, (x, y) = cases["main"]
    r = _jax_model_ref(main, None)
    m = main.model
    data = (jnp.asarray(x), jnp.asarray(y))
    r["elbo"] = float(jax.jit(m.elbo)(main.params, data, jax.random.PRNGKey(3)))
    r["kl"] = float(jax.jit(m.prior_kl)(main.params, jax.random.PRNGKey(3)))
    loss, g = jax.jit(jax.value_and_grad(lambda p: m.training_loss(
        p, data, jax.random.PRNGKey(4))))(main.params)
    r["grads"] = {"loss": float(loss), **_flat(g)}
    dense = ClusterGP(kernel=Matern32(), num_data=96)
    x0, y0, counts, u = _cluster(0)
    dparams = dense.init_params(jnp.asarray(x0[:13]), pseudo_u=jnp.asarray(u),
                                cluster_counts=jnp.asarray(counts))
    r["dense_predict"] = _tree(dense.predict_f(dparams, jnp.asarray(x)))
    r["dense_cov"] = _tree(dense.predict_f(dparams, jnp.asarray(x[:17]), full_cov=True))
    a = add_diagonal(dense.kernel.K(dparams["kernel"], dparams["inducing_points"]),
                     dense.diag_variance(dparams)[:, 0])
    r["dense_kl_less_logdet"] = float(dense.prior_kl(dparams)) - 0.5 * float(
        jnp.linalg.slogdet(a)[1])
    r["dense_elbo"] = float(dense.elbo(dparams, data))
    refs["main"] = r
    # ShardedIterGPR against JAX's and the dense GPR
    rng = np.random.default_rng(12)
    xi = rng.uniform(-1.5, 1.5, (52, 2))
    yi = np.sin(xi.sum(-1, keepdims=True)) + 0.1 * rng.normal(size=(52, 1))
    xq = rng.uniform(-1.5, 1.5, (24, 2))
    model = ShardedIterGPR(kernel=SquaredExponential(), mesh=mesh, **ITERGPR_KW)
    gpr = GPR(kernel=SquaredExponential())
    params = gpr.init_params(2, noise_variance=0.1, dtype=jnp.float64)
    probes = np.sqrt(52.0) * np.eye(52)
    di = (jnp.asarray(xi), jnp.asarray(yi))
    mll, g = jax.jit(jax.value_and_grad(lambda p: model.log_marginal_likelihood(
        p, di, probes=jnp.asarray(probes))))(params)
    post = jax.jit(model.posterior)(params, di)
    mu, var = jax.jit(model.posterior_predict)(post, jnp.asarray(xq))
    refs["itergpr"] = {"mll": float(mll), "grads": _flat(g), "mu": np.asarray(mu),
                       "var": np.asarray(var),
                       "dense_mll": float(gpr.log_marginal_likelihood(params, di)),
                       "dense": _tree(gpr.predict_f(params, di, jnp.asarray(xq)))}
    if world != 2:
        return refs

    kl, _ = cases["kl256"]
    refs["kl256"] = {"kl": float(jax.jit(kl.model.prior_kl)(kl.params, jax.random.PRNGKey(0)))}
    slq, _ = cases["slq"]
    key = jax.random.PRNGKey(11)
    r = _jax_model_ref(slq, None)
    r["elbo"] = float(jax.jit(slq.model.elbo)(slq.params, data, key))
    r["kl"] = float(jax.jit(slq.model.prior_kl)(slq.params, key))
    loss, g = jax.jit(jax.value_and_grad(lambda p: slq.model.training_loss(p, data, key)))(
        slq.params)
    r["grads"] = {"loss": float(loss), **_flat(g)}
    refs["slq"] = r
    for name in ("plain", "pivchol", "rff"):
        c, (xp, yp) = cases[f"pre_{name}"]
        dp = (jnp.asarray(xp), jnp.asarray(yp))
        key = jax.random.PRNGKey(5)
        loss, g = jax.jit(jax.value_and_grad(lambda p: c.model.training_loss(p, dp, key)))(
            c.params)
        refs[f"pre_{name}"] = {"elbo": float(jax.jit(c.model.elbo)(c.params, dp, key)),
                               "grads": {"loss": float(loss), **_flat(g)},
                               "steps": int(jax.jit(c.model.cg_stats)(c.params, dp, key).steps)}
    multi, (xm, ym, um, cm) = cases["multi"]
    r = _jax_model_ref(multi, None)
    loss, g = jax.jit(jax.value_and_grad(lambda p: multi.model.training_loss(
        p, (jnp.asarray(xm), jnp.asarray(ym)), jax.random.PRNGKey(0))))(multi.params)
    r["grads"] = {"loss": float(loss), **_flat(g)}
    refs["multi"] = r
    for name in ("love", "resolve_chol", "resolve_cg"):
        refs[name] = _jax_model_ref(cases[name][0], None)
    return refs


ITERGPR_KW = dict(error_threshold=1e-13, max_cg_iterations=208, relative_threshold=False,
                  precondition=None, logdet_variant="slq", slq_lanczos_iters=52)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``runs[world]`` (each rank's results) and ``refs[world]`` (the JAX
    package's, computed while the ranks run)."""
    inputs = {world: _inputs(world) for world in WORLDS}
    started = {world: start_world(tmp_path_factory.mktemp(f"model{world}"), world,
                                  _port_cases(inputs[world][1], world)) for world in WORLDS}
    refs = {world: _references(world, *inputs[world]) for world in WORLDS}
    return {world: started[world].results()[0] for world in WORLDS}, refs


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cggp_predict_matches_jax_and_dense(worlds, world):
    """predict_f: JAX's within ``CG_GAP``, the dense ClusterGP's within 1e-6
    (JAX's own tolerance), pads stripped."""
    runs, refs = worlds
    got, ref = runs[world]["main"]["predict"], refs[world]["main"]
    for i in range(2):
        _close(got[i], ref["predict"][i], 0, CG_GAP)
        _close(got[i], ref["dense_predict"][i], 0, 1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_posterior_cache_matches_jax(worlds, world):
    """``"auto"`` builds the Cholesky cache (M <= 16384) and ``"cg"`` the CG
    one, as JAX's: each posterior_predict within ``CG_GAP`` of
    JAX's and of predict_f (both CG-accurate: ``CG_GAP``), posterior_mean
    equal to posterior_predict's mean; predict_in_batches(mean_only) within
    1e-6 of predict_f."""
    runs, refs = worlds
    got, ref = runs[world]["main"], refs[world]["main"]
    for label in ("post_auto", "post_cg"):
        assert got[label]["chol"] == ref[label]["chol"] == (label == "post_auto")
        for k in ("mu", "var"):
            _close(got[label][k], ref[label][k], 0, CG_GAP, f"{label}/{k}")
        _close(got[label]["mean"], got[label]["mu"], 0, 1e-12)
        _close(got[label]["mu"], got["predict"][0], 0, CG_GAP)
        _close(got[label]["var"], got["predict"][1], 0, CG_GAP)
    mu_b, none = got["batches"]
    assert none is None
    _close(mu_b, got["predict"][0], 0, 1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_full_cov_matches_jax_and_dense(worlds, world):
    """full_cov through predict_f and both caches: [1, 17, 17], JAX's within
    ``CG_GAP``, the dense ClusterGP's within 1e-6."""
    runs, refs = worlds
    got, ref = runs[world]["main"], refs[world]["main"]
    assert got["full_cov"][1].shape == (1, 17, 17)
    for i in range(2):
        _close(got["full_cov"][i], ref["full_cov"][i], 0, CG_GAP)
        _close(got["full_cov"][i], ref["dense_cov"][i], 0, 1e-6)
    for label in ("post_chol_cov", "post_cg_cov"):
        _close(got[label]["mu"], ref["dense_cov"][0], 0, 1e-6, label)
        _close(got[label]["var"], ref["dense_cov"][1], 0, 1e-6, label)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fused_elbo_and_kl_match_jax(worlds, world):
    """Same probes: the fused ELBO and the KL within rtol ``OBJ_RTOL`` of JAX's, and
    the ELBO equal to its parts (VE(predict_f) - KL, rtol 1e-6, JAX's)."""
    runs, refs = worlds
    got, ref = runs[world]["main"], refs[world]["main"]
    _close(got["elbo"], ref["elbo"], OBJ_RTOL, 0)
    _close(got["kl"], ref["kl"], OBJ_RTOL, 0)
    mu, var = got["predict"]
    x, y, _, _ = _cluster(0)
    noise = 0.1  # the likelihood's initial variance
    ve = -0.5 * (np.log(2 * np.pi) + np.log(noise) + ((y - mu) ** 2 + var) / noise)
    _close(got["elbo"], ve.sum() - got["kl"], 1e-6, 0)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fused_elbo_gradients_match_jax_pads_inert(worlds, world):
    """Gradients of the training loss: finite, JAX's within rtol 1e-6 /
    atol 1e-9, exactly zero on the padded pseudo_u rows."""
    runs, refs = worlds
    got, ref = runs[world]["main"]["grads"], refs[world]["main"]["grads"]
    for name, want in ref.items():
        assert np.all(np.isfinite(got[name])), name
        _close(got[name], want, 1e-6, 1e-9, name)
    np.testing.assert_array_equal(got["pseudo_u"][13:], 0.0)


@pytest.mark.parametrize("world", [2])
def test_sharded_cggp_kl_matches_jax_and_dense_modulo_logdet(worlds, world):
    """256 probes: JAX's KL within ``OBJ_RTOL``, and the dense KL less its 0.5
    logdet within Monte-Carlo error (rtol 0.05, atol 0.3, JAX's)."""
    runs, refs = worlds
    got = runs[world]["kl256"]["kl"]
    _close(got, refs[world]["kl256"]["kl"], OBJ_RTOL, 0)
    _close(got, refs[world]["main"]["dense_kl_less_logdet"], 0.05, 0.3)


@pytest.mark.parametrize("world", [2])
def test_sharded_slq_elbo_matches_jax_and_cholesky(worlds, world):
    """logdet_variant="slq": the ELBO and KL within rtol ``OBJ_RTOL`` of JAX's, the
    ELBO near the dense Cholesky ELBO (rtol 0.05, atol 0.5, JAX's), equal to
    its parts (rtol 1e-6); gradients finite, JAX's within rtol 1e-6, zero on
    padded pseudo_u rows."""
    runs, refs = worlds
    got, ref = runs[world]["slq"], refs[world]["slq"]
    _close(got["elbo"], ref["elbo"], OBJ_RTOL, 0)
    _close(got["kl"], ref["kl"], OBJ_RTOL, 0)
    _close(got["elbo"], refs[world]["main"]["dense_elbo"], 0.05, 0.5)
    x, y, _, _ = _cluster(0)
    mu, var = got["predict"]
    ve = -0.5 * (np.log(2 * np.pi) + np.log(0.1) + ((y - mu) ** 2 + var) / 0.1)
    _close(got["elbo"], ve.sum() - got["kl"], 1e-6, 0)
    for name, want in ref["grads"].items():
        assert np.all(np.isfinite(got["grads"][name])), name
        _close(got["grads"][name], want, 1e-6, 1e-9, name)
    np.testing.assert_array_equal(got["grads"]["pseudo_u"][13:], 0.0)


@pytest.mark.parametrize("precondition", ["pivchol", "rff"])
@pytest.mark.parametrize("world", [2])
def test_sharded_preconditioned_elbo_matches(worlds, world, precondition):
    """Preconditioning is solver state: on converged solves the ELBO and the
    gradients equal the plain model's (rtol 1e-8 / 1e-5, JAX's), and never
    cost CG steps; the plain model's ELBO within rtol ``OBJ_RTOL`` of JAX's and the
    pivchol one's too (the port's rff sketch draws its own frequencies)."""
    runs, refs = worlds
    plain, pre = runs[world]["pre_plain"], runs[world][f"pre_{precondition}"]
    _close(pre["elbo"], plain["elbo"], 1e-8, 0)
    for name, want in plain["grads"].items():
        _close(pre["grads"][name], want, 1e-5, 1e-7, name)
    assert pre["steps"] <= plain["steps"]
    _close(plain["elbo"], refs[world]["pre_plain"]["elbo"], OBJ_RTOL, 0)
    if precondition == "pivchol":
        _close(pre["elbo"], refs[world]["pre_pivchol"]["elbo"], OBJ_RTOL, 0)
        assert abs(pre["steps"] - refs[world]["pre_pivchol"]["steps"]) <= 3


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_assign_clusters_repads(worlds, world):
    """Re-clustered to M = 10: padded to the world multiple again, the mask
    summing to 10, finite predictions."""
    got = worlds[0][world]["main"]["assign"]
    assert got["z_rows"] == -(-10 // world) * world
    assert got["mask_sum"] == 10.0
    assert np.all(np.isfinite(got["mu"]))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_init_params_pads_as_jax(worlds, world):
    """The port's own init_params pads M = 13 to the world multiple exactly
    as the JAX package's (the same points, counts, u and mask, to the last
    bits of the pads' far coordinates)."""
    runs, refs = worlds
    got = runs[world]["init_padded"]
    x, y, counts, u = _cluster(0)
    want = _flat(ShardedCGGP(kernel=Matern32(), mesh=make_mesh(world), **BASE).init_params(
        x[:13], pseudo_u=u, cluster_counts=counts))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-15, atol=0, err_msg=name)


@pytest.mark.parametrize("world", [2])
def test_sharded_cggp_multi_output(worlds, world):
    """u of 3 columns: predictions [20, 3] and both caches' means as JAX's
    (``CG_GAP``), finite gradients as JAX's (rtol 1e-6)."""
    runs, refs = worlds
    got, ref = runs[world]["multi"], refs[world]["multi"]
    assert got["predict"][0].shape == (20, 3)
    _close(got["predict"][0], ref["predict"][0], 0, CG_GAP)
    _close(got["predict"][1], ref["predict"][1], 0, CG_GAP)
    for label in ("post_cg", "post_chol"):
        _close(got[label]["mu"], ref["predict"][0], 0, 1e-6, label)
    for name, want in ref["grads"].items():
        _close(got["grads"][name], want, 1e-6, 1e-9, name)


@pytest.mark.parametrize("world", [2])
def test_sharded_lanczos_serving_matches_cg(worlds, world):
    """posterior(solver="lanczos") at rank 24 >= M: means equal the CG
    cache's (rtol 1e-12), variances within rtol 1e-6 / atol 1e-7 (JAX's), and
    both as JAX's (``CG_GAP``)."""
    runs, refs = worlds
    got, ref = runs[world]["love"], refs[world]["love"]
    _close(got["lanczos"]["mu"], got["cg"]["mu"], 1e-12, 0)
    _close(got["lanczos"]["var"], got["cg"]["var"], 1e-6, 1e-7)
    for label in ("cg", "lanczos"):
        _close(got[label]["mu"], ref[label]["mu"], 0, CG_GAP, label)
        _close(got[label]["var"], ref[label]["var"], 0, CG_GAP, label)


@pytest.mark.parametrize("world", [2])
def test_sharded_resolve_serving_solver_by_conditioning(worlds, world):
    """The Lanczos resolver through the sharded matvec: a well-conditioned
    fp32 system serves by Cholesky, one with kappa >> 1/eps(fp32) by CG
    (finite outputs), as in JAX."""
    runs, refs = worlds
    assert runs[world]["resolve_chol"]["solver"] == refs[world]["resolve_chol"]["solver"] == "chol"
    assert runs[world]["resolve_cg"]["solver"] == refs[world]["resolve_cg"]["solver"] == "cg"
    served = runs[world]["resolve_cg"]["served"]
    assert np.isfinite(served["mu"]).all() and np.isfinite(served["var"]).all()


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_itergpr_matches_jax_and_dense_gpr(worlds, world):
    """ShardedIterGPR, N = 52 padded to the world multiple, SLQ at N
    iterations with the exact probes: the MLL within rtol ``OBJ_RTOL`` of JAX's and
    1e-8 of the dense GPR's, gradients within rtol 1e-6 of JAX's, the
    posterior within ``CG_GAP`` of JAX's and 1e-5 of the dense GPR's."""
    runs, refs = worlds
    got, ref = runs[world]["itergpr"], refs[world]["itergpr"]
    _close(got["mll"], ref["mll"], OBJ_RTOL, 0)
    _close(got["mll"], ref["dense_mll"], 1e-8, 1e-8)
    for name, want in ref["grads"].items():
        _close(got["grads"][name], want, 1e-6, 1e-8, name)
    _close(got["mu"], ref["mu"], 0, CG_GAP)
    _close(got["var"], ref["var"], 0, CG_GAP)
    _close(got["mu"], ref["dense"][0], 1e-5, 1e-8)
    _close(got["var"], ref["dense"][1], 1e-5, 1e-8)
    _close(got["mean"], ref["dense"][0], 1e-5, 1e-8)


def test_sharded_models_require_a_mesh():
    """Both sharded models refuse to build without a mesh, as in JAX."""
    from cggp_tpu_torch.ops.kernels import SquaredExponential as TSE
    from cggp_tpu_torch.parallel import ShardedCGGP as TShardedCGGP
    from cggp_tpu_torch.parallel import ShardedIterGPR as TShardedIterGPR

    with pytest.raises(ValueError, match="mesh"):
        TShardedCGGP(kernel=TSE())
    with pytest.raises(ValueError, match="mesh"):
        TShardedIterGPR(kernel=TSE())
