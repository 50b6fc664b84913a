"""Port parity for the data-parallel paths of ``cggp_tpu_torch.parallel``:
``make_data_parallel_loss`` / ``make_data_parallel_predict``, Adam on the
sharded model, the K-step trainer over it, the trainer's hybrid dp+tp
``mesh`` step, mesh serving in ``predict_in_batches`` and
``posterior_predict_scan`` (LOVE included), and ``make_mesh``'s refusals,
at world sizes 2 and 4 over gloo against the JAX package on a virtual CPU
mesh of the same size (the trainer's trajectory against the port's own
replicated path, the contract of ``tests/test_parallel.py``).  The ranks run
in spawned processes (``torch_dist_helpers``), one world per size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cggp_tpu.models import CGGP, ClusterGP
from cggp_tpu.ops.cg import ConjugateGradient
from cggp_tpu.ops.kernels import Matern32, SquaredExponential
from cggp_tpu.parallel import (ShardedCGGP, make_data_parallel_loss,
                               make_data_parallel_predict, make_mesh, shard_batch)
from cggp_tpu.training.optimize import posterior_predict_scan, predict_in_batches
from torch_dist_helpers import start_world

WORLDS = (2, 4)


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rad(key, shape):
    return np.asarray(jax.random.rademacher(key, shape, dtype=jnp.float64))


def _sharded_probes(key, p, m):
    k1, k2 = jax.random.split(key)
    return [_rad(k1, (p, m)), _rad(k2, (p, m))]


N_DP = 64  # rows of the data-parallel loss case


def _inputs(world):
    """``(port cases, JAX-side inputs)`` at one world size."""
    mesh = make_mesh(world)
    cases, jin = [], {}
    # data-parallel loss of the dense CGGP (probes: split(key, 3)[0], [1])
    rng = np.random.default_rng(0)
    n, m = N_DP, 8
    x = rng.uniform(-1, 1, (n, 2))
    y = np.sin(x[:, :1])
    model = CGGP(kernel=SquaredExponential(), conjugate_gradient=ConjugateGradient(1e-12),
                 num_data=n, num_probes=3)
    params = model.init_params(jnp.asarray(x[:m]))
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    cases.append(("dp_loss", dict(params=_tree(params), x=x, y=y,
                                  probes=[_rad(k1, (m, 3)), _rad(k2, (m, 3))])))
    jin["dp_loss"] = (model, params, x, y)
    # data-parallel predict of ClusterGP
    rng = np.random.default_rng(1)
    xd = rng.uniform(-1, 1, (n, 2))
    cgp = ClusterGP(kernel=SquaredExponential(), num_data=n)
    cparams = cgp.init_params(jnp.asarray(xd[:m]))
    cases.append(("dp_predict", dict(params=_tree(cparams), x=xd)))
    jin["dp_predict"] = (cgp, cparams, xd)
    # Adam on the sharded model: 10 steps, JAX's probes for each
    rng = np.random.default_rng(2)
    xs = rng.uniform(-1, 1, (128, 2))
    ys = np.sin(2 * xs[:, :1]) + 0.1 * rng.standard_normal((128, 1))
    counts = rng.integers(1, 9, (13, 1)).astype(np.float64)
    u = rng.standard_normal((13, 1))
    skw = dict(num_data=128, num_probes=4, error_threshold=1e-14, max_cg_iterations=64)
    smodel = ShardedCGGP(kernel=Matern32(), mesh=mesh, **skw)
    sparams = smodel.init_params(jnp.asarray(xs[:13]), pseudo_u=jnp.asarray(u),
                                 cluster_counts=jnp.asarray(counts))
    m_pad = sparams["inducing_points"].shape[0]
    keys, key = [], jax.random.PRNGKey(0)
    probes = []
    for _ in range(10):
        key, sub = jax.random.split(key)
        keys.append(sub)
        probes += _sharded_probes(sub, 4, m_pad)
    cases.append(("adam", dict(_case="model_ops", kernel="matern32", model_kw=skw,
                               params=_tree(sparams),
                               ops=[("adam", "adam", dict(x=xs, y=ys, probes=probes, steps=10,
                                                           lr=0.05))])))
    jin["adam"] = (smodel, sparams, xs, ys, keys)
    # the K-step trainer over the sharded model
    rng = np.random.default_rng(3)
    xt = rng.uniform(-1, 1, (96, 2))
    yt = np.sin(2 * xt[:, :1])
    tkw = dict(num_data=96, num_probes=2, error_threshold=1e-10, max_cg_iterations=32)
    tparams = ShardedCGGP(kernel=Matern32(), mesh=mesh, **tkw).init_params(
        jnp.asarray(xt[:11]), pseudo_u=jnp.asarray(yt[:11]), cluster_counts=jnp.ones((11, 1)))
    cases.append(("trainer_sharded", dict(params=_tree(tparams), x=xt, y=yt, model_kw=tkw,
                                          iterations=6, batch=32, lr=0.05, k=3)))
    # the hybrid dp+tp trainer step against the replicated one
    rng = np.random.default_rng(4)
    xh = rng.uniform(-1, 1, (128, 2))
    yh = np.sin(2 * xh[:, :1]) + 0.1 * rng.standard_normal((128, 1))
    hkw = dict(num_data=128, num_probes=2, error_threshold=1e-12, max_cg_iterations=32)
    hparams = ShardedCGGP(kernel=SquaredExponential(), mesh=mesh, **hkw).init_params(
        jnp.asarray(xh[:8]), noise_variance=0.1, pseudo_u=jnp.asarray(rng.standard_normal((8, 1))),
        cluster_counts=jnp.full((8, 1), 4.0))
    cases.append(("hybrid_trainer", dict(params=_tree(hparams), x=xh, y=yh, model_kw=hkw,
                                         kw=dict(iterations=4, batch_size=64,
                                                 learning_rate=0.05))))
    # mesh serving of the dense fp32 CGGP
    rng = np.random.default_rng(5)
    xv = rng.uniform(-1, 1, (200, 2)).astype(np.float32)
    vmodel = CGGP(kernel=SquaredExponential(),
                  conjugate_gradient=ConjugateGradient(1e-10, max_iterations=96),
                  num_data=200, num_probes=2)
    vparams = vmodel.init_params(jnp.asarray(xv[:24]), noise_variance=0.1,
                                 pseudo_u=jnp.asarray(rng.standard_normal((24, 1)), jnp.float32),
                                 cluster_counts=jnp.full((24, 1), 4.0, jnp.float32),
                                 dtype=jnp.float32)
    xq = rng.uniform(-1, 1, (100, 2)).astype(np.float32)
    cases.append(("dp_serving", dict(params=_tree(vparams), x=xv, xq=xq, love_rank=24)))
    jin["dp_serving"] = (vmodel, vparams, xq)
    cases.append(("mesh_errors", {}))
    return mesh, cases, jin


def _references(world, mesh, cases, jin):
    ref = {}
    model, params, x, y = jin["dp_loss"]
    key = jax.random.PRNGKey(0)
    loss_fn = lambda p, b, k: model.training_loss(p, b, k)  # noqa: E731
    ref["dp_loss"] = {"dp": float(make_data_parallel_loss(loss_fn, mesh)(
        params, shard_batch(mesh, jnp.asarray(x), jnp.asarray(y)), key)),
        "single": float(jax.jit(loss_fn)(params, (jnp.asarray(x), jnp.asarray(y)), key))}
    cgp, cparams, xd = jin["dp_predict"]
    ref["dp_predict"] = _tree(make_data_parallel_predict(
        lambda p, xq: cgp.predict_f(p, xq, full_cov=False), mesh)(
        cparams, shard_batch(mesh, jnp.asarray(xd))))
    smodel, sparams, xs, ys, keys = jin["adam"]
    import optax

    opt = optax.adam(0.05)
    mask = smodel.trainable_mask(sparams)

    @jax.jit
    def step(p, s, k):
        loss, g = jax.value_and_grad(smodel.training_loss)(p, (jnp.asarray(xs), jnp.asarray(ys)),
                                                         k)
        g = jax.tree_util.tree_map(lambda a, m_: a if m_ else jnp.zeros_like(a), g, mask)
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    p, s, losses = sparams, opt.init(sparams), []
    for k in keys:
        p, s, loss = step(p, s, k)
        losses.append(float(loss))
    ref["adam"] = np.asarray(losses)
    vmodel, vparams, xq = jin["dp_serving"]
    xq = jnp.asarray(xq)
    ref["dp_serving"] = {
        "mesh": _tree(predict_in_batches(vmodel, vparams, xq, batch_size=40, mesh=mesh))}
    post = vmodel.posterior(vparams, solver="chol")
    ref["dp_serving"]["scan30"] = _tree(posterior_predict_scan(vmodel, post, xq, batch_size=30,
                                                               mesh=mesh))
    return ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    inputs = {world: _inputs(world) for world in WORLDS}
    started = {world: start_world(tmp_path_factory.mktemp(f"dp{world}"), world,
                                  inputs[world][1]) for world in WORLDS}
    refs = {world: _references(world, *inputs[world]) for world in WORLDS}
    return {world: started[world].results() for world in WORLDS}, refs


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_loss_matches_jax_and_single_device(worlds, world):
    """The dense CGGP's loss from this rank's rows: the single-device loss
    (rtol 1e-8, JAX's own contract being 1e-6: each rank solves ``[u |
    probes | Kmn(its rows)]``, whose products round otherwise than the
    whole batch's, and CG at 1e-12 stops on a residual of ~1e-6, so the
    two solutions differ at ~1e-9) and JAX's data-parallel loss (rtol 1e-7:
    fp64, the same probes), the same value on every rank;
    ``make_data_parallel_train_step``'s Adam step equal to the
    single-device step (rtol 1e-8); each rank's solve took ``u``, the 2 x 3
    probes and only its own rows."""
    runs, refs = worlds
    got = runs[world][0]["dp_loss"]
    np.testing.assert_allclose(got["dp"], got["single"], rtol=1e-8)
    for name, want in got["step_single"].items():
        np.testing.assert_allclose(got["step_dp"][name], want, rtol=1e-8, err_msg=name)
    for r in runs[world]:
        assert r["dp_loss"]["solve_rows"] == 1 + 6 + N_DP // world
    np.testing.assert_allclose(got["dp"], refs[world]["dp_loss"]["dp"], rtol=1e-7)
    np.testing.assert_allclose(got["single"], refs[world]["dp_loss"]["single"], rtol=1e-7)
    assert len({r["dp_loss"]["dp"] for r in runs[world]}) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_predict_shards_rows(worlds, world):
    """Each rank predicts its own block of rows: together JAX's row-sharded
    outputs (atol 1e-9, JAX's tolerance against the single device)."""
    runs, refs = worlds
    for i in range(2):
        got = np.concatenate([r["dp_predict"][i] for r in runs[world]])
        np.testing.assert_allclose(got, np.asarray(refs[world]["dp_predict"][i]), atol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_training_steps_match_jax_and_improve(worlds, world):
    """Ten adam(0.05) steps of the sharded model on JAX's probes: the losses
    within rtol 1e-7 of JAX's (CG at 1e-14 in fp64), falling, the pads'
    mask unchanged."""
    runs, refs = worlds
    got = runs[world][0]["adam"]["adam"]
    np.testing.assert_allclose(got["losses"], refs[world]["adam"], rtol=1e-7)
    assert np.isfinite(got["losses"]).all() and got["losses"][-1] < got["losses"][0]
    assert got["mask"].sum() == 13 and got["mask"].shape[0] == -(-13 // world) * world


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_training_with_steps_per_call(worlds, world):
    """The K = 3 trainer composes with the sharded model: the loss after six
    steps below the loss before, both finite."""
    got = worlds[0][world][0]["trainer_sharded"]
    assert np.isfinite(got["after"]) and got["after"] < got["before"]


@pytest.mark.parametrize("world", WORLDS)
def test_trainer_mesh_hybrid_dp_tp_matches_replicated(worlds, world):
    """``train_using_adam_and_update(mesh=...)``: the trajectory equals the
    replicated-batch path's (rtol 1e-6, atol 1e-8, the JAX package's
    contract) on every rank; steps_per_call > 1 and a batch that does not
    divide the mesh are refused with the JAX package's messages."""
    runs, _ = worlds
    for rank_res in runs[world]:
        got = rank_res["hybrid_trainer"]
        for name, want in got["replicated"].items():
            np.testing.assert_allclose(got["mesh"][name], want, rtol=1e-6, atol=1e-8,
                                       err_msg=name)
        assert "steps_per_call" in got["errors"]["steps_per_call"]
        assert "divide" in got["errors"]["divide"]


@pytest.mark.parametrize("world", WORLDS)
def test_predict_in_batches_mesh_serving_matches(worlds, world):
    """Mesh serving (the batch rounded up to the world multiple; the
    Cholesky cache serves by the scan) equals the single-device serving and
    JAX's mesh serving within fp32 rounding (rtol 1e-3, atol 1e-4, JAX's
    tolerance for its mesh scan: each rank's triangular solves take fewer
    right-hand sides, which the fp32 library blocks differently, and the
    variance cancels against the kernel diagonal); the mean-only and
    forced-scan routes too, and the CG-cache loop with its stop agreed over
    the ranks (rtol 1e-4, atol 1e-5); a model with collectives of its own is
    refused."""
    runs, refs = worlds
    got = runs[world][0]["dp_serving"]
    for i in range(2):
        np.testing.assert_allclose(got["mesh"][i], got["single"][i], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got["mesh"][i], refs[world]["dp_serving"]["mesh"][i],
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got["mesh_scan"][i], got["single"][i], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got["mesh_cg"][i], got["single_cg"][i], rtol=1e-4,
                                   atol=1e-5)
    assert got["mesh_mean"][1] is None
    np.testing.assert_allclose(got["mesh_mean"][0], got["single"][0], rtol=1e-3, atol=1e-4)
    assert "own mesh collectives" in got["refused"]


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_scan_serving_matches(worlds, world):
    """posterior_predict_scan over the mesh at a batch (30) that does not
    divide it, and a LOVE cache through the mesh scan: the single-device
    scan's values (rtol 1e-3, atol 1e-4, JAX's) and JAX's mesh scan."""
    runs, refs = worlds
    got = runs[world][0]["dp_serving"]
    for i in range(2):
        np.testing.assert_allclose(got["scan30"][i], got["single"][i], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got["scan30"][i], refs[world]["dp_serving"]["scan30"][i],
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got["love_mesh"][i], got["love_single"][i], rtol=1e-3,
                                   atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_refuses_another_size(worlds, world):
    """``make_mesh(n)`` with n other than the running world's size raises
    ValueError (JAX's refusal of a silently different mesh)."""
    got = worlds[0][world][0]["mesh_errors"]
    assert all(msg is not None and "silently" in msg for msg in got.values())
