"""Port parity for gang training (``cggp_tpu_torch.training.gang``), the
cases of ``tests/test_gang.py`` against the JAX package on the same numpy
inputs, in float64.

The contract: gang training changes the schedule, never the math.  A gang
member fed the same probes and index stream as a solo run reproduces its
trajectory: the port's gang against the JAX package's solo
``make_adam_multi_step`` (the port's ``rademacher`` returns, for each
member's generator, JAX's draws from the keys JAX's solo trainer splits:
``split(step_key, 3)[0]`` and ``[1]`` of every step), and against the
port's own solo run.  The gang CG runs until every member stops, a
stopped member keeping its state; over 2 gloo ranks (spawned,
``torch_dist_helpers``) the sharded gang equals the single-process gang."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cggp_tpu_torch.models.cggp as tcggp_module
from cggp_tpu.models import CGGP as JaxCGGP
from cggp_tpu.ops import ConjugateGradient as JaxConjugateGradient
from cggp_tpu.ops import Matern32 as JaxMatern32
from cggp_tpu.training.gang import gang_eval_rmse_nlpd as jax_gang_eval
from cggp_tpu.training.gang import gang_index_chunks as jax_gang_index_chunks
from cggp_tpu.training.optimize import make_adam_multi_step as jax_multi_step
from cggp_tpu_torch.models.cggp import CGGP
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.ops.kernels import Matern32
from cggp_tpu_torch.training import adam, make_adam_multi_step
from cggp_tpu_torch.training.gang import (gang_eval_rmse_nlpd, gang_index_chunks, init_gang_adam,
                                          make_adam_gang_multi_step, per_member, stack_pytrees,
                                          train_gang_adam, unstack_pytree)
from cggp_tpu_torch.utils.store import params_from_numpy
from torch_dist_helpers import run_world

torch.set_num_threads(1)
N, M = 96, 12
PRECOND_RANK = 6  # a pivoted-Cholesky factor of half of M


def _small(seed=0, precondition=None):
    """``tests/test_gang.py``'s model: numpy data and the JAX parameters."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, 2))
    y = np.sin(x.sum(-1, keepdims=True)) + 0.1 * rng.normal(size=(N, 1))
    u = rng.normal(size=(M, 1)) * 0.3
    counts = np.maximum(rng.integers(1, 6, (M, 1)), 1).astype(float)
    jmodel = JaxCGGP(JaxMatern32(), num_data=N,
                     conjugate_gradient=JaxConjugateGradient(1e-10, max_iterations=4 * M),
                     num_probes=3, precondition=precondition,
                     precond_rank=PRECOND_RANK)
    jparams = jmodel.init_params(jnp.asarray(x[:M]), pseudo_u=jnp.asarray(u),
                                 cluster_counts=jnp.asarray(counts))
    return jmodel, jparams, x, y


def _port_model(matvec_impl="xla", precondition=None):
    return CGGP(Matern32(), num_data=N, num_probes=3, precondition=precondition,
                precond_rank=PRECOND_RANK,
                conjugate_gradient=ConjugateGradient(1e-10, max_iterations=4 * M,
                                                     matvec_impl=matvec_impl))


def _variants(jparams, scales):
    out = []
    for s in scales:
        p = jax.tree_util.tree_map(jnp.copy, jparams)
        p["kernel"]["lengthscales"] = p["kernel"]["lengthscales"] * s
        out.append(p)
    return out


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v.detach().numpy() if hasattr(v, "detach") else v)
    return out


class MemberProbes:
    """The port's ``rademacher``: each member's generator pops JAX's draws
    for that member in call order."""

    def __init__(self):
        self.queues = {}

    def feed(self, gen, key, steps):
        """JAX's solo multi-step draws from ``key`` for ``steps`` steps."""
        queue = self.queues.setdefault(id(gen), [])
        for _ in range(steps):
            key, step_key = jax.random.split(key)
            k1, k2, _ = jax.random.split(step_key, 3)
            queue += [k1, k2]

    def __call__(self, gen, shape, dtype):
        key = self.queues[id(gen)].pop(0)
        draw = jax.random.rademacher(key, tuple(shape), dtype=jnp.float64)
        return torch.as_tensor(np.asarray(draw)).to(dtype)


@pytest.fixture
def probes(monkeypatch):
    feed = MemberProbes()
    monkeypatch.setattr(tcggp_module, "rademacher", feed)
    return feed


@pytest.mark.parametrize("scales,precondition", [([1.0], None), ([1.0, 1.7], None),
                                                  ([1.0, 1.7], "chol"), ([1.0, 1.7], "pivchol")],
                         ids=["gang_of_one", "gang_of_two", "gang_of_two_chol",
                              "gang_of_two_pivchol"])
def test_gang_matches_solo_trajectories(probes, scales, precondition):
    """Each member's trajectory equals the port's solo
    ``make_adam_multi_step`` on the same index stream and probes at
    tests/test_gang.py's tolerances (losses rtol 1e-9, params rtol 1e-7 /
    atol 1e-9; the gang's reductions sum in another order, and CG run past
    M steps magnifies an ulp from one step to the next), and JAX's solo run
    at losses rtol 1e-8: the port's solo run is itself 2.0e-9 (relative)
    from JAX's at the fifth step of the second member (lengthscale x 1.7),
    the two packages' reduction orders magnified the same way.  Under the
    exact-factor and the pivoted-Cholesky preconditioners the gang's
    factors are stacked, one a member, and applied batched."""
    jmodel, jparams, x, y = _small(precondition=precondition)
    variants = _variants(jparams, scales)
    g, k_steps, lr = len(scales), 6, 0.05
    keys = jax.random.split(jax.random.PRNGKey(3), g)
    idx = np.asarray(next(jax_gang_index_chunks(jax.random.PRNGKey(9), N, batch_size=32,
                                                chunk=k_steps, gang=g)))
    data = (torch.as_tensor(x), torch.as_tensor(y))
    tvariants = [params_from_numpy(_np_tree(v), device="cpu") for v in variants]
    tmodel = _port_model(precondition=precondition)
    mask = tmodel.trainable_mask(tvariants[0])
    gens = [torch.Generator() for _ in range(g)]
    for gen, key in zip(gens, keys):
        probes.feed(gen, key, k_steps)
    optimizer, opt_state = init_gang_adam(tvariants, [lr] * g)
    step = make_adam_gang_multi_step(tmodel.training_loss, optimizer, data, mask)
    gp, _, glosses = step(stack_pytrees(tvariants), opt_state, torch.as_tensor(idx), gens)
    members = unstack_pytree(gp, g)
    assert glosses.shape == (k_steps, g)

    jdata = (jnp.asarray(x), jnp.asarray(y))
    jstep = jax_multi_step(lambda p, b, k: jmodel.training_loss(p, b, k), optax.adam(lr), jdata,
                           trainable_mask=jmodel.trainable_mask(jparams))
    solo = make_adam_multi_step(tmodel.training_loss, adam(lr), data, mask)
    for i in range(g):
        sp, _, slosses = jstep(variants[i], optax.adam(lr).init(variants[i]),
                               jnp.asarray(idx[:, i]), keys[i])
        np.testing.assert_allclose(glosses[:, i].numpy(), np.asarray(slosses), rtol=1e-8)
        for name, want in _flat(_np_tree(sp)).items():
            np.testing.assert_allclose(_flat(members[i])[name], want, rtol=1e-7, atol=1e-9,
                                       err_msg=name)
        gen = torch.Generator()
        probes.feed(gen, keys[i], k_steps)
        tp, _, tlosses = solo(tvariants[i], adam(lr).init(tvariants[i]),
                              torch.as_tensor(idx[:, i]), gen)
        np.testing.assert_allclose(glosses[:, i].numpy(), tlosses.numpy(), rtol=1e-9)
        for name, want in _flat(tp).items():
            np.testing.assert_allclose(_flat(members[i])[name], want, rtol=1e-7, atol=1e-9,
                                       err_msg=name)


def test_gang_per_model_learning_rates():
    """Each member's own rate: lr = 0 freezes that member exactly while its
    gangmate trains (tests/test_gang.py's case)."""
    jmodel, jparams, x, y = _small()
    tvariants = [params_from_numpy(_np_tree(v), device="cpu")
                 for v in _variants(jparams, [1.0, 1.0])]
    tmodel = _port_model()
    trained, losses = train_gang_adam(
        tvariants, tmodel.training_loss, (torch.as_tensor(x), torch.as_tensor(y)),
        iterations=8, batch_size=32, learning_rates=[0.05, 0.0], key=torch.Generator(),
        trainable_mask=tmodel.trainable_mask(tvariants[0]), steps_per_call=4)
    assert losses.shape == (8, 2) and np.all(np.isfinite(losses))
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        _flat(trained[0]).values(), _flat(tvariants[0]).values()))
    frozen = max(float(np.abs(a - b).max()) for a, b in zip(
        _flat(trained[1]).values(), _flat(tvariants[1]).values()))
    assert moved > 1e-4
    assert frozen == 0.0


def test_gang_eval_matches_sequential_and_jax():
    """Per-cell test RMSE and NLPD (batches of 17): the port's sequential
    per-cell values on all 48 points and JAX's gang evaluation, rtol 1e-6
    (tests/test_gang.py's tolerance: a batch's CG solves its own rows)."""
    jmodel, jparams, x, y = _small()
    variants = _variants(jparams, [0.7, 1.0, 1.6])
    test = (x[:48], y[:48])
    tvariants = [params_from_numpy(_np_tree(v), device="cpu") for v in variants]
    tmodel = _port_model()
    rmse, nlpd = gang_eval_rmse_nlpd(tmodel, stack_pytrees(tvariants), test, batch_size=17)
    assert rmse.shape == (3,) and nlpd.shape == (3,)
    for g, p in enumerate(tvariants):
        mu, var = tmodel.predict_f(p, torch.as_tensor(test[0]))
        yt = torch.as_tensor(test[1])
        r = float(torch.sqrt(torch.mean(torch.square(yt - mu))))
        lpd = tmodel.likelihood.predict_log_density(p["likelihood"], mu, var, yt)
        np.testing.assert_allclose(rmse[g], r, rtol=1e-6)
        np.testing.assert_allclose(nlpd[g], -float(torch.mean(lpd)), rtol=1e-6)
    jrmse, jnlpd = jax_gang_eval(jmodel, jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                                                *variants),
                                 (jnp.asarray(test[0]), jnp.asarray(test[1])), batch_size=17)
    np.testing.assert_allclose(rmse, np.asarray(jrmse), rtol=1e-6)
    np.testing.assert_allclose(nlpd, np.asarray(jnlpd), rtol=1e-6)


def test_gang_index_streams_are_independent():
    """[chunk, G, batch] blocks of G independent epoch permutations."""
    idx = next(gang_index_chunks(torch.Generator().manual_seed(0), n=512, batch_size=64,
                                 chunk=4, gang=3, device="cpu"))
    assert idx.shape == (4, 3, 64)
    assert not torch.equal(idx[:, 0], idx[:, 1])
    for g in range(3):  # each member's stream is an epoch permutation: no repeats
        assert torch.unique(idx[:, g]).numel() == 4 * 64


def test_gang_rejects_mismatched_learning_rates():
    jmodel, jparams, _, _ = _small()
    p = params_from_numpy(_np_tree(jparams), device="cpu")
    with pytest.raises(ValueError, match="learning rates"):
        init_gang_adam([p, p], [0.1])


def _solo_solve(cg, a, b):
    return cg.solve_with_stats(a, b)


@pytest.mark.parametrize("impl", ["xla", "pallas", "xla_high", "pallas_resident", "bf16_ir"])
def test_gang_cg_members_keep_their_solo_iterates(impl):
    """A gang of two systems of different conditioning: each member's
    solution, step count and flag equal a solo solve of it on the same
    route (the frozen member keeps its state; on the CPU "pallas" and
    "xla_high" take the plain product, "pallas_resident" B2's plain version
    member by member, "bf16_ir" member by member)."""
    rng = np.random.default_rng(0)
    mats = []
    for ridge in (1.0, 0.01):
        g = rng.standard_normal((24, 24))
        mats.append(g @ g.T / 24 + ridge * np.eye(24))
    dtype = torch.float32 if impl in ("pallas", "pallas_resident", "bf16_ir") else torch.float64
    a = torch.as_tensor(np.stack(mats)).to(dtype)
    b = torch.as_tensor(rng.standard_normal((2, 24, 3))).to(dtype)
    threshold = 1e-6 if dtype == torch.float32 else 1e-12
    cg = ConjugateGradient(threshold, max_iterations=100, matvec_impl=impl)
    sol, stats = cg.solve_with_stats(a, b)
    assert stats.steps.shape == (2,) and stats.converged.shape == (2,)
    for g in range(2):
        want, wstats = _solo_solve(cg, a[g], b[g])
        np.testing.assert_array_equal(sol[g].numpy(), want.numpy())
        assert int(stats.steps[g]) == int(wstats.steps)
        assert bool(stats.converged[g]) == bool(wstats.converged)
    if impl in ("xla", "xla_high", "pallas"):
        assert int(stats.steps[0]) < int(stats.steps[1])  # one member froze early


def test_gang_per_member_fallback_matches_batched(probes):
    """A configuration the batched ELBO does not take (precondition="rff",
    a sketch drawn from each member's generator) runs member by member and
    equals per-member solo losses bitwise; ``per_member`` wraps a one-model
    loss the same way."""
    jmodel, jparams, x, y = _small()
    tvariants = [params_from_numpy(_np_tree(v), device="cpu")
                 for v in _variants(jparams, [1.0, 1.3])]
    model = CGGP(Matern32(), num_data=N, num_probes=3, precondition="rff", precond_rank=4,
                 conjugate_gradient=ConjugateGradient(1e-10, max_iterations=4 * M))
    assert not model._gang_batches(None)
    xb, yb = torch.as_tensor(x[:32]), torch.as_tensor(y[:32])
    batch = (torch.stack([xb, xb]), torch.stack([yb, yb]))
    for loss_fn in (model.training_loss, per_member(model.training_loss)):
        gens = [torch.Generator(), torch.Generator()]
        for gen, key in zip(gens, jax.random.split(jax.random.PRNGKey(0), 2)):
            probes.feed(gen, key, 1)
        losses = loss_fn(stack_pytrees(tvariants), batch, gens)
        for g in range(2):
            gen = torch.Generator()
            probes.feed(gen, jax.random.split(jax.random.PRNGKey(0), 2)[g], 1)
            want = model.training_loss(tvariants[g], (xb, yb), gen)
            assert torch.equal(losses[g], want)


def test_gang_sharded_over_mesh_matches_single_process(tmp_path):
    """Eight members over 2 gloo ranks (four each, no collective while
    training, gathered at the end): the losses (rtol 1e-7) and members
    (rtol 1e-6, atol 1e-8) of the single-process gang, tests/test_gang.py's
    tolerances, the same on both ranks."""
    jmodel, jparams, x, y = _small()
    variants = [_np_tree(v) for v in _variants(jparams, list(np.linspace(0.8, 2.0, 8)))]
    kw = dict(iterations=6, batch_size=32, learning_rates=0.05, steps_per_call=3)
    ranks = run_world(tmp_path, 2, [("gang_sharded", dict(x=x, y=y, variants=variants,
                                                          model_kw=dict(num_data=N, num_probes=3),
                                                          kw=kw))])
    for res in ranks:
        got = res["gang_sharded"]
        np.testing.assert_allclose(got["mesh"]["losses"], got["single"]["losses"], rtol=1e-7)
        for a, b in zip(got["mesh"]["members"], got["single"]["members"]):
            for name in a:
                np.testing.assert_allclose(a[name], b[name], rtol=1e-6, atol=1e-8, err_msg=name)
    np.testing.assert_array_equal(ranks[0]["gang_sharded"]["mesh"]["losses"],
                                  ranks[1]["gang_sharded"]["mesh"]["losses"])


def test_gang_pivchol_preconditioner_matches_members():
    """The pivoted-Cholesky preconditioner of a gang's stacked systems: each
    member's factor, state and apply equal the solo ones (rtol 1e-12 in
    float64: the batched products sum in another order)."""
    from cggp_tpu_torch.ops.cg import pivoted_cholesky_preconditioner
    from cggp_tpu_torch.ops.linalg import pivoted_cholesky

    rng = np.random.default_rng(4)
    mats, lams = [], []
    for scale in (0.5, 2.0, 1.0):
        g = rng.standard_normal((20, 20))
        mats.append(scale * g @ g.T / 20)
        lams.append(rng.uniform(0.1, 0.5, 20))
    a, lam = torch.as_tensor(np.stack(mats)), torch.as_tensor(np.stack(lams))
    vec = torch.as_tensor(rng.standard_normal((3, 4, 20)))
    factors = pivoted_cholesky(a, 8)
    gang = pivoted_cholesky_preconditioner(a, lam, 8)
    z, rz = gang(vec)
    for g in range(3):
        np.testing.assert_allclose(factors[g].numpy(), pivoted_cholesky(a[g], 8).numpy(),
                                   rtol=1e-12, atol=1e-14)
        solo = pivoted_cholesky_preconditioner(a[g], lam[g], 8)
        zs, rzs = solo(vec[g])
        np.testing.assert_allclose(z[g].numpy(), zs.numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(rz[g].numpy(), rzs.numpy(), rtol=1e-12)
