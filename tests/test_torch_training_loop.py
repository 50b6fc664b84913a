"""Port parity for the training loop: ``train_using_adam_and_update`` (one step
per call and K steps per call, with an inducing update that changes M, the
preconditioner-mode resolver and chunk-frozen preconditioning),
``make_adam_multi_step``, ``Monitor`` and the four callbacks of
``cggp_tpu_torch`` against ``cggp_tpu`` with ``optax.adam`` on the CPU.

Both packages get the same batches and the same probes: the port's batch
seed (``seed_from`` in ``training/optimize.py``) is patched to the seed JAX
draws from its data key, and the port's ``rademacher`` (looked up in
``models/cggp.py``) returns, in call order, the arrays
``jax.random.rademacher`` draws from the keys JAX's trainer and callbacks
split: a fused ELBO's trace and logdet probes from ``split(step_key, 3)[0]``
and ``[1]``, ``cg_stats``' probes from ``split(key)[0]``."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cggp_tpu_torch.models.cggp as tcggp_module
import cggp_tpu_torch.training.optimize as toptimize
from cggp_tpu.models.cggp import CGGP as JaxCGGP
from cggp_tpu.ops import kernels as jkernels
from cggp_tpu.ops.cg import ConjugateGradient as JaxConjugateGradient
from cggp_tpu.selection import labels_update_inducing_parameters as jax_labels_update
from cggp_tpu.training import optimize as joptimize
from cggp_tpu.training.monitor import Monitor as JaxMonitor
from cggp_tpu_torch.models.cggp import CGGP
from cggp_tpu_torch.ops import kernels as tkernels
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.selection import labels_update_inducing_parameters
from cggp_tpu_torch.training import (Monitor, adam, create_monitor, make_adam_multi_step,
                                     make_adam_step, make_cg_stats_callback,
                                     make_metrics_callback, make_param_callback,
                                     train_using_adam_and_update)
from cggp_tpu_torch.utils.store import adam_state_from_optax, params_from_numpy

torch.set_num_threads(1)

M, P, N, B = 16, 3, 300, 32
CG64 = 1e-16  # float64, just above the reference's 1e-16 curvature guard


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, 3))
    y = np.sin(1.5 * x[:, :1]) + 0.1 * rng.standard_normal((n, 1))
    return x, y


X, Y = _data()
X_TEST, Y_TEST = _data(seed=1, n=100)


def _model_pair(precondition=None, threshold=CG64, max_iterations=None):
    common = dict(num_data=N, num_probes=P, precondition=precondition, precond_rank=4)
    return (JaxCGGP(kernel=jkernels.Matern32(), conjugate_gradient=JaxConjugateGradient(
                threshold, max_iterations=max_iterations), **common),
            CGGP(kernel=tkernels.Matern32(), conjugate_gradient=ConjugateGradient(
                threshold, max_iterations=max_iterations), **common))


def _params(jmodel, m=M):
    iv, u, counts = (a.numpy() for a in labels_update_inducing_parameters(
        (torch.as_tensor(X), torch.as_tensor(Y)), torch.as_tensor(X[:m])))
    jparams = jmodel.init_params(iv, pseudo_u=u, cluster_counts=counts, noise_variance=0.5,
                                 dtype=jnp.float64)
    return jparams, params_from_numpy(jparams, device="cpu")


class JaxProbes:
    """The port's ``rademacher``: pops ``(key, splits, index)`` entries and
    returns JAX's draw from ``split(key, splits)[index]`` at the shape asked."""

    def __init__(self):
        self.queue = []

    def elbo(self, step_key):
        self.queue += [(step_key, 3, 0), (step_key, 3, 1)]

    def cg_stats(self, key):
        self.queue.append((key, 2, 0))

    def __call__(self, gen, shape, dtype):
        key, splits, index = self.queue.pop(0)
        draw = jax.random.rademacher(jax.random.split(key, splits)[index], tuple(shape),
                                     dtype=jnp.float64)
        return torch.as_tensor(np.array(draw)).to(dtype)


@pytest.fixture
def probes(monkeypatch):
    feed = JaxProbes()
    monkeypatch.setattr(tcggp_module, "rademacher", feed)
    return feed


def _trainer_keys(key, iterations, k):
    """JAX's batch seed and every step's key, as its trainer splits them."""
    key, data_key = jax.random.split(key)
    seed = int(jax.random.randint(data_key, (), 0, np.iinfo(np.int32).max))
    step_keys = []
    for _ in range(-(-iterations // k)):
        key, sub = jax.random.split(key)
        if k == 1:
            step_keys.append(sub)
            continue
        for _ in range(k):
            sub, step_key = jax.random.split(sub)
            step_keys.append(step_key)
    return seed, step_keys


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _logs(path):
    return list(np.load(str(path), allow_pickle=True))


CASES = ["stepwise", "k_step", "update_changes_m", "resolver", "frozen_precond"]


def _case(name, jmodel, tmodel):
    """The trainer arguments of one case for each package, and what to check."""
    iterations, k = {"stepwise": (10, 1), "k_step": (10, 5), "update_changes_m": (6, 1),
                     "resolver": (6, 1), "frozen_precond": (10, 5)}[name]
    jkw, tkw = {"steps_per_call": k}, {"steps_per_call": k}
    if name == "update_changes_m":
        # The third call swaps in a selection of M - 4 points: the optimizer
        # state restarts and the step runs at the new M.
        def make_update(update, model, to_array):
            calls = []

            def update_fn(params):
                calls.append(len(calls))
                if len(calls) != 3:
                    return params
                return model.assign_clusters(params, *update((to_array(X), to_array(Y)),
                                                             to_array(X[40:52])))
            return update_fn

        jkw["update_fn"] = make_update(jax_labels_update, jmodel, jnp.asarray)
        tkw["update_fn"] = make_update(labels_update_inducing_parameters, tmodel,
                                       torch.as_tensor)
    if name == "resolver":
        def resolver_pair():
            modes = []

            def resolver(params):
                # None selects the trainer's loss_fn itself (the stepwise
                # case's program, which JAX then compiles only once).
                modes.append(["chol", None][len(modes) % 2])
                return modes[-1]
            return resolver, modes

        for kw, base in ((jkw, jmodel), (tkw, tmodel)):
            resolver, modes = resolver_pair()
            changes = []
            kw.update(
                update_fn=lambda p: p, resolve_every=2, precond_resolver=resolver,
                on_mode_change=changes.append,
                loss_fn_for_mode=lambda mode, base=base: (
                    lambda p, b, key: type(base)(
                        kernel=base.kernel, conjugate_gradient=base.conjugate_gradient,
                        num_data=N, num_probes=P, precondition=mode,
                        precond_rank=4).training_loss(p, b, key)))
            kw["_changes"] = changes
    if name == "frozen_precond":
        for kw, model in ((jkw, jmodel), (tkw, tmodel)):
            kw["precond_fn"] = model.precond_state
            kw["_loss"] = (lambda p, b, key, pc, model=model:
                           model.training_loss(p, b, key, precond_override=pc))
    return iterations, k, jkw, tkw


@pytest.mark.parametrize("name", CASES)
def test_trainer_matches_jax(name, probes, monkeypatch, tmp_path):
    precondition = {"frozen_precond": "chol"}.get(name)
    jmodel, tmodel = _model_pair(precondition)
    jparams, tparams = _params(jmodel)
    iterations, k, jkw, tkw = _case(name, jmodel, tmodel)
    jchanges, tchanges = jkw.pop("_changes", None), tkw.pop("_changes", None)
    jloss = jkw.pop("_loss", jmodel.training_loss)
    tloss = tkw.pop("_loss", tmodel.training_loss)
    key = jax.random.PRNGKey(5)
    seed, step_keys = _trainer_keys(key, iterations, k)
    for step_key in step_keys:
        probes.elbo(step_key)
    monkeypatch.setattr(toptimize, "seed_from", lambda gen: seed)

    jmon, tmon = JaxMonitor(tmp_path / "jax"), Monitor(tmp_path / "port")
    if name == "k_step":  # step labels of the chunks' first steps, every 5 steps
        jmon.add_callback("params", joptimize.make_param_callback(jmodel), record_step=5)
        tmon.add_callback("params", make_param_callback(tmodel), record_step=5)
    jout = joptimize.train_using_adam_and_update(
        jparams, jloss, (jnp.asarray(X), jnp.asarray(Y)), iterations, B, 0.01, key,
        trainable_mask=jmodel.trainable_mask(jparams), monitor=jmon, **jkw)
    tout = train_using_adam_and_update(
        tparams, tloss, (torch.as_tensor(X), torch.as_tensor(Y)), iterations, B, 0.01,
        torch.Generator(), trainable_mask=tmodel.trainable_mask(tparams), monitor=tmon, **tkw)
    assert not probes.queue  # every step drew its probes

    # fp64 CG at 1e-16 and the same Adam update on the same batches and
    # probes: over the cases the losses measured <= 8.6e-12 apart relative
    # and the parameters <= 8.8e-13; held at 1e-8 and 1e-9.
    jlog, tlog = _logs(tmp_path / "jax" / "train.logs.npy"), _logs(tmp_path / "port" /
                                                                     "train.logs.npy")
    assert [sorted(e) for e in tlog] == [sorted(e) for e in jlog]
    assert [e["step"] for e in tlog] == [e["step"] for e in jlog]
    jl = np.array([float(e["loss"]) for e in jlog if "loss" in e])
    tl = np.array([float(e["loss"]) for e in tlog if "loss" in e])
    assert len(tl) == -(-iterations // k)
    np.testing.assert_allclose(tl, jl, rtol=1e-8)
    jflat, tflat = _flat(jout), _flat(tout)
    assert set(jflat) == set(tflat)
    for leaf, want in jflat.items():
        assert tflat[leaf].shape == want.shape, leaf
        np.testing.assert_allclose(tflat[leaf], want, rtol=1e-9, atol=1e-12, err_msg=leaf)
    if name == "k_step":
        jp, tp = _logs(tmp_path / "jax" / "params.logs.npy"), _logs(tmp_path / "port" /
                                                                   "params.logs.npy")
        assert [e["step"] for e in tp] == [e["step"] for e in jp] == [0, 5]
        for te, je in zip(tp, jp):
            assert set(te) == set(je)
            for name_ in je:
                np.testing.assert_allclose(te[name_], je[name_], rtol=1e-9)
    if name == "update_changes_m":
        assert tout["inducing_points"].shape == (M - 4, 3)
    if name == "resolver":
        assert tchanges == jchanges == [None, "chol", None]


def test_multi_step_equals_stepwise():
    """K steps in one call are K single steps on the same index rows with
    the probes drawn in order from the one generator: bitwise equal."""
    _, tmodel = _model_pair("chol", threshold=1e-10)
    jmodel, _ = _model_pair()
    _, tparams = _params(jmodel)
    x, y = torch.as_tensor(X), torch.as_tensor(Y)
    idx = torch.as_tensor(np.random.default_rng(3).integers(0, N, (4, B)))
    mask = tmodel.trainable_mask(tparams)
    multi = make_adam_multi_step(tmodel.training_loss, adam(0.01), (x, y), mask)
    p1, s1, losses = multi(tparams, adam(0.01).init(tparams), idx,
                           torch.Generator().manual_seed(9))
    step = make_adam_step(tmodel.training_loss, adam(0.01), mask)
    p2, s2, gen = tparams, adam(0.01).init(tparams), torch.Generator().manual_seed(9)
    want = []
    for row in idx:
        p2, s2, loss = step(p2, s2, (x[row], y[row]), gen)
        want.append(loss)
    assert losses.shape == (4,) and torch.equal(losses, torch.stack(want))
    for leaf, value in _flat(p2).items():
        np.testing.assert_array_equal(_flat(p1)[leaf], value, err_msg=leaf)
    assert s1.count == s2.count == 4


def test_resume_from_an_optax_state_matches_jax(probes):
    """A JAX run's optax state carried into the port: three more steps in
    each package from the same state, batches and probes."""
    jmodel, tmodel = _model_pair()
    jparams, _ = _params(jmodel)
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, N, B) for _ in range(5)]
    keys = [jax.random.fold_in(jax.random.PRNGKey(1), i) for i in range(5)]
    opt = optax.adam(0.01)  # the trainer cases' step: JAX compiles it once
    jstep = joptimize.make_adam_step(jmodel.training_loss, opt, jmodel.trainable_mask(jparams))
    jstate = opt.init(jparams)
    for i in range(2):
        jparams, jstate, _ = jstep(jparams, jstate, (X[batches[i]], Y[batches[i]]), keys[i])
    tparams = params_from_numpy(jparams, device="cpu")
    tstate = adam_state_from_optax(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    assert tstate.count == 2
    tstep = make_adam_step(tmodel.training_loss, adam(0.01), tmodel.trainable_mask(tparams))
    for i in range(2, 5):
        jparams, jstate, jl = jstep(jparams, jstate, (X[batches[i]], Y[batches[i]]), keys[i])
        probes.elbo(keys[i])
        tparams, tstate, tl = tstep(tparams, tstate, (torch.as_tensor(X[batches[i]]),
                                                      torch.as_tensor(Y[batches[i]])),
                                      torch.Generator())
        # fp64: losses measured <= 6.2e-13 apart relative, parameters <=
        # 2.2e-14; held at 1e-8 and 1e-9.
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-8)
    for leaf, want in _flat(jparams).items():
        np.testing.assert_allclose(_flat(tparams)[leaf], want, rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError, match="one ScaleByAdamState"):
        adam_state_from_optax((optax.EmptyState(),))


def test_callbacks_and_create_monitor_match_jax(probes, tmp_path):
    jmodel, tmodel = _model_pair()
    jparams, tparams = _params(jmodel)
    train, test = (X, Y), (X_TEST, Y_TEST)
    jmon = joptimize.create_monitor(tmp_path / "jax", joptimize.make_metrics_callback(
        jmodel, tuple(map(jnp.asarray, train)), tuple(map(jnp.asarray, test)), batch_size=64),
        joptimize.make_param_callback(jmodel), record_step=2)
    tmon = create_monitor(tmp_path / "port", make_metrics_callback(
        tmodel, tuple(map(torch.as_tensor, train)), tuple(map(torch.as_tensor, test)),
        batch_size=64), make_param_callback(tmodel), record_step=2)
    jmon.add_callback("cg", joptimize.make_cg_stats_callback(
        jmodel, tuple(map(jnp.asarray, train)), batch_size=48), record_step=1)
    tmon.add_callback("cg", make_cg_stats_callback(
        tmodel, tuple(map(torch.as_tensor, train)), batch_size=48), record_step=1)
    for step in range(3):
        # Monitor runs callbacks in registration order: metrics (the ELBO at
        # PRNGKey(0)) on even steps, then cg_stats at fold_in(0, step).
        if step % 2 == 0:
            probes.elbo(jax.random.PRNGKey(0))
        probes.cg_stats(jax.random.fold_in(jax.random.PRNGKey(0), step))
        jmon(step, jparams)
        tmon(step, tparams)
    jmon.add_scalar("train/loss", 1.5, 3)
    tmon.add_scalar("train/loss", 1.5, 3)
    jmon.close()
    tmon.close()
    assert not probes.queue
    for name in ("metrics", "params", "cg", "train"):
        jlog, tlog = _logs(tmp_path / "jax" / f"{name}.logs.npy"), _logs(
            tmp_path / "port" / f"{name}.logs.npy")
        assert [e["step"] for e in tlog] == [e["step"] for e in jlog], name
        for te, je in zip(tlog, jlog):
            assert set(te) == set(je) and all(isinstance(v, np.ndarray) for k, v in te.items()
                                              if k != "step"), name
            for k_, want in je.items():
                # fp64 CG at 1e-16 on the same probes: RMSE, NLPD and ELBO
                # measured <= 1.6e-12 apart relative, CG steps equal; held at
                # 1e-9.  The CG residual at the stop is rounding noise
                # (~5e-17): measured 5e-25 apart, held at 1e-22 absolute.
                tol = {"rtol": 0, "atol": 1e-22} if k_ == "cg/max_error" else {"rtol": 1e-9}
                np.testing.assert_allclose(te[k_], want, err_msg=f"{name} {k_}", **tol)
    assert [e["step"] for e in _logs(tmp_path / "port" / "metrics.logs.npy")] == [0, 2]


def test_metrics_callback_raises_on_a_non_finite_elbo():
    _, tmodel = _model_pair()
    jmodel, _ = _model_pair()
    _, tparams = _params(jmodel)
    tparams["likelihood"]["variance"] = torch.full_like(tparams["likelihood"]["variance"],
                                                        float("nan"))
    cb = make_metrics_callback(tmodel, (torch.as_tensor(X), torch.as_tensor(Y)),
                               (torch.as_tensor(X_TEST), torch.as_tensor(Y_TEST)))
    with pytest.raises(FloatingPointError, match="non-finite ELBO at step 7"):
        cb(7, tparams)


def test_cg_stats_warning_and_no_false_positive_at_cap(probes):
    """A capped solve warns once per transition and logs cg/unconverged=1,
    as JAX's does; a solve converging on exactly its last permitted step
    does not."""
    key0 = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    data = (torch.as_tensor(X), torch.as_tensor(Y))
    jdata = (jnp.asarray(X), jnp.asarray(Y))
    jcap, tcap = _model_pair(threshold=1e-14, max_iterations=2)
    jparams, tparams = _params(jcap)
    want = joptimize.make_cg_stats_callback(jcap, jdata, batch_size=32)(0, jparams)
    cb = make_cg_stats_callback(tcap, data, batch_size=32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        probes.cg_stats(key0)
        out = cb(0, tparams)
        assert out == {"cg/steps": 2, "cg/max_error": pytest.approx(want["cg/max_error"],
                                                                    rel=1e-9),
                       "cg/unconverged": 1} and want["cg/unconverged"] == 1
        assert sum("max_iterations=2" in str(w.message) for w in caught) == 1
        probes.cg_stats(jax.random.fold_in(jax.random.PRNGKey(0), 1))
        cb(1, tparams)
        assert len(caught) == 1  # still unconverged: no second warning
    _, tfree = _model_pair(threshold=1e-8, max_iterations=64)
    probes.cg_stats(key0)
    steps = int(tfree.cg_stats(tparams, (data[0][:64], data[1][:64]), torch.Generator()).steps)
    assert 0 < steps < 64
    _, texact = _model_pair(threshold=1e-8, max_iterations=steps)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        probes.cg_stats(key0)
        out = make_cg_stats_callback(texact, data, batch_size=64)(0, tparams)
    assert out["cg/steps"] == steps and out["cg/unconverged"] == 0
    assert not [w for w in caught if issubclass(w.category, RuntimeWarning)]


@pytest.mark.parametrize("kwargs, error, match", [
    ({"mesh": object()}, NotImplementedError, "item 12"),
    ({"recluster_fn": lambda p: p, "steps_per_call": 2}, NotImplementedError, "item 10"),
    ({"precond_fn": lambda p: ()}, ValueError, "requires steps_per_call > 1"),
    ({"precond_resolver": lambda p: "chol"}, ValueError, "requires loss_fn_for_mode"),
    ({"precond_resolver": lambda p: "chol", "loss_fn_for_mode": lambda m: None,
      "precond_fn": lambda p: (), "steps_per_call": 2}, ValueError, "plain Adam paths only"),
    ({"precond_resolver": lambda p: "chol", "loss_fn_for_mode": lambda m: None,
      "resolve_every": 0}, ValueError, "resolve_every must be >= 1"),
], ids=["mesh", "recluster_fn", "precond_fn_k1", "resolver_no_factory", "resolver_frozen",
        "resolve_every"])
def test_trainer_refusals(kwargs, error, match):
    # JAX raises the same ValueErrors (same checks, same order); mesh and
    # recluster_fn are ported refusals naming their ROADMAP items.
    _, tmodel = _model_pair()
    jmodel, _ = _model_pair()
    _, tparams = _params(jmodel)
    with pytest.raises(error, match=match):
        train_using_adam_and_update(tparams, tmodel.training_loss,
                                    (torch.as_tensor(X), torch.as_tensor(Y)), 2, B, 0.01,
                                    torch.Generator(), **kwargs)
    if error is NotImplementedError and "recluster_fn" in kwargs:
        with pytest.raises(NotImplementedError, match="item 10"):
            make_adam_multi_step(tmodel.training_loss, adam(0.01), (X, Y),
                                 recluster_fn=lambda p: p)


@pytest.mark.parametrize("iterations, k, window, traced", [
    (4, 1, (1, 2), True),  # stops inside the loop at step 2
    (3, 1, (1, 6), True),  # still open at the end: stopped after the loop
    (1, 1, (1, 6), False),  # the loop never reaches step 1: nothing to stop
    (4, 2, (2, 3), True),  # K steps per call: chunks overlapping the window
], ids=["inside", "open_at_end", "never_started", "k_step"])
def test_profile_window_follows_jax(iterations, k, window, traced, tmp_path):
    _, tmodel = _model_pair(threshold=1e-10)
    jmodel, _ = _model_pair()
    _, tparams = _params(jmodel)
    train_using_adam_and_update(tparams, tmodel.training_loss,
                                (torch.as_tensor(X), torch.as_tensor(Y)), iterations, B, 0.01,
                                torch.Generator(), steps_per_call=k,
                                profile_dir=str(tmp_path / "trace"), profile_steps=window)
    assert (tmp_path / "trace" / "trace.json").is_file() == traced


@pytest.mark.parametrize("k", [1, 2])
def test_profile_window_opens_once(k, monkeypatch, tmp_path):
    """One trace a run: the chunks after the window do not open another."""
    opened = []
    real = toptimize._Profiler

    def counting(*args):
        opened.append(args)
        return real(*args)

    monkeypatch.setattr(toptimize, "_Profiler", counting)
    _, tmodel = _model_pair(threshold=1e-10)
    jmodel, _ = _model_pair()
    _, tparams = _params(jmodel)
    train_using_adam_and_update(tparams, tmodel.training_loss,
                                (torch.as_tensor(X), torch.as_tensor(Y)), 6, B, 0.01,
                                torch.Generator(), steps_per_call=k,
                                profile_dir=str(tmp_path / "trace"), profile_steps=(1, 2))
    assert len(opened) == 1
    assert (tmp_path / "trace" / "trace.json").is_file()
