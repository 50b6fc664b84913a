"""Port parity for the four L-BFGS trainers of ``training/optimize.py``
against ``cggp_tpu``'s, float64 on the CPU.

* ``train_using_lbfgs_and_update`` (scipy's L-BFGS-B): fed the JAX
  package's own objective, bridged into torch (``_bridge``), it must make
  the same iterates as JAX's trainer; on the two packages' own ``GPR``
  objectives (values 1e-13 apart) the iterates agree for 10 iterations.
  Past that this problem amplifies the rounding of the two objectives
  chaotically (measured: after 60 iterations JAX's run stops at -305.65,
  the port's at -317.05), so the 60-iteration comparison uses the bridge.
* ``train_using_device_lbfgs`` (``optax.lbfgs``'s two-loop recursion and
  zoom line search, ported): its first 10 iterates against optax's on the
  two packages' own objectives, and the loss after 60 iterations.
* frozen leaves, ``update_fn`` and the monitor, the two vanilla variants,
  and ``IterGPR`` with fixed probes on the blocked route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from cggp_tpu.models import GPR as JaxGPR
from cggp_tpu.models import SGPR as JaxSGPR
from cggp_tpu.models.itergpr import IterGPR as JaxIterGPR
from cggp_tpu.ops import kernels as jkernels
from cggp_tpu.training import optimize as jopt
from cggp_tpu_torch.models import GPR, SGPR, IterGPR
from cggp_tpu_torch.ops import kernels as tkernels
from cggp_tpu_torch.training import (train_using_device_lbfgs, train_using_lbfgs_and_update,
                                     train_vanilla_using_lbfgs,
                                     train_vanilla_using_lbfgs_and_standard_ip_update)
from cggp_tpu_torch.utils.store import flatten_params, params_from_numpy

torch.set_num_threads(1)


def _gpr_problem(n=60):
    """``tests/test_training.py::test_device_lbfgs_matches_scipy_on_gpr``'s
    problem: both packages' GPR losses and init parameters."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (n, 2))
    y = np.sin(x[:, :1].sum(-1, keepdims=True)) + 0.05
    jmodel = JaxGPR(kernel=jkernels.SquaredExponential())
    jparams = jmodel.init_params(input_dim=2, noise_variance=0.5)
    tmodel = GPR(kernel=tkernels.SquaredExponential())
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jdata, tdata = (jnp.asarray(x), jnp.asarray(y)), (torch.as_tensor(x), torch.as_tensor(y))
    return (lambda p: jmodel.training_loss(p, jdata), jparams,
            lambda p: tmodel.training_loss(p, tdata), tparams)


def _bridge(jax_loss, jparams):
    """A torch loss over the port's parameter dict that evaluates
    ``jax_loss`` (and its gradient) at the same raveled values: the two
    trainers then see one objective."""
    _, unravel = ravel_pytree(jparams)
    value_and_grad = jax.jit(jax.value_and_grad(lambda flat: jax_loss(unravel(flat))))

    class Bridge(torch.autograd.Function):
        @staticmethod
        def forward(ctx, flat):
            value, grad = value_and_grad(jnp.asarray(flat.detach().numpy()))
            ctx.grad = torch.as_tensor(np.array(grad))
            return torch.tensor(float(value), dtype=torch.float64)

        @staticmethod
        def backward(ctx, grad_output):
            return grad_output * ctx.grad

    def loss(params):
        leaves = [_leaf(params, name) for name in sorted(flatten_params(params))]
        return Bridge.apply(torch.cat([leaf.reshape(-1) for leaf in leaves]))

    return loss


def _leaf(params, name):
    for part in name.split("/"):
        params = params[part]
    return params


def _rel_gap(jax_params, port_params):
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jax_params))
    got = flatten_params(port_params)
    assert set(got) == set(want)
    return max(float(np.max(np.abs(got[k] - want[k]) / np.abs(want[k]))) for k in want)


class Recorder:
    """A monitor that keeps ``(step, flat params)`` of every call, and the
    evaluations of ``counting`` (a :class:`Counting` loss) before each."""

    def __init__(self, counting=None):
        self.calls, self.flushed, self.marks, self.counting = [], 0, [], counting

    def __call__(self, step, params):
        self.calls.append((int(step), flatten_params(params)))
        if self.counting is not None:
            self.marks.append(self.counting.evaluations)

    def flush(self):
        self.flushed += 1

    def linesearch_steps(self):
        """Each iteration's line-search steps (``record_step=1``): its
        evaluations less the one at the iterate."""
        return [b - a - 1 for a, b in zip([0] + self.marks, self.marks)]


class Counting:
    """A loss that counts its evaluations."""

    def __init__(self, loss_fn):
        self.loss_fn, self.evaluations = loss_fn, 0

    def __call__(self, params):
        self.evaluations += 1
        return self.loss_fn(params)


def test_scipy_trainer_makes_jax_s_iterates_on_one_objective():
    jloss, jparams, _, tparams = _gpr_problem()
    want = jopt.train_using_lbfgs_and_update(jparams, jloss, 60)
    counted = Counting(_bridge(jloss, jparams))
    monitor = Recorder(counted)
    got = train_using_lbfgs_and_update(tparams, counted, 60, monitor=monitor)
    # Measured: bitwise equal (the same scipy run on the same values).
    assert _rel_gap(want, got) <= 1e-6
    assert len(monitor.calls) == 60 and counted.evaluations == monitor.marks[-1] > 60


def test_scipy_trainer_on_the_port_s_own_objective():
    jloss, jparams, tloss, tparams = _gpr_problem()
    want = jopt.train_using_lbfgs_and_update(jparams, jloss, 10)
    got = train_using_lbfgs_and_update(tparams, tloss, 10)
    # Measured: 7.6e-10 relative after 10 iterations.
    assert _rel_gap(want, got) <= 1e-6
    assert float(tloss(got)) < float(tloss(tparams)) - 100.0


def test_device_trainer_makes_optax_s_iterates():
    jloss, jparams, tloss, tparams = _gpr_problem()
    counted = Counting(tloss)
    want, got = Recorder(), Recorder(counted)
    jopt.train_using_device_lbfgs(jparams, jloss, 10, monitor=want, record_step=1)
    train_using_device_lbfgs(tparams, counted, 10, monitor=got, record_step=1)
    assert [s for s, _ in got.calls] == [s for s, _ in want.calls] == list(range(1, 11))
    # Measured: the 10 iterates within 7.0e-9 relative of optax's.
    for (_, g), (_, w) in zip(got.calls, want.calls):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    # One evaluation at each iterate and one per line-search step (1 to 20).
    steps = got.linesearch_steps()
    assert len(steps) == 10 and all(1 <= k <= 20 for k in steps)
    assert counted.evaluations == 10 + sum(steps)


def test_device_trainer_loss_after_60_iterations_matches_optax():
    jloss, jparams, tloss, tparams = _gpr_problem()
    want = float(jloss(jopt.train_using_device_lbfgs(jparams, jloss, 60)))
    got = float(tloss(train_using_device_lbfgs(tparams, tloss, 60)))
    # Measured: 7.8e-8 relative (-317.06330 against optax's -317.06327).
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got < float(tloss(tparams)) - 1.0


@pytest.mark.parametrize("trainer", ["scipy", "device"])
def test_frozen_leaves_stay_bitwise_in_place(trainer):
    jloss, jparams, tloss, tparams = _gpr_problem()
    for mask in ({"kernel": True, "likelihood": False},
                 {"kernel": {"variance": True, "lengthscales": True},
                  "likelihood": {"variance": False}}):
        if trainer == "scipy":
            got = train_using_lbfgs_and_update(tparams, tloss, 10, trainable_mask=mask)
        else:
            got = train_using_device_lbfgs(tparams, tloss, 10, trainable_mask=mask)
        assert torch.equal(got["likelihood"]["variance"], tparams["likelihood"]["variance"])
        assert not torch.allclose(got["kernel"]["lengthscales"], tparams["kernel"]["lengthscales"])
    if trainer == "device":
        want = jopt.train_using_device_lbfgs(jparams, jloss, 10, trainable_mask=mask)
        assert _rel_gap(want, got) <= 1e-6  # measured 1.2e-11


def test_update_fn_and_monitor_fire_every_iteration_in_the_scipy_trainer():
    jloss, jparams, tloss, tparams = _gpr_problem()
    seen, got = [], Recorder()

    def update_fn(p):
        seen.append(float(p["kernel"]["variance"]))
        return p

    train_using_lbfgs_and_update(tparams, tloss, 7, update_fn=update_fn, monitor=got)
    want = Recorder()
    jopt.train_using_lbfgs_and_update(jparams, jloss, 7, update_fn=lambda p: p, monitor=want)
    assert [s for s, _ in got.calls] == [s for s, _ in want.calls] == list(range(7))
    assert len(seen) == 7 and got.flushed == want.flushed == 1
    # The monitor sees the parameters after each iteration (and the update).
    assert len({c["kernel/variance"].item() for _, c in got.calls}) == 7


def test_update_fn_changes_frozen_leaves_between_iterations():
    """Frozen leaves are carried outside the vector: an update_fn that moves
    one is honoured at the next evaluation (the likelihood frozen here)."""
    _, _, tloss, tparams = _gpr_problem()
    evaluated = []

    def loss(p):
        evaluated.append(float(p["likelihood"]["variance"]))
        return tloss(p)

    def update_fn(p):
        return {**p, "likelihood": {"variance": p["likelihood"]["variance"] + 0.01}}

    got = train_using_lbfgs_and_update(tparams, loss, 3, update_fn=update_fn,
                                       trainable_mask={"kernel": True, "likelihood": False})
    start = float(tparams["likelihood"]["variance"])
    assert evaluated[0] == start and max(evaluated) == pytest.approx(start + 0.02)
    assert float(got["likelihood"]["variance"]) == pytest.approx(start + 0.03)


def test_device_monitor_fires_every_record_step():
    jloss, jparams, tloss, tparams = _gpr_problem()
    got = Recorder()
    train_using_device_lbfgs(tparams, tloss, 10, monitor=got, record_step=4)
    want = Recorder()
    jopt.train_using_device_lbfgs(jparams, jloss, 10, monitor=want, record_step=4)
    assert [s for s, _ in got.calls] == [s for s, _ in want.calls] == [4, 8, 10]
    assert got.flushed == 1
    assert train_using_device_lbfgs(tparams, tloss, 0) is tparams
    assert train_using_lbfgs_and_update(tparams, tloss, 0) is tparams


def _sgpr_problem():
    """``tests/test_training.py::test_vanilla_lbfgs_variants``' problem."""
    rng = np.random.default_rng(42)
    x = rng.uniform(-1, 1, (64, 2))
    y = np.sin(2 * x[:, :1])
    jmodel, tmodel = JaxSGPR(kernel=jkernels.SquaredExponential()), \
        SGPR(kernel=tkernels.SquaredExponential())
    jparams = jmodel.init_params(jnp.asarray(x[:8]), dtype=jnp.float64)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jdata, tdata = (jnp.asarray(x), jnp.asarray(y)), (torch.as_tensor(x), torch.as_tensor(y))
    return (x, lambda p: jmodel.training_loss(p, jdata), jparams,
            lambda p: tmodel.training_loss(p, tdata), tparams)


def test_vanilla_lbfgs_matches_jax():
    """On the bridged objective the port's run is JAX's for all 15
    iterations (measured bitwise).  On the port's own SGPR, with the
    inducing points trained, the two objectives' rounding is amplified
    from the fourth iteration on (measured: 2.0e-11 relative after 3
    iterations, 3.8e-3 after 5, 0.72 after 15), so that comparison stops
    at 3."""
    _, jloss, jparams, tloss, tparams = _sgpr_problem()
    want = jopt.train_vanilla_using_lbfgs(jparams, jloss, 15)
    assert _rel_gap(want, train_vanilla_using_lbfgs(tparams, _bridge(jloss, jparams), 15)) <= 1e-6
    got = train_vanilla_using_lbfgs(tparams, tloss, 3)
    assert _rel_gap(jopt.train_vanilla_using_lbfgs(jparams, jloss, 3), got) <= 1e-6
    assert float(tloss(got)) < float(tloss(tparams))


def test_vanilla_lbfgs_with_inducing_assignment_matches_jax():
    x, jloss, jparams, tloss, tparams = _sgpr_problem()
    calls = {"jax": 0, "port": 0}

    def clustering(who):
        def fn():
            calls[who] += 1
            return x[:8] + 0.01 * calls[who]
        return fn

    want = jopt.train_vanilla_using_lbfgs_and_standard_ip_update(
        jparams, jloss, clustering("jax"), 10)
    got = train_vanilla_using_lbfgs_and_standard_ip_update(
        tparams, tloss, clustering("port"), 10)
    assert calls["port"] == calls["jax"] >= 1  # once per optimizer iteration
    np.testing.assert_allclose(got["inducing_points"].numpy(), x[:8] + 0.01 * calls["port"],
                               rtol=1e-15)
    # Measured: 1.2e-10 relative.
    assert _rel_gap(want, got) <= 1e-6
    bridged = train_vanilla_using_lbfgs_and_standard_ip_update(
        tparams, _bridge(jloss, jparams), clustering("port"), 10)
    assert torch.equal(bridged["inducing_points"], torch.as_tensor(x[:8] + 0.01 * calls["port"]))


def test_scipy_trainer_on_itergpr_with_fixed_probes():
    """``paper_gpr --iterative``'s objective at N = 512 on the blocked
    route (block 64, pivoted Cholesky rank 16, relative 1e-12, SLQ 20), 8
    fixed Rademacher probes: the loss is deterministic, as L-BFGS needs.
    The two packages' SLQ values of the same estimator are 2.8e-9 apart
    relative at the init parameters (Lanczos in another summation order;
    ``tests/test_torch_itergpr.py`` measures the same)."""
    rng = np.random.default_rng(3)
    n = 512
    x = rng.uniform(-2, 2, (n, 2))
    y = np.sin(x.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((n, 1))
    probes = (2 * rng.integers(0, 2, (8, n)) - 1).astype(np.float64)
    common = dict(error_threshold=1e-12, relative_threshold=True, max_cg_iterations=512,
                  num_probes=8, slq_lanczos_iters=20, precondition="pivchol", precond_rank=16,
                  block=64)
    jmodel, tmodel = JaxIterGPR(kernel=jkernels.Matern32(), **common), \
        IterGPR(kernel=tkernels.Matern32(), **common)
    jparams = jmodel.init_params(2, dtype=jnp.float64)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jdata, tdata = (jnp.asarray(x), jnp.asarray(y)), (torch.as_tensor(x), torch.as_tensor(y))
    jprobes, tprobes = jnp.asarray(probes), torch.as_tensor(probes)
    jloss = jax.jit(lambda p: jmodel.training_loss(p, jdata, probes=jprobes))
    want = jopt.train_using_lbfgs_and_update(jparams, jloss, 4)
    got = train_using_lbfgs_and_update(
        tparams, lambda p: tmodel.training_loss(p, tdata, probes=tprobes), 4)
    # Measured: 6.6e-8 relative after 4 iterations.
    assert _rel_gap(want, got) <= 1e-6
    assert float(jloss(want)) < float(jloss(jparams))


def test_device_trainer_line_search_steps_at_fp32_match_optax():
    """Both device trainers on ``IterGPR``'s float32 objective (N = 256,
    fixed probes, the blocked route, relative 1e-4), 18 iterations: optax
    (run here step by step, reading its ``num_linesearch_steps``) and the
    port (its evaluations between monitor calls).  Measured: the same counts
    for the first 12 iterations (1 to 4 steps); then, once the decrease
    sinks under fp32 noise, both take 18-20 steps of the cap of 20 in most
    iterations (of the last 7, optax 4, the port 5), as the port does at
    N = 16,384 on the card.  Held: the first 11 equal, and at least 3 of
    the last 7 at 18 or more in each run."""
    import optax

    n, iterations, agree = 256, 18, 11
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    y = (np.sin(x.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    probes = (2 * rng.integers(0, 2, (8, n)) - 1).astype(np.float32)
    common = dict(error_threshold=1e-4, relative_threshold=True, max_cg_iterations=n,
                  num_probes=8, slq_lanczos_iters=20, precondition="pivchol", precond_rank=16,
                  block=64)
    with jax.enable_x64(False):
        jmodel = JaxIterGPR(kernel=jkernels.Matern32(), **common)
        jparams = jmodel.init_params(2, dtype=jnp.float32)
        jdata, jprobes = (jnp.asarray(x), jnp.asarray(y)), jnp.asarray(probes)

        def jloss(p):
            return jmodel.training_loss(p, jdata, probes=jprobes)

        opt = optax.lbfgs(memory_size=10)

        @jax.jit
        def step(p, s):
            value, grads = jax.value_and_grad(jloss)(p)
            updates, s = opt.update(grads, s, p, value=value, grad=grads, value_fn=jloss)
            return optax.apply_updates(p, updates), s

        p, s, want = jparams, opt.init(jparams), []
        for _ in range(iterations):
            p, s = step(p, s)
            want.append(int(optax.tree_utils.tree_get(s, "num_linesearch_steps")))
        tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tmodel = IterGPR(kernel=tkernels.Matern32(), **common)
    tdata, tprobes = (torch.as_tensor(x), torch.as_tensor(y)), torch.as_tensor(probes)
    counted = Counting(lambda q: tmodel.training_loss(q, tdata, probes=tprobes))
    monitor = Recorder(counted)
    train_using_device_lbfgs(tparams, counted, iterations, monitor=monitor, record_step=1)
    got = monitor.linesearch_steps()
    assert tparams["kernel"]["variance"].dtype == torch.float32
    assert got[:agree] == want[:agree], (got, want)
    for run in (got, want):
        assert sum(k >= 18 for k in run[agree:]) >= 3, (got, want)
