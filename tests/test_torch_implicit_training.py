"""Port parity for matrix-free training: ``ImplicitCGGP.elbo`` /
``training_loss`` and their gradients, ``prior_kl``, ``cg_stats``,
``precond_state`` with ``precond_override``, the ``"pivchol"`` and ``"rff"``
preconditioners, the ``"slq"`` logdet, multi-output ``pseudo_u``,
re-clustering, the trainable mask and the K-step trainer of
``cggp_tpu_torch`` against ``cggp_tpu`` on the CPU, in float64, at the JAX
package's own test size (``tests/test_implicit_model.py::_models``: m = 13
padded to 16 with block 8, n = 96, 4 probes, absolute threshold 1e-14).

Both packages get the same numpy inputs (JAX's parameters carried across by
``params_from_numpy``) and the same probes: the port's ``rademacher``, where
``models/rowcg.py`` looks it up, returns in call order the arrays
``jax.random.rademacher`` draws from the keys JAX's objectives split (trace
probes from ``split(key)[0]``, logdet probes from ``split(key)[1]``;
``cg_stats`` draws from ``key`` itself).  For ``"rff"`` the port's
``basis_theta_parameter`` returns JAX's frequencies from
``PRNGKey(precond_seed)``.  With ``use_pallas=True`` the JAX route's kernel
runs in Pallas interpret mode (as ``tests/test_implicit_model.py`` runs it)
and the port's its plain version; both multiply in float32 there."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cggp_tpu.ops.pallas_gram as jax_pallas_gram
import cggp_tpu_torch.models.rowcg as trowcg_module
import cggp_tpu_torch.ops.rff as trff_module
from cggp_tpu.models.implicit import ImplicitCGGP as JaxImplicitCGGP
from cggp_tpu.ops import kernels as jkernels
from cggp_tpu.ops import rff as jax_rff
from cggp_tpu.training.optimize import make_adam_multi_step as jax_make_adam_multi_step
from cggp_tpu_torch.models.implicit import ImplicitCGGP
from cggp_tpu_torch.ops import kernels as tkernels
from cggp_tpu_torch.training import adam, make_adam_multi_step
from cggp_tpu_torch.utils.store import params_from_numpy

torch.set_num_threads(1)

M, BLOCK, N, P = 13, 8, 96, 4
M_PAD = 16
THRESHOLD = 1e-14


def _data(u_width=1):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (N, 2))
    y = np.sin(2 * x[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    counts = rng.integers(1, 9, (M, 1)).astype(np.float64)
    u = rng.standard_normal((M, u_width))
    return x, y, counts, u


def _pair(use_pallas=False, u_width=1, **kw):
    common = dict(num_data=N, num_probes=P, error_threshold=THRESHOLD, max_cg_iterations=64,
                  block=BLOCK, use_pallas=use_pallas, **kw)
    jmodel = JaxImplicitCGGP(kernel=jkernels.Matern32(), **common)
    tmodel = ImplicitCGGP(kernel=tkernels.Matern32(), **common)
    x, y, counts, u = _data(u_width)
    jparams = jmodel.init_params(x[:M], pseudo_u=u, cluster_counts=counts,
                                 lengthscales=np.array([0.9, 1.1]), noise_variance=0.3,
                                 dtype=jnp.float64)
    return jmodel, jparams, tmodel, params_from_numpy(jparams, device="cpu"), (x, y)


class JaxDraws:
    """The port's ``rademacher``: pops ``(key, index)`` entries and returns
    JAX's draw from ``key`` (``index`` None) or ``split(key)[index]`` at the
    shape asked."""

    def __init__(self):
        self.queue = []

    def elbo(self, key):
        self.queue += [(key, 0), (key, 1)]

    def __call__(self, gen, shape, dtype):
        key, index = self.queue.pop(0)
        if index is not None:
            key = jax.random.split(key)[index]
        draw = jax.random.rademacher(key, tuple(shape), dtype=jnp.float64)
        return torch.as_tensor(np.array(draw)).to(dtype)


@pytest.fixture
def draws(monkeypatch):
    feed = JaxDraws()
    monkeypatch.setattr(trowcg_module, "rademacher", feed)
    return feed


@pytest.fixture(autouse=True)
def jax_theta(monkeypatch):
    """The port's RFF frequencies are JAX's, from the key the JAX model
    uses (``PRNGKey(precond_seed)``; every model here keeps seed 0)."""

    def theta(kernel, params, num_bases, generator, ndim=None):
        jkp = {k: jnp.asarray(v.detach().numpy()) for k, v in params.items()}
        jkernel = jkernels.Kernel(name=kernel.name, positive_lower=kernel.positive_lower)
        got = jax_rff.basis_theta_parameter(jkernel, jkp, num_bases, jax.random.PRNGKey(0),
                                            ndim=ndim)
        return torch.as_tensor(np.array(got))

    monkeypatch.setattr(trff_module, "basis_theta_parameter", theta)


@pytest.fixture
def jax_interpret_gram(monkeypatch):
    """Run the JAX use_pallas route's kernel in interpret mode with blocks
    that fit m = 16 (as tests/test_implicit_model.py does)."""
    orig = jax_pallas_gram.kuu_matvec

    def interpreted(z_scaled, lam, p, variance, kernel_name="se", **kw):
        kw.update(interpret=True, block_n=16, block_m=16)
        return orig(z_scaled, lam, p, variance, kernel_name, **kw)

    monkeypatch.setattr(jax_pallas_gram, "kuu_matvec", interpreted)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _torch_value_and_grads(fn, tparams):
    """``fn(params)`` and its gradient with respect to every leaf (zeros
    where it does not reach)."""
    leaves = {}

    def live(tree, prefix=""):
        return {k: (live(v, f"{prefix}{k}/") if isinstance(v, dict) else
                    leaves.setdefault(f"{prefix}{k}", v.detach().clone().requires_grad_()))
                for k, v in tree.items()}

    value = fn(live(tparams))
    grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
    return float(value.detach()), {k: (np.zeros(v.shape) if g is None else g.numpy())
                                   for (k, v), g in zip(leaves.items(), grads)}


def _jax_value_and_grads(fn, jparams):
    value, grads = jax.jit(jax.value_and_grad(fn))(jparams)
    return float(value), _flat(grads)


def _assert_close(t, j, rtol):
    (tval, tgrads), (jval, jgrads) = t, j
    assert np.isfinite(tval)
    assert tval == pytest.approx(jval, rel=rtol, abs=rtol)
    assert set(tgrads) == set(jgrads)
    for name, want in jgrads.items():
        got = tgrads[name]
        assert got.shape == want.shape and np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1.0),
                                   err_msg=name)


# Float64 on the blocked route in both packages, the worst entry over every
# leaf scaled by the leaf's largest entry or 1: preconditioned cases measured
# <= 3.1e-12 apart (gradients) and <= 3.5e-16 (losses); the unpreconditioned
# solves run longer and drift further: <= 7.9e-8 (gradients, relative
# threshold) and <= 1.1e-9 (losses).  Held at 1e-6.  The kernel routes
# multiply in float32 (JAX's interpret-mode kernel, the port's plain
# version) inside a float64 CG: gradients <= 7.9e-6 apart, losses <=
# 3.7e-7; held at 5e-5.
RTOL64 = 1e-6
RTOL_KERNEL_ROUTE = 5e-5


def _elbo_case(name):
    """``(model kwargs, u width)`` of a named ELBO case."""
    return {"plain": ({}, 1), "pivchol": ({"precondition": "pivchol", "precond_rank": 6}, 1),
            "rff": ({"precondition": "rff", "precond_rank": 6}, 1),
            "slq": ({"logdet_variant": "slq", "slq_lanczos_iters": 13}, 1),
            "relative": ({"relative_threshold": True}, 1),
            "multi_output": ({"precondition": "pivchol", "precond_rank": 6}, 2)}[name]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", ["plain", "pivchol", "rff", "slq", "relative", "multi_output"])
def test_elbo_and_every_gradient_match_jax(draws, jax_interpret_gram, case, use_pallas):
    kw, u_width = _elbo_case(case)
    jmodel, jparams, tmodel, tparams, (x, y) = _pair(use_pallas, u_width, **kw)
    key = jax.random.PRNGKey(3)
    draws.elbo(key)
    jdata = (jnp.asarray(x), jnp.asarray(y))
    want = _jax_value_and_grads(lambda p: jmodel.training_loss(p, jdata, key), jparams)
    got = _torch_value_and_grads(
        lambda p: tmodel.training_loss(p, (torch.as_tensor(x), torch.as_tensor(y)),
                                       torch.Generator()), tparams)
    assert not draws.queue
    _assert_close(got, want, RTOL_KERNEL_ROUTE if use_pallas else RTOL64)
    # The pads are exact no-ops: their pseudo_u gradient is exactly 0.
    assert np.all(got[1]["pseudo_u"][M:] == 0.0)
    assert got[1]["pseudo_u"].shape == (M_PAD, u_width)


@pytest.mark.parametrize("variant", ["zero", "slq"])
def test_prior_kl_matches_jax(draws, variant):
    kw = {"logdet_variant": variant, "slq_lanczos_iters": 13}
    jmodel, jparams, tmodel, tparams, _ = _pair(precondition="pivchol", precond_rank=6, **kw)
    key = jax.random.PRNGKey(7)
    draws.elbo(key)  # the same split: trace probes, then logdet probes
    want = _jax_value_and_grads(lambda p: jmodel.prior_kl(p, key), jparams)
    got = _torch_value_and_grads(lambda p: tmodel.prior_kl(p, torch.Generator()), tparams)
    assert not draws.queue
    _assert_close(got, want, RTOL64)


def test_slq_value_matches_the_cholesky_logdet():
    """The SLQ ELBO tracks the exact ClusterGP ELBO (the JAX package's own
    check, tests/test_implicit_model.py: 96 probes, 13 Lanczos steps,
    rtol 0.05)."""
    from cggp_tpu_torch.models.clustergp import ClusterGP

    _, _, tmodel, tparams, (x, y) = _pair(logdet_variant="slq", slq_lanczos_iters=13)
    slq = ImplicitCGGP(kernel=tkernels.Matern32(), num_data=N, num_probes=96,
                       error_threshold=THRESHOLD, max_cg_iterations=64, block=BLOCK,
                       logdet_variant="slq", slq_lanczos_iters=13)
    dense = ClusterGP(kernel=tkernels.Matern32(), num_data=N)
    x_, u_, counts_ = (tparams[k][:M] for k in ("inducing_points", "pseudo_u",
                                                "cluster_counts"))
    dparams = dense.init_params(x_, pseudo_u=u_, cluster_counts=counts_,
                                lengthscales=np.array([0.9, 1.1]), noise_variance=0.3,
                                dtype=torch.float64, device="cpu")
    data = (torch.as_tensor(x), torch.as_tensor(y))
    e_slq = float(slq.elbo(tparams, data, torch.Generator().manual_seed(5)))
    e_dense = float(dense.elbo(dparams, data))
    assert e_slq == pytest.approx(e_dense, rel=0.05, abs=0.5)


def test_cg_stats_match_jax(draws):
    jmodel, jparams, tmodel, tparams, (x, y) = _pair(precondition="pivchol", precond_rank=6)
    key = jax.random.PRNGKey(11)
    draws.queue.append((key, None))  # cg_stats draws 2P probes from the key itself
    want = jmodel.cg_stats(jparams, (jnp.asarray(x), jnp.asarray(y)), key)
    got = tmodel.cg_stats(tparams, (torch.as_tensor(x), torch.as_tensor(y)), torch.Generator())
    assert int(got.steps) == int(want.steps)
    assert bool(got.converged) == bool(want.converged) and bool(got.converged)
    # The residuals sit at rounding level (1e-27 to 1e-22): both under the
    # threshold is what they can show.
    assert got.error.shape == np.asarray(want.error).shape
    assert float(got.error.max()) <= THRESHOLD and float(np.max(want.error)) <= THRESHOLD


@pytest.mark.parametrize("precondition", ["pivchol", "rff"])
def test_precond_state_and_override_match_jax(draws, precondition):
    jmodel, jparams, tmodel, tparams, (x, y) = _pair(precondition=precondition, precond_rank=6)
    jstate = jmodel.precond_state(jparams)
    tstate = tmodel.precond_state(tparams)
    assert len(tstate) == len(jstate) == 3
    # q's columns are eigenvectors: compare the projector Q diag(w) Q^T.
    for t, j in ((tstate, jstate),):
        tq, tw, td = t
        jq, jw, jd = (np.asarray(a) for a in j)
        np.testing.assert_allclose(td.numpy(), jd, rtol=1e-12)
        np.testing.assert_allclose((tq * tw) @ tq.T, (jq * jw) @ jq.T, atol=1e-10)
    key = jax.random.PRNGKey(13)
    draws.elbo(key)
    jdata = (jnp.asarray(x), jnp.asarray(y))
    want = _jax_value_and_grads(
        lambda p: jmodel.training_loss(p, jdata, key, precond_override=jstate), jparams)
    got = _torch_value_and_grads(
        lambda p: tmodel.training_loss(p, (torch.as_tensor(x), torch.as_tensor(y)),
                                       torch.Generator(), precond_override=tstate), tparams)
    _assert_close(got, want, RTOL64)


def test_assign_clusters_and_trainable_mask_match_jax():
    jmodel, jparams, tmodel, tparams, (x, y) = _pair()
    rng = np.random.default_rng(1)
    for m_new in (7, 21):  # one panel; three panels after re-padding to 24
        iv, means = rng.uniform(-1, 1, (m_new, 2)), rng.standard_normal((m_new, 1))
        counts = rng.integers(1, 5, (m_new, 1)).astype(np.float64)
        want = jmodel.assign_clusters(jparams, iv, means, counts)
        got = tmodel.assign_clusters(tparams, iv, means, counts)
        for key in ("inducing_points", "pseudo_u", "cluster_counts", "inducing_mask"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), key)
        assert got["inducing_points"].shape[0] == (m_new if m_new <= BLOCK else 24)
    capacity = 32
    jcap = jmodel.init_params(x[:M], capacity=capacity, dtype=jnp.float64)
    tcap = params_from_numpy(jcap, device="cpu")
    new = tmodel.init_params(x[M:M + 20], capacity=capacity, dtype=torch.float64, device="cpu")
    args = [new[k] for k in ("inducing_points", "pseudo_u", "cluster_counts", "inducing_mask")]
    got = tmodel.assign_clusters_device(tcap, *args)
    want = jmodel.assign_clusters_device(jcap, *(jnp.asarray(a.numpy()) for a in args))
    for key in ("inducing_points", "pseudo_u", "cluster_counts", "inducing_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), key)
    with pytest.raises(ValueError, match="capacity"):
        tmodel.assign_clusters_device(tparams, *args)
    # The mask never trains (it would under ClusterGP's default mask).
    for kw in ({}, {"trainable_inducing_points": True, "trainable_pseudo_u": True}):
        tmask = tmodel.trainable_mask(tparams, **kw)
        assert tmask["inducing_mask"] is False
        assert tmask == jax.tree_util.tree_map(bool, jmodel.trainable_mask(jparams, **kw))


# Ten Adam steps in float64, K = 5 a call, from the same batches and probes:
# losses measured <= 1.5e-9 apart relative and parameters after 10 steps
# <= 1.4e-10 without a preconditioner (<= 1.4e-14 and 7.3e-14 under
# pivchol); held at 1e-8.
TRAJECTORY_RTOL = 1e-8


@pytest.mark.parametrize("precondition", [None, "pivchol"])
def test_adam_multi_step_trajectory_matches_jax(draws, precondition):
    jmodel, jparams, tmodel, tparams, (x, y) = _pair(precondition=precondition, precond_rank=6)
    k, b = 5, 24
    idx = np.random.default_rng(2).integers(0, N, (2, k, b))
    key = jax.random.PRNGKey(17)
    jstep = jax.jit(jax_make_adam_multi_step(jmodel.training_loss, optax.adam(0.01),
                                             (jnp.asarray(x), jnp.asarray(y)),
                                             jmodel.trainable_mask(jparams)))
    tstep = make_adam_multi_step(tmodel.training_loss, adam(0.01),
                                 (torch.as_tensor(x), torch.as_tensor(y)),
                                 tmodel.trainable_mask(tparams))
    jp, jopt, tp, topt = jparams, optax.adam(0.01).init(jparams), tparams, adam(0.01).init(tparams)
    gen = torch.Generator()
    for chunk in idx:
        # JAX's K-step call splits (key, step_key) once a step.
        sub = key
        for _ in range(k):
            sub, step_key = jax.random.split(sub)
            draws.elbo(step_key)
        jp, jopt, jlosses = jstep(jp, jopt, jnp.asarray(chunk), key)
        tp, topt, tlosses = tstep(tp, topt, torch.as_tensor(chunk), gen)
        key = jax.random.split(key)[0]
        np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=TRAJECTORY_RTOL)
    assert not draws.queue
    jflat, tflat = _flat(jp), _flat(tp)
    for name, want in jflat.items():
        np.testing.assert_allclose(tflat[name], want, rtol=TRAJECTORY_RTOL, atol=1e-12,
                                   err_msg=name)
    moved = jflat["kernel/lengthscales"] - np.asarray(jparams["kernel"]["lengthscales"])
    assert np.abs(moved).max() > 1e-3  # the parameters trained


def test_training_loop_with_reclustering_and_callbacks_on_the_matrix_free_model(tmp_path):
    """``train_using_adam_and_update`` on ``ImplicitCGGP`` (port only; the
    K-step parity with JAX is above): a cover-tree update each chunk that
    changes M and re-pads it through ``assign_clusters``, and a monitor with
    the metrics, parameter and CG-statistics callbacks, whose logged values
    are finite and move."""
    from cggp_tpu_torch.selection import covertree_update_inducing_parameters
    from cggp_tpu_torch.training import (create_monitor, make_cg_stats_callback,
                                         make_metrics_callback, make_param_callback,
                                         train_using_adam_and_update)

    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.uniform(-2, 2, (300, 2)))
    y = torch.sin(1.5 * x[:, :1]) + 0.1 * torch.as_tensor(rng.standard_normal((300, 1)))
    model = ImplicitCGGP(kernel=tkernels.Matern32(), num_data=300, num_probes=3,
                         error_threshold=1e-8, relative_threshold=True, max_cg_iterations=200,
                         block=16, precondition="pivchol", precond_rank=8)
    resolutions = iter([0.5, 0.8, 0.5])

    def update_fn(params):
        z, u, counts = covertree_update_inducing_parameters((x, y), next(resolutions),
                                                            backend="numpy")
        return model.assign_clusters(params, z, u, counts)

    z0, u0, c0 = covertree_update_inducing_parameters((x, y), 0.5, backend="numpy")
    params = model.init_params(z0, pseudo_u=u0, cluster_counts=c0, dtype=torch.float64,
                               device="cpu")
    sizes = []
    monitor = create_monitor(str(tmp_path), make_metrics_callback(model, (x, y), (x, y),
                                                                  batch_size=128),
                             make_param_callback(model), record_step=4, use_tensorboard=False)
    cg = make_cg_stats_callback(model, (x, y), batch_size=64)
    monitor.add_callback("cg", lambda step, p: (sizes.append(p["inducing_points"].shape[0]),
                                                cg(step, p))[1], record_step=4)
    out = train_using_adam_and_update(params, model.training_loss, (x, y), 12, 32, 0.05,
                                      torch.Generator().manual_seed(0), update_fn=update_fn,
                                      trainable_mask=model.trainable_mask(params),
                                      monitor=monitor, steps_per_call=4)
    # M changed and was re-padded: a multiple of the block, or one panel.
    assert len(set(sizes)) == 2 and all(s <= 16 or s % 16 == 0 for s in sizes)
    assert out["inducing_points"].shape[0] == sizes[-1]
    logs = {name: list(np.load(str(tmp_path / f"{name}.logs.npy"), allow_pickle=True))
            for name in ("metrics", "params", "cg")}
    assert [int(e["step"]) for e in logs["metrics"]] == [0, 4, 8]
    for name, key in (("metrics", "test/rmse"), ("metrics", "train/elbo"),
                      ("params", "kernel/variance"), ("params", "likelihood/variance")):
        values = [float(e[key]) for e in logs[name]]
        assert all(np.isfinite(values)) and len(set(values)) == len(values), (key, values)
    assert not any(int(e["cg/unconverged"]) for e in logs["cg"])
