"""Port parity for the dense CGGP training slice as a whole: ``CGGP.elbo``
(fused and unfused), ``prior_kl``, ``cg_stats``, ``ClusterGP.elbo``, the
preconditioner modes, capacity padding, ``make_adam_step`` and the serving
``"auto"`` resolvers of ``cggp_tpu_torch`` against ``cggp_tpu`` on the CPU.

Both packages get the same numpy inputs (JAX's parameters carried across by
``params_from_numpy``) and the same Rademacher probes: the port's
``rademacher``, where ``models/cggp.py`` and ``ops/logdet.py`` look it up,
returns in call order the arrays ``jax.random.rademacher`` draws from the
keys JAX's ``elbo`` / ``prior_kl`` / ``cg_stats`` split.  JAX's kernel routes
run in Pallas interpret mode, the port's their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import cggp_tpu_torch.models.cggp as tcggp_module
import cggp_tpu_torch.ops.logdet as tlogdet_module
from cggp_tpu.data import synthetic as jax_synthetic
from cggp_tpu.models.clustergp import ClusterGP as JaxClusterGP
from cggp_tpu.models.cggp import CGGP as JaxCGGP
from cggp_tpu.ops import kernels as jkernels
from cggp_tpu.ops.cg import ConjugateGradient as JaxConjugateGradient
from cggp_tpu.training.optimize import make_adam_step as jax_make_adam_step
from cggp_tpu_torch.models.clustergp import ClusterGP
from cggp_tpu_torch.models.cggp import CGGP
from cggp_tpu_torch.ops import kernels as tkernels
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.training.optimize import (_expand_trainable_mask, adam, make_adam_step,
                                              predict_in_batches)
from cggp_tpu_torch.utils.store import params_from_numpy

torch.set_num_threads(1)

M, B, P, RANK, N_TRAIN = 32, 48, 5, 8, 400
CG64 = 1e-16  # float64, just above the reference's 1e-16 curvature guard


def _problem(dtype=np.float64):
    """Inducing set, cluster state and a batch from the synthetic data; the
    batch's first 4 rows ARE inducing points (coincident, r2 = 0 in Kmn).
    noise 0.5 over counts 1..4 puts Lambda >= 0.125."""
    (x, y), _ = jax_synthetic(n=600, dim=3, seed=0)
    rng = np.random.default_rng(0)
    z = x[rng.choice(x.shape[0], M, replace=False)]
    u = y[rng.choice(y.shape[0], M, replace=False)]
    counts = rng.integers(1, 5, (M, 1)).astype(np.float64)
    xb = np.concatenate([z[:4], x[:B - 4]])
    yb = np.concatenate([u[:4], y[:B - 4]])
    return [a.astype(dtype) for a in (z, u, counts, xb, yb)]


def _models(precondition=None, impl="xla", threshold=CG64, dtype=np.float64, capacity=None,
            **kw):
    jdtype = jnp.float64 if dtype == np.float64 else jnp.float32
    common = dict(num_data=N_TRAIN, precondition=precondition, precond_rank=RANK, **kw)
    jmodel = JaxCGGP(kernel=jkernels.Matern32(), conjugate_gradient=JaxConjugateGradient(
        threshold, matvec_impl=impl), **common)
    tmodel = CGGP(kernel=tkernels.Matern32(), conjugate_gradient=ConjugateGradient(
        threshold, matvec_impl=impl), **common)
    z, u, counts, xb, yb = _problem(dtype)
    jparams = jmodel.init_params(z, pseudo_u=u, cluster_counts=counts, noise_variance=0.5,
                                 lengthscales=np.array([0.9, 1.1, 1.0]), dtype=jdtype,
                                 capacity=capacity)
    tparams = params_from_numpy(jparams, device="cpu")
    return jmodel, jparams, tmodel, tparams, (xb, yb)


def _jax_draws(key, shapes, dtype):
    """The arrays JAX's objectives draw, in call order: one per split key."""
    keys = jax.random.split(key, 3 if len(shapes) <= 3 else len(shapes))
    return [np.asarray(jax.random.rademacher(k, s, dtype=dtype)) for k, s in zip(keys, shapes)]


@pytest.fixture
def feed(monkeypatch):
    """Queue arrays for the port's rademacher, in call order."""
    queue = []

    def draw(gen, shape, dtype):
        got = torch.as_tensor(np.array(queue.pop(0)))
        assert tuple(got.shape) == tuple(shape), (got.shape, shape)
        return got.to(dtype)

    monkeypatch.setattr(tcggp_module, "rademacher", draw)
    monkeypatch.setattr(tlogdet_module, "rademacher", draw)
    return queue


def _loss_and_grads_jax(jmodel, jparams, batch, key):
    data = tuple(jnp.asarray(a) for a in batch)
    with pltpu.force_tpu_interpret_mode():  # jitted: one compile, not one per op
        loss, grads = jax.jit(jax.value_and_grad(jmodel.training_loss))(jparams, data, key)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _loss_and_grads_torch(tmodel, tparams, batch):
    leaves = {}

    def live(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = live(v, f"{prefix}{k}/")
            else:
                out[k] = leaves.setdefault(f"{prefix}{k}", v.detach().clone().requires_grad_())
        return out

    params = live(tparams)
    loss = tmodel.training_loss(params, tuple(torch.as_tensor(a) for a in batch),
                                torch.Generator())
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return float(loss.detach()), {k: (np.zeros(v.shape) if g is None else g.numpy())
                                  for (k, v), g in zip(leaves.items(), grads)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_loss_and_grads(t, j, rtol):
    (tloss, tgrads), (jloss, jgrads) = t, j
    assert np.isfinite(tloss)
    assert tloss == pytest.approx(jloss, rel=rtol)
    jflat = _flat(jgrads)
    assert set(tgrads) == set(jflat)
    for name, want in jflat.items():
        got = tgrads[name]
        assert got.shape == want.shape and np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1.0),
                                   err_msg=name)


# Float64 CG at 1e-16 in both packages: losses measured <= 9e-11 apart
# relative, gradients <= 3.3e-9 (the worst entry over every parameter,
# scaled by the leaf's largest entry or 1; the pivoted-Cholesky runs, whose
# solves take the most steps; the exact-factor runs ~4e-15); held at 1e-7.
RTOL64 = 1e-7


@pytest.mark.parametrize("precondition", [None, "pivchol", "chol", "auto"])
@pytest.mark.parametrize("fused", [True, False])
def test_elbo_and_every_gradient_match_jax(feed, fused, precondition):
    jmodel, jparams, tmodel, tparams, batch = _models(precondition, fuse_kl_solves=fused)
    key = jax.random.PRNGKey(11)
    feed.extend(_jax_draws(key, [(M, P), (M, P)], jnp.float64))
    want = _loss_and_grads_jax(jmodel, jparams, batch, key)
    got = _loss_and_grads_torch(tmodel, tparams, batch)
    assert not feed
    _assert_loss_and_grads(got, want, RTOL64)
    # The batch's inducing points (r2 = 0) get finite, JAX-equal gradients.
    assert np.isfinite(got[1]["inducing_points"]).all()


@pytest.mark.parametrize("variant", ["capacity_zero_fused", "capacity_slq_chol_unfused",
                                     "slq_pivchol_fused"])
def test_elbo_variants_match_jax(feed, variant):
    capacity = 40 if variant.startswith("capacity") else None
    logdet = "slq" if "slq" in variant else "zero"
    precondition = "chol" if "chol" in variant and "pivchol" not in variant else (
        "pivchol" if "pivchol" in variant else None)
    jmodel, jparams, tmodel, tparams, batch = _models(
        precondition, capacity=capacity, logdet_variant=logdet, slq_lanczos_iters=8,
        fuse_kl_solves=variant.endswith("_fused"))
    m = tparams["inducing_points"].shape[0]
    key = jax.random.PRNGKey(12)
    feed.extend(_jax_draws(key, [(m, P), (m, P)], jnp.float64))
    want = _loss_and_grads_jax(jmodel, jparams, batch, key)
    got = _loss_and_grads_torch(tmodel, tparams, batch)
    assert not feed
    _assert_loss_and_grads(got, want, RTOL64)
    if capacity:  # the pads are exact no-ops: zero gradient
        assert m == capacity
        np.testing.assert_array_equal(got[1]["pseudo_u"][M:], 0.0)
        np.testing.assert_array_equal(got[1]["inducing_points"][M:], 0.0)


def test_num_probes_none_gradients_match_the_cholesky_oracle():
    # With exact trace and logdet gradients (num_probes=None: solves against
    # the identity), the CG ELBO's gradients are the Cholesky ClusterGP's,
    # and its value misses exactly 0.5 logdet(Kmm + Lambda).  The port's
    # ClusterGP ELBO is held to the JAX package's first.
    jmodel, jparams, tmodel, tparams, batch = _models(num_probes=None)
    oracle = ClusterGP(kernel=tkernels.Matern32(), num_data=N_TRAIN)
    joracle = JaxClusterGP(kernel=jkernels.Matern32(), num_data=N_TRAIN)
    jvalue = float(joracle.elbo(jparams, tuple(jnp.asarray(a) for a in batch)))
    data = tuple(torch.as_tensor(a) for a in batch)
    assert float(oracle.elbo(tparams, data)) == pytest.approx(jvalue, rel=1e-12)
    got = _loss_and_grads_torch(tmodel, tparams, batch)
    want = _loss_and_grads_torch(oracle, tparams, batch)
    kmm = tkernels.Matern32().K(tparams["kernel"], tparams["inducing_points"])
    lam = oracle.diag_variance(tparams)[:, 0]
    logdet = float(torch.linalg.slogdet(kmm + torch.diag(lam))[1])
    # CG at 1e-16 against an exact factorization: measured <= 9.4e-11 apart
    # relative; held at 1e-8.
    assert got[0] + 0.5 * logdet == pytest.approx(want[0], rel=1e-8)
    for name in ("kernel/variance", "kernel/lengthscales", "likelihood/variance"):
        np.testing.assert_allclose(got[1][name], want[1][name], rtol=1e-8, err_msg=name)


def test_cg_stats_match_jax(feed):
    jmodel, jparams, tmodel, tparams, batch = _models("pivchol")
    key = jax.random.PRNGKey(13)
    k0 = jax.random.split(key)[0]
    feed.append(np.asarray(jax.random.rademacher(k0, (M, 2 * P), dtype=jnp.float64)))
    jstats = jmodel.cg_stats(jparams, tuple(jnp.asarray(a) for a in batch), key)
    tstats = tmodel.cg_stats(tparams, tuple(torch.as_tensor(a) for a in batch),
                             torch.Generator())
    assert int(tstats.steps) == int(jstats.steps)
    assert bool(tstats.converged) == bool(jstats.converged)
    # The final 0.5 r.z per row sits at the float64 roundoff floor, where
    # summation order moves it by up to 70 % (measured 1.7e-17 apart):
    # both under the threshold, compared at half of it.
    assert (tstats.error.numpy() <= CG64).all()
    np.testing.assert_allclose(tstats.error.numpy(), np.asarray(jstats.error), rtol=0,
                               atol=0.5 * CG64)


def _trajectory(impl, dtype, steps, threshold):
    jmodel, jparams, tmodel, tparams, _ = _models(None, impl=impl, threshold=threshold,
                                                  dtype=dtype)
    (x, y), _ = jax_synthetic(n=600, dim=3, seed=0)
    rng = np.random.default_rng(1)
    batches = [(x[i].astype(dtype), y[i].astype(dtype))
               for i in (rng.choice(N_TRAIN, B, replace=False) for _ in range(steps))]
    jdtype = jnp.float64 if dtype == np.float64 else jnp.float32
    keys = [jax.random.fold_in(jax.random.PRNGKey(0), i) for i in range(steps)]
    jstep = jax_make_adam_step(jmodel.training_loss, optax.adam(0.01),
                               jmodel.trainable_mask(jparams))
    opt_state = optax.adam(0.01).init(jparams)
    jlosses = []
    with pltpu.force_tpu_interpret_mode():
        for batch, key in zip(batches, keys):
            jparams, opt_state, loss = jstep(jparams, opt_state,
                                             tuple(jnp.asarray(a) for a in batch), key)
            jlosses.append(float(loss))
    queue = [a for key in keys for a in _jax_draws(key, [(M, P), (M, P)], jdtype)]
    tstep = make_adam_step(tmodel.training_loss, adam(0.01), tmodel.trainable_mask(tparams))
    tstate = adam(0.01).init(tparams)
    tlosses = []
    gen = torch.Generator()
    original = tcggp_module.rademacher
    tcggp_module.rademacher = lambda g, shape, d: torch.as_tensor(np.array(queue.pop(0)))
    try:
        for batch in batches:
            tparams, tstate, loss = tstep(tparams, tstate,
                                          tuple(torch.as_tensor(a) for a in batch), gen)
            tlosses.append(float(loss))
    finally:
        tcggp_module.rademacher = original
    assert not queue
    return np.array(tlosses), np.array(jlosses), _flat(tparams), _flat(jparams)


def test_adam_trajectory_matches_jax_over_20_steps():
    tl, jl, tp, jp = _trajectory("xla", np.float64, 20, CG64)
    # Float64 CG at 1e-16 and the same Adam update: over 20 steps the losses
    # measured <= 1.6e-10 apart relative, the parameters <= 7.4e-12; held
    # at 1e-8 and 1e-9.
    np.testing.assert_allclose(tl, jl, rtol=1e-8)
    for name, want in jp.items():
        np.testing.assert_allclose(tp[name], want, rtol=1e-9, atol=1e-12, err_msg=name)
    assert jl[-1] < jl[0]  # it trains


@pytest.mark.parametrize("impl", ["pallas_resident", "pallas"])
def test_adam_steps_on_kernel_routes_match_jax(impl):
    # float32 on both sides: B2 solves in float32 in both packages, B1
    # multiplies in float32; at threshold 1e-8 three steps' losses measured
    # <= 9.1e-7 apart relative, the parameters <= 2.5e-7; held at 1e-4.
    tl, jl, tp, jp = _trajectory(impl, np.float32, 3, 1e-8)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for name, want in jp.items():
        np.testing.assert_allclose(tp[name], want, rtol=1e-4, atol=1e-6, err_msg=name)


def test_adam_update_is_optax_adam_with_zeroed_masked_gradients():
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal(3), "b": {"c": rng.standard_normal((2, 2))}}
    grads = [{"a": rng.standard_normal(3), "b": {"c": rng.standard_normal((2, 2))}}
             for _ in range(4)]
    grads[2]["b"]["c"][0, 0] = np.nan  # frozen: NaN times zero stays NaN, as in JAX
    mask = {"a": True, "b": False}
    jstate = optax.adam(0.05).init(params)
    tstate = adam(0.05).init(params_from_numpy(params, device="cpu"))
    jparams, tparams = params, params_from_numpy(params, device="cpu")
    for g in grads:
        jg = jax.tree_util.tree_map(lambda v, m: v * m, g, {"a": True, "b": {"c": False}})
        jup, jstate = optax.adam(0.05).update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, jup)
        tg = params_from_numpy(g, device="cpu")
        full = _expand_trainable_mask(mask, tg)
        assert full == {"a": True, "b": {"c": False}}
        tg = {"a": tg["a"] * float(full["a"]), "b": {"c": tg["b"]["c"] * float(full["b"]["c"])}}
        tup, tstate = adam(0.05).update(tg, tstate, tparams)
        tparams = {"a": tparams["a"] + tup["a"], "b": {"c": tparams["b"]["c"] + tup["b"]["c"]}}
    for name, want in _flat(jparams).items():
        got = _flat(tparams)[name]
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-14, atol=1e-15,
                                   equal_nan=True, err_msg=name)


@pytest.mark.parametrize("name", ["se", "matern12", "matern32", "matern52"])
def test_kernel_gradient_at_coincident_points_matches_jax(name):
    # x[0] == z[0] exactly, in one dimension, where |x|^2 + |z|^2 - 2 x.z is
    # exactly 0 (each term is the same rounded square), so max(r2, 0) ties.
    # JAX's jnp.maximum passes half the gradient at a tie, the port's
    # torch.clamp all of it; but what it passes it to, d r2 = 2 (xs - zs)
    # d(xs - zs), is exactly 0 there, so the gradients agree for every
    # kernel (and matern12/32 read r2 only through sqrt(max(r2, 1e-36)),
    # which passes nothing at r2 = 0).
    z = np.array([[0.3], [1.1]])
    x = np.array([[0.3], [-0.4], [0.9]])
    jk, tk = jkernels.kernel_by_name(name), tkernels.kernel_by_name(name)
    jkp = jk.init_params(1.3, np.array([0.8]), dtype=jnp.float64)
    tkp = params_from_numpy(jkp, device="cpu")

    def jsum(kp, xx):
        return jnp.sum(jnp.sin(jk.K(kp, xx, jnp.asarray(z))))

    jg_kp, jg_x = jax.grad(jsum, argnums=(0, 1))(jkp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tkp.items()}
    tx = torch.as_tensor(x).requires_grad_()
    torch.sum(torch.sin(tk.K(leaves, tx, torch.as_tensor(z)))).backward()
    xs = torch.as_tensor(x[:1]) / tk.lengthscales(tkp)
    zs = torch.as_tensor(z[:1]) / tk.lengthscales(tkp)
    raw = torch.sum(xs * xs) + torch.sum(zs * zs) - 2.0 * torch.sum(xs * zs)
    assert float(raw) == 0.0  # the tie this test is about
    for k in ("variance", "lengthscales"):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(jg_kp[k]), rtol=1e-12,
                                   atol=1e-14, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), rtol=1e-12, atol=1e-14)


def test_trainable_masks_match_jax():
    jmodel, jparams, tmodel, tparams, _ = _models(capacity=40)
    assert tmodel.trainable_mask(tparams) == jax.tree_util.tree_map(
        bool, jmodel.trainable_mask(jparams))
    assert tmodel.trainable_mask(tparams, trainable_pseudo_u=True)["pseudo_u"] is True


def test_auto_resolvers_and_preconditioned_posterior_match_jax():
    jmodel, jparams, tmodel, tparams, batch = _models("auto")
    assert tmodel.resolve_precondition(tparams) == jmodel.resolve_precondition(jparams) == "chol"
    assert tmodel.resolve_serving_solver(tparams) == jmodel.resolve_serving_solver(jparams)
    xq = batch[0]
    for solver in ("auto", "cg"):
        jpost = jmodel.posterior(jparams, solver=solver)
        tpost = tmodel.posterior(tparams, solver=solver)
        assert (tpost.chol is None) == (jpost.chol is None)
        assert isinstance(tpost.precond_state, dict) == isinstance(jpost.precond_state, dict)
        jmean, jvar = jmodel.posterior_predict(jpost, jnp.asarray(xq))
        tmean, tvar = tmodel.posterior_predict(tpost, torch.as_tensor(xq))
        # float64 CG at 1e-16 or a Cholesky solve: measured <= 2e-15 apart.
        np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=0, atol=1e-9)
        np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), rtol=0, atol=1e-9)
    mean, var = predict_in_batches(tmodel, tparams, torch.as_tensor(xq), batch_size=16)
    jmean, jvar = jmodel.predict_f(jparams, jnp.asarray(xq))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0, atol=1e-9)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=0, atol=1e-9)


def test_auto_chol_with_a_non_finite_factor_falls_back_to_cg():
    _, _, _, tparams, batch = _models()
    tparams["cluster_counts"] = -tparams["cluster_counts"]  # Kmm + Lambda indefinite

    class AlwaysChol(CGGP):  # a resolver that picks "chol" for this indefinite system
        def resolve_serving_solver(self, params):
            return "chol"

    model = AlwaysChol(kernel=tkernels.Matern32(), num_data=N_TRAIN,
                       conjugate_gradient=ConjugateGradient(1e-8, max_iterations=5))
    with pytest.warns(RuntimeWarning, match="falling back to CG"):
        mean, _ = predict_in_batches(model, tparams, torch.as_tensor(batch[0]))
    assert mean.shape == (B, 1)
    with pytest.raises(FloatingPointError):
        predict_in_batches(model, tparams, torch.as_tensor(batch[0]), posterior_solver="chol")


@pytest.mark.parametrize("call", ["rff", "lanczos", "key"])
def test_training_refusals(call):
    jmodel, jparams, tmodel, tparams, batch = _models()
    data = tuple(torch.as_tensor(a) for a in batch)
    if call == "rff":
        # precondition="rff" is ported now (it raised here before): the loss
        # and every gradient are the unpreconditioned ones (the probes are
        # drawn before the sketch, so both runs draw the same), within what
        # the stop rule leaves: |r|^2 <= 2e-16 bounds each solution's error
        # by 1.1e-7 (lam >= 0.125).  Measured: loss 5.2e-9 relative,
        # gradients <= 1.0e-6 (the worst entry of a leaf over its largest
        # entry or 1); held at 1e-5.
        model = CGGP(kernel=tkernels.Matern32(), conjugate_gradient=ConjugateGradient(CG64),
                     num_data=N_TRAIN, precondition="rff", precond_rank=RANK)
        got = _loss_and_grads_torch(model, tparams, batch)
        want = _loss_and_grads_torch(tmodel, tparams, batch)
        assert got[0] == pytest.approx(want[0], rel=1e-5)
        for name, w in want[1].items():
            np.testing.assert_allclose(got[1][name], w, rtol=0,
                                       atol=1e-5 * max(np.abs(w).max(), 1.0), err_msg=name)
    elif call == "lanczos":
        # LOVE serving is ported (it raised here before): its variances
        # equal JAX's LOVE cache's (its parity is tests/test_torch_love.py's).
        xq = torch.as_tensor(batch[0][:16])
        got = tmodel.posterior_predict(tmodel.posterior(tparams, solver="lanczos"), xq)
        want = jmodel.posterior_predict(jmodel.posterior(jparams, solver="lanczos"),
                                        jnp.asarray(batch[0][:16]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-7)
    else:
        with pytest.raises(ValueError, match="generator"):
            tmodel.elbo(tparams, data)
