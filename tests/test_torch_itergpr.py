"""Port parity for the exact GP models: ``IterGPR`` (matrix-free CG) and the
dense ``GPR`` of ``cggp_tpu_torch`` against ``cggp_tpu`` on the CPU, in
float64 unless a test says otherwise, mirroring ``tests/test_itergpr.py``.

Both packages get the same numpy inputs (JAX's parameters carried across by
``params_from_numpy``) and the same probes, given explicitly or, where the
model draws them, JAX's draws returned by the port's ``rademacher``
(looked up by name in ``models/itergpr.py``).  Scaled-identity probes
``sqrt(N) I`` make the Hutchinson gradient and the full-depth SLQ value
exact, so there both models also equal the dense ``GPR``.  Full-depth SLQ
over N probe rows costs ~N^4 on the CPU, so its cases stay at N <= 96; the
others run at N = 200 with ``block=64`` (pads 56).  With
``use_pallas=True`` the JAX route's kernel runs in Pallas interpret mode
and the port's its plain version (kernel B3 needs a card; its CUDA tests
are ``tests/test_torch_cuda_itergpr.py``).  For ``"rff"`` the port's
``basis_theta_parameter`` returns JAX's frequencies."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import cggp_tpu.ops.pallas_gram as jax_pallas_gram
import cggp_tpu_torch.models.itergpr as titergpr_module
import cggp_tpu_torch.ops.cg_implicit as cg_implicit_module
import cggp_tpu_torch.ops.rff as trff_module
from cggp_tpu.models.gpr import GPR as JaxGPR
from cggp_tpu.models.itergpr import IterGPR as JaxIterGPR
from cggp_tpu.ops import kernels as jkernels
from cggp_tpu.ops import rff as jax_rff
from cggp_tpu.ops.cg import cg_loop as jax_cg_loop
from cggp_tpu.training.optimize import predict_in_batches as jax_predict_in_batches
from cggp_tpu.training.optimize import train_chunked_adam as jax_train_chunked_adam
from cggp_tpu.training.optimize import train_full_batch_adam as jax_train_full_batch_adam
from cggp_tpu_torch.models import GPR, IterGPR, IterGPRPosterior
from cggp_tpu_torch.ops import kernels as tkernels
from cggp_tpu_torch.ops.cg import cg_loop, precond_apply_or_identity, spectral_precond_state
from cggp_tpu_torch.training import predict_in_batches, train_chunked_adam, train_full_batch_adam
from cggp_tpu_torch.utils.store import params_from_numpy

torch.set_num_threads(1)

N, DIM, BLOCK = 200, 3, 64  # padded to 256
KERNELS = {"se": (jkernels.SquaredExponential, tkernels.SquaredExponential),
           "matern32": (jkernels.Matern32, tkernels.Matern32)}


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, (n, DIM))
    y = np.sin(x.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((n, 1))
    return x, y


def _pair(kernel="matern32", noise=0.1, **kw):
    """JAX's and the port's model with the same settings and parameters."""
    jk, tk = KERNELS[kernel]
    jmodel, tmodel = JaxIterGPR(kernel=jk(), **kw), IterGPR(kernel=tk(), **kw)
    jparams = jmodel.init_params(DIM, noise_variance=noise,
                                 lengthscales=np.array([0.5, 0.6, 0.7]), dtype=jnp.float64)
    return jmodel, jparams, tmodel, params_from_numpy(jparams, device="cpu")


def _exact(n, **kw):
    """Exact-probe settings: absolute 1e-13, no cap in practice, full-depth SLQ."""
    return dict(error_threshold=1e-13, max_cg_iterations=4 * n, relative_threshold=False,
                slq_lanczos_iters=n, **kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _port_value_and_grads(fn, tparams):
    """``fn(params)`` and its gradient in every leaf."""
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


def _assert_close(got, want, rtol):
    """Value and every gradient, each gradient's worst entry relative to its
    largest entry (or 1)."""
    (gval, ggrads), (wval, wgrads) = got, want
    assert np.isfinite(gval) and gval == pytest.approx(wval, rel=rtol, abs=rtol)
    assert set(ggrads) == set(wgrads)
    for name, w in wgrads.items():
        g = ggrads[name]
        assert g.shape == w.shape and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * max(np.abs(w).max(), 1.0),
                                   err_msg=name)


@pytest.fixture
def jax_theta(monkeypatch):
    """The port's RFF frequencies are JAX's, from ``PRNGKey(precond_seed)``
    (seed 0 here)."""

    def theta(kernel, params, num_bases, generator, ndim=None):
        jkp = {k: jnp.asarray(v.detach().numpy()) for k, v in params.items()}
        jkernel = jkernels.Kernel(name=kernel.name, positive_lower=kernel.positive_lower)
        return torch.as_tensor(np.array(jax_rff.basis_theta_parameter(
            jkernel, jkp, num_bases, jax.random.PRNGKey(0), ndim=ndim)))

    monkeypatch.setattr(trff_module, "basis_theta_parameter", theta)


@pytest.fixture
def jax_interpret_gram(monkeypatch):
    """JAX's ``use_pallas`` route with its kernel in interpret mode, blocks
    of 128 (two by two at N_pad = 256)."""
    orig = jax_pallas_gram.kuu_matvec

    def interpreted(z_scaled, lam, p, variance, kernel_name="se", **kw):
        kw.update(interpret=True, block_n=128, block_m=128)
        return orig(z_scaled, lam, p, variance, kernel_name, **kw)

    monkeypatch.setattr(jax_pallas_gram, "kuu_matvec", interpreted)


class JaxDraws:
    """The port's ``rademacher``: pops JAX keys and returns
    ``jax.random.rademacher``'s draw from each at the shape asked."""

    def __init__(self):
        self.keys = []

    def __call__(self, gen, shape, dtype):
        draw = jax.random.rademacher(self.keys.pop(0), tuple(shape), dtype=jnp.float64)
        return torch.as_tensor(np.array(draw)).to(dtype)


@pytest.fixture
def draws(monkeypatch):
    feed = JaxDraws()
    monkeypatch.setattr(titergpr_module, "rademacher", feed)
    return feed


# -- the marginal likelihood and its gradients -----------------------------------

# Exact probes, float64, both packages on the blocked route.  Each CG stops
# at 0.5 ||r||^2 <= 1e-13, so two runs whose sums differ in order stop at
# solutions up to ~||r|| / lambda_min apart: the values measured <= 2.2e-10
# apart relative and the gradients <= 7.1e-10 (relative to each leaf's
# largest entry); held at 5e-9.  Against the dense GPR (Cholesky): <= 2.1e-10
# (values) and <= 2.2e-8 (gradients); held at 1e-7.
RTOL_JAX = 5e-9
RTOL_DENSE = 1e-7

EXACT_CASES = {
    # n <= block: one panel, no pads.
    "slq_one_panel": (48, "se", _exact(48, precondition=None)),
    # 90 -> 96 at block 32, scanned panels, preconditioned.
    "slq_padded_pivchol": (90, "matern32", _exact(90, block=32, precondition="pivchol",
                                                  precond_rank=16)),
    # "zero": the value omits exactly 0.5 logdet; N = 200 at block 64.
    "zero_padded": (N, "matern32", _exact(N, block=BLOCK, logdet_variant="zero",
                                          precondition="pivchol", precond_rank=16)),
}


@pytest.mark.parametrize("case", list(EXACT_CASES))
def test_mll_and_gradients_match_jax_and_dense_gpr(case):
    n, kernel, kw = EXACT_CASES[case]
    jmodel, jparams, tmodel, tparams = _pair(kernel, **kw)
    x, y = _data(n)
    probes = np.sqrt(n) * np.eye(n)  # real-N rows: both models pad the columns
    jdata = (jnp.asarray(x), jnp.asarray(y))
    want = _jax_value_and_grads(
        lambda p: jmodel.training_loss(p, jdata, probes=jnp.asarray(probes)), jparams)
    got = _port_value_and_grads(lambda p: tmodel.training_loss(p, (x, y), probes=probes),
                                tparams)
    _assert_close(got, want, RTOL_JAX)
    dense = GPR(kernel=tmodel.kernel)
    dval, dgrads = _port_value_and_grads(lambda p: dense.training_loss(p, (x, y)), tparams)
    if kw.get("logdet_variant") == "zero":
        chol = torch.linalg.cholesky(dense.kernel.K(tparams["kernel"], torch.as_tensor(x))
                                     + 0.1 * torch.eye(n, dtype=torch.float64))
        dval -= float(torch.sum(torch.log(torch.diagonal(chol))))  # the loss omits +0.5 logdet
    _assert_close(got, (dval, dgrads), RTOL_DENSE)


# Rademacher probes and Lanczos at depth 10 over pads: the same estimator in
# both packages.  Float64 at relative 1e-12: measured <= 1.4e-9 (values) and
# <= 6.3e-8 (gradients) apart over pivchol, rff (with JAX's frequencies) and
# no preconditioner; held at 5e-7.
RTOL_PRECOND = 5e-7


@pytest.mark.parametrize("precondition", ["pivchol", "rff", None])
def test_preconditioned_mll_with_pads_matches_jax(jax_theta, precondition):
    jmodel, jparams, tmodel, tparams = _pair(
        error_threshold=1e-12, max_cg_iterations=400, block=BLOCK, precondition=precondition,
        precond_rank=8, num_probes=4, slq_lanczos_iters=10)
    x, y = _data()
    probes = np.random.default_rng(1).choice([-1.0, 1.0], size=(4, 256))  # N_pad columns
    jdata = (jnp.asarray(x), jnp.asarray(y))
    want = _jax_value_and_grads(
        lambda p: jmodel.training_loss(p, jdata, probes=jnp.asarray(probes)), jparams)
    got = _port_value_and_grads(lambda p: tmodel.training_loss(p, (x, y), probes=probes),
                                tparams)
    _assert_close(got, want, RTOL_PRECOND)


# The kernel routes multiply in float32 (JAX's interpret-mode kernel, the
# port's plain version) inside a float64 CG: measured <= 2.5e-8 (values) and
# <= 6.5e-7 (gradients) apart; held at 1e-5.
RTOL_KERNEL_ROUTE = 1e-5


def test_kernel_route_matches_jax_interpret_mode(jax_interpret_gram):
    jmodel, jparams, tmodel, tparams = _pair(
        error_threshold=1e-10, max_cg_iterations=400, block=BLOCK, precondition="pivchol",
        precond_rank=8, num_probes=4, slq_lanczos_iters=10, use_pallas=True)
    x, y = _data()
    probes = np.random.default_rng(2).choice([-1.0, 1.0], size=(4, N))
    jdata = (jnp.asarray(x), jnp.asarray(y))
    want = _jax_value_and_grads(
        lambda p: jmodel.training_loss(p, jdata, probes=jnp.asarray(probes)), jparams)
    got = _port_value_and_grads(lambda p: tmodel.training_loss(p, (x, y), probes=probes),
                                tparams)
    _assert_close(got, want, RTOL_KERNEL_ROUTE)


def test_probes_drawn_from_the_key_at_n_pad(draws):
    """Without explicit probes both draw ``num_probes`` rows at N_pad from the
    key (the port from its generator) and mask the pad columns."""
    jmodel, jparams, tmodel, tparams = _pair(error_threshold=1e-12, block=BLOCK,
                                             precond_rank=8, num_probes=3,
                                             slq_lanczos_iters=8)
    x, y = _data()
    key = jax.random.PRNGKey(4)
    draws.keys.append(key)
    jdata = (jnp.asarray(x), jnp.asarray(y))
    want = float(jax.jit(lambda p, k: jmodel.log_marginal_likelihood(p, jdata, key=k))(
        jparams, key))
    got = float(tmodel.log_marginal_likelihood(tparams, (x, y), key=torch.Generator()))
    assert not draws.keys
    assert got == pytest.approx(want, rel=RTOL_PRECOND)


# -- serving ----------------------------------------------------------------------

# Float64 at absolute 1e-13 (the stop rule sets the gaps, as above): alpha
# measured <= 5.3e-8 of its largest entry apart, the means, variances and
# covariances <= 8.1e-8 apart and <= 6.0e-8 from the dense GPR; held at 5e-7.
ATOL_SERVE_JAX = 5e-7
ATOL_SERVE_DENSE = 5e-7


def test_posterior_cache_and_predict_match_jax_and_dense_gpr():
    kw = _exact(N, block=BLOCK, precondition="pivchol", precond_rank=16)
    jmodel, jparams, tmodel, tparams = _pair(**kw)
    x, y = _data()
    xq = np.random.default_rng(3).uniform(-1.5, 1.5, (40, DIM))
    jdata, jxq, txq = (jnp.asarray(x), jnp.asarray(y)), jnp.asarray(xq), torch.as_tensor(xq)
    jpost = jmodel.posterior(jparams, jdata)
    post = tmodel.posterior(tparams, (x, y))
    assert isinstance(post, IterGPRPosterior) and post._fields == jpost._fields
    assert post.lanczos_r is None and post.x_train.shape == (256, DIM)
    np.testing.assert_allclose(post.alpha.numpy(), np.asarray(jpost.alpha), rtol=0,
                               atol=ATOL_SERVE_JAX * float(np.abs(jpost.alpha).max()))
    dense = GPR(kernel=tmodel.kernel)
    for full_cov in (False, True):
        want = jmodel.posterior_predict(jpost, jxq, full_cov=full_cov)
        got = tmodel.posterior_predict(post, txq, full_cov=full_cov)
        oracle = dense.predict_f(tparams, (x, y), txq, full_cov=full_cov)
        uncached = tmodel.predict_f(tparams, (x, y), txq, full_cov=full_cov)
        for g, w, o, u in zip(got, want, oracle, uncached):
            assert g.shape == w.shape == o.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL_SERVE_JAX)
            np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=0, atol=ATOL_SERVE_DENSE)
            np.testing.assert_allclose(u.numpy(), g.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tmodel.posterior_mean(post, txq).numpy(),
                               np.asarray(jmodel.posterior_mean(jpost, jxq)), rtol=0,
                               atol=ATOL_SERVE_JAX)


@pytest.mark.parametrize("mode", ["mean_and_var", "mean_only", "chunked"])
def test_predict_in_batches_serves_the_data_bound_models(mode):
    kw = _exact(N, block=BLOCK, precondition="pivchol", precond_rank=16)
    jmodel, jparams, tmodel, tparams = _pair(**kw)
    x, y = _data()
    xq = np.random.default_rng(4).uniform(-1.5, 1.5, (70, DIM))
    extra = {"mean_only": mode == "mean_only",
             "chunk_iterations": 6 if mode == "chunked" else 0}
    want = jax_predict_in_batches(jmodel, jparams, jnp.asarray(xq), batch_size=32,
                                  train_data=(jnp.asarray(x), jnp.asarray(y)), **extra)
    got = predict_in_batches(tmodel, tparams, xq, batch_size=32, train_data=(x, y), **extra)
    dense = predict_in_batches(GPR(kernel=tmodel.kernel), tparams, xq, batch_size=32,
                               train_data=(x, y), mean_only=extra["mean_only"])
    jdense = jax_predict_in_batches(JaxGPR(kernel=jmodel.kernel), jparams, jnp.asarray(xq),
                                    batch_size=32, train_data=(jnp.asarray(x), jnp.asarray(y)),
                                    mean_only=extra["mean_only"])
    for g, w, d, jd in zip(got, want, dense, jdense):
        if mode == "mean_only" and w is None:
            assert g is None and d is None
            continue
        assert g.shape == (70, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL_SERVE_JAX)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-12)
        np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=0, atol=ATOL_SERVE_DENSE)
    # Without the training data a data-bound model has no cache to build:
    # both packages serve through predict_f, which needs the data.
    with pytest.raises(TypeError, match="x_new"):
        jax_predict_in_batches(jmodel, jparams, jnp.asarray(xq))
    with pytest.raises(TypeError, match="x_new"):
        predict_in_batches(tmodel, tparams, xq)


# -- validation, memory, coercion, parameters -------------------------------------


def test_validation_errors():
    _, _, tmodel, tparams = _pair(block=BLOCK, precond_rank=8)
    x, y = _data(16)
    with pytest.raises(ValueError, match="PRNG key"):
        tmodel.log_marginal_likelihood(tparams, (x, y))
    with pytest.raises(ValueError, match="logdet_variant"):
        IterGPR(kernel=tkernels.SquaredExponential(), logdet_variant="exact")
    bad = IterGPR(kernel=tkernels.SquaredExponential(), precondition="nystrom")
    with pytest.raises(ValueError, match="precondition"):
        bad.log_marginal_likelihood(tparams, (x, y), key=torch.Generator())
    with pytest.raises(ValueError, match="posterior solver"):
        tmodel.posterior(tparams, (x, y), solver="qr")
    with pytest.raises(ValueError, match="logdet_value"):
        tmodel.log_marginal_likelihood_chunked(tparams, (x, y), probes=np.eye(16),
                                               logdet_value="sql")
    with pytest.raises(ValueError, match="posterior solver"):
        tmodel.posterior_chunked(tparams, (x, y), solver="qr")
    # The LOVE cache is ported (it raised here before): built by both
    # builders, it serves with no solve (its parity with JAX is
    # tests/test_torch_love.py's).
    for build in (tmodel.posterior, tmodel.posterior_chunked):
        post = build(tparams, (x, y), solver="lanczos")
        assert tuple(post.lanczos_r.shape) == (16, 16)
        mean, var = tmodel.posterior_predict(post, torch.as_tensor(x[:3]))
        assert mean.shape == var.shape == (3, 1) and bool(torch.all(var > 0))


class _Largest(TorchDispatchMode):
    """The largest tensor any operation creates."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def _mll_memory(model, params, data, panel):
    """Over the training loss and its gradient: the largest tensor created
    and the elements saved for backward in tensors of at least ``panel``."""
    saved = {"panels": 0}

    def pack(t):
        if t.numel() >= panel:
            saved["panels"] += t.numel()
        return t

    leaves = [params["kernel"]["variance"], params["kernel"]["lengthscales"],
              params["likelihood"]["variance"]]
    mode = _Largest()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), mode:
        loss = model.training_loss(params, data, key=torch.Generator().manual_seed(0))
        grads = torch.autograd.grad(loss, leaves)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    return mode.largest, saved["panels"]


def test_gradient_never_saves_stacked_panels(monkeypatch):
    """The memory contract (the twin of JAX's
    ``test_itergpr_grad_never_materializes_stacked_panels``): at N = 512 with
    block 128 the loss and its gradient, SLQ value included, create no
    [N, N] tensor and save no panel for the backward pass; the same count
    sees the panels once they are not rebuilt."""
    n, block = 512, 128
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-2, 2, (n, DIM)))
    y = torch.sin(x.sum(-1, keepdim=True))
    model = IterGPR(kernel=tkernels.Matern32(), error_threshold=1e-5, max_cg_iterations=32,
                    num_probes=4, slq_lanczos_iters=10, precond_rank=16, block=block)
    params = model.init_params(DIM, dtype=torch.float64, device="cpu")
    params = {s: {k: v.requires_grad_() for k, v in d.items()} for s, d in params.items()}
    largest, panels = _mll_memory(model, params, (x, y), block * n)
    assert largest < n * n and panels == 0, (largest, panels)
    monkeypatch.setattr(cg_implicit_module, "checkpoint",
                        lambda fn, *args, use_reentrant: fn(*args))
    assert _mll_memory(model, params, (x, y), block * n)[1] >= n * n


def test_padded_system_coerces_host_arrays():
    """numpy float64 data with float32 parameters: the caches hold float32
    tensors on the parameters' device (JAX's test ``:720``)."""
    x, y = _data(40)
    model = IterGPR(kernel=tkernels.Matern32(), error_threshold=1e-10, max_cg_iterations=6,
                    precondition=None, block=16)
    params = model.init_params(DIM, dtype=torch.float32, device="cpu")
    for post in (model.posterior_chunked(params, (x, y), chunk_iterations=6, max_chunks=50),
                 model.posterior(params, (x, y))):
        leaves = [post.x_train, post.lam, post.mask, post.alpha, *post.kernel_params.values()]
        assert all(isinstance(t, torch.Tensor) and t.dtype == torch.float32
                   and t.device.type == "cpu" for t in leaves)
        assert post.x_train.shape == (48, DIM)


def test_params_from_numpy_carries_the_jax_parameters():
    """The JAX model's parameters (the same ``{"kernel", "likelihood"}`` tree
    as GPR), flat or nested, serve the port's model unchanged."""
    jmodel, jparams, tmodel, _ = _pair(block=BLOCK, precond_rank=8)
    jparams = jax.tree_util.tree_map(lambda v: v * 1.1, jparams)
    flat = {"kernel/variance": np.asarray(jparams["kernel"]["variance"]),
            "kernel/lengthscales": np.asarray(jparams["kernel"]["lengthscales"]),
            "likelihood/variance": np.asarray(jparams["likelihood"]["variance"])}
    for given in (jparams, flat):
        tparams = params_from_numpy(given, device="cpu")
        assert set(_flat(tparams)) == set(_flat(jparams))
        for name, value in _flat(jparams).items():
            np.testing.assert_array_equal(_flat(tparams)[name], value)
    x, y = _data()
    dense_j = JaxGPR(kernel=jmodel.kernel).log_marginal_likelihood(
        jparams, (jnp.asarray(x), jnp.asarray(y)))
    dense_t = GPR(kernel=tmodel.kernel).log_marginal_likelihood(tparams, (x, y))
    assert float(dense_t) == pytest.approx(float(dense_j), rel=1e-12)


# -- the dense GPR --------------------------------------------------------------


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_gpr_matches_jax(kernel):
    """Value, gradients, the cache and its predictions (Cholesky in both
    packages: measured <= 1.6e-14 apart; held at 1e-12)."""
    jk, tk = KERNELS[kernel]
    jmodel, tmodel = JaxGPR(kernel=jk()), GPR(kernel=tk())
    jparams = jmodel.init_params(DIM, noise_variance=0.2, lengthscales=np.array([0.5, 0.6, 0.7]),
                                 dtype=jnp.float64)
    tparams = params_from_numpy(jparams, device="cpu")
    x, y = _data()
    jdata = (jnp.asarray(x), jnp.asarray(y))
    _assert_close(_port_value_and_grads(lambda p: tmodel.training_loss(p, (x, y)), tparams),
                  _jax_value_and_grads(lambda p: jmodel.training_loss(p, jdata), jparams), 1e-12)
    assert float(tmodel.maximum_log_likelihood_objective(tparams, (x, y))) == pytest.approx(
        float(jmodel.maximum_log_likelihood_objective(jparams, jdata)), rel=1e-12)
    jpost, post = jmodel.posterior(jparams, jdata), tmodel.posterior(tparams, (x, y))
    assert post._fields == jpost._fields
    for got, want in zip(post[1:], jpost[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    xq = np.random.default_rng(5).uniform(-1.5, 1.5, (30, DIM))
    for full_cov in (False, True):
        for got, want in zip(tmodel.posterior_predict(post, torch.as_tensor(xq), full_cov),
                             jmodel.predict_f(jparams, jdata, jnp.asarray(xq), full_cov)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tmodel.posterior_mean(post, torch.as_tensor(xq)).numpy(),
                               np.asarray(jmodel.posterior_mean(jpost, jnp.asarray(xq))),
                               rtol=0, atol=1e-12)


# -- cg_loop's carried direction -------------------------------------------------


@pytest.mark.parametrize("precondition", [False, True])
def test_cg_loop_p0_and_return_state_match_jax(precondition):
    """Residual replacement: from ``v0`` with a carried ``p0`` both packages
    take the same steps (float64, 6 steps: measured <= 3.0e-15 apart relative
    to each array's largest entry; held at 1e-12); without ``p0`` the loop is unchanged, bit for bit."""
    rng = np.random.default_rng(6)
    g = rng.standard_normal((30, 30))
    a = g @ g.T / 30 + np.eye(30)
    b = rng.standard_normal((3, 30))
    v0, p0 = rng.standard_normal((3, 30)), rng.standard_normal((3, 30))
    if precondition:
        factor = rng.standard_normal((30, 4))
        state = spectral_precond_state(torch.as_tensor(factor), torch.ones(30, dtype=torch.float64))
        from cggp_tpu.ops.cg import precond_apply_or_identity as japply
        from cggp_tpu.ops.cg import spectral_precond_state as jstate_fn

        jstate = jstate_fn(jnp.asarray(factor), jnp.ones(30))
    else:
        from cggp_tpu.ops.cg import precond_apply_or_identity as japply

        state, jstate = (), ()
    limits = dict(error_threshold=1e-30, max_iterations=6, max_steps_cycle=7,
                  relative_threshold=True)
    ta, jav = torch.as_tensor(a), jnp.asarray(a)
    v, stats, final = cg_loop(lambda q: q @ ta, precond_apply_or_identity, state,
                              torch.as_tensor(b), torch.as_tensor(v0), p0=torch.as_tensor(p0),
                              return_state=True, **limits)
    jv, jstats, jfinal = jax_cg_loop(lambda q: q @ jav, japply, jstate, jnp.asarray(b),
                                     jnp.asarray(v0), p0=jnp.asarray(p0), return_state=True,
                                     **limits)
    assert int(stats.steps) == int(jstats.steps) == final.i == 6
    for got, want in ((v, jv), (final.v, jfinal.v), (final.r, jfinal.r), (final.p, jfinal.p),
                      (final.rz, jfinal.rz)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12 * max(float(np.abs(want).max()), 1.0))
    plain = cg_loop(lambda q: q @ ta, precond_apply_or_identity, state, torch.as_tensor(b),
                    torch.as_tensor(v0), **limits)
    assert len(plain) == 2
    carried_none = cg_loop(lambda q: q @ ta, precond_apply_or_identity, state,
                           torch.as_tensor(b), torch.as_tensor(v0), p0=None, return_state=True,
                           **limits)
    assert torch.equal(plain[0], carried_none[0])


# -- the trainers -----------------------------------------------------------------


def _jax_keys(n_steps):
    key, subs = jax.random.PRNGKey(0), []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


# The solves' stop rule leaves gradients ~1e-8 apart (above), and Adam's
# normalised steps carry that into the parameters: after 5 (3) steps of
# adam(0.05) in float64 they measured <= 1.3e-9 (7.3e-9) apart; held at 5e-8.
TRAIN_ATOL = 5e-8


def test_train_full_batch_adam_matches_jax_and_optax(draws):
    jmodel, jparams, tmodel, tparams = _pair(error_threshold=1e-12, max_cg_iterations=400,
                                             block=BLOCK, precond_rank=8, num_probes=3,
                                             slq_lanczos_iters=8)
    x, y = _data()
    jdata = (jnp.asarray(x), jnp.asarray(y))
    draws.keys += _jax_keys(5)
    mask = {"kernel": {"variance": True, "lengthscales": True},
            "likelihood": {"variance": False}}
    want = jax_train_full_batch_adam(jparams, lambda p, k: jmodel.training_loss(p, jdata, key=k),
                                     5, learning_rate=0.05, trainable_mask=mask)
    got = train_full_batch_adam(tparams, lambda p, g: tmodel.training_loss(p, (x, y), key=g), 5,
                                learning_rate=0.05, trainable_mask=mask)
    assert not draws.keys
    for name, value in _flat(want).items():
        np.testing.assert_allclose(_flat(got)[name], value, rtol=0, atol=TRAIN_ATOL,
                                   err_msg=name)
    assert np.array_equal(_flat(got)["likelihood/variance"],
                          _flat(tparams)["likelihood/variance"])  # masked: frozen


def test_train_chunked_adam_matches_jax(draws):
    jmodel, jparams, tmodel, tparams = _pair(error_threshold=1e-10, max_cg_iterations=400,
                                             block=BLOCK, precond_rank=8, num_probes=3,
                                             slq_lanczos_iters=8, logdet_variant="zero")
    x, y = _data()
    jdata = (jnp.asarray(x), jnp.asarray(y))
    draws.keys += _jax_keys(3)
    want = jax_train_chunked_adam(
        jparams, lambda p, k: jmodel.log_marginal_likelihood_chunked(p, jdata, key=k,
                                                                     chunk_iterations=8), 3)
    got = train_chunked_adam(
        tparams, lambda p, g: tmodel.log_marginal_likelihood_chunked(p, (x, y), key=g,
                                                                     chunk_iterations=8), 3)
    assert not draws.keys
    for name, value in _flat(want).items():
        np.testing.assert_allclose(_flat(got)[name], value, rtol=0, atol=TRAIN_ATOL,
                                   err_msg=name)
    # A starved chunk budget is reported once, at the end.
    starved = dataclasses.replace(tmodel, error_threshold=1e-30)
    with pytest.warns(RuntimeWarning, match="2/2 steps"):
        train_chunked_adam(tparams, lambda p, g: starved.log_marginal_likelihood_chunked(
            p, (x, y), probes=np.ones((1, N)), chunk_iterations=2, max_chunks=1), 2)
