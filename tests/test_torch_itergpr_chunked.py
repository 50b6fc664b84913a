"""Port parity for ``IterGPR``'s chunked family (host-driven residual-
replacement CG chunks on the blocked matvec): the chunked marginal
likelihood against the fused path and JAX's, the chunked SLQ against the
dense log-det, ``posterior_chunked`` and ``posterior_predict_chunked``
against the one-solve versions, the carried Krylov direction, and the
kernel route staying off the chunked path.  Float64 unless a test says
otherwise, the same numpy inputs in both packages (``tests/test_itergpr.py``
``:523-843`` is the JAX package's own version)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cggp_tpu_torch.ops.cg_implicit as cg_implicit_module
from cggp_tpu.models.itergpr import IterGPR as JaxIterGPR
from cggp_tpu.ops import kernels as jkernels
from cggp_tpu.ops.logdet import slq_value_rows_chunked as jax_slq_value_rows_chunked
from cggp_tpu_torch.models import GPR, IterGPR
from cggp_tpu_torch.models.itergpr import _chunked_mll_parts, _chunked_restart_solve
from cggp_tpu_torch.ops import kernels as tkernels
from cggp_tpu_torch.ops.logdet import slq_value_rows, slq_value_rows_chunked
from cggp_tpu_torch.utils.store import params_from_numpy

torch.set_num_threads(1)

N, DIM, BLOCK = 200, 3, 64  # padded to 256


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, (n, DIM))
    y = np.sin(x.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((n, 1))
    return x, y


def _pair(**kw):
    jmodel = JaxIterGPR(kernel=jkernels.Matern32(), **kw)
    tmodel = IterGPR(kernel=tkernels.Matern32(), **kw)
    jparams = jmodel.init_params(DIM, noise_variance=0.1, lengthscales=np.array([0.5, 0.6, 0.7]),
                                 dtype=jnp.float64)
    return jmodel, jparams, tmodel, params_from_numpy(jparams, device="cpu")


def _grad_gap(got, want):
    """The worst gradient entry's gap relative to its leaf's largest entry."""
    return max(float(np.abs(np.asarray(got[s][k]) - np.asarray(w)).max())
               / max(float(np.abs(np.asarray(w)).max()), 1e-300)
               for s in want for k, w in want[s].items())


# Relative 1e-12 on 0.5||r||^2 (a relative residual up to 1.4e-6), float64:
# the chunked path re-anchors on the true residual, the fused loop stops on
# its recurrence residual.  Chunked against fused: values measured 2.8e-10
# apart relative, gradients 1.3e-8 (of each leaf's largest entry); against
# JAX's chunked path 4.8e-10 and 1.8e-8, with the same 6 chunks.  Held at
# 5e-9 and 2e-7.
RTOL_VALUE, RTOL_GRAD = 5e-9, 2e-7


def test_chunked_mll_matches_the_fused_path_and_jax():
    kw = dict(error_threshold=1e-12, max_cg_iterations=400, num_probes=6,
              precondition="pivchol", precond_rank=16, block=BLOCK, logdet_variant="zero")
    jmodel, jparams, tmodel, tparams = _pair(**kw)
    x, y = _data()
    probes = np.random.default_rng(1).choice([-1.0, 1.0], size=(6, N))
    live = {s: {k: v.clone().requires_grad_() for k, v in d.items()} for s, d in tparams.items()}
    fused = tmodel.log_marginal_likelihood(live, (x, y), probes=probes)
    fused_grads = torch.autograd.grad(fused, [v for d in live.values() for v in d.values()])
    fused_grads = dict(zip(("kernel", "likelihood"), ({"variance": fused_grads[0],
                                                      "lengthscales": fused_grads[1]},
                                                     {"variance": fused_grads[2]})))
    val, grads, info = tmodel.log_marginal_likelihood_chunked(tparams, (x, y), probes=probes,
                                                              chunk_iterations=7,
                                                              max_chunks=100)
    assert info["converged"] and info["chunks"] > 1, info
    assert info["rel_residual"] <= np.sqrt(1e-12)
    assert float(val) == pytest.approx(float(fused), rel=RTOL_VALUE)
    assert _grad_gap(grads, fused_grads) <= RTOL_GRAD
    jval, jgrads, jinfo = jmodel.log_marginal_likelihood_chunked(
        jparams, (jnp.asarray(x), jnp.asarray(y)), probes=jnp.asarray(probes),
        chunk_iterations=7, max_chunks=100)
    assert (info["chunks"], info["converged"]) == (jinfo["chunks"], jinfo["converged"])
    assert float(val) == pytest.approx(float(jval), rel=RTOL_VALUE)
    assert _grad_gap(grads, jgrads) <= RTOL_GRAD
    # A starved budget reports itself.
    _, _, bad = tmodel.log_marginal_likelihood_chunked(tparams, (x, y), probes=probes,
                                                       chunk_iterations=2, max_chunks=2)
    assert not bad["converged"] and bad["chunks"] == 2


def test_chunked_slq_value_matches_the_dense_logdet():
    """Scaled-identity probes and full-depth Lanczos make the chunked SLQ
    exact: the chunked MLL equals the dense GPR's and JAX's chunked value
    (absolute 1e-12 stop rule: measured 3.3e-10 and 2.5e-10 relative, held
    at 5e-9); ``"zero"`` drops exactly 0.5 logdet (1.1e-15, held at 1e-12).
    The chunked SLQ name computes the one-program value bit for bit, JAX's
    chunked SLQ value and the exact log-det (1.3e-15 and 8.4e-16, held at
    1e-12)."""
    n = 64
    kw = dict(error_threshold=1e-12, max_cg_iterations=4 * n, relative_threshold=False,
              slq_lanczos_iters=n, precondition="pivchol", precond_rank=12, block=32)
    jmodel, jparams, tmodel, tparams = _pair(**kw)
    x, y = _data(n)
    probes = np.sqrt(n) * np.eye(n)
    dense = float(GPR(kernel=tmodel.kernel).log_marginal_likelihood(tparams, (x, y)))
    val, _, info = tmodel.log_marginal_likelihood_chunked(
        tparams, (x, y), probes=probes, chunk_iterations=9, max_chunks=200, logdet_value="slq")
    assert info["converged"]
    assert float(val) == pytest.approx(dense, rel=5e-9)
    jval, _, _ = jmodel.log_marginal_likelihood_chunked(
        jparams, (jnp.asarray(x), jnp.asarray(y)), probes=jnp.asarray(probes),
        chunk_iterations=9, max_chunks=200, logdet_value="slq")
    assert float(val) == pytest.approx(float(jval), rel=5e-9)
    val0, _, _ = tmodel.log_marginal_likelihood_chunked(
        tparams, (x, y), probes=probes, chunk_iterations=9, max_chunks=200, logdet_value="zero")
    kmat = tmodel.kernel.K(tparams["kernel"], torch.as_tensor(x))
    logdet = float(torch.linalg.slogdet(kmat + 0.1 * torch.eye(n, dtype=torch.float64))[1])
    assert float(val0) - float(val) == pytest.approx(0.5 * logdet, rel=1e-12)
    # The SLQ functions themselves, on the padded system's matvec.
    x_pad, lam, mask, _ = tmodel._padded_system(tparams, x, y)
    tprobes = torch.as_tensor(probes)

    def matvec(rows):
        return tmodel._matvec(tparams["kernel"], x_pad, lam, mask, rows)

    chunked = slq_value_rows_chunked(matvec, tprobes, n)
    assert torch.equal(chunked, slq_value_rows(matvec, tprobes, n))
    jmat = np.asarray(kmat) + 0.1 * np.eye(n)
    want = float(jax_slq_value_rows_chunked(lambda r: r @ jnp.asarray(jmat), jnp.asarray(probes),
                                            n))
    assert float(chunked) == pytest.approx(want, rel=1e-12)
    assert float(chunked) == pytest.approx(logdet, rel=1e-12)


# Both solves stop at 0.5 ||r||^2 <= 1e-18 (absolute): alpha measured
# 3.9e-10 apart (of its largest entry) and the served means 1.7e-10; held at
# 5e-9.
ATOL_CHUNKED_SERVE = 5e-9


def test_posterior_chunked_matches_posterior():
    _, _, tmodel, tparams = _pair(error_threshold=1e-18, max_cg_iterations=800,
                                  relative_threshold=False, precondition="pivchol",
                                  precond_rank=16, block=BLOCK)
    x, y = _data()
    xq = torch.as_tensor(np.random.default_rng(2).uniform(-1.5, 1.5, (17, DIM)))
    ref = tmodel.posterior(tparams, (x, y))
    got = tmodel.posterior_chunked(tparams, (x, y), chunk_iterations=7, max_chunks=200)
    assert got._fields == ref._fields and got.lanczos_r is None
    scale = float(ref.alpha.abs().max())
    assert float((got.alpha - ref.alpha).abs().max()) <= ATOL_CHUNKED_SERVE * scale
    for a, b in zip(tmodel.posterior_predict(got, xq), tmodel.posterior_predict(ref, xq)):
        assert float((a - b).abs().max()) <= ATOL_CHUNKED_SERVE
    with pytest.raises(ValueError, match="posterior solver"):
        tmodel.posterior_chunked(tparams, (x, y), solver="qr")


def test_posterior_predict_chunked_matches_posterior_predict():
    """Diagonal and full covariance to solver precision (relative 1e-16 on
    0.5 ||r||^2: the means equal, variances and covariances measured
    <= 2.0e-9 apart; held at 2e-8), and a starved budget warns, here and in
    ``posterior_chunked``."""
    _, _, tmodel, tparams = _pair(error_threshold=1e-16, max_cg_iterations=400,
                                  precondition="pivchol", precond_rank=12, block=BLOCK)
    x, y = _data()
    xq = torch.as_tensor(np.random.default_rng(3).uniform(-1.5, 1.5, (13, DIM)))
    post = tmodel.posterior(tparams, (x, y))
    for full_cov in (False, True):
        want = tmodel.posterior_predict(post, xq, full_cov=full_cov)
        got = tmodel.posterior_predict_chunked(post, xq, chunk_iterations=6, max_chunks=100,
                                               full_cov=full_cov)
        for a, b in zip(got, want):
            assert a.shape == b.shape and float((a - b).abs().max()) <= 2e-8
    for call in (lambda: tmodel.posterior_predict_chunked(post, xq, chunk_iterations=2,
                                                          max_chunks=1),
                 lambda: tmodel.posterior_chunked(tparams, (x, y), chunk_iterations=2,
                                                  max_chunks=1)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            call()
        assert any("unconverged" in str(w.message) for w in caught)


def test_chunked_solve_carries_krylov_momentum():
    """Carrying the search direction across chunks converges like
    unrestarted CG: on an ill-conditioned float32 system at a 1e-12
    relative target the carried solve needs fewer chunks than plain
    restarts (JAX's test ``:797``, the same sizes), and matches the dense
    solve (float32 stop rule: held at JAX's 5e-4 / 5e-5)."""
    n = 800
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-2, 2, (n, 3)), dtype=torch.float32)
    y = torch.sin(x.sum(-1, keepdim=True)) + 0.01 * torch.as_tensor(
        rng.standard_normal((n, 1)), dtype=torch.float32)
    model = IterGPR(kernel=tkernels.Matern32(), error_threshold=1e-12, max_cg_iterations=8,
                    relative_threshold=True, precondition="pivchol", precond_rank=16, block=256)
    params = model.init_params(3, dtype=torch.float32, device="cpu")
    kp = params["kernel"]
    x_pad, lam, mask, y_rows = model._padded_system(params, x, y)
    solve_chunk, _ = _chunked_mll_parts(model, 8)
    state = model._precond_state(kp, x_pad, lam, mask)
    # Plain restarts: the same chunk, the direction dropped.
    b_norm2 = 0.5 * torch.sum(torch.square(y_rows), dim=-1)
    v, err, restart_chunks = torch.zeros_like(y_rows), b_norm2, 0
    while restart_chunks < 120 and not bool(torch.all(err <= 1e-12 * b_norm2)):
        v, _p, err = solve_chunk(kp, x_pad, lam, mask, y_rows, v, None, state)
        restart_chunks += 1
    v_rr, _err, converged, carry_chunks = _chunked_restart_solve(
        model, kp, x_pad, lam, mask, y_rows, state, solve_chunk, max_chunks=120)
    assert converged and carry_chunks < restart_chunks, (carry_chunks, restart_chunks)
    a = model.kernel.K(kp, x).double() + 0.1 * torch.eye(n, dtype=torch.float64)
    alpha = torch.linalg.solve(a, y.double())[:, 0]
    np.testing.assert_allclose(v_rr[0, :n].double().numpy(), alpha.numpy(), rtol=5e-4, atol=5e-5)


def test_chunked_path_stays_on_the_blocked_matvec(monkeypatch):
    """As in JAX, the chunked solves and the surrogate gradient run on the
    blocked matvec even with ``use_pallas=True``: kernel B3 is never
    called (on the card it makes no launch there)."""
    _, _, tmodel, tparams = _pair(error_threshold=1e-10, max_cg_iterations=400, num_probes=2,
                                  precond_rank=8, block=BLOCK, slq_lanczos_iters=6,
                                  use_pallas=True)

    def refused(*args, **kw):
        raise AssertionError("kernel B3 called on the chunked path")

    monkeypatch.setattr(cg_implicit_module, "kuu_matvec", refused)
    x, y = _data()
    gen = torch.Generator().manual_seed(0)
    val, grads, info = tmodel.log_marginal_likelihood_chunked(tparams, (x, y), key=gen,
                                                              logdet_value="slq")
    assert info["converged"] and np.isfinite(float(val))
    post = tmodel.posterior_chunked(tparams, (x, y))
    tmodel.posterior_predict_chunked(post, torch.as_tensor(x[:5]))
    with pytest.raises(AssertionError, match="kernel B3"):
        tmodel.posterior(tparams, (x, y))  # the one-solve path does call it
