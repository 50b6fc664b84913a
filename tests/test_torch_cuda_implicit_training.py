"""Matrix-free training on the card: one ``ImplicitCGGP`` training step
through B3 (``use_pallas=True``) against the blocked route, at M = 4000
padded to 4096 (block 1024): every matvec of the forward and the backward
solve goes through ``kuu_matvec`` (launches = the solves' steps + 1, no
``gram_matvec``), none on the blocked route, and the first step's loss and
each trainable gradient no further from float64 than twice the blocked
float32 route's gap.

Every test takes the ``cuda`` fixture, which skips it without a card; the
decision is made there, never at import.  On a machine with a card, without
JAX::

    python -m pytest tests/test_torch_cuda_implicit_training.py -q --noconftest
"""

import numpy as np
import pytest
import torch

import cggp_tpu_torch.ops.cg_implicit as cg_implicit_module
from cggp_tpu_torch.data import synthetic
from cggp_tpu_torch.models.implicit import ImplicitCGGP
from cggp_tpu_torch.ops.kernels import Matern32
from cggp_tpu_torch.ops.pallas_gram import gram_matvec, kuu_matvec

pytestmark = pytest.mark.cuda
TRAINABLE = (("kernel", "variance"), ("kernel", "lengthscales"), ("likelihood", "variance"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with --noconftest (module docstring)")
    from cggp_tpu_torch import resolve_device

    return resolve_device("cuda")


def _step(model, params, batch, device, solves):
    """The first step's loss and trainable gradients, the solves' steps."""
    live = {k: ({kk: vv.detach().clone().requires_grad_() for kk, vv in v.items()}
                if isinstance(v, dict) else v) for k, v in params.items()}
    solves.clear()
    loss = model.training_loss(live, batch, torch.Generator(device=device).manual_seed(1))
    grads = torch.autograd.grad(loss, [live[a][b] for a, b in TRAINABLE])
    return loss.detach().double(), [g.double() for g in grads], [
        (int(s.steps), bool(s.converged)) for s in solves]


def test_one_step_through_b3_against_the_blocked_route(cuda, monkeypatch):
    (x, y), _ = synthetic(n=30_000, dim=3, seed=0)
    rng = np.random.default_rng(0)
    m = 4000
    iv = x[rng.choice(x.shape[0], m, replace=False)]
    u = rng.standard_normal((m, 1))
    counts = rng.integers(1, 50, (m, 1)).astype(np.float64)
    idx = rng.choice(x.shape[0], 512, replace=False)
    solves = []
    impl = cg_implicit_module._implicit_cg_impl

    def recording(*args):
        solution, stats = impl(*args)
        solves.append(stats)
        return solution, stats

    monkeypatch.setattr(cg_implicit_module, "_implicit_cg_impl", recording)

    def run(use_pallas, dtype, threshold):
        model = ImplicitCGGP(kernel=Matern32(), num_data=x.shape[0], block=1024,
                             precondition="pivchol", precond_rank=64, relative_threshold=True,
                             error_threshold=threshold, max_cg_iterations=2000,
                             use_pallas=use_pallas)
        params = model.init_params(iv, pseudo_u=u, cluster_counts=counts, dtype=dtype,
                                   device=cuda)
        assert params["inducing_points"].shape[0] == 4096
        batch = tuple(torch.as_tensor(a[idx], dtype=dtype, device=cuda) for a in (x, y))
        kuu_matvec.launches = gram_matvec.launches = 0
        out = _step(model, params, batch, cuda, solves)
        torch.cuda.synchronize()
        return (*out, {"kuu_matvec": kuu_matvec.launches, "gram_matvec": gram_matvec.launches})

    loss64, grads64, steps64, _ = run(False, torch.float64, 1e-12)
    results = {route: run(use_pallas, torch.float32, 1e-5)
               for route, use_pallas in (("blocked", False), ("b3", True))}
    assert all(c for _, c in steps64)
    gaps = {}
    for route, (loss, grads, steps, launches) in results.items():
        assert len(steps) == 2 and all(c for _, c in steps), steps  # forward, backward
        want = sum(k + 1 for k, _ in steps) if route == "b3" else 0
        assert launches == {"kuu_matvec": want, "gram_matvec": 0}, (route, launches, steps)
        assert torch.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in grads)
        gaps[route] = [float(abs(loss - loss64) / abs(loss64))] + [
            float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
            for g, w in zip(grads, grads64)]
    for got, plain in zip(gaps["b3"], gaps["blocked"]):
        assert got <= 2.0 * plain, gaps
    for (a, _), (b, _) in zip(results["b3"][2], results["blocked"][2]):
        assert abs(a - b) <= max(3, 0.05 * b)
