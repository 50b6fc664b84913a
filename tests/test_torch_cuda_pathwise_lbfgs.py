"""This slice's paths through the kernels, on the card: the pathwise serving
cache built with ``solver="cg"`` through B2 (``pallas_resident``) and B1
(``pallas`` under the exact factor), and scipy's L-BFGS of ``IterGPR``
through B3 (``use_pallas=True``).

Every test takes the ``cuda`` fixture, which skips it without a card (the
CPU runs).  On a machine with a card, without JAX::

    python -m pytest tests/test_torch_cuda_pathwise_lbfgs.py -q --noconftest

Tolerances: each kernel route's pathwise weights within 2x the float32
``"xla"`` route's gap (same configuration) from a float64 Cholesky build on
the same draws, the rule every kernel path is held to; the launches as the
solve records them.  The L-BFGS run through B3 against the blocked route's
in float32 on the same fixed probes: every evaluation's B3 launches = the
steps + 1 of its two solves, and the two runs' parameters within the fp32
rounding that the solves' stop rule lets through (1e-3 relative after 3
iterations).
"""

import numpy as np
import pytest
import torch

import cggp_tpu_torch.ops.cg as tcg
import cggp_tpu_torch.ops.cg_implicit as tcg_implicit
import cggp_tpu_torch.ops.rff as trff
from cggp_tpu_torch.data import synthetic
from cggp_tpu_torch.models import CGGP, IterGPR, build_pathwise_posterior
from cggp_tpu_torch.ops.kernels import Matern32
from cggp_tpu_torch.ops.pallas_cg import pallas_cg_solve
from cggp_tpu_torch.ops.pallas_gram import kuu_matvec
from cggp_tpu_torch.ops.pallas_matvec import pallas_matvec
from cggp_tpu_torch.selection import covertree_update_inducing_parameters
from cggp_tpu_torch.training import train_using_lbfgs_and_update

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with --noconftest (module docstring)")
    from cggp_tpu_torch import resolve_device

    return resolve_device("cuda")


def _cggp(impl, config, n):
    if config == "chol":
        cg = tcg.ConjugateGradient(1e-5, relative_threshold=True, matvec_impl=impl)
    else:
        cg = tcg.ConjugateGradient(1e-8, matvec_impl=impl)
    return CGGP(kernel=Matern32(), num_data=n, conjugate_gradient=cg,
                precondition="chol" if config == "chol" else None)


def _solves():
    records, impl = [], tcg._cg_dense_impl

    def recording(*args):
        solution, stats = impl(*args)
        records.append(stats)
        return solution, stats

    return records, recording, impl


@pytest.mark.parametrize("route", ["pallas_resident", "pallas"])
def test_pathwise_weights_through_the_kernels_against_float64(cuda, monkeypatch, route):
    (x, y), _ = synthetic(n=20_000, dim=3, seed=1)
    iv, u, counts = covertree_update_inducing_parameters(
        (torch.as_tensor(x, device=cuda), torch.as_tensor(y, device=cuda)), 0.5,
        backend="numpy")
    config = "plain" if route == "pallas_resident" else "chol"
    params = _cggp("xla", config, len(x)).init_params(
        iv, pseudo_u=u, cluster_counts=counts, dtype=torch.float32, device=cuda)
    params64 = {k: ({kk: vv.double() for kk, vv in v.items()} if isinstance(v, dict)
                    else v.double()) for k, v in params.items()}
    drawn, theta_fn, normal_fn = {}, trff.basis_theta_parameter, trff.standard_normal

    def build(impl):
        records, recording, _ = _solves()
        monkeypatch.setattr(tcg, "_cg_dense_impl", recording)
        monkeypatch.setattr(trff, "basis_theta_parameter",
                            lambda *a, **k: drawn.setdefault("theta", theta_fn(*a, **k)))
        monkeypatch.setattr(trff, "standard_normal",
                            lambda g, shape, dtype, dev: drawn.setdefault(
                                tuple(shape), normal_fn(g, shape, dtype, dev)))
        pallas_cg_solve.launches = pallas_matvec.launches = 0
        post = build_pathwise_posterior(_cggp(impl, config, len(x)), params,
                                        torch.Generator(device=cuda).manual_seed(3),
                                        num_bases=128, num_samples=8, solver="cg")
        return post, records, (pallas_cg_solve.launches, pallas_matvec.launches)

    got, records, launches = build(route)
    steps = int(records[0].steps)
    assert len(records) == 1 and bool(records[0].converged)
    assert launches == ((1, 0) if route == "pallas_resident" else (0, steps + 1))
    xla, _, xla_launches = build("xla")  # the same draws (recorded by the first build)
    assert xla_launches == (0, 0)
    monkeypatch.setattr(trff, "basis_theta_parameter", lambda *a, **k: drawn["theta"].double())
    monkeypatch.setattr(trff, "standard_normal",
                        lambda g, shape, dtype, dev: drawn[tuple(shape)].double())
    exact = build_pathwise_posterior(_cggp("xla", config, len(x)), params64,
                                     torch.Generator(device=cuda), num_bases=128, num_samples=8,
                                     solver="chol")
    gap = float((got.weights.double() - exact.weights).abs().max())
    xla_gap = float((xla.weights.double() - exact.weights).abs().max())
    assert gap <= 2.0 * xla_gap, (gap, xla_gap)


class IterationCount:
    """A monitor that notes the iteration of each of its calls."""

    def __init__(self, iterations):
        self.iterations = iterations

    def __call__(self, step, params):
        self.iterations.append(int(step))

    def flush(self):
        pass


def test_scipy_lbfgs_of_itergpr_through_b3_matches_the_blocked_route(cuda, monkeypatch):
    (x_np, y_np), _ = synthetic(n=6200, dim=3, seed=0)
    n = 4096
    x = torch.as_tensor(x_np[:n], dtype=torch.float32, device=cuda)
    y = torch.as_tensor(y_np[:n], dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(7)
    probes = torch.as_tensor((2 * rng.integers(0, 2, (8, n)) - 1).astype(np.float32),
                             device=cuda)
    solves, impl = [], tcg_implicit._implicit_cg_impl

    def recording(*args):
        solution, stats = impl(*args)
        solves.append(stats)
        return solution, stats

    monkeypatch.setattr(tcg_implicit, "_implicit_cg_impl", recording)
    runs = {}
    for use_pallas in (True, False):
        model = IterGPR(kernel=Matern32(), error_threshold=1e-4, relative_threshold=True,
                        num_probes=8, slq_lanczos_iters=20, precondition="pivchol",
                        precond_rank=256, block=1024, use_pallas=use_pallas)
        params = model.init_params(3, dtype=torch.float32, device=cuda)
        marks = []

        def loss(p):
            marks.append((kuu_matvec.launches, len(solves)))
            return model.training_loss(p, (x, y), probes=probes)

        kuu_matvec.launches = 0
        iterations = []
        runs[use_pallas] = train_using_lbfgs_and_update(params, loss, 3,
                                                        monitor=IterationCount(iterations))
        marks.append((kuu_matvec.launches, len(solves)))
        for (a, sa), (b, sb) in zip(marks, marks[1:]):
            records = solves[sa:sb]
            assert len(records) == 2 and all(bool(r.converged) for r in records)
            want = sum(int(r.steps) + 1 for r in records) if use_pallas else 0
            assert b - a == want
        assert iterations == [0, 1, 2]
    for group in ("kernel", "likelihood"):
        for name, value in runs[True][group].items():
            torch.testing.assert_close(value, runs[False][group][name], rtol=1e-3, atol=1e-4)
