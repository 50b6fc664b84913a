"""The exact GP on the card: kernel B3 (``kuu_matvec``) at the row counts
``IterGPR`` gives it (R = 1 on the small launch, R = 9 on the tiled 3xTF32
launch) against its plain version and float64 at N = 4096 + 37; the
operator the B3 route applies to the padded system, solved in float64,
against the blocked route's float32 matrix; and ``IterGPR`` marginal
likelihoods and gradients through B3 against the blocked route at the
relative threshold 1e-4 that ``chip_smoke.py``'s exact GP runs at and at a
tight 1e-6, where float32 rounding, not the stop rule, sets the gaps: every
matvec of the forward and the backward solve goes through ``kuu_matvec``
(launches = the solves' steps + 1), none on the blocked route.

Why the float32 solves are held by their solution vectors, not by the
ratio of two scalar gaps: at N ~ 3000 the loss and each gradient sit
1e-7 to 1e-3 from float64 on both routes, set by where each route's CG
stops and how its float32 rounding falls, and one route's scalar gap can
land near zero by cancellation: the loss is -0.5 (quad + logdet + N log
2 pi), both routes take the same float32 SLQ log-det value, and where the
quadratic term's error has the opposite sign the two cancel (each case
prints both parts).  A ratio of two such gaps says nothing about B3.  The tight check of B3 itself is the
float64 solve with the operator it applies (``test_b3_operator_*``).

Every test takes the ``cuda`` fixture, which skips it without a card; the
decision is made there, never at import.  On a machine with a card, without
JAX (``-rA`` prints each case's measured ratios)::

    python -m pytest tests/test_torch_cuda_itergpr.py -q --noconftest -rA
"""

import math

import numpy as np
import pytest
import torch

import cggp_tpu_torch.ops.cg_implicit as cg_implicit_module
from cggp_tpu_torch.data import synthetic
from cggp_tpu_torch.models import IterGPR
from cggp_tpu_torch.ops.kernels import Matern32, kernel_value_from_r2, scaled_squared_distance
from cggp_tpu_torch.ops.pallas_gram import gram_matvec, kuu_matvec, kuu_matvec_plain

pytestmark = pytest.mark.cuda
TRAINABLE = (("kernel", "variance"), ("kernel", "lengthscales"), ("likelihood", "variance"))
N_RAGGED = 4096 + 37
PATH_THRESHOLD = 1e-4  # chip_smoke.py's exact GP (relative)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with --noconftest (module docstring)")
    from cggp_tpu_torch import resolve_device

    return resolve_device("cuda")


def _max_rel(got, want, scale):
    return float((got.double() - want.double()).abs().max()) / scale


def _rel(got, want):
    return float(torch.linalg.vector_norm(got.double() - want.double())
                 / torch.linalg.vector_norm(want.double()))


@pytest.mark.parametrize("rows", [1, 9])
def test_b3_at_the_exact_gp_row_counts(cuda, rows):
    gen = torch.Generator(device=cuda).manual_seed(3)
    z = (torch.rand(N_RAGGED, 3, generator=gen, device=cuda) * 4 - 2).contiguous()
    lam = torch.full((N_RAGGED,), 0.1, device=cuda)
    p = torch.randn(rows, N_RAGGED, generator=gen, device=cuda)
    var = torch.ones(1, device=cuda)
    launches = kuu_matvec.launches
    got = kuu_matvec(z, lam, p, var, "matern32")
    torch.cuda.synchronize()
    assert kuu_matvec.launches == launches + 1 and bool(torch.isfinite(got).all())
    plain = kuu_matvec_plain(z, lam, p, var, "matern32")
    scale = float(kuu_matvec_plain(z, lam, p.abs(), var, "matern32").max())
    assert _max_rel(got, plain, scale) <= 5e-5  # chip_smoke.py's B3 gate
    # Both launches sum the depth at two levels: no further from fp64 than
    # twice the plain fp32 version (chip_smoke.py's B3_itergpr gate).
    z64 = z.double()
    k64 = kernel_value_from_r2("matern32", scaled_squared_distance(z64, z64),
                               torch.tensor(1.0, dtype=torch.float64, device=cuda))
    exact = p.double() @ k64 + p.double() * lam.double()
    assert _max_rel(got, exact, scale) <= 2 * _max_rel(plain, exact, scale)


def _system(n, cuda):
    """The padded exact-GP system of the first ``n`` rows at the init
    parameters (block 1024): ``(model, params, x_pad, lam, mask, y_rows)``."""
    (x, y), _ = synthetic(n=20_000, dim=3, seed=0)
    model = IterGPR(kernel=Matern32(), block=1024)
    params = model.init_params(3, dtype=torch.float32, device=cuda)
    data = tuple(torch.as_tensor(a[:n], dtype=torch.float32, device=cuda) for a in (x, y))
    return (model, params, *model._padded_system(params, *data))


@pytest.mark.parametrize("n", [3000, 3072])  # 72 pads, none
def test_b3_operator_of_the_padded_system(cuda, n):
    """The operator the B3 route applies (the masked composition around
    ``kuu_matvec``), read off identity rows through the tiled launch, is
    the padded system: pad rows and columns exactly decoupled, exactly
    symmetric.  Solved in float64, its quadratic term ``y^T A^-1 y`` and
    its solution sit no further from the exact system's than twice the
    blocked route's float32 matrix does: B3 builds its kernel values no
    worse than the blocked route, here with no CG stop and no float32
    solve in the way.  On the fused solve's own rows its matvec error is
    as small as the blocked route's."""
    model, params, x_pad, lam, mask, y_rows = _system(n, cuda)
    kp, n_pad = params["kernel"], x_pad.shape[0]
    eye = torch.eye(n_pad, device=cuda)
    ops = {}
    for route, use_pallas in (("blocked", False), ("b3", True)):
        solver = cg_implicit_module._Solver(model.kernel, model.block, use_pallas, 1e-4, 10, 10,
                                            True)
        with torch.no_grad():
            ops[route] = solver.matvec(kp, x_pad, lam, mask)(eye).double()
    torch.cuda.synchronize()
    x64 = x_pad.double() / model.kernel.lengthscales(kp).double()
    k64 = kernel_value_from_r2("matern32", scaled_squared_distance(x64, x64),
                               model.kernel.variance(kp).double())
    m64 = mask.double()
    exact = k64 * (m64[:, None] * m64[None, :]) + torch.diag(lam.double())
    b3 = ops["b3"]
    real, pads = mask > 0, mask == 0
    assert torch.equal(b3, b3.T)
    assert not bool(b3[real][:, pads].any()) and torch.equal(
        b3[pads][:, pads], torch.eye(int(pads.sum()), dtype=b3.dtype, device=cuda))
    y = y_rows[0].double()
    alpha64 = torch.linalg.solve(exact, y)
    quad64 = float(y @ alpha64)
    gaps = {}
    for route, op in ops.items():
        alpha = torch.linalg.solve(op, y)
        gaps[route] = {"quad": abs(float(y @ alpha) - quad64) / quad64,
                       "alpha": _rel(alpha, alpha64)}
    # The matvec itself on the fused solve's own rows, y and 8 probes: its
    # error from float64, relative to |rows| |A|, as small as the blocked
    # route's (RMS), and its bias along y printed beside it.
    probes = np.random.default_rng(7).choice([-1.0, 1.0], size=(8, n_pad))
    rows = torch.cat([y_rows, torch.as_tensor(probes, dtype=torch.float32, device=cuda)
                      * mask[None, :]])
    want = rows.double() @ exact
    scale = rows.double().abs() @ exact.abs()
    for route, use_pallas in (("blocked", False), ("b3", True)):
        solver = cg_implicit_module._Solver(model.kernel, model.block, use_pallas, 1e-4, 10, 10,
                                            True)
        with torch.no_grad():
            err = solver.matvec(kp, x_pad, lam, mask)(rows).double() - want
        gaps[route]["matvec_rms"] = float((err[:, real] / scale[:, real]).pow(2).mean().sqrt())
        gaps[route]["matvec_along_y"] = float(err[0] @ rows[0].double() / (want[0] @ rows[0].double()))
    print(f"n={n} float64 solves of each route's operator, gaps from the exact system: {gaps}")
    for what in ("quad", "alpha", "matvec_rms"):
        assert gaps["b3"][what] <= 2.0 * gaps["blocked"][what], gaps


@pytest.mark.parametrize("n,probe_seed,threshold", [
    (3000, 7, PATH_THRESHOLD), (3000, 8, PATH_THRESHOLD), (4059, 7, PATH_THRESHOLD),
    (3072, 7, PATH_THRESHOLD), (3000, 7, 1e-6), (3072, 7, 1e-6)])
def test_itergpr_mll_through_b3_against_the_blocked_route(cuda, monkeypatch, n, probe_seed,
                                                          threshold):
    (x, y), _ = synthetic(n=20_000, dim=3, seed=0)  # n = 3000 / 4059 pad to 3072 / 4096
    probes = np.random.default_rng(probe_seed).choice([-1.0, 1.0], size=(8, n))
    solves = []
    impl = cg_implicit_module._implicit_cg_impl

    def recording(*args):
        solution, stats = impl(*args)
        solves.append((args[2].detach().clone(), solution.detach().clone(), stats))
        return solution, stats

    monkeypatch.setattr(cg_implicit_module, "_implicit_cg_impl", recording)

    def run(use_pallas, dtype, threshold):
        model = IterGPR(kernel=Matern32(), error_threshold=threshold, relative_threshold=True,
                        max_cg_iterations=2000, num_probes=8, slq_lanczos_iters=20,
                        precondition="pivchol", precond_rank=64, block=1024,
                        use_pallas=use_pallas)
        params = model.init_params(3, dtype=dtype, device=cuda)
        live = {s: {k: v.requires_grad_() for k, v in d.items()} for s, d in params.items()}
        data = tuple(torch.as_tensor(a[:n], dtype=dtype, device=cuda) for a in (x, y))
        solves.clear()
        kuu_matvec.launches = gram_matvec.launches = 0
        loss = model.training_loss(live, data, probes=probes)
        grads = torch.autograd.grad(loss, [live[a][b] for a, b in TRAINABLE])
        torch.cuda.synchronize()
        (y_rows, forward, _), (_, backward, _) = [s for s in solves]
        terms = forward[0].double() * y_rows[0].double()
        return {"loss": float(loss), "grads": [g.double() for g in grads],
                "quad": float(terms.sum()), "quad_terms": float(terms.abs().sum()),
                "forward": forward.double(), "backward": backward.double(),
                "steps": [(int(s.steps), bool(s.converged)) for _, _, s in solves],
                "launches": {"kuu_matvec": kuu_matvec.launches,
                             "gram_matvec": gram_matvec.launches},
                "var": float(model.kernel.variance(params["kernel"])),
                "noise": float(model.likelihood.variance(params["likelihood"]))}

    ref = run(False, torch.float64, 1e-12)
    assert len(ref["steps"]) == 2 and all(c for _, c in ref["steps"])
    results = {route: run(use_pallas, torch.float32, threshold)
               for route, use_pallas in (("blocked", False), ("b3", True))}
    gaps = {}
    for route, r in results.items():
        assert len(r["steps"]) == 2 and all(c for _, c in r["steps"]), r["steps"]
        want = sum(k + 1 for k, _ in r["steps"]) if route == "b3" else 0
        assert r["launches"] == {"kuu_matvec": want, "gram_matvec": 0}, (route, r)
        assert math.isfinite(r["loss"]) and all(bool(torch.isfinite(g).all())
                                                for g in r["grads"])
        gaps[route] = {
            "forward_alpha": _rel(r["forward"][0], ref["forward"][0]),
            "forward_probes": _rel(r["forward"][1:], ref["forward"][1:]),
            "backward": _rel(r["backward"], ref["backward"]),
            "quad": abs(r["quad"] - ref["quad"]) / abs(ref["quad"]),
            "loss": abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
            # the loss's error in its two parts, signed, in loss units
            "quad_part": 0.5 * (r["quad"] - ref["quad"]),
            "logdet_part": r["loss"] - ref["loss"] - 0.5 * (r["quad"] - ref["quad"]),
            **{f"d {a}/{b}": _rel(g, w)
               for (a, b), g, w in zip(TRAINABLE, r["grads"], ref["grads"])}}
    ratios = {k: gaps["b3"][k] / gaps["blocked"][k] if gaps["blocked"][k] else math.inf
              for k in gaps["b3"] if not k.endswith("_part")}
    print(f"n={n} probes={probe_seed} threshold={threshold:g} gaps from float64 {gaps}; "
          f"b3 over blocked {ratios}")
    # The same CG step counts, up to the routes' rounding.
    for (a, _), (b, _) in zip(results["b3"]["steps"], results["blocked"]["steps"]):
        assert abs(a - b) <= max(3, 0.05 * b)
    # The solutions, forward (alpha and the solved probes) and backward:
    # vectors whose gaps from float64 both routes' stop rule sets alike.
    for what in ("forward_alpha", "forward_probes", "backward"):
        assert gaps["b3"][what] <= 2.0 * gaps["blocked"][what], (what, gaps)
    # The quadratic term: CG from zero stops with y^T alpha short of y^T
    # K^-1 y by ||e||_K^2 <= ||r||^2 / lambda_min; at a true residual
    # within 2x the stop rule's, relative to y^T K^-1 y >= ||y||^2 /
    # lambda_max, that is at most 4 threshold^2 kappa, kappa <= (n var +
    # noise) / noise.  At 1e-6 float32 rounding sets it instead.
    kappa = (n * results["b3"]["var"] + results["b3"]["noise"]) / results["b3"]["noise"]
    if threshold == PATH_THRESHOLD:
        for route in results:
            assert gaps[route]["quad"] <= 4 * threshold ** 2 * kappa, (route, gaps)
    # The two routes' losses differ only by their quadratic terms: both take
    # the same SLQ value on the blocked route from the same inputs.  Up to
    # the float32 rounding of the sum of alpha y and of 0.5 (quad + logdet +
    # n log 2 pi), whose terms are at most |loss| + n log 2 pi + |quad| in
    # size.
    b3, blocked = results["b3"], results["blocked"]
    terms = (abs(ref["loss"]) + n * math.log(2 * math.pi) + abs(ref["quad"])
             + b3["quad_terms"] + blocked["quad_terms"])
    assert abs(b3["loss"] - blocked["loss"]) <= (
        0.5 * abs(b3["quad"] - blocked["quad"]) + 8 * np.finfo(np.float32).eps * terms)
    # The gradients: scalar contractions of those solutions through the same
    # blocked VJP on both routes.  At the path's threshold each is held to
    # 3x the blocked route's gap (measured 0.87-1.78x over these cases on an
    # H100); at 1e-6 one route's gap can fall near zero by cancellation, and
    # the solutions above carry the check.
    if threshold == PATH_THRESHOLD:
        for (a, b) in TRAINABLE:
            key = f"d {a}/{b}"
            assert gaps["b3"][key] <= 3.0 * gaps["blocked"][key], (key, gaps)
