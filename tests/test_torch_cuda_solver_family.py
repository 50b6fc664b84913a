"""The CG solver family's card routes and LOVE serving through B3, on the
card, against float64: ``xla_high`` (every matvec through kernel B1), the
bf16 products (``torch.mm(..., out_dtype=torch.float32)``), the refinement
loops, the compensated dot, and ``ImplicitCGGP``'s LOVE cache built through
``kuu_matvec`` (kernel B3), one launch per Lanczos step.

Every test takes the ``cuda`` fixture, which skips it without a card (the
CPU runs).  On a machine with a card, without JAX::

    python -m pytest tests/test_torch_cuda_solver_family.py -q --noconftest

Tolerances: solutions within the stop rule's distance of the float64 solve
(``2 sqrt(threshold) |b| / lambda_min`` per column); the bf16 product
within fp32 rounding of the float64 product of the bf16-rounded operands
(``8 eps_32`` of ``|p| |A|``, at one row too, where cuBLAS may split the
sum); the kernel route's LOVE variances within 2x the float32 blocked
route's gap from a float64 LOVE cache (the rule every kernel path is held
to) and conservative against the float64 Cholesky variances less twice
that gap.
"""

import math

import numpy as np
import pytest
import torch

from cggp_tpu_torch.models import ClusterGP, ImplicitCGGP
from cggp_tpu_torch.ops import cg as tcg
from cggp_tpu_torch.ops.kernels import Matern32
from cggp_tpu_torch.ops.linalg import compensated_dot
from cggp_tpu_torch.ops.pallas_gram import kuu_matvec
from cggp_tpu_torch.ops.pallas_matvec import pallas_matvec

pytestmark = pytest.mark.cuda
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with --noconftest (module docstring)")
    from cggp_tpu_torch import resolve_device

    return resolve_device("cuda")


def _system(device, m=2048, d=8, rhs=4, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(m, d, generator=gen, device=device)
    kern = Matern32()
    kp = kern.init_params(1.0, np.ones(d), dtype=torch.float32, device=device)
    lam = 0.05 + 0.45 * torch.rand(m, generator=gen, device=device)
    a = (kern.K(kp, x) + torch.diag(lam)).contiguous()
    b = torch.randn(m, rhs, generator=gen, device=device)
    return a, b


@pytest.mark.parametrize("rhs", [1, 4])
@pytest.mark.parametrize("impl", ["xla_high", "bf16_ir", "bf16_ru", "xla"])
def test_routes_converge_within_the_stop_rule(cuda, impl, rhs):
    a, b = _system(cuda, rhs=rhs)
    a64, b64 = a.double(), b.double()
    exact = torch.linalg.solve(a64, b64)
    lam_min = float(torch.linalg.eigvalsh(a64)[0])
    rel = 1e-6
    dot = "compensated" if impl == "xla" else "standard"
    before = pallas_matvec.launches
    got, stats = tcg.ConjugateGradient(rel, relative_threshold=True, matvec_impl=impl, dot=dot,
                                       max_iterations=1000).solve_with_stats(a, b)
    torch.cuda.synchronize()
    launches = pallas_matvec.launches - before
    assert bool(stats.converged) and got.dtype == torch.float32
    # xla_high: B1 for every matvec (the steps plus the initial residual).
    assert launches == (int(stats.steps) + 1 if impl == "xla_high" else 0)
    bound = 2 * math.sqrt(rel) * torch.linalg.vector_norm(b64, dim=0) / lam_min
    assert bool(torch.all(torch.linalg.vector_norm(got.double() - exact, dim=0) <= bound))


@pytest.mark.parametrize("rows", [1, 16])
def test_bf16_product_sums_in_fp32(cuda, rows):
    a, _ = _system(cuda, m=1024)
    p = torch.randn(rows, 1024, device=cuda)
    got = tcg._bf16_diagsplit_matvec(a)(p)
    assert got.dtype == torch.float32
    off = a.to(torch.bfloat16)
    off.diagonal().zero_()
    exact = p.to(torch.bfloat16).double() @ off.double() + p.double() * torch.diagonal(a).double()
    scale = (p.abs().double() @ a.abs().double()).max()
    assert float((got.double() - exact).abs().max()) <= 8 * EPS32 * float(scale)


def test_compensated_dot_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(8, 5000, generator=gen, device=cuda) * 1e3
    y = torch.randn(8, 5000, generator=gen, device=cuda)
    prods = (x * y).double()
    exact = prods.sum(-1, keepdim=True)
    got = compensated_dot(x, y)
    tol = 2 * EPS32 * exact.abs() + math.log2(5000) * EPS32 ** 2 * prods.abs().sum(-1, True)
    assert bool(torch.all((got.double() - exact).abs() <= tol))


def test_implicit_love_cache_through_b3(cuda):
    gen = np.random.default_rng(0)
    m, block, rank = 3000, 1024, 64  # padded to 3072
    z = gen.uniform(-2, 2, (m, 3))
    u = np.sin(z.sum(-1, keepdims=True))
    counts = gen.integers(1, 5, (m, 1)).astype(np.float64)

    def model(use_pallas):
        return ImplicitCGGP(kernel=Matern32(), num_data=10 * m, block=block,
                            error_threshold=1e-6, relative_threshold=True,
                            max_cg_iterations=2000, use_pallas=use_pallas,
                            serving_lanczos_rank=rank)

    def params(dtype):
        return model(False).init_params(z, pseudo_u=u, cluster_counts=counts,
                                        dtype=dtype, device=cuda)

    p32, p64 = params(torch.float32), params(torch.float64)
    kernel_model = model(True)
    steps = []
    solve = kernel_model._solve

    def recording(*args, **kw):
        out = solve(*args, **kw)
        steps.append(int(out[1].steps))
        return out

    object.__setattr__(kernel_model, "_solve", recording)
    before = kuu_matvec.launches
    post = kernel_model.posterior(p32, solver="lanczos")
    torch.cuda.synchronize()
    assert kuu_matvec.launches - before == steps[0] + 1 + rank
    pads = p32["inducing_mask"][:, 0] == 0
    assert int(pads.sum()) == 72 and bool(torch.all(post.lanczos_r[:, pads] == 0))
    blocked = model(False).posterior(p32, solver="lanczos")
    ref = model(False).posterior(p64, solver="lanczos")
    xq = torch.as_tensor(gen.uniform(-2, 2, (512, 3)), device=cuda)
    var = kernel_model.posterior_predict(post, xq.float())[1].double()
    var_blocked = model(False).posterior_predict(blocked, xq.float())[1].double()
    var_ref = model(False).posterior_predict(ref, xq)[1]
    gap, gap_blocked = (float((v - var_ref).abs().max()) for v in (var, var_blocked))
    assert gap <= 2 * gap_blocked
    oracle = ClusterGP(kernel=Matern32())
    real = {k: (v[~pads] if k in ("inducing_points", "pseudo_u", "cluster_counts") else v)
            for k, v in p64.items() if k != "inducing_mask"}
    exact = oracle.posterior_predict(oracle.posterior(real), xq)[1]
    assert bool(torch.all(var >= exact - 2 * gap_blocked))
