"""Gang training's kernel paths on the card: B1 with a gang axis (one
launch over [G, R, M] x [G, M, M], each member bitwise a launch on the
member alone, on both launch shapes and at skewed row addresses), the gang
CG on the ``"pallas"`` route against per-member solves, the gang through B2
member by member, and the one-rank NCCL mesh's sharded solve.

Every test takes the ``cuda`` fixture, which skips it without a card (the
CPU runs); the decision is made there, never at import.  On a machine with
a card, without JAX::

    python -m pytest tests/test_torch_cuda_gang.py -q --noconftest
"""

import pytest
import torch

from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.ops.pallas_cg import pallas_cg_solve
from cggp_tpu_torch.ops.pallas_matvec import pallas_matvec, pallas_matvec_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with --noconftest (module docstring)")
    from cggp_tpu_torch import resolve_device

    return resolve_device("cuda")


def _spd(gang, m, gen, device):
    g = torch.randn(gang, m, m, generator=gen, device=device)
    return ((g @ g.mT) / m + torch.eye(m, device=device)).contiguous()


@pytest.mark.parametrize("rows", [1, 8, 9, 300])
@pytest.mark.parametrize("m", [33, 989])
def test_batched_b1_is_bitwise_per_member(cuda, rows, m):
    """One gang launch equals G separate launches bitwise, on the GEMV (R <=
    8) and the tiled (R > 8) shapes, and sits within 2x the plain version's
    error from fp64."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = _spd(3, m, gen, cuda)
    p = torch.randn(3, rows, m, generator=gen, device=cuda)
    before = pallas_matvec.launches
    got = pallas_matvec(p, a)
    assert pallas_matvec.launches == before + 1
    for g in range(3):
        assert torch.equal(got[g], pallas_matvec(p[g].contiguous(), a[g].contiguous()))
    exact = p.double() @ a.double()
    plain = pallas_matvec_plain(p, a)
    assert float((got.double() - exact).abs().max()) <= 2 * float(
        (plain.double() - exact).abs().max()) + 1e-12


def test_batched_b1_at_a_skewed_address(cuda):
    """p starting 1 to 3 words into its buffer: the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    a = _spd(2, 989, gen, cuda)
    p = torch.randn(2, 40, 989, generator=gen, device=cuda)
    want = pallas_matvec(p, a)
    for offset in (1, 2, 3):
        skew = torch.empty(p.numel() + offset, device=cuda)[offset:].view(p.shape)
        skew.copy_(p)
        assert torch.equal(pallas_matvec(skew, a), want)


@pytest.mark.parametrize("impl", ["pallas", "pallas_resident"])
def test_gang_cg_on_the_kernel_routes_matches_per_member_solves(cuda, impl):
    """The gang solve through B1 (one launch a matvec) and B2 (one launch a
    member): each member's solution and steps as a solo solve's (B2 runs
    the member alone: bitwise; B1's gang loop sums its dots over the gang's
    rows: steps within 1, the solution within fp32 CG's 1e-4)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    a = _spd(2, 512, gen, cuda)
    a[1].diagonal().add_(-0.9)  # the second member converges later
    b = torch.randn(2, 512, 4, generator=gen, device=cuda)
    cg = ConjugateGradient(1e-8 if impl == "pallas_resident" else 1e-5, max_iterations=400,
                           relative_threshold=impl == "pallas", matvec_impl=impl)
    b1, b2 = pallas_matvec.launches, pallas_cg_solve.launches
    sol, stats = cg.solve_with_stats(a, b)
    if impl == "pallas_resident":
        assert pallas_cg_solve.launches - b2 == 2
    else:
        assert pallas_matvec.launches - b1 == int(stats.steps.max()) + 1
    for g in range(2):
        want, wstats = cg.solve_with_stats(a[g], b[g])
        if impl == "pallas_resident":
            assert int(stats.steps[g]) == int(wstats.steps)
            assert torch.equal(sol[g], want)
        else:
            assert abs(int(stats.steps[g]) - int(wstats.steps)) <= 1
            torch.testing.assert_close(sol[g], want, rtol=1e-4, atol=1e-4)


def test_one_rank_nccl_sharded_solve_equals_the_dense_solve(cuda):
    """``make_mesh(1)`` on the card starts a one-rank NCCL group; the sharded
    solve's row block is then the whole system: the dense ``"xla"`` solve's
    bits and steps."""
    import numpy as np

    from cggp_tpu_torch.ops.cg import conjugate_gradient
    from cggp_tpu_torch.ops.kernels import Matern32
    from cggp_tpu_torch.ops.linalg import add_diagonal
    from cggp_tpu_torch.parallel import make_mesh, make_sharded_cg

    mesh = make_mesh(1)
    assert mesh.size == 1 and mesh.device.type == "cuda"
    rng = np.random.default_rng(3)
    z = torch.as_tensor(rng.uniform(-2, 2, (700, 3)), dtype=torch.float32, device=cuda)
    lam = torch.as_tensor(rng.uniform(0.1, 0.5, 700), dtype=torch.float32, device=cuda)
    rhs = torch.as_tensor(rng.standard_normal((2, 700)), dtype=torch.float32, device=cuda)
    kp = Matern32().init_params(lengthscales=np.full(3, 0.5), dtype=torch.float32, device=cuda)
    sol, stats = make_sharded_cg(Matern32(), mesh, 1e-10, 300, relative_threshold=True)(
        kp, z, lam, rhs)
    want, wstats = conjugate_gradient(add_diagonal(Matern32().K(kp, z), lam), rhs,
                                      torch.zeros_like(rhs), 1e-10, max_iterations=300,
                                      max_steps_cycle=301, relative_threshold=True)
    assert int(stats.steps) == int(wstats.steps)
    assert torch.equal(sol, want)
