"""The port's CUDA kernels on the card, against their plain versions and an
fp64 reference, at chip_smoke.py's tolerances: B1 (``pallas_matvec``), B2
(``pallas_cg_solve``: both launch paths, each side of the small-R switches,
the edge cases, bitwise repeats, the training step's block of mixed-scale
and zero rows), B3 (``gram_matvec`` / ``kuu_matvec``), and the CG autograd
Function's gradients through B2 and B1.

Every test takes the ``cuda`` fixture, which skips it without a card (the
CPU runs); the decision is made there, never at import, so every worker
collects the same tests.  On a machine with a card, without JAX::

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

(``--noconftest``: the suite's conftest configures JAX, which this file
does not use.)
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from cggp_tpu_torch.ops.cg_implicit import pad_inducing
from cggp_tpu_torch.ops.kernels import kernel_value_from_r2, scaled_squared_distance
from cggp_tpu_torch.ops.pallas_cg import pallas_cg_plan, pallas_cg_solve, pallas_cg_solve_plain
from cggp_tpu_torch.ops.pallas_gram import (gram_matvec, gram_matvec_plain, kuu_matvec,
                                            kuu_matvec_plain)
from cggp_tpu_torch.ops.pallas_matvec import pallas_matvec, pallas_matvec_plain

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parent.parent
M_DENSE = 989  # the dense serving shape (committed cover-tree selection)
M_IMPLICIT, M_PAD = 9576, 10240  # the matrix-free serving shape, padded as served


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with --noconftest (module docstring)")
    from cggp_tpu_torch import resolve_device

    return resolve_device("cuda")


def _max_rel(got, ref, scale):
    return float(((got.double() - ref.double()).abs()).max()) / scale


@pytest.mark.parametrize("rows", [1, 8192])
def test_b1_matches_plain_and_fp64(cuda, rows):
    gen = torch.Generator(device=cuda).manual_seed(0)
    g = torch.randn(M_DENSE, M_DENSE, generator=gen, device=cuda)
    a = ((g @ g.T) / M_DENSE + torch.eye(M_DENSE, device=cuda)).contiguous()
    p = torch.randn(rows, M_DENSE, generator=gen, device=cuda)
    launches = pallas_matvec.launches
    got = pallas_matvec(p, a)
    torch.cuda.synchronize()
    assert pallas_matvec.launches == launches + 1
    plain = pallas_matvec_plain(p, a)
    exact = p.double() @ a.double()
    scale = float((p.abs() @ a.abs()).max())
    # chip_smoke.py's B1 gate, and its accuracy gate against fp64.
    assert _max_rel(got, plain, scale) <= 1e-5
    assert _max_rel(got, exact, scale) <= 2 * _max_rel(plain, exact, scale)


def test_b1_two_level_depth_sums_at_m_32768(cuda):
    """B1 at the solver family's shape (R = 16 rows of bench.py's M = 32768
    system: Matern32 over uniform(-2, 2)^8 at lengthscale 1.2, Lambda
    uniform in [0.05, 0.5]).  With one running sum over the depth its error
    from fp64 was 3.0x torch.matmul's (9.07e-5 against 3.06e-5, H100 80GB
    HBM3 at 700 W); with the outer sums every 32 stages 0.50x (1.52e-5),
    inside the 2x rule of every kernel path."""
    from cggp_tpu_torch.ops.kernels import Matern32

    rng = np.random.RandomState(0)
    m = 32768
    kern = Matern32()
    kp = kern.init_params(1.0, np.full(8, 1.2), dtype=torch.float32, device=cuda)
    z = torch.as_tensor(rng.uniform(-2, 2, (m, 8)), dtype=torch.float32, device=cuda)
    lam = torch.as_tensor(rng.uniform(0.05, 0.5, (m,)), dtype=torch.float32, device=cuda)
    p = torch.as_tensor(rng.standard_normal((16, m)), dtype=torch.float32, device=cuda)
    with torch.no_grad():
        a = (kern.K(kp, z) + torch.diag(lam)).contiguous()
        got, lib = pallas_matvec(p, a), torch.matmul(p, a)
        exact = p.double() @ a.double()
    err = float((got.double() - exact).abs().max())
    lib_err = float((lib.double() - exact).abs().max())
    print(f"B1 error from fp64 {err:.3e}, torch.matmul's {lib_err:.3e}")
    assert err <= 2.0 * lib_err, (err, lib_err)


def _at_offset(t, offset):
    """A contiguous copy of ``t`` that starts ``offset`` words into its buffer."""
    view = torch.empty(t.numel() + offset, device=t.device)[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("rows", [1, 9, 300])
def test_b1_takes_p_at_any_offset(cuda, rows, offset):
    # p one to three words into its buffer: its rows sit at every skew from
    # 16-byte alignment; the kernel reads the same values, so the output is
    # bitwise the aligned one's.
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = torch.randn(M_DENSE, M_DENSE, generator=gen, device=cuda)
    a = ((g @ g.T) / M_DENSE + torch.eye(M_DENSE, device=cuda)).contiguous()
    p = torch.randn(rows, M_DENSE, generator=gen, device=cuda)
    p_off = _at_offset(p, offset)
    assert p_off.data_ptr() % 16 == 4 * offset
    got = pallas_matvec(p_off, a)
    torch.cuda.synchronize()
    assert torch.equal(got, pallas_matvec(p, a))
    scale = float((p.abs() @ a.abs()).max())
    assert _max_rel(got, pallas_matvec_plain(p, a), scale) <= 1e-5


def _dense_system(device):
    from cggp_tpu_torch.data import synthetic
    from cggp_tpu_torch.models.cggp import CGGP
    from cggp_tpu_torch.ops.cg import ConjugateGradient
    from cggp_tpu_torch.ops.kernels import Matern32
    from cggp_tpu_torch.ops.linalg import add_diagonal

    with np.load(ROOT / "benchmarks" / "e2e_selection_covertree.npz") as sel:
        iv, u, counts = sel["iv"], sel["u"], sel["counts"]
    (x_train, _), (x_test, _) = synthetic(n=435_000, dim=3, seed=0)
    model = CGGP(kernel=Matern32(), num_data=x_train.shape[0],
                 conjugate_gradient=ConjugateGradient(1e-8))
    params = model.init_params(iv, pseudo_u=u, cluster_counts=counts, dtype=torch.float32,
                               device=device)
    kp, z = params["kernel"], params["inducing_points"]
    a = add_diagonal(Matern32().K(kp, z), model.diag_variance(params)[:, 0]).contiguous()
    xq = torch.as_tensor(x_test[:8192], dtype=torch.float32, device=device)
    return a, {"pseudo_u": params["pseudo_u"].T.contiguous(),
               "kmn_batch": Matern32().K(kp, xq, z).contiguous()}


@pytest.mark.parametrize("rhs_name", ["pseudo_u", "kmn_batch"])
def test_b2_matches_plain_and_fp64(cuda, rhs_name):
    a, rhs = _dense_system(cuda)
    b = rhs[rhs_name]
    m = a.shape[0]
    got, steps = pallas_cg_solve(a, b, 1e-8, m)
    plain, steps_plain = pallas_cg_solve_plain(a, b, 1e-8, m)
    torch.cuda.synchronize()
    exact = torch.linalg.solve(a.double(), b.double().T).T
    tol = 2e-3 * float(exact.abs().max())  # chip_smoke.py's B2 gates
    assert int(steps) < m
    assert abs(int(steps) - int(steps_plain)) <= max(3, 0.05 * int(steps_plain))
    assert float((got - plain).abs().max()) <= tol
    err_exact = float((got.double() - exact).abs().max())
    assert err_exact <= tol
    assert err_exact <= 2 * float((plain.double() - exact).abs().max())


def _spd_system(device, m, rows, seed):
    """An SE Gram matrix of points in [-1, 1]^2 plus a diagonal shift in
    [0.2, 0.6] (as tests/test_torch_pallas_cg.py), and standard normal rows."""
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.rand(m, 2, generator=gen, device=device) * 2 - 1
    lam = torch.rand(m, generator=gen, device=device) * 0.4 + 0.2
    a = (torch.exp(-0.5 * torch.cdist(z, z) ** 2) + torch.diag(lam)).contiguous()
    return a, torch.randn(rows, m, generator=gen, device=device)


# 0.5 |r|^2 <= thr puts a converged row within sqrt(2 thr) / lambda_min of
# the exact solution, lambda_min >= 0.2 here; twice that for fp32 drift.
B2_THRESHOLD = 1e-8
B2_TOL = 2 * (2 * B2_THRESHOLD) ** 0.5 / 0.2


def _check_b2(a, b, max_iterations=None):
    """B2 against the plain loop and the fp64 solve: steps within
    max(3, 15 %) of the plain loop's (fp32 runs whose sums differ in order
    cross the threshold a few steps apart on these systems), both solutions
    within the stop rule's bound of the fp64 solve; two runs bitwise equal."""
    m = a.shape[0]
    cap = m if max_iterations is None else max_iterations
    launches = pallas_cg_solve.launches
    got, steps = pallas_cg_solve(a, b, B2_THRESHOLD, cap)
    again, steps_again = pallas_cg_solve(a, b, B2_THRESHOLD, cap)
    plain, steps_plain = pallas_cg_solve_plain(a, b, B2_THRESHOLD, cap)
    torch.cuda.synchronize()
    assert pallas_cg_solve.launches == launches + 2
    assert steps.dtype == torch.int32 and steps.shape == () and steps.device == b.device
    assert torch.equal(got, again) and int(steps) == int(steps_again)
    assert int(steps) < cap
    assert abs(int(steps) - int(steps_plain)) <= max(3, 0.15 * int(steps_plain))
    exact = torch.linalg.solve(a.double(), b.double().T).T
    assert float((got.double() - exact).abs().max()) <= B2_TOL
    assert float((plain.double() - exact).abs().max()) <= B2_TOL
    return got, steps


@pytest.mark.parametrize("m", [33, 989, 1000])
@pytest.mark.parametrize("rows", [1, 2, 8, 9, 130, 8192])
def test_b2_shapes_match_plain_and_fp64(cuda, rows, m):
    a, b = _spd_system(cuda, m, rows, seed=rows + m)
    path = pallas_cg_plan(rows, m, cuda)["path"]
    assert path == ("small_resident" if rows <= 8 else "tiled")
    _check_b2(a, b)


def test_b2_two_level_depth_sums_at_m_32768(cuda):
    """B2's tiled path at the solver family's shape (R = 16 rows of
    bench.py's M = 32768 system, as test_b1_two_level_depth_sums_at_m_32768),
    five CG steps (threshold 0): the iterate's error from the fp64 loop
    within 2x the plain loop's (torch.matmul, IEEE fp32).  Measured on an
    H100 80GB HBM3 at 700 W: 1.18x (2.40e-6 against 2.03e-6); a build with
    one running sum over the 1024 stages 3.32x (6.74e-6)."""
    from cggp_tpu_torch.ops.kernels import Matern32

    rng = np.random.RandomState(0)
    m, rows, steps = 32768, 16, 5
    kern = Matern32()
    kp = kern.init_params(1.0, np.full(8, 1.2), dtype=torch.float32, device=cuda)
    z = torch.as_tensor(rng.uniform(-2, 2, (m, 8)), dtype=torch.float32, device=cuda)
    lam = torch.as_tensor(rng.uniform(0.05, 0.5, (m,)), dtype=torch.float32, device=cuda)
    b = torch.as_tensor(rng.standard_normal((rows, m)), dtype=torch.float32, device=cuda)
    assert pallas_cg_plan(rows, m, cuda)["path"] == "tiled"
    with torch.no_grad():
        a = (kern.K(kp, z) + torch.diag(lam)).contiguous()
        launches = pallas_cg_solve.launches
        got, got_steps = pallas_cg_solve(a, b, 0.0, steps)
        assert pallas_cg_solve.launches == launches + 1 and int(got_steps) == steps
        plain, _ = pallas_cg_solve_plain(a, b, 0.0, steps)
        exact, _ = pallas_cg_solve_plain(a.double(), b.double(), 0.0, steps)
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    print(f"B2 five steps' error from fp64 {err:.3e}, the plain loop's {plain_err:.3e}")
    assert err <= 2.0 * plain_err, (err, plain_err)


def _largest_m(device, rows, path):
    """The largest M whose plan for `rows` rows is `path`, by bisection: as
    M grows a small-R solve goes from A in shared memory to A streamed to
    the tiled path, never back."""
    order = {"small_resident": 0, "small_streamed": 1, "tiled": 2}

    def at_most(m):
        return order[pallas_cg_plan(rows, m, device)["path"]] <= order[path]

    lo, hi = 33, 65536
    assert at_most(lo) and not at_most(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if at_most(mid) else (lo, mid)
    assert pallas_cg_plan(rows, lo, device)["path"] == path
    return lo


@pytest.mark.parametrize("rows,path,side", [
    (1, "small_resident", 0), (1, "small_resident", 1),
    (8, "small_resident", 0), (8, "small_resident", 1),
    (8, "small_streamed", 0), (8, "small_streamed", 1)])
def test_b2_small_r_switch(cuda, rows, path, side):
    # Each side of a switch: A's column slices in shared memory, then
    # streamed from L2; at R = 8 also p in shared memory, then the tiled path.
    last = _largest_m(cuda, rows, path)
    after = {"small_resident": "small_streamed", "small_streamed": "tiled"}[path]
    m = last + side
    assert pallas_cg_plan(rows, m, cuda)["path"] == (path if side == 0 else after)
    a, b = _spd_system(cuda, m, rows, seed=m)
    _check_b2(a, b)


@pytest.mark.parametrize("rows", [1, 130])
def test_b2_zero_cap_and_rhs_under_threshold(cuda, rows):
    a, b = _spd_system(cuda, 989, rows, seed=5)
    v, steps = pallas_cg_solve(a, b, B2_THRESHOLD, 0)  # no step allowed
    small = b * (B2_THRESHOLD ** 0.5 / float(b.norm(dim=1).max()))  # 0.5 |b|^2 < thr
    w, steps_small = pallas_cg_solve(a, small, B2_THRESHOLD, 989)
    torch.cuda.synchronize()
    assert int(steps) == 0 and not v.any()
    assert int(steps_small) == 0 and not w.any()


@pytest.mark.parametrize("rows", [5, 9])
def test_b2_zero_rows(cuda, rows):
    # Zero rows stay exactly zero and never hold the others back.
    a, b = _spd_system(cuda, 989, rows, seed=6)
    b[1] = 0.0
    b[3] = 0.0
    got, _ = _check_b2(a, b)
    assert not got[1].any() and not got[3].any()


@pytest.mark.parametrize("rows", [1, 9, 300])
def test_b2_takes_rhs_at_an_offset(cuda, rows):
    # The rhs one word into its buffer (rows not 16-byte aligned): the same
    # values are read, so the output is bitwise the aligned one's.
    a, b = _spd_system(cuda, 989, rows, seed=7)
    b_off = _at_offset(b, 1)
    assert b_off.data_ptr() % 16 == 4
    got, steps = pallas_cg_solve(a, b_off, B2_THRESHOLD, 989)
    want, want_steps = pallas_cg_solve(a, b, B2_THRESHOLD, 989)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(steps) == int(want_steps)


TRAIN_ROWS = 2059  # the fused training block: [u | 5 + 5 probes | 2048 Kmn rows]


def test_b2_mixed_scales_and_zero_rows_at_the_training_shape(cuda):
    # The shape and the kind of rows of the training step's backward solve:
    # 2059 rows at M = 989 whose norms span 1 to 1e5, five of them zero (the
    # logdet probes' cotangents).  The absolute stop rule is decided by the
    # largest rows.  B2 is held to its plain loop and to fp64 as chip_smoke.py
    # holds it: steps within max(3, 5 %), no further from fp64 than twice the
    # plain loop, zero rows exactly zero.
    a, rhs = _dense_system(cuda)
    b = rhs["kmn_batch"][:TRAIN_ROWS].clone()
    scales = 10.0 ** (5.0 * torch.arange(TRAIN_ROWS, device=cuda) / (TRAIN_ROWS - 1))
    b = (b / b.norm(dim=1, keepdim=True) * scales[:, None]).contiguous()
    b[6:11] = 0.0
    m = a.shape[0]
    launches = pallas_cg_solve.launches
    got, steps = pallas_cg_solve(a, b, 1e-8, m)
    plain, steps_plain = pallas_cg_solve_plain(a, b, 1e-8, m)
    torch.cuda.synchronize()
    assert pallas_cg_solve.launches == launches + 1
    assert torch.isfinite(got).all() and not got[6:11].any()
    assert abs(int(steps) - int(steps_plain)) <= max(3, 0.05 * int(steps_plain))
    exact = torch.linalg.solve(a.double(), b.double().T).T
    err = float((got.double() - exact).abs().max())
    assert err <= 2.0 * float((plain.double() - exact).abs().max())


@pytest.mark.parametrize("impl", ["pallas_resident", "pallas"])
def test_cg_function_gradients_on_the_card(cuda, impl, monkeypatch):
    # The autograd Function's dA and db through B2 (both solves) or B1 (every
    # matvec of both solves), at the training shape, against fp64 solves: no
    # further from them than twice the float32 "xla" route.
    import cggp_tpu_torch.ops.cg as cg_module
    from cggp_tpu_torch.ops.cg import conjugate_gradient

    solves = []  # every solve's stats, forward and backward
    impl_fn = cg_module._cg_dense_impl

    def recording(*args):
        out = impl_fn(*args)
        solves.append(out[1])
        return out

    monkeypatch.setattr(cg_module, "_cg_dense_impl", recording)

    a, rhs = _dense_system(cuda)
    b = rhs["kmn_batch"][:TRAIN_ROWS].contiguous()
    gen = torch.Generator(device=cuda).manual_seed(9)
    dx = torch.randn(b.shape, generator=gen, device=cuda)
    m = a.shape[0]

    def grads(route):
        aa = a.clone().requires_grad_()
        bb = b.clone().requires_grad_()
        sol, stats = conjugate_gradient(aa, bb, torch.zeros_like(bb), 1e-8,
                                        max_iterations=m, max_steps_cycle=m + 1,
                                        matvec_impl=route)
        sol.backward(dx)
        return aa.grad, bb.grad, int(stats.steps)

    counters = (pallas_cg_solve.launches, pallas_matvec.launches)
    da, db, _ = grads(impl)
    launched = (pallas_cg_solve.launches - counters[0], pallas_matvec.launches - counters[1])
    steps = [int(st.steps) for st in solves]
    da_plain, db_plain, _ = grads("xla")
    torch.cuda.synchronize()
    assert len(steps) == 2  # the forward solve and the backward solve
    if impl == "pallas_resident":
        assert launched == (2, 0)
    else:  # the initial residual and one matvec a step, in both solves
        assert launched == (0, sum(k + 1 for k in steps))
    a64 = a.double()
    sol64 = torch.linalg.solve(a64, b.double().T).T
    db64 = torch.linalg.solve(a64, dx.double().T).T
    da64 = -sol64.T @ db64
    for got, plain, exact in ((da, da_plain, da64), (db, db_plain, db64)):
        assert torch.isfinite(got).all()
        err = float((got.double() - exact).abs().max())
        assert err <= 2.0 * float((plain.double() - exact).abs().max())


def _implicit_operands(device, rows):
    gen = torch.Generator(device=device).manual_seed(1)
    z = torch.rand(M_IMPLICIT, 3, generator=gen, device=device) * 4 - 2
    lam = torch.rand(M_IMPLICIT, generator=gen, device=device) * 0.09 + 0.01
    z, lam = pad_inducing(z, lam, M_PAD)
    mask = (torch.arange(M_PAD, device=device) < M_IMPLICIT).float()
    p = (torch.randn(rows, M_PAD, generator=gen, device=device) * mask).contiguous()
    return z.contiguous(), lam.contiguous(), p


@pytest.mark.parametrize("rows", [1, 8192])
def test_b3_kuu_matches_plain_and_fp64(cuda, rows):
    z, lam, p = _implicit_operands(cuda, rows)
    var = torch.ones(1, device=cuda)
    launches = kuu_matvec.launches
    got = kuu_matvec(z, lam, p, var, "matern32")
    torch.cuda.synchronize()
    assert kuu_matvec.launches == launches + 1
    assert bool(torch.isfinite(got).all())
    plain = kuu_matvec_plain(z, lam, p, var, "matern32")
    scale = float(kuu_matvec_plain(z, lam, p.abs(), var, "matern32").max())
    assert _max_rel(got, plain, scale) <= 5e-5  # chip_smoke.py's B3 gate
    # Pad columns: K is 0 against every real point and p is 0 there, so the
    # output is exactly p * lam (= 0), off the tensor cores.
    assert bool((got[:, M_IMPLICIT:] == p[:, M_IMPLICIT:] * lam[M_IMPLICIT:]).all())
    if rows > 8:
        z64 = z.double()
        k64 = kernel_value_from_r2("matern32", scaled_squared_distance(z64, z64),
                                   torch.tensor(1.0, dtype=torch.float64, device=cuda))
        exact = p.double() @ k64 + p.double() * lam.double()
        del k64
        assert _max_rel(got, exact, scale) <= 2 * _max_rel(plain, exact, scale)


@pytest.mark.parametrize("kernel_name", ["se", "matern12", "matern32", "matern52"])
@pytest.mark.parametrize("n,m,d,r", [(1000, 777, 3, 5), (1000, 777, 5, 37), (333, 1001, 32, 130),
                                     (8192, 10240, 3, 1)])
def test_b3_gram_matches_plain(cuda, kernel_name, n, m, d, r):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = (torch.rand(n, d, generator=gen, device=cuda) * 4 - 2).contiguous()
    z = (torch.rand(m, d, generator=gen, device=cuda) * 4 - 2).contiguous()
    v = torch.randn(m, r, generator=gen, device=cuda)
    got = gram_matvec(x, z, v, 1.3, kernel_name)
    torch.cuda.synchronize()
    plain = gram_matvec_plain(x, z, v, 1.3, kernel_name)
    scale = float(gram_matvec_plain(x, z, v.abs(), 1.3, kernel_name).max())
    assert _max_rel(got, plain, scale) <= 5e-5


@pytest.mark.parametrize("rows", [9, 300])
def test_b3_kuu_takes_p_at_an_offset(cuda, rows):
    # p one word into its buffer: rows no longer 16-byte aligned, so the
    # tiled launch copies its B tiles another way; the output is bitwise the
    # aligned one's.
    z, lam, p = _implicit_operands(cuda, rows)
    var = torch.ones(1, device=cuda)
    p_off = _at_offset(p, 1)
    got = kuu_matvec(z, lam, p_off, var, "matern32")
    torch.cuda.synchronize()
    assert torch.equal(got, kuu_matvec(z, lam, p, var, "matern32"))
