"""The matrix-free solve's custom backward pass (``ops/cg_implicit.py``
``_ImplicitSolve``) and the memory contract of matrix-free training: the
solve passes ``torch.autograd.gradcheck`` in float64 on a padded system, its
gradients equal the dense ``_CGDense`` solve's on the same system, the
backward solve's stats can be read, the checkpointed panel VJP equals the
unchecked one, and a training step at M = 4 x block creates and saves no
tensor of M x M elements (the twin of the JAX package's
``test_implicit_elbo_compiles_without_m_by_m_tensor``)."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import cggp_tpu_torch.ops.cg_implicit as cg_implicit_module
from cggp_tpu_torch.models.cggp import CGGP
from cggp_tpu_torch.models.implicit import ImplicitCGGP
from cggp_tpu_torch.ops.cg import ConjugateGradient, conjugate_gradient
from cggp_tpu_torch.ops.cg_implicit import blocked_kuu_matvec, make_implicit_cg, pad_inducing
from cggp_tpu_torch.ops.kernels import Matern32, SquaredExponential
from cggp_tpu_torch.training import adam, make_adam_step

torch.set_num_threads(1)

M, BLOCK, ROWS = 13, 4, 3  # padded to 16: four panels, three of them real
# Float64 CG stops at the reference's curvature guard (p.Ap <= 1e-16) near
# |r| ~ 1e-8; right-hand sides of scale 1e4 put that at 1e-12 relative.
RHS_SCALE = 1e4
THRESHOLD = 1e-16


def _system(seed=0):
    gen = torch.Generator().manual_seed(seed)
    kernel = Matern32()
    z = torch.rand(M, 2, generator=gen, dtype=torch.float64)
    lam = torch.rand(M, generator=gen, dtype=torch.float64) + 0.5
    rhs = RHS_SCALE * torch.randn(ROWS, M, generator=gen, dtype=torch.float64)
    ones = torch.ones(1, M, dtype=torch.float64)
    z, lam, rhs, mask = pad_inducing(z, lam, BLOCK, rhs, ones)
    kp = kernel.init_params(1.2, np.array([0.7, 1.3]), dtype=torch.float64, device="cpu")
    return kernel, kp, z, lam, rhs, mask[0]


def _leaves(kp, z, lam, rhs):
    return [t.detach().clone().requires_grad_() for t in (kp["variance"], kp["lengthscales"],
                                                          z, lam, rhs)]


def test_implicit_solve_passes_gradcheck():
    kernel, kp, z, lam, rhs, mask = _system()
    solve = make_implicit_cg(kernel, THRESHOLD, 200, block=BLOCK)

    def solution(variance, lengthscales, z_, lam_, rhs_):
        sol, stats = solve({"variance": variance, "lengthscales": lengthscales}, z_, lam_, rhs_,
                           (), mask)
        assert bool(stats.converged)
        return sol

    assert torch.autograd.gradcheck(solution, tuple(_leaves(kp, z, lam, rhs)), eps=1e-6,
                                    atol=1e-5, rtol=1e-3)


# The implicit and the dense solve of the same float64 system: gradients
# measured <= 3.1e-11 apart relative to each gradient's largest entry
# (Matern32; 8.3e-13 for se); held at 1e-9.
DENSE_RTOL = 1e-9


@pytest.mark.parametrize("kernel", [Matern32(), SquaredExponential()], ids=lambda k: k.name)
def test_gradients_equal_the_dense_solve(kernel):
    _, kp, z, lam, rhs, mask = _system(1)
    cot = torch.randn(rhs.shape, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    solve = make_implicit_cg(kernel, THRESHOLD, 200, block=BLOCK)

    def implicit(variance, lengthscales, z_, lam_, rhs_):
        return solve({"variance": variance, "lengthscales": lengthscales}, z_, lam_, rhs_, (),
                     mask)[0]

    def dense(variance, lengthscales, z_, lam_, rhs_):
        k = kernel.K({"variance": variance, "lengthscales": lengthscales}, z_)
        a = k * (mask[:, None] * mask[None, :]) + torch.diag(lam_)
        return conjugate_gradient(a, rhs_, torch.zeros_like(rhs_), THRESHOLD,
                                  max_iterations=200, max_steps_cycle=201)[0]

    grads = {}
    for name, fn in (("implicit", implicit), ("dense", dense)):
        leaves = _leaves(kp, z, lam, rhs)
        loss = torch.sum(fn(*leaves) * cot)
        grads[name] = torch.autograd.grad(loss, leaves)
    for got, want, label in zip(grads["implicit"], grads["dense"],
                                ("variance", "lengthscales", "z", "lam", "rhs")):
        scale = float(want.abs().max())
        assert torch.isfinite(got).all() and scale > 0, label
        assert float((got - want).abs().max()) <= DENSE_RTOL * scale, label
    # The pads are decoupled: no gradient reaches their coordinates or lam.
    assert torch.all(grads["implicit"][2][M:] == 0) and torch.all(grads["implicit"][3][M:] == 0)


def test_backward_solve_runs_on_the_same_route_and_its_stats_are_readable(monkeypatch):
    kernel, kp, z, lam, rhs, mask = _system(3)
    solves = []
    impl = cg_implicit_module._implicit_cg_impl

    def recording(matvec, precond_state, rhs_, *limits):
        solution, stats = impl(matvec, precond_state, rhs_, *limits)
        solves.append({"rhs": rhs_.clone(), "state": precond_state, "stats": stats})
        return solution, stats

    monkeypatch.setattr(cg_implicit_module, "_implicit_cg_impl", recording)
    from cggp_tpu_torch.ops.cg import spectral_precond_state
    from cggp_tpu_torch.ops.cg_implicit import pivoted_cholesky_kernel

    state = spectral_precond_state(pivoted_cholesky_kernel(kernel, kp, z, 4, mask=mask), lam)
    for use_pallas in (False, True):  # on the CPU, B3's route runs its plain version
        solves.clear()
        solve = make_implicit_cg(kernel, THRESHOLD, 200, block=BLOCK, use_pallas=use_pallas)
        leaves = _leaves(kp, z, lam, rhs)
        sol, _ = solve({"variance": leaves[0], "lengthscales": leaves[1]}, leaves[2],
                       leaves[3], leaves[4], state, mask)
        cot = torch.ones_like(sol)
        torch.sum(sol * cot).backward()
        assert len(solves) == 2  # the forward solve, then the backward one
        assert torch.equal(solves[1]["rhs"], cot)
        assert solves[1]["state"] is state  # the same preconditioner state
        for record in solves:
            assert bool(record["stats"].converged) and 0 < int(record["stats"].steps) < 200
        assert torch.allclose(leaves[4].grad, torch.linalg.solve(
            (Matern32().K(kp, z) * (mask[:, None] * mask[None, :]) + torch.diag(lam)).detach(),
            cot.T).T, rtol=0, atol=1e-8 if not use_pallas else 1e-4)


def test_checkpointed_panel_vjp_equals_the_unchecked_one(monkeypatch):
    kernel, kp, z, lam, rhs, mask = _system(4)

    def grads():
        leaves = _leaves(kp, z, lam, rhs)
        out = blocked_kuu_matvec(kernel, {"variance": leaves[0], "lengthscales": leaves[1]},
                                 leaves[2], leaves[3], leaves[4], block=BLOCK, mask=mask)
        return torch.autograd.grad(torch.sum(out * torch.cos(out.detach())), leaves)

    checked = grads()
    monkeypatch.setattr(cg_implicit_module, "checkpoint",
                        lambda fn, *args, use_reentrant: fn(*args))
    unchecked = grads()
    for a, b in zip(checked, unchecked):
        assert torch.allclose(a, b, rtol=1e-13, atol=1e-13 * float(b.abs().max()))


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


def _step_memory(model, params, data, panel: int):
    """Over one ``make_adam_step`` step, forward and backward: the largest
    tensor created, the largest saved for backward, and the elements saved
    in tensors of at least ``panel`` elements (a Gram panel's size)."""
    saved = {"largest": 0, "panels": 0}

    def pack(t):
        saved["largest"] = max(saved["largest"], t.numel())
        if t.numel() >= panel:
            saved["panels"] += t.numel()
        return t

    step = make_adam_step(model.training_loss, adam(0.01), model.trainable_mask(params))
    mode = _Largest()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), mode:
        new, _, loss = step(params, adam(0.01).init(params), data, torch.Generator())
    assert torch.isfinite(loss) and not torch.equal(new["kernel"]["variance"],
                                                    params["kernel"]["variance"])
    return mode.largest, saved["largest"], saved["panels"]


def test_training_step_creates_and_saves_no_m_by_m_tensor(monkeypatch):
    m, block, n = 64, 16, 8
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-1, 1, (n, 2)))
    y = torch.as_tensor(rng.standard_normal((n, 1)))
    iv = rng.uniform(-1, 1, (m, 2))
    u = rng.standard_normal((m, 1))
    model = ImplicitCGGP(kernel=SquaredExponential(), num_data=n, num_probes=2,
                         error_threshold=1e-10, max_cg_iterations=16, block=block,
                         precondition="pivchol", precond_rank=4)
    params = model.init_params(iv, pseudo_u=u, dtype=torch.float64, device="cpu")
    assert params["inducing_points"].shape[0] == m
    largest, largest_saved, panels_saved = _step_memory(model, params, (x, y), block * m)
    assert largest < m * m and largest_saved < m * m, (largest, largest_saved)
    assert panels_saved == 0  # every panel rebuilt in the backward pass, none kept
    # Sanity: the same check sees the dense model's [M, M] Gram matrix, and
    # the implicit step's panels, M x M in all, once they are not rebuilt.
    dense = CGGP(kernel=SquaredExponential(), num_data=n, num_probes=2,
                 conjugate_gradient=ConjugateGradient(1e-10, max_iterations=16))
    dparams = dense.init_params(iv, pseudo_u=u, dtype=torch.float64, device="cpu")
    assert _step_memory(dense, dparams, (x, y), block * m)[0] >= m * m
    monkeypatch.setattr(cg_implicit_module, "checkpoint",
                        lambda fn, *args, use_reentrant: fn(*args))
    assert _step_memory(model, params, (x, y), block * m)[2] >= m * m
