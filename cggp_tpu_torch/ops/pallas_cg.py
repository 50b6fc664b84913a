"""Kernel B2: a whole unpreconditioned CG solve in one launch (port of
``cggp_tpu/ops/pallas_cg.py``).

:func:`pallas_cg_solve` launches the hand-written cooperative CUDA kernel
(``csrc/pallas_cg.cu``) on CUDA tensors and uses its plain version,
:func:`pallas_cg_solve_plain`, on CPU tensors; on any other device it
raises.  Both follow the TPU kernel ``_cg_kernel``: ``v0 = 0``; iterate
while any row has ``0.5 |r|^2 > threshold`` and ``i < max_iterations``;
``gamma = 0`` when ``p.pA <= 1e-16``; no momentum when the old ``r.r <=
1e-16``; the association ``(p * new_rz) / rz``.  A converged row keeps
stepping until every row has converged.  The TPU wrapper pads M to 128 with
a unit diagonal and R to 8 with zero rows; neither changes the answer, and
neither version here pads.  ``pallas_cg_solve.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from cggp_tpu_torch.ops.pallas_matvec import check_device, check_operand

_MIN_FLOAT = 1e-16


def pallas_cg_solve_plain(a: torch.Tensor, rhs: torch.Tensor, threshold: float,
                          max_iterations: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's loop in torch ops: ``(solution [R, M], steps int32)``."""
    zero = torch.zeros((), dtype=rhs.dtype, device=rhs.device)
    thr = torch.tensor(threshold, dtype=rhs.dtype, device=rhs.device)
    v = torch.zeros_like(rhs)
    r = rhs
    p = rhs
    rz = torch.sum(rhs * rhs, dim=-1, keepdim=True)
    i = 0
    while i < max_iterations and bool(torch.any(0.5 * torch.sum(r * r, dim=-1, keepdim=True) > thr)):
        pa = torch.matmul(p, a)
        denom = torch.sum(p * pa, dim=-1, keepdim=True)
        gamma = torch.where(denom <= _MIN_FLOAT, zero, rz / denom)
        v = v + gamma * p
        r = r - gamma * pa
        new_rz = torch.sum(r * r, dim=-1, keepdim=True)
        p = r + torch.where(rz <= _MIN_FLOAT, zero, p * new_rz / rz)
        rz = new_rz
        i += 1
    return v, torch.tensor(i, dtype=torch.int32, device=rhs.device)


def pallas_cg_solve(a: torch.Tensor, rhs: torch.Tensor, threshold: float,
                    max_iterations: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve ``v A = b`` for symmetric PD ``A [M, M]`` and rows ``b [R, M]``.

    Returns ``(solution [R, M] float32, steps)`` with ``steps`` a 0-d int32
    tensor on the operands' device (no host read on the CUDA path)."""
    if not isinstance(rhs, torch.Tensor) or rhs.dim() != 2:
        raise ValueError(f"rhs must be an [R, M] tensor, got {getattr(rhs, 'shape', type(rhs))}")
    rows, m = rhs.shape
    check_operand("a", a, (m, m))
    check_operand("rhs", rhs, (rows, m))
    if int(max_iterations) < 0:
        raise ValueError(f"max_iterations must be >= 0, got {max_iterations}")
    if check_device(a, rhs) == "cpu":
        return pallas_cg_solve_plain(a, rhs, threshold, int(max_iterations))
    device = rhs.device
    if rows == 0 or m == 0:
        return torch.empty_like(rhs), torch.zeros((), dtype=torch.int32, device=device)
    from cggp_tpu_torch import _build

    lib = _build.load()
    grid = ctypes.c_int(0)
    _build.check(lib.cggp_cg_grid(rows, m, device.index or 0, ctypes.byref(grid)),
                 "pallas_cg_solve grid")
    solution = torch.empty_like(rhs)
    r = torch.empty_like(rhs)
    p = torch.empty_like(rhs)
    pa = torch.empty_like(rhs)
    rz = torch.empty(rows, dtype=torch.float32, device=device)
    flags = torch.zeros(2 * grid.value, dtype=torch.int32, device=device)
    steps = torch.zeros(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(
        lib.cggp_pallas_cg_solve(a.data_ptr(), rhs.data_ptr(), solution.data_ptr(), r.data_ptr(),
                                 p.data_ptr(), pa.data_ptr(), rz.data_ptr(), flags.data_ptr(),
                                 steps.data_ptr(), rows, m, float(threshold),
                                 int(max_iterations), grid.value, stream),
        "pallas_cg_solve")
    pallas_cg_solve.launches += 1
    return solution, steps[0]


pallas_cg_solve.launches = 0
