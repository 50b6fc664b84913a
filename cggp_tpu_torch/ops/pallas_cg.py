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

Arithmetic.  The kernel has two paths (:func:`pallas_cg_plan`).  On the
tiled path (above 8 rows, or where the small-R path does not fit) it
computes the product ``p @ A`` in 3xTF32 on the tensor cores, through the
main loop of kernel B1 (``csrc/tiled_matvec.cuh``, the depth summed at two
levels), with A split into its TF32 halves once per solve; the dots and
updates are IEEE fp32.  On the
small-R path (up to 8 rows) everything, the product included, is IEEE fp32
FMA.  The plain version computes in IEEE fp32 (TF32 stays off);
:func:`pallas_cg_solve_3xtf32_emulated` is the same loop with the product
taken as the tiled path takes it (``matmul_3xtf32_emulated``), for the tests
and the card's smoke run.  The main path never calls either.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Tuple

import torch

from cggp_tpu_torch.ops.pallas_matvec import (OUTER_STAGES, check_device, check_operand,
                                               matmul_3xtf32_emulated)

_MIN_FLOAT = 1e-16
# The kernel's launch paths, as cggp_cg_plan numbers them.
PATHS = ("tiled", "small_resident", "small_streamed")


def _cg_loop(matvec: Callable[[torch.Tensor], torch.Tensor], rhs: torch.Tensor,
             threshold: float, max_iterations: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's loop in torch ops with the product ``matvec(p)``."""
    zero = torch.zeros((), dtype=rhs.dtype, device=rhs.device)
    thr = torch.tensor(threshold, dtype=rhs.dtype, device=rhs.device)
    v = torch.zeros_like(rhs)
    r = rhs
    p = rhs
    rz = torch.sum(rhs * rhs, dim=-1, keepdim=True)
    i = 0
    while i < max_iterations and bool(torch.any(0.5 * torch.sum(r * r, dim=-1, keepdim=True) > thr)):
        pa = matvec(p)
        denom = torch.sum(p * pa, dim=-1, keepdim=True)
        gamma = torch.where(denom <= _MIN_FLOAT, zero, rz / denom)
        v = v + gamma * p
        r = r - gamma * pa
        new_rz = torch.sum(r * r, dim=-1, keepdim=True)
        p = r + torch.where(rz <= _MIN_FLOAT, zero, p * new_rz / rz)
        rz = new_rz
        i += 1
    return v, torch.tensor(i, dtype=torch.int32, device=rhs.device)


def pallas_cg_solve_plain(a: torch.Tensor, rhs: torch.Tensor, threshold: float,
                          max_iterations: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's loop in torch ops: ``(solution [R, M], steps int32)``."""
    return _cg_loop(lambda p: torch.matmul(p, a), rhs, threshold, max_iterations)


def pallas_cg_solve_3xtf32_emulated(a: torch.Tensor, rhs: torch.Tensor, threshold: float,
                                    max_iterations: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same loop with the product in the tiled path's 3xTF32 arithmetic
    (``matmul_3xtf32_emulated``, outer sums every ``OUTER_STAGES`` stages),
    everything else IEEE fp32."""
    return _cg_loop(lambda p: matmul_3xtf32_emulated(p, a, outer_every=OUTER_STAGES), rhs,
                    threshold, max_iterations)


def pallas_cg_plan(rows: int, m: int, device: torch.device) -> Dict[str, int | str]:
    """The kernel's launch for ``rows`` right-hand sides of length ``m``:
    ``path`` (``"tiled"``, ``"small_resident"`` with A's column slices in
    shared memory, ``"small_streamed"`` reading them from L2), the
    cooperative ``grid``, the columns per block ``cols`` of the small-R path
    and the dynamic shared memory ``smem_bytes``."""
    return dict(_plan(rows, m, device.index or 0))


@functools.lru_cache(maxsize=64)
def _plan(rows: int, m: int, device_index: int):
    from cggp_tpu_torch import _build

    lib = _build.load()
    path, grid, cols = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    smem = ctypes.c_longlong(0)
    _build.check(lib.cggp_cg_plan(rows, m, device_index, ctypes.byref(path),
                                  ctypes.byref(grid), ctypes.byref(cols), ctypes.byref(smem)),
                 "pallas_cg_solve plan")
    return tuple({"path": PATHS[path.value], "grid": grid.value, "cols": cols.value,
                  "smem_bytes": smem.value}.items())


def pallas_cg_sync_floor(plan: Dict[str, int | str], count: int, device: torch.device) -> None:
    """Launch a kernel on ``plan``'s grid and shared memory that does nothing
    but ``count`` grid-wide synchronisations (the floor under a small-R
    step); the caller times it.  Not a solve: it is not counted."""
    from cggp_tpu_torch import _build

    lib = _build.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(lib.cggp_cg_sync_floor(plan["grid"], plan["smem_bytes"], int(count), stream),
                 "pallas_cg_solve sync floor")


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
    plan = pallas_cg_plan(rows, m, device)
    path = PATHS.index(plan["path"])
    # The solve's state (r, p, pA, r.r and stop flags on the tiled path; r
    # and the blocks' partial dots on the small-R path) and, on the tiled
    # path, A split into its TF32 halves (8 MB at M = 989).
    work = torch.empty(lib.cggp_cg_work_words(rows, m, path, plan["grid"]),
                       dtype=torch.float32, device=device)
    split_words = lib.cggp_cg_split_words(m, path)
    split = torch.empty(split_words, dtype=torch.int32, device=device) if split_words else None
    solution = torch.empty_like(rhs)
    steps = torch.zeros(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(
        lib.cggp_pallas_cg_solve(a.data_ptr(), rhs.data_ptr(), solution.data_ptr(),
                                 work.data_ptr(), None if split is None else split.data_ptr(),
                                 steps.data_ptr(), rows, m, float(threshold),
                                 int(max_iterations), path, plan["grid"],
                                 plan["cols"], plan["smem_bytes"], stream),
        "pallas_cg_solve")
    pallas_cg_solve.launches += 1
    return solution, steps[0]


pallas_cg_solve.launches = 0
