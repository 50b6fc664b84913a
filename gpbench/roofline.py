"""Frozen operation and byte counts, and the published peaks they are held
against (NVIDIA H100 SXM data sheet, dense rates, 700 W).

Every count here is of the work the inputs need, computed from shapes and
the CG steps a solve took, whatever kernel implements it: a redesign that
moves fewer bytes or does less redundant work raises its share; none can
push a share past 100 %.
"""

from __future__ import annotations

FP32_PEAK_FLOPS = 67e12  # fp32 FMA outside the tensor cores
TF32_PEAK_FLOPS = 495e12  # dense TF32 on the tensor cores
# An fp32-accurate product on the tensor cores is three TF32 passes (3xTF32).
FP32_ACCURATE_PEAK_FLOPS = TF32_PEAK_FLOPS / 3.0
HBM_BYTES_PER_S = 3.35e12
SM_COUNT = 132
SFU_OPS_PER_CLOCK = 16 * SM_COUNT  # special-function results (exp, sqrt) per clock
MAX_SM_CLOCK_HZ = 1.98e9  # the boost clock the published peaks assume
WORD = 4  # float32 bytes


def bound_parts(nbytes: float, fma_flops: float, tc_flops: float = 0.0,
                transcendentals: float = 0.0, sm_clock_hz: float = MAX_SM_CLOCK_HZ):
    """The least time (ms) of an fp32-accurate result: the smaller of the
    fp32 FMA time of all ``fma_flops`` and the 3xTF32 time (three TF32
    passes over the product's ``tc_flops`` on the tensor cores, the rest in
    fp32 FMA), then the larger of that, the special-function time and the
    byte time.  Returns ``(bound_ms, "bytes" | "operations", the part that
    sets it, every part)``."""
    parts = {"fp32 FMA": fma_flops / FP32_PEAK_FLOPS * 1e3,
             "3xTF32 tensor cores": (3.0 * tc_flops / TF32_PEAK_FLOPS
                                     + (fma_flops - tc_flops) / FP32_PEAK_FLOPS) * 1e3,
             "special functions": (transcendentals / (SFU_OPS_PER_CLOCK * sm_clock_hz) * 1e3
                                   if transcendentals else 0.0),
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    arithmetic = min(parts["fp32 FMA"], parts["3xTF32 tensor cores"])
    limits = {"fp32 FMA" if arithmetic == parts["fp32 FMA"] else "3xTF32 tensor cores": arithmetic,
              "special functions": parts["special functions"], "bytes": parts["bytes"]}
    what = max(limits, key=limits.get)
    return limits[what], ("bytes" if what == "bytes" else "operations"), what, parts


def gram_bound(n: int, m: int, d: int, r: int, kernel_name: str = "matern32",
               sm_clock_hz: float = MAX_SM_CLOCK_HZ):
    """``bound_parts`` of one ``[R, M] @ K(Z, X)`` product with the Gram
    block built on the fly, ``X`` [N, D], ``Z`` [M, D]: the contraction's
    2 N M R flops (on the tensor cores), the distances' 2 N M D, an exp
    (and for a Matern kernel a sqrt) per kernel value; bytes: both point
    sets, the [R, N] operand and the [R, M] result, each once."""
    transcendentals = n * m * (1 if kernel_name == "se" else 2)
    nbytes = WORD * ((n + m) * (d + 1) + 2 * r * max(n, m))
    return bound_parts(nbytes, 2.0 * n * m * (r + d), 2.0 * n * m * r, transcendentals,
                       sm_clock_hz)


def cg_solve_bound(rows: int, m: int, steps: int):
    """``bound_parts`` of one whole CG solve of an [M, M] system for
    ``rows`` right-hand sides in ``steps`` steps, counted at the
    algorithm's level: the matrix, the right-hand sides and the solution
    each moved once; per step the [R, M] x [M, M] product (on the tensor
    cores) and ~11 R M operations of dots and vector updates."""
    nbytes = WORD * (m * m + 2 * rows * m)
    return bound_parts(nbytes, steps * (2.0 * rows * m * m + 11.0 * rows * m),
                       steps * 2.0 * rows * m * m)


def matrix_free_solve_bound(rows: int, m: int, d: int, steps: int,
                            kernel_name: str = "matern32"):
    """Bound (ms) of the Gram products of one matrix-free CG solve: one
    :func:`gram_bound` product with ``X = Z`` a step."""
    return steps * gram_bound(m, m, d, rows, kernel_name)[0]


def solve_flops(rows: int, m: int, steps: int) -> float:
    """Model FLOPs of a CG solve: the [R, M] x [M, M] product of each step."""
    return 2.0 * rows * m * m * steps


def gram_build_flops(m: int, n: int, d: int) -> float:
    """Model FLOPs of the distance products of a Gram block [M, N]."""
    return 2.0 * d * m * n
