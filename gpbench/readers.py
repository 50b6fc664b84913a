"""Shared arithmetic of the per-layer metric readers (``gpbench/metrics/``).

A reader returns ``None`` where its run has nothing to read: no trace, no
kernel of its name in the trace, no solve recorded.  It never returns 0
for a share of a roofline or of a peak.
"""

from __future__ import annotations

from typing import Optional

from gpbench import roofline

# Device kernels by the program's source file: B2 (csrc/pallas_cg.cu, with
# the TF32 split of A it launches, csrc/tiled_matvec.cuh) and B3
# (csrc/pallas_gram.cu).  Neither dense cell's path launches B1, the other
# user of the split kernel.
B2_KERNELS = ("cg_tiled_kernel", "cg_small_kernel", "split_b_kernel")
B3_KERNELS = ("gram_tiled_kernel", "gram_small_kernel")


def share(bound_s: float, time_s: float) -> Optional[float]:
    if bound_s <= 0.0 or time_s <= 0.0:
        return None
    return 100.0 * bound_s / time_s


def b2_roofline(ctx) -> Optional[float]:
    """B2's bound over the recorded solves, as a share of its device time."""
    if ctx.trace is None or not ctx.solves:
        return None
    bound_ms = sum(roofline.cg_solve_bound(r, m, s)[0] for r, m, s in ctx.solves)
    return share(bound_ms * 1e-3, ctx.trace.kernel_time(*B2_KERNELS))


def b3_roofline(ctx) -> Optional[float]:
    """B3's bound over the recorded matrix-free solves (one Gram product a
    CG step), as a share of its device time."""
    if ctx.trace is None or not ctx.solves:
        return None
    d = ctx.shapes["d"]
    bound_ms = sum(roofline.matrix_free_solve_bound(r, m, d, s) for r, m, s in ctx.solves)
    return share(bound_ms * 1e-3, ctx.trace.kernel_time(*B3_KERNELS))


def model_flops(ctx, rows_built: float) -> float:
    """The CG products of every recorded solve plus the distance products
    of the Gram blocks built (``rows_built`` columns against Z, plus Kmm
    once a step or request)."""
    m, d = ctx.shapes["m"], ctx.shapes["d"]
    solves = sum(roofline.solve_flops(r, mm, s) for r, mm, s in ctx.solves)
    return solves + roofline.gram_build_flops(m, rows_built, d)


def mfu(ctx, units: str) -> Optional[float]:
    """Model FLOPs over the traced stretch's time and the fp32-accurate
    tensor-core peak; ``units`` is ``"steps"`` or ``"requests"``."""
    if ctx.trace is None or not ctx.solves or ctx.trace.window_s <= 0.0:
        return None
    m = ctx.shapes["m"]
    if units == "steps":
        rows = ctx.counts["steps"] * (m + ctx.shapes["batch"])
    else:
        rows = ctx.counts["requests"] * m + ctx.counts["points"]
    flops = model_flops(ctx, rows)
    return share(flops / roofline.FP32_ACCURATE_PEAK_FLOPS, ctx.trace.window_s)


def idle_pct(ctx) -> Optional[float]:
    if ctx.trace is None or ctx.trace.window_s <= 0.0 or ctx.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def cg_steps_per(ctx, count: str) -> Optional[float]:
    """CG steps of the recorded solves per step (``count="steps"``) or per
    solve (``count="solves"``)."""
    if not ctx.solves:
        return None
    total = sum(s for _, _, s in ctx.solves)
    return total / (ctx.counts["steps"] if count == "steps" else len(ctx.solves))


def enqueue_ms(ctx, per: str) -> Optional[float]:
    spans = ctx.spans.get("enqueue")
    if not spans:
        return None
    return 1e3 * sum(spans) / ctx.counts[per]
