#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (``cggp_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line of its own:

1. ``env``    the card (``nvidia-smi`` name and power limit), torch and CUDA
              versions, the TF32 switches.
2. ``build``  ``nvcc`` builds the kernels from ``cggp_tpu_torch/csrc``.
3. ``setup``  the serving workload: ``synthetic(n=435_000, dim=3, seed=0)``
              and the committed cover-tree selection (M = 989).
4. ``B1``     ``pallas_matvec`` against its plain version at R = 1 and 8192.
5. ``B2``     ``pallas_cg_solve`` against its plain version at R = 1 and 8192.
6. ``serve_pallas_resident`` / ``serve_pallas``  the port's serving path
              (``CGGP.posterior(solver="cg")`` + ``predict_in_batches``,
              4 x 8192 query points) through each kernel, with the launch
              counts set to 0 just before and read just after, and results
              held against the Cholesky posterior and the ``"xla"`` route.

Then one ``kernels`` JSON line, the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Every phase runs under a deadline: device
work is awaited by polling a CUDA event against the clock, and a watchdog
(``faulthandler``, which needs no interpreter lock) ends the process if a
blocking call outlives the phase.  Any failure exits non-zero; without a
CUDA card, or without the rest of the repository, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import faulthandler
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOTAL_BUDGET_S = 1100.0  # the whole run, build included, stays under this
M_EXPECTED = 989
R_BATCH = 8192
NUM_BATCHES = 4
# Absolute CG threshold of the serving solves: JAX's fp32 "xla" route meets
# it at this shape (M = 989, Matern32 at init parameters) in ~185 steps for
# Kmn rows and ~255 for the pseudo-u solve, far below the max_iterations = M
# cap (tests/test_torch_cggp_serving.py::test_serving_threshold_converges_at_m989
# checks this on the CPU with 64 query rows).
CG_THRESHOLD = 1e-8
# Serving outputs of two fp32 routes, or CG against the Cholesky posterior:
# at this threshold the card's runs of this script put them ~2e-5 (mean)
# and ~8e-6 (variance) apart; the tolerance leaves a 25x margin.
SERVE_ATOL = 5e-4
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
FP32_PEAK_FLOPS = 67e12  # fp32 FMA outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

_T0 = time.monotonic()


def emit(record) -> None:
    print(json.dumps(record), flush=True)


class Phase:
    """A deadline-bounded phase: ``wait()`` polls a CUDA event instead of a
    blocking synchronize, and a faulthandler watchdog ends the process if a
    blocking call (a host read inside a solver loop) outlives the deadline."""

    def __init__(self, name: str, budget_s: float):
        self.name = name
        remaining = TOTAL_BUDGET_S - (time.monotonic() - _T0)
        self.budget_s = max(1.0, min(budget_s, remaining))

    def __enter__(self):
        self.t0 = time.monotonic()
        self.deadline = self.t0 + self.budget_s
        print(f"chip_smoke: phase {self.name} (deadline {self.budget_s:.0f} s)",
              file=sys.stderr, flush=True)
        faulthandler.dump_traceback_later(self.budget_s + 5.0, exit=True)
        return self

    def wait(self) -> None:
        event = torch.cuda.Event()
        event.record()
        while not event.query():
            if time.monotonic() > self.deadline:
                emit({"phase": self.name, "error": "deadline passed"})
                os._exit(1)
            time.sleep(0.0002)

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.wait()
        faulthandler.cancel_dump_traceback_later()
        return False


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def event_ms(phase: Phase, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    phase.wait()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    phase.wait()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / FP32_PEAK_FLOPS * 1e3
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from cggp_tpu_torch import _build, resolve_device
    from cggp_tpu_torch.data import synthetic
    from cggp_tpu_torch.models.cggp import CGGP
    from cggp_tpu_torch.ops.cg import ConjugateGradient
    from cggp_tpu_torch.ops.kernels import Matern32
    from cggp_tpu_torch.ops.linalg import add_diagonal
    from cggp_tpu_torch.ops.pallas_cg import pallas_cg_solve, pallas_cg_solve_plain
    from cggp_tpu_torch.ops.pallas_matvec import pallas_matvec, pallas_matvec_plain
    from cggp_tpu_torch.training.optimize import predict_in_batches

    selection_path = ROOT / "benchmarks" / "e2e_selection_covertree.npz"
    require(selection_path.is_file(), f"missing {selection_path}")

    # -- env ---------------------------------------------------------------
    with Phase("env", 60) as ph:
        device = resolve_device("cuda")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
        card_line = smi.splitlines()[torch.cuda.current_device()]
        require(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul is on")
        require(torch.get_float32_matmul_precision() == "highest", "fp32 matmul not highest")
        emit({"phase": "env", "nvidia_smi": card_line, "device": torch.cuda.get_device_name(0),
              "device_count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0],
              "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
              "float32_matmul_precision": torch.get_float32_matmul_precision(),
              "wall_s": ph.elapsed()})

    # -- build -------------------------------------------------------------
    with Phase("build", 400) as ph:
        lib_path = _build.build()
        _build.load()
        ptxas = [line.strip() for line in _build.build_log().splitlines()
                 if "registers" in line or "spill" in line]
        emit({"phase": "build", "library": str(lib_path.relative_to(ROOT)),
              "ptxas": ptxas, "wall_s": ph.elapsed()})

    # -- setup: the serving workload -----------------------------------------
    with Phase("setup", 180) as ph:
        meta = {"n": 435_000, "dim": 3, "seed": 0, "res": 0.35}
        with np.load(selection_path) as sel:
            require(all(float(sel[k]) == v for k, v in meta.items()),
                    f"selection metadata differs from {meta}")
            iv, u, counts = sel["iv"], sel["u"], sel["counts"]
        require(iv.shape == (M_EXPECTED, 3), f"inducing set shape {iv.shape}")
        (x_train, _), (x_test, _) = synthetic(n=meta["n"], dim=meta["dim"], seed=meta["seed"])
        n_train = x_train.shape[0]
        xq = torch.as_tensor(x_test[:NUM_BATCHES * R_BATCH], dtype=torch.float32, device=device)

        def make_model(impl):
            return CGGP(kernel=Matern32(), num_data=n_train,
                        conjugate_gradient=ConjugateGradient(CG_THRESHOLD, matvec_impl=impl))

        params = make_model("xla").init_params(iv, pseudo_u=u, cluster_counts=counts,
                                               dtype=torch.float32, device=device)
        kp, z = params["kernel"], params["inducing_points"]
        lam = make_model("xla").diag_variance(params)[:, 0]
        kmm_lambda = add_diagonal(Matern32().K(kp, z), lam).contiguous()
        kmn_rows = Matern32().K(kp, xq[:R_BATCH], z).contiguous()  # [8192, M] = Kmn^T
        u_row = params["pseudo_u"].T.contiguous()  # [1, M]
        m = kmm_lambda.shape[0]
        emit({"phase": "setup", "n_train": int(n_train), "m": int(m),
              "query_points": int(xq.shape[0]), "wall_s": ph.elapsed()})

    kernels = {}

    # -- B1: pallas_matvec ---------------------------------------------------
    with Phase("B1", 120) as ph:
        gen = torch.Generator(device=device).manual_seed(0)
        g = torch.randn(m, m, generator=gen, device=device)
        a = (g @ g.T) / m + torch.eye(m, device=device)  # symmetric positive definite
        cases = []
        for rows in (1, R_BATCH):
            p = torch.randn(rows, m, generator=gen, device=device)
            got = pallas_matvec(p, a)
            want = pallas_matvec_plain(p, a)
            ph.wait()
            err = float((got - want).abs().max())
            err_fp64 = float((got.double() - p.double() @ a.double()).abs().max())
            # Both are fp32 sums of M products in other orders: the gap is a
            # few ulps of sum |p||a| (worst case M * eps = 6e-5 of it).
            scale = float((p.abs() @ a.abs()).max())
            require(math.isfinite(err) and err <= 1e-5 * scale,
                    f"B1 R={rows}: max abs err {err} > 1e-5 * {scale}")
            kernel_ms = event_ms(ph, lambda: pallas_matvec(p, a), reps=20)
            plain_ms = event_ms(ph, lambda: pallas_matvec_plain(p, a), reps=20)
            library_ms = event_ms(ph, lambda: torch.matmul(p, a), reps=20)
            bound, bound_by = bound_ms(4.0 * (2 * rows * m + m * m), 2.0 * rows * m * m)
            case = {"rows": rows, "m": m, "max_abs_err": err, "max_rel_err": err / scale,
                    "max_abs_err_vs_fp64": err_fp64,
                    "tolerance": f"max_abs_err <= 1e-5 * max(|p| @ |A|) = {1e-5 * scale:.3g}",
                    "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound, "bound_by": bound_by,
                    "peak": "fp32 FMA 67 TFLOP/s, HBM 3.35 TB/s (H100 SXM data sheet)"}
            cases.append(case)
        emit({"phase": "B1", "cases": cases, "wall_s": ph.elapsed()})
        big = cases[-1]
        kernels["pallas_matvec"] = {
            "max_abs_err": max(c["max_abs_err"] for c in cases), "ms": big["kernel_ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": big["library_ms"]}

    # -- B2: pallas_cg_solve ---------------------------------------------------
    with Phase("B2", 240) as ph:
        max_it = m
        a64 = kmm_lambda.double()
        cases = []
        for name, rhs in (("pseudo_u", u_row), ("kmn_batch", kmn_rows)):
            rows = rhs.shape[0]
            got, steps = pallas_cg_solve(kmm_lambda, rhs, CG_THRESHOLD, max_it)
            want, steps_plain = pallas_cg_solve_plain(kmm_lambda, rhs, CG_THRESHOLD, max_it)
            ph.wait()
            steps, steps_plain = int(steps), int(steps_plain)
            exact = torch.linalg.solve(a64, rhs.double().T).T
            scale = float(exact.abs().max())
            err = float((got - want).abs().max())
            err_exact = float((got.double() - exact).abs().max())
            err_exact_plain = float((want.double() - exact).abs().max())
            # fp32 CG runs whose sums differ in order drift apart before they
            # converge; at this threshold JAX's fp32 CG on the CPU sat within
            # 2e-4 (relative to max |v|) of the exact solve, so both are held
            # to 10x that, and the step counts to a few percent.
            tol = 2e-3 * scale
            require(steps < max_it, f"B2 {name}: no convergence in {max_it} steps")
            require(abs(steps - steps_plain) <= max(3, 0.05 * steps_plain),
                    f"B2 {name}: steps {steps} vs plain {steps_plain}")
            require(err <= tol and err_exact <= tol,
                    f"B2 {name}: err {err}, vs exact {err_exact}, tolerance {tol}")
            kernel_ms = event_ms(ph, lambda: pallas_cg_solve(kmm_lambda, rhs, CG_THRESHOLD,
                                                             max_it), reps=3)
            plain_ms = event_ms(ph, lambda: pallas_cg_solve_plain(kmm_lambda, rhs, CG_THRESHOLD,
                                                                  max_it), reps=2)
            # Bytes: A and b read once, v written once.  Operations: per step
            # the [R, M] x [M, M] product plus ~11 R M for dots and updates.
            bound, bound_by = bound_ms(4.0 * (m * m + 2 * rows * m),
                                       steps * (2.0 * rows * m * m + 11.0 * rows * m))
            cases.append({"rhs": name, "rows": rows, "m": m, "steps": steps,
                          "steps_plain": steps_plain, "max_abs_err": err,
                          "max_abs_err_vs_fp64_solve": err_exact,
                          "plain_max_abs_err_vs_fp64_solve": err_exact_plain,
                          "tolerance": f"max_abs_err <= 2e-3 * max|v| = {tol:.3g}",
                          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": bound_by,
                          "per_step_bound_ms": bound / steps if bound_by == "operations" else None,
                          "peak": "fp32 FMA 67 TFLOP/s, HBM 3.35 TB/s (H100 SXM data sheet)"})
        emit({"phase": "B2", "cases": cases, "library_ms": None,
              "library_note": "no single PyTorch call computes a CG solve",
              "wall_s": ph.elapsed()})
        big = cases[-1]
        kernels["pallas_cg_solve"] = {
            "max_abs_err": max(c["max_abs_err"] for c in cases), "ms": big["kernel_ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": None}

    # -- serving, through each kernel ------------------------------------------
    with Phase("reference", 240) as ph:
        chol_mean, chol_var = predict_in_batches(make_model("xla"), params, xq,
                                                 batch_size=R_BATCH, posterior_solver="chol")
        xla_mean, xla_var = predict_in_batches(make_model("xla"), params, xq,
                                               batch_size=R_BATCH, posterior_solver="cg")
        ph.wait()
        for name, t in (("chol_mean", chol_mean), ("chol_var", chol_var),
                        ("xla_mean", xla_mean), ("xla_var", xla_var)):
            require(bool(torch.isfinite(t).all()), f"{name} is not finite")
        emit({"phase": "reference", "xla_vs_chol_mean": float((xla_mean - chol_mean).abs().max()),
              "xla_vs_chol_var": float((xla_var - chol_var).abs().max()),
              "wall_s": ph.elapsed()})

    counters = {"pallas_resident": pallas_cg_solve, "pallas": pallas_matvec}
    served = {}
    for impl, counted in counters.items():
        with Phase(f"serve_{impl}", 300) as ph:
            model = make_model(impl)
            predict_in_batches(model, params, xq[:R_BATCH], batch_size=R_BATCH,
                               posterior_solver="cg")  # warm-up, not counted
            ph.wait()
            pallas_cg_solve.launches = 0
            pallas_matvec.launches = 0
            t0 = time.monotonic()
            post = model.posterior(params, solver="cg")
            ph.wait()
            t1 = time.monotonic()
            mean, var = predict_in_batches(model, params, xq, batch_size=R_BATCH,
                                           posterior_solver="cg", posterior=post)
            ph.wait()
            t2 = time.monotonic()
            launches = {"pallas_cg_solve": pallas_cg_solve.launches,
                        "pallas_matvec": pallas_matvec.launches}
            solves = 1 + NUM_BATCHES
            if impl == "pallas_resident":
                require(launches == {"pallas_cg_solve": solves, "pallas_matvec": 0},
                        f"resident route launches {launches}, want {solves} B2 solves")
            else:
                require(launches["pallas_matvec"] > 0 and launches["pallas_cg_solve"] == 0,
                        f"pallas route launches {launches}")
            kernels[counted.__name__]["launches"] = launches[counted.__name__]
            # Steps of each solve, re-run outside the counted window.
            steps, converged = [], []
            _, nu_stats = model.conjugate_gradient.solve_with_stats(post.kmm_lambda,
                                                                    params["pseudo_u"])
            for b in range(NUM_BATCHES):
                kmn = model.kernel.K(kp, z, xq[b * R_BATCH:(b + 1) * R_BATCH])
                _, st = model.conjugate_gradient.solve_with_stats(post.kmm_lambda, kmn)
                steps.append(int(st.steps))
                converged.append(bool(st.converged))
            require(all(converged) and bool(nu_stats.converged), "a serving solve did not converge")
            require(mean.shape == (xq.shape[0], 1) and var.shape == (xq.shape[0], 1),
                    f"output shapes {tuple(mean.shape)} {tuple(var.shape)}")
            require(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
                    "non-finite serving output")
            require(bool((var >= 0).all()), "negative predictive variance")
            gaps = {"mean_vs_chol": float((mean - chol_mean).abs().max()),
                    "var_vs_chol": float((var - chol_var).abs().max()),
                    "mean_vs_xla": float((mean - xla_mean).abs().max()),
                    "var_vs_xla": float((var - xla_var).abs().max())}
            require(all(v <= SERVE_ATOL for v in gaps.values()),
                    f"serving outputs differ beyond {SERVE_ATOL}: {gaps}")
            served[impl] = (mean, var)
            emit({"phase": f"serve_{impl}", "launches": launches, "solves": solves,
                  "points": int(xq.shape[0]), "batch_size": R_BATCH,
                  "posterior_build_s": t1 - t0, "serve_s": t2 - t1,
                  "points_per_s": xq.shape[0] / (t2 - t1),
                  "cg_steps_nu": int(nu_stats.steps), "cg_steps_per_batch": steps,
                  "tolerance": f"max abs gap <= {SERVE_ATOL}", **gaps,
                  "var_min": float(var.min()), "wall_s": ph.elapsed()})
    route_gap = max(float((served["pallas"][i] - served["pallas_resident"][i]).abs().max())
                    for i in (0, 1))
    require(route_gap <= SERVE_ATOL, f"the two kernel routes differ by {route_gap}")

    sources = {"pallas_matvec": ("cggp_tpu_torch/csrc/pallas_matvec.cu",
                                 "cggp_tpu/ops/pallas_matvec.py:65"),
               "pallas_cg_solve": ("cggp_tpu_torch/csrc/pallas_cg.cu",
                                   "cggp_tpu/ops/pallas_cg.py:107")}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
         "launches": kernels[name]["launches"], "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"],
         "bound_ms": kernels[name]["bound_ms"], "bound_by": kernels[name]["bound_by"],
         "library_ms": kernels[name]["library_ms"]}
        for name in ("pallas_matvec", "pallas_cg_solve")]})
    print(card_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
