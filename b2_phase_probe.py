#!/usr/bin/env python3
"""Where a step of kernel B2's tiled path goes, on one CUDA card.

Run from the repository root with no arguments::

    python3 b2_phase_probe.py

No profiler sees inside a cooperative kernel, so this builds a copy of
``cggp_tpu_torch/csrc`` (under the git-ignored ``cggp_tpu_torch/_build/``)
whose ``cg_tiled_kernel`` stamps ``%globaltimer`` at its phase boundaries in
the first and the last block, solves the dense serving system of
``chip_smoke.py`` (the committed M = 989 selection, Matern32 at init
parameters, absolute threshold 1e-8) for the first 8192 query points, and
prints one JSON line: the mean microseconds per step of the product
(phase A), the wait at the grid.sync() after it, the row pass (phase B) and
the whole step, per block, over steps 2-59.  The sources are patched at
fixed lines and the script fails if one is not found.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
STEPS = 64  # steps stamped

STAMPS = f"""
__device__ unsigned long long g_stamps[2][{STEPS}][4];
__device__ __forceinline__ unsigned long long probe_time() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}}
#define STAMP(k)                                                              \\
  do {{                                                                       \\
    if (threadIdx.x == 0 && it < {STEPS} &&                                   \\
        (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1))                     \\
      g_stamps[blockIdx.x == 0 ? 0 : 1][it][k] = probe_time();               \\
  }} while (0)
"""
PATCHES = [
    ("// ---- Tiled path ----", STAMPS + "// ---- Tiled path ----"),
    ("    // (A) pA = p @ A, one 128 x 128 tile per unit.\n",
     "    STAMP(0);\n    // (A) pA = p @ A, one 128 x 128 tile per unit.\n"),
    ("    grid.sync();\n\n    // (B) per row", "    STAMP(1);\n    grid.sync();\n    STAMP(2);\n\n"
     "    // (B) per row"),
    ("    ++it;\n    any = any_over(grid, flags, it & 1, over);",
     "    STAMP(3);\n    ++it;\n    any = any_over(grid, flags, it & 1, over);"),
]
READ_STAMPS = """
extern "C" int probe_stamps(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
"""


def patched_sources(work: Path) -> Path:
    csrc = work / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(ROOT / "cggp_tpu_torch" / "csrc", csrc)
    source = csrc / "pallas_cg.cu"
    text = source.read_text()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise SystemExit(f"b2_phase_probe: the line {old.strip()!r} of pallas_cg.cu changed")
        text = text.replace(old, new)
    source.write_text(text + READ_STAMPS)
    return csrc


def main() -> int:
    if not torch.cuda.is_available():
        print("b2_phase_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from cggp_tpu_torch import _build
    from cggp_tpu_torch.data import synthetic
    from cggp_tpu_torch.models.cggp import CGGP
    from cggp_tpu_torch.ops.cg import ConjugateGradient
    from cggp_tpu_torch.ops.kernels import Matern32
    from cggp_tpu_torch.ops.linalg import add_diagonal
    from cggp_tpu_torch.ops.pallas_cg import pallas_cg_plan, pallas_cg_solve

    work = ROOT / "cggp_tpu_torch" / "_build" / "phase_probe"
    _build.CSRC_DIR = patched_sources(work)
    _build.BUILD_DIR = work / "build"
    lib = _build.load()
    lib.probe_stamps.argtypes = [ctypes.c_void_p]
    lib.probe_stamps.restype = ctypes.c_int

    device = torch.device("cuda")
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
    b = Matern32().K(kp, xq, z).contiguous()
    m = a.shape[0]
    plan = pallas_cg_plan(b.shape[0], m, device)
    if plan["path"] != "tiled":
        raise SystemExit(f"b2_phase_probe: expected the tiled path, got {plan}")
    for _ in range(2):  # the second solve's stamps are read
        _, steps = pallas_cg_solve(a, b, 1e-8, m)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (2 * STEPS * 4))()
    _build.check(lib.probe_stamps(ctypes.addressof(buf)), "probe_stamps")
    stamps = np.array(buf, dtype=np.float64).reshape(2, STEPS, 4) / 1e3  # us
    window = slice(2, STEPS - 4)
    blocks = {}
    for index, name in ((0, "first"), (1, "last")):
        s = stamps[index]
        step = s[3:STEPS - 1, 0] - s[2:STEPS - 2, 0]
        blocks[name] = {"product_us": float(np.mean(s[window, 1] - s[window, 0])),
                        "wait_after_product_us": float(np.mean(s[window, 2] - s[window, 1])),
                        "row_pass_us": float(np.mean(s[window, 3] - s[window, 2])),
                        "step_us": float(np.mean(step[:STEPS - 6]))}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30).stdout.strip()
    print(json.dumps({"b2_phase_probe": {"rows": b.shape[0], "m": m, "steps": int(steps),
                                         "plan": plan, "steps_averaged": "2-59",
                                         "blocks": blocks},
                      "nvidia_smi": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
