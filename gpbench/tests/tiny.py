"""Cells of ``BENCHMARK.json`` cut to a size the CPU tests can hold: a few
thousand rows, a coarse selection, small batches and short windows, the
kernels' plain routes (CPU tensors never reach a CUDA kernel)."""

from __future__ import annotations

import time

import torch

from gpbench import harness

TINY = {
    "dense-train": ({"batch": 64, "k": 2, "batch_pool": 8}, {"data_n": 3000, "resolution": 0.6}),
    "implicit-train": ({"batch": 64, "k": 2, "batch_pool": 8}, {"data_n": 3000, "resolution": 0.45}),
    "dense-serve": ({"sizes": {"low": 50, "high": 300, "count": 8}, "batch_size": 128},
                    {"data_n": 3000, "resolution": 0.6}),
}


def tiny_run(workload: str, seed: int, hooks=None, trace: bool = False,
             seconds: float = 0.5) -> harness.Run:
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _cell, cfg, traffic, limits = harness.cell_files(bench, workload)
    mix, sizes = TINY[workload]
    traffic.update(mix)
    model = cfg["model"]
    if "block" in model:
        model.update(block=16, use_pallas=False)
    return harness.Run(workload=workload, cfg=cfg, traffic=traffic, limits=limits, seed=seed,
                       seconds=seconds, trace=trace, device=torch.device("cpu"),
                       t0=time.monotonic(), sizes=sizes, hooks=hooks or {})
