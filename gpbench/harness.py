"""The benchmark's harness: finds a cell's configuration, traffic mix, limits
and per-layer metrics by the names in ``BENCHMARK.json``, runs the traffic
mix's kind (``gpbench/kinds/<kind>.py``) against the system the
configuration names (``gpbench/systems/<system>.py``), and prints the
result line.

Nothing here or in what it loads imports ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``cggp_tpu``; the check after the window reads
``sys.modules`` for them, by whole top-level names.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from bisect import bisect_right
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cggp_tpu")
GIB = float(1 << 30)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_loaded() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def nvidia_smi() -> str:
    """The card's name, power limit, clocks, power draw and temperature."""
    query = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        done = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
        return done.stdout.strip() or done.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def log(message: str) -> None:
    print(f"gpbench: {message}", file=sys.stderr, flush=True)


def identity(fn):
    return fn


@dataclass
class Run:
    """What a kind's ``run`` gets: the cell's files, the run's arguments,
    the device and the hooks that tests use to plant faults."""

    workload: str
    cfg: Dict
    traffic: Dict
    limits: Dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    sizes: Dict = field(default_factory=dict)  # overrides of input sizes (tests)
    hooks: Dict[str, Callable] = field(default_factory=dict)
    notes: Dict = field(default_factory=dict)

    def hook(self, name: str) -> Callable:
        return self.hooks.get(name, identity)

    def system(self, inputs):
        module = importlib.import_module(f"gpbench.systems.{self.cfg['system']}")
        return module.System(self.cfg, inputs, self.device)

    def note(self, **values) -> None:
        self.notes.update(values)
        log(" ".join(f"{k}={v}" for k, v in values.items()))

    def synchronize(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclass
class TraceReading:
    """What the profiler saw over a stretch: device busy and window seconds,
    device time by kernel name, and the breakdown for the result line."""

    busy_s: float
    window_s: float
    kernel_s: Dict[str, float]
    breakdown: Dict

    def kernel_time(self, *fragments: str) -> float:
        """Seconds of the kernels whose names hold any of ``fragments``."""
        return sum(s for name, s in self.kernel_s.items()
                   if any(f in name for f in fragments))


@dataclass
class MetricContext:
    """What a per-layer metric's reader reads (``gpbench/metrics/``)."""

    trace: Optional[TraceReading]
    spans: Dict[str, List[float]]
    solves: List  # (rows, m, steps) of each CG solve in the traced stretch
    counts: Dict[str, float]
    shapes: Dict
    values: Dict[str, float]


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _innermost_host(host, starts, t: float) -> str:
    """Name of the latest-starting host event that covers ``t``."""
    i = bisect_right(starts, t) - 1
    for j in range(i, max(i - 20000, -1), -1):
        ts, end, name = host[j]
        if end >= t:
            return name
    return "no host event"


def reduce_trace(events: List[Dict], stretch_name: str) -> TraceReading:
    """Busy and window seconds, kernel seconds by name and the breakdown
    from a Chrome trace's events (microsecond ``ts`` and ``dur``)."""
    stretch = [e for e in events if e.get("name") == stretch_name
               and e.get("cat") == "user_annotation"]
    if not stretch:
        raise RuntimeError("the trace holds no stretch annotation")
    w0 = float(stretch[0]["ts"])
    w1 = w0 + float(stretch[0]["dur"])
    device, kernel_s = [], {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            start = max(float(e["ts"]), w0)
            end = min(float(e["ts"]) + float(e["dur"]), w1)
            if end > start:
                device.append((start, end))
                kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + (end - start) * 1e-6
    merged = _merge(device)
    busy = sum(end - start for start, end in merged)
    gaps, previous = [], w0
    for start, end in merged + [[w1, w1]]:
        if start > previous:
            gaps.append((start - previous, previous, start))
        previous = max(previous, end)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                  for e in events
                  if e.get("cat") in ("cpu_op", "user_annotation", "python_function")
                  and e.get("name") != stretch_name and "dur" in e)
    starts = [h[0] for h in host]
    idle = {}
    for length, start, end in sorted(gaps, reverse=True)[:400]:
        label = _innermost_host(host, starts, 0.5 * (start + end))
        idle[label] = idle.get(label, 0.0) + length * 1e-6
    top_ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return TraceReading(busy_s=busy * 1e-6, window_s=(w1 - w0) * 1e-6, kernel_s=kernel_s,
                        breakdown={"device_ops": [[n, s] for n, s in top_ops],
                                   "idle_gaps": [[n, s] for n, s in top_idle]})


STRETCH = "gpbench.stretch"


def profile_stretch(run: Run, fn: Callable):
    """``fn()`` under ``torch.profiler`` (host and device activity) between
    two synchronizations; returns ``(fn's result, TraceReading)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    run.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            out = fn()
            run.synchronize()
    handle, path = tempfile.mkstemp(suffix=".json")
    os.close(handle)
    try:
        prof.export_chrome_trace(path)
        events = load_json(Path(path))["traceEvents"]
    finally:
        os.remove(path)
    del prof
    torch.cuda.empty_cache() if run.device.type == "cuda" else None
    return out, reduce_trace(events, STRETCH)


def read_per_layer(bench: Dict, workload: str, ctx: MetricContext) -> Dict:
    """Every per-layer metric that lists this cell and whose reader finds
    something."""
    out = {}
    for metric in bench["per_layer"]:
        if workload not in metric["workloads"]:
            continue
        module = load_module(BENCH_DIR / "metrics" / f"{metric['name']}.py",
                             f"gpbench_metric_{metric['name']}")
        value = module.read(ctx)
        if value is not None and math.isfinite(value):
            out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out


def e2e_names(bench: Dict, workload: str) -> List[str]:
    return [m["name"] for m in bench["end_to_end"]
            if m.get("workloads") is None or workload in m["workloads"]]


def cell_files(bench: Dict, workload: str, root: Path = ROOT):
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"gpbench: no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(root / config["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{workload}.json")
    return cell, cfg, traffic, limits


def format_checks(checks: Dict) -> List[str]:
    return [f"{name} {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]


def execute(run: Run):
    """Run the cell's kind; returns the kind's outcome dict."""
    kind = importlib.import_module(f"gpbench.kinds.{run.traffic['kind']}")
    return kind.run(run)


def main(argv, t0: float) -> int:
    parser = argparse.ArgumentParser(description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic, limits = cell_files(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"needs {cell['chips']} CUDA device(s); torch.cuda.is_available() = "
            f"{torch.cuda.is_available()}, device_count = "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}; no result")
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(device)
    log(f"card {nvidia_smi()}")
    from cggp_tpu_torch import _build

    _build.load()  # built once per checkout, under cggp_tpu_torch/_build/
    run = Run(workload=args.workload, cfg=cfg, traffic=traffic, limits=limits, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), device=device, t0=t0)
    outcome = execute(run)

    found = forbidden_loaded()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {', '.join(found)}; no result")
        return 3
    names = e2e_names(bench, args.workload)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    if args.trace:
        metrics = read_per_layer(bench, args.workload, outcome["context"])
    else:
        metrics = {n: {"value": float(outcome["e2e"][n]), "unit": units[n]} for n in names}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                   "memory_peak_bytes": int(outcome["memory_peak_bytes"])}
    result = {"correct": bool(outcome["correct"]), "attempted": int(outcome["attempted"]),
              "failed": int(outcome["failed"]), "metrics": metrics, "device": device_info}
    trace = outcome.get("trace")
    if args.trace and trace is not None:
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown
    log(f"card after the run {nvidia_smi()}")
    for line in format_checks(outcome["checks"]):
        print(line, file=sys.stderr, flush=True)
    result["checks"] = outcome["checks"]
    print(json.dumps(result), flush=True)
    return 0
