"""Traffic kind ``closed_loop_serve``: one caller serving prediction
requests back to back from a posterior cache built in set-up.

Each request is ``predict_in_batches`` over a contiguous slice of the test
split, mean and variance, timed from its send to its results on the host.
Request sizes come from a fixed log-uniform grid, each pass in an order
drawn from the seed (:func:`gpbench.inputs.request_sizes`); slice offsets
from the seed.  Set-up builds the cache (timed apart as ``cache_build_s``)
and serves the largest and the smallest size once.  After the window a
sample of the finished requests drawn from the seed, the largest among
them, is held to the reference's float64 posterior.

Mix keys: ``solver`` (the cache), ``batch_size``, ``sizes`` (``low``,
``high``, ``count``).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from gpbench import harness
from gpbench.inputs import Inputs, request_sizes
from gpbench.kinds.adam_chunks import is_correct, judge

# Requests held to the reference after the window.
CHECK_REQUESTS = 8
# Requests in the traced stretch of --trace 1.
TRACE_REQUESTS = 24


class Server:
    def __init__(self, run: harness.Run, inputs: Inputs):
        mix = run.traffic
        self.run, self.inputs = run, inputs
        self.system = run.system(inputs)
        self.batch_size = mix["batch_size"]
        start = time.monotonic()
        self.cache = self.system.posterior(mix["solver"])
        run.synchronize()
        self.cache_build_s = time.monotonic() - start
        self.serve_fn = run.hook("serve")(self.system.serve)
        self.sizes = request_sizes(mix["sizes"], inputs.seeds["requests"])
        self.offsets = np.random.default_rng([inputs.seeds["requests"], 1])
        self.n_test = int(inputs.x_test.shape[0])

    def next_request(self):
        n = min(next(self.sizes), self.n_test)
        return int(self.offsets.integers(0, self.n_test - n + 1)), n

    def serve(self, offset: int, n: int, spans=None):
        """One request: ``(mean, var)`` on the host, and its latency."""
        start = time.monotonic()
        mean, var = self.serve_fn(self.cache, self.inputs.x_test[offset:offset + n],
                                  self.batch_size)
        if spans is not None:
            spans.append(time.monotonic() - start)
        mean, var = mean.cpu(), var.cpu()
        return mean, var, time.monotonic() - start


def reference_answers(system, served: List, precision: str):
    """The reference's ``(mean, var)`` at the points of ``served``, a list
    of ``(offset, n, ...)`` requests, in ``precision``."""
    x = torch.cat([system.inputs.x_test[o:o + n] for o, n, *_ in served])
    return system.reference_predict(x, precision)


def compare(system, served: List) -> Dict[str, float]:
    """Worst gaps of the served means (over the largest reference mean) and
    variances (over the prior variance) from the float64 reference, at the
    points of ``served``, a list of ``(offset, n, mean, var)``."""
    mean_r, var_r = reference_answers(system, served, "float64")
    mean_p = torch.cat([m for _, _, m, _ in served]).to(mean_r.device).double()
    var_p = torch.cat([v for _, _, _, v in served]).to(var_r.device).double()
    mean_gap = float(torch.max(torch.abs(mean_p - mean_r)) / torch.max(torch.abs(mean_r)))
    var_gap = float(torch.max(torch.abs(var_p - var_r))) / float(system.inputs.kernel_variance)
    return {k: (v if np.isfinite(v) else float("inf"))
            for k, v in {"mean_gap": mean_gap, "var_gap": var_gap}.items()}


def sample(run: harness.Run, inputs: Inputs, done: List) -> List:
    """The requests to check: a draw from the seed, the largest among them."""
    count = min(CHECK_REQUESTS, len(done))
    rng = np.random.default_rng(inputs.seeds["sample"])
    picked = set(rng.choice(len(done), size=count, replace=False).tolist())
    largest = max(range(len(done)), key=lambda i: done[i][1])
    if largest not in picked:
        picked.discard(min(picked))
        picked.add(largest)
    return [done[i] for i in sorted(picked)]


def setup(run: harness.Run):
    inputs = Inputs(run.cfg, run.seed, run.device, **run.sizes)
    run.note(m=inputs.m, n_test=int(inputs.x_test.shape[0]), resolution=inputs.resolution)
    server = Server(run, inputs)
    sizes = run.traffic["sizes"]
    for n in (int(sizes["high"]), int(sizes["low"])):
        server.serve(0, min(n, server.n_test))
    run.synchronize()
    return server


def run(run: harness.Run) -> Dict:
    server = setup(run)
    inputs = server.inputs
    setup_s = time.monotonic() - run.t0
    run.note(setup_s=round(setup_s, 3), cache_build_s=round(server.cache_build_s, 4))
    shapes = {"m": inputs.m, "d": int(inputs.x.shape[1])}
    outcome = {"trace": None, "context": None}
    done: List = []
    latencies: List[float] = []
    if run.trace:
        spans: Dict[str, List[float]] = {"enqueue": []}

        def stretch():
            with server.system.recording_solves() as solves:
                for _ in range(TRACE_REQUESTS):
                    offset, n = server.next_request()
                    mean, var, _ = server.serve(offset, n, spans["enqueue"])
                    done.append((offset, n, mean, var))
            return solves

        solves, reading = harness.profile_stretch(run, stretch)
        solves = [(r, m, int(s)) for r, m, s in solves]  # read after the stretch
        outcome["trace"] = reading
        outcome["context"] = harness.MetricContext(
            trace=reading, spans=spans, solves=solves,
            counts={"requests": len(done), "points": sum(n for _, n, _, _ in done)},
            shapes=shapes, values={"cache_build_s": server.cache_build_s})
    else:
        start = time.monotonic()
        while time.monotonic() - start < run.seconds:
            offset, n = server.next_request()
            mean, var, latency = server.serve(offset, n)
            done.append((offset, n, mean, var))
            latencies.append(latency)
        window_s = time.monotonic() - start
        points = sum(n for _, n, _, _ in done)
        outcome["e2e"] = {"serve_points_per_s": points / window_s,
                          "serve_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
                          "setup_s": setup_s}
    failed = sum(1 for _, _, m, v in done
                 if not (bool(torch.isfinite(m).all()) and bool(torch.isfinite(v).all())))
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    if "e2e" in outcome:
        outcome["e2e"]["peak_mem_gib"] = peak / harness.GIB
    run.note(requests=len(done), peak_bytes=peak)
    # The program's state goes before the reference runs.
    server.cache = server.system.params = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(compare(server.system, sample(run, inputs, done)), run.limits)
    outcome.update(correct=is_correct(checks) and failed == 0, attempted=len(done),
                   failed=failed, memory_peak_bytes=peak, checks=checks)
    return outcome
