"""The initial values of a configuration: a fit by the float64 reference.

    python3 gpbench/fit_init.py --config cdgp-m989 [--every 100]

Runs the reference's Adam (``gpbench/reference/cggp.py``: float64, exact
solves) on the configuration's own data and inducing set, as its ``fit``
block states: from ``fit.from`` (the CLI's initial values), batches of
``fit.batch`` rows (each pass a permutation of the training rows drawn from
``fit.seed``), ``fit.probes`` Rademacher probes a step, ``adam(fit.lr)``, for
``fit.of`` steps, the length of ``configs/geospatial.toml``'s
``train-adam -n 2000 -b 2000 -l 0.01``.  Prints one JSON line every
``--every`` steps: the step, the mean loss since the last line and the
constrained parameters rounded to float32.  The line of step ``fit.steps``
is the configuration's ``init``, where every run's fit starts and restarts.
Needs a CUDA card; the benchmark's own runs never run this.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from gpbench import harness  # noqa: E402


def constrained(reference, raw) -> dict:
    """The constrained parameters as float32 values (lists of floats)."""
    out = {}
    for name, value in raw.items():
        v = reference.positive(value.detach()).cpu().numpy().astype(np.float32)
        out[name] = float(v) if v.ndim == 0 else [float(e) for e in v]
    return out


def fit(cfg: dict, device, every: int, **sizes):
    """``(step, mean loss, constrained parameters)`` every ``every`` steps of
    the configuration's fit, step 0 first; ``sizes`` override the inputs'
    (the CPU tests)."""
    import torch

    from gpbench.inputs import Inputs

    spec = cfg["fit"]
    start = spec["from"]
    inputs = Inputs({**cfg, "init": start}, 0, device, **sizes)
    reference = harness.load_module(harness.ROOT / cfg["reference"], "gpbench_reference")
    raw0 = reference.init_raw(inputs.kernel_variance, inputs.lengthscales, inputs.noise_variance,
                              "float64", device)
    n, batch, probes = int(inputs.x.shape[0]), int(spec["batch"]), int(spec["probes"])
    rng = np.random.default_rng(int(spec["seed"]))
    gen = torch.Generator(device=device).manual_seed(int(spec["seed"]))

    def batches():
        step = 0
        while True:
            rows = torch.as_tensor(rng.permutation(n), device=device)
            for s in range(0, n - batch + 1, batch):
                if step == int(spec["of"]):
                    return
                step += 1
                t, ld = (2.0 * torch.randint(0, 2, (inputs.m, probes), generator=gen,
                                             device=device) - 1.0 for _ in range(2))
                yield inputs.x[rows[s:s + batch]], inputs.y[rows[s:s + batch]], t, ld

    yield 0, None, constrained(reference, raw0)
    losses = []
    for step, (loss, _grads, raw) in enumerate(
            reference.adam_trajectory(raw0, batches(), inputs.z, inputs.u, inputs.counts, n,
                                      float(spec["lr"]), "float64"), start=1):
        losses.append(loss)
        if step % every == 0 or step == int(spec["steps"]):
            yield step, float(np.mean(losses)), constrained(reference, raw)
            losses = []


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--every", type=int, default=100)
    args = parser.parse_args(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == args.config)
    cfg = harness.load_json(harness.ROOT / entry["file"])

    import torch

    if not torch.cuda.is_available():
        harness.log("fit_init.py needs a CUDA card")
        return 2
    harness.log(f"card {harness.nvidia_smi()}")
    for step, loss, params in fit(cfg, torch.device("cuda:0"), args.every):
        line = {"config": args.config, "step": step, "loss": loss, "params": params,
                "wall_s": time.monotonic() - T0}
        if step == int(cfg["fit"]["steps"]):
            line["init"] = True
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
