"""Readings that the limits of ``gpbench/limits/<cell>.json`` are set from.

    python3 gpbench/calibrate.py --workload <name> --seeds 1,2,3 [--seconds 5]

For each seed, in one process and on the card, at the cell's own sizes:

* ``program``: the numbers a run compares, of the program against the
  float64 reference (training: the first steps; serving: a window of
  ``--seconds`` at the cell's load);
* ``control``: the same numbers of the reference computed in TF32 (float32
  with both operands of every product rounded to TF32), put in the
  program's place;
* ``faults`` (training): the program with half of each batch left out and
  the ELBO's data term scaled over the rest.

One JSON line per seed on standard output.  The benchmark's own runs never
run this.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gpbench import faults, harness  # noqa: E402


def training_readings(run: harness.Run, with_faults: bool = True) -> dict:
    from gpbench.kinds import adam_chunks as kind

    trainer, prog = kind.setup(run)
    ref = kind.reference_readings(trainer, "float64")
    control = kind.reference_readings(trainer, "tf32")
    out = {"m": trainer.inputs.m, "program": kind.compare(prog, ref),
           "control": kind.compare(control, ref), "faults": {}}
    for name in ("half_batch", "unchanged") if with_faults else ():
        faulty = harness.Run(**{**run.__dict__, "hooks": faults.HOOKS[name], "notes": {}})
        _, prog_fault = kind.setup(faulty)
        out["faults"][name] = kind.compare(prog_fault, ref)
    return out


def serving_readings(run: harness.Run, with_faults: bool = True) -> dict:
    del with_faults  # a serving cell's limits rest on the control alone
    import torch

    from gpbench.kinds import closed_loop_serve as kind

    server = kind.setup(run)
    done = []
    start = time.monotonic()
    while time.monotonic() - start < run.seconds:
        offset, n = server.next_request()
        mean, var, _ = server.serve(offset, n)
        done.append((offset, n, mean, var))
    checked = kind.sample(run, server.inputs, done)
    server.cache = server.system.params = None
    mean_c, var_c = kind.reference_answers(server.system, checked, "tf32")
    as_served, s = [], 0
    for offset, n, _, _ in checked:
        as_served.append((offset, n, mean_c[s:s + n].cpu(), var_c[s:s + n].cpu()))
        s += n
    torch.cuda.empty_cache()
    return {"m": server.inputs.m, "requests": len(done),
            "program": kind.compare(server.system, checked),
            "control": kind.compare(server.system, as_served)}


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--fault-seeds", type=int, default=3,
                        help="read the planted faults on the first this many seeds")
    args = parser.parse_args(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _cell, cfg, traffic, limits = harness.cell_files(bench, args.workload)

    import torch

    if not torch.cuda.is_available():
        harness.log("calibrate.py needs a CUDA card")
        return 2
    from cggp_tpu_torch import _build

    _build.load()
    harness.log(f"card {harness.nvidia_smi()}")
    readings = training_readings if traffic["kind"] == "adam_chunks" else serving_readings
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = harness.Run(workload=args.workload, cfg=cfg, traffic=traffic, limits=limits,
                          seed=seed, seconds=args.seconds, trace=False,
                          device=torch.device("cuda:0"), t0=time.monotonic())
        t = time.monotonic()
        out = readings(run, with_faults=i < args.fault_seeds)
        out.update(seed=seed, wall_s=time.monotonic() - t)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
