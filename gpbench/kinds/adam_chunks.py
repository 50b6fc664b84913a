"""Traffic kind ``adam_chunks``: training by the program's
``make_adam_multi_step``, chunks of K steps back to back.

Set-up builds the model, its parameters, Adam's state and the one K-step
call, then drives its first ``reference_steps`` steps through that same
call (one step, then the rest), keeping the first step's gradient as Adam
got it (its first moment over ``1 - b1``) and each loss.  The window runs
whole chunks from where those steps left off until ``--seconds`` have
passed, then finishes the chunk in flight and synchronizes.  Every
``restart_every`` steps the fit starts again from the initial parameters
(a fresh Adam state): the solves grow harder as a fit moves (the noise
variance falls), so without restarts a faster program would reach harder
steps within the window and a rate would understate its gain.  After the
window the reference follows the first steps in float64 and the gaps are
held to the cell's limits (``gpbench/limits/<cell>.json``).

Mix keys: ``k`` (steps a call), ``batch``, ``batch_pool`` (the fixed
pool of batches every seed visits in its own order,
:func:`gpbench.inputs.batch_stream`), ``lr``, ``restart_every`` (steps).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from gpbench import harness
from gpbench.inputs import Inputs, batch_stream, take_steps

# The reference follows the first three steps.
REFERENCE_STEPS = 3
# K-step calls in the traced stretch of --trace 1.
TRACE_CHUNKS = 1
# Leaves whose reference gradient is below this share of the median leaf's
# are left out of the comparison (round-off moves them under Adam).
NEGLIGIBLE_LEAF = 1e-3


class Trainer:
    """The program's training state for one run."""

    def __init__(self, run: harness.Run, inputs: Inputs):
        from cggp_tpu_torch.training.optimize import adam, make_adam_multi_step

        mix = run.traffic
        self.run, self.inputs = run, inputs
        self.system = run.system(inputs)
        self.optimizer = adam(float(mix["lr"]))
        loss_fn = run.hook("loss")(self.system.loss_fn)
        self.multi_step = run.hook("step")(make_adam_multi_step(
            loss_fn, self.optimizer, (inputs.x, inputs.y), self.system.trainable_mask()))
        self.stream = batch_stream(int(inputs.x.shape[0]), int(mix["batch"]),
                                   int(mix["batch_pool"]), inputs.seeds["batches"],
                                   run.device)
        self.generator = torch.Generator(device=run.device).manual_seed(inputs.seeds["probes"])
        self.params0 = self.system.params
        self.params, self.state = self.params0, self.optimizer.init(self.params0)
        self.since_restart = 0

    def first_steps(self, count: int) -> Dict:
        """The first ``count`` steps, one call of one step, then one call of
        the rest; the readings the reference checks."""
        self.first_index = take_steps(self.stream, count)
        self.params, self.state, first = self.multi_step(self.params, self.state,
                                                         self.first_index[:1], self.generator)
        leaf = self.system.leaf
        grads = {n: (leaf(self.state.mu, n) / (1.0 - self.optimizer.b1)).detach().clone()
                 for n in self.system.LEAVES}
        self.params, self.state, rest = self.multi_step(self.params, self.state,
                                                        self.first_index[1:], self.generator)
        self.since_restart = count
        change = {n: (leaf(self.params, n) - leaf(self.params0, n)).detach().clone()
                  for n in self.system.LEAVES}
        return {"losses": torch.cat([first, rest]), "grads": grads, "change": change}

    def chunk(self) -> torch.Tensor:
        """One K-step call; every ``restart_every`` steps the fit starts
        again from the initial parameters and a fresh Adam state."""
        k = int(self.run.traffic["k"])
        if self.since_restart >= int(self.run.traffic["restart_every"]):
            self.params, self.state = self.params0, self.optimizer.init(self.params0)
            self.since_restart = 0
        self.since_restart += k
        idx = take_steps(self.stream, k)
        self.params, self.state, losses = self.multi_step(self.params, self.state, idx,
                                                          self.generator)
        return losses


def reference_readings(trainer: Trainer, precision: str) -> Dict:
    """The reference's losses, first gradients and change over the first
    steps, on the same rows and probes, in ``precision``."""
    return trainer.system.reference_steps(trainer.first_index, float(trainer.run.traffic["lr"]),
                                          precision)


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(torch.as_tensor(t).double()))


def worst_leaf_gap(prog: Dict, ref: Dict, counted: List[str]) -> float:
    """The largest gap between the program's and the reference's norm of a
    leaf, over the larger of that leaf's reference norm and the median
    leaf's."""
    norms = {n: _norm(ref[n]) for n in counted}
    median = float(np.median(list(norms.values())))
    return max(abs(_norm(prog[n]) - norms[n]) / max(norms[n], median, 1e-300) for n in counted)


def total_gap(prog: Dict, ref: Dict, counted: List[str]) -> float:
    """The gap between the program's and the reference's norm of all the
    counted leaves together, over the reference's."""
    p = _norm([_norm(prog[n]) for n in counted])
    r = _norm([_norm(ref[n]) for n in counted])
    return abs(p - r) / max(r, 1e-300)


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a cell's limits may hold: the losses' largest relative
    gap, the worst leaf's gap of the first gradient, and the gap of the
    change over the first steps, by the worst leaf and of all leaves
    together."""
    ref_grad = {n: _norm(g) for n, g in ref["grads"].items()}
    median = float(np.median(list(ref_grad.values())))
    counted = [n for n in ref_grad if ref_grad[n] >= NEGLIGIBLE_LEAF * median]
    p_loss = prog["losses"].double().cpu()
    r_loss = ref["losses"].double().cpu()
    gaps = {"loss_gap": float(torch.max(torch.abs(p_loss - r_loss) / torch.abs(r_loss))),
            "grad_gap": worst_leaf_gap(prog["grads"], ref["grads"], counted),
            "change_gap": worst_leaf_gap(prog["change"], ref["change"], counted),
            "total_change_gap": total_gap(prog["change"], ref["change"], counted)}
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in gaps.items()}


def judge(gaps: Dict[str, float], limits: Dict) -> Dict:
    """The numbers that the cell's limits name, each beside its limit."""
    return {name: {"value": gaps[name], "limit": float(limit)} for name, limit in limits.items()}


def is_correct(checks: Dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def setup(run: harness.Run):
    inputs = Inputs(run.cfg, run.seed, run.device, **run.sizes)
    run.note(m=inputs.m, n_train=int(inputs.x.shape[0]), resolution=inputs.resolution)
    trainer = Trainer(run, inputs)
    prog = trainer.first_steps(REFERENCE_STEPS)
    run.synchronize()
    return trainer, prog


def run(run: harness.Run) -> Dict:
    trainer, prog = setup(run)
    mix = run.traffic
    setup_s = time.monotonic() - run.t0
    run.note(setup_s=round(setup_s, 3))
    inputs = trainer.inputs
    shapes = {"m": inputs.m, "d": int(inputs.x.shape[1]), "batch": int(mix["batch"])}
    outcome = {"trace": None, "context": None}
    if run.trace:
        spans: Dict[str, List[float]] = {"enqueue": []}

        def stretch():
            losses = []
            with trainer.system.recording_solves() as solves:
                for _ in range(TRACE_CHUNKS):
                    t = time.monotonic()
                    losses.append(trainer.chunk())
                    spans["enqueue"].append(time.monotonic() - t)
            return losses, solves

        (losses, solves), reading = harness.profile_stretch(run, stretch)
        solves = [(r, m, int(s)) for r, m, s in solves]  # read after the stretch
        steps = TRACE_CHUNKS * int(mix["k"])
        outcome["trace"] = reading
        outcome["context"] = harness.MetricContext(
            trace=reading, spans=spans, solves=solves, counts={"steps": steps},
            shapes=shapes, values={})
        attempted = steps
    else:
        losses, steps = [], 0
        start = time.monotonic()
        while True:
            losses.append(trainer.chunk())
            steps += int(mix["k"])
            if time.monotonic() - start >= run.seconds:
                break
        run.synchronize()
        window_s = time.monotonic() - start
        attempted = steps
        outcome["e2e"] = {"train_steps_per_s": steps / window_s, "setup_s": setup_s}
    failed = int((~torch.isfinite(torch.cat(losses))).sum())
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    if "e2e" in outcome:
        outcome["e2e"]["peak_mem_gib"] = peak / harness.GIB
    run.note(steps=attempted, peak_bytes=peak)
    # The program's state goes before the reference runs.
    trainer.params = trainer.state = trainer.multi_step = trainer.params0 = None
    trainer.system.params = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(trainer, "float64")
    checks = judge(compare(prog, ref), run.limits)
    outcome.update(correct=is_correct(checks) and failed == 0, attempted=attempted,
                   failed=failed, memory_peak_bytes=peak, checks=checks)
    return outcome
