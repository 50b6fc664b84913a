"""``correct`` on small cells on the CPU: true for the program, false for
the control (the reference in TF32 in the program's place) and for each
fault a cell can have, planted under the timed path."""

import pytest
import torch

from gpbench import calibrate, faults, harness
from gpbench.kinds import adam_chunks
from gpbench.tests.tiny import tiny_run

TRAIN = ["dense-train", "implicit-train"]


@pytest.mark.parametrize("workload", TRAIN + ["dense-serve"])
def test_the_program_is_correct(workload):
    out = harness.execute(tiny_run(workload, seed=2 ** 31 + 17))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload", TRAIN)
def test_training_control_is_not_correct(workload):
    run = tiny_run(workload, seed=5)
    trainer, _prog = adam_chunks.setup(run)
    ref = adam_chunks.reference_readings(trainer, "float64")
    control = adam_chunks.reference_readings(trainer, "tf32")
    checks = adam_chunks.judge(adam_chunks.compare(control, ref), run.limits)
    assert not adam_chunks.is_correct(checks), checks


def test_serving_control_is_not_correct():
    run = tiny_run("dense-serve", seed=5)
    out = calibrate.serving_readings(run)
    checks = adam_chunks.judge(out["control"], run.limits)
    assert not adam_chunks.is_correct(checks), checks


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_faults_are_not_correct(workload, fault):
    out = harness.execute(tiny_run(workload, seed=6, hooks=faults.HOOKS[fault]))
    assert not out["correct"], out["checks"]


def test_an_altered_answer_is_not_correct():
    out = harness.execute(tiny_run("dense-serve", seed=6,
                                   hooks=faults.HOOKS["altered_answer"]))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", ["dense-train", "dense-serve"])
def test_the_traced_run_reads_its_counters(workload):
    out = harness.execute(tiny_run(workload, seed=8, trace=True))
    assert out["correct"], out["checks"]
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    metrics = harness.read_per_layer(bench, workload, out["context"])
    kind = "train" if "train" in workload else "serve"
    assert metrics[f"cg_steps.{kind}"]["value"] > 0
    assert metrics[f"enqueue_ms.{kind}"]["value"] > 0
    # No CUDA kernel runs on the CPU: no roofline share is made up.
    assert not any("roofline" in name for name in metrics)


def test_the_fit_restarts_from_the_initial_state():
    run = tiny_run("dense-train", seed=9)
    run.traffic.update(k=2, restart_every=4)
    trainer, _ = adam_chunks.setup(run)  # three steps: the next chunk runs steps 4-5
    trainer.chunk()
    assert trainer.state.count == 5 and trainer.since_restart == 5
    trainer.chunk()  # past restart_every: steps 1-2 of a new fit
    assert trainer.state.count == 2 and trainer.since_restart == 2


def test_the_change_numbers_read_a_state_left_unchanged_or_moved_double():
    ref = {"losses": torch.tensor([2.0, 3.0]),
           "grads": {"a": torch.tensor([3.0]), "b": torch.tensor([4.0, -0.5])},
           "change": {"a": torch.tensor([0.01]), "b": torch.tensor([-0.02, 0.01])}}
    assert all(v == 0 for v in adam_chunks.compare(ref, ref).values())
    zeros = {k: {n: torch.zeros_like(t) for n, t in ref[k].items()} for k in ("grads", "change")}
    unchanged = adam_chunks.compare({"losses": ref["losses"], **zeros}, ref)
    assert unchanged["grad_gap"] == unchanged["change_gap"] == 1
    assert unchanged["total_change_gap"] == pytest.approx(1)
    double = {**ref, "change": {n: 2 * t for n, t in ref["change"].items()}}
    assert adam_chunks.compare(double, ref)["total_change_gap"] == pytest.approx(1)


def test_a_cell_compares_the_numbers_its_limits_name():
    gaps = {"loss_gap": 1e-4, "grad_gap": 0.01, "change_gap": 0.9, "total_change_gap": 0.02}
    checks = adam_chunks.judge(gaps, {"loss_gap": 1e-3, "total_change_gap": 0.3})
    assert set(checks) == {"loss_gap", "total_change_gap"}
    assert adam_chunks.is_correct(checks)
