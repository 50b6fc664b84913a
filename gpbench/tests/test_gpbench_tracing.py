"""The per-layer metrics that read the program's own spans and counters,
on small traced cells on the CPU."""

import sys

import pytest

from gpbench import harness, program_trace
from gpbench.tests.tiny import tiny_run

NEW = {"host_reads.train", "host_reads.serve", "solve_device_ms.train",
       "solve_device_ms.serve", "vjp_device_ms.train"}


def _traced(workload):
    out = harness.execute(tiny_run(workload, seed=2 ** 31 + 5, trace=True))
    assert out["correct"], out["checks"]
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    return out["context"], harness.read_per_layer(bench, workload, out["context"])


@pytest.mark.parametrize("workload, kind", [("implicit-train", "train"),
                                            ("dense-serve", "serve")])
def test_traced_cells_read_the_program_counters(workload, kind):
    ctx, metrics = _traced(workload)
    # On the CPU every route reads its stop rule on the host each CG step
    # (B2's plain version too), so each unit reads at least once.
    assert metrics[f"host_reads.{kind}"]["value"] >= 1
    assert metrics[f"host_reads.{kind}"]["unit"] == "reads"
    # No CUDA event on the CPU: no device time is made up.
    assert not {name for name in metrics if "device_ms" in name}
    assert program_trace.device_ms(ctx, "cggp.cg.solve",
                                   "steps" if kind == "train" else "requests") is None
    # The metrics the benchmark had still read.
    assert metrics[f"cg_steps.{kind}"]["value"] > 0


def test_readers_find_nothing_without_the_module_or_the_stretch(monkeypatch):
    ctx, _ = _traced("dense-serve")
    assert program_trace.host_reads(ctx, "requests") is not None
    ctx.counts["requests"] += 1  # a recording that is not this stretch's
    assert program_trace.host_reads(ctx, "requests") is None
    ctx.counts["requests"] -= 1
    # A program without the module.
    monkeypatch.delattr(sys.modules["cggp_tpu_torch"], "tracing")
    monkeypatch.setitem(sys.modules, "cggp_tpu_torch.tracing", None)
    assert program_trace.host_reads(ctx, "requests") is None
    assert program_trace.device_ms(ctx, "cggp.cg.solve", "requests") is None


def test_the_new_metrics_are_declared_with_their_readers():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    declared = {m["name"]: m for m in bench["per_layer"]}
    assert NEW <= set(declared)
    for name in NEW:
        assert (harness.BENCH_DIR / "metrics" / f"{name}.py").is_file()
        assert declared[name]["source"] in ("program_counter", "program_span")
