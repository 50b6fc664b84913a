"""A short run of each cell on the card (marker ``cuda``: skipped without
one).  Run on the card with
``python -m pytest gpbench/tests/test_gpbench_card.py -q``."""

import json
import subprocess
import sys

import pytest

from gpbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_is_correct(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    done = subprocess.run([sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
                           workload, "--seed", "12345", "--seconds", "3", "--trace", "0"],
                          capture_output=True, text=True, cwd=harness.ROOT, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    result = json.loads(done.stdout.splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
