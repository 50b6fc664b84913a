"""What the harness may import and read, and its refusal without a card."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from gpbench import harness

SOURCES = sorted(p for p in harness.BENCH_DIR.rglob("*.py") if "_cache" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "cggp_tpu"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_jax_and_no_jax_package(path):
    assert not FORBIDDEN.intersection(imported_tops(path))
    for word in ("benchmarks/", "bench.py", "chip_smoke"):
        assert word not in path.read_text() or path.name.startswith("test_gpbench_boundary")


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").rglob("*.py"):
        assert set(imported_tops(path)) <= {"__future__", "math", "typing", "torch"}, path


def test_forbidden_modules_are_compared_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cggp_tpu_torch_fake", object())
    assert harness.forbidden_loaded() == [] or "cggp_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_loaded()


def test_run_exits_non_zero_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    done = subprocess.run([sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
                           "dense-serve", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert done.returncode != 0
    for line in done.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
