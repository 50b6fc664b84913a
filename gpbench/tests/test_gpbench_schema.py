"""BENCHMARK.json's format and limits, and every file a cell
needs found by name."""

import json
import re

import pytest

from gpbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def reported_e2e(cell: str):
    return {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32 and 1 <= len(BENCH["paths"]) <= 16
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[section]
    for entry in BENCH[section]:
        assert NAME.match(entry["name"]), entry["name"]
        assert set(entry) - {"workloads"} == keys, entry["name"]
        for text in ("why", "layer", "source"):
            if text in entry:
                assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
                assert "\t" not in entry[text]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        for key in entry.get("reduced", []):
            assert NAME.match(key)
        if section == "workloads":
            assert entry["chips"] in (1, 4)
            assert NAME.match(entry["traffic"]) and entry["config"] in {
                c["name"] for c in BENCH["configs"]}


def test_end_to_end_bounds_and_sources():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_per_layer_cells_and_moves():
    layers = {}
    for metric in BENCH["per_layer"]:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert metric["moves"] in E2E
        for cell in metric["workloads"]:  # the harness reads a metric in the cells it lists
            assert cell in CELLS
            assert metric["moves"] in reported_e2e(cell), (metric["name"], cell)
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
        layers.setdefault(metric["layer"], []).append(metric["name"])
    assert all("\n" not in layer for layer in layers)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_enough_and_finds_its_files(cell):
    e2e = reported_e2e(cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [])]
    assert per_layer
    _w, cfg, traffic, limits = harness.cell_files(BENCH, cell)
    assert (harness.BENCH_DIR / "kinds" / f"{traffic['kind']}.py").is_file()
    assert (harness.BENCH_DIR / "systems" / f"{cfg['system']}.py").is_file()
    assert (harness.ROOT / cfg["reference"]).is_file()
    if traffic["kind"] == "adam_chunks":
        assert {"loss_gap", "grad_gap"} <= set(limits)
        assert len(set(limits) & {"change_gap", "total_change_gap"}) == 1
        assert set(limits) <= {"loss_gap", "grad_gap", "change_gap", "total_change_gap"}
    else:
        assert set(limits) == {"mean_gap", "var_gap"}
    for metric in per_layer:
        assert (harness.BENCH_DIR / "metrics" / f"{metric['name']}.py").is_file()


def test_configs_lie_under_paths_and_differ():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for config in BENCH["configs"]:
        assert any(config["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = json.loads((harness.ROOT / config["file"]).read_text())
        assert cfg["name"] == config["name"]
        assert set(config["reduced"]) <= set(cfg["assumed"])
        used = [w for w in BENCH["workloads"] if w["config"] == config["name"]]
        assert used


def test_four_chip_cells_within_the_share():
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(BENCH["workloads"]) // 4)
