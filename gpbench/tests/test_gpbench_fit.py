"""The fit that makes a configuration's initial values, at a CPU size."""

import numpy as np
import torch

from gpbench import fit_init, harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def tiny_fit(name: str):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = harness.load_json(harness.ROOT / entry["file"])
    cfg["fit"].update(of=30, steps=20, batch=100)
    return list(fit_init.fit(cfg, torch.device("cpu"), 10, data_n=3000, resolution=0.6))


def test_the_fit_repeats_starts_from_its_start_and_lowers_the_loss():
    one, two = tiny_fit("cdgp-m989"), tiny_fit("cdgp-m989")
    assert one == two
    assert [step for step, _, _ in one] == [0, 10, 20, 30]
    start = one[0][2]
    assert start["kernel_variance"] == 1.0 and start["lengthscales"] == [1.0] * 3
    assert start["noise_variance"] == float(np.float32(0.1))
    assert one[-1][1] < one[1][1]
    for _, _, params in one:
        flat = [params["kernel_variance"], params["noise_variance"], *params["lengthscales"]]
        assert all(float(np.float32(v)) == v for v in flat)  # what a configuration holds


def test_every_configuration_starts_from_its_fit():
    for entry in BENCH["configs"]:
        cfg = harness.load_json(harness.ROOT / entry["file"])
        assert 0 <= cfg["fit"]["steps"] <= cfg["fit"]["of"]
        assert set(cfg["init"]) == set(cfg["fit"]["from"])
