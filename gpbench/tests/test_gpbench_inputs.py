"""The benchmark's inputs: the selection, the generators repeating for a
seed, and the frozen copy of the synthetic data."""

import numpy as np
import pytest
import torch

from gpbench import inputs


@pytest.mark.parametrize("resolution", [0.3, 0.5, 0.9])
def test_selection_is_the_sequential_greedy_and_a_net(resolution):
    (x, _), _ = inputs.synthetic(2500, 3, seed=11)
    picked = inputs.min_separation_select(x, resolution)
    assert np.array_equal(picked, inputs.greedy_select_plain(x, resolution))
    z = x[picked]
    d2 = np.sum((z[:, None] - z[None]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    assert d2.min() > resolution ** 2
    assert np.sum((x[:, None] - z[None]) ** 2, axis=-1).min(axis=1).max() <= resolution ** 2


def test_the_cache_returns_what_was_made(tmp_path, monkeypatch):
    monkeypatch.setattr(inputs, "CACHE_DIR", tmp_path)
    cfg = {"name": "tiny", "data": {"n": 1500, "dim": 3, "seed": 2, "noise": 0.1},
           "selection": {"resolution": 0.7}}
    made = inputs.dataset(cfg)
    assert len(list(tmp_path.iterdir())) == 1
    again = inputs.dataset(cfg)
    assert set(made) == set(again)
    for k in made:
        assert np.array_equal(made[k], again[k])


def test_clusters_are_means_and_counts_of_the_nearest_centre():
    (x, y), _ = inputs.synthetic(500, 2, seed=3)
    z = x[inputs.min_separation_select(x, 0.8)]
    u, counts = inputs.assign_clusters(torch.as_tensor(x), torch.as_tensor(y),
                                       torch.as_tensor(z), block=64)
    nearest = np.argmin(np.sum((x[:, None] - z[None]) ** 2, axis=-1), axis=1)
    for j in range(len(z)):
        assert counts[j, 0] == np.sum(nearest == j)
        assert float(u[j, 0]) == pytest.approx(float(np.mean(y[nearest == j, 0])))


def test_synthetic_is_the_programs():
    from cggp_tpu_torch.data import synthetic

    ours, theirs = inputs.synthetic(4000, 3, seed=5), synthetic(n=4000, dim=3, seed=5)
    for a, b in zip(ours, theirs):
        for u, v in zip(a, b):
            assert np.array_equal(u, v)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 3, 2 ** 40 + 1])
def test_streams_repeat_for_a_seed(seed):
    a, b = inputs.seeds_of(seed), inputs.seeds_of(seed)
    assert a == b and len(set(a.values())) == len(a)
    device = torch.device("cpu")
    s1 = inputs.batch_stream(1000, 64, 10, a["batches"], device)
    s2 = inputs.batch_stream(1000, 64, 10, a["batches"], device)
    first = inputs.take_steps(s1, 20)
    assert torch.equal(first, inputs.take_steps(s2, 20))
    assert len(set(first[:10].flatten().tolist())) == 10 * 64  # one pass: rows all differ
    pool = sorted(map(tuple, first[:10].tolist()))
    assert pool == sorted(map(tuple, first[10:].tolist()))  # every pass: the same pool
    other = inputs.take_steps(inputs.batch_stream(1000, 64, 10, a["batches"] + 1, device), 10)
    assert pool == sorted(map(tuple, other.tolist())) and not torch.equal(other, first[:10])
    sizes = {"low": 2048, "high": 16384, "count": 16}
    r1, r2 = inputs.request_sizes(sizes, a["requests"]), inputs.request_sizes(sizes, a["requests"])
    got = [next(r1) for _ in range(40)]
    assert got == [next(r2) for _ in range(40)]
    assert sorted(got[:16]) == sorted(got[16:32]) and min(got) == 2048 and max(got) == 16384


def test_inputs_are_the_configurations():
    cfg = {"name": "tiny", "data": {"n": 2000, "dim": 3, "seed": 4, "noise": 0.1},
           "selection": {"resolution": 0.7},
           "init": {"kernel_variance": 1.5, "lengthscales": 0.7, "noise_variance": 0.2}}
    one, two, other = (inputs.Inputs(cfg, s, torch.device("cpu"), data_n=2000)
                       for s in (9, 9, 10))
    for name in ("x", "y", "z", "u", "counts", "x_test"):
        assert torch.equal(getattr(one, name), getattr(two, name))
        assert torch.equal(getattr(one, name), getattr(other, name))  # the configuration's
    assert one.lengthscales.tolist() == [np.float32(0.7)] * 3
    ard = inputs.Inputs({**cfg, "init": {**cfg["init"], "lengthscales": [0.5, 0.6, 0.7]}}, 9,
                        torch.device("cpu"), data_n=2000)
    assert ard.lengthscales.tolist() == [np.float32(v) for v in (0.5, 0.6, 0.7)]
    assert one.kernel_variance == np.float32(1.5) and one.noise_variance == np.float32(0.2)
    assert one.seeds != other.seeds
    assert float(one.counts.sum()) == one.x.shape[0]
