"""``train``, ``geospatial``, ``predict`` and the file tools of the port's CLI
against the JAX package's, on the CPU at a small size.

What is compared, and why:

* ``train train-cggp-adam`` and ``geospatial ... train-adam`` draw their
  batches and probes from each package's generator, so only their
  draw-free outputs are compared: ``info.json`` (equal apart from
  ``logdir``), the names and shapes of ``params.npz`` (the selection,
  ``kmeans -m 8``, starts from the same ``RandomState`` subset), the
  monitor's log files and keys, finite values, and the posterior dumps'
  shapes.  Options covered: ``--trainable-u``, ``-P pivchol``,
  ``--checkpoint-every`` / ``--resume-from`` (the port's checkpoint, and a
  config dir written by the JAX package, which has no ``ckpt/`` the port
  can read), ``--matrix-free``, ``--steps-per-call``, ``-P auto`` (the
  resolved mode in ``info.json``) and ``--precond-refresh chunk``.
* ``predict`` is draw-free: from a config dir written by the JAX package
  and from one written by the port, the port's means and variances match
  the JAX package's on the same dir (1e-7 of the largest value; both serve
  in float64, JAX's default float under this suite's x64); ``--posterior-dir`` round-trips (the second run loads the
  cache and dumps bitwise the same arrays), the port loads a cache the JAX
  package saved (the fingerprints agree), and ``--serving-solver lanczos``
  on a matrix-free run matches JAX's LOVE cache.
* ``condition-wasserstein`` draws its data: the port's ``uniform_draw``
  and ``normal_draw`` return JAX's draws of ``split(PRNGKey(seed), 3)``, and
  the CSVs then read back equal under pandas (1e-6 relative).
* ``geospatial ... covernet ... train-adam``: the same layout and the same
  selected inducing points as JAX's.
* ``geospatial-csv`` writes the file pandas writes; ``uci-plot`` writes the
  same file name (skipped without matplotlib).
"""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import cggp_tpu_torch.cli.condition_wasserstein as tcw
from torch_cli_helpers import npz, restore_torch_default_dtype, run_jax, run_port  # noqa: F401

torch.set_num_threads(2)

DATA = "synthetic:n=300:dim=2"
PREDICT_RTOL = 1e-7
TRAIN = ["train-cggp-adam", "-n", 4, "-b", 64, "-m", 8, "-c", "kmeans", "-d", "euclidean",
         "--no-tensorboard", "-r", 2, "--max-cg-iterations", 64, "-e", "1e-8"]


def _info(logdir) -> dict:
    return {k: v for k, v in json.loads(Path(logdir, "info.json").read_text()).items()
            if k != "logdir"}


def _assert_same_layout(port_dir, jax_dir, logs=("metrics", "params", "cg", "train")):
    assert _info(port_dir) == _info(jax_dir)
    got, want = npz(Path(port_dir, "params.npz")), npz(Path(jax_dir, "params.npz"))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(np.all(np.isfinite(v)) for v in got.values())
    for name in logs:
        port_log = np.load(Path(port_dir, f"{name}.logs.npy"), allow_pickle=True)
        jax_log = np.load(Path(jax_dir, f"{name}.logs.npy"), allow_pickle=True)
        assert [sorted(e) for e in port_log] == [sorted(e) for e in jax_log], name
        assert [e["step"] for e in port_log] == [e["step"] for e in jax_log], name


TRAIN_CASES = {
    "kmeans": [],
    "trainable_u_pivchol": ["--trainable-u", "-P", "pivchol", "--precond-rank", 4],
    "matrix_free_k2": ["--matrix-free", "--block", 16, "-P", "pivchol", "--precond-rank", 4,
                       "--relative-threshold", "--steps-per-call", 2],
    "auto_k2": ["-P", "auto", "--steps-per-call", 2],
    "chunk_frozen_k2": ["-P", "pivchol", "--precond-rank", 4, "--steps-per-call", 2,
                        "--precond-refresh", "chunk"],
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_writes_what_jax_writes(case, tmp_path):
    head = ["train", "-d", DATA, "-s", 0]
    run_jax([*head, "-l", tmp_path / "jax", *TRAIN, *TRAIN_CASES[case]])
    run_port([*head, "-l", tmp_path / "port", *TRAIN, *TRAIN_CASES[case]])
    _assert_same_layout(tmp_path / "port", tmp_path / "jax")
    metrics = np.load(tmp_path / "port" / "metrics.logs.npy", allow_pickle=True)
    assert all(np.isfinite(float(e["train/elbo"])) for e in metrics)


def test_train_checkpoints_and_resumes(tmp_path, capsys):
    """The port's own checkpoints under ``ckpt/`` resume the run; a JAX
    run dir (orbax ``ckpt/`` removed) resumes through its ``params.npz``."""
    head = ["train", "-d", DATA, "-s", 0]
    run1 = tmp_path / "run1"
    run_port([*head, "-l", run1, *TRAIN, "--checkpoint-every", 2], capsys)
    assert sorted(p.name for p in (run1 / "ckpt").iterdir()) == ["0", "2"]
    out = run_port([*head, "-l", tmp_path / "run2", *TRAIN, "-n", 0, "--resume-from", run1],
                   capsys)
    assert "resumed from checkpoint" in out
    # With no step taken, run2's parameters are the latest checkpoint's.
    resumed = npz(tmp_path / "run2" / "params.npz")
    latest = npz(run1 / "ckpt" / "2" / "checkpoint.npz")
    for name in ("kernel/variance", "kernel/lengthscales", "likelihood/variance"):
        np.testing.assert_array_equal(resumed[name], latest[name])

    jax_run = tmp_path / "jax_run"
    run_jax([*head, "-l", jax_run, *TRAIN])
    shutil.rmtree(jax_run / "ckpt", ignore_errors=True)
    out = run_port([*head, "-l", tmp_path / "run3", *TRAIN, "-n", 0, "--resume-from", jax_run],
                   capsys)
    assert "resumed from config dir" in out
    resumed, want = npz(tmp_path / "run3" / "params.npz"), npz(jax_run / "params.npz")
    for name in ("kernel/variance", "kernel/lengthscales", "likelihood/variance"):
        np.testing.assert_allclose(resumed[name], want[name], rtol=1e-6)


def test_geospatial_train_adam_writes_what_jax_writes(tmp_path):
    head = ["geospatial", "-d", DATA, "-mc", "cdgp", "-s", 0, "-e", "1e-10"]
    tail = ["kmeans", "-m", 8, "train-adam", "-n", 2, "-b", 64, "-r", 1, "--no-tensorboard"]
    run_jax([*head, "-l", tmp_path / "jax", *tail])
    run_port([*head, "-l", tmp_path / "port", *tail])
    _assert_same_layout(tmp_path / "port", tmp_path / "jax", logs=("metrics", "params", "train"))
    for split in ("train", "test"):
        for what in ("mean", "variances"):
            got = np.load(tmp_path / "port" / f"{split}_{what}.npy")
            want = np.load(tmp_path / "jax" / f"{split}_{what}.npy")
            assert got.shape == want.shape and np.all(np.isfinite(got))


def test_geospatial_covernet_train_adam_writes_what_jax_writes(tmp_path):
    # The device net in geospatial's loop: a draw-free selection, so the
    # inducing state before training equals JAX's (params.npz after the
    # run holds the trained kernel, so only its layout is compared).
    head = ["geospatial", "-d", DATA, "-mc", "cdgp", "-s", 0, "-e", "1e-10"]
    tail = ["covernet", "-s", 0.5, "train-adam", "-n", 2, "-b", 64, "-r", 1,
            "--no-tensorboard"]
    run_jax([*head, "-l", tmp_path / "jax", *tail])
    run_port([*head, "-l", tmp_path / "port", *tail])
    _assert_same_layout(tmp_path / "port", tmp_path / "jax", logs=("metrics", "params", "train"))
    got, want = npz(tmp_path / "port" / "params.npz"), npz(tmp_path / "jax" / "params.npz")
    np.testing.assert_allclose(got["inducing_points"], want["inducing_points"], rtol=0,
                               atol=1e-12)


@pytest.fixture(scope="module")
def trained_dirs(tmp_path_factory):
    """A dense and a matrix-free training run by each package (fp32)."""
    base = tmp_path_factory.mktemp("trained")
    head = ["train", "-d", DATA, "-s", 0]
    mf = ["--matrix-free", "--block", 16, "-P", "pivchol", "--precond-rank", 4,
          "--relative-threshold"]
    run_jax([*head, "-l", base / "jax", *TRAIN])
    run_port([*head, "-l", base / "port", *TRAIN])
    run_jax([*head, "-l", base / "jax_mf", *TRAIN, *mf])
    return base


def _predictions(logdir):
    return {f"{s}_{w}": np.load(Path(logdir, f"{s}_{w}.npy"))
            for s in ("train", "test") for w in ("mean", "variances")}


def _assert_close(got, want, rtol):
    for name in want:
        scale = float(np.max(np.abs(want[name])))
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=rtol * scale,
                                   err_msg=name)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_predict_matches_jax_on_either_packages_config_dir(writer, trained_dirs, tmp_path,
                                                           capsys):
    # This suite runs JAX with x64 on, so JAX's predict of an fp32 run
    # builds float64 parameters (its default float); the port does the same
    # with float64 as torch's default dtype, and the cache fingerprints agree.
    torch.set_default_dtype(torch.float64)
    config = trained_dirs / writer
    args = ["predict", "-c", config, "-mc", "cdgp", "-e", "1e-10", "-tb", 64]
    run_jax([*args, "-l", tmp_path / "jax", "--posterior-dir", tmp_path / "jax_cache"])
    run_port([*args, "-l", tmp_path / "port"])
    want = _predictions(tmp_path / "jax")
    _assert_close(_predictions(tmp_path / "port"), want, PREDICT_RTOL)

    # The cache: built and saved, then loaded (bitwise the same dumps).
    run_port([*args, "-l", tmp_path / "p1", "--posterior-dir", tmp_path / "cache"], capsys)
    out = run_port([*args, "-l", tmp_path / "p2", "--posterior-dir", tmp_path / "cache"], capsys)
    assert "build skipped" in out
    first, second = _predictions(tmp_path / "p1"), _predictions(tmp_path / "p2")
    for name in first:
        np.testing.assert_array_equal(second[name], first[name])
    # A cache the JAX package saved for the same parameters loads here.
    out = run_port([*args, "-l", tmp_path / "p3", "--posterior-dir", tmp_path / "jax_cache"],
                   capsys)
    assert "build skipped" in out and "WARNING" not in out
    _assert_close(_predictions(tmp_path / "p3"), want, PREDICT_RTOL)


def test_predict_serves_a_matrix_free_run_through_love(trained_dirs, tmp_path):
    torch.set_default_dtype(torch.float64)  # JAX's default float here (x64 on)
    args = ["predict", "-c", trained_dirs / "jax_mf", "-mc", "cdgp-implicit", "-tb", 64,
            "--serving-solver", "lanczos"]
    run_jax([*args, "-l", tmp_path / "jax"])
    run_port([*args, "-l", tmp_path / "port"])
    _assert_close(_predictions(tmp_path / "port"), _predictions(tmp_path / "jax"),
                  PREDICT_RTOL)


def test_condition_wasserstein_matches_jax_given_its_draws(tmp_path, monkeypatch):
    dims, num_data, seed = (1, 2), 40, 0
    draws = {}
    for dim in dims:
        key_x, key_f, key_probe = jax.random.split(jax.random.PRNGKey(seed), 3)
        draws[dim] = {"x": np.asarray(jax.random.uniform(key_x, (num_data, dim),
                                                         dtype=np.float64, minval=-1.0,
                                                         maxval=1.0)),
                      "normals": [np.asarray(jax.random.normal(k, (num_data, 1),
                                                               dtype=np.float64))
                                  for k in (key_f, key_probe)]}
    current = {}

    def uniform_draw(generator, shape, dtype):
        current["dim"] = shape[1]
        current["normals"] = list(draws[shape[1]]["normals"])
        return torch.as_tensor(draws[shape[1]]["x"].copy(), dtype=dtype)

    def normal_draw(generator, shape, dtype):
        return torch.as_tensor(current["normals"].pop(0).copy(), dtype=dtype)

    monkeypatch.setattr(tcw, "uniform_draw", uniform_draw)
    monkeypatch.setattr(tcw, "normal_draw", normal_draw)
    args = ["condition-wasserstein", "-n", num_data, "-s", seed, "-r", 1.0, "-r", 0.5,
            *[a for d in dims for a in ("-d", d)]]
    run_jax([*args, "-l", tmp_path / "jax"])
    run_port([*args, "-l", tmp_path / "port"])
    for dim in dims:
        name = f"condition_wasserstein_dim{dim}.csv"
        got = pd.read_csv(tmp_path / "port" / name)
        want = pd.read_csv(tmp_path / "jax" / name)
        pd.testing.assert_frame_equal(got, want, rtol=1e-6)


def test_geospatial_csv_writes_the_file_pandas_writes(tmp_path):
    args = ["geospatial-csv", "-d", "synthetic:n=50:dim=3", "-s", 1]
    run_jax([*args, "-l", tmp_path / "jax"])
    run_port([*args, "-l", tmp_path / "port"])
    for split in ("train", "test"):
        name = f"synthetic:n=50:dim=3_{split}.csv"
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


def test_uci_plot_writes_the_same_file(tmp_path):
    pytest.importorskip("matplotlib")
    runs = tmp_path / "runs"
    for i, (m, rmse) in enumerate([(8, 0.3), (16, 0.2), (16, 0.22)]):
        d = runs / f"r{i}"
        d.mkdir(parents=True)
        (d / "results.json").write_text(json.dumps({
            "model": "cdgp", "precision": "fp64", "clustering_type": "kmeans",
            "num_inducing_points": m, "test/rmse": rmse}))
    run_jax(["uci-plot", runs, "-l", tmp_path / "jax"])
    run_port(["uci-plot", runs, "-l", tmp_path / "port"])
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir()) == ["uci_test_rmse.png"]
    run_jax(["uci-csv", runs, "-l", tmp_path / "csv"])
    run_port(["uci-plot", tmp_path / "csv" / "results.csv", "-l", tmp_path / "from_csv"])
    assert (tmp_path / "from_csv" / "uci_test_rmse.png").stat().st_size > 0
