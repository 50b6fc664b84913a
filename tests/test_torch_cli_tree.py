"""The port's CLI tree against the JAX package's, and its draw-free tools.

* The option table: JAX's click tree (``cggp_tpu.cli.__main__.cli``) and
  the port's argparse tree have the same groups and commands, and each has
  the same options (strings, flag pairs, defaults, choices, required-ness,
  ``multiple``) and positional arguments; the port's one extra option is
  the root's ``--device``.
* Refusals and exit codes: a usage error exits 2 in both packages;
  ``--num-devices 1`` trains the sharded model and serves data-parallel at
  one rank (the JAX package's info, shapes and, for ``predict``, the
  single-device dumps), ``--num-devices 2`` above the one-rank world raises
  ``make_mesh``'s ``ValueError``, while the ``covernet`` group, ``--recluster fused`` and
  ``condition-wasserstein --selection covernet`` write what JAX's CLI
  writes (the selection and the inducing state to 1e-12); without
  ``--device cpu`` and without a card the port fails with
  ``resolve_device``'s message and runs nothing on the CPU.
* ``sweep``: the expansion of every checked-in ``configs/*.toml`` is JAX's
  with the module renamed and ``--device`` for the platform; ``--dry-run``
  prints it; ``"tpu"`` is refused.
* ``uci-csv``: on the same ``results.json`` files both packages write
  ``results.csv`` and ``summary.csv`` that pandas reads back equal.
"""

import argparse
import json
from pathlib import Path

import click
import jax
import numpy as np
import pandas as pd
import pytest
import torch

from cggp_tpu.cli.__main__ import cli as jax_cli
from cggp_tpu.cli.sweep import expand_experiments as jax_expand
from cggp_tpu_torch.cli import sweep as tsweep
from cggp_tpu_torch.cli.__main__ import PROG, make_cli, main as port_main
from cggp_tpu_torch.cli.cli_utils import make_parser
from torch_cli_helpers import port_exit_code, restore_torch_default_dtype, run_jax, run_port  # noqa: F401,E501

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.toml"))


# ---------------------------------------------------------------------------
# The option table
# ---------------------------------------------------------------------------


def _click_default(param):
    default = param.default
    if default is None or "UNSET" in repr(default) or "Sentinel" in type(default).__name__:
        return None
    return list(default) if isinstance(default, (tuple, list)) else default


def click_table(cmd) -> dict:
    """``{"options": {strings: spec}, "arguments": [...], "children": {...}}``."""
    options, arguments = {}, []
    for p in cmd.params:
        if isinstance(p, click.Argument):
            arguments.append({"name": p.name, "variadic": p.nargs == -1,
                              "required": bool(p.required)})
            continue
        if "--help" in p.opts:
            continue
        strings = frozenset(p.opts) | frozenset(p.secondary_opts)
        options[strings] = {
            "default": _click_default(p),
            "choices": list(p.type.choices) if isinstance(p.type, click.Choice) else None,
            "required": bool(p.required),
            "multiple": bool(p.multiple),
            "flag": bool(p.is_flag),
            "pair": (tuple(sorted(p.opts)), tuple(sorted(p.secondary_opts)))
            if p.secondary_opts else None,
        }
    children = {name: click_table(c) for name, c in getattr(cmd, "commands", {}).items()}
    return {"options": options, "arguments": arguments, "children": children}


def argparse_table(parser: argparse.ArgumentParser) -> dict:
    by_dest, arguments, children = {}, [], {}
    for action in parser._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        if isinstance(action, argparse._SubParsersAction):
            children = {name: argparse_table(p) for name, p in action.choices.items()}
            continue
        if not action.option_strings:
            arguments.append({"name": action.dest.split(":", 1)[1], "variadic": action.nargs == "+",
                              "required": True})
            continue
        by_dest.setdefault(action.dest, []).append(action)
    options = {}
    for actions in by_dest.values():
        strings = frozenset(s for a in actions for s in a.option_strings)
        flag = all(isinstance(a, (argparse._StoreTrueAction, argparse._StoreFalseAction))
                   for a in actions)
        first = actions[0]
        default = first.default
        options[strings] = {
            "default": list(default) if isinstance(default, (tuple, list)) else default,
            "choices": list(first.choices) if first.choices is not None else None,
            "required": bool(first.required),
            "multiple": type(first).__name__ == "_Multiple",
            "flag": flag,
            "pair": (tuple(sorted(actions[0].option_strings)),
                     tuple(sorted(actions[1].option_strings))) if len(actions) == 2 else None,
        }
    return {"options": options, "arguments": arguments, "children": children}


def _compare(port: dict, jax: dict, path: str) -> None:
    assert sorted(port["children"]) == sorted(jax["children"]), path
    assert port["arguments"] == jax["arguments"], path
    port_opts = dict(port["options"])
    if path == "":
        device = port_opts.pop(frozenset({"--device"}))
        assert device["default"] == "cuda" and device["choices"] == ["cuda", "cpu"]
    assert set(port_opts) == set(jax["options"]), (path, set(port_opts) ^ set(jax["options"]))
    for strings, spec in jax["options"].items():
        assert port_opts[strings] == spec, (path, sorted(strings), port_opts[strings], spec)
    for name in jax["children"]:
        _compare(port["children"][name], jax["children"][name], f"{path} {name}")


def test_the_option_table_is_the_jax_clis():
    port = argparse_table(make_parser(make_cli(), PROG))
    jax = click_table(jax_cli)
    assert sorted(jax["children"]) == sorted(
        ["uci", "gpr", "geospatial", "train", "predict", "uci-csv", "uci-plot",
         "geospatial-csv", "condition-wasserstein", "sweep"])
    _compare(port, jax, "")
    # Three levels deep where click chains groups.
    assert "compute-metrics" in port["children"]["uci"]["children"]["covertree"]["children"]
    assert "train-adam" in port["children"]["geospatial"]["children"]["oips"]["children"]


def test_abbreviations_are_refused_as_click_refuses_them(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the default logdir is made before the refusal
    assert port_exit_code(["--device", "cpu", "gpr", "--num-iter", "3", "-d", "synthetic"]) == 2


# ---------------------------------------------------------------------------
# Refusals and exit codes
# ---------------------------------------------------------------------------


USAGE_ERRORS = [
    ["gpr", "-d", "synthetic"],  # missing required -n
    ["gpr", "-n", "2", "-d", "nosuchset"],  # a bad type
    ["gpr", "-n", "2", "-d", "synthetic", "-p", "fp16"],  # a bad float type
    ["gpr", "-n", "2", "-d", "synthetic", "-o", "bfgs"],  # a bad choice
    ["uci", "-mc", "cdgp", "-p", "fp64", "-j", "1e-6", "nosuchgroup"],
    ["gpr", "-n", "2", "-d", "synthetic", "--chunk-iterations", "4"],  # click.UsageError
    ["uci", "-mc", "cdgp-implicit", "-p", "fp64", "-j", "1e-6", "-P", "chol", "kmeans", "-m",
     "4", "compute-metrics"],  # click.UsageError in the group's callback
    ["sweep", "no-such-config.toml"],  # a path that must exist
]


@pytest.mark.parametrize("args", USAGE_ERRORS, ids=lambda a: "_".join(a[:1] + a[-2:]))
def test_a_usage_error_exits_2_in_both_packages(args, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run_jax(args, expect=2)
    assert port_exit_code(["--device", "cpu", *args]) == 2


def test_a_command_error_exits_1(tmp_path, monkeypatch):
    """click's ClickException (predict's refusal of a cache built for other
    parameters) is exit code 1 in the port."""
    monkeypatch.chdir(tmp_path)
    config = tmp_path / "cfg"
    run_port(["gpr", "-d", "synthetic:n=120:dim=2", "-n", 1, "-l", config])
    post = tmp_path / "post"
    run_port(["predict", "-c", config, "-mc", "gpr", "-l", tmp_path / "p1",
              "--posterior-dir", post])
    meta = json.loads((post / "cache_meta.json").read_text())
    (post / "cache_meta.json").write_text(json.dumps(dict(meta, fingerprint="0" * 16)))
    assert port_exit_code(["--device", "cpu", "predict", "-c", config, "-mc", "gpr", "-l",
                           tmp_path / "p2", "--posterior-dir", post]) == 1


NOT_PORTED = [
    (["uci", "-mc", "cdgp", "-p", "fp64", "-j", "1e-6", "-P", "chol", "-e", "1e-20", "-c", "cfg",
      "covernet", "-s", "0.5", "compute-metrics"], "item 10"),
    (["train", "-d", "synthetic:n=120:dim=2", "train-cggp-adam", "-n", "1", "-b", "16", "-c",
      "covernet", "--recluster", "fused", "--steps-per-call", "2", "--no-tensorboard"],
     "item 10"),
    (["train", "-d", "synthetic:n=120:dim=2", "train-cggp-adam", "-n", "1", "-b", "16",
      "--num-devices", "1"], "item 12"),
    (["condition-wasserstein", "-d", "1", "-r", "1.0", "-r", "0.5", "-n", "20", "--selection",
      "covernet"], "item 10"),
]


def _patch_condition_wasserstein_draws(monkeypatch, num_data, dim, seed=0):
    """The port's draws of ``condition-wasserstein`` return JAX's from
    ``split(PRNGKey(seed), 3)``."""
    import cggp_tpu_torch.cli.condition_wasserstein as tcw

    key_x, key_f, key_probe = jax.random.split(jax.random.PRNGKey(seed), 3)
    x = np.asarray(jax.random.uniform(key_x, (num_data, dim), dtype=np.float64, minval=-1.0,
                                      maxval=1.0))
    normals = [np.asarray(jax.random.normal(k, (num_data, 1), dtype=np.float64))
               for k in (key_f, key_probe)]
    monkeypatch.setattr(tcw, "uniform_draw",
                        lambda gen, shape, dtype: torch.as_tensor(x.copy(), dtype=dtype))
    monkeypatch.setattr(tcw, "normal_draw",
                        lambda gen, shape, dtype: torch.as_tensor(normals.pop(0).copy(),
                                                                  dtype=dtype))


@pytest.mark.parametrize("args,item", NOT_PORTED, ids=["uci_covernet", "train_fused",
                                                       "train_num_devices", "cw_covernet"])
def test_unported_paths_raise_naming_their_roadmap_item(args, item, tmp_path, monkeypatch):
    # Each path raised here naming its ROADMAP item before and is ported
    # now: the item-10 paths (the covernet group, --recluster fused,
    # --selection covernet) write what JAX's CLI writes; --num-devices
    # (item 12) trains ShardedCGGP at one rank (JAX's info and parameter
    # shapes) and refuses a mesh above the one-rank world.
    monkeypatch.chdir(tmp_path)
    if "cfg" in args:
        run_port(["gpr", "-d", "synthetic:n=120:dim=2", "-n", 1, "-l", tmp_path / "cfg"])
    if item == "item 12":
        with pytest.raises(ValueError, match="requested 2 devices"):
            port_main(["--device", "cpu", *args[:-1], "2"])
    if args[0] == "condition-wasserstein":
        _patch_condition_wasserstein_draws(monkeypatch, 20, 1)
    for run, name in ((run_jax, "jax"), (run_port, "port")):
        logdir = ["-l", tmp_path / name]
        # train's -l belongs to the group, before the command.
        run([*args[:3], *logdir, *args[3:]] if args[0] == "train" else [*args, *logdir])
    if args[0] == "uci":
        got, want = (json.loads(Path(tmp_path, d, "results.json").read_text())
                     for d in ("port", "jax"))
        assert got["clustering_type"] == "covernet" and got["num_inducing_points"] > 8
        assert list(got) == list(want)
        for key in want:
            if key in ("config_dir",):
                continue
            if key in ("test/rmse", "test/nlpd", "condition_number", "eig_min", "eig_max"):
                assert abs(got[key] - want[key]) <= 1e-6 * abs(want[key]), key
            elif key == "train/elbo":  # trace probes from each package's generator
                assert abs(got[key] - want[key]) <= 1e-2 * abs(want[key]), key
            else:
                assert got[key] == want[key], key
    elif args[0] == "train" and item == "item 12":
        info = {d: {k: v for k, v in json.loads(Path(tmp_path, d, "info.json").read_text())
                    .items() if k != "logdir"} for d in ("port", "jax")}
        assert info["port"] == info["jax"] and info["port"]["num_devices"] == 1
        got, want = (dict(np.load(Path(tmp_path, d, "params.npz"))) for d in ("port", "jax"))
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
        assert all(np.isfinite(v).all() for v in got.values())
    elif args[0] == "train":
        info = {d: {k: v for k, v in json.loads(Path(tmp_path, d, "info.json").read_text())
                    .items() if k != "logdir"} for d in ("port", "jax")}
        assert info["port"] == info["jax"] and info["port"]["recluster"] == "fused"
        got, want = (dict(np.load(Path(tmp_path, d, "params.npz"))) for d in ("port", "jax"))
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
        # One K = 2 call: the selection at its top reads the initial kernel
        # parameters, so the inducing state is JAX's.
        for name in want:
            if "kernel" not in name and "likelihood" not in name:
                np.testing.assert_allclose(got[name], want[name], rtol=1e-12, atol=1e-12,
                                           err_msg=name)
        assert got["inducing_mask"].sum() < info["port"]["capacity"]
    else:
        name = "condition_wasserstein_dim1_covernet.csv"
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port" / name),
                                      pd.read_csv(tmp_path / "jax" / name), rtol=1e-6)


def test_predict_num_devices_raises_naming_item_12(tmp_path, monkeypatch):
    """``predict --num-devices 1`` (item 12, ported) serves data-parallel at
    one rank: the dumps equal the single-device run's bitwise; 2 ranks
    above the one-rank world raise ``make_mesh``'s ValueError."""
    monkeypatch.chdir(tmp_path)
    run_port(["gpr", "-d", "synthetic:n=120:dim=2", "-n", 1, "-l", tmp_path / "cfg"])
    base = ["--device", "cpu", "predict", "-c", str(tmp_path / "cfg"), "-mc", "gpr", "-l"]
    port_main([*base, str(tmp_path / "p1")])
    port_main([*base, str(tmp_path / "p2"), "--num-devices", "1"])
    for name in ("train_mean.npy", "train_variances.npy", "test_mean.npy",
                 "test_variances.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "p2" / name),
                                      np.load(tmp_path / "p1" / name), err_msg=name)
    with pytest.raises(ValueError, match="requested 2 devices"):
        port_main([*base, str(tmp_path / "p3"), "--num-devices", "2"])


def test_without_a_card_the_default_device_fails_and_nothing_runs(tmp_path, monkeypatch,
                                                                  capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_exit_code(["gpr", "-d", "synthetic:n=120:dim=2", "-n", "1", "-l",
                           str(tmp_path / "gpr")]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device is available" in err and "--device cpu" in err
    assert not (tmp_path / "gpr" / "params.npz").exists()


def test_without_a_card_run_sweep_called_directly_fails(monkeypatch):
    """``condition_wasserstein.run_sweep`` is public: its default device is
    the card too, and it raises without one instead of running on the CPU."""
    from cggp_tpu_torch.cli.condition_wasserstein import run_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        run_sweep(1, 16, [0.5], 0.01, 0)


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------


def _jax_flags_platforms(config):
    platforms = config.get("flags", {}).get("platforms")
    return [platforms] if isinstance(platforms, str) else platforms


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_sweep_expansion_is_jaxs_with_the_two_translations(path):
    import tomllib

    config = tomllib.loads(path.read_text())
    jax_jobs = list(jax_expand(config))
    port_jobs = list(tsweep.expand_experiments(config))
    assert [j["uid"] for j in port_jobs] == [j["uid"] for j in jax_jobs]
    assert [j["values"] for j in port_jobs] == [j["values"] for j in jax_jobs]
    platforms = _jax_flags_platforms(config)
    want = []
    for i, job in enumerate(jax_jobs):
        cmd = job["cmd"].replace("python -m cggp_tpu.cli ", "python -m cggp_tpu_torch.cli ")
        if platforms:
            device = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}[platforms[i % len(platforms)]]
            cmd = cmd.replace("cggp_tpu_torch.cli ", f"cggp_tpu_torch.cli --device {device} ")
        want.append(cmd)
    assert tsweep.job_commands(config) == want
    assert all("cggp_tpu.cli" not in c for c in want)


def test_sweep_dry_run_prints_the_commands_and_refuses_tpu(capsys):
    config = ROOT / "configs" / "smoke-uci.toml"
    assert port_main(["sweep", str(config), "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "python -m cggp_tpu_torch.cli --device cpu gpr" in out
    assert "sweep finished:" in out and " 0 failed" in out
    assert port_exit_code(["sweep", str(config), "--dry-run", "--platform", "tpu"]) == 2
    assert tsweep.translate_command("echo cggp_tpu.clix") == "echo cggp_tpu.clix"
    assert tsweep.with_device("echo hello", "gpu") == "echo hello"


def test_sweep_runs_jobs_and_pins_cuda_visible_devices(tmp_path, capsys):
    config = {"cmd": "", "exp": [{"cmd": "python -c 'import os; open(\"{uid}\", \"w\")"
                                         ".write(os.environ[\"CUDA_VISIBLE_DEVICES\"])'",
                                  "uid": str(tmp_path / "job{i}"), "i": [0, 1]}],
              "flags": {"gpu_indices": [3, 5], "num_proc": 2}}
    assert tsweep.run_sweep(config) == [0, 0]
    assert (tmp_path / "job0").read_text() == "3" and (tmp_path / "job1").read_text() == "5"


# ---------------------------------------------------------------------------
# uci-csv
# ---------------------------------------------------------------------------


def _write_results(root: Path):
    rng = np.random.default_rng(0)
    runs = []
    for model in ("cdgp", "sgpr"):
        for precision in ("fp32", "fp64"):
            for seed in (0, 1, 2):
                m = 989 if seed < 2 else 1001
                runs.append({"seed": seed, "model": model, "dataset": "synthetic:n=435000:dim=3",
                             "jitter": 1e-06, "precision": precision, "jit": True,
                             "clustering_type": "covertree",
                             "clustering_args": {"spatial_resolution": 0.35},
                             "num_inducing_points": m,
                             "test/rmse": float(rng.uniform(0.1, 0.3)),
                             "test/nlpd": float(rng.normal()),
                             "train/elbo": float(rng.normal() * 1e5),
                             "condition_number": float(rng.uniform(1e3, 1e4)),
                             "condition_method": "exact" if seed else "lanczos",
                             "eig_min_is_upper_bound": seed == 0})
    runs.append({"model": "gpr", "dataset": "synthetic:n=435000:dim=3", "precision": "fp64",
                 "seed": 0, "jitter": None, "clustering_type": None, "test/rmse": 0.11,
                 "test/nlpd": -0.5, "train/lml": 12.5, "train/elbo": 12.5})
    for i, run in enumerate(runs):
        d = root / f"run{i:02d}"
        d.mkdir(parents=True)
        (d / "results.json").write_text(json.dumps(run, indent=2))


def test_uci_csv_writes_what_pandas_reads_as_jaxs(tmp_path, capsys):
    _write_results(tmp_path / "runs")
    jax_out = run_jax(["uci-csv", tmp_path / "runs", "-l", tmp_path / "jax"]).output
    assert port_main(["uci-csv", str(tmp_path / "runs"), "-l", str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    assert "WARNING: condition_number mixes estimators" in out
    got = pd.read_csv(tmp_path / "port" / "results.csv")
    want = pd.read_csv(tmp_path / "jax" / "results.csv")
    pd.testing.assert_frame_equal(got, want)
    assert (tmp_path / "port" / "results.csv").read_text() == \
        (tmp_path / "jax" / "results.csv").read_text()
    kw = dict(header=[0, 1], index_col=[0, 1, 2, 3, 4])
    got = pd.read_csv(tmp_path / "port" / "summary.csv", **kw)
    want = pd.read_csv(tmp_path / "jax" / "summary.csv", **kw)
    pd.testing.assert_frame_equal(got, want, rtol=1e-12)
    assert len(got) == 4 and "gpr" not in got.index.get_level_values(0)
    assert "(4 groups)" in jax_out and "(4 groups)" in out


def test_uci_plot_without_matplotlib_names_it(tmp_path, monkeypatch):
    """matplotlib is imported inside the command: without it ``uci-plot``
    fails naming it, and the rest of the CLI is untouched."""
    import sys

    runs = tmp_path / "runs" / "r0"
    runs.mkdir(parents=True)
    (runs / "results.json").write_text(json.dumps({"model": "cdgp", "test/rmse": 0.2,
                                                   "num_inducing_points": 8}))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        port_main(["uci-plot", str(tmp_path / "runs"), "-l", str(tmp_path / "out")])
