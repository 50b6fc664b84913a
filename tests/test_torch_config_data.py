"""Port parity for ``config.py`` (``Config``, ``default_config``,
``set_default_config``) and ``data.py``'s loaders: each loader of
``cggp_tpu_torch`` against ``cggp_tpu``'s on files the tests write under a
temporary ``CGGP_DATA_DIR`` (``.npz`` in both key layouts, Wilson's
``.mat`` through ``scipy.io.savemat``, ``.csv``, ``.txt``, the snelson and
east_africa files), arrays equal bitwise.  No data ships with the
repository, and the port's loaders open no network connection: the
snelson tests make ``urllib`` and ``socket`` fail if touched."""

import socket
import urllib.request

import numpy as np
import pytest
import scipy.io
import torch

from cggp_tpu import config as jconfig
from cggp_tpu import data as jdata
from cggp_tpu_torch import config as tconfig
from cggp_tpu_torch import data as tdata


def _assert_bundles_equal(got, want):
    assert got.name == want.name
    for got_split, want_split in ((got.train, want.train), (got.test, want.test)):
        for g, w in zip(got_split, want_split):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def _assert_splits_equal(got, want):
    for got_split, want_split in zip(got, want):
        for g, w in zip(got_split, want_split):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_config_defaults_updates_and_the_process_default(monkeypatch):
    cfg = tconfig.Config()
    jcfg = jconfig.Config()
    assert (cfg.dtype_name, cfg.jitter, cfg.positive_minimum) == \
        (jcfg.dtype_name, jcfg.jitter, jcfg.positive_minimum)
    assert cfg.dtype == torch.float64 and tconfig.Config("float32").dtype == torch.float32
    changed = cfg.with_updates(jitter=1e-4, positive_minimum=1e-9)
    assert changed == tconfig.Config("float64", 1e-4, 1e-9) and cfg.jitter == 1e-6
    with pytest.raises(Exception):  # frozen
        cfg.jitter = 1.0
    with pytest.raises(ValueError, match="dtype_name"):
        tconfig.Config("bfloat17").dtype
    monkeypatch.setattr(tconfig, "_DEFAULT", tconfig._DEFAULT)
    assert tconfig.default_config() == tconfig.Config()
    tconfig.set_default_config(changed)
    assert tconfig.default_config() is changed


def test_enable_x64_and_nan_checks(monkeypatch):
    before = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float32)
        tconfig.enable_x64_if_needed(tconfig.Config("float32"))
        assert torch.get_default_dtype() == torch.float32
        tconfig.enable_x64_if_needed(tconfig.Config())
        assert torch.get_default_dtype() == torch.float64
        assert tconfig.default_float() == torch.float64
    finally:
        torch.set_default_dtype(before)
    assert not torch.is_anomaly_enabled()
    try:
        tconfig.enable_nan_checks()
        assert torch.is_anomaly_enabled()
    finally:
        tconfig.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


def _table(rng, n=40, d=3):
    """A [n, d + 1] table of 17-digit values, the target last."""
    return rng.standard_normal((n, d + 1)) * np.array([1.0, 10.0, 0.1, 3.0])


LAYOUTS = ["npz_xy", "npz_data", "npz_nested", "mat_nested", "mat_flat", "mat_wilson",
           "mat_other_name", "csv_nested", "csv_flat", "txt"]


def _write_uci(root, name, layout, table):
    base = root / "uci"
    (base / name).mkdir(parents=True, exist_ok=True)
    if layout == "npz_xy":
        np.savez(base / f"{name}.npz", X=table[:, :-1], Y=table[:, -1])  # Y [N]: made [N, 1]
    elif layout == "npz_data":
        np.savez(base / f"{name}.npz", data=table)
    elif layout == "npz_nested":
        np.savez(base / name / f"{name}.npz", X=table[:, :-1], Y=table[:, -1:])
    elif layout == "mat_nested":
        scipy.io.savemat(base / name / f"{name}.mat", {"data": table})
    elif layout == "mat_flat":
        scipy.io.savemat(base / f"{name}.mat", {"data": table})
    elif layout == "mat_wilson":
        (base / f"wilson_{name}").mkdir()
        scipy.io.savemat(base / f"wilson_{name}" / f"{name}.mat", {"data": table})
    elif layout == "mat_other_name":
        scipy.io.savemat(base / name / f"{name}.mat", {"table": table})
    elif layout == "csv_nested":
        np.savetxt(base / name / "data.csv", table, delimiter=",", fmt="%.17g")
    elif layout == "csv_flat":
        np.savetxt(base / f"{name}.csv", table, delimiter=",", fmt="%.17g")
    else:
        np.savetxt(base / name / "data.txt", table, fmt="%.17g")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_uci_loader_layouts_match_jax(tmp_path, monkeypatch, layout):
    monkeypatch.setenv("CGGP_DATA_DIR", str(tmp_path))
    table = _table(np.random.default_rng(LAYOUTS.index(layout)))
    _write_uci(tmp_path, "elevators", layout, table)
    source = tdata._uci_source("elevators")
    assert source == jdata._uci_source("elevators") and source is not None
    x, y = tdata._read_uci_arrays(source)
    np.testing.assert_array_equal(x, table[:, :-1])
    np.testing.assert_array_equal(y, table[:, -1:])
    assert tdata.available_uci_datasets() == jdata.available_uci_datasets() == ("elevators",)
    for seed in (0, 3):
        _assert_splits_equal(tdata.uci("elevators", seed=seed), jdata.uci("elevators", seed=seed))
    _assert_bundles_equal(tdata.load_data("elevators", seed=1),
                          jdata.load_data("elevators", seed=1))


def test_uci_loader_refusals(tmp_path, monkeypatch):
    monkeypatch.setenv("CGGP_DATA_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="power"):
        tdata.uci("power")
    assert tdata.available_uci_datasets() == ()
    (tmp_path / "uci" / "pol").mkdir(parents=True)
    scipy.io.savemat(tmp_path / "uci" / "pol" / "pol.mat", {"a": np.ones((3, 2)),
                                                             "b": np.ones((3, 2))})
    with pytest.raises(ValueError, match="'data' array"):
        tdata.uci("pol")
    with pytest.raises(ValueError, match="Unknown dataset"):
        tdata.load_data("mnist")
    with pytest.raises(ValueError, match="unrecognised"):
        tdata._read_uci_arrays(tmp_path / "x.json")


def test_norm_dataset_load_data_and_cast_bundle_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("CGGP_DATA_DIR", str(tmp_path))
    table = _table(np.random.default_rng(11), n=57)
    _write_uci(tmp_path, "bike", "npz_data", table)
    data = (table[:, :-1], table[:, -1:])
    for got, want in zip(tdata.norm_dataset(data), jdata.norm_dataset(data)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for kwargs in ({}, {"normalise": False}, {"seed": 2, "dtype": np.float32}):
        got, want = tdata.load_data("bike", **kwargs), jdata.load_data("bike", **kwargs)
        _assert_bundles_equal(got, want)
    bundle = tdata.load_data("bike")
    # Test columns are normalised by the training split's statistics.
    (x_tr, _), (x_te, _) = tdata.uci("bike")
    _, mu, std = tdata.norm(x_tr)
    np.testing.assert_array_equal(bundle.test[0], (x_te - mu) / std)
    assert abs(float(bundle.train[0].mean())) < 1e-12
    _assert_bundles_equal(tdata.cast_bundle(bundle, np.float32),
                          jdata.cast_bundle(jdata.load_data("bike"), np.float32))
    for name, kwargs in (("synthetic", {"synthetic_n": 300, "synthetic_dim": 3}),
                         ("synthetic1d", {"synthetic_n": 120})):
        _assert_bundles_equal(tdata.load_data(name, seed=4, **kwargs),
                              jdata.load_data(name, seed=4, **kwargs))


@pytest.mark.parametrize("fmt", ["%.6f", "%.17g"])
def test_east_africa_matches_jax(tmp_path, monkeypatch, fmt):
    """Six-decimal values parse alike in both packages, so the splits are
    held bitwise.  At 17 digits the port (numpy's correctly rounded parser)
    reads back the written values exactly, while the JAX package reads
    through pandas' ``read_csv``, whose default parser lands 1-2 ulp off on
    about a quarter of such values (measured): held at 2 ulp there."""
    monkeypatch.setenv("CGGP_DATA_DIR", str(tmp_path))
    rng = np.random.default_rng(5)
    folder = tmp_path / "east_africa"
    folder.mkdir()
    tables = []
    for split, n in (("train", 31), ("test", 17)):
        table = rng.standard_normal((n, 4)) * 50.0
        np.savetxt(folder / f"east_africa_{split}.csv", table, delimiter=",", fmt=fmt,
                   header="lon,lat,elev,target", comments="")
        tables.append(table)
    stacked = np.concatenate(tables)
    for seed in (0, 1):
        got, want = tdata.east_africa(seed=seed), jdata.east_africa(seed=seed)
        if fmt == "%.6f":
            _assert_splits_equal(got, want)
            continue
        (x_tr, y_tr), _ = got
        ind = np.random.RandomState(seed).permutation(len(stacked))[:len(x_tr)]
        np.testing.assert_array_equal(np.concatenate([x_tr, y_tr], 1), stacked[ind])
        for got_split, want_split in zip(got, want):
            for g, w in zip(got_split, want_split):
                np.testing.assert_array_max_ulp(g, w, maxulp=2)
    if fmt == "%.6f":
        _assert_bundles_equal(tdata.load_data("east_africa"), jdata.load_data("east_africa"))
    with pytest.raises(FileNotFoundError, match="east_africa_train.csv"):
        tdata.east_africa(dirpath=str(tmp_path / "elsewhere"))


@pytest.fixture
def no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the network was touched")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setattr(socket, "socket", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(socket, "getaddrinfo", refuse)


def test_snelson_from_cached_files_matches_jax(tmp_path, monkeypatch, no_network):
    monkeypatch.setenv("CGGP_DATA_DIR", str(tmp_path))
    folder = tmp_path / "snelson1d"
    folder.mkdir()
    rng = np.random.default_rng(9)
    np.savetxt(folder / "snelson_train_inputs", np.sort(rng.uniform(0, 6, 200)), fmt="%.17g")
    np.savetxt(folder / "snelson_train_outputs", rng.standard_normal(200), fmt="%.17g")
    got, want = tdata.snelson1d(), jdata.snelson1d(allow_download=False)
    _assert_splits_equal(got, want)
    assert got[0][0].shape == (200, 1)
    _assert_bundles_equal(tdata.load_data("snelson1d"), jdata.load_data("snelson1d"))


@pytest.mark.parametrize("allow_download_env", [None, "1"])
def test_snelson_download_path_raises_without_the_network(tmp_path, monkeypatch, no_network,
                                                          allow_download_env):
    """A missing file raises, naming it, with or without the JAX package's
    download switch set; nothing is written."""
    monkeypatch.setenv("CGGP_DATA_DIR", str(tmp_path))
    if allow_download_env is not None:
        monkeypatch.setenv("CGGP_ALLOW_DOWNLOAD", allow_download_env)
    with pytest.raises(FileNotFoundError, match="snelson_train_inputs") as info:
        tdata.snelson1d()
    assert "does not download" in str(info.value)
    assert not (tmp_path / "snelson1d").exists()
    with pytest.raises(FileNotFoundError, match="elsewhere"):
        tdata.snelson1d(target_dir=str(tmp_path / "elsewhere"))
