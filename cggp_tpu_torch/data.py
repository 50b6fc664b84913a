"""Dataset loading, splits and normalisation (port of ``cggp_tpu/data.py``).

A numpy copy of the JAX package's loaders: the same dataset names, split
proportion (0.67), seeded splits and per-column normalisation, so the same
files and seeds give the same arrays.  Datasets are read from a local data
directory (``$CGGP_DATA_DIR``, default ``~/.datasets``):

* UCI sets under ``uci/`` in any of the JAX package's layouts
  (:func:`_uci_source`): ``{name}.npz`` with ``X``/``Y`` arrays or a
  Wilson-style ``data`` array, Wilson's ``{name}.mat``, headerless
  ``data.csv`` / ``{name}.csv`` / ``data.txt``; the target is the last
  column of a ``data`` array.
* ``snelson1d/snelson_train_inputs`` and ``snelson_train_outputs``.
* ``east_africa/east_africa_{train,test}.csv`` (one header line).

The port never downloads: a missing file raises ``FileNotFoundError``
naming the files it expected, where the JAX package's ``snelson1d`` can
fetch its archive.  ``synthetic`` datasets are made in memory.
"""

from __future__ import annotations

import os
from collections import namedtuple
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

Dataset = Tuple[np.ndarray, np.ndarray]
DatasetBundle = namedtuple("DatasetBundle", "name, train, test")

SPLIT_PROPORTION = 0.67

# The reference's dataset names plus the synthetic family.
DATASET_NAMES = [
    "snelson1d",
    "power",
    "naval",
    "elevators",
    "bike",
    "pol",
    "houseelectric",
    "3droad",
    "buzz",
    "keggdirected",
    "keggundirected",
    "song",
    "east_africa",
    "synthetic1d",
    "synthetic",
]


def data_dir() -> Path:
    return Path(os.environ.get("CGGP_DATA_DIR", "~/.datasets")).expanduser()


def norm(x: np.ndarray):
    """Zero mean and unit standard deviation per column, 1e-6 added to the
    standard deviation; returns ``(normalised, mean, std)``."""
    mu = np.mean(x, axis=0, keepdims=True)
    std = np.std(x, axis=0, keepdims=True) + 1e-6
    return (x - mu) / std, mu, std


def norm_dataset(data: Dataset):
    return norm(data[0]), norm(data[1])


def _split(x: np.ndarray, y: np.ndarray, prop: float, seed: int) -> Tuple[Dataset, Dataset]:
    """Shuffled prop-split with a seeded RandomState (the bayesian_benchmarks
    convention): the first ``int(prop * n)`` shuffled rows train."""
    n = x.shape[0]
    ind = np.arange(n)
    rng = np.random.RandomState(seed)
    rng.shuffle(ind)
    n_train = int(np.floor(prop * n))
    tr, te = ind[:n_train], ind[n_train:]
    return (x[tr], y[tr]), (x[te], y[te])


def snelson1d(target_dir: Optional[str] = None) -> Tuple[Dataset, Dataset]:
    """Snelson's 200-point 1-D set from its cached files (under
    ``target_dir``, default ``{data_dir}/snelson1d``); train and test are
    the same arrays.  The port opens no network connection: a missing file
    raises ``FileNotFoundError`` (the JAX package's ``allow_download`` /
    ``CGGP_ALLOW_DOWNLOAD`` fetch is not ported)."""
    target = Path(target_dir) if target_dir else data_dir() / "snelson1d"
    inputs_path = target / "snelson_train_inputs"
    outputs_path = target / "snelson_train_outputs"
    missing = [str(p) for p in (inputs_path, outputs_path) if not p.exists()]
    if missing:
        raise FileNotFoundError(
            f"snelson1d data not found: {', '.join(missing)}. Place train_inputs and "
            "train_outputs from SPGP_dist.zip (gatsby.ucl.ac.uk/~snelson) there as "
            "snelson_train_inputs / snelson_train_outputs; cggp_tpu_torch does not "
            "download data.")
    x = np.loadtxt(inputs_path)[:, None]
    y = np.loadtxt(outputs_path)[:, None]
    return (x, y), (x, y)


def _read_csv_with_header(path: Path) -> np.ndarray:
    """The numeric body of a comma-separated file with one header line."""
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


def east_africa(dirpath: Optional[str] = None, train_proportion: float = 0.7,
                seed: int = 0) -> Tuple[Dataset, Dataset]:
    """The geospatial train and test CSVs stacked and re-split 70/30 by
    ``seed``; the target is the last column.  numpy parses the values
    (correctly rounded); the JAX package's ``pandas.read_csv`` lands 1-2 ulp
    off on some 17-digit values."""
    dirpath = Path(dirpath) if dirpath else data_dir() / "east_africa"
    frames = []
    for split_name in ("train", "test"):
        path = Path(dirpath, f"east_africa_{split_name}.csv")
        if not path.exists():
            raise FileNotFoundError(f"east_africa data not found: {path}. Place "
                                    "east_africa_train.csv / east_africa_test.csv there.")
        frames.append(_read_csv_with_header(path))
    stacked = np.concatenate(frames, axis=0)
    x, y = stacked[:, :-1], stacked[:, -1:]
    return _split(x, y, train_proportion, seed)


def _uci_source(name: str) -> Optional[Path]:
    """The first existing file of a UCI set among the accepted layouts."""
    base = data_dir() / "uci"
    for candidate in (
        base / f"{name}.npz",
        base / name / f"{name}.npz",
        base / name / f"{name}.mat",
        base / f"{name}.mat",
        base / f"wilson_{name}" / f"{name}.mat",
        base / f"Wilson_{name}" / f"{name}.mat",
        base / name / "data.csv",
        base / f"{name}.csv",
        base / name / "data.txt",
    ):
        if candidate.exists():
            return candidate
    return None


def _read_uci_arrays(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """``(X, Y)`` from any accepted file (see :func:`_uci_source`)."""
    if path.suffix == ".npz":
        with np.load(path) as blob:
            if "X" in blob and "Y" in blob:
                x = np.asarray(blob["X"], np.float64)
                y = np.asarray(blob["Y"], np.float64)
                return x, y if y.ndim > 1 else y[:, None]
            data = np.asarray(blob["data"], np.float64)  # Wilson-style blob
    elif path.suffix == ".mat":
        from scipy.io import loadmat

        blob = loadmat(str(path))
        if "data" in blob:
            data = np.asarray(blob["data"], np.float64)
        else:  # a single differently-named array
            arrays = [v for k, v in blob.items() if not k.startswith("__") and hasattr(v, "ndim")]
            if len(arrays) != 1:
                raise ValueError(
                    f"{path}: expected a 'data' array (Wilson .mat format); found keys "
                    f"{sorted(k for k in blob if not k.startswith('__'))}")
            data = np.asarray(arrays[0], np.float64)
    elif path.suffix in (".csv", ".txt"):
        delimiter = "," if path.suffix == ".csv" else None
        data = np.asarray(np.loadtxt(path, delimiter=delimiter), np.float64)
    else:
        raise ValueError(f"unrecognised UCI data file: {path}")
    return data[:, :-1], data[:, -1:]  # Wilson's convention: the target is last


def available_uci_datasets() -> Tuple[str, ...]:
    """The UCI sets with a file present in any accepted layout."""
    skip = {"snelson1d", "east_africa", "synthetic1d", "synthetic"}
    return tuple(n for n in DATASET_NAMES if n not in skip and _uci_source(n) is not None)


def uci(name: str, seed: int = 0, prop: float = SPLIT_PROPORTION) -> Tuple[Dataset, Dataset]:
    """A UCI regression set from ``{data_dir}/uci/``, split by
    :func:`_split` with the split index as its seed."""
    path = _uci_source(name)
    if path is None:
        raise FileNotFoundError(
            f"UCI dataset {name!r} not found under {data_dir() / 'uci'}. Accepted layouts: "
            f"{name}.npz (arrays 'X' [N, D], 'Y' [N, 1]), the bayesian_benchmarks extraction "
            f"{name}/{name}.mat ('data' array, target = last column), or headerless "
            "data.csv/.txt.")
    x, y = _read_uci_arrays(path)
    return _split(x, y, prop, seed)


def synthetic(
    n: int = 2000, dim: int = 2, seed: int = 0, noise: float = 0.1,
    prop: float = SPLIT_PROPORTION,
) -> Tuple[Dataset, Dataset]:
    """Deterministic GP-flavoured regression problem: a fixed random-Fourier
    function of uniform inputs on ``[-2, 2]^dim`` plus Gaussian noise,
    returned as ``((x_train, y_train), (x_test, y_test))``."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-2.0, 2.0, size=(n, dim))
    w_rng = np.random.RandomState(12345)  # the function is fixed across seeds
    num_features = 32
    theta = w_rng.normal(size=(dim, num_features)) * 1.5
    weights = w_rng.normal(size=(2 * num_features,)) / np.sqrt(num_features)
    phi = np.concatenate([np.cos(x @ theta), np.sin(x @ theta)], axis=-1)
    y = (phi @ weights)[:, None] + noise * rng.standard_normal((n, 1))
    return _split(x, y, prop, seed)


def load_data(name: str, normalise: bool = True, seed: int = 0, dtype=np.float64,
              synthetic_n: int = 2000, synthetic_dim: int = 2) -> DatasetBundle:
    """Name-dispatched loader: with ``normalise`` the test columns are
    normalised by the training split's statistics."""
    if name == "snelson1d":
        train, test = snelson1d()
    elif name == "east_africa":
        train, test = east_africa(train_proportion=0.7, seed=seed)
    elif name == "synthetic1d":
        train, test = synthetic(n=synthetic_n, dim=1, seed=seed)
    elif name == "synthetic":
        train, test = synthetic(n=synthetic_n, dim=synthetic_dim, seed=seed)
    elif name in DATASET_NAMES:
        train, test = uci(name, seed=seed)
    else:
        raise ValueError(f"Unknown dataset {name!r}; choose from {DATASET_NAMES}")

    if normalise:
        (x_train, x_mu, x_std), (y_train, y_mu, y_std) = norm_dataset(train)
        x_test = (test[0] - x_mu) / x_std
        y_test = (test[1] - y_mu) / y_std
    else:
        (x_train, y_train), (x_test, y_test) = train, test
    return DatasetBundle(name, (np.asarray(x_train, dtype), np.asarray(y_train, dtype)),
                         (np.asarray(x_test, dtype), np.asarray(y_test, dtype)))


def cast_bundle(bundle: DatasetBundle, dtype) -> DatasetBundle:
    """Every array of ``bundle`` cast to ``dtype``."""
    def cast(split):
        return tuple(np.asarray(a, dtype=dtype) for a in split)

    return DatasetBundle(bundle.name, cast(bundle.train), cast(bundle.test))
