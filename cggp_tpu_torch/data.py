"""Synthetic regression data (port of ``cggp_tpu/data.py``: ``synthetic`` and
its split).  A numpy copy: the same seeds give the same arrays as the JAX
package's ``synthetic``."""

from __future__ import annotations

from typing import Tuple

import numpy as np

Dataset = Tuple[np.ndarray, np.ndarray]

SPLIT_PROPORTION = 0.67


def _split(x: np.ndarray, y: np.ndarray, prop: float, seed: int) -> Tuple[Dataset, Dataset]:
    """Shuffled prop-split with a seeded RandomState."""
    n = x.shape[0]
    ind = np.arange(n)
    rng = np.random.RandomState(seed)
    rng.shuffle(ind)
    n_train = int(np.floor(prop * n))
    tr, te = ind[:n_train], ind[n_train:]
    return (x[tr], y[tr]), (x[te], y[te])


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
