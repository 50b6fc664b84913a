"""The benchmark's own inputs.

Everything here is plain NumPy or plain torch and independent of the
program under test.  The data set and its inducing set (centres,
pseudo-observations, cluster counts) belong to the configuration: made
from the configuration's own data seed, the same in every run, and kept
after the first run of a checkout under ``gpbench/_cache/inputs/``.  What
``--seed`` draws: the order of the training batches, the probe
generator's seed and the serving requests.  The initial parameters are the
configuration's.  The program and the
reference get the same arrays.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
from pathlib import Path
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

SPLIT_PROPORTION = 0.67
# Sub-streams of one --seed, each drawn from its own word of a SeedSequence;
# the first word is left unused, so that each stream keeps its word.
STREAMS = ("unused", "batches", "probes", "requests", "sample")
# The seed of the fixed pool of training batches (batch_stream).
POOL_SEED = 0
CACHE_DIR = Path(__file__).resolve().parent / "_cache" / "inputs"
# Rows of the float64 distance blocks of the cluster assignment: small
# enough that the benchmark's own set-up never sets the memory peak.
ASSIGN_ELEMENTS = 1 << 21


def seeds_of(seed: int) -> Dict[str, int]:
    """One 32-bit seed per input stream from any non-negative ``seed``."""
    words = np.random.SeedSequence(int(seed)).generate_state(len(STREAMS), dtype=np.uint32)
    return {name: int(w) for name, w in zip(STREAMS, words)}


def synthetic(n: int, dim: int, seed: int, noise: float = 0.1,
              prop: float = SPLIT_PROPORTION):
    """A frozen copy of the program's ``data.synthetic``: a fixed
    random-Fourier function of uniform inputs on ``[-2, 2]^dim`` plus
    Gaussian noise, split by a seeded shuffle; ``((x_train, y_train),
    (x_test, y_test))`` in float64."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-2.0, 2.0, size=(n, dim))
    w_rng = np.random.RandomState(12345)  # the function is fixed across seeds
    num_features = 32
    theta = w_rng.normal(size=(dim, num_features)) * 1.5
    weights = w_rng.normal(size=(2 * num_features,)) / np.sqrt(num_features)
    phi = np.concatenate([np.cos(x @ theta), np.sin(x @ theta)], axis=-1)
    y = (phi @ weights)[:, None] + noise * rng.standard_normal((n, 1))
    ind = np.arange(n)
    np.random.RandomState(seed).shuffle(ind)
    n_train = int(np.floor(prop * n))
    tr, te = ind[:n_train], ind[n_train:]
    return (x[tr], y[tr]), (x[te], y[te])


def _cell_order(cells: np.ndarray, dims: np.ndarray):
    """Flat cell ids and, per point, the rank of the point inside its cell
    (points in index order)."""
    flat = np.ravel_multi_index(cells.T, dims)
    order = np.argsort(flat, kind="stable")
    sorted_flat = flat[order]
    starts = np.flatnonzero(np.r_[True, sorted_flat[1:] != sorted_flat[:-1]])
    run = np.repeat(starts, np.diff(np.r_[starts, len(flat)]))
    rank = np.empty_like(order)
    rank[order] = np.arange(len(flat)) - run
    return flat, rank


def min_separation_select(x: np.ndarray, resolution: float) -> np.ndarray:
    """Indices of a greedy minimum-separation set of ``x`` [N, D]: every
    two chosen points lie more than ``resolution`` apart and every point
    lies within ``resolution`` of a chosen one.

    The greedy visits the points in a fixed order, accepting a point that
    is more than ``resolution`` from every point accepted before it.  The
    order: the grid of cells of side ``resolution`` is split into ``3^D``
    colours by cell coordinate modulo 3, then colour by colour, the j-th
    point (in index order) of every cell of the colour, j = 0, 1, ...
    Cells of one colour are two cells apart, so the points of one (colour,
    j) step cannot conflict and are decided together; the result is that
    of the sequential greedy in this order (``greedy_select_plain``)."""
    n, d = x.shape
    lo = x.min(axis=0)
    cells = np.floor((x - lo) / resolution).astype(np.int64) + 1  # a border of empty cells
    dims = cells.max(axis=0) + 2
    flat, rank = _cell_order(cells, dims)
    colour = np.ravel_multi_index((cells % 3).T, (3,) * d)
    slots = 2 ** d  # points more than a cell side apart in one cell: at most 2^D
    centres = np.full((int(np.prod(dims)), slots, d), np.inf)
    filled = np.zeros(int(np.prod(dims)), dtype=np.int64)
    offsets = np.array(list(itertools.product((-1, 0, 1), repeat=d)))
    neighbour_shift = np.ravel_multi_index(offsets.T + 1, dims) - np.ravel_multi_index(
        np.ones(d, dtype=np.int64), dims)
    r2 = resolution * resolution
    chosen = []
    by_key = np.lexsort((flat, rank, colour))  # colour, then rank, then cell
    key_c, key_r = colour[by_key], rank[by_key]
    bounds = np.flatnonzero(np.r_[True, (key_c[1:] != key_c[:-1]) | (key_r[1:] != key_r[:-1]),
                                  True])
    for a, b in zip(bounds[:-1], bounds[1:]):
        idx = by_key[a:b]
        near = centres[flat[idx][:, None] + neighbour_shift[None, :]]  # [B, 3^D, slots, D]
        gap = np.min(np.sum((near - x[idx][:, None, None, :]) ** 2, axis=-1), axis=(1, 2))
        take = idx[gap > r2]
        if take.size:
            cell = flat[take]
            centres[cell, filled[cell]] = x[take]
            filled[cell] += 1
            chosen.append(take)
    return np.sort(np.concatenate(chosen)) if chosen else np.zeros(0, dtype=np.int64)


def greedy_select_plain(x: np.ndarray, resolution: float) -> np.ndarray:
    """The sequential greedy of :func:`min_separation_select`, one point at
    a time against every accepted point (a check at small N)."""
    n, d = x.shape
    lo = x.min(axis=0)
    cells = np.floor((x - lo) / resolution).astype(np.int64) + 1
    dims = cells.max(axis=0) + 2
    flat, rank = _cell_order(cells, dims)
    colour = np.ravel_multi_index((cells % 3).T, (3,) * d)
    accepted = []
    for i in np.lexsort((flat, rank, colour)):
        if all(np.sum((x[i] - x[j]) ** 2) > resolution ** 2 for j in accepted):
            accepted.append(i)
    return np.sort(np.array(accepted, dtype=np.int64))


def assign_clusters(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                    block: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster means of ``y`` and counts over the nearest point of ``z``
    (float64 distances, in row blocks); ``(u [M, 1], counts [M, 1])``."""
    m = z.shape[0]
    block = block or max(1, ASSIGN_ELEMENTS // m)
    z64 = z.double()
    z2 = torch.sum(z64 * z64, dim=1)
    nearest = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], block):
        xb = x[s:s + block].double()
        d2 = torch.sum(xb * xb, dim=1, keepdim=True) + z2[None, :] - 2.0 * (xb @ z64.T)
        nearest[s:s + block] = torch.argmin(d2, dim=1)
    counts = torch.bincount(nearest, minlength=m).double()
    sums = torch.zeros(m, dtype=torch.float64, device=x.device).index_add_(
        0, nearest, y[:, 0].double())
    return (sums / counts)[:, None], counts[:, None]


def dataset(cfg: Dict, data_n=None, resolution=None, cache: bool = True) -> Dict:
    """The configuration's data split and inducing set as float64 / int64
    NumPy arrays: ``x``, ``y``, ``x_test``, ``z``, ``u``, ``counts``.  Kept
    in ``CACHE_DIR`` under a key of the data and selection settings (the
    file is written whole, then renamed into place)."""
    data = cfg["data"]
    n = int(data_n or data["n"])
    res = float(resolution or cfg["selection"]["resolution"])
    spec = {"n": n, "dim": int(data["dim"]), "seed": int(data["seed"]),
            "noise": float(data["noise"]), "resolution": res, "version": 1}
    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]
    path = CACHE_DIR / f"{cfg['name']}-{key}.npz"
    if cache and path.is_file():
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    (x_tr, y_tr), (x_te, _) = synthetic(n, spec["dim"], spec["seed"], spec["noise"])
    z = x_tr[min_separation_select(x_tr, res)]
    u, counts = assign_clusters(torch.as_tensor(x_tr), torch.as_tensor(y_tr),
                                torch.as_tensor(z))
    out = {"x": x_tr, "y": y_tr, "x_test": x_te, "z": z, "u": u.numpy(),
           "counts": counts.numpy(), "resolution": np.float64(res)}
    if cache:
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        partial = path.with_suffix(f".{os.getpid()}.partial.npz")
        np.savez(partial, **out)
        os.replace(partial, path)
    return out


class Inputs:
    """A cell's inputs on ``device``: float32 data and selection, the
    initial constrained parameters (the configuration's ``init``: lengthscales
one value a dimension, or one for all), and the sub-seeds of ``seed``.  ``cfg`` is a
    configuration file's dict; ``data_n`` and ``resolution`` override its
    sizes (the CPU tests), and then nothing is cached."""

    def __init__(self, cfg: Dict, seed: int, device: torch.device, data_n=None,
                 resolution=None):
        self.seeds = seeds_of(seed)
        self.device = device
        arrays = dataset(cfg, data_n, resolution, cache=data_n is None and resolution is None)

        def on_device(name):
            return torch.as_tensor(arrays[name], dtype=torch.float32, device=device)

        self.x, self.y, self.x_test = on_device("x"), on_device("y"), on_device("x_test")
        self.z, self.u, self.counts = on_device("z"), on_device("u"), on_device("counts")
        self.resolution = float(arrays["resolution"])
        init = cfg["init"]
        self.kernel_variance = np.float32(init["kernel_variance"])
        self.lengthscales = np.broadcast_to(np.asarray(init["lengthscales"], np.float32),
                                            (int(cfg["data"]["dim"]),)).copy()
        self.noise_variance = np.float32(init["noise_variance"])

    @property
    def m(self) -> int:
        return int(self.z.shape[0])


def batch_stream(n: int, batch: int, pool: int, seed: int,
                 device: torch.device) -> Iterator[torch.Tensor]:
    """Batch indices, one [batch] tensor a step, from a fixed pool of
    ``pool`` disjoint batches (consecutive slices of a permutation of
    ``range(n)`` drawn from ``POOL_SEED``): every pass visits the whole pool
    in an order drawn from ``seed``, so every seed does the same work in
    another order, and the rows of steps in one pass all differ."""
    if pool * batch > n:
        raise ValueError(f"a pool of {pool} batches of {batch} needs {pool * batch} rows, "
                         f"the data has {n}")
    perm = torch.as_tensor(np.random.default_rng(POOL_SEED).permutation(n)[:pool * batch],
                           device=device)
    batches = perm.reshape(pool, batch)
    rng = np.random.default_rng(seed)
    while True:
        for i in rng.permutation(pool):
            yield batches[int(i)]


def take_steps(stream: Iterator[torch.Tensor], k: int) -> torch.Tensor:
    """The next ``k`` steps' indices as a [k, batch] tensor."""
    return torch.stack([next(stream) for _ in range(k)])


def request_sizes(sizes: Dict, seed: int) -> Iterator[int]:
    """Request sizes: a fixed log-uniform grid of ``count`` sizes over
    ``[low, high]``, each pass through it in an order drawn from ``seed``,
    so every seed serves the same multiset of sizes."""
    grid = np.unique(np.round(np.exp(np.linspace(np.log(sizes["low"]), np.log(sizes["high"]),
                                                 int(sizes["count"])))).astype(np.int64))
    rng = np.random.default_rng(seed)
    while True:
        for s in rng.permutation(grid):
            yield int(s)
