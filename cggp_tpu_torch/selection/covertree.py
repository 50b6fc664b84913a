"""Cover-tree inducing-point selection with a minimum-separation guarantee
(port of ``cggp_tpu/selection/covertree.py``).

Host numpy in fp64, run once per inducing-point update, as in the JAX
package: it never sits inside a training step.

* The root sits at the data mean with ``max_radius`` the largest distance to
  it; ``spatial_resolution`` fixes ``num_levels = ceil(log2(max_radius /
  res)) + 1`` and snaps ``max_radius = res * 2^(num_levels - 1)``.
* Each level halves the radius; a new centre is seeded from the first
  still-uncovered point in parent-major order; with ``lloyds=True`` the seed
  is replaced by the mean of its uncovered radius-neighbourhood unless that
  mean breaks the minimum separation from the centres already placed.
* With ``voronoi=True`` every point is re-assigned to its nearest centre at
  each level.

Backends:

* ``"native"``: the multithreaded C++ construction ``csrc/covertree.cc``, built at
  first use (:mod:`cggp_tpu_torch.selection.native`); raises if it cannot be
  built.  ``"auto"`` uses it where it builds and otherwise warns and falls
  back to ``"numpy"``.
* ``"numpy"``: the same construction vectorised in numpy, claiming coverage
  globally (the trees keep the two properties used downstream: centres at
  least ``radius`` apart, and with Voronoi the clusters are the centres'
  Voronoi cells).
* ``"reference"``: node-for-node the reference algorithm with its per-node
  ``r_neighbors`` locality lists; slower, for reproducing its exact sets.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, List, Optional, Tuple

import numpy as np

from cggp_tpu_torch.selection.native import covertree_build_native


class CoverTree:
    """Hierarchical cover tree over ``data = (x, y)`` numpy arrays."""

    def __init__(
        self,
        distance: Optional[Callable],
        data: Tuple[np.ndarray, np.ndarray],
        spatial_resolution: Optional[float] = None,
        num_levels: int = 1,
        lloyds: bool = True,
        voronoi: bool = True,
        backend: str = "auto",
        plotting: bool = False,
    ):
        """``plotting=True`` records per-level coverage diagnostics
        (reference covertree.py:34,61-62,116-117 keeps per-node data
        snapshots for its playground plots): ``self.plotting_data[level]``
        is a dict with ``centers`` [M_l, D], ``radius`` (float), and
        ``labels`` [N] — the PRE-Voronoi claim labels, so each node's
        claimed point set (all within ``radius`` of its center) can be
        recovered.  Forces the numpy backend (the native code does not
        export per-level assignments)."""
        if distance is not None:
            # Parity with the reference, which ignores the distance argument
            # and forces the Euclidean norm (covertree.py:36-47).
            warnings.warn(
                "Distance function is ignored; Euclidean distance is used "
                "(matches reference covertree.py:36-47)."
            )

        x = np.asarray(data[0], dtype=np.float64)
        y = np.asarray(data[1], dtype=np.float64)
        if y.ndim == 1:
            y = y[:, None]
        n = x.shape[0]

        self.plotting_data: List[dict] = []
        if plotting and backend in ("auto", "native"):
            backend = "numpy"

        if backend in ("auto", "native"):
            result = None
            try:
                result = covertree_build_native(x, spatial_resolution, num_levels=num_levels,
                                                lloyds=lloyds, voronoi=voronoi)
            except RuntimeError as exc:
                if backend == "native":
                    raise
                warnings.warn(f"native cover-tree library unavailable ({exc}); "
                              "falling back to the numpy backend", RuntimeWarning)
            if result is not None:
                centers, labels, levels = result
                self.num_levels = levels
                # The numpy path's radius bookkeeping (``levels`` already
                # encodes its max(max_radius, resolution) rounding).
                root = x.mean(axis=0)
                max_radius = float(np.linalg.norm(x - root, axis=-1).max())
                if spatial_resolution is not None:
                    max_radius = spatial_resolution * (2 ** (levels - 1))
                self.max_radius = max_radius
                self.level_centers = [root[None, :], centers]
                self._x, self._y, self._labels = x, y, labels
                return

        if backend == "reference":
            self._build_reference(x, y, spatial_resolution, num_levels, lloyds, voronoi)
            return

        root = x.mean(axis=0)
        max_radius = float(np.linalg.norm(x - root, axis=-1).max())
        if spatial_resolution is not None:
            max_radius = max(max_radius, spatial_resolution)
            num_levels = math.ceil(math.log2(max_radius / spatial_resolution)) + 1
            max_radius = spatial_resolution * (2 ** (num_levels - 1))

        self.max_radius = max_radius
        self.num_levels = num_levels
        self.level_centers: List[np.ndarray] = [root[None, :]]
        labels = np.zeros(n, dtype=np.int64)
        if plotting:
            self.plotting_data.append({
                "centers": root[None, :].copy(),
                "radius": float(max_radius),
                "labels": labels.copy(),
            })

        for level in range(1, num_levels):
            radius = max_radius / (2**level)
            centers: List[np.ndarray] = []
            assigned = np.zeros(n, dtype=bool)
            order = np.argsort(labels, kind="stable")  # keep parent-major order

            center_arr = np.empty((0, x.shape[1]))
            cursor = 0
            while True:
                # first still-uncovered point in parent-major order
                while cursor < n and assigned[order[cursor]]:
                    cursor += 1
                if cursor >= n:
                    break
                seed_idx = order[cursor]
                seed = x[seed_idx]

                if lloyds:
                    # local mean of the seed's uncovered radius-neighbourhood
                    un_idx = np.flatnonzero(~assigned)
                    d_seed = np.linalg.norm(x[un_idx] - seed, axis=-1)
                    neighborhood = x[un_idx[d_seed <= radius]]
                    point = neighborhood.mean(axis=0)
                    if center_arr.shape[0]:
                        sep = np.linalg.norm(center_arr - point, axis=-1)
                        if np.any(sep < radius):
                            point = seed  # keep minimum separation
                else:
                    point = seed

                # claim all uncovered points within radius of the new center
                un_idx = np.flatnonzero(~assigned)
                d_center = np.linalg.norm(x[un_idx] - point, axis=-1)
                claimed = un_idx[d_center <= radius]
                assigned[claimed] = True
                assigned[seed_idx] = True  # guard against an empty claim
                new_label = len(centers)
                labels[claimed] = new_label
                labels[seed_idx] = new_label
                centers.append(point)
                center_arr = np.vstack([center_arr, point[None, :]])

            center_arr = np.stack(centers)
            if plotting:
                # PRE-Voronoi claim labels: every point is within `radius`
                # of its labeled center (the coverage invariant the plots
                # visualize); Voronoi reassignment below may break that.
                self.plotting_data.append({
                    "centers": center_arr.copy(),
                    "radius": float(radius),
                    "labels": labels.copy(),
                })
            if voronoi:
                labels = _nearest_center_labels(x, center_arr)
            self.level_centers.append(center_arr)

        self._x = x
        self._y = y
        self._labels = labels

    def _build_reference(self, x, y, spatial_resolution, num_levels, lloyds, voronoi):
        """Exact-parity construction with ``r_neighbors`` locality lists
        (reference covertree.py:42-156, translated node-for-node)."""
        n = x.shape[0]
        root_point = x.mean(axis=0)
        max_radius = float(np.linalg.norm(x - root_point, axis=-1).max())
        if spatial_resolution is not None:
            num_levels = math.ceil(math.log2(max_radius / spatial_resolution)) + 1
            max_radius = spatial_resolution * (2 ** (num_levels - 1))
        self.max_radius = max_radius
        self.num_levels = num_levels

        class _Node:
            __slots__ = ("point", "data_idx", "vor_idx", "r_neighbors", "children")

            def __init__(self, point, data_idx):
                self.point = point
                self.data_idx = data_idx
                self.vor_idx = np.empty(0, dtype=np.int64)
                self.r_neighbors: List["_Node"] = [self]
                self.children: List["_Node"] = []

        root = _Node(root_point, np.arange(n, dtype=np.int64))
        if voronoi:
            root.vor_idx = root.data_idx.copy()
        levels: List[List[_Node]] = [[root]]
        # neighbor_factor[level] = 4 * (1 - 2^-(num_levels - level))
        # (reference :65 builds it with np.arange(num_levels, -1, -1))
        neighbor_factor = 4.0 * (1.0 - 1.0 / 2.0 ** np.arange(num_levels, -1, -1))

        for level in range(1, num_levels):
            radius = max_radius / (2**level)
            current: List[_Node] = []
            for parent in levels[level - 1]:
                while parent.data_idx.size > 0:
                    seed = x[parent.data_idx[0]]
                    if lloyds:
                        # Local mean of the seed's radius-neighbourhood within
                        # the PARENT's remaining data only (reference :73-76).
                        d_seed = np.linalg.norm(x[parent.data_idx] - seed, axis=-1)
                        point = x[parent.data_idx[d_seed <= radius]].mean(axis=0)
                        # Separation checked against children of the parent's
                        # r_neighbors only (reference :77-84).
                        violated = any(
                            np.linalg.norm(point - child.point) < radius
                            for rn in parent.r_neighbors
                            for child in rn.children
                        )
                        if violated:
                            point = seed
                    else:
                        point = seed
                    # Claim points within radius from every r_neighbor's data
                    # (reference :87-100) — NOT from the global pool.
                    claimed = []
                    for rn in parent.r_neighbors:
                        if rn.data_idx.size == 0:
                            continue
                        d = np.linalg.norm(x[rn.data_idx] - point, axis=-1)
                        take = d <= radius
                        claimed.append(rn.data_idx[take])
                        rn.data_idx = rn.data_idx[~take]
                    child = _Node(point, np.concatenate(claimed) if claimed
                                  else np.empty(0, dtype=np.int64))
                    child.r_neighbors = []
                    current.append(child)
                    parent.children.append(child)
            # Child r_neighbors: children of the parent's r_neighbors within
            # neighbor_factor[level] * radius (reference :103-115).
            for parent in levels[level - 1]:
                potential = [c for rn in parent.r_neighbors for c in rn.children]
                for child in parent.children:
                    child.r_neighbors = [
                        q for q in potential
                        if np.linalg.norm(q.point - child.point)
                        <= neighbor_factor[level] * radius
                    ]
            # Voronoi repartition of each parent's cell among the children of
            # its r_neighbors (reference :118-156) — local, not global argmin.
            if voronoi:
                for parent in levels[level - 1]:
                    vor_idx = parent.vor_idx
                    if vor_idx.size == 0:
                        continue
                    potential = [c for rn in parent.r_neighbors for c in rn.children]
                    pts = np.stack([c.point for c in potential])
                    d = np.linalg.norm(pts[:, None, :] - x[vor_idx][None, :, :], axis=-1)
                    nearest = np.argmin(d, axis=0)
                    for idx, child in enumerate(potential):
                        got = vor_idx[nearest == idx]
                        if got.size:
                            child.vor_idx = np.concatenate([child.vor_idx, got])
                for child in current:
                    child.data_idx = child.vor_idx.copy()
            levels.append(current)

        self.level_centers = [np.stack([node.point for node in lvl]) for lvl in levels]
        labels = np.zeros(n, dtype=np.int64)
        for i, node in enumerate(levels[-1]):
            labels[node.data_idx] = i
        self._x, self._y, self._labels = x, y, labels

    # -- outputs consumed by the update fn (reference covertree.py:160-176) --

    @property
    def centroids(self) -> np.ndarray:
        return self.level_centers[-1]

    @property
    def labels(self) -> np.ndarray:
        return self._labels

    @property
    def cluster_ys(self) -> List[np.ndarray]:
        m = self.centroids.shape[0]
        return [self._y[self._labels == i] for i in range(m)]

    @property
    def cluster_mean_and_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-cluster y means [M, P] and counts [M, 1].

        For the [N, 1] targets used everywhere this matches the reference's
        scalar ``np.mean(node.data[1])`` (covertree.py:169-176); multi-output
        [N, P] targets get proper per-column means instead of the silent
        cross-column averaging the reference would produce.
        """
        m = self.centroids.shape[0]
        counts = np.bincount(self._labels, minlength=m).astype(self._y.dtype)
        sums = np.zeros((m, self._y.shape[-1]), dtype=self._y.dtype)
        np.add.at(sums, self._labels, self._y)
        means = np.divide(
            sums, counts[:, None], out=np.zeros_like(sums), where=counts[:, None] > 0
        )
        return means, counts[:, None]

    def minimum_separation(self, level: int = -1) -> float:
        """Smallest pairwise distance between centers at ``level``.

        The native backend keeps only ``[root, leaf_centers]``, so only
        levels 0/1/-1/-2 are addressable there even when ``num_levels`` is
        larger; intermediate levels need the numpy/reference backends.
        """
        try:
            centers = self.level_centers[level]
        except IndexError:
            raise ValueError(
                f"level {level} not materialised: this tree keeps "
                f"{len(self.level_centers)} center levels "
                f"(num_levels={self.num_levels}; the native backend stores "
                "only root + leaves — use backend='numpy' for intermediate "
                "levels)"
            ) from None
        if centers.shape[0] < 2:
            return float("inf")
        d = np.linalg.norm(centers[:, None, :] - centers[None, :, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        return float(d.min())


def _nearest_center_labels(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Voronoi labels, blocked to bound peak memory at large N."""
    n = x.shape[0]
    labels = np.empty(n, dtype=np.int64)
    c2 = np.sum(centers**2, axis=-1)
    block = max(1, int(2e7) // max(centers.shape[0], 1))
    for start in range(0, n, block):
        xb = x[start : start + block]
        d2 = np.sum(xb**2, axis=-1)[:, None] + c2[None, :] - 2.0 * xb @ centers.T
        labels[start : start + block] = np.argmin(d2, axis=-1)
    return labels
