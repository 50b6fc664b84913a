"""Lloyd's k-means on the device (port of ``cggp_tpu/selection/kmeans.py``).

The assignment step computes the pairwise distances of one row block of
16,384 points at a time against all centroids and reduces each block to its
argmin at once, so only the ``[N]`` labels and distances are ever
materialised.  The distance cross term runs in IEEE fp32 (or fp64): TF32
would corrupt small distances by cancellation, so CUDA inputs switch it off
through :func:`require_ieee_fp32_matmul`.  The centroid update is a segment
sum in a fixed order (:func:`_segment_sums`: the same bits on every run, as
JAX's); empty clusters keep count 1, so their centroid collapses to 0 as in
the JAX package.  The host reads the stop rule,
``prev - mean > threshold``, once per Lloyd iteration.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from cggp_tpu_torch.config import require_ieee_fp32_matmul
from cggp_tpu_torch.selection import points as _points

BLOCK = 16_384
# Words of one one-hot block of the segment sums (64 MB in fp32).
ONEHOT_WORDS = 1 << 24


def _pairwise_euclid(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[N, K] Euclidean distances, the cross term a full-precision matmul."""
    p2 = torch.sum(points * points, dim=-1, keepdim=True)
    c2 = torch.sum(centroids * centroids, dim=-1, keepdim=True)
    cross = points @ centroids.T
    return torch.sqrt(torch.clamp(p2 + c2.T - 2.0 * cross, min=0.0))


def _block_indices_and_distances(xb, centroids, distance_fn):
    if distance_fn is None:
        d = _pairwise_euclid(xb, centroids)
    else:
        # distance_fn takes an (x, y) tuple and broadcasts on leading axes.
        d = distance_fn((xb[:, None, :], centroids[None, :, :]))
    chosen, indices = torch.min(d, dim=-1)
    return indices, chosen


def kmeans_indices_and_distances(
    centroids: torch.Tensor,
    points: torch.Tensor,
    distance_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid labels ``[N]`` (int64) and distances ``[N]``, one
    row block of :data:`BLOCK` points at a time (the first of equal
    distances wins, as ``jnp.argmin``)."""
    if points.is_cuda:
        require_ieee_fp32_matmul()
    n = points.shape[0]
    if n <= BLOCK:
        return _block_indices_and_distances(points, centroids, distance_fn)
    parts = [_block_indices_and_distances(points[s:s + BLOCK], centroids, distance_fn)
             for s in range(0, n, BLOCK)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _segment_sums(points: torch.Tensor, indices: torch.Tensor, k: int) -> torch.Tensor:
    """Row sums of ``points`` [N, D] by label ``indices`` [N] into [k, D], in
    a fixed order: one-hot products over row blocks, added block after block.
    (``index_add_`` adds in the order its CUDA atomics land, so fp32 Lloyd
    runs from one start part ways: at the e2e workload on an H100 they
    ended 1.6e-6 to 1.1e-4 from the fp64 run's mean distance.)"""
    rows = max(1, ONEHOT_WORDS // k)
    segments = torch.arange(k, device=points.device)[:, None]
    sums = torch.zeros((k, points.shape[-1]), dtype=points.dtype, device=points.device)
    for s in range(0, points.shape[0], rows):
        onehot = (indices[None, s:s + rows] == segments).to(points.dtype)
        sums = sums + onehot @ points[s:s + rows]
    return sums


def kmeans_lloyd(
    points: torch.Tensor,
    k_centroids: int,
    threshold: float = 1e-5,
    initial_centroids: Optional[torch.Tensor] = None,
    distance_fn: Optional[Callable] = None,
    key: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations until the mean distance improves by no more than
    ``threshold``; returns ``(centroids [K, D], mean distance)``, the mean
    distance being that of the last assignment (to the centroids before the
    last update), as in the JAX package.  Without ``initial_centroids`` the
    first ``k_centroids`` of a random permutation drawn from ``key`` start
    it."""
    if initial_centroids is None:
        if key is None:
            raise ValueError("kmeans_lloyd needs either initial_centroids or a generator (key)")
        initial_centroids = points[_points.permutation(key, points.shape[0])[:k_centroids]]
    initial_centroids = initial_centroids.to(device=points.device, dtype=points.dtype)

    def assign_and_update(centroids):
        indices, distances = kmeans_indices_and_distances(centroids, points,
                                                          distance_fn=distance_fn)
        counts = torch.bincount(indices, minlength=k_centroids).to(points.dtype)
        sums = _segment_sums(points, indices, k_centroids)
        return sums / torch.clamp(counts, min=1.0)[:, None], torch.mean(distances)

    centroids, mean_distance = assign_and_update(initial_centroids)
    prev = torch.full_like(mean_distance, float("inf"))
    # The rule in the points' dtype, as JAX's while_loop tests it; one host
    # read per iteration.
    while bool(prev - mean_distance > threshold):
        prev = mean_distance
        centroids, mean_distance = assign_and_update(centroids)
    return centroids, mean_distance
