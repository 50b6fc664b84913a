"""Selection to model parameters (port of ``cggp_tpu/selection/update.py``).

Each update function maps a selection of inducing points to the triple
``(Z, pseudo_u, cluster_counts)`` the Cluster/CGGP models consume:
``pseudo_u`` holds the per-cluster means of y (every output column) and
``cluster_counts`` the cluster sizes (``Lambda = sigma^2 / counts``).  An
empty cluster gets count 1 and mean 0, on every path.  The results lie on
the data's device in the data's dtype.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cggp_tpu_torch.config import default_float, resolve_device
from cggp_tpu_torch.selection.covertree import CoverTree
from cggp_tpu_torch.selection.kmeans import kmeans_indices_and_distances

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _means_and_counts_from_labels(y: torch.Tensor, labels: torch.Tensor,
                                  num_clusters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster y means ``[M, P]`` and counts ``[M, 1]`` (segment sums)."""
    counts = torch.zeros(num_clusters, dtype=y.dtype, device=y.device)
    counts.index_add_(0, labels, torch.ones(y.shape[0], dtype=y.dtype, device=y.device))
    sums = torch.zeros((num_clusters, y.shape[-1]), dtype=y.dtype, device=y.device)
    sums.index_add_(0, labels, y)
    safe_counts = torch.clamp(counts, min=1.0)
    return sums / safe_counts[:, None], safe_counts[:, None]


def labels_update_inducing_parameters(data: Tuple[torch.Tensor, torch.Tensor],
                                      iv: torch.Tensor,
                                      distance_fn: Optional[Callable] = None) -> Triple:
    """Voronoi-assign the data to given inducing points: ``(Z, u, counts)``
    (the OIPS, uniform and greedy paths)."""
    x, y = data
    iv = iv.to(device=x.device, dtype=x.dtype)
    labels, _ = kmeans_indices_and_distances(iv, x, distance_fn=distance_fn)
    means, counts = _means_and_counts_from_labels(y, labels, iv.shape[0])
    return iv, means, counts


def kmeans_update_inducing_parameters(data: Tuple[torch.Tensor, torch.Tensor],
                                      clustering_fn: Callable[[], torch.Tensor],
                                      distance_fn: Optional[Callable] = None) -> Triple:
    """Run a clustering function, then :func:`labels_update_inducing_parameters`."""
    return labels_update_inducing_parameters(data, clustering_fn(), distance_fn=distance_fn)


def covertree_update_inducing_parameters(data, spatial_resolution: float,
                                         distance_fn: Optional[Callable] = None,
                                         lloyds: bool = True, voronoi: bool = True,
                                         backend: str = "auto") -> Triple:
    """Cover tree on the host, then ``(Z, u, counts)`` over its non-empty
    clusters.

    The data are copied to the host (fp64) for the build; the results go to
    the data's device in the data's dtype (numpy data: the default float on
    the default device).  ``backend`` is the :class:`CoverTree` backend
    (the JAX package always uses ``"auto"``)."""
    x, y = data
    if isinstance(x, torch.Tensor):
        device, dtype = x.device, x.dtype
        x_host, y_host = x.detach().cpu().numpy(), y.detach().cpu().numpy()
    else:
        device, dtype = resolve_device(None), default_float()
        x_host, y_host = np.asarray(x), np.asarray(y)
    tree = CoverTree(distance_fn, (x_host, y_host), spatial_resolution=spatial_resolution,
                     lloyds=lloyds, voronoi=voronoi, backend=backend)
    iv = tree.centroids
    means, counts = tree.cluster_mean_and_counts
    keep = counts[:, 0] != 0.0
    return tuple(torch.as_tensor(a[keep], device=device, dtype=dtype)
                 for a in (iv, means, counts))
