"""Inducing-point selection (port of ``cggp_tpu/selection``): the cover tree
(host numpy, reference and native backends), Lloyd's k-means on the device,
OIPS, greedy and uniform, the device delta-net (``covernet_*``, with its
fixed-capacity and streaming variants), and the update functions that turn
a selection into ``(Z, pseudo_u, cluster_counts)``.
"""

from cggp_tpu_torch.selection.covernet import (covernet_extend, covernet_extend_update,
                                               covernet_extend_update_padded, covernet_lloyds,
                                               covernet_select,
                                               covernet_update_inducing_parameters)
from cggp_tpu_torch.selection.covertree import CoverTree
from cggp_tpu_torch.selection.kmeans import kmeans_indices_and_distances, kmeans_lloyd
from cggp_tpu_torch.selection.points import greedy_selection, oips, uniform
from cggp_tpu_torch.selection.update import (covertree_update_inducing_parameters,
                                             kmeans_update_inducing_parameters,
                                             labels_update_inducing_parameters)


__all__ = [
    "kmeans_indices_and_distances",
    "kmeans_lloyd",
    "greedy_selection",
    "oips",
    "uniform",
    "CoverTree",
    "covernet_extend",
    "covernet_extend_update",
    "covernet_extend_update_padded",
    "covernet_lloyds",
    "covernet_select",
    "covernet_update_inducing_parameters",
    "covertree_update_inducing_parameters",
    "kmeans_update_inducing_parameters",
    "labels_update_inducing_parameters",
]
