"""Inducing-point selection (port of ``cggp_tpu/selection``): the cover tree
(host numpy, reference and native backends), Lloyd's k-means on the device,
OIPS, greedy and uniform, and the update functions that turn a selection
into ``(Z, pseudo_u, cluster_counts)``.

The device delta-net (``covernet_*``) is not ported yet: its names raise
``NotImplementedError`` (ROADMAP Queue A item 10).
"""

from cggp_tpu_torch.selection.covertree import CoverTree
from cggp_tpu_torch.selection.kmeans import kmeans_indices_and_distances, kmeans_lloyd
from cggp_tpu_torch.selection.points import greedy_selection, oips, uniform
from cggp_tpu_torch.selection.update import (covertree_update_inducing_parameters,
                                             kmeans_update_inducing_parameters,
                                             labels_update_inducing_parameters)


def _covernet_not_ported(name: str):
    def refused(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (the device delta-net selection) arrives with a later slice of the "
            "port (ROADMAP Queue A item 10); use CoverTree or kmeans_lloyd")

    refused.__name__ = name
    return refused


covernet_extend = _covernet_not_ported("covernet_extend")
covernet_extend_update = _covernet_not_ported("covernet_extend_update")
covernet_extend_update_padded = _covernet_not_ported("covernet_extend_update_padded")
covernet_lloyds = _covernet_not_ported("covernet_lloyds")
covernet_select = _covernet_not_ported("covernet_select")
covernet_update_inducing_parameters = _covernet_not_ported(
    "covernet_update_inducing_parameters")

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
