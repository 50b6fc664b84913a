"""Distance functions for the clustering front ends (port of
``cggp_tpu/ops/distance.py``): ``euclidean``, the kernel-induced
``covariance`` ``k(x, x) + k(y, y) - 2 k(x, y)`` and ``correlation``
``1 - k(x, y) / sqrt(k(x, x) k(y, y))``.  Each takes one ``(x, y)`` pair of
row-aligned tensors (broadcast, not all pairs) and returns one distance per
row."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from cggp_tpu_torch.ops.kernels import kernel_value_from_r2

DistanceType = ("euclidean", "covariance", "correlation")


def euclid_distance(args: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    x, y = args
    return torch.linalg.vector_norm(x - y, dim=-1)


def create_distance_fn(kernel, kernel_params, distance_type: str) -> Callable:
    """A distance over row pairs, parameterised by a kernel and its
    parameters; ``distance_type`` is one of :data:`DistanceType`."""

    def pairwise_k(x, y):
        # Elementwise k(x_i, y_i).
        diff = (x - y) / kernel.lengthscales(kernel_params)
        r2 = torch.clamp(torch.sum(torch.square(diff), dim=-1), min=0.0)
        return kernel_value_from_r2(kernel.name, r2, kernel.variance(kernel_params))

    def cov(args):
        x, y = args
        return (kernel.K_diag(kernel_params, x) + kernel.K_diag(kernel_params, y)
                - 2.0 * pairwise_k(x, y))

    def cor(args):
        x, y = args
        x_diag = kernel.K_diag(kernel_params, x)
        y_diag = kernel.K_diag(kernel_params, y)
        return 1.0 - pairwise_k(x, y) / torch.sqrt(x_diag * y_diag)

    functions = {"covariance": cov, "correlation": cor, "euclidean": euclid_distance}
    return functions[distance_type]
