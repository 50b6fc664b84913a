"""Small linear-algebra helpers (port of ``cggp_tpu/ops/linalg.py``)."""

from __future__ import annotations

import torch


def add_diagonal(matrix: torch.Tensor, diagonal: torch.Tensor) -> torch.Tensor:
    """Return ``matrix + diag(diagonal)`` for an [n, n] matrix and [n] vector
    (a new tensor; ``matrix`` is left as it is)."""
    out = matrix.clone()
    out.diagonal(dim1=-2, dim2=-1).add_(diagonal)
    return out
