"""Small linear-algebra helpers (port of ``cggp_tpu/ops/linalg.py``):
``add_diagonal`` and the greedy pivoted Cholesky, dense and matrix-free."""

from __future__ import annotations

from typing import Callable

import torch


def add_diagonal(matrix: torch.Tensor, diagonal: torch.Tensor) -> torch.Tensor:
    """Return ``matrix + diag(diagonal)`` for an [n, n] matrix and [n] vector
    (a new tensor; ``matrix`` is left as it is)."""
    out = matrix.clone()
    out.diagonal(dim1=-2, dim2=-1).add_(diagonal)
    return out


def pivoted_cholesky(matrix: torch.Tensor, rank: int) -> torch.Tensor:
    """Greedy partial pivoted Cholesky: ``L [n, rank]`` with ``L L^T ~= matrix``.

    Each step picks the largest remaining diagonal (the greedy trace-error
    pivot).  Exhausted or numerically non-positive pivots contribute zero
    columns, so ``rank`` above the numerical rank is safe."""

    def row_fn(pivot):
        return matrix.index_select(0, pivot)[0]

    return pivoted_cholesky_matfree(row_fn, torch.diagonal(matrix), rank)


def pivoted_cholesky_matfree(row_fn: Callable[[torch.Tensor], torch.Tensor],
                             diag: torch.Tensor, rank: int) -> torch.Tensor:
    """Matrix-free pivoted Cholesky: the matrix is exposed only through
    ``row_fn(pivot) -> row [n]`` and its ``diag [n]``.

    ``pivot`` is a one-element int64 tensor on the device: the pivot is
    picked by ``argmax`` there (ties go to the first index, as in
    ``jnp.argmax``) and nothing is read back to the host per step."""
    n = diag.shape[0]
    dtype, device = diag.dtype, diag.device
    # Relative pivot floor: once the residual diagonal falls to rounding
    # noise, further columns are amplified garbage (each is divided by
    # sqrt(pivot)); stop contributing instead.
    eps = torch.finfo(dtype).eps
    tiny = 10.0 * eps * torch.clamp(torch.max(diag), min=1e-30)
    ell = torch.zeros((n, rank), dtype=dtype, device=device)
    d = diag.clone()
    for i in range(rank):
        pivot = torch.argmax(d).reshape(1)
        val = d.index_select(0, pivot)[0]
        row = row_fn(pivot)
        cross = torch.mv(ell, ell.index_select(0, pivot)[0])
        inv_sqrt = torch.rsqrt(torch.maximum(val, tiny))
        col = torch.where(val > tiny, (row - cross) * inv_sqrt, torch.zeros_like(row))
        ell[:, i] = col
        d = torch.clamp(d - torch.square(col), min=0.0)
        d.index_fill_(0, pivot, 0.0)
    return ell
