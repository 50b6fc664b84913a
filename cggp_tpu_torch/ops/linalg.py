"""Small linear-algebra helpers (port of ``cggp_tpu/ops/linalg.py``):
``add_diagonal``, the greedy pivoted Cholesky (dense and matrix-free),
``pad_rows_to_blocks`` for the serving sweep, the compensated sums and
dots of the CG's ``dot="compensated"``, and the bordered factor updates
``chol_extend`` / ``triangular_inv_extend``."""

from __future__ import annotations

from typing import Callable, Tuple

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
    columns, so ``rank`` above the numerical rank is safe.  A gang's
    stacked matrices ``[G, n, n]`` give ``[G, n, rank]``, one factor a
    member."""
    n = matrix.shape[-1]

    def row_fn(pivot):
        index = pivot[..., None].expand(*pivot.shape, n)
        return torch.gather(matrix, -2, index)[..., 0, :]

    return pivoted_cholesky_matfree(row_fn, torch.diagonal(matrix, dim1=-2, dim2=-1), rank)


def pivoted_cholesky_matfree(row_fn: Callable[[torch.Tensor], torch.Tensor],
                             diag: torch.Tensor, rank: int) -> torch.Tensor:
    """Matrix-free pivoted Cholesky: the matrix is exposed only through
    ``row_fn(pivot) -> row [n]`` and its ``diag [n]``.

    ``pivot`` is a one-element int64 tensor on the device: the pivot is
    picked by ``argmax`` there (ties go to the first index, as in
    ``jnp.argmax``) and nothing is read back to the host per step.  A
    gang's diagonals ``[G, n]`` take pivots ``[G, 1]`` and rows ``[G, n]``
    and give ``[G, n, rank]``."""
    n = diag.shape[-1]
    dtype, device = diag.dtype, diag.device
    # Relative pivot floor: once the residual diagonal falls to rounding
    # noise, further columns are amplified garbage (each is divided by
    # sqrt(pivot)); stop contributing instead.
    eps = torch.finfo(dtype).eps
    tiny = 10.0 * eps * torch.clamp(torch.amax(diag, dim=-1, keepdim=True), min=1e-30)
    ell = torch.zeros((*diag.shape[:-1], n, rank), dtype=dtype, device=device)
    d = diag.clone()
    for i in range(rank):
        pivot = torch.argmax(d, dim=-1, keepdim=True)
        val = torch.gather(d, -1, pivot)
        row = row_fn(pivot)
        pivot_row = torch.gather(ell, -2, pivot[..., None].expand(*pivot.shape, rank))
        cross = (torch.mv(ell, pivot_row[0]) if ell.dim() == 2
                 else torch.matmul(ell, pivot_row.mT)[..., 0])
        inv_sqrt = torch.rsqrt(torch.maximum(val, tiny))
        col = torch.where(val > tiny, (row - cross) * inv_sqrt, torch.zeros_like(row))
        ell[..., i] = col
        d = torch.clamp(d - torch.square(col), min=0.0)
        d.scatter_(-1, pivot, 0.0)
    return ell


def pad_rows_to_blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """``x [n, d]`` as fixed-size row blocks ``[num_blocks, block_size, d]``,
    the tail block padded with copies of row 0 (callers strip outputs back
    to ``[:n]``).  ``block_size`` is used as given, floored at 1, so an
    empty ``x`` gives zero blocks."""
    n, d = x.shape
    block = max(int(block_size), 1)
    pad = (-n) % block
    if pad:
        x = torch.cat([x, x[:1].expand(pad, d)])
    return x.reshape(-1, block, d)


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Knuth's exact two-sum: ``a + b = s + err`` with ``s = fl(a + b)``."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def compensated_sum(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Error-compensated sum along ``dim``.

    The JAX package runs Kahan's recurrence as a scan over the summed axis;
    here the axis is halved ``log2(n)`` times, each pair of halves added by
    :func:`two_sum` and the exact rounding errors carried beside the sums
    (pairwise summation with compensation).  The carried errors are summed
    plainly, so the result is within ~2 ulps of the exact sum plus
    ``O(log2(n) eps^2) sum |x|``, Kahan's bound, at ``log2(n)`` vectorised
    steps instead of n sequential ones."""
    x = torch.movedim(x, dim, -1)
    n = x.shape[-1]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        x = torch.nn.functional.pad(x, (0, size - n))
    err = torch.zeros_like(x)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x, e = two_sum(x[..., :half], x[..., half:])
        err = err[..., :half] + err[..., half:] + e
    s = (x + err)[..., 0]
    if keepdim:
        s = s.unsqueeze(dim if dim >= 0 else s.dim() + 1 + dim)
    return s


def compensated_dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    """Row-wise ``sum(a * b, -1)`` with compensated accumulation."""
    return compensated_sum(a * b, dim=-1, keepdim=keepdim)


def chol_extend(l11: torch.Tensor, a21: torch.Tensor, a22: torch.Tensor) -> torch.Tensor:
    """Bordered Cholesky update: from ``L11``, the lower factor of the
    leading [M, M] block, and the new blocks ``A21 [dM, M]``, ``A22 [dM, dM]``
    of ``[[A11, A21^T], [A21, A22]]``, the [M + dM, M + dM] lower factor
    ``[[L11, 0], [L21, L22]]`` with ``L21 = A21 L11^{-T}`` and ``L22 =
    chol(A22 - L21 L21^T)``: O(dM M^2) instead of a refactorization.  A
    Schur complement that is not positive definite gives a NaN ``L22``, as
    ``jnp.linalg.cholesky`` does; callers check ``isfinite``."""
    m, dm = l11.shape[-1], a22.shape[-1]
    l21_t = torch.linalg.solve_triangular(l11, a21.T, upper=False)
    schur = a22 - l21_t.T @ l21_t
    chol, info = torch.linalg.cholesky_ex(schur)
    l22 = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
    top = torch.cat([l11, l11.new_zeros((m, dm))], dim=1)
    bottom = torch.cat([l21_t.T, l22], dim=1)
    return torch.cat([top, bottom], dim=0)


def triangular_inv_extend(w11: torch.Tensor, l21: torch.Tensor,
                          l22: torch.Tensor) -> torch.Tensor:
    """The bordered factor's inverse from a cached ``W11 = L11^{-1}``:
    ``[[W11, 0], [-W22 L21 W11, W22]]`` with ``W22 = L22^{-1}``, ``l21`` and
    ``l22`` the bottom row of :func:`chol_extend` (the streaming update of a
    :class:`~cggp_tpu_torch.ops.cg.CholPreconditioner` state)."""
    m, dm = w11.shape[-1], l22.shape[-1]
    eye = torch.eye(dm, dtype=l22.dtype, device=l22.device)
    w22 = torch.linalg.solve_triangular(l22, eye, upper=False)
    w21 = -(w22 @ (l21 @ w11))
    top = torch.cat([w11, w11.new_zeros((m, dm))], dim=1)
    bottom = torch.cat([w21, w22], dim=1)
    return torch.cat([top, bottom], dim=0)
