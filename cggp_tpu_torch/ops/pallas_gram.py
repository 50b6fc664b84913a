"""Kernel B3: the fused Gram matvec, ``K`` never in device memory (port of
``cggp_tpu/ops/pallas_gram.py``).

:func:`gram_matvec` (``K(x, z) @ v``) and :func:`kuu_matvec` (the
row-convention CG matvec ``p @ (K(Z, Z) + diag(lam))``) launch the
hand-written CUDA kernel ``csrc/pallas_gram.cu`` on CUDA tensors and use
their plain versions on CPU tensors; on any other device they raise.  Points
come already divided by the lengthscales.  Operands must be contiguous
float32 on one device (the JAX wrapper casts to float32 inside; the port's
callers cast outside), with at most :data:`MAX_DIM` features.  The variance
is a one-element float32 tensor on the operands' device (or a Python
number), read by the kernel on the device.  Each wrapper counts its own
launches (``gram_matvec.launches``, ``kuu_matvec.launches``).

Arithmetic.  The kernel builds every kernel value in IEEE fp32 (fp32 FMA
distances, IEEE ``expf``/``sqrtf``).  Above 8 rows of ``B`` it contracts
them in 3xTF32 on the tensor cores (TF32 halves ``hi + lo``, products
``lo hi + hi lo + hi hi``, each 32-deep stage added to the running sum in
IEEE fp32; ``csrc/mma_3xtf32.cuh``), adds the running sums to outer sums
every 32 stages, and adds ``p * lam`` in plain fp32; up to 8 rows it
contracts them with IEEE fp32 FMA in 16-deep chunks whose sums meet in a
compensated (Kahan) sum.  The plain versions compute
in IEEE fp32 (TF32 stays off).  :func:`gram_matvec_3xtf32_emulated` and
:func:`kuu_matvec_3xtf32_emulated` repeat the 3xTF32 contraction in plain
torch for the tests and the card's smoke run; the main path never calls
them.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from cggp_tpu_torch.ops.kernels import kernel_value_from_r2, scaled_squared_distance
from cggp_tpu_torch.ops.pallas_matvec import (OUTER_STAGES, check_device, check_operand,
                                              matmul_3xtf32_emulated)

MAX_DIM = 32  # features per point the kernel takes (csrc/pallas_gram.cu kMaxDim)
_KERNEL_IDS = {"se": 0, "matern12": 1, "matern32": 2, "matern52": 3}

Variance = Union[torch.Tensor, float]


def gram_matvec_plain(x_scaled: torch.Tensor, z_scaled: torch.Tensor, v: torch.Tensor,
                      variance: Variance, kernel_name: str = "se") -> torch.Tensor:
    """The plain version: the dense ``K(x, z) @ v``."""
    r2 = scaled_squared_distance(x_scaled, z_scaled)
    return torch.matmul(kernel_value_from_r2(kernel_name, r2, _variance_like(variance, v)), v)


def kuu_matvec_plain(z_scaled: torch.Tensor, lam: torch.Tensor, p_rows: torch.Tensor,
                     variance: Variance, kernel_name: str = "se") -> torch.Tensor:
    """The plain version: ``p @ K(Z, Z) + p * lam`` with the dense ``K``."""
    r2 = scaled_squared_distance(z_scaled, z_scaled)
    k = kernel_value_from_r2(kernel_name, r2, _variance_like(variance, p_rows))
    return torch.matmul(p_rows, k) + p_rows * lam.reshape(1, -1)


def gram_matvec_3xtf32_emulated(x_scaled: torch.Tensor, z_scaled: torch.Tensor,
                                v: torch.Tensor, variance: Variance,
                                kernel_name: str = "se") -> torch.Tensor:
    """The kernel's arithmetic above 8 columns of ``v``: ``K(x, z) @ v`` with
    ``K`` built in fp32 and contracted in emulated 3xTF32 (the kernel reads
    ``B = v^T`` against ``K(z, x)``)."""
    r2 = scaled_squared_distance(z_scaled, x_scaled)
    k = kernel_value_from_r2(kernel_name, r2, _variance_like(variance, v))
    return matmul_3xtf32_emulated(v.T, k, outer_every=OUTER_STAGES).T


def kuu_matvec_3xtf32_emulated(z_scaled: torch.Tensor, lam: torch.Tensor, p_rows: torch.Tensor,
                               variance: Variance, kernel_name: str = "se") -> torch.Tensor:
    """The kernel's arithmetic above 8 rows: ``p @ K(Z, Z)`` in emulated
    3xTF32, then ``+ p * lam`` in plain fp32."""
    r2 = scaled_squared_distance(z_scaled, z_scaled)
    k = kernel_value_from_r2(kernel_name, r2, _variance_like(variance, p_rows))
    return (matmul_3xtf32_emulated(p_rows, k, outer_every=OUTER_STAGES)
            + p_rows * lam.reshape(1, -1))


def _variance_like(variance: Variance, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(variance, dtype=like.dtype, device=like.device).reshape(())


def _check_points(name: str, t: torch.Tensor) -> int:
    if not isinstance(t, torch.Tensor) or t.dim() != 2:
        raise ValueError(f"{name} must be an [n, D] tensor, got {getattr(t, 'shape', type(t))}")
    if t.shape[1] > MAX_DIM:
        raise ValueError(f"{name} has {t.shape[1]} features; the kernel takes at most {MAX_DIM}")
    check_operand(name, t, tuple(t.shape))
    return t.shape[0]


def _check_kernel_name(kernel_name: str) -> int:
    if kernel_name not in _KERNEL_IDS:
        raise ValueError(f"Unsupported kernel name: {kernel_name!r}")
    return _KERNEL_IDS[kernel_name]


def _check_variance(variance: Variance) -> None:
    if isinstance(variance, torch.Tensor) and variance.numel() != 1:
        raise ValueError(f"variance must hold one value, got shape {tuple(variance.shape)}")


def _device_variance(variance: Variance, device: torch.device) -> torch.Tensor:
    """The variance as one float32 on ``device``, never read on the host."""
    if isinstance(variance, torch.Tensor):
        check_operand("variance", variance, tuple(variance.shape))
        if variance.device != device:
            raise ValueError(f"variance lies on {variance.device}, the operands on {device}")
        return variance
    return torch.full((1,), float(variance), dtype=torch.float32, device=device)


def _launch(y, w, b, lam: Optional[torch.Tensor], variance, out, rows, cols, depth,
            strides, kernel_id) -> None:
    from cggp_tpu_torch import _build

    lib = _build.load()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    _build.check(
        lib.cggp_gram_matvec(y.data_ptr(), w.data_ptr(), b.data_ptr(),
                             None if lam is None else lam.data_ptr(), variance.data_ptr(),
                             out.data_ptr(), rows, cols, depth, y.shape[1], *strides,
                             kernel_id, stream),
        "gram_matvec")


def gram_matvec(x_scaled: torch.Tensor, z_scaled: torch.Tensor, v: torch.Tensor,
                variance: Variance, kernel_name: str = "se") -> torch.Tensor:
    """``K(x, z) @ v`` fused: ``[N, D], [M, D], [M, R] -> [N, R]``."""
    kernel_id = _check_kernel_name(kernel_name)
    _check_variance(variance)
    n = _check_points("x_scaled", x_scaled)
    m = _check_points("z_scaled", z_scaled)
    if z_scaled.shape[1] != x_scaled.shape[1]:
        raise ValueError(f"x_scaled and z_scaled differ in features: "
                         f"{x_scaled.shape[1]} vs {z_scaled.shape[1]}")
    if not isinstance(v, torch.Tensor) or v.dim() != 2:
        raise ValueError(f"v must be an [M, R] tensor, got {getattr(v, 'shape', type(v))}")
    r = v.shape[1]
    check_operand("v", v, (m, r))
    if check_device(x_scaled, z_scaled, v) == "cpu":
        return gram_matvec_plain(x_scaled, z_scaled, v, variance, kernel_name)
    var = _device_variance(variance, v.device)
    out = torch.empty((n, r), dtype=torch.float32, device=v.device)
    if n == 0 or r == 0:
        return out
    # B(r, k) = v[k, r]; out(r, c) = out[c, r].
    _launch(z_scaled, x_scaled, v, None, var, out, r, n, m, (1, r, 1, r), kernel_id)
    gram_matvec.launches += 1
    return out


def kuu_matvec(z_scaled: torch.Tensor, lam: torch.Tensor, p_rows: torch.Tensor,
               variance: Variance, kernel_name: str = "se") -> torch.Tensor:
    """Row-convention CG matvec ``p @ (K(Z, Z) + diag(lam))``: ``p_rows [R, M]``
    -> ``[R, M]``, with ``lam`` added in the kernel's epilogue."""
    kernel_id = _check_kernel_name(kernel_name)
    _check_variance(variance)
    m = _check_points("z_scaled", z_scaled)
    check_operand("lam", lam, (m,))
    if not isinstance(p_rows, torch.Tensor) or p_rows.dim() != 2:
        raise ValueError(f"p_rows must be an [R, M] tensor, "
                         f"got {getattr(p_rows, 'shape', type(p_rows))}")
    rows = p_rows.shape[0]
    check_operand("p_rows", p_rows, (rows, m))
    if check_device(z_scaled, lam, p_rows) == "cpu":
        return kuu_matvec_plain(z_scaled, lam, p_rows, variance, kernel_name)
    var = _device_variance(variance, p_rows.device)
    out = torch.empty((rows, m), dtype=torch.float32, device=p_rows.device)
    if rows == 0 or m == 0:
        return out
    _launch(z_scaled, z_scaled, p_rows, lam, var, out, rows, m, m, (m, 1, m, 1), kernel_id)
    kuu_matvec.launches += 1
    return out


gram_matvec.launches = 0
kuu_matvec.launches = 0
