"""Numerics configuration and device resolution (port of ``cggp_tpu/config.py``).

The JAX package resolves its default float from the ambient x64 mode; the
port reads ``torch.get_default_dtype()`` the same way.

Precision rule: the distance cross term ``x @ z.T`` and every CG matvec must
run in IEEE fp32 (or fp64), never TF32 — reduced matmul precision makes
``Kmm + Lambda`` indefinite and CG diverges (``cggp_tpu/ops/kernels.py``,
``scaled_squared_distance``).  :func:`resolve_device` therefore switches
TF32 (and bf16 products' reduced-precision sums) off for CUDA matmuls
whenever it hands out a CUDA device.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def default_float() -> torch.dtype:
    """The float dtype ``init_params`` uses when none is given."""
    return torch.get_default_dtype()


def require_ieee_fp32_matmul() -> None:
    """Set, process-wide, IEEE fp32 CUDA matmuls: TF32 off and float32
    matmul precision "highest" (both are PyTorch's defaults; a caller that
    changed them would silently break CG convergence), and fp32 sums in
    bf16 products (the bf16 CG routes ask for fp32 accumulation, as JAX's
    ``preferred_element_type`` does; PyTorch's default lets cuBLAS reduce
    split sums in bf16)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises instead of running on the CPU when CUDA is requested (explicitly
    or by default) and no card is present: the CPU is used only when the
    caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cggp_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU"
            )
        require_ieee_fp32_matmul()
    return dev
