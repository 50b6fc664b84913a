"""Numerics configuration and device resolution (port of ``cggp_tpu/config.py``).

:class:`Config` carries the reference's three global numerics settings
(float dtype, jitter, positive minimum) as one explicit frozen object;
``set_default_config`` is process-global.  The JAX package resolves its
default float from the ambient x64 mode; the port reads
``torch.get_default_dtype()`` the same way, and
:func:`enable_x64_if_needed` sets it to float64 where a config asks for
it.  :func:`enable_nan_checks` is ``torch.autograd.set_detect_anomaly``
behind a flag, off by default.

Precision rule: the distance cross term ``x @ z.T`` and every CG matvec must
run in IEEE fp32 (or fp64), never TF32 — reduced matmul precision makes
``Kmm + Lambda`` indefinite and CG diverges (``cggp_tpu/ops/kernels.py``,
``scaled_squared_distance``).  :func:`resolve_device` therefore switches
TF32 (and bf16 products' reduced-precision sums) off for CUDA matmuls
whenever it hands out a CUDA device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class Config:
    """Numerics knobs, the reference's three global settings.

    Attributes:
        dtype_name: "float32" or "float64" (the reference's
            ``default_float()``).
        jitter: diagonal jitter of the ``Kuu`` builders that ask for it
            (SGPR's); the CG models build ``Kuu`` with jitter 0.
        positive_minimum: lower bound of the positive bijector (0.0 keeps
            each component's own bound).
    """

    dtype_name: str = "float64"
    jitter: float = 1e-6
    positive_minimum: float = 0.0

    @property
    def dtype(self) -> torch.dtype:
        if self.dtype_name not in _DTYPES:
            raise ValueError(f"unknown dtype_name {self.dtype_name!r}; choose from "
                             f"{sorted(_DTYPES)}")
        return _DTYPES[self.dtype_name]

    def with_updates(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


_DEFAULT = Config()


def default_config() -> Config:
    return _DEFAULT


def set_default_config(config: Config) -> None:
    global _DEFAULT
    _DEFAULT = config


def enable_x64_if_needed(config: Config) -> None:
    """Set torch's default dtype to float64 when ``config`` asks for it."""
    if config.dtype == torch.float64:
        torch.set_default_dtype(torch.float64)


def enable_nan_checks(enabled: bool = True) -> None:
    """Autograd's anomaly mode behind a flag: a backward pass that makes a
    NaN raises where it was made (the counterpart of ``jax_debug_nans``)."""
    torch.autograd.set_detect_anomaly(enabled)


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
