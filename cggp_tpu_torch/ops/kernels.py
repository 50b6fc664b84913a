"""Stationary GP kernels over parameter dicts (port of ``cggp_tpu/ops/kernels.py``).

A :class:`Kernel` is a frozen, hashable spec; the numbers live in a dict
``{"variance": raw, "lengthscales": raw}`` of tensors in unconstrained
space, under the JAX pytree's keys.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from cggp_tpu_torch.config import DeviceLike, default_float, resolve_device
from cggp_tpu_torch.ops.bijectors import positive

KernelParams = Dict[str, torch.Tensor]

_SUPPORTED = ("se", "matern12", "matern32", "matern52")

# gpflow clips the scaled squared distance at 1e-36 before sqrt so Matern
# gradients stay finite at r == 0.
_R2_FLOOR = 1e-36


def scaled_squared_distance(x_scaled: torch.Tensor,
                            y_scaled: Optional[torch.Tensor]) -> torch.Tensor:
    """``r2[i, j] = ||xs_i - ys_j||^2`` as ``|x|^2 + |y|^2 - 2 x @ y.T``.

    The cross term must run in IEEE fp32 (or fp64), never TF32: ``x2 + y2 -
    2xy`` cancels catastrophically for nearby points, and the Gram-matrix
    error makes ``Kmm + Lambda`` indefinite.  On CUDA that needs TF32 off,
    which :func:`cggp_tpu_torch.resolve_device` sets."""
    if y_scaled is None:
        y_scaled = x_scaled
    xs2 = torch.sum(torch.square(x_scaled), dim=-1, keepdim=True)  # [N, 1]
    ys2 = torch.sum(torch.square(y_scaled), dim=-1, keepdim=True)  # [M, 1]
    if x_scaled.dim() == 3:
        # A gang: one product per member, the bits of the member's own Gram
        # (a batched product sums the depth in another order, and CG past M
        # steps magnifies an ulp of the system).
        cross = torch.stack([torch.matmul(xg, yg.T) for xg, yg in zip(x_scaled, y_scaled)])
    else:
        cross = torch.matmul(x_scaled, y_scaled.T)
    r2 = xs2 + ys2.mT - 2.0 * cross
    return torch.clamp(r2, min=0.0)


def kernel_value_from_r2(name: str, r2: torch.Tensor, variance: torch.Tensor) -> torch.Tensor:
    """Stationary kernel value as a function of the scaled squared distance."""
    if name == "se":
        return variance * torch.exp(-0.5 * r2)
    r = torch.sqrt(torch.clamp(r2, min=_R2_FLOOR))
    if name == "matern12":
        return variance * torch.exp(-r)
    if name == "matern32":
        sqrt3_r = math.sqrt(3.0) * r
        return variance * (1.0 + sqrt3_r) * torch.exp(-sqrt3_r)
    if name == "matern52":
        sqrt5_r = math.sqrt(5.0) * r
        return variance * (1.0 + sqrt5_r + (5.0 / 3.0) * r2) * torch.exp(-sqrt5_r)
    raise ValueError(f"Unsupported kernel name: {name!r}")


@dataclasses.dataclass(frozen=True)
class Kernel:
    """Static spec of a stationary kernel with ARD lengthscales.

    ``name`` is one of {"se", "matern12", "matern32", "matern52"};
    ``positive_lower`` is the softplus lower bound of both parameters.
    """

    name: str
    positive_lower: float = 1e-6

    def __post_init__(self):
        if self.name not in _SUPPORTED:
            raise ValueError(f"Unsupported kernel {self.name!r}; choose from {_SUPPORTED}")

    @property
    def bijector(self):
        return positive(self.positive_lower)

    def init_params(
        self,
        variance: float = 1.0,
        lengthscales: Union[float, Sequence[float], np.ndarray] = 1.0,
        dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ) -> KernelParams:
        """Build the raw (unconstrained) parameter dict."""
        dtype = default_float() if dtype is None else dtype
        device = resolve_device(device)
        bij = self.bijector
        variance = torch.as_tensor(np.asarray(variance), dtype=dtype, device=device)
        lengthscales = torch.as_tensor(np.asarray(lengthscales), dtype=dtype, device=device)
        return {"variance": bij.inverse(variance), "lengthscales": bij.inverse(lengthscales)}

    def variance(self, params: KernelParams) -> torch.Tensor:
        return self.bijector.forward(params["variance"])

    def lengthscales(self, params: KernelParams) -> torch.Tensor:
        return self.bijector.forward(params["lengthscales"])

    def constrained(self, params: KernelParams) -> Dict[str, torch.Tensor]:
        return {"variance": self.variance(params), "lengthscales": self.lengthscales(params)}

    def K(self, params: KernelParams, x: torch.Tensor,
          x2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Dense Gram matrix ``K(x, x2)`` of shape [N, M].

        A gang (gang training) passes ``x [G, N, D]`` with every parameter
        stacked on a leading [G] axis (the variance [G] instead of 0-d) and
        gets [G, N, M]."""
        ell = self.lengthscales(params)
        variance = self.variance(params)
        if variance.dim() == 1 and x.dim() == 3:
            ell = ell.reshape(x.shape[0], 1, -1)
            variance = variance.reshape(x.shape[0], 1, 1)
        xs = x / ell
        ys = None if x2 is None else x2 / ell
        r2 = scaled_squared_distance(xs, ys)
        return kernel_value_from_r2(self.name, r2, variance)

    def K_diag(self, params: KernelParams, x: torch.Tensor) -> torch.Tensor:
        """Diagonal of ``K(x, x)``: constant ``variance`` for stationary kernels
        ([G, N] for a gang's ``x [G, N, D]``)."""
        # A broadcast of the 0-d variance: no host read of its value.
        variance = self.variance(params).to(x.dtype)
        if variance.dim() == 1 and x.dim() == 3:
            variance = variance.reshape(x.shape[0], 1)
        return variance.expand(x.shape[:-1])


def SquaredExponential(positive_lower: float = 1e-6) -> Kernel:
    return Kernel("se", positive_lower)


def Matern12(positive_lower: float = 1e-6) -> Kernel:
    return Kernel("matern12", positive_lower)


def Matern32(positive_lower: float = 1e-6) -> Kernel:
    return Kernel("matern32", positive_lower)


def Matern52(positive_lower: float = 1e-6) -> Kernel:
    return Kernel("matern52", positive_lower)


_BY_NAME = {
    "se": SquaredExponential,
    "rbf": SquaredExponential,
    "matern12": Matern12,
    "matern32": Matern32,
    "matern52": Matern52,
}


def kernel_by_name(name: str, positive_lower: float = 1e-6) -> Kernel:
    """Kernel factory by the reference CLI names."""
    try:
        return _BY_NAME[name.lower()](positive_lower)
    except KeyError:
        raise ValueError(f"Unknown kernel name {name!r}; choose from {sorted(_BY_NAME)}")
