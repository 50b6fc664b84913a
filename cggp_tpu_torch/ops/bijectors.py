"""Parameter transforms (port of ``cggp_tpu/ops/bijectors.py``).

GPflow's ``positive()`` softplus bijector with an explicit lower bound; the
inverse is only used at init time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # Stable softplus: log(1 + exp(x)) = max(x, 0) + log1p(exp(-|x|)).
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _softplus_inverse(y: torch.Tensor) -> torch.Tensor:
    # Stable inverse softplus: x = y + log(-expm1(-y)).
    return y + torch.log(-torch.expm1(-y))


@dataclasses.dataclass(frozen=True)
class Bijector:
    """A pair of forward/inverse maps, hashable by name."""

    name: str
    forward: Callable = dataclasses.field(compare=False)
    inverse: Callable = dataclasses.field(compare=False)

    def __hash__(self):
        return hash(self.name)


def positive(lower: float = 1e-6) -> Bijector:
    """Softplus bijector shifted by ``lower``; matches GPflow ``positive``."""

    def forward(x):
        return _softplus(x) + lower

    def inverse(y):
        tiny = torch.finfo(y.dtype).tiny
        return _softplus_inverse(torch.clamp(y - lower, min=tiny))

    return Bijector(name=f"positive(lower={lower:g})", forward=forward, inverse=inverse)


identity_bijector = Bijector(name="identity", forward=lambda x: x, inverse=lambda x: x)
