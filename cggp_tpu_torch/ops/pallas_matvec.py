"""Kernel B1: the row-batched CG matvec ``p @ A`` (port of
``cggp_tpu/ops/pallas_matvec.py``).

:func:`pallas_matvec` launches the hand-written CUDA kernel
(``csrc/pallas_matvec.cu``) on CUDA tensors and uses its plain version,
:func:`pallas_matvec_plain`, on CPU tensors; on any other device it raises.
Operands must be contiguous float32 on one device: the caller casts (the
JAX wrapper casts to float32 inside, the port's CG route does it outside).
``pallas_matvec.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch


def check_operand(name: str, t: torch.Tensor, shape) -> None:
    """Refuse what the kernels do not take: a non-tensor, a dtype other than
    float32, a wrong shape, or a non-contiguous layout."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_device(*tensors: torch.Tensor) -> str:
    """The one device type all operands share: ``"cpu"`` or ``"cuda"``."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: {sorted(map(str, devices))}")
    kind = next(iter(devices)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {kind!r}: the kernels run on CUDA, "
                         "their plain versions on the CPU")
    return kind


def pallas_matvec_plain(p: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The plain version: ``p @ a`` (IEEE fp32 on CUDA with TF32 off)."""
    return torch.matmul(p, a)


def pallas_matvec(p: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``p @ A`` for symmetric ``A``: ``p [R, M]``, ``A [M, M]`` -> ``[R, M]``."""
    if not isinstance(p, torch.Tensor) or p.dim() != 2:
        raise ValueError(f"p must be an [R, M] tensor, got {getattr(p, 'shape', type(p))}")
    rows, m = p.shape
    check_operand("p", p, (rows, m))
    check_operand("a", a, (m, m))
    if check_device(p, a) == "cpu":
        return pallas_matvec_plain(p, a)
    out = torch.empty((rows, m), dtype=torch.float32, device=p.device)
    if rows == 0 or m == 0:
        return out
    from cggp_tpu_torch import _build

    lib = _build.load()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    _build.check(lib.cggp_pallas_matvec(p.data_ptr(), a.data_ptr(), out.data_ptr(),
                                        rows, m, stream), "pallas_matvec")
    pallas_matvec.launches += 1
    return out


pallas_matvec.launches = 0
