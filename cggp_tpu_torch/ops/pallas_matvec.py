"""Kernel B1: the row-batched CG matvec ``p @ A`` (port of
``cggp_tpu/ops/pallas_matvec.py``).

:func:`pallas_matvec` launches the hand-written CUDA kernel
(``csrc/pallas_matvec.cu``) on CUDA tensors and uses its plain version,
:func:`pallas_matvec_plain`, on CPU tensors; on any other device it raises.
Operands must be contiguous float32 on one device: the caller casts (the
JAX wrapper casts to float32 inside, the port's CG route does it outside).
``pallas_matvec.launches`` counts kernel launches.

Arithmetic.  Above 8 rows the kernel computes in 3xTF32 on the tensor
cores: each operand is split into TF32 halves ``hi + lo`` and each product
taken as ``lo hi + hi lo + hi hi``, every 32-deep stage summed from zero on
the tensor cores in two parts, each added to the running sum in IEEE fp32,
which keeps fp32-level error (``csrc/mma_3xtf32.cuh``); the depth is summed
at two levels, the running sum added to an outer sum every
``OUTER_STAGES`` stages (``csrc/tiled_matvec.cuh``).  Up to 8 rows it is
an IEEE fp32 FMA GEMV.  The plain version computes in IEEE fp32 (TF32 stays
off).
:func:`matmul_3xtf32_emulated` repeats the 3xTF32 arithmetic in plain
torch for the tests and the card's smoke run; the main path never calls it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# Depth of one stage of the 3xTF32 kernels: its products are summed from
# zero on the tensor cores and the sum is added to the running fp32 sum.
TF32_STAGE = 32
# Stages between the outer sums of B1's, B2's and B3's two-level depth sums
# (kFlushStages in csrc/tiled_matvec.cuh and csrc/pallas_gram.cu).
OUTER_STAGES = 32


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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to TF32's 10 mantissa bits,
    to nearest with ties away from zero (add half of the 13 dropped bits'
    range to the bit pattern, then clear them)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """``x = hi + lo`` to ~22 significant bits, both TF32 values."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32, truncated (rounded toward zero)."""
    f = x.to(torch.float32)
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def matmul_3xtf32_emulated(a: torch.Tensor, b: torch.Tensor, truncate: bool = False,
                           outer_every: Optional[int] = None) -> torch.Tensor:
    """``a [R, K] @ b [K, N]`` as the 3xTF32 kernels compute it, in plain
    torch.  Each 32-deep stage is summed in the two parts of
    ``csrc/mma_3xtf32.cuh``: the eight small products ``lo hi + hi lo`` of
    its four 8-deep steps with the first two steps' ``hi hi``, then the last
    two steps' ``hi hi``.  Inside a part each large product is added to the
    part's sum and the result rounded to float32, to nearest, or toward
    zero with ``truncate`` as the tensor cores do; the parts are added to
    the running sum in order in IEEE float32 (with ``outer_every``, the
    kernels' two levels: every ``outer_every`` stages the running sum is added to an
    outer sum and restarts from zero).  Not modelled: the roundings
    after each small product (they go first, while the part's sum is
    small)."""
    rows, depth = a.shape
    cols = b.shape[1]
    pad = (-depth) % TF32_STAGE
    stages = (depth + pad) // TF32_STAGE
    steps = TF32_STAGE // 8
    a_hi, a_lo = (F.pad(t, (0, pad)).double() for t in split_tf32(a))
    b_hi, b_lo = (F.pad(t, (0, 0, 0, pad)).double() for t in split_tf32(b))
    to_float = round_toward_zero if truncate else (lambda x: x.to(torch.float32))
    out = torch.empty((rows, cols), dtype=torch.float32, device=a.device)
    block = max(1, (1 << 24) // max(1, stages * steps * cols))  # rows per pass: <= 128 MB
    for r0 in range(0, rows, block):
        def split(t, width):  # [block, K] -> [K / width, block, width]
            return t[r0:r0 + block].reshape(-1, t.shape[1] // width, width).transpose(0, 1)
        small = (torch.bmm(split(a_lo, TF32_STAGE), b_hi.reshape(stages, TF32_STAGE, cols))
                 + torch.bmm(split(a_hi, TF32_STAGE), b_lo.reshape(stages, TF32_STAGE, cols)))
        large = torch.bmm(split(a_hi, 8), b_hi.reshape(stages * steps, 8, cols))
        large = large.reshape(stages, steps, -1, cols)
        first = to_float(to_float(small + large[:, 0]).double() + large[:, 1])
        second = to_float(to_float(large[:, 2]).double() + large[:, 3])
        acc = torch.zeros((first.shape[1], cols), dtype=torch.float32, device=a.device)
        outer = torch.zeros_like(acc)
        for k in range(stages):
            acc = acc + first[k]
            acc = acc + second[k]
            if outer_every and (k + 1) % outer_every == 0:
                outer, acc = outer + acc, torch.zeros_like(acc)
        out[r0:r0 + block] = outer + acc
    return out


def pallas_matvec(p: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``p @ A`` for symmetric ``A``: ``p [R, M]``, ``A [M, M]`` -> ``[R, M]``.

    A gang of G systems, ``p [G, R, M]`` and ``A [G, M, M]``, runs in one
    launch (the gang axis on the grid's third dimension), each member's
    output bitwise that of a launch on the member alone."""
    if not isinstance(p, torch.Tensor) or p.dim() not in (2, 3):
        raise ValueError(f"p must be an [R, M] or [G, R, M] tensor, got "
                         f"{getattr(p, 'shape', type(p))}")
    *lead, rows, m = p.shape
    check_operand("p", p, (*lead, rows, m))
    check_operand("a", a, (*lead, m, m))
    if check_device(p, a) == "cpu":
        return pallas_matvec_plain(p, a)
    gang = lead[0] if lead else 1
    out = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    if gang == 0 or rows == 0 or m == 0:
        return out
    from cggp_tpu_torch import _build

    lib = _build.load()
    # Above 8 rows the kernel first splits each member's A into its TF32
    # halves, tile by tile, in this scratch buffer (8 MB a member at M = 989).
    scratch = None
    if rows > 8:
        words = gang * lib.cggp_pallas_matvec_scratch_words(rows, m)
        scratch = torch.empty((words,), dtype=torch.int32, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    _build.check(lib.cggp_pallas_matvec(p.data_ptr(), a.data_ptr(), out.data_ptr(), gang, rows,
                                        m, None if scratch is None else scratch.data_ptr(),
                                        stream),
                 "pallas_matvec")
    pallas_matvec.launches += 1
    return out


pallas_matvec.launches = 0
