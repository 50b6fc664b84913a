"""The rank mesh and its collectives (port of ``cggp_tpu/parallel/mesh.py``).

JAX runs one process over N devices; the port runs one process per rank,
each on its own device, over ``torch.distributed``.  A :class:`Mesh` holds
the process group, its size, this rank and this rank's device.  Every rank
calls each parallel function with the same full arguments and gets the
same replicated result (JAX's "shardings in, replicated out"):
:func:`shard_batch` hands a rank its row block, :func:`replicate` makes
every rank hold rank 0's bits, :func:`all_gather_rows` puts row blocks back
together.

Start N ranks with ``torchrun --nproc-per-node N`` (one card each), or
initialise the default group yourself (the tests start gloo worlds from a
``FileStore``).  With no group and ``n`` None or 1, :func:`make_mesh`
starts a one-rank group: NCCL on the card, gloo on the CPU, from an
in-process store (no port).  A failed NCCL start raises; nothing falls
back to gloo.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cggp_tpu_torch.config import DeviceLike, resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks: ``size`` ranks of ``group`` (None: the default
    group), this process being ``rank`` on ``device``."""

    size: int
    rank: int
    device: torch.device
    group: object = None
    axis_name: str = DATA_AXIS

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis_name,)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS,
              device: DeviceLike = None) -> Mesh:
    """A mesh over every rank of the running group (started here as a
    one-rank group when none runs and ``n_devices`` is None or 1).
    ``n_devices`` other than the world size raises ``ValueError``: a
    silently different mesh would change shardings and padding.  ``device``
    is the rank's device type (``"cuda"`` unless the caller asks for the
    CPU); on the card each rank takes ``cuda:LOCAL_RANK``."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_mesh: requested {n_devices} devices but only 1 rank is running — start "
                "the ranks with torchrun --nproc-per-node N (a silently smaller mesh would "
                "change shardings and padding without warning)")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"make_mesh: requested {n_devices} devices but the running group has {world} "
            "ranks — a silently different mesh would change shardings and padding without "
            "warning")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    return Mesh(size=world, rank=rank, device=dev, axis_name=axis_name)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's row block of each array (row counts must divide the
    mesh size: pads are the caller's job, :func:`pad_rows_to_multiple`)."""
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        n = a.shape[0]
        if n % mesh.size != 0:
            raise ValueError(f"shard_batch: {n} rows do not divide over the {mesh.size}-rank "
                             "mesh")
        block = n // mesh.size
        out.append(a[mesh.rank * block:(mesh.rank + 1) * block])
    return tuple(out) if len(out) != 1 else out[0]


def replicate(mesh: Mesh, tree):
    """``tree`` (tensors in dicts, tuples and named tuples) with every
    tensor replaced by rank 0's bits, broadcast to each rank."""
    if isinstance(tree, torch.Tensor):
        out = tree.detach().clone().contiguous()
        dist.broadcast(out, src=0, group=mesh.group)
        return out
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate(mesh, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(mesh, v) for v in tree)
    return tree


def pad_rows_to_multiple(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    """Zero-pad rows to a multiple; returns ``(padded, original_n)``."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, rem)), n


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, on every rank (a new tensor)."""
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def agree_max(mesh: Mesh, flag: torch.Tensor) -> torch.Tensor:
    """A boolean flag OR-ed over the ranks (a MAX all-reduce): one stop
    decision for every rank."""
    out = flag.to(torch.int32).contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group)
    return out.bool()


def all_gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The ranks' row blocks of equal size concatenated in rank order, on
    every rank."""
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=0)


class _Total(torch.autograd.Function):
    """The sum over the ranks; the gradient passes through to this rank's
    part."""

    @staticmethod
    def forward(ctx, mesh, t):
        return all_reduce_sum(mesh, t)

    @staticmethod
    def backward(ctx, grad):
        return None, grad


class _SumGrads(torch.autograd.Function):
    """Identity on its tensors; their gradients summed over the ranks in one
    all-reduce."""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        summed = all_reduce_sum(ctx.mesh, flat)
        out, at = [], 0
        for g in grads:
            out.append(summed[at:at + g.numel()].view_as(g))
            at += g.numel()
        return (None, *out)


def total(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiable: each rank's gradient
    reaches its own part."""
    return _Total.apply(mesh, t)


def sum_grads(mesh: Mesh, tree):
    """``tree`` (tensors in dicts and tuples) passed through, the gradients
    of its tensors that require grad summed over the ranks in one
    all-reduce."""
    leaves = []

    def collect(node):
        if isinstance(node, torch.Tensor):
            if node.requires_grad:
                leaves.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                collect(v)

    collect(tree)
    if not leaves:
        return tree
    swapped = dict(zip(map(id, leaves), _SumGrads.apply(mesh, *leaves)))

    def rebuild(node):
        if isinstance(node, torch.Tensor):
            return swapped.get(id(node), node)
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(v) for v in node)
        return node

    return rebuild(tree)
