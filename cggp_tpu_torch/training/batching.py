"""Minibatch streams (port of ``cggp_tpu/training/batching.py``).

Epoch permutations are drawn on the host from ``np.random.default_rng(seed)``,
as in the JAX package; the data stay where they are and each batch is a
gather on their device.  Where JAX derives the integer seed from a PRNG key
(``jax.random.randint(key, (), 0, int32 max)``), the port draws it from the
caller's ``torch.Generator`` (:func:`seed_from`); an int is taken as the
seed itself, so both packages can be fed the same one.
"""

from __future__ import annotations

from typing import Iterator, Tuple, Union

import numpy as np
import torch

from cggp_tpu_torch.config import DeviceLike, resolve_device

Key = Union[torch.Generator, int]


def seed_from(key: Key) -> int:
    """The numpy seed of a stream: ``key`` itself when it is an int, else one
    draw in ``[0, int32 max)`` from the generator (a host read)."""
    if isinstance(key, torch.Generator):
        draw = torch.randint(0, np.iinfo(np.int32).max, (), generator=key, device=key.device)
        return int(draw)
    return int(key)


def minibatch_iterator(
    key: Key,
    data: Tuple[torch.Tensor, torch.Tensor],
    batch_size: int,
    drop_remainder: bool = True,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Infinite shuffled minibatch stream of ``(x[idx], y[idx])``, gathered on
    the data's device.  With ``drop_remainder=True`` every batch has
    ``min(batch_size, N)`` rows."""
    x, y = data
    n = x.shape[0]
    if drop_remainder:
        for idx_block in minibatch_index_iterator(key, n, batch_size, 1, device=x.device):
            idx = idx_block[0]
            yield x[idx], y[idx]
        return
    batch_size = min(int(batch_size), n)
    rng = np.random.default_rng(seed_from(key))
    while True:
        perm = rng.permutation(n)
        for start in range(0, n, batch_size):
            idx = torch.as_tensor(perm[start:start + batch_size], device=x.device)
            yield x[idx], y[idx]


def batched_indices(n: int, batch_size: int) -> Iterator[np.ndarray]:
    """Sequential index batches for full-dataset evaluation passes."""
    for start in range(0, n, batch_size):
        yield np.arange(start, min(start + batch_size, n))


def minibatch_index_iterator(
    key: Key,
    n: int,
    batch_size: int,
    chunk: int,
    device: DeviceLike = None,
) -> Iterator[torch.Tensor]:
    """Infinite stream of ``[chunk, batch_size]`` int64 index blocks from
    epoch permutations (a partial last batch of an epoch is dropped), each
    moved to ``device`` in one copy: the index feed of the K-step trainer."""
    device = resolve_device(device)
    batch_size = min(int(batch_size), n)
    rng = np.random.default_rng(seed_from(key))
    buf = []
    while True:
        perm = rng.permutation(n)
        limit = (n // batch_size) * batch_size
        for start in range(0, limit, batch_size):
            buf.append(perm[start:start + batch_size])
            if len(buf) == chunk:
                yield torch.as_tensor(np.stack(buf), dtype=torch.int64).to(device)
                buf = []
