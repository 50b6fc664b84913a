"""Parameter snapshots and the config-dir contract (port of
``cggp_tpu/utils/store.py``).

Names are slash-joined paths of the raw (unconstrained) parameter dict, e.g.
``kernel/lengthscales``; a directory holds ``params.npz`` and ``info.json``.
:func:`params_from_numpy` turns the JAX package's parameters (numpy arrays
under the same keys, flat or nested) into the port's dict of tensors, and
:func:`adam_state_from_optax` turns ``optax.adam``'s state into the port's
:class:`AdamState`, so a JAX run can resume in the port.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from cggp_tpu_torch.config import DeviceLike, resolve_device
from cggp_tpu_torch.training.optimize import AdamState


def flatten_params(params: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a nested dict to ``{"a/b": ndarray}``."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in params.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, prefix=f"{name}/"))
        elif isinstance(value, torch.Tensor):
            flat[name] = value.detach().cpu().numpy()
        else:
            flat[name] = np.asarray(value)
    return flat


def unflatten_params(flat: Mapping[str, np.ndarray]) -> Dict:
    """Inverse of :func:`flatten_params` (leaves stay as given)."""
    nested: Dict = {}
    for name, value in flat.items():
        parts = name.split("/")
        node = nested
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return nested


def params_from_numpy(flat_or_tree: Mapping, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Dict:
    """The port's parameter dict from numpy-like leaves, flat (``"a/b"``
    names) or nested; floating leaves are cast to ``dtype`` when given.

    Values are taken as they are — unconstrained, as both packages store
    them — so JAX parameters carry over unchanged."""
    device = resolve_device(device)
    tree = unflatten_params(flatten_params(flat_or_tree))

    def convert(node):
        if isinstance(node, Mapping):
            return {key: convert(value) for key, value in node.items()}
        array = np.array(node)  # a writable copy: torch shares its memory
        target = dtype if dtype is not None and np.issubdtype(array.dtype, np.floating) else None
        return torch.as_tensor(array, device=device, dtype=target)

    return convert(tree)


def adam_state_from_optax(state, device: DeviceLike = None,
                          dtype: Optional[torch.dtype] = None) -> AdamState:
    """The port's :class:`AdamState` from optax's ``ScaleByAdamState``
    (``count``, ``mu``, ``nu``, numpy-like leaves), or from the tuple
    ``optax.adam(...).init`` returns, which holds one; ``mu`` and ``nu``
    convert as :func:`params_from_numpy` does."""
    if not hasattr(state, "mu"):
        found = [s for s in state if hasattr(s, "mu")]
        if len(found) != 1:
            raise ValueError("adam_state_from_optax: expected one ScaleByAdamState "
                             f"(count, mu, nu), found {len(found)}")
        state = found[0]
    return AdamState(count=int(np.asarray(state.count)),
                     mu=params_from_numpy(state.mu, device=device, dtype=dtype),
                     nu=params_from_numpy(state.nu, device=device, dtype=dtype))


def load_config_dir(dirpath) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Read back ``(flat params, info)`` from ``params.npz`` + ``info.json``."""
    dirpath = Path(dirpath)
    with np.load(str(dirpath / "params.npz")) as data:
        flat = {name: data[name] for name in data.files}
    info_path = dirpath / "info.json"
    info = {}
    if info_path.exists():
        with open(info_path) as fh:
            info = json.load(fh)
    return flat, info
