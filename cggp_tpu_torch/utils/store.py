"""Parameter snapshots, the config-dir contract and serving-cache files
(port of ``cggp_tpu/utils/store.py``).

Names are slash-joined paths of the raw (unconstrained) parameter dict, e.g.
``kernel/lengthscales``; a config directory holds ``params.npz`` and
``info.json`` (:func:`save_config_dir`, :func:`load_config_dir`), and
:func:`assign_flat` writes matching names into a model's parameters.  The
files are the JAX package's: a directory written by either package loads in
the other.  :func:`params_from_numpy` turns the JAX package's parameters
(numpy arrays under the same keys, flat or nested) into the port's dict of
tensors, and :func:`adam_state_from_optax` turns ``optax.adam``'s state into
the port's :class:`AdamState`, so a JAX run can resume in the port.

Serving caches (:func:`save_posterior`, :func:`load_posterior`) use the JAX
package's ``posterior.npz`` + ``posterior.json`` encoding, and name the
cache's class by the JAX package's qualified name (``_JAX_CLASS_NAMES``),
the only names the JAX loader accepts; the port reads back exactly those
names through the same fixed table and refuses any other.  It imports
nothing of the JAX package.  :func:`posterior_fingerprint` gives the same
hex string as the JAX package's for the same parameters.

Checkpoints (:func:`save_checkpoint`, :func:`load_checkpoint`) keep the
JAX package's API (one directory per step, the latest by default) in the
port's own format: the JAX package writes orbax checkpoints, which neither
package reads from the other.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from cggp_tpu_torch.config import DeviceLike, resolve_device
from cggp_tpu_torch.models.base import CholPosterior
from cggp_tpu_torch.models.cggp import CGGPPosterior
from cggp_tpu_torch.models.gpr import GPRPosterior
from cggp_tpu_torch.models.itergpr import IterGPRPosterior
from cggp_tpu_torch.models.pathwise import PathwisePosterior
from cggp_tpu_torch.models.rowcg import RowCGGPPosterior
from cggp_tpu_torch.models.sgpr import SGPRPosterior
from cggp_tpu_torch.training.optimize import AdamState

# Serving-cache classes, by the qualified names the JAX package writes and
# reads (its loader imports only from cggp_tpu.*).
_JAX_CLASS_NAMES = {
    CGGPPosterior: ("cggp_tpu.models.cggp", "CGGPPosterior"),
    RowCGGPPosterior: ("cggp_tpu.models.rowcg", "RowCGGPPosterior"),
    IterGPRPosterior: ("cggp_tpu.models.itergpr", "IterGPRPosterior"),
    GPRPosterior: ("cggp_tpu.models.gpr", "GPRPosterior"),
    CholPosterior: ("cggp_tpu.models.base", "CholPosterior"),
    SGPRPosterior: ("cggp_tpu.models.sgpr", "SGPRPosterior"),
    PathwisePosterior: ("cggp_tpu.models.pathwise", "PathwisePosterior"),
}
_PORT_CLASSES = {name: cls for cls, name in _JAX_CLASS_NAMES.items()}
_CHECKPOINT_FORMAT = "cggp_tpu_torch checkpoint 1"


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def flatten_params(params: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a nested dict to ``{"a/b": ndarray}``."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in params.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, prefix=f"{name}/"))
        else:
            flat[name] = _to_numpy(value)
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


def assign_flat(params: Mapping, flat: Mapping[str, np.ndarray], prefix: str = "") -> Dict:
    """``params`` with its leaves overwritten from matching ``flat`` names.

    Names in ``flat`` that match no leaf are ignored and leaves without a
    name in ``flat`` are kept (the reference's ``multiple_assign``); a new
    leaf takes the old leaf's dtype and device."""
    out: Dict = {}
    for key, value in params.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out[key] = assign_flat(value, flat, prefix=f"{name}/")
        elif name in flat:
            out[key] = torch.as_tensor(np.array(_to_numpy(flat[name])), dtype=value.dtype,
                                       device=value.device)
        else:
            out[key] = value
    return out


def save_config_dir(dirpath, params: Mapping, info: Dict) -> None:
    """Write ``params.npz`` (flat names) and ``info.json``."""
    dirpath = Path(dirpath)
    dirpath.mkdir(parents=True, exist_ok=True)
    np.savez(str(dirpath / "params.npz"), **flatten_params(params))
    with open(dirpath / "info.json", "w") as fh:
        json.dump(info, fh, indent=2, default=str)


def store_as_json(path, payload: Dict) -> None:
    """Write ``payload`` as indented JSON (``results.json``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, default=str)


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


# ---------------------------------------------------------------------------
# Checkpoints: the JAX package's API in the port's own format
# ---------------------------------------------------------------------------


def save_checkpoint(dirpath, params: Mapping, step: int = 0) -> None:
    """Write ``params`` at ``{dirpath}/{step}``, replacing a checkpoint of
    that step.  The port's format (``checkpoint.npz`` + ``format.json``):
    the JAX package's orbax checkpoints and these are not readable across
    the packages."""
    path = Path(dirpath) / str(int(step))
    path.mkdir(parents=True, exist_ok=True)
    np.savez(str(path / "checkpoint.npz"), **flatten_params(params))
    with open(path / "format.json", "w") as fh:
        json.dump({"format": _CHECKPOINT_FORMAT, "step": int(step)}, fh)


def load_checkpoint(dirpath, params_like: Mapping, step: Optional[int] = None) -> Dict:
    """Restore the checkpoint at ``step`` (default: the latest) into the
    structure of ``params_like``, each leaf in its template's dtype and on
    its device; a missing name or another shape raises ``ValueError``."""
    base = Path(dirpath)
    if step is None:
        steps = sorted(int(q.name) for q in base.iterdir() if q.name.isdigit())
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {base}")
        step = steps[-1]
    path = base / str(int(step))
    with open(path / "format.json") as fh:
        fmt = json.load(fh).get("format")
    if fmt != _CHECKPOINT_FORMAT:
        raise ValueError(f"{path} holds no checkpoint of this package (format {fmt!r})")
    with np.load(str(path / "checkpoint.npz")) as data:
        flat = {name: data[name] for name in data.files}
    template = flatten_params(params_like)
    for name, like in template.items():
        if name not in flat or flat[name].shape != like.shape:
            got = flat[name].shape if name in flat else "missing"
            raise ValueError(f"checkpoint leaf {name!r}: {got}, want shape {like.shape}")
    return assign_flat(params_like, flat)


# ---------------------------------------------------------------------------
# Serving caches: the JAX package's encoding (arrays to posterior.npz under
# slash-joined paths, the structure to posterior.json)
# ---------------------------------------------------------------------------


def _encode_pytree(obj, path: str, arrays: Dict[str, np.ndarray]):
    """JSON-able structure descriptor; array leaves spilled to ``arrays``."""
    if obj is None:
        return None
    if isinstance(obj, (bool, int, float, str)):
        return {"kind": "scalar", "value": obj}
    if isinstance(obj, Mapping):
        return {"kind": "dict", "items": {str(k): _encode_pytree(v, f"{path}/{k}", arrays)
                                          for k, v in obj.items()}}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        name = _JAX_CLASS_NAMES.get(type(obj))
        if name is None:
            raise TypeError(f"no serving-cache class name for {type(obj).__qualname__}; "
                            f"known: {sorted(c.__qualname__ for c in _JAX_CLASS_NAMES)}")
        return {"kind": "namedtuple", "class": list(name),
                "items": {f: _encode_pytree(v, f"{path}/{f}", arrays)
                          for f, v in zip(obj._fields, obj)}}
    if isinstance(obj, (tuple, list)):
        return {"kind": "tuple" if isinstance(obj, tuple) else "list",
                "items": [_encode_pytree(v, f"{path}/{i}", arrays) for i, v in enumerate(obj)]}
    arrays[path] = _to_numpy(obj)
    return {"kind": "array", "name": path}


def _decode_pytree(desc, arrays, device: torch.device):
    if desc is None:
        return None
    kind = desc["kind"]
    if kind == "scalar":
        return desc["value"]
    if kind == "array":
        return torch.as_tensor(np.array(arrays[desc["name"]]), device=device)
    if kind == "dict":
        return {k: _decode_pytree(v, arrays, device) for k, v in desc["items"].items()}
    if kind in ("tuple", "list"):
        seq = [_decode_pytree(v, arrays, device) for v in desc["items"]]
        return tuple(seq) if kind == "tuple" else seq
    if kind == "namedtuple":
        cls = _PORT_CLASSES.get(tuple(desc["class"]))
        if cls is None:
            # A fixed table, never an import: a tampered sidecar cannot
            # name an arbitrary target.
            raise ValueError(f"refusing posterior class {desc['class']!r}: not one of "
                             f"{sorted('.'.join(n) for n in _PORT_CLASSES)}")
        return cls(**{k: _decode_pytree(v, arrays, device) for k, v in desc["items"].items()})
    raise ValueError(f"unknown descriptor kind: {kind!r}")


def save_posterior(dirpath, post) -> None:
    """Write a serving cache (one of the classes of ``_JAX_CLASS_NAMES``:
    :class:`CGGPPosterior`, :class:`RowCGGPPosterior`,
    :class:`IterGPRPosterior`, :class:`GPRPosterior`, :class:`CholPosterior`,
    :class:`SGPRPosterior`, :class:`PathwisePosterior`; LOVE caches
    included, their ``lanczos_r`` an array field) to
    ``{dirpath}/posterior.{npz,json}``, readable by both packages; dtypes
    are kept exactly."""
    if not (isinstance(post, tuple) and hasattr(post, "_fields")):
        raise TypeError(f"save_posterior expects a posterior NamedTuple, got {type(post)}")
    dirpath = Path(dirpath)
    dirpath.mkdir(parents=True, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    desc = _encode_pytree(post, "post", arrays)
    np.savez(str(dirpath / "posterior.npz"), **arrays)
    with open(dirpath / "posterior.json", "w") as fh:
        json.dump(desc, fh, indent=2)


def load_posterior(dirpath, device: DeviceLike = None):
    """Read back a serving cache written by either package's
    ``save_posterior``, its arrays on ``device`` (``None``: the card) in
    the dtypes they were saved in."""
    device = resolve_device(device)
    dirpath = Path(dirpath)
    with open(dirpath / "posterior.json") as fh:
        desc = json.load(fh)
    with np.load(str(dirpath / "posterior.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}
    return _decode_pytree(desc, arrays, device)


def posterior_fingerprint(model_class: str, params: Mapping, extra: str = "") -> str:
    """Identity of (model class, parameters[, ``extra``]) stored beside a
    serving cache, so a later process can tell the cache was built for other
    parameters.  The JAX package's hash: the same parameters give the same
    hex string in both packages."""
    h = hashlib.sha256(f"{model_class}|{extra}".encode())
    flat = flatten_params(params)
    for name in sorted(flat):
        arr = flat[name]
        h.update(name.encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]
