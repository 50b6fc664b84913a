"""CLI parameter types, the command tree and the model/update-fn factories
(port of ``cggp_tpu/cli/cli_utils.py``).

The JAX package builds its CLI on click; the port's is ``argparse`` with
the same command tree, option strings, defaults, choices and exit codes:

* the four parameter types (:class:`FloatType`, :class:`LogdirPath`,
  :class:`DatasetType`, :class:`KernelType`) are ``type=`` callables with
  click's parsing and error texts; string defaults go through them at
  parse time, as click converts its defaults (so the default
  ``./logs-default`` is made when a command that owns it runs);
* :class:`Command` is one node of the tree: its options, its children and
  the callback that runs with its own options, parents first, the way
  click's chained groups run (``uci [opts] covertree [opts]
  compute-metrics [opts]``).  Each node's options live under their own
  namespace prefix, so ``-d`` can be a dataset on one level and a distance
  on the next;
* click's ``--x/--no-x`` pairs are two options on one destination;
  ``multiple=True`` options append to a fresh list (:class:`_Multiple`);
* :class:`UsageError` exits 2 and :class:`CommandError` exits 1, click's
  ``UsageError`` and ``ClickException``; an argparse parse error exits 2;
  anything else keeps its traceback (exit 1).

The factories return ``(model, params, update_fn)`` triples as the JAX
package's do, with tensors on the run's device (``--device``, resolved by
:func:`~cggp_tpu_torch.config.resolve_device`; never a silent fall back to
the CPU).  ``jitter=None`` and ``positive_minimum=None`` resolve through
:func:`~cggp_tpu_torch.config.default_config`.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import glob as globlib
import inspect
import sys
from functools import reduce
from operator import iconcat
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cggp_tpu_torch.config import default_config, default_float, resolve_device
from cggp_tpu_torch.data import DATASET_NAMES, DatasetBundle, load_data
from cggp_tpu_torch.models import CGGP, GPR, ClusterGP, ImplicitCGGP, IterGPR, LpSVGP, SGPR
from cggp_tpu_torch.models.base import GaussianLikelihood
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.ops.distance import DistanceType, create_distance_fn
from cggp_tpu_torch.ops.kernels import Kernel, kernel_by_name
from cggp_tpu_torch.selection.covernet import covernet_update_inducing_parameters
from cggp_tpu_torch.selection.kmeans import kmeans_lloyd
from cggp_tpu_torch.selection.points import greedy_selection, oips, uniform
from cggp_tpu_torch.selection.update import (covertree_update_inducing_parameters,
                                             kmeans_update_inducing_parameters,
                                             labels_update_inducing_parameters)

MODEL_NAMES = ("sgpr", "cdgp", "cdgp-implicit")
DistanceChoices = list(DistanceType)
ModelChoices = list(MODEL_NAMES)

precision_names = {np.float32: "fp32", np.float64: "fp64"}
_TORCH_DTYPES = {np.float32: torch.float32, np.float64: torch.float64}

# ---------------------------------------------------------------------------
# Errors and output (click's exceptions and echo)
# ---------------------------------------------------------------------------


class CommandError(Exception):
    """A command's failure (click's ``ClickException``): exit code 1."""

    exit_code = 1


class UsageError(CommandError):
    """Wrong use of a command (click's ``UsageError``): exit code 2."""

    exit_code = 2


def echo(message="", err: bool = False) -> None:
    print(message, file=sys.stderr if err else sys.stdout, flush=True)


# ---------------------------------------------------------------------------
# Parameter types (argparse ``type=`` callables; click's error texts)
# ---------------------------------------------------------------------------


class FloatType:
    """``fp32`` / ``fp64`` (any case) to ``np.float32`` / ``np.float64``."""

    __name__ = "dtype"

    def __call__(self, value):
        options = {"fp32": np.float32, "fp64": np.float64}
        try:
            return options[value.lower()]
        except KeyError:
            raise argparse.ArgumentTypeError(f"{value} is not a valid float type [fp32, fp64]")


class LogdirPath:
    """A directory path, expanded and resolved; made (with its parents)
    unless ``mkdir=False``."""

    __name__ = "path"
    default_logdir = "./logs-default"

    def __init__(self, mkdir: bool = True):
        self.mkdir = mkdir

    def __call__(self, value):
        logdir = Path(value).expanduser().resolve()
        if self.mkdir:
            logdir.mkdir(parents=True, exist_ok=True)
        return logdir


class ExistingPath:
    """A path that must exist (click's ``Path(exists=True)``)."""

    __name__ = "path"

    def __call__(self, value):
        if not Path(value).exists():
            raise argparse.ArgumentTypeError(f"Path {value!r} does not exist.")
        return value


class DatasetType:
    """Dataset name, with inline sizes for the synthetic family
    (``synthetic:n=435000:dim=3``); returns ``load_data_fn(seed)``.  The
    full spec stays the bundle's name, so a saved config round-trips to the
    same-sized dataset."""

    __name__ = "dataset"
    datasets = DATASET_NAMES

    def __call__(self, value):
        name, *conf = value.split(":")
        kwargs = {}
        if conf:
            if not name.startswith("synthetic"):
                raise argparse.ArgumentTypeError(
                    f"inline parameters are only supported for synthetic datasets, got "
                    f"{value!r}")
            try:
                for kv in conf:
                    k, v = kv.split("=")
                    kwargs[{"n": "synthetic_n", "dim": "synthetic_dim"}[k]] = int(v)
            except (ValueError, KeyError):
                raise argparse.ArgumentTypeError(
                    f"bad synthetic parameters in {value!r}; use synthetic:n=NNN:dim=D")
            if name == "synthetic1d" and "synthetic_dim" in kwargs:
                raise argparse.ArgumentTypeError(
                    "synthetic1d is fixed to dim=1; use synthetic:dim=D")
        if name not in self.datasets:
            raise argparse.ArgumentTypeError(f"{name} dataset is not supported")

        def load_data_fn(seed: int) -> DatasetBundle:
            bundle = load_data(name, seed=seed, **kwargs)
            return bundle._replace(name=value) if conf else bundle

        return load_data_fn


class KernelType:
    """``se``, ``matern32`` etc., with optional ``_len=..._var=...`` inline
    parameters; returns ``create_kernel_fn(ndim) -> (kernel, init kwargs)``."""

    __name__ = "kernel"
    kernels = ("se", "matern32", "matern12", "matern52")
    param_keymap = {"var": "variance", "len": "lengthscales"}

    @classmethod
    def parse_kernel_parameters(cls, source: str) -> Dict:
        params = [kv.split("=") for kv in source.split("_")]
        return {cls.param_keymap[k]: ast.literal_eval(v) for k, v in params}

    def __call__(self, value):
        try:
            kernel_name, *conf = value.split("_", maxsplit=1)
            if kernel_name not in self.kernels:
                raise KeyError(kernel_name)
            kernel_params = self.parse_kernel_parameters(conf[0]) if conf else {}

            def create_kernel_fn(ndim: int) -> Tuple[Kernel, Dict]:
                kernel = kernel_by_name(kernel_name)
                lengthscales = np.ones(ndim)
                if "lengthscales" in kernel_params:
                    lengthscales = lengthscales * kernel_params["lengthscales"]
                variance = float(kernel_params.get("variance", 1.0))
                return kernel, dict(variance=variance, lengthscales=lengthscales)

            return create_kernel_fn
        except (KeyError, ValueError, SyntaxError):
            raise argparse.ArgumentTypeError(f"{value} is not supported")


def expand_paths_with_wildcards(filepaths: Sequence[str]) -> Sequence[str]:
    full_list = [globlib.glob(str(f)) for f in filepaths]
    return list(reduce(iconcat, full_list, []))


# ---------------------------------------------------------------------------
# The command tree
# ---------------------------------------------------------------------------


class _Multiple(argparse.Action):
    """click's ``multiple=True``: every use appends, the first use to a
    fresh list (the default is not extended)."""

    def __call__(self, parser, namespace, values, option_string=None):
        current = getattr(namespace, self.dest, None)
        items = [] if current is None or current is self.default else list(current)
        items.append(values)
        setattr(namespace, self.dest, items)


class Context:
    """What a callback sees: the run's ``device`` string and ``obj``, the
    dict a group leaves for the commands under it (click's ``ctx.obj``)."""

    def __init__(self, device: str = "cuda"):
        self.device = device
        self.obj: Optional[Dict] = None

    def torch_device(self) -> torch.device:
        """The run's device; no card under ``--device cuda`` is a
        :class:`CommandError` with ``resolve_device``'s message."""
        try:
            return resolve_device(self.device)
        except RuntimeError as err:
            raise CommandError(f"{err} (--device cpu)") from err


class Command:
    """One command or group: options (kept in order), children and the
    callback ``callback(ctx, **options)`` run before any child's."""

    def __init__(self, name: str, callback: Optional[Callable] = None, help: str = ""):
        self.name = name
        self.callback = callback
        self.help = help
        self.params: List[Tuple[str, tuple, dict]] = []
        self.children: Dict[str, "Command"] = {}

    def option(self, *flags: str, dest: Optional[str] = None, multiple: bool = False,
               **kwargs) -> "Command":
        dest = dest or max(flags, key=len).lstrip("-").replace("-", "_")
        if multiple:
            kwargs["action"] = _Multiple
        self.params.append(("option", flags, dict(kwargs, dest=dest)))
        return self

    def flag(self, flag: str, dest: Optional[str] = None, help: Optional[str] = None
             ) -> "Command":
        """An on-only flag (click's ``is_flag=True``), default False."""
        dest = dest or flag.lstrip("-").replace("-", "_")
        self.params.append(("option", (flag,), dict(action="store_true", dest=dest,
                                                    help=help)))
        return self

    def flag_pair(self, on: Sequence[str], off: Sequence[str], dest: str, default: bool,
                  help: Optional[str] = None) -> "Command":
        """click's ``--x/--no-x``: two options on one destination."""
        self.params.append(("pair", (tuple(on), tuple(off)),
                            dict(dest=dest, default=default, help=help)))
        return self

    def argument(self, name: str, **kwargs) -> "Command":
        self.params.append(("argument", (name,), kwargs))
        return self

    def add(self, child: "Command", name: Optional[str] = None) -> "Command":
        self.children[name or child.name] = child
        return self

    def _dests(self) -> List[str]:
        out = []
        for kind, flags, kw in self.params:
            out.append(flags[0] if kind == "argument" else kw["dest"])
        return out

    def build(self, parser: argparse.ArgumentParser, path: str) -> None:
        """Add this node's options to ``parser`` under the prefix ``path``,
        then one subparser per child."""
        for kind, flags, kw in self.params:
            if kind == "argument":
                parser.add_argument(f"{path}:{flags[0]}", metavar=flags[0].upper(), **kw)
                continue
            dest = f"{path}:{kw['dest']}"
            meta = kw["dest"].upper()
            if kind == "pair":
                on, off = flags
                group = parser.add_argument_group()
                group.add_argument(*on, dest=dest, action="store_true", default=kw["default"],
                                   help=kw["help"])
                group.add_argument(*off, dest=dest, action="store_false",
                                   default=kw["default"], help=argparse.SUPPRESS)
                continue
            kw = dict(kw, dest=dest)
            if kw.get("action") in ("store_true",):
                parser.add_argument(*flags, **kw)
            else:
                if "choices" not in kw:
                    kw.setdefault("metavar", meta)
                parser.add_argument(*flags, **kw)
        if self.children:
            sub = parser.add_subparsers(dest=f"{path}:", metavar="COMMAND", required=True)
            for name, child in self.children.items():
                child_parser = sub.add_parser(name, help=child.help, description=child.help,
                                              allow_abbrev=False)
                child.build(child_parser, f"{path}/{name}")

    def run(self, ctx: Context, namespace: argparse.Namespace, path: str = ""):
        """Run this node's callback, then the chosen child's."""
        kwargs = {d: getattr(namespace, f"{path}:{d}") for d in self._dests()}
        if self.callback is not None:
            self.callback(ctx, **kwargs)
        if self.children:
            name = getattr(namespace, f"{path}:")
            self.children[name].run(ctx, namespace, f"{path}/{name}")


def make_parser(root: Command, prog: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=prog, description=root.help, allow_abbrev=False)
    root.build(parser, "")
    return parser


def run_command_line(root: Command, argv: Optional[Sequence[str]], prog: str,
                     ctx: Context) -> int:
    """Parse ``argv`` and run the chain of callbacks: returns 0, or exits
    with click's codes (2 for a usage error, 1 for a command error)."""
    parser = make_parser(root, prog)
    namespace = parser.parse_args(None if argv is None else list(argv))
    try:
        root.run(ctx, namespace, "")
    except UsageError as err:
        echo(parser.format_usage().rstrip(), err=True)
        echo(f"Error: {err}", err=True)
        sys.exit(err.exit_code)
    except CommandError as err:
        echo(f"Error: {err}", err=True)
        sys.exit(err.exit_code)
    return 0


# ---------------------------------------------------------------------------
# Data on the run's device
# ---------------------------------------------------------------------------


def torch_dtype(dtype) -> Optional[torch.dtype]:
    """``np.float32`` / ``np.float64`` (or a torch dtype, or None) as a
    torch dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype).type]


def to_device_bundle(bundle: DatasetBundle, device, dtype=None) -> DatasetBundle:
    """``bundle`` with every array a tensor on ``device`` (in ``dtype``,
    default: the arrays' own)."""
    tdtype = torch_dtype(dtype)

    def move(split):
        return tuple(torch.as_tensor(np.asarray(a), device=device).to(
            tdtype or torch_dtype(np.asarray(a).dtype)) for a in split)

    return DatasetBundle(bundle.name, move(bundle.train), move(bundle.test))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _device_of(data) -> torch.device:
    """The data's device (numpy data: the default device)."""
    if isinstance(data[0], torch.Tensor):
        return data[0].device
    return resolve_device(None)


# ---------------------------------------------------------------------------
# Model factories
# ---------------------------------------------------------------------------


def default_kernel_fn(ndim: int) -> Tuple[Kernel, Dict]:
    """Matern32 with unit ARD lengthscales."""
    return kernel_by_name("matern32"), dict(variance=1.0, lengthscales=np.ones(ndim))


def create_model(
    model_name: str,
    kernel_fn: Callable,
    data,
    num_inducing_points: Optional[int] = None,
    error_threshold: float = 1e-6,
    dtype=None,
    seed: int = 0,
    dot: str = "standard",
    max_cg_iterations: Optional[int] = None,
    jitter: Optional[float] = None,
    relative_threshold: bool = False,
    **model_kwargs,
):
    """Build ``(model, params)`` with a random-subset Z (``RandomState(seed)``,
    the JAX package's draw) and likelihood variance 0.1, on the data's device
    (numpy data: the default device).  ``jitter`` reaches SGPR's Kuu; the CG
    models build Kuu with jitter 0.  ``jitter=None`` resolves from
    :func:`~cggp_tpu_torch.config.default_config`."""
    if jitter is None:
        jitter = default_config().jitter
    device = _device_of(data)
    tdtype = torch_dtype(dtype) or default_float()
    x = _host(data[0])
    n, dim = x.shape[0], x.shape[-1]
    if num_inducing_points is None:
        num_inducing_points = int(n * 0.1)
    rng = np.random.RandomState(seed)
    rand_indices = rng.choice(n, size=num_inducing_points, replace=False)
    iv = x[rand_indices]

    kernel, kernel_init = kernel_fn(dim)
    noise_variance = 0.1
    init = dict(noise_variance=noise_variance, dtype=tdtype, device=device, **kernel_init)

    if model_name == "cdgp":
        model = CGGP(
            kernel=kernel,
            conjugate_gradient=ConjugateGradient(
                error_threshold, max_iterations=max_cg_iterations, dot=dot,
                relative_threshold=relative_threshold,
            ),
            num_data=n,
            **model_kwargs,
        )
        params = model.init_params(iv, **init)
    elif model_name == "cdgp-implicit":
        if dot != "standard":
            raise ValueError(
                "cdgp-implicit's blocked matvec accumulates in HIGHEST precision already; "
                "the compensated-dot option applies to the dense solver only")
        model = ImplicitCGGP(
            kernel=kernel,
            num_data=n,
            error_threshold=error_threshold,
            max_cg_iterations=max_cg_iterations or 100,
            relative_threshold=relative_threshold,
            **model_kwargs,
        )
        params = model.init_params(iv, **init)
    elif model_name == "clustergp":
        model = ClusterGP(kernel=kernel, num_data=n, **model_kwargs)
        params = model.init_params(iv, **init)
    elif model_name == "lpsvgp":
        model = LpSVGP(kernel=kernel, num_data=n, **model_kwargs)
        params = model.init_params(iv, **init)
    elif model_name == "sgpr":
        model = SGPR(kernel=kernel, jitter=jitter, **model_kwargs)
        params = model.init_params(iv, **init)
    elif model_name == "gpr":
        # Data-bound exact-GP serving (predict from a gpr config dir); the
        # bijector bound must be the training run's (info.json records it).
        return create_gpr_model(data, kernel_fn, dtype=tdtype,
                                positive_minimum=model_kwargs.get("positive_minimum"))
    elif model_name == "gpr-iter":
        return create_itergpr_model(
            data, kernel_fn, dtype=tdtype, cg_threshold=error_threshold,
            positive_minimum=model_kwargs.get("positive_minimum"),
            **{k: v for k, v in model_kwargs.items() if k in ("num_probes", "block")},
        )
    else:
        raise ValueError(f"Unknown model {model_name!r}")
    return model, params


def _resolve_positive_minimum(positive_minimum: Optional[float]) -> Optional[float]:
    """``None`` resolves from ``default_config()`` (0.0 there keeps each
    component's own bound)."""
    if positive_minimum is None:
        pm = default_config().positive_minimum
        positive_minimum = pm if pm > 0.0 else None
    return positive_minimum


def create_gpr_model(train_data, kernel_fn: Callable, dtype=None,
                     positive_minimum: Optional[float] = None) -> Tuple[GPR, Dict]:
    """The dense exact GPR with ``kernel_fn``'s kernel; ``positive_minimum``
    is the lower bound of the kernel's and the likelihood's bijectors."""
    positive_minimum = _resolve_positive_minimum(positive_minimum)
    dim = _host(train_data[0]).shape[-1]
    kernel, kernel_init = kernel_fn(dim)
    if positive_minimum is not None:
        kernel = dataclasses.replace(kernel, positive_lower=positive_minimum)
        model = GPR(kernel=kernel, likelihood=GaussianLikelihood(positive_lower=positive_minimum))
    else:
        model = GPR(kernel=kernel)
    params = model.init_params(input_dim=dim, noise_variance=0.1, dtype=torch_dtype(dtype),
                               device=_device_of(train_data), **kernel_init)
    return model, params


def create_itergpr_model(train_data, kernel_fn: Callable, dtype=None,
                         positive_minimum: Optional[float] = None, num_probes: int = 8,
                         cg_threshold: float = 1e-8, block: int = 4096):
    """The matrix-free CG exact GPR: the dense GPR's parameter tree and
    config-dir contract, the [N, N] system never materialised."""
    positive_minimum = _resolve_positive_minimum(positive_minimum)
    dim = _host(train_data[0]).shape[-1]
    n = int(train_data[0].shape[0])
    kernel, kernel_init = kernel_fn(dim)
    kw = dict(
        error_threshold=cg_threshold, relative_threshold=True,
        max_cg_iterations=min(n, 1000), num_probes=num_probes,
        logdet_variant="slq", precondition="pivchol",
        precond_rank=min(128, max(8, n // 8)), block=block,
    )
    if positive_minimum is not None:
        kernel = dataclasses.replace(kernel, positive_lower=positive_minimum)
        model = IterGPR(kernel=kernel,
                        likelihood=GaussianLikelihood(positive_lower=positive_minimum), **kw)
    else:
        model = IterGPR(kernel=kernel, **kw)
    params = model.init_params(input_dim=dim, noise_variance=0.1, dtype=torch_dtype(dtype),
                               device=_device_of(train_data), **kernel_init)
    return model, params


# ---------------------------------------------------------------------------
# Update-fn factories
# ---------------------------------------------------------------------------


def _apply_selection(model, params: Dict, iv, means, counts) -> Dict:
    """The per-model assignment of a selection."""
    if isinstance(model, ClusterGP):  # CGGP and the row models are ClusterGPs
        return model.assign_clusters(params, iv, means, counts)
    new = dict(params)
    z = params["inducing_points"]
    new["inducing_points"] = torch.as_tensor(iv).to(device=z.device, dtype=z.dtype)
    return new


def _distance_fn(model, params: Dict, distance_type: str):
    if distance_type == "euclidean":
        return None  # the fast path of k-means and the cover tree
    return create_distance_fn(model.kernel, params["kernel"], distance_type)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def create_update_fn(
    clustering_type: str,
    model,
    data,
    distance_type: str = "euclidean",
    seed: int = 0,
    **clustering_kwargs,
) -> Callable[[Dict], Dict]:
    """``update_fn(params) -> params`` for one selection strategy.  The
    kernel-dependent strategies (oips, greedy, kernel distances) read the
    kernel parameters at call time; uniform and greedy draw from a
    generator seeded ``seed`` afresh each call (JAX's fixed key)."""
    x, _y = data

    if clustering_type == "kmeans":
        max_points = int(clustering_kwargs["max_points"])

        def update_fn(params: Dict) -> Dict:
            dist = _distance_fn(model, params, distance_type)
            iv_init = params["inducing_points"]
            if "inducing_mask" in params:
                # Capacity pads never seed Lloyd's.
                real = params["inducing_mask"][:, 0] > 0.5
                iv_init = iv_init[real]
            if iv_init.shape[0] != max_points:
                idx = np.random.RandomState(seed).choice(x.shape[0], max_points, replace=False)
                iv_init = x[torch.as_tensor(idx, device=x.device)]
            iv_init = iv_init.detach().to(device=x.device, dtype=x.dtype)

            def clustering():
                return kmeans_lloyd(x, max_points, initial_centroids=iv_init,
                                    distance_fn=dist)[0]

            iv, means, counts = kmeans_update_inducing_parameters(data, clustering,
                                                                  distance_fn=dist)
            return _apply_selection(model, params, iv, means, counts)

    elif clustering_type == "kmeans2":
        from scipy.cluster.vq import kmeans2 as scipy_kmeans2

        max_points = int(clustering_kwargs["max_points"])

        def update_fn(params: Dict) -> Dict:
            dist = _distance_fn(model, params, distance_type)

            def clustering():
                centroids = scipy_kmeans2(_host(x), max_points, minit="++", seed=seed)[0]
                return torch.as_tensor(centroids).to(device=x.device, dtype=x.dtype)

            iv, means, counts = kmeans_update_inducing_parameters(data, clustering,
                                                                  distance_fn=dist)
            return _apply_selection(model, params, iv, means, counts)

    elif clustering_type == "covertree":
        spatial_resolution = float(clustering_kwargs["spatial_resolution"])

        def update_fn(params: Dict) -> Dict:
            dist = _distance_fn(model, params, distance_type)
            iv, means, counts = covertree_update_inducing_parameters(
                data, spatial_resolution, distance_fn=dist)
            return _apply_selection(model, params, iv, means, counts)

    elif clustering_type == "covernet":
        spatial_resolution = float(clustering_kwargs["spatial_resolution"])
        covernet_kwargs = {k: clustering_kwargs[k] for k in ("max_points", "lloyds", "block_size")
                           if clustering_kwargs.get(k) is not None}
        if distance_type != "euclidean":
            # Lloyd's mean-shift is euclidean geometry: an explicit --lloyds
            # is refused rather than dropped.
            if clustering_kwargs.get("lloyds"):
                raise ValueError("covernet Lloyd's refinement is euclidean-only; drop --lloyds "
                                 f"with -d {distance_type}")
            covernet_kwargs["lloyds"] = 0

        def update_fn(params: Dict) -> Dict:
            # The net honours the kernel metric, read from the current
            # kernel parameters, so re-selection follows them.
            kernel_kwargs = ({} if distance_type == "euclidean"
                             else {"kernel": model.kernel, "kernel_params": params["kernel"]})
            iv, means, counts = covernet_update_inducing_parameters(
                data, spatial_resolution, distance_type=distance_type, **kernel_kwargs,
                **covernet_kwargs)
            return _apply_selection(model, params, iv, means, counts)

    elif clustering_type == "oips":
        rho = float(clustering_kwargs["rho"])
        max_points = clustering_kwargs.get("max_points") or x.shape[0]

        def update_fn(params: Dict) -> Dict:
            dist = _distance_fn(model, params, distance_type)
            iv, _idx = oips(model.kernel, params["kernel"], x, rho, int(max_points))
            iv, means, counts = labels_update_inducing_parameters(data, iv, distance_fn=dist)
            return _apply_selection(model, params, iv, means, counts)

    elif clustering_type == "uniform":
        max_points = int(clustering_kwargs["max_points"])
        if max_points > x.shape[0]:
            raise ValueError("Max points cannot be larger than the dataset size")

        def update_fn(params: Dict) -> Dict:
            dist = _distance_fn(model, params, distance_type)
            iv, _idx = uniform(x, max_points, _generator(x.device, seed))
            iv, means, counts = labels_update_inducing_parameters(data, iv, distance_fn=dist)
            return _apply_selection(model, params, iv, means, counts)

    elif clustering_type == "greedy":
        max_points = int(clustering_kwargs["max_points"])

        def update_fn(params: Dict) -> Dict:
            dist = _distance_fn(model, params, distance_type)
            iv, _idx = greedy_selection(model.kernel, params["kernel"], x, max_points,
                                        _generator(x.device, seed))
            iv, means, counts = labels_update_inducing_parameters(data, iv, distance_fn=dist)
            return _apply_selection(model, params, iv, means, counts)

    else:
        raise ValueError(f"Unknown clustering type {clustering_type!r}")

    def no_grad_update(params: Dict) -> Dict:
        with torch.no_grad():
            return update_fn(params)

    return no_grad_update


def create_model_and_update_fn(
    model_name: str,
    train_data,
    clustering_type: str,
    distance_type: str = "euclidean",
    error_threshold: float = 1e-6,
    dtype=None,
    seed: int = 0,
    dot: str = "standard",
    jitter: Optional[float] = None,
    relative_threshold: bool = False,
    model_kwargs: Optional[Dict] = None,
    clustering_kwargs: Optional[Dict] = None,
    kernel_fn: Optional[Callable] = None,
):
    """Build ``(model, params, update_fn)``; ``kernel_fn`` defaults to
    Matern32.  One ``model_kwargs`` dict may serve both CG models: keys that
    are fields of the other CG class only (``block``, ``use_pallas`` on the
    dense leg) are dropped, never ``create_model``'s own parameters; a key
    that is a field of neither class reaches the constructor and raises."""
    model_kwargs = model_kwargs or {}
    clustering_kwargs = clustering_kwargs or {}
    if kernel_fn is None:
        kernel_fn = default_kernel_fn
    if model_name not in ("cdgp", "cdgp-implicit"):
        # CG-solver knobs only apply to the CG-powered models.
        model_kwargs = {k: v for k, v in model_kwargs.items()
                        if k not in ("num_probes", "logdet_variant", "precondition",
                                     "precond_rank", "block")}
    else:
        target = ImplicitCGGP if model_name == "cdgp-implicit" else CGGP
        other = CGGP if model_name == "cdgp-implicit" else ImplicitCGGP
        only_other = ({f.name for f in dataclasses.fields(other)}
                      - {f.name for f in dataclasses.fields(target)})
        only_other -= set(inspect.signature(create_model).parameters)
        model_kwargs = {k: v for k, v in model_kwargs.items() if k not in only_other}
    model, params = create_model(
        model_name,
        kernel_fn,
        train_data,
        error_threshold=error_threshold,
        dtype=dtype,
        seed=seed,
        dot=dot if model_name == "cdgp" else "standard",
        jitter=jitter,
        relative_threshold=relative_threshold,
        **model_kwargs,
    )
    update_fn = create_update_fn(clustering_type, model, train_data, distance_type=distance_type,
                                 seed=seed, **clustering_kwargs)
    return model, params, update_fn


# ---------------------------------------------------------------------------
# Prediction helpers
# ---------------------------------------------------------------------------


def dump_posterior_arrays(model, params, train_data, x, batch_size: int,
                          mean_only: bool = False, posterior_solver: str = "auto", mesh=None,
                          posterior=None, chunk_iterations: int = 0):
    """Posterior ``(mean, var)`` over ``x`` as numpy, through
    ``predict_in_batches`` and the model's posterior cache (the data-bound
    models with the training set bound in); ``mean_only`` serves the
    solve-free cached mean."""
    from cggp_tpu_torch.training.optimize import predict_in_batches

    needs_data = "data" in inspect.signature(model.predict_f).parameters
    with torch.no_grad():
        mean, var = predict_in_batches(
            model, params, x, batch_size=batch_size,
            train_data=train_data if needs_data else None,
            mean_only=mean_only, posterior_solver=posterior_solver, mesh=mesh,
            posterior=posterior, chunk_iterations=chunk_iterations,
        )
    return _host(mean), None if var is None else _host(var)


def covariance_properties(model, params: Dict, jitter: float, method: str = "auto") -> Dict:
    """``condition_number`` / ``eig_min`` / ``eig_max`` of ``Kuu + jitter I``.

    The row models (``cdgp-implicit``) never build [M, M]: a matrix-free
    Lanczos through ``model._matvec`` with ``lam = jitter``, the start row
    masked to the real coordinates.  Otherwise ``"exact"`` is a dense
    ``eigvalsh``, ``"lanczos"`` the extremal Ritz values, and ``"auto"``
    picks lanczos above M = 4096.  ``estimator`` names what produced the
    numbers (lanczos' ``eig_min`` is an over-estimate); ``condition_method``
    keeps the older {exact, lanczos} vocabulary."""
    from cggp_tpu_torch.ops.logdet import lanczos_extremal_eigs, lanczos_extremal_eigs_rows

    z = params["inducing_points"]
    m = z.shape[0]
    with torch.no_grad():
        if hasattr(model, "_matvec") and "inducing_mask" in params:
            kp = params["kernel"]
            mask = params["inducing_mask"][:, 0]
            lam = torch.full((m,), jitter, dtype=z.dtype, device=z.device)
            lo, hi = lanczos_extremal_eigs_rows(
                lambda rows: model._matvec(kp, z, lam, mask, rows), _generator(z.device, 0), m,
                z.dtype, num_iters=min(96, m), mask=mask)
            eig_min, eig_max = float(lo), float(hi)
            return dict(condition_number=eig_max / eig_min, eig_min=eig_min, eig_max=eig_max,
                        estimator="lanczos", condition_method="lanczos",
                        eig_min_is_upper_bound=True)
        kuu = model.kernel.K(params["kernel"], z)
        kuu = kuu + jitter * torch.eye(m, dtype=z.dtype, device=z.device)
        if method == "auto":
            method = "exact" if m <= 4096 else "lanczos"
        if method == "lanczos":
            lo, hi = lanczos_extremal_eigs(kuu, _generator(z.device, 0), num_iters=min(96, m))
            eig_min, eig_max = float(lo), float(hi)
            estimator = "lanczos"
        else:
            eigvals = _host(torch.linalg.eigvalsh(kuu))
            eig_min, eig_max = float(eigvals.min()), float(eigvals.max())
            estimator = "eigvalsh"
    return dict(
        condition_number=eig_max / eig_min, eig_min=eig_min, eig_max=eig_max,
        condition_method=method,
        estimator=estimator,
        eig_min_is_upper_bound=(estimator == "lanczos"),
    )
