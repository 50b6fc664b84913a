"""Posterior mean and variance dumps from a saved run (port of
``cggp_tpu/cli/predict.py``).

Loads ``params.npz`` + ``info.json`` from a config dir (either package's),
rebuilds the model it describes (its kernel, precision, solver fields),
strips capacity pad rows, and writes ``{split}_mean.npy`` /
``{split}_variances.npy``.  ``--posterior-dir`` keeps the serving cache in
the JAX package's files: a cache on disk is loaded (its fingerprint must
match these parameters), else it is built once, checked finite (an
auto-picked Cholesky cache that is not falls back to CG) and saved.
``--chunk-iterations`` builds the cache in host-driven chunks.
``--num-devices N`` serves data-parallel over the N-rank world (``torchrun
--nproc-per-node N``; on one card N = 1; another N raises ``make_mesh``'s
``ValueError``): each rank serves its rows of every batch.
"""

from __future__ import annotations

import inspect
import json
import time
from pathlib import Path

import numpy as np
import torch

from cggp_tpu_torch.cli.cli_utils import (Command, CommandError, Context,
                                          DatasetType, LogdirPath, create_model,
                                          default_kernel_fn, dump_posterior_arrays, echo,
                                          to_device_bundle)
from cggp_tpu_torch.config import Config, default_float, enable_x64_if_needed
from cggp_tpu_torch.ops.kernels import kernel_by_name
from cggp_tpu_torch.utils.store import (assign_flat, load_config_dir, load_posterior,
                                        posterior_fingerprint, save_posterior)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (tuple, list)):  # NamedTuple caches included
        for value in tree:
            yield from _tensors(value)


def _posterior_finite(post) -> bool:
    """True iff every floating tensor of the serving cache is finite."""
    return all(bool(torch.isfinite(t).all()) for t in _tensors(post)
               if t.is_floating_point() or t.is_complex())


def _write_meta(meta_path: Path, fingerprint: str, model_class: str) -> None:
    meta_path.write_text(json.dumps({"fingerprint": fingerprint, "model_class": model_class}))


def run(ctx: Context, config_dir, logdir, model_class, test_batch_size, error_threshold,
        mean_only, serving_solver, posterior_dir, num_devices, chunk_iterations) -> None:
    device = ctx.torch_device()
    flat, info = load_config_dir(config_dir)
    dataset_name = info.get("dataset_name", info.get("dataset"))
    seed = int(info.get("seed", 0))

    # Serve at the run's precision: an fp64 run served in fp32 would
    # downcast every hyperparameter on assignment.
    if info.get("precision") == "fp64":
        enable_x64_if_needed(Config(dtype_name="float64"))
    dataset = to_device_bundle(DatasetType()(dataset_name)(seed), device, default_float())

    # Rebuild with the kernel the run was trained with (all kernels share
    # parameter names, so a wrong one would assign cleanly).
    kernel_name = info.get("kernel")
    if kernel_name:
        def kernel_fn(dim):
            return kernel_by_name(kernel_name), dict(variance=1.0, lengthscales=np.ones(dim))
    else:
        kernel_fn = default_kernel_fn
        echo("WARNING: info.json records no kernel; assuming matern32 — posteriors are "
             "wrong if the run used a different kernel.", err=True)

    # Capacity-padded or sharded runs carry pad rows (inducing_mask == 0):
    # the rebuild has no mask of its own, so strip them.
    if "inducing_mask" in flat:
        real = np.asarray(flat["inducing_mask"])[:, 0] > 0.5
        if not real.all():
            echo(f"stripping {int((~real).sum())} sharded pad rows ({int(real.sum())} real "
                 "inducing points)")
            for name in ("inducing_points", "pseudo_u", "cluster_counts"):
                if name in flat:
                    flat[name] = np.asarray(flat[name])[real]
        flat.pop("inducing_mask", None)

    m = flat["inducing_points"].shape[0] if "inducing_points" in flat else None
    model_kwargs = {}
    if model_class == "cdgp-implicit" and info.get("block"):
        model_kwargs["block"] = int(info["block"])
    if model_class in ("gpr", "gpr-iter"):
        # The exact GP with the training run's bijector bound and solver shape.
        if info.get("positive_minimum") is not None:
            model_kwargs["positive_minimum"] = float(info["positive_minimum"])
        if model_class == "gpr-iter":
            if info.get("block"):
                model_kwargs["block"] = int(info["block"])
            if info.get("num_probes"):
                model_kwargs["num_probes"] = int(info["num_probes"])
    if model_class in ("cdgp", "cdgp-implicit"):
        # The training run's solver configuration: without it the serving
        # solves of an ill-conditioned large-M system would degrade.
        if info.get("precondition") not in (None, "none"):
            model_kwargs["precondition"] = info["precondition"]
            if info.get("precond_rank"):
                model_kwargs["precond_rank"] = int(info["precond_rank"])
        if info.get("max_cg_iterations"):
            model_kwargs["max_cg_iterations"] = int(info["max_cg_iterations"])
    model, params = create_model(
        model_class, kernel_fn, dataset.train,
        num_inducing_points=m, error_threshold=error_threshold, seed=seed,
        relative_threshold=bool(info.get("relative_threshold", False)),
        **model_kwargs,
    )

    had_pseudo_u = "pseudo_u" in flat
    if "inducing_mask" in params and all(
            k in flat for k in ("inducing_points", "pseudo_u", "cluster_counts")):
        # Row models pad at their own serving multiple: re-pad the real rows
        # through the model, then assign the rest by name.
        params = model.assign_clusters(params, flat.pop("inducing_points"),
                                       flat.pop("pseudo_u"), flat.pop("cluster_counts"))
    params = assign_flat(params, flat)
    if "pseudo_u" in params and not had_pseudo_u:
        echo("WARNING: config dir carries no pseudo_u (hyperparameters only); posterior means "
             "will be identically zero. Pass a trained cdgp/geospatial config dir for "
             "non-trivial means.", err=True)

    mesh = None
    if num_devices is not None:
        from cggp_tpu_torch.parallel import make_mesh

        mesh = make_mesh(num_devices, device=device)
        echo(f"data-parallel serving over {num_devices} devices")

    post = None
    cache_on_disk = posterior_dir is not None and Path(posterior_dir, "posterior.json").exists()
    with torch.no_grad():
        if chunk_iterations > 0 and not cache_on_disk:
            if not hasattr(model, "posterior_chunked"):
                raise CommandError(f"{model_class} has no dispatch-bounded posterior build; "
                                   "drop --chunk-iterations")
            solver = serving_solver if serving_solver != "chol" else "cg"
            post = model.posterior_chunked(params, dataset.train, solver=solver,
                                           chunk_iterations=chunk_iterations)
            echo(f"serving cache built in bounded chunks (<= {chunk_iterations} CG iterations "
                 f"/ one matvec per dispatch, solver {solver})")
        if posterior_dir is not None:
            post = _posterior_from_dir(model, model_class, params, dataset, dataset_name, seed,
                                       posterior_dir, post, serving_solver, device)

    t0 = time.perf_counter()
    for split_name, split in (("train", dataset.train), ("test", dataset.test)):
        mean, var = dump_posterior_arrays(
            model, params, dataset.train, split[0], test_batch_size,
            mean_only=mean_only, posterior_solver=serving_solver, mesh=mesh,
            posterior=post, chunk_iterations=chunk_iterations,
        )
        np.save(Path(logdir, f"{split_name}_mean.npy"), mean)
        if var is not None:
            np.save(Path(logdir, f"{split_name}_variances.npy"), var)
        echo(f"{split_name}: mean {mean.shape}, var {'skipped' if var is None else var.shape}")
    points = int(dataset.train[0].shape[0] + dataset.test[0].shape[0])
    echo(f"predict wall: {json.dumps({'points': points, 'serve_s': time.perf_counter() - t0})}",
         err=True)
    echo("=== Script finished ===")


def _posterior_from_dir(model, model_class, params, dataset, dataset_name, seed,
                        posterior_dir, post, serving_solver, device):
    """Load the cache under ``posterior_dir`` (refusing one built for other
    parameters), or save ``post`` / a freshly built cache there."""
    # Data-bound caches are stale across datasets even with equal
    # hyperparameters: the dataset's identity is part of the fingerprint.
    shape = tuple(dataset.train[0].shape)
    fingerprint = posterior_fingerprint(model_class, params,
                                        extra=f"{dataset_name}|{seed}|{shape}")
    meta_path = Path(posterior_dir, "cache_meta.json")
    if Path(posterior_dir, "posterior.json").exists():
        if meta_path.exists():
            meta = json.loads(meta_path.read_text())
            if meta.get("fingerprint") != fingerprint:
                raise CommandError(
                    f"serving cache at {posterior_dir} was built for a different model/params "
                    f"(fingerprint {meta.get('fingerprint')} != {fingerprint}); delete the "
                    "directory to rebuild")
        else:
            echo(f"WARNING: serving cache at {posterior_dir} has no cache_meta.json "
                 "fingerprint; cannot verify it matches this config — delete the directory "
                 "to rebuild safely.", err=True)
        post = load_posterior(posterior_dir, device=device)
        echo(f"serving cache loaded from {posterior_dir} (build skipped)")
        return post
    if post is not None:
        # Built above in bounded chunks; persist it.
        if not _posterior_finite(post):
            raise CommandError("chunk-built serving cache is non-finite; not saving.")
        save_posterior(posterior_dir, post)
        _write_meta(meta_path, fingerprint, model_class)
        echo(f"serving cache built and saved to {posterior_dir}")
        return post
    if not hasattr(model, "posterior"):
        echo(f"WARNING: {model_class} has no posterior cache; --posterior-dir ignored",
             err=True)
        return None
    sig = inspect.signature(model.posterior).parameters
    solver = serving_solver
    if solver == "auto" and hasattr(model, "resolve_serving_solver"):
        solver = model.resolve_serving_solver(params)
    kwargs = {"solver": solver} if "solver" in sig else {}

    def build(kw):
        return (model.posterior(params, dataset.train, **kw) if "data" in sig
                else model.posterior(params, **kw))

    post = build(kwargs)
    # A non-finite factor saved would poison every later run of the
    # directory: the auto route's CG fallback runs before saving.
    if not _posterior_finite(post):
        if serving_solver == "auto" and kwargs.get("solver") == "chol":
            echo("WARNING: auto-resolved chol cache is non-finite (ill-conditioned system); "
                 "falling back to the CG cache.", err=True)
            kwargs["solver"] = "cg"
            post = build(kwargs)
        if not _posterior_finite(post):
            raise CommandError(f"{kwargs.get('solver', serving_solver)} serving cache is "
                               "non-finite; not saving. Try --serving-solver cg.")
    save_posterior(posterior_dir, post)
    _write_meta(meta_path, fingerprint, model_class)
    echo(f"serving cache built and saved to {posterior_dir}")
    return post


def make_command() -> Command:
    cmd = Command("predict", run, help="Posterior mean/variance dumps from a config dir.")
    cmd.option("-c", "--config-dir", type=LogdirPath(mkdir=False), required=True)
    cmd.option("-l", "--logdir", type=LogdirPath(), default=LogdirPath.default_logdir)
    cmd.option("-mc", "--model-class", type=str, default="cdgp")
    cmd.option("-tb", "--test-batch-size", type=int, default=4096)
    cmd.option("-e", "--error-threshold", type=float, default=1e-6)
    cmd.flag("--mean-only", help="Dump posterior means only (the CG-free cached path).")
    cmd.option("--serving-solver", choices=["auto", "chol", "cg", "lanczos"], default="auto",
               help="Block-solve mode of the serving cache: chol = one factorization + "
                    "triangular solves; cg = preconditioned CG; auto = chol for M <= 16384 "
                    "with a CG fallback on a non-finite factor; lanczos = LOVE-style rank-k "
                    "cache (matrix-free models).")
    cmd.option("--posterior-dir", type=LogdirPath(), default=None,
               help="Persist/reuse the serving cache: loads posterior.{npz,json} from this "
                    "dir if present (the build is skipped), else builds once and saves it.")
    cmd.option("--num-devices", type=int, default=None,
               help="Serve data-parallel over the N-rank world (start N ranks with torchrun "
                    "--nproc-per-node N), the posterior cache replicated.")
    cmd.option("--chunk-iterations", type=int, default=0,
               help="> 0: build the serving cache in host-driven restarted-CG chunks (models "
                    "with posterior_chunked, e.g. gpr-iter).")
    return cmd
