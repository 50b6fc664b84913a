"""Generic CGGP Adam training (port of ``cggp_tpu/cli/train.py``: ``train
... train-cggp-adam``).

The model is built with a random-subset Z and re-clustered between
dispatches during training; ``--matrix-free`` trains ``ImplicitCGGP``.
Checkpoints (``--checkpoint-every``, ``--resume-from``) are the port's own
format (``utils/store.py``); a run dir without ``ckpt/``, from either
package, resumes through the config-dir contract.  JAX's generator keys
become ``torch.Generator`` objects seeded ``-s`` on the run's device.

``--recluster fused`` (with ``-c covernet``) pins the inducing dimension
to a capacity and re-selects by the device net at the top of every K-step
call (``make_device_recluster_fn``).  ``--num-devices N`` trains
``ShardedCGGP`` over the N-rank world (``torchrun --nproc-per-node N``, one
card a rank; on one card N = 1; another N raises ``make_mesh``'s
``ValueError``), with the hybrid data-parallel step at one step a call when
the batch divides N.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import torch

from cggp_tpu_torch.cli.cli_utils import (Command, Context, DatasetType, ExistingPath, FloatType,
                                          KernelType, LogdirPath, UsageError, create_model,
                                          create_update_fn, echo, precision_names,
                                          to_device_bundle)
from cggp_tpu_torch.config import Config, enable_x64_if_needed
from cggp_tpu_torch.data import cast_bundle
from cggp_tpu_torch.selection.covernet import (covernet_update_inducing_parameters,
                                               make_device_recluster_fn)
from cggp_tpu_torch.training.optimize import (create_monitor, make_cg_stats_callback,
                                              make_metrics_callback, make_param_callback,
                                              train_using_adam_and_update)
from cggp_tpu_torch.utils.store import (assign_flat, load_checkpoint, load_config_dir,
                                        save_checkpoint, save_config_dir)

_distance_types = ["covariance", "correlation", "euclidean"]
_clustering_types = ["covertree", "covernet", "kmeans", "oips"]


def _group(ctx: Context, dataset_fn, kernel, logdir, seed, precision, jit) -> None:
    device = ctx.torch_device()
    if precision == np.float64:
        enable_x64_if_needed(Config(dtype_name="float64"))
    np.random.seed(seed)
    ctx.obj = dict(
        seed=seed,
        logdir=logdir,
        dataset=to_device_bundle(cast_bundle(dataset_fn(seed), precision), device),
        kernel_fn=kernel,
        precision=precision_names[precision],
        jit=jit,
    )


def train_cggp_adam(ctx: Context, num_iterations, batch_size, num_inducing_points,
                    distance_type, clustering_type, spatial_resolution, recluster,
                    learning_rate, error_threshold, record_step, num_devices, precondition,
                    precond_rank, relative_threshold, resume_from, checkpoint_every,
                    trainable_u, steps_per_call, precond_refresh, matrix_free, block,
                    max_cg_iterations, tensorboard) -> None:
    """Adam training of the CGGP model with re-clustering between dispatches."""
    obj = ctx.obj
    dataset = obj["dataset"]
    train_data, test_data = dataset.train, dataset.test
    logdir = obj["logdir"]
    device = train_data[0].device

    model_class = "cdgp-implicit" if matrix_free else "cdgp"
    info = {
        "command": "train_cggp_adam",
        "model_class": model_class,
        # predict rebuilds with the same kernel (params.npz cannot tell).
        "kernel": obj["kernel_fn"](int(train_data[0].shape[-1]))[0].name,
        "seed": obj["seed"],
        "precision": obj["precision"],
        "dataset_name": dataset.name,
        "num_inducing_points": num_inducing_points,
        "num_iterations": num_iterations,
        "learning_rate": learning_rate,
        "logdir": str(logdir),
        "batch_size": batch_size,
        "train_size": int(train_data[0].shape[0]),
        "test_size": int(test_data[0].shape[0]),
        "input_dimension": int(train_data[0].shape[-1]),
        "clustering_type": clustering_type,
        "spatial_resolution": spatial_resolution,
        "distance_type": distance_type,
        "precondition": precondition,
        "precond_rank": precond_rank,
        "relative_threshold": relative_threshold,
        "trainable_u": trainable_u,
        "steps_per_call": steps_per_call,
        "precond_refresh": precond_refresh,
        "num_devices": num_devices,
        "matrix_free": matrix_free,
        "block": block if matrix_free else None,
        "max_cg_iterations": max_cg_iterations,
    }
    echo(f"-> {json.dumps(info, indent=2)}")

    if matrix_free and num_devices is not None:
        raise UsageError("--matrix-free is single-chip; ShardedCGGP (--num-devices) is already "
                         "matrix-free per device")
    mesh = None
    if num_devices is not None:
        # ShardedCGGP over the N-rank world (torchrun --nproc-per-node N;
        # one rank on one card), M sharded by rows, random initial centres.
        from cggp_tpu_torch.parallel import ShardedCGGP, make_mesh

        mesh = make_mesh(num_devices, device=device)
        x = train_data[0]
        n, dim = x.shape
        m0 = num_inducing_points or int(n * 0.1)
        kernel, kernel_init = obj["kernel_fn"](dim)
        if precondition in ("rff", "chol", "auto"):
            raise UsageError(f"--precondition {precondition} is single-chip only; use "
                             "pivchol with --num-devices")
        model = ShardedCGGP(kernel=kernel, mesh=mesh, num_data=n,
                            error_threshold=error_threshold, max_cg_iterations=max(m0, 16),
                            precondition=None if precondition == "none" else precondition,
                            precond_rank=precond_rank, relative_threshold=relative_threshold)
        rng = np.random.RandomState(obj["seed"])
        iv = x[torch.as_tensor(rng.choice(n, m0, replace=False), device=x.device)]
        params = model.init_params(iv, noise_variance=0.1, dtype=x.dtype, device=x.device,
                                   **kernel_init)
        echo(f"sharded over {num_devices} devices; M={m0} padded to "
             f"{params['inducing_points'].shape[0]}")
    else:
        if matrix_free and precondition in ("chol", "auto"):
            raise UsageError(f"--precondition {precondition} needs the dense [M, M] system "
                             "(matrix-free models build factors matrix-free: use pivchol)")
        extra = {"block": block} if matrix_free else {}
        model, params = create_model(
            model_class, obj["kernel_fn"], train_data,
            num_inducing_points=num_inducing_points,
            error_threshold=error_threshold, seed=obj["seed"],
            max_cg_iterations=max_cg_iterations,
            relative_threshold=relative_threshold,
            precondition=None if precondition == "none" else precondition,
            precond_rank=precond_rank,
            dtype=train_data[0].dtype,
            **extra,
        )
    if matrix_free:
        echo(f"matrix-free: M={num_inducing_points} padded to "
             f"{params['inducing_points'].shape[0]} (block {block}); no [M, M] Gram is ever "
             "built")
    if resume_from is not None:
        ckpt_dir = Path(resume_from) / "ckpt"
        if ckpt_dir.is_dir():
            params = load_checkpoint(ckpt_dir, params)
            echo(f"resumed from checkpoint {ckpt_dir}")
        else:
            flat, _info = load_config_dir(resume_from)
            params = assign_flat(params, flat)
            echo(f"resumed from config dir {resume_from}")

    auto_model = None
    if precondition == "auto" and hasattr(model, "resolve_precondition"):
        # Resolved eagerly from the Lanczos conditioning estimate of the
        # (possibly resumed) system; auto_model keeps "auto" for the live
        # resolver during training.
        auto_model = model
        resolved = model.resolve_precondition(params)
        model = dataclasses.replace(model, precondition=resolved)
        info["precondition_resolved"] = resolved
        echo(f"precondition auto -> {resolved} (Lanczos conditioning estimate)")

    clustering_kwargs = {}
    if clustering_type == "kmeans":
        clustering_kwargs["max_points"] = (num_inducing_points
                                           or int(train_data[0].shape[0] * 0.1))
    elif clustering_type == "oips":
        clustering_kwargs = {"rho": 0.5, "max_points": num_inducing_points}
    elif clustering_type == "covertree":
        clustering_kwargs = {"spatial_resolution": spatial_resolution}
    elif clustering_type == "covernet":
        clustering_kwargs = {"spatial_resolution": spatial_resolution,
                             "max_points": num_inducing_points}
    update_fn = create_update_fn(clustering_type, model, train_data,
                                 distance_type=distance_type, seed=obj["seed"],
                                 **clustering_kwargs)

    recluster_fn = None
    if recluster == "fused":
        # Pin the inducing dimension to a fixed capacity (mask-padded, exact
        # no-ops) and run the covernet update at the top of every K-step call.
        if clustering_type != "covernet":
            raise UsageError("--recluster fused requires -c covernet")
        if steps_per_call <= 1:
            raise UsageError("--recluster fused needs --steps-per-call > 1 (it runs inside "
                             "the scan-chunked dispatch)")
        if trainable_u:
            raise UsageError("--recluster fused overwrites pseudo_u every dispatch; it is "
                             "incompatible with --trainable-u")
        ck = {k: v for k, v in clustering_kwargs.items() if k != "max_points"}
        ck["lloyds"] = 0  # the per-chunk updates run lloyds=0; the first one too
        if distance_type != "euclidean":
            ck.update(kernel=model.kernel, kernel_params=params["kernel"])
        with torch.no_grad():
            iv, u0, c0 = covernet_update_inducing_parameters(train_data,
                                                             distance_type=distance_type, **ck)
        if num_inducing_points:
            cap = num_inducing_points
            multiple = model._pad_multiple_for(cap)
            if cap % multiple != 0:
                raise UsageError(f"-m {cap} must be a multiple of {multiple} for this model "
                                 "(--matrix-free pads to the panel --block; --num-devices to "
                                 "the mesh size)")
        else:
            # ~25 % headroom for the net's drift, rounded up to the lcm of
            # the model's pad multiple and 64.
            want = int(iv.shape[0]) + max(int(iv.shape[0]) // 4, 8)
            multiple = math.lcm(model._pad_multiple_for(want), 64)
            cap = -(-want // multiple) * multiple
        if cap < iv.shape[0]:
            raise UsageError(f"-m {cap} is below the initial net size {iv.shape[0]}; raise -m "
                             "or --spatial-resolution")
        fresh = model.init_params(iv, pseudo_u=u0, cluster_counts=c0, capacity=cap,
                                  dtype=iv.dtype, device=iv.device)
        # The (possibly resumed) hyperparameters stay; only the inducing
        # state moves to the capacity-pinned layout.
        for k in params:
            if k not in ("inducing_points", "pseudo_u", "cluster_counts", "inducing_mask"):
                fresh[k] = params[k]
        params = fresh
        recluster_fn = make_device_recluster_fn(model, train_data, spatial_resolution, cap,
                                                lloyds=0, distance_type=distance_type)
        update_fn = None
        info["capacity"] = cap
        echo(f"fused re-clustering: m0={iv.shape[0]} pinned at capacity {cap}, update runs "
             f"inside each {steps_per_call}-step dispatch")
    info["recluster"] = recluster

    metrics_fn = make_metrics_callback(model, train_data, test_data,
                                       batch_size=batch_size * 5, key=obj["seed"])
    monitor = create_monitor(str(logdir), metrics_fn, make_param_callback(model),
                             record_step=record_step, use_tensorboard=tensorboard)
    if checkpoint_every is not None:
        monitor.add_callback(
            "checkpoint", lambda step, p: save_checkpoint(Path(logdir) / "ckpt", p, step),
            record_step=checkpoint_every)
    if recluster_fn is not None:
        # A kernel-metric net can outgrow the capacity and is then truncated
        # without a warning: m_real == capacity is the sign.
        monitor.add_callback("m_real", lambda step, p: {
            "selection/m_real": float(p["inducing_mask"].sum())}, record_step=record_step)
    if hasattr(model, "cg_stats"):
        monitor.add_callback("cg", make_cg_stats_callback(model, train_data,
                                                          batch_size=batch_size),
                             record_step=record_step)

    if trainable_u:
        # Re-clustering would reset the trained pseudo_u: cluster once up
        # front (not when resuming: the checkpoint carries them), then train.
        if resume_from is None:
            params = update_fn(params)
        update_fn = None

    train_mesh = None
    if num_devices is not None and steps_per_call == 1:
        # Hybrid dp+tp: batch rows sharded over the mesh the model's KL is
        # sharded on, when the effective batch divides it (else replicated
        # batches, so every valid invocation still trains).
        effective_batch = min(batch_size, train_data[0].shape[0])
        if effective_batch % num_devices == 0:
            echo(f"data-parallel batches over the {num_devices}-device mesh")
            train_mesh = mesh
        else:
            echo(f"replicated batches: effective batch {effective_batch} does not divide the "
                 f"{num_devices}-device mesh (pick a multiple to enable data-parallel batches)")

    def loss_fn(p, b, k):
        return model.training_loss(p, b, k)

    precond_fn = None
    if precond_refresh == "chunk":
        if steps_per_call <= 1:
            raise UsageError("--precond-refresh chunk needs --steps-per-call > 1")
        if num_devices is not None:
            raise UsageError("--precond-refresh chunk applies to the single-chip models (not "
                             "--num-devices)")
        if precondition == "none":
            raise UsageError("--precond-refresh chunk needs a preconditioner (-P pivchol or "
                             "rff)")

        def loss_fn(p, b, k, pc):
            return model.training_loss(p, b, k, precond_override=pc)

        precond_fn = model.precond_state
    resolver_kwargs = {}
    if (auto_model is not None and update_fn is not None and train_mesh is None
            and precond_fn is None):
        # -P auto keeps resolving during training: re-clustering moves Z
        # and the conditioning with it.  Every boundary for K-step chunks,
        # every record_step-th step at one step a call.
        def loss_for_mode(mode, _m=auto_model):
            concrete = dataclasses.replace(_m, precondition=mode)
            return lambda p, b, k: concrete.training_loss(p, b, k)

        def on_mode_change(mode):
            info["precondition_resolved_final"] = mode
            echo(f"precondition re-resolved -> {mode} (recluster-boundary Lanczos estimate)")

        resolver_kwargs = dict(
            precond_resolver=auto_model.resolve_precondition,
            loss_fn_for_mode=loss_for_mode,
            resolve_every=1 if steps_per_call > 1 else max(int(record_step), 1),
            initial_mode=info["precondition_resolved"],
            on_mode_change=on_mode_change,
        )
    params = train_using_adam_and_update(
        params,
        loss_fn,
        train_data,
        iterations=num_iterations,
        batch_size=batch_size,
        learning_rate=learning_rate,
        key=torch.Generator(device=device).manual_seed(int(obj["seed"])),
        update_fn=update_fn,
        trainable_mask=model.trainable_mask(params, trainable_pseudo_u=trainable_u),
        monitor=monitor,
        steps_per_call=steps_per_call,
        mesh=train_mesh,
        precond_fn=precond_fn,
        recluster_fn=recluster_fn,
        **resolver_kwargs,
    )
    save_config_dir(logdir, params, info)
    monitor.close()
    echo("=== Script finished ===")


def make_command() -> Command:
    cmd = Command("train", _group, help="Generic CGGP Adam training.")
    cmd.option("-d", "--dataset", dest="dataset_fn", type=DatasetType(), required=True)
    cmd.option("-k", "--kernel", type=KernelType(), default="se")
    cmd.option("-l", "--logdir", type=LogdirPath(), default=LogdirPath.default_logdir)
    cmd.option("-s", "--seed", type=int, default=0)
    cmd.option("-p", "--precision", type=FloatType(), default="fp32",
               help="Process float width; fp64 sets torch's default dtype to float64. The "
                    "dataset is cast up front either way.")
    cmd.flag_pair(["--jit"], ["--no-jit"], dest="jit", default=True,
                  help="Accepted for the JAX package's command line; eager torch has "
                       "nothing to jit.")

    sub = Command("train-cggp-adam", train_cggp_adam, help="Adam training on the CGGP model.")
    sub.option("-n", "--num-iterations", type=int, required=True)
    sub.option("-b", "--batch-size", type=int, required=True)
    sub.option("-m", "--num-inducing-points", type=int)
    sub.option("-d", "--distance-type", choices=_distance_types, default="covariance")
    sub.option("-c", "--clustering-type", choices=_clustering_types, default="kmeans")
    sub.option("--spatial-resolution", type=float, default=1.0,
               help="covertree/covernet resolution, on the metric's scale.")
    sub.option("--recluster", choices=["between", "fused"], default="between",
               help="'between' = host update between dispatches; 'fused' = inside each "
                    "dispatch (the device net at a pinned capacity; needs -c covernet).")
    sub.option("-l", "--learning-rate", type=float, default=0.01)
    sub.option("-e", "--error-threshold", type=float, default=1e-5)
    sub.option("-r", "--record-step", type=int, default=100)
    sub.option("--num-devices", type=int, default=None,
               help="Shard the inducing dimension over this many ranks (ShardedCGGP: "
                    "row-sharded CG over torch.distributed; start N ranks with torchrun "
                    "--nproc-per-node N). Default: one card.")
    sub.option("-P", "--precondition", choices=["none", "pivchol", "rff", "chol", "auto"],
               default="none",
               help="Per-step CG preconditioning rebuilt from current hyperparameters; "
                    "'chol' is the exact factor (dense model only).")
    sub.option("--precond-rank", type=int, default=128,
               help="Low-rank preconditioner factor rank.")
    sub.flag_pair(["--relative-threshold"], ["--absolute-threshold"],
                  dest="relative_threshold", default=False,
                  help="Scale each CG row's stopping target by its own RHS norm.")
    sub.option("--resume-from", type=ExistingPath(), default=None,
               help="Resume from a previous run's logdir: the latest checkpoint under "
                    "<dir>/ckpt if present, else the final params.npz (the config-dir "
                    "contract).")
    sub.option("--checkpoint-every", type=int, default=None,
               help="Write a checkpoint to <logdir>/ckpt every N steps.")
    sub.flag_pair(["--trainable-u"], ["--fixed-u"], dest="trainable_u", default=False,
                  help="Train the pseudo-observations (the CG-powered variational mean).")
    sub.option("--steps-per-call", type=int, default=1,
               help="Run K optimizer steps per call; inducing updates and the monitor then "
                    "fire every K steps.")
    sub.option("--precond-refresh", choices=["step", "chunk"], default="step",
               help="With --steps-per-call K > 1 and a preconditioner: 'chunk' builds the "
                    "CG preconditioner once per K-step call instead of every step.")
    sub.flag_pair(["--matrix-free"], ["--dense"], dest="matrix_free", default=False,
                  help="Never materialise the [M, M] Gram: CG over kernel panels "
                       "(ImplicitCGGP).")
    sub.option("--block", type=int, default=2048,
               help="Panel height of the matrix-free Gram row blocks (--matrix-free).")
    sub.option("--max-cg-iterations", type=int, default=None,
               help="Cap CG iterations per solve (default: M for the dense model, 100 for "
                    "--matrix-free).")
    sub.flag_pair(["--tensorboard"], ["--no-tensorboard"], dest="tensorboard", default=False)
    cmd.add(sub)
    return cmd
