#!/usr/bin/env python3
"""The parallel package across several cards: one process per rank, NCCL.

``chip_smoke.py`` runs the parallel package at world size 1 (one card).
This probe spawns ``--ranks`` processes, one per card, joined by NCCL, and
runs in every rank:

* ``sharded_cg``: ``make_sharded_cg`` on ``tests/test_parallel.py``'s M =
  8192 system (a jittered 0.2 grid in 3-D, Matern32 at lengthscale 0.5,
  lambda ~ U(0.1, 0.5), 2 right-hand sides, relative 1e-10, cap 300)
  against the dense ``"xla"`` loop on the rank's own card: converged, its
  error from a float64 solve at most 2x the dense loop's, the steps within
  max(3, 5 %); ms a CG step, and a matvec with and without its all-reduce.
* ``sharded_cggp``: ``ShardedCGGP`` at the committed M = 9576 selection
  (capacity 10240, pivoted Cholesky rank 128, relative 1e-5, batches of
  2048): the first step's loss and gradients against a float64 sharded run
  at relative 1e-12 and the single-card blocked ``ImplicitCGGP`` route
  (each gap at most 2x that route's, ``chip_smoke.within_twice_route``),
  then 3 timed Adam steps.
* ``serve_mesh``: ``predict_in_batches(mesh=...)`` of 4 x 8192 points of
  the dense M = 989 model through B1's CG cache against single-card
  serving (fp32: rtol 1e-3, atol 1e-4), points/s of each.
* ``train_dp``: ``train_using_adam_and_update(mesh=...)`` of the dense M =
  989 model (the exact factor, relative 1e-5, B1), each rank solving its
  2048 / world rows: the first step's loss and gradients
  (``make_data_parallel_loss``) against a float64 one-card step, each gap
  at most 2x the fp32 one-card step's; seconds a step of each over 4
  steps.
* ``gang_mesh``: ``train_gang_adam(mesh=...)`` of 8 members (M = 989,
  batches of 2048, the exact-factor solve, 25 steps) against the gang on
  one card: losses rtol 1e-4 (fp32), aggregate steps/s of each.

Every rank checks its own gates; rank 0 prints one JSON line a phase, the
cards' ``nvidia-smi`` name and power limit, and ``{"ok": true, ...}`` last.
Run from the repository root::

    python3 parallel_chip_probe.py --ranks 4

``--device cpu`` runs the same over gloo at small sizes (``--small``), for
a rehearsal without a card.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TIMEOUT_S = 600


def _emit(rank, record):
    if rank == 0:
        print(json.dumps(record), flush=True)


def _require(cond, what):
    if not cond:
        raise AssertionError(what)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device, fn, reps=1):
    """Seconds per call of ``fn`` over ``reps`` calls, the device awaited."""
    _sync(device)
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps, out


def _rank_main(rank, world, store_path, device_type, small):
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1 if device_type == "cpu" else torch.get_num_threads())
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        _phases(rank, world, device_type, small)
    finally:
        dist.destroy_process_group()


def _phases(rank, world, device_type, small):
    import chip_smoke as cs
    from cggp_tpu_torch.data import synthetic
    from cggp_tpu_torch.models.cggp import CGGP
    from cggp_tpu_torch.models.implicit import ImplicitCGGP
    from cggp_tpu_torch.ops.cg import ConjugateGradient, conjugate_gradient
    from cggp_tpu_torch.ops.kernels import Matern32
    from cggp_tpu_torch.ops.linalg import add_diagonal
    from cggp_tpu_torch.parallel import (ShardedCGGP, make_data_parallel_loss, make_mesh,
                                         make_sharded_cg, shard_batch)
    from cggp_tpu_torch.parallel.sharded_cg import _local_matvec, _local_rows
    from cggp_tpu_torch.selection.update import labels_update_inducing_parameters
    from cggp_tpu_torch.training.gang import train_gang_adam
    from cggp_tpu_torch.training.optimize import (adam, make_adam_step, predict_in_batches,
                                                  train_using_adam_and_update)

    mesh = make_mesh(world, device=device_type)
    device = mesh.device
    kernel = Matern32()

    # -- sharded_cg -------------------------------------------------------------
    m, d = (600 if small else cs.CONFIG5_M), 3
    rng = np.random.default_rng(cs.CONFIG5_SEED)
    axes = [np.arange(21) * 0.2 - 2.0] + [np.arange(20) * 0.2 - 2.0] * (d - 1)
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, d)[:m]
    z = torch.as_tensor(grid + rng.uniform(-0.05, 0.05, grid.shape), dtype=torch.float32,
                        device=device)
    lam = torch.as_tensor(rng.uniform(0.1, 0.5, (m,)), dtype=torch.float32, device=device)
    rhs = torch.as_tensor(rng.standard_normal((2, m)), dtype=torch.float32, device=device)
    kp = kernel.init_params(variance=1.0, lengthscales=np.full(d, 0.5), dtype=torch.float32,
                            device=device)
    solve = make_sharded_cg(kernel, mesh, 1e-10, 300, relative_threshold=True)
    solve(kp, z, lam, rhs)  # warm-up
    sharded_s, (sol, stats) = _timed(device, lambda: solve(kp, z, lam, rhs))
    a = add_diagonal(kernel.K(kp, z), lam)
    dense_s, (dense, dstats) = _timed(device, lambda: conjugate_gradient(
        a, rhs, torch.zeros_like(rhs), 1e-10, max_iterations=300, max_steps_cycle=301,
        relative_threshold=True))
    exact = torch.linalg.solve(a.double(), rhs.double().T).T
    err = float((sol.double() - exact).abs().max())
    dense_err = float((dense.double() - exact).abs().max())
    steps, dsteps = int(stats.steps), int(dstats.steps)
    _require(bool(stats.converged) and bool(dstats.converged), "sharded_cg: a solve stopped")
    _require(err <= 2.0 * dense_err, f"sharded_cg: {err} from fp64, dense {dense_err}")
    _require(abs(steps - dsteps) <= max(3, 0.05 * dsteps), f"sharded_cg: {steps} / {dsteps}")
    a_rows, offset, mb = _local_rows(kernel, kp, z, lam, mesh)
    reduce_mv = _local_matvec(a_rows, offset, mb, mesh)
    with_reduce, _ = _timed(device, lambda: reduce_mv(rhs), reps=50)
    local_only, _ = _timed(device, lambda: rhs[..., offset:offset + mb] @ a_rows, reps=50)
    _emit(rank, {"phase": "sharded_cg", "world_size": world, "m": m, "steps": steps,
                 "dense_steps": dsteps, "max_abs_err_fp64": err,
                 "dense_max_abs_err_fp64": dense_err,
                 "ms_per_cg_step": 1e3 * sharded_s / max(steps, 1),
                 "dense_ms_per_cg_step": 1e3 * dense_s / max(dsteps, 1),
                 "matvec_ms_with_all_reduce": 1e3 * with_reduce,
                 "local_product_ms": 1e3 * local_only, "row_block_rows": mb})
    del a, a_rows, exact, dense, sol

    # -- sharded_cggp -------------------------------------------------------------
    (x_np, y_np), (xt_np, _) = synthetic(n=3000 if small else 435_000, dim=3, seed=0)
    x = torch.as_tensor(x_np, dtype=torch.float32, device=device)
    y = torch.as_tensor(y_np, dtype=torch.float32, device=device)
    n = x.shape[0]
    if small:
        siv, su, scounts = (t.cpu().numpy() for t in labels_update_inducing_parameters(
            (x.cpu(), y.cpu()), x[:100].cpu()))
        block, batch, selection = 64, 40, None
    else:
        with np.load(ROOT / cs.IMPLICIT_SELECTION) as sel:
            siv, su, scounts = sel["iv"], sel["u"], sel["counts"]
        block, batch = cs.IMPLICIT_BLOCK, cs.TRAIN_BATCH
        with np.load(ROOT / "benchmarks" / "e2e_selection_covertree.npz") as sel:
            selection = (sel["iv"], sel["u"], sel["counts"])
    common = dict(kernel=kernel, num_data=n, num_probes=cs.TRAIN_PROBES,
                  precondition="pivchol", precond_rank=16 if small else 128,
                  relative_threshold=True)

    def sharded(threshold=cs.IMPLICIT_THRESHOLD, max_cg=cs.IMPLICIT_MAX_CG):
        return ShardedCGGP(mesh=mesh, error_threshold=threshold, max_cg_iterations=max_cg,
                           **common)

    blocked = ImplicitCGGP(block=block, error_threshold=cs.IMPLICIT_THRESHOLD,
                           max_cg_iterations=cs.IMPLICIT_MAX_CG, use_pallas=False, **common)
    bparams = blocked.init_params(siv, pseudo_u=su, cluster_counts=scounts,
                                  dtype=torch.float32, device=device)
    capacity = int(bparams["inducing_points"].shape[0])
    capacity = -(-capacity // world) * world
    sparams = sharded().init_params(siv, pseudo_u=su, cluster_counts=scounts, capacity=capacity,
                                    dtype=torch.float32, device=device)
    if capacity != bparams["inducing_points"].shape[0]:
        bparams = blocked.init_params(siv, pseudo_u=su, cluster_counts=scounts,
                                      capacity=capacity, dtype=torch.float32, device=device)
    cpu_gen = torch.Generator().manual_seed(cs.SHARDED_TRAIN_SEED)
    index = torch.stack([torch.randperm(n, generator=cpu_gen)[:batch]
                         for _ in range(1 + cs.SHARDED_TRAIN_STEPS)]).to(device)
    batches = [(x[i], y[i]) for i in index]

    def probe_gen():
        return torch.Generator(device=device).manual_seed(cs.SHARDED_TRAIN_SEED)

    to64 = {k: ({kk: vv.double() for kk, vv in v.items()} if isinstance(v, dict)
                else v.double()) for k, v in sparams.items()}
    ref_s, (loss64, grads64) = _timed(device, lambda: cs.loss_and_grads(
        sharded(cs.IMPLICIT_REF_THRESHOLD, cs.IMPLICIT_REF_MAX_CG), to64,
        tuple(t.double() for t in batches[0]), probe_gen()))
    first_s, (loss_s, grads_s) = _timed(device, lambda: cs.loss_and_grads(
        sharded(), sparams, batches[0], probe_gen()))
    loss_b, grads_b = cs.loss_and_grads(blocked, bparams, batches[0], probe_gen())
    gaps = cs.relative_gaps(loss_s, grads_s, loss64, grads64)
    blocked_gaps = cs.relative_gaps(loss_b, grads_b, loss64, grads64)
    _require(cs.within_twice_route(gaps, blocked_gaps),
             f"sharded_cggp: gaps {gaps} beyond the blocked route's {blocked_gaps}")
    model = sharded()
    step = make_adam_step(model.training_loss, adam(cs.TRAIN_LR), model.trainable_mask(sparams))

    def steps_fn():
        p, state, gen, losses = sparams, adam(cs.TRAIN_LR).init(sparams), probe_gen(), []
        for b in batches[1:]:
            p, state, loss = step(p, state, b, gen)
            losses.append(float(loss))
        return losses

    steps_s, losses = _timed(device, steps_fn)
    _require(all(np.isfinite(losses)), "sharded_cggp: a loss is not finite")
    _emit(rank, {"phase": "sharded_cggp", "world_size": world, "m_pad": capacity,
                 "rows": 1 + 2 * cs.TRAIN_PROBES + batch,
                 "row_block_mb": capacity * capacity * 4 / world / 1e6,
                 "gaps_from_fp64": gaps, "blocked_gaps_from_fp64": blocked_gaps,
                 "s_first_step_fp64": ref_s, "s_first_step": first_s,
                 "s_per_step": steps_s / cs.SHARDED_TRAIN_STEPS, "losses": losses})
    del sparams, bparams, to64, batches

    # -- serve_mesh and gang_mesh on the dense model --------------------------------
    if selection is None:
        selection = tuple(t.cpu().numpy() for t in labels_update_inducing_parameters(
            (x.cpu(), y.cpu()), x[:20].cpu()))
    serve_model = CGGP(kernel=kernel, num_data=n, conjugate_gradient=ConjugateGradient(
        cs.CG_THRESHOLD, matvec_impl="pallas"))
    params = serve_model.init_params(selection[0], pseudo_u=selection[1],
                                     cluster_counts=selection[2], dtype=torch.float32,
                                     device=device)
    xq = torch.as_tensor(xt_np[:(256 if small else cs.NUM_BATCHES * cs.R_BATCH)],
                         dtype=torch.float32, device=device)
    qbatch = 64 if small else cs.R_BATCH
    post = serve_model.posterior(params, solver="cg")
    single_s, single = _timed(device, lambda: predict_in_batches(
        serve_model, params, xq, batch_size=qbatch, posterior_solver="cg", posterior=post))
    mesh_s, served = _timed(device, lambda: predict_in_batches(
        serve_model, params, xq, batch_size=qbatch, posterior_solver="cg", posterior=post,
        mesh=mesh))
    gap = max(float((a - b).abs().max() / (b.abs().max() + 1e-30))
              for a, b in zip(served, single))
    for a, b in zip(served, single):
        _require(bool(torch.allclose(a, b, rtol=1e-3, atol=1e-4)),
                 "serve_mesh: mesh serving differs from single-card serving")
    _emit(rank, {"phase": "serve_mesh", "world_size": world, "points": int(xq.shape[0]),
                 "batch_size": qbatch, "single_points_per_s": xq.shape[0] / single_s,
                 "mesh_points_per_s": xq.shape[0] / mesh_s, "max_rel_gap": gap,
                 "tolerance": "rtol 1e-3, atol 1e-4 (fp32)"})

    gang_model = CGGP(kernel=kernel, num_data=n, num_probes=cs.TRAIN_PROBES,
                      precondition="chol", conjugate_gradient=ConjugateGradient(
                          cs.TRAIN_CHOL_THRESHOLD, relative_threshold=True,
                          matvec_impl="pallas"))

    # -- train_dp: each rank the data term of its rows --------------------------------
    dp_steps = 2 if small else cs.HYBRID_STEPS
    model64 = CGGP(kernel=kernel, num_data=n, num_probes=cs.TRAIN_PROBES, precondition="chol",
                   conjugate_gradient=ConjugateGradient(cs.TRAIN_CHOL_THRESHOLD,
                                                        relative_threshold=True))
    params64 = {k: ({kk: vv.double() for kk, vv in v.items()} if isinstance(v, dict)
                    else v.double()) for k, v in params.items()}
    xb, yb = x[:batch], y[:batch]

    def probe_gen():
        return torch.Generator(device=device).manual_seed(cs.HYBRID_SEED)

    dp_objective = SimpleNamespace(
        training_loss=make_data_parallel_loss(gang_model.training_loss, mesh))
    loss64, grads64 = cs.loss_and_grads(model64, params64, (xb.double(), yb.double()),
                                        probe_gen())
    loss1, grads1 = cs.loss_and_grads(gang_model, params, (xb, yb), probe_gen())
    loss_dp, grads_dp = cs.loss_and_grads(dp_objective, params, shard_batch(mesh, xb, yb),
                                          probe_gen())
    dp_gaps = cs.relative_gaps(loss_dp, grads_dp, loss64, grads64)
    replicated_gaps = cs.relative_gaps(loss1, grads1, loss64, grads64)
    _require(cs.within_twice_route(dp_gaps, replicated_gaps),
             f"train_dp: gaps {dp_gaps} beyond the one-card step's {replicated_gaps}")

    def train_dp(mesh_arg):
        return train_using_adam_and_update(
            dict(params), gang_model.training_loss, (x, y), dp_steps, batch, cs.TRAIN_LR,
            probe_gen(), trainable_mask=gang_model.trainable_mask(params), mesh=mesh_arg)

    replicated_s, _ = _timed(device, lambda: train_dp(None))
    dp_s, _ = _timed(device, lambda: train_dp(mesh))
    _emit(rank, {"phase": "train_dp", "world_size": world, "steps": dp_steps, "batch": batch,
                 "rows_per_rank": batch // world, "gaps_from_fp64": dp_gaps,
                 "one_card_gaps_from_fp64": replicated_gaps,
                 "tolerance": "the first step's loss and gradients: each gap <= 2x the "
                              "one-card step's",
                 "s_per_step": dp_s / dp_steps, "replicated_s_per_step": replicated_s / dp_steps})

    size = 8
    variants = []
    for g in range(size):
        p = {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
                 else v.clone()) for k, v in params.items()}
        p["kernel"]["lengthscales"] = p["kernel"]["lengthscales"] * (0.8 + 0.1 * g)
        variants.append(p)
    kw = dict(iterations=5 if small else cs.GANG_K, batch_size=batch,
              learning_rates=cs.GANG_LR, trainable_mask=gang_model.trainable_mask(params),
              steps_per_call=5 if small else cs.GANG_K)
    run = {}
    for name, mesh_arg in (("one_card", None), ("mesh", mesh)):
        wall, (_, losses) = _timed(device, lambda: train_gang_adam(
            variants, gang_model.training_loss, (x, y), key=torch.Generator(
                device=device).manual_seed(cs.GANG_SEED), mesh=mesh_arg, **kw))
        run[name] = {"s": wall, "losses": losses,
                     "aggregate_steps_per_s": size * kw["iterations"] / wall}
    _require(np.allclose(run["mesh"]["losses"], run["one_card"]["losses"], rtol=1e-4),
             "gang_mesh: the sharded gang differs from the one-card gang")
    _emit(rank, {"phase": "gang_mesh", "world_size": world, "gang": size,
                 "steps": kw["iterations"],
                 "one_card_steps_per_s": run["one_card"]["aggregate_steps_per_s"],
                 "mesh_steps_per_s": run["mesh"]["aggregate_steps_per_s"],
                 "max_rel_loss_gap": float(np.max(np.abs(
                     run["mesh"]["losses"] - run["one_card"]["losses"])
                     / np.abs(run["one_card"]["losses"]))),
                 "tolerance": "losses rtol 1e-4 (fp32, 25 steps)"})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="parallel_chip_probe.py")
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--small", action="store_true", help="small sizes (a CPU rehearsal)")
    args = parser.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("parallel_chip_probe: no CUDA device is available", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < args.ranks:
            print(f"parallel_chip_probe: {args.ranks} ranks need {args.ranks} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        sys.path.insert(0, str(ROOT))
        from cggp_tpu_torch import _build

        _build.load()  # built once here, not by every rank at once
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main, args=(args.ranks, str(Path(tmp) / "store"),
                                                   args.device, args.small),
                                 nprocs=args.ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                print("parallel_chip_probe: the ranks did not finish in time", file=sys.stderr)
                return 1
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        print(json.dumps({"nvidia_smi": smi[:args.ranks]}), flush=True)
        kind = torch.cuda.get_device_name(0)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": args.ranks}}), flush=True)
    else:
        print(json.dumps({"ok": True, "device": {"platform": "cpu", "count": args.ranks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
