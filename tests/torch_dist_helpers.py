"""Multi-rank runs of the port's parallel package on the CPU, for the
``test_torch_parallel_*`` and ``test_torch_gang`` files.

Torch and numpy only: the ranks are spawned processes that import this
module by name, so they never import JAX.  A world starts from a
``FileStore`` under the test's ``tmp_path`` (no ports, no clash between
xdist workers) over gloo; every ``init_process_group`` and the join have
a timeout, so a deadlock fails the test instead of stalling the suite.

:func:`start_world` / :func:`run_world` run a list of ``(case, kwargs)`` on every rank and
returns each rank's results: a case is a function of this module's
``CASES`` taking the mesh and numpy inputs and returning numpy outputs.
Where a case needs the JAX package's probes, the caller passes them in
(drawn in the parent) and the case patches the port's ``rademacher``.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np

TIMEOUT_S = 120.0


def _worker(rank: int, world: int, store_path: str, cases, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    results = {}
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        from cggp_tpu_torch.parallel import make_mesh

        mesh = make_mesh(world, device="cpu")
        for name, kwargs in cases:
            results[name] = CASES[kwargs.pop("_case", name)](mesh, **kwargs)
    except Exception:  # the rank's boundary: the parent reports it
        results = {"__error__": traceback.format_exc()}
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    if dist.is_initialized():
        dist.destroy_process_group()


class World:
    """A started world (:func:`start_world`); :meth:`results` waits for it."""

    def __init__(self, ctx, world: int, out_dir: Path, timeout: float):
        self.ctx, self.world, self.out_dir = ctx, world, out_dir
        self.deadline = time.monotonic() + timeout
        self._results = None

    def results(self):
        """Each rank's ``{name: result}``, in rank order."""
        if self._results is not None:
            return self._results
        ctx = self.ctx
        while not ctx.join(timeout=max(0.1, self.deadline - time.monotonic())):
            if time.monotonic() > self.deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"a {self.world}-rank world did not finish in time")
        out = []
        for rank in range(self.world):
            with open(self.out_dir / f"rank{rank}.pkl", "rb") as f:
                res = pickle.load(f)
            if "__error__" in res:
                raise RuntimeError(f"rank {rank} failed:\n{res['__error__']}")
            out.append(res)
        self._results = out
        return out


def start_world(tmp_path, world: int, cases, timeout: float = TIMEOUT_S) -> World:
    """Start ``cases`` (``[(name, kwargs)]``; ``kwargs["_case"]`` names the
    function when ``name`` is a label) on ``world`` gloo ranks, without
    waiting: the caller computes its references meanwhile."""
    import torch.multiprocessing as mp

    out_dir = Path(tmp_path) / f"world{world}_{time.monotonic_ns()}"
    out_dir.mkdir(parents=True)
    store = str(out_dir / "store")
    repo = str(Path(__file__).resolve().parent.parent)
    tests = str(Path(__file__).resolve().parent)
    env_path = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (repo, tests, env_path) if p)
    try:
        ctx = mp.start_processes(_worker, args=(world, store, cases, str(out_dir)),
                                 nprocs=world, join=False, start_method="spawn")
    finally:
        os.environ["PYTHONPATH"] = env_path
    return World(ctx, world, out_dir, timeout)


def run_world(tmp_path, world: int, cases, timeout: float = TIMEOUT_S):
    """:func:`start_world`, then wait: a list of each rank's results."""
    return start_world(tmp_path, world, cases, timeout).results()


# ---------------------------------------------------------------------------
# helpers (torch only)
# ---------------------------------------------------------------------------


def _t(a):
    import torch

    return torch.as_tensor(np.asarray(a))


def _np(t):
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_np(v) for v in t)
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _kp(kernel, variance, lengthscales, dtype=None):
    import torch

    return kernel.init_params(variance=variance, lengthscales=lengthscales,
                              dtype=dtype or torch.float64, device="cpu")


class _Probes:
    """The port's ``rademacher`` replaced by a queue of given arrays (the
    JAX package's draws), popped in call order."""

    def __init__(self, arrays):
        self.queue = [np.asarray(a) for a in arrays]

    def __call__(self, gen, shape, dtype):
        import torch

        draw = self.queue.pop(0)
        assert tuple(draw.shape) == tuple(shape), (draw.shape, shape)
        return torch.as_tensor(draw).to(dtype)


def _patch_probes(module_names, arrays):
    import importlib

    feed = _Probes(arrays)
    for name in module_names:
        setattr(importlib.import_module(name), "rademacher", feed)
    return feed


def _grads(fn, leaves):
    import torch

    live = [t.detach().clone().requires_grad_() for t in leaves]
    out = fn(*live)
    return out, torch.autograd.grad(out, live, allow_unused=True)


CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _kernel(name):
    from cggp_tpu_torch.ops.kernels import kernel_by_name

    return kernel_by_name(name)


def _params(tree, dtype=None):
    import torch

    from cggp_tpu_torch.utils.store import params_from_numpy

    return params_from_numpy(tree, device="cpu",
                             dtype=None if dtype is None else getattr(torch, dtype))


def _sharded(mesh, kernel, model_kw):
    from cggp_tpu_torch.parallel import ShardedCGGP

    return ShardedCGGP(kernel=_kernel(kernel), mesh=mesh, **model_kw)


# -- sharded CG ------------------------------------------------------------


@case
def solve(mesh, kernel, kp, z, lam, rhs, threshold, max_iter, mask=None, relative=False,
          dtype="float64"):
    """``make_sharded_cg``'s solution, steps and flag."""
    import torch

    from cggp_tpu_torch.parallel import make_sharded_cg

    dt = getattr(torch, dtype)
    sol, stats = make_sharded_cg(_kernel(kernel), mesh, threshold, max_iter,
                                 relative_threshold=relative)(
        _params(kp, dtype), _t(z).to(dt), _t(lam).to(dt), _t(rhs).to(dt),
        mask=None if mask is None else _t(mask).to(dt))
    return {"solution": _np(sol), "steps": int(stats.steps), "converged": bool(stats.converged)}


@case
def solve_grads(mesh, kernel, kp, z, lam, rhs, threshold, max_iter):
    """Gradients of ``sum(solution^2)`` in the kernel parameters, z and lam."""
    import torch

    from cggp_tpu_torch.parallel import make_sharded_cg

    solve_fn = make_sharded_cg(_kernel(kernel), mesh, threshold, max_iter)
    names = sorted(kp)

    def loss(z_, lam_, *kp_values):
        sol, _ = solve_fn(dict(zip(names, kp_values)), z_, lam_, _t(rhs))
        return torch.sum(torch.square(sol))

    _, grads = _grads(loss, [_t(z), _t(lam)] + [_t(kp[k]) for k in names])
    return {"z": _np(grads[0]), "lam": _np(grads[1]),
            **{f"kernel/{k}": _np(g) for k, g in zip(names, grads[2:])}}


@case
def solve_state_bitwise(mesh, kernel, kp, z, lam, rhs, threshold, max_iter):
    """A solve's state gathered from every rank: bitwise equal copies."""
    import torch

    from cggp_tpu_torch.parallel import make_sharded_cg
    from cggp_tpu_torch.parallel.mesh import all_gather_rows

    sol, stats = make_sharded_cg(_kernel(kernel), mesh, threshold, max_iter)(
        _params(kp), _t(z), _t(lam), _t(rhs))
    state = torch.cat([sol.reshape(-1), stats.error.reshape(-1),
                       stats.steps.reshape(-1).to(sol.dtype)])
    copies = all_gather_rows(mesh, state[None])
    return {"equal": all(torch.equal(copies[0], c) for c in copies), "copies": _np(copies)}


@case
def kuu_solver(mesh, kernel, kp, z, lam, rhs_cols, threshold, max_iter):
    from cggp_tpu_torch.parallel import ShardedKuuSolver

    solver = ShardedKuuSolver(_kernel(kernel), mesh, threshold, max_iter)
    return _np(solver(_params(kp), _t(z), _t(lam), _t(rhs_cols)))


@case
def slq(mesh, kernel, kp, z, lam, mask, probes, iters):
    from cggp_tpu_torch.parallel.sharded_cg import make_sharded_slq_value

    return float(make_sharded_slq_value(_kernel(kernel), mesh, iters)(
        _params(kp), _t(z), _t(lam), _t(mask), _t(probes)))


@case
def logdet_grad(mesh, kernel, kp, z, lam, probes, model_kw, variant):
    """``ShardedCGGP._logdet`` (zero-valued) or ``_slq_logdet``: value and
    gradient in the kernel parameters."""
    import torch

    model = _sharded(mesh, kernel, model_kw)
    fn = model._slq_logdet if variant == "slq" else model._logdet
    names = sorted(kp)
    mask = torch.ones(len(z))

    def value(*kp_values):
        return fn(dict(zip(names, kp_values)), _t(z), _t(lam), mask, _t(probes))

    val, grads = _grads(value, [_t(kp[k]) for k in names])
    return {"value": float(val.detach()), **{f"kernel/{k}": _np(g) for k, g in zip(names, grads)}}


# -- the sharded model -----------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = _np(v)
    return out


def _model_op(model, params, op, kw):
    """One operation on a model and its parameters, numpy out."""
    import torch

    import cggp_tpu_torch.models.rowcg as rowcg
    from cggp_tpu_torch.training.optimize import _leaves, _unflatten_like, predict_in_batches

    if "probes" in kw:
        rowcg.rademacher = _Probes(kw["probes"])
    gen = torch.Generator().manual_seed(0)
    data = (_t(kw["x"]), _t(kw["y"])) if "y" in kw else None
    if op == "predict_f":
        return _np(model.predict_f(params, _t(kw["x"]), full_cov=kw.get("full_cov", False)))
    if op == "posterior":
        post = model.posterior(params, solver=kw["solver"])
        mu, var = model.posterior_predict(post, _t(kw["x"]), full_cov=kw.get("full_cov", False))
        return {"chol": post.chol is not None, "mu": _np(mu), "var": _np(var),
                "mean": _np(model.posterior_mean(post, _t(kw["x"])))}
    if op == "predict_in_batches":
        return _np(predict_in_batches(model, params, _t(kw["x"]), batch_size=kw["batch_size"],
                                      mean_only=kw.get("mean_only", False)))
    if op == "prior_kl":
        return float(model.prior_kl(params, gen).detach())
    if op == "elbo":
        return float(model.elbo(params, data, gen).detach())
    if op == "loss_grads":
        leaves = [t.detach().requires_grad_() for t in _leaves(params)]
        loss = model.training_loss(_unflatten_like(params, leaves), data, gen)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        return {"loss": float(loss.detach()), **_flat(_unflatten_like(params, grads))}
    if op == "cg_stats":
        return int(model.cg_stats(params, data, gen).steps)
    if op == "resolve_serving_solver":
        return model.resolve_serving_solver(params)
    if op == "assign_clusters":
        new = model.assign_clusters(params, _t(kw["iv"]), _t(kw["u"]), _t(kw["counts"]))
        mu, _ = model.predict_f(new, _t(kw["x"]))
        return {"z_rows": int(new["inducing_points"].shape[0]),
                "mask_sum": float(new["inducing_mask"].sum()), "mu": _np(mu)}
    if op == "adam":
        from cggp_tpu_torch.training.optimize import adam, make_adam_step

        opt = adam(kw["lr"])
        step = make_adam_step(model.training_loss, opt, model.trainable_mask(params))
        state, losses, p = opt.init(params), [], params
        for _ in range(kw["steps"]):
            p, state, loss = step(p, state, data, gen)
            losses.append(float(loss))
        return {"losses": np.asarray(losses), "mask": _np(p["inducing_mask"]), **_flat(p)}
    raise ValueError(op)


@case
def model_ops(mesh, kernel, model_kw, params, ops, dtype=None):
    """``ShardedCGGP(kernel, mesh, **model_kw)`` at the given (padded) numpy
    parameters, then each ``(label, op, kwargs)`` of ``ops``."""
    model = _sharded(mesh, kernel, model_kw)
    p = _params(params, dtype)
    return {label: _model_op(model, p, op, kw) for label, op, kw in ops}


@case
def init_padded(mesh, kernel, model_kw, z, u, counts, init_kw):
    """The port's own ``init_params`` padding (beside JAX's)."""
    import torch

    model = _sharded(mesh, kernel, model_kw)
    dtype = getattr(torch, init_kw.pop("dtype", "float64"))
    return _flat(model.init_params(_t(z).to(dtype), pseudo_u=_t(u).to(dtype),
                                   cluster_counts=_t(counts).to(dtype), dtype=dtype,
                                   device="cpu", **init_kw))


@case
def itergpr(mesh, x, y, xq):
    """``ShardedIterGPR`` (SE, N = 52, SLQ at N iterations, exact probes):
    MLL, its gradients, the posterior and its mean."""
    import torch

    from cggp_tpu_torch.models import GPR
    from cggp_tpu_torch.ops.kernels import SquaredExponential
    from cggp_tpu_torch.parallel import ShardedIterGPR
    from cggp_tpu_torch.training.optimize import _leaves, _unflatten_like

    n = len(x)
    model = ShardedIterGPR(kernel=SquaredExponential(), mesh=mesh, error_threshold=1e-13,
                           max_cg_iterations=4 * n, relative_threshold=False, precondition=None,
                           logdet_variant="slq", slq_lanczos_iters=n)
    params = GPR(kernel=SquaredExponential()).init_params(2, noise_variance=0.1,
                                                          dtype=torch.float64, device="cpu")
    probes = np.sqrt(float(n)) * torch.eye(n)
    data = (_t(x), _t(y))
    leaves = [t.detach().requires_grad_() for t in _leaves(params)]
    mll = model.log_marginal_likelihood(_unflatten_like(params, leaves), data, probes=probes)
    grads = torch.autograd.grad(mll, leaves)
    post = model.posterior(params, data)
    mu, var = model.posterior_predict(post, _t(xq))
    return {"mll": float(mll.detach()), "grads": _flat(_unflatten_like(params, grads)),
            "mu": _np(mu), "var": _np(var), "mean": _np(model.posterior_mean(post, _t(xq)))}


# -- data-parallel paths -----------------------------------------------------


def _dense_cggp(n, num_probes, threshold, max_iterations=None):
    from cggp_tpu_torch.models.cggp import CGGP
    from cggp_tpu_torch.ops.cg import ConjugateGradient
    from cggp_tpu_torch.ops.kernels import SquaredExponential

    return CGGP(kernel=SquaredExponential(), num_data=n, num_probes=num_probes,
                conjugate_gradient=ConjugateGradient(threshold, max_iterations=max_iterations))


@case
def dp_loss(mesh, params, x, y, probes):
    """``make_data_parallel_loss`` of the dense CGGP on this rank's rows,
    beside the single-device loss on every row, the same probes."""
    import torch

    import cggp_tpu_torch.models.cggp as tcggp
    from cggp_tpu_torch.parallel import make_data_parallel_loss, shard_batch

    model = _dense_cggp(len(x), 3, 1e-12)
    solve_rows = []
    cg = model.conjugate_gradient

    def recording_cg(matrix, rhs, **kw):
        solve_rows.append(rhs.shape[-1])
        return cg(matrix, rhs, **kw)

    object.__setattr__(model, "conjugate_gradient", recording_cg)
    p = _params(params)
    loss_fn = model.training_loss
    out = {}
    tcggp.rademacher = _Probes(probes)
    out["dp"] = float(make_data_parallel_loss(loss_fn, mesh)(
        p, shard_batch(mesh, _t(x), _t(y)), torch.Generator()))
    out["solve_rows"] = solve_rows[0]
    tcggp.rademacher = _Probes(probes)
    out["single"] = float(loss_fn(p, (_t(x), _t(y)), torch.Generator()))
    # One Adam step from this rank's rows against the single-device step.
    from cggp_tpu_torch.parallel.data_parallel import make_data_parallel_train_step
    from cggp_tpu_torch.training.optimize import adam, make_adam_step

    opt = adam(0.05)
    tcggp.rademacher = _Probes(probes)
    dp_p, _, _ = make_data_parallel_train_step(loss_fn, opt, mesh)(
        p, opt.init(p), shard_batch(mesh, _t(x), _t(y)), torch.Generator())
    tcggp.rademacher = _Probes(probes)
    one_p, _, _ = make_adam_step(loss_fn, opt)(p, opt.init(p), (_t(x), _t(y)),
                                               torch.Generator())
    out["step_dp"], out["step_single"] = _flat(dp_p), _flat(one_p)
    return out


@case
def dp_predict(mesh, params, x):
    """``make_data_parallel_predict`` of ClusterGP: this rank's rows."""
    from cggp_tpu_torch.models import ClusterGP
    from cggp_tpu_torch.ops.kernels import SquaredExponential
    from cggp_tpu_torch.parallel import make_data_parallel_predict, shard_batch

    model = ClusterGP(kernel=SquaredExponential(), num_data=len(x))
    fn = make_data_parallel_predict(lambda p, xq: model.predict_f(p, xq, full_cov=False), mesh)
    return _np(fn(_params(params), shard_batch(mesh, _t(x))))


@case
def hybrid_trainer(mesh, params, x, y, model_kw, kw):
    """``train_using_adam_and_update`` with and without the mesh (the same
    generator seed), and its refusals."""
    import torch

    from cggp_tpu_torch.ops.kernels import SquaredExponential
    from cggp_tpu_torch.parallel import ShardedCGGP
    from cggp_tpu_torch.training.optimize import train_using_adam_and_update

    model = ShardedCGGP(kernel=SquaredExponential(), mesh=mesh, **model_kw)
    p0 = _params(params)
    data = (_t(x), _t(y))
    common = dict(kw, trainable_mask=model.trainable_mask(p0))
    out = {}
    for name, mesh_arg in (("replicated", None), ("mesh", mesh)):
        trained = train_using_adam_and_update(dict(p0), model.training_loss, data,
                                              key=torch.Generator().manual_seed(7),
                                              mesh=mesh_arg, **common)
        out[name] = _flat(trained)
    errors = {}
    for name, extra in (("steps_per_call", dict(steps_per_call=4)),
                        ("divide", dict(batch_size=mesh.size * 16 + 1))):
        try:
            train_using_adam_and_update(dict(p0), model.training_loss, data,
                                        key=torch.Generator().manual_seed(7), mesh=mesh,
                                        **dict(common, **extra))
        except ValueError as exc:
            errors[name] = str(exc)
    out["errors"] = errors
    return out


@case
def dp_serving(mesh, params, x, xq, love_rank):
    """``predict_in_batches`` / ``posterior_predict_scan`` with and without
    the mesh on the dense fp32 CGGP (chol, scan, mean_only, LOVE), and the
    refusal of a model with collectives of its own."""
    import torch

    from cggp_tpu_torch.models.cggp import CGGP
    from cggp_tpu_torch.ops.cg import ConjugateGradient
    from cggp_tpu_torch.ops.kernels import SquaredExponential
    from cggp_tpu_torch.parallel import ShardedCGGP
    from cggp_tpu_torch.training.optimize import posterior_predict_scan, predict_in_batches

    m = len(params["inducing_points"])
    model = CGGP(kernel=SquaredExponential(), num_data=len(x), num_probes=2,
                 conjugate_gradient=ConjugateGradient(1e-10, max_iterations=4 * m))
    p = _params(params, "float32")
    xq = _t(xq).to(torch.float32)
    out = {"single": _np(predict_in_batches(model, p, xq, batch_size=40)),
           "mesh": _np(predict_in_batches(model, p, xq, batch_size=40, mesh=mesh)),
           "mesh_cg": _np(predict_in_batches(model, p, xq, batch_size=40, mesh=mesh,
                                             posterior_solver="cg", scan=False)),
           "single_cg": _np(predict_in_batches(model, p, xq, batch_size=40,
                                               posterior_solver="cg", scan=False)),
           "mesh_mean": _np(predict_in_batches(model, p, xq, batch_size=40, mesh=mesh,
                                               mean_only=True)),
           "mesh_scan": _np(predict_in_batches(model, p, xq, batch_size=48, mesh=mesh,
                                               scan=True))}
    post = model.posterior(p, solver="chol")
    out["scan30"] = _np(posterior_predict_scan(model, post, xq, batch_size=30, mesh=mesh))
    love = CGGP(kernel=SquaredExponential(), num_data=len(x), num_probes=2,
                conjugate_gradient=model.conjugate_gradient, serving_lanczos_rank=love_rank)
    post_l = love.posterior(p, solver="lanczos")
    out["love_single"] = _np(posterior_predict_scan(love, post_l, xq, batch_size=48))
    out["love_mesh"] = _np(posterior_predict_scan(love, post_l, xq, batch_size=48, mesh=mesh))
    sharded = ShardedCGGP(kernel=SquaredExponential(), mesh=mesh, num_data=len(x),
                          error_threshold=1e-8, max_cg_iterations=64)
    sp = sharded.init_params(_t(x[:m]).to(torch.float32), noise_variance=0.1,
                             dtype=torch.float32, device="cpu")
    try:
        predict_in_batches(sharded, sp, xq, batch_size=40, mesh=mesh)
        out["refused"] = None
    except ValueError as exc:
        out["refused"] = str(exc)
    return out


@case
def trainer_sharded(mesh, params, x, y, model_kw, iterations, batch, lr, k):
    """The K-step trainer on ``ShardedCGGP`` (no mesh argument: the model's
    own collectives): the loss before and after on the same probes."""
    import torch

    import cggp_tpu_torch.models.rowcg as rowcg
    from cggp_tpu_torch.ops.kernels import Matern32
    from cggp_tpu_torch.parallel import ShardedCGGP
    from cggp_tpu_torch.training.optimize import train_using_adam_and_update

    model = ShardedCGGP(kernel=Matern32(), mesh=mesh, **model_kw)
    p0 = _params(params)
    data = (_t(x), _t(y))
    rowcg.rademacher = __import__("cggp_tpu_torch.ops.logdet", fromlist=["x"]).rademacher

    def evaluate(p):
        return float(model.training_loss(p, data, torch.Generator().manual_seed(0)))

    before = evaluate(p0)
    trained = train_using_adam_and_update(p0, model.training_loss, data, iterations, batch, lr,
                                          torch.Generator().manual_seed(0), steps_per_call=k,
                                          trainable_mask=model.trainable_mask(p0))
    return {"before": before, "after": evaluate(trained)}


@case
def mesh_errors(mesh):
    """``make_mesh`` with a size other than the world's raises ValueError."""
    from cggp_tpu_torch.parallel import make_mesh

    out = {}
    for n in (mesh.size + 1, 1):
        try:
            make_mesh(n, device="cpu")
            out[n] = None
        except ValueError as exc:
            out[n] = str(exc)
    return out


# -- gang training over a mesh ---------------------------------------------


@case
def gang_sharded(mesh, x, y, variants, model_kw, kw):
    """``train_gang_adam`` with and without the mesh on this rank (the same
    generator seed): both runs' members and losses."""
    import torch

    from cggp_tpu_torch.models.cggp import CGGP
    from cggp_tpu_torch.ops.cg import ConjugateGradient
    from cggp_tpu_torch.ops.kernels import Matern32
    from cggp_tpu_torch.training.gang import train_gang_adam

    m = len(variants[0]["inducing_points"])
    model = CGGP(kernel=Matern32(), conjugate_gradient=ConjugateGradient(
        1e-10, max_iterations=4 * m), **model_kw)
    params = [_params(v) for v in variants]
    data = (_t(x), _t(y))
    out = {}
    for name, mesh_arg in (("single", None), ("mesh", mesh)):
        trained, losses = train_gang_adam(params, model.training_loss, data,
                                          key=torch.Generator().manual_seed(1),
                                          trainable_mask=model.trainable_mask(params[0]),
                                          mesh=mesh_arg, **kw)
        out[name] = {"losses": losses, "members": [_flat(p) for p in trained]}
    return out
