"""Condition-number / Wasserstein figure harness (port of
``cggp_tpu/cli/condition_wasserstein.py``).

For each input dimension: data drawn from a GP prior, the exact GPR
posterior, then a sweep of cover-tree resolutions, each recording the
condition number of ``Kuu + Lambda``, M, the CG iterations of the
``(Kuu + Lambda)^{-1} u`` solve and the squared 2-Wasserstein distance of
the CDGP posterior from the exact one.  One CSV per dimension (written with
``csv``, laid out as pandas writes the JAX package's) and optional plots.

The oracle (prior sample, exact posterior, W2) runs in float64; ``-p fp32``
runs only the CDGP side in float32.  Where the JAX package splits a key
three ways, the port draws the inputs, the prior's normals and the noise in
that order from one ``torch.Generator`` seeded ``-s`` (:func:`uniform_draw`
and ``normal_draw``, looked up by name).  ``--selection covernet`` selects
by the device net instead of the host cover tree.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from cggp_tpu_torch.cli.cli_utils import Command, Context, FloatType, LogdirPath, echo
from cggp_tpu_torch.cli.uci_csv import write_rows_csv
from cggp_tpu_torch.config import resolve_device
from cggp_tpu_torch.models import CGGP, GPR
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.ops.kernels import Kernel, SquaredExponential
from cggp_tpu_torch.ops.linalg import add_diagonal
from cggp_tpu_torch.ops.logdet import normal_draw
from cggp_tpu_torch.selection.covernet import covernet_update_inducing_parameters
from cggp_tpu_torch.selection.update import covertree_update_inducing_parameters


def uniform_draw(generator: torch.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    """Uniform draws on ``[-1, 1)`` in ``dtype`` from ``generator``."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device, dtype=dtype)
    return 2.0 * u - 1.0


def matrix_sqrt(m: torch.Tensor, floor: float = 0.0) -> torch.Tensor:
    """Symmetric PSD square root ``V sqrt(D) V^T``.

    The JAX package's deliberate fix of the reference, which returned
    ``V sqrt(D)`` without the trailing ``V^T`` (not a matrix square root)
    and so reported values that are not W2 distances."""
    eigvals, eigvecs = torch.linalg.eigh(m)
    eigvals = torch.clamp(eigvals, min=floor)
    return (eigvecs * torch.sqrt(eigvals)[None, :]) @ eigvecs.T


def wasserstein2(moments1: Tuple[torch.Tensor, torch.Tensor],
                 moments2: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Squared 2-Wasserstein distance between two Gaussians:
    ``|mu1-mu2|^2 + tr(C1 + C2 - 2 (C1^{1/2} C2 C1^{1/2})^{1/2})``."""
    mu1, cov1 = moments1
    mu2, cov2 = moments2
    sqrt_cov1 = matrix_sqrt(cov1)
    inner = sqrt_cov1 @ cov2 @ sqrt_cov1
    inner = 0.5 * (inner + inner.T)  # exact symmetry for eigh
    cross = torch.sum(torch.sqrt(torch.clamp(torch.linalg.eigvalsh(inner), min=0.0)))
    norm_term = torch.sum(torch.square(mu1 - mu2))
    return norm_term + torch.trace(cov1 + cov2) - 2.0 * cross


def sample_gpr_prior(kernel: Kernel, kp, inputs: torch.Tensor, generator: torch.Generator,
                     jitter: float = 1e-10) -> torch.Tensor:
    """One sample [N, 1] from the zero-mean GP prior at ``inputs``."""
    n = inputs.shape[0]
    cov = add_diagonal(kernel.K(kp, inputs),
                       jitter * torch.ones(n, dtype=inputs.dtype, device=inputs.device))
    chol = torch.linalg.cholesky(cov)
    eps = normal_draw(generator, (n, 1), inputs.dtype)
    return chol @ eps


def run_sweep(dim: int, num_data: int, resolutions, noise: float, seed: int,
              solver_dtype=None, precondition: str = None, selection: str = "covertree",
              device=None):
    """One dimension's resolution sweep; returns a list of row dicts.  The
    oracle is float64 on ``device`` (``config.resolve_device``: ``None``
    means the card, and no card raises); ``solver_dtype``
    runs only the CDGP side (covertree-conditioned ``Kuu + Lambda``, CG,
    predictive moments) at another precision; ``precondition`` threads the
    model's preconditioner into the stats solve and the prediction."""
    update_fn = (covernet_update_inducing_parameters if selection == "covernet"
                 else covertree_update_inducing_parameters)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dtype = torch.float64
    solver_dtype = dtype if solver_dtype is None else solver_dtype

    kernel = SquaredExponential()
    kp = kernel.init_params(variance=1.0, lengthscales=np.full(dim, 0.5), dtype=dtype,
                            device=device)
    x = uniform_draw(gen, (num_data, dim), dtype)
    f = sample_gpr_prior(kernel, kp, x, gen)
    y = f + np.sqrt(noise) * normal_draw(gen, tuple(f.shape), dtype)
    data = (x, y)

    gpr = GPR(kernel=kernel)
    gpr_params = gpr.init_params(dim, noise_variance=noise, dtype=dtype, device=device)
    gpr_params["kernel"] = dict(kp)
    with torch.no_grad():
        mu_exact, cov_exact = gpr.predict_f(gpr_params, data, x, full_cov=True)
    gpr_moments = (mu_exact, cov_exact[0])

    x_lo = x.to(solver_dtype)
    kp_lo = {k: v.to(solver_dtype) for k, v in kp.items()}

    rows = []
    for resolution in resolutions:
        iv, means, counts = update_fn(data, float(resolution))
        m = iv.shape[0]

        cg = ConjugateGradient(1e-6, max_iterations=max(m, 8))
        model = CGGP(kernel=kernel, conjugate_gradient=cg, num_data=num_data, num_probes=5,
                     precondition=precondition)
        params = model.init_params(iv.to(solver_dtype), pseudo_u=means.to(solver_dtype),
                                   cluster_counts=counts.to(solver_dtype),
                                   noise_variance=noise, dtype=solver_dtype, device=device)
        params["kernel"] = kp_lo

        with torch.no_grad():
            var = model.diag_variance(params)
            lam = var[:, 0]
            kuu = kernel.K(params["kernel"], params["inducing_points"])
            kuu_lambda = add_diagonal(kuu, lam)
            precond = model._build_preconditioner(
                params["kernel"], params["inducing_points"], kuu, var,
                torch.Generator(device=device).manual_seed(int(seed) + 1))
            _, stats = cg.solve_with_stats(kuu_lambda, params["pseudo_u"],
                                           preconditioner=precond)
            # The solver-precision matrix's condition number, measured in fp64.
            eigvals = np.linalg.eigvalsh(kuu_lambda.cpu().numpy().astype(np.float64))
            mu_approx, cov_approx = model.predict_f(params, x_lo, full_cov=True)
            w2 = float(wasserstein2(gpr_moments, (mu_approx.to(dtype), cov_approx[0].to(dtype))))

        row = {
            "dim": dim,
            "selection": selection,
            "resolution": float(resolution),
            "num_inducing_points": int(m),
            "condition_number": float(eigvals.max() / eigvals.min()),
            "eig_min": float(eigvals.min()),
            "eig_max": float(eigvals.max()),
            "cg_iterations": int(stats.steps),
            "wasserstein2": w2,
        }
        bad = [k for k, v in row.items() if not isinstance(v, str) and not np.isfinite(v)]
        if bad:
            echo(f"WARNING dim={dim} res={resolution}: non-finite {bad} — run with -p fp64 "
                 "(fp32 NaNs out of the jitter=1e-10 prior Cholesky at these lengthscales)",
                 err=True)
        rows.append(row)
    return rows


def _table(rows) -> str:
    """``rows`` as a plain right-aligned text table."""
    columns = list(rows[0])
    cells = [[str(r[c]) for c in columns] for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in cells)) for i, c in enumerate(columns)]
    lines = [" ".join(c.rjust(w) for c, w in zip(columns, widths))]
    lines += [" ".join(v.rjust(w) for v, w in zip(row, widths)) for row in cells]
    return "\n".join(lines)


def run(ctx: Context, logdir, precision, num_data, seed, noise, dims, resolutions, plot,
        precondition, selection) -> None:
    """``-p fp64`` runs everything in fp64; ``-p fp32`` keeps the fp64
    oracle and runs the CDGP side in fp32 (a ``_fp32`` file suffix)."""
    device = ctx.torch_device()
    solver_dtype = torch.float32 if precision == np.float32 else torch.float64
    precondition = None if precondition == "none" else precondition
    suffix = "_fp32" if precision == np.float32 else ""
    if precondition is not None:
        suffix += f"_{precondition}"
    if selection != "covertree":
        suffix += f"_{selection}"

    all_rows = []
    for dim in dims:
        rows = run_sweep(dim, num_data, resolutions, noise, seed, solver_dtype=solver_dtype,
                         precondition=precondition, selection=selection, device=device)
        all_rows.extend(rows)
        out = Path(logdir, f"condition_wasserstein_dim{dim}{suffix}.csv")
        write_rows_csv(out, rows)
        echo(f"dim={dim}: wrote {out}")
        echo(_table(rows))

    if plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        for dim in sorted({r["dim"] for r in all_rows}):
            group = [r for r in all_rows if r["dim"] == dim]
            ms = [r["num_inducing_points"] for r in group]
            for ax, key in zip(axes, ("condition_number", "wasserstein2", "cg_iterations")):
                ax.plot(ms, [r[key] for r in group], marker="o", label=f"d={dim}")
        for ax, ylabel in zip(axes, ["condition number", "W2^2", "CG iterations"]):
            ax.set_xlabel("M")
            ax.set_ylabel(ylabel)
            ax.set_yscale("log")
            ax.legend()
        fig.tight_layout()
        out = Path(logdir, f"condition_wasserstein{suffix}.png")
        fig.savefig(out, dpi=120)
        echo(f"wrote {out}")

    echo("=== Script finished ===")


def make_command() -> Command:
    cmd = Command("condition-wasserstein", run,
                  help="Condition number and W2 distance against the cover-tree resolution.")
    cmd.option("-l", "--logdir", type=LogdirPath(), default=LogdirPath.default_logdir)
    cmd.option("-p", "--precision", type=FloatType(), default="fp64")
    cmd.option("-n", "--num-data", type=int, default=400)
    cmd.option("-s", "--seed", type=int, default=0)
    cmd.option("--noise", type=float, default=0.01)
    cmd.option("-d", "--dims", multiple=True, type=int, default=(1, 2, 4, 8))
    cmd.option("-r", "--resolutions", multiple=True, type=float,
               default=(1.0, 0.5, 0.2, 0.1, 0.05, 0.02))
    cmd.flag_pair(["--plot"], ["--no-plot"], dest="plot", default=False)
    cmd.option("--precondition", choices=["none", "pivchol", "rff", "chol"], default="none",
               help="Per-solve preconditioner for the CDGP side.")
    cmd.option("--selection", choices=["covertree", "covernet"], default="covertree",
               help="Inducing-point selection for the CDGP side: the host cover tree, or the "
                    "device delta-net with the same separation and coverage guarantees.")
    return cmd
