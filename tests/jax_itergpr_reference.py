"""The JAX package's first step of the exact GP at N = 16,384, in float32
and in float64, the reference of ``chip_smoke.py``'s ``check_itergpr_small``
phase (its ``JAX_ITERGPR_STEP0`` figures).

The step: ``IterGPR`` (Matern32 at ``init_params``: variance 1, lengthscales
1, noise 0.1; ``block=4096``, pivoted Cholesky at rank 256, relative
threshold 1e-4, ``max_cg_iterations=1000``, 8 probes, SLQ with 20 Lanczos
steps) on the first 16,384 training rows of ``synthetic(n=195_633, dim=3,
seed=0)`` in float32 (``scripts/exact_gp_train_chip.py``'s split):
``jax.value_and_grad`` of ``training_loss`` on the blocked XLA route, with
fixed probes.  With ``--float64`` the same step runs in float64 (from the
same float32 data and parameters, widened) at relative threshold 1e-12 and
``max_cg_iterations=5000``, as the port's float64 reference does on the
card.  With ``--port`` the port's ``IterGPR`` takes the same fp32 step on
the CPU (``torch.autograd``), which separates the platform's fp32 rounding
from the package's.  The probes are 8 Rademacher rows of 131,072 columns drawn by
``np.random.default_rng(7)`` (the full-size run's, cut to the first 16,384
columns here), made the same way in ``chip_smoke.py``; their sha256 is the
full rows'.  The forward and the backward CG steps are read through a
``jax.debug.callback`` in a wrapper of ``cggp_tpu.ops.cg_implicit.cg_loop``;
the JAX package is not changed.

Run from the repository root on the CPU (a few minutes on 8 cores)::

    env JAX_PLATFORMS=cpu python tests/jax_itergpr_reference.py
    env JAX_PLATFORMS=cpu python tests/jax_itergpr_reference.py --float64
    env JAX_PLATFORMS=cpu python tests/jax_itergpr_reference.py --port

Each prints one JSON line.  Not a test module: pytest collects only
``test_*.py``.
"""

import hashlib
import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
FLOAT64 = "--float64" in sys.argv[1:]
jax.config.update("jax_enable_x64", FLOAT64)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import cggp_tpu.ops.cg_implicit as cg_implicit_module  # noqa: E402
from cggp_tpu.data import synthetic  # noqa: E402
from cggp_tpu.models.itergpr import IterGPR  # noqa: E402
from cggp_tpu.ops.kernels import Matern32  # noqa: E402

N_FULL, N_SMALL, PROBES, PROBE_SEED = 131_072, 16_384, 8, 7
TRAINABLE = (("kernel", "variance"), ("kernel", "lengthscales"), ("likelihood", "variance"))


def fixed_probes() -> np.ndarray:
    """The 8 full-size Rademacher rows (float32, [8, 131072])."""
    rng = np.random.default_rng(PROBE_SEED)
    return (2 * rng.integers(0, 2, size=(PROBES, N_FULL)) - 1).astype(np.float32)


def port_step() -> None:
    """The same fp32 step through the port's ``IterGPR`` on the CPU."""
    import torch

    import cggp_tpu_torch.ops.cg_implicit as port_cg_implicit
    from cggp_tpu_torch.models import IterGPR as PortIterGPR
    from cggp_tpu_torch.ops.kernels import Matern32 as PortMatern32

    probes = fixed_probes()
    (x, y), _ = synthetic(n=195_633, dim=3, seed=0)
    model = PortIterGPR(kernel=PortMatern32(), error_threshold=1e-4, relative_threshold=True,
                        max_cg_iterations=1000, num_probes=PROBES, slq_lanczos_iters=20,
                        precondition="pivchol", precond_rank=256, block=4096)
    params = model.init_params(3, dtype=torch.float32, device="cpu")
    live = {s: {k: v.requires_grad_() for k, v in d.items()} for s, d in params.items()}
    solves = []
    impl = port_cg_implicit._implicit_cg_impl

    def recording(*args):
        solution, stats = impl(*args)
        solves.append((int(stats.steps), bool(stats.converged)))
        return solution, stats

    port_cg_implicit._implicit_cg_impl = recording
    data = tuple(torch.as_tensor(a[:N_SMALL], dtype=torch.float32) for a in (x, y))
    t0 = time.perf_counter()
    loss = model.training_loss(live, data, probes=torch.as_tensor(probes[:, :N_SMALL]))
    grads = torch.autograd.grad(loss, [live[a][b] for a, b in TRAINABLE])
    wall = time.perf_counter() - t0
    print(json.dumps({
        "package": "cggp_tpu_torch", "torch": torch.__version__, "dtype": "float32",
        "n": N_SMALL, "rows": 1 + PROBES,
        "probes_sha256": hashlib.sha256(probes.tobytes()).hexdigest(), "loss": float(loss),
        "grad_norms": {f"{a}/{b}": float(torch.linalg.vector_norm(g.double()))
                       for (a, b), g in zip(TRAINABLE, grads)},
        "cg_steps": [s for s, _ in solves], "converged": [c for _, c in solves],
        "wall_s": wall}))


def main() -> None:
    if "--port" in sys.argv[1:]:
        port_step()
        return
    dtype = jnp.float64 if FLOAT64 else jnp.float32
    probes = fixed_probes()
    (x, y), _ = synthetic(n=195_633, dim=3, seed=0)
    # The float32 data, widened for --float64: the port's float64 reference
    # widens the same float32 inputs (and parameters) on the card.
    x = jnp.asarray(x[:N_SMALL].astype(np.float32), dtype)
    y = jnp.asarray(y[:N_SMALL].astype(np.float32), dtype)
    model = IterGPR(kernel=Matern32(), error_threshold=1e-12 if FLOAT64 else 1e-4,
                    relative_threshold=True, max_cg_iterations=5000 if FLOAT64 else 1000,
                    num_probes=PROBES, slq_lanczos_iters=20, precondition="pivchol",
                    precond_rank=256, block=4096)
    # float32 parameters, widened for --float64 as the data are.
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                    model.init_params(input_dim=3, dtype=jnp.float32))
    solves = []
    cg_loop = cg_implicit_module.cg_loop

    def recording(*args, **kwargs):
        solution, stats = cg_loop(*args, **kwargs)
        jax.debug.callback(lambda s, c: solves.append((int(s), bool(c))), stats[0], stats[2])
        return solution, stats

    cg_implicit_module.cg_loop = recording
    small = jnp.asarray(probes[:, :N_SMALL], dtype)
    t0 = time.perf_counter()
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.training_loss(p, (x, y), probes=small)))(params)
    loss = float(loss)
    jax.effects_barrier()
    wall = time.perf_counter() - t0
    assert len(solves) == 2, solves
    print(json.dumps({
        "jax": jax.__version__, "dtype": jnp.dtype(dtype).name, "n": N_SMALL, "rows": 1 + PROBES,
        "probes_sha256": hashlib.sha256(probes.tobytes()).hexdigest(),
        "loss": loss,
        "grad_norms": {f"{a}/{b}": float(np.linalg.norm(np.asarray(grads[a][b], np.float64)))
                       for a, b in TRAINABLE},
        "cg_steps": [s for s, _ in solves], "converged": [c for _, c in solves],
        "wall_s": wall}))


if __name__ == "__main__":
    main()
