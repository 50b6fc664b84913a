"""The JAX package's fp32 first training step of the matrix-free model, the
reference of ``chip_smoke.py``'s ``check_train_implicit_jax`` phase (its
``JAX_IMPLICIT_TRAIN_STEP0`` figures).

The step: ``ImplicitCGGP`` (Matern32 at init parameters, ``block=2048``,
pivoted Cholesky at rank 128, relative threshold 1e-5, ``max_cg_iterations
1000``, 5 probes) on the committed cover-tree selection
``cggp_tpu_torch/assets/selection_covertree_r015.npz`` (M = 9576, padded to
10240), over a batch of the e2e training split ``synthetic(n=435_000,
dim=3, seed=0)`` in float32: ``jax.value_and_grad`` of ``training_loss``
on the blocked XLA route.  The batch's indices and the step's probes (trace
probes, then logdet probes) come from the file the card's run of
``chip_smoke.py`` writes, ``chiprun_out/implicit_train_step0.npz``; the
JAX package's ``rademacher`` is replaced, in this process only, by a
function returning those probes.  The forward and the backward CG steps are
read through a ``jax.debug.callback`` in a wrapper of
``cggp_tpu.ops.cg_implicit.cg_loop``; the JAX package is not changed.

Run from the repository root on the CPU (about 7 min on 8 cores, ~2 GB)::

    env JAX_PLATFORMS=cpu python tests/jax_implicit_train_reference.py [path]

It prints one JSON line.  Not a test module: pytest collects only
``test_*.py``.
"""

import hashlib
import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import cggp_tpu.models.rowcg as rowcg_module  # noqa: E402
import cggp_tpu.ops.cg_implicit as cg_implicit_module  # noqa: E402
from cggp_tpu.data import synthetic  # noqa: E402
from cggp_tpu.models.implicit import ImplicitCGGP  # noqa: E402
from cggp_tpu.ops.kernels import Matern32  # noqa: E402

SELECTION = ROOT / "cggp_tpu_torch" / "assets" / "selection_covertree_r015.npz"
TRAINABLE = (("kernel", "variance"), ("kernel", "lengthscales"), ("likelihood", "variance"))


def main() -> None:
    path = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "chiprun_out" / \
        "implicit_train_step0.npz"
    with np.load(path) as step0:
        probes, batch_index = step0["probes"], step0["batch_index"]
    (x, y), _ = synthetic(n=435_000, dim=3, seed=0)
    with np.load(SELECTION) as sel:
        iv, u, counts = sel["iv"], sel["u"], sel["counts"]
    model = ImplicitCGGP(kernel=Matern32(), num_data=x.shape[0], block=2048,
                         precondition="pivchol", precond_rank=128, relative_threshold=True,
                         error_threshold=1e-5, max_cg_iterations=1000, num_probes=5)
    params = model.init_params(iv, pseudo_u=u, cluster_counts=counts, dtype=jnp.float32)
    assert params["inducing_points"].shape[0] == probes.shape[-1]

    queue = [jnp.asarray(p) for p in probes]  # trace probes, then logdet probes

    def card_probes(key, shape, dtype):
        got = queue.pop(0)
        assert got.shape == tuple(shape), (got.shape, shape)
        return got.astype(dtype)

    rowcg_module.rademacher = card_probes
    solves = []
    cg_loop = cg_implicit_module.cg_loop

    def recording(*args, **kwargs):
        solution, stats = cg_loop(*args, **kwargs)
        jax.debug.callback(lambda s, c: solves.append((int(s), bool(c))), stats[0], stats[2])
        return solution, stats

    cg_implicit_module.cg_loop = recording
    batch = (jnp.asarray(x[batch_index], jnp.float32), jnp.asarray(y[batch_index], jnp.float32))
    t0 = time.perf_counter()
    loss, grads = jax.value_and_grad(model.training_loss)(params, batch, jax.random.PRNGKey(0))
    loss = float(loss)
    jax.effects_barrier()
    wall = time.perf_counter() - t0
    assert not queue and len(solves) == 2, (len(queue), solves)
    print(json.dumps({
        "jax": jax.__version__, "dtype": "float32", "rows": int(1 + 2 * 5 + batch_index.shape[0]),
        "m_pad": int(probes.shape[-1]),
        "probes_sha256": hashlib.sha256(probes.tobytes()).hexdigest(),
        "batch_index_sha256": hashlib.sha256(batch_index.tobytes()).hexdigest(),
        "loss": loss,
        "grad_norms": {f"{a}/{b}": float(np.linalg.norm(np.asarray(grads[a][b], np.float64)))
                       for a, b in TRAINABLE},
        "cg_steps": [s for s, _ in solves], "converged": [c for _, c in solves],
        "wall_s": wall}))


if __name__ == "__main__":
    main()
