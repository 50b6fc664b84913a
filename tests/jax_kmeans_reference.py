"""The JAX package's fp32 k-means reference for ``chip_smoke.py``'s
``select_kmeans`` phase (its ``JAX_KMEANS`` figures): ``kmeans_lloyd`` over
the e2e training split, ``synthetic(n=435_000, dim=3, seed=0)`` in float32,
warm-started from the committed cover-tree selection
``benchmarks/e2e_selection_covertree.npz`` (M = 989), as the JAX CLI's
k-means update function warm-starts from the current inducing points.

Run from the repository root on the CPU (~1 min)::

    env JAX_PLATFORMS=cpu python tests/jax_kmeans_reference.py

It prints one JSON line: the Lloyd iterations (assignment passes, counted
through a ``jax.debug.callback`` in a wrapper of
``kmeans_indices_and_distances``; the JAX package is not changed), the final
mean distance, and summaries of the centroids.  Not a test module: pytest
collects only ``test_*.py``.
"""

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

import cggp_tpu.selection.kmeans as kmeans_module  # noqa: E402
from cggp_tpu.data import synthetic  # noqa: E402


def main() -> None:
    (x, _), _ = synthetic(n=435_000, dim=3, seed=0)
    with np.load(ROOT / "benchmarks" / "e2e_selection_covertree.npz") as sel:
        iv = sel["iv"]
    passes = []
    assign = kmeans_module.kmeans_indices_and_distances

    def counted(centroids, points, distance_fn=None):
        jax.debug.callback(lambda: passes.append(1))
        return assign(centroids, points, distance_fn=distance_fn)

    kmeans_module.kmeans_indices_and_distances = counted
    t0 = time.perf_counter()
    centroids, mean = kmeans_module.kmeans_lloyd(jnp.asarray(x, jnp.float32), iv.shape[0],
                                                 initial_centroids=jnp.asarray(iv))
    centroids = np.asarray(centroids)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "jax": jax.__version__, "dtype": str(centroids.dtype), "k": int(iv.shape[0]),
        "lloyd_passes": len(passes), "mean_distance": float(mean),
        "centroid_sum": float(centroids.astype(np.float64).sum()),
        "centroid_abs_sum": float(np.abs(centroids.astype(np.float64)).sum()),
        "max_shift_from_start": float(np.abs(centroids - iv).max()),
        "wall_s": wall}))


if __name__ == "__main__":
    main()
