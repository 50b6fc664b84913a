#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (``cggp_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line of its own:

1. ``env``    the card (``nvidia-smi`` name and power limit), torch and CUDA
              versions, the TF32 switches.
2. ``build``  ``nvcc`` builds the kernels from ``cggp_tpu_torch/csrc``.
3. ``setup``  the serving workload: ``synthetic(n=435_000, dim=3, seed=0)``
              and the committed cover-tree selection (M = 989).
4. ``B1``     ``pallas_matvec`` against its plain version and fp64 at R = 1 and
              8192 (the kernel's error from fp64 at most 2x the plain
              version's), timed in turns with the plain version and
              ``torch.matmul`` (back-to-back calls; at R = 1 also replayed
              from a CUDA graph, the host out of the way).
5. ``B2``     ``pallas_cg_solve`` at R = 1 (the small-R path) and 8192 (the tiled
              3xTF32 path) against its plain version, its 3xTF32 emulation,
              fp64 and the JAX package's step counts; repeat runs bitwise
              equal; timed in turns with the plain version, per step and
              beside a kernel that only synchronises the same grid as often.
6. ``serve_pallas_resident`` / ``serve_pallas``  the port's serving path
              (``CGGP.posterior(solver="cg")`` + ``predict_in_batches``,
              4 x 8192 query points) through each kernel, with the launch
              counts set to 0 just before and read just after, and results
              held against the Cholesky posterior and the ``"xla"`` route.
   ``serve_love_dense``  the same points through ``posterior(solver=
              "lanczos")`` (the LOVE cache, rank 128; its ``nu`` solve on
              B2) by the loop and the scan route of ``predict_in_batches``
              (bitwise equal): means within ``SERVE_ATOL`` of the ``"cg"``
              route's, variances at least the fp64 Cholesky ones less the
              fp32 ``"cg"`` route's gap, at most the kernel variance.
   ``train_sgpr_lbfgs``  ``SGPR`` (float64, Z the committed selection, held
              fixed) over all 291,450 training rows: the first ELBO and its
              gradients against the host CPU's float64 (1e-9), scipy's
              L-BFGS-B for 20 iterations (the loss never rising between
              callbacks), the test split through ``predict_in_batches`` on
              the data-bound cache (RMSE falling), the device L-BFGS for 20
              iterations (ending at most 1e-3 |scipy's| above scipy's).
   ``train_lpsvgp`` / ``train_pathwise``  ``LpSVGP`` and
              ``PathwiseClusterGP`` (S = 8, L = 512), float64, 100 adam(0.01)
              steps on batches of 2048: the last 10 steps' mean loss below
              the first 10's.  No kernel runs in these three.
   ``pathwise_cggp``  ``build_pathwise_posterior(solver="cg")`` on the
              serving CGGP (S = 8, L = 512) through B2 (one launch), B1
              under the exact factor (steps + 1 launches) and ``"xla"``: the
              weights within 2x the fp32 ``"xla"`` route's gap from a float64
              Cholesky build on the same draws; the 4 x 8192 points through
              ``pathwise_samples_at`` and ``pathwise_samples_scan`` (bitwise
              equal); per-call samples against the cache; S = 256 sample
              moments within 5 Monte-Carlo standard errors at L = 512, 4096,
              32768 and 262144 (the mean of ClusterGP's at each L; the
              variance of the sampler's given its frequencies at L = 512,
              of ClusterGP's at L = 262144; the RFF error between the two
              reported at each L).
7. ``setup_train`` / ``reference_train``  the dense training workload: the
              same data and selection, batches of 2048 training points
              (indices from a seeded CPU generator, drawn up front), probes
              from a seeded generator on the card; the first step's loss and
              gradients in fp64 and on the fp32 ``"xla"`` loop.
   ``train_pallas_resident`` / ``train_pallas_chol`` / ``train_xla``  the
              port's training step (``CGGP.training_loss`` + ``make_adam_step``
              at adam(0.01)): B2 for both CG solves of a step (absolute 1e-8,
              no preconditioner), B1 for every matvec under the exact-factor
              preconditioner (relative 1e-5, ``bench.py``'s production solve),
              and the plain loop.  Each: the first step against fp64 (the
              relative gap of the loss and of each gradient at most 2x the
              fp32 ``"xla"`` route's), 3 warm-up steps, 20 timed steps with the
              launch counts of B1, B2 and B3 set to 0 just before and read just
              after (2 B2 launches a step; B1 launches = the solves' steps + 1;
              no B3 launch), every loss and parameter finite; B2 at the
              training shape (a step's forward and backward blocks) and B1 at
              R = 2059 against their plain versions and fp64, timed.
   ``check_train_jax``  B2's first-step forward and backward steps within
              max(3, 5 %) of the JAX package's (``JAX_TRAIN_STEP0``).
8. ``select_covertree``  ``covertree_update_inducing_parameters`` with the
              native cover tree (host C++, built at first use) at resolution
              0.35 over the float32 training split: M = 989, counts equal to
              the committed selection, Z and u within ``SELECT_ATOL`` of it,
              the minimum separation at least the last level's radius.
   ``select_kmeans``  ``kmeans_lloyd`` warm-started from that Z, in fp32 and
              fp64 on the card, then ``kmeans_update_inducing_parameters``:
              the fp32 run against the fp64 one and against the JAX
              package's fp32 run on the CPU (``JAX_KMEANS``), ms per Lloyd
              pass.
   ``train_multi_chol`` / ``train_multi_chol_frozen`` / ``train_multi_resident``
              ``make_adam_multi_step`` at K = 25 (``bench.py``'s method: a
              warm-up chunk, then 2 windows of 4 chunks, the best window's
              steps/s) through B1 under the exact factor at relative 1e-5
              (rebuilt every step, or frozen per chunk by
              ``precond_fn=model.precond_state``) and through B2 with no
              preconditioner at absolute 1e-8.  The warm-up chunk is held
              against 25 ``make_adam_step`` calls on the same indices and
              probes; each window's launch counts are set to 0 just before
              and read just after (B2 exactly 2 a step, B1 the solves'
              steps + 1, B3 none); every loss and parameter finite.
   ``train_loop``  ``train_using_adam_and_update`` for 100 steps at
              ``steps_per_call=25`` on the production route, re-clustering
              with the cover tree every chunk, with a ``create_monitor`` of
              the metrics (test RMSE, NLPD, train ELBO), parameter and
              CG-statistics callbacks at ``record_step=25``: logged values
              change from step to step, the test RMSE ends below its value
              before training, no CG solve unconverged, launches counted.
9. ``setup_implicit``  the matrix-free workload: the committed cover-tree
              selection at resolution 0.15 (M = 9576, padded to 10240 with
              ``block=2048``), ``ImplicitCGGP`` with pivoted-Cholesky
              preconditioning (rank 128) at relative threshold 1e-5.
10. ``B3``    ``kuu_matvec`` against its plain version and fp64 at M = 10240
              (real pads and mask) for R = 1, 8192 and the training block's
              2059 (above R = 8 the kernel's error from fp64 at most 2x the
              plain version's), ``gram_matvec``
              at N = 8192, M = 10240, R = 1, and ragged cases of each kernel
              family on both launch shapes; timed in turns with the plain
              version.
11. ``reference_implicit``  the fp64 Cholesky posterior over the real points.
12. ``serve_implicit_pallas`` / ``serve_implicit_xla``  the matrix-free
              serving path (``posterior(solver="cg")`` + ``predict_in_batches``,
              2 x 8192 query points) through B3 and through the plain blocked
              route, with the B3 launch counts set to 0 just before and read
              just after: every CG matvec must have gone through B3.
13. ``check_implicit_tight_{pallas,xla}``  one 8192-row batch per route at relative
              threshold 1e-9, held tightly against the fp64 posterior.
    ``reference_love_implicit`` / ``serve_love_implicit_xla`` /
              ``serve_love_implicit_pallas``  LOVE serving (rank 128) of the
              same 2 x 8192 points: an fp64 LOVE cache on the blocked route,
              then fp32 caches through the blocked route and through B3 (B3
              launches = the nu solve's steps + 1 + 128; R's pad columns
              zero); B3's variances within 2x the blocked route's gap from the
              fp64 cache, each conservative against the fp64 Cholesky
              variances less its allowance.
14. ``setup_train_implicit`` / ``reference_train_implicit``  matrix-free
              training on the same selection: batches of 2048 (indices from a
              seeded CPU generator, drawn up front), 5 probes from a seeded
              generator on the card (written with the first batch's indices to
              ``chiprun_out/implicit_train_step0.npz`` for the JAX reference),
              adam(0.01); the first step's loss and gradients in fp64 on the
              plain route at relative 1e-12 and in fp32 on the plain route.
    ``train_implicit_pallas`` / ``train_implicit_xla``  ``make_adam_step``
              through B3 and through the blocked route: the first step against
              fp64 (B3 at most 2x the fp32 plain route's gap), 1 warm-up step
              (peak device memory over it, beside one [M, M] fp32 buffer) and 3
              timed steps with the launch counts set to 0 just before and read
              just after (B3: ``kuu_matvec`` = the steps + 1 of every forward
              and backward solve, no ``gram_matvec``; blocked route: none);
              B3's first-step CG steps within max(3, 5 %) of the plain route's.
    ``train_multi_implicit``  ``make_adam_multi_step`` at K = 5 through B3,
              its chunk against 5 single steps, then a chunk with the factor
              frozen (``precond_fn=model.precond_state``), launches counted.
    ``train_loop_implicit``  ``train_using_adam_and_update`` for 10 steps at
              K = 5 through B3, a native cover-tree update at resolution 0.15
              each chunk re-padded by ``assign_clusters``, the metrics (first
              8192 test points), parameter and CG-statistics callbacks at
              ``record_step=5``; launches read apart for the steps, the
              callbacks and ``update_fn``.
    ``check_train_implicit_jax``  B3's first-step CG steps within max(3, 5 %)
              of the JAX package's (``JAX_IMPLICIT_TRAIN_STEP0``, from
              ``tests/jax_implicit_train_reference.py`` on the CPU), and JAX's
              loss and gradient norms within 2x the fp32 plain route's gap
              from fp64.
15. ``setup_itergpr``  the exact GP at the JAX package's exact-GP training run
              (``scripts/exact_gp_train_chip.py``): the first 131,072 rows of
              ``synthetic(n=195_633, dim=3, seed=0)``, ``IterGPR`` (block 4096,
              pivoted Cholesky rank 256, relative 1e-4, SLQ 20) with 8 fixed
              Rademacher probes (``np.random.default_rng(7)``).
    ``B3_itergpr``  ``kuu_matvec`` at M = N = 131,072 for R = 1, 9 and 512
              against the first 4096 output columns in fp32 and fp64 (its
              error from fp64 at most 2x the fp32 slice's), timed in turns
              with the blocked route's matvec.
    ``reference_itergpr`` / ``check_itergpr_small`` / ``itergpr_chunked``  at
              N = 16,384: the dense fp64 ``GPR`` (quadratic term, posterior,
              MLL) and the fp64 blocked route at 1e-12; the B3 route's first
              step, quadratic term and posterior within 2x the fp32 blocked
              route's gap, its CG steps within max(3, 5 %) of that route's and
              JAX's (``JAX_ITERGPR_STEP0``), launches counted; JAX's float64
              step within 1e-6 of the port's, JAX's fp32 gradient norms within
              2x the fp32 blocked route's gap; the chunked MLL and posterior
              against the fused ones.
    ``love_itergpr_small``  LOVE caches (rank 128) at N = 16,384 through
              B3, the fp32 and the fp64 blocked route: B3's variances within
              2x the fp32 route's gap from the fp64 cache, conservative
              against the dense fp64 ones; at rank = N = 512 (fp64) the
              cache's variances equal Cholesky's at 1e-8.
    ``train_itergpr_pallas``  ``train_full_batch_adam`` at N = 131,072 through
              B3, 1 warm-up + 2 timed steps at adam(0.1): the MLL rising,
              launches = the solves' steps + 1 per step, the first fused
              solve's true residual by one fp64 blocked matvec.
    ``serve_itergpr_pallas``  ``posterior`` and ``predict_in_batches(
              train_data=...)`` at the trained parameters: test RMSE below its
              untrained value, then means and variances of 512 points.
    ``serve_love_itergpr``  ``posterior(solver="lanczos")`` at the trained
              parameters through B3 (launches = the alpha solve's steps + 1
              + 128), means and variances of the 4096 test points with
              ``batch_size="auto"``: means equal the ``"cg"`` cache's, each of
              the first 512 variances at least the CG one less the stop
              rule's allowance ``2 sqrt(threshold) |k| |v|``.
    ``train_gpr_lbfgs``  ``paper_gpr``'s default: the dense float64 ``GPR``
              on the first 10,000 training rows, scipy's and the device
              L-BFGS for 50 iterations each (both below the init loss, the
              device's at most 1e-3 |scipy's| above scipy's).
    ``train_itergpr_lbfgs``  ``paper_gpr --iterative -o scipy``: scipy's
              L-BFGS-B of ``IterGPR`` at N = 131,072 through B3 with the
              fixed probes for 1 iteration (every MLL finite, the final
              loss below the init, B3 launches = the steps + 1 of each
              evaluation's solves), then both trainers for 10 iterations at
              N = 16,384 (device at most 1e-3 |scipy's| above scipy's).
16. ``setup_solver_family`` / ``solver_family``  ``bench.py``'s dense CG system
              (M = 32768, 16 right-hand sides) through every route of
              ``ConjugateGradient`` at relative 1e-6 and 1e-4 and through
              ``solve_chunked``, against an fp64 Cholesky solve, timed; the
              bf16 envelope check on three systems (see
              ``solver_family_phases``); B1 alone at R = 16 timed against
              ``torch.matmul`` (its error from fp64 at most 2x the library's).

Bounds (``bound_parts``): the least time of an fp32-accurate result, the
smaller of the fp32 FMA time and three TF32 passes on the tensor cores, then
the larger of that, the special functions and the bytes; ``simt_bound_ms``
keeps the fp32-FMA-only bound of the first kernels.

Then one ``kernels`` JSON line, the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Every phase runs under a deadline: device
work is awaited by polling a CUDA event against the clock, and a watchdog
(``faulthandler``, which needs no interpreter lock) ends the process if a
blocking call outlives the phase.  Any failure exits non-zero; without a
CUDA card, or without the rest of the repository, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import faulthandler
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOTAL_BUDGET_S = 1100.0  # the whole run, build included, stays under this
M_EXPECTED = 989
R_BATCH = 8192
NUM_BATCHES = 4
# Absolute CG threshold of the serving solves: JAX's fp32 "xla" route meets
# it at this shape (M = 989, Matern32 at init parameters) in ~185 steps for
# Kmn rows and ~255 for the pseudo-u solve, far below the max_iterations = M
# cap (tests/test_torch_cggp_serving.py::test_serving_threshold_converges_at_m989
# checks this on the CPU with 64 query rows).
CG_THRESHOLD = 1e-8
# Serving outputs of two fp32 routes, or CG against the Cholesky posterior:
# at this threshold the card's runs of this script put them ~2e-5 (mean)
# and ~8e-6 (variance) apart; the tolerance leaves a 25x margin.
SERVE_ATOL = 5e-4
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
FP32_PEAK_FLOPS = 67e12  # fp32 FMA outside the tensor cores
TF32_PEAK_FLOPS = 495e12  # dense TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
SFU_OPS_PER_CLOCK = 16 * 132  # special-function results (exp, sqrt) per clock, 132 SMs

# The matrix-free workload: the cover-tree selection of the same data at
# resolution 0.15 and the production configuration of the matrix-free model
# (configs/uci-cdgp-implicit.toml: pivoted Cholesky at rank 128, relative
# per-row thresholds), Matern32 at init parameters.
IMPLICIT_SELECTION = "cggp_tpu_torch/assets/selection_covertree_r015.npz"
IMPLICIT_M = 9576
IMPLICIT_BLOCK = 2048
IMPLICIT_M_PAD = 10240
IMPLICIT_BATCHES = 2
IMPLICIT_MAX_CG = 1000  # the pseudo-u solve needs ~160 steps; the default 100 stops short
IMPLICIT_THRESHOLD = 1e-5  # relative; the CLI's default
IMPLICIT_TIGHT_THRESHOLD = 1e-9
# Gates against the fp64 Cholesky posterior.  The JAX package's own fp32
# route, on the CPU at this configuration (first 32 test points), deviated
# from it by 3.5e-3 (mean) and 1.0e-3 (variance) at relative 1e-5 and by
# 1.0e-4 and 4.3e-6 at 1e-9.  The loose gate is 3x the former; the tight
# gate is 5e-4 and 5e-5, 5x and 12x the latter.
IMPLICIT_ATOL = {"mean": 3 * 3.5e-3, "var": 3 * 1.0e-3}
IMPLICIT_TIGHT_ATOL = {"mean": 5e-4, "var": 5e-5}
# The JAX package's own fp32 CG step counts for chip_smoke.py's B2 inputs
# (the committed M = 989 selection, Matern32 at init parameters, absolute
# threshold 1e-8, max_iterations = M): the rhs pseudo_u (255 steps, both
# the _cg_kernel loop under jax.jit at Precision.HIGHEST and
# pallas_cg_solve(interpret=True)) and K(x_test[:8192], Z) (198 steps, the
# jitted loop), run on the CPU with jax 0.9.0.
JAX_CG_STEPS = {"pseudo_u": 255, "kmn_batch": 198}
# The earlier B2 design (a SIMT fp32 tile product in the same cooperative
# grid) took 28.48 ms for the pseudo_u solve on an H100 80GB HBM3 at 700 W
# (PERF.md's kernel table): the small-R path must beat it.
B2_R1_BEFORE_MS = 28.48
# The JAX package's fp32 matrix-free route (use_pallas=False) at relative
# threshold 1e-5, against its fp64 Cholesky posterior, over the first 512 of
# the matrix-free query points (x_test[:512]), on the CPU with jax 0.9.0:
# max abs gap of the mean and of the variance.
JAX_IMPLICIT_GAP_512 = {"mean": 7.081343216427172e-3, "var": 9.075545169006105e-4}

# The dense training workload: the e2e data and selection above, Matern32
# at init parameters, num_probes=5, batches of 2048 points, adam(0.01).
TRAIN_BATCH = 2048
TRAIN_PROBES = 5
TRAIN_WARMUP = 3
TRAIN_STEPS = 20
TRAIN_LR = 0.01
TRAIN_BATCH_SEED = 0  # batch indices: a CPU generator, drawn for every step up front
TRAIN_PROBE_SEED = 1  # the probes: a generator on the card, reseeded for each phase
# bench.py's production training solve, with B1 in place of "xla_high":
# relative threshold 1e-5 under the exact-factor preconditioner.
TRAIN_CHOL_THRESHOLD = 1e-5
# The JAX package's fp32 values for the first training step of the
# train_pallas_resident configuration (absolute threshold 1e-8, no
# preconditioner, max_iterations = M), on the CPU with jax 0.9.0, with
# rademacher patched to return this script's probes (their sha256 below,
# written to chiprun_out/train_step0.npz with the batch's indices) and the
# jitted "xla" loop at Precision.HIGHEST: the loss, the gradient norms of the
# trainable parameters and the steps of the forward and backward CG solves.
JAX_TRAIN_STEP0 = {
    "probes_sha256": "e34b41de641856fc20e63cd12d4f5c8b69980b0996d4c05d58cba5f8811a1f04",
    "loss": -12601.994140625,
    "grad_norms": {"kernel/variance": 18141.625, "kernel/lengthscales": 29861.91015625,
                   "likelihood/variance": 89475.7890625},
    "cg_steps": [331, 371], "converged": [True, True]}

# The JAX package's e2e selection and training run (bench.py::end_to_end_metrics):
# the cover tree at resolution 0.35 over the float32 training split, then
# make_adam_multi_step at K = 25 in windows of 4 chunks, best of 3 there;
# best of 2 here, to keep the whole run near half its time limit.
SELECT_RES = 0.35
# Z and u of a fresh native build against the committed selection (built by
# the JAX package from the same float32 split): the JAX package's own native
# build reproduced it within 6e-8 on the CPU (float32 rounding of fp64
# centres and means); counts must be equal.
SELECT_ATOL = 1e-6
# The JAX package's fp32 k-means for the select_kmeans phase, on the CPU with
# jax 0.9.0 (tests/jax_kmeans_reference.py): kmeans_lloyd over the float32
# training split, k = 989, warm-started from the committed selection's Z;
# Lloyd passes (assignments) and the final mean distance, and sums of the
# centroids.
JAX_KMEANS = {"jax": "0.9.0", "lloyd_passes": 50, "mean_distance": 0.18876200914382935,
              "centroid_sum": 2.9715927221550373, "centroid_abs_sum": 3009.9370602845884}
# Lloyd in fp32 and fp64 from one start reach nearby fixed points, not the
# same one, and the fp32 run's path varies between runs (index_add_ sums in
# no fixed order).  Over three runs on an H100 80GB HBM3 (700 W) the port's
# fp32 run ended 2.8e-6 to 1.8e-5 (relative) from its fp64 run in mean
# distance and 3.2e-7 to 2.1e-5 from JAX's fp32 run, in as many passes (50)
# as both, its centroids 0.126 to 0.140 from the fp64 run's (rearrangements
# within cells of the 0.35 resolution) and their absolute sum 3.8e-5 to
# 5.9e-5 from JAX's; on the CPU the port's fp32 run gave 2.1e-5, 49 passes
# and 0.138.  The mean distance and the pass count carry the check: the
# mean distance held at 1e-4, about 5x the largest gap, the passes within 5
# and the centroids' absolute sum at 3e-4, 5x its largest gap.  The bound on
# the centroids' largest gap from fp64, one resolution, is only a sanity
# bound: it would pass a badly wrong centroid.
KMEANS_TOL = {"mean_distance_rel": 1e-4, "passes": 5, "centroid_max_abs": SELECT_RES,
              "centroid_abs_sum_rel": 3e-4}
MULTI_K = 25
MULTI_WINDOWS = 2
MULTI_CHUNKS = 4
MULTI_BATCH_SEED = 1  # the index chunks' numpy seed (bench.py: PRNGKey(1))
MULTI_PROBE_SEED = 2  # the probes: one generator on the card for the whole phase
# The warm-up chunk against K make_adam_step calls on the same indices and
# probes: the same operations in the same order, measured bitwise equal on
# every route (H100 80GB HBM3, 700 W); held at 1e-6 relative.
MULTI_CHUNK_RTOL = 1e-6
LOOP_ITERATIONS = 100
LOOP_RECORD_STEP = 25
LOOP_SEED = 3
METRICS_BATCH = 8192
# Matrix-free training (ImplicitCGGP on the matrix-free workload above):
# batches of 2048 training points, 5 probes, adam(0.01) from the init
# parameters; each step solves a fused [u | 5 trace probes | 5 logdet probes
# | Kmn] block of 2059 rows at M = 10240, forward and backward.
IMPLICIT_TRAIN_ROWS = 1 + 2 * TRAIN_PROBES + TRAIN_BATCH
IMPLICIT_TRAIN_WARMUP = 1
IMPLICIT_TRAIN_STEPS = 3  # timed single steps a route (5 before the LOVE phases came)
IMPLICIT_TRAIN_BATCH_SEED = 4  # batch indices: a CPU generator, drawn up front
IMPLICIT_TRAIN_PROBE_SEED = 5  # the probes: a generator on the card, reseeded per phase
# The float64 yardstick of the first step: relative threshold 1e-12 (the
# residual of each row within 1e-6 of its right-hand side's norm), a cap it
# must stop before.
IMPLICIT_REF_THRESHOLD = 1e-12
IMPLICIT_REF_MAX_CG = 5000
IMPLICIT_MULTI_K = 5
IMPLICIT_LOOP_ITERATIONS = 10
IMPLICIT_LOOP_RECORD_STEP = 5
IMPLICIT_SELECT_RES = 0.15  # the committed selection's resolution
IMPLICIT_METRICS_POINTS = 8192
# The JAX package's fp32 values for the first matrix-free training step (the
# train_implicit_pallas configuration on the blocked XLA route), on the CPU,
# from tests/jax_implicit_train_reference.py fed this script's probes and
# batch indices (chiprun_out/implicit_train_step0.npz; their sha256 below):
# the loss, the gradient norms and the forward and backward CG steps (jax
# 0.9.0, full batch, 395-562 s on 8 CPU cores).
JAX_IMPLICIT_TRAIN_STEP0 = {
    "probes_sha256": "33861cb6185f628738eef0d1ca4e9170dc6628e9b41bbd474d4af96b5b5f0013",
    "batch_index_sha256": "29b7633e9aed9630e90984d553dbc1dc89d8e8911c72a43702d6c657fee9e1cb",
    "loss": -23030.44140625,
    "grad_norms": {"kernel/variance": 3438.0, "kernel/lengthscales": 5791.760855517569,
                   "likelihood/variance": 118906.96875},
    "cg_steps": [230, 81], "converged": [True, True]}
# The exact GP (IterGPR) at the JAX package's own exact-GP training run,
# scripts/exact_gp_train_chip.py at its default N: synthetic(n=195_633,
# dim=3, seed=0), the first 131,072 training rows and the first 4096 test
# rows, float32 (no pads: 131,072 = 32 x 4096); Matern32 at init_params,
# block 4096, pivoted Cholesky at rank 256, relative threshold 1e-4, 8
# probes, SLQ with 20 Lanczos steps, adam(0.1).  The probes are fixed (8
# Rademacher rows drawn by np.random.default_rng(7)), so the objective is
# deterministic; the fp64 references run on the first 16,384 rows (the
# same probes cut to N).  Its 12 training steps are cut to 3 here (1
# warm-up + 2 timed).
ITERGPR_RAW_N = 195_633
ITERGPR_N = 131_072
ITERGPR_SMALL_N = 16_384
ITERGPR_TEST = 4096
ITERGPR_SMALL_TEST = 2048
ITERGPR_BLOCK = 4096
ITERGPR_PROBES = 8
ITERGPR_PROBE_SEED = 7
ITERGPR_THRESHOLD = 1e-4
ITERGPR_RANK = 256
ITERGPR_SLQ = 20
ITERGPR_LR = 0.1
ITERGPR_WARMUP = 1
ITERGPR_STEPS = 2
ITERGPR_VAR_BATCH = 512
ITERGPR_REF_THRESHOLD = 1e-12
ITERGPR_REF_MAX_CG = 5000
ITERGPR_CHUNK = 8
ITERGPR_CHUNK_THRESHOLD = 1e-8  # the chunked-against-fused comparison's (relative)
ITERGPR_NOISE_FLOOR_RMSE = 0.1
ITERGPR_LOVE_EXACT_N = 512  # rank = N: the LOVE cache is exact (fp64, a tiny slice)
# LOVE serving: the models' default serving_lanczos_rank.
LOVE_RANK = 128
# bench.py's dense CG system (bench.py:213-219): Matern32 over 8 dimensions
# at lengthscale 1.2, points uniform in [-2, 2]^8, Lambda uniform in [0.05,
# 0.5], 16 right-hand sides, numpy RandomState(0); A is 4.3 GB in fp32.
SOLVER_FAMILY_M = 32768
SOLVER_FAMILY_RHS = 16
SOLVER_FAMILY_CAP = 1000
SOLVER_FAMILY_CHUNK = 64
# The JAX package's check_bf16_envelope verdict for bf16_ir on the cover-tree
# training system (the committed M = 989 selection, Matern32 at init
# parameters, Lambda = 0.1 / counts >= 1.8e-4), on the CPU with jax 0.9.0:
# its Lanczos lambda_min estimate (~1.7e-2, the fp64 eigenvalue 1.67e-2)
# exceeds the bf16 perturbation (3.9e-3), so the route stays
# (tests/test_torch_solver_family.py holds the port to it).
JAX_ENVELOPE = {"training_system": "bf16_ir"}
# The JAX package's fp32 first step at N = 16,384 on the blocked XLA route
# with these probes, on the CPU (tests/jax_itergpr_reference.py, jax 0.9.0,
# 58 s on 8 cores): the loss, the gradient norms, the forward and backward
# CG steps, and the probes' sha256 (of the full [8, 131072] rows); under
# "float64" the same step from the fp32 data and parameters widened, at
# relative 1e-12 (the script's --float64, 178 s on 8 cores).
JAX_ITERGPR_STEP0 = {
    "probes_sha256": "e72184bb18c630871db22ab999a9c61c1bfea457d18c3f8afc9efb2d4678a890",
    "loss": -288.9619140625,
    "grad_norms": {"kernel/variance": 490.747802734375,
                   "kernel/lengthscales": 799.7800061298026,
                   "likelihood/variance": 6223.6767578125},
    "cg_steps": [20, 16], "converged": [True, True],
    "float64": {"loss": -288.77880031464883,
                "grad_norms": {"kernel/variance": 490.45387630263883,
                               "kernel/lengthscales": 799.646020440767,
                               "likelihood/variance": 6223.89886133914},
                "cg_steps": [52, 48], "converged": [True, True]}}
# The baselines of the paper (SGPR, LpSVGP, PathwiseClusterGP) on the e2e
# data at the committed selection (M = 989), float64 as the reference runs
# them: SGPR over the whole training split by L-BFGS (20 iterations of each
# trainer; the host CPU's float64 first ELBO over SGPR_CPU_CHECK_ROWS rows,
# None = all), LpSVGP and PathwiseClusterGP by 100 adam(0.01) steps on
# batches of 2048; the pathwise serving cache of the serving workload's CGGP
# at S = 8 samples of L = 512 bases.
SGPR_LBFGS_ITERATIONS = 20
SGPR_CPU_CHECK_ROWS = None
BASELINE_STEPS = 100
BASELINE_SEED = 9
PATHWISE_SAMPLES = 8
PATHWISE_BASES = 512
PATHWISE_SEED = 10
PATHWISE_CHECK_POINTS = 512
PATHWISE_MOMENT_SAMPLES = 256
# The sample moments' sweep in L: the RFF error given theta falls as
# 1 / sqrt(L); at L = 512 it put ClusterGP's variance 23.9 standard errors
# from the S = 256 samples' (H100 80GB HBM3, 700 W).
PATHWISE_MOMENT_BASES = (512, 4096, 32768, 262144)
# paper_gpr's L-BFGS entry points: the dense GPR on its default 10,000 rows
# (cggp_tpu/cli/paper_gpr.py), 50 iterations of each trainer; IterGPR at N =
# 131,072 through B3 for 1 scipy iteration, then the two trainers for 10
# iterations each at N = 16,384.  Two iterations at N = 131,072 took 342 s on
# an H100 80GB HBM3 at 700 W (5 evaluations of 34-49 s, and one of 183 s
# whose trial step ran both solves to the 1000-step cap), which would take
# the whole run past 1000 s; the first iteration's 2 evaluations take ~74 s.
GPR_LBFGS_N = 10_000
GPR_LBFGS_ITERATIONS = 50
ITERGPR_LBFGS_ITERATIONS = 1
ITERGPR_LBFGS_SMALL_ITERATIONS = 10
ITERGPR_LBFGS_BUDGET_S = 300
_T0 = time.monotonic()


def emit(record) -> None:
    print(json.dumps(record), flush=True)


class Phase:
    """A deadline-bounded phase: ``wait()`` polls a CUDA event instead of a
    blocking synchronize, and a faulthandler watchdog ends the process if a
    blocking call (a host read inside a solver loop) outlives the deadline."""

    def __init__(self, name: str, budget_s: float):
        self.name = name
        remaining = TOTAL_BUDGET_S - (time.monotonic() - _T0)
        self.budget_s = max(1.0, min(budget_s, remaining))

    def __enter__(self):
        self.t0 = time.monotonic()
        self.deadline = self.t0 + self.budget_s
        print(f"chip_smoke: phase {self.name} (deadline {self.budget_s:.0f} s)",
              file=sys.stderr, flush=True)
        faulthandler.dump_traceback_later(self.budget_s + 5.0, exit=True)
        return self

    def wait(self) -> None:
        event = torch.cuda.Event()
        event.record()
        while not event.query():
            if time.monotonic() > self.deadline:
                emit({"phase": self.name, "error": "deadline passed"})
                os._exit(1)
            time.sleep(0.0002)

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.wait()
        faulthandler.cancel_dump_traceback_later()
        return False


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def event_ms(phase: Phase, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    phase.wait()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    phase.wait()
    return start.elapsed_time(end) / reps


def bound_parts(nbytes: float, fma_flops: float, tc_flops: float = 0.0,
                transcendentals: float = 0.0, sm_clock_hz: float = 0.0):
    """The least time (ms) of an fp32-accurate result: the smaller of the
    fp32 FMA time of all ``fma_flops`` and the 3xTF32 time (three TF32
    passes over the product's ``tc_flops`` on the tensor cores, the rest in
    fp32 FMA), then the larger of that, the special-function time (exp,
    sqrt at 16 per clock per SM) and the byte time.  Returns the bound, what
    bounds it ("bytes" or "operations"), the part that sets it, and every
    part; "fp32 FMA" alone is the SIMT bound of the first kernels."""
    parts = {"fp32 FMA": fma_flops / FP32_PEAK_FLOPS * 1e3,
             "3xTF32 tensor cores": (3.0 * tc_flops / TF32_PEAK_FLOPS
                                     + (fma_flops - tc_flops) / FP32_PEAK_FLOPS) * 1e3,
             "special functions": (transcendentals / (SFU_OPS_PER_CLOCK * sm_clock_hz) * 1e3
                                   if transcendentals else 0.0),
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    arithmetic = min(parts["fp32 FMA"], parts["3xTF32 tensor cores"])
    limits = {"fp32 FMA" if arithmetic == parts["fp32 FMA"] else "3xTF32 tensor cores": arithmetic,
              "special functions": parts["special functions"], "bytes": parts["bytes"]}
    what = max(limits, key=limits.get)
    return limits[what], ("bytes" if what == "bytes" else "operations"), what, parts


def gram_bound(n: int, m: int, d: int, r: int, kernel_name: str, sm_clock_hz: float,
               nbytes: float):
    """bound_parts of ``K(x, z) @ v`` at [N, D], [M, D], [M, R]: the
    contraction's 2 N M R flops (3xTF32 on the tensor cores above R = 8),
    the distances' 2 N M D fp32 FMA, an exp (and for Matern a sqrt) per
    kernel value."""
    transcendentals = n * m * (1 if kernel_name == "se" else 2)
    return bound_parts(nbytes, 2.0 * n * m * (r + d), 2.0 * n * m * r, transcendentals,
                       sm_clock_hz)


def timed_in_turns(phase: Phase, fns, order, reps: int):
    """Device ms per call of each named function, timed in the given order
    (plain, kernel, kernel, plain: drift between the two shows), from CUDA
    events over back-to-back calls; returns {name: [ms, ...]}."""
    out = {name: [] for name in fns}
    for name in order:
        out[name].append(event_ms(phase, fns[name], reps=reps))
    return out


def graph_ms(phase: Phase, fn, calls: int = 20, reps: int = 5) -> float:
    """Device ms per call with the host out of the way: ``calls`` calls
    captured in one CUDA graph, replayed ``reps`` times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    phase.wait()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    phase.wait()
    ms = start.elapsed_time(end) / (reps * calls)
    del graph
    return ms


def b3_loader(b: torch.Tensor, rows: int, row_stride: int, depth_stride: int) -> str:
    """How B3 copies its B operand B(r, k) = b[r * row_stride + k * depth_stride]
    at ``rows`` rows, by the rule of ``csrc/pallas_gram.cu`` (TiledLaunch): up
    to 8 rows the small launch reads it directly; above, one TMA copy per
    stage when B's rows are contiguous and 16-byte aligned, else cp.async."""
    if rows <= 8:
        return "small launch"
    aligned = depth_stride == 1 and row_stride % 4 == 0 and b.data_ptr() % 16 == 0
    return "tma" if aligned else "cp.async"


def kernel_device_ms(phase: Phase, fn, calls: int = 20):
    """Device ms per call of each CUDA kernel ``fn`` launches, from
    torch.profiler's CUPTI trace over ``calls`` calls: {kernel name: ms}.
    A trace without device times gives {"error": ...} instead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    phase.wait()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            phase.wait()
        out = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            if us and "kernel" in ev.key:
                out[ev.key] = us / 1e3 / calls
        return out or {"error": "the trace holds no device time"}
    except Exception as exc:  # the measurement is reported, never gated
        return {"error": f"{type(exc).__name__}: {exc}"}


def ptxas_report(log: str):
    """Registers, shared memory and spills of each kernel in the build log
    (``nvcc -Xptxas -v``)."""
    kernels, current = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = re.search(r"(\w+_kernel)(I\w*?E)?", entry.group(1))
            current = {"kernel": name.group(0) if name else entry.group(1)}
            kernels.append(current)
        elif current is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill:
                current["spill_stores"], current["spill_loads"] = map(int, spill.groups())
            used = re.search(r"Used (\d+) registers", line)
            if used:
                current["registers"] = int(used.group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                current["static_smem"] = int(smem.group(1)) if smem else 0
    return kernels


def record_solves(model):
    """Wrap a row model's ``_solve`` so every solve's CGStats is kept, for
    reading after the timed window (the model itself discards them)."""
    stats = []
    solve = model._solve

    def recording(*args, **kwargs):
        solution, st = solve(*args, **kwargs)
        stats.append(st)
        return solution, st

    object.__setattr__(model, "_solve", recording)
    return stats


def b2_bound(rows: int, m: int, steps: int, plan):
    """bound_parts of one B2 solve of ``steps`` steps, counting this design's
    bytes (csrc/pallas_cg.cu), each once: A and b read, v written, and per
    step on the tiled path p read and pA written by the product, p, r, pA, v
    read and v, r, p written by the row pass (9 R M words); on the small-R
    path r written and read and each block's two partial dots.  Operations:
    per step the [R, M] x [M, M] product (3xTF32 on the tiled path, fp32 FMA
    on the small-R path) plus ~11 R M for dots and updates."""
    tiled = plan["path"] == "tiled"
    per_step_bytes = 4.0 * (9 * rows * m if tiled else 2 * rows * m + 4 * plan["grid"] * rows)
    bound = bound_parts(4.0 * (m * m + 2 * rows * m) + steps * per_step_bytes,
                        steps * (2.0 * rows * m * m + 11.0 * rows * m),
                        steps * 2.0 * rows * m * m if tiled else 0.0)
    return bound, per_step_bytes


def record_dense_solves(cg_module, operands: bool = True):
    """Wrap the dense CG's ``_cg_dense_impl`` (forward and backward solves
    alike) so every solve's CGStats (and with ``operands`` its system and
    right-hand side) are kept for reading after the timed window; returns
    the list and an undo."""
    solves = []
    impl = cg_module._cg_dense_impl

    def recording(*args):
        solution, stats = impl(*args)
        solves.append({"matrix": args[7].detach(), "rhs": args[8].detach(), "stats": stats}
                      if operands else {"stats": stats})
        return solution, stats

    cg_module._cg_dense_impl = recording

    def undo():
        cg_module._cg_dense_impl = impl

    return solves, undo


TRAINABLE = ("kernel/variance", "kernel/lengthscales", "likelihood/variance")


def loss_and_grads(model, params, batch, generator):
    """The training loss and the gradients of the trainable parameters."""
    live = {**params, "kernel": {k: v.detach().clone().requires_grad_()
                                 for k, v in params["kernel"].items()},
            "likelihood": {k: v.detach().clone().requires_grad_()
                           for k, v in params["likelihood"].items()}}
    loss = model.training_loss(live, batch, generator)
    leaves = [live["kernel"]["variance"], live["kernel"]["lengthscales"],
              live["likelihood"]["variance"]]
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(TRAINABLE, (g.detach() for g in grads)))


def relative_gaps(loss, grads, ref_loss, ref_grads):
    """Relative gap of the loss and of each gradient (norm of the difference
    over the norm of the reference) from a float64 reference."""
    out = {"loss": float(abs(loss.double() - ref_loss) / abs(ref_loss))}
    for name in TRAINABLE:
        ref = ref_grads[name]
        out[name] = float(torch.linalg.vector_norm(grads[name].double() - ref)
                          / torch.linalg.vector_norm(ref))
    return out


def e2e_phases(ctx) -> None:
    """The selection and training-loop phases (``select_covertree``,
    ``select_kmeans``, ``train_multi_*``, ``train_loop``) on the e2e
    workload: ``ctx`` carries the card, the fp32 parameters at M = 989, the
    training route's model factory, the training split on the card, the
    test split (numpy), the committed selection's path and the ``kernels``
    record, which gains each kernel's ``multi_*`` and ``loop_*`` counts."""
    import cggp_tpu_torch.ops.cg as cg_module
    import cggp_tpu_torch.selection.kmeans as kmeans_module
    from cggp_tpu_torch.ops.pallas_cg import pallas_cg_solve
    from cggp_tpu_torch.ops.pallas_gram import gram_matvec, kuu_matvec
    from cggp_tpu_torch.ops.pallas_matvec import pallas_matvec
    from cggp_tpu_torch.selection import native as covertree_native
    from cggp_tpu_torch.selection import (CoverTree, covertree_update_inducing_parameters,
                                          kmeans_lloyd, kmeans_update_inducing_parameters)
    from cggp_tpu_torch.training.batching import minibatch_index_iterator
    from cggp_tpu_torch.training.optimize import (adam, create_monitor, make_adam_multi_step,
                                                  make_adam_step, make_cg_stats_callback,
                                                  make_metrics_callback, make_param_callback,
                                                  train_using_adam_and_update)

    device, card_line, params = ctx["device"], ctx["card_line"], ctx["params"]
    train_model, kernels = ctx["train_model"], ctx["kernels"]
    xt, yt = ctx["data"]
    x_test, y_test = ctx["test_data"]
    selection_path = ctx["selection_path"]
    n_train = xt.shape[0]
    counted_kernels = (pallas_cg_solve, pallas_matvec, gram_matvec, kuu_matvec)

    def zero_counts():
        for counted in counted_kernels:
            counted.launches = 0

    def read_counts():
        return {counted.__name__: counted.launches for counted in counted_kernels}

    # -- select_covertree: the e2e selection, built fresh by the native code
    with Phase("select_covertree", 180) as ph:
        t0 = time.monotonic()
        covertree_native.build()  # host C++ at first use (not a GPU kernel)
        native_build_s = time.monotonic() - t0
        t0 = time.monotonic()
        sel_z, sel_u, sel_counts = covertree_update_inducing_parameters(
            (xt, yt), SELECT_RES, backend="native")
        ph.wait()
        select_s = time.monotonic() - t0
        require(sel_z.shape == (M_EXPECTED, 3), f"cover tree M = {sel_z.shape[0]}, want 989")
        require(sel_z.device == xt.device and sel_z.dtype == torch.float32,
                f"the selection landed on {sel_z.device} in {sel_z.dtype}")
        with np.load(selection_path) as sel:
            ref = {"iv": sel["iv"], "u": sel["u"], "counts": sel["counts"]}
        got = {"iv": sel_z.cpu().numpy(), "u": sel_u.cpu().numpy(),
               "counts": sel_counts.cpu().numpy()}
        gaps = {k: float(np.abs(got[k].astype(np.float64) - ref[k]).max()) for k in ("iv", "u")}
        require(np.array_equal(got["counts"], ref["counts"]),
                "cluster counts differ from the committed selection")
        require(all(v <= SELECT_ATOL for v in gaps.values()),
                f"Z / u {gaps} from the committed selection, beyond {SELECT_ATOL}")
        # The separation guarantee, in fp64 on the tree itself.
        t0 = time.monotonic()
        tree = CoverTree(None, (xt.cpu().numpy(), yt.cpu().numpy()),
                         spatial_resolution=SELECT_RES, backend="native")
        tree_s = time.monotonic() - t0
        last_radius = tree.max_radius / 2 ** (tree.num_levels - 1)
        separation = tree.minimum_separation()
        require(separation >= last_radius,
                f"minimum separation {separation} below the last radius {last_radius}")
        require(np.array_equal(tree.centroids.astype(np.float32), got["iv"]),
                "the tree's centres are not the update's Z")
        emit({"phase": "select_covertree", "backend": "native", "resolution": SELECT_RES,
              "m": int(sel_z.shape[0]), "levels": int(tree.num_levels),
              "native_build_s": native_build_s, "select_s": select_s, "tree_build_s": tree_s,
              "host_threads": int(covertree_native.load().covertree_num_threads()),
              "gap_vs_committed": gaps, "counts_equal": True,
              "min_separation": separation, "last_radius": last_radius,
              "tolerance": f"counts equal; Z and u within {SELECT_ATOL} of "
                           "benchmarks/e2e_selection_covertree.npz",
              "nvidia_smi": card_line, "wall_s": ph.elapsed()})

    # -- select_kmeans: Lloyd warm-started from the cover tree, fp32 and fp64
    with Phase("select_kmeans", 240) as ph:
        passes = []
        assign = kmeans_module.kmeans_indices_and_distances

        def counted_assign(centroids, points, distance_fn=None):
            passes.append(1)
            return assign(centroids, points, distance_fn=distance_fn)

        kmeans_module.kmeans_indices_and_distances = counted_assign
        lloyd = {}
        try:
            for label, dtype in (("fp32", torch.float32), ("fp64", torch.float64)):
                xs = xt.to(dtype)
                passes.clear()
                ph.wait()
                t0 = time.monotonic()
                centroids, mean = kmeans_lloyd(xs, M_EXPECTED, initial_centroids=sel_z.to(dtype))
                ph.wait()
                wall = time.monotonic() - t0
                lloyd[label] = {"centroids": centroids, "mean_distance": float(mean),
                                "passes": len(passes), "wall_s": wall,
                                "ms_per_pass": wall * 1e3 / len(passes)}
                del xs
        finally:
            kmeans_module.kmeans_indices_and_distances = assign
        t0 = time.monotonic()
        km_z, km_u, km_counts = kmeans_update_inducing_parameters(
            (xt, yt), lambda: lloyd["fp32"]["centroids"])
        ph.wait()
        update_s = time.monotonic() - t0
        require(km_z.shape == (M_EXPECTED, 3) and km_u.shape == (M_EXPECTED, 1)
                and km_counts.shape == (M_EXPECTED, 1), "k-means update shapes")
        require(all(bool(torch.isfinite(t).all()) for t in (km_z, km_u, km_counts)),
                "non-finite k-means update")
        require(float(km_counts.sum()) >= n_train, "k-means counts do not cover the data")
        c32 = lloyd["fp32"]["centroids"].double()
        c64 = lloyd["fp64"]["centroids"]
        vs_fp64 = {"mean_distance_rel": abs(lloyd["fp32"]["mean_distance"]
                                            - lloyd["fp64"]["mean_distance"])
                   / lloyd["fp64"]["mean_distance"],
                   "passes": lloyd["fp32"]["passes"] - lloyd["fp64"]["passes"],
                   "centroid_max_abs": float((c32 - c64).abs().max())}
        vs_jax = {"mean_distance_rel": abs(lloyd["fp32"]["mean_distance"]
                                           - JAX_KMEANS["mean_distance"])
                  / JAX_KMEANS["mean_distance"],
                  "passes": lloyd["fp32"]["passes"] - JAX_KMEANS["lloyd_passes"],
                  "centroid_sum": float(c32.sum()) - JAX_KMEANS["centroid_sum"],
                  "centroid_abs_sum_rel": abs(float(c32.abs().sum())
                                              - JAX_KMEANS["centroid_abs_sum"])
                  / JAX_KMEANS["centroid_abs_sum"]}
        for ref_name, gaps in (("fp64", vs_fp64), ("JAX", vs_jax)):
            require(gaps["mean_distance_rel"] <= KMEANS_TOL["mean_distance_rel"]
                    and abs(gaps["passes"]) <= KMEANS_TOL["passes"],
                    f"k-means fp32 vs {ref_name}: {gaps}, tolerance {KMEANS_TOL}")
        require(vs_fp64["centroid_max_abs"] <= KMEANS_TOL["centroid_max_abs"],
                f"k-means fp32 centroids {vs_fp64['centroid_max_abs']} from fp64")
        require(vs_jax["centroid_abs_sum_rel"] <= KMEANS_TOL["centroid_abs_sum_rel"],
                f"k-means fp32 centroids vs JAX {vs_jax}")
        emit({"phase": "select_kmeans", "k": M_EXPECTED, "points": int(n_train),
              **{label: {k: v for k, v in r.items() if k != "centroids"}
                 for label, r in lloyd.items()},
              "update_s": update_s, "fp32_vs_fp64": vs_fp64, "fp32_vs_jax_cpu_fp32": vs_jax,
              "jax_cpu_fp32": JAX_KMEANS, "tolerance": KMEANS_TOL,
              "nvidia_smi": card_line, "wall_s": ph.elapsed()})
        del c32, c64, lloyd, km_z, km_u, km_counts

    # -- train_multi_*: make_adam_multi_step at K = 25, bench.py's windows ----
    multi = {}

    def multi_phase(name, impl, config, frozen, windows, chunks_per_window, budget_s):
        """One warm-up chunk, held against K single steps on the same
        indices and probes, then ``windows`` windows of ``chunks_per_window``
        chunks with the launch counts set to 0 just before each and read
        just after; the best window gives steps/s."""
        with Phase(name, budget_s) as ph:
            model = train_model(impl, config)
            mask = model.trainable_mask(params)
            if frozen:
                def loss_fn(p, batch, key, state):
                    return model.training_loss(p, batch, key, precond_override=state)
            else:
                loss_fn = model.training_loss
            multi_step = make_adam_multi_step(loss_fn, adam(TRAIN_LR), (xt, yt), mask,
                                              precond_fn=model.precond_state if frozen else None)
            chunks = minibatch_index_iterator(MULTI_BATCH_SEED, n_train, TRAIN_BATCH, MULTI_K,
                                              device=device)

            def multi_gen():
                return torch.Generator(device=device).manual_seed(MULTI_PROBE_SEED)

            solves, undo = record_dense_solves(cg_module, operands=False)
            try:
                chunk0 = next(chunks)
                gen = multi_gen()
                p, opt, losses0 = multi_step(params, adam(TRAIN_LR).init(params), chunk0, gen)
                if frozen:
                    state0 = model.precond_state(params)
                    single = make_adam_step(lambda q, batch, key: loss_fn(q, batch, key, state0),
                                            adam(TRAIN_LR), mask)
                else:
                    single = make_adam_step(loss_fn, adam(TRAIN_LR), mask)
                q, q_opt, q_gen, single_losses = params, adam(TRAIN_LR).init(params), multi_gen(), []
                for row in chunk0:
                    q, q_opt, loss = single(q, q_opt, (xt[row], yt[row]), q_gen)
                    single_losses.append(loss)
                ph.wait()
                single_losses = torch.stack(single_losses)
                chunk_gap = {"loss_rel": float(((losses0 - single_losses).abs()
                                                / single_losses.abs()).max()),
                             "bitwise_equal": bool(torch.equal(losses0, single_losses))}
                for leaf in TRAINABLE:
                    section, key = leaf.split("/")
                    a, b = p[section][key], q[section][key]
                    chunk_gap[leaf] = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                    chunk_gap["bitwise_equal"] &= bool(torch.equal(a, b))
                require(all(v <= MULTI_CHUNK_RTOL for k, v in chunk_gap.items()
                            if k != "bitwise_equal"),
                        f"{name}: first chunk vs {MULTI_K} single steps {chunk_gap}")
                del q, q_opt
                window_s, window_launches, window_steps, all_losses = [], [], [], [losses0]
                for _ in range(windows):
                    ph.wait()
                    solves.clear()
                    zero_counts()
                    t0 = time.monotonic()
                    for _ in range(chunks_per_window):
                        p, opt, losses = multi_step(p, opt, next(chunks), gen)
                        all_losses.append(losses)
                    float(losses[-1])  # the host read that ends a window, as bench.py's
                    ph.wait()
                    window_s.append(time.monotonic() - t0)
                    window_launches.append(read_counts())
                    window_steps.append([(int(st["stats"].steps), bool(st["stats"].converged))
                                         for st in solves])
            finally:
                undo()
            steps_per_window = chunks_per_window * MULTI_K
            for launches, steps in zip(window_launches, window_steps):
                require(len(steps) == 2 * steps_per_window,
                        f"{name}: {len(steps)} CG solves in a window of {steps_per_window} steps")
                want = {"pallas_cg_solve": 0, "pallas_matvec": 0, "gram_matvec": 0,
                        "kuu_matvec": 0}
                if impl == "pallas_resident":
                    want["pallas_cg_solve"] = 2 * steps_per_window
                elif impl == "pallas":
                    want["pallas_matvec"] = sum(k + 1 for k, _ in steps)
                require(launches == want, f"{name}: launches {launches}, want {want}")
            losses = torch.cat(all_losses).cpu()
            require(bool(torch.isfinite(losses).all()), f"{name}: non-finite loss")
            leaves = [v for sub in p.values() for v in (sub.values() if isinstance(sub, dict)
                                                        else [sub])]
            require(all(bool(torch.isfinite(v).all()) for v in leaves),
                    f"{name}: non-finite parameters after training")
            best = min(window_s)
            fwd = [k for steps in window_steps for k, _ in steps[0::2]]
            bwd = [k for steps in window_steps for k, _ in steps[1::2]]
            record = {"phase": name, "matvec_impl": impl, "config": config,
                      "precond_fn": "model.precond_state" if frozen else None, "k": MULTI_K,
                      "windows": windows, "chunks_per_window": chunks_per_window,
                      "steps_per_window": steps_per_window, "window_s": window_s,
                      "steps_per_s": steps_per_window / best,
                      "steps_per_s_windows": [steps_per_window / w for w in window_s],
                      "ms_per_step": best * 1e3 / steps_per_window,
                      "launches_per_window": window_launches,
                      "launches_per_step": {k: v / steps_per_window
                                            for k, v in window_launches[0].items()},
                      "cg_steps_forward_mean": float(np.mean(fwd)),
                      "cg_steps_backward_mean": float(np.mean(bwd)),
                      "cg_steps_max": max(fwd + bwd),
                      "converged": all(c for steps in window_steps for _, c in steps),
                      "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
                      "first_chunk_vs_single_steps": chunk_gap,
                      "tolerance": f"first chunk vs {MULTI_K} make_adam_step calls: "
                                   f"relative {MULTI_CHUNK_RTOL}",
                      "nvidia_smi": card_line, "wall_s": ph.elapsed()}
            multi[name] = record
            emit(record)

    multi_phase("train_multi_chol", "pallas", "chol", False, MULTI_WINDOWS, MULTI_CHUNKS, 200)
    multi_phase("train_multi_chol_frozen", "pallas", "chol", True, MULTI_WINDOWS,
                MULTI_CHUNKS, 200)
    multi_phase("train_multi_resident", "pallas_resident", "plain", False, MULTI_WINDOWS,
                MULTI_CHUNKS, 240)

    # -- train_loop: train_using_adam_and_update end to end, production route
    with Phase("train_loop", 300) as ph:
        model = train_model("pallas", "chol")
        logdir = Path(tempfile.mkdtemp(prefix="cggp_train_loop_"))
        spent = {"update_s": 0.0, "update_calls": 0, "callbacks_s": 0.0, "callback_calls": 0,
                 "training_steps": 0}
        # The launches and CG solves made inside update_fn and the callbacks,
        # so that what is left of the run's counts is the training steps'.
        outside = {part: {"launches": dict.fromkeys(read_counts(), 0), "solves": []}
                   for part in ("update_fn", "callbacks")}

        def attributed(part, fn, *args):
            before, first = read_counts(), len(solves)
            out = fn(*args)
            for name, count in read_counts().items():
                outside[part]["launches"][name] += count - before[name]
            outside[part]["solves"].extend(solves[first:])
            return out

        def timed(fn):
            def wrapped(step, p):
                t0 = time.monotonic()
                out = attributed("callbacks", fn, step, p)  # each reads its values on the host
                spent["callbacks_s"] += time.monotonic() - t0
                spent["callback_calls"] += 1
                return out
            return wrapped

        def update_fn(p):
            t0 = time.monotonic()

            def update(p):
                iv_new, u_new, counts_new = covertree_update_inducing_parameters(
                    (xt, yt), SELECT_RES, backend="native")
                return model.assign_clusters(p, iv_new, u_new, counts_new)
            out = attributed("update_fn", update, p)
            spent["update_s"] += time.monotonic() - t0
            spent["update_calls"] += 1
            return out

        def step_loss(p, batch, key):
            spent["training_steps"] += 1  # once per step: the trainer's loss call
            return model.training_loss(p, batch, key)

        test_data = (torch.as_tensor(x_test, dtype=torch.float32, device=device),
                     torch.as_tensor(y_test, dtype=torch.float32, device=device))
        metrics_fn = make_metrics_callback(model, (xt, yt), test_data, batch_size=METRICS_BATCH)
        metrics0 = metrics_fn(0, params)  # the parameters before the first step
        monitor = create_monitor(str(logdir), timed(metrics_fn), timed(make_param_callback(model)),
                                 record_step=LOOP_RECORD_STEP, use_tensorboard=False)
        monitor.add_callback("cg", timed(make_cg_stats_callback(model, (xt, yt),
                                                                batch_size=TRAIN_BATCH)),
                             record_step=LOOP_RECORD_STEP)
        solves, undo = record_dense_solves(cg_module, operands=False)
        try:
            ph.wait()
            zero_counts()
            t0 = time.monotonic()
            trained_loop = train_using_adam_and_update(
                params, step_loss, (xt, yt), LOOP_ITERATIONS, TRAIN_BATCH, TRAIN_LR,
                torch.Generator(device=device).manual_seed(LOOP_SEED), update_fn=update_fn,
                trainable_mask=model.trainable_mask(params), monitor=monitor,
                scalar_record_step=LOOP_RECORD_STEP, steps_per_call=MULTI_K)
            ph.wait()
            loop_s = time.monotonic() - t0
            loop_launches = {"all": read_counts()}
        finally:
            undo()
        loop_solves = {"all": solves}
        for part, got in outside.items():
            loop_launches[part] = got["launches"]
            loop_solves[part] = got["solves"]
        loop_launches["steps"] = {name: count - sum(loop_launches[part][name] for part in outside)
                                  for name, count in loop_launches["all"].items()}
        outside_ids = {id(st) for part in outside for st in loop_solves[part]}
        loop_solves["steps"] = [st for st in solves if id(st) not in outside_ids]
        loop_solves = {part: [(int(st["stats"].steps), bool(st["stats"].converged)) for st in sv]
                       for part, sv in loop_solves.items()}
        loop_steps = spent["training_steps"]
        logs = {name: list(np.load(str(logdir / f"{name}.logs.npy"), allow_pickle=True))
                for name in ("metrics", "params", "cg", "train")}
        shutil.rmtree(logdir, ignore_errors=True)
        label_steps = list(range(0, LOOP_ITERATIONS, LOOP_RECORD_STEP))
        for name in ("metrics", "params", "cg"):
            require([int(e["step"]) for e in logs[name]] == label_steps,
                    f"train_loop: {name} logged at {[e['step'] for e in logs[name]]}")
        for name, keys in (("metrics", ("test/rmse", "test/nlpd", "train/elbo")),
                           ("params", ("kernel/variance", "likelihood/variance"))):
            for key in keys:
                values = [float(e[key]) for e in logs[name]]
                require(all(math.isfinite(v) for v in values), f"train_loop: {key} {values}")
                require(all(a != b for a, b in zip(values, values[1:])),
                        f"train_loop: {key} frozen across steps {values}")
        rmse = [float(e["test/rmse"]) for e in logs["metrics"]]
        require(rmse[-1] < metrics0["test/rmse"],
                f"train_loop: test RMSE {rmse[-1]} at the end, {metrics0['test/rmse']} before")
        unconverged = [int(e["cg/unconverged"]) for e in logs["cg"]]
        require(not any(unconverged), f"train_loop: cg/unconverged {unconverged}")
        require(spent["update_calls"] == LOOP_ITERATIONS // MULTI_K,
                f"train_loop: update_fn ran {spent['update_calls']} times")
        require(loop_steps == LOOP_ITERATIONS,
                f"train_loop: {loop_steps} training steps, want {LOOP_ITERATIONS}")
        require(len(loop_solves["steps"]) == 2 * loop_steps,
                f"train_loop: {len(loop_solves['steps'])} CG solves in {loop_steps} steps")
        require(trained_loop["inducing_points"].shape == (M_EXPECTED, 3),
                "train_loop: the re-clustered M changed")
        for part in ("all", "steps", *outside):
            want = {"pallas_cg_solve": 0,
                    "pallas_matvec": sum(k + 1 for k, _ in loop_solves[part]),
                    "gram_matvec": 0, "kuu_matvec": 0}
            require(loop_launches[part] == want,
                    f"train_loop: launches in {part} {loop_launches[part]}, want {want}")
        steps_only_s = loop_s - spent["update_s"] - spent["callbacks_s"]
        emit({"phase": "train_loop", "matvec_impl": "pallas", "config": "chol",
              "iterations": LOOP_ITERATIONS, "steps_per_call": MULTI_K,
              "record_step": LOOP_RECORD_STEP, "wall_s_run": loop_s, **spent,
              "steps_s": steps_only_s, "steps_per_s_excluding_callbacks_and_update":
                  loop_steps / steps_only_s,
              "launches": loop_launches,
              "cg_solves": {part: len(sv) for part, sv in loop_solves.items()},
              "metrics_before": metrics0,
              "metrics": [{k: (int(v) if k == "step" else float(v)) for k, v in e.items()}
                          for e in logs["metrics"]],
              "cg": [{k: (int(v) if k == "step" else float(v)) for k, v in e.items()}
                     for e in logs["cg"]],
              "train_loss": [float(e["loss"]) for e in logs["train"] if "loss" in e],
              "nvidia_smi": card_line, "wall_s": ph.elapsed()})
    for kernel_name in ("pallas_matvec", "pallas_cg_solve", "gram_matvec"):
        names = ("gram_matvec", "kuu_matvec") if kernel_name == "gram_matvec" else (kernel_name,)
        kernels.setdefault(kernel_name, {}).update({
            "multi_launches": {phase: sum(sum(w[n] for n in names)
                                          for w in r["launches_per_window"])
                               for phase, r in multi.items()},
            "multi_steps": {phase: r["windows"] * r["steps_per_window"]
                            for phase, r in multi.items()},
            "loop_launches": {part: sum(loop_launches[part][n] for n in names)
                              for part in ("steps", "callbacks", "update_fn")},
            "loop_steps": loop_steps})


def implicit_training_phases(ctx) -> None:
    """The matrix-free training phases (``setup_train_implicit``,
    ``reference_train_implicit``, ``train_implicit_pallas``,
    ``train_implicit_xla``, ``train_multi_implicit``,
    ``train_loop_implicit``, ``check_train_implicit_jax``) on the
    matrix-free workload: ``ctx`` carries the card, the model factory
    ``make_implicit(use_pallas, threshold, max_cg)``, the fp32 parameters at
    M = 9576 padded to 10240, the data splits (numpy), the B3 record of the
    ``kernels`` line (which gains the ``implicit_*`` counts) and B3's
    R = 2059 case.  Every solve, forward or backward, is read through a
    wrapper of ``ops.cg_implicit._implicit_cg_impl``."""
    import cggp_tpu_torch.ops.cg_implicit as cg_implicit_module
    from cggp_tpu_torch.ops.cg import SpectralPreconditioner
    from cggp_tpu_torch.ops.cg_implicit import blocked_kuu_matvec, matvec_vjp
    from cggp_tpu_torch.ops.logdet import rademacher
    from cggp_tpu_torch.ops.pallas_gram import gram_matvec, kuu_matvec
    from cggp_tpu_torch.selection import covertree_update_inducing_parameters
    from cggp_tpu_torch.training.optimize import (adam, create_monitor, make_adam_multi_step,
                                                  make_adam_step, make_cg_stats_callback,
                                                  make_metrics_callback, make_param_callback,
                                                  train_using_adam_and_update)

    device, card_line, make_implicit = ctx["device"], ctx["card_line"], ctx["make_implicit"]
    iparams, b3 = ctx["params"], ctx["gram_record"]
    x_train, y_train, x_test, y_test = ctx["data"]
    m_pad = iparams["inducing_points"].shape[0]
    n_train = x_train.shape[0]
    gram_mb = 4.0 * m_pad * m_pad / 1e6  # one [M, M] fp32 buffer

    def read_counts():
        return {"kuu_matvec": kuu_matvec.launches, "gram_matvec": gram_matvec.launches}

    def zero_counts():
        kuu_matvec.launches = gram_matvec.launches = 0

    solves = []
    impl = cg_implicit_module._implicit_cg_impl

    def recording(matvec, precond_state, rhs, *limits):
        solution, stats = impl(matvec, precond_state, rhs, *limits)
        solves.append({"rows": int(rhs.shape[0]), "stats": stats})
        return solution, stats

    def steps_of(records):
        return [(int(r["stats"].steps), bool(r["stats"].converged)) for r in records]

    def want_launches(use_pallas, records):
        return {"kuu_matvec": sum(k + 1 for k, _ in steps_of(records)) if use_pallas else 0,
                "gram_matvec": 0}

    def finite_params(p):
        return all(bool(torch.isfinite(v).all()) for sub in p.values()
                   for v in (sub.values() if isinstance(sub, dict) else [sub]))

    def step_breakdown(ph, model, record, launches):
        """Where a B3 training step's time goes, from the device times of
        its parts at the path's shapes (CUDA events, 3-5 calls each) times
        how often a step runs them: B3 (its launches), the preconditioner
        apply (once per CG step and solve start), the pivoted-Cholesky build,
        the blocked matvec's VJP at the solution, the KL's two blocked
        matvecs (R = 1 and 5: panel builds, each again in the backward
        pass); the rest (row updates, dots, the stop rule's host read per
        CG step, the ELBO's small kernels, autograd) is the remainder."""
        kernel, kp, z = model.kernel, iparams["kernel"], iparams["inducing_points"]
        lam = model.diag_variance(iparams)[:, 0]
        mask = iparams["inducing_mask"][:, 0]
        gen = torch.Generator(device=device).manual_seed(6)
        rows = torch.randn(IMPLICIT_TRAIN_ROWS, m_pad, generator=gen, device=device) * mask
        state = model.precond_state(iparams)
        needs = (True,) * (len(kp) + 2)
        zeros = torch.zeros_like(lam)
        ms = {"b3": b3["implicit_train_ms"],
              "precond_apply": event_ms(ph, lambda: SpectralPreconditioner.apply(state, rows),
                                        reps=5),
              "pivchol_build": event_ms(ph, lambda: model.precond_state(iparams), reps=3),
              "vjp_at_solution": event_ms(ph, lambda: matvec_vjp(
                  model._matvec, kp, z, lam, mask, rows, rows, needs), reps=3),
              "blocked_matvec_r1": event_ms(ph, lambda: blocked_kuu_matvec(
                  kernel, kp, z, zeros, rows[:1], IMPLICIT_BLOCK, mask), reps=3),
              "blocked_matvec_r2059": event_ms(ph, lambda: blocked_kuu_matvec(
                  kernel, kp, z, lam, rows, IMPLICIT_BLOCK, mask), reps=3)}
        steps = IMPLICIT_TRAIN_STEPS
        cg_steps = sum(record["cg_steps_forward"]) + sum(record["cg_steps_backward"])
        per_step = {"b3": launches["kuu_matvec"] / steps * ms["b3"],
                    "precond_apply": (cg_steps / steps + 2) * ms["precond_apply"],
                    "pivchol_build": ms["pivchol_build"],
                    "vjp_at_solution": ms["vjp_at_solution"],
                    "kl_matvecs": 4 * ms["blocked_matvec_r1"]}
        per_step["rest"] = record["ms_per_step"] - sum(per_step.values())
        return {"device_ms": ms, "ms_per_step": per_step,
                "share_of_step": {k: v / record["ms_per_step"] for k, v in per_step.items()},
                "note": "KL matvecs counted as 4 R <= 5 blocked matvecs a step (2 forward, "
                        "2 rebuilt in the backward pass)"}

    cg_implicit_module._implicit_cg_impl = recording
    try:
        with Phase("setup_train_implicit", 60) as ph:
            xt = torch.as_tensor(x_train, dtype=torch.float32, device=device)
            yt = torch.as_tensor(y_train, dtype=torch.float32, device=device)
            cpu_gen = torch.Generator().manual_seed(IMPLICIT_TRAIN_BATCH_SEED)
            batch_index = torch.stack(
                [torch.randperm(n_train, generator=cpu_gen)[:TRAIN_BATCH]
                 for _ in range(1 + IMPLICIT_TRAIN_WARMUP + IMPLICIT_TRAIN_STEPS
                                + 2 * IMPLICIT_MULTI_K)])
            index_dev = batch_index.to(device)
            batches = [(xt[i], yt[i]) for i in index_dev[:1 + IMPLICIT_TRAIN_WARMUP
                                                       + IMPLICIT_TRAIN_STEPS]]
            chunks = index_dev[1 + IMPLICIT_TRAIN_WARMUP + IMPLICIT_TRAIN_STEPS:].reshape(
                2, IMPLICIT_MULTI_K, TRAIN_BATCH)
            batch0_64 = tuple(t.double() for t in batches[0])
            params64 = {k: ({kk: vv.double() for kk, vv in v.items()} if isinstance(v, dict)
                            else v.double()) for k, v in iparams.items()}

            def probe_gen():
                return torch.Generator(device=device).manual_seed(IMPLICIT_TRAIN_PROBE_SEED)

            # The first step's probes as the ELBO draws them (trace probes,
            # then logdet probes), kept with the batch for the JAX reference.
            gen = probe_gen()
            step0_probes = np.stack([rademacher(gen, (TRAIN_PROBES, m_pad),
                                                torch.float32).cpu().numpy() for _ in range(2)])
            probes_sha256 = hashlib.sha256(step0_probes.tobytes()).hexdigest()
            batch_sha256 = hashlib.sha256(batch_index[0].numpy().tobytes()).hexdigest()
            out_dir = ROOT / "chiprun_out"
            out_dir.mkdir(exist_ok=True)
            np.savez(out_dir / "implicit_train_step0.npz", probes=step0_probes,
                     batch_index=batch_index[0].numpy())
            emit({"phase": "setup_train_implicit", "m_pad": int(m_pad), "rows": IMPLICIT_TRAIN_ROWS,
                  "batch": TRAIN_BATCH, "steps": IMPLICIT_TRAIN_STEPS,
                  "warmup": IMPLICIT_TRAIN_WARMUP, "lr": TRAIN_LR, "probes_sha256": probes_sha256,
                  "batch_index_sha256": batch_sha256, "wall_s": ph.elapsed()})

        # The first step in float64 on the plain route at a tight threshold,
        # and in float32 on the plain route: the yardstick of B3's gap.
        with Phase("reference_train_implicit", 300) as ph:
            solves.clear()
            loss64, grads64 = loss_and_grads(
                make_implicit(False, IMPLICIT_REF_THRESHOLD, IMPLICIT_REF_MAX_CG), params64,
                batch0_64, probe_gen())
            ph.wait()
            steps64 = steps_of(solves)
            require(len(steps64) == 2 and all(c and k < IMPLICIT_REF_MAX_CG for k, c in steps64),
                    f"reference_train_implicit: fp64 solves {steps64}")
            solves.clear()
            loss32, grads32 = loss_and_grads(make_implicit(False), iparams, batches[0],
                                             probe_gen())
            ph.wait()
            steps32 = steps_of(solves)
            xla_gap = relative_gaps(loss32, grads32, loss64, grads64)
            emit({"phase": "reference_train_implicit", "fp64_threshold": IMPLICIT_REF_THRESHOLD,
                  "fp64": {"loss": float(loss64), "cg_steps": [k for k, _ in steps64],
                           **{f"|d {n}|": float(torch.linalg.vector_norm(grads64[n]))
                              for n in TRAINABLE}},
                  "fp32_plain": {"loss": float(loss32), "cg_steps": [k for k, _ in steps32]},
                  "xla_fp32_gap": xla_gap, "wall_s": ph.elapsed()})

        trained = {}
        for route, use_pallas in (("pallas", True), ("xla", False)):
            name = f"train_implicit_{route}"
            with Phase(name, 240) as ph:
                model = make_implicit(use_pallas)
                solves.clear()
                zero_counts()
                loss0, grads0 = loss_and_grads(model, iparams, batches[0], probe_gen())
                ph.wait()
                step0 = steps_of(solves)
                require(read_counts() == want_launches(use_pallas, solves),
                        f"{name}: first-step launches {read_counts()}, solves {step0}")
                step = make_adam_step(model.training_loss, adam(TRAIN_LR),
                                      model.trainable_mask(iparams))
                p, opt = iparams, adam(TRAIN_LR).init(iparams)
                gen = probe_gen()
                torch.cuda.reset_peak_memory_stats()
                before_mb = torch.cuda.memory_allocated() / 1e6
                for batch in batches[1:1 + IMPLICIT_TRAIN_WARMUP]:
                    p, opt, _ = step(p, opt, batch, gen)
                ph.wait()
                peak_mb = torch.cuda.max_memory_allocated() / 1e6
                solves.clear()
                zero_counts()
                t0 = time.monotonic()
                losses = []
                for batch in batches[1 + IMPLICIT_TRAIN_WARMUP:]:
                    p, opt, loss = step(p, opt, batch, gen)
                    losses.append(loss)
                ph.wait()
                window_s = time.monotonic() - t0
                launches = read_counts()
                window = steps_of(solves)
                require(len(window) == 2 * IMPLICIT_TRAIN_STEPS
                        and all(r["rows"] == IMPLICIT_TRAIN_ROWS for r in solves),
                        f"{name}: {len(window)} solves of rows {[r['rows'] for r in solves]}")
                require(launches == want_launches(use_pallas, solves),
                        f"{name}: launches {launches}, want {want_launches(use_pallas, solves)}")
                require(all(c for _, c in step0 + window), f"{name}: a solve did not converge")
                losses = [float(v) for v in losses]
                require(all(math.isfinite(v) for v in losses) and finite_params(p),
                        f"{name}: non-finite loss or parameters {losses}")
                gaps = relative_gaps(loss0, grads0, loss64, grads64)
                gap_over_xla = {k: (gaps[k] / xla_gap[k] if xla_gap[k] > 0
                                    else 0.0 if gaps[k] == 0 else math.inf) for k in gaps}
                if use_pallas:
                    require(all(math.isfinite(v) and v <= 2.0 for v in gap_over_xla.values()),
                            f"{name}: first step {gaps} from fp64, plain fp32 {xla_gap}")
                cg_total = sum(k for k, _ in window)
                record = {"phase": name, "use_pallas": use_pallas, "m_pad": int(m_pad),
                          "rows": IMPLICIT_TRAIN_ROWS, "steps": IMPLICIT_TRAIN_STEPS,
                          "window_s": window_s,
                          "steps_per_s": IMPLICIT_TRAIN_STEPS / window_s,
                          "ms_per_step": window_s * 1e3 / IMPLICIT_TRAIN_STEPS,
                          "launches": launches,
                          "cg_steps_forward": [k for k, _ in window[0::2]],
                          "cg_steps_backward": [k for k, _ in window[1::2]],
                          "ms_per_cg_step": window_s * 1e3 / cg_total,
                          "peak_mb_over_a_step": peak_mb, "allocated_mb_before_the_step": before_mb,
                          "one_m_by_m_fp32_buffer_mb": gram_mb,
                          "loss_first": losses[0], "loss_last": losses[-1],
                          "step0": {"loss": float(loss0),
                                    **{f"|d {n}|": float(torch.linalg.vector_norm(grads0[n]))
                                       for n in TRAINABLE},
                                    "cg_steps": [k for k, _ in step0],
                                    "gap_vs_fp64": gaps, "xla_fp32_gap_vs_fp64": xla_gap,
                                    "gap_over_xla_fp32_gap": gap_over_xla},
                          "tolerance": "first-step loss and each gradient: the relative gap "
                                       "from fp64 at most 2x the fp32 plain route's",
                          "nvidia_smi": card_line, "wall_s": ph.elapsed()}
                if use_pallas:
                    record["breakdown"] = step_breakdown(ph, model, record, launches)
                trained[route] = {"record": record, "step0": step0, "launches": launches,
                                  "steps": len(window) // 2}
                emit(record)
        # The kernel route solves the same systems: its first step's forward
        # and backward steps within max(3, 5 %) of the plain route's.
        for (a, _), (b, _) in zip(trained["pallas"]["step0"], trained["xla"]["step0"]):
            require(abs(a - b) <= max(3, 0.05 * b),
                    f"train_implicit: first-step steps {trained['pallas']['step0']} on B3, "
                    f"{trained['xla']['step0']} on the plain route")

        with Phase("train_multi_implicit", 240) as ph:
            model = make_implicit(True)
            mask = model.trainable_mask(iparams)
            multi_step = make_adam_multi_step(model.training_loss, adam(TRAIN_LR), (xt, yt), mask)

            def frozen_loss(p, batch, key, state):
                return model.training_loss(p, batch, key, precond_override=state)

            frozen_step = make_adam_multi_step(frozen_loss, adam(TRAIN_LR), (xt, yt), mask,
                                               precond_fn=model.precond_state)
            solves.clear()
            zero_counts()
            t0 = time.monotonic()
            p, opt, losses0 = multi_step(iparams, adam(TRAIN_LR).init(iparams), chunks[0],
                                         probe_gen())
            float(losses0[-1])
            ph.wait()
            chunk0_s = time.monotonic() - t0
            chunk0_launches, chunk0_steps = read_counts(), steps_of(solves)
            require(chunk0_launches == want_launches(True, solves),
                    f"train_multi_implicit: chunk launches {chunk0_launches}, "
                    f"solves {chunk0_steps}")
            single = make_adam_step(model.training_loss, adam(TRAIN_LR), mask)
            q, q_opt, q_gen, single_losses = iparams, adam(TRAIN_LR).init(iparams), probe_gen(), []
            for row in chunks[0]:
                q, q_opt, loss = single(q, q_opt, (xt[row], yt[row]), q_gen)
                single_losses.append(loss)
            ph.wait()
            single_losses = torch.stack(single_losses)
            chunk_gap = {"loss_rel": float(((losses0 - single_losses).abs()
                                            / single_losses.abs()).max()),
                         "bitwise_equal": bool(torch.equal(losses0, single_losses))}
            for leaf in TRAINABLE:
                section, key = leaf.split("/")
                a, b = p[section][key], q[section][key]
                chunk_gap[leaf] = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                chunk_gap["bitwise_equal"] &= bool(torch.equal(a, b))
            require(all(v <= MULTI_CHUNK_RTOL for k, v in chunk_gap.items()
                        if k != "bitwise_equal"),
                    f"train_multi_implicit: chunk vs {IMPLICIT_MULTI_K} single steps {chunk_gap}")
            del q, q_opt
            # One more chunk with the factor built once, from its entry
            # parameters, and frozen for its steps.
            solves.clear()
            zero_counts()
            t0 = time.monotonic()
            p, opt, losses1 = frozen_step(p, opt, chunks[1], probe_gen())
            float(losses1[-1])
            ph.wait()
            frozen_s = time.monotonic() - t0
            frozen_launches, frozen_steps = read_counts(), steps_of(solves)
            require(frozen_launches == want_launches(True, solves),
                    f"train_multi_implicit: frozen launches {frozen_launches}, {frozen_steps}")
            require(len(chunk0_steps) == len(frozen_steps) == 2 * IMPLICIT_MULTI_K
                    and all(c for _, c in chunk0_steps + frozen_steps),
                    f"train_multi_implicit: solves {chunk0_steps} / {frozen_steps}")
            losses = torch.cat([losses0, losses1]).cpu()
            require(bool(torch.isfinite(losses).all()) and finite_params(p),
                    "train_multi_implicit: non-finite loss or parameters")
            multi_record = {
                "phase": "train_multi_implicit", "use_pallas": True, "k": IMPLICIT_MULTI_K,
                "chunk_s": chunk0_s, "steps_per_s": IMPLICIT_MULTI_K / chunk0_s,
                "frozen_chunk_s": frozen_s, "frozen_steps_per_s": IMPLICIT_MULTI_K / frozen_s,
                "launches": chunk0_launches, "frozen_launches": frozen_launches,
                "cg_steps_forward": [k for k, _ in chunk0_steps[0::2]],
                "cg_steps_backward": [k for k, _ in chunk0_steps[1::2]],
                "frozen_cg_steps_forward": [k for k, _ in frozen_steps[0::2]],
                "frozen_cg_steps_backward": [k for k, _ in frozen_steps[1::2]],
                "losses": [float(v) for v in losses],
                "chunk_vs_single_steps": chunk_gap,
                "tolerance": f"chunk vs {IMPLICIT_MULTI_K} make_adam_step calls: relative "
                             f"{MULTI_CHUNK_RTOL}",
                "nvidia_smi": card_line, "wall_s": ph.elapsed()}
            emit(multi_record)

        with Phase("train_loop_implicit", 300) as ph:
            model = make_implicit(True)
            logdir = Path(tempfile.mkdtemp(prefix="cggp_train_loop_implicit_"))
            spent = {"update_s": 0.0, "update_calls": 0, "callbacks_s": 0.0,
                     "callback_calls": 0, "training_steps": 0, "m_after_update": []}
            outside = {part: {"launches": dict.fromkeys(read_counts(), 0), "solves": []}
                       for part in ("update_fn", "callbacks")}

            def attributed(part, fn, *args):
                before, first = read_counts(), len(solves)
                out = fn(*args)
                for key, count in read_counts().items():
                    outside[part]["launches"][key] += count - before[key]
                outside[part]["solves"].extend(solves[first:])
                return out

            def timed(fn):
                def wrapped(step, p):
                    t0 = time.monotonic()
                    out = attributed("callbacks", fn, step, p)
                    spent["callbacks_s"] += time.monotonic() - t0
                    spent["callback_calls"] += 1
                    return out
                return wrapped

            def update_fn(p):
                t0 = time.monotonic()

                def update(p):
                    iv_new, u_new, counts_new = covertree_update_inducing_parameters(
                        (xt, yt), IMPLICIT_SELECT_RES, backend="native")
                    spent["m_after_update"].append(int(iv_new.shape[0]))
                    return model.assign_clusters(p, iv_new, u_new, counts_new)
                out = attributed("update_fn", update, p)
                spent["update_s"] += time.monotonic() - t0
                spent["update_calls"] += 1
                return out

            def step_loss(p, batch, key):
                spent["training_steps"] += 1
                return model.training_loss(p, batch, key)

            test_data = tuple(torch.as_tensor(a[:IMPLICIT_METRICS_POINTS], dtype=torch.float32,
                                              device=device) for a in (x_test, y_test))
            monitor = create_monitor(
                str(logdir), timed(make_metrics_callback(model, (xt, yt), test_data,
                                                         batch_size=METRICS_BATCH)),
                timed(make_param_callback(model)), record_step=IMPLICIT_LOOP_RECORD_STEP,
                use_tensorboard=False)
            monitor.add_callback("cg", timed(make_cg_stats_callback(model, (xt, yt),
                                                                    batch_size=TRAIN_BATCH)),
                                 record_step=IMPLICIT_LOOP_RECORD_STEP)
            solves.clear()
            ph.wait()
            zero_counts()
            t0 = time.monotonic()
            trained_loop = train_using_adam_and_update(
                iparams, step_loss, (xt, yt), IMPLICIT_LOOP_ITERATIONS, TRAIN_BATCH, TRAIN_LR,
                torch.Generator(device=device).manual_seed(LOOP_SEED), update_fn=update_fn,
                trainable_mask=model.trainable_mask(iparams), monitor=monitor,
                scalar_record_step=IMPLICIT_LOOP_RECORD_STEP, steps_per_call=IMPLICIT_MULTI_K)
            ph.wait()
            loop_s = time.monotonic() - t0
            loop_launches = {"all": read_counts()}
            loop_solves = {"all": list(solves)}
            for part, got in outside.items():
                loop_launches[part] = got["launches"]
                loop_solves[part] = got["solves"]
            loop_launches["steps"] = {k: v - sum(loop_launches[part][k] for part in outside)
                                      for k, v in loop_launches["all"].items()}
            outside_ids = {id(r) for part in outside for r in loop_solves[part]}
            loop_solves["steps"] = [r for r in solves if id(r) not in outside_ids]
            logs = {name: list(np.load(str(logdir / f"{name}.logs.npy"), allow_pickle=True))
                    for name in ("metrics", "params", "cg", "train")}
            shutil.rmtree(logdir, ignore_errors=True)
            label_steps = list(range(0, IMPLICIT_LOOP_ITERATIONS, IMPLICIT_LOOP_RECORD_STEP))
            for name in ("metrics", "params", "cg"):
                require([int(e["step"]) for e in logs[name]] == label_steps,
                        f"train_loop_implicit: {name} logged at {[e['step'] for e in logs[name]]}")
            for name, keys in (("metrics", ("test/rmse", "test/nlpd", "train/elbo")),
                               ("params", ("kernel/variance", "likelihood/variance"))):
                for key in keys:
                    values = [float(e[key]) for e in logs[name]]
                    require(all(math.isfinite(v) for v in values), f"train_loop_implicit: {key}")
                    require(all(a != b for a, b in zip(values, values[1:])),
                            f"train_loop_implicit: {key} frozen across steps {values}")
            unconverged = [int(e["cg/unconverged"]) for e in logs["cg"]]
            require(not any(unconverged), f"train_loop_implicit: cg/unconverged {unconverged}")
            require(all(c for _, c in steps_of(loop_solves["all"])),
                    "train_loop_implicit: a solve did not converge")
            require(spent["update_calls"] == IMPLICIT_LOOP_ITERATIONS // IMPLICIT_MULTI_K,
                    f"train_loop_implicit: update_fn ran {spent['update_calls']} times")
            require(spent["training_steps"] == IMPLICIT_LOOP_ITERATIONS,
                    f"train_loop_implicit: {spent['training_steps']} steps")
            require(len(loop_solves["steps"]) == 2 * IMPLICIT_LOOP_ITERATIONS,
                    f"train_loop_implicit: {len(loop_solves['steps'])} solves in the steps")
            m_loop = trained_loop["inducing_points"].shape[0]
            require(m_loop % IMPLICIT_BLOCK == 0 and finite_params(trained_loop),
                    f"train_loop_implicit: M {m_loop} after re-clustering")
            for part in ("all", "steps", *outside):
                want = want_launches(True, loop_solves[part])
                require(loop_launches[part] == want,
                        f"train_loop_implicit: launches in {part} {loop_launches[part]}, "
                        f"want {want}")
            steps_only_s = loop_s - spent["update_s"] - spent["callbacks_s"]
            emit({"phase": "train_loop_implicit", "use_pallas": True,
                  "iterations": IMPLICIT_LOOP_ITERATIONS, "steps_per_call": IMPLICIT_MULTI_K,
                  "record_step": IMPLICIT_LOOP_RECORD_STEP, "m_pad_after": int(m_loop),
                  "wall_s_run": loop_s, **spent, "steps_s": steps_only_s,
                  "steps_per_s_excluding_callbacks_and_update":
                      IMPLICIT_LOOP_ITERATIONS / steps_only_s,
                  "launches": loop_launches,
                  "cg_solves": {part: len(sv) for part, sv in loop_solves.items()},
                  "cg_steps_steps": [k for k, _ in steps_of(loop_solves["steps"])],
                  "metrics": [{k: (int(v) if k == "step" else float(v)) for k, v in e.items()}
                              for e in logs["metrics"]],
                  "cg": [{k: (int(v) if k == "step" else float(v)) for k, v in e.items()}
                         for e in logs["cg"]],
                  "train_loss": [float(e["loss"]) for e in logs["train"] if "loss" in e],
                  "nvidia_smi": card_line, "wall_s": ph.elapsed()})
    finally:
        cg_implicit_module._implicit_cg_impl = impl

    b3.update({
        "implicit_train_launches": trained["pallas"]["launches"]["kuu_matvec"],
        "implicit_train_steps": trained["pallas"]["steps"],
        "implicit_multi_launches": chunk0_launches["kuu_matvec"]
        + frozen_launches["kuu_matvec"],
        "implicit_multi_steps": (len(chunk0_steps) + len(frozen_steps)) // 2,
        "implicit_loop_launches": {part: loop_launches[part]["kuu_matvec"]
                                   for part in ("steps", "callbacks", "update_fn")},
        "implicit_loop_steps": spent["training_steps"]})

    # The JAX package's first step (JAX_IMPLICIT_TRAIN_STEP0, on the CPU from
    # this run's probes and batch): B3's forward and backward steps within
    # max(3, 5 %) of JAX's, and JAX's fp32 loss and gradient norms no further
    # from this run's fp64 values than twice the port's fp32 plain route.
    with Phase("check_train_implicit_jax", 30):
        ref = JAX_IMPLICIT_TRAIN_STEP0
        require(ref is not None, "no JAX reference for the first matrix-free training step")
        require(probes_sha256 == ref["probes_sha256"]
                and batch_sha256 == ref["batch_index_sha256"],
                "the first step's probes or batch are not those JAX's values were taken with")
        step0 = trained["pallas"]["step0"]
        for (got, _), want, label in zip(step0, ref["cg_steps"], ("forward", "backward")):
            require(abs(got - want) <= max(3, 0.05 * want),
                    f"train_implicit_pallas: first-step {label} steps {got} vs JAX {want}")
        jax_gap = abs(ref["loss"] - float(loss64)) / abs(float(loss64))
        require(jax_gap <= 2.0 * xla_gap["loss"],
                f"JAX's fp32 loss {ref['loss']} is {jax_gap} from fp64, the port's fp32 plain "
                f"route {xla_gap['loss']}")
        # A norm's gap is at most its vector's, so the plain route's vector
        # gaps bound the norms' from above.
        norms64 = {n: float(torch.linalg.vector_norm(grads64[n])) for n in TRAINABLE}
        jax_grad_gap = {n: abs(ref["grad_norms"][n] - norms64[n]) / norms64[n] for n in TRAINABLE}
        require(all(jax_grad_gap[n] <= 2.0 * xla_gap[n] for n in TRAINABLE),
                f"JAX's fp32 gradient norms are {jax_grad_gap} from fp64, the port's fp32 "
                f"plain route's gradients {xla_gap}")
        port = trained["pallas"]["record"]["step0"]
        emit({"phase": "check_train_implicit_jax", "jax_cpu_fp32": ref,
              "port_b3": {"loss": port["loss"], "cg_steps": port["cg_steps"],
                          **{f"|d {n}|": port[f"|d {n}|"] for n in TRAINABLE}},
              "jax_loss_gap_vs_fp64": jax_gap, "xla_fp32_loss_gap_vs_fp64": xla_gap["loss"],
              "jax_grad_norm_gap_vs_fp64": jax_grad_gap, "xla_fp32_grad_gap_vs_fp64":
                  {n: xla_gap[n] for n in TRAINABLE},
              "port_b3_vs_jax_loss_rel": abs(port["loss"] - ref["loss"]) / abs(ref["loss"]),
              "tolerance": "B3's first-step forward and backward steps within max(3, 5 %) of "
                           "JAX's; JAX's loss and gradient norms within 2x the fp32 plain "
                           "route's gap from fp64"})


def itergpr_phases(ctx) -> None:
    """The exact GP phases (``setup_itergpr``, ``B3_itergpr``,
    ``reference_itergpr``, ``check_itergpr_small``, ``itergpr_chunked``,
    ``train_itergpr_pallas``, ``serve_itergpr_pallas``): ``IterGPR`` trained
    and served through its entry points at N = 131,072 with every CG matvec
    of its solves on B3, held against float64 and the JAX package at N =
    16,384.  ``ctx`` carries the card, its ``nvidia-smi`` line and max SM
    clock, and the B3 record of the ``kernels`` line (which gains the
    ``itergpr_*`` counts and times).  Every solve, forward or backward, is
    read through a wrapper of ``ops.cg_implicit._implicit_cg_impl``."""
    import cggp_tpu_torch.ops.cg_implicit as cg_implicit_module
    import cggp_tpu_torch.ops.logdet as logdet_module
    from cggp_tpu_torch.data import synthetic
    from cggp_tpu_torch.models import GPR, IterGPR
    from cggp_tpu_torch.ops.cg_implicit import blocked_kuu_matvec
    from cggp_tpu_torch.ops.kernels import (Matern32, kernel_value_from_r2,
                                            scaled_squared_distance)
    from cggp_tpu_torch.ops.pallas_gram import gram_matvec, kuu_matvec
    from cggp_tpu_torch.training.optimize import predict_in_batches, train_full_batch_adam

    device, card_line, b3 = ctx["device"], ctx["card_line"], ctx["gram_record"]
    sm_clock_hz = ctx["sm_clock_hz"]
    n, small = ITERGPR_N, ITERGPR_SMALL_N

    def read_counts():
        return {"kuu_matvec": kuu_matvec.launches, "gram_matvec": gram_matvec.launches}

    def zero_counts():
        kuu_matvec.launches = gram_matvec.launches = 0

    solves, capture = [], {"armed": False}
    impl = cg_implicit_module._implicit_cg_impl
    vjp_impl = cg_implicit_module.matvec_vjp

    def recording(matvec, precond_state, rhs, *limits):
        solution, stats = impl(matvec, precond_state, rhs, *limits)
        solves.append({"rows": int(rhs.shape[0]), "stats": stats})
        if capture["armed"]:  # keep the next solve's operands (the fused forward solve)
            capture.update(armed=False, rhs=rhs.detach().clone(), solution=solution.detach())
        return solution, stats

    def steps_of(records):
        return [(int(r["stats"].steps), bool(r["stats"].converged)) for r in records]

    def want_launches(use_pallas, records):
        return {"kuu_matvec": sum(k + 1 for k, _ in steps_of(records)) if use_pallas else 0,
                "gram_matvec": 0}

    def make_itergpr(use_pallas, threshold=ITERGPR_THRESHOLD, max_cg=1000):
        return IterGPR(kernel=Matern32(), error_threshold=threshold, relative_threshold=True,
                       max_cg_iterations=max_cg, num_probes=ITERGPR_PROBES,
                       slq_lanczos_iters=ITERGPR_SLQ, precondition="pivchol",
                       precond_rank=ITERGPR_RANK, block=ITERGPR_BLOCK, use_pallas=use_pallas)

    def mll_step(model, params, data, probes):
        """The training loss and the gradients of the trainable parameters."""
        live = {s: {k: v.detach().clone().requires_grad_() for k, v in d.items()}
                for s, d in params.items()}
        loss = model.training_loss(live, data, probes=probes)
        grads = torch.autograd.grad(loss, [live["kernel"]["variance"],
                                           live["kernel"]["lengthscales"],
                                           live["likelihood"]["variance"]])
        return loss.detach(), dict(zip(TRAINABLE, (g.detach() for g in grads)))

    def finite_params(p):
        return all(bool(torch.isfinite(v).all()) for d in p.values() for v in d.values())

    def over(gaps, ref):
        return {k: (gaps[k] / ref[k] if ref[k] > 0 else 0.0 if gaps[k] == 0 else math.inf)
                for k in gaps}

    cg_implicit_module._implicit_cg_impl = recording
    try:
        # -- setup_itergpr: the data, the fixed probes and the init parameters
        with Phase("setup_itergpr", 20) as ph:
            (x_np, y_np), (xt_np, yt_np) = synthetic(n=ITERGPR_RAW_N, dim=3, seed=0)
            require(x_np.shape[0] >= n and xt_np.shape[0] >= ITERGPR_TEST and n % ITERGPR_BLOCK == 0,
                    f"split {x_np.shape[0]} / {xt_np.shape[0]} rows")
            x = torch.as_tensor(x_np[:n], dtype=torch.float32, device=device)
            y = torch.as_tensor(y_np[:n], dtype=torch.float32, device=device)
            xt = torch.as_tensor(xt_np[:ITERGPR_TEST], dtype=torch.float32, device=device)
            yt = torch.as_tensor(yt_np[:ITERGPR_TEST], dtype=torch.float32, device=device)
            rng = np.random.default_rng(ITERGPR_PROBE_SEED)
            probes_np = (2 * rng.integers(0, 2, size=(ITERGPR_PROBES, n)) - 1).astype(np.float32)
            probes_sha256 = hashlib.sha256(probes_np.tobytes()).hexdigest()
            probes = torch.as_tensor(probes_np, device=device)
            params = make_itergpr(True).init_params(3, dtype=torch.float32, device=device)
            emit({"phase": "setup_itergpr", "n": n, "n_small": small, "test_points": ITERGPR_TEST,
                  "block": ITERGPR_BLOCK, "probes": ITERGPR_PROBES, "probes_sha256": probes_sha256,
                  "precond_rank": ITERGPR_RANK, "slq_lanczos_iters": ITERGPR_SLQ,
                  "relative_threshold": ITERGPR_THRESHOLD, "lr": ITERGPR_LR,
                  "steps": ITERGPR_WARMUP + ITERGPR_STEPS, "wall_s": ph.elapsed()})

        kernel, kp = Matern32(), params["kernel"]
        noise = make_itergpr(True).likelihood.variance(params["likelihood"])

        # -- B3_itergpr: kuu_matvec at M = N = 131,072 for the path's row counts
        with Phase("B3_itergpr", 60) as ph:
            z = (x / kernel.lengthscales(kp)).contiguous()
            lam = (noise * torch.ones(n, device=device)).contiguous()
            var = kernel.variance(kp).reshape(1).contiguous()
            ones = torch.ones(n, device=device)
            blocked = make_itergpr(False)
            cols = ITERGPR_BLOCK  # the plain slice: the first 4096 output columns
            k32 = kernel_value_from_r2("matern32", scaled_squared_distance(z, z[:cols]),
                                       var.reshape(()))
            z64 = z.double()
            k64 = kernel_value_from_r2("matern32", scaled_squared_distance(z64, z64[:cols]),
                                       var.double().reshape(()))
            gen = torch.Generator(device=device).manual_seed(8)
            cases = {}
            for rows in (1, 9, ITERGPR_VAR_BATCH):
                p = torch.randn(rows, n, generator=gen, device=device)
                got = kuu_matvec(z, lam, p, var, "matern32")
                plain = p @ k32 + p[:, :cols] * lam[:cols]
                exact = p.double() @ k64 + p[:, :cols].double() * lam[:cols].double()
                ph.wait()
                require(bool(torch.isfinite(got).all()), f"B3_itergpr R={rows}: non-finite output")
                scale = float((p.abs() @ k32).max())
                err = float((got[:, :cols] - plain).abs().max())
                err64 = float((got[:, :cols].double() - exact).abs().max())
                plain64 = float((plain.double() - exact).abs().max())
                del plain, exact
                # Both are fp32-accurate sums of N = 131,072 kernel values
                # times p in other orders: the gap is within the random walk
                # sqrt(N) eps = 4.3e-5 of sum |p| K.  From fp64, B3 (its
                # depth summed at two levels) is held to twice the fp32 slice
                # that torch.matmul computes, at every row count.
                require(err <= 5e-5 * scale, f"B3_itergpr R={rows}: {err} vs the plain slice")
                require(err64 <= 2.0 * plain64,
                        f"B3_itergpr R={rows}: {err64} from fp64, the fp32 slice {plain64}")
                times = timed_in_turns(
                    ph, {"blocked": lambda: blocked._matvec(kp, x, lam, ones, p),
                         "kernel": lambda: kuu_matvec(z, lam, p, var, "matern32")},
                    ["blocked", "kernel", "kernel", "blocked"], reps=1)
                kernel_ms = float(np.mean(times["kernel"]))
                bound, bound_by, bound_what, parts = gram_bound(
                    n, n, 3, rows, "matern32", sm_clock_hz, 4.0 * (n * 3 + n + 1 + 2 * rows * n))
                row_tiles = -(-rows // 128)
                launch = ({"launch": "small", "blocks": -(-n // 32), "threads": 256,
                           "rows": rows, "rows_of_8_used": rows} if rows <= 8 else
                          {"launch": "tiled 3xTF32", "row_tiles": row_tiles,
                           "column_tiles": -(-n // 128), "threads": 512,
                           "rows_used_of_each_128_row_tile": min(rows, 128),
                           "rows_used_of_last_tile": rows - 128 * (row_tiles - 1)})
                values_built = (1 if rows <= 8 else row_tiles) * float(n) * n
                cases[rows] = {
                    "rows": rows, "n": n, "b_loader": b3_loader(p, rows, n, 1), **launch,
                    "max_abs_err_vs_plain_slice": err, "max_rel_err": err / scale,
                    "max_abs_err_vs_fp64_slice": err64, "plain_slice_max_abs_err_vs_fp64": plain64,
                    "err_vs_fp64_over_plain_slice": err64 / plain64 if plain64 else None,
                    "scale_max_abs_p_K": scale,
                    "tolerance": "vs the fp32 slice <= 5e-5 * max(|p| K); "
                                 "vs fp64 <= 2x the fp32 slice's",
                    "kernel_ms": kernel_ms, "blocked_ms": float(np.mean(times["blocked"])),
                    "turns_ms": times, "kernel_values_built": values_built,
                    "kernel_values_per_s": values_built / (kernel_ms / 1e3),
                    "bound_ms": bound, "bound_by": bound_by, "bound_detail": bound_what,
                    "bound_parts_ms": parts}
                del p, got
            del k32, k64, z64
            emit({"phase": "B3_itergpr", "cases": list(cases.values()),
                  "plain_note": "blocked_ms: the blocked route's matvec (32 [4096, N] kernel "
                                "panels, torch.matmul) at the same R; the plain version whole "
                                "would build a 68.7 GB [N, N] K",
                  "nvidia_smi": card_line, "wall_s": ph.elapsed()})
            for rows, case in cases.items():
                b3.update({f"itergpr_ms_r{rows}": case["kernel_ms"],
                           f"itergpr_blocked_ms_r{rows}": case["blocked_ms"],
                           f"itergpr_bound_ms_r{rows}": case["bound_ms"]})

        # -- reference_itergpr: fp64 at N = 16,384 (dense GPR; blocked at 1e-12)
        xs, ys, probes_s = x[:small], y[:small], probes[:, :small]
        xq = xt[:ITERGPR_SMALL_TEST]
        with Phase("reference_itergpr", 50) as ph:
            xs64, ys64, xq64 = xs.double(), ys.double(), xq.double()
            params64 = {s: {k: v.double() for k, v in d.items()} for s, d in params.items()}
            dense = GPR(kernel=kernel)
            post64 = dense.posterior(params64, (xs64, ys64))
            quad64 = float(torch.sum(ys64 * post64.nu))
            mean64, var64 = dense.posterior_predict(post64, xq64)
            mll64 = float(dense.log_marginal_likelihood(params64, (xs64, ys64)))
            del post64
            solves.clear()
            loss_ref, grads_ref = mll_step(make_itergpr(False, ITERGPR_REF_THRESHOLD,
                                                        ITERGPR_REF_MAX_CG),
                                           params64, (xs64, ys64), probes_s.double())
            ph.wait()
            steps64 = steps_of(solves)
            require(len(steps64) == 2 and all(c and k < ITERGPR_REF_MAX_CG for k, c in steps64),
                    f"reference_itergpr: fp64 solves {steps64}")
            solves.clear()
            loss32, grads32 = mll_step(make_itergpr(False), params, (xs, ys), probes_s)
            ph.wait()
            steps32 = steps_of(solves)
            xla_gap = relative_gaps(loss32, grads32, loss_ref, grads_ref)
            blocked = make_itergpr(False)
            post32 = blocked.posterior(params, (xs, ys))
            quad_gap_xla = abs(float(torch.sum(post32.alpha * ys.T)) - quad64) / abs(quad64)
            m32, v32 = predict_in_batches(blocked, params, xq, batch_size=1024,
                                          train_data=(xs, ys), posterior=post32)
            ph.wait()
            serve_gap_xla = {"mean": float((m32.double() - mean64).abs().max()),
                             "var": float((v32.double() - var64).abs().max())}
            emit({"phase": "reference_itergpr", "n": small, "query_points": ITERGPR_SMALL_TEST,
                  "dense_fp64": {"mll": mll64, "quad": quad64,
                                 "var_min": float(var64.min()), "var_max": float(var64.max())},
                  "blocked_fp64": {"threshold": ITERGPR_REF_THRESHOLD, "loss": float(loss_ref),
                                   "cg_steps": [k for k, _ in steps64],
                                   **{f"|d {k}|": float(torch.linalg.vector_norm(grads_ref[k]))
                                      for k in TRAINABLE}},
                  "blocked_fp32": {"loss": float(loss32), "cg_steps": [k for k, _ in steps32]},
                  "xla_fp32_gap": xla_gap, "xla_fp32_quad_gap": quad_gap_xla,
                  "xla_fp32_serve_gap": serve_gap_xla, "wall_s": ph.elapsed()})

        # -- check_itergpr_small: the B3 route at N = 16,384 against fp64 and JAX
        with Phase("check_itergpr_small", 30) as ph:
            model = make_itergpr(True)
            solves.clear()
            zero_counts()
            loss_b3, grads_b3 = mll_step(model, params, (xs, ys), probes_s)
            ph.wait()
            step0, step_launches = steps_of(solves), read_counts()
            require(len(step0) == 2 and all(c for _, c in step0), f"check_itergpr_small: {step0}")
            require(step_launches == want_launches(True, solves),
                    f"check_itergpr_small: launches {step_launches}, solves {step0}")
            gaps = relative_gaps(loss_b3, grads_b3, loss_ref, grads_ref)
            require(all(v <= 2.0 for v in over(gaps, xla_gap).values()),
                    f"check_itergpr_small: {gaps} from fp64, the fp32 blocked route {xla_gap}")
            require(probes_sha256 == JAX_ITERGPR_STEP0["probes_sha256"],
                    "the probes are not those JAX's values were taken with")
            for (got, _), (plain, _), jax_steps, label in zip(
                    step0, steps32, JAX_ITERGPR_STEP0["cg_steps"], ("forward", "backward")):
                for ref, who in ((plain, "the fp32 blocked route"), (jax_steps, "JAX")):
                    require(abs(got - ref) <= max(3, 0.05 * ref),
                            f"check_itergpr_small: {label} steps {got} vs {who} {ref}")
            solves.clear()
            zero_counts()
            post = model.posterior(params, (xs, ys))
            mb, vb = predict_in_batches(model, params, xq, batch_size=1024, train_data=(xs, ys),
                                        posterior=post)
            ph.wait()
            serve_launches = read_counts()
            require(len(solves) == 1 + ITERGPR_SMALL_TEST // 1024
                    and serve_launches == want_launches(True, solves),
                    f"check_itergpr_small: serving launches {serve_launches}, "
                    f"solves {steps_of(solves)}")
            quad_gap = abs(float(torch.sum(post.alpha * ys.T)) - quad64) / abs(quad64)
            serve_gap = {"mean": float((mb.double() - mean64).abs().max()),
                         "var": float((vb.double() - var64).abs().max())}
            require(quad_gap <= 2.0 * quad_gap_xla,
                    f"check_itergpr_small: quad {quad_gap} from fp64, blocked {quad_gap_xla}")
            require(all(v <= 2.0 for v in over(serve_gap, serve_gap_xla).values()),
                    f"check_itergpr_small: posterior {serve_gap} from fp64, blocked {serve_gap_xla}")
            # JAX against this run's references.  In float64 both packages
            # compute the same function of the same widened fp32 inputs.
            # Their fp32 initial noise parameters differ by one ulp (torch's
            # and XLA's log / expm1), and a solve stopped at relative 1e-12
            # is within kappa 1e-12 <= 1.6e-7 of its solution (kappa <= (N
            # var + noise) / noise): 1e-6 holds JAX's float64 loss and
            # gradient norms to the port's.
            ref64 = JAX_ITERGPR_STEP0["float64"]
            norms_ref = {k: float(torch.linalg.vector_norm(grads_ref[k])) for k in TRAINABLE}
            jax64_gap = {"loss": abs(ref64["loss"] - float(loss_ref)) / abs(float(loss_ref)),
                         **{k: abs(ref64["grad_norms"][k] - norms_ref[k]) / norms_ref[k]
                            for k in TRAINABLE}}
            require(all(v <= 1e-6 for v in jax64_gap.values()),
                    f"check_itergpr_small: JAX's float64 step {jax64_gap} from the port's")
            for (got, _), want, label in zip(steps64, ref64["cg_steps"], ("forward", "backward")):
                require(abs(got - want) <= max(3, 0.05 * want),
                        f"check_itergpr_small: float64 {label} steps {got} vs JAX {want}")
            # JAX's fp32 gradient norms no further from fp64 than twice the
            # fp32 blocked route's gradients (a norm's gap is at most its
            # vector's).  JAX's fp32 loss is not held to the card's: the
            # loss, -0.5 (quad + logdet + N log 2 pi), cancels terms of
            # ~3e4 to ~3e2, so its fp32 gap is the platform's rounding of
            # those terms -- 6.2e-5 through cuBLAS on the card, 2.3e-4 for
            # the port's blocked route on the CPU, 6.3e-4 for JAX's on the
            # CPU (PERF.md, PR 11); the float64 gate above holds the value.
            jax_loss_gap = abs(JAX_ITERGPR_STEP0["loss"] - float(loss_ref)) / abs(float(loss_ref))
            jax_grad_gap = {k: abs(JAX_ITERGPR_STEP0["grad_norms"][k] - norms_ref[k]) / norms_ref[k]
                            for k in TRAINABLE}
            require(all(jax_grad_gap[k] <= 2.0 * xla_gap[k] for k in TRAINABLE),
                    f"check_itergpr_small: JAX's fp32 gradient norms {jax_grad_gap} from fp64, "
                    f"the fp32 blocked route's gradients {xla_gap}")
            emit({"phase": "check_itergpr_small", "n": small, "launches": step_launches,
                  "cg_steps": [k for k, _ in step0], "cg_steps_blocked_fp32":
                      [k for k, _ in steps32], "cg_steps_jax": JAX_ITERGPR_STEP0["cg_steps"],
                  "loss": float(loss_b3), "gap_vs_fp64": gaps, "xla_fp32_gap_vs_fp64": xla_gap,
                  "gap_over_xla_fp32_gap": over(gaps, xla_gap),
                  "quad_gap_vs_dense_fp64": quad_gap, "xla_fp32_quad_gap": quad_gap_xla,
                  "serve_launches": serve_launches,
                  "serve_cg_steps": [k for k, _ in steps_of(solves)],
                  "serve_gap_vs_dense_fp64": serve_gap, "xla_fp32_serve_gap": serve_gap_xla,
                  "jax_cpu": JAX_ITERGPR_STEP0, "jax_fp32_loss_gap_vs_fp64": jax_loss_gap,
                  "jax_fp32_grad_norm_gap_vs_fp64": jax_grad_gap,
                  "jax_fp64_gap_vs_port_fp64": jax64_gap,
                  "tolerance": "loss, each gradient, quad term, posterior mean and variance: "
                               "the gap from fp64 at most 2x the fp32 blocked route's; CG "
                               "steps within max(3, 5 %) of the fp32 blocked route's and JAX's "
                               "(fp32 and fp64); JAX's fp32 gradient norms within 2x the fp32 "
                               "blocked route's gap from fp64; JAX's fp64 loss and gradient "
                               "norms within 1e-6 of the port's",
                  "nvidia_smi": card_line, "wall_s": ph.elapsed()})

        # -- itergpr_chunked: the chunked MLL and posterior (blocked matvec)
        # against the fused path, both at a tight threshold where fp32
        # rounding, not the stop rule, sets their gap: held to the fused
        # fp32 blocked route's own gap from fp64 at the path's threshold.
        with Phase("itergpr_chunked", 30) as ph:
            tight = make_itergpr(True, ITERGPR_CHUNK_THRESHOLD)
            loss_f, grads_f = mll_step(tight, params, (xs, ys), probes_s)
            loss_tb, grads_tb = mll_step(make_itergpr(False, ITERGPR_CHUNK_THRESHOLD), params,
                                         (xs, ys), probes_s)
            post_f = tight.posterior(params, (xs, ys))
            mf, vf = predict_in_batches(tight, params, xq, batch_size=1024, train_data=(xs, ys),
                                        posterior=post_f)
            ph.wait()
            zero_counts()
            value, grads_c, info = tight.log_marginal_likelihood_chunked(
                params, (xs, ys), probes=probes_s, chunk_iterations=ITERGPR_CHUNK,
                max_chunks=128, logdet_value="slq")
            post_c = tight.posterior_chunked(params, (xs, ys), chunk_iterations=ITERGPR_CHUNK,
                                             max_chunks=128)
            mc, vc = predict_in_batches(tight, params, xq, batch_size=1024, train_data=(xs, ys),
                                        posterior=post_c, chunk_iterations=ITERGPR_CHUNK)
            ph.wait()
            chunk_launches = read_counts()
            require(chunk_launches == {"kuu_matvec": 0, "gram_matvec": 0},
                    f"itergpr_chunked: launches {chunk_launches} (the blocked matvec only)")
            require(info["converged"], f"itergpr_chunked: {info}")
            loss_c = -value
            grads_loss_c = {f"{s}/{k}": -g for s, d in grads_c.items() for k, g in d.items()}
            vs_fused = relative_gaps(loss_c, grads_loss_c, loss_f.double(),
                                     {k: v.double() for k, v in grads_f.items()})
            require(all(v <= 1.0 for v in over(vs_fused, xla_gap).values()),
                    f"itergpr_chunked: {vs_fused} from the fused path, the fp32 blocked "
                    f"route's gap from fp64 {xla_gap}")
            serve_vs_fused = {"mean": float((mc - mf).abs().max()),
                              "var": float((vc - vf).abs().max())}
            require(all(v <= 1.0 for v in over(serve_vs_fused, serve_gap_xla).values()),
                    f"itergpr_chunked: posterior {serve_vs_fused} from the fused path, "
                    f"the fp32 blocked route's from fp64 {serve_gap_xla}")
            emit({"phase": "itergpr_chunked", "chunk_iterations": ITERGPR_CHUNK,
                  "relative_threshold": ITERGPR_CHUNK_THRESHOLD, "info": info,
                  "launches": chunk_launches, "vs_fused_b3": vs_fused,
                  "gap_vs_fp64": relative_gaps(loss_c, grads_loss_c, loss_ref, grads_ref),
                  "fused_b3_gap_vs_fp64": relative_gaps(loss_f, grads_f, loss_ref, grads_ref),
                  "fused_blocked_fp32_gap_vs_fp64": relative_gaps(loss_tb, grads_tb, loss_ref,
                                                                  grads_ref),
                  "serve_vs_fused_b3": serve_vs_fused,
                  "serve_gap_vs_dense_fp64": {"mean": float((mc.double() - mean64).abs().max()),
                                              "var": float((vc.double() - var64).abs().max())},
                  "xla_fp32_gap_at_path_threshold": xla_gap,
                  "xla_fp32_serve_gap_at_path_threshold": serve_gap_xla,
                  "tolerance": "chunked vs fused (loss, each gradient, posterior mean and "
                               "variance) at most the fp32 blocked route's gap from fp64 at the "
                               "path's threshold",
                  "wall_s": ph.elapsed()})
            del post_c, mc, vc, post_f, mf, vf, post, mb, vb, post32, m32, v32

        # -- love_itergpr_small: LOVE caches at N = 16,384 through B3, the fp32
        # and the fp64 blocked route; exact at rank = N on a tiny slice
        with Phase("love_itergpr_small", 60) as ph:
            solves.clear()
            zero_counts()
            model = make_itergpr(True)
            love_b3 = model.posterior(params, (xs, ys), solver="lanczos")
            ph.wait()
            love_launches, love_steps = read_counts(), steps_of(solves)
            require(len(love_steps) == 1 and love_steps[0][1]
                    and love_launches == {"kuu_matvec": love_steps[0][0] + 1 + LOVE_RANK,
                                          "gram_matvec": 0},
                    f"love_itergpr_small: launches {love_launches}, solves {love_steps}")
            blocked = make_itergpr(False)
            love_xla = blocked.posterior(params, (xs, ys), solver="lanczos")
            love_64 = blocked.posterior(params64, (xs64, ys64), solver="lanczos")
            var_b3 = model.posterior_predict(love_b3, xq)[1].double()
            var_xla = blocked.posterior_predict(love_xla, xq)[1].double()
            var_love64 = blocked.posterior_predict(love_64, xq64)[1]
            gap_b3 = float((var_b3 - var_love64).abs().max())
            gap_xla = float((var_xla - var_love64).abs().max())
            require(gap_b3 <= 2.0 * gap_xla,
                    f"love_itergpr_small: B3 {gap_b3} from the fp64 LOVE cache, the fp32 "
                    f"blocked route {gap_xla}")
            over64 = var_love64 - var64
            over_b3 = var_b3 - var64
            require(float(over64.min()) >= -1e-9 and float(over_b3.min()) >= -2.0 * gap_xla,
                    f"love_itergpr_small: below the dense fp64 variances: fp64 LOVE "
                    f"{float(over64.min())}, B3 {float(over_b3.min())}")
            # rank = N on a tiny slice, fp64: the cache is exact.
            tiny = ITERGPR_LOVE_EXACT_N
            exact_model = IterGPR(kernel=kernel, error_threshold=ITERGPR_REF_THRESHOLD,
                                  relative_threshold=True, max_cg_iterations=ITERGPR_REF_MAX_CG,
                                  precondition=None, block=ITERGPR_BLOCK,
                                  serving_lanczos_rank=tiny)
            tiny_data = (xs64[:tiny], ys64[:tiny])
            love_tiny = exact_model.posterior(params64, tiny_data, solver="lanczos")
            var_tiny = exact_model.posterior_predict(love_tiny, xq64)[1]
            chol_tiny = dense.posterior_predict(dense.posterior(params64, tiny_data), xq64)[1]
            exact_gap = float((var_tiny - chol_tiny).abs().max())
            require(exact_gap <= 1e-8, f"love_itergpr_small: rank = N = {tiny} LOVE "
                                       f"variances {exact_gap} from Cholesky")
            emit({"phase": "love_itergpr_small", "n": small, "rank": LOVE_RANK,
                  "query_points": ITERGPR_SMALL_TEST, "launches": love_launches,
                  "cg_steps_alpha": love_steps[0][0], "b3_var_gap_vs_fp64_love": gap_b3,
                  "blocked_fp32_var_gap_vs_fp64_love": gap_xla,
                  "fp64_love_over_dense_mean": float(over64.mean()),
                  "fp64_love_over_dense_max": float(over64.max()),
                  "b3_over_dense_min": float(over_b3.min()),
                  "exact_rank_n": tiny, "exact_rank_var_gap_vs_chol": exact_gap,
                  "tolerance": "B3's gap to the fp64 LOVE cache <= 2x the fp32 blocked "
                               "route's; LOVE >= the dense fp64 variances (B3 less 2x that "
                               "gap); rank = N exact at 1e-8; B3 launches = alpha steps + 1 "
                               "+ rank",
                  "nvidia_smi": card_line, "wall_s": ph.elapsed()})
            del love_b3, love_xla, love_64, love_tiny

        # -- train_itergpr_pallas: train_full_batch_adam at N = 131,072 on B3
        with Phase("train_itergpr_pallas", 160) as ph:
            model = make_itergpr(True)
            data = (x, y)
            blocked_s, marks, losses = [0.0], [], []

            def timed(fn):
                def wrapped(*args, **kwargs):
                    ph.wait()
                    t0 = time.monotonic()
                    out = fn(*args, **kwargs)
                    ph.wait()
                    blocked_s[0] += time.monotonic() - t0
                    return out
                return wrapped

            class StepLog:
                """The trainer's monitor: each step's loss, end time, counts."""

                def add_scalar(self, name, value, step):
                    losses.append(float(value))

                def __call__(self, step, p):
                    ph.wait()
                    marks.append({"t": time.monotonic(), "launches": read_counts(),
                                  "solves": len(solves), "blocked_s": blocked_s[0],
                                  "peak_mb": torch.cuda.max_memory_allocated() / 1e6})

                def flush(self):
                    pass

            # The blocked route's share of a step: the SLQ value and the two
            # matvec VJPs (the solve's and the log-det's), synchronised.
            object.__setattr__(model, "_slq_value", timed(model._slq_value))
            cg_implicit_module.matvec_vjp = logdet_module.matvec_vjp = timed(vjp_impl)
            try:
                solves.clear()
                ph.wait()
                torch.cuda.reset_peak_memory_stats()
                zero_counts()
                capture["armed"] = True
                t_start = time.monotonic()
                trained = train_full_batch_adam(
                    params, lambda p, g: model.training_loss(p, data, probes=probes),
                    ITERGPR_WARMUP + ITERGPR_STEPS, learning_rate=ITERGPR_LR,
                    key=torch.Generator().manual_seed(0), monitor=StepLog())
            finally:
                cg_implicit_module.matvec_vjp = logdet_module.matvec_vjp = vjp_impl
            total = ITERGPR_WARMUP + ITERGPR_STEPS
            require(len(marks) == total and len(losses) == total,
                    f"train_itergpr_pallas: {len(marks)} steps logged")
            starts = [{"t": t_start, "launches": {"kuu_matvec": 0, "gram_matvec": 0},
                       "solves": 0, "blocked_s": 0.0}] + marks[:-1]
            per_step = []
            for i, (a, b) in enumerate(zip(starts, marks)):
                records = solves[a["solves"]:b["solves"]]
                launches = {k: b["launches"][k] - a["launches"][k] for k in b["launches"]}
                require(len(records) == 2 and launches == want_launches(True, records),
                        f"train_itergpr_pallas: step {i} launches {launches}, "
                        f"solves {steps_of(records)}")
                per_step.append({"step": i, "mll": -losses[i], "s": b["t"] - a["t"],
                                 "cg_steps": [k for k, _ in steps_of(records)],
                                 "converged": [c for _, c in steps_of(records)],
                                 "launches": launches["kuu_matvec"],
                                 "blocked_route_s": b["blocked_s"] - a["blocked_s"],
                                 "peak_mb": b["peak_mb"]})
            mll = [-v for v in losses]
            require(all(math.isfinite(v) for v in mll) and finite_params(trained),
                    f"train_itergpr_pallas: non-finite MLL or parameters {mll}")
            require(all(b > a for a, b in zip(mll, mll[1:])),
                    f"train_itergpr_pallas: the MLL does not strictly improve {mll}")
            require(all(all(s["converged"]) for s in per_step),
                    "train_itergpr_pallas: a solve did not converge")
            timed_steps = per_step[ITERGPR_WARMUP:]
            window_s = sum(s["s"] for s in timed_steps)
            window_launches = sum(s["launches"] for s in timed_steps)
            # The first fused solve's true residual, by one fp64 blocked matvec.
            b_rows, v_rows = capture["rhs"].double(), capture["solution"].double()
            with torch.no_grad():
                kp64 = {k: v.double() for k, v in kp.items()}
                residual = b_rows - blocked_kuu_matvec(kernel, kp64, x.double(),
                                                       noise.double() * torch.ones(
                                                           n, dtype=torch.float64, device=device),
                                                       v_rows, ITERGPR_BLOCK)
            true_rel = (torch.linalg.vector_norm(residual, dim=-1)
                        / torch.linalg.vector_norm(b_rows, dim=-1)).tolist()
            del b_rows, v_rows, residual
            rule = math.sqrt(ITERGPR_THRESHOLD)
            require(len(true_rel) == 1 + ITERGPR_PROBES and max(true_rel) <= 2.0 * rule,
                    f"train_itergpr_pallas: true relative residuals {true_rel} > 2 x {rule}")
            train_record = {
                "phase": "train_itergpr_pallas", "n": n, "rows": 1 + ITERGPR_PROBES,
                "warmup": ITERGPR_WARMUP, "steps": ITERGPR_STEPS, "lr": ITERGPR_LR,
                "per_step": per_step, "mll": mll, "window_s": window_s,
                "steps_per_s": ITERGPR_STEPS / window_s,
                "ms_per_step": window_s * 1e3 / ITERGPR_STEPS,
                "launches_timed": window_launches,
                "b3_ms_per_step_estimate": window_launches / ITERGPR_STEPS
                * cases[1 + ITERGPR_PROBES]["kernel_ms"],
                "blocked_route_share": sum(s["blocked_route_s"] for s in timed_steps) / window_s,
                "peak_mb": max(s["peak_mb"] for s in per_step),
                "first_solve_true_rel_residual": true_rel,
                "stop_rule_rel_residual": rule,
                "tolerance": "MLL strictly improving; B3 launches = sum(steps + 1) per step; "
                             "the first fused solve's true relative residual per row <= 2x "
                             "sqrt(threshold)",
                "nvidia_smi": card_line, "wall_s": ph.elapsed()}
            emit(train_record)
            b3.update({"itergpr_launches": window_launches, "itergpr_steps": len(timed_steps)})

        # -- serve_itergpr_pallas: posterior (B3, R = 1) and predict_in_batches
        with Phase("serve_itergpr_pallas", 50) as ph:
            model = make_itergpr(True)
            data = (x, y)

            def rmse(p):
                post = model.posterior(p, data)
                mean, none = predict_in_batches(model, p, xt, batch_size=1024, train_data=data,
                                                mean_only=True, posterior=post)
                require(none is None and mean.shape == (ITERGPR_TEST, 1),
                        f"serve_itergpr_pallas: mean shape {tuple(mean.shape)}")
                return float(torch.sqrt(torch.mean(torch.square(mean - yt))))

            rmse_before = rmse(params)
            solves.clear()
            zero_counts()
            ph.wait()
            t0 = time.monotonic()
            post = model.posterior(trained, data)
            ph.wait()
            t1 = time.monotonic()
            mean, _ = predict_in_batches(model, trained, xt, batch_size=1024, train_data=data,
                                         mean_only=True, posterior=post)
            ph.wait()
            t2 = time.monotonic()
            rmse_after = float(torch.sqrt(torch.mean(torch.square(mean - yt))))
            capture["armed"] = True  # keep the variance solve's rows for serve_love_itergpr
            mean_v, var_v = predict_in_batches(model, trained, xt[:ITERGPR_VAR_BATCH],
                                               batch_size=ITERGPR_VAR_BATCH, train_data=data,
                                               posterior=post)
            ph.wait()
            t3 = time.monotonic()
            t2_cg = t2
            serve_launches, serve_steps = read_counts(), steps_of(solves)
            require(len(serve_steps) == 2 and all(c for _, c in serve_steps)
                    and serve_launches == want_launches(True, solves),
                    f"serve_itergpr_pallas: launches {serve_launches}, solves {serve_steps}")
            require(rmse_after < rmse_before,
                    f"serve_itergpr_pallas: test RMSE {rmse_after} after, {rmse_before} before")
            variance = float(kernel.variance(trained["kernel"]))
            require(bool(torch.isfinite(mean_v).all() and torch.isfinite(var_v).all()),
                    "serve_itergpr_pallas: non-finite mean or variance")
            require(float(var_v.max()) <= variance and float(var_v.min()) >= -1e-4,
                    f"serve_itergpr_pallas: variances in [{float(var_v.min())}, "
                    f"{float(var_v.max())}], kernel variance {variance}")
            emit({"phase": "serve_itergpr_pallas", "n": n, "test_points": ITERGPR_TEST,
                  "rmse_before": rmse_before, "rmse_after": rmse_after,
                  "noise_floor_rmse": ITERGPR_NOISE_FLOOR_RMSE,
                  "posterior_build_s": t1 - t0, "mean_s": t2 - t1,
                  "mean_points_per_s": ITERGPR_TEST / (t2 - t1),
                  "var_batch": ITERGPR_VAR_BATCH, "mean_var_s": t3 - t2,
                  "mean_var_points_per_s": ITERGPR_VAR_BATCH / (t3 - t2),
                  "launches": serve_launches, "cg_steps": [k for k, _ in serve_steps],
                  "var_min": float(var_v.min()), "var_max": float(var_v.max()),
                  "kernel_variance": variance,
                  "tolerance": "RMSE below its value before training; variances finite, at "
                               "most the kernel variance, at least -1e-4",
                  "nvidia_smi": card_line, "wall_s": ph.elapsed()})

        # -- serve_love_itergpr: the LOVE cache at the trained parameters through
        # B3 (R = 1, one launch per Lanczos step), means and variances of the
        # 4096 test points with batch_size="auto"
        with Phase("serve_love_itergpr", 120) as ph:
            kmn_rows, v_rows = capture.pop("rhs"), capture.pop("solution")
            require(kmn_rows.shape[0] == ITERGPR_VAR_BATCH, "serve_love_itergpr: capture")
            # The CG variances' allowance per point: |k.(v - v*)| <= |v*| |r|, with
            # |r| <= sqrt(threshold) |k| by the stop rule (2x for the true residual).
            allowed = (2.0 * math.sqrt(ITERGPR_THRESHOLD) * torch.linalg.vector_norm(
                kmn_rows.double(), dim=-1) * torch.linalg.vector_norm(v_rows.double(), dim=-1))
            del kmn_rows, v_rows
            solves.clear()
            zero_counts()
            torch.cuda.reset_peak_memory_stats()
            ph.wait()
            t0 = time.monotonic()
            love = model.posterior(trained, data, solver="lanczos")
            ph.wait()
            t1 = time.monotonic()
            love_launches, love_steps = read_counts(), steps_of(solves)
            require(len(love_steps) == 1 and love_steps[0][1]
                    and love_launches == {"kuu_matvec": love_steps[0][0] + 1 + LOVE_RANK,
                                          "gram_matvec": 0},
                    f"serve_love_itergpr: launches {love_launches}, solves {love_steps}")
            love_mean, love_var = predict_in_batches(model, trained, xt, batch_size="auto",
                                                     train_data=data, posterior=love)
            ph.wait()
            t2 = time.monotonic()
            peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
            # The same alpha, so the same means where the batching is the same
            # (the 1024-row batches above sum in another order: 1.5e-4 apart).
            cg_mean, _ = predict_in_batches(model, trained, xt, batch_size="auto",
                                            train_data=data, mean_only=True, posterior=post)
            same_alpha = bool(torch.equal(love.alpha, post.alpha))
            require(same_alpha and bool(torch.equal(love_mean, cg_mean)),
                    f"serve_love_itergpr: alpha equal {same_alpha}, means "
                    f"{float((love_mean - cg_mean).abs().max())} from the cg cache's")
            mean_gap = float((love_mean - mean).abs().max())
            over = love_var[:ITERGPR_VAR_BATCH, 0].double() - var_v[:, 0].double()
            require(bool(torch.all(over >= -allowed)),
                    f"serve_love_itergpr: a LOVE variance below the cg one by "
                    f"{float((-over - allowed).max())} beyond the stop rule's allowance")
            require(bool(torch.isfinite(love_var).all()) and float(love_var.max()) <= variance,
                    "serve_love_itergpr: variances not finite or above the kernel variance")
            emit({"phase": "serve_love_itergpr", "n": n, "rank": LOVE_RANK,
                  "test_points": ITERGPR_TEST, "launches": love_launches,
                  "cg_steps_alpha": love_steps[0][0], "cache_build_s": t1 - t0,
                  "mean_var_s": t2 - t1, "mean_var_points_per_s": ITERGPR_TEST / (t2 - t1),
                  "cg_route_mean_var_points_per_s": ITERGPR_VAR_BATCH / (t3 - t2_cg),
                  "alpha_bitwise_equal_cg_cache": same_alpha,
                  "mean_gap_vs_cg_cache_1024_row_batches": mean_gap,
                  "over_cg_first_512_mean": float(over.mean()),
                  "over_cg_first_512_max": float(over.max()),
                  "over_cg_first_512_min": float(over.min()),
                  "cg_allowance_max": float(allowed.max()),
                  "cg_allowance_median": float(allowed.median()),
                  "peak_mb": peak_mb, "batch_size": "auto",
                  "tolerance": "alpha and means (same batching) bitwise the cg cache's; LOVE "
                               "variance >= cg "
                               "variance - 2 sqrt(threshold) |k| |v| per point; <= the kernel "
                               "variance; B3 launches = alpha steps + 1 + rank",
                  "nvidia_smi": card_line, "wall_s": ph.elapsed()})
            b3.update({"love_itergpr_launches": love_launches["kuu_matvec"]})
            del love, love_mean, love_var

        exact_gp_lbfgs_phases({"device": device, "card_line": card_line, "gram_record": b3,
                               "data64": (x_np, y_np), "data": (x, y, probes),
                               "make_itergpr": make_itergpr, "solves": solves,
                               "steps_of": steps_of, "read_counts": read_counts,
                               "want_launches": want_launches,
                               "b3_ms_r9": cases[1 + ITERGPR_PROBES]["kernel_ms"]})
    finally:
        cg_implicit_module._implicit_cg_impl = impl
        cg_implicit_module.matvec_vjp = logdet_module.matvec_vjp = vjp_impl


class StepLosses:
    """A trainer monitor that keeps every ``train/loss`` scalar."""

    def __init__(self):
        self.losses = []

    def add_scalar(self, name, value, step):
        if name == "train/loss":
            self.losses.append(float(value))

    def __call__(self, step, params):
        pass

    def flush(self):
        pass


class IterationLog:
    """An L-BFGS monitor that notes how many evaluations came before each of
    its calls (the evaluations' losses are read after the run)."""

    def __init__(self, evaluations):
        self.evaluations, self.marks = evaluations, []

    def __call__(self, step, params):
        self.marks.append(len(self.evaluations))

    def flush(self):
        pass

    def counts(self, trainer: str) -> dict:
        """The run's iterations (one monitor call each: scipy's callback, or
        the device trainer at ``record_step=1``), evaluations and host reads
        (both trainers read each evaluation once: scipy its loss and
        gradient, the device trainer its value and slope), and the device
        trainer's line-search steps per iteration (its evaluations between
        two monitor calls, less the one at the iterate)."""
        evaluations = len(self.evaluations)
        counts = {"iterations": len(self.marks), "evaluations": evaluations,
                  "host_reads": evaluations}
        if trainer == "device":
            counts["linesearch_steps"] = [b - a - 1 for a, b in
                                          zip([0] + self.marks, self.marks)]
        return counts


def flat_of(params) -> torch.Tensor:
    """The leaves in sorted-key order as one detached vector (no host read)."""
    if isinstance(params, dict):
        return torch.cat([flat_of(params[k]) for k in sorted(params)])
    return params.detach().reshape(-1)


def counted_loss(loss_fn, evaluations):
    """``loss_fn`` that keeps each evaluation's ``(parameters, loss)``
    (detached, on the device: no host read) in ``evaluations``."""

    def wrapped(params):
        value = loss_fn(params)
        evaluations.append((flat_of(params), value.detach()))
        return value

    return wrapped


def final_loss(loss_fn, evaluations, trained) -> float:
    """The loss at ``trained``: an evaluation's at the same parameters
    (bitwise) when there is one, else one more evaluation."""
    flat = flat_of(trained)
    for params, value in reversed(evaluations):
        if params.shape == flat.shape and torch.equal(params, flat):
            return float(value)
    with torch.no_grad():
        return float(loss_fn(trained))


def value_and_named_grads(loss_fn, params, names):
    """``loss_fn(params)`` and its gradients with respect to the leaves
    named ``names`` (slash-joined), the other leaves held fixed."""
    live = {k: ({kk: vv.detach().clone() for kk, vv in v.items()} if isinstance(v, dict)
                else v.detach().clone()) for k, v in params.items()}
    leaves = []
    for name in names:
        node = live
        *path, last = name.split("/")
        for part in path:
            node = node[part]
        node[last] = node[last].requires_grad_()
        leaves.append(node[last])
    value = loss_fn(live)
    grads = torch.autograd.grad(value, leaves)
    return value.detach(), {n: g.detach() for n, g in zip(names, grads)}


def to_device(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: to_device(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype or tree.dtype)


def baseline_phases(ctx) -> None:
    """The baselines of the paper on the e2e data at M = 989 and the
    pathwise serving cache on the dense serving workload:

    * ``train_sgpr_lbfgs``: ``SGPR`` (Matern32, float64, jitter 1e-6, Z
      the committed selection, held fixed) over all 291,450 training rows:
      the first ELBO and its gradients against the port's float64 values
      on the host CPU (1e-9 relative), ``train_using_lbfgs_and_update``
      for 20 iterations (the loss never rises between callbacks), the test
      split served through ``predict_in_batches`` on the data-bound cache
      (RMSE falls from init), then ``train_using_device_lbfgs`` for 20
      iterations from the same init (its loss <= scipy's + 1e-3 |scipy's|).
    * ``train_lpsvgp`` / ``train_pathwise``: ``LpSVGP`` and
      ``PathwiseClusterGP`` (S = 8, L = 512, its generator on the card),
      float64, 100 adam(0.01) steps on batches of 2048 through
      ``train_using_adam_and_update``: the mean loss of the last 10 steps
      below the first 10's.  No kernel runs in these three phases.
    * ``pathwise_cggp``: ``build_pathwise_posterior(solver="cg")`` on the
      serving workload's fp32 ``CGGP`` (S = 8, L = 512, one generator
      seed) through B2 (``pallas_resident``, no preconditioner, absolute
      1e-8), through B1 (``pallas`` under the exact factor, relative 1e-5)
      and through ``"xla"`` in each configuration, against ``solver="chol"``
      in float64 on the same draws: each kernel route's weights within 2x
      the fp32 ``"xla"`` route's gap; one B2 launch, B1 launches = steps +
      1.  The 4 x 8192 serving points through ``pathwise_samples_at`` (one
      call a batch) and ``pathwise_samples_scan``, bitwise equal; over 512
      points ``PathwiseClusterGP.pathwise_samples`` with the same seed
      against the cached ``"chol"`` samples (``SERVE_ATOL``), and S = 256
      cached samples at each L of ``PATHWISE_MOMENT_BASES`` within 5
      Monte-Carlo standard errors: their mean of ``ClusterGP``'s float64
      Cholesky predictive at every L, their variance of the sampler's own
      given its frequencies at L = 512 and of ``ClusterGP``'s at the largest
      L (the RFF error between the two, reported at each L, falls as
      1 / sqrt(L)).

    ``ctx`` carries the card, its ``nvidia-smi`` line, the e2e split
    (numpy), the committed selection, the fp32 serving parameters, the
    serving points and the dense model factory, and the ``kernels`` record
    (which gains B1's and B2's ``pathwise_*`` counts)."""
    import cggp_tpu_torch.ops.cg as cg_module
    import cggp_tpu_torch.ops.rff as rff_module
    from cggp_tpu_torch.models import (CGGP, ClusterGP, LpSVGP, PathwiseClusterGP, SGPR,
                                       build_pathwise_posterior, pathwise_samples_at,
                                       pathwise_samples_scan)
    from cggp_tpu_torch.ops.cg import ConjugateGradient
    from cggp_tpu_torch.ops.kernels import Matern32
    from cggp_tpu_torch.ops.pallas_cg import pallas_cg_solve
    from cggp_tpu_torch.ops.pallas_matvec import pallas_matvec
    from cggp_tpu_torch.training.optimize import (predict_in_batches, train_using_adam_and_update,
                                                  train_using_device_lbfgs,
                                                  train_using_lbfgs_and_update)

    device, card_line, kernels = ctx["device"], ctx["card_line"], ctx["kernels"]
    x_train, y_train, x_test, y_test = ctx["data"]
    iv, u, counts = ctx["selection"]
    n_train = x_train.shape[0]
    x64 = torch.as_tensor(x_train, dtype=torch.float64, device=device)
    y64 = torch.as_tensor(y_train, dtype=torch.float64, device=device)
    xt64 = torch.as_tensor(x_test, dtype=torch.float64, device=device)
    yt64 = torch.as_tensor(y_test, dtype=torch.float64, device=device)

    # -- train_sgpr_lbfgs: the Titsias baseline at full width, float64 -------
    with Phase("train_sgpr_lbfgs", 300) as ph:
        model = SGPR(kernel=Matern32())
        params0 = model.init_params(iv, dtype=torch.float64, device=device)
        mask = {"kernel": True, "likelihood": True, "inducing_points": False}
        names = ("kernel/variance", "kernel/lengthscales", "likelihood/variance")
        torch.cuda.reset_peak_memory_stats()
        loss_card, grads_card = value_and_named_grads(
            lambda p: model.training_loss(p, (x64, y64)), params0, names)
        ph.wait()
        rows = SGPR_CPU_CHECK_ROWS or n_train
        if rows != n_train:
            loss_card, grads_card = value_and_named_grads(
                lambda p: model.training_loss(p, (x64[:rows], y64[:rows])), params0, names)
        t0 = time.monotonic()
        loss_cpu, grads_cpu = value_and_named_grads(
            lambda p: model.training_loss(p, (torch.as_tensor(x_train[:rows]),
                                              torch.as_tensor(y_train[:rows]))),
            to_device(params0, "cpu"), names)
        cpu_s = time.monotonic() - t0
        vs_cpu = {"loss": abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu)),
                  **{n: float(torch.linalg.vector_norm(grads_card[n].cpu() - grads_cpu[n])
                              / torch.linalg.vector_norm(grads_cpu[n])) for n in names}}
        require(all(v <= 1e-9 for v in vs_cpu.values()),
                f"train_sgpr_lbfgs: the card's first ELBO and gradients {vs_cpu} from the "
                "host CPU's float64")

        def rmse(p):
            mean, _ = predict_in_batches(model, p, xt64, batch_size=R_BATCH, train_data=(x64, y64))
            return float(torch.sqrt(torch.mean(torch.square(mean - yt64))))

        rmse_before = rmse(params0)
        runs = {}
        for trainer in ("scipy", "device"):
            evaluations = []
            loss_fn = counted_loss(lambda p: model.training_loss(p, (x64, y64)), evaluations)
            log = IterationLog(evaluations)
            ph.wait()
            t0 = time.monotonic()
            if trainer == "scipy":
                trained = train_using_lbfgs_and_update(params0, loss_fn, SGPR_LBFGS_ITERATIONS,
                                                       trainable_mask=mask, monitor=log)
            else:
                trained = train_using_device_lbfgs(params0, loss_fn, SGPR_LBFGS_ITERATIONS,
                                                   trainable_mask=mask, monitor=log,
                                                   record_step=1)
            ph.wait()
            wall = time.monotonic() - t0
            stats = log.counts(trainer)
            losses = torch.stack([v for _, v in evaluations]).tolist()
            at_callbacks = [losses[k - 1] for k in log.marks]
            require(all(math.isfinite(v) for v in losses), f"train_sgpr_lbfgs {trainer}: "
                                                            "a non-finite loss")
            final = final_loss(lambda p: model.training_loss(p, (x64, y64)), evaluations,
                               trained)
            runs[trainer] = {"trained": trained, "final_loss": final,
                             "iterations": stats["iterations"],
                             "evaluations": stats["evaluations"],
                             "host_reads": stats["host_reads"], "wall_s": wall,
                             "s_per_evaluation": wall / stats["evaluations"],
                             "evaluations_per_iteration":
                                 stats["evaluations"] / stats["iterations"],
                             "host_reads_per_iteration": stats["host_reads"] / stats["iterations"],
                             "loss_at_callbacks": at_callbacks,
                             **({"linesearch_steps": stats["linesearch_steps"]}
                                if trainer == "device" else {})}
        scipy_run, device_run = runs["scipy"], runs["device"]
        require(all(b <= a for a, b in zip(scipy_run["loss_at_callbacks"],
                                           scipy_run["loss_at_callbacks"][1:])),
                f"train_sgpr_lbfgs: the loss rose between callbacks "
                f"{scipy_run['loss_at_callbacks']}")
        require(device_run["final_loss"] <= scipy_run["final_loss"]
                + 1e-3 * abs(scipy_run["final_loss"]),
                f"train_sgpr_lbfgs: device L-BFGS ended at {device_run['final_loss']}, scipy "
                f"at {scipy_run['final_loss']}")
        ph.wait()
        t0 = time.monotonic()
        rmse_after = rmse(scipy_run["trained"])
        serve_s = time.monotonic() - t0
        require(rmse_after < rmse_before,
                f"train_sgpr_lbfgs: test RMSE {rmse_after} after, {rmse_before} before")
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        emit({"phase": "train_sgpr_lbfgs", "n": n_train, "m": int(iv.shape[0]),
              "dtype": "float64", "cpu_check_rows": rows, "cpu_reference_s": cpu_s,
              "first_loss": float(loss_card), "first_step_gap_vs_cpu_fp64": vs_cpu,
              **{f"{t}_{k}": v for t, r in runs.items() for k, v in r.items()
                 if k != "trained"},
              "rmse_before": rmse_before, "rmse_after": rmse_after,
              "serve_test_points": int(xt64.shape[0]), "serve_s": serve_s,
              "serve_points_per_s": xt64.shape[0] / serve_s, "peak_mb": peak_mb,
              "tolerance": "first ELBO and gradients within 1e-9 of the host CPU's float64; "
                           "scipy's loss never rises between callbacks; device final loss <= "
                           "scipy's + 1e-3 |scipy's|; test RMSE below its init value",
              "nvidia_smi": card_line, "wall_s": ph.elapsed()})
        del runs, scipy_run, device_run
    torch.cuda.empty_cache()

    # -- train_lpsvgp / train_pathwise: 100 minibatch adam steps each ---------
    for name in ("train_lpsvgp", "train_pathwise"):
        with Phase(name, 120) as ph:
            if name == "train_lpsvgp":
                model = LpSVGP(kernel=Matern32(), num_data=n_train)
                params = model.init_params(iv, dtype=torch.float64, device=device)
            else:
                model = PathwiseClusterGP(kernel=Matern32(), num_data=n_train,
                                          num_bases=PATHWISE_BASES, num_samples=PATHWISE_SAMPLES)
                params = model.init_params(iv, pseudo_u=u, cluster_counts=counts,
                                           dtype=torch.float64, device=device)
            log = StepLosses()
            key = torch.Generator(device=device).manual_seed(BASELINE_SEED)
            ph.wait()
            t0 = time.monotonic()
            trained = train_using_adam_and_update(
                params, model.training_loss, (x64, y64), BASELINE_STEPS, TRAIN_BATCH, TRAIN_LR,
                key, trainable_mask=model.trainable_mask(params), monitor=log)
            ph.wait()
            wall = time.monotonic() - t0
            losses = log.losses
            require(len(losses) == BASELINE_STEPS and all(math.isfinite(v) for v in losses),
                    f"{name}: {len(losses)} losses logged, finite {np.isfinite(losses).all()}")
            require(all(bool(torch.isfinite(v).all()) for v in
                        (trained["kernel"]["lengthscales"], trained["likelihood"]["variance"])),
                    f"{name}: non-finite parameters")
            first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
            require(last < first, f"{name}: mean loss of the last 10 steps {last}, first {first}")
            emit({"phase": name, "n": n_train, "m": int(iv.shape[0]), "dtype": "float64",
                  "steps": BASELINE_STEPS, "batch": TRAIN_BATCH, "lr": TRAIN_LR,
                  **({"num_samples": PATHWISE_SAMPLES, "num_bases": PATHWISE_BASES}
                     if name == "train_pathwise" else {}),
                  "loss_first_10_mean": first, "loss_last_10_mean": last,
                  "steps_per_s": BASELINE_STEPS / wall, "wall_train_s": wall,
                  "kernels": "none: plain torch (Cholesky, triangular solves, RFF features)",
                  "tolerance": "the last 10 steps' mean loss below the first 10's",
                  "nvidia_smi": card_line, "wall_s": ph.elapsed()})

    # -- pathwise_cggp: the pathwise serving cache through each route --------
    with Phase("pathwise_cggp", 150) as ph:
        params, xq = ctx["params"], ctx["xq"]
        params64 = to_device(params, device, torch.float64)

        def cggp(impl, config):
            if config == "chol":
                cg = ConjugateGradient(TRAIN_CHOL_THRESHOLD, relative_threshold=True,
                                       matvec_impl=impl)
            else:
                cg = ConjugateGradient(CG_THRESHOLD, matvec_impl=impl)
            return CGGP(kernel=Matern32(), num_data=n_train, conjugate_gradient=cg,
                        precondition="chol" if config == "chol" else None)

        def gen():
            return torch.Generator(device=device).manual_seed(PATHWISE_SEED)

        # Record the fp32 draws to replay them in float64: theta (its own
        # normals inside) and, by shape, w [S, 2L] and eps [S, M, 1].
        drawn = {"theta": None, "normal": {}}
        theta_fn, normal_fn = rff_module.basis_theta_parameter, rff_module.standard_normal

        def recording_theta(*args, **kwargs):
            drawn["theta"] = theta_fn(*args, **kwargs)
            return drawn["theta"]

        def recording_normal(generator, shape, dtype, device_):
            drawn["normal"][tuple(shape)] = normal_fn(generator, shape, dtype, device_)
            return drawn["normal"][tuple(shape)]

        m = int(params["inducing_points"].shape[0])
        draw_shapes = ((PATHWISE_SAMPLES, 2 * PATHWISE_BASES), (PATHWISE_SAMPLES, m, 1))
        builds = {}
        for route, impl, config in (("b2", "pallas_resident", "plain"), ("xla_plain", "xla", "plain"),
                                    ("b1", "pallas", "chol"), ("xla_chol", "xla", "chol")):
            model = cggp(impl, config)
            solves, undo = record_dense_solves(cg_module, operands=False)
            rff_module.basis_theta_parameter = recording_theta
            rff_module.standard_normal = recording_normal
            drawn["normal"] = {}
            try:
                ph.wait()
                pallas_cg_solve.launches = pallas_matvec.launches = 0
                t0 = time.monotonic()
                post = build_pathwise_posterior(model, params, gen(), num_bases=PATHWISE_BASES,
                                                num_samples=PATHWISE_SAMPLES, solver="cg")
                ph.wait()
                build_ms = (time.monotonic() - t0) * 1e3
                launches = {"pallas_cg_solve": pallas_cg_solve.launches,
                            "pallas_matvec": pallas_matvec.launches}
            finally:
                undo()
                rff_module.basis_theta_parameter, rff_module.standard_normal = theta_fn, normal_fn
            steps = [int(s["stats"].steps) for s in solves]
            require(len(steps) == 1 and all(bool(s["stats"].converged) for s in solves),
                    f"pathwise_cggp {route}: solves {steps}")
            want = {"pallas_cg_solve": 1 if impl == "pallas_resident" else 0,
                    "pallas_matvec": steps[0] + 1 if impl == "pallas" else 0}
            require(launches == want, f"pathwise_cggp {route}: launches {launches}, want {want}")
            require(all(shape in drawn["normal"] for shape in draw_shapes),
                    f"pathwise_cggp {route}: draws of shapes {sorted(drawn['normal'])}")
            builds[route] = {"post": post, "build_ms": build_ms, "launches": launches,
                             "cg_steps": steps[0],
                             "draws": [drawn["theta"]] + [drawn["normal"][s] for s in draw_shapes]}
        for route in builds:
            require(all(torch.equal(a, b) for a, b in zip(builds[route]["draws"],
                                                          builds["xla_plain"]["draws"])),
                    f"pathwise_cggp {route}: other draws than the xla route's")
        # The float64 yardstick: solver="chol" on the same draws, widened.
        theta_drawn, *normals_drawn = builds["xla_plain"]["draws"]
        replay = {shape: t.double() for shape, t in zip(draw_shapes, normals_drawn)}
        rff_module.basis_theta_parameter = lambda *args, **kwargs: theta_drawn.double()
        rff_module.standard_normal = lambda generator, shape, dtype, device_: replay[tuple(shape)]
        try:
            chol64 = build_pathwise_posterior(cggp("xla", "plain"), params64, gen(),
                                              num_bases=PATHWISE_BASES,
                                              num_samples=PATHWISE_SAMPLES, solver="chol")
        finally:
            rff_module.basis_theta_parameter, rff_module.standard_normal = theta_fn, normal_fn
        gaps = {route: float((b["post"].weights.double() - chol64.weights).abs().max())
                for route, b in builds.items()}
        for route, ref in (("b2", "xla_plain"), ("b1", "xla_chol")):
            require(gaps[route] <= 2.0 * gaps[ref],
                    f"pathwise_cggp: {route} weights {gaps[route]} from fp64, {ref} {gaps[ref]}")
        # Serving: the 4 x 8192 points, one call a batch and the scan.
        model = cggp("pallas_resident", "plain")
        post = builds["b2"]["post"]
        ph.wait()
        t0 = time.monotonic()
        per_batch = torch.cat([pathwise_samples_at(model, post, xq[i:i + R_BATCH])
                               for i in range(0, xq.shape[0], R_BATCH)], dim=1)
        ph.wait()
        t1 = time.monotonic()
        swept = pathwise_samples_scan(model, post, xq, batch_size=R_BATCH)
        ph.wait()
        t2 = time.monotonic()
        require(per_batch.shape == (PATHWISE_SAMPLES, xq.shape[0], 1)
                and bool(torch.isfinite(per_batch).all()), "pathwise_cggp: samples")
        require(torch.equal(per_batch, swept), "pathwise_cggp: the scan differs from the "
                                               "per-batch evaluation")
        # Per call against the cache ("chol", fp32), one seed.
        pts = xq[:PATHWISE_CHECK_POINTS]
        per_call_model = PathwiseClusterGP(kernel=Matern32(), num_data=n_train,
                                           num_bases=PATHWISE_BASES, num_samples=PATHWISE_SAMPLES)
        per_call = per_call_model.pathwise_samples(params, pts, gen())
        cached = pathwise_samples_at(model, build_pathwise_posterior(
            model, params, gen(), num_bases=PATHWISE_BASES, num_samples=PATHWISE_SAMPLES,
            solver="chol"), pts)
        call_gap = float((per_call - cached).abs().max())
        require(call_gap <= SERVE_ATOL, f"pathwise_cggp: per-call samples {call_gap} from the "
                                        "cached ones")
        # Moments of S = 256 cached samples, float64, at each L of
        # PATHWISE_MOMENT_BASES: the mean against ClusterGP's Cholesky
        # predictive (the sampler's exact mean at every L); the variance
        # against ClusterGP's and against the sampler's own given its
        # frequencies (the RFF prior through the same correction), its exact
        # Monte-Carlo target at that L.  The two variances differ by the
        # RFF error given theta, which falls as 1 / sqrt(L): gated against
        # the sampler's own at L = 512 and against ClusterGP's at the
        # largest L (PERF.md §6, the sweep).
        mu, var = ClusterGP(kernel=Matern32(), num_data=n_train).predict_f(params64, pts.double())
        mu, var = mu[:, 0], var[:, 0]
        kp64, z64 = params64["kernel"], params64["inducing_points"]
        lam64 = model.diag_variance(params64)[:, 0]
        chol = torch.linalg.cholesky(model.kernel.K(kp64, z64) + torch.diag(lam64))
        g = torch.cholesky_solve(model.kernel.K(kp64, z64, pts.double()), chol)  # [M, P]
        noise_var = torch.sum(g ** 2 * lam64[:, None], dim=0)
        sweep = {}
        for bases in PATHWISE_MOMENT_BASES:
            post_s = build_pathwise_posterior(model, params, gen(), num_bases=bases,
                                              num_samples=PATHWISE_MOMENT_SAMPLES, solver="chol")
            many = pathwise_samples_at(model, post_s, pts)[..., 0].double()
            theta64, scale64 = post_s.theta.double(), post_s.basis_scale.double()
            del post_s
            resid = rff_module.basis_vectors(pts.double(), theta64)
            resid -= g.T @ rff_module.basis_vectors(z64, theta64)
            var_given_theta = scale64 ** 2 * torch.sum(resid ** 2, dim=-1) + noise_var
            del resid
            s_mean, s_var = many.mean(dim=0), many.var(dim=0)
            se_mean = torch.sqrt(s_var / PATHWISE_MOMENT_SAMPLES)
            se_var = s_var * math.sqrt(2.0 / (PATHWISE_MOMENT_SAMPLES - 1))
            sweep[bases] = {
                "mean_max_standard_errors": float(((s_mean - mu).abs() / se_mean).max()),
                "var_given_theta_max_standard_errors":
                    float(((s_var - var_given_theta).abs() / se_var).max()),
                "var_vs_clustergp_max_standard_errors": float(((s_var - var).abs() / se_var).max()),
                "rff_var_bias_max_abs": float((var_given_theta - var).abs().max()),
                "rff_var_bias_max_standard_errors":
                    float(((var_given_theta - var).abs() / se_var).max())}
            del many
            torch.cuda.empty_cache()
        at_512, at_most = sweep[PATHWISE_BASES], sweep[max(PATHWISE_MOMENT_BASES)]
        require(all(r["mean_max_standard_errors"] <= 5.0 for r in sweep.values())
                and at_512["var_given_theta_max_standard_errors"] <= 5.0
                and at_most["var_vs_clustergp_max_standard_errors"] <= 5.0,
                f"pathwise_cggp: sample moments in standard errors by L: {sweep}")
        kernels["pallas_cg_solve"]["pathwise_launches"] = builds["b2"]["launches"][
            "pallas_cg_solve"]
        kernels["pallas_matvec"]["pathwise_launches"] = builds["b1"]["launches"]["pallas_matvec"]
        sample_points = PATHWISE_SAMPLES * xq.shape[0]
        emit({"phase": "pathwise_cggp", "m": int(post.weights.shape[1]),
              "num_samples": PATHWISE_SAMPLES, "num_bases": PATHWISE_BASES,
              "routes": {r: {k: v for k, v in b.items() if k not in ("post", "draws")}
                         for r, b in builds.items()},
              "weights_gap_vs_fp64_chol": gaps,
              "points": int(xq.shape[0]),
              "per_batch_sample_points_per_s": sample_points / (t1 - t0),
              "scan_sample_points_per_s": sample_points / (t2 - t1),
              "per_call_vs_cache_max_abs": call_gap,
              "moments_points": PATHWISE_CHECK_POINTS, "moment_samples": PATHWISE_MOMENT_SAMPLES,
              "moments_by_num_bases": {str(k): v for k, v in sweep.items()},
              "clustergp_var_range": [float(var.min()), float(var.max())],
              "tolerance": "each kernel route's weights within 2x the fp32 xla route's gap from "
                           "fp64 chol (same config); launches: one B2, B1 = steps + 1; scan == "
                           f"per-batch bitwise; per call vs cache <= {SERVE_ATOL}; S = 256 "
                           "moments within 5 Monte-Carlo standard errors: the mean of "
                           "ClusterGP's at every L, the variance of the sampler's given its "
                           f"frequencies at L = {PATHWISE_BASES} and of ClusterGP's at L = "
                           f"{max(PATHWISE_MOMENT_BASES)}",
              "nvidia_smi": card_line, "wall_s": ph.elapsed()})
    del x64, y64, xt64, yt64
    torch.cuda.empty_cache()


def exact_gp_lbfgs_phases(ctx) -> None:
    """``paper_gpr``'s L-BFGS entry points on the exact-GP data (called
    inside :func:`itergpr_phases`, whose solve recorder is on):

    * ``train_gpr_lbfgs``: the dense float64 ``GPR`` (Matern32) on the
      first 10,000 training rows (``paper_gpr``'s default size),
      ``train_using_lbfgs_and_update`` and ``train_using_device_lbfgs``
      for 50 iterations each: both end below the init loss, the device
      run's loss <= scipy's + 1e-3 |scipy's|.
    * ``train_itergpr_lbfgs``: ``paper_gpr --iterative -o scipy`` at N =
      131,072 through B3 (``train_itergpr_pallas``' model and its 8 fixed
      probes) for ``ITERGPR_LBFGS_ITERATIONS`` (1) iteration: every
      evaluation's MLL finite, the final loss below the init loss, each
      evaluation's B3 launches = the steps + 1 of its two solves; then the
      device trainer against scipy for 10 iterations each at N = 16,384
      through B3 (device <= scipy + 1e-3 |scipy|)."""
    from cggp_tpu_torch.models import GPR
    from cggp_tpu_torch.ops.kernels import Matern32
    from cggp_tpu_torch.training.optimize import (train_using_device_lbfgs,
                                                  train_using_lbfgs_and_update)

    device, card_line, b3 = ctx["device"], ctx["card_line"], ctx["gram_record"]
    x_np, y_np = ctx["data64"]
    x, y, probes = ctx["data"]
    make_itergpr, solves, steps_of = ctx["make_itergpr"], ctx["solves"], ctx["steps_of"]
    read_counts, want_launches = ctx["read_counts"], ctx["want_launches"]

    def lbfgs_runs(loss_fn, params0, iterations, trainers, ph):
        """Each trainer from ``params0``: its stats, wall time, the losses
        of its evaluations and at its callbacks, and the final loss."""
        runs = {}
        for trainer in trainers:
            evaluations = []
            log = IterationLog(evaluations)
            counted = counted_loss(loss_fn, evaluations)
            ph.wait()
            t0 = time.monotonic()
            if trainer == "scipy":
                trained = train_using_lbfgs_and_update(params0, counted, iterations, monitor=log)
            else:
                trained = train_using_device_lbfgs(params0, counted, iterations, monitor=log,
                                                   record_step=1)
            ph.wait()
            wall = time.monotonic() - t0
            stats = log.counts(trainer)
            losses = torch.stack([v for _, v in evaluations]).double().tolist()
            final = final_loss(loss_fn, evaluations, trained)
            runs[trainer] = {"final_loss": final, "iterations": stats["iterations"],
                             "evaluations": stats["evaluations"],
                             "host_reads": stats["host_reads"], "wall_s": wall,
                             "s_per_iteration": wall / stats["iterations"],
                             "s_per_evaluation": wall / stats["evaluations"],
                             "losses": losses,
                             "loss_at_callbacks": [losses[k - 1] for k in log.marks],
                             **({"linesearch_steps": stats["linesearch_steps"]}
                                if trainer == "device" else {})}
        return runs

    # -- train_gpr_lbfgs: the dense GPR on paper_gpr's 10,000 rows, float64 ---
    with Phase("train_gpr_lbfgs", 150) as ph:
        xg = torch.as_tensor(x_np[:GPR_LBFGS_N], dtype=torch.float64, device=device)
        yg = torch.as_tensor(y_np[:GPR_LBFGS_N], dtype=torch.float64, device=device)
        gpr = GPR(kernel=Matern32())
        params0 = gpr.init_params(3, dtype=torch.float64, device=device)

        def gpr_loss(p):
            return gpr.training_loss(p, (xg, yg))

        init = float(gpr_loss(params0))
        runs = lbfgs_runs(gpr_loss, params0, GPR_LBFGS_ITERATIONS, ("scipy", "device"), ph)
        for trainer, run in runs.items():
            require(run["final_loss"] < init,
                    f"train_gpr_lbfgs {trainer}: final loss {run['final_loss']}, init {init}")
        scipy_loss, device_loss = runs["scipy"]["final_loss"], runs["device"]["final_loss"]
        require(device_loss <= scipy_loss + 1e-3 * abs(scipy_loss),
                f"train_gpr_lbfgs: device L-BFGS ended at {device_loss}, scipy at {scipy_loss}")
        emit({"phase": "train_gpr_lbfgs", "n": GPR_LBFGS_N, "dtype": "float64",
              "init_loss": init,
              **{f"{t}_{k}": v for t, r in runs.items() for k, v in r.items()
                 if k not in ("losses", "loss_at_callbacks")},
              "tolerance": "both below the init loss; device <= scipy + 1e-3 |scipy|",
              "nvidia_smi": card_line, "wall_s": ph.elapsed()})
        del xg, yg

    # -- train_itergpr_lbfgs: paper_gpr --iterative -o scipy at N = 131,072 ---
    with Phase("train_itergpr_lbfgs", ITERGPR_LBFGS_BUDGET_S) as ph:
        model = make_itergpr(True)
        params0 = model.init_params(3, dtype=torch.float32, device=device)
        marks = []  # (launches, solves, time) at each evaluation's start

        def itergpr_loss(p):
            ph.wait()  # the trainer reads the last evaluation already: no extra stall
            marks.append((read_counts(), len(solves), time.monotonic()))
            if len(marks) > 1:
                print(f"chip_smoke: train_itergpr_lbfgs evaluation {len(marks) - 1} took "
                      f"{marks[-1][2] - marks[-2][2]:.1f} s", file=sys.stderr, flush=True)
            return model.training_loss(p, (x, y), probes=probes)

        solves.clear()
        torch.cuda.reset_peak_memory_stats()
        runs = lbfgs_runs(itergpr_loss, params0, ITERGPR_LBFGS_ITERATIONS, ("scipy",), ph)
        run = runs["scipy"]
        evaluations = run["evaluations"]
        ph.wait()
        marks.append((read_counts(), len(solves), time.monotonic()))
        per_eval = []
        for i in range(len(marks) - 1):  # the trainer's evaluations (and any final one)
            (a, sa, ta), (b, sb, tb) = marks[i], marks[i + 1]
            records = solves[sa:sb]
            launches = {k: b[k] - a[k] for k in b}
            want_n = 2 if i < evaluations else 1  # a final loss runs no backward solve
            require(len(records) == want_n and launches == want_launches(True, records),
                    f"train_itergpr_lbfgs: evaluation {i} launches {launches}, solves "
                    f"{steps_of(records)}")
            per_eval.append({"cg_steps": [k for k, _ in steps_of(records)],
                             "converged": [c for _, c in steps_of(records)],
                             "b3_launches": launches["kuu_matvec"], "s": tb - ta})
        losses = run["losses"]
        require(all(math.isfinite(v) for v in losses), f"train_itergpr_lbfgs: MLL {losses}")
        require(run["final_loss"] < losses[0],
                f"train_itergpr_lbfgs: final loss {run['final_loss']}, init {losses[0]}")
        train_launches = sum(e["b3_launches"] for e in per_eval[:evaluations])
        b3_ms = ctx["b3_ms_r9"]
        itergpr_record = {
            "n": ITERGPR_N, "iterations": run["iterations"], "evaluations": evaluations,
            "linesearch_host_reads": run["host_reads"], "mll": [-v for v in losses],
            "final_mll": -run["final_loss"], "s_per_evaluation": run["s_per_evaluation"],
            "b3_launches": train_launches, "per_evaluation": per_eval[:evaluations],
            "b3_share_estimate": train_launches * b3_ms / 1e3
            / sum(e["s"] for e in per_eval[:evaluations]),
            "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
        # Device against scipy at N = 16,384 (check_itergpr_small's size).
        small = ITERGPR_SMALL_N
        xs, ys, probes_s = x[:small], y[:small], probes[:, :small]

        def small_loss(p):
            return model.training_loss(p, (xs, ys), probes=probes_s)

        small_runs = lbfgs_runs(small_loss, params0, ITERGPR_LBFGS_SMALL_ITERATIONS,
                                ("scipy", "device"), ph)
        s_scipy, s_device = small_runs["scipy"]["final_loss"], small_runs["device"]["final_loss"]
        require(all(math.isfinite(v) for r in small_runs.values() for v in r["losses"]),
                "train_itergpr_lbfgs: a non-finite loss at N = 16,384")
        require(s_device <= s_scipy + 1e-3 * abs(s_scipy),
                f"train_itergpr_lbfgs: N = {small}: device L-BFGS ended at {s_device}, scipy "
                f"at {s_scipy}")
        emit({"phase": "train_itergpr_lbfgs", **itergpr_record,
              "small_n": small,
              **{f"small_{t}_{k}": v for t, r in small_runs.items() for k, v in r.items()
                 if k not in ("losses", "loss_at_callbacks")},
              "b3_ms_at_r9": b3_ms,
              "tolerance": "every MLL finite; the final loss below the init loss; B3 "
                           "launches = the steps + 1 of each evaluation's solves; N = 16,384: "
                           "device <= scipy + 1e-3 |scipy|",
              "nvidia_smi": card_line, "wall_s": ph.elapsed()})
        b3.update({"lbfgs_launches": train_launches, "lbfgs_evaluations": evaluations})


def serve_love_dense(ctx) -> None:
    """``serve_love_dense``: the dense serving workload (M = 989, 4 x 8192
    points) through ``CGGP.posterior(solver="lanczos")`` at rank
    ``LOVE_RANK`` (its ``nu`` solve through B2) and ``predict_in_batches``,
    by the loop and by the scan route (bitwise equal); the means within
    ``SERVE_ATOL`` of the fp32 ``"cg"`` route's, every variance at least the
    fp64 Cholesky variance less the fp32 ``"cg"`` route's gap from it, and at
    most the kernel variance.  Launches counted (one B2 solve, no B1)."""
    from cggp_tpu_torch.ops.pallas_cg import pallas_cg_solve
    from cggp_tpu_torch.ops.pallas_matvec import pallas_matvec
    from cggp_tpu_torch.training.optimize import predict_in_batches

    card_line, params, xq, make_model = (ctx[k] for k in ("card_line", "params", "xq",
                                                          "make_model"))
    xla_mean, xla_var = ctx["xla"]
    with Phase("serve_love_dense", 120) as ph:
        params64 = {k: ({kk: vv.double() for kk, vv in v.items()} if isinstance(v, dict)
                        else v.double()) for k, v in params.items()}
        _, chol64_var = predict_in_batches(make_model("xla"), params64, xq.double(),
                                           batch_size=R_BATCH, posterior_solver="chol")
        xla_gap = float((xla_var.double() - chol64_var).abs().max())
        model = make_model("pallas_resident")
        require(model.serving_lanczos_rank == LOVE_RANK, "LOVE rank")
        model.posterior(params, solver="lanczos")  # warm-up, not counted
        ph.wait()
        pallas_cg_solve.launches = pallas_matvec.launches = 0
        t0 = time.monotonic()
        post = model.posterior(params, solver="lanczos")
        ph.wait()
        t1 = time.monotonic()
        loop = predict_in_batches(model, params, xq, batch_size=R_BATCH, posterior=post,
                                  scan=False)
        ph.wait()
        t2 = time.monotonic()
        scan = predict_in_batches(model, params, xq, batch_size=R_BATCH, posterior=post)
        ph.wait()
        t3 = time.monotonic()
        launches = {"pallas_cg_solve": pallas_cg_solve.launches,
                    "pallas_matvec": pallas_matvec.launches}
        require(launches == {"pallas_cg_solve": 1, "pallas_matvec": 0},
                f"serve_love_dense: launches {launches}, want one B2 solve (nu)")
        require(tuple(post.lanczos_r.shape) == (LOVE_RANK, M_EXPECTED),
                f"serve_love_dense: R {tuple(post.lanczos_r.shape)}")
        require(all(torch.equal(a, b) for a, b in zip(loop, scan)),
                "serve_love_dense: the loop and the scan route differ")
        mean, var = loop
        require(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
                "serve_love_dense: non-finite output")
        mean_gap = float((mean - xla_mean).abs().max())
        over = var.double() - chol64_var
        variance = float(model.kernel.variance(params["kernel"]))
        require(mean_gap <= SERVE_ATOL, f"serve_love_dense: mean {mean_gap} from the cg route")
        require(float(over.min()) >= -xla_gap,
                f"serve_love_dense: a variance {float(over.min())} below fp64 Cholesky, "
                f"the fp32 cg route's gap {xla_gap}")
        require(float(var.max()) <= variance,
                f"serve_love_dense: variance {float(var.max())} above the kernel's {variance}")
        n = xq.shape[0]
        emit({"phase": "serve_love_dense", "rank": LOVE_RANK, "m": M_EXPECTED, "points": n,
              "batch_size": R_BATCH, "launches": launches, "cache_build_s": t1 - t0,
              "loop_points_per_s": n / (t2 - t1), "scan_points_per_s": n / (t3 - t2),
              "mean_vs_cg_route": mean_gap, "over_estimate_mean": float(over.mean()),
              "over_estimate_max": float(over.max()), "over_estimate_min": float(over.min()),
              "cg_fp32_var_gap_vs_fp64_chol": xla_gap,
              "tolerance": f"mean within {SERVE_ATOL} of the cg route; variance >= fp64 "
                           "Cholesky - the fp32 cg route's gap, <= the kernel variance; loop "
                           "== scan bitwise",
              "nvidia_smi": card_line, "wall_s": ph.elapsed()})


def serve_love_implicit(ctx) -> dict:
    """``serve_love_implicit_pallas`` / ``serve_love_implicit_xla``: the
    matrix-free serving workload (M = 9576 padded to 10240, 2 x 8192 points)
    through ``ImplicitCGGP.posterior(solver="lanczos")`` at rank
    ``LOVE_RANK``, through B3 and through the blocked route, and one float64
    LOVE cache on the blocked route.  Gates: B3's variances within 2x the
    fp32 blocked route's gap from the fp64 LOVE cache; each route's at least
    the fp64 Cholesky variances less its allowance (the blocked route's gap,
    twice it for B3); B3 launches = the nu solve's steps + 1 + the rank;
    R's pad columns exactly zero.  Returns B3's LOVE launches."""
    from cggp_tpu_torch.ops.pallas_gram import gram_matvec, kuu_matvec
    from cggp_tpu_torch.training.optimize import predict_in_batches

    card_line, iparams, xs, make_implicit = (ctx[k] for k in ("card_line", "params", "xs",
                                                              "make_implicit"))
    ref_var = ctx["ref_var"]
    pads = iparams["inducing_mask"][:, 0] == 0
    with Phase("reference_love_implicit", 120) as ph:
        iparams64 = {k: ({kk: vv.double() for kk, vv in v.items()} if isinstance(v, dict)
                         else v.double()) for k, v in iparams.items()}
        model64 = make_implicit(False)
        t0 = time.monotonic()
        post64 = model64.posterior(iparams64, solver="lanczos")
        _, var64 = predict_in_batches(model64, iparams64, xs.double(), batch_size=R_BATCH,
                                      posterior=post64)
        ph.wait()
        require(bool(torch.all(post64.lanczos_r[:, pads] == 0)),
                "reference_love_implicit: R's pad columns are not zero")
        over64 = var64 - ref_var[:xs.shape[0]]
        require(float(over64.min()) >= -1e-9,
                f"reference_love_implicit: fp64 LOVE {float(over64.min())} below fp64 Cholesky")
        emit({"phase": "reference_love_implicit", "rank": LOVE_RANK,
              "over_estimate_mean": float(over64.mean()), "over_estimate_max": float(over64.max()),
              "over_estimate_min": float(over64.min()), "wall_s": time.monotonic() - t0})
        del post64
    records = {}
    for route, use_pallas in (("xla", False), ("pallas", True)):
        name = f"serve_love_implicit_{route}"
        with Phase(name, 120) as ph:
            model = make_implicit(use_pallas)
            solves = record_solves(model)
            gram_matvec.launches = kuu_matvec.launches = 0
            t0 = time.monotonic()
            post = model.posterior(iparams, solver="lanczos")
            ph.wait()
            t1 = time.monotonic()
            mean, var = predict_in_batches(model, iparams, xs, batch_size=R_BATCH,
                                           posterior=post)
            ph.wait()
            t2 = time.monotonic()
            launches = {"kuu_matvec": kuu_matvec.launches, "gram_matvec": gram_matvec.launches}
            steps = [int(st.steps) for st in solves]
            require(len(steps) == 1 and all(bool(st.converged) for st in solves),
                    f"{name}: solves {steps}")
            want = {"kuu_matvec": steps[0] + 1 + LOVE_RANK if use_pallas else 0,
                    "gram_matvec": 0}
            require(launches == want, f"{name}: launches {launches}, want {want}")
            require(bool(torch.all(post.lanczos_r[:, pads] == 0)),
                    f"{name}: R's pad columns are not zero")
            require(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
                    f"{name}: non-finite output")
            gap = float((var.double() - var64).abs().max())
            over = var.double() - ref_var[:xs.shape[0]]
            records[route] = {"phase": name, "use_pallas": use_pallas, "rank": LOVE_RANK,
                              "launches": launches, "cg_steps_nu": steps[0],
                              "cache_build_s": t1 - t0, "serve_s": t2 - t1,
                              "points_per_s": xs.shape[0] / (t2 - t1),
                              "var_gap_vs_fp64_love": gap,
                              "over_estimate_mean": float(over.mean()),
                              "over_estimate_max": float(over.max()),
                              "over_estimate_min": float(over.min()),
                              "nvidia_smi": card_line, "wall_s": ph.elapsed()}
            if route == "xla":
                xla_gap = gap
                require(float(over.min()) >= -xla_gap,
                        f"{name}: a variance {float(over.min())} below fp64 Cholesky less "
                        f"{xla_gap}")
                records[route]["tolerance"] = ("variance >= fp64 Cholesky - the gap to the "
                                               "fp64 LOVE cache")
            else:
                require(gap <= 2.0 * xla_gap,
                        f"{name}: {gap} from the fp64 LOVE cache, the fp32 blocked route "
                        f"{xla_gap}")
                require(float(over.min()) >= -2.0 * xla_gap,
                        f"{name}: a variance {float(over.min())} below fp64 Cholesky less "
                        f"2 x {xla_gap}")
                records[route]["tolerance"] = (
                    "gap to the fp64 LOVE cache <= 2x the fp32 blocked route's; variance >= "
                    "fp64 Cholesky - 2x that gap; B3 launches = nu steps + 1 + rank")
                records[route]["mean_vs_blocked"] = float((mean - xla_mean).abs().max())
            xla_mean = mean
            emit(records[route])
    return records["pallas"]["launches"]["kuu_matvec"]


def solver_family_phases(ctx) -> dict:
    """``setup_solver_family`` / ``solver_family``: ``bench.py``'s dense CG
    system (M = 32768, Matern32 over 8 dimensions at lengthscale 1.2,
    Lambda uniform in [0.05, 0.5], 16 right-hand sides, numpy RandomState
    0) solved through every dense route of ``ConjugateGradient`` at
    relative 1e-6 and 1e-4 (cap 1000): ``xla``, ``pallas`` (B1),
    ``xla_high`` (B1), ``xla_bf16``, ``bf16_ir``, ``bf16_ru`` with the
    standard dot and ``xla`` with the compensated dot, then ``solve_chunked``
    on ``xla``.  Each: steps, converged, the error from the fp64 Cholesky
    solve, ms per solve (the better of two) and per step.  Gates: every
    route but ``xla_bf16`` converges within the stop rule's distance of
    fp64 (``2 sqrt(threshold) |b| / min(Lambda)`` per column); ``xla_bf16``
    finite and its ``converged`` True exactly where the true residual meets
    the rule; B1 launches = steps + 1 on its routes.  ``check_bf16_envelope``
    keeps ``bf16_ir`` here and falls back to ``"xla_high"`` with a warning on
    the cover-tree training system (M = 989, Lambda ~ 2e-4).  B1 alone at R
    = 16 (one step's product) is timed in turns with ``torch.matmul``.
    Returns the B1 launches and those times."""
    import warnings

    from cggp_tpu_torch.ops.cg import ConjugateGradient
    from cggp_tpu_torch.ops.kernels import Matern32
    from cggp_tpu_torch.ops.linalg import add_diagonal
    from cggp_tpu_torch.ops.pallas_matvec import pallas_matvec

    device, card_line = ctx["device"], ctx["card_line"]
    m = SOLVER_FAMILY_M
    with Phase("setup_solver_family", 120) as ph:
        rng = np.random.RandomState(0)
        kern = Matern32()
        kp = kern.init_params(1.0, np.full(8, 1.2), dtype=torch.float32, device=device)
        z = torch.as_tensor(rng.uniform(-2, 2, (m, 8)), dtype=torch.float32, device=device)
        lam = torch.as_tensor(rng.uniform(0.05, 0.5, (m,)), dtype=torch.float32, device=device)
        rhs = torch.as_tensor(rng.standard_normal((SOLVER_FAMILY_RHS, m)), dtype=torch.float32,
                              device=device)
        with torch.no_grad():
            a = add_diagonal(kern.K(kp, z), lam).contiguous()
            a64 = a.double()
            chol, info = torch.linalg.cholesky_ex(a64)
            require(int(info) == 0, "setup_solver_family: the fp64 factorization failed")
            exact = torch.cholesky_solve(rhs.double().T, chol)  # [M, 16] columns
            del chol
        ph.wait()
        b_cols = rhs.T.contiguous()
        b_norm = torch.linalg.vector_norm(rhs.double(), dim=-1)
        lam_min = float(lam.min())  # lambda_min(K + Lambda) >= min(Lambda)
        emit({"phase": "setup_solver_family", "m": m, "rhs": SOLVER_FAMILY_RHS,
              "lambda_min_bound": lam_min, "matrix_gb": 4.0 * m * m / 1e9,
              "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20, "wall_s": ph.elapsed()})
    routes = [("xla", "standard"), ("pallas", "standard"), ("xla_high", "standard"),
              ("xla_bf16", "standard"), ("bf16_ir", "standard"), ("bf16_ru", "standard"),
              ("xla", "compensated")]
    results, b1_launches = [], 0
    with Phase("solver_family", 400) as ph:
        for impl, dot in routes:
            for rel in (1e-6, 1e-4):
                cg = ConjugateGradient(rel, relative_threshold=True, matvec_impl=impl, dot=dot,
                                       max_iterations=SOLVER_FAMILY_CAP)
                require(cg.check_bf16_envelope(a) == impl, f"solver_family: {impl} envelope")
                times = []
                for _ in range(2):
                    pallas_matvec.launches = 0
                    ph.wait()
                    t0 = time.monotonic()
                    sol, stats = cg.solve_with_stats(a, b_cols)
                    ph.wait()
                    times.append(time.monotonic() - t0)
                    launches = pallas_matvec.launches
                steps, converged = int(stats.steps), bool(stats.converged)
                b1_launches += launches
                sol64 = sol.double()
                err = torch.linalg.vector_norm(sol64 - exact, dim=0)
                bound = 2.0 * math.sqrt(rel) * b_norm / lam_min
                true_r = torch.linalg.vector_norm(b_cols.double() - a64 @ sol64, dim=0)
                meets = bool(torch.all(0.5 * true_r ** 2 <= rel * 0.5 * b_norm ** 2))
                require(bool(torch.isfinite(sol).all()), f"solver_family {impl}: non-finite")
                if impl == "xla_bf16":
                    require(converged == meets, f"solver_family xla_bf16 {rel}: converged "
                                                f"{converged}, true residual meets the rule {meets}")
                else:
                    require(converged and steps < SOLVER_FAMILY_CAP,
                            f"solver_family {impl}/{dot} {rel}: steps {steps}, converged "
                            f"{converged}")
                    require(bool(torch.all(err <= bound)),
                            f"solver_family {impl}/{dot} {rel}: error {err.max()} > {bound.min()}")
                want_b1 = steps + 1 if impl in ("pallas", "xla_high") else 0
                require(launches == want_b1, f"solver_family {impl}: B1 launches {launches}, "
                                             f"want {want_b1}")
                ms = min(times) * 1e3
                results.append({"route": impl, "dot": dot, "relative_threshold": rel,
                                "steps": steps, "converged": converged,
                                "true_residual_meets_rule": meets,
                                "max_rel_true_residual": float((true_r / b_norm).max()),
                                "max_err_vs_fp64": float(err.max()),
                                "max_err_over_bound": float((err / bound).max()),
                                "ms_per_solve": ms, "ms_per_step": ms / max(steps, 1),
                                "times_s": times, "b1_launches": launches})
                del sol, sol64
        # B1 alone at this shape (one CG step's product, [16, M] x [M, M]),
        # against torch.matmul and fp64, timed in turns.
        b1_got, b1_lib = pallas_matvec(rhs, a), torch.matmul(rhs, a)
        b1_exact = rhs.double() @ a64
        b1_err = float((b1_got.double() - b1_exact).abs().max())
        lib_err = float((b1_lib.double() - b1_exact).abs().max())
        del b1_exact
        require(b1_err <= 2.0 * lib_err,
                f"solver_family: B1 at R = {SOLVER_FAMILY_RHS} {b1_err} from fp64, "
                f"torch.matmul {lib_err}")
        b1_times = timed_in_turns(ph, {"kernel": lambda: pallas_matvec(rhs, a),
                                       "library": lambda: torch.matmul(rhs, a)},
                                  ["library", "kernel", "kernel", "library"], reps=10)
        b1_bound, b1_bound_by, b1_bound_what, _ = bound_parts(
            4.0 * (2 * SOLVER_FAMILY_RHS * m + m * m), 2.0 * SOLVER_FAMILY_RHS * m * m,
            2.0 * SOLVER_FAMILY_RHS * m * m)
        b1_alone = {"rows": SOLVER_FAMILY_RHS, "m": m,
                    "kernel_ms": float(np.mean(b1_times["kernel"])),
                    "library_ms": float(np.mean(b1_times["library"])), "turns_ms": b1_times,
                    "bound_ms": b1_bound, "bound_by": b1_bound_by, "bound_detail": b1_bound_what,
                    "max_abs_err_vs_fp64": b1_err, "library_max_abs_err_vs_fp64": lib_err}
        # solve_chunked on the plain route.
        cg = ConjugateGradient(1e-6, relative_threshold=True, max_iterations=SOLVER_FAMILY_CAP)
        t0 = time.monotonic()
        sol, stats = cg.solve_chunked(a, b_cols, chunk_iterations=SOLVER_FAMILY_CHUNK,
                                      max_chunks=64)
        ph.wait()
        chunk_s = time.monotonic() - t0
        err = torch.linalg.vector_norm(sol.double() - exact, dim=0)
        bound = 2.0 * math.sqrt(1e-6) * b_norm / lam_min
        require(bool(stats.converged) and bool(torch.all(err <= bound)),
                f"solver_family solve_chunked: converged {bool(stats.converged)}, "
                f"error {float(err.max())}")
        chunked = {"chunk_iterations": SOLVER_FAMILY_CHUNK, "steps_upper_bound": int(stats.steps),
                   "converged": bool(stats.converged), "max_err_vs_fp64": float(err.max()),
                   "s": chunk_s}
        # The envelope: the bench system and the cover-tree training system
        # (M = 989 at init parameters, Lambda 1.8e-4..) lie inside it, as in
        # the JAX package (JAX_ENVELOPE); the JAX package's own out-of-envelope
        # system (tests/test_cg.py's bf16 envelope test: Matern32 over
        # uniform(-2, 2)^2, Lambda = 2e-4) at M = 989 lies outside.
        rng = np.random.default_rng(0)
        zo = torch.as_tensor(rng.uniform(-2, 2, (M_EXPECTED, 2)), dtype=torch.float32,
                             device=device)
        kpo = kern.init_params(1.0, np.ones(2), dtype=torch.float32, device=device)
        outside_system = add_diagonal(kern.K(kpo, zo), torch.full((M_EXPECTED,), 2e-4,
                                                                  device=device))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            verdicts = {name: ConjugateGradient(1e-6, matvec_impl="bf16_ir")
                        .check_bf16_envelope(system)
                        for name, system in (("bench_system", a),
                                             ("training_system", ctx["training_system"]),
                                             ("jax_out_of_envelope_system", outside_system))}
        warned = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
        require(verdicts == {"bench_system": "bf16_ir",
                             "training_system": JAX_ENVELOPE["training_system"],
                             "jax_out_of_envelope_system": "xla_high"} and len(warned) == 1,
                f"solver_family envelope: {verdicts}, warnings {warned}")
        # Measured, not gated: the bf16 loops on the training system (its u at
        # relative 1e-5), which the rule keeps although the bf16 rounding's
        # 2-norm (2.1e-2 on the CPU) exceeds lambda_min (1.7e-2).
        training_bf16 = {}
        for impl in ("bf16_ir", "bf16_ru"):
            cg = ConjugateGradient(1e-5, relative_threshold=True, matvec_impl=impl,
                                   max_iterations=SOLVER_FAMILY_CAP)
            _, st = cg.solve_with_stats(ctx["training_system"], ctx["training_rhs"])
            training_bf16[impl] = {"steps": int(st.steps), "converged": bool(st.converged)}
        xla = {r["relative_threshold"]: r for r in results
               if r["route"] == "xla" and r["dot"] == "standard"}
        for r in results:
            r["ms_per_solve_over_xla"] = r["ms_per_solve"] / xla[r["relative_threshold"]][
                "ms_per_solve"]
        emit({"phase": "solver_family", "m": m, "rhs": SOLVER_FAMILY_RHS,
              "cap": SOLVER_FAMILY_CAP, "routes": results, "solve_chunked_xla": chunked,
              "envelope": {**verdicts, "warning": warned[0] if warned else None,
                           "jax_cpu": JAX_ENVELOPE,
                           "training_system_rel_1e-5": training_bf16},
              "b1_launches": b1_launches, "b1_alone": b1_alone,
              "tolerance": "every route but xla_bf16 converged, error <= 2 sqrt(threshold) "
                           "|b| / min(Lambda) per column; xla_bf16 finite, converged == the "
                           "true residual meets the rule; B1 launches = steps + 1 on pallas "
                           "and xla_high; envelope verdicts as JAX's, one warning (the "
                           "out-of-envelope system -> xla_high); B1 alone at R = 16 within 2x "
                           "torch.matmul's error from fp64",
              "nvidia_smi": card_line, "wall_s": ph.elapsed()})
    del a, a64, exact
    return {"solver_family_launches": b1_launches,
            "solver_family_r16_ms": b1_alone["kernel_ms"],
            "solver_family_r16_library_ms": b1_alone["library_ms"],
            "solver_family_r16_bound_ms": b1_alone["bound_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from cggp_tpu_torch import _build, resolve_device
    from cggp_tpu_torch.data import synthetic
    from cggp_tpu_torch.models.cggp import CGGP
    from cggp_tpu_torch.ops.cg import ConjugateGradient
    from cggp_tpu_torch.ops.kernels import Matern32
    from cggp_tpu_torch.ops.linalg import add_diagonal
    from cggp_tpu_torch.ops.pallas_cg import (pallas_cg_plan, pallas_cg_solve,
                                              pallas_cg_solve_3xtf32_emulated,
                                              pallas_cg_solve_plain, pallas_cg_sync_floor)
    from cggp_tpu_torch.ops.pallas_matvec import (OUTER_STAGES, matmul_3xtf32_emulated,
                                                  pallas_matvec, pallas_matvec_plain)
    from cggp_tpu_torch.training.optimize import adam, make_adam_step, predict_in_batches
    import cggp_tpu_torch.ops.cg as cg_module
    from cggp_tpu_torch.ops.cg import CholPreconditioner
    from cggp_tpu_torch.ops.logdet import rademacher
    from cggp_tpu_torch.models.clustergp import ClusterGP
    from cggp_tpu_torch.models.implicit import ImplicitCGGP
    from cggp_tpu_torch.ops.kernels import kernel_value_from_r2, scaled_squared_distance
    from cggp_tpu_torch.ops.pallas_gram import (gram_matvec, gram_matvec_plain, kuu_matvec,
                                                kuu_matvec_3xtf32_emulated, kuu_matvec_plain)

    selection_path = ROOT / "benchmarks" / "e2e_selection_covertree.npz"
    require(selection_path.is_file(), f"missing {selection_path}")
    implicit_selection_path = ROOT / IMPLICIT_SELECTION
    require(implicit_selection_path.is_file(), f"missing {implicit_selection_path}")

    # -- env ---------------------------------------------------------------
    with Phase("env", 60) as ph:
        device = resolve_device("cuda")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
        card_line = smi.splitlines()[torch.cuda.current_device()]
        sm_clock_mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30,
            check=True).stdout.splitlines()[torch.cuda.current_device()])
        require(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul is on")
        require(torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False,
                "bf16 products may sum in bf16")
        require(torch.get_float32_matmul_precision() == "highest", "fp32 matmul not highest")
        emit({"phase": "env", "nvidia_smi": card_line, "device": torch.cuda.get_device_name(0),
              "device_count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0],
              "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
              "float32_matmul_precision": torch.get_float32_matmul_precision(),
              "max_sm_clock_mhz": sm_clock_mhz, "wall_s": ph.elapsed()})

    # -- build -------------------------------------------------------------
    with Phase("build", 400) as ph:
        lib_path = _build.build()
        _build.load()
        ptxas = ptxas_report(_build.build_log())
        require(len(ptxas) > 0, "no ptxas report in the build log")
        emit({"phase": "build", "library": str(lib_path.relative_to(ROOT)),
              "ptxas": ptxas, "wall_s": ph.elapsed()})

    # -- setup: the serving workload -----------------------------------------
    with Phase("setup", 180) as ph:
        meta = {"n": 435_000, "dim": 3, "seed": 0, "res": 0.35}
        with np.load(selection_path) as sel:
            require(all(float(sel[k]) == v for k, v in meta.items()),
                    f"selection metadata differs from {meta}")
            iv, u, counts = sel["iv"], sel["u"], sel["counts"]
        require(iv.shape == (M_EXPECTED, 3), f"inducing set shape {iv.shape}")
        (x_train, y_train), (x_test, y_test) = synthetic(n=meta["n"], dim=meta["dim"],
                                                    seed=meta["seed"])
        n_train = x_train.shape[0]
        xq = torch.as_tensor(x_test[:NUM_BATCHES * R_BATCH], dtype=torch.float32, device=device)

        def make_model(impl):
            return CGGP(kernel=Matern32(), num_data=n_train,
                        conjugate_gradient=ConjugateGradient(CG_THRESHOLD, matvec_impl=impl))

        params = make_model("xla").init_params(iv, pseudo_u=u, cluster_counts=counts,
                                               dtype=torch.float32, device=device)
        kp, z = params["kernel"], params["inducing_points"]
        lam = make_model("xla").diag_variance(params)[:, 0]
        kmm_lambda = add_diagonal(Matern32().K(kp, z), lam).contiguous()
        kmn_rows = Matern32().K(kp, xq[:R_BATCH], z).contiguous()  # [8192, M] = Kmn^T
        u_row = params["pseudo_u"].T.contiguous()  # [1, M]
        m = kmm_lambda.shape[0]
        emit({"phase": "setup", "n_train": int(n_train), "m": int(m),
              "query_points": int(xq.shape[0]), "wall_s": ph.elapsed()})

    kernels = {}

    # -- B1: pallas_matvec ---------------------------------------------------
    with Phase("B1", 150) as ph:
        gen = torch.Generator(device=device).manual_seed(0)
        g = torch.randn(m, m, generator=gen, device=device)
        a = (g @ g.T) / m + torch.eye(m, device=device)  # symmetric positive definite
        cases = []
        for rows in (1, R_BATCH):
            p = torch.randn(rows, m, generator=gen, device=device)
            got = pallas_matvec(p, a)
            want = pallas_matvec_plain(p, a)
            ph.wait()
            exact = p.double() @ a.double()
            err = float((got - want).abs().max())
            err_fp64 = float((got.double() - exact).abs().max())
            plain_err_fp64 = float((want.double() - exact).abs().max())
            del exact
            # Both are fp32-accurate sums of M products in other orders: the
            # gap is a few ulps of sum |p||a| (worst case M * eps = 6e-5 of it).
            scale = float((p.abs() @ a.abs()).max())
            require(math.isfinite(err) and err <= 1e-5 * scale,
                    f"B1 R={rows}: max abs err {err} > 1e-5 * {scale}")
            # The kernel (3xTF32 above R = 8) is no further from fp64 than
            # twice the IEEE fp32 plain version.
            require(err_fp64 <= 2.0 * plain_err_fp64,
                    f"B1 R={rows}: {err_fp64} from fp64, plain fp32 {plain_err_fp64}")
            # p at one, two and three words into a buffer (rows at every
            # skew from 16-byte alignment): the same arithmetic, so the
            # output must be bitwise equal.
            for offset in (1, 2, 3):
                p_off = torch.empty(rows * m + offset, device=device)[offset:].view(rows, m)
                p_off.copy_(p)
                require(torch.equal(pallas_matvec(p_off, a), got),
                        f"B1 R={rows}: p at a {offset}-word offset changes the output")
                del p_off
            emulation, profiled = {}, None
            if rows > 8:
                k = 256
                emulated = matmul_3xtf32_emulated(p[:k], a, outer_every=OUTER_STAGES)
                emulation = {"max_abs_err_vs_3xtf32_emulation_first_256_rows":
                             float((got[:k] - emulated).abs().max())}
                profiled = kernel_device_ms(ph, lambda: pallas_matvec(p, a))
            times = timed_in_turns(ph, {"plain": lambda: pallas_matvec_plain(p, a),
                                        "kernel": lambda: pallas_matvec(p, a),
                                        "library": lambda: torch.matmul(p, a)},
                                   ["plain", "kernel", "library", "kernel", "library", "plain"],
                                   reps=20)
            graph = {}
            if rows == 1:  # launch-bound: host overhead hides the device time
                graph = {name: graph_ms(ph, fn) for name, fn in (
                    ("kernel", lambda: pallas_matvec(p, a)),
                    ("library", lambda: torch.matmul(p, a)))}
            bound, bound_by, bound_what, parts = bound_parts(
                4.0 * (2 * rows * m + m * m), 2.0 * rows * m * m, 2.0 * rows * m * m)
            case = {"rows": rows, "m": m, "max_abs_err": err, "max_rel_err": err / scale,
                    "max_abs_err_vs_fp64": err_fp64, "plain_max_abs_err_vs_fp64": plain_err_fp64,
                    **emulation,
                    "tolerance": f"max_abs_err <= 1e-5 * max(|p| @ |A|) = {1e-5 * scale:.3g}; "
                                 "vs fp64 <= 2x the plain version's",
                    "kernel_ms": float(np.mean(times["kernel"])),
                    "plain_ms": float(np.mean(times["plain"])),
                    "library_ms": float(np.mean(times["library"])), "turns_ms": times,
                    "graph_ms": graph or None, "profiled_kernel_ms": profiled,
                    "bound_ms": bound, "bound_by": bound_by, "bound_detail": bound_what,
                    "bound_parts_ms": parts,
                    "simt_bound_ms": max(parts["fp32 FMA"], parts["bytes"]),
                    "peak": "fp32 FMA 67 TFLOP/s, TF32 495 TFLOP/s dense, HBM 3.35 TB/s "
                            "(H100 SXM data sheet)"}
            cases.append(case)
        # On data of one sign (the serving system: Kmn rows times Kmm +
        # Lambda) a rounding that leans one way does not average out: the
        # mean signed error relative to fp64, kernel against torch.matmul
        # and against the emulation with its parts truncated (as the tensor
        # cores do) and rounded to nearest.
        exact = kmn_rows.double() @ kmm_lambda.double()
        one_sign = {name: float(((fn(kmn_rows, kmm_lambda).double() - exact) / exact).mean())
                    for name, fn in (
                        ("kernel", pallas_matvec), ("library", torch.matmul),
                        ("3xtf32_emulated_truncated",
                         lambda p, a: matmul_3xtf32_emulated(p, a, truncate=True,
                                                             outer_every=OUTER_STAGES)),
                        ("3xtf32_emulated",
                         lambda p, a: matmul_3xtf32_emulated(p, a, outer_every=OUTER_STAGES)))}
        del exact
        emit({"phase": "B1", "cases": cases,
              "mean_signed_rel_err_on_kernel_values": one_sign,
              "nvidia_smi": card_line, "wall_s": ph.elapsed()})
        big = cases[-1]
        kernels["pallas_matvec"] = {
            "max_abs_err": max(c["max_abs_err"] for c in cases), "ms": big["kernel_ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": big["library_ms"]}

    # -- B2: pallas_cg_solve ---------------------------------------------------
    with Phase("B2", 300) as ph:
        max_it = m
        a64 = kmm_lambda.double()
        b2_ptxas = [k for k in ptxas if "pallas_cg_cu" in k["kernel"]]
        cases = []
        for name, rhs in (("pseudo_u", u_row), ("kmn_batch", kmn_rows)):
            rows = rhs.shape[0]
            plan = pallas_cg_plan(rows, m, device)
            got, steps = pallas_cg_solve(kmm_lambda, rhs, CG_THRESHOLD, max_it)
            again, steps_again = pallas_cg_solve(kmm_lambda, rhs, CG_THRESHOLD, max_it)
            want, steps_plain = pallas_cg_solve_plain(kmm_lambda, rhs, CG_THRESHOLD, max_it)
            emulated, steps_emulated = pallas_cg_solve_3xtf32_emulated(kmm_lambda, rhs,
                                                                       CG_THRESHOLD, max_it)
            ph.wait()
            steps, steps_plain, steps_emulated = int(steps), int(steps_plain), int(steps_emulated)
            bitwise = bool(torch.equal(got, again)) and int(steps_again) == steps
            exact = torch.linalg.solve(a64, rhs.double().T).T
            scale = float(exact.abs().max())
            err = float((got - want).abs().max())
            err_emulated = float((got - emulated).abs().max())
            err_exact = float((got.double() - exact).abs().max())
            err_exact_plain = float((want.double() - exact).abs().max())
            del exact, again, emulated
            # fp32 CG runs whose sums differ in order drift apart before they
            # converge; at this threshold JAX's fp32 CG on the CPU sat within
            # 2e-4 (relative to max |v|) of the exact solve, so both are held
            # to 10x that, and the step counts to a few percent of the plain
            # loop's and of the JAX package's own (JAX_CG_STEPS).
            tol = 2e-3 * scale
            jax_steps = JAX_CG_STEPS[name]
            require(steps < max_it, f"B2 {name}: no convergence in {max_it} steps")
            for label, ref in (("plain", steps_plain), ("JAX", jax_steps)):
                require(abs(steps - ref) <= max(3, 0.05 * ref),
                        f"B2 {name}: steps {steps} vs {label} {ref}")
            require(err <= tol and err_exact <= tol,
                    f"B2 {name}: err {err}, vs exact {err_exact}, tolerance {tol}")
            # The kernel is no further from the fp64 solve than twice the
            # IEEE fp32 plain loop, as B1 and B3 are held to fp64.
            require(err_exact <= 2.0 * err_exact_plain,
                    f"B2 {name}: {err_exact} from fp64, plain fp32 {err_exact_plain}")
            require(bitwise, f"B2 {name}: two runs of the same solve differ")
            times = timed_in_turns(
                ph, {"plain": lambda: pallas_cg_solve_plain(kmm_lambda, rhs, CG_THRESHOLD, max_it),
                     "kernel": lambda: pallas_cg_solve(kmm_lambda, rhs, CG_THRESHOLD, max_it)},
                ["plain", "kernel", "kernel", "plain"], reps=3)
            kernel_ms = float(np.mean(times["kernel"]))
            plain_ms = float(np.mean(times["plain"]))
            # Two grid.sync()s a step and one before the first.
            syncs = 2 * steps + 1
            sync_floor_ms = event_ms(ph, lambda: pallas_cg_sync_floor(plan, syncs, device),
                                     reps=5)
            profiled = kernel_device_ms(ph, lambda: pallas_cg_solve(kmm_lambda, rhs,
                                                                    CG_THRESHOLD, max_it),
                                        calls=3)
            split_ms = sum(v for k, v in profiled.items() if "split_b_kernel" in k)
            solve_ms = sum(v for k, v in profiled.items() if "cg_" in k and "kernel" in k)
            (bound, bound_by, bound_what, parts), per_step_bytes = b2_bound(rows, m, steps, plan)
            cases.append({"rhs": name, "rows": rows, "m": m, "plan": plan, "steps": steps,
                          "steps_plain": steps_plain, "steps_jax_cpu": jax_steps,
                          "steps_3xtf32_emulated": steps_emulated, "max_abs_err": err,
                          "max_abs_err_vs_3xtf32_emulation": err_emulated,
                          "max_abs_err_vs_fp64_solve": err_exact,
                          "plain_max_abs_err_vs_fp64_solve": err_exact_plain,
                          "bitwise_equal_repeat": bitwise,
                          "tolerance": f"max_abs_err <= 2e-3 * max|v| = {tol:.3g}; vs fp64 <= "
                                       "2x the plain version's; steps within max(3, 5 %) of "
                                       "the plain loop's and JAX's",
                          "kernel_ms": kernel_ms, "plain_ms": plain_ms, "turns_ms": times,
                          "per_step_ms": kernel_ms / max(steps, 1),
                          "sync_floor_ms": sync_floor_ms, "syncs": syncs,
                          "profiled_kernel_ms": profiled,
                          "split_share": split_ms / (split_ms + solve_ms) if solve_ms else None,
                          "bytes_per_step": per_step_bytes,
                          "bound_ms": bound, "bound_by": bound_by, "bound_detail": bound_what,
                          "bound_parts_ms": parts,
                          "simt_bound_ms": max(parts["fp32 FMA"], parts["bytes"]),
                          "per_step_bound_ms": bound / max(steps, 1),
                          "peak": "fp32 FMA 67 TFLOP/s, TF32 495 TFLOP/s dense, HBM 3.35 TB/s "
                                  "(H100 SXM data sheet)"})
        # The design's targets: the tiled path beats the plain loop, the
        # small-R path the earlier SIMT kernel.
        require(cases[1]["kernel_ms"] < cases[1]["plain_ms"],
                f"B2 R={R_BATCH}: {cases[1]['kernel_ms']} ms, plain {cases[1]['plain_ms']} ms")
        require(cases[0]["kernel_ms"] < B2_R1_BEFORE_MS,
                f"B2 R=1: {cases[0]['kernel_ms']} ms, the SIMT kernel {B2_R1_BEFORE_MS} ms")
        emit({"phase": "B2", "cases": cases, "library_ms": None,
              "library_note": "no single PyTorch call computes a CG solve",
              "ptxas": b2_ptxas, "b1_kernel_ms_r8192": kernels["pallas_matvec"]["ms"],
              "nvidia_smi": card_line, "wall_s": ph.elapsed()})
        big = cases[-1]
        kernels["pallas_cg_solve"] = {
            "max_abs_err": max(c["max_abs_err"] for c in cases), "ms": big["kernel_ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": None}

    # -- serving, through each kernel ------------------------------------------
    with Phase("reference", 240) as ph:
        chol_mean, chol_var = predict_in_batches(make_model("xla"), params, xq,
                                                 batch_size=R_BATCH, posterior_solver="chol")
        xla_mean, xla_var = predict_in_batches(make_model("xla"), params, xq,
                                               batch_size=R_BATCH, posterior_solver="cg")
        ph.wait()
        for name, t in (("chol_mean", chol_mean), ("chol_var", chol_var),
                        ("xla_mean", xla_mean), ("xla_var", xla_var)):
            require(bool(torch.isfinite(t).all()), f"{name} is not finite")
        emit({"phase": "reference", "xla_vs_chol_mean": float((xla_mean - chol_mean).abs().max()),
              "xla_vs_chol_var": float((xla_var - chol_var).abs().max()),
              "wall_s": ph.elapsed()})

    counters = {"pallas_resident": pallas_cg_solve, "pallas": pallas_matvec}
    served = {}
    for impl, counted in counters.items():
        with Phase(f"serve_{impl}", 300) as ph:
            model = make_model(impl)
            predict_in_batches(model, params, xq[:R_BATCH], batch_size=R_BATCH,
                               posterior_solver="cg")  # warm-up, not counted
            ph.wait()
            pallas_cg_solve.launches = 0
            pallas_matvec.launches = 0
            t0 = time.monotonic()
            post = model.posterior(params, solver="cg")
            ph.wait()
            t1 = time.monotonic()
            mean, var = predict_in_batches(model, params, xq, batch_size=R_BATCH,
                                           posterior_solver="cg", posterior=post)
            ph.wait()
            t2 = time.monotonic()
            launches = {"pallas_cg_solve": pallas_cg_solve.launches,
                        "pallas_matvec": pallas_matvec.launches}
            solves = 1 + NUM_BATCHES
            if impl == "pallas_resident":
                require(launches == {"pallas_cg_solve": solves, "pallas_matvec": 0},
                        f"resident route launches {launches}, want {solves} B2 solves")
            else:
                require(launches["pallas_matvec"] > 0 and launches["pallas_cg_solve"] == 0,
                        f"pallas route launches {launches}")
            kernels[counted.__name__]["launches"] = launches[counted.__name__]
            # Steps of each solve, re-run outside the counted window.
            steps, converged = [], []
            _, nu_stats = model.conjugate_gradient.solve_with_stats(post.kmm_lambda,
                                                                    params["pseudo_u"])
            for b in range(NUM_BATCHES):
                kmn = model.kernel.K(kp, z, xq[b * R_BATCH:(b + 1) * R_BATCH])
                _, st = model.conjugate_gradient.solve_with_stats(post.kmm_lambda, kmn)
                steps.append(int(st.steps))
                converged.append(bool(st.converged))
            require(all(converged) and bool(nu_stats.converged), "a serving solve did not converge")
            require(mean.shape == (xq.shape[0], 1) and var.shape == (xq.shape[0], 1),
                    f"output shapes {tuple(mean.shape)} {tuple(var.shape)}")
            require(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
                    "non-finite serving output")
            require(bool((var >= 0).all()), "negative predictive variance")
            gaps = {"mean_vs_chol": float((mean - chol_mean).abs().max()),
                    "var_vs_chol": float((var - chol_var).abs().max()),
                    "mean_vs_xla": float((mean - xla_mean).abs().max()),
                    "var_vs_xla": float((var - xla_var).abs().max())}
            require(all(v <= SERVE_ATOL for v in gaps.values()),
                    f"serving outputs differ beyond {SERVE_ATOL}: {gaps}")
            served[impl] = (mean, var)
            emit({"phase": f"serve_{impl}", "launches": launches, "solves": solves,
                  "points": int(xq.shape[0]), "batch_size": R_BATCH,
                  "posterior_build_s": t1 - t0, "serve_s": t2 - t1,
                  "points_per_s": xq.shape[0] / (t2 - t1),
                  "cg_steps_nu": int(nu_stats.steps), "cg_steps_per_batch": steps,
                  "tolerance": f"max abs gap <= {SERVE_ATOL}", **gaps,
                  "var_min": float(var.min()), "wall_s": ph.elapsed()})
    route_gap = max(float((served["pallas"][i] - served["pallas_resident"][i]).abs().max())
                    for i in (0, 1))
    require(route_gap <= SERVE_ATOL, f"the two kernel routes differ by {route_gap}")
    serve_love_dense({"card_line": card_line, "params": params, "xq": xq,
                      "make_model": make_model, "xla": (xla_mean, xla_var)})
    baseline_phases({"device": device, "card_line": card_line, "kernels": kernels,
                     "data": (x_train, y_train, x_test, y_test), "selection": (iv, u, counts),
                     "params": params, "xq": xq})

    # -- training: the dense CGGP training step through each route -------------
    m = params["inducing_points"].shape[0]
    train_rows = 1 + 2 * TRAIN_PROBES + TRAIN_BATCH  # [u | probes | logdet probes | Kmn]
    with Phase("setup_train", 120) as ph:
        cpu_gen = torch.Generator().manual_seed(TRAIN_BATCH_SEED)
        batch_index = torch.stack([torch.randperm(n_train, generator=cpu_gen)[:TRAIN_BATCH]
                                   for _ in range(1 + TRAIN_WARMUP + TRAIN_STEPS)])
        xt = torch.as_tensor(x_train, dtype=torch.float32, device=device)
        yt = torch.as_tensor(y_train, dtype=torch.float32, device=device)
        index_dev = batch_index.to(device)
        # Batch 0 is the first step's (checked against fp64 and JAX); the
        # training window runs on the batches after it.
        batches = [(xt[i], yt[i]) for i in index_dev]
        batch0_64 = tuple(t.double() for t in batches[0])
        params64 = {k: ({kk: vv.double() for kk, vv in v.items()} if isinstance(v, dict)
                        else v.double()) for k, v in params.items()}

        def train_model(impl, config):
            if config == "chol":
                cg = ConjugateGradient(TRAIN_CHOL_THRESHOLD, relative_threshold=True,
                                       matvec_impl=impl)
            else:
                cg = ConjugateGradient(CG_THRESHOLD, matvec_impl=impl)
            return CGGP(kernel=Matern32(), conjugate_gradient=cg, num_data=n_train,
                        num_probes=TRAIN_PROBES,
                        precondition="chol" if config == "chol" else None)

        def probe_gen():
            return torch.Generator(device=device).manual_seed(TRAIN_PROBE_SEED)

        # The first step's probes as the fused ELBO draws them (trace probes,
        # then logdet probes), kept with the batch for the JAX reference run.
        gen = probe_gen()
        step0_probes = np.stack([rademacher(gen, (m, TRAIN_PROBES), torch.float32).cpu().numpy()
                                 for _ in range(2)])
        probes_sha256 = hashlib.sha256(step0_probes.tobytes()).hexdigest()
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        np.savez(out_dir / "train_step0.npz", probes=step0_probes,
                 batch_index=batch_index[0].numpy())
        emit({"phase": "setup_train", "m": int(m), "rows": train_rows, "batch": TRAIN_BATCH,
              "steps": TRAIN_STEPS, "warmup": TRAIN_WARMUP, "lr": TRAIN_LR,
              "probes_sha256": probes_sha256,
              "batch_index_sha256": hashlib.sha256(batch_index[0].numpy().tobytes()).hexdigest(),
              "wall_s": ph.elapsed()})

    # The first step in float64 ("xla", same configuration, same batch and
    # probes) and in float32 on the plain "xla" loop: the yardstick of each
    # kernel route's gap.
    with Phase("reference_train", 300) as ph:
        refs = {}
        for config in ("plain", "chol"):
            loss64, grads64 = loss_and_grads(train_model("xla", config), params64, batch0_64,
                                             probe_gen())
            loss32, grads32 = loss_and_grads(train_model("xla", config), params, batches[0],
                                             probe_gen())
            ph.wait()
            refs[config] = {"loss64": loss64, "grads64": grads64,
                            "xla_gap": relative_gaps(loss32, grads32, loss64, grads64)}
        emit({"phase": "reference_train",
              "fp64": {c: {"loss": float(r["loss64"]),
                           **{f"|d {n}|": float(torch.linalg.vector_norm(r["grads64"][n]))
                              for n in TRAINABLE}} for c, r in refs.items()},
              "xla_fp32_gap": {c: r["xla_gap"] for c, r in refs.items()},
              "wall_s": ph.elapsed()})

    trained = {}

    def train_phase(name, impl, config, budget_s, extra=None):
        """One training route: the first step against fp64, 3 warm-up steps,
        then TRAIN_STEPS timed steps with the launch counts set to 0 just
        before and read just after; ``extra(ph, record)`` adds to the record
        inside the phase."""
        with Phase(name, budget_s) as ph:
            model = train_model(impl, config)
            solves, undo = record_dense_solves(cg_module)
            try:
                loss0, grads0 = loss_and_grads(model, params, batches[0], probe_gen())
                step0 = [(int(s["stats"].steps), bool(s["stats"].converged)) for s in solves]
                solves.clear()
                step = make_adam_step(model.training_loss, adam(TRAIN_LR),
                                      model.trainable_mask(params))
                p, opt = params, adam(TRAIN_LR).init(params)
                gen = probe_gen()
                for batch in batches[1:1 + TRAIN_WARMUP]:
                    p, opt, _ = step(p, opt, batch, gen)
                ph.wait()
                solves.clear()
                for counted in (pallas_cg_solve, pallas_matvec, gram_matvec, kuu_matvec):
                    counted.launches = 0
                t0 = time.monotonic()
                losses = []
                for batch in batches[1 + TRAIN_WARMUP:]:
                    p, opt, loss = step(p, opt, batch, gen)
                    losses.append(loss)
                ph.wait()
                window_s = time.monotonic() - t0
                launches = {counted.__name__: counted.launches for counted in
                            (pallas_cg_solve, pallas_matvec, gram_matvec, kuu_matvec)}
            finally:
                undo()
            # Everything below reads the window's results after it.
            steps_run = len(losses)
            require(steps_run == TRAIN_STEPS, f"{name}: {steps_run} steps, want {TRAIN_STEPS}")
            require(len(solves) == 2 * steps_run,
                    f"{name}: {len(solves)} CG solves, want a forward and a backward a step")
            fwd = [(int(s["stats"].steps), bool(s["stats"].converged)) for s in solves[0::2]]
            bwd = [(int(s["stats"].steps), bool(s["stats"].converged)) for s in solves[1::2]]
            require(all(int(s["rhs"].shape[0]) == train_rows for s in solves),
                    f"{name}: a solve's block is not [{train_rows}, {m}]")
            # B3 is off the dense path (it carries the matrix-free phases).
            want = {"pallas_cg_solve": 0, "pallas_matvec": 0, "gram_matvec": 0, "kuu_matvec": 0}
            if impl == "pallas_resident":
                want["pallas_cg_solve"] = 2 * steps_run
            elif impl == "pallas":
                # every matvec: the initial residual and one a step, both passes
                want["pallas_matvec"] = sum(k + 1 for k, _ in fwd + bwd)
            require(launches == want, f"{name}: launches {launches}, want {want}")
            losses = [float(v) for v in losses]
            require(all(math.isfinite(v) for v in losses), f"{name}: non-finite loss {losses}")
            leaves = [v for sub in p.values() for v in (sub.values() if isinstance(sub, dict)
                                                        else [sub])]
            require(all(bool(torch.isfinite(v).all()) for v in leaves),
                    f"{name}: non-finite parameters after training")
            gaps = relative_gaps(loss0, grads0, refs[config]["loss64"], refs[config]["grads64"])
            xla_gap = refs[config]["xla_gap"]
            gap_over_xla = {k: (gaps[k] / xla_gap[k] if xla_gap[k] > 0
                                else 0.0 if gaps[k] == 0 else math.inf) for k in gaps}
            if impl != "xla":
                # The rule of every kernel phase: no further from float64
                # than twice the float32 plain route, for the loss and for
                # each gradient on its own.
                require(all(math.isfinite(v) and v <= 2.0 for v in gap_over_xla.values()),
                        f"{name}: first step {gaps} from fp64, xla fp32 {xla_gap}")
            record = {"phase": name, "matvec_impl": impl, "config": config,
                      "steps": steps_run, "window_s": window_s,
                      "steps_per_s": steps_run / window_s,
                      "ms_per_step": window_s * 1e3 / steps_run, "launches": launches,
                      "cg_steps_forward": [k for k, _ in fwd],
                      "cg_steps_backward": [k for k, _ in bwd],
                      "converged_forward": [c for _, c in fwd],
                      "converged_backward": [c for _, c in bwd],
                      "loss_first": losses[0], "loss_last": losses[-1],
                      "step0": {"loss": float(loss0),
                                **{f"|d {n}|": float(torch.linalg.vector_norm(grads0[n]))
                                   for n in TRAINABLE},
                                "cg_steps": [k for k, _ in step0],
                                "converged": [c for _, c in step0],
                                "gap_vs_fp64": gaps, "xla_fp32_gap_vs_fp64": xla_gap,
                                "gap_over_xla_fp32_gap": gap_over_xla},
                      "tolerance": "first-step loss and each gradient: the relative gap "
                                   "from fp64 at most 2x the fp32 xla route's",
                      "nvidia_smi": card_line}
            trained[name] = {"record": record, "solves": solves, "step0": step0,
                             "launches": launches, "steps": steps_run}
            if extra is not None:
                extra(ph, record)
            record["wall_s"] = ph.elapsed()
            emit(record)

    def b2_at_training_shape(ph, record):
        # B2 at the training shape: the first timed step's forward block and
        # its backward block (the cotangents: rows of mixed scale, the logdet
        # probes' rows zero), against the plain loop and the fp64 solve.
        cases = []
        for label, rec in zip(("forward", "backward"),
                              trained["train_pallas_resident"]["solves"][:2]):
            a32 = rec["matrix"].float().contiguous()
            rhs32 = rec["rhs"].float().contiguous()
            rows = rhs32.shape[0]
            plan = pallas_cg_plan(rows, m, device)
            got, steps = pallas_cg_solve(a32, rhs32, CG_THRESHOLD, m)
            want, steps_plain = pallas_cg_solve_plain(a32, rhs32, CG_THRESHOLD, m)
            ph.wait()
            steps, steps_plain = int(steps), int(steps_plain)
            exact = torch.linalg.solve(a32.double(), rhs32.double().T).T
            err_exact = float((got.double() - exact).abs().max())
            err_exact_plain = float((want.double() - exact).abs().max())
            err = float((got - want).abs().max())
            row_norms = torch.linalg.vector_norm(rhs32, dim=1)
            zero_rows = int((row_norms == 0).sum())
            del exact
            require(err_exact <= 2.0 * err_exact_plain,
                    f"B2 training {label}: {err_exact} from fp64, plain fp32 {err_exact_plain}")
            require(abs(steps - steps_plain) <= max(3, 0.05 * steps_plain),
                    f"B2 training {label}: steps {steps} vs plain {steps_plain}")
            require(bool(torch.all(got[row_norms == 0] == 0)),
                    f"B2 training {label}: a zero row's solution is not zero")
            times = timed_in_turns(
                ph, {"plain": lambda: pallas_cg_solve_plain(a32, rhs32, CG_THRESHOLD, m),
                     "kernel": lambda: pallas_cg_solve(a32, rhs32, CG_THRESHOLD, m)},
                ["plain", "kernel", "kernel", "plain"], reps=1)
            (bound, bound_by, bound_what, parts), _ = b2_bound(rows, m, steps, plan)
            cases.append({"solve": label, "rows": rows, "m": m, "plan": plan, "steps": steps,
                          "steps_plain": steps_plain, "zero_rows": zero_rows,
                          "row_norm_max_over_min_nonzero": float(
                              row_norms.max() / row_norms[row_norms > 0].min()),
                          "max_abs_err": err, "max_abs_err_vs_fp64_solve": err_exact,
                          "plain_max_abs_err_vs_fp64_solve": err_exact_plain,
                          "kernel_ms": float(np.mean(times["kernel"])),
                          "plain_ms": float(np.mean(times["plain"])), "turns_ms": times,
                          "bound_ms": bound, "bound_by": bound_by, "bound_detail": bound_what,
                          "bound_parts_ms": parts})
        b2_ms = sum(c["kernel_ms"] for c in cases)
        record.update({"b2_at_training_shape": cases, "b2_ms_per_step": b2_ms,
                       "b2_share_of_step": b2_ms / record["ms_per_step"]})
        kernels["pallas_cg_solve"].update({
            "train_launches": record["launches"]["pallas_cg_solve"],
            "train_steps": record["steps"], "train_ms": cases[0]["kernel_ms"],
            "train_backward_ms": cases[1]["kernel_ms"], "train_bound_ms": cases[0]["bound_ms"],
            "train_backward_bound_ms": cases[1]["bound_ms"]})

    def b1_at_training_shape(ph, record):
        rec = trained["train_pallas_chol"]["solves"][0]
        a32 = rec["matrix"].float().contiguous()
        p = rec["rhs"].float().contiguous()  # a [2059, 989] block of the path's shape
        rows = p.shape[0]
        got = pallas_matvec(p, a32)
        want = pallas_matvec_plain(p, a32)
        ph.wait()
        exact = p.double() @ a32.double()
        err_fp64 = float((got.double() - exact).abs().max())
        plain_err_fp64 = float((want.double() - exact).abs().max())
        del exact
        require(err_fp64 <= 2.0 * plain_err_fp64,
                f"B1 training shape: {err_fp64} from fp64, plain fp32 {plain_err_fp64}")
        times = timed_in_turns(ph, {"plain": lambda: pallas_matvec_plain(p, a32),
                                    "kernel": lambda: pallas_matvec(p, a32),
                                    "library": lambda: torch.matmul(p, a32)},
                               ["plain", "kernel", "library", "kernel", "library", "plain"],
                               reps=20)
        b1_ms = float(np.mean(times["kernel"]))
        bound, bound_by, bound_what, parts = bound_parts(
            4.0 * (2 * rows * m + m * m), 2.0 * rows * m * m, 2.0 * rows * m * m)
        lam0 = torch.zeros(m, device=device)
        chol_build_ms = event_ms(ph, lambda: CholPreconditioner(a32, lam0), reps=5)
        solves = trained["train_pallas_chol"]["solves"]
        refinement = [int(s["stats"].steps) for s in solves]
        launches_per_step = record["launches"]["pallas_matvec"] / record["steps"]
        step_ms = record["ms_per_step"]
        record.update({"refinement_iterations": refinement,
                       "b1_at_training_shape": {
                           "rows": rows, "m": m, "max_abs_err_vs_fp64": err_fp64,
                           "plain_max_abs_err_vs_fp64": plain_err_fp64,
                           "kernel_ms": b1_ms, "plain_ms": float(np.mean(times["plain"])),
                           "library_ms": float(np.mean(times["library"])), "turns_ms": times,
                           "bound_ms": bound, "bound_by": bound_by, "bound_detail": bound_what,
                           "bound_parts_ms": parts},
                       "b1_launches_per_step": launches_per_step,
                       "b1_ms_per_step": launches_per_step * b1_ms,
                       "b1_share_of_step": launches_per_step * b1_ms / step_ms,
                       "chol_build_ms": chol_build_ms,
                       "chol_build_share_of_step": chol_build_ms / step_ms})
        kernels["pallas_matvec"].update({
            "train_launches": record["launches"]["pallas_matvec"], "train_steps": record["steps"],
            "train_ms": b1_ms, "train_bound_ms": bound})

    # B2 for the whole forward and backward solve of every step; B1 for every
    # matvec of the exact-factor refinement, both passes; the plain "xla"
    # loop in the resident route's configuration, the yardstick.
    train_phase("train_pallas_resident", "pallas_resident", "plain", 300, b2_at_training_shape)
    train_phase("train_pallas_chol", "pallas", "chol", 240, b1_at_training_shape)
    train_phase("train_xla", "xla", "plain", 300)

    # The JAX package's first step (JAX_TRAIN_STEP0): B2's forward and
    # backward steps within max(3, 5 %) of JAX's on the same batch and probes.
    with Phase("check_train_jax", 30):
        require(JAX_TRAIN_STEP0 is not None, "no JAX reference for the first training step")
        require(probes_sha256 == JAX_TRAIN_STEP0["probes_sha256"],
                "the first step's probes are not those JAX's values were taken with")
        step0 = trained["train_pallas_resident"]["step0"]
        for (got, _), ref, label in zip(step0, JAX_TRAIN_STEP0["cg_steps"],
                                        ("forward", "backward")):
            require(abs(got - ref) <= max(3, 0.05 * ref),
                    f"train_pallas_resident: first-step {label} steps {got} vs JAX {ref}")
        port = trained["train_pallas_resident"]["record"]["step0"]
        emit({"phase": "check_train_jax", "jax_cpu_fp32": JAX_TRAIN_STEP0,
              "port_b2": {k: port[k] for k in ("loss", "cg_steps", "converged",
                                               *(f"|d {n}|" for n in TRAINABLE))},
              "tolerance": "B2's first-step forward and backward steps within max(3, 5 %) "
                           "of JAX's"})
    e2e_phases({"device": device, "card_line": card_line, "params": params,
                "train_model": train_model, "data": (xt, yt),
                "test_data": (x_test, y_test), "selection_path": selection_path,
                "kernels": kernels})

    # B3 is off the dense training path (the matrix-free model trains in its
    # own phases): its launches read in the three dense windows, all steps.
    b3_train = {"train_launches": sum(t["launches"]["gram_matvec"] + t["launches"]["kuu_matvec"]
                                      for t in trained.values()),
                "train_steps": sum(t["steps"] for t in trained.values())}
    del trained, batches, xt, yt

    # -- setup_implicit: the matrix-free workload ------------------------------
    with Phase("setup_implicit", 120) as ph:
        meta = {"n": 435_000, "dim": 3, "seed": 0, "res": 0.15}
        with np.load(implicit_selection_path) as sel:
            require(all(float(sel[k]) == v for k, v in meta.items()),
                    f"implicit selection metadata differs from {meta}")
            iv, u, counts = sel["iv"], sel["u"], sel["counts"]
        require(iv.shape == (IMPLICIT_M, 3), f"implicit inducing set shape {iv.shape}")

        def make_implicit(use_pallas, threshold=IMPLICIT_THRESHOLD, max_cg=IMPLICIT_MAX_CG):
            return ImplicitCGGP(kernel=Matern32(), num_data=n_train, block=IMPLICIT_BLOCK,
                                precondition="pivchol", precond_rank=128,
                                relative_threshold=True, error_threshold=threshold,
                                max_cg_iterations=max_cg, num_probes=TRAIN_PROBES,
                                use_pallas=use_pallas)

        iparams = make_implicit(True).init_params(iv, pseudo_u=u, cluster_counts=counts,
                                                  dtype=torch.float32, device=device)
        imask = iparams["inducing_mask"][:, 0]
        num_pads = int((imask == 0).sum())
        m_pad = iparams["inducing_points"].shape[0]
        require(m_pad == IMPLICIT_M_PAD and num_pads == IMPLICIT_M_PAD - IMPLICIT_M,
                f"padded M {m_pad} with {num_pads} pads")
        ixq = xq[:IMPLICIT_BATCHES * R_BATCH]
        ikp = iparams["kernel"]
        iz_scaled = (iparams["inducing_points"] / Matern32().lengthscales(ikp)).contiguous()
        ilam = make_implicit(True).diag_variance(iparams)[:, 0].contiguous()
        ivar = Matern32().variance(ikp).reshape(1).contiguous()
        emit({"phase": "setup_implicit", "m": IMPLICIT_M, "m_pad": m_pad, "pads": num_pads,
              "block": IMPLICIT_BLOCK, "query_points": int(ixq.shape[0]),
              "wall_s": ph.elapsed()})

    # -- B3: gram_matvec / kuu_matvec ------------------------------------------
    with Phase("B3", 240) as ph:
        gen = torch.Generator(device=device).manual_seed(1)
        cases = []

        def b3_case(label, fn, plain, plain_abs, shape, kernel_name, nbytes, reps, loader,
                    exact=None, emulated=None, gate_fp64=False):
            got = fn()
            want = plain()
            ph.wait()
            require(bool(torch.isfinite(got).all()), f"B3 {label}: non-finite output")
            err = float((got - want).abs().max())
            # Both are fp32-accurate sums of M nonnegative kernel values times
            # B in other orders: the gap is a few ulps of sum |B| K
            # (random-walk estimate sqrt(M) eps = 1.2e-5 of it at M = 10240).
            scale = float(plain_abs().max())
            tol = 5e-5 * scale
            require(err <= tol, f"B3 {label}: max abs err {err} > {tol}")
            accuracy = {}
            if exact is not None:
                reference = exact()
                err_fp64 = float((got.double() - reference).abs().max())
                plain_err_fp64 = float((want.double() - reference).abs().max())
                del reference
                accuracy = {"max_abs_err_vs_fp64": err_fp64,
                            "plain_max_abs_err_vs_fp64": plain_err_fp64}
                if gate_fp64:
                    require(err_fp64 <= 2.0 * plain_err_fp64,
                            f"B3 {label}: {err_fp64} from fp64, plain fp32 {plain_err_fp64}")
            if emulated is not None:
                rows_emulated, emulated_out = emulated()
                accuracy["max_abs_err_vs_3xtf32_emulation"] = float(
                    (got[:rows_emulated] - emulated_out).abs().max())
            times = timed_in_turns(ph, {"plain": plain, "kernel": fn},
                                   ["plain", "kernel", "kernel", "plain"], reps=reps)
            n, m, d, r = shape
            graph = {"kernel": graph_ms(ph, fn)} if r == 1 else None
            bound, bound_by, bound_what, parts = gram_bound(
                n, m, d, r, kernel_name, sm_clock_mhz * 1e6, nbytes)
            case = {"case": label, "kernel": kernel_name, "n": n, "m": m, "d": d, "r": r,
                    "b_loader": loader, "max_abs_err": err, "max_rel_err": err / scale, **accuracy,
                    "tolerance": f"max_abs_err <= 5e-5 * max(|B| K) = {tol:.3g}"
                                 + ("; vs fp64 <= 2x the plain version's" if gate_fp64 else ""),
                    "kernel_ms": float(np.mean(times["kernel"])),
                    "plain_ms": float(np.mean(times["plain"])), "turns_ms": times,
                    "graph_ms": graph, "bound_ms": bound, "bound_by": bound_by,
                    "bound_detail": bound_what, "bound_parts_ms": parts,
                    "simt_bound_ms": max(parts["fp32 FMA"], parts["special functions"],
                                         parts["bytes"]),
                    "library_ms": None}
            cases.append(case)
            return case

        m = IMPLICIT_M_PAD
        z64 = iz_scaled.double()
        b_loader = None
        for rows in (1, R_BATCH):
            # The path's operand: p * mask (pad columns zero), pads in place.
            p = (torch.randn(rows, m, generator=gen, device=device) * imask).contiguous()
            p_abs = p.abs()

            def kuu_exact(p=p):
                # The same function in fp64 from the same fp32 inputs.
                k64 = kernel_value_from_r2("matern32", scaled_squared_distance(z64, z64),
                                           ivar.double().reshape(()))
                return p.double() @ k64 + p.double() * ilam.double()

            def kuu_emulated(p=p):
                return 256, kuu_matvec_3xtf32_emulated(iz_scaled, ilam, p[:256], ivar,
                                                       "matern32")

            b3_case(f"kuu_matvec R={rows}",
                    lambda: kuu_matvec(iz_scaled, ilam, p, ivar, "matern32"),
                    lambda: kuu_matvec_plain(iz_scaled, ilam, p, ivar, "matern32"),
                    lambda: kuu_matvec_plain(iz_scaled, ilam, p_abs, ivar, "matern32"),
                    (m, m, 3, rows), "matern32", 4.0 * (m * 3 + m + 1 + 2 * rows * m),
                    reps=3 if rows > 1 else 20, loader=b3_loader(p, rows, m, 1), exact=kuu_exact,
                    emulated=kuu_emulated if rows > 8 else None, gate_fp64=rows > 8)
            if rows > 8:
                # The same p one word into a buffer: its rows are no longer
                # 16-byte aligned, so the tiled launch copies its B tiles by
                # cp.async instead of TMA.  The arithmetic is the same, so the
                # output must be bitwise equal; the two loaders are timed in
                # turns.
                p_off = torch.empty(rows * m + 1, device=device)[1:].view(rows, m)
                p_off.copy_(p)
                same = torch.equal(kuu_matvec(iz_scaled, ilam, p, ivar, "matern32"),
                                   kuu_matvec(iz_scaled, ilam, p_off, ivar, "matern32"))
                require(same, f"B3 kuu_matvec R={rows}: an offset view of p changes the output")
                times = timed_in_turns(
                    ph, {"aligned": lambda: kuu_matvec(iz_scaled, ilam, p, ivar, "matern32"),
                         "offset": lambda: kuu_matvec(iz_scaled, ilam, p_off, ivar, "matern32")},
                    ["aligned", "offset", "offset", "aligned"], reps=3)
                b_loader = {"rows": rows, "aligned_ms": float(np.mean(times["aligned"])),
                            "offset_ms": float(np.mean(times["offset"])), "turns_ms": times,
                            "bitwise_equal": same, "aligned": b3_loader(p, rows, m, 1),
                            "offset": b3_loader(p_off, rows, m, 1)}
                del p_off
        # The matrix-free training shape: a step's fused block of 2059 rows.
        p = (torch.randn(IMPLICIT_TRAIN_ROWS, m, generator=gen, device=device)
             * imask).contiguous()
        p_abs = p.abs()
        train_case = b3_case(
            f"kuu_matvec R={IMPLICIT_TRAIN_ROWS} (training)",
            lambda: kuu_matvec(iz_scaled, ilam, p, ivar, "matern32"),
            lambda: kuu_matvec_plain(iz_scaled, ilam, p, ivar, "matern32"),
            lambda: kuu_matvec_plain(iz_scaled, ilam, p_abs, ivar, "matern32"),
            (m, m, 3, IMPLICIT_TRAIN_ROWS), "matern32",
            4.0 * (m * 3 + m + 1 + 2 * IMPLICIT_TRAIN_ROWS * m), reps=5,
            loader=b3_loader(p, IMPLICIT_TRAIN_ROWS, m, 1),
            exact=lambda p=p: kuu_exact(p), gate_fp64=True)
        del p, p_abs
        xg = xq[:R_BATCH].contiguous()
        v = (torch.randn(m, 1, generator=gen, device=device) * imask[:, None]).contiguous()
        v_abs = v.abs()
        b3_case("gram_matvec R=1", lambda: gram_matvec(xg, iz_scaled, v, ivar, "matern32"),
                lambda: gram_matvec_plain(xg, iz_scaled, v, ivar, "matern32"),
                lambda: gram_matvec_plain(xg, iz_scaled, v_abs, ivar, "matern32"),
                (R_BATCH, m, 3, 1), "matern32", 4.0 * ((R_BATCH + m) * 3 + m + 1 + R_BATCH),
                reps=20, loader=b3_loader(v, 1, 1, 1))
        # Ragged cases of every family: the small launch (R = 5) and the
        # tiled one reading B transposed (R = 37 at D = 5, R = 130 at D = 32).
        for n_r, m_r, d_r, r_r in ((1000, 777, 3, 5), (1000, 777, 5, 37), (333, 1001, 32, 130)):
            for kernel_name in ("se", "matern12", "matern32", "matern52"):
                xr = (torch.rand(n_r, d_r, generator=gen, device=device) * 4 - 2).contiguous()
                zr = (torch.rand(m_r, d_r, generator=gen, device=device) * 4 - 2).contiguous()
                vr = torch.randn(m_r, r_r, generator=gen, device=device)
                vr_abs = vr.abs()
                b3_case(f"gram_matvec ragged {kernel_name} R={r_r}",
                        lambda: gram_matvec(xr, zr, vr, 1.3, kernel_name),
                        lambda: gram_matvec_plain(xr, zr, vr, 1.3, kernel_name),
                        lambda: gram_matvec_plain(xr, zr, vr_abs, 1.3, kernel_name),
                        (n_r, m_r, d_r, r_r), kernel_name,
                        4.0 * ((n_r + m_r) * d_r + m_r * r_r + 1 + n_r * r_r), reps=10,
                        loader=b3_loader(vr, r_r, 1, r_r))
        emit({"phase": "B3", "cases": cases, "b_loader": b_loader, "library_ms": None,
              "library_note": "no single PyTorch call builds and contracts the Gram matrix",
              "peak": "fp32 FMA 67 TFLOP/s, TF32 495 TFLOP/s dense, 16 special-function "
                      "results/clock/SM x 132 SMs at the max SM clock, HBM 3.35 TB/s (H100 SXM)",
              "nvidia_smi": card_line, "wall_s": ph.elapsed()})
        big = cases[1]
        kernels.setdefault("gram_matvec", {}).update({
            "max_abs_err": max(c["max_abs_err"] for c in cases), "ms": big["kernel_ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": None,
            "implicit_train_ms": train_case["kernel_ms"],
            "implicit_train_plain_ms": train_case["plain_ms"],
            "implicit_train_bound_ms": train_case["bound_ms"]})

    # -- reference_implicit: the fp64 Cholesky posterior ----------------------
    with Phase("reference_implicit", 180) as ph:
        oracle = ClusterGP(kernel=Matern32(), num_data=n_train)
        oparams = oracle.init_params(iv, pseudo_u=u, cluster_counts=counts,
                                     dtype=torch.float64, device=device)
        ref_mean, ref_var = oracle.predict_f(oparams, ixq.double())
        ph.wait()
        require(bool(torch.isfinite(ref_mean).all() and torch.isfinite(ref_var).all()),
                "the fp64 Cholesky posterior is not finite")
        emit({"phase": "reference_implicit", "points": int(ixq.shape[0]),
              "mean_abs_max": float(ref_mean.abs().max()), "var_min": float(ref_var.min()),
              "var_max": float(ref_var.max()), "wall_s": ph.elapsed()})

    def serve_implicit(name, use_pallas, threshold, xs, atol, budget_s):
        with Phase(name, budget_s) as ph:
            model = make_implicit(use_pallas, threshold)
            solves = record_solves(model)
            gram_matvec.launches = 0
            kuu_matvec.launches = 0
            t0 = time.monotonic()
            post = model.posterior(iparams, solver="cg")
            ph.wait()
            t1 = time.monotonic()
            mean, var = predict_in_batches(model, iparams, xs, batch_size=R_BATCH,
                                           posterior_solver="cg", posterior=post)
            ph.wait()
            t2 = time.monotonic()
            launches = {"kuu_matvec": kuu_matvec.launches, "gram_matvec": gram_matvec.launches}
            steps = [int(st.steps) for st in solves]
            converged = [bool(st.converged) for st in solves]
            require(len(steps) == 1 + xs.shape[0] // R_BATCH, f"{name}: {len(steps)} solves")
            want = {"kuu_matvec": sum(k + 1 for k in steps) if use_pallas else 0,
                    "gram_matvec": 0}
            require(launches == want, f"{name}: launches {launches}, want {want} "
                                      f"(steps + 1 over the solves {steps})")
            require(all(converged), f"{name}: a solve did not converge: steps {steps}")
            require(mean.shape == (xs.shape[0], 1) and var.shape == (xs.shape[0], 1),
                    f"{name}: output shapes {tuple(mean.shape)} {tuple(var.shape)}")
            require(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
                    f"{name}: non-finite serving output")
            require(bool((var >= 0).all()), f"{name}: negative predictive variance")
            rows = xs.shape[0]
            gaps = {"mean": float((mean.double() - ref_mean[:rows]).abs().max()),
                    "var": float((var.double() - ref_var[:rows]).abs().max())}
            # Over the points the JAX package's own gap was measured on.
            gaps_512 = {"mean": float((mean[:512].double() - ref_mean[:512]).abs().max()),
                        "var": float((var[:512].double() - ref_var[:512]).abs().max())}
            require(all(gaps[k] <= atol[k] for k in gaps),
                    f"{name}: gaps to the fp64 Cholesky posterior {gaps} beyond {atol}")
            serve_s = t2 - t1
            record = {"phase": name, "use_pallas": use_pallas,
                      "relative_threshold": threshold, "launches": launches,
                      "solves": len(steps), "points": rows, "batch_size": R_BATCH,
                      "posterior_build_s": t1 - t0, "serve_s": serve_s,
                      "points_per_s": rows / serve_s, "cg_steps_nu": steps[0],
                      "cg_steps_per_batch": steps[1:],
                      "ms_per_cg_step_serving": serve_s * 1e3 / sum(steps[1:]),
                      "mean_vs_fp64_chol": gaps["mean"], "var_vs_fp64_chol": gaps["var"],
                      "mean_vs_fp64_chol_first_512": gaps_512["mean"],
                      "var_vs_fp64_chol_first_512": gaps_512["var"],
                      **({"jax_cpu_vs_fp64_chol_first_512": JAX_IMPLICIT_GAP_512,
                          "mean_gap_over_jax_first_512":
                              gaps_512["mean"] / JAX_IMPLICIT_GAP_512["mean"]}
                         if threshold == IMPLICIT_THRESHOLD else {}),
                      "tolerance": atol, "var_min": float(var.min()),
                      "nvidia_smi": card_line, "wall_s": ph.elapsed()}
            emit(record)
            return record

    # Not warmed up: B3 and the blocked route's matmuls ran in earlier phases.
    implicit = {}
    for route, use_pallas in (("pallas", True), ("xla", False)):
        implicit[route] = serve_implicit(f"serve_implicit_{route}", use_pallas,
                                         IMPLICIT_THRESHOLD, ixq, IMPLICIT_ATOL, 150)
    kernels["gram_matvec"]["launches"] = sum(implicit["pallas"]["launches"].values())
    kernels["gram_matvec"].update(b3_train)
    tight = {route: serve_implicit(f"check_implicit_tight_{route}", use_pallas,
                                   IMPLICIT_TIGHT_THRESHOLD, ixq[:R_BATCH], IMPLICIT_TIGHT_ATOL,
                                   120)
             for route, use_pallas in (("pallas", True), ("xla", False))}
    # Both routes solve the same systems: the kernel route's step counts stay
    # within 5 % (or 3 steps) of the plain route's.
    for runs in (implicit, tight):
        for key in ("cg_steps_nu", "cg_steps_per_batch"):
            a = np.atleast_1d(runs["pallas"][key])
            b = np.atleast_1d(runs["xla"][key])
            require(bool(np.all(np.abs(a - b) <= np.maximum(3, 0.05 * b))),
                    f"kernel route steps {a.tolist()} vs plain {b.tolist()} ({key})")

    # -- LOVE serving of the matrix-free model, through B3 and the blocked route
    kernels["gram_matvec"]["love_implicit_launches"] = serve_love_implicit(
        {"card_line": card_line, "params": iparams, "xs": ixq, "make_implicit": make_implicit,
         "ref_var": ref_var})

    # -- matrix-free training through B3 and the blocked route ----------------
    implicit_training_phases({"device": device, "card_line": card_line,
                              "make_implicit": make_implicit, "params": iparams,
                              "data": (x_train, y_train, x_test, y_test),
                              "gram_record": kernels["gram_matvec"]})

    # -- the exact GP through B3 at N = 131,072 ---------------------------------
    itergpr_phases({"device": device, "card_line": card_line,
                    "sm_clock_hz": sm_clock_mhz * 1e6, "gram_record": kernels["gram_matvec"]})

    # -- the rest of the CG solver family on bench.py's dense system -----------
    kernels["pallas_matvec"].update(solver_family_phases(
        {"device": device, "card_line": card_line, "training_system": kmm_lambda,
         "training_rhs": params["pseudo_u"]}))

    sources = {"pallas_matvec": ("cggp_tpu_torch/csrc/pallas_matvec.cu",
                                 "cggp_tpu/ops/pallas_matvec.py:65"),
               "pallas_cg_solve": ("cggp_tpu_torch/csrc/pallas_cg.cu",
                                   "cggp_tpu/ops/pallas_cg.py:107"),
               "gram_matvec": ("cggp_tpu_torch/csrc/pallas_gram.cu",
                               "cggp_tpu/ops/pallas_gram.py:118")}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
         "launches": kernels[name]["launches"], "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"],
         "bound_ms": kernels[name]["bound_ms"], "bound_by": kernels[name]["bound_by"],
         "library_ms": kernels[name]["library_ms"],
         **{k: v for k, v in kernels[name].items()
            if k.startswith(("train_", "multi_", "loop_", "implicit_", "itergpr_", "love_",
                             "solver_family_", "pathwise_", "lbfgs_"))}}
        for name in ("pallas_matvec", "pallas_cg_solve", "gram_matvec")]})
    print(card_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
