"""The selection and training-loop slice on the card: the K-step trainer's
launch counts through B2 (``"pallas_resident"``: exactly 2 a step) and B1
(``"pallas"`` under the exact factor: the solves' steps + 1), no B3 launch,
its first chunk against single steps, and Lloyd's k-means in fp32 against
fp64 on the card.

Every test takes the ``cuda`` fixture, which skips it without a card; the
decision is made there, never at import.  On a machine with a card, without
JAX::

    python -m pytest tests/test_torch_cuda_training_loop.py -q --noconftest
"""

import numpy as np
import pytest
import torch

import cggp_tpu_torch.ops.cg as cg_module
from cggp_tpu_torch.data import synthetic
from cggp_tpu_torch.models.cggp import CGGP
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.ops.kernels import Matern32
from cggp_tpu_torch.ops.pallas_cg import pallas_cg_solve
from cggp_tpu_torch.ops.pallas_gram import gram_matvec, kuu_matvec
from cggp_tpu_torch.ops.pallas_matvec import pallas_matvec
from cggp_tpu_torch.selection import covertree_update_inducing_parameters, kmeans_lloyd
from cggp_tpu_torch.training import adam, make_adam_multi_step, make_adam_step
from cggp_tpu_torch.training.batching import minibatch_index_iterator

pytestmark = pytest.mark.cuda
COUNTED = (pallas_cg_solve, pallas_matvec, gram_matvec, kuu_matvec)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with --noconftest (module docstring)")
    from cggp_tpu_torch import resolve_device

    return resolve_device("cuda")


def _problem(device, n=40_000):
    (x, y), _ = synthetic(n=n, dim=3, seed=0)
    xt = torch.as_tensor(x, dtype=torch.float32, device=device)
    yt = torch.as_tensor(y, dtype=torch.float32, device=device)
    z, u, counts = covertree_update_inducing_parameters((xt, yt), 0.5, backend="native")
    return xt, yt, z, u, counts


@pytest.mark.parametrize("impl", ["pallas_resident", "pallas"])
def test_multi_step_launch_counts_and_first_chunk(cuda, impl):
    xt, yt, z, u, counts = _problem(cuda)
    if impl == "pallas":
        cg = ConjugateGradient(1e-5, relative_threshold=True, matvec_impl=impl)
    else:
        cg = ConjugateGradient(1e-8, matvec_impl=impl)
    model = CGGP(kernel=Matern32(), conjugate_gradient=cg, num_data=xt.shape[0], num_probes=5,
                 precondition="chol" if impl == "pallas" else None)
    params = model.init_params(z, pseudo_u=u, cluster_counts=counts, dtype=torch.float32,
                               device=cuda)
    mask = model.trainable_mask(params)
    k = 5
    idx = next(minibatch_index_iterator(0, xt.shape[0], 512, k, device=cuda))
    solves = []
    impl_fn = cg_module._cg_dense_impl

    def recording(*args):
        out = impl_fn(*args)
        solves.append(out[1])
        return out

    cg_module._cg_dense_impl = recording
    try:
        for counted in COUNTED:
            counted.launches = 0
        multi = make_adam_multi_step(model.training_loss, adam(0.01), (xt, yt), mask)
        p, _, losses = multi(params, adam(0.01).init(params), idx,
                             torch.Generator(device=cuda).manual_seed(1))
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in COUNTED}
        steps = [int(s.steps) for s in solves]
    finally:
        cg_module._cg_dense_impl = impl_fn
    assert len(steps) == 2 * k  # a forward and a backward solve a step
    want = {"pallas_cg_solve": 2 * k if impl == "pallas_resident" else 0,
            "pallas_matvec": sum(s + 1 for s in steps) if impl == "pallas" else 0,
            "gram_matvec": 0, "kuu_matvec": 0}
    assert launches == want
    assert losses.shape == (k,) and bool(torch.isfinite(losses).all())
    # The same chunk as k single steps on the same rows and probes: the
    # same operations in the same order (chip_smoke.py measured its K = 25
    # chunks bitwise equal), held at 1e-6 relative (fp32).
    step = make_adam_step(model.training_loss, adam(0.01), mask)
    q, opt, gen, single = params, adam(0.01).init(params), \
        torch.Generator(device=cuda).manual_seed(1), []
    for row in idx:
        q, opt, loss = step(q, opt, (xt[row], yt[row]), gen)
        single.append(loss)
    single = torch.stack(single)
    assert float(((losses - single).abs() / single.abs()).max()) <= 1e-6
    for key in ("variance", "lengthscales"):
        a, b = p["kernel"][key], q["kernel"][key]
        assert float(((a - b).abs() / b.abs()).max()) <= 1e-6


def test_kmeans_fp32_repeats_bitwise_on_the_card(cuda):
    # The segment sums add in a fixed order: two runs from one start give
    # the same bits (with index_add_'s atomics they parted after a few
    # passes: chip_smoke.py's select_kmeans moved 1.6e-6 to 1.1e-4 from fp64
    # between runs).
    xt, _, z, _, _ = _problem(cuda)
    first, again = (kmeans_lloyd(xt, z.shape[0], initial_centroids=z) for _ in range(2))
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_kmeans_fp32_matches_fp64_on_the_card(cuda):
    xt, _, z, _, _ = _problem(cuda)
    c32, m32 = kmeans_lloyd(xt, z.shape[0], initial_centroids=z)
    c64, m64 = kmeans_lloyd(xt.double(), z.shape[0], initial_centroids=z.double())
    assert c32.dtype == torch.float32 and c32.device.type == "cuda"
    # Lloyd from the same start in fp32 and fp64 over 40k points (M = 325)
    # reaches the same fixed point here: on an H100 the mean distances
    # measured 4.9e-8 apart relative and the centroids 7.6e-7; held at 1e-6
    # and 1e-5 (one point changing cells would move two centroids by ~4e-3).
    assert abs(float(m32) - float(m64)) / float(m64) <= 1e-6
    assert float((c32.double() - c64).abs().max()) <= 1e-5
    np.testing.assert_array_equal(torch.isfinite(c32).cpu().numpy(), True)
