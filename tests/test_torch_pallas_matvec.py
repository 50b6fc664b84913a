"""Port parity for kernel B1 (``pallas_matvec``): the port's wrapper on CPU
tensors (its plain version) against the JAX Pallas kernel in interpret mode,
plus the wrapper's refusals.  The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cggp_tpu.ops.pallas_matvec import pallas_matvec as jax_pallas_matvec
from cggp_tpu_torch.ops.pallas_matvec import pallas_matvec, pallas_matvec_plain

torch.set_num_threads(1)


def _operands(seed, r, m):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((r, m)).astype(np.float32)
    a0 = rng.standard_normal((m, m))
    return p, (a0 + a0.T).astype(np.float32)


@pytest.mark.parametrize("r,m", [(3, 70), (1, 70), (8, 64), (5, 1)])
def test_pallas_matvec_matches_jax_interpret(r, m):
    p, a = _operands(r * 100 + m, r, m)
    want = np.asarray(jax_pallas_matvec(jnp.asarray(p), jnp.asarray(a), block_i=128,
                                        interpret=True))
    launches = pallas_matvec.launches
    got = pallas_matvec(torch.as_tensor(p), torch.as_tensor(a))
    assert got.dtype == torch.float32 and got.shape == (r, m)
    # Both sides are fp32 sums of m products in different orders: the same
    # tolerance the JAX package's own test holds its kernel to.
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)
    assert pallas_matvec.launches == launches  # the CPU path launches nothing


def test_pallas_matvec_plain_is_the_product():
    p, a = _operands(7, 4, 33)
    got = pallas_matvec_plain(torch.as_tensor(p), torch.as_tensor(a))
    np.testing.assert_allclose(got.numpy(), p.astype(np.float64) @ a, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", ["float64", "shape", "rank", "noncontiguous", "numpy"])
def test_pallas_matvec_refuses_bad_operands(case):
    p, a = (torch.as_tensor(t) for t in _operands(0, 4, 16))
    with pytest.raises((TypeError, ValueError)):
        if case == "float64":
            pallas_matvec(p.double(), a.double())
        elif case == "shape":
            pallas_matvec(p, a[:15, :15].contiguous())
        elif case == "rank":
            pallas_matvec(p[0], a)
        elif case == "noncontiguous":
            pallas_matvec(p, a.T)
        else:
            pallas_matvec(p.numpy(), a)


def test_pallas_matvec_refuses_other_devices():
    p, a = (torch.as_tensor(t) for t in _operands(0, 2, 8))
    with pytest.raises(ValueError):
        pallas_matvec(p.to("meta"), a.to("meta"))
