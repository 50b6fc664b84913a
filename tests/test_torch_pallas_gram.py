"""Port parity for kernel B3 (``gram_matvec`` / ``kuu_matvec``): the port's
wrappers on CPU tensors (their plain versions) against the JAX Pallas kernel
in interpret mode, for all four kernel families, plus the pad rows of the
matrix-free model and the wrappers' refusals.  The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cggp_tpu.ops.pallas_gram import gram_matvec as jax_gram_matvec
from cggp_tpu.ops.pallas_gram import kuu_matvec as jax_kuu_matvec
from cggp_tpu_torch.ops.cg_implicit import pad_inducing
from cggp_tpu_torch.ops.kernels import kernel_by_name
from cggp_tpu_torch.ops.pallas_gram import (
    MAX_DIM,
    gram_matvec,
    gram_matvec_plain,
    kuu_matvec,
    kuu_matvec_plain,
)

torch.set_num_threads(1)

FAMILIES = ["se", "matern12", "matern32", "matern52"]
# Both sides are fp32: the interpret-mode kernel and the plain version sum
# the M products of each output in other orders.  The JAX package's own test
# of this kernel holds it to the same tolerance (tests/test_pallas_gram.py).
TOL = dict(rtol=2e-5, atol=2e-5)
INTERPRET = dict(interpret=True, block_n=16, block_m=16)


def _gram_operands(seed, n, m, d, r):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    z = rng.uniform(-1, 1, (m, d)).astype(np.float32)
    v = rng.standard_normal((m, r)).astype(np.float32)
    ell = rng.uniform(0.5, 1.5, (d,)).astype(np.float32)
    return x / ell, z / ell, v


def _self_pair_atol(kernel_name, zs, p, variance):
    """K(Z, Z) holds coincident pairs, where r2 is fp32 cancellation noise
    (|z|^2 + |z|^2 - 2 z.z, each side rounding its own way, up to ~4 eps
    |z|^2).  Matern12's exp(-sqrt(r2)) turns that into a kernel-value gap of
    up to variance * sqrt(4 eps max|z|^2) on the diagonal (the other
    families are smooth in r2 there), so its tolerance adds that gap times
    max|p|."""
    if kernel_name != "matern12":
        return TOL["atol"]
    zs, p = np.asarray(zs, np.float64), np.asarray(p, np.float64)
    r2_noise = 4 * np.finfo(np.float32).eps * np.max(np.sum(zs**2, axis=-1))
    return TOL["atol"] + float(variance) * np.sqrt(r2_noise) * np.abs(p).max()


def _counts():
    return gram_matvec.launches, kuu_matvec.launches


@pytest.mark.parametrize("kernel_name", FAMILIES)
@pytest.mark.parametrize("n,m,d,r", [(70, 33, 3, 2), (100, 50, 5, 1)])
def test_gram_matvec_matches_jax_interpret(kernel_name, n, m, d, r):
    # (70, 33): unaligned everywhere; (100, 50): n and m past the 16 block.
    xs, zs, v = _gram_operands(n + m, n, m, d, r)
    variance = np.float32(1.7)
    want = np.asarray(jax_gram_matvec(jnp.asarray(xs), jnp.asarray(zs), jnp.asarray(v),
                                      jnp.asarray(variance), kernel_name=kernel_name,
                                      **INTERPRET))
    before = _counts()
    got = gram_matvec(torch.as_tensor(xs), torch.as_tensor(zs), torch.as_tensor(v),
                      torch.tensor(variance), kernel_name)
    assert got.dtype == torch.float32 and got.shape == (n, r)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert _counts() == before  # the CPU path launches nothing


@pytest.mark.parametrize("kernel_name", FAMILIES)
def test_kuu_matvec_matches_jax_interpret(kernel_name):
    m, d, r = 33, 3, 5
    rng = np.random.default_rng(21)
    _, zs, _ = _gram_operands(21, 1, m, d, 1)
    lam = rng.uniform(0.1, 0.5, (m,)).astype(np.float32)
    p = rng.standard_normal((r, m)).astype(np.float32)
    variance = np.float32(0.9)
    want = np.asarray(jax_kuu_matvec(jnp.asarray(zs), jnp.asarray(lam), jnp.asarray(p),
                                     jnp.asarray(variance), kernel_name=kernel_name,
                                     **INTERPRET))
    before = _counts()
    got = kuu_matvec(torch.as_tensor(zs), torch.as_tensor(lam), torch.as_tensor(p),
                     float(variance), kernel_name)
    assert got.shape == (r, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL["rtol"],
                               atol=_self_pair_atol(kernel_name, zs, p, variance))
    assert _counts() == before


@pytest.mark.parametrize("kernel_name", FAMILIES)
def test_kuu_matvec_with_pad_rows_matches_jax_and_composes_exactly(kernel_name):
    """Pads at 1e6 (1 + k) (before the lengthscale divide) as the matrix-free
    model places them: the kernel's output stays finite, and the masked
    composition mask * kuu(p * mask) + p * lam * (1 - mask) gives the pads
    exactly p * lam and the real rows the unpadded product."""
    m_real, m_pad, d, r = 21, 32, 3, 2
    rng = np.random.default_rng(5)
    z = torch.as_tensor(rng.uniform(-1, 1, (m_real, d)).astype(np.float32))
    lam = torch.as_tensor(rng.uniform(0.1, 0.5, (m_real,)).astype(np.float32))
    ones = torch.ones((1, m_real))
    z_pad, lam_pad, mask = pad_inducing(z, lam, m_pad, ones)
    mask = mask[0]
    assert z_pad.shape == (m_pad, d) and float(z_pad.max()) == pytest.approx(1e6 * 12)
    ell = torch.tensor([0.8, 1.2, 1.0])
    zs = (z_pad / ell).contiguous()
    p = torch.as_tensor(rng.standard_normal((r, m_pad)).astype(np.float32))
    variance = 1.3
    want = np.asarray(jax_kuu_matvec(jnp.asarray(zs.numpy()), jnp.asarray(lam_pad.numpy()),
                                     jnp.asarray((p * mask).numpy()),
                                     jnp.asarray(variance, jnp.float32),
                                     kernel_name=kernel_name, **INTERPRET))
    fused = kuu_matvec(zs, lam_pad, (p * mask).contiguous(), variance, kernel_name)
    assert torch.isfinite(fused).all()
    atol = _self_pair_atol(kernel_name, zs[:m_real], p, variance)
    np.testing.assert_allclose(fused.numpy(), want, rtol=TOL["rtol"], atol=atol)
    masked = fused * mask + p * (lam_pad * (1.0 - mask))
    pads = mask == 0
    assert torch.equal(masked[:, pads], p[:, pads] * lam_pad[pads])
    unpadded = kuu_matvec_plain((z / ell).contiguous(), lam, p[:, :m_real].contiguous(),
                                variance, kernel_name)
    np.testing.assert_allclose(masked[:, :m_real].numpy(), unpadded.numpy(), rtol=TOL["rtol"],
                               atol=atol)


def test_plain_versions_are_the_dense_products():
    xs, zs, v = _gram_operands(3, 40, 25, 3, 3)
    kernel = kernel_by_name("matern52")
    kp = kernel.init_params(variance=1.4, lengthscales=np.ones(3), dtype=torch.float64,
                            device="cpu")
    x64, z64, v64 = (torch.as_tensor(t, dtype=torch.float64) for t in (xs, zs, v))
    k = kernel.K(kp, x64, z64)
    np.testing.assert_allclose(gram_matvec_plain(x64, z64, v64, 1.4, "matern52").numpy(),
                               (k @ v64).numpy(), rtol=1e-12, atol=1e-12)
    lam = torch.linspace(0.1, 0.2, 25, dtype=torch.float64)
    p = v64.T.contiguous()
    kzz = kernel.K(kp, z64)
    np.testing.assert_allclose(kuu_matvec_plain(z64, lam, p, 1.4, "matern52").numpy(),
                               (p @ kzz + p * lam).numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["float64", "features", "too_many_features", "v_shape",
                                  "lam_shape", "noncontiguous", "kernel", "variance_shape"])
def test_wrappers_refuse_bad_operands(case):
    xs, zs, v = (torch.as_tensor(t) for t in _gram_operands(0, 8, 6, 3, 2))
    lam = torch.ones(6)
    p = v.T.contiguous()
    with pytest.raises((TypeError, ValueError)):
        if case == "float64":
            gram_matvec(xs.double(), zs.double(), v.double(), 1.0)
        elif case == "features":
            gram_matvec(xs[:, :2].contiguous(), zs, v, 1.0)
        elif case == "too_many_features":
            wide = torch.zeros((6, MAX_DIM + 1))
            kuu_matvec(wide, lam, p, 1.0)
        elif case == "v_shape":
            gram_matvec(xs, zs, v[:5].contiguous(), 1.0)
        elif case == "lam_shape":
            kuu_matvec(zs, lam[:5].contiguous(), p, 1.0)
        elif case == "noncontiguous":
            kuu_matvec(zs, lam, v.T, 1.0)
        elif case == "kernel":
            gram_matvec(xs, zs, v, 1.0, "rbf")
        else:
            kuu_matvec(zs, lam, p, torch.ones(2))


def test_wrappers_refuse_other_devices():
    xs, zs, v = (torch.as_tensor(t).to("meta") for t in _gram_operands(0, 8, 6, 3, 2))
    with pytest.raises(ValueError):
        gram_matvec(xs, zs, v, 1.0)
