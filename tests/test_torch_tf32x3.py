"""The 3xTF32 arithmetic of kernels B1 and B3 (``csrc/mma_3xtf32.cuh``),
emulated in plain torch on the CPU (``ops.pallas_matvec.tf32_round``,
``matmul_3xtf32_emulated`` and the B3 emulations): the split is exact
where it must be, the product stays within fp32-level error of fp64, and
CG at the serving threshold converges in the same steps as the fp32 loop.
The emulation sums each stage in the kernels' two parts, each rounded to
nearest (its default); the tensor cores truncate each part, which
``truncate=True`` models and which leaves a one-sign bias on data of one
sign (checked here, and against the card's in ``chip_smoke.py``).  The
kernels themselves are held against their plain versions and fp64 on the
card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cggp_tpu.ops.pallas_gram import kuu_matvec as jax_kuu_matvec
from cggp_tpu_torch.data import synthetic
from cggp_tpu_torch.models.cggp import CGGP
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.ops.kernels import Matern32, kernel_value_from_r2, scaled_squared_distance
from cggp_tpu_torch.ops.pallas_gram import (gram_matvec_3xtf32_emulated, gram_matvec_plain,
                                            kuu_matvec_3xtf32_emulated, kuu_matvec_plain)
from cggp_tpu_torch.ops.pallas_matvec import (OUTER_STAGES, TF32_STAGE, matmul_3xtf32_emulated,
                                              round_toward_zero,
                                              split_tf32, tf32_round)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CG_THRESHOLD = 1e-8  # chip_smoke.py's absolute serving threshold at M = 989


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """Round float32 to 10 mantissa bits, to nearest, ties away from zero,
    in float64 arithmetic (independent of the bit trick under test)."""
    x = x.astype(np.float64)
    mant, exp = np.frexp(x)  # x = mant 2^exp, 0.5 <= |mant| < 1
    scaled = np.abs(mant) * 2.0 ** 11  # 11 significant bits
    rounded = np.floor(scaled + 0.5)
    return (np.sign(mant) * rounded * 2.0 ** (exp - 11)).astype(np.float32)


def test_tf32_round_is_round_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    spread = rng.standard_normal(20000) * 10.0 ** rng.integers(-30, 30, 20000)
    x = np.concatenate([spread, [1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 3 * 2 ** -11,
                                 0.0, -0.0, 1e-36, 3.0e38]]).astype(np.float32)
    got = tf32_round(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, _rna_reference(x))
    # The 13 low bits are clear, and the ties go away from zero.
    assert not np.any(got.view(np.int32) & 0x1FFF)
    assert got[-7] == np.float32(1.0 + 2 ** -10) and got[-6] == -np.float32(1.0 + 2 ** -10)


def test_split_recovers_22_bits():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal(50000).astype(np.float32))
    hi, lo = split_tf32(x)
    assert torch.equal(tf32_round(hi), hi) and torch.equal(tf32_round(lo), lo)
    gap = (x.double() - hi.double() - lo.double()).abs()
    assert bool((gap <= 2.0 ** -22 * x.double().abs()).all())


def _errors(got: np.ndarray, exact: np.ndarray, scale: np.ndarray):
    """rms and max of |got - exact| / scale over the entries with a nonzero
    scale (pad columns of a masked product are exactly 0 in every route)."""
    live = scale > 0
    assert np.all(got[~live] == 0)
    rel = np.abs(got.astype(np.float64)[live] - exact[live]) / scale[live]
    return float(np.sqrt(np.mean(rel ** 2))), float(rel.max())


def _spd(rng, m):
    g = rng.standard_normal((m, m))
    return ((g @ g.T) / m + np.eye(m)).astype(np.float32)


def _matern32_kzz_with_pads(rng, m, pads):
    """K(Z, Z) (Matern32, unit lengthscale and variance) in fp32 over m - pads
    points in [-2, 2]^3 and `pads` pads at 1e6 (1 + k), as the matrix-free
    model places them; p's pad columns are zero, as the mask makes them."""
    z = rng.uniform(-2, 2, (m, 3)).astype(np.float32)
    z[m - pads:] = (1e6 * (1 + np.arange(1, pads + 1, dtype=np.float32)))[:, None]
    zt = torch.as_tensor(z)
    k = kernel_value_from_r2("matern32", scaled_squared_distance(zt, zt),
                             torch.tensor(1.0)).numpy()
    mask = np.ones(m, np.float32)
    mask[m - pads:] = 0
    return k, mask


@pytest.mark.parametrize("case", ["spd989", "spd777", "matern32_kzz2048_pads"])
def test_emulated_product_is_fp32_accurate(case):
    """(a) The emulated 3xTF32 ``p @ A`` is within 1.5x of the fp32 product's
    error against fp64 (rms and max, relative to |p| @ |A|), at ragged M and
    on a kernel matrix with pads."""
    rng = np.random.default_rng(["spd989", "spd777", "matern32_kzz2048_pads"].index(case))
    if case == "matern32_kzz2048_pads":
        a, mask = _matern32_kzz_with_pads(rng, 2048, 64)
        p = (rng.standard_normal((32, 2048)) * mask).astype(np.float32)
    else:
        m = int(case[3:])
        a = _spd(rng, m)
        p = rng.standard_normal((64, m)).astype(np.float32)
    exact = p.astype(np.float64) @ a.astype(np.float64)
    scale = np.abs(p).astype(np.float64) @ np.abs(a).astype(np.float64)
    emulated = matmul_3xtf32_emulated(torch.as_tensor(p), torch.as_tensor(a)).numpy()
    fp32 = (torch.as_tensor(p) @ torch.as_tensor(a)).numpy()
    e_rms, e_max = _errors(emulated, exact, scale)
    f_rms, f_max = _errors(fp32, exact, scale)
    assert e_rms <= 1.5 * f_rms, (e_rms, f_rms)
    assert e_max <= 1.5 * f_max, (e_max, f_max)


def test_round_toward_zero_truncates():
    """``round_toward_zero`` against float64 truncation to 24 significant
    bits (frexp, independent of the nextafter under test)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal(20000) * 10.0 ** rng.integers(-30, 30, 20000)
    x = np.concatenate([x, [0.0, 1.0, -1.0, 1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30)]])
    mant, exp = np.frexp(x)
    want = (np.trunc(mant * 2.0 ** 24) * 2.0 ** (exp - 24)).astype(np.float32)
    got = round_toward_zero(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(np.abs(got.astype(np.float64)) <= np.abs(x))


def test_truncated_parts_bias_one_sign_data():
    """On kernel values (one sign) the truncating model leans one way: its
    mean signed error relative to fp64 is -6.3e-8 over 64 rows of a Matern32
    K(Z, Z) at M = 1024, against -9.8e-10 rounded to nearest and +5.9e-11
    for the fp32 product; the largest relative error stays fp32-level
    (6.5e-7, 5.5e-7 and 7.4e-7).  Held: below -2e-8 truncated, under a
    twentieth of that in size rounded to nearest, and every largest error
    below 1e-6."""
    rng = np.random.default_rng(5)
    a, _ = _matern32_kzz_with_pads(rng, 1024, 0)
    p = a[:64].copy()
    exact = p.astype(np.float64) @ a.astype(np.float64)
    rel = {truncate: (matmul_3xtf32_emulated(torch.as_tensor(p), torch.as_tensor(a),
                                             truncate=truncate).numpy() - exact) / exact
           for truncate in (False, True)}
    assert rel[True].mean() < -2e-8, rel[True].mean()
    assert abs(rel[False].mean()) < abs(rel[True].mean()) / 20, rel[False].mean()
    assert max(np.abs(r).max() for r in rel.values()) < 1e-6


@pytest.mark.parametrize("depth", [1024, 8192, 32768])
def test_two_level_depth_sums_bound_long_sums(depth):
    """B1's and B3's tiled launches add their running sum to an outer sum
    every ``OUTER_STAGES`` stages.  Up to that many stages (depth 1024) the
    two forms give the same bits; past it one running sum rounds at the
    ulp of the growing sum on every add.  On data of one sign (uniform
    [0, 1), 4 rows, 64 columns) the one-level model lands 4.2x (8192) and
    10.5x (32768) the IEEE fp32 product's error from fp64, the two-level
    model 0.71x and 1.56x (measured).  Held: two-level within 2x the fp32
    product, and at most a quarter of the one-level error past depth 1024."""
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.uniform(0, 1, (4, depth)), dtype=torch.float32)
    b = torch.as_tensor(rng.uniform(0, 1, (depth, 64)), dtype=torch.float32)
    exact = a.double() @ b.double()
    one = matmul_3xtf32_emulated(a, b)
    two = matmul_3xtf32_emulated(a, b, outer_every=OUTER_STAGES)
    err_one, err_two = (float((t.double() - exact).abs().max()) for t in (one, two))
    err_fp32 = float(((a @ b).double() - exact).abs().max())
    if depth <= OUTER_STAGES * TF32_STAGE:
        assert torch.equal(one, two)
    else:
        assert err_two <= err_one / 4, (err_two, err_one)
    assert err_two <= 2.0 * err_fp32, (err_two, err_fp32)


@pytest.mark.parametrize("kernel_name", ["se", "matern12", "matern32", "matern52"])
def test_b3_emulations_match_plain_versions(kernel_name):
    """The B3 emulations differ from the fp32 plain versions only by the
    rounding of the contraction: within the B3 gate of chip_smoke.py (5e-5
    of max(|B| K))."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.uniform(-2, 2, (70, 3)).astype(np.float32))
    z = torch.as_tensor(rng.uniform(-2, 2, (45, 3)).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal((45, 12)).astype(np.float32))
    got = gram_matvec_3xtf32_emulated(x, z, v, 1.3, kernel_name)
    want = gram_matvec_plain(x, z, v, 1.3, kernel_name)
    scale = float(gram_matvec_plain(x, z, v.abs(), 1.3, kernel_name).max())
    assert float((got - want).abs().max()) <= 5e-5 * scale
    lam = torch.as_tensor(rng.uniform(0.01, 0.1, 45).astype(np.float32))
    p = torch.as_tensor(rng.standard_normal((16, 45)).astype(np.float32))
    got = kuu_matvec_3xtf32_emulated(z, lam, p, 1.3, kernel_name)
    want = kuu_matvec_plain(z, lam, p, 1.3, kernel_name)
    scale = float(kuu_matvec_plain(z, lam, p.abs(), 1.3, kernel_name).max())
    assert float((got - want).abs().max()) <= 5e-5 * scale


def test_kuu_emulation_matches_jax_interpret_with_pads():
    """The same inputs, pads included, through JAX's kuu_matvec (Pallas in
    interpret mode) and the port's B3 emulation, at the JAX test's
    tolerance; pad outputs are exactly p * lam in the emulation."""
    rng = np.random.default_rng(4)
    m, pads = 160, 32
    z = rng.uniform(-2, 2, (m, 3)).astype(np.float32)
    z[m - pads:] = (1e6 * (1 + np.arange(1, pads + 1, dtype=np.float32)))[:, None]
    lam = rng.uniform(0.01, 0.1, m).astype(np.float32)
    lam[m - pads:] = 1.0
    p = rng.standard_normal((16, m)).astype(np.float32)
    p[:, m - pads:] = 0.0
    want = np.asarray(jax_kuu_matvec(jnp.asarray(z), jnp.asarray(lam), jnp.asarray(p),
                                     jnp.float32(1.0), "matern32", block_m=32, block_n=32,
                                     interpret=True))
    got = kuu_matvec_3xtf32_emulated(torch.as_tensor(z), torch.as_tensor(lam),
                                     torch.as_tensor(p), 1.0, "matern32").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got[:, m - pads:], p[:, m - pads:] * lam[m - pads:])


def _cg_steps_per_row(matvec, b: torch.Tensor, threshold: float, cap: int):
    """Unpreconditioned CG on every row of v A = b at once (the repo's stop
    rule 0.5 |r|^2 <= threshold), recording the step at which each row
    first meets it; rows run independently."""
    v = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rz = (r * r).sum(-1, keepdim=True)
    steps = torch.full((b.shape[0],), -1, dtype=torch.int64)
    done = 0.5 * rz[:, 0] <= threshold
    steps[done] = 0
    for i in range(1, cap + 1):
        pa = matvec(p)
        gamma = rz / (p * pa).sum(-1, keepdim=True)
        v = v + gamma * p
        r = r - gamma * pa
        new_rz = (r * r).sum(-1, keepdim=True)
        p = r + (new_rz / rz) * p
        rz = new_rz
        met = (0.5 * rz[:, 0] <= threshold) & (steps < 0)
        steps[met] = i
        if bool((steps >= 0).all()):
            break
    return steps, v


def test_cg_with_emulated_matvec_matches_fp32_steps():
    """(b) CG at absolute 1e-8 on the committed M = 989 selection (Matern32
    at init parameters), for the pseudo-u row and 64 Kmn rows: every row
    converges with the emulated 3xTF32 matvec, the pseudo-u solve and the
    mean over the Kmn rows take within 5 % of the fp32 loop's steps.  Single
    rows scatter more near convergence whatever the rounding: a matvec
    accumulated in float64 and rounded to fp32 once moves a row by up to
    8.4 % (14 steps) here, so each row is held to 10 % (or 3 steps).  The
    emulation rounds each part to nearest (the default); the fp32 loop's
    own pseudo-u count moves from 242 to 255 steps between one and four
    CPU threads, and the truncating model (``truncate=True``) lands on 255
    against the one-thread 242."""
    with np.load(ROOT / "benchmarks" / "e2e_selection_covertree.npz") as sel:
        iv, u, counts = sel["iv"], sel["u"], sel["counts"]
    (x_train, _), (x_test, _) = synthetic(n=435_000, dim=3, seed=0)
    model = CGGP(kernel=Matern32(), num_data=x_train.shape[0],
                 conjugate_gradient=ConjugateGradient(CG_THRESHOLD))
    params = model.init_params(iv, pseudo_u=u, cluster_counts=counts, dtype=torch.float32,
                               device="cpu")
    a = model.posterior(params, solver="cg").kmm_lambda
    kmn = model.kernel.K(params["kernel"], torch.as_tensor(x_test[:64], dtype=torch.float32),
                         params["inducing_points"])
    b = torch.cat([params["pseudo_u"].T, kmn], dim=0).contiguous()
    m = a.shape[0]
    fp32_steps, _ = _cg_steps_per_row(lambda p: p @ a, b, CG_THRESHOLD, m)
    emu_steps, v = _cg_steps_per_row(lambda p: matmul_3xtf32_emulated(p, a), b, CG_THRESHOLD, m)
    assert bool((fp32_steps > 0).all()) and bool((emu_steps > 0).all())
    gap = (emu_steps - fp32_steps).abs().double()
    assert float(gap[0]) <= max(3.0, 0.05 * float(fp32_steps[0])), (emu_steps[0], fp32_steps[0])
    assert bool((gap <= torch.clamp(0.10 * fp32_steps.double(), min=3.0)).all()), (
        emu_steps.tolist(), fp32_steps.tolist())
    mean_fp32, mean_emu = fp32_steps[1:].double().mean(), emu_steps[1:].double().mean()
    assert abs(float(mean_emu - mean_fp32)) <= 0.05 * float(mean_fp32)
    # The solutions sit where the stop rule allows: within the fp64 solve's
    # distance bound 2 sqrt(2 threshold) / lambda_min of it (per row, max norm
    # bounded by the 2-norm).
    exact = torch.linalg.solve(a.double(), b.double().T).T
    lam_min = float(torch.linalg.eigvalsh(a.double())[0])
    assert float((v.double() - exact).abs().max()) <= 2 * (2 * CG_THRESHOLD) ** 0.5 / lam_min
