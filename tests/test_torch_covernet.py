"""Port parity for the device delta-net (``cggp_tpu_torch/selection/covernet.py``)
against ``cggp_tpu/selection/covernet.py`` on the CPU, in float64, on the
same numpy inputs.

* The scan: the selected centres identical to JAX's, in the same order, for
  the euclidean, covariance and correlation metrics, small blocks (many
  blocks, several MIS rounds each), the buffer's doubling ladder and the
  ``max_points`` truncation (warned in both); the net is also the
  sequential greedy net of a numpy oracle.
* The MIS rounds run in groups between host reads: any group size gives
  bitwise the same net, with fewer reads for larger groups.
* Lloyd's rounds, the update functions (plain, padded, streaming) and
  ``make_device_recluster_fn`` at JAX's tolerances (``tests/test_covernet.py``,
  ``tests/test_streaming.py``: 1e-12 on the statistics), and JAX's refusals.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cggp_tpu_torch.selection.covernet as tcovernet
from cggp_tpu.models.cggp import CGGP as JaxCGGP
from cggp_tpu.models.implicit import ImplicitCGGP as JaxImplicitCGGP
from cggp_tpu.ops import kernels as jkernels
from cggp_tpu.ops.cg import ConjugateGradient as JaxConjugateGradient
from cggp_tpu.selection import covernet as jcovernet
from cggp_tpu_torch.models.cggp import CGGP
from cggp_tpu_torch.models.implicit import ImplicitCGGP
from cggp_tpu_torch.ops import kernels as tkernels
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.utils.store import params_from_numpy

torch.set_num_threads(1)


def _data(seed=0, n=700, dim=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, dim))
    y = np.concatenate([np.sin(1.5 * x[:, :1]), np.cos(x[:, 1:2])], axis=1)
    return x, y


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _kernels(lengthscale=0.7, variance=1.3, dim=2):
    jk, tk = jkernels.Matern32(), tkernels.Matern32()
    jkp = jk.init_params(variance, jnp.full(dim, lengthscale))
    tkp = tk.init_params(variance, torch.full((dim,), lengthscale, dtype=torch.float64),
                         dtype=torch.float64, device="cpu")
    return (jk, jkp), (tk, tkp)


def _greedy_oracle(x, resolution):
    centers = []
    for p in x:
        if all(np.linalg.norm(p - c) > resolution for c in centers):
            centers.append(p)
    return np.stack(centers)


SELECT_CASES = [  # (distance, resolution, block_size, max_points)
    ("euclidean", 0.3, 64, None),
    ("euclidean", 0.08, 128, None),  # M > 256: the buffer doubles
    ("euclidean", 0.08, 128, 100),  # truncated at the cap, with a warning
    ("covariance", 0.5, 64, None),
    ("correlation", 0.2, 64, None),
]


@pytest.mark.parametrize("distance,res,block,cap", SELECT_CASES,
                         ids=["euclid", "euclid_ladder", "euclid_cap", "covariance",
                              "correlation"])
def test_select_matches_jax(distance, res, block, cap):
    x, _ = _data()
    (jk, jkp), (tk, tkp) = _kernels()
    jkw = {} if distance == "euclidean" else {"kernel": jk, "kernel_params": jkp}
    tkw = {} if distance == "euclidean" else {"kernel": tk, "kernel_params": tkp}
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jz, jm = jcovernet.covernet_select(jnp.asarray(x), res, cap, block, distance, **jkw)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tz, tm = tcovernet.covernet_select(_t(x), res, cap, block, distance, **tkw)
    assert tm == jm and tz.shape == (jm, 2)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))  # the same points, in order
    truncated = [w for w in tw if "truncated" in str(w.message)]
    assert len(truncated) == sum("truncated" in str(w.message) for w in jw) == (cap is not None)
    if distance == "euclidean":
        np.testing.assert_array_equal(tz.numpy(), _greedy_oracle(x, res)[:tm])


@pytest.mark.parametrize("group", [1, 3, 64])
def test_mis_round_groups_give_the_same_net_bitwise(group, monkeypatch):
    # A round on an empty candidate set is a no-op, so any group size
    # between two reads of the stop rule gives the net of the default.
    x, _ = _data(seed=3, n=900)
    want, m = tcovernet.covernet_select(_t(x), 0.15, block_size=256)
    tcovernet.scan_counts.update(host_reads=0, mis_rounds=0)
    tcovernet.covernet_select(_t(x), 0.15, block_size=256)
    default_reads = tcovernet.scan_counts["host_reads"]
    monkeypatch.setattr(tcovernet, "MIS_ROUNDS_PER_READ", group)
    tcovernet.scan_counts.update(host_reads=0, mis_rounds=0)
    got, m_got = tcovernet.covernet_select(_t(x), 0.15, block_size=256)
    assert m_got == m and torch.equal(got, want)
    reads = tcovernet.scan_counts["host_reads"]
    assert (reads >= default_reads) if group < 4 else (reads <= default_reads)
    assert tcovernet.scan_counts["mis_rounds"] % group == 0


def test_sqdist_and_kernel_metrics_match_jax():
    x, _ = _data(n=60)
    a, b = x[:25], x[25:]
    np.testing.assert_allclose(tcovernet._sqdist(_t(a), _t(b)).numpy(),
                               np.asarray(jcovernet._sqdist(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-14)
    (jk, jkp), (tk, tkp) = _kernels()
    for distance in ("covariance", "correlation"):
        np.testing.assert_allclose(
            tcovernet._kernel_metric(tk, tkp, _t(a), _t(b), distance).numpy(),
            np.asarray(jcovernet._kernel_metric(jk, jkp, jnp.asarray(a), jnp.asarray(b),
                                                distance)), rtol=0, atol=1e-14)


@pytest.mark.parametrize("lloyds", [0, 1, 2])
def test_update_inducing_parameters_matches_jax(lloyds):
    x, y = _data()
    jout = jcovernet.covernet_update_inducing_parameters((jnp.asarray(x), jnp.asarray(y)), 0.3,
                                                        lloyds=lloyds, block_size=128)
    tout = tcovernet.covernet_update_inducing_parameters((_t(x), _t(y)), 0.3, lloyds=lloyds,
                                                         block_size=128)
    for got, want in zip(tout, jout):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    z = tout[0].numpy()
    d = np.linalg.norm(z[:, None] - z[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    assert d.min() > 0.3  # Lloyd's keeps the separation
    np.testing.assert_allclose(
        tcovernet.covernet_lloyds(_t(x), _t(z), 0.3, rounds=2).numpy(),
        np.asarray(jcovernet.covernet_lloyds(jnp.asarray(x), jnp.asarray(z), 0.3, rounds=2)),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("distance,res,lloyds,capacity", [("euclidean", 0.3, 1, 256),
                                                          ("covariance", 0.6, 0, 256),
                                                          ("euclidean", 0.3, 0, 40)],
                         ids=["euclid_lloyds", "covariance", "saturated"])
def test_update_padded_matches_jax(distance, res, lloyds, capacity):
    x, y = _data()
    (jk, jkp), (tk, tkp) = _kernels()
    jkw = {} if distance == "euclidean" else {"kernel": jk, "kernel_params": jkp}
    tkw = {} if distance == "euclidean" else {"kernel": tk, "kernel_params": tkp}
    jout = jcovernet.covernet_update_padded(jnp.asarray(x), jnp.asarray(y), res, capacity,
                                            block_size=128, lloyds=lloyds,
                                            distance_type=distance, **jkw)
    tout = tcovernet.covernet_update_padded(_t(x), _t(y), res, capacity, block_size=128,
                                            lloyds=lloyds, distance_type=distance, **tkw)
    for got, want in zip(tout, jout):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    m = int(tout[3].sum())
    assert (m == capacity) == (capacity == 40)
    # Pads stay where the convention puts them: far points, count 1, u 0.
    far = 1.0e6 * (1.0 + np.arange(1, capacity + 1))
    np.testing.assert_array_equal(tout[0][m:].numpy(), np.repeat(far[m:, None], 2, axis=1))
    assert bool((tout[2][m:] == 1).all() and (tout[1][m:] == 0).all())


def test_extend_and_streaming_updates_match_jax():
    x, y = _data()
    x1, y1, x2, y2 = x[:400] * 0.6, y[:400], x[400:], y[400:]
    jz, ju, jc = jcovernet.covernet_update_inducing_parameters(
        (jnp.asarray(x1), jnp.asarray(y1)), 0.35, lloyds=0)
    tz, tu, tc = tcovernet.covernet_update_inducing_parameters((_t(x1), _t(y1)), 0.35, lloyds=0)
    m1 = tz.shape[0]
    # The extended net is the net of all the data (covered old points are
    # rejected again), and JAX's.
    ze, me = tcovernet.covernet_extend(tz, _t(x2), 0.35, block_size=64)
    full, m_full = tcovernet.covernet_select(_t(np.concatenate([x1, x2])), 0.35, block_size=64)
    assert me == m_full > m1 and torch.equal(ze, full)
    jze, jme = jcovernet.covernet_extend(jz, jnp.asarray(x2), 0.35, block_size=64)
    np.testing.assert_array_equal(ze.numpy(), np.asarray(jze))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        zc, mc = tcovernet.covernet_extend(tz, _t(x2), 0.35, max_points=m1 - 1)
    assert mc == m1 and torch.equal(zc, tz) and "never dropped" in str(caught[0].message)

    jout = jcovernet.covernet_extend_update(jz, ju, jc, (jnp.asarray(x2), jnp.asarray(y2)), 0.35)
    tout = tcovernet.covernet_extend_update(tz, tu, tc, (_t(x2), _t(y2)), 0.35)
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)

    cap = me + 7
    pad = cap - m1
    far = 1.0e6 * (1.0 + np.arange(1, cap + 1))[:, None]
    padded = (np.concatenate([np.asarray(jz), np.repeat(far[m1:], 2, axis=1)]),
              np.concatenate([np.asarray(ju), np.zeros((pad, 2))]),
              np.concatenate([np.asarray(jc), np.ones((pad, 1))]),
              np.concatenate([np.ones((m1, 1)), np.zeros((pad, 1))]))
    jp = jcovernet.covernet_extend_update_padded(*map(jnp.asarray, padded),
                                                 (jnp.asarray(x2), jnp.asarray(y2)), 0.35)
    tp = tcovernet.covernet_extend_update_padded(*map(_t, padded), (_t(x2), _t(y2)), 0.35)
    for got, want in zip(tp, jp):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    assert int(tp[3].sum()) == me
    for got, want in zip(tp, tout):  # the padded ingest is the unpadded one, padded
        np.testing.assert_allclose(got[:me].numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("model_name", ["dense", "implicit"])
def test_device_recluster_fn_matches_jax(model_name):
    x, y = _data(n=500)
    y = y[:, :1]
    if model_name == "dense":
        cg = 1e-12
        jmodel = JaxCGGP(kernel=jkernels.Matern32(), conjugate_gradient=JaxConjugateGradient(cg),
                         num_data=500)
        tmodel = CGGP(kernel=tkernels.Matern32(), conjugate_gradient=ConjugateGradient(cg),
                      num_data=500)
        capacity = 100
    else:
        jmodel = JaxImplicitCGGP(kernel=jkernels.Matern32(), num_data=500, block=16)
        tmodel = ImplicitCGGP(kernel=tkernels.Matern32(), num_data=500, block=16)
        capacity = 96
    z0, u0, c0 = jcovernet.covernet_update_inducing_parameters(
        (jnp.asarray(x), jnp.asarray(y)), 0.6, lloyds=0)
    jparams = jmodel.init_params(z0, pseudo_u=u0, cluster_counts=c0, capacity=capacity,
                                 dtype=jnp.float64)
    jparams["kernel"]["lengthscales"] = jparams["kernel"]["lengthscales"] - 0.2
    tparams = params_from_numpy(jparams, device="cpu")
    for distance in ("euclidean", "covariance"):
        res = 0.35 if distance == "euclidean" else 0.8
        jre = jcovernet.make_device_recluster_fn(jmodel, (jnp.asarray(x), jnp.asarray(y)), res,
                                                 capacity, distance_type=distance)
        tre = tcovernet.make_device_recluster_fn(tmodel, (_t(x), _t(y)), res, capacity,
                                                 distance_type=distance)
        jout, tout = jre(jparams), tre(tparams)
        for leaf in ("inducing_points", "pseudo_u", "cluster_counts", "inducing_mask"):
            np.testing.assert_allclose(tout[leaf].numpy(), np.asarray(jout[leaf]), rtol=1e-12,
                                       atol=1e-12, err_msg=leaf)
        assert 8 < int(tout["inducing_mask"].sum()) < capacity
        assert tout["kernel"] is tparams["kernel"]
    if model_name == "implicit":  # the panel block is the pad multiple
        for module, model, data in ((jcovernet, jmodel, (jnp.asarray(x), jnp.asarray(y))),
                                    (tcovernet, tmodel, (_t(x), _t(y)))):
            with pytest.raises(ValueError, match="must be a multiple of 16"):
                module.make_device_recluster_fn(model, data, 0.35, 40)


def test_refusals_match_jax():
    x, y = _data(n=100)
    (jk, jkp), (tk, tkp) = _kernels()
    calls = [
        (lambda m, k, kp, a, b: m.covernet_update_inducing_parameters(
            (a, b), 0.3, lloyds=1, distance_type="covariance", kernel=k, kernel_params=kp),
         "euclidean-only"),
        (lambda m, k, kp, a, b: m.covernet_select(a, 0.3, distance_type="covariance"),
         "needs kernel and kernel_params"),
        (lambda m, k, kp, a, b: m.covernet_select(a, 0.3, distance_type="cosine"),
         "unknown distance_type"),
        (lambda m, k, kp, a, b: m.covernet_update_padded(
            a, b, 0.3, 64, lloyds=1, distance_type="correlation", kernel=k, kernel_params=kp),
         "euclidean-only"),
    ]
    for call, match in calls:
        with pytest.raises(ValueError, match=match):
            call(jcovernet, jk, jkp, jnp.asarray(x), jnp.asarray(y))
        with pytest.raises(ValueError, match=match):
            call(tcovernet, tk, tkp, _t(x), _t(y))
    for m, k, kp, a in ((jcovernet, jk, jkp, jnp.asarray(x)), (tcovernet, tk, tkp, _t(x))):
        with pytest.warns(UserWarning, match="only one center"):
            z, count = m.covernet_select(a, 2.0, distance_type="covariance", kernel=k,
                                         kernel_params=kp)
        assert count == 1
        with pytest.warns(UserWarning, match="kept all"):
            m.covernet_update_inducing_parameters((a[:20], a[:20, :1]), 1e-3)

