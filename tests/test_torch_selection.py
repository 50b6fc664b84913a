"""Port parity for selection and its plumbing: k-means (labels, distances,
Lloyd), the three update functions, OIPS, greedy and uniform, the models'
re-clustering (``assign_clusters*``) and the minibatch streams of
``cggp_tpu_torch`` against ``cggp_tpu`` on the CPU, on the same numpy
inputs.  Where JAX draws a permutation from a PRNG key, the port's
``permutation`` is patched to return the same one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cggp_tpu_torch.selection.points as tpoints
from cggp_tpu.models.cggp import CGGP as JaxCGGP
from cggp_tpu.models.clustergp import ClusterGP as JaxClusterGP
from cggp_tpu.ops import kernels as jkernels
from cggp_tpu.ops.cg import ConjugateGradient as JaxConjugateGradient
from cggp_tpu.selection import (covertree_update_inducing_parameters as jax_covertree_update,
                                greedy_selection as jax_greedy,
                                kmeans_indices_and_distances as jax_kmeans_labels,
                                kmeans_lloyd as jax_kmeans_lloyd,
                                kmeans_update_inducing_parameters as jax_kmeans_update,
                                labels_update_inducing_parameters as jax_labels_update,
                                oips as jax_oips, uniform as jax_uniform)
from cggp_tpu.training.batching import (minibatch_index_iterator as jax_index_iterator,
                                        minibatch_iterator as jax_minibatch_iterator)
from cggp_tpu_torch import selection
from cggp_tpu_torch.models.cggp import CGGP
from cggp_tpu_torch.models.clustergp import ClusterGP
from cggp_tpu_torch.ops import kernels as tkernels
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.selection import kmeans as tkmeans
from cggp_tpu_torch.training.batching import (batched_indices, minibatch_index_iterator,
                                              minibatch_iterator, seed_from)
from cggp_tpu_torch.utils.store import params_from_numpy

torch.set_num_threads(1)


def _data(seed=0, n=600, dim=3, p=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, dim))
    y = np.sin(x[:, :1] * 1.5) + 0.1 * rng.standard_normal((n, p))
    return x, y


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("block", [None, 128])
def test_kmeans_labels_and_distances_match_jax(block, monkeypatch):
    # block=128 runs the port's row-block loop (5 blocks, the last ragged)
    # against JAX's single block: blocking changes no row's arithmetic.
    if block is not None:
        monkeypatch.setattr(tkmeans, "BLOCK", block)
    x, _ = _data()
    c = x[::37]
    labels, dist = tkmeans.kmeans_indices_and_distances(_t(c), _t(x))
    jlabels, jdist = jax_kmeans_labels(jnp.asarray(c), jnp.asarray(x))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    # fp64: the same |p|^2 + |c|^2 - 2 p.c formula, measured <= 2.3e-16 apart.
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=0, atol=1e-12)
    assert labels.dtype == torch.int64 and labels.shape == (600,)


@pytest.mark.parametrize("init", ["centroids", "key"])
def test_kmeans_lloyd_matches_jax(init, monkeypatch):
    x, _ = _data(n=800)
    k = 12
    if init == "centroids":
        start = x[5:5 + k]
        got_c, got_m = selection.kmeans_lloyd(_t(x), k, initial_centroids=_t(start))
        want_c, want_m = jax_kmeans_lloyd(jnp.asarray(x), k, initial_centroids=jnp.asarray(start))
    else:
        key = jax.random.PRNGKey(3)
        perm = np.asarray(jax.random.permutation(key, x.shape[0]))
        monkeypatch.setattr(tpoints, "permutation", lambda g, n: torch.as_tensor(perm.copy()))
        got_c, got_m = selection.kmeans_lloyd(_t(x), k, key=torch.Generator())
        want_c, want_m = jax_kmeans_lloyd(jnp.asarray(x), k, key=key)
    # fp64, the same assignments every iteration and so the same stop:
    # centroids measured equal, the mean distance <= 2.6e-16 apart relative.
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=1e-12)
    assert float(got_m) == pytest.approx(float(want_m), rel=1e-12)
    with pytest.raises(ValueError, match="initial_centroids or a generator"):
        selection.kmeans_lloyd(_t(x), k)


def test_kmeans_lloyd_segment_sums_in_blocks_match_jax(monkeypatch):
    # One-hot blocks of 128 rows (7 blocks, the last ragged) against JAX's
    # segment_sum: fp64, the same fixed point, centroids measured equal.
    monkeypatch.setattr(tkmeans, "ONEHOT_WORDS", 12 * 128)
    x, _ = _data(n=800)
    start = x[5:17]
    got_c, got_m = selection.kmeans_lloyd(_t(x), 12, initial_centroids=_t(start))
    want_c, want_m = jax_kmeans_lloyd(jnp.asarray(x), 12, initial_centroids=jnp.asarray(start))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=1e-12)
    assert float(got_m) == pytest.approx(float(want_m), rel=1e-12)


def test_kmeans_lloyd_empty_cluster_collapses_to_zero():
    # JAX's rule (count 1, so the empty cluster's centroid is 0), checked
    # against its closed form: the first centroid is the three points' mean.
    x = np.array([[1.0, 1.0], [1.1, 1.0], [0.9, 1.0]])
    start = np.array([[1.0, 1.0], [50.0, 50.0]])  # the second cluster stays empty
    got_c, got_m = selection.kmeans_lloyd(_t(x), 2, initial_centroids=_t(start))
    np.testing.assert_allclose(got_c.numpy(), [x.mean(axis=0), [0.0, 0.0]], rtol=0, atol=1e-15)
    assert float(got_m) == pytest.approx(np.abs(x[:, 0] - 1.0).mean(), rel=1e-12)


@pytest.mark.parametrize("p", [1, 3])
def test_update_functions_match_jax(p):
    # n = 800 and k = 12, the shapes of test_kmeans_lloyd_matches_jax: JAX
    # compiles its Lloyd loop once for both.
    x, y = _data(seed=1, n=800, p=p)
    tdata, jdata = (_t(x), _t(y)), (jnp.asarray(x), jnp.asarray(y))
    iv = x[::40]
    got = selection.labels_update_inducing_parameters(tdata, _t(iv))
    want = jax_labels_update(jdata, jnp.asarray(iv))
    got_k = selection.kmeans_update_inducing_parameters(
        tdata, lambda: selection.kmeans_lloyd(tdata[0], 12, initial_centroids=tdata[0][:12])[0])
    want_k = jax_kmeans_update(
        jdata, lambda: jax_kmeans_lloyd(jdata[0], 12, initial_centroids=jdata[0][:12])[0])
    got_c = selection.covertree_update_inducing_parameters(tdata, 0.8)
    want_c = jax_covertree_update(jdata, 0.8)
    # fp64 segment sums of the same labels: every triple measured equal;
    # held at 1e-12.
    for g, w in ((got, want), (got_k, want_k), (got_c, want_c)):
        assert [tuple(a.shape) for a in g] == [tuple(b.shape) for b in w]
        assert all(a.dtype == torch.float64 and a.device.type == "cpu" for a in g)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    assert got[1].shape == (iv.shape[0], p)
    assert float(got_c[2].sum()) == 800 and bool((got_c[2] > 0).all())


def test_update_keeps_the_data_dtype_and_gives_empty_clusters_count_one():
    x, y = _data(seed=2, n=200)
    iv = np.concatenate([x[:6], [[40.0, 40.0, 40.0]]])  # the last centre claims nothing
    z, u, counts = selection.labels_update_inducing_parameters(
        (_t(x).float(), _t(y).float()), _t(iv))
    assert z.dtype == u.dtype == counts.dtype == torch.float32
    assert float(counts[-1, 0]) == 1.0 and float(u[-1, 0]) == 0.0
    zc, uc, cc = selection.covertree_update_inducing_parameters(
        (_t(x).float(), _t(y).float()), 0.8, backend="numpy")
    assert zc.dtype == torch.float32 and float(cc.sum()) == 200


def test_oips_matches_jax():
    x, _ = _data(seed=3, n=300, dim=2)
    jk, tk = jkernels.SquaredExponential(), tkernels.SquaredExponential()
    jp = jk.init_params(variance=1.0, lengthscales=np.array([0.7, 0.7]), dtype=jnp.float64)
    tp = params_from_numpy(jp, device="cpu")
    z, idx = selection.oips(tk, tp, _t(x), rho=0.5, max_points=40)
    jz, jidx = jax_oips(jk, jp, jnp.asarray(x), rho=0.5, max_points=40)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    # The budget binds: rho = 0.9 accepts 78 points of 300 unbounded.
    z9, idx9 = selection.oips(tk, tp, _t(x), rho=0.9, max_points=40)
    assert idx9.shape == (40,)
    np.testing.assert_array_equal(idx9.numpy(), np.asarray(jax_oips(jk, jp, jnp.asarray(x),
                                                                    0.9, 40)[1]))


@pytest.mark.parametrize("duplicated", [False, True])
def test_greedy_and_uniform_match_jax_given_the_same_permutation(duplicated, monkeypatch):
    rng = np.random.default_rng(4)
    # 40 points either way (one JAX compile of the greedy scan for both).
    if duplicated:  # numerical rank ~10, 20 asked: no index is picked twice
        x = np.concatenate([rng.uniform(-1, 1, (10, 2))] * 4)
    else:
        x = rng.uniform(-2, 2, (40, 2))
    jk, tk = jkernels.Matern32(), tkernels.Matern32()
    jp = jk.init_params(dtype=jnp.float64)
    tp = params_from_numpy(jp, device="cpu")
    key = jax.random.PRNGKey(7)
    perm = np.asarray(jax.random.permutation(key, x.shape[0]))
    monkeypatch.setattr(tpoints, "permutation", lambda g, n: torch.as_tensor(perm.copy()))
    z, idx = selection.greedy_selection(tk, tp, _t(x), 20, torch.Generator())
    jz, jidx = jax_greedy(jk, jp, jnp.asarray(x), 20, key)
    # Past the numerical rank (10 distinct points) the residual variances are
    # rounding noise and the argmax of noise is not comparable: the
    # duplicated case measured the first 12 picks equal.
    same = 10 if duplicated else 20
    np.testing.assert_array_equal(idx.numpy()[:same], np.asarray(jidx)[:same])
    np.testing.assert_array_equal(z.numpy()[:same], np.asarray(jz)[:same])
    assert len(np.unique(idx.numpy())) == 20
    # jax.random.choice without replacement is permutation(key)[:k].
    zu, iu = selection.uniform(_t(x), 15, torch.Generator())
    jzu, jiu = jax_uniform(jnp.asarray(x), 15, key)
    np.testing.assert_array_equal(iu.numpy(), np.asarray(jiu))
    np.testing.assert_array_equal(zu.numpy(), np.asarray(jzu))


def test_permutation_is_a_seeded_permutation_on_the_generator_device():
    a = tpoints.permutation(torch.Generator().manual_seed(5), 50)
    b = tpoints.permutation(torch.Generator().manual_seed(5), 50)
    assert torch.equal(a, b) and sorted(a.tolist()) == list(range(50))


def _cggp_pair(capacity=None, m=12):
    x, y = _data(seed=5, n=300)
    common = dict(num_data=300, num_probes=3)
    jmodel = JaxCGGP(kernel=jkernels.Matern32(), conjugate_gradient=JaxConjugateGradient(1e-10),
                     **common)
    tmodel = CGGP(kernel=tkernels.Matern32(), conjugate_gradient=ConjugateGradient(1e-10),
                  **common)
    iv, u, counts = _selection(x, y, x[:m])
    jparams = jmodel.init_params(iv, pseudo_u=u, cluster_counts=counts, dtype=jnp.float64,
                                 capacity=capacity)
    return jmodel, jparams, tmodel, params_from_numpy(jparams, device="cpu"), (x, y)


def _selection(x, y, iv):
    """``(Z, u, counts)`` as numpy, from the port's labels update (held
    equal to JAX's in test_update_functions_match_jax)."""
    return [a.numpy() for a in selection.labels_update_inducing_parameters((_t(x), _t(y)),
                                                                           _t(iv))]


@pytest.mark.parametrize("capacity", [None, 16])
def test_assign_clusters_matches_jax(capacity):
    jmodel, jparams, tmodel, tparams, (x, y) = _cggp_pair(capacity)
    new = _selection(x, y, x[20:29])
    got = tmodel.assign_clusters(tparams, *new)
    want = jmodel.assign_clusters(jparams, *(jnp.asarray(a) for a in new))
    assert set(got) == set(want)
    for name in ("inducing_points", "pseudo_u", "cluster_counts", "inducing_mask"):
        if name in want:
            assert got[name].dtype == torch.float64
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), name)
    if capacity is not None:
        assert got["inducing_points"].shape[0] == capacity
        assert float(got["inducing_mask"].sum()) == 9
    # The plain ClusterGP swap, too.
    jc = JaxClusterGP(kernel=jkernels.Matern32()).assign_clusters(jparams, *new)
    tc = ClusterGP(kernel=tkernels.Matern32()).assign_clusters(tparams, *new)
    np.testing.assert_array_equal(tc["pseudo_u"].numpy(), np.asarray(jc["pseudo_u"]))


def test_assign_clusters_refusals_match_jax():
    jmodel, jparams, tmodel, tparams, (x, y) = _cggp_pair(capacity=16)
    big = _selection(x, y, x[:20])
    with pytest.raises(ValueError, match="exceeds the pinned capacity 16"):
        jmodel.assign_clusters(jparams, *(jnp.asarray(a) for a in big))
    with pytest.raises(ValueError, match="exceeds the pinned capacity 16"):
        tmodel.assign_clusters(tparams, *big)
    z = tparams["inducing_points"]
    with pytest.raises(ValueError, match="capacity mismatch"):
        tmodel.assign_clusters_device(tparams, z[:8], tparams["pseudo_u"][:8],
                                      tparams["cluster_counts"][:8],
                                      tparams["inducing_mask"][:8])
    same = tmodel.assign_clusters_device(tparams, z, tparams["pseudo_u"] + 1,
                                         tparams["cluster_counts"], tparams["inducing_mask"])
    assert torch.equal(same["pseudo_u"], tparams["pseudo_u"] + 1)
    _, _, _, plain, _ = _cggp_pair()
    with pytest.raises(ValueError, match="capacity-padded params"):
        tmodel.assign_clusters_device(plain, plain["inducing_points"], plain["pseudo_u"],
                                      plain["cluster_counts"], plain["cluster_counts"])


def test_index_blocks_match_jax_bit_for_bit():
    key = jax.random.PRNGKey(11)
    seed = int(jax.random.randint(key, (), 0, np.iinfo(np.int32).max))
    got = minibatch_index_iterator(seed, 103, 20, 3, device="cpu")
    want = jax_index_iterator(key, 103, 20, 3)
    for _ in range(4):  # two epochs (5 batches each, 3 dropped rows) and more
        g, w = next(got), np.asarray(next(want))
        assert g.dtype == torch.int64 and g.shape == (3, 20)
        np.testing.assert_array_equal(g.numpy(), w)
    x, y = _data(seed=6, n=50)
    tit = minibatch_iterator(seed, (_t(x), _t(y)), 16)
    jit_ = jax_minibatch_iterator(key, (jnp.asarray(x), jnp.asarray(y)), 16)
    for _ in range(4):
        (tx, ty), (jx, jy) = next(tit), next(jit_)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    tit = minibatch_iterator(seed, (_t(x), _t(y)), 16, drop_remainder=False)
    jit_ = jax_minibatch_iterator(key, (jnp.asarray(x), jnp.asarray(y)), 16,
                                  drop_remainder=False)
    for _ in range(5):  # the ragged last batch of the epoch (2 rows) included
        np.testing.assert_array_equal(next(tit)[0].numpy(), np.asarray(next(jit_)[0]))
    assert [b.tolist() for b in batched_indices(5, 2)] == [[0, 1], [2, 3], [4]]
    gen = torch.Generator().manual_seed(0)
    assert seed_from(gen) == seed_from(torch.Generator().manual_seed(0)) != seed_from(gen)
    assert seed_from(42) == 42


def test_covernet_names_raise_naming_their_item():
    for name in [n for n in selection.__all__ if n.startswith("covernet")]:
        with pytest.raises(NotImplementedError, match="item 10"):
            getattr(selection, name)()
