"""The store of the port (``utils/store.py``) against the JAX package's
(``cggp_tpu/utils/store.py``), both ways: config directories, serving-cache
files of the dense ``CGGP`` (``"cg"`` and ``"chol"``), of the matrix-free
model (``RowCGGPPosterior``), of the exact GPs (``IterGPRPosterior``,
``GPRPosterior``) and of the baselines (``SGPRPosterior``,
``PathwisePosterior``) written by one package and served by the other
as the writer serves its in-memory cache, equal fingerprints, refused class
names, and the port's checkpoints."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cggp_tpu.models.cggp import CGGP as JaxCGGP
from cggp_tpu.models.implicit import ImplicitCGGP as JaxImplicitCGGP
from cggp_tpu.ops import kernels as jkernels
from cggp_tpu.ops.cg import ConjugateGradient as JaxConjugateGradient
from cggp_tpu.utils import store as jstore
from cggp_tpu_torch.models.cggp import CGGP, CGGPPosterior
from cggp_tpu_torch.models.implicit import ImplicitCGGP
from cggp_tpu_torch.models.rowcg import RowCGGPPosterior
from cggp_tpu_torch.ops import kernels as tkernels
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.utils import store as tstore

torch.set_num_threads(1)

M, N_QUERY = 20, 30


def _inputs():
    rng = np.random.default_rng(5)
    z = rng.uniform(-1, 1, (M, 2))
    u = rng.standard_normal((M, 1))
    counts = rng.integers(1, 6, (M, 1)).astype(np.float64)
    return z, u, counts, rng.uniform(-1, 1, (N_QUERY, 2))


def _pair(kind):
    z, u, counts, xq = _inputs()
    if kind == "implicit":
        common = dict(num_data=100, error_threshold=1e-16, max_cg_iterations=100, block=8,
                      precondition="pivchol", precond_rank=4)
        jmodel = JaxImplicitCGGP(kernel=jkernels.Matern32(), **common)
        tmodel = ImplicitCGGP(kernel=tkernels.Matern32(), **common)
    else:
        common = dict(num_data=100, precondition="pivchol", precond_rank=4)
        jmodel = JaxCGGP(kernel=jkernels.Matern32(), **common,
                         conjugate_gradient=JaxConjugateGradient(1e-16))
        tmodel = CGGP(kernel=tkernels.Matern32(), **common,
                      conjugate_gradient=ConjugateGradient(1e-16))
    jparams = jmodel.init_params(z, pseudo_u=u, cluster_counts=counts,
                                 lengthscales=np.array([0.8, 1.2]), dtype=jnp.float64)
    tparams = tstore.params_from_numpy(jparams, device="cpu")
    return jmodel, jparams, tmodel, tparams, xq


def _tree_equal(got, want):
    got, want = tstore.flatten_params(got), jstore.flatten_params(want)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], name)
        assert got[name].dtype == want[name].dtype, name


def test_config_dir_written_by_either_package_loads_in_the_other(tmp_path):
    jmodel, jparams, tmodel, tparams, _ = _pair("dense")
    trained = {**jparams, "kernel": {k: v * 1.5 for k, v in jparams["kernel"].items()}}
    info = {"model": "cdgp", "m": M}
    jstore.save_config_dir(tmp_path / "jax", trained, info)
    flat, got_info = tstore.load_config_dir(tmp_path / "jax")
    assert got_info == info
    into_port = tstore.assign_flat(tparams, flat)
    _tree_equal(into_port, trained)
    assert into_port["kernel"]["variance"].dtype == torch.float64

    tstore.save_config_dir(tmp_path / "port", into_port, info)
    jflat, jinfo = jstore.load_config_dir(tmp_path / "port")
    assert jinfo == info
    _tree_equal(into_port, jstore.assign_flat(jparams, jflat))
    # Names the destination lacks are ignored; leaves without a name kept.
    partial = tstore.assign_flat(tparams, {"kernel/variance": np.asarray(2.0), "other": 1})
    assert float(partial["kernel"]["variance"]) == 2.0
    assert partial["inducing_points"] is tparams["inducing_points"]
    tstore.store_as_json(tmp_path / "out" / "results.json", {"rmse": 0.1})
    assert json.loads((tmp_path / "out" / "results.json").read_text()) == {"rmse": 0.1}


def _serve_jax(jmodel, post, xq):
    return [np.asarray(a) for a in jmodel.posterior_predict(post, jnp.asarray(xq))]


def _serve_port(tmodel, post, xq):
    return [a.numpy() for a in tmodel.posterior_predict(post, torch.as_tensor(xq))]


# Served from one cache file, the two packages' outputs measured <= 1.6e-9
# apart (the variances: each package's own float64 CG solve of the Kmn rows
# at the absolute threshold 1e-16, run to the curvature guard; the means and
# the Cholesky route <= 1.4e-14).  Held at 1e-8.
CROSS_ATOL = 1e-8


@pytest.mark.parametrize("kind,solver", [("dense", "cg"), ("dense", "chol"),
                                         ("implicit", "cg")])
def test_posterior_cache_files_serve_alike_in_both_packages(tmp_path, kind, solver):
    jmodel, jparams, tmodel, tparams, xq = _pair(kind)
    cls = RowCGGPPosterior if kind == "implicit" else CGGPPosterior
    # JAX writes, the port reads and serves as JAX serves its own cache.
    jpost = jmodel.posterior(jparams, solver=solver)
    jstore.save_posterior(tmp_path / "jax", jpost)
    loaded = tstore.load_posterior(tmp_path / "jax", device="cpu")
    assert type(loaded) is cls
    for got, want in zip(_serve_port(tmodel, loaded, xq), _serve_jax(jmodel, jpost, xq)):
        np.testing.assert_allclose(got, want, rtol=0, atol=CROSS_ATOL)
    # The port writes, JAX reads and serves as the port serves its own.
    tpost = tmodel.posterior(tparams, solver=solver)
    tstore.save_posterior(tmp_path / "port", tpost)
    desc = json.loads((tmp_path / "port" / "posterior.json").read_text())
    assert desc["class"][0].startswith("cggp_tpu.models.")  # the JAX package's name
    jloaded = jstore.load_posterior(tmp_path / "port")
    assert type(jloaded).__name__ == cls.__name__
    for got, want in zip(_serve_jax(jmodel, jloaded, xq), _serve_port(tmodel, tpost, xq)):
        np.testing.assert_allclose(got, want, rtol=0, atol=CROSS_ATOL)
    # The port's own round trip is exact.
    again = tstore.load_posterior(tmp_path / "port", device="cpu")
    for got, want in zip(_serve_port(tmodel, again, xq), _serve_port(tmodel, tpost, xq)):
        np.testing.assert_array_equal(got, want)


def _exact_gp_pair(kind):
    """JAX's and the port's exact GP (``IterGPR`` at N = 200 padded to 256 by
    block 64, or the dense ``GPR``), float64, with the training data and
    query points."""
    from cggp_tpu.models.gpr import GPR as JaxGPR
    from cggp_tpu.models.itergpr import IterGPR as JaxIterGPR
    from cggp_tpu_torch.models import GPR, IterGPR

    rng = np.random.default_rng(6)
    x = rng.uniform(-1.5, 1.5, (200, 2))
    y = np.sin(x.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((200, 1))
    if kind == "itergpr":
        common = dict(error_threshold=1e-16, max_cg_iterations=800, relative_threshold=False,
                      precondition="pivchol", precond_rank=8, block=64)
        jmodel = JaxIterGPR(kernel=jkernels.Matern32(), **common)
        tmodel = IterGPR(kernel=tkernels.Matern32(), **common)
    else:
        jmodel, tmodel = JaxGPR(kernel=jkernels.Matern32()), GPR(kernel=tkernels.Matern32())
    jparams = jmodel.init_params(2, lengthscales=np.array([0.6, 0.8]), dtype=jnp.float64)
    return jmodel, jparams, tmodel, tstore.params_from_numpy(jparams, device="cpu"), (x, y), \
        rng.uniform(-1.5, 1.5, (N_QUERY, 2))


@pytest.mark.parametrize("kind", ["itergpr", "gpr"])
def test_exact_gp_cache_files_serve_alike_in_both_packages(tmp_path, kind):
    """The exact GP caches (``IterGPRPosterior`` with its 56 pad rows and
    mask, ``GPRPosterior``), written by one package and served by the other
    as the writer serves its own, at ``CROSS_ATOL`` (each package's own
    float64 solve of the query rows at absolute 1e-16)."""
    from cggp_tpu_torch.models import GPRPosterior, IterGPRPosterior

    jmodel, jparams, tmodel, tparams, (x, y), xq = _exact_gp_pair(kind)
    cls = IterGPRPosterior if kind == "itergpr" else GPRPosterior
    jpost = jmodel.posterior(jparams, (jnp.asarray(x), jnp.asarray(y)))
    jstore.save_posterior(tmp_path / "jax", jpost)
    loaded = tstore.load_posterior(tmp_path / "jax", device="cpu")
    assert type(loaded) is cls and loaded._fields == jpost._fields
    if kind == "itergpr":
        assert loaded.x_train.shape == (256, 2) and float(loaded.mask.sum()) == 200
    for got, want in zip(_serve_port(tmodel, loaded, xq), _serve_jax(jmodel, jpost, xq)):
        np.testing.assert_allclose(got, want, rtol=0, atol=CROSS_ATOL)
    tpost = tmodel.posterior(tparams, (x, y))
    tstore.save_posterior(tmp_path / "port", tpost)
    desc = json.loads((tmp_path / "port" / "posterior.json").read_text())
    assert desc["class"] == [f"cggp_tpu.models.{kind}", cls.__name__]
    jloaded = jstore.load_posterior(tmp_path / "port")
    assert type(jloaded).__name__ == cls.__name__
    for got, want in zip(_serve_jax(jmodel, jloaded, xq), _serve_port(tmodel, tpost, xq)):
        np.testing.assert_allclose(got, want, rtol=0, atol=CROSS_ATOL)


def test_fingerprints_are_equal_across_the_packages():
    for kind in ("dense", "implicit"):
        _, jparams, _, tparams, _ = _pair(kind)
        for extra in ("", "dataset-a"):
            want = jstore.posterior_fingerprint("CGGP", jparams, extra)
            assert tstore.posterior_fingerprint("CGGP", tparams, extra) == want
        changed = {**tparams, "pseudo_u": tparams["pseudo_u"] + 1e-12}
        assert tstore.posterior_fingerprint("CGGP", changed) != tstore.posterior_fingerprint(
            "CGGP", tparams)


@pytest.mark.parametrize("name", [["os", "system"], ["cggp_tpu.models.cggp", "CGGP"],
                                  ["cggp_tpu_torch.models.rowcg", "RowCGGPPosterior"]])
def test_unknown_posterior_class_names_are_refused(tmp_path, name):
    _, _, tmodel, tparams, _ = _pair("implicit")
    tstore.save_posterior(tmp_path, tmodel.posterior(tparams, solver="cg"))
    path = tmp_path / "posterior.json"
    desc = json.loads(path.read_text())
    desc["class"] = name
    path.write_text(json.dumps(desc))
    with pytest.raises(ValueError, match="refusing"):
        tstore.load_posterior(tmp_path, device="cpu")
    with pytest.raises(TypeError):
        tstore.save_posterior(tmp_path / "other", tstore.AdamState(0, {}, {}))


def test_checkpoint_round_trip(tmp_path):
    _, _, _, tparams, _ = _pair("dense")
    with pytest.raises(FileNotFoundError):
        tstore.load_checkpoint(tmp_path, tparams)
    later = {**tparams, "kernel": {k: v + 1.0 for k, v in tparams["kernel"].items()}}
    tstore.save_checkpoint(tmp_path, tparams, step=1)
    tstore.save_checkpoint(tmp_path, later, step=3)
    _tree_equal(tstore.load_checkpoint(tmp_path, tparams), tstore.flatten_params(later))
    _tree_equal(tstore.load_checkpoint(tmp_path, tparams, step=1),
                tstore.flatten_params(tparams))
    like32 = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
              for k, v in tparams.items()}
    restored = tstore.load_checkpoint(tmp_path, like32, step=1)
    assert restored["inducing_points"].dtype == torch.float32
    wrong = {**tparams, "pseudo_u": torch.zeros(M + 1, 1, dtype=torch.float64)}
    with pytest.raises(ValueError, match="pseudo_u"):
        tstore.load_checkpoint(tmp_path, wrong)
    (tmp_path / "7").mkdir()  # a step directory of another format
    (tmp_path / "7" / "format.json").write_text(json.dumps({"format": "orbax"}))
    with pytest.raises(ValueError, match="no checkpoint of this package"):
        tstore.load_checkpoint(tmp_path, tparams)


def _baseline_posteriors(kind):
    """JAX's and the port's caches of the same parameters: ``SGPRPosterior``
    (data-bound) or a ``PathwisePosterior`` (from a ``PathwiseClusterGP``,
    each package's own draws), with each package's model."""
    import jax
    from cggp_tpu.models import PathwiseClusterGP as JaxPathwiseClusterGP
    from cggp_tpu.models import SGPR as JaxSGPR
    from cggp_tpu_torch.models import PathwiseClusterGP, SGPR

    z, u, counts, xq = _inputs()
    rng = np.random.default_rng(8)
    x, y = rng.uniform(-1, 1, (50, 2)), rng.standard_normal((50, 1))
    if kind == "sgpr":
        jmodel, tmodel = JaxSGPR(kernel=jkernels.Matern32()), SGPR(kernel=tkernels.Matern32())
        jparams = jmodel.init_params(jnp.asarray(z), lengthscales=np.array([0.8, 1.2]),
                                     dtype=jnp.float64)
        tparams = tstore.params_from_numpy(jparams, device="cpu")
        jpost = jmodel.posterior(jparams, (jnp.asarray(x), jnp.asarray(y)))
        tpost = tmodel.posterior(tparams, (x, y))
    else:
        common = dict(num_data=100, num_bases=16, num_samples=3)
        jmodel = JaxPathwiseClusterGP(jkernels.Matern32(), **common)
        tmodel = PathwiseClusterGP(tkernels.Matern32(), **common)
        jparams = jmodel.init_params(jnp.asarray(z), pseudo_u=u, cluster_counts=counts,
                                     dtype=jnp.float64)
        tparams = tstore.params_from_numpy(jparams, device="cpu")
        jpost = jmodel.pathwise_posterior(jparams, jax.random.PRNGKey(0))
        tpost = tmodel.pathwise_posterior(tparams, torch.Generator().manual_seed(0))
    return jmodel, jpost, tmodel, tpost, xq


def _serve(model, post, xq, port):
    from cggp_tpu.models import pathwise_samples_at as jax_samples_at
    from cggp_tpu_torch.models import pathwise_samples_at

    if hasattr(post, "weights"):
        out = (pathwise_samples_at(model, post, torch.as_tensor(xq)) if port
               else jax_samples_at(model, post, jnp.asarray(xq)),)
    else:
        out = model.posterior_predict(post, torch.as_tensor(xq) if port else jnp.asarray(xq))
    return [a.numpy() if port else np.asarray(a) for a in out]


def _leaves_equal(got, want):
    got, want = tstore.flatten_params(got._asdict()), tstore.flatten_params(want._asdict())
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], name)


@pytest.mark.parametrize("kind", ["sgpr", "pathwise"])
def test_baseline_posterior_files_round_trip_exactly_across_the_packages(tmp_path, kind):
    """``SGPRPosterior`` and ``PathwisePosterior`` files written by either
    package load in the other with every array bitwise the writer's, and
    serve as the writer serves its own cache, bitwise."""
    from cggp_tpu_torch.models import PathwisePosterior, SGPRPosterior

    jmodel, jpost, tmodel, tpost, xq = _baseline_posteriors(kind)
    cls = SGPRPosterior if kind == "sgpr" else PathwisePosterior
    jstore.save_posterior(tmp_path / "jax", jpost)
    loaded = tstore.load_posterior(tmp_path / "jax", device="cpu")
    assert type(loaded) is cls and loaded._fields == jpost._fields
    _leaves_equal(loaded, jpost)
    for got, want in zip(_serve(tmodel, loaded, xq, True), _serve(jmodel, jpost, xq, False)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)  # measured <= 1.3e-14
    tstore.save_posterior(tmp_path / "port", tpost)
    desc = json.loads((tmp_path / "port" / "posterior.json").read_text())
    assert desc["class"] == [f"cggp_tpu.models.{kind}", cls.__name__]
    jloaded = jstore.load_posterior(tmp_path / "port")
    assert type(jloaded).__name__ == cls.__name__
    _leaves_equal(jloaded, tpost)
    again = tstore.load_posterior(tmp_path / "port", device="cpu")
    _leaves_equal(again, tpost)
    for got, want in zip(_serve(tmodel, again, xq, True), _serve(tmodel, tpost, xq, True)):
        np.testing.assert_array_equal(got, want)
