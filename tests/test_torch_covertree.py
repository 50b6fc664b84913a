"""Port parity for the cover tree: ``cggp_tpu_torch.selection.CoverTree``
(numpy, reference and native backends) against ``cggp_tpu``'s on the same
numpy inputs, the JAX package's invariants (``tests/test_covertree.py``,
``tests/test_native_covertree.py``, without the wall-clock tripwire), the
native library's build and fall-back rules, and its source kept a copy of
the JAX package's."""

import re
from pathlib import Path

import numpy as np
import pytest

from cggp_tpu.selection.covertree import CoverTree as JaxCoverTree
from cggp_tpu_torch.selection import native as tnative
from cggp_tpu_torch.selection.covertree import CoverTree

ROOT = Path(__file__).resolve().parent.parent
BACKENDS = ["numpy", "reference", "native"]


def _data(seed=0, n=600, dim=2, p=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, dim))
    y = np.sin(x[:, :1]) + 0.05 * rng.standard_normal((n, p))
    return x, y


def _trees(backend, data, **kw):
    return (CoverTree(None, data, backend=backend, **kw),
            JaxCoverTree(None, data, backend=backend, **kw))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", [
    dict(spatial_resolution=0.5),
    dict(spatial_resolution=0.3, lloyds=False, voronoi=False),
    dict(spatial_resolution=0.7, voronoi=False),
    dict(num_levels=4),
], ids=["res0.5", "plain", "no_voronoi", "levels4"])
def test_tree_matches_jax(backend, case):
    # The same construction from the same fp64 numpy inputs: the numpy and
    # reference backends run the same numpy code and measured bitwise equal;
    # the two native builds compile one source, but the Lloyd's mean adds
    # OpenMP partial sums in finishing order (csrc/covertree.cc): centres
    # measured up to 4.4e-16 apart, means and labels equal.  Centres and
    # means are held at 1e-12, labels, counts and the level count exactly.
    data = _data(dim=3 if backend == "native" else 2)
    t, j = _trees(backend, data, **case)
    assert t.num_levels == j.num_levels
    assert t.max_radius == pytest.approx(j.max_radius, rel=1e-15)
    assert len(t.level_centers) == len(j.level_centers)
    for tc, jc in zip(t.level_centers, j.level_centers):
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(t.labels, j.labels)
    (tm, tcnt), (jm, jcnt) = t.cluster_mean_and_counts, j.cluster_mean_and_counts
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tcnt, jcnt)
    assert [len(a) for a in t.cluster_ys] == [len(a) for a in j.cluster_ys]
    assert t.minimum_separation() == pytest.approx(j.minimum_separation(), rel=1e-12)


@pytest.mark.parametrize("backend", BACKENDS)
def test_invariants(backend):
    """Separation >= the last radius, labels the Voronoi cells, counts
    partition the data, means are the labelled points' means, radius
    snapping, and a finer resolution gives more centres."""
    x, y = _data(seed=1, n=500)
    res = 0.5
    tree = CoverTree(None, (x, y), spatial_resolution=res, backend=backend)
    assert tree.num_levels >= 2
    assert tree.max_radius == pytest.approx(res * 2 ** (tree.num_levels - 1))
    assert tree.minimum_separation(-1) >= res - 1e-9
    m = tree.centroids.shape[0]
    labels = tree.labels
    assert labels.shape == (500,) and labels.min() >= 0 and labels.max() < m
    means, counts = tree.cluster_mean_and_counts
    assert counts.sum() == 500
    if backend != "reference":  # the reference repartitions locally, not globally
        d = np.linalg.norm(x[:, None, :] - tree.centroids[None, :, :], axis=-1)
        np.testing.assert_array_equal(labels, d.argmin(axis=1))
    for c in range(m):
        sel = labels == c
        if sel.any():
            np.testing.assert_allclose(means[c, 0], y[sel].mean(), rtol=1e-10)
    coarse = CoverTree(None, (x, y), spatial_resolution=1.0, backend=backend)
    assert m > coarse.centroids.shape[0]


def test_multi_output_means_and_plotting_match_jax():
    x, y = _data(seed=3, n=120, p=3)
    t, j = _trees("numpy", (x, y), spatial_resolution=1.0)
    means, counts = t.cluster_mean_and_counts
    assert means.shape == (t.centroids.shape[0], 3)
    np.testing.assert_array_equal(means, j.cluster_mean_and_counts[0])
    for i in range(t.centroids.shape[0]):
        sel = t.labels == i
        np.testing.assert_allclose(means[i], y[sel].mean(axis=0), atol=1e-12)
        assert counts[i, 0] == sel.sum()
    # plotting=True forces the numpy backend and keeps every level's
    # pre-Voronoi claim labels: each point within its centre's radius.
    t, j = _trees("auto", (x, y), spatial_resolution=0.5, plotting=True)
    assert len(t.plotting_data) == t.num_levels == len(j.plotting_data)
    for level, (snap, jsnap) in enumerate(zip(t.plotting_data, j.plotting_data)):
        np.testing.assert_array_equal(snap["labels"], jsnap["labels"])
        np.testing.assert_array_equal(snap["centers"], jsnap["centers"])
        assert snap["radius"] == pytest.approx(t.max_radius / 2 ** level)
        d = np.linalg.norm(x - snap["centers"][snap["labels"]], axis=-1)
        assert np.all(d <= snap["radius"] + 1e-12)
    with pytest.raises(ValueError, match="not materialised"):
        CoverTree(None, (x, y), spatial_resolution=0.5, backend="native").minimum_separation(2)


def test_native_build_failure_raises_and_auto_falls_back(monkeypatch):
    def broken():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "build", broken)
    data = _data(n=200)
    with pytest.raises(RuntimeError, match="no compiler"):
        CoverTree(None, data, spatial_resolution=0.5, backend="native")
    with pytest.warns(RuntimeWarning, match="falling back to the numpy backend"):
        fallback = CoverTree(None, data, spatial_resolution=0.5, backend="auto")
    want = JaxCoverTree(None, data, spatial_resolution=0.5, backend="numpy")
    np.testing.assert_array_equal(fallback.centroids, want.centroids)


def test_native_library_is_built_under_the_port(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_lib", None)
    # A $CXX that cannot build the source (here: absent) gives way to g++.
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert tnative.compilers() == [str(tmp_path / "no-such-compiler"), "g++", "c++"]
    lib = tnative.library_path()
    assert lib.parent.parent == tmp_path and lib.parent.name.startswith("host-")
    assert tnative.build() == lib and lib.is_file()
    assert tnative.load().covertree_num_threads() >= 1
    with pytest.raises(RuntimeError, match="returned 1"):
        tnative.covertree_build_native(np.zeros((0, 2)), 0.5)
    lib.unlink()
    monkeypatch.setattr(tnative, "compilers", lambda: [str(tmp_path / "a"), str(tmp_path / "b")])
    with pytest.raises(RuntimeError, match="(?s)build failed.*/a .*/b "):
        tnative.build()
    assert not list(lib.parent.iterdir())  # no half-written library left


def test_native_source_is_a_copy_of_the_jax_source():
    """The port's csrc/covertree.cc: the JAX package's code line for line
    (comments aside), including only standard headers, naming no file of
    the JAX package."""
    def code(path):
        return [ln for ln in path.read_text().splitlines() if not ln.strip().startswith("//")]

    port = ROOT / "cggp_tpu_torch" / "csrc" / "covertree.cc"
    assert code(port) == code(ROOT / "cggp_tpu" / "native" / "covertree.cc")
    text = port.read_text()
    assert all(re.fullmatch(r'#include <[a-z_.]+>', ln.strip())
               for ln in text.splitlines() if ln.strip().startswith("#include"))
    assert not re.search(r"\bcggp_tpu/", text)
