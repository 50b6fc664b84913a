"""The port's boundary: cggp_tpu_torch and chip_smoke.py never import jax or
cggp_tpu, and entry points never fall back to the CPU when no card is
present."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import cggp_tpu_torch
from cggp_tpu_torch.models.base import GaussianLikelihood
from cggp_tpu_torch.models.cggp import CGGP
from cggp_tpu_torch.models.itergpr import IterGPR
from cggp_tpu_torch.models.lpsvgp import LpSVGP
from cggp_tpu_torch.models.pathwise import PathwiseClusterGP
from cggp_tpu_torch.models.sgpr import SGPR
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.ops.kernels import Matern32
from cggp_tpu_torch.selection import covertree_update_inducing_parameters
from cggp_tpu_torch.training.batching import minibatch_index_iterator
from cggp_tpu_torch.utils.store import load_posterior, params_from_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted((ROOT / "cggp_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "cggp_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__"):
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_neither_jax_nor_the_jax_package(path):
    roots = set(_imported_roots(path))
    assert not roots & set(BANNED), f"{path.name} imports {sorted(roots & set(BANNED))}"


def test_port_package_and_smoke_script_exist():
    assert len(PORT_SOURCES) >= 22
    assert (ROOT / "cggp_tpu_torch" / "csrc" / "pallas_cg.cu").is_file()
    assert (ROOT / "cggp_tpu_torch" / "csrc" / "pallas_matvec.cu").is_file()
    for module in ("selection/__init__", "selection/covertree", "selection/kmeans",
                   "selection/native", "selection/points", "selection/update",
                   "training/batching", "training/monitor", "ops/rff", "ops/cg_implicit",
                   "ops/logdet", "models/rowcg", "models/implicit", "utils/store",
                   "models/gpr", "models/itergpr", "models/sgpr", "models/lpsvgp",
                   "models/pathwise", "data", "config"):
        assert ROOT / "cggp_tpu_torch" / f"{module}.py" in PORT_SOURCES, module


NATIVE_SOURCES = sorted(p for ext in ("*.cu", "*.cuh", "*.cc")
                        for p in (ROOT / "cggp_tpu_torch" / "csrc").glob(ext))


@pytest.mark.parametrize("path", NATIVE_SOURCES, ids=lambda p: p.name)
def test_native_source_includes_nothing_of_jax_or_the_jax_package(path):
    """The port's C++ and CUDA sources (the copied cover-tree source
    among them) include only their own headers and the toolchain's."""
    includes = [ln.split("#include", 1)[1].strip() for ln in path.read_text().splitlines()
                if ln.strip().startswith("#include")]
    for inc in includes:
        assert "jax" not in inc and "cggp_tpu" not in inc, f"{path.name}: #include {inc}"
        local = inc.startswith('"')
        assert not local or (path.parent / inc.strip('"')).is_file(), f"{path.name}: {inc}"
    assert any(p.name == "covertree.cc" for p in NATIVE_SOURCES)


@pytest.mark.parametrize("entry", ["resolve_device", "cggp_init_params", "likelihood",
                                   "params_from_numpy", "index_iterator", "covertree_update",
                                   "load_posterior", "itergpr_init_params", "sgpr_init_params",
                                   "lpsvgp_init_params", "pathwise_init_params"])
def test_entry_points_without_a_card_raise_instead_of_using_the_cpu(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = CGGP(kernel=Matern32(), conjugate_gradient=ConjugateGradient(1e-6))
    z = np.zeros((4, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "resolve_device":
            cggp_tpu_torch.resolve_device()
        elif entry == "cggp_init_params":
            model.init_params(z)
        elif entry == "likelihood":
            GaussianLikelihood().init_params()
        elif entry == "index_iterator":
            next(minibatch_index_iterator(0, 10, 4, 2))
        elif entry == "covertree_update":
            covertree_update_inducing_parameters((z, z[:, :1]), 0.5, backend="numpy")
        elif entry == "load_posterior":
            load_posterior("a-posterior-directory")  # the device is resolved before any read
        elif entry == "itergpr_init_params":
            IterGPR(kernel=Matern32()).init_params(2)
        elif entry == "sgpr_init_params":
            SGPR(kernel=Matern32()).init_params(z)
        elif entry == "lpsvgp_init_params":
            LpSVGP(kernel=Matern32()).init_params(z)
        elif entry == "pathwise_init_params":
            PathwiseClusterGP(kernel=Matern32()).init_params(z)
        else:
            params_from_numpy({"pseudo_u": z})
    # Asking for the CPU works.
    assert model.init_params(z, device="cpu")["inducing_points"].device.type == "cpu"


def test_resolve_device_switches_tf32_off_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        assert cggp_tpu_torch.resolve_device().type == "cuda"
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_float32_matmul_precision(before)


def test_build_reports_a_missing_compiler(monkeypatch, tmp_path):
    from cggp_tpu_torch import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
    assert len(_build.build_key()) == 16
