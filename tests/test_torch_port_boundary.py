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
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.ops.kernels import Matern32
from cggp_tpu_torch.utils.store import params_from_numpy

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
    assert len(PORT_SOURCES) >= 15
    assert (ROOT / "cggp_tpu_torch" / "csrc" / "pallas_cg.cu").is_file()
    assert (ROOT / "cggp_tpu_torch" / "csrc" / "pallas_matvec.cu").is_file()


@pytest.mark.parametrize("entry", ["resolve_device", "cggp_init_params", "likelihood",
                                   "params_from_numpy"])
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
