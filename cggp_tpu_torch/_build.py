"""Build the package's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, started together) and linked into one shared library with a plain
``extern "C"`` interface, ``_build/<key>/libcggp_tpu_torch_kernels.so``.  The
key hashes the sources and flags, so an edit rebuilds and an unchanged tree
reuses the library.  ``_build/`` is git-ignored.  Each ``nvcc`` call has a
time limit; a missing ``nvcc`` raises with the places that were searched.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libcggp_tpu_torch_kernels.so"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
# No -use_fast_math: it flushes denormals and changes division.  -Xptxas -v
# prints registers, shared memory and spills of each kernel into build.log.
NVCC_FLAGS = GENCODE + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 300

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``/``$CUDA_PATH``, ``PATH``, or the toolkit's
    default prefix ``/usr/local/cuda``."""
    candidates = [Path(os.environ[var]) / "bin" / "nvcc"
                  for var in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(var)]
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for candidate in candidates:
        if candidate.is_file():
            return str(candidate)
    raise RuntimeError(
        "cggp_tpu_torch: nvcc (the CUDA compiler) was not found; searched "
        + ", ".join(str(c) for c in candidates)
        + ". Set CUDA_HOME to the CUDA toolkit or put nvcc on PATH."
    )


def _run(cmd) -> str:
    try:
        done = subprocess.run(cmd, timeout=NVCC_TIMEOUT_S, check=True,
                              capture_output=True, text=True)
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{exc.stdout}{exc.stderr}") from exc
    return done.stdout + done.stderr


def build_key() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / build_key() / LIB_NAME


def build() -> Path:
    """Compile the kernels unless this tree's library already exists."""
    lib = library_path()
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC_DIR.glob("*.cu"))
    # A private directory per process, renamed into place at the end, so two
    # processes building at once never see each other's half-written files.
    work = Path(tempfile.mkdtemp(dir=lib.parent))
    try:
        def compile_one(src: Path) -> str:
            obj = work / (src.stem + ".o")
            return _run([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)])

        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            logs = list(pool.map(compile_one, sources))
        objects = [str(work / (src.stem + ".o")) for src in sources]
        logs.append(_run([nvcc, *GENCODE, "-shared", "-o", str(work / LIB_NAME), *objects]))
        (lib.parent / "build.log").write_text("\n".join(logs))
        os.replace(work / LIB_NAME, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


def build_log() -> str:
    """The compiler's report (registers, shared memory, spills) of the build."""
    log = library_path().parent / "build.log"
    return log.read_text() if log.is_file() else ""


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use, with argument types set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.cggp_pallas_matvec.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
            lib.cggp_pallas_matvec.restype = i32
            lib.cggp_cg_grid.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
            lib.cggp_cg_grid.restype = i32
            lib.cggp_pallas_cg_solve.argtypes = [ptr] * 9 + [i32, i32, f32, i32, i32, ptr]
            lib.cggp_pallas_cg_solve.restype = i32
            lib.cggp_error_string.argtypes = [i32]
            lib.cggp_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        name = load().cggp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({name})")
