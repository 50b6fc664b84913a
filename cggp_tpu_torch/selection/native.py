"""The native cover tree: ``csrc/covertree.cc`` compiled at first use
with the host's C++ compiler and OpenMP, loaded with ``ctypes``.

Host code, not a GPU kernel.  The library goes to
``_build/host-<key>/libcggp_covertree.so`` (git-ignored); the key hashes
the source, the flags and the CPU's model and feature flags, since
``-march=native`` code is specific to the CPU it was built on.  A build is
written to a private file and renamed into place, so concurrent builds
never load a half-written library.  Nothing runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "covertree.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "libcggp_covertree.so"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-fopenmp")
BUILD_TIMEOUT_S = 180

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cpu_identity() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            lines = [ln for ln in fh.read().splitlines()
                     if ln.startswith(("model name", "flags", "Features", "CPU part"))]
    except OSError:
        lines = []
    return platform.machine() + "\n" + "\n".join(sorted(set(lines)))


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(_cpu_identity().encode())
    return BUILD_DIR / f"host-{digest.hexdigest()[:16]}" / LIB_NAME


def compilers() -> list:
    """The host C++ compilers to try, in order: ``$CXX`` when set, then
    ``g++`` and ``c++`` from ``PATH`` (a ``$CXX`` without OpenMP support
    cannot build the source with these flags)."""
    found = [os.environ["CXX"]] if os.environ.get("CXX") else []
    return list(dict.fromkeys(found + ["g++", "c++"]))


def build() -> Path:
    """Compile the library unless this source's library exists, with the
    first of :func:`compilers` that succeeds; raises ``RuntimeError`` with
    every compiler's output when none does."""
    lib = library_path()
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.tmp{os.getpid()}.{threading.get_ident()}")
    errors = []
    try:
        for cxx in compilers():
            cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
            try:
                subprocess.run(cmd, check=True, capture_output=True, text=True,
                               timeout=BUILD_TIMEOUT_S)
            except subprocess.CalledProcessError as exc:
                errors.append(f"{' '.join(cmd)}:\n{exc.stdout}{exc.stderr}")
                continue
            except (subprocess.TimeoutExpired, OSError) as exc:
                errors.append(f"{' '.join(cmd)}: {exc}")
                continue
            os.replace(tmp, lib)
            return lib
    finally:
        tmp.unlink(missing_ok=True)
    raise RuntimeError("native cover-tree build failed:\n" + "\n".join(errors))


def load() -> ctypes.CDLL:
    """The cover tree's library, built on first use, with argument types set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f64p, i64p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
            lib.covertree_build.restype = ctypes.c_int
            lib.covertree_build.argtypes = [
                f64p, ctypes.c_int64, ctypes.c_int64,  # x, n, d
                ctypes.c_double, ctypes.c_int64,  # spatial_resolution, num_levels
                ctypes.c_int, ctypes.c_int,  # lloyds, voronoi
                f64p, i64p, i64p, i64p,  # centers, labels, num_centers, num_levels out
            ]
            lib.covertree_num_threads.restype = ctypes.c_int
            lib.covertree_num_threads.argtypes = []
            _lib = lib
    return _lib


def covertree_build_native(x: np.ndarray, spatial_resolution: Optional[float],
                           num_levels: int = 1, lloyds: bool = True,
                           voronoi: bool = True) -> Tuple[np.ndarray, np.ndarray, int]:
    """``(centers [M, D], labels [N], num_levels)`` of the tree over ``x``
    (fp64).  Raises ``RuntimeError`` when the library cannot be built or the
    C++ code rejects its input."""
    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float64)
    if x.ndim != 2:
        raise ValueError(f"covertree_build_native: x must be [N, D], got {x.shape}")
    n, d = x.shape
    centers = np.empty((n, d), dtype=np.float64)
    labels = np.empty((n,), dtype=np.int64)
    num_centers = ctypes.c_int64(0)
    levels_out = ctypes.c_int64(0)
    status = lib.covertree_build(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, d,
        ctypes.c_double(-1.0 if spatial_resolution is None else float(spatial_resolution)),
        int(num_levels), int(bool(lloyds)), int(bool(voronoi)),
        centers.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(num_centers), ctypes.byref(levels_out))
    if status != 0:
        raise RuntimeError(f"native cover-tree build returned {status} for x of shape {x.shape}")
    return centers[:int(num_centers.value)].copy(), labels, int(levels_out.value)
