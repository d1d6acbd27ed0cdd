"""ctypes loader for the native world-generation core
(rvo3d_tpu_torch/csrc/theta_star.cpp; counterpart of
rvo3d_tpu/worlds/gen/native.py).

Builds the library with g++ on first use into build/torch_kernels/ at the
repo root (named by a hash of the source and flags) and exposes Theta* and
line-of-sight with the same results as the Python implementations. The
planner picks native when the library builds and loads; RVO3D_NO_NATIVE=1
forces the Python planner. This is host code: no device runs it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC = os.path.join(_PKG, "csrc", "theta_star.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
# why the native planner is not in use (None while it is, or untried)
UNAVAILABLE: Optional[str] = None


def library_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"theta_star-{digest.hexdigest()[:16]}.so")


def _build() -> str:
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, UNAVAILABLE
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("RVO3D_NO_NATIVE"):
        UNAVAILABLE = "RVO3D_NO_NATIVE is set"
        return None
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.SubprocessError) as e:
        UNAVAILABLE = f"g++ build or load failed: {e!r}"
        return None
    lib.theta_star.restype = ctypes.c_int
    lib.theta_star.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    lib.los3d.restype = ctypes.c_int
    lib.los3d.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double,
    ]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


def theta_star_native(grid_safe: np.ndarray, start, goal, *, kg=1.0,
                      kh=1.25, ke=1.0, blocked_threshold=1.0,
                      samples_per_cell=3.0
                      ) -> Optional[Tuple[np.ndarray, int]]:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native planner is unavailable: {UNAVAILABLE}")
    g = np.ascontiguousarray(grid_safe, np.float64)
    ys, xs, zs = g.shape
    max_len = int(ys * xs * zs) + 1
    out = np.zeros((max_len, 3), np.int32)
    n = lib.theta_star(
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ys, xs, zs,
        float(start[0]), float(start[1]), float(start[2]),
        float(goal[0]), float(goal[1]), float(goal[2]),
        float(kg), float(kh), float(ke), float(blocked_threshold),
        float(samples_per_cell),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_len,
    )
    if n <= 0:
        return None
    return out[:n].astype(float), n


def los3d_native(grid: np.ndarray, p0, p1, samples_per_cell=3.0) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native planner is unavailable: {UNAVAILABLE}")
    g = np.ascontiguousarray(grid, np.float64)
    ys, xs, zs = g.shape
    return lib.los3d(
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ys, xs, zs,
        float(p0[0]), float(p0[1]), float(p0[2]),
        float(p1[0]), float(p1[1]), float(p1[2]), float(samples_per_cell),
    )
