"""Build the port's CUDA sources with nvcc into plain-C shared libraries and
load them with ctypes.

Each `csrc/<name>.cu` exposes `extern "C"` launchers that take raw device
pointers and a cudaStream_t, so no PyTorch header is compiled and the build
takes seconds. The library is written under `build/torch_kernels/` at the
repo root, named by a hash of its source, the shared headers (`csrc/*.cuh`)
and the flags, and reused while that hash holds. Nothing is built at import
time: the first CUDA launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Callable, Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": nvcc wall time (0 when reused), "log": nvcc output, "path": .so}
BUILD_INFO: Dict[str, dict] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> str:
    """The library's path, named by a hash of its source, the headers of
    csrc/ (which a source may include) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for src in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless a library of the same hash exists.
    Returns the library's path; raises with nvcc's output on failure."""
    so = library_path(name)
    if os.path.exists(so):
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "", "path": so})
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "log": proc.stdout + proc.stderr, "path": so}
    return so


def load(name: str,
         on_load: Optional[Callable[[ctypes.CDLL], ctypes.CDLL]] = None) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use; `on_load`
    runs once on a newly loaded library (to set its ctypes signatures)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            if on_load is not None:
                lib = on_load(lib)
            _LIBS[name] = lib
        return lib
