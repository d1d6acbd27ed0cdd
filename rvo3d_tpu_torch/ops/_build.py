"""Build the port's CUDA sources with nvcc into plain-C shared libraries and
load them with ctypes.

Each `csrc/<name>.cu` exposes `extern "C"` launchers that take raw device
pointers and a cudaStream_t, so no PyTorch header is compiled and the build
takes seconds. The library is written under `build/torch_kernels/` at the
repo root, named by a hash of its source, the shared headers (`csrc/*.cuh`)
and the flags, and reused while that hash holds. Nothing is built at import
time: the first CUDA launch builds. The wrappers in ops/ call a library's
functions through `launcher`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, Sequence

import torch

from rvo3d_tpu_torch.utils import profiler

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": nvcc wall time (0 when reused), "log": nvcc output, "path": .so}
BUILD_INFO: Dict[str, dict] = {}

# (states dtype, actions dtype) -> the dtype code vo_pairs_launch and
# env_drones_launch take
DTYPES = {(torch.float32, torch.float32): 0,
          (torch.float64, torch.float64): 1,
          (torch.float64, torch.float32): 2}


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


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(build(name))
        return lib


@contextlib.contextmanager
def _stream(device: torch.device):
    """The CUDA `device` made current; yields its current stream's handle."""
    if device.type != "cuda":
        raise ValueError(f"the hand-written kernels take CUDA tensors, got {device}")
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def add_launches(name: str, n: int) -> None:
    """n launches added to ops/<name>.py's `launches`."""
    sys.modules[f"{__package__}.{name}"].launches += n


def launcher(name: str, fn: str, argtypes: Sequence, stream: bool = True,
             counted: bool = True) -> Callable[..., None]:
    """csrc/<name>.cu's extern "C" `fn` (argtypes: all but the stream; it
    returns a cudaError_t) as f(device, *args): fn(*args) with the CUDA
    device current and, when `stream`, its current stream last; raises on a
    nonzero return, and when `counted` counts a launch (profiler.tally:
    a graph's replays count what its capture launched)."""
    signature = list(argtypes) + ([ctypes.c_void_p] if stream else [])

    def call(device, *args) -> None:
        with _stream(torch.device(device)) as handle:
            f = getattr(load(name), fn)
            if f.argtypes is None:
                f.argtypes, f.restype = signature, ctypes.c_int
            err = f(*args, handle) if stream else f(*args)
        if err != 0:
            raise RuntimeError(f"{fn} failed: cudaError {err}")
        if counted:
            profiler.tally(add_launches, name)
    return call
