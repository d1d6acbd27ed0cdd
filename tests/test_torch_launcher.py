"""The one launch seam of the hand-written kernels (ops/_build.launcher),
on the CPU: a fake library stands in for the built one and a fake stream
for the card's. Each launcher of ops/ and utils/profiler.stamp sets its
function's ctypes signature, passes the stream last where the function
takes one, raises RuntimeError naming its function and the cudaError on a
nonzero return and counts no launch then, and on a zero return counts one
launch in its library's `launches` (the occupancy query and the stamp
none)."""

import contextlib
import ctypes
import types

import pytest
import torch

from rvo3d_tpu_torch.ops import _build, env_drones, masked_gru, vo_pairs
from rvo3d_tpu_torch.utils import profiler

CUDA = torch.device("cuda", 0)
STREAM = 0x5EED
KERNELS = (masked_gru, vo_pairs, env_drones)
_BUF = types.SimpleNamespace(is_cuda=True, device=CUDA, data_ptr=lambda: 0, shape=(4, 3))

# function -> (library, a call through its launcher, takes a stream, counted)
LAUNCHERS = {
    "masked_gru_forward": ("masked_gru", lambda: masked_gru._forward(
        CUDA, ctypes.byref(masked_gru._Params()), 15, 1024), True, True),
    "masked_gru_max_active_clusters": ("masked_gru", lambda: masked_gru._max_clusters(
        CUDA, 48, 1024, ctypes.byref(ctypes.c_int())), False, False),
    "vo_pairs_launch": ("vo_pairs", lambda: vo_pairs._kernel(
        CUDA, ctypes.byref(vo_pairs._Params()), 1, 0, 4, 1024), True, True),
    "env_drones_launch": ("env_drones", lambda: env_drones._kernel(
        CUDA, ctypes.byref(env_drones._Params()), 2, 0, 4), True, True),
    "globaltimer_stamp": ("masked_gru", lambda: profiler.stamp(_BUF, _BUF, 1), True, False),
}


class FakeFunction:
    """A library function that returns `err` and keeps its calls."""

    def __init__(self, err: int):
        self.argtypes = self.restype = None
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


@contextlib.contextmanager
def fake_stream(device):
    assert device == CUDA
    yield STREAM


@pytest.mark.parametrize("err", [0, 700])
@pytest.mark.parametrize("fn", sorted(LAUNCHERS))
def test_a_launcher_checks_the_error_and_counts_what_ran(monkeypatch, fn, err):
    lib, call, stream, counted = LAUNCHERS[fn]
    fake = FakeFunction(err)
    monkeypatch.setitem(_build._LIBS, lib, types.SimpleNamespace(**{fn: fake}))
    monkeypatch.setattr(_build, "_stream", fake_stream)
    for mod in KERNELS:
        monkeypatch.setattr(mod, "launches", 0)
    if err:
        with pytest.raises(RuntimeError, match=f"{fn} failed: cudaError 700"):
            call()
    else:
        call()
    (args,) = fake.calls
    assert fake.restype is ctypes.c_int and len(fake.argtypes) == len(args)
    assert (args[-1] == STREAM and fake.argtypes[-1] is ctypes.c_void_p) == stream
    ran = counted and not err
    assert {m.__name__: m.launches for m in KERNELS} == {
        m.__name__: int(ran and m.__name__.endswith(f".{lib}")) for m in KERNELS}
