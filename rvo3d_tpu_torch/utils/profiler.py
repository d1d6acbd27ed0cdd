"""Profiling and numerics-debug helpers (counterpart of
rvo3d_tpu/utils/profiler.py):

  trace(log_dir)       torch.profiler over CPU and, with a card, CUDA
                       activity; writes <log_dir>/trace.json (Chrome trace
                       format) and yields the profiler, whose
                       key_averages() sums the ops by name
  debug_nans(enable)   autograd anomaly detection with NaN checks, and a
                       forward hook on every module that raises on the
                       first non-finite output
  StepTimer            steps/s and their EMA
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = "rvo3d_trace") -> Iterator[torch.profiler.profile]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _raise_on_nonfinite(module, _inputs, output) -> None:
    outs = output if isinstance(output, (tuple, list)) else (output,)
    for x in outs:
        if (isinstance(x, torch.Tensor) and x.is_floating_point()
                and not bool(torch.isfinite(x).all())):
            raise FloatingPointError(
                f"non-finite output of {type(module).__name__} {tuple(x.shape)}")


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    if not enable:
        yield
        return
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    hook = torch.nn.modules.module.register_module_forward_hook(_raise_on_nonfinite)
    try:
        yield
    finally:
        hook.remove()
        torch.autograd.set_detect_anomaly(*prev)


class StepTimer:
    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._avg: Optional[float] = None
        self._last = time.perf_counter()
        self.total_steps = 0

    def tick(self, steps: int = 1) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.total_steps += steps
        rate = steps / dt if dt > 0 else 0.0
        self._avg = rate if self._avg is None else (
            self.ema * self._avg + (1 - self.ema) * rate)
        return rate

    @property
    def steps_per_sec(self) -> float:
        return self._avg or 0.0
