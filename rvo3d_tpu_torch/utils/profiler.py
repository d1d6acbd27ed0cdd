"""Tracing and numerics-debug helpers (counterpart of
rvo3d_tpu/utils/profiler.py).

The recorder: what the port's layers record about their own work, for the
layers' metrics to read.

  span(name, **attrs)  a context manager around a block of host work; its
                       `__enter__` returns a handle (None when off)
  count(name, n=1)     adds n to a counter
  tally(add, name, n=1)   add(name, n); while a CUDA graph captures
                       (`capturing()`), (add, name, n) goes into the list
                       it yields instead, for each replay to add
                       (utils/graphs.StepGraph): `count`'s adds keep only
                       while on, ops/_build.launcher's launches always
  keep(name, x)        keeps a clone of tensor x, on x's device, made on
                       the current stream with no sync (the graphed loops'
                       device stamps, the evaluator's masks)
  device_time(handle, start, end)   keeps two CUDA events as the device
                       time of the span `handle` (attribute `device_ms`)
  stamp(buf, t, col)   launches the one-thread kernel that writes the
                       card's %globaltimer (ns) into buf[t, col], t an int64
                       device step index: a timestamp that a CUDA graph
                       holds (csrc/masked_gru.cu's `globaltimer_stamp`, not
                       counted as a launch); a no-op on CPU tensors and for
                       buf None
  recorded()           -> Recording(spans, counters, kept): device values
                       become host numbers here, never while recording
  clear()              forgets everything recorded

The switch: the recorder is on exactly while a torch profiler runs
(torch.profiler.profile, `trace` below). Off, `span` returns one shared
no-op context after a single check, and `count`, `keep` and
`device_time` return at once: nothing is allocated or recorded. On, each
span is also a profiler range of the same name (record_function's), so it
sits in the profiler's trace beside the device's work; its start and end are
time.time_ns() (Unix nanoseconds, the clock of the profiler's host
events) taken inside that range. Spans nest through their parent's index;
a span without a `request` attribute takes its parent's, so the spans of
one served request share its id. Python's garbage collections are
recorded as `gc.collect` spans (attribute `generation`) by a gc.callbacks
hook that checks the switch.

  trace(log_dir)       torch.profiler over CPU and, with a card, CUDA
                       activity, the recorder cleared at its start; writes
                       <log_dir>/trace.json (Chrome trace format) and
                       yields the profiler, whose key_averages() sums the
                       ops by name
  debug_nans(enable)   autograd anomaly detection with NaN checks, and a
                       forward hook on every module that raises on the
                       first non-finite output
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional

import torch

on = torch._C._autograd._profiler_enabled     # the switch: a profiler runs
# a profiler range of the given name: record_function's, entered in ~1 us
# where record_function takes ~10 us
profiler_range = torch._C._profiler._RecordFunctionFast


@dataclass
class Span:
    name: str
    start: int                 # ns, time.time_ns(): the profiler's host clock
    end: int
    parent: Optional[int]      # index of the enclosing span, None at the top
    attrs: Dict[str, Any] = field(default_factory=dict)


class Recording(NamedTuple):
    spans: List[Span]
    counters: Dict[str, float]
    kept: Dict[str, List[torch.Tensor]]    # name -> host copies, in keeping order


class _Recorder:
    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self.spans: List[list] = []        # [name, start, end, parent, attrs]
        self.stack: List[int] = []
        self.counters: Dict[str, float] = {}
        self.kept: Dict[str, List[torch.Tensor]] = {}
        self.timed: List[tuple] = []       # (span index, start event, end event)


_REC = _Recorder()


class _NoSpan:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "rf", "rec", "idx")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> int:
        self.rf = profiler_range(self.name)
        self.rf.__enter__()
        rec = _REC
        parent = rec.stack[-1] if rec.stack else None
        if parent is not None and "request" not in self.attrs:
            req = rec.spans[parent][4].get("request")
            if req is not None:
                self.attrs["request"] = req
        self.idx = len(rec.spans)
        self.rec = [self.name, time.time_ns(), None, parent, self.attrs]
        rec.spans.append(self.rec)
        rec.stack.append(self.idx)
        return self.idx

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        stack = _REC.stack
        if stack and stack[-1] == self.idx:
            stack.pop()
        self.rf.__exit__(None, None, None)
        return False


def span(name: str, **attrs):
    if not on():
        return _NO_SPAN
    return _Span(name, attrs)


_CAPTURED: Optional[List[tuple]] = None      # a capture's (add, name, n)


def tally(add: Callable[[str, float], None], name: str, n: float = 1) -> None:
    if _CAPTURED is not None:
        _CAPTURED.append((add, name, n))
    else:
        add(name, n)


def _add(name: str, n: float) -> None:
    if on():
        _REC.counters[name] = _REC.counters.get(name, 0) + n


def count(name: str, n: float = 1) -> None:
    tally(_add, name, n)


def counting() -> bool:
    """Whether `count` keeps anything: the recorder is on, or a graph captures."""
    return _CAPTURED is not None or on()


@contextlib.contextmanager
def capturing() -> Iterator[List[tuple]]:
    global _CAPTURED
    prev, _CAPTURED = _CAPTURED, []
    try:
        yield _CAPTURED
    finally:
        _CAPTURED = prev


def keep(name: str, x: torch.Tensor) -> None:
    if on():
        _REC.kept.setdefault(name, []).append(x.clone())


def device_time(handle: Optional[int], start, end) -> None:
    if handle is not None and on():
        _REC.timed.append((handle, start, end))


def stamp(buf: Optional[torch.Tensor], t: torch.Tensor, col: int) -> None:
    if buf is None or not buf.is_cuda:
        return
    from rvo3d_tpu_torch.ops import _build      # which imports this module

    stamp_launch = _build.launcher("masked_gru", "globaltimer_stamp", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int], counted=False)
    stamp_launch(buf.device, buf.data_ptr(), t.data_ptr(), col, buf.shape[0])


def recorded() -> Recording:
    rec = _REC
    spans = [Span(n, s, e, p, dict(a)) for n, s, e, p, a in rec.spans]
    for idx, start, end in rec.timed:
        spans[idx].attrs["device_ms"] = start.elapsed_time(end)
    return Recording(spans, dict(rec.counters),
                     {k: [x.cpu() for x in v] for k, v in rec.kept.items()})


def clear() -> None:
    _REC.clear()


_GC_OPEN: List[_Span] = []


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        if on():
            s = _Span("gc.collect", {"generation": info["generation"]})
            s.__enter__()
            _GC_OPEN.append(s)
    elif _GC_OPEN:
        _GC_OPEN.pop().__exit__(None, None, None)


gc.callbacks.append(_on_gc)


@contextlib.contextmanager
def trace(log_dir: str = "rvo3d_trace") -> Iterator[torch.profiler.profile]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear()
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
