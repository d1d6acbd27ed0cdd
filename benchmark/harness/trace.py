"""The device trace of a traced window, reduced to what the metrics read.

What chip_smoke.py's `cuda_ops` and `device_us` read from a profile's
key_averages (commit 9c4d68f085eba6da2a2a461640d8c4e22e7131e6: the device
ops with their device time, the device spans of record_function ranges
left out, since they are no ops and would count their kernels twice),
`summarize` reads from the profiler's raw events, whose FunctionEvent
list a window of hundreds of thousands of kernels makes slow to build:
the kernels, copies and sets on the device (their union is the busy
time), their sums by name, and the idle gaps between them, each named by
the innermost harness span on the host that covers it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceSummary:
    window_s: float                       # the traced window, host clock
    busy_s: float                         # union of device op intervals
    ops: Dict[str, float]                 # device seconds by op name
    gaps: List[Tuple[str, float]] = field(default_factory=list)   # longest idle gaps

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s)

    def op_seconds(self, needle: str) -> float:
        """Device seconds of the ops whose name holds `needle`."""
        return sum(s for n, s in self.ops.items() if needle in n)

    def top_ops(self, k: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.ops.items(), key=lambda kv: -kv[1])[:k]


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals, sorted and disjoint."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _is_device(ev) -> bool:
    """A kernel, copy or set on the device (not a range's device span)."""
    kind = ev.activity_type() if hasattr(ev, "activity_type") else ""
    if kind:
        return kind in DEVICE_ACTIVITIES
    return str(ev.device_type()).endswith("CUDA") and not ev.is_user_annotation()


def _is_host(ev) -> bool:
    return str(ev.device_type()).endswith("CPU")


def summarize(events, window_s: float, span_names, start_ns: int, end_ns: int,
              n_gaps: int = 10) -> TraceSummary:
    """Reduce raw profiler events to a TraceSummary. Device events are
    clipped to [start_ns, end_ns], the host window; host ranges whose name
    is in `span_names` label the gaps."""
    dev: List[Tuple[int, int]] = []
    ops: Dict[str, float] = {}
    host: List[Tuple[int, int, str]] = []
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if _is_device(ev):
            s, e = max(s, start_ns), min(e, end_ns)
            if e <= s:
                continue
            dev.append((s, e))
            name = ev.name()
            ops[name] = ops.get(name, 0.0) + (e - s) * 1e-9
        elif _is_host(ev) and ev.name() in span_names:
            host.append((s, e, ev.name()))
    busy = merge(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    edges = [start_ns] + [x for iv in busy for x in iv] + [end_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return TraceSummary(window_s, busy_s, ops,
                        [(label_gap(g, host), (g[1] - g[0]) * 1e-9)
                         for g in gaps[:n_gaps]])


def label_gap(gap: Tuple[int, int], host: List[Tuple[int, int, str]]) -> str:
    """The innermost host span that covers the gap's middle, or "no span"."""
    mid = (gap[0] + gap[1]) // 2
    best: Optional[Tuple[int, int, str]] = None
    for s, e, name in host:
        if s <= mid <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "no span"


WINDOW = "trace.window"


class Tracer:
    """A torch.profiler window over CPU and CUDA activity. Enter and exit
    synchronise the device, and a profiler range named WINDOW marks the
    window between them, so the device events are cut to it on the
    profiler's own clock. On exit `summary` holds the TraceSummary, and
    run.trace_summary is set (to the first traced window of a run)."""

    def __init__(self, run):
        self.run = run
        self.summary: Optional[TraceSummary] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.run._annotate = True
        self.mark = record_function(WINDOW)
        self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.run._annotate = False
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events = list(self.prof.profiler.kineto_results.events())
        with self.run.span("trace.reduce"):
            self.summary = reduce_events(events, {s.name for s in self.run.spans})
        if self.run.trace_summary is None:
            self.run.trace_summary = self.summary
        return False


def reduce_events(events, span_names) -> TraceSummary:
    """summarize() over the WINDOW range's interval."""
    marks = [ev for ev in events if ev.name() == WINDOW and _is_host(ev)]
    if len(marks) != 1:
        raise RuntimeError(f"the profile holds {len(marks)} {WINDOW} ranges, not 1")
    start_ns = marks[0].start_ns()
    end_ns = start_ns + marks[0].duration_ns()
    return summarize(events, (end_ns - start_ns) * 1e-9, span_names, start_ns, end_ns)
