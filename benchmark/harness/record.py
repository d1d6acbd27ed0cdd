"""What one run records: its spans (host clock, in memory, written out at
exit), its counters, what its driver kept of the window, and what the
trace said. Metric readers (benchmark/metrics/) read a `Run` and nothing
else."""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Span:
    name: str
    start: float          # time.perf_counter() seconds
    end: float
    parent: Optional[int]  # index of the enclosing span, None at the top
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Run:
    cell: str
    seed: int
    seconds: float
    trace: bool
    config: dict                    # the configuration file's contents
    workload: dict                  # the workload file's contents
    root: str                       # the checkout's root
    out_dir: str
    device: str = "cuda"            # the tests drive a run on "cpu"
    spans: List[Span] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)
    window: Dict[str, Any] = field(default_factory=dict)   # the driver's readings
    setup_s: Optional[float] = None
    trace_summary: Any = None       # harness.trace.TraceSummary of a traced run
    _stack: List[int] = field(default_factory=list)
    _annotate: bool = False         # spans also become profiler ranges
    _open: Dict[int, Any] = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """A span around the block; inside a traced window it is also a
        torch.profiler range, so the trace's idle gaps can be named by it."""
        idx = len(self.spans)
        self.spans.append(Span(name, time.perf_counter(), float("nan"),
                               self._stack[-1] if self._stack else None, attrs))
        self._stack.append(idx)
        rf = None
        if self._annotate:
            import torch
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        try:
            yield self.spans[idx]
        finally:
            if rf is not None:
                rf.__exit__(None, None, None)
            self._stack.pop()
            self.spans[idx].end = time.perf_counter()

    def open_span(self, name: str, **attrs) -> int:
        """Open a span that `close_span` ends (for marks a callback sees
        one at a time); spans opened so must nest."""
        cm = self.span(name, **attrs)
        cm.__enter__()
        self._open[len(self.spans) - 1] = cm
        return len(self.spans) - 1

    def close_span(self, idx: int) -> None:
        self._open.pop(idx).__exit__(None, None, None)

    def sync(self) -> None:
        """Wait for the device (nothing to wait for on the CPU)."""
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def write_spans(self) -> str:
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "spans.jsonl")
        with open(path, "w") as f:
            for s in self.spans:
                f.write(json.dumps({"name": s.name, "start": s.start, "end": s.end,
                                    "parent": s.parent, **s.attrs}) + "\n")
            f.write(json.dumps({"counters": self.counters}) + "\n")
        return path
