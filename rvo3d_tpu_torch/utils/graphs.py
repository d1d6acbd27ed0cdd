"""Step loops replayed as CUDA graphs: the port's counterpart of the JAX
package running each loop of its main path as one compiled program (jit of
bench.py's scan, make_eval_chunk, the rollout step, the served forward).

A loop's body is one step that reads and writes static tensors: buffers
allocated once, which the caller fills (observations, pre-drawn random
numbers) and reads (the carry, the records) between steps. The body holds
no Python value that depends on the data, so one capture replays every
step:

  - the first call of `StepGraph.step` runs the body eagerly on a side
    stream: the warm-up, where the hand-written kernels are built with
    nvcc, the masked GRU's launch geometry is cached and cuBLAS takes its workspace on the
    stream the capture uses. It is a real step;
  - the second call captures the body on that stream (torch.cuda.graph)
    and replays it; every later call replays it.

A replay launches the captured kernels without Python, so what the body
counts while captured (its kernels' launches, the recorder's counters) is
kept in one list (profiler.capturing) and added again by each replay.

GraphedLoop is the loop every user runs (the bench chunk, bench.detail's
policy chunk, the eval chunk, the rollout, each served batch shape): it
owns the static carry, copied in before a call's first step and cloned out
after its last; the static inputs, which its `draw` makes before each
step outside the graph (random numbers with the same calls the eager loop
makes, so a replay gives the eager loop's numbers bit for bit and no
generator is registered with the graph; a served request); and the
optional [T, ...] records, written at a device step index. A capture that
fails raises: nothing falls back to eager. The callers run eager loops on
CPU tensors and never build a StepGraph there. Host spans cannot enter a
replay, so the rollout and eval steps write device timestamps of their own
inside the graph (GraphedLoop's `stamps`; utils/profiler.py reads them).

The learner's training steps (algo/ppo.PPOUpdate's policy and value
iterations, algo/bc.fit's step) are StepGraphs over bodies that run
autograd and an optimizer step, captured whole as PyTorch's whole-network
capture does: the forward, `backward()`, the clip and algo/adam.py's step. Such a
body enables grad itself, sets the gradients to None before its forward
and after its step (so the captured backward allocates them from the
graph's pool, and no gradient outlives a step), and finds its optimizer
state made by the warm-up, which is the first real iteration. Two
StepGraphs that never run at once may capture into one memory pool
(SharedPool): the policy and value steps of an update do.
"""

from __future__ import annotations

import gc
from typing import Any, Callable, Optional

import torch

from rvo3d_tpu_torch.utils import profiler

WARMUP = 1   # eager steps on the side stream before the capture


def on_card(device) -> bool:
    """Whether a loop on `device` runs as a CUDA graph (a CUDA device) or
    eagerly (the CPU): the one place the loops' factories ask."""
    return torch.device(device).type == "cuda"


def _side_stream(device: torch.device):
    return torch.cuda.Stream(device)


def _on_stream(stream, body: Callable[[], None]) -> None:
    """body() eagerly on `stream`, ordered after and before the current
    stream's work."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        body()
    current.wait_stream(stream)


class SharedPool:
    """One memory pool for the captures of StepGraphs that never run at
    once, made at the first of them (a pool exists only on a card)."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


def _capture(body: Callable[[], None], stream, pool=None):
    """body() captured on `stream` (into `pool`, a SharedPool's handle, or
    a pool of its own). The cyclic garbage collector runs just
    before and not during the capture: a dropped loop's graph lives in a
    reference cycle (the loop holds its StepGraph, which holds the loop's
    body), and freeing it mid-capture releases its memory with calls a
    capture refuses, which invalidates the capture."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            body()
    finally:
        if enabled:
            gc.enable()
    return graph


class StepGraph:
    """body() as one step of a loop on a CUDA device: warmed up, captured
    once and replayed (the module's docstring). `counts` is what the
    capture counted (profiler.tally's entries), `replays` the replays so far.
    `pool`: a SharedPool to capture into. The capture is recorded as the
    span `capture_span` (name, attributes; utils/profiler.py)."""

    def __init__(self, body: Callable[[], None], device,
                 pool: Optional[SharedPool] = None):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph runs on a CUDA device, not {dev}; "
                             "CPU tensors take the eager loop")
        self.body, self.pool = body, pool
        self.device = dev
        self.stream = _side_stream(dev)
        self.graph = None
        self.warmed = 0
        self.counts: list = []
        self.replays = 0
        self.capture_span = ("graph.capture", {})

    @torch.no_grad()
    def step(self) -> None:
        if self.warmed < WARMUP:
            _on_stream(self.stream, self.body)
            self.warmed += 1
            return
        if self.graph is None:
            name, attrs = self.capture_span
            with profiler.span(name, **attrs), profiler.capturing() as self.counts:
                self.graph = _capture(self.body, self.stream,
                                      None if self.pool is None else self.pool.handle())
        self.graph.replay()
        self.replays += 1
        for add, name, n in self.counts:
            add(name, n)


def clone_tree(tree: Any) -> Any:
    """Clones of the tensors of a tree of NamedTuples and tuples; other
    leaves (None, a generator) as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        items = [clone_tree(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def copy_tree_(dst: Any, src: Any) -> None:
    """Copy every tensor of `src` into the tensor at the same place of
    `dst`, in place; raises where the shapes or dtypes differ (a static
    buffer holds one step's values exactly)."""
    if isinstance(dst, torch.Tensor):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"static buffer {dst.dtype}{tuple(dst.shape)}, "
                             f"value {src.dtype}{tuple(src.shape)}")
        dst.copy_(src)
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            copy_tree_(d, s)


def fill_static(buffers: Any, tree: Any, device) -> Any:
    """`tree` copied into `buffers` (static_tree's, made from `tree` when
    None); returns the buffers."""
    if buffers is None:
        buffers = static_tree(tree, device)
    copy_tree_(buffers, tree)
    return buffers


def static_tree(tree: Any, device) -> Any:
    """Uninitialised tensors on `device` of the shapes and dtypes of a
    tree's tensors; other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=device)
    if isinstance(tree, tuple):
        items = [static_tree(x, device) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


class GraphedLoop:
    """A loop on a CUDA device whose step is `step(carry, inputs, t) ->
    (carry, records or None)`, run as one StepGraph over static tensors:

      - the carry is cloned from the first call's and copied in on each
        later call (carry None goes on from the last call's); each call
        returns a clone of its final carry;
      - `draw(carry, ctx)`, when given, makes a step's inputs before the
        step, outside the graph, from the call's `ctx` (a generator, a
        request); they are copied into static buffers;
      - `records(carry)`, when given, allocates [T, ...] buffers once, and
        each step's records go in at the device step index t (int64 [1],
        0 at each call's start). A call returns them as they are: they
        hold until the next call.
    `step` holds no Python value that depends on the data.

    What the loop records (utils/profiler.py), under the `name` its
    factory gives it (rollout, eval, bench, serve): each step the spans
    `<name>.draw`, `<name>.copy_in` and `<name>.replay`, each call
    `<name>.copy_out`, and the capture `<name>.capture` (with
    `capture_attrs`). `stamps=T` gives the loop a [T, 3] int64 buffer of
    device timestamps (ns) that the step writes at its index t: column 0
    at the step's start, 1 where the step calls `mark()` (the end of the
    policy's or the controller's work), 2 at its end; while the recorder
    is on, each call keeps a device clone of its steps' rows as
    `<name>.stamps`. The stamps are captured into the graph always and
    change no output. `timed`:
    while the recorder is on, each replay is bracketed by two CUDA events
    (the replay span's `device_ms`), and the host waits on the second
    before the copy out.

    loop(carry, steps, ctx=None) -> (carry, records or None)."""

    def __init__(self, step: Callable, device, draw: Optional[Callable] = None,
                 records: Optional[Callable] = None, name: str = "loop",
                 stamps: int = 0, timed: bool = False,
                 capture_attrs: Optional[dict] = None):
        self.graph = StepGraph(self._body, device)
        self.graph.capture_span = (f"{name}.capture", capture_attrs or {})
        self.step_fn, self.draw, self.make_records = step, draw, records
        self.carry = self.inputs = self.records = None
        self.t = torch.zeros(1, dtype=torch.int64, device=device)
        self.names = {k: f"{name}.{k}" for k in ("draw", "copy_in", "replay",
                                                 "copy_out", "stamps")}
        on_cuda = torch.device(device).type == "cuda"
        self.stamps = (torch.zeros((stamps, 3), dtype=torch.int64, device=device)
                       if stamps and on_cuda else None)
        self.timed = timed and on_cuda

    def mark(self) -> None:
        """Stamp the end of the policy's (or controller's) work in the
        current step."""
        profiler.stamp(self.stamps, self.t, 1)

    def _body(self) -> None:
        profiler.stamp(self.stamps, self.t, 0)
        carry, rec = self.step_fn(self.carry, self.inputs, self.t)
        if self.records is not None:
            for buf, x in zip(self.records, rec):
                buf.index_copy_(0, self.t, x[None])
        copy_tree_(self.carry, carry)
        profiler.stamp(self.stamps, self.t, 2)
        self.t.add_(1)

    def _replay(self, handle) -> None:
        if handle is None or not self.timed:
            self.graph.step()
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        self.graph.step()
        end.record()
        end.synchronize()
        profiler.device_time(handle, start, end)

    def __call__(self, carry: Any, steps: int, ctx: Any = None):
        if self.carry is None:
            self.carry = clone_tree(carry)
            if self.make_records is not None:
                self.records = self.make_records(carry)
        elif carry is not None:
            copy_tree_(self.carry, carry)
        self.t.zero_()
        names = self.names
        for _ in range(steps):
            if self.draw is not None:
                with profiler.span(names["draw"]):
                    inputs = self.draw(self.carry, ctx)
                with profiler.span(names["copy_in"]):
                    self.inputs = fill_static(self.inputs, inputs, self.t.device)
            with profiler.span(names["replay"]) as handle:
                self._replay(handle)
        with profiler.span(names["copy_out"]):
            out = clone_tree(self.carry)
        if self.stamps is not None:
            profiler.keep(names["stamps"], self.stamps[:steps])
        return out, self.records
