"""mfu.serve: encoder and actor-head FLOPs of the requests served in the
window (reference/counts), the profiled ones left out, over the window's
time without them, over the H100's 67 TFLOP/s float32 peak, percent."""

from benchmark.harness.stats import share
from benchmark.reference.counts import F32_PEAK


def read(run):
    w = run.window
    if "served_flops" not in w:
        return None
    return share(w["served_flops"] / (w["end"] - w["start"] - w.get("traced_s", 0.0)),
                 F32_PEAK)
