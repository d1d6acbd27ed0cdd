"""mfu.train: model FLOPs of the profiled epoch (reference/counts: the
rollout's forward of encoder, actor and critic on every row, each policy
iteration's forward and backward of encoder and actor, each value
iteration's of encoder and critic) over the epoch's time from its
"rollout" to its "end" phase mark (CUDA events), over the H100's 67
TFLOP/s float32 peak, percent."""

from benchmark.harness.stats import share
from benchmark.reference.counts import F32_PEAK


def read(run):
    w = run.window
    if "traced_flops" not in w or not w.get("traced_epoch_s"):
        return None
    return share(w["traced_flops"] / w["traced_epoch_s"], F32_PEAK)
