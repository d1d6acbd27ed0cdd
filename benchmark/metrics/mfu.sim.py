"""mfu.sim: model FLOPs of the profiled evaluation call (reference/counts.
policy_flops of the encoder, the actor and the critic, which the eval step
runs both, on the masks each step gave the kernel, kept by the port's
recorder as `eval.obs_mask`) over the call's traced window, over the
H100's 67 TFLOP/s float32 peak, percent."""

from benchmark.harness.stats import share
from benchmark.reference.counts import F32_PEAK, policy_flops
from benchmark.reference.policy import encoder_mask


def recording():
    """The recorder of the profiled window (rvo3d_tpu_torch/utils/profiler.py),
    or None where the port has none."""
    try:
        from rvo3d_tpu_torch.utils.profiler import recorded
    except ImportError:
        return None
    return recorded()


def read(run):
    t, rec = run.trace_summary, recording()
    masks = rec.kept.get("eval.obs_mask") if rec is not None else None
    if t is None or not masks or "traced_env_steps" not in run.window:
        return None
    model = run.config["program"]["model"]
    flops = sum(policy_flops(encoder_mask(m.reshape(-1, m.shape[-1])).t(), model, "both")
                for m in masks)
    return share(flops / t.window_s, F32_PEAK)
