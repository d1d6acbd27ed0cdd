"""vo_roofline.flag: the summed bound (reference/vo_counts.bound_seconds)
of the VO pair kernel's launches in the profiled bench call, from the
launch shapes the port's recorder counts (`vo_pairs.<mode>.*`, graph
replays included), over the kernel's device time in the trace, percent."""

import torch

from benchmark.harness.stats import share
from benchmark.reference.vo_counts import bound_seconds


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
    if t is None or rec is None or "traced_env_steps" not in run.window:
        return None
    itemsize = getattr(torch, run.config["program"]["dtype"]).itemsize
    bound = bound_seconds(rec.counters, itemsize)
    return None if bound is None else share(bound, t.op_seconds("vo_pairs"))
