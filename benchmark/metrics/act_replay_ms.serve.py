"""act_replay_ms.serve: the median (nearest rank) over the profiled
requests of their graph replay's device time, ms: two CUDA events around
the replay, outside the graph (the `device_ms` of the port's
`serve.replay` spans)."""

from benchmark.harness.stats import nearest_rank


def recording():
    """The recorder of the profiled window (rvo3d_tpu_torch/utils/profiler.py),
    or None where the port has none."""
    try:
        from rvo3d_tpu_torch.utils.profiler import recorded
    except ImportError:
        return None
    return recorded()


def read(run):
    rec = recording()
    if rec is None:
        return None
    return nearest_rank([s.attrs["device_ms"] for s in rec.spans
                         if s.name == "serve.replay" and "device_ms" in s.attrs], 0.5)
