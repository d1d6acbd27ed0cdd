"""gc_ms.train: the time of Python's garbage collections (the port's
`gc.collect` spans, host clock) inside the profiled epoch's
`train.epoch` span, ms."""


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
    if rec is None or "epoch_ends" not in run.window:
        return None
    epochs = [(s.start, s.end) for s in rec.spans if s.name == "train.epoch"]
    if not epochs:
        return None
    return sum(s.end - s.start for s in rec.spans if s.name == "gc.collect"
               and any(a <= s.start and s.end <= b for a, b in epochs)) * 1e-6
