"""graph_captures.serve: the CUDA graphs PolicyServer captured during the
profiled requests (the port's `serve.capture` spans, each with its
shape); 0 while every shape keeps its graph."""


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
    if rec is None or not any(s.name == "serve.act" for s in rec.spans):
        return None
    return sum(s.name == "serve.capture" for s in rec.spans)
