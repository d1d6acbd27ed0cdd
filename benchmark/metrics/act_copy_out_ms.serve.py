"""act_copy_out_ms.serve: the median (nearest rank) over the profiled
requests of their `serve.copy_out` spans (the action's clone and its copy
to numpy, after the host has waited for the replay), host clock, ms."""

from benchmark.harness.stats import nearest_rank


def recording():
    """The recorder of the profiled window (rvo3d_tpu_torch/utils/profiler.py),
    or None where the port has none."""
    try:
        from rvo3d_tpu_torch.utils.profiler import recorded
    except ImportError:
        return None
    return recorded()


def per_request(rec, names):
    """{request id: the summed ms of its spans named in `names`} over the
    recorded `serve.act` requests."""
    ms = {s.attrs["request"]: 0.0 for s in rec.spans if s.name == "serve.act"}
    for s in rec.spans:
        if s.name in names and s.attrs.get("request") in ms:
            ms[s.attrs["request"]] += (s.end - s.start) * 1e-6
    return ms


def read(run):
    rec = recording()
    if rec is None:
        return None
    return nearest_rank(list(per_request(rec, ("serve.copy_out",)).values()), 0.5)
