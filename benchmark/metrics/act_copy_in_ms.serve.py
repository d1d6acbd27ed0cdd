"""act_copy_in_ms.serve: the median (nearest rank) over the profiled
requests of their `serve.inputs` (numpy to host tensors) and
`serve.copy_in` (into the graph's static buffers) spans, host clock, ms."""

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
    return nearest_rank(list(per_request(rec, ("serve.inputs", "serve.copy_in")).values()),
                        0.5)
