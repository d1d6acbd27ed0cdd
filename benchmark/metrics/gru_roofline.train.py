"""gru_roofline.train: the masked-GRU kernel's launches in the profiled
epoch, their summed bound (reference/counts.gru_bound on the masks each
launch was given) over their device time in the trace, percent."""

from benchmark.harness.stats import share


def read(run):
    t, bound = run.trace_summary, run.window.get("traced_gru_bound_s")
    if t is None or bound is None:
        return None
    return share(bound, t.op_seconds("masked_gru"))
