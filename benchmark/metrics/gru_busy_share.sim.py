"""gru_busy_share.sim: the masked-GRU kernel's device time over all the
device's busy time in the profiled evaluation call, percent."""

from benchmark.harness.stats import share


def read(run):
    t = run.trace_summary
    if t is None or "traced_env_steps" not in run.window:
        return None
    return share(t.op_seconds("masked_gru"), t.busy_s)
