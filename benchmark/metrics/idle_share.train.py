"""idle_share.train: 1 - the union of the device's kernel, copy and set
intervals over the profiled epoch's window, percent."""


def read(run):
    t = run.trace_summary
    if t is None or "epoch_ends" not in run.window:
        return None
    return 100.0 * t.idle_share
