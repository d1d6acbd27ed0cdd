"""busy_ms_per_step.sim: the device's busy time (union of its op
intervals) in the profiled evaluation call over the env-steps it ran."""


def read(run):
    t, steps = run.trace_summary, run.window.get("traced_env_steps")
    if t is None or not steps:
        return None
    return t.busy_s * 1e3 / steps
