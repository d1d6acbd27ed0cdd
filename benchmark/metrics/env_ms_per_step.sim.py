"""env_ms_per_step.sim: the mean over the profiled evaluation call's
graphed steps of end - policy_end, ms, from the device stamps the eval
step writes (kept by the port's recorder as `eval.stamps`, [steps, 3]
ns: step start, policy end, step end): the env step, the episode records
and the resets."""


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
    calls = rec.kept.get("eval.stamps") if rec is not None else None
    if not calls or "traced_env_steps" not in run.window:
        return None
    steps = sum(len(s) for s in calls)
    return sum(float((s[:, 2] - s[:, 1]).sum()) for s in calls) * 1e-6 / steps
