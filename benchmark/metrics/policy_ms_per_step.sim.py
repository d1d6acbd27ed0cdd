"""policy_ms_per_step.sim: the mean over the profiled evaluation call's
graphed steps of policy_end - start, ms, from the device stamps the eval
step writes (`eval.stamps`): the biGRU encoder (the masked-GRU kernel),
the heads and the action's rounding."""


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
    return sum(float((s[:, 1] - s[:, 0]).sum()) for s in calls) * 1e-6 / steps
