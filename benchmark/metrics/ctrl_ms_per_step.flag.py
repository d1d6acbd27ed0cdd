"""ctrl_ms_per_step.flag: the mean over the profiled bench call's graphed
steps of mark - start, ms, from the device stamps the bench step writes
(kept by the port's recorder as `bench.stamps`, [steps, 3] ns: step start,
controller end, step end): the analytic controller."""


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
    calls = rec.kept.get("bench.stamps") if rec is not None else None
    if not calls or "traced_env_steps" not in run.window:
        return None
    steps = sum(len(s) for s in calls)
    return sum(float((s[:, 1] - s[:, 0]).sum()) for s in calls) * 1e-6 / steps
