"""rollout_env_ms.train: the sum over the profiled epoch's rollout of
end[t] - policy_end[t], ms, from the device stamps the graphed rollout
step writes (`rollout.stamps`): the env step, the lifecycle resets and
the next observation, after the policy's action."""


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
    calls = rec.kept.get("rollout.stamps") if rec is not None else None
    if not calls or "epoch_ends" not in run.window:
        return None
    return sum(float((s[:, 2] - s[:, 1]).sum()) for s in calls) * 1e-6
