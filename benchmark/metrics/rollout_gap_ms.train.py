"""rollout_gap_ms.train: the sum over the profiled epoch's rollout of
start[t+1] - end[t], ms, from the device stamps the graphed rollout step
writes (kept by the port's recorder as `rollout.stamps`, [T, 3] ns: step
start, policy end, step end): the step's draws, its copies into the
static buffers and the device's wait for the host between two replays."""


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
    return sum(float((s[1:, 0] - s[:-1, 2]).sum()) for s in calls) * 1e-6
