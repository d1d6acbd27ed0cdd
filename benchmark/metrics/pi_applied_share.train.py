"""pi_applied_share.train: the policy iterations the KL stop applied over
those the update replayed in the profiled epoch, percent (the port's
counters `ppo.pi_iters_applied` and `ppo.pi_iters_replayed`, counted
from the epoch's pi_iters as Trainer.run_epoch reads them)."""


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
    if rec is None or "epoch_ends" not in run.window:
        return None
    replayed = rec.counters.get("ppo.pi_iters_replayed")
    if not replayed:
        return None
    return 100.0 * rec.counters.get("ppo.pi_iters_applied", 0) / replayed
