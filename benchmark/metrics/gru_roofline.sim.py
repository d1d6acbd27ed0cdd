"""gru_roofline.sim: the summed bound (reference/counts.gru_bound, both
directions) of the masks the profiled evaluation call's steps gave the
masked-GRU kernel (kept by the port's recorder as `eval.obs_mask`, one
[E, N, nm] mask a step), after the encoder's rule that a row with no
valid slot runs its last one, over the kernel's device time in the
trace, percent."""

from benchmark.harness.stats import share
from benchmark.reference.counts import gru_bound
from benchmark.reference.policy import encoder_mask


def recording():
    """The recorder of the profiled window (rvo3d_tpu_torch/utils/profiler.py),
    or None where the port has none."""
    try:
        from rvo3d_tpu_torch.utils.profiler import recorded
    except ImportError:
        return None
    return recorded()


def read(run):
    t, rec = run.trace_summary, recording()
    masks = rec.kept.get("eval.obs_mask") if rec is not None else None
    if t is None or not masks or "traced_env_steps" not in run.window:
        return None
    model = run.config["program"]["model"]
    bound = sum(gru_bound(encoder_mask(m.reshape(-1, m.shape[-1])).t(),
                          model["rnn_input_dim"], model["rnn_hidden_dim"])["bound_s"]
                for m in masks)
    return share(bound, t.op_seconds("masked_gru"))
