"""gru_roofline.serve: the summed bound (reference/counts.gru_bound) of the
profiled requests' masks, after the encoder's rule that a row with no
valid slot runs its last one, over the kernel's device time, percent."""

import torch

from benchmark.harness.stats import share
from benchmark.reference.counts import gru_bound
from benchmark.reference.policy import encoder_mask


def read(run):
    t, masks = run.trace_summary, run.window.get("traced_masks")
    if t is None or not masks:
        return None
    model = run.config["program"]["model"]
    bound = sum(gru_bound(encoder_mask(torch.as_tensor(m)).t(), model["rnn_input_dim"],
                          model["rnn_hidden_dim"])["bound_s"] for m in masks)
    return share(bound, t.op_seconds("masked_gru"))
