"""rollout_ms.train: mean ms from the trainer's "rollout" phase mark to its
"gae" mark (CUDA events) over the traced run's window epochs, the profiled
epoch left out."""


def read(run):
    return run.window.get("rollout_ms")
