"""update_ms.train: mean ms from the trainer's "update" phase mark to its
"end" mark (CUDA events) over the traced run's window epochs, the profiled
epoch left out."""


def read(run):
    return run.window.get("update_ms")
