"""act_p50_ms.serve: the median request (nearest rank) of the traced run's
window, the profiled requests left out, host clock."""

from benchmark.harness.stats import nearest_rank


def read(run):
    p = nearest_rank(run.window.get("latency_s", []), 0.5)
    return None if p is None else p * 1e3
