"""act_p95_ms: the 95th percentile (nearest rank) over the window's
requests of one PolicyServer.act call, numpy in to numpy out, host clock;
requests a traced run profiled are left out."""

from benchmark.harness.stats import nearest_rank


def read(run):
    p = nearest_rank(run.window.get("latency_s", []), 0.95)
    return None if p is None else p * 1e3
