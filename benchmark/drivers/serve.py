"""Driver `serve`: `PolicyServer.act`, one client in a closed loop, each
request sent when the last one has returned.

Set-up loads the product (its sha256 checked) into a deterministic
PolicyServer, makes the request pool from --seed (for each batch size of
the traffic, `pool` requests of numpy observations: obs_self and obs_nbr
standard normal, float32, the mask Bernoulli(mask_p) per slot: the draw
of rvo3d_tpu_torch/bench/serving.py at commit 9c4d68f085eb, after
scripts/serving_bench.py:42-49), and serves each batch size twice: the first request of a shape
runs eagerly, the second captures its graph (utils/graphs.py). The
window then draws each request's batch size uniformly from the traffic's
sizes with a generator seeded from --seed, and serves requests until
--seconds have passed; a request's latency is the host's wall time of the
act call, numpy observations in to numpy actions out. A traced run
profiles `traced_requests` requests from the window's second on, past the
window's end if need be.

The check draws `check_requests` of the window's requests from the seed,
the first of the largest batch size among them, and holds every action
of theirs against the reference's mean action on the same observations.
Compared number (workload `limits`): act_gap (benchmark/checks.py).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import checks
from benchmark.reference import counts
from benchmark.reference import policy as ref


class State:
    pass


def request_pool(seed: int, sizes, pool: int, nm: int, mask_p: float):
    """{B: [(obs_self [B, 12], obs_nbr [B, nm, 9], obs_mask [B, nm]), ...]}."""
    out = {}
    for b in sizes:
        rng = np.random.default_rng([seed, b])
        out[b] = [(rng.standard_normal((b, 12), dtype=np.float32),
                   rng.standard_normal((b, nm, 9), dtype=np.float32),
                   rng.random((b, nm)) < mask_p) for _ in range(pool)]
    return out


def setup(run):
    from rvo3d_tpu_torch.serving import PolicyServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = run.workload["params"]
    path = os.path.join(run.root, run.config["product"]["path"])
    if ref.sha256_of(path) != run.config["product"]["sha256"]:
        raise ValueError(f"{path} is not the configuration's product")
    st = State()
    with run.span("policy.load"):
        st.server = PolicyServer.from_checkpoint(path, device=torch.device(run.device),
                                                 std_factor=tr["std_factor"],
                                                 deterministic=True)
    st.pool = request_pool(run.seed, tr["batch_sizes"], tr["pool"],
                           run.config["program"]["env"]["neighbor_num"], tr["mask_p"])
    model = run.config["program"]["model"]
    st.flops = {b: [counts.policy_flops(ref.encoder_mask(torch.as_tensor(m)).t(), model,
                                        "actor") for _, _, m in reqs]
                for b, reqs in st.pool.items()}
    for b in tr["batch_sizes"]:
        for _ in range(2):      # the first serves eagerly, the second captures
            with run.span("act", batch=b, warmup=True):
                st.server.act(*st.pool[b][0])
    run.sync()
    return st


def _serve(st, run, i, b, lat, outs):
    req = st.pool[b][i % len(st.pool[b])]
    with run.span("request", batch=b):
        t0 = time.perf_counter()
        a = st.server.act(*req)
        lat.append(time.perf_counter() - t0)
    outs.append(a)


def window(st, run):
    tr = run.workload["params"]
    rng = np.random.default_rng([run.seed, 2])
    sizes = list(tr["batch_sizes"])
    st.sizes, st.latency, st.outputs = [], [], []
    traced = (1, 1 + tr["traced_requests"]) if run.trace else (0, 0)
    tracer = None
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while time.perf_counter() < deadline or tracer is not None:
        i = len(st.sizes)
        b = sizes[int(rng.integers(len(sizes)))]
        st.sizes.append(b)
        if run.trace and i == traced[0]:
            from benchmark.harness.trace import Tracer
            tracer = Tracer(run)
            tracer.__enter__()
            st.traced_masks, t_traced = [], time.perf_counter()
        if traced[0] <= i < traced[1]:
            st.traced_masks.append(st.pool[b][i % len(st.pool[b])][2])
        _serve(st, run, i, b, st.latency, st.outputs)
        if tracer is not None and i == traced[1] - 1:
            tracer.__exit__(None, None, None)
            tracer = None
            run.window["traced_s"] = time.perf_counter() - t_traced
    end = time.perf_counter()
    keep = [i for i in range(len(st.sizes)) if not traced[0] <= i < traced[1]]
    run.window.update(start=t0, end=end, latency_s=[st.latency[i] for i in keep],
                      sizes=[st.sizes[i] for i in keep],
                      served_flops=sum(st.flops[st.sizes[i]][i % tr["pool"]] for i in keep))
    if run.trace:
        run.window["traced_masks"] = st.traced_masks
    run.count("attempted", len(st.sizes))


def release(st):
    import gc

    st.server = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(st, run):
    return checks.serve_checks(st, run)
