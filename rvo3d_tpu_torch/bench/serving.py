"""PolicyServer.act latency and throughput at serving batch sizes (the
port's counterpart of scripts/serving_bench.py): a biGRU-256 policy drawn
from a fixed seed, nm = 10 neighbour slots, normal observations and a
Bernoulli(0.5) neighbour mask already on the device, 50 calls at
B <= 4096 and 20 above. On the card the encoder runs the hand-written
masked-GRU kernel; the JAX script's second (lax.scan) path has no
counterpart there (detail.ROLLOUT_NOTE).

    python -m rvo3d_tpu_torch.bench.serving [--device cuda] [B ...]
    (default B = 1 256 4096 32768)

Writes runs_torch/bench/serving_bench.json.
"""

from __future__ import annotations

import argparse
import time
from typing import Sequence

import torch

from rvo3d_tpu_torch.bench.core import device_name, sync, write_results
from rvo3d_tpu_torch.config import ModelConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.serving import PolicyServer
from rvo3d_tpu_torch.utils.device import resolve_device

BATCHES = (1, 256, 4096, 32768)
NM = 10


def serve_batches(batches: Sequence[int] = BATCHES, device="cuda") -> dict:
    """Per batch size: the mean and median ms of one act call, timed one
    call at a time between synchronizations after a first untimed call,
    and actions/s at the mean. The policy is drawn from seed 0, a batch's
    observations from seed B (serving_bench.py:42-49)."""
    dev = resolve_device(device)
    ac = ActorCritic(ModelConfig(), generator=torch.Generator().manual_seed(0),
                     device=dev)
    srv = PolicyServer(ac, nm=NM)
    path = "kernel" if dev.type == "cuda" else "plain"
    rows = {}
    for b in batches:
        g = torch.Generator().manual_seed(b)
        obs = (torch.randn(b, 12, generator=g).to(dev),
               torch.randn(b, NM, 9, generator=g).to(dev),
               (torch.rand(b, NM, generator=g) < 0.5).to(dev))
        srv.act(*obs)
        times = []
        for _ in range(50 if b <= 4096 else 20):
            sync(dev)
            t0 = time.perf_counter()
            srv.act(*obs)
            sync(dev)
            times.append(time.perf_counter() - t0)
        mean = sum(times) / len(times)
        rows[str(b)] = {f"latency_ms_{path}": mean * 1e3,
                        f"p50_ms_{path}": sorted(times)[len(times) // 2] * 1e3,
                        f"actions_per_sec_{path}": b / mean, "calls": len(times)}
        print(f"B={b:6d} {path}: {mean * 1e3:7.3f} ms/call, {b / mean:,.0f} actions/s",
              flush=True)
    return {"device": device_name(dev), "nm": NM, "batches": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("batches", type=int, nargs="*", default=list(BATCHES))
    args = ap.parse_args(argv)
    results = serve_batches(args.batches, args.device)
    print(f"wrote {write_results(results, 'serving_bench.json')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
