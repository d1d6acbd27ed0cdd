"""The masked-GRU kernel's microbenchmark (the port's counterpart of
scripts/gru_bench.py): one direction of the hand-written CUDA kernel
(csrc/masked_gru.cu) against its plain torch version, forward only, at
rollout shapes: B = E * 8 flattened agents, H = 256 over nm = 10
neighbour slots of 9 features, weights normal x 0.05, the mask
uniform < 0.7. Also times cuDNN's unmasked one-direction nn.GRU on the
same inputs as the library's reference point.

    python -m rvo3d_tpu_torch.bench.gru [E ...]   (default E = 4096 16384)

B = 131072 is past the largest batch the other checks launch (65536);
the kernel's offsets there stay far inside 32 bits (xs holds 11.8M
elements, out 33.6M), the launcher takes any B >= 1, and the grid is the
card's resident clusters whatever the tile count (ops/masked_gru.py).
Writes runs_torch/bench/gru_bench.json. There is no CPU form: the bench
exists to time the kernel, so `--device cpu` raises.
"""

from __future__ import annotations

import argparse
import json
from typing import Sequence

import torch

from rvo3d_tpu_torch.bench.core import best_seconds, device_name, write_results
from rvo3d_tpu_torch.ops import masked_gru as mg
from rvo3d_tpu_torch.utils.device import resolve_device

N, NM, IN, H = 8, 10, 9, 256
LANES = (4096, 16384)
REPEATS = 5          # timed calls after one warm-up (gru_bench.py:26-35)


def inputs(batch: int, dev):
    """xs [NM, B, IN], mask [NM, B] and one direction's (w_ih, w_hh, b_ih,
    b_hh), drawn on the CPU from seed 0 (gru_bench.py:45-55)."""
    g = torch.Generator().manual_seed(0)
    w = [torch.randn(shape, generator=g) * 0.05
         for shape in ((IN, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))]
    xs = torch.randn(NM, batch, IN, generator=g)
    mask = (torch.rand(NM, batch, generator=g) < 0.7).float()
    return xs.to(dev), mask.to(dev), [t.to(dev) for t in w]


@torch.no_grad()
def gru_rows(lanes: Sequence[int] = LANES, device="cuda") -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the GRU bench times the CUDA kernel, which has no CPU "
                         f"form; got device {dev}")
    results = {"device": device_name(dev), "direction": "one (forward)",
               "shapes": {}}
    for e in lanes:
        b = e * N
        xs, mask, w = inputs(b, dev)
        gru = torch.nn.GRU(IN, H).to(dev)
        dense = xs.contiguous()
        t_plain, t_kernel, t_cudnn = (
            best_seconds(fn, dev, REPEATS) * 1e3
            for fn in (lambda: mg.masked_gru_scan_plain(xs, mask, *w),
                       lambda: mg.masked_gru_scan_cuda(xs, mask, *w),
                       lambda: gru(dense)))
        err = (mg.masked_gru_scan_cuda(xs, mask, *w)
               - mg.masked_gru_scan_plain(xs, mask, *w)).abs().max().item()
        row = {"B": b, "plain_ms": t_plain, "kernel_ms": t_kernel,
               "speedup": t_plain / t_kernel, "cudnn_gru_unmasked_ms": t_cudnn,
               "max_abs_err": err}
        results["shapes"][f"E{e}"] = row
        print(f"E={e} (B={b}): plain {t_plain:.3f} ms, kernel {t_kernel:.3f} ms, "
              f"speedup {row['speedup']:.2f}x, cuDNN {t_cudnn:.3f} ms, err {err:.2e}",
              flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("lanes", type=int, nargs="*", default=list(LANES))
    args = ap.parse_args(argv)
    results = gru_rows(args.lanes, args.device)
    print(f"wrote {write_results(results, 'gru_bench.json')}")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
