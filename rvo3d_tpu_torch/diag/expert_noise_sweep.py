"""Sweep the RVO expert's margin x slowdown under injected control noise
(counterpart of scripts/expert_noise_sweep.py).

The noise robustness of a BC clone is inherited from its expert's margin:
this sweep measures, per world, the expert's own success under the eval
noise (drone.py:79-82 semantics, std 0.06, 100 distinct episodes) across
the margin / slowdown grid -- the upper bound a clone can inherit.

Every margin of a (world, slowdown) pair sees the same 100 noise streams
(the JAX script reuses split(PRNGKey(17), 100) for each margin): the
streams are drawn once from a generator seeded 17, and the margins ride
as lanes of one batch (lane m * lanes + l flies stream l at margin m, the
margin entering the expert as a per-lane tensor).

    python -m rvo3d_tpu_torch.diag.expert_noise_sweep [out.json] [--device cuda]

Writes runs_torch/bc_evals/expert_noise_sweep.json by default.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional, Sequence

import torch

from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env.env import reset, step
from rvo3d_tpu_torch.env.rvo_policy import rvo_controller
from rvo3d_tpu_torch.env.state import WorldSpec
from rvo3d_tpu_torch.utils.device import resolve_device

MAX_EP_LEN = 150
LANES = 100  # 100 distinct noisy episodes, one per lane
NOISE_SEED = 17
OUT = os.path.join("runs_torch", "bc_evals", "expert_noise_sweep.json")
PLAN = [
    ("world_4", [0.3, 0.6, 0.8, 1.0, 1.2], False),
    ("world_8", [0.3, 0.45, 0.55, 0.65, 0.8], False),
    ("world32_mix", [0.0, 0.1, 0.2, 0.3, 0.45], False),
    ("world32_mix", [0.0, 0.1, 0.2, 0.3, 0.45], True),
    ("world_3", [0.8, 1.0, 1.2], False),
    ("world16_dense", [0.0, 0.1, 0.2, 0.3], False),
]


@torch.no_grad()
def noisy_episode(world: WorldSpec, p: EnvParams, slowdown: bool,
                  margin: torch.Tensor, noise: torch.Tensor):
    """One noisy episode in each lane: margin [L] (one per lane), noise
    [T, L, N, 3] standard normals (step t of lane l). Returns per-lane
    (success, ep_len, collided) tensors [L], with the JAX scan's `ended`
    latch; the loop stops once every lane has ended."""
    lanes = margin.shape[0]
    state = reset(world, p, (lanes,))
    dev = margin.device
    t = torch.zeros(lanes, dtype=torch.int32, device=dev)
    ended = torch.zeros(lanes, dtype=torch.bool, device=dev)
    success, collided = ended.clone(), ended.clone()
    for k in range(noise.shape[0]):
        a = rvo_controller(state, world, p, margin=margin, slowdown=slowdown)
        state, out = step(world, state, a, p, noise[k])
        col = torch.any(out.done, dim=-1)
        fin = torch.all(out.finish, dim=-1)
        t = torch.where(ended, t, t + 1)
        success |= ~ended & fin
        collided |= ~ended & col
        ended |= col | fin
        if bool(ended.all()):
            break
    return success, t, collided


def sweep_world(wname: str, margins: Sequence[float], reverse: bool = False,
                device="cuda", noise: Optional[torch.Tensor] = None):
    """The rows of one world (both slowdowns, every margin), LANES episodes
    of at most MAX_EP_LEN steps each. `noise` [MAX_EP_LEN, LANES, N, 3]
    replaces the streams drawn from NOISE_SEED (tests inject the JAX
    script's)."""
    from rvo3d_tpu_torch.worlds import load_world
    from rvo3d_tpu_torch.worlds.multi import reverse_routes

    dev = resolve_device(device)
    wd = load_world(wname)
    world = wd.spec(device=dev)
    if reverse:
        world = reverse_routes(world)
    p = dataclasses.replace(EnvParams(num_drones=wd.drone_num), noise=True,
                            control_std=0.06)
    m, lanes = len(margins), LANES
    lane_margin = torch.tensor(margins, dtype=world.dtype,
                               device=dev).repeat_interleave(lanes)
    rows = []
    for slowdown in (False, True):
        t0 = time.time()
        streams = noise
        if streams is None:
            g = torch.Generator(device=dev).manual_seed(NOISE_SEED)
            streams = torch.randn((MAX_EP_LEN, lanes, wd.drone_num, 3), generator=g,
                                  dtype=world.dtype, device=dev)
        s, t, c = noisy_episode(world, p, slowdown, lane_margin,
                                streams.to(dev).repeat(1, m, 1, 1))
        s, t, c = (x.cpu().numpy().reshape(m, lanes) for x in (s, t, c))
        dt = (time.time() - t0) / m
        for i, mg in enumerate(margins):
            ok_len = t[i][s[i]]
            row = {
                "world": wname + (":rev" if reverse else ""),
                "margin": float(mg),
                "slowdown": bool(slowdown),
                "noisy_success": round(float(s[i].mean()), 3),
                "mean_ep_len": (round(float(ok_len.mean()), 1) if s[i].any() else None),
                "collide_rate": round(float(c[i].mean()), 3),
            }
            rows.append(row)
            print(f"{row['world']:16s} m={mg:<4} slow={int(slowdown)} "
                  f"-> noisy {row['noisy_success']:.0%} "
                  f"len {row['mean_ep_len']} col {row['collide_rate']:.0%} "
                  f"({dt:.0f}s)", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default=OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    all_rows = []
    for wname, margins, rev in PLAN:
        all_rows.extend(sweep_world(wname, margins, reverse=rev, device=dev))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"lanes": LANES, "max_ep_len": MAX_EP_LEN,
                   "control_std": 0.06, "rows": all_rows}, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
