"""Evaluate the analytic experts (the waypoint and RVO controllers) under
the reference's eval semantics (post_train.py:86-104: an episode ends on
any collision, at max_ep_len, or when every drone has finished; success =
every drone reached its destination): the success-rate upper bound a BC
warm start can inherit before PPO fine-tuning (counterpart of
scripts/expert_eval.py).

    python -m rvo3d_tpu_torch.diag.expert_eval [world ...] [--device cuda]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Tuple

import torch

from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env.env import reset, step
from rvo3d_tpu_torch.env.rvo_policy import rvo_controller
from rvo3d_tpu_torch.env.state import DroneState, WorldSpec
from rvo3d_tpu_torch.utils.device import resolve_device
from rvo3d_tpu_torch.utils.heuristic import waypoint_controller

DEFAULT_WORLDS = ["world_2", "world_3", "world_4", "world_8"]


@torch.no_grad()
def expert_episode(world: WorldSpec, p: EnvParams,
                   controller: Callable[[DroneState], torch.Tensor],
                   max_ep_len: int = 150) -> Tuple[bool, int, bool]:
    """One episode from reset; returns (success, ep_len, collided). The
    `ended` latch of the JAX scan: nothing counts after the first step
    with a collision or with every drone finished, so the loop stops
    there."""
    state = reset(world, p)
    for t in range(max_ep_len):
        state, out = step(world, state, controller(state), p)
        col, fin = bool(torch.any(out.done)), bool(torch.all(out.finish))
        if col or fin:
            return fin, t + 1, col
    return False, max_ep_len, False


def controllers(world: WorldSpec, p: EnvParams):
    """(name, controller) of both experts, in the JAX script's order."""
    return [("waypoint", lambda st: waypoint_controller(st, world)),
            ("rvo", lambda st: rvo_controller(st, world, p))]


def main(argv=None) -> int:
    from rvo3d_tpu_torch.worlds import load_world

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("worlds", nargs="*", default=DEFAULT_WORLDS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for wname in args.worlds:
        wd = load_world(wname)
        world = wd.spec(device=dev)
        p = EnvParams(num_drones=wd.drone_num)
        for name, ctrl in controllers(world, p):
            t0 = time.time()
            s, t, c = expert_episode(world, p, ctrl)
            print(f"{wname:14s} {name:9s} success={s} ep_len={t} collided={c} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
