"""Environment smoke script (counterpart of examples/env_smoke.py): the
working equivalent of the reference's uaisa_env/gym_env_test.py, which
feeds desired-velocity vectors into the kinematic action space, so its
drones barely move (SURVEY §4).

Drives one env of a world (world_3 by default, as the JAX script) for 300
steps with the analytic waypoint controller, resetting drones on
collision and on arrival, and prints a running summary.

    python -m rvo3d_tpu_torch.examples.env_smoke [world_name] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env.env import reset, reset_where, step
from rvo3d_tpu_torch.utils.device import resolve_device
from rvo3d_tpu_torch.utils.heuristic import waypoint_controller
from rvo3d_tpu_torch.worlds import load_world


@torch.no_grad()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("world", nargs="?", default="world_3")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    wd = load_world(args.world)
    world = wd.spec(device=dev)
    p = EnvParams(num_drones=wd.drone_num)
    state = reset(world, p)

    collisions = finishes = 0
    for t in range(300):
        state, out = step(world, state, waypoint_controller(state, world), p)
        if bool(out.done.any()):
            collisions += int(out.done.sum())
            state = reset_where(world, state, out.done)
        if bool(out.finish.any()):
            finishes += int(out.finish.sum())
            state = reset_where(world, state, out.finish)
        if t % 50 == 0:
            print(f"t={t:3d} pos[0]={state.pos[0].cpu().numpy().round(2)} "
                  f"reward={out.reward.cpu().numpy().round(2)}")
    print(f"done: {collisions} collision resets, {finishes} arrivals "
          f"over 300 steps on {args.world} ({wd.drone_num} drones)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
