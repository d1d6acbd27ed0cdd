"""Trace a deterministic closed-loop rollout of the BC policy against the
expert on one env: per-step waypoint index, distance to the current
target, finish and collision flags, drone 0's action from each, and drone
0's position. Pinpoints where the clone diverges (counterpart of
scripts/bc_trace.py).

    python -m rvo3d_tpu_torch.diag.bc_trace [world] [explore_std] [--device cuda]
"""

from __future__ import annotations

import argparse
from typing import Iterator, Tuple

import numpy as np
import torch

from rvo3d_tpu_torch.config import Config, EnvParams, ModelConfig, TrainConfig
from rvo3d_tpu_torch.env import geometry as geo
from rvo3d_tpu_torch.env.env import observe, reset, step
from rvo3d_tpu_torch.env.rvo_policy import rvo_controller
from rvo3d_tpu_torch.env.state import DroneState, StepOutput, WorldSpec
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils.device import resolve_device


@torch.no_grad()
def closed_loop(ac: ActorCritic, world: WorldSpec, p: EnvParams, steps: int
                ) -> Iterator[Tuple[DroneState, StepOutput, np.ndarray, np.ndarray]]:
    """The evaluator's deterministic flight of one env from reset: each
    step observes, acts round(mu, 2), and steps. Yields (state after the
    step, its output, the action, the expert's command at the observed
    state) until `steps` steps or the episode's end, whichever is first."""
    state = reset(world, p)
    for _ in range(steps):
        out, state = observe(world, state, p)
        mu = ac(out.obs_self, out.obs_nbr, out.obs_mask)[0]
        a = geo.rnd(mu, 2)
        ea = rvo_controller(state, world, p)
        state, out = step(world, state, a, p)
        yield state, out, a.cpu().numpy(), ea.cpu().numpy()
        if bool(torch.all(out.finish)) or bool(torch.any(out.done)):
            return


def step_summary(world: WorldSpec, state: DroneState, out: StepOutput):
    """(positions, waypoint indices, distances to the current target,
    finish flags, collision flags) on the host."""
    d0 = geo.norm3(state.pos - state.current_des(world))
    return (state.pos.cpu().numpy(), state.wp_idx.cpu().numpy(), d0.cpu().numpy(),
            out.finish.cpu().numpy().astype(int), out.done.cpu().numpy().astype(int))


def trace(ac: ActorCritic, world: WorldSpec, p: EnvParams, steps: int = 60) -> None:
    for t, (state, out, a, ea) in enumerate(closed_loop(ac, world, p, steps)):
        pos, wp, d0, fin, col = step_summary(world, state, out)
        print(f"t={t:3d} wp={wp} |d_wp|={np.round(d0, 2)} "
              f"fin={fin} col={col} "
              f"a0={np.round(a[0], 2)} "
              f"ea0={np.round(ea[0], 2)} "
              f"pos0={np.round(pos[0], 2)}", flush=True)
        if fin.all() or col.any():
            print("episode end", flush=True)


def fresh_policy(world_name: str, model: ModelConfig, device):
    """(policy of a fresh Trainer, world, env params) as the JAX scripts
    build them: safe rewards, 'direct' actions."""
    from rvo3d_tpu_torch.algo.trainer import Trainer
    from rvo3d_tpu_torch.worlds import load_world

    dev = resolve_device(device)
    wd = load_world(world_name)
    world = wd.spec(device=dev)
    p = EnvParams(num_drones=wd.drone_num, safe_rewards=True)
    cfg = Config(env=p, model=model, train=TrainConfig(action_mode="direct"),
                 world=world_name)
    return Trainer(cfg, world, device=dev).ac, world, p


def clone_rvo(ac: ActorCritic, world: WorldSpec, p: EnvParams, train_steps: int,
              explore_std: float) -> float:
    """BC of `ac` in place from the RVO expert (margin 0.3) on 32 lanes x
    400 demo steps with 3 DAgger rounds, draws seeded 8; the final loss."""
    from rvo3d_tpu_torch.algo.bc import bc_pretrain

    return bc_pretrain(ac, world, p, torch.Generator(device=world.device).manual_seed(8),
                       num_envs=32, train_steps=train_steps, expert="rvo",
                       action_mode="direct", explore_std=explore_std, demo_steps=400,
                       dagger_rounds=3, expert_margin=0.3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("world", nargs="?", default="world_2")
    ap.add_argument("explore_std", nargs="?", type=float, default=0.15)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ac, world, p = fresh_policy(args.world, ModelConfig(), args.device)
    loss = clone_rvo(ac, world, p, 3000, args.explore_std)
    print(f"BC loss {loss:.5f}", flush=True)
    trace(ac, world, p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
