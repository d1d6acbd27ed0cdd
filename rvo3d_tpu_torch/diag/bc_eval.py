"""Isolate BC fidelity: pretrain the policy on an analytic expert, then run
the reference's eval semantics on the BC-only policy (no PPO). Answers
whether closed-loop covariate shift (not PPO) breaks the clone
(counterpart of scripts/bc_eval.py).

    python -m rvo3d_tpu_torch.diag.bc_eval [world] [expert] [bc_steps] [log_std]
        [explore_std] [dagger] [margin] [cw] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from rvo3d_tpu_torch.algo.bc import bc_pretrain
from rvo3d_tpu_torch.algo.evaluator import evaluate
from rvo3d_tpu_torch.config import Config, EnvParams, ModelConfig, TrainConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils.device import resolve_device


def run(world_name: str = "world_2", expert: str = "rvo", bc_steps: int = 2000,
        log_std: float = -1.0, explore_std: float = 0.0, dagger: int = 0,
        margin: float = 0.4, cw: float = 1.0, device="cuda") -> ActorCritic:
    """BC on 32 lanes x 400 demo steps, an 8-episode det evaluation after
    every round (on_round), then 100 episodes at std factors 1e-3 and 1;
    returns the clone."""
    from rvo3d_tpu_torch.algo.trainer import Trainer
    from rvo3d_tpu_torch.worlds import load_world

    dev = resolve_device(device)
    wd = load_world(world_name)
    cfg = Config(env=EnvParams(num_drones=wd.drone_num, safe_rewards=True),
                 model=ModelConfig(log_std_init=log_std),
                 train=TrainConfig(action_mode="direct", num_envs=32), world=world_name)
    trainer = Trainer(cfg, wd.spec(device=dev), device=dev)

    def det_eval(ac, num_episodes, num_lanes, std):
        return evaluate(ac, trainer.world, cfg.env,
                        generator=torch.Generator(device=dev).manual_seed(0),
                        num_episodes=num_episodes, num_lanes=num_lanes, std_factor=std,
                        action_mode="direct")

    def on_round(r, ac, loss_r):
        m = det_eval(ac, 8, 8, 1e-3)
        print(f"  round {r}: loss={loss_r:.5f} det-success="
              f"{m['success_rate']:.0%} EpLen={m['mean_ep_len']}", flush=True)

    loss = bc_pretrain(
        trainer.ac, trainer.world, cfg.env, torch.Generator(device=dev).manual_seed(8),
        num_envs=32, train_steps=bc_steps, expert=expert, action_mode="direct",
        explore_std=explore_std, demo_steps=400, dagger_rounds=dagger,
        expert_margin=margin, conflict_weight=cw, on_round=on_round)
    print(f"BC: {bc_steps} steps, explore_std={explore_std}, "
          f"dagger={dagger}, margin={margin}, cw={cw}, "
          f"final loss {loss:.5f}", flush=True)
    for std in (1e-3, 1.0):
        m = det_eval(trainer.ac, 100, 16, std)
        print(f"{world_name} BC-only std_factor={std}: "
              f"success={m['success_rate']:.2%} EpLen={m['mean_ep_len']} "
              f"speed={m['mean_speed']}", flush=True)
    return trainer.ac


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("world", nargs="?", default="world_2")
    ap.add_argument("expert", nargs="?", default="rvo")
    ap.add_argument("bc_steps", nargs="?", type=int, default=2000)
    ap.add_argument("log_std", nargs="?", type=float, default=-1.0)
    ap.add_argument("explore_std", nargs="?", type=float, default=0.0)
    ap.add_argument("dagger", nargs="?", type=int, default=0)
    ap.add_argument("margin", nargs="?", type=float, default=0.4)
    ap.add_argument("cw", nargs="?", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.world, a.expert, a.bc_steps, a.log_std, a.explore_std, a.dagger, a.margin,
        a.cw, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
