"""Detailed throughput of the port (its counterpart of
scripts/bench_detail.py):

  1. env-only stepping (core.py's metric) at 2048, 4096, 8192 and 16384
     lanes, 60 steps, 2 repeats
  2. policy-in-the-loop rollout: a biGRU-256 policy sampling every step,
     then `step` and the lifecycle reset, 2048 lanes x 30 steps (on a card
     one step captured as a CUDA graph and replayed, as the JAX script
     jits its chunk)
  3. a full PPO epoch (rollout, GAE, update) of the flagship world at
     TrainConfig(steps_per_epoch=300, num_envs=32), every other field at
     its default: the per-agent update, 50 pi and 50 v iterations; the
     second of two epochs is timed
  4. with --world only: a training epoch of that world (the JAX script
     runs world_2) split into rollout and update, at the two tags of the JAX
     script (bench_detail.py:120-165): E256_reference_schedule (256 lanes)
     and E4096_minibatch_batched (4096 lanes, the batched update with
     minibatch 32768), T = 300, 20 pi / 50 v iterations: the rollout alone
     (algo/rollout.make_rollout, best of 3 from one carry), then the second of two
     full epochs, the update by difference; then one more E256 epoch
     traced (utils/profiler.trace) into runs_torch/bench/profiles/

    python -m rvo3d_tpu_torch.bench.detail [--world W] [--device cuda]

Writes runs_torch/bench/bench_details.json. world_2, the JAX script's
world for section 4, is a reference fixture this repository does not
hold; gen_demo is the in-repo world closest to it in size.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Sequence

import torch

from rvo3d_tpu_torch.bench.core import (OUT_DIR, bench_env, best_seconds, device_name,
                                        sync, world_spec, write_results)
from rvo3d_tpu_torch.bench.flagship import flagship_world
from rvo3d_tpu_torch.config import Config, EnvParams, ModelConfig, TrainConfig
from rvo3d_tpu_torch.env import geometry as geo
from rvo3d_tpu_torch.env.env import observe, reset, reset_where, step
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils import graphs
from rvo3d_tpu_torch.utils.device import resolve_device

SWEEP_LANES = (2048, 4096, 8192, 16384)
SEED = 0             # the policy's weights; its draws come from SEED + 1
# The JAX script times its rollout with use_pallas_gru off and on. On the
# card the port has one path, the hand-written kernel, and no switch that
# turns it off (ROADMAP rule 2), so it reports one rollout number.
ROLLOUT_NOTE = ("one policy path: on the card the masked GRU runs the hand-written "
                "kernel and nothing switches it off, so the JAX script's scan/pallas "
                "pair is one number")
# section 4's two tags: lanes, and the TrainConfig fields beyond the shared ones
SPLIT_TAGS = (("E256_reference_schedule", 256, {}),
              ("E4096_minibatch_batched", 4096, {"minibatch": 32768, "batched_update": True}))


def env_sweep(world_dict: dict, lanes: Sequence[int] = SWEEP_LANES, steps: int = 60,
              repeats: int = 2, device="cuda") -> Dict[str, float]:
    """Best env-steps/s at each lane count (bench_detail.py:55-60)."""
    return {str(e): bench_env(world_dict, e, steps, repeats, device)[0] for e in lanes}


@torch.no_grad()
def policy_step(ac: ActorCritic, world, state, p: EnvParams, eps: torch.Tensor):
    """One policy-in-the-loop step (bench_detail.py:76-87): observe, sample
    mu + std * eps, round the action to 2 decimals, abs = rnd(acceler * a +
    vel, 2), step, reset collided or finished drones."""
    out, state = observe(world, state, p)
    ps = ac.step(out.obs_self, out.obs_nbr, out.obs_mask, 1.0, eps=eps)
    a = geo.rnd(ps.action, 2)
    abs_a = geo.rnd(p.acceler * a + state.vel, 2)
    state, o = step(world, state, abs_a, p)
    return reset_where(world, state, o.done | o.finish)


def policy_draw(state, generator: torch.Generator) -> torch.Tensor:
    """A step's standard normals, as ActorCritic.step draws them."""
    return torch.randn(state.vel.shape, generator=generator, dtype=torch.float32,
                       device=state.vel.device)


def rollout_chunk(ac: ActorCritic, world, state, p: EnvParams, steps: int,
                  generator: torch.Generator):
    """`steps` eager policy steps: the loop on CPU tensors, and the plain
    version the card's graph (make_policy_chunk) is held against."""
    for _ in range(steps):
        state = policy_step(ac, world, state, p, policy_draw(state, generator))
    return state


def make_policy_chunk(ac: ActorCritic, world, p: EnvParams):
    """chunk(state, steps, generator) -> state: on a card policy_step
    captured once as a CUDA graph over a static state, its draws made
    outside it as rollout_chunk makes them (utils/graphs.GraphedLoop),
    replayed `steps` times a call; rollout_chunk on the CPU."""
    if not graphs.on_card(world.device):
        return lambda state, steps, generator: rollout_chunk(ac, world, state, p, steps,
                                                             generator)
    loop = graphs.GraphedLoop(lambda s, eps, t: (policy_step(ac, world, s, p, eps), None),
                              world.device, draw=policy_draw, name="bench")
    return lambda state, steps, generator: loop(state, steps, generator)[0]


def policy_rollout(world_dict: dict, num_envs: int = 2048, steps: int = 30,
                   repeats: int = 3, device="cuda") -> float:
    """Best env-steps/s of the rollout of a biGRU-256 policy drawn from
    SEED: a warm-up chunk, then `repeats` chunks each from the same reset
    state with the same draws (bench_detail.py:23-33, :89-90), through
    make_policy_chunk."""
    dev = resolve_device(device)
    world = world_spec(world_dict, dev)
    p = EnvParams(num_drones=world_dict["drone_num"])
    ac = ActorCritic(ModelConfig(), generator=torch.Generator().manual_seed(SEED),
                     device=dev)
    state = reset(world, p, lead=(num_envs,))
    chunk = make_policy_chunk(ac, world, p)

    def run():
        return chunk(state, steps, torch.Generator(device=dev).manual_seed(SEED + 1))
    return num_envs * steps / best_seconds(run, dev, repeats)


def ppo_epoch(world_dict: dict, steps_per_epoch: int = 300, num_envs: int = 32,
              device="cuda") -> Dict[str, float]:
    """Seconds and env-steps/s of the second of two Trainer epochs
    (bench_detail.py:105-121); the first builds and warms everything."""
    from rvo3d_tpu_torch.algo.trainer import Trainer

    dev = resolve_device(device)
    p = EnvParams(num_drones=world_dict["drone_num"])
    cfg = Config(env=p, model=ModelConfig(),
                 train=TrainConfig(steps_per_epoch=steps_per_epoch, num_envs=num_envs))
    tr = Trainer(cfg, world_spec(world_dict, dev), device=dev)
    tr.run_epoch()
    sync(dev)
    t0 = time.perf_counter()
    m = tr.run_epoch()
    sync(dev)
    dt = time.perf_counter() - t0
    return {"ppo_epoch_seconds": round(dt, 3),
            "ppo_env_steps_per_sec": round(steps_per_epoch * num_envs / dt, 1),
            "pi_iters": m["pi_iters"]}


def train_split(world_name: str = "world_2", device="cuda", steps_per_epoch: int = 300,
                train_pi_iters: int = 20, train_v_iters: int = 50) -> Dict[str, dict]:
    """Section 4: per tag, the rollout's seconds (best of 3 from clones of
    one carry, after a warm-up), the second of two full epochs' seconds,
    the update's by difference and both rates; one more E256 epoch is
    traced. Keys w2_<tag> for world_2, <world>_<tag> otherwise (the JAX
    script's names). The depth (T, iterations) defaults to the script's."""
    from rvo3d_tpu_torch.algo.rollout import make_rollout
    from rvo3d_tpu_torch.algo.trainer import Trainer
    from rvo3d_tpu_torch.utils.profiler import trace
    from rvo3d_tpu_torch.worlds import load_world

    dev = resolve_device(device)
    wd = load_world(world_name)
    prefix = "w2" if world_name == "world_2" else world_name
    out = {}
    for tag, lanes, extra in SPLIT_TAGS:
        cfg = Config(env=EnvParams(num_drones=wd.drone_num, safe_rewards=True),
                     model=ModelConfig(log_std_init=-2.3),
                     train=TrainConfig(steps_per_epoch=steps_per_epoch, num_envs=lanes,
                                       train_pi_iters=train_pi_iters,
                                       train_v_iters=train_v_iters, target_kl=0.01,
                                       pi_lr=1e-6, action_mode="direct", **extra))
        tr = Trainer(cfg, wd.spec(device=dev), device=dev)
        carries = iter([tr.snapshot()[3] for _ in range(4)])
        rollout = make_rollout(tr.ac, tr.world, cfg.env, cfg.train)

        def roll():
            return rollout(next(carries))
        dt_roll = best_seconds(roll, dev, 3)
        tr.run_epoch()
        sync(dev)
        t0 = time.perf_counter()
        tr.run_epoch()
        sync(dev)
        dt_full = time.perf_counter() - t0
        steps = steps_per_epoch * lanes
        out[f"{prefix}_{tag}"] = {
            "rollout_seconds": round(dt_roll, 3),
            "full_epoch_seconds": round(dt_full, 3),
            "update_seconds_approx": round(dt_full - dt_roll, 3),
            "env_steps_per_sec_full": round(steps / dt_full, 1),
            "env_steps_per_sec_rollout_only": round(steps / dt_roll, 1),
        }
        print(f"{prefix} {tag}: rollout {dt_roll:.2f}s, full {dt_full:.2f}s "
              f"-> {steps / dt_full:,.0f} env-steps/s full epoch", flush=True)
        if tag == "E256_reference_schedule":
            profile = os.path.join(OUT_DIR, "profiles", f"{prefix}_train_epoch")
            with trace(profile):
                tr.run_epoch()
                sync(dev)
            print(f"profiler trace: {profile}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", default=None,
                    help="run section 4 on this world (the JAX script's is world_2)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.world:
        from rvo3d_tpu_torch.worlds import load_world

        load_world(args.world)        # a missing world fails before any timing
    world_dict = flagship_world()
    results = {"device": device_name(dev)}

    sweep = env_sweep(world_dict, device=dev)
    results["env_only_steps_per_sec"] = {e: round(r, 1) for e, r in sweep.items()}
    for e, r in sweep.items():
        print(f"env-only E={e}: {r:,.0f} env-steps/s", flush=True)

    path = "kernel" if dev.type == "cuda" else "plain"
    rate = policy_rollout(world_dict, device=dev)
    results[f"rollout_policy_steps_per_sec_{path}"] = round(rate, 1)
    results["rollout_policy_note"] = ROLLOUT_NOTE
    print(f"policy rollout ({path}) E=2048: {rate:,.0f} env-steps/s", flush=True)

    epoch = ppo_epoch(world_dict, device=dev)
    results.update(epoch)
    print(f"PPO epoch (E=32, T=300, 8 drones): {epoch['ppo_epoch_seconds']:.2f}s "
          f"({epoch['ppo_env_steps_per_sec']:,.0f} env-steps/s incl. 8x(50pi+50v) "
          "updates)", flush=True)

    if args.world:
        results.update(train_split(args.world, dev))

    print(f"wrote {write_results(results, 'bench_details.json')}")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
