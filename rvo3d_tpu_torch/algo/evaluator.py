"""Policy evaluation over E lanes of near-deterministic episodes
(counterpart of rvo3d_tpu/algo/evaluator.py; reference post_train.policy_test):

  - std_factor 1e-3; abs_action = acceler_vel * round(a, 2) + cur_vel with
    acceler_vel = 1.0 ('increment'), or round(a, 2) ('direct')
  - an episode ends on any collision, at max_ep_len, or when every drone
    has finished; the lane then resets
  - success: every drone reached its destination; EpLen statistics are over
    episodes in which every drone arrived
  - per-step mean drone speed, averaged over the episode
Lanes run in lockstep; records stay on the device for a chunk of steps and
come to the host once per chunk, until enough episodes have ended.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import geometry as geo
from rvo3d_tpu_torch.env.env import observe, reset, reset_where, step
from rvo3d_tpu_torch.env.state import DroneState, WorldSpec
from rvo3d_tpu_torch.models import ActorCritic


class EvalCarry(NamedTuple):
    env_state: DroneState
    obs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    ep_len: torch.Tensor     # [E] int32
    speed_sum: torch.Tensor  # [E]
    ret0: torch.Tensor       # [E] drone-0 return (the reference's ep_ret)


_REC = ("ended", "success", "all_info", "ep_len", "speed", "ret0")


def init_eval_carry(world: WorldSpec, p: EnvParams, num_lanes: int) -> EvalCarry:
    state = reset(world, p, (num_lanes,))
    out, state = observe(world, state, p)
    z = torch.zeros((num_lanes,), dtype=torch.float32, device=world.device)
    return EvalCarry(
        env_state=state, obs=(out.obs_self, out.obs_nbr, out.obs_mask),
        ep_len=torch.zeros((num_lanes,), dtype=torch.int32, device=world.device),
        speed_sum=z, ret0=z.clone())


def eval_step(ac: ActorCritic, world: WorldSpec, p: EnvParams, c: EvalCarry,
              generator: torch.Generator, *, max_ep_len: int = 150,
              acceler_vel: float = 1.0, std_factor: float = 1e-3,
              action_mode: str = "increment"):
    """One lockstep step of every lane. Returns (carry, records), records a
    dict of [E] tensors for the episodes that ended at this step."""
    obs_self, obs_nbr, obs_mask = c.obs
    ps = ac.step(obs_self, obs_nbr, obs_mask, std_factor, generator)
    a = geo.rnd(ps.action, 2, p.parity_rounding)
    abs_action = a if action_mode == "direct" else acceler_vel * a + c.env_state.vel
    noise = (torch.randn(abs_action.shape, generator=generator,
                         dtype=abs_action.dtype, device=abs_action.device)
             if p.noise else None)
    env_state, out = step(world, c.env_state, abs_action, p, noise)
    speed = torch.mean(geo.norm3(env_state.vel), dim=-1)
    ep_len = c.ep_len + 1
    speed_sum = c.speed_sum + speed
    ret0 = c.ret0 + out.reward[:, 0]
    success = torch.all(out.finish, dim=1)
    ended = torch.any(out.done, dim=1) | (ep_len == max_ep_len) | success
    rec = {"ended": ended, "success": success,
           "all_info": torch.all(out.info_arrive, dim=1), "ep_len": ep_len,
           "speed": speed_sum / torch.clamp(ep_len, min=1), "ret0": ret0}

    env_state = reset_where(world, env_state, ended[:, None].expand_as(out.done))
    re_out, env_state = observe(world, env_state, p)
    e3 = ended[:, None, None]
    nobs = (torch.where(e3, re_out.obs_self, out.obs_self),
            torch.where(e3[..., None], re_out.obs_nbr, out.obs_nbr),
            torch.where(e3, re_out.obs_mask, out.obs_mask))
    zero = torch.zeros_like(speed_sum)
    carry = EvalCarry(env_state=env_state, obs=nobs,
                      ep_len=torch.where(ended, torch.zeros_like(ep_len), ep_len),
                      speed_sum=torch.where(ended, zero, speed_sum),
                      ret0=torch.where(ended, zero, ret0))
    return carry, rec


@torch.no_grad()
def evaluate(ac: ActorCritic, world: WorldSpec, p: EnvParams, *,
             generator: Optional[torch.Generator] = None,
             num_episodes: int = 100, num_lanes: int = 16,
             max_ep_len: int = 150, acceler_vel: float = 1.0,
             std_factor: float = 1e-3, action_mode: str = "increment",
             max_chunks: int = 32,
             chunk_len: Optional[int] = None) -> Dict[str, float]:
    """Run until >= num_episodes episodes end; return the reference's
    summary metrics. max_chunks bounds the work (chunk_len steps of
    num_lanes lanes each); if it cuts the run short of num_episodes the
    result carries "truncated": True and a warning is printed."""
    dev = world.device
    if next(ac.parameters()).device != dev:
        raise ValueError(f"policy on {next(ac.parameters()).device}, world on {dev}")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    chunk = chunk_len if chunk_len is not None else max_ep_len + 10
    carry = init_eval_carry(world, p, num_lanes)

    recs = {k: [] for k in _REC}
    total = 0
    for _ in range(max_chunks):
        steps = []
        for _ in range(chunk):
            carry, rec = eval_step(ac, world, p, carry, generator,
                                   max_ep_len=max_ep_len,
                                   acceler_vel=acceler_vel,
                                   std_factor=std_factor,
                                   action_mode=action_mode)
            steps.append(rec)
        for k in _REC:
            recs[k].append(torch.stack([r[k] for r in steps]).cpu().numpy())
        total += int(recs["ended"][-1].sum())
        if total >= num_episodes:
            break

    ended = np.concatenate(recs["ended"]).ravel()
    sel = {k: np.concatenate(recs[k]).ravel()[ended][:num_episodes]
           for k in _REC[1:]}
    success, info, lens = sel["success"], sel["all_info"], sel["ep_len"]
    speeds, rets = sel["speed"], sel["ret0"]
    n = len(success)
    truncated = n < num_episodes
    if truncated:
        print(f"evaluate: WARNING — chunk budget exhausted at {n}/"
              f"{num_episodes} episodes ({max_chunks} chunks x {chunk} "
              f"steps x {num_lanes} lanes); raise max_chunks/num_lanes",
              flush=True)
    ok_lens = lens[info.astype(bool)]
    return {
        **({"truncated": True} if truncated else {}),
        "episodes": int(n),
        "success_rate": float(success.sum() / max(n, 1)),
        "mean_ep_len": float(np.round(ok_lens.mean(), 2)) if len(ok_lens) else 0.0,
        "std_ep_len": float(np.round(ok_lens.std(), 2)) if len(ok_lens) else 0.0,
        "mean_speed": float(np.round(speeds.mean(), 2)) if n else 0.0,
        "std_speed": float(np.round(speeds.std(), 2)) if n else 0.0,
        "mean_ret0": float(np.mean(rets)) if n else 0.0,
    }
