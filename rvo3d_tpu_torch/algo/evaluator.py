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

make_eval_chunk gives the chunk (the JAX package's name): on a card one
eval_step captured as a CUDA graph and replayed chunk_len times, its
records written into static [chunk, E] buffers at a device step index
(utils/graphs.py); on the CPU eval_chunk, the eager loop. Both draw each
step's standard normals outside the step (eval_draws): the policy's sample,
then the control noise, from the one generator, in that order.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import geometry as geo
from rvo3d_tpu_torch.env.env import observe, reset, reset_where, step
from rvo3d_tpu_torch.env.state import DroneState, WorldSpec
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils import graphs, profiler
from rvo3d_tpu_torch.utils.graphs import clone_tree


class EvalCarry(NamedTuple):
    env_state: DroneState
    obs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    ep_len: torch.Tensor     # [E] int32
    speed_sum: torch.Tensor  # [E]
    ret0: torch.Tensor       # [E] drone-0 return (the reference's ep_ret)


class EvalRecords(NamedTuple):
    """Per (step, lane) episode-end records: [E] for one step, [T, E] for
    a chunk."""

    ended: torch.Tensor      # bool
    success: torch.Tensor    # every drone finished
    all_info: torch.Tensor   # every drone arrived (gates the EpLen statistics)
    ep_len: torch.Tensor
    speed: torch.Tensor      # mean speed over the episode
    ret0: torch.Tensor


def init_eval_carry(world: WorldSpec, p: EnvParams, num_lanes: int) -> EvalCarry:
    """Every lane reset and observed. speed_sum and ret0 have the dtype a
    step gives them (float32, or the env's float64), so the carry's
    dtypes hold from step to step."""
    state = reset(world, p, (num_lanes,))
    out, state = observe(world, state, p)
    z = torch.zeros((num_lanes,), dtype=torch.promote_types(torch.float32, state.pos.dtype),
                    device=world.device)
    return EvalCarry(
        env_state=state, obs=(out.obs_self, out.obs_nbr, out.obs_mask),
        ep_len=torch.zeros((num_lanes,), dtype=torch.int32, device=world.device),
        speed_sum=z, ret0=z.clone())


def eval_draws(c: EvalCarry, generator: torch.Generator, p: EnvParams,
               action_mode: str = "increment"):
    """One step's standard normals, as ActorCritic.step and the env draw
    them: the policy's sample [E, N, 3] float32, then (p.noise) the control
    noise in the absolute action's dtype, else None. While the recorder is
    on (utils/profiler.py) the step's obs_mask is kept as
    `eval.obs_mask`."""
    profiler.keep("eval.obs_mask", c.obs[2])     # the step's masked-GRU input
    vel = c.env_state.vel
    eps = torch.randn(vel.shape, generator=generator, dtype=torch.float32,
                      device=vel.device)
    if not p.noise:
        return eps, None
    # the absolute action's dtype: the policy's float32, plus the velocity
    # in 'increment' mode
    dtype = (torch.float32 if action_mode == "direct"
             else torch.promote_types(torch.float32, vel.dtype))
    return eps, torch.randn(vel.shape, generator=generator, dtype=dtype, device=vel.device)


def eval_step(ac: ActorCritic, world: WorldSpec, p: EnvParams, c: EvalCarry,
              eps: torch.Tensor, noise: Optional[torch.Tensor] = None, *,
              max_ep_len: int = 150, acceler_vel: float = 1.0,
              std_factor: float = 1e-3, action_mode: str = "increment",
              mark: Optional[Callable[[], None]] = None
              ) -> Tuple[EvalCarry, EvalRecords]:
    """One lockstep step of every lane with the draws of eval_draws.
    `mark`, when given, is called between the policy's action and the env
    step (the graphed loop's device stamp). Returns (carry, records), the
    records [E] for the episodes that ended at this step."""
    obs_self, obs_nbr, obs_mask = c.obs
    ps = ac.step(obs_self, obs_nbr, obs_mask, std_factor, eps=eps)
    a = geo.rnd(ps.action, 2, p.parity_rounding)
    abs_action = a if action_mode == "direct" else acceler_vel * a + c.env_state.vel
    if mark is not None:
        mark()
    env_state, out = step(world, c.env_state, abs_action, p, noise)
    speed = torch.mean(geo.norm3(env_state.vel), dim=-1)
    ep_len = c.ep_len + 1
    speed_sum = c.speed_sum + speed
    ret0 = c.ret0 + out.reward[:, 0]
    success = torch.all(out.finish, dim=1)
    ended = torch.any(out.done, dim=1) | (ep_len == max_ep_len) | success
    rec = EvalRecords(ended=ended, success=success,
                      all_info=torch.all(out.info_arrive, dim=1), ep_len=ep_len,
                      speed=speed_sum / torch.clamp(ep_len, min=1), ret0=ret0)

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
def eval_chunk(ac: ActorCritic, world: WorldSpec, p: EnvParams, c: EvalCarry,
               generator: torch.Generator, chunk: int, *, max_ep_len: int = 150,
               acceler_vel: float = 1.0, std_factor: float = 1e-3,
               action_mode: str = "increment") -> Tuple[EvalCarry, EvalRecords]:
    """`chunk` eager steps: the loop on CPU tensors, and the plain version
    the card's graph is held against. Records [chunk, E]."""
    kw = dict(max_ep_len=max_ep_len, acceler_vel=acceler_vel,
              std_factor=std_factor, action_mode=action_mode)
    recs = []
    for _ in range(chunk):
        c, rec = eval_step(ac, world, p, c, *eval_draws(c, generator, p, action_mode),
                           **kw)
        recs.append(rec)
    return c, EvalRecords(*[torch.stack(x) for x in zip(*recs)])


def make_eval_chunk(ac: ActorCritic, world: WorldSpec, p: EnvParams,
                    max_ep_len: int = 150, acceler_vel: float = 1.0,
                    std_factor: float = 1e-3, chunk: int = 160,
                    action_mode: str = "increment"):
    """chunk_fn(carry, generator) -> (carry, EvalRecords [chunk, E]) (the
    JAX package's make_eval_chunk, jitted by its evaluate): on a card
    eval_step captured once as a CUDA graph over a static carry, its draws
    made outside it and its records written at a device step index
    (utils/graphs.GraphedLoop), replayed `chunk` times a call; eval_chunk
    on the CPU."""
    kw = dict(max_ep_len=max_ep_len, acceler_vel=acceler_vel,
              std_factor=std_factor, action_mode=action_mode)
    if not graphs.on_card(world.device):
        return lambda c, generator: eval_chunk(ac, world, p, c, generator, chunk, **kw)

    def records(c: EvalCarry) -> EvalRecords:
        return EvalRecords(*[
            torch.empty((chunk,) + c.ep_len.shape, dtype=dt, device=world.device)
            for dt in (torch.bool, torch.bool, torch.bool, c.ep_len.dtype,
                       c.speed_sum.dtype, c.ret0.dtype)])
    loop = graphs.GraphedLoop(
        lambda c, draws, t: eval_step(ac, world, p, c, *draws, mark=loop.mark, **kw),
        world.device, draw=lambda c, generator: eval_draws(c, generator, p, action_mode),
        records=records, name="eval", stamps=chunk)

    def chunk_fn(c: EvalCarry, generator: torch.Generator):
        c, rec = loop(c, chunk, generator)
        return c, clone_tree(rec)
    return chunk_fn


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
    chunk_fn = make_eval_chunk(ac, world, p, max_ep_len, acceler_vel, std_factor,
                               chunk, action_mode)

    recs = {k: [] for k in EvalRecords._fields}
    total = 0
    for _ in range(max_chunks):
        carry, rec = chunk_fn(carry, generator)
        for k, x in zip(EvalRecords._fields, rec):
            recs[k].append(x.cpu().numpy())
        total += int(recs["ended"][-1].sum())
        if total >= num_episodes:
            break

    ended = np.concatenate(recs["ended"]).ravel()
    sel = {k: np.concatenate(recs[k]).ravel()[ended][:num_episodes]
           for k in EvalRecords._fields[1:]}
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
