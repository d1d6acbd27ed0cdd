"""One epoch of experience over E env lanes and N agents (counterpart of
rvo3d_tpu/algo/rollout.py; reference multi_ppo.training_loop):

  per step t:
    a, v, logp = policy(obs)           (a rounded to 2 decimals; logp is
                                        kept for the UNROUNDED sample)
    abs = round(acceler*a + vel, 2)    ('increment'; 'direct': abs = a)
    env.step(abs)
    store (obs, a, r, v, logp)
    lifecycle:
      collision  -> per-drone reset, no GAE cut
      epoch end | all arrived -> full reset, cut
      terminal (any finished / over length) -> per-drone reset, cut
    obs <- recomputed for every lane that reset anything

Lanes and agents are tensor axes; the loop over T runs on the host and
nothing in it reads back from the device. With a lane world
(worlds/multi.py) lane e steps its own scenario.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from rvo3d_tpu_torch.config import EnvParams, TrainConfig
from rvo3d_tpu_torch.env import geometry as geo
from rvo3d_tpu_torch.env.env import observe, reset, reset_where, step
from rvo3d_tpu_torch.env.state import DroneState, WorldSpec
from rvo3d_tpu_torch.models import ActorCritic

class EpisodeStats(NamedTuple):
    """Per-agent completed-episode aggregates, all [N]."""

    count: torch.Tensor
    ret_sum: torch.Tensor
    ret_min: torch.Tensor
    ret_max: torch.Tensor
    len_sum: torch.Tensor
    finish_count: torch.Tensor      # episodes ended by destination arrival
    collision_count: torch.Tensor   # episodes ended by collision

    @staticmethod
    def zero(n: int, device=None) -> "EpisodeStats":
        def z():
            return torch.zeros((n,), dtype=torch.float32, device=device)
        inf = torch.full((n,), float("inf"), dtype=torch.float32, device=device)
        return EpisodeStats(z(), z(), inf, -inf, z(), z(), z())

    def record(self, mask: torch.Tensor, ep_ret: torch.Tensor,
               ep_len: torch.Tensor, finished: torch.Tensor,
               collided: torch.Tensor) -> "EpisodeStats":
        """mask/ep_ret/ep_len/finished/collided: [E, N]; reduce over E."""
        m = mask.to(torch.float32)
        inf = torch.tensor(float("inf"), dtype=ep_ret.dtype, device=ep_ret.device)
        return EpisodeStats(
            count=self.count + m.sum(0),
            ret_sum=self.ret_sum + (ep_ret * m).sum(0),
            ret_min=torch.minimum(
                self.ret_min, torch.where(mask, ep_ret, inf).amin(0)),
            ret_max=torch.maximum(
                self.ret_max, torch.where(mask, ep_ret, -inf).amax(0)),
            len_sum=self.len_sum + (ep_len.to(torch.float32) * m).sum(0),
            finish_count=self.finish_count + (mask & finished).sum(0),
            collision_count=self.collision_count + (mask & collided).sum(0),
        )


class RolloutCarry(NamedTuple):
    env_state: DroneState                                   # [E, N, ...]
    obs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # self, nbr, mask
    ep_len: torch.Tensor                                    # [E, N] int32
    ep_ret: torch.Tensor                                    # [E, N]
    generator: torch.Generator                              # actions and control noise
    stats: EpisodeStats


class RolloutBatch(NamedTuple):
    """Stored experience, leaves [T, E, N, ...]."""

    obs_self: torch.Tensor
    obs_nbr: torch.Tensor
    obs_mask: torch.Tensor
    act: torch.Tensor
    rew: torch.Tensor
    val: torch.Tensor
    logp: torch.Tensor
    cut: torch.Tensor              # [T, E] path boundary after step t


def init_rollout_carry(world: WorldSpec, p: EnvParams, num_envs: int,
                       generator: torch.Generator, dtype=None,
                       lane_worlds=None) -> RolloutCarry:
    """Every lane reset and observed; `generator` lives on the world's
    device and draws the actions (and the control noise). lane_worlds: an
    optional lane world (leaves [num_envs, ...]); `world` then gives only
    the static shapes."""
    dtype = dtype or world.dtype
    env_world = world if lane_worlds is None else lane_worlds
    state = reset(env_world, p, (num_envs,), dtype)
    out, state = observe(env_world, state, p)
    n = world.num_drones
    return RolloutCarry(
        env_state=state,
        obs=(out.obs_self, out.obs_nbr, out.obs_mask),
        ep_len=torch.zeros((num_envs, n), dtype=torch.int32, device=world.device),
        ep_ret=torch.zeros((num_envs, n), dtype=dtype, device=world.device),
        generator=generator,
        stats=EpisodeStats.zero(n, world.device),
    )


def _empty_batch(carry: RolloutCarry, t_len: int, act_dim: int) -> RolloutBatch:
    obs_self, obs_nbr, obs_mask = carry.obs
    e, n = carry.ep_len.shape
    dev = carry.ep_len.device

    def buf(like, shape=None, dtype=None):
        shape = like.shape if shape is None else shape
        return torch.empty((t_len,) + tuple(shape), dtype=dtype or like.dtype,
                           device=dev)

    f32 = torch.float32
    return RolloutBatch(
        obs_self=buf(obs_self), obs_nbr=buf(obs_nbr), obs_mask=buf(obs_mask),
        act=buf(obs_self, (e, n, act_dim), f32), rew=buf(carry.ep_ret),
        val=buf(obs_self, (e, n), f32), logp=buf(obs_self, (e, n), f32),
        cut=buf(obs_mask, (e,), torch.bool))


@torch.no_grad()
def rollout_epoch(ac: ActorCritic, world: WorldSpec, env_p: EnvParams,
                  cfg: TrainConfig, carry: RolloutCarry,
                  lane_worlds=None) -> Tuple[RolloutCarry, RolloutBatch]:
    """Collect cfg.steps_per_epoch steps across all E lanes with the
    policy's current parameters. lane_worlds: an optional lane world
    (leaves [E, ...]); `world` then gives only the static shapes."""
    if lane_worlds is not None:
        world = lane_worlds
    t_len = cfg.steps_per_epoch
    batch = _empty_batch(carry, t_len, ac.act_dim)
    gen = carry.generator
    env_state, (obs_self, obs_nbr, obs_mask) = carry.env_state, carry.obs
    ep_len, ep_ret, stats = carry.ep_len, carry.ep_ret, carry.stats

    for t in range(t_len):
        ps = ac.step(obs_self, obs_nbr, obs_mask, 1.0, gen)
        a_inc = geo.rnd(ps.action, 2, env_p.parity_rounding)
        if cfg.action_mode == "direct":
            abs_action = a_inc
        else:
            abs_action = geo.rnd(env_p.acceler * a_inc + env_state.vel, 2,
                                 env_p.parity_rounding)
        noise = (torch.randn(abs_action.shape, generator=gen,
                             dtype=env_state.pos.dtype, device=abs_action.device)
                 if env_p.noise else None)
        env_state, out = step(world, env_state, abs_action, env_p, noise)

        ep_len = ep_len + 1
        ep_ret = ep_ret + out.reward

        # ---- lifecycle flags: terminal reads ep_len before any reset ----
        epoch_ended = t == t_len - 1
        arrive_all = torch.all(out.finish, dim=1)                   # [E]
        terminal = torch.any(out.finish, dim=1) | (
            torch.amax(ep_len, dim=1) > cfg.max_ep_len)

        # ---- collision branch: per-drone resets, no cut ----
        col_mask = out.done                                          # [E, N]
        none = torch.zeros_like(col_mask)
        stats = stats.record(col_mask, ep_ret, ep_len, finished=none,
                             collided=col_mask)
        env_state = reset_where(world, env_state, col_mask)
        ep_ret = torch.where(col_mask, 0.0, ep_ret)
        ep_len = torch.where(col_mask, 0, ep_len)

        # ---- full-reset branch ----
        full = arrive_all | epoch_ended                              # [E]
        full_mask = full[:, None].expand_as(col_mask)
        stats = stats.record(full_mask & arrive_all[:, None], ep_ret, ep_len,
                             finished=arrive_all[:, None].expand_as(col_mask),
                             collided=none)
        env_state = reset_where(world, env_state, full_mask)
        ep_ret = torch.where(full_mask, 0.0, ep_ret)
        ep_len = torch.where(full_mask, 0, ep_len)

        # ---- terminal branch (elif: only where not full); ep_len now
        # reads after the collision and full resets ----
        term = ~full & terminal                                      # [E]
        term_mask = term[:, None] & (out.finish | (ep_len > cfg.max_ep_len))
        stats = stats.record(term_mask, ep_ret, ep_len, finished=out.finish,
                             collided=none)
        env_state = reset_where(world, env_state, term_mask)
        ep_ret = torch.where(term_mask, 0.0, ep_ret)
        ep_len = torch.where(term_mask, 0, ep_len)

        cut = arrive_all | terminal | epoch_ended                    # [E]

        # ---- store (obs before the step, the rounded action, the logp
        # of the unrounded sample) ----
        for buf, x in zip(batch, (obs_self, obs_nbr, obs_mask, a_inc,
                                  out.reward, ps.value, ps.logp, cut)):
            buf[t] = x

        # ---- next obs: recomputed for lanes that reset anything ----
        any_reset = torch.any(col_mask, dim=1) | full | term         # [E]
        re_out, env_state = observe(world, env_state, env_p)
        r3 = any_reset[:, None, None]
        obs_self = torch.where(r3, re_out.obs_self, out.obs_self)
        obs_nbr = torch.where(r3[..., None], re_out.obs_nbr, out.obs_nbr)
        obs_mask = torch.where(r3, re_out.obs_mask, out.obs_mask)

    carry = RolloutCarry(env_state=env_state, obs=(obs_self, obs_nbr, obs_mask),
                         ep_len=ep_len, ep_ret=ep_ret, generator=gen, stats=stats)
    return carry, batch
