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
(worlds/multi.py) lane e steps its own scenario. Under a data-parallel
mesh (parallel/mesh.py) the carry holds this rank's lanes, and every draw
is made at the global lane count and cut to them (parallel/sharding.py).

One step is rollout_step, with its standard normals drawn before it
(step_draws: the policy's sample, then the control noise). rollout_epoch
runs it eagerly; make_rollout captures it once as a CUDA graph on a card
and replays it T times an epoch (utils/graphs.py), and gives the eager
loop on the CPU and under tensor parallelism (mesh.model > 1), whose
forward makes gloo all_reduces that a graph cannot hold.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from rvo3d_tpu_torch.config import EnvParams, TrainConfig
from rvo3d_tpu_torch.env import geometry as geo
from rvo3d_tpu_torch.env.env import observe, reset, reset_where, step
from rvo3d_tpu_torch.env.state import DroneState, WorldSpec
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.parallel.sharding import LaneDraws
from rvo3d_tpu_torch.utils import graphs


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
    def zero(n: int, device=None, ret_dtype=torch.float32) -> "EpisodeStats":
        """Counts in float32; the return fields in `ret_dtype`, float32 or
        the env's float64, the dtype recording returns gives them."""
        def z(dtype=torch.float32):
            return torch.zeros((n,), dtype=dtype, device=device)
        inf = torch.full((n,), float("inf"), dtype=ret_dtype, device=device)
        return EpisodeStats(z(), z(ret_dtype), inf, -inf, z(), z(), z())

    def record(self, mask: torch.Tensor, ep_ret: torch.Tensor,
               ep_len: torch.Tensor, finished: torch.Tensor,
               collided: torch.Tensor) -> "EpisodeStats":
        """mask/ep_ret/ep_len/finished/collided: [E, N]; reduce over E."""
        m = mask.to(torch.float32)
        inf = float("inf")
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
        stats=EpisodeStats.zero(n, world.device, torch.promote_types(torch.float32, dtype)),
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


def _lane_draws(carry: RolloutCarry, cfg: TrainConfig, mesh) -> LaneDraws:
    gen = carry.generator
    if mesh is None:
        return LaneDraws(gen, slice(None), carry.ep_len.shape[0])
    return LaneDraws(gen, mesh.lanes(cfg.num_envs), cfg.num_envs)


def step_draws(draws: LaneDraws, carry: RolloutCarry, env_p: EnvParams, act_dim: int):
    """One step's standard normals, in the order the step uses them: the
    policy's sample [E, N, act_dim] float32, then (env_p.noise) the control
    noise in the env's dtype, else None."""
    obs_self, pos = carry.obs[0], carry.env_state.pos
    eps = draws.randn(obs_self.shape[:-1] + (act_dim,), torch.float32, pos.device)
    noise = draws.randn(pos.shape, pos.dtype, pos.device) if env_p.noise else None
    return eps, noise


def rollout_step(ac: ActorCritic, world: WorldSpec, env_p: EnvParams, cfg: TrainConfig,
                 carry: RolloutCarry, eps: torch.Tensor, noise, epoch_ended,
                 mark: Optional[Callable[[], None]] = None
                 ) -> Tuple[RolloutCarry, RolloutBatch]:
    """One step of every lane with the draws of step_draws. `epoch_ended`
    is a bool, or a bool tensor of shape [1] (the graph's device flag).
    `mark`, when given, is called between the policy's action and the env
    step (the graphed loop's device stamp). Returns the carry after the
    step and its records, leaves [E, N, ...] in RolloutBatch's order."""
    env_state, (obs_self, obs_nbr, obs_mask) = carry.env_state, carry.obs
    ep_len, ep_ret, stats = carry.ep_len, carry.ep_ret, carry.stats
    ps = ac.step(obs_self, obs_nbr, obs_mask, 1.0, eps=eps)
    a_inc = geo.rnd(ps.action, 2, env_p.parity_rounding)
    if cfg.action_mode == "direct":
        abs_action = a_inc
    else:
        abs_action = geo.rnd(env_p.acceler * a_inc + env_state.vel, 2,
                             env_p.parity_rounding)
    if mark is not None:
        mark()
    env_state, out = step(world, env_state, abs_action, env_p, noise)

    ep_len = ep_len + 1
    ep_ret = ep_ret + out.reward

    # ---- lifecycle flags: terminal reads ep_len before any reset ----
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
    rec = RolloutBatch(obs_self, obs_nbr, obs_mask, a_inc, out.reward, ps.value,
                       ps.logp, cut)

    # ---- next obs: recomputed for lanes that reset anything ----
    any_reset = torch.any(col_mask, dim=1) | full | term         # [E]
    re_out, env_state = observe(world, env_state, env_p)
    r3 = any_reset[:, None, None]
    obs = (torch.where(r3, re_out.obs_self, out.obs_self),
           torch.where(r3[..., None], re_out.obs_nbr, out.obs_nbr),
           torch.where(r3, re_out.obs_mask, out.obs_mask))
    carry = carry._replace(env_state=env_state, obs=obs, ep_len=ep_len, ep_ret=ep_ret,
                           stats=stats)
    return carry, rec


@torch.no_grad()
def rollout_epoch(ac: ActorCritic, world: WorldSpec, env_p: EnvParams,
                  cfg: TrainConfig, carry: RolloutCarry,
                  lane_worlds=None, mesh=None) -> Tuple[RolloutCarry, RolloutBatch]:
    """Collect cfg.steps_per_epoch eager steps across the carry's lanes
    with the policy's current parameters: the loop on CPU tensors and under
    tensor parallelism, and the plain version the card's graph is held
    against. lane_worlds: an optional lane world (leaves [E, ...]); `world`
    then gives only the static shapes. mesh: a parallel.Mesh whose rank
    holds its lanes of cfg.num_envs in the carry (and in lane_worlds)."""
    if lane_worlds is not None:
        world = lane_worlds
    t_len = cfg.steps_per_epoch
    batch = _empty_batch(carry, t_len, ac.act_dim)
    draws = _lane_draws(carry, cfg, mesh)
    for t in range(t_len):
        eps, noise = step_draws(draws, carry, env_p, ac.act_dim)
        carry, rec = rollout_step(ac, world, env_p, cfg, carry, eps, noise,
                                  t == t_len - 1)
        for buf, x in zip(batch, rec):
            buf[t] = x
    return carry, batch


def make_rollout(ac: ActorCritic, world: WorldSpec, env_p: EnvParams, cfg: TrainConfig,
                 lane_worlds=None, mesh=None):
    """rollout(carry) -> (carry, batch). On a card (data-parallel ranks
    included) rollout_step captured once as a CUDA graph over a static
    carry, its draws made outside it and its records stored into the batch
    at a device step index, whose last value is the epoch-end flag
    (utils/graphs.GraphedLoop), replayed T times an epoch: the batch
    buffers are allocated once and reused, so an epoch's batch holds until
    the next epoch; the parameters are read in place, so the capture holds
    across in-place updates and load_state_dict. rollout_epoch on the CPU
    and under tensor parallelism (mesh.model > 1: the forward's gloo
    all_reduces cannot be captured)."""
    if not graphs.on_card(world.device) or (mesh is not None and mesh.model > 1):
        return lambda carry: rollout_epoch(ac, world, env_p, cfg, carry, lane_worlds, mesh)
    t_len = cfg.steps_per_epoch
    step_world = world if lane_worlds is None else lane_worlds
    loop = graphs.GraphedLoop(
        lambda c, draws, t: rollout_step(ac, step_world, env_p, cfg, c, *draws,
                                         t == t_len - 1, mark=loop.mark),
        world.device,
        draw=lambda c, lane_draws: step_draws(lane_draws, c, env_p, ac.act_dim),
        records=lambda c: _empty_batch(c, t_len, ac.act_dim), name="rollout",
        stamps=t_len)

    def rollout(carry: RolloutCarry) -> Tuple[RolloutCarry, RolloutBatch]:
        # the static carry holds no generator: the draws come from this one
        out, batch = loop(carry._replace(generator=None), t_len,
                          _lane_draws(carry, cfg, mesh))
        return out._replace(generator=carry.generator), batch
    return rollout
