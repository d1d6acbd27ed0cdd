"""The vectorized drone environment: reset / observe / step over [E, N]
(counterpart of rvo3d_tpu/env/env.py).

One step follows the reference's mdin.drone_step (mdin.py:19-30):
  1. RVO shaping reward on pre-step states
  2. kinematics, integration, waypoint advance (with the effective `stop`
     freeze of arrived/collided drones)
  3. observation and movement reward on post-step states
  4. reward = rvo + mov
Lanes and agents are tensor axes; functions take the fleet state with any
leading shape ([E, N, ...] or [N, ...]) against one WorldSpec, or an
[E, N, ...] state against a lane world whose leaves lead with the same E
(worlds/multi.py): lane e then steps its own world.

step, observe and reset_where take the plain PyTorch versions below
(step_plain, observe_plain, reset_where_plain) for CPU tensors, and for
CUDA tensors the hand-written per-drone passes of ops/env_drones.py
(csrc/env_drones.cu) around the VO kernel's launches: 3 passes and 2 VO
launches a step, 2 and 1 an observation, 1 a reset, with the same
arithmetic; the card tests hold them to the plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import geometry as geo
from rvo3d_tpu_torch.env.obstacles import sphere_states8, step_spheres
from rvo3d_tpu_torch.env.reward import mov_reward, rvo_reward
from rvo3d_tpu_torch.env.rvo import vo_observe, vo_reward_info
from rvo3d_tpu_torch.env.state import (DroneState, StepOutput, WorldSpec,
                                       init_drone_state)
from rvo3d_tpu_torch.ops import env_drones


def drone_states_12(world: WorldSpec, state: DroneState,
                    p: EnvParams) -> Tuple[torch.Tensor, DroneState]:
    """[pos, vel, radius, priority, des_vel, deviation] per drone
    (drone.dronestate); updates the running max_deviation as the
    reference's side effect does. Returns (states [..., N, 12], state)."""
    cur_des = state.current_des(world)
    prev_des = state.previous_des(world)
    des_vel = geo.desired_velocity(state.pos, cur_des, world.vel_max,
                                   p.goal_threshold,
                                   parity_round=p.parity_rounding)
    dev = geo.point_line_deviation(prev_des, cur_des, state.pos)
    dtype = state.pos.dtype
    states = torch.cat([
        state.pos, state.vel,
        world.radius.to(dtype).expand_as(dev)[..., None],
        world.priority.to(dtype).expand_as(dev)[..., None],
        des_vel, dev[..., None],
    ], dim=-1)
    state = state._replace(max_deviation=torch.maximum(state.max_deviation, dev))
    return states, state


def reset(world: WorldSpec, p: EnvParams, lead=(), dtype=None) -> DroneState:
    """Full fleet reset for `lead` lanes (e.g. (E,))."""
    del p
    return init_drone_state(world, lead, dtype)


def reset_where(world: WorldSpec, state: DroneState,
                mask: torch.Tensor) -> DroneState:
    """Reset drones where mask [..., N]; the others are untouched. Sphere
    obstacles of a lane reset only when every drone of it resets. The
    `reset` pass for CUDA tensors, reset_where_plain for CPU tensors."""
    if not state.pos.is_cuda:
        return reset_where_plain(world, state, mask)
    return _reset_where_passes(world, state, mask)


def _reset_where_passes(world: WorldSpec, state: DroneState,
                        mask: torch.Tensor) -> DroneState:
    fields = env_drones.reset(world, state, mask)
    if world.sphere_count:
        full = torch.all(mask, dim=-1)[..., None, None]
        init = world.spheres.init.to(state.pos.dtype)
        fields["sphere_pos"] = torch.where(full, init[..., 0:3], state.sphere_pos)
        fields["sphere_vel"] = torch.where(full, init[..., 3:6], state.sphere_vel)
    else:
        fields["sphere_pos"], fields["sphere_vel"] = state.sphere_pos, state.sphere_vel
    return DroneState(**fields)


def reset_where_plain(world: WorldSpec, state: DroneState,
                      mask: torch.Tensor) -> DroneState:
    """reset_where in plain PyTorch."""
    fresh = init_drone_state(world, mask.shape[:-1], state.pos.dtype)
    full = torch.all(mask, dim=-1)

    def pick(a, b, m):
        while m.dim() < a.dim():
            m = m[..., None]
        return torch.where(m, a, b)

    fields = {}
    for name, a, b in zip(DroneState._fields, fresh, state):
        fields[name] = pick(a, b, full if name.startswith("sphere") else mask)
    return DroneState(**fields)


def _vo_others(world: WorldSpec, state: DroneState,
               states12: torch.Tensor) -> Optional[torch.Tensor]:
    """The drones plus any sphere obstacles as VO participants."""
    if world.sphere_count == 0:
        return None
    sph = sphere_states8(state.sphere_pos, state.sphere_vel, world.spheres)
    return torch.cat([states12[..., 0:8], sph.to(states12.dtype)], dim=-2)


def observe(world: WorldSpec, state: DroneState,
            p: EnvParams) -> Tuple[StepOutput, DroneState]:
    """Observation-only pass with a zero action; obs rounded to 2 decimals;
    reward and done are zero (ir_gym.observation). The `obs` and `post`
    passes around a VO launch for CUDA tensors, observe_plain for CPU
    tensors."""
    if not state.pos.is_cuda:
        return observe_plain(world, state, p)
    return _observe_passes(world, state, p)


def _observe_passes(world: WorldSpec, state: DroneState,
                    p: EnvParams) -> Tuple[StepOutput, DroneState]:
    states12, obs_self, max_dev, act0 = env_drones.obs(world, state, p)
    state = state._replace(max_deviation=max_dev)
    vo = vo_observe(states12, act0, world.buildings, world.building_mask, p,
                    others=_vo_others(world, state, states12))
    reward, done = env_drones.post_obs(world, state, vo.obs_nbr, vo.obs_mask, p)
    out = StepOutput(obs_self=obs_self, obs_nbr=vo.obs_nbr, obs_mask=vo.obs_mask,
                     reward=reward, done=done, info_arrive=state.arrive_flag,
                     finish=state.dest_arrive_flag)
    return out, state


def observe_plain(world: WorldSpec, state: DroneState,
                  p: EnvParams) -> Tuple[StepOutput, DroneState]:
    """observe in plain PyTorch."""
    states12, state = drone_states_12(world, state, p)
    vo = vo_observe(states12, torch.zeros_like(state.vel), world.buildings,
                    world.building_mask, p,
                    others=_vo_others(world, state, states12))
    out = StepOutput(
        obs_self=geo.rnd(states12, 2, p.parity_rounding),
        obs_nbr=geo.rnd(vo.obs_nbr, 2, p.parity_rounding),
        obs_mask=vo.obs_mask,
        reward=torch.zeros_like(state.yaw),
        done=torch.zeros_like(state.arrive_flag),
        info_arrive=state.arrive_flag,
        finish=state.dest_arrive_flag,
    )
    return out, state


def step(world: WorldSpec, state: DroneState, abs_action: torch.Tensor,
         p: EnvParams, noise: Optional[torch.Tensor] = None
         ) -> Tuple[DroneState, StepOutput]:
    """One step of every lane. abs_action [..., N, 3] is the absolute
    [acc, yaw, pitch] command. With p.noise, `noise` holds pre-drawn
    standard-normal samples [..., N, 3]; they are scaled by control_std and
    perturb the position update only (drone.py:150-169). The `pre`, `mid`
    and `post` passes around the two VO launches for CUDA tensors,
    step_plain for CPU tensors."""
    if not state.pos.is_cuda:
        return step_plain(world, state, abs_action, p, noise)
    return _step_passes(world, state, abs_action, p, noise)


def _step_passes(world: WorldSpec, state: DroneState, abs_action: torch.Tensor,
                 p: EnvParams, noise: Optional[torch.Tensor]
                 ) -> Tuple[DroneState, StepOutput]:
    if world.sphere_count:
        sp, sv = step_spheres(state.sphere_pos, state.sphere_vel,
                              world.spheres, world.map_size, p.dt,
                              p.goal_threshold)
        state = state._replace(sphere_pos=sp, sphere_vel=sv)
    states12_pre = env_drones.pre(world, state, p)
    info = vo_reward_info(states12_pre, abs_action, p,
                          others=_vo_others(world, state, states12_pre))
    mid = env_drones.mid(world, state, states12_pre, abs_action, info.vo_flag,
                         info.min_exp_time, p, noise)
    state = state._replace(**mid.fields)
    vo = vo_observe(mid.states12, abs_action, world.buildings, world.building_mask,
                    p, others=_vo_others(world, state, mid.states12))
    reward, done = env_drones.post(world, state, vo.collision, mid, vo.obs_nbr,
                                    vo.obs_mask, p)
    out = StepOutput(obs_self=mid.obs_self, obs_nbr=vo.obs_nbr, obs_mask=vo.obs_mask,
                     reward=reward, done=done, info_arrive=state.arrive_flag,
                     finish=state.dest_arrive_flag)
    return state, out


def step_plain(world: WorldSpec, state: DroneState, abs_action: torch.Tensor,
               p: EnvParams, noise: Optional[torch.Tensor] = None
               ) -> Tuple[DroneState, StepOutput]:
    """step in plain PyTorch."""
    dtype = state.pos.dtype

    if world.sphere_count:
        sp, sv = step_spheres(state.sphere_pos, state.sphere_vel,
                              world.spheres, world.map_size, p.dt,
                              p.goal_threshold)
        state = state._replace(sphere_pos=sp, sphere_vel=sv)

    # 1. RVO shaping reward on pre-step states
    states12_pre, state = drone_states_12(world, state, p)
    r_rvo = rvo_reward(states12_pre, abs_action, p,
                       others=_vo_others(world, state, states12_pre))

    # 2. physics; arrived/collided drones hold position
    new_vel, new_yaw, new_pitch, _ = geo.kinematic_step(
        state.vel, state.yaw, state.pitch, abs_action,
        p.max_acc, p.max_angle_change)
    frozen = state.dest_arrive_flag | state.collision_flag
    new_vel = torch.where(frozen[..., None], torch.zeros_like(new_vel), new_vel)
    if p.noise:
        if noise is None:
            raise ValueError("EnvParams.noise is set: pass pre-drawn `noise` samples")
        vel_eff = geo.rnd(new_vel + noise.to(dtype) * p.control_std, 2, True)
    else:
        vel_eff = new_vel
    new_pos = state.pos + vel_eff * p.dt
    real_route_len = state.real_route_len + geo.norm3(new_pos - state.pos)

    # waypoint advance (drone.py:116-130)
    cur_des = state.current_des(world)
    dest = world.destinations.to(dtype)
    arrived_wp = geo.norm3(new_pos - cur_des) <= p.goal_threshold
    at_dest = geo.norm3(new_pos - dest) <= p.goal_threshold
    route_len = world.route_len.to(dtype)
    extra_len = torch.where(arrived_wp & at_dest, real_route_len - route_len,
                            state.extra_len)
    can_advance = arrived_wp & (~at_dest) & (state.wp_idx < world.n_points - 1)
    new_wp_idx = torch.where(can_advance, state.wp_idx + 1, state.wp_idx)
    arrive_flag = state.arrive_flag & ~can_advance
    state = state._replace(
        pos=new_pos, vel=new_vel, yaw=new_yaw, pitch=new_pitch,
        wp_idx=new_wp_idx, arrive_flag=arrive_flag,
        real_route_len=real_route_len, extra_len=extra_len,
        prev_pos=state.pos)

    # 3. post-step observation and movement reward (ir_gym.py:156-254)
    states12_post, state = drone_states_12(world, state, p)
    cur_des2 = state.current_des(world)
    arrived_now = geo.norm3(new_pos - cur_des2) <= p.goal_threshold
    arrive_reward_flag = arrived_now & (~state.arrive_flag)
    arrive_flag = state.arrive_flag | arrived_now
    dest_now = arrive_flag & at_dest
    dest_reward_flag = dest_now & (~state.dest_arrive_flag)
    dest_arrive_flag = state.dest_arrive_flag | dest_now
    extra_len = torch.where(dest_now, real_route_len - route_len, state.extra_len)
    state = state._replace(arrive_flag=arrive_flag,
                           dest_arrive_flag=dest_arrive_flag,
                           extra_len=extra_len)

    vo = vo_observe(states12_post, abs_action, world.buildings,
                    world.building_mask, p,
                    others=_vo_others(world, state, states12_post))
    collision = vo.collision | geo.out_of_map(new_pos, world.map_size[..., None, :])
    exlen = real_route_len - route_len + 4.0
    r_mov = mov_reward(
        collision=collision, arrive_reward_flag=arrive_reward_flag,
        waypoint_num=new_wp_idx, n_points_m1=world.n_points - 1,
        dest_arrive_reward_flag=dest_reward_flag,
        deviation=states12_post[..., 11], exlen_pos=exlen > 0.0, exlen=exlen,
        p=p)
    if p.mov_p_progress:
        progress = (geo.norm3(state.prev_pos - cur_des)
                    - geo.norm3(new_pos - cur_des))
        r_mov = r_mov + torch.where(collision, torch.zeros_like(progress),
                                    p.mov_p_progress * progress)

    out = StepOutput(
        obs_self=geo.rnd(states12_post, 2, p.parity_rounding),
        obs_nbr=geo.rnd(vo.obs_nbr, 2, p.parity_rounding),
        obs_mask=vo.obs_mask,
        reward=r_rvo + r_mov,
        done=collision,
        info_arrive=arrive_flag,
        finish=dest_arrive_flag,
    )
    return state, out


class DroneEnv:
    """(world, params) bound over E lanes: reset / observe / step /
    reset_where on [E, N, ...] state."""

    def __init__(self, world: WorldSpec, params: EnvParams, num_envs: int = 1,
                 dtype: Optional[torch.dtype] = None):
        self.world = world
        self.params = params
        self.num_envs = num_envs
        self.dtype = dtype or world.dtype

    def reset(self) -> Tuple[DroneState, StepOutput]:
        s = reset(self.world, self.params, (self.num_envs,), self.dtype)
        out, s = observe(self.world, s, self.params)
        return s, out

    def step(self, state: DroneState, abs_action: torch.Tensor,
             noise: Optional[torch.Tensor] = None):
        return step(self.world, state, abs_action, self.params, noise)

    def observe(self, state: DroneState):
        return observe(self.world, state, self.params)

    def reset_where(self, state: DroneState, mask: torch.Tensor) -> DroneState:
        return reset_where(self.world, state, mask)

    @staticmethod
    def obs_flat(out: StepOutput) -> torch.Tensor:
        """(self, neighbours) in the reference's concatenated layout
        [..., 12 + 9*nm]."""
        nbr = out.obs_nbr.reshape(out.obs_nbr.shape[:-2] + (-1,))
        return torch.cat([out.obs_self, nbr], dim=-1)
