"""Classic (non-learning) reciprocal-velocity-obstacle controller
(counterpart of rvo3d_tpu/env/rvo_policy.py; reference
uaisa_env/vel_obs/reciprocal_vel_obs.py:21-166).

Grid-search candidate velocities, keep those outside every neighbour's RVO
cone and the env's discrete endpoint test, pick the feasible candidate
closest to the desired velocity (with a climb-and-right convention term),
otherwise minimize an expected-collision-time penalty; then convert the
chosen velocity to the env's kinematic action. The JAX package vmaps a
per-drone function; here every drone of every lane and every candidate is
one element of an [..., N, C(, M)] tensor program. Candidates below the
minimum speed stay in the tensor with an infinite cost, so shapes are
static.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import geometry as geo
from rvo3d_tpu_torch.env.env import _vo_others, drone_states_12
from rvo3d_tpu_torch.env.state import DroneState, WorldSpec

INF = float("inf")
# a margin for every drone, or one per lane: a tensor of the state's lead shape
Margin = Optional[Union[float, torch.Tensor]]


def candidate_grid(vmax: float, spacing: float, min_speed: float, dtype, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """([C, 3] velocity candidates on a cubic grid, [C] usable). At the
    defaults the axis holds the 9 values -1, -0.75, ..., 1: C = 729."""
    axis = torch.arange(-vmax, vmax + 1e-6, spacing, dtype=dtype, device=device)
    gx, gy, gz = torch.meshgrid(axis, axis, axis, indexing="ij")
    cands = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)
    return cands, geo.norm3(cands) >= min_speed


def rvo_choice(world: WorldSpec, state: DroneState, p: EnvParams,
               spacing: float = 0.25, min_speed: float = 0.0, vmax: float = 1.0,
               margin: Margin = None, slowdown: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(chosen candidate index [..., N], candidates [C, 3]); see rvo_velocity."""
    if margin is None:
        margin = p.exp_radius
    states12, _ = drone_states_12(world, state, p)
    others = _vo_others(world, state, states12)
    if others is None:
        others = states12[..., 0:8]

    pos = states12[..., 0:3]
    vel = states12[..., 3:6]
    radius = states12[..., 6]
    prio = states12[..., 7]
    des = states12[..., 8:11]
    if slowdown:
        # aim to land on the active waypoint when it is closer than one
        # max-speed step (else a drone can overfly the arrival ball forever)
        land = (state.current_des(world) - pos) / p.dt
        des = torch.where((geo.norm3(land) < geo.norm3(des))[..., None], land, des)

    o_pos, o_vel = others[..., 0:3], others[..., 3:6]
    o_radius, o_prio = others[..., 6], others[..., 7]

    # pairs [..., N, M]
    rel = o_pos[..., None, :, :] - pos[..., :, None, :]
    dis = geo.norm3(rel)
    r_sum = radius[..., :, None] + o_radius[..., None, :]
    pos_equal = torch.all(pos[..., :, None, :] == o_pos[..., None, :, :], dim=-1)
    valid = (~pos_equal) & (dis <= p.drone_range) & (dis > r_sum)
    if isinstance(margin, torch.Tensor):      # per lane [...] -> [..., 1, 1]
        margin = margin.to(dis.dtype).reshape(margin.shape + (1, 1))
    r_safe = torch.minimum(r_sum + margin, dis - 1e-3)   # keep asin in range
    alpha = geo.cone_alpha(dis, r_safe, parity_round=False)
    paa = geo.reciprocal_apex(
        pos[..., :, None, :], prio[..., :, None].expand(dis.shape),
        o_prio[..., None, :].expand(dis.shape), vel[..., :, None, :],
        o_vel[..., None, :, :])

    cands, cand_ok = candidate_grid(vmax, spacing, min_speed, pos.dtype, pos.device)
    c_m = cands[:, None, :]                               # [C, 1, 3]

    # candidate x pair [..., N, C, M]: inside any neighbour's cone?
    panew = pos[..., :, None, None, :] + 2.0 * c_m * p.delta_t
    arr = panew - paa[..., :, None, :, :]
    beta = geo.angle_between(rel[..., :, None, :, :], arr, parity_round=False)
    valid_c = valid[..., :, None, :]
    blocked = torch.any((alpha[..., :, None, :] > beta) & valid_c, dim=-1)

    # map awareness: reject candidates whose 2-step lookahead leaves the map
    future = pos[..., :, None, :] + 2.0 * cands * p.dt    # [..., N, C, 3]
    r_c = radius[..., :, None, None]
    oob = torch.any((future < r_c) | (future > world.map_size[..., None, None, :] - r_c),
                    dim=-1)

    # discrete endpoint screen: next-step separation under constant
    # neighbour velocity must clear the inflated radius
    end_rel = rel[..., :, None, :, :] + (o_vel[..., None, None, :, :] - c_m) * p.dt
    end_close = torch.any((geo.norm3(end_rel) <= (r_sum + margin)[..., :, None, :])
                          & valid_c, dim=-1)              # [..., N, C]
    blocked = blocked | end_close

    des_c = des[..., :, None, :]
    dist_to_des = geo.norm3(cands - des_c)
    feasible = (~blocked) & cand_ok & (~oob)
    any_feasible = torch.any(feasible, dim=-1)

    # right-of-way convention: bias deviations toward climb-and-right of the
    # desired track, so that mirror-image dodges of a head-on encounter do
    # not tie (an MSE clone would average the two into no dodge)
    dev = cands - des_c
    # des x (0, 0, 1) = (d1, -d0, 0): the products with 0 and 1 are exact
    right = torch.stack([des[..., 1], -des[..., 0], torch.zeros_like(des[..., 0])], -1)
    right = (right / (geo.norm3(right) + 1e-9)[..., None])[..., :, None, :]
    dev_right = (dev[..., 0] * right[..., 0] + dev[..., 1] * right[..., 1]
                 + dev[..., 2] * right[..., 2])
    conv = -0.15 * (dev[..., 2] + dev_right) / (geo.norm3(dev) + 0.3)
    cost_feas = torch.where(feasible, dist_to_des + conv, INF)

    # infeasible fallback: expected collision time and desired-velocity distance
    rel_v = 2.0 * c_m - o_vel[..., None, None, :, :] - vel[..., :, None, None, :]
    t_exp = geo.vo_expected_time(rel[..., :, None, :, :], rel_v, r_sum[..., :, None, :])
    t_exp = torch.where(valid_c, t_exp, INF)
    t_min = torch.amin(t_exp, dim=-1)
    penalty = (1.0 / (t_min + 0.2) + dist_to_des
               + 10.0 * end_close.to(t_min.dtype))
    cost_pen = torch.where(cand_ok & (~oob), penalty, INF)

    idx = torch.where(any_feasible, torch.argmin(cost_feas, dim=-1),
                      torch.argmin(cost_pen, dim=-1))
    return idx, cands


def rvo_velocity(world: WorldSpec, state: DroneState, p: EnvParams,
                 spacing: float = 0.25, min_speed: float = 0.0, vmax: float = 1.0,
                 margin: Margin = None, slowdown: bool = False) -> torch.Tensor:
    """Per-drone collision-free velocities [..., N, 3].

    Beyond the reference's continuous-time cone test, candidates are also
    screened by the env's own collision rule, the endpoint distance after
    one dt. `margin` (default p.exp_radius) inflates radii in both tests,
    by one value or by one per lane (a tensor of the state's lead shape);
    `slowdown` aims to land on the active waypoint when one step away."""
    idx, cands = rvo_choice(world, state, p, spacing, min_speed, vmax, margin, slowdown)
    return cands[idx]


def velocity_to_action(state: DroneState, target_vel: torch.Tensor,
                       p: EnvParams) -> torch.Tensor:
    """A target velocity [..., N, 3] as the kinematic action
    [acc, dyaw/90, dpitch/90]; angles wrap with floor modulo."""
    t_speed = geo.norm3(target_vel)
    t_yaw = torch.remainder(torch.rad2deg(torch.atan2(target_vel[..., 1],
                                                      target_vel[..., 0])), 360.0)
    horiz = torch.sqrt(target_vel[..., 0] ** 2 + target_vel[..., 1] ** 2)
    t_pitch = torch.rad2deg(torch.atan2(target_vel[..., 2], horiz))
    # zero target velocity: hold heading, kill speed
    zero = t_speed < 1e-9
    t_yaw = torch.where(zero, state.yaw, t_yaw)
    t_pitch = torch.where(zero, state.pitch, t_pitch)
    dyaw = torch.remainder(t_yaw - state.yaw + 180.0, 360.0) - 180.0
    dpitch = t_pitch - state.pitch
    speed = geo.norm3(state.vel)
    return torch.stack([
        torch.clamp(t_speed - speed, -1.0, 1.0),
        torch.clamp(dyaw / p.max_angle_change, -1.0, 1.0),
        torch.clamp(dpitch / p.max_angle_change, -1.0, 1.0)], dim=-1)


def rvo_controller(state: DroneState, world: WorldSpec,
                   p: Optional[EnvParams] = None, **kw) -> torch.Tensor:
    """controller(state, world) -> actions [..., N, 3]; kw go to rvo_velocity."""
    p = p or EnvParams(num_drones=world.num_drones)
    return velocity_to_action(state, rvo_velocity(world, state, p, **kw), p)
