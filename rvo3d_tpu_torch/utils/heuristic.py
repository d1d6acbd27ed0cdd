"""Analytic waypoint-tracking controller (counterpart of
rvo3d_tpu/utils/heuristic.py): steer yaw/pitch toward the current waypoint
and regulate speed, in the action space of kinematic increments
[acc, dyaw/90, dpitch/90]. A non-learning policy that flies the drones."""

from __future__ import annotations

import torch

from rvo3d_tpu_torch.env import geometry as geo
from rvo3d_tpu_torch.env.state import DroneState, WorldSpec


def waypoint_controller(state: DroneState, world: WorldSpec,
                        cruise_speed: float = 0.8, dt: float = 1.0) -> torch.Tensor:
    """Actions [..., N, 3] in [-1, 1]."""
    dif = state.current_des(world) - state.pos
    dist = geo.norm3(dif)
    t_yaw = torch.remainder(torch.rad2deg(torch.atan2(dif[..., 1], dif[..., 0])), 360.0)
    horiz = torch.sqrt(dif[..., 0] ** 2 + dif[..., 1] ** 2)
    t_pitch = torch.rad2deg(torch.atan2(dif[..., 2], horiz))
    dyaw = torch.remainder(t_yaw - state.yaw + 180.0, 360.0) - 180.0
    dpitch = t_pitch - state.pitch
    speed = geo.norm3(state.vel)
    acc = torch.clamp(torch.clamp(dist / dt, max=cruise_speed) - speed, -1.0, 1.0)
    return torch.stack([acc, torch.clamp(dyaw / 90.0, -1.0, 1.0),
                        torch.clamp(dpitch / 90.0, -1.0, 1.0)], dim=-1)
