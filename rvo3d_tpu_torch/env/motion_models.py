"""Euler-angle and Ackermann motion models on tensors (counterpart of
rvo3d_tpu/env/motion_models.py; the reference's dormant motion_model.py,
which its main code never imports):

  motion_omni       : x' = x + v*dt, with optional Gaussian control noise
  euler_rotation    : Z-Y-X rotation matrices from (roll, pitch, yaw) degrees
  motion_euler      : body-frame velocity rotated to the world frame and
                      integrated; roll wrapped, pitch and yaw clipped
  ackermann_preview : bicycle-model rollout over a preview horizon
  ackermann_step    : discrete arc/straight step, steer in {-1, 0, 1}

Every function broadcasts over leading axes. Scalars given as Python
numbers take the state's dtype and device, as JAX's weak types do.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from rvo3d_tpu_torch.env.geometry import rnd


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def motion_omni(state: torch.Tensor, vel: torch.Tensor, dt: float,
                noise_generator: Optional[torch.Generator] = None,
                control_std: float = 0.01) -> torch.Tensor:
    """state + vel*dt; with a generator, vel gets N(0, control_std) noise
    drawn at vel's shape."""
    if noise_generator is not None:
        vel = vel + torch.randn(vel.shape, generator=noise_generator, dtype=vel.dtype,
                                device=vel.device) * control_std
    return state + vel * dt


def euler_rotation(roll_deg, pitch_deg, yaw_deg) -> torch.Tensor:
    """Z-Y-X (yaw @ pitch @ roll) rotation matrices [..., 3, 3]."""
    ref = next((t for t in (roll_deg, pitch_deg, yaw_deg) if isinstance(t, torch.Tensor)),
               torch.zeros(()))
    r, p, y = (torch.deg2rad(_like(a, ref)) for a in (roll_deg, pitch_deg, yaw_deg))
    r, p, y = torch.broadcast_tensors(r, p, y)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], -1)
    return torch.stack([row0, row1, row2], -2)


def motion_euler(pos: torch.Tensor, angles_deg: torch.Tensor, vel_body: torch.Tensor,
                 dt: float, steer_limit_deg: float = 90.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pos [..., 3]; angles_deg [..., 3] (roll, pitch, yaw); vel_body
    [..., 3] (forward, lateral, vertical). Returns (pos', angles')."""
    roll, pitch, yaw = angles_deg[..., 0], angles_deg[..., 1], angles_deg[..., 2]
    rot = euler_rotation(roll, pitch, yaw)
    vel_world = torch.einsum("...ij,...j->...i", rot, vel_body)
    new_pos = pos + vel_world * dt
    roll = ((roll + 180.0) % 360.0) - 180.0
    pitch = torch.clamp(pitch, -steer_limit_deg, steer_limit_deg)
    yaw = torch.clamp(yaw, -steer_limit_deg, steer_limit_deg)
    return new_pos, torch.stack([roll, pitch, yaw], -1)


def ackermann_preview(state: torch.Tensor, wheelbase: float = 1.0, vel: float = 1.0,
                      psi=0.0, steer_limit: float = math.pi / 4,
                      pre_time: float = 2.0, dt: float = 0.1) -> torch.Tensor:
    """state [..., 4] = (x, y, phi, psi). Integrates the bicycle model for
    round(pre_time / dt) steps of dt; returns the final state."""
    psi_c = torch.clamp(_like(psi, state), -steer_limit, steer_limit)
    s = state
    for _ in range(int(round(pre_time / dt))):
        phi = s[..., 2]
        d = torch.stack([vel * torch.cos(phi), vel * torch.sin(phi),
                         torch.broadcast_to(vel * torch.tan(psi_c) / wheelbase, phi.shape),
                         torch.zeros_like(phi)], -1)
        s = s + d * dt
        phi = s[..., 2]
        phi = torch.where(phi > math.pi, phi - 2 * math.pi, phi)
        phi = torch.where(phi < -math.pi, phi + 2 * math.pi, phi)
        s = torch.cat([s[..., :2], phi[..., None],
                       torch.broadcast_to(psi_c, phi.shape)[..., None]], -1)
    return s


def ackermann_step(state: torch.Tensor, gear=1.0, steer=0.0, step_size: float = 0.5,
                   min_radius: float = 1.0) -> torch.Tensor:
    """Discrete arc/straight primitive. state [..., 3] = (x, y, theta);
    steer in {-1, 0, 1} (left/straight/right), gear in {-1, 1}. The result
    is rounded to 4 decimals by the port's parity rounding (env/geometry.rnd:
    float32 multiplies by the scale's reciprocal, as XLA compiles
    jnp.round; float64 divides)."""
    x, y, theta = state[..., 0], state[..., 1], state[..., 2]
    gear, steer = _like(gear, state), _like(steer, state)
    curvature = steer / min_radius
    rot = torch.abs(steer) * step_size * curvature * gear
    trans = (1.0 - torch.abs(steer)) * step_size * gear
    cx = x + torch.cos(theta + steer * math.pi / 2) * min_radius
    cy = y + torch.sin(theta + steer * math.pi / 2) * min_radius
    dx, dy = x - cx, y - cy
    nx = cx + torch.cos(rot) * dx - torch.sin(rot) * dy + trans * torch.cos(theta)
    ny = cy + torch.sin(rot) * dx + torch.cos(rot) * dy + trans * torch.sin(theta)
    ntheta = (theta + rot) % (2 * math.pi)
    return torch.stack([rnd(nx, 4), rnd(ny, 4), rnd(ntheta, 4)], -1)
