"""Elementwise geometry: cones, collision times, kinematics, deviation
(counterpart of rvo3d_tpu/env/geometry.py).

Every function works over arbitrary leading axes ([E, N] or [E, N, M]) and
keeps the JAX package's operation order, so float64 results agree with the
NumPy oracle (rvo3d_tpu/env/oracle.py) to rounding.
"""

from __future__ import annotations

import math

import torch

INF = math.inf
PI = math.pi


def rnd(x: torch.Tensor, decimals: int, enabled: bool = True) -> torch.Tensor:
    """Parity rounding: scale, round half to even, unscale. float64 divides
    by the scale, as np.round does (the reference env). float32 multiplies
    by the scale's float32 reciprocal, as XLA compiles the JAX package's
    jnp.round (the arithmetic its policies were trained under): the two
    differ by one ulp on most values, and a 3-decimal value rounded again
    to 2 decimals can then land on the other side of a tie."""
    if not enabled:
        return x
    if x.dtype == torch.float64:
        return torch.round(x, decimals=decimals)
    scale = 10.0 ** decimals
    return torch.round(x * scale) * (1.0 / scale)


def wraptopi(theta: torch.Tensor) -> torch.Tensor:
    """The reference's single-correction wrap (vel_obs3D.py:195-202)."""
    theta = torch.where(theta > PI, theta - 2 * PI, theta)
    theta = torch.where(theta < -PI, theta + 2 * PI, theta)
    return theta


def norm3(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum of squares, then sqrt (the oracle's operation order)."""
    return torch.sqrt(torch.sum(v * v, dim=dim))


def cone_alpha(dis, r_sum, *, parity_round: bool = True):
    """VO cone half-angle asin((ra+rb)/|pb-pa|), wrapped and rounded."""
    ratio = torch.clamp(r_sum / torch.clamp(dis, min=1e-30), -1.0, 1.0)
    return rnd(wraptopi(torch.asin(ratio)), 2, parity_round)


def reciprocal_apex(pa, pra, prb, va, vb):
    """Priority-weighted reciprocal apex pr * (2*pa + (va+vb)*1)."""
    pr = pra / (pra + prb)
    return pr[..., None] * (2.0 * pa + (va + vb) * 1.0)


def angle_between(a, b, *, parity_round: bool = True):
    """acos(dot/(|a||b|)) with the reference's zero guard, wrapped and
    rounded to 2 decimals (vel_obs3D.get_beta)."""
    dot = torch.sum(a * b, dim=-1)
    mag = norm3(a) * norm3(b)
    nz = mag != 0.0
    cos = torch.where(nz, dot / torch.where(nz, mag, torch.ones_like(mag)),
                      torch.zeros_like(dot))
    cos = torch.clamp(cos, -1.0, 1.0)
    return rnd(wraptopi(torch.acos(cos)), 2, parity_round)


def angle_between_eps(a, b):
    """The epsilon-protected angle of ir_gym.calculate_angle_between_vectors."""
    eps = 1e-8
    mag_a = torch.sqrt(torch.sum(a * a, dim=-1) + eps)
    mag_b = torch.sqrt(torch.sum(b * b, dim=-1) + eps)
    dot = torch.sum(a * b, dim=-1)
    cos = torch.clamp(dot / (mag_a * mag_b), -1.0 + eps, 1.0 - eps)
    ang = torch.acos(cos)
    return torch.where((mag_a < 1e-6) | (mag_b < 1e-6), torch.zeros_like(ang), ang)


def vo_expected_time(rel_p, rel_v_origin, r_sum):
    """Expected collision time of the reciprocal relative motion: 0 if
    overlapping, inf if no real crossing, -1 if both roots are negative,
    else the least positive root (vel_obs3D.cal_vo_exp_tim)."""
    rel_v = -rel_v_origin
    a = torch.sum(rel_v * rel_v, dim=-1)
    b = 2.0 * torch.sum(rel_p * rel_v, dim=-1)
    c = torch.sum(rel_p * rel_p, dim=-1) - r_sum * r_sum
    disc = b * b - 4.0 * a * c
    safe_a = torch.where(a != 0.0, a, torch.ones_like(a))
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b + sq) / (2.0 * safe_a)
    t2 = (-b - sq) / (2.0 * safe_a)
    both_neg = (t1 < 0.0) & (t2 < 0.0)
    inf = torch.full_like(t1, INF)
    t_pos = torch.minimum(torch.where(t1 >= 0.0, t1, inf),
                          torch.where(t2 >= 0.0, t2, inf))
    t = torch.where(disc <= 0.0, inf,
                    torch.where(both_neg, torch.full_like(t1, -1.0), t_pos))
    return torch.where(c <= 0.0, torch.zeros_like(t), t)


def vo_cone_outside(pa, action, paa, rel, alpha, delta_t, *, parity_round=True):
    """Is the doubled post-action position outside the VO cone?
    (rvo_inter.vo_out_jud_vector)"""
    panew = pa + 2.0 * action * delta_t
    beta = angle_between(rel, panew - paa, parity_round=parity_round)
    return ~(alpha > beta)


def point_line_deviation(start, end, p):
    """Distance from p to the infinite line through (start, end); 0 when
    start == end (drone.calculate_deviation; not clamped to the segment)."""
    d = end - start
    mag = norm3(d)
    safe_mag = torch.where(mag != 0.0, mag, torch.ones_like(mag))
    d_hat = d / safe_mag[..., None]
    t = torch.sum((p - start) * d_hat, dim=-1)
    q = start + t[..., None] * d_hat
    dev = norm3(p - q)
    return torch.where(mag == 0.0, torch.zeros_like(dev), dev)


def polyline_length(waypoints, n_points):
    """Route length over the first n_points waypoints of a padded [W, 3]."""
    seg_len = norm3(waypoints[1:] - waypoints[:-1])
    idx = torch.arange(seg_len.shape[0], device=waypoints.device)
    return torch.sum(torch.where(idx < (n_points - 1), seg_len,
                                 torch.zeros_like(seg_len)))


def desired_velocity(pos, des, vel_max, goal_threshold, *, parity_round=True):
    """Max-speed unit vector toward the current waypoint, rounded to 3
    decimals; zero inside the goal threshold (drone.cal_des_vel)."""
    dif = des - pos
    dis = norm3(dif)
    azimuth = torch.atan2(dif[..., 1], dif[..., 0])
    horiz = torch.sqrt(dif[..., 0] ** 2 + dif[..., 1] ** 2)
    elevation = torch.atan2(dif[..., 2], horiz)
    direction = torch.stack([
        torch.cos(azimuth) * torch.cos(elevation),
        torch.sin(azimuth) * torch.cos(elevation),
        torch.sin(elevation),
    ], dim=-1)
    vel = rnd(vel_max * direction, 3, parity_round)
    return torch.where((dis > goal_threshold)[..., None], vel,
                       torch.zeros_like(vel))


def kinematic_step(vel, yaw_deg, pitch_deg, action, max_acc, max_angle_change):
    """Speed/yaw/pitch kinematics (drone.kinematicstep). Yaw wraps with
    Python's floor modulo (torch.remainder), as the reference's `% 360`.
    Returns (new_vel [..., 3], new_yaw_deg, new_pitch_deg, new_speed)."""
    speed = norm3(vel)
    acc_delta = torch.clamp(action[..., 0] * max_acc, -max_acc, max_acc)
    yaw_delta = torch.clamp(action[..., 1] * max_angle_change,
                            -max_angle_change, max_angle_change)
    pitch_delta = torch.clamp(action[..., 2] * max_angle_change,
                              -max_angle_change, max_angle_change)
    new_speed = torch.clamp(speed + acc_delta * 1.0, min=0.0)
    new_yaw = torch.remainder(yaw_deg + yaw_delta, 360.0)
    new_pitch = torch.clamp(pitch_deg + pitch_delta, -90.0, 90.0)
    yaw_rad = torch.deg2rad(new_yaw)
    pitch_rad = torch.deg2rad(new_pitch)
    new_vel = torch.stack([
        new_speed * torch.cos(pitch_rad) * torch.cos(yaw_rad),
        new_speed * torch.cos(pitch_rad) * torch.sin(yaw_rad),
        new_speed * torch.sin(pitch_rad),
    ], dim=-1)
    return new_vel, new_yaw, new_pitch, new_speed


def deviation_penalty(deviation):
    """Sigmoid route-deviation penalty -1.5 * 2 / (1 + exp(-(10d - 5)/0.3))."""
    d = deviation * 10.0
    return -1.5 * (2.0 / (1.0 + torch.exp(-(d - 5.0) / 0.3)))


def out_of_map(pos, map_size):
    """True where any coordinate leaves [0, map_size]."""
    return torch.any(pos < 0.0, dim=-1) | torch.any(pos > map_size, dim=-1)
