"""Rewards: RVO shaping on pre-step states plus movement reward on
post-step states; reward = rvo + mov (counterpart of rvo3d_tpu/env/reward.py).
"""

from __future__ import annotations

import math

import torch

from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import geometry as geo
from rvo3d_tpu_torch.env.rvo import vo_reward_info


def angle_bucket_bonus(angle: torch.Tensor) -> torch.Tensor:
    """|angle| < pi/18 -> +3; < pi/6 -> +1; < pi/3 -> +0.5; < pi/2 -> 0;
    else -4 (ir_gym.rvo_reward_cal)."""
    out = torch.full_like(angle, -4.0)
    out = torch.where(angle < math.pi / 2, torch.zeros_like(angle), out)
    out = torch.where(angle < math.pi / 3, torch.full_like(angle, 0.5), out)
    out = torch.where(angle < math.pi / 6, torch.ones_like(angle), out)
    return torch.where(angle < math.pi / 18, torch.full_like(angle, 3.0), out)


def rvo_reward(states: torch.Tensor, actions: torch.Tensor, p: EnvParams,
               others=None) -> torch.Tensor:
    """RVO shaping reward on pre-step states, rounded to 3 decimals:
    angle bucket + 0.2*|a|/|des_vel| + urgency. In parity mode
    (safe_rewards=False) the division is unguarded, so an arrived drone
    (des_vel = 0) gets +inf, as in the reference (ir_gym.py:88).
    states [..., N, 12], actions [..., N, 3] -> [..., N]."""
    info = vo_reward_info(states, actions, p, others)
    des_vel = geo.rnd(states[..., 8:11], 3, p.parity_rounding)
    denom = geo.norm3(des_vel)
    if p.safe_rewards:
        vel_penalty = torch.where(
            denom > 0.0,
            0.2 * geo.norm3(actions) / torch.clamp(denom, min=1e-6),
            torch.zeros_like(denom))
    else:
        vel_penalty = 0.2 * geo.norm3(actions) / denom
    angle_punish = angle_bucket_bonus(geo.angle_between_eps(des_vel, actions))
    t = info.min_exp_time
    urgency = torch.where(t < 2.0, p.rvo_p_urgent * torch.exp(-t / 0.5),
                          torch.zeros_like(t))
    safety = torch.where(info.vo_flag, p.rvo_p_base + urgency,
                         torch.zeros_like(t))
    total = angle_punish + vel_penalty + safety
    if p.safe_rewards:
        total = torch.clamp(total, -100.0, 100.0)
    return geo.rnd(total, 3, p.parity_rounding)


def mov_reward(collision, arrive_reward_flag, waypoint_num, n_points_m1,
               dest_arrive_reward_flag, deviation, exlen_pos, exlen,
               p: EnvParams) -> torch.Tensor:
    """Movement reward on post-step state (ir_gym.mov_reward): collision
    -50 flat; waypoint +3*0.95^(n-1-i); destination +20; deviation sigmoid
    penalty; extra length -0.3*log(exlen+1+1e-6) floored at -6."""
    zero = torch.zeros_like(deviation)
    way = torch.where(
        arrive_reward_flag,
        p.mov_p_way * torch.pow(torch.full_like(deviation, 0.95),
                                (n_points_m1 - waypoint_num).to(deviation.dtype)),
        zero)
    dest = torch.where(dest_arrive_reward_flag,
                       torch.full_like(deviation, p.mov_p_dest), zero)
    dev_pen = geo.deviation_penalty(deviation)
    exlen_raw = p.mov_p_exlen * torch.log(exlen + 1.0 + 1e-6)
    exlen_raw = torch.where((exlen_raw < -6.0) | torch.isnan(exlen_raw),
                            torch.full_like(exlen_raw, -6.0), exlen_raw)
    exlen_pen = torch.where(exlen_pos, exlen_raw, zero)
    total = geo.rnd(way + dest + dev_pen + exlen_pen, 3, p.parity_rounding)
    return torch.where(collision, torch.full_like(total, p.mov_collision), total)


def osc_reward(vel_hist: torch.Tensor, parity_rounding: bool = True) -> torch.Tensor:
    """Oscillation penalty (ir_gym.osc_reward, dormant upstream): -10 where
    consecutive heading changes alternate sign (+,-,+ or -,+,-), scanning
    triples j in range(len-3) as the reference does. vel_hist [T, ..., 3]."""
    t_len = vel_hist.shape[0]
    zeros = torch.zeros(vel_hist.shape[1:-1], dtype=vel_hist.dtype,
                        device=vel_hist.device)
    if t_len < 3:
        return zeros
    ang = geo.angle_between_eps(vel_hist[1:], vel_hist[:-1])
    dif = geo.rnd(geo.wraptopi(ang[1:] - ang[:-1]), 2, parity_rounding)
    n = dif.shape[0]
    if n < 4:
        return zeros
    a, b, c = dif[:n - 3], dif[1:n - 2], dif[2:n - 1]
    osc = ((a > 0) & (b < 0) & (c > 0)) | ((a < 0) & (b > 0) & (c < 0))
    return torch.where(torch.any(osc, dim=0), torch.full_like(zeros, -10.0), zeros)
