"""All-pairs 3D reciprocal-velocity-obstacle engine (counterpart of
rvo3d_tpu/env/rvo.py).

Every ordered pair (i = self, j = other) of every lane is one element of an
[..., N, M] tensor program; the branches of the reference's
config_vo_circle2 (rvo_inter.py:116-196) become selects:
  collision : dis <= r_a + r_b      -> obs [p, rel, 0, 0, 0]
  back-off  : dot(v_a, rel) <= 0    -> obs [p, rel, 0, -1, -1]
  normal    : cone alpha/apex/membership -> obs [PAA, rel, alpha, min_dis,
                                                 1/(exp_time+0.2)]
Neighbour gates: drones within 10 m (self excluded by exact position
equality); buildings with h > z-2 and horizontal distance <= 5 m.

vo_reward_info and vo_observe take the plain PyTorch version below for CPU
tensors, and for CUDA tensors the hand-written kernel of ops/vo_pairs.py
(csrc/vo_pairs.cu), which computes each row's pairs and reduces them in
one launch with the same arithmetic; the card tests hold it to the plain
version.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import geometry as geo
from rvo3d_tpu_torch.ops import vo_pairs

INF = math.inf


class PairwiseVO(NamedTuple):
    valid: torch.Tensor      # [..., N, M] neighbour gate
    collision: torch.Tensor  # [..., N, M] pair collision branch
    vo_flag: torch.Tensor    # [..., N, M] inside cone and expected time < threshold
    exp_time: torch.Tensor   # [..., N, M]
    obs9: torch.Tensor       # [..., N, M, 9]
    min_dis4: torch.Tensor   # [..., N, M] 5th return slot of config_vo_circle2
    sort_t: torch.Tensor     # [..., N, M] urgency key (ascending)
    sort_d: torch.Tensor     # [..., N, M] min_dis secondary key (descending)


def pairwise_vo(states: torch.Tensor, actions: torch.Tensor, p: EnvParams,
                others: Optional[torch.Tensor] = None) -> PairwiseVO:
    """states [..., N, 12] = [pos, vel, radius, priority, des_vel, dev];
    actions [..., N, 3]; others [..., M, 8] (defaults to the drones)."""
    pos = states[..., 0:3]
    vel = states[..., 3:6]
    radius = states[..., 6]
    prio = states[..., 7]
    if others is None:
        others = states[..., 0:8]
    o_pos = others[..., 0:3]
    o_vel = others[..., 3:6]
    o_radius = others[..., 6]
    o_prio = others[..., 7]

    # the reference zeroes near-zero actions (rvo_inter.py:118-119)
    act = torch.where((geo.norm3(actions) < 1e-5)[..., None],
                      torch.zeros_like(actions), actions)

    pos_i = pos[..., :, None, :]                         # [..., N, 1, 3]
    rel = o_pos[..., None, :, :] - pos_i                 # [..., N, M, 3]
    dis = geo.norm3(rel)
    r_sum = radius[..., :, None] + o_radius[..., None, :]

    pos_equal = torch.all(pos_i == o_pos[..., None, :, :], dim=-1)
    valid = (~pos_equal) & (dis <= p.drone_range)

    if p.env_train:
        collision = dis <= r_sum
    else:
        collision = dis <= (radius[..., :, None] - p.exp_radius
                            + o_radius[..., None, :])

    dot = torch.sum(vel[..., :, None, :] * rel, dim=-1)
    backoff = (~collision) & (dot <= 0.0)
    normal = (~collision) & (~backoff)

    alpha = geo.cone_alpha(dis, r_sum, parity_round=p.parity_rounding)
    paa = geo.reciprocal_apex(
        pos_i,
        prio[..., :, None].expand(dis.shape),
        o_prio[..., None, :].expand(dis.shape),
        vel[..., :, None, :],
        o_vel[..., None, :, :],
    )
    act_i = act[..., :, None, :]
    outside = geo.vo_cone_outside(pos_i, act_i, paa, rel, alpha, p.delta_t,
                                  parity_round=p.parity_rounding)
    rel_v_origin = 2.0 * act_i - o_vel[..., None, :, :] - vel[..., :, None, :]
    t_raw = geo.vo_expected_time(rel, rel_v_origin, r_sum)
    vo_flag = normal & (~outside) & (t_raw < p.ctime_threshold)
    exp_time = torch.where(vo_flag, t_raw, torch.full_like(t_raw, INF))
    input_exp_time = 1.0 / (exp_time + 0.2)              # 1/inf -> 0
    min_dis_n = dis - o_radius[..., None, :]

    pos_b = pos_i.expand(rel.shape)
    zeros = torch.zeros_like(dis)[..., None]
    m_ones = -torch.ones_like(dis)[..., None]
    obs_col = torch.cat([pos_b, rel, zeros, zeros, zeros], -1)
    obs_back = torch.cat([pos_b, rel, zeros, m_ones, m_ones], -1)
    obs_norm = torch.cat([paa, rel, alpha[..., None], min_dis_n[..., None],
                          input_exp_time[..., None]], -1)
    obs9 = torch.where(collision[..., None], obs_col,
                       torch.where(backoff[..., None], obs_back, obs_norm))

    min_dis4 = torch.where(collision, r_sum, torch.where(backoff, dis, min_dis_n))

    flagged = vo_flag & valid
    sort_t = torch.where(flagged, input_exp_time, torch.full_like(dis, -INF))
    sort_d = torch.where(flagged, min_dis_n, torch.zeros_like(dis))
    return PairwiseVO(valid=valid, collision=collision, vo_flag=vo_flag,
                      exp_time=exp_time, obs9=obs9, min_dis4=min_dis4,
                      sort_t=sort_t, sort_d=sort_d)


def building_collision(pos: torch.Tensor, radius: torch.Tensor,
                       buildings: torch.Tensor, building_mask: torch.Tensor,
                       p: EnvParams) -> torch.Tensor:
    """Per-agent cylinder collision under the preprocess gates: h > z - 2
    and 2D distance <= 5 (in range), z <= h and 2D distance <= r + br (hit).
    pos [..., N, 3], radius [..., N] or [N], buildings [B, 4] (or a lane
    world's [E, B, 4], mask [E, B]) -> [..., N]."""
    b = buildings[..., None, :, :]                       # [(E,) 1, B, 4]
    bx, by, bh, br = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    dx = pos[..., :, None, 0] - bx
    dy = pos[..., :, None, 1] - by
    d2 = torch.sqrt(dx * dx + dy * dy)                   # [..., N, B]
    z = pos[..., :, None, 2]
    in_range = (bh > z - p.building_z_slack) & (d2 <= p.building_range)
    hit = (z <= bh) & (d2 <= radius[..., :, None] + br)
    return torch.any(building_mask[..., None, :] & in_range & hit, dim=-1)


class VORewardInfo(NamedTuple):
    vo_flag: torch.Tensor       # [..., N]
    min_exp_time: torch.Tensor  # [..., N]
    min_dis: torch.Tensor       # [..., N]


def vo_reward_info(states, actions, p: EnvParams, others=None) -> VORewardInfo:
    """config_vo_reward's urgency aggregates (rvo_inter.py:63-83): the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if states.is_cuda:
        return VORewardInfo(*vo_pairs.reward_info(states, actions, p, others))
    return vo_reward_info_plain(states, actions, p, others)


def vo_reward_info_plain(states, actions, p: EnvParams, others=None) -> VORewardInfo:
    """vo_reward_info in plain PyTorch."""
    pw = pairwise_vo(states, actions, p, others)
    flagged = pw.vo_flag & pw.valid
    inf = torch.full_like(pw.exp_time, INF)
    return VORewardInfo(
        torch.any(flagged, dim=-1),
        torch.amin(torch.where(flagged, pw.exp_time, inf), dim=-1),
        torch.amin(torch.where(pw.valid, pw.min_dis4, inf), dim=-1),
    )


class VOObservation(NamedTuple):
    obs_nbr: torch.Tensor       # [..., N, nm, 9]
    obs_mask: torch.Tensor      # [..., N, nm] bool
    vo_flag: torch.Tensor       # [..., N]
    min_exp_time: torch.Tensor  # [..., N]
    collision: torch.Tensor     # [..., N]


def lexsort_rows(sort_t: torch.Tensor, sort_d: torch.Tensor) -> torch.Tensor:
    """The order of jnp.lexsort((-sort_d, sort_t), axis=-1): primary key
    sort_t ascending, then sort_d descending, full ties by index. Two
    stable sorts, secondary key first. Adding 0.0 maps -0.0 to +0.0, so a
    radix sort on bit patterns (CUDA) sees the ties a comparison sort sees."""
    order = torch.sort(-sort_d + 0.0, dim=-1, stable=True).indices
    prim = torch.gather(sort_t, -1, order)
    return torch.gather(order, -1, torch.sort(prim, dim=-1, stable=True).indices)


def vo_observe(states, actions, buildings, building_mask, p: EnvParams,
               others=None) -> VOObservation:
    """config_vo_inf (rvo_inter.py:20-61): flagged neighbour blocks sorted by
    (input_exp_time asc, min_dis desc); the nm most urgent (the last nm of
    the sorted list) fill the last slots; plus collision/urgency aggregates.
    The kernel for CUDA tensors, the plain version for CPU tensors."""
    if states.is_cuda:
        return VOObservation(*vo_pairs.observe(states, actions, buildings,
                                               building_mask, p, others))
    return vo_observe_plain(states, actions, buildings, building_mask, p, others)


def vo_observe_plain(states, actions, buildings, building_mask, p: EnvParams,
                     others=None) -> VOObservation:
    """vo_observe in plain PyTorch."""
    pw = pairwise_vo(states, actions, p, others)
    m = pw.valid.shape[-1]
    flagged = pw.vo_flag & pw.valid
    inf = torch.full_like(pw.exp_time, INF)
    vo_any = torch.any(flagged, dim=-1)
    min_exp = torch.amin(torch.where(flagged, pw.exp_time, inf), dim=-1)

    pair_col = torch.any(pw.collision & pw.valid, dim=-1)
    bld_col = building_collision(states[..., 0:3], states[..., 6], buildings,
                                 building_mask, p)
    collision = pair_col | bld_col

    order = lexsort_rows(pw.sort_t, pw.sort_d)           # [..., N, M]
    nm = p.neighbor_num
    k = min(nm, m)
    tail = order[..., m - k:]                            # [..., N, k]
    obs_k = torch.gather(pw.obs9, -2, tail[..., None].expand(tail.shape + (9,)))
    mask_k = torch.gather(flagged, -1, tail)

    lead = states.shape[:-1]
    obs_nbr = torch.zeros(lead + (nm, 9), dtype=states.dtype, device=states.device)
    obs_mask = torch.zeros(lead + (nm,), dtype=torch.bool, device=states.device)
    obs_nbr[..., nm - k:, :] = torch.where(mask_k[..., None], obs_k,
                                           torch.zeros_like(obs_k))
    obs_mask[..., nm - k:] = mask_k
    return VOObservation(obs_nbr, obs_mask, vo_any, min_exp, collision)
