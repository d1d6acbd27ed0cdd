"""The env step's all-pairs VO as one hand-written CUDA kernel
(csrc/vo_pairs.cu): its launch geometry, the ctypes binding, and the two
entry points env/rvo.py takes for CUDA tensors.

  reward_info(states, actions, p, others)
      -> (vo_flag [..., N] bool, min_exp_time [..., N], min_dis [..., N])
  observe(states, actions, buildings, building_mask, p, others)
      -> (obs_nbr [..., N, nm, 9], obs_mask [..., N, nm] bool,
          vo_flag [..., N] bool, min_exp_time [..., N], collision [..., N] bool)

The plain PyTorch version is env/rvo.py's vo_reward_info_plain and
vo_observe_plain: the CPU takes it, and the card tests hold the kernel to
it. The kernel replaces no TPU kernel (see the note in its source).

states [..., N, 12] and others [..., M, 8] are float32 or float64;
actions [..., N, 3] are of the states' type, or float32 beside float64
states (the action's own arithmetic then stays in float32, as PyTorch's
type promotion keeps it). Buildings are [B, 4] with a mask [B], or a lane
world's [E, B, 4] with [E, B], where E is the last leading axis.

While the recorder is on (utils/profiler.py), each launch adds its shape
to the counters `vo_pairs.<mode>.<key>`, mode `reward` or `observe`, keys
`launches`, `rows`, `pairs` (rows x M), `slots` (rows x nm written,
observe), `others` (values of `others` read) and `buildings` (building
rows read, observe); a CUDA graph's replays add the shapes its capture
took (utils/profiler.tally). Off, nothing is counted.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import torch

from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.ops import _build
from rvo3d_tpu_torch.utils import profiler

launches = 0             # of the CUDA kernel since the last reset

THREADS = 256            # per block; each group of G threads owns one row
MAX_SMEM = 48 * 1024     # the keys of a block's rows, without an opt-in


@dataclass(frozen=True)
class LaunchGeometry:
    group: int       # G: threads a row, the next power of 2 of M, at most 32
    blocks: int
    smem_bytes: int

    @property
    def rows_per_block(self) -> int:
        return THREADS // self.group


def launch_geometry(rows: int, m: int, itemsize: int) -> LaunchGeometry:
    """The launch for `rows` rows of M = m candidates in a type of
    `itemsize` bytes; raises ValueError for what the kernel does not take."""
    if rows < 1 or m < 1 or itemsize not in (4, 8):
        raise ValueError(f"bad shape: rows={rows}, M={m}, itemsize={itemsize}")
    group = min(32, 1 << (m - 1).bit_length())
    per_block = THREADS // group
    smem = per_block * m * (2 * itemsize + 1)
    if smem > MAX_SMEM:
        raise ValueError(f"M={m} candidates need {smem} bytes of shared memory "
                         f"a block, more than {MAX_SMEM}")
    return LaunchGeometry(group, -(-rows // per_block), smem)


class _Params(ctypes.Structure):
    """struct VoParams in csrc/vo_pairs.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "states", "actions", "others", "buildings", "bmask", "obs_nbr",
        "obs_mask", "any_flag", "min_exp", "min_dis", "collision")]
    _fields_ += [(n, ctypes.c_int64) for n in ("o_lane", "o_row", "b_lane",
                                               "m_lane", "rows")]
    _fields_ += [(n, ctypes.c_double) for n in (
        "drone_range", "exp_radius", "delta_t", "ctime_threshold",
        "building_range", "building_z_slack")]
    _fields_ += [(n, ctypes.c_int) for n in ("N", "M", "nm", "B", "b_lanes",
                                             "m_lanes", "group", "env_train",
                                             "parity")]


_kernel = _build.launcher("vo_pairs", "vo_pairs_launch",
                          [ctypes.POINTER(_Params)] + [ctypes.c_int] * 4)


def _inputs(states, actions, p: EnvParams, others) -> _Params:
    """The row and candidate part of the launch's parameters; raises on
    what the kernel does not take."""
    if not states.is_cuda:
        raise ValueError("the VO pair kernel takes CUDA tensors")
    if states.dim() < 2 or states.shape[-1] != 12:
        raise ValueError(f"states must be [..., N, 12], got {tuple(states.shape)}")
    lead, n = states.shape[:-2], states.shape[-2]
    if tuple(actions.shape) != tuple(states.shape[:-1]) + (3,):
        raise ValueError(f"actions must be {tuple(states.shape[:-1]) + (3,)}, "
                         f"got {tuple(actions.shape)}")
    if (states.dtype, actions.dtype) not in _build.DTYPES:
        raise TypeError(f"the VO pair kernel takes float32 or float64 states with "
                        f"actions of their type or float32; got {states.dtype}, "
                        f"{actions.dtype}")
    q = _Params()
    states, actions = states.contiguous(), actions.contiguous()
    q.states, q.actions = states.data_ptr(), actions.data_ptr()
    if others is None:
        q.others, q.o_row, m = states.data_ptr(), 12, n
    else:
        if others.dim() != states.dim() or tuple(others.shape[:-2]) != tuple(lead) \
                or others.shape[-1] != 8:
            raise ValueError(f"others must be {tuple(lead)} + (M, 8), got "
                             f"{tuple(others.shape)}")
        if others.dtype != states.dtype:
            raise TypeError(f"others are {others.dtype}, states {states.dtype}")
        others = others.contiguous()
        q.others, q.o_row, m = others.data_ptr(), 8, others.shape[-2]
    for name, t in (("actions", actions), ("others", others)):
        if t is not None and t.device != states.device:
            raise ValueError(f"{name} are on {t.device}, states on {states.device}")
    q.o_lane = m * q.o_row
    q.rows, q.N, q.M, q.nm = math.prod(lead) * n, n, m, p.neighbor_num
    q.drone_range, q.exp_radius = p.drone_range, p.exp_radius
    q.delta_t, q.ctime_threshold = p.delta_t, p.ctime_threshold
    q.building_range, q.building_z_slack = p.building_range, p.building_z_slack
    q.env_train, q.parity = int(bool(p.env_train)), int(bool(p.parity_rounding))
    q.B, q.b_lanes, q.m_lanes = 0, 1, 1
    q._keep = (states, actions, others)   # the launch's inputs outlive it
    return q


def _lanes_of(t, dim: int, lead, name: str) -> int:
    """1 for a shared [B, ...] leaf, E for a lane world's [E, B, ...]
    (E the last leading axis of the states)."""
    if t.dim() == dim:
        return 1
    if t.dim() == dim + 1 and len(lead) and t.shape[0] == lead[-1]:
        return t.shape[0]
    raise ValueError(f"{name} {tuple(t.shape)} fit neither one world nor "
                     f"lanes {tuple(lead)}")


def _note(q: _Params, observe: bool) -> None:
    """One launch's shape added to the recorder's counters."""
    if not profiler.counting():
        return
    # o_row 12: no `others`, the rows' own states are the candidates
    others = 0 if q.o_row == 12 else q.o_lane * (q.rows // q.N)
    mode = "observe" if observe else "reward"
    shape = {"launches": 1, "rows": q.rows, "pairs": q.rows * q.M,
             "slots": q.rows * q.nm if observe else 0, "others": others,
             "buildings": q.b_lanes * q.B if observe else 0}
    for key, n in shape.items():
        profiler.count(f"vo_pairs.{mode}.{key}", n)


def _launch(q: _Params, observe: bool, dtype: torch.dtype, act_dtype: torch.dtype,
            device) -> None:
    geo = launch_geometry(q.rows, q.M, dtype.itemsize)
    q.group = geo.group
    _kernel(device, ctypes.byref(q), int(observe), _build.DTYPES[(dtype, act_dtype)],
            geo.blocks, geo.smem_bytes)
    _note(q, observe)


def reward_info(states, actions, p: EnvParams, others: Optional[torch.Tensor] = None):
    """(vo_flag, min_exp_time, min_dis) [..., N] of config_vo_reward, by the
    kernel (env/rvo.py vo_reward_info_plain's semantics)."""
    q = _inputs(states, actions, p, others)
    lead = states.shape[:-1]
    dev = states.device
    any_flag = torch.empty(lead, dtype=torch.bool, device=dev)
    min_exp = torch.empty(lead, dtype=states.dtype, device=dev)
    min_dis = torch.empty(lead, dtype=states.dtype, device=dev)
    if q.rows:
        q.any_flag, q.min_exp, q.min_dis = (any_flag.data_ptr(), min_exp.data_ptr(),
                                            min_dis.data_ptr())
        _launch(q, False, states.dtype, actions.dtype, dev)
    return any_flag, min_exp, min_dis


def observe(states, actions, buildings, building_mask, p: EnvParams,
            others: Optional[torch.Tensor] = None):
    """(obs_nbr, obs_mask, vo_flag, min_exp_time, collision) of
    config_vo_inf plus the building collision, by the kernel (env/rvo.py
    vo_observe_plain's semantics)."""
    q = _inputs(states, actions, p, others)
    lead = states.shape[:-1]
    dev = states.device
    if buildings.dtype != states.dtype:
        if (buildings.dtype, states.dtype) != (torch.float32, torch.float64):
            raise TypeError(f"buildings are {buildings.dtype}, states {states.dtype}")
        buildings = buildings.to(states.dtype)      # exact, as type promotion
    if buildings.shape[-1] != 4 or building_mask.dtype != torch.bool \
            or building_mask.shape[-1] != buildings.shape[-2]:
        raise ValueError(f"buildings must be [..., B, 4] with a bool mask [..., B]; "
                         f"got {tuple(buildings.shape)}, {building_mask.dtype}"
                         f"{tuple(building_mask.shape)}")
    for name, t in (("buildings", buildings), ("building_mask", building_mask)):
        if t.device != dev:
            raise ValueError(f"{name} are on {t.device}, states on {dev}")
    bld, bmask = buildings.contiguous(), building_mask.contiguous()
    q.B = bld.shape[-2]
    q.b_lanes = _lanes_of(bld, 2, lead[:-1], "buildings")
    q.m_lanes = _lanes_of(bmask, 1, lead[:-1], "building_mask")
    q.b_lane, q.m_lane = q.B * 4, q.B
    q.buildings, q.bmask = bld.data_ptr(), bmask.data_ptr()
    q._keep_b = (bld, bmask)
    nm = p.neighbor_num
    obs_nbr = torch.empty(lead + (nm, 9), dtype=states.dtype, device=dev)
    obs_mask = torch.empty(lead + (nm,), dtype=torch.bool, device=dev)
    any_flag = torch.empty(lead, dtype=torch.bool, device=dev)
    min_exp = torch.empty(lead, dtype=states.dtype, device=dev)
    collision = torch.empty(lead, dtype=torch.bool, device=dev)
    if q.rows:
        q.obs_nbr, q.obs_mask = obs_nbr.data_ptr(), obs_mask.data_ptr()
        q.any_flag, q.min_exp = any_flag.data_ptr(), min_exp.data_ptr()
        q.collision = collision.data_ptr()
        _launch(q, True, states.dtype, actions.dtype, dev)
    return obs_nbr, obs_mask, any_flag, min_exp, collision
