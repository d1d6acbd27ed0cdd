"""The env step's per-drone arithmetic as hand-written CUDA passes
(csrc/env_drones.cu): the ctypes binding and the passes env/env.py runs for
CUDA tensors around the VO kernel's launches (ops/vo_pairs.py).

  pre(world, state, p) -> states12 [..., N, 12]
  mid(world, state, states12, actions, vo_flag, min_exp, p, noise) -> Mid
  post(world, state, collision, mid, obs_nbr, obs_mask, p) -> (reward, done)
  obs(world, state, p) -> (states12, obs_self, max_deviation, zero action)
  post_obs(world, state, obs_nbr, obs_mask, p) -> (reward, done)
  reset(world, state, mask) -> the drone fields of DroneState

One thread owns one (lane, drone) row. `step` is pre, VO reward, mid, VO
observe, post; `observe` is obs, VO observe, post in its observe mode
(counted as `post`); `reset_where` is one reset. post rounds the VO's
obs_nbr in place. The plain PyTorch version is env/env.py's step_plain,
observe_plain and reset_where_plain: the CPU takes it, and the card tests
hold the passes to it. The passes replace no TPU kernel (see the note in
their source).

States are float32 or float64, and so is every float leaf of the world;
actions are of the states' type, or float32 beside float64 states.
A lane world (its leaves led by [E], E the last leading axis of the
states) is read through each leaf's lane stride, with no copy.

While the recorder is on (utils/profiler.py), each launch adds 1 to
`env_drones.<pass>.launches` and its rows to `env_drones.<pass>.rows`, for
the passes pre, mid, post, obs and reset; a CUDA graph's replays add the
counts its capture took (utils/profiler.capturing). Off, nothing is counted.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.ops import _build
from rvo3d_tpu_torch.utils import profiler

# Launches of the CUDA passes since the last reset (counted through graph
# replays by utils/graphs.py, as vo_pairs' are).
launches = 0

THREADS = 256    # one row a thread
_MODES = {"pre": 0, "mid": 1, "post": 2, "obs": 3, "post_obs": 4, "reset": 5}

# (states dtype, actions dtype) -> the launcher's dtype code
_DTYPES = {(torch.float32, torch.float32): 0,
           (torch.float64, torch.float64): 1,
           (torch.float64, torch.float32): 2}

_IN = ("pos", "vel", "yaw", "pitch", "wp", "arrive", "dest", "coll", "rrl", "extra",
       "maxdev", "prev")
# DroneState's drone fields, in the order of _IN
FIELDS = ("pos", "vel", "yaw", "pitch", "wp_idx", "arrive_flag", "dest_arrive_flag",
          "collision_flag", "real_route_len", "extra_len", "max_deviation", "prev_pos")


class _Params(ctypes.Structure):
    """struct DroneParams in csrc/env_drones.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        _IN + tuple(f"{n}_o" for n in _IN)
        + ("wps", "n_points", "route_len", "map_size", "radius", "priority", "vel_max",
           "actions", "noise", "s12_in", "vo_flag", "min_exp", "vo_coll", "mask",
           "s12", "obs_self", "act0", "reward", "done", "scratch", "obs_nbr", "obs_mask"))]
    _fields_ += [(n, ctypes.c_int64) for n in (
        "wps_lane", "np_lane", "rl_lane", "ms_lane", "rad_lane", "pri_lane", "vm_lane",
        "mask_lane", "mask_row", "rows")]
    _fields_ += [(n, ctypes.c_double) for n in (
        "goal_threshold", "dt", "max_acc", "max_angle_change", "control_std",
        "rvo_p_base", "rvo_p_urgent", "mov_p_way", "mov_p_dest", "mov_p_exlen",
        "mov_collision", "mov_p_progress")]
    _fields_ += [(n, ctypes.c_int) for n in (
        "N", "W", "nm", "w_lanes", "parity", "safe_rewards", "noise_on", "noise_f64",
        "progress_on")]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the launcher's ctypes signature once, when the library loads."""
    lib.env_drones_launch.argtypes = [ctypes.POINTER(_Params), ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.env_drones_launch.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    return _build.load("env_drones", on_load=bind)


class Mid(NamedTuple):
    """What the mid pass writes: the post-step drone fields (DroneState's
    names, prev_pos the pre-step pos), the post-step states, their rounding
    (obs_self; the states themselves without parity rounding), the rvo
    reward and mov_reward's terms for post."""
    fields: dict
    states12: torch.Tensor
    obs_self: torch.Tensor
    reward: torch.Tensor
    scratch: torch.Tensor


def _check_state(state) -> torch.dtype:
    """The states' float type; raises on what the passes do not take (CUDA
    tensors are required at the launch, after every other check)."""
    pos = state.pos
    if pos.dim() < 2 or pos.shape[-1] != 3:
        raise ValueError(f"pos must be [..., N, 3], got {tuple(pos.shape)}")
    dtype = pos.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the env passes take float32 or float64 states, got {dtype}")
    lead = pos.shape[:-1]
    kinds = {"wp_idx": torch.int32, "arrive_flag": torch.bool,
             "dest_arrive_flag": torch.bool, "collision_flag": torch.bool}
    for name in FIELDS:
        t = getattr(state, name)
        want = kinds.get(name, dtype)
        shape = lead + (3,) if name in ("pos", "vel", "prev_pos") else lead
        if t.dtype != want or tuple(t.shape) != tuple(shape):
            raise TypeError(f"{name} must be {want} {tuple(shape)}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != pos.device:
            raise ValueError(f"{name} is on {t.device}, pos on {pos.device}")
    return dtype


def _leaf(t: torch.Tensor, dim: int, lead, dtype, name: str):
    """(tensor, lane stride in elements, lanes) of a world leaf: one [X...]
    of `dim` axes all lanes share, or a lane world's [E, X...] with E the
    last leading axis of the states."""
    if t.dtype != dtype:
        raise TypeError(f"world.{name} is {t.dtype}, the passes want {dtype}")
    if t.dim() == dim:
        return t.contiguous(), 0, 1
    if t.dim() == dim + 1 and len(lead) and t.shape[0] == lead[-1]:
        if not t[0].is_contiguous():
            t = t.contiguous()
        return t, t.stride(0), t.shape[0]
    raise ValueError(f"world.{name} {tuple(t.shape)} fits neither one world nor "
                     f"lanes {tuple(lead)}")


# the world's leaves: (struct field, WorldSpec field, axes of one world's
# leaf, the struct field of its lane stride)
_LEAVES = (("wps", "waypoints", 3, "wps_lane"), ("n_points", "n_points", 1, "np_lane"),
           ("route_len", "route_len", 1, "rl_lane"), ("map_size", "map_size", 1, "ms_lane"),
           ("radius", "radius", 1, "rad_lane"), ("priority", "priority", 1, "pri_lane"),
           ("vel_max", "vel_max", 2, "vm_lane"))


def _params(world, state, p: Optional[EnvParams]):
    """(the launch's state, world and EnvParams fields, the states' type);
    raises on what the passes do not take."""
    dtype = _check_state(state)
    q = _Params()
    lead, n = state.pos.shape[:-2], state.pos.shape[-2]
    if world.num_drones != n:
        raise ValueError(f"the world has {world.num_drones} drones, the state {n}")
    keep = []
    for c, name in zip(_IN, FIELDS):
        t = getattr(state, name).contiguous()
        keep.append(t)
        setattr(q, c, t.data_ptr())
    q.rows, q.N, q.W = math.prod(lead) * n, n, world.waypoints.shape[-2]
    lanes = {1}
    for c, name, dim, lane_field in _LEAVES:
        want = torch.int32 if name == "n_points" else dtype
        t, stride, e = _leaf(getattr(world, name), dim, lead, want, name)
        if t.device != state.pos.device:
            raise ValueError(f"world.{name} is on {t.device}, the state on {state.pos.device}")
        keep.append(t)
        setattr(q, c, t.data_ptr())
        setattr(q, lane_field, stride)
        lanes.add(e)
    q.w_lanes = max(lanes)
    if p is not None:
        for f in ("goal_threshold", "dt", "max_acc", "max_angle_change", "control_std",
                  "rvo_p_base", "rvo_p_urgent", "mov_p_way", "mov_p_dest", "mov_p_exlen",
                  "mov_collision", "mov_p_progress"):
            setattr(q, f, float(getattr(p, f)))
        q.nm = p.neighbor_num
        q.parity, q.safe_rewards = int(bool(p.parity_rounding)), int(bool(p.safe_rewards))
        q.progress_on = int(bool(p.mov_p_progress))
    q._keep = keep           # the launch's inputs outlive it
    return q, dtype


def _note(mode: str, rows: int) -> None:
    """One launch added to the recorder's counters."""
    if profiler.counting():
        profiler.count(f"env_drones.{mode}.launches", 1)
        profiler.count(f"env_drones.{mode}.rows", rows)


def _launch(q: _Params, mode: str, dtype, act_dtype, device, counted: str) -> None:
    global launches
    if device.type != "cuda":
        raise ValueError(f"the env passes take CUDA tensors, got {device}")
    if not q.rows:
        return
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.env_drones_launch(ctypes.byref(q), _MODES[mode],
                                    _DTYPES[(dtype, act_dtype)],
                                    -(-q.rows // THREADS), stream)
    if err != 0:
        raise RuntimeError(f"env_drones_launch ({mode}) failed: cudaError {err}")
    launches += 1
    _note(counted, q.rows)


def _empty(like: torch.Tensor, shape, dtype=None) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype or like.dtype, device=like.device)


def _same(t: torch.Tensor, shape, dtype, device, name: str) -> torch.Tensor:
    """t, contiguous, after checking its shape, type and device."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the state on {device}")
    return t.contiguous()


def pre(world, state, p: EnvParams) -> torch.Tensor:
    """env.drone_states_12's states [..., N, 12] of `state` (its
    max_deviation update is mid's)."""
    q, dtype = _params(world, state, p)
    s12 = _empty(state.pos, state.pos.shape[:-1] + (12,))
    q.s12 = s12.data_ptr()
    _launch(q, "pre", dtype, dtype, state.pos.device, "pre")
    return s12


def mid(world, state, states12, actions, vo_flag, min_exp, p: EnvParams,
        noise: Optional[torch.Tensor] = None) -> Mid:
    """The step from rvo_reward to the post-step states (csrc's `mid`):
    states12 of `state` (pre), the absolute actions [..., N, 3], the VO
    reward pass's (vo_flag, min_exp_time), and with p.noise the pre-drawn
    standard-normal samples."""
    q, dtype = _params(world, state, p)
    lead = state.pos.shape[:-1]
    pos = state.pos
    if (dtype, actions.dtype) not in _DTYPES:
        raise TypeError(f"the env passes take actions of the states' type or float32; "
                        f"got {actions.dtype} beside {dtype} states")
    actions = _same(actions, lead + (3,), actions.dtype, pos.device, "actions")
    states12 = _same(states12, lead + (12,), dtype, pos.device, "states12")
    vo_flag = _same(vo_flag, lead, torch.bool, pos.device, "vo_flag")
    min_exp = _same(min_exp, lead, dtype, pos.device, "min_exp")
    q.actions, q.s12_in = actions.data_ptr(), states12.data_ptr()
    q.vo_flag, q.min_exp = vo_flag.data_ptr(), min_exp.data_ptr()
    keep = [actions, states12, vo_flag, min_exp]
    if p.noise:
        if noise is None:
            raise ValueError("EnvParams.noise is set: pass pre-drawn `noise` samples")
        if noise.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"noise must be float32 or float64, got {noise.dtype}")
        noise = _same(noise, lead + (3,), noise.dtype, pos.device, "noise")
        q.noise, q.noise_on = noise.data_ptr(), 1
        q.noise_f64 = int(noise.dtype == torch.float64)
        keep.append(noise)
    fields = {name: _empty(getattr(state, name), getattr(state, name).shape)
              for name in FIELDS if name not in ("collision_flag", "prev_pos")}
    fields["collision_flag"], fields["prev_pos"] = state.collision_flag, pos
    for c, name in zip(_IN, FIELDS):
        if name not in ("collision_flag", "prev_pos"):
            setattr(q, f"{c}_o", fields[name].data_ptr())
    s12 = _empty(pos, lead + (12,))
    obs_self = _empty(pos, lead + (12,)) if p.parity_rounding else s12
    reward = _empty(pos, lead)
    scratch = _empty(pos, (2,) + tuple(lead))
    q.s12, q.obs_self = s12.data_ptr(), obs_self.data_ptr()
    q.reward, q.scratch = reward.data_ptr(), scratch.data_ptr()
    q._keep_in = keep
    _launch(q, "mid", dtype, actions.dtype, pos.device, "mid")
    return Mid(fields, s12, obs_self, reward, scratch)


def _obs_out(q: _Params, state, obs_nbr, obs_mask, p: EnvParams) -> None:
    """The VO observe pass's outputs, which post rounds in place."""
    lead, dev = state.pos.shape[:-1], state.pos.device
    nm = p.neighbor_num
    if not obs_nbr.is_contiguous():
        raise ValueError("obs_nbr is rounded in place: pass it contiguous")
    q.obs_nbr = _same(obs_nbr, lead + (nm, 9), state.pos.dtype, dev, "obs_nbr").data_ptr()
    obs_mask = _same(obs_mask, lead + (nm,), torch.bool, dev, "obs_mask")
    q.obs_mask = obs_mask.data_ptr()
    q._keep_mask = obs_mask


def post(world, state, collision, m: Mid, obs_nbr, obs_mask, p: EnvParams):
    """(reward, done) of the step from the post-step `state`, the VO observe
    pass's collision and mid's reward terms; rounds obs_nbr in place."""
    q, dtype = _params(world, state, p)
    lead = state.pos.shape[:-1]
    collision = _same(collision, lead, torch.bool, state.pos.device, "collision")
    _obs_out(q, state, obs_nbr, obs_mask, p)
    done = _empty(state.pos, lead, torch.bool)
    q.vo_coll, q.scratch, q.reward = (collision.data_ptr(), m.scratch.data_ptr(),
                                      m.reward.data_ptr())
    q.done = done.data_ptr()
    q._keep_in = collision
    _launch(q, "post", dtype, dtype, state.pos.device, "post")
    return m.reward, done


def obs(world, state, p: EnvParams):
    """(states12, obs_self, max_deviation, zero action) of observe: the
    states of `state`, their rounding (the states themselves without parity
    rounding), the updated running max deviation and the zero action the VO
    observe pass takes."""
    q, dtype = _params(world, state, p)
    lead = state.pos.shape[:-1]
    s12 = _empty(state.pos, lead + (12,))
    obs_self = _empty(state.pos, lead + (12,)) if p.parity_rounding else s12
    maxdev = _empty(state.pos, lead)
    act0 = _empty(state.pos, lead + (3,))
    q.s12, q.obs_self = s12.data_ptr(), obs_self.data_ptr()
    q.maxdev_o, q.act0 = maxdev.data_ptr(), act0.data_ptr()
    _launch(q, "obs", dtype, dtype, state.pos.device, "obs")
    return s12, obs_self, maxdev, act0


def post_obs(world, state, obs_nbr, obs_mask, p: EnvParams):
    """observe's zero (reward, done); rounds obs_nbr in place."""
    q, dtype = _params(world, state, p)
    lead = state.pos.shape[:-1]
    _obs_out(q, state, obs_nbr, obs_mask, p)
    reward = _empty(state.pos, lead)
    done = _empty(state.pos, lead, torch.bool)
    q.reward, q.done = reward.data_ptr(), done.data_ptr()
    _launch(q, "post_obs", dtype, dtype, state.pos.device, "post")
    return reward, done


def reset(world, state, mask: torch.Tensor) -> dict:
    """The drone fields of env.reset_where_plain (DroneState's names): reset
    to the world's starts where mask [..., N], the others copied."""
    q, dtype = _params(world, state, None)
    lead = state.pos.shape[:-1]
    if mask.dtype != torch.bool or tuple(mask.shape) != tuple(lead):
        raise ValueError(f"mask must be bool {tuple(lead)}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if mask.device != state.pos.device:
        raise ValueError(f"mask is on {mask.device}, the state on {state.pos.device}")
    if mask.dim() > 2:
        mask = mask.contiguous()
    q.mask = mask.data_ptr()
    q.mask_row = mask.stride(-1)
    q.mask_lane = mask.stride(-2) if mask.dim() >= 2 else 0
    q._keep_in = (mask,)
    fields = {name: _empty(getattr(state, name), getattr(state, name).shape)
              for name in FIELDS}
    for c, name in zip(_IN, FIELDS):
        setattr(q, f"{c}_o", fields[name].data_ptr())
    _launch(q, "reset", dtype, dtype, state.pos.device, "reset")
    return fields
