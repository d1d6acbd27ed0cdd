"""World and fleet state (counterpart of rvo3d_tpu/env/state.py).

The world is a NamedTuple of tensors with a leading agent axis [N]; the
fleet state carries [E, N, ...] (or [N, ...] for one env) and broadcasts
against the world, so lanes and agents are tensor axes throughout.

A lane world (worlds/multi.py) puts the state's lane axis in front of every
leaf (waypoints [E, N, W, 3], buildings [E, B, 4], map_size [E, 3], ...),
so that lane e steps its own world; the env functions take either kind.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from rvo3d_tpu_torch.env.obstacles import SphereSpec, make_sphere_spec


def _wp_select(wps: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """wps[..., idx, :] for wps [N, W, 3] (or a lane world's [E, N, W, 3])
    and idx [..., N] -> [..., N, 3].

    The JAX package writes this as a one-hot contraction to dodge a TPU
    gather bug; a gather gives the same values exactly."""
    w = wps.expand(idx.shape + wps.shape[-2:])
    g = idx.long()[..., None, None].expand(idx.shape + (1, wps.shape[-1]))
    return torch.gather(w, -2, g).squeeze(-2)


class WorldSpec(NamedTuple):
    """Static per-world data, padded to fixed shapes (the data_1.json schema)."""

    waypoints: torch.Tensor      # [N, W, 3] padded by repeating the last waypoint
    n_points: torch.Tensor       # [N] int32
    route_len: torch.Tensor      # [N]
    buildings: torch.Tensor      # [B, 4] (x, y, h, r), zero-padded
    building_mask: torch.Tensor  # [B] bool
    map_size: torch.Tensor       # [3]
    radius: torch.Tensor         # [N]
    priority: torch.Tensor       # [N]
    vel_max: torch.Tensor        # [N, 3]
    spheres: Optional[SphereSpec] = None
    # a lane world has an [E] axis in front of every leaf

    @property
    def num_drones(self) -> int:
        return self.waypoints.shape[-3]

    @property
    def lanes(self) -> Optional[int]:
        """E for a lane world, None for one world."""
        return self.waypoints.shape[0] if self.waypoints.dim() == 4 else None

    @property
    def sphere_count(self) -> int:
        return 0 if self.spheres is None else self.spheres.count

    @property
    def device(self) -> torch.device:
        return self.waypoints.device

    @property
    def dtype(self) -> torch.dtype:
        return self.waypoints.dtype

    @property
    def starts(self) -> torch.Tensor:
        return self.waypoints[..., 0, :]

    @property
    def destinations(self) -> torch.Tensor:
        return _wp_select(self.waypoints, self.n_points - 1)


class DroneState(NamedTuple):
    """Dynamic fleet state, leading axes [E, N] (or [N])."""

    pos: torch.Tensor               # [..., N, 3]
    vel: torch.Tensor               # [..., N, 3]
    yaw: torch.Tensor               # [..., N] degrees
    pitch: torch.Tensor             # [..., N] degrees
    wp_idx: torch.Tensor            # [..., N] int32
    arrive_flag: torch.Tensor       # [..., N] bool
    dest_arrive_flag: torch.Tensor  # [..., N] bool
    collision_flag: torch.Tensor    # [..., N] bool
    real_route_len: torch.Tensor    # [..., N]
    extra_len: torch.Tensor         # [..., N]
    max_deviation: torch.Tensor     # [..., N]
    prev_pos: torch.Tensor          # [..., N, 3]
    sphere_pos: torch.Tensor        # [..., S, 3]
    sphere_vel: torch.Tensor        # [..., S, 3]

    def current_des(self, world: WorldSpec) -> torch.Tensor:
        """waypoints[i]: the active target waypoint."""
        return _wp_select(world.waypoints, self.wp_idx)

    def previous_des(self, world: WorldSpec) -> torch.Tensor:
        """waypoints[i-1]: segment start for deviation tracking."""
        return _wp_select(world.waypoints, torch.clamp(self.wp_idx - 1, min=0))


class StepOutput(NamedTuple):
    obs_self: torch.Tensor     # [..., N, 12]
    obs_nbr: torch.Tensor      # [..., N, nm, 9] urgency-ascending, valid slots at the end
    obs_mask: torch.Tensor     # [..., N, nm] bool
    reward: torch.Tensor       # [..., N]
    done: torch.Tensor         # [..., N] bool: collision
    info_arrive: torch.Tensor  # [..., N] bool
    finish: torch.Tensor       # [..., N] bool: destination arrived


def init_drone_state(world: WorldSpec, lead=(), dtype=None) -> DroneState:
    """Fleet state after reset, broadcast to leading shape `lead` (e.g. (E,);
    a lane world's E)."""
    dtype = dtype or world.dtype
    dev = world.device
    n = world.num_drones
    shape = tuple(lead) + (n,)
    starts = world.starts.to(dtype).expand(shape + (3,)).clone()
    z = torch.zeros(shape, dtype=dtype, device=dev)
    if world.sphere_count:
        sp = world.spheres.init[..., 0:3].to(dtype)
        sv = world.spheres.init[..., 3:6].to(dtype)
    else:
        sp = torch.zeros((0, 3), dtype=dtype, device=dev)
        sv = torch.zeros((0, 3), dtype=dtype, device=dev)
    sshape = tuple(lead) + sp.shape[-2:]
    f = torch.zeros(shape, dtype=torch.bool, device=dev)
    return DroneState(
        pos=starts,
        vel=torch.zeros(shape + (3,), dtype=dtype, device=dev),
        yaw=z, pitch=z.clone(),
        wp_idx=torch.ones(shape, dtype=torch.int32, device=dev),
        arrive_flag=f, dest_arrive_flag=f.clone(), collision_flag=f.clone(),
        real_route_len=z.clone(), extra_len=z.clone(), max_deviation=z.clone(),
        prev_pos=starts.clone(),
        sphere_pos=sp.expand(sshape).clone(),
        sphere_vel=sv.expand(sshape).clone(),
    )


def make_world_spec(waypoints_list, building_list, map_size, *,
                    radius: float = 0.2, priority: float = 5.0,
                    vel_max: float = 1.0, pad_waypoints: int | None = None,
                    pad_buildings: int | None = None, spheres=None,
                    dtype=torch.float32, device="cuda") -> WorldSpec:
    """Build a padded WorldSpec from the data_1.json schema lists."""
    from rvo3d_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    npdt = torch.empty((), dtype=dtype).numpy().dtype
    n = len(waypoints_list)
    n_points = np.array([len(w) for w in waypoints_list], np.int32)
    w_max = int(pad_waypoints or max(2, n_points.max()))
    wps = np.zeros((n, w_max, 3), npdt)
    for i, w in enumerate(waypoints_list):
        w = np.asarray(w, npdt)
        wps[i, :len(w)] = w
        wps[i, len(w):] = w[-1]
    # route length on the host in float64, then cast (as the reference does)
    route_len = np.zeros((n,), np.float64)
    for i, w in enumerate(waypoints_list):
        w = np.asarray(w, np.float64)
        route_len[i] = np.sqrt(((w[1:] - w[:-1]) ** 2).sum(-1)).sum()
    b = len(building_list)
    b_max = int(pad_buildings if pad_buildings is not None else max(1, b))
    buildings = np.zeros((b_max, 4), npdt)
    bmask = np.zeros((b_max,), bool)
    for i, bd in enumerate(building_list):
        buildings[i] = np.asarray(bd, npdt)
        bmask[i] = True
    if spheres is not None and not isinstance(spheres, SphereSpec):
        spheres = make_sphere_spec(spheres, priority=priority, dtype=npdt,
                                   device=device)

    def t(a):
        return torch.as_tensor(a, device=device)

    return WorldSpec(
        waypoints=t(wps), n_points=t(n_points),
        route_len=t(route_len.astype(npdt)),
        buildings=t(buildings), building_mask=t(bmask),
        map_size=t(np.asarray(map_size, npdt)),
        radius=torch.full((n,), radius, dtype=dtype, device=device),
        priority=torch.full((n,), priority, dtype=dtype, device=device),
        vel_max=torch.full((n, 3), vel_max, dtype=dtype, device=device),
        spheres=spheres,
    )
