"""Multi-scenario batching: different worlds in different env lanes
(counterpart of rvo3d_tpu/worlds/multi.py).

Stack K WorldSpecs along a leading axis (padded to common waypoint and
building counts), gather one spec per lane, and hand the resulting lane
world to the env functions: every leaf then leads with the lane axis E of
the fleet state, and lane e steps scenario world_idx[e]. The JAX package
gets the same by vmapping the step over (world, state, action); here the
lane axis broadcasts through the env's tensor program.

All stacked worlds must share the drone count N (the agent axis is a
static shape); waypoint and building axes pad automatically.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env.env import observe, reset, reset_where, step
from rvo3d_tpu_torch.env.obstacles import SphereSpec
from rvo3d_tpu_torch.env.state import DroneState, StepOutput, WorldSpec


def stack_worlds(specs: Sequence[WorldSpec]) -> WorldSpec:
    """Stack K WorldSpecs into one with a leading scenario axis K."""
    n = {int(s.num_drones) for s in specs}
    if len(n) != 1:
        raise ValueError(f"all worlds must share drone count, got {sorted(n)}")
    if any(s.spheres is not None for s in specs):
        if not all(s.spheres is not None
                   and s.spheres.count == specs[0].spheres.count
                   for s in specs):
            raise ValueError("sphere counts must match across stacked worlds")

    w_max = max(s.waypoints.shape[1] for s in specs)
    b_max = max(s.buildings.shape[0] for s in specs)

    def pad_wps(s: WorldSpec) -> torch.Tensor:
        w = s.waypoints
        if w.shape[1] < w_max:     # repeat the last waypoint
            w = torch.cat([w, w[:, -1:, :].expand(-1, w_max - w.shape[1], -1)], 1)
        return w

    def pad_b(s: WorldSpec) -> Tuple[torch.Tensor, torch.Tensor]:
        b, m = s.buildings, s.building_mask
        k = b_max - b.shape[0]
        if k:
            b = torch.cat([b, b.new_zeros((k, 4))], 0)
            m = torch.cat([m, m.new_zeros((k,))], 0)
        return b, m

    bs, ms = zip(*(pad_b(s) for s in specs))
    spheres = None
    if specs[0].spheres is not None:
        spheres = SphereSpec(*[torch.stack(xs) for xs in zip(*(s.spheres for s in specs))])
    return WorldSpec(
        waypoints=torch.stack([pad_wps(s) for s in specs]),
        n_points=torch.stack([s.n_points for s in specs]),
        route_len=torch.stack([s.route_len for s in specs]),
        buildings=torch.stack(bs),
        building_mask=torch.stack(ms),
        map_size=torch.stack([s.map_size for s in specs]),
        radius=torch.stack([s.radius for s in specs]),
        priority=torch.stack([s.priority for s in specs]),
        vel_max=torch.stack([s.vel_max for s in specs]),
        spheres=spheres,
    )


def reverse_routes(spec: WorldSpec) -> WorldSpec:
    """Scenario variant with every route flown end-to-start (same map, same
    buildings, same polyline length). Reverses only each drone's n_points
    valid waypoints and pads again by repeating the new last one (the
    padding invariant of make_world_spec): slot j < k takes waypoint
    k - 1 - j, every later slot the first waypoint."""
    wps = spec.waypoints
    k = spec.n_points.long()[:, None]                               # [N, 1]
    j = torch.arange(wps.shape[1], device=wps.device)[None, :]      # [1, W]
    src = torch.where(j < k, k - 1 - j, torch.zeros_like(j))        # [N, W]
    rev = torch.gather(wps, 1, src[..., None].expand(wps.shape))
    return spec._replace(waypoints=rev)


def worlds_for_lanes(stacked: WorldSpec, world_idx) -> WorldSpec:
    """A lane world (leaves [E, ...]) from a stacked spec: lane e gets
    scenario world_idx[e]. Built once at setup."""
    idx = torch.as_tensor(world_idx, dtype=torch.long, device=stacked.device)

    def take(x):
        if x is None:
            return None
        if isinstance(x, SphereSpec):
            return SphereSpec(*[take(v) for v in x])
        return x[idx]
    return WorldSpec(*[take(x) for x in stacked])


class MultiWorldEnv:
    """Batched env where lane e runs its own world (leaves [E, ...])."""

    def __init__(self, specs: Sequence[WorldSpec], world_idx, params: EnvParams,
                 dtype: Optional[torch.dtype] = None):
        self.params = params
        self.lane_worlds = worlds_for_lanes(stack_worlds(specs), world_idx)
        self.num_envs = self.lane_worlds.lanes
        self.dtype = dtype or self.lane_worlds.dtype

    def reset_batch(self) -> Tuple[DroneState, StepOutput]:
        state = reset(self.lane_worlds, self.params, (self.num_envs,), self.dtype)
        out, state = observe(self.lane_worlds, state, self.params)
        return state, out

    def step_batch(self, state: DroneState, actions: torch.Tensor,
                   noise: Optional[torch.Tensor] = None):
        return step(self.lane_worlds, state, actions, self.params, noise)

    def observe_batch(self, state: DroneState):
        return observe(self.lane_worlds, state, self.params)

    def reset_where_batch(self, state: DroneState, mask: torch.Tensor) -> DroneState:
        return reset_where(self.lane_worlds, state, mask)
