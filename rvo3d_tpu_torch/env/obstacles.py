"""Dynamic sphere obstacles (counterpart of rvo3d_tpu/env/obstacles.py).

Spheres are extra VO participants: they join the all-pairs cone math,
neighbour top-nm, reward shaping and collision checks like drones but take
no actions. Motion models: STATIC (0) holds position, LINEAR (1) moves at
constant velocity and reflects off the map bounds, GOAL (2) flies at its
initial speed toward a goal and stops inside the goal threshold.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

STATIC, LINEAR, GOAL = 0, 1, 2


class SphereSpec(NamedTuple):
    """Static sphere definitions, [S, ...]."""

    init: torch.Tensor    # [S, 8] pos(3), vel(3), radius, priority
    goal: torch.Tensor    # [S, 3]
    model: torch.Tensor   # [S] int32 motion model code
    mask: torch.Tensor    # [S] bool

    @property
    def count(self) -> int:
        return self.init.shape[-2]


def make_sphere_spec(spheres: Optional[Sequence[dict]] = None,
                     priority: float = 5.0, dtype=np.float32,
                     device="cuda") -> SphereSpec:
    """spheres: list of dicts with keys pos, radius and optional vel, goal,
    model ('static'|'linear'|'goal')."""
    from rvo3d_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    spheres = spheres or []
    s = len(spheres)
    init = np.zeros((s, 8), dtype)
    goal = np.zeros((s, 3), dtype)
    model = np.zeros((s,), np.int32)
    codes = {"static": STATIC, "linear": LINEAR, "goal": GOAL}
    for i, sp in enumerate(spheres):
        init[i, 0:3] = np.asarray(sp["pos"], dtype)
        init[i, 3:6] = np.asarray(sp.get("vel", (0, 0, 0)), dtype)
        init[i, 6] = sp["radius"]
        init[i, 7] = sp.get("priority", priority)
        goal[i] = np.asarray(sp.get("goal", sp["pos"]), dtype)
        model[i] = codes[sp.get("model", "static")]
    return SphereSpec(
        init=torch.as_tensor(init, device=device),
        goal=torch.as_tensor(goal, device=device),
        model=torch.as_tensor(model, device=device),
        mask=torch.ones((s,), dtype=torch.bool, device=device),
    )


def step_spheres(pos: torch.Tensor, vel: torch.Tensor, spec: SphereSpec,
                 map_size: torch.Tensor, dt: float,
                 goal_threshold: float = 0.1):
    """Advance sphere states one step. pos/vel: [..., S, 3]; spec and
    map_size ([3]) may carry a lane world's [E] axis in front."""
    if spec.count == 0:
        return pos, vel
    radius = spec.init[..., 6:7]
    to_goal = spec.goal - pos
    dist = torch.sqrt(torch.sum(to_goal * to_goal, dim=-1, keepdim=True))
    speed = torch.sqrt(torch.sum(spec.init[..., 3:6] ** 2, dim=-1, keepdim=True))
    goal_vel = torch.where(dist > goal_threshold,
                           to_goal / torch.clamp(dist, min=1e-9) * speed,
                           torch.zeros_like(to_goal))
    model = spec.model[..., None]
    vel = torch.where(model == GOAL, goal_vel, vel)
    vel = torch.where(model == STATIC, torch.zeros_like(vel), vel)
    new_pos = pos + vel * dt
    lo = radius
    hi = map_size[..., None, :] - radius
    is_lin = model == LINEAR
    bounce = is_lin & ((new_pos < lo) | (new_pos > hi))
    vel = torch.where(bounce, -vel, vel)
    new_pos = torch.where(is_lin, torch.minimum(torch.maximum(new_pos, lo), hi),
                          new_pos)
    return new_pos, vel


def sphere_states8(pos: torch.Tensor, vel: torch.Tensor,
                   spec: SphereSpec) -> torch.Tensor:
    """[..., S, 8] rows [pos, vel, radius, priority] for the VO 'others' block."""
    rp = spec.init[..., 6:8].to(pos.dtype).expand(pos.shape[:-1] + (2,))
    return torch.cat([pos, vel, rp], dim=-1)


def inside_sphere(point: torch.Tensor, center: torch.Tensor,
                  radius: torch.Tensor) -> torch.Tensor:
    """Norm-cone membership ||p - c|| <= r over leading axes."""
    d = point - center
    return torch.sqrt(torch.sum(d * d, dim=-1)) <= radius


def predict_states(pos: torch.Tensor, vel: torch.Tensor, radius: torch.Tensor,
                   dt: float, receding: int = 5) -> torch.Tensor:
    """Constant-velocity prediction over a receding horizon:
    [receding+1, S, 4] rows (x, y, z, r)."""
    ks = torch.arange(receding + 1, dtype=pos.dtype,
                      device=pos.device)[:, None, None]
    preds = pos[None] + ks * vel[None] * dt
    r = radius[None, :, None].expand(receding + 1, radius.shape[0], 1)
    return torch.cat([preds, r], dim=-1)
