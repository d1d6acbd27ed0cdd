"""The analytic waypoint controller and bench.py's lifecycle, flown on the
frozen oracle (reference/oracle.py): the plain reference of the `sim`
driver. Imports nothing of the port, nor JAX.

`waypoint_controller` restates bench.py:44-59 (the port's
utils/heuristic.waypoint_controller at cruise 0.8 m/s and dt 1) in plain
torch, the port's operations in the port's order, so in float64 the two
give the same bits. `fly` runs bench_step's lifecycle on one lane: the
controller on the lane's state, the oracle's step with its output as the
absolute action, then a reset of each drone that collided (done) or
reached its destination (finish).

`precision` (None, or a float type below float64, e.g. torch.float16)
flies the lane as if the reference were computed in that type: the
controller runs in it, and after each step every drone's position,
velocity, angles and route length are rounded to it. It is the control a
check's limits are set against, never the reference.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference.oracle import OracleEnv

CRUISE = 0.8    # m/s (bench.py:44-59)
DT = 1.0


def norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def waypoint_controller(pos, vel, yaw, pitch, target, cruise_speed: float = CRUISE,
                        dt: float = DT) -> torch.Tensor:
    """Actions [..., N, 3] in [-1, 1] (acceleration, yaw and pitch
    increments over 90 degrees) from positions, velocities and targets
    [..., N, 3] and yaw and pitch [..., N] in degrees."""
    dif = target - pos
    dist = norm3(dif)
    t_yaw = torch.remainder(torch.rad2deg(torch.atan2(dif[..., 1], dif[..., 0])), 360.0)
    horiz = torch.sqrt(dif[..., 0] ** 2 + dif[..., 1] ** 2)
    t_pitch = torch.rad2deg(torch.atan2(dif[..., 2], horiz))
    dyaw = torch.remainder(t_yaw - yaw + 180.0, 360.0) - 180.0
    dpitch = t_pitch - pitch
    speed = norm3(vel)
    acc = torch.clamp(torch.clamp(dist / dt, max=cruise_speed) - speed, -1.0, 1.0)
    return torch.stack([acc, torch.clamp(dyaw / 90.0, -1.0, 1.0),
                        torch.clamp(dpitch / 90.0, -1.0, 1.0)], dim=-1)


def oracle_action(oracle: OracleEnv, precision: Optional[torch.dtype] = None) -> np.ndarray:
    """The controller's actions [N, 3] on the oracle's drones, float64."""
    dt = precision or torch.float64
    col = lambda xs: torch.tensor(np.asarray(xs, float), dtype=dt)  # noqa: E731
    ds = oracle.drones
    act = waypoint_controller(col([d.state for d in ds]), col([d.vel for d in ds]),
                              col([d.yaw for d in ds]), col([d.pitch for d in ds]),
                              col([d.current_des for d in ds]))
    return act.to(torch.float64).numpy()


def round_to(oracle: OracleEnv, precision: torch.dtype) -> None:
    """Every drone's continuous state rounded to `precision`."""
    r = lambda x: torch.tensor(x, dtype=torch.float64).to(precision).double().numpy()  # noqa: E731
    for d in oracle.drones:
        d.state, d.previous_state, d.vel = r(d.state), r(d.previous_state), r(d.vel)
        d.yaw, d.pitch = float(r(d.yaw)), float(r(d.pitch))
        d.real_route_len = float(r(d.real_route_len))
        d.velocity = float(np.linalg.norm(d.vel))


def step(oracle: OracleEnv, precision: Optional[torch.dtype] = None,
         jitter: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """One step of bench_step's lifecycle on the oracle, in place; returns
    what it decided: the action, done and finish [N], and whether each
    drone advanced its waypoint or reset."""
    act = oracle_action(oracle, precision)
    if jitter is not None:
        act = act + jitter
    wp = np.array([d.i for d in oracle.drones])
    _, _, done, _, fin = oracle.step(list(act))
    done, fin = np.asarray(done, bool), np.asarray(fin, bool)
    advanced = np.array([d.i for d in oracle.drones]) != wp
    for i in np.flatnonzero(done | fin):
        oracle.reset_one(i)
    if precision is not None:
        round_to(oracle, precision)
    return {"act": act, "done": done, "finish": fin, "advanced": advanced,
            "reset": done | fin}


def fly(oracle: OracleEnv, steps: int,
        precision: Optional[torch.dtype] = None) -> Dict[str, int]:
    """`steps` steps of the lane from the oracle's state, in place; counts
    of the resets, collisions, arrivals at the destination and waypoint
    advances."""
    n = {"resets": 0, "collisions": 0, "finishes": 0, "advances": 0}
    for _ in range(steps):
        res = step(oracle, precision)
        n["resets"] += int(res["reset"].sum())
        n["collisions"] += int(res["done"].sum())
        n["finishes"] += int(res["finish"].sum())
        n["advances"] += int(res["advanced"].sum())
    return n
