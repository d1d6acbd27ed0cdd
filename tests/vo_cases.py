"""Inputs of the env step's VO pass (env/rvo.py) where neighbours get
listed, shared by the CPU tests and the card tests (no JAX here).

  dense_cluster   a converging lattice of drones: every row flags more than
                  nm candidates, and the lattice's symmetry plants exact ties
                  in sort_t (and, with env_train off, overlapping pairs whose
                  expected time is exactly 0) and in sort_d
  flown_inputs    (states12, actions, others) of lanes flown on the CPU by
                  the noisy waypoint controller
  select_brute    the top-nm selection by a Python sort of each row
"""

import itertools

import numpy as np
import torch

from rvo3d_tpu_torch.env import geometry as geo
from rvo3d_tpu_torch.env.env import _vo_others, drone_states_12
from rvo3d_tpu_torch.utils.heuristic import waypoint_controller

# 12 drones and 3 spheres crossing a 12 x 12 x 6 map: M = 12 + 3 > nm = 10
SPHERES = [
    {"pos": (5.0, 5.0, 3.0), "radius": 0.5},
    {"pos": (2.0, 8.0, 2.0), "vel": (0.6, -0.3, 0.1), "radius": 0.4, "model": "linear"},
    {"pos": (9.0, 2.0, 4.0), "vel": (0.5, 0.0, 0.0), "radius": 0.3,
     "model": "goal", "goal": (3.0, 9.0, 2.0)},
]
SPHERE_WAYPOINTS = [[[1.0 + i * 0.8, 1.0, 2.0 + (i % 3)],
                     [11.0 - i * 0.8, 11.0, 4.0 - (i % 3)]] for i in range(12)]
SPHERE_BUILDINGS = [[6.0, 6.0, 5.0, 0.8]]
SPHERE_MAP = [12.0, 12.0, 6.0]

# (lattice dims, env_train): every row flags more than nm = 10 candidates
# at spacing 0.3 (M = 16, 32 and 64: one row per 16 threads, per warp, and
# two chunks of 32)
CLUSTERS = [((4, 2, 2), False), ((4, 4, 2), False), ((4, 4, 2), True),
            ((4, 4, 4), False), ((4, 4, 4), True)]


def dense_cluster(dims, dtype=torch.float64, spacing=0.3, lanes=2,
                  act_dtype=None):
    """(states [lanes, N, 12], actions [lanes, N, 3], buildings [2, 4],
    building_mask [2]): a lattice of N = prod(dims) drones at `spacing`,
    each flying (and commanded) toward the lattice's centre along the
    diagonals, lane e at (e + 1) times the speed; one building stands in
    the lattice and a second, masked out, beside it."""
    pts = np.array(list(itertools.product(*[range(d) for d in dims])), float)
    pts = pts * spacing + 5.0
    vel = 0.5 * np.sign(pts.mean(0) - pts)
    st = np.zeros((lanes, len(pts), 12))
    st[..., 0:3] = pts
    st[..., 3:6] = vel[None] * np.arange(1, lanes + 1)[:, None, None]
    st[..., 6] = 0.2
    st[..., 7] = 5.0
    centre = pts.mean(0)
    buildings = torch.tensor([[centre[0], centre[1], 10.0, 0.1],
                              [centre[0] + 0.3, centre[1], 10.0, 0.5]], dtype=dtype)
    states = torch.tensor(st, dtype=dtype)
    actions = torch.tensor(st[..., 3:6], dtype=act_dtype or dtype)
    return states, actions, buildings, torch.tensor([True, False])


def flown_inputs(env, world, p, steps=40, every=2, noise=1.0, seed=0,
                 lane_world=False):
    """[(states12, actions, others)] of every `every`-th step of `env`'s
    lanes (a DroneEnv, or a MultiWorldEnv when lane_world) flown on the CPU
    by the waypoint controller with Gaussian noise, reset where done."""
    reset, step, reset_where = ((env.reset_batch, env.step_batch, env.reset_where_batch)
                                if lane_world else (env.reset, env.step, env.reset_where))
    state, _ = reset()
    g = torch.Generator().manual_seed(seed)
    kept = []
    for t in range(steps):
        noise_t = noise * torch.randn(state.pos.shape, generator=g, dtype=state.pos.dtype)
        act = geo.rnd(waypoint_controller(state, world) + noise_t, 2)
        if t % every == 0:
            s12, _ = drone_states_12(world, state, p)
            kept.append((s12, act, _vo_others(world, state, s12)))
        state, out = step(state, act)
        state = reset_where(state, out.done)
    return kept


def select_brute(sort_t, sort_d, flagged, obs9, nm):
    """(obs_nbr, obs_mask) of each row's last min(nm, M) candidates in the
    order (sort_t ascending, sort_d descending, index ascending), by
    Python's sort: its float comparisons see -0.0 equal to +0.0. Flagged
    blocks fill the last slots; the rest are zero and unmasked."""
    sort_t, sort_d = np.asarray(sort_t), np.asarray(sort_d)
    flagged, obs9 = np.asarray(flagged), np.asarray(obs9)
    lead, m = sort_t.shape[:-1], sort_t.shape[-1]
    k = min(nm, m)
    obs_nbr = np.zeros(lead + (nm, 9), obs9.dtype)
    obs_mask = np.zeros(lead + (nm,), bool)
    for idx in np.ndindex(*lead):
        order = sorted(range(m), key=lambda j: (sort_t[idx][j], -sort_d[idx][j], j))
        for s, j in enumerate(order[m - k:]):
            if flagged[idx][j]:
                obs_nbr[idx][nm - k + s] = obs9[idx][j]
                obs_mask[idx][nm - k + s] = True
    return obs_nbr, obs_mask
