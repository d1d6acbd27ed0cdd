"""Host-side 3D scene rendering (counterpart of rvo3d_tpu/render/plot.py).

Capability of the reference's env_plot (reference:
uaisa_env/drone_envs/env_plot.py:21-414): cylinder buildings, waypoint
routes, drone markers with trails, velocity quivers, VO cones via Rodrigues
rotation, and GIF/animation export — but decoupled from the environment.
The reference constructs a live matplotlib figure inside the env
(env_base.py:107-108, plot always on) and mutates it per step; here the env
emits arrays and the plotter consumes recorded trajectories after the fact,
so rendering never touches the env's step. Matplotlib is imported only
when a ScenePlotter is made.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch


def record_trajectory(env, controller, steps: int = 150, reset_done: bool = True):
    """Roll one env instance, a DroneEnv with num_envs=1 (state [1, N, ...],
    on any device), with `controller(state, world) -> absolute actions
    [1, N, 3]`; returns a dict of stacked host arrays [T, N, ...] for
    rendering and analysis."""
    if env.num_envs != 1:
        raise ValueError(f"record_trajectory steps one env instance, not {env.num_envs}")
    state, out = env.reset()
    pos, vel, done, finish, rew = [], [], [], [], []
    obs_nbr, obs_mask = [], []

    def host(x):
        return x[0].cpu().numpy()

    with torch.no_grad():
        for _ in range(steps):
            a = controller(state, env.world)
            state, out = env.step(state, a)
            pos.append(host(state.pos))
            vel.append(host(state.vel))
            done.append(host(out.done))
            finish.append(host(out.finish))
            rew.append(host(out.reward))
            # post-step VO observation = cones at the drawn positions
            # (reference feeds live obs to draw_cone, env_plot.py:241-270)
            obs_nbr.append(host(out.obs_nbr))
            obs_mask.append(host(out.obs_mask))
            if reset_done and bool(out.done.any()):
                state = env.reset_where(state, out.done)
    return {
        "pos": np.stack(pos), "vel": np.stack(vel), "done": np.stack(done),
        "finish": np.stack(finish), "reward": np.stack(rew),
        "obs_nbr": np.stack(obs_nbr), "obs_mask": np.stack(obs_mask),
    }


def cones_from_obs(obs_nbr: np.ndarray, obs_mask: np.ndarray):
    """Extract VO cones for one frame from the logged [N, nm, 9] blocks.

    The normal-branch block is [PAA(3), rel(3), alpha, min_dis, 1/(t+0.2)]
    (reference: rvo_inter.config_vo_circle2, rvo_inter.py:192): vertex =
    reciprocal apex PAA, axis = p_b - p_a, half-angle = alpha. Collision /
    back-off branches zero the alpha slot, so alpha > 0 selects exactly the
    live cones."""
    cones = []
    for i in range(obs_nbr.shape[0]):
        for m in range(obs_nbr.shape[1]):
            if not obs_mask[i, m]:
                continue
            blk = obs_nbr[i, m]
            alpha = float(blk[6])
            if alpha <= 0.0:
                continue
            cones.append((blk[0:3], blk[3:6], alpha))
    return cones


def _rotation_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation (reference: env_plot.rotation_matrix,
    env_plot.py:459-468)."""
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    k = np.array([
        [0, -axis[2], axis[1]],
        [axis[2], 0, -axis[0]],
        [-axis[1], axis[0], 0],
    ])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


class ScenePlotter:
    """Static-world 3D scene with per-frame drone overlays."""

    def __init__(self, map_size: Sequence[float],
                 building_list: Sequence[Sequence[float]],
                 waypoints_list: Optional[Sequence] = None,
                 figsize=(8, 6)):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self.plt = plt
        self.map_size = list(map_size)
        self.buildings = [list(b) for b in building_list]
        self.waypoints = waypoints_list or []
        self.fig = plt.figure(figsize=figsize)
        self.ax = self.fig.add_subplot(111, projection="3d")
        self._dynamic = []
        self._draw_static()

    def _draw_static(self):
        ax = self.ax
        x, y, z = self.map_size
        ax.set_xlim(0, x)
        ax.set_ylim(0, y)
        ax.set_zlim(0, z + 1)
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.set_zlabel("z")
        # cylinder buildings (env_plot.plot_buildings_on_map, :84-109)
        for b in self.buildings:
            bx, by, bh, br = b
            u = np.linspace(0, 2 * np.pi, 30)
            hs = np.linspace(0, bh, 8)
            U, H = np.meshgrid(u, hs)
            X = bx + br * np.cos(U)
            Y = by + br * np.sin(U)
            ax.plot_surface(X, Y, H, color="steelblue", alpha=0.5,
                            linewidth=0)
        # waypoint routes (env_plot.draw_waypoints, :127-156)
        for i, wps in enumerate(self.waypoints):
            w = np.asarray(wps)
            ax.plot(w[:, 0], w[:, 1], w[:, 2], "x--", color="gray",
                    linewidth=0.8, markersize=4)
            ax.plot([w[0, 0]], [w[0, 1]], [w[0, 2]], "go", markersize=5)
            ax.plot([w[-1, 0]], [w[-1, 1]], [w[-1, 2]], "r*", markersize=8)

    def clear_dynamic(self):
        for artist in self._dynamic:
            try:
                artist.remove()
            except (ValueError, NotImplementedError):   # already detached
                pass
        self._dynamic = []

    def draw_frame(self, pos: np.ndarray, vel: Optional[np.ndarray] = None,
                   trail: Optional[np.ndarray] = None,
                   cones: Optional[List] = None):
        """pos [N,3]; vel [N,3]; trail [T,N,3] history; cones: list of
        (vertex, axis, half_angle_rad)."""
        self.clear_dynamic()
        ax = self.ax
        n = pos.shape[0]
        cmap = self.plt.get_cmap("tab10")
        for i in range(n):
            c = cmap(i % 10)
            art = ax.scatter([pos[i, 0]], [pos[i, 1]], [pos[i, 2]],
                             color=c, s=40, depthshade=False)
            self._dynamic.append(art)
            if trail is not None:
                line, = ax.plot(trail[:, i, 0], trail[:, i, 1],
                                trail[:, i, 2], color=c, linewidth=1.0,
                                alpha=0.7)
                self._dynamic.append(line)
            if vel is not None and np.linalg.norm(vel[i]) > 1e-6:
                q = ax.quiver(pos[i, 0], pos[i, 1], pos[i, 2],
                              vel[i, 0], vel[i, 1], vel[i, 2],
                              color=c, length=1.0, normalize=False)
                self._dynamic.append(q)
        if cones:
            for vertex, axis, alpha in cones:
                self._draw_cone(np.asarray(vertex), np.asarray(axis),
                                float(alpha))

    def _draw_cone(self, vertex, axis, half_angle, length=2.0, n_theta=20):
        """VO cone (env_plot.draw_cone, :241-270): unit cone along +z,
        rotated onto `axis` with Rodrigues, translated to vertex."""
        r = np.tan(half_angle) * length
        theta = np.linspace(0, 2 * np.pi, n_theta)
        hs = np.linspace(0, length, 6)
        T, H = np.meshgrid(theta, hs)
        X = (H / length) * r * np.cos(T)
        Y = (H / length) * r * np.sin(T)
        Z = H
        pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()])
        z_axis = np.array([0.0, 0.0, 1.0])
        a = axis / (np.linalg.norm(axis) + 1e-12)
        rot_axis = np.cross(z_axis, a)
        if np.linalg.norm(rot_axis) < 1e-9:
            R = np.eye(3) if a[2] > 0 else np.diag([1.0, -1.0, -1.0])
        else:
            angle = np.arccos(np.clip(np.dot(z_axis, a), -1, 1))
            R = _rotation_matrix(rot_axis, angle)
        rp = (R @ pts).reshape(3, *X.shape) + np.asarray(vertex)[:, None, None]
        surf = self.ax.plot_surface(rp[0], rp[1], rp[2], color="orange",
                                    alpha=0.25, linewidth=0)
        self._dynamic.append(surf)

    def save_frame(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.fig.savefig(path, dpi=100)

    def render_trajectory(self, traj: dict, out_dir: str, every: int = 1,
                          trail_len: int = 30,
                          draw_cones: bool = False) -> List[str]:
        """Render a record_trajectory() dict to PNG frames; returns paths.
        draw_cones=True overlays the live VO cones decoded from the logged
        per-step observation blocks (cones_from_obs)."""
        pos = traj["pos"]
        vel = traj.get("vel")
        obs_nbr = traj.get("obs_nbr") if draw_cones else None
        frames = []
        for t in range(0, pos.shape[0], every):
            lo = max(0, t - trail_len)
            cones = (cones_from_obs(obs_nbr[t], traj["obs_mask"][t])
                     if obs_nbr is not None else None)
            self.draw_frame(pos[t], vel[t] if vel is not None else None,
                            trail=pos[lo:t + 1], cones=cones)
            p = os.path.join(out_dir, f"frame_{t:04d}.png")
            self.save_frame(p)
            frames.append(p)
        return frames

    def close(self):
        self.plt.close(self.fig)
