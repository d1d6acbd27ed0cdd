"""End-to-end world generation: endpoints -> cylinder city -> Theta* routes
-> WorldData (data_1.json + occupancy grids).

Capability of the reference's path_planning_main.py (reference:
uaisa_env/world/path_planning_main.py:172-205), with its rot fixed: the
reference comments out its own city generator and hand-builds a single
pillar (path_planning_main.py:49-67); here the generator is actually
called. Coordinates: grids are indexed [y, x, z]; world waypoints are
(x, y, z) at cell centers (the shipped worlds' .5-offset convention).

The port's copy of rvo3d_tpu/worlds/gen/pipeline.py: host NumPy, the same
seeded draws, so the same seed gives the same world.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from rvo3d_tpu_torch.worlds.gen.citygen import cylinder_city
from rvo3d_tpu_torch.worlds.gen.endpoints import random_endpoints
from rvo3d_tpu_torch.worlds.gen.planner import theta_star_3d
from rvo3d_tpu_torch.worlds.loader import WorldData


def _to_world(path_yxz: np.ndarray) -> list:
    """grid (y, x, z) -> world (x+.5, y+.5, z+.5) cell centers."""
    out = []
    for y, x, z in path_yxz:
        out.append([float(x) + 0.5, float(y) + 0.5, float(z) + 0.5])
    return out


def _simplify(path: list) -> list:
    """Drop collinear intermediate waypoints (Theta* already shortcuts, but
    grid fallback segments can leave runs of collinear nodes)."""
    if len(path) <= 2:
        return path
    out = [path[0]]
    for i in range(1, len(path) - 1):
        a = np.asarray(out[-1])
        b = np.asarray(path[i])
        c = np.asarray(path[i + 1])
        ab, ac = b - a, c - a
        cross = np.linalg.norm(np.cross(ab, ac))
        if cross > 1e-9:
            out.append(path[i])
    out.append(path[-1])
    return out


def generate_world(
    name: str,
    num_drones: int = 4,
    map_size: Sequence[int] = (12, 12, 6),
    *,
    seed: int = 0,
    n_low: int = 1,
    k_sigma: float = 2.0,
    kg: float = 1.0,
    kh: float = 1.25,
    ke: float = 1.0,
    min_distance: Optional[float] = None,
    max_retries: int = 8,
) -> WorldData:
    """Returns a WorldData ready for .spec() / .save(); raises if any route
    cannot be planned after max_retries reseeds."""
    x_size, y_size, z_size = map_size

    for attempt in range(max_retries):
        s = seed + attempt * 1000
        eps = random_endpoints(
            num_drones, (x_size, y_size, z_size),
            min_distance=min_distance, seed=s, margin=1,
        )
        # citygen wants (y, x) endpoint order for clearing; endpoints are
        # (x, y, z) world ints
        starts_yx = [(p[1], p[0], p[2]) for p in eps["start_points"]]
        ends_yx = [(p[1], p[0], p[2]) for p in eps["end_points"]]
        _, _, e3d, e3d_safe, buildings_yx = cylinder_city(
            (y_size, x_size, z_size), starts_yx, ends_yx,
            n_low=n_low, k_sigma=k_sigma, seed=s,
        )

        waypoints_list = []
        ok = True
        for st, en in zip(starts_yx, ends_yx):
            res = theta_star_3d(e3d_safe, st, en, kg=kg, kh=kh, ke=ke)
            if res is None:
                ok = False
                break
            path, _ = res
            wps = _simplify(_to_world(path))
            if len(wps) < 2:
                wps = wps + wps  # degenerate: start == goal cell
            waypoints_list.append(wps)
        if not ok:
            continue

        # buildings: grid (y, x, h, r_dilate-1) -> world (x+.5, y+.5, h, r)
        building_list = [
            [bx + 0.5, by + 0.5, bh, max(br, 0.0) + 0.5]
            for (by, bx, bh, br) in buildings_yx
        ]

        wd = WorldData(
            name=name,
            drone_num=num_drones,
            map_size=[float(x_size), float(y_size), float(z_size)],
            waypoints_list=waypoints_list,
            n_points_list=[len(w) for w in waypoints_list],
            building_list=building_list,
        )
        wd._e3d = e3d
        wd._e3d_safe = e3d_safe
        return wd

    raise RuntimeError(
        f"world generation failed after {max_retries} attempts "
        f"(map {tuple(map_size)}, {num_drones} drones)"
    )
