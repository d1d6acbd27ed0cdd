"""World artifact loading (counterpart of rvo3d_tpu/worlds/loader.py).

A world directory holds the reference's format:

  <world>/data_1.json : {drone_num, map_size, waypoints_list, n_points_list,
                         building_list}
  <world>/E3d.npy, E3d_safe.npy : occupancy grids (host-side planning only;
                                  the env step never reads them)

Worlds resolve by path or by name under the repo's `worlds_data/`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np
import torch

from rvo3d_tpu_torch.env.state import WorldSpec, make_world_spec

WORLDS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "worlds_data")


@dataclasses.dataclass
class WorldData:
    """Host-side world record (before padding)."""

    name: str
    drone_num: int
    map_size: List[float]
    waypoints_list: List[List[List[float]]]
    n_points_list: List[int]
    building_list: List[List[float]]
    base_dir: Optional[str] = None

    def e3d(self, safe: bool = False) -> Optional[np.ndarray]:
        """The occupancy grid (E3d.npy, or E3d_safe.npy), if present."""
        if not self.base_dir:
            return None
        path = os.path.join(self.base_dir, "E3d_safe.npy" if safe else "E3d.npy")
        return np.load(path) if os.path.exists(path) else None

    def spec(self, *, radius: float = 0.2, priority: float = 5.0,
             vel_max: float = 1.0, pad_waypoints: int | None = None,
             pad_buildings: int | None = None, dtype=torch.float32,
             device="cuda") -> WorldSpec:
        return make_world_spec(
            self.waypoints_list, self.building_list, self.map_size,
            radius=radius, priority=priority, vel_max=vel_max,
            pad_waypoints=pad_waypoints, pad_buildings=pad_buildings,
            dtype=dtype, device=device)


def load_world_dir(base_dir: str, name: Optional[str] = None) -> WorldData:
    with open(os.path.join(base_dir, "data_1.json")) as f:
        data = json.load(f)
    return WorldData(
        name=name or os.path.basename(os.path.normpath(base_dir)),
        drone_num=int(data.get("drone_num", 0)),
        map_size=data.get("map_size", []),
        waypoints_list=data.get("waypoints_list", []),
        n_points_list=data.get("n_points_list", []),
        building_list=data.get("building_list", []),
        base_dir=base_dir,
    )


def load_world(name: str) -> WorldData:
    """A world by directory path, or by name under worlds_data/."""
    if os.path.exists(os.path.join(name, "data_1.json")):
        return load_world_dir(name)
    cand = os.path.join(WORLDS_DIR, name)
    if os.path.exists(os.path.join(cand, "data_1.json")):
        return load_world_dir(cand, name)
    raise FileNotFoundError(f"world '{name}' not found as a path or under {WORLDS_DIR}")
