"""World artifact loading (counterpart of rvo3d_tpu/worlds/loader.py).

A world directory holds the reference's format:

  <world>/data_1.json : {drone_num, map_size, waypoints_list, n_points_list,
                         building_list}
  <world>/E3d.npy, E3d_safe.npy : occupancy grids (host-side planning only;
                                  the env step never reads them)

`load_world` resolves a name through worlds/registry.py: registered
names, then a directory path, then $RVO3D_WORLD_PATH, then the repo's
`worlds_data/`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np
import torch

from rvo3d_tpu_torch.env.state import WorldSpec, make_world_spec


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
    # grids held in memory (a generated world's), written by save()
    _e3d: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    _e3d_safe: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)

    def e3d(self, safe: bool = False) -> Optional[np.ndarray]:
        """The occupancy grid (E3d.npy, or E3d_safe.npy), if present."""
        held = self._e3d_safe if safe else self._e3d
        if held is not None or not self.base_dir:
            return held
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

    def save(self, out_dir: str) -> None:
        """Write data_1.json, and the grids held in memory, to out_dir."""
        os.makedirs(out_dir, exist_ok=True)
        payload = {
            "drone_num": self.drone_num,
            "map_size": list(self.map_size),
            "waypoints_list": self.waypoints_list,
            "n_points_list": self.n_points_list,
            "building_list": self.building_list,
        }
        with open(os.path.join(out_dir, "data_1.json"), "w") as f:
            json.dump(payload, f)
        if self._e3d is not None:
            np.save(os.path.join(out_dir, "E3d.npy"), self._e3d)
        if self._e3d_safe is not None:
            np.save(os.path.join(out_dir, "E3d_safe.npy"), self._e3d_safe)


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
    """A world by registered name, directory path, or name under the
    search paths (worlds/registry.py)."""
    from rvo3d_tpu_torch.worlds.registry import resolve_world

    return resolve_world(name)
