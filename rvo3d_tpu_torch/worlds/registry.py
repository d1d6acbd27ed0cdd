"""World registry: name -> directory (counterpart of
rvo3d_tpu/worlds/registry.py).

Search order:
  1. names given to register_world
  2. a directory path holding data_1.json
  3. $RVO3D_WORLD_PATH (colon-separated directories)
  4. <repo>/worlds_data
"""

from __future__ import annotations

import os
from typing import Dict, List

from rvo3d_tpu_torch.worlds.loader import WorldData, load_world_dir

_REGISTRY: Dict[str, str] = {}

WORLDS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "worlds_data")


def register_world(name: str, base_dir: str) -> None:
    _REGISTRY[name] = base_dir


def world_search_paths() -> List[str]:
    env = os.environ.get("RVO3D_WORLD_PATH", "")
    return [p for p in env.split(":") if p] + [WORLDS_DIR]


def resolve_world(name: str) -> WorldData:
    if name in _REGISTRY:
        return load_world_dir(_REGISTRY[name], name)
    if os.path.isdir(name) and os.path.exists(os.path.join(name, "data_1.json")):
        return load_world_dir(name)
    for root in world_search_paths():
        cand = os.path.join(root, name)
        if os.path.exists(os.path.join(cand, "data_1.json")):
            return load_world_dir(cand, name)
    raise FileNotFoundError(
        f"world '{name}' not found; searched registry + {world_search_paths()}")
