from rvo3d_tpu_torch.worlds.loader import WorldData, load_world, load_world_dir
from rvo3d_tpu_torch.worlds.registry import register_world, world_search_paths

__all__ = ["WorldData", "load_world", "load_world_dir", "register_world",
           "world_search_paths"]
