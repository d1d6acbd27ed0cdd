from rvo3d_tpu_torch.worlds.loader import WorldData, load_world, load_world_dir

__all__ = ["WorldData", "load_world", "load_world_dir"]
