from rvo3d_tpu_torch.worlds.gen.endpoints import random_endpoints
from rvo3d_tpu_torch.worlds.gen.citygen import cylinder_city
from rvo3d_tpu_torch.worlds.gen.lineofsight import line_of_sight_3d
from rvo3d_tpu_torch.worlds.gen.planner import theta_star_3d
from rvo3d_tpu_torch.worlds.gen.pipeline import generate_world

__all__ = [
    "random_endpoints", "cylinder_city", "line_of_sight_3d",
    "theta_star_3d", "generate_world",
]
