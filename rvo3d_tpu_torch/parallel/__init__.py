from rvo3d_tpu_torch.parallel.mesh import Mesh, make_mesh
from rvo3d_tpu_torch.parallel.multihost import distributed_init_from_env, is_coordinator
from rvo3d_tpu_torch.parallel.sharding import (LaneDraws, gather_lanes, reduce_lanes,
                                               replicate, shard_carry)

__all__ = ["Mesh", "make_mesh", "distributed_init_from_env",
           "is_coordinator", "LaneDraws", "gather_lanes", "reduce_lanes", "replicate",
           "shard_carry"]
