"""The data-parallel layout over env lanes (counterpart of
rvo3d_tpu/parallel/mesh.py).

A Mesh is the process group seen from one rank: `data` ranks, each
stepping a contiguous block of num_envs / data lanes, the parameters and
both optimizers replicated. Tensor parallelism (`model` > 1, the JAX
package's shard_params_tp) is not ported: it needs more than one card
(ROADMAP A18).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from rvo3d_tpu_torch.parallel.multihost import distributed_init_from_env


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int     # ranks over the env lanes (the world size)
    rank: int

    def lanes(self, num_envs: int) -> slice:
        """This rank's lanes of num_envs."""
        if num_envs % self.data:
            raise ValueError(f"num_envs={num_envs} does not split over {self.data} ranks")
        n = num_envs // self.data
        return slice(self.rank * n, (self.rank + 1) * n)


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The mesh of this process group (one process: data = 1). `data`
    defaults to the world size and must equal it."""
    if model != 1:
        raise NotImplementedError(
            f"mesh model={model}: tensor parallelism is not ported to "
            "rvo3d_tpu_torch (ROADMAP A18; it needs more than one card)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    data = world if data is None else data
    if data != world:
        raise ValueError(f"mesh data={data} needs {data} processes; this run has "
                         f"{world} (start them with the RVO3D_* variables)")
    return Mesh(data, rank)


# the JAX package's name for the same start-up (rvo3d_tpu/parallel/mesh.py)
maybe_distributed_init = distributed_init_from_env
