"""The (data, model) process layout (counterpart of
rvo3d_tpu/parallel/mesh.py).

A Mesh is the process group seen from one rank: `data` x `model` ranks,
numbered row-major as create_device_mesh((data, model)) lays out devices,
so rank = d * model + m. The `data` ranks of one model column each step a
contiguous block of num_envs / data lanes; the `model` ranks of one data
row step the same lanes with the same draws and each hold a shard of the
tensor-parallel weights (parallel/tensor_parallel.py). Each row and each
column gets its own process group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch.distributed as dist

from rvo3d_tpu_torch.parallel.multihost import distributed_init_from_env


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's view of its data row: `size` model ranks, its index
    among them, and their process group."""

    size: int
    rank: int
    group: Any


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int     # ranks over the env lanes
    rank: int     # global rank, d * model + m
    model: int = 1
    # process groups of this rank's model column (over `data`) and data
    # row (over `model`); None where the axis has one rank
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def model_axis(self) -> ModelAxis:
        return ModelAxis(self.model, self.model_rank, self.model_group)

    def lanes(self, num_envs: int) -> slice:
        """This rank's lanes of num_envs (its data row's)."""
        if num_envs % self.data:
            raise ValueError(f"num_envs={num_envs} does not split over {self.data} ranks")
        n = num_envs // self.data
        return slice(self.data_rank * n, (self.data_rank + 1) * n)


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The mesh of this process group (one process: 1 x 1). `data`
    defaults to world size / model; data * model must equal the world
    size. Every rank must call it, in the same order: it makes the row
    and column process groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model < 1 or world % model:
        raise ValueError(f"mesh model={model} does not divide the {world} processes "
                         "of this run (start them with the RVO3D_* variables)")
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"mesh data={data} x model={model} needs {data * model} "
                         f"processes; this run has {world} (start them with the "
                         "RVO3D_* variables)")
    rows = [[d * model + m for m in range(model)] for d in range(data)]
    cols = [[d * model + m for d in range(data)] for m in range(model)]

    def groups(members):
        if len(members[0]) == 1:
            return [None] * len(members)
        if len(members[0]) == world:
            return [dist.group.WORLD]
        return [dist.new_group(ranks) for ranks in members]   # every rank makes each

    row_groups, col_groups = groups(rows), groups(cols)
    return Mesh(data, rank, model, data_group=col_groups[rank % model],
                model_group=row_groups[rank // model])


# the JAX package's name for the same start-up (rvo3d_tpu/parallel/mesh.py)
maybe_distributed_init = distributed_init_from_env
