"""Placement over the mesh's data axis (counterpart of
rvo3d_tpu/parallel/sharding.py; the model axis is
parallel/tensor_parallel.py).

The env-lane axis E is the scaling axis: each rank keeps its data row's
lanes of the rollout carry and of a lane world, draws every random number
at the global [E, ...] shape and keeps its lanes of it, and the rollout
buffers are gathered over the data axis so that every rank runs the same
PPO update on the full batch. Parameters and optimizer states are
replicated over the data axis.

Collectives use only `all_reduce` and `broadcast`, which gloo takes for
CPU and CUDA tensors and NCCL for CUDA tensors: a gather is the sum of a
zero-filled global buffer into which each rank writes its own lanes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from rvo3d_tpu_torch.parallel.mesh import Mesh


def shard_carry(carry: Any, mesh: Mesh, num_envs: int) -> Any:
    """This rank's lanes of every tensor whose leading axis is num_envs, in
    a tree of NamedTuples and tuples; every other leaf stays whole."""
    lanes = mesh.lanes(num_envs)

    def place(x):
        if isinstance(x, torch.Tensor):
            return x[lanes].clone() if x.dim() >= 1 and x.shape[0] == num_envs else x
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*map(place, x))
        if isinstance(x, (tuple, list)):
            return type(x)(map(place, x))
        return x
    return place(carry)


class LaneDraws(NamedTuple):
    """A generator's standard-normal draws at the global lane count,
    cut to this rank's lanes: rank r's lanes see the draws they would see
    in one process."""

    generator: torch.Generator
    lanes: slice
    num_envs: int

    def randn(self, shape, dtype, device) -> torch.Tensor:
        full = torch.randn((self.num_envs,) + tuple(shape[1:]), generator=self.generator,
                           dtype=dtype, device=device)
        return full[self.lanes]


def gather_lanes(t: torch.Tensor, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """The concatenation over the data axis, in data-rank order, of every
    rank's `t` along `axis` (equal shards)."""
    if mesh.data == 1:
        return t
    return gather_shards(t, mesh.data, mesh.data_rank, mesh.data_group, axis)


def gather_shards(t: torch.Tensor, size: int, rank: int, group, axis: int = 0
                  ) -> torch.Tensor:
    """The concatenation along `axis`, in rank order, of `t` from each of
    the `size` ranks of `group` (this one is `rank`): the sum of a
    zero-filled buffer into which each rank writes its own block."""
    n = t.shape[axis]
    shape = list(t.shape)
    shape[axis] = n * size
    wire = torch.uint8 if t.dtype == torch.bool else t.dtype
    buf = torch.zeros(shape, dtype=wire, device=t.device)
    buf.narrow(axis, rank * n, n).copy_(t)
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


def reduce_lanes(t: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """The elementwise sum, min or max of `t` over the data axis."""
    if mesh.data == 1:
        return t
    out = t.clone()
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                             "max": dist.ReduceOp.MAX}[op], group=mesh.data_group)
    return out


def _broadcast_(t: torch.Tensor) -> None:
    if dist.get_backend() == "nccl" and not t.is_cuda:   # NCCL moves CUDA tensors only
        wire = t.cuda()
        dist.broadcast(wire, 0)
        t.copy_(wire)
    else:
        dist.broadcast(t, 0)


@torch.no_grad()
def replicate(obj, mesh: Mesh):
    """Overwrite a module's parameters and buffers, or an optimizer's
    state tensors, with rank 0's on every rank, in place; returns `obj`.
    (Before parallel/tensor_parallel.shard_params_tp: it broadcasts whole
    tensors.)"""
    if mesh.size == 1:
        return obj
    if isinstance(obj, nn.Module):
        tensors = list(obj.parameters()) + list(obj.buffers())
    elif isinstance(obj, torch.optim.Optimizer):
        tensors = [v for g in obj.param_groups for p in g["params"]
                   for _, v in sorted(obj.state.get(p, {}).items())
                   if isinstance(v, torch.Tensor)]
    else:
        raise TypeError(f"replicate takes a module or an optimizer, not {type(obj)}")
    for t in tensors:
        _broadcast_(t.data)
    return obj
