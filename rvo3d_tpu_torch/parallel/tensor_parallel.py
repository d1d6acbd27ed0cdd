"""Tensor parallelism over the mesh's model axis (counterpart of
shard_params_tp and _TP_RULES in rvo3d_tpu/parallel/sharding.py).

TP_RULES name, in the JAX package's flax parameter paths, the tensors of
which a model rank holds only its shard, and the sharded axis of each:

  - the actor's and critic's dense_0 kernel and bias, on the output dim;
  - their dense_1 kernel, on the input dim;
  - the encoder's fwd/bwd w_ih, w_hh, b_ih, b_hh, on the packed gate dim
    (the LSTM's core is `fwd` too).

`tp_shard_dims` maps them onto the port's state_dict names through
utils/convert.py (a flax kernel [in, out] is nn.Linear's weight [out, in]).
Rank m of a row of M holds block m of M equal blocks of each such tensor;
every other tensor is whole on every rank.

The forward under tensor parallelism (models/actor_critic.py,
models/encoder.py read the `tp` attribute that shard_params_tp sets):
  - an MLP runs Megatron column -> row: dense_0 on this rank's output
    columns, its input through `copy_to_model` (identity forward, the sum
    of the gradient over the row backward); dense_1 on the matching input
    rows, the partial products summed over the row by `reduce_from_model`
    (sum forward, identity backward); then dense_1's bias, and dense_2 whole;
  - the recurrent weights are gathered whole over the row before the
    recurrence (`gather_from_model`), which is what GSPMD does around a
    custom call: the masked-GRU kernel and the LSTM loop stay unsharded.
    The gather's backward keeps this rank's block of the gradient, which
    every rank of the row computes whole because they all see the same rows.
The Adam states hold the shards; the global gradient norm sums its
squares over the row (algo/ppo.clip_by_global_norm_). Every collective is
an all_reduce over the row's process group, which gloo takes for CPU and
CUDA tensors and NCCL for CUDA tensors.
"""

from __future__ import annotations

import re
from typing import Dict

import torch
import torch.distributed as dist
from torch import nn

from rvo3d_tpu_torch.parallel.mesh import Mesh, ModelAxis
from rvo3d_tpu_torch.parallel.sharding import gather_shards
from rvo3d_tpu_torch.utils.convert import flax_names

# (flax path pattern, the axis names of the flax array); "model" marks the
# sharded axis (the JAX package's PartitionSpecs)
TP_RULES = [
    (re.compile(r".*(actor|critic)/dense_0/kernel"), (None, "model")),
    (re.compile(r".*(actor|critic)/dense_0/bias"), ("model",)),
    (re.compile(r".*(actor|critic)/dense_1/kernel"), ("model", None)),
    (re.compile(r".*(fwd|bwd)/w_ih"), (None, "model")),
    (re.compile(r".*(fwd|bwd)/w_hh"), (None, "model")),
    (re.compile(r".*(fwd|bwd)/b_ih"), ("model",)),
    (re.compile(r".*(fwd|bwd)/b_hh"), ("model",)),
]


def tp_shard_dims(module: nn.Module) -> Dict[str, int]:
    """The module's state_dict names that TP_RULES shard -> the sharded
    dim in the port's layout."""
    out = {}
    for name, (path, transposed) in flax_names(module.state_dict()).items():
        for pat, spec in TP_RULES:
            if pat.match(path):
                axis = spec.index("model")
                out[name] = (len(spec) - 1 - axis) if transposed else axis
                break
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=axis.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, w.shape[dim]
        return gather_shards(w.detach(), axis.size, axis.rank, axis.group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n).contiguous(), None, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _ReduceFromModel.apply(x, axis)


def gather_from_model(w: torch.Tensor) -> torch.Tensor:
    """A sharded parameter, whole; the parameter itself when it is not
    sharded."""
    axis = getattr(w, "tp_axis", None)
    return w if axis is None else _GatherFromModel.apply(w, axis, w.tp_dim)


def _gather_value(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`t` whole if it is a tensor of the sharded parameter `like`'s shape
    (its value or an Adam moment), else `t`."""
    axis = getattr(like, "tp_axis", None)
    if axis is None or not isinstance(t, torch.Tensor) or t.shape != like.shape:
        return t
    return gather_shards(t.detach(), axis.size, axis.rank, axis.group, like.tp_dim)


@torch.no_grad()
def shard_params_tp(ppo_state, mesh: Mesh):
    """In place on a PPOState (ac, pi_opt, vf_opt): every parameter that
    TP_RULES name becomes this rank's block of it, in the module and in
    both optimizers (with its Adam state, if any), tagged `tp_axis` and
    `tp_dim`; the modules that hold them get `tp`. With mesh.model == 1
    nothing changes. Returns ppo_state."""
    if mesh.model == 1:
        return ppo_state
    ac, axis = ppo_state.ac, mesh.model_axis
    swap = {}
    for name, dim in tp_shard_dims(ac).items():
        owner_name, attr = name.rsplit(".", 1)
        owner = ac.get_submodule(owner_name)
        full = getattr(owner, attr)
        if full.shape[dim] % axis.size:
            raise ValueError(f"{name} {tuple(full.shape)}: dim {dim} does not split "
                             f"over {axis.size} model ranks")
        n = full.shape[dim] // axis.size
        shard = nn.Parameter(full.detach().narrow(dim, axis.rank * n, n).clone())
        shard.tp_axis, shard.tp_dim = axis, dim
        setattr(owner, attr, shard)
        mlp = owner_name.rsplit(".layers.", 1)[0]       # actor.layers.0 -> actor
        ac.get_submodule(mlp).tp = axis
        swap[id(full)] = (full, shard, dim, n)
    for opt in (ppo_state.pi_opt, ppo_state.vf_opt):
        for group in opt.param_groups:
            group["params"] = [swap[id(p)][1] if id(p) in swap else p
                               for p in group["params"]]
        for full, shard, dim, n in swap.values():
            if full in opt.state:
                opt.state[shard] = {
                    k: (v.narrow(dim, axis.rank * n, n).clone()
                        if isinstance(v, torch.Tensor) and v.shape == full.shape else v)
                    for k, v in opt.state.pop(full).items()}
    ac.tp = axis
    return ppo_state


def is_sharded(module: nn.Module) -> bool:
    return getattr(module, "tp", None) is not None


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's state_dict with every shard gathered whole (a
    collective over the row under tensor parallelism: every rank of the
    row calls it)."""
    params = dict(module.named_parameters())
    return {k: _gather_value(v, params[k]) if k in params else v
            for k, v in module.state_dict().items()}


def full_optimizer_state_dict(opt: torch.optim.Optimizer) -> dict:
    """The optimizer's state_dict with the Adam moments of every sharded
    parameter gathered whole (collective, as full_state_dict)."""
    sd = opt.state_dict()
    params = [p for g in opt.param_groups for p in g["params"]]
    sd["state"] = {i: {k: _gather_value(v, params[i]) for k, v in st.items()}
                   for i, st in sd["state"].items()}
    return sd


def full_policy(ac: nn.Module) -> nn.Module:
    """`ac` when it is not sharded; otherwise an unsharded ActorCritic of
    the same config with the gathered weights (collective, as
    full_state_dict)."""
    if not is_sharded(ac):
        return ac
    whole = full_state_dict(ac)
    out = type(ac)(ac.cfg, ac.act_dim, device=ac.log_std.device)
    out.load_state_dict(whole)
    return out


def global_sq_norm(grads, params) -> torch.Tensor:
    """The squared norm of the whole gradients of `params` from their
    local `grads`: the shards' squares summed over their row."""
    local = [torch.sum(g * g) for g, p in zip(grads, params)
             if getattr(p, "tp_axis", None) is None]
    sharded = [(torch.sum(g * g), p.tp_axis) for g, p in zip(grads, params)
               if getattr(p, "tp_axis", None) is not None]
    total = sum(local) if local else None
    if sharded:
        part = sum(sq for sq, _ in sharded)
        dist.all_reduce(part, group=sharded[0][1].group)
        total = part if total is None else total + part
    return total
