"""Gaussian actor and critic over the shared neighbour encoder
(counterpart of rvo3d_tpu/models/actor_critic.py).

  - actor MLP (256, 256), ReLU hidden, tanh output -> mu
  - log_std a free parameter; std = clamp(std_factor*exp(log_std) + 1e-6,
    1e-4, 10); logp summed over the action axis
  - critic MLP (256, 256) -> scalar value
Dense layers use torch's nn.Linear default bounds, uniform +-1/sqrt(fan_in)
for weight and bias, drawn from an explicit torch.Generator.

ModelConfig.param_dtype and compute_dtype ('float32' or 'bfloat16') act as
in flax: the recurrent and dense weights are stored in the parameter dtype
(drawn in float32, then cast), LayerNorm and log_std stay float32, every
matmul runs in the compute dtype, and mu, std and v come back float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rvo3d_tpu_torch.config import ModelConfig
from rvo3d_tpu_torch.models.encoder import NeighborEncoder
from rvo3d_tpu_torch.parallel.tensor_parallel import copy_to_model, reduce_from_model
from rvo3d_tpu_torch.utils.device import resolve_device

LOG_2PI = 1.8378770664093453
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TorchDense(nn.Linear):
    """nn.Linear initialized from an explicit generator."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if generator is None:  # nn.Linear.__init__ calls this with no generator
            return
        bound = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)


class MLP(nn.Module):
    """ReLU-hidden MLP with an identity or tanh output. Under tensor
    parallelism (`tp`, set by parallel/tensor_parallel.shard_params_tp)
    layer 0 holds this rank's output columns and layer 1 the matching
    input rows (Megatron column -> row)."""

    tp = None   # the ModelAxis of a sharded MLP

    def __init__(self, in_dim: int, sizes: Sequence[int],
                 output_activation: str = "identity",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [in_dim] + list(sizes)
        self.layers = nn.ModuleList(TorchDense(a, b) for a, b in zip(dims, dims[1:]))
        self.output_activation = output_activation
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, x):
        cdt = self.compute_dtype
        x = x.to(cdt)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            w, b = layer.weight.to(cdt), layer.bias.to(cdt)
            if self.tp is not None and i == 0:
                x = F.linear(copy_to_model(x, self.tp), w, b)
            elif self.tp is not None and i == 1:
                x = reduce_from_model(F.linear(x, w), self.tp) + b
            else:
                x = F.linear(x, w, b)
            if i < last:
                x = torch.relu(x)
            elif self.output_activation == "tanh":
                x = torch.tanh(x)
        return x


class PolicyStep(NamedTuple):
    action: torch.Tensor
    value: torch.Tensor
    logp: torch.Tensor
    mu: torch.Tensor
    std: torch.Tensor


class ActorCritic(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig(), act_dim: int = 3, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        pdt, cdt = (DTYPES.get(name) for name in (cfg.param_dtype, cfg.compute_dtype))
        if pdt is None or cdt is None:
            raise ValueError(f"param_dtype {cfg.param_dtype!r} / compute_dtype "
                             f"{cfg.compute_dtype!r}: each is one of {sorted(DTYPES)}")
        self.cfg = cfg
        self.act_dim = act_dim
        self.encoder = NeighborEncoder(cfg.state_dim, cfg.rnn_input_dim,
                                       cfg.rnn_hidden_dim, cfg.rnn_mode, cdt)
        feat = cfg.state_dim + cfg.rnn_hidden_dim
        self.actor = MLP(feat, tuple(cfg.hidden_sizes_ac) + (act_dim,), "tanh", cdt)
        self.critic = MLP(feat, tuple(cfg.hidden_sizes_v) + (1,), "identity", cdt)
        self.log_std = nn.Parameter(torch.full((act_dim,), float(cfg.log_std_init)))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.encoder.reset_parameters(generator)
        self.actor.reset_parameters(generator)
        self.critic.reset_parameters(generator)
        for m in (self.encoder.fwd, getattr(self.encoder, "bwd", None),
                  self.actor, self.critic):
            if m is not None:
                m.to(pdt)
        self.to(resolve_device(device))

    def _std(self, std_factor: float):
        return torch.clamp(std_factor * torch.exp(self.log_std) + 1e-6, 1e-4, 10.0)

    def forward(self, obs_self, obs_nbr, obs_mask, std_factor: float = 1.0):
        """(mu, std, value) for one batch of observations, float32 whatever
        the observations' and the compute dtype."""
        feat = self.encoder(obs_self, obs_nbr, obs_mask)
        mu = self.actor(feat).float()
        v = self.critic(feat).squeeze(-1).float()
        return mu, self._std(std_factor), v

    def step(self, obs_self, obs_nbr, obs_mask, std_factor: float = 1.0,
             generator=None, eps=None) -> PolicyStep:
        """Sample an action with its value and logp: mu + std * eps, with
        eps the given standard normals or drawn from `generator`."""
        mu, std, v = self(obs_self, obs_nbr, obs_mask, std_factor)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                              device=mu.device)
        a = mu + std * eps
        return PolicyStep(action=a, value=v, logp=self.logp_of(mu, std, a),
                          mu=mu, std=std)

    def logp(self, obs_self, obs_nbr, obs_mask, act, std_factor: float = 1.0):
        mu, std, _ = self(obs_self, obs_nbr, obs_mask, std_factor)
        return self.logp_of(mu, std, act)

    def value(self, obs_self, obs_nbr, obs_mask):
        return self.critic(self.encoder(obs_self, obs_nbr, obs_mask)).squeeze(-1).float()

    def entropy(self, std_factor: float = 1.0):
        return torch.sum(0.5 + 0.5 * LOG_2PI + torch.log(self._std(std_factor)), -1)

    @staticmethod
    def logp_of(mu, std, act):
        z = (act - mu) / std
        return torch.sum(-0.5 * z * z - torch.log(std) - 0.5 * LOG_2PI, dim=-1)
