"""Policy serving: batched actions from a policy on the card
(counterpart of rvo3d_tpu/serving.py; reference post_train.load_policy).

Deterministic mode returns the policy mean; stochastic mode samples with
the evaluator's std_factor from an explicit torch.Generator.

On a card each batch shape is served by its own CUDA graph (the
counterpart of the JAX server's jit per shape): the policy's forward is
captured once over static input buffers (utils/graphs.py), a request is
copied in, the graph replayed and the action copied out. A stochastic
request's standard normals are drawn from the caller's generator outside
the graph, with the call ActorCritic.step makes, so the action equals the
eager forward's. The graphs read the policy's parameters in place: load
new weights with `ac.load_state_dict`, which copies into them. Each graph
keeps its own memory pool (the forward's activations at that batch), so
at most MAX_GRAPHS batch shapes keep one: the least recently served shape
loses its graph, and is warmed up and captured anew if it comes back.

While the recorder is on (utils/profiler.py) a request is the span
`serve.act` (attributes `batch`, `request`) over `serve.inputs` (the host
tensors), `serve.lookup` (the graph's key and the LRU), the loop's
`serve.copy_in`, `serve.replay` (its device time as `device_ms`) and
`serve.copy_out`, and the server's `serve.copy_out` (the action to
numpy); `serve.capture` and `serve.evict` carry the shape they capture or
drop.
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch

from rvo3d_tpu_torch.config import ModelConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils import graphs, profiler
from rvo3d_tpu_torch.utils.convert import flax_to_state_dict

MAX_GRAPHS = 8      # batch shapes (and modes) that keep a CUDA graph


class PolicyServer:
    """act(obs_self [B,12], obs_nbr [B,nm,9], obs_mask [B,nm]) -> [B, 3]
    act_flat(obs [B, 12 + 9*k]) -> [B, 3] (the reference's flat layout)
    from_checkpoint(path)      — the port's own checkpoint (see save)
    from_torch(run_dir, epoch) — a training run's <ckpt>/<epoch>/state.pt
    from_numpy_params(params)  — the JAX package's params as numpy arrays
    """

    def __init__(self, ac: ActorCritic, nm: int = 10, std_factor: float = 1e-3,
                 deterministic: bool = True):
        self.ac = ac.eval()
        self.nm = nm
        self.std_factor = std_factor
        self.deterministic = deterministic
        self.device = next(ac.parameters()).device
        self._graphs: "OrderedDict[tuple, graphs.GraphedLoop]" = OrderedDict()
        self.requests = 0       # act calls so far: the id of a request's spans

    @classmethod
    def from_numpy_params(cls, params: Dict[str, Any],
                          cfg: ModelConfig = ModelConfig(), *,
                          device="cuda", **kw) -> "PolicyServer":
        ac = ActorCritic(cfg, device=device)
        ac.load_state_dict(flax_to_state_dict(params))
        return cls(ac, **kw)

    @classmethod
    def from_checkpoint(cls, path: str, *, device="cuda", **kw) -> "PolicyServer":
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        model = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in ckpt["model"].items()}
        ac = ActorCritic(ModelConfig(**model), device=device)
        ac.load_state_dict(ckpt["state_dict"])
        return cls(ac, nm=int(ckpt["nm"]), **kw)

    @classmethod
    def from_torch(cls, run_dir: str, epoch: Optional[int] = None, *,
                   device="cuda", **kw) -> "PolicyServer":
        """The policy of a training run: `run_dir` holds ckpt/ (or is the
        ckpt directory); `epoch` None loads the latest. The run's Config
        is `server.config`, the loaded epoch `server.epoch`."""
        from rvo3d_tpu_torch.algo.ppo import PPOState
        from rvo3d_tpu_torch.utils.checkpoint import load_config, restore_checkpoint

        ckpt = run_dir if os.path.basename(os.path.normpath(run_dir)) == "ckpt" \
            else os.path.join(run_dir, "ckpt")
        cfg = load_config(ckpt)
        ac = ActorCritic(cfg.model, device=device)
        _, epoch = restore_checkpoint(ckpt, PPOState(ac, None, None), epoch,
                                      params_only=True)
        server = cls(ac, nm=cfg.env.neighbor_num, std_factor=cfg.train.std_factor_eval,
                     **kw)
        server.config, server.epoch = cfg, epoch
        return server

    def save(self, path: str) -> None:
        torch.save({"model": dataclasses.asdict(self.ac.cfg), "nm": self.nm,
                    "state_dict": {k: v.detach().cpu()
                                   for k, v in self.ac.state_dict().items()}},
                   path)

    @torch.no_grad()
    def policy(self, obs_self, obs_nbr, obs_mask, eps=None) -> torch.Tensor:
        """The eager forward on device tensors: the mean, or with `eps`
        (standard normals [..., 3]) the sample mu + std * eps."""
        if eps is None:
            return self.ac(obs_self, obs_nbr, obs_mask)[0]
        return self.ac.step(obs_self, obs_nbr, obs_mask, self.std_factor, eps=eps).action

    def _graphed(self, inputs) -> torch.Tensor:
        """policy(*inputs) through the graph of this shape and mode (made
        on first use, the least recently used one dropped past
        MAX_GRAPHS)."""
        with profiler.span("serve.lookup"):
            key = tuple(tuple(x.shape) for x in inputs) + (self.std_factor,)
            loop = self._graphs.pop(key, None)
            if loop is None:
                loop = graphs.GraphedLoop(lambda a, x, t: (self.policy(*x), None),
                                          self.device, draw=lambda a, request: request,
                                          name="serve", timed=True,
                                          capture_attrs={"shape": key})
                carry = torch.empty(inputs[0].shape[:-1] + (self.ac.act_dim,),
                                    dtype=torch.float32, device=self.device)
            else:
                carry = None                       # the action buffer, overwritten
            self._graphs[key] = loop
            while len(self._graphs) > MAX_GRAPHS:
                old = next(iter(self._graphs))
                with profiler.span("serve.evict", shape=old):
                    del self._graphs[old]
        return loop(carry, 1, tuple(inputs))[0]

    @torch.no_grad()
    def act(self, obs_self, obs_nbr, obs_mask,
            generator: Optional[torch.Generator] = None) -> np.ndarray:
        self.requests += 1
        with profiler.span("serve.act", batch=len(obs_self), request=self.requests):
            with profiler.span("serve.inputs"):
                inputs = [torch.as_tensor(obs_self, dtype=torch.float32),
                          torch.as_tensor(obs_nbr, dtype=torch.float32),
                          torch.as_tensor(obs_mask, dtype=torch.bool)]
                if not self.deterministic:
                    if generator is None:
                        raise ValueError("stochastic serving needs a generator")
                    # ActorCritic.step's draw
                    inputs.append(torch.randn(inputs[0].shape[:-1] + (self.ac.act_dim,),
                                              generator=generator, dtype=torch.float32,
                                              device=self.device))
            if graphs.on_card(self.device):
                a = self._graphed(inputs)
            else:
                a = self.policy(*[x.to(self.device) for x in inputs])
            with profiler.span("serve.copy_out"):
                return a.cpu().numpy()

    def act_flat(self, obs, generator: Optional[torch.Generator] = None
                 ) -> np.ndarray:
        """obs [B, 12 + 9*k]: k neighbour blocks, all-zero blocks are padding."""
        obs = np.asarray(obs, np.float32)
        b = obs.shape[0]
        rest = obs[:, 12:]
        k = rest.shape[1] // 9
        nbr = np.zeros((b, self.nm, 9), np.float32)
        mask = np.zeros((b, self.nm), bool)
        if k > 0:
            blocks = rest.reshape(b, k, 9)
            nbr[:, self.nm - k:] = blocks
            mask[:, self.nm - k:] = ~np.all(blocks == 0, axis=-1)
        return self.act(obs[:, :12], nbr, mask, generator)
