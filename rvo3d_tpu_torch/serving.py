"""Policy serving: batched actions from a policy on the card
(counterpart of rvo3d_tpu/serving.py; reference post_train.load_policy).

Deterministic mode returns the policy mean; stochastic mode samples with
the evaluator's std_factor from an explicit torch.Generator.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from rvo3d_tpu_torch.config import ModelConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils.convert import flax_to_state_dict


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

    def _t(self, x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    @torch.no_grad()
    def act(self, obs_self, obs_nbr, obs_mask,
            generator: Optional[torch.Generator] = None) -> np.ndarray:
        obs_self, obs_nbr = self._t(obs_self), self._t(obs_nbr)
        obs_mask = self._t(obs_mask, torch.bool)
        if self.deterministic:
            a = self.ac(obs_self, obs_nbr, obs_mask)[0]
        else:
            if generator is None:
                raise ValueError("stochastic serving needs a generator")
            a = self.ac.step(obs_self, obs_nbr, obs_mask, self.std_factor,
                             generator).action
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
