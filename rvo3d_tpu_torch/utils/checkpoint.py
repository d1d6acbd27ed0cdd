"""Training checkpoints in the port's own format (counterpart of
rvo3d_tpu/utils/checkpoint.py, which writes Orbax):

  <directory>/<epoch>/state.pt : {"epoch", "params" (the ActorCritic
                                  state_dict), "pi_opt", "vf_opt" (the two
                                  Adams' state_dicts)}
  <directory>/config.json      : the run's Config, loadable by both packages
  <run_dir>/best_checkpoint.json : the persisted epoch with the best worst-
                                   population success (BestCheckpoint)

Every saved epoch is kept. Resume restores the parameters and both
optimizer states, or the parameters alone (`params_only`, for a run whose
optimizer masks differ from the checkpoint's). Under tensor parallelism
every rank calls save_checkpoint: the shards of the parameters and of their
Adam moments are gathered, and rank 0 writes them in the one-process
format, so the checkpoint loads into an unsharded ActorCritic.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch

from rvo3d_tpu_torch.algo.ppo import PPOState
from rvo3d_tpu_torch.config import Config, from_dict, to_dict
from rvo3d_tpu_torch.parallel.multihost import is_coordinator
from rvo3d_tpu_torch.parallel.tensor_parallel import (full_optimizer_state_dict,
                                                      full_state_dict)

STATE_FILE = "state.pt"


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_cpu(v) for v in obj]
    return obj


def saved_epochs(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.exists(os.path.join(directory, d, STATE_FILE)))


def save_checkpoint(directory: str, epoch: int, ppo_state: PPOState,
                    cfg: Config) -> str:
    """Write <directory>/<epoch>/state.pt and <directory>/config.json on
    the coordinator (every rank gathers its shards; see the module's
    docstring); returns the state file's path."""
    step_dir = os.path.join(directory, str(int(epoch)))
    path = os.path.join(step_dir, STATE_FILE)
    payload = {"epoch": int(epoch),
               "params": _cpu(full_state_dict(ppo_state.ac)),
               "pi_opt": _cpu(full_optimizer_state_dict(ppo_state.pi_opt)),
               "vf_opt": _cpu(full_optimizer_state_dict(ppo_state.vf_opt))}
    if not is_coordinator():
        return path
    os.makedirs(step_dir, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(to_dict(cfg), f, indent=2)
    return path


def restore_checkpoint(directory: str, ppo_state: PPOState,
                       epoch: Optional[int] = None,
                       params_only: bool = False) -> Tuple[PPOState, int]:
    """Load a saved epoch (the latest if None) into `ppo_state` in place;
    returns (ppo_state, epoch). params_only keeps the optimizers' state."""
    if epoch is None:
        epochs = saved_epochs(directory)
        if not epochs:
            raise FileNotFoundError(f"no checkpoint under {directory}")
        epoch = epochs[-1]
    payload = torch.load(os.path.join(directory, str(int(epoch)), STATE_FILE),
                         map_location="cpu", weights_only=True)
    ppo_state.ac.load_state_dict(payload["params"])
    if not params_only:
        ppo_state.pi_opt.load_state_dict(payload["pi_opt"])
        ppo_state.vf_opt.load_state_dict(payload["vf_opt"])
    return ppo_state, int(payload["epoch"])


def load_config(directory: str) -> Config:
    with open(os.path.join(directory, "config.json")) as f:
        return from_dict(json.load(f))


class BestCheckpoint:
    """Tracks which persisted epoch scored best and rewrites
    <run_dir>/best_checkpoint.json after every evaluation, in the JAX
    CLI's format. A multi-population checkpoint is as good as its worst
    population; only persisted epochs may become best (an eval-only epoch
    has no checkpoint to restore)."""

    FILE = "best_checkpoint.json"

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self.epoch: Optional[int] = None
        self.success = -1.0

    def update(self, epoch: int, min_success: float, saved: bool = True) -> None:
        if saved and min_success > self.success:
            self.epoch, self.success = epoch, min_success
        record = {"epoch": self.epoch, "min_success_rate": self.success,
                  "hint": f"cli eval --checkpoint {self.run_dir} "
                          f"--ckpt_epoch {self.epoch}"}
        with open(os.path.join(self.run_dir, self.FILE), "w") as f:
            json.dump(record, f, indent=1)
