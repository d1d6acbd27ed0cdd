"""Trainer: one epoch = rollout -> GAE -> PPO update, plus the host loop
(checkpointing, metrics, eval scheduling, the non-finite halt)
(counterpart of rvo3d_tpu/algo/trainer.py; reference train_process.py and
multi_ppo.training_loop).

The epoch runs eagerly on the trainer's device. The parameters and the
optimizer states are updated in place, so the rollback to the last finite
epoch keeps cloned snapshots of the parameters, both optimizer states and
the env carry (the JAX trainer's snapshot is free: its arrays are
immutable).
"""

from __future__ import annotations

import copy
import inspect
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from rvo3d_tpu_torch.algo.gae import gae_advantages
from rvo3d_tpu_torch.algo.ppo import (AgentData, PPOState, UpdateMetrics,
                                      make_optimizers, ppo_update)
from rvo3d_tpu_torch.algo.rollout import (EpisodeStats, RolloutCarry,
                                          init_rollout_carry, rollout_epoch)
from rvo3d_tpu_torch.config import Config
from rvo3d_tpu_torch.env.state import WorldSpec
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils.device import resolve_device

# on_phase(name, data): called at "rollout" (data None), "gae" (the
# RolloutBatch), "update" (the AgentData [T, E, N, ...]) and "end" (None)
PhaseHook = Callable[[str, Any], None]


class EpochOutput(NamedTuple):
    ppo_state: PPOState
    carry: RolloutCarry
    stats: EpisodeStats
    update_metrics: UpdateMetrics
    mean_reward: torch.Tensor


def make_train_epoch(ac: ActorCritic, world: WorldSpec, cfg: Config,
                     pi_opt, vf_opt, lane_worlds: Optional[WorldSpec] = None):
    """train_epoch(carry, generator, perm=None, offsets=None, on_phase=None)
    -> EpochOutput. `generator` (CPU) draws the agent order and minibatch
    offsets; `perm`/`offsets` inject them (see ppo_update). lane_worlds: an
    optional lane world (worlds/multi.py) that the rollout steps."""
    env_p, tr = cfg.env, cfg.train
    state = PPOState(ac, pi_opt, vf_opt)

    def train_epoch(carry: RolloutCarry, generator: torch.Generator,
                    perm=None, offsets=None,
                    on_phase: Optional[PhaseHook] = None) -> EpochOutput:
        hook = on_phase or (lambda name, data: None)
        hook("rollout", None)
        carry, batch = rollout_epoch(ac, world, env_p, tr, carry,
                                     lane_worlds=lane_worlds)
        hook("gae", batch)
        adv, ret = gae_advantages(batch.rew, batch.val, batch.cut[:, :, None],
                                  tr.gamma, tr.lam)
        data = AgentData(obs_self=batch.obs_self, obs_nbr=batch.obs_nbr,
                         obs_mask=batch.obs_mask, act=batch.act, adv=adv,
                         ret=ret, logp=batch.logp, val=batch.val)
        hook("update", data)
        upd = ppo_update(ac, tr, pi_opt, vf_opt, data, generator, perm, offsets)
        hook("end", None)
        stats = carry.stats
        carry = carry._replace(stats=EpisodeStats.zero(stats.count.shape[0],
                                                       stats.count.device))
        return EpochOutput(ppo_state=state, carry=carry, stats=stats,
                           update_metrics=upd, mean_reward=torch.mean(batch.rew))

    return train_epoch


def metrics_finite(metrics: Dict[str, Any]) -> bool:
    """True iff the epoch's learner-health scalars (mean step reward and
    the per-agent losses and KL) are all finite."""
    vals = [metrics["mean_step_reward"]]
    vals += (list(metrics["pi_loss"]) + list(metrics["v_loss"])
             + list(metrics["kl"]))
    return bool(np.all(np.isfinite(np.asarray(vals, dtype=np.float64))))


def _clone_generator(g: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


def _clone_carry(c: RolloutCarry) -> RolloutCarry:
    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, torch.Generator):
            return _clone_generator(x)
        return type(x)(*map(clone, x)) if hasattr(x, "_fields") else tuple(map(clone, x))
    return clone(c)


class Trainer:
    """End-to-end training driver (reference: train/train_process.py).

    Parameters come from ActorCritic's init with a generator seeded from
    cfg.train.seed (load others with `trainer.ac.load_state_dict`: the
    optimizers hold the same tensors). `phase_hook` (None by default) is
    passed to every epoch as its on_phase callback. lane_worlds: an
    optional lane world (leaves [num_envs, ...], worlds/multi.py) for
    multi-scenario training; `world` then gives only the static shapes."""

    def __init__(self, cfg: Config, world: WorldSpec,
                 lane_worlds: Optional[WorldSpec] = None, device="cuda"):
        if resolve_device(device).type != world.device.type:
            raise ValueError(f"world on {world.device}, trainer on {device}")
        if lane_worlds is not None and (lane_worlds.lanes != cfg.train.num_envs
                                        or lane_worlds.device != world.device):
            raise ValueError(f"lane_worlds must have num_envs={cfg.train.num_envs} "
                             f"lanes on {world.device}")
        self.device = world.device
        self.cfg = cfg
        self.world = world
        self.lane_worlds = lane_worlds
        seed = cfg.train.seed
        self.ac = ActorCritic(cfg.model, generator=torch.Generator().manual_seed(seed),
                              device=self.device)
        self.pi_opt, self.vf_opt = make_optimizers(cfg.train, self.ac)
        self.ppo_state = PPOState(self.ac, self.pi_opt, self.vf_opt)
        self.update_generator = torch.Generator().manual_seed(seed)
        self.carry = init_rollout_carry(
            world, cfg.env, cfg.train.num_envs,
            torch.Generator(device=self.device).manual_seed(seed + 1),
            lane_worlds=lane_worlds)
        self._train_epoch = make_train_epoch(self.ac, world, cfg, self.pi_opt,
                                             self.vf_opt, lane_worlds=lane_worlds)
        self.phase_hook: Optional[PhaseHook] = None

    def run_epoch(self) -> Dict[str, Any]:
        t0 = time.time()
        out = self._train_epoch(self.carry, self.update_generator,
                                on_phase=self.phase_hook)
        mean_reward = float(out.mean_reward)      # waits for the device
        dt = time.time() - t0
        self.carry = out.carry

        st = EpisodeStats(*[x.cpu().numpy() for x in out.stats])
        um = UpdateMetrics(*[x.cpu().numpy() for x in out.update_metrics])
        count = st.count
        tr = self.cfg.train
        metrics = {
            "epoch_time_s": dt,
            "env_steps": tr.steps_per_epoch * tr.num_envs,
            "steps_per_sec": tr.steps_per_epoch * tr.num_envs / dt,
            "mean_step_reward": mean_reward,
            "episodes": count.tolist(),
            "ep_ret_mean": np.where(count > 0, st.ret_sum / np.maximum(count, 1),
                                    0.0).tolist(),
            "ep_ret_min": np.where(count > 0, st.ret_min, 0.0).tolist(),
            "ep_ret_max": np.where(count > 0, st.ret_max, 0.0).tolist(),
            "success_episodes": st.finish_count.tolist(),
            "collision_episodes": st.collision_count.tolist(),
            "pi_loss": um.pi_loss.tolist(),
            "v_loss": um.v_loss.tolist(),
            "kl": um.kl.tolist(),
            "pi_iters": um.pi_iters.tolist(),
        }
        # an agent whose first-iteration KL already exceeds target_kl loses
        # its whole policy update: surface it
        stalled = int(np.sum(um.pi_iters == 0))
        if stalled:
            metrics["pi_stalled_agents"] = stalled
        return metrics

    def snapshot(self):
        """Clones of the parameters, both optimizer states and the carry."""
        return ({k: v.clone() for k, v in self.ac.state_dict().items()},
                copy.deepcopy(self.pi_opt.state_dict()),
                copy.deepcopy(self.vf_opt.state_dict()),
                _clone_carry(self.carry))

    def restore(self, snap) -> None:
        params, pi_state, vf_state, carry = snap
        self.ac.load_state_dict(params)
        self.pi_opt.load_state_dict(pi_state)
        self.vf_opt.load_state_dict(vf_state)
        self.carry = carry

    def train(self, epochs: Optional[int] = None, log_fn=print,
              checkpoint_fn=None, eval_fn=None,
              eval_every: Optional[int] = None) -> None:
        """checkpoint_fn(epoch, ppo_state) runs every save_freq epochs and
        at the last; eval_fn(epoch, ppo_state[, saved=...]) after every
        saved epoch and every eval_every epochs. A non-finite epoch rolls
        back to the last finite one, saves a rescue checkpoint under that
        epoch's index, scores it, and stops."""
        takes_saved = eval_fn is not None and (
            "saved" in inspect.signature(eval_fn).parameters)

        def run_eval(epoch, saved):
            if takes_saved:
                eval_fn(epoch, self.ppo_state, saved=saved)
            else:
                eval_fn(epoch, self.ppo_state)

        epochs = epochs if epochs is not None else self.cfg.train.train_epoch
        last_good = (-1, self.snapshot())
        for epoch in range(epochs + 1):
            metrics = self.run_epoch()
            metrics["epoch"] = epoch
            if not metrics_finite(metrics):
                metrics["non_finite_halt"] = True
                log_fn(metrics)
                good_epoch, snap = last_good
                self.restore(snap)
                if checkpoint_fn:
                    checkpoint_fn(max(good_epoch, 0), self.ppo_state)
                log_fn({
                    "epoch": epoch, "halted": "non-finite metrics",
                    "restored_to_epoch": good_epoch,
                    "rescue_checkpoint_saved": checkpoint_fn is not None,
                })
                if eval_fn:
                    run_eval(max(good_epoch, 0), checkpoint_fn is not None)
                return
            last_good = (epoch, self.snapshot())
            log_fn(metrics)
            saved = bool(checkpoint_fn) and (
                epoch % self.cfg.train.save_freq == 0 or epoch == epochs)
            if saved:
                checkpoint_fn(epoch, self.ppo_state)
            if eval_fn and (saved or (eval_every and (
                    epoch % eval_every == 0 or epoch == epochs))):
                run_eval(epoch, saved)
