"""Conflict-state approximation-error diagnostic (counterpart of
scripts/conflict_diag.py): the instrument for judging the
conflict-weighted-BC lever (--bc_conflict_weight).

Load a trained run's checkpoint, roll the clone's own mean policy on the
control-noise channel (the noisy eval's noise, drone.py:79-82,163-165),
relabel every visited state with the run's expert (rvo, with the margin
and slowdown given), and split the rows by conflict flag (any VO
neighbour flagged in the observation mask):

  - frac_conflict              share of visited states that are conflicts
  - rms_err_{conflict,cruise}  per-component RMS of (clone mean - expert)
  - rms_label_conflict         per-component RMS of the expert's own
                               commands at conflict states (the dodge
                               signal's size)

A clone whose rms_err_conflict >= rms_label_conflict cannot express the
dodge; driving that ratio below ~1 is the point of --bc_conflict_weight.

    python -m rvo3d_tpu_torch.diag.conflict_diag RUN_DIR WORLD [--ckpt_epoch N]
        [--margin M] [--slowdown] [--steps T] [--envs E] [--seed S] [--out PATH]
        [--device cuda]

RUN_DIR is a run of the port's `cli train` (config.json, ckpt/<epoch>/
state.pt). Writes runs_torch/bc_evals/conflict_diag_<run>_<epoch>.json.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from rvo3d_tpu_torch.algo.bc import Randn, collect_demos
from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.utils.device import resolve_device


def _rms(x: np.ndarray, m: np.ndarray):
    if not m.any():
        return [float("nan")] * x.shape[1]
    return [float(v) for v in np.sqrt(np.mean(x[m] ** 2, axis=0)).round(4)]


def conflict_report(run_dir: str, world_name: str, *, ckpt_epoch: Optional[int] = None,
                    margin: Optional[float] = None, slowdown: bool = False,
                    steps: int = 400, envs: int = 16, seed: int = 3, device="cuda",
                    randn: Optional[Randn] = None) -> dict:
    """The report of scripts/conflict_diag.py:97-111, with the same keys.
    `randn` replaces the control-noise draws (tests inject the JAX ones)."""
    from rvo3d_tpu_torch.algo.trainer import Trainer
    from rvo3d_tpu_torch.utils.checkpoint import load_config, restore_checkpoint
    from rvo3d_tpu_torch.worlds import load_world

    dev = resolve_device(device)
    wd = load_world(world_name)
    world = wd.spec(device=dev)
    cfg = load_config(run_dir)
    p = EnvParams(num_drones=wd.drone_num)
    trainer = Trainer(cfg, world, device=dev)
    _, epoch = restore_checkpoint(os.path.join(run_dir, "ckpt"), trainer.ppo_state,
                                  epoch=ckpt_epoch, params_only=True)
    ac = trainer.ac
    print(f"diagnosing {run_dir} @ epoch {epoch} "
          f"(action_mode={cfg.train.action_mode})", flush=True)

    def behavior_fn(obs_self, obs_nbr, obs_mask):
        return ac(obs_self, obs_nbr, obs_mask)[0]

    # clone-driven rollout on the control-noise channel; the expert relabels
    obs_self, obs_nbr, obs_mask, target = collect_demos(
        world, p, envs, steps, torch.Generator(device=dev).manual_seed(seed),
        expert="rvo", action_mode=cfg.train.action_mode, expert_margin=margin,
        behavior_fn=behavior_fn, expert_slowdown=slowdown, env_noise=True, randn=randn)
    with torch.no_grad():
        mu = ac(obs_self, obs_nbr, obs_mask)[0]
    mu, target = mu.cpu().numpy(), target.cpu().numpy()
    conflict = torch.any(obs_mask, -1).cpu().numpy()
    err = mu - target
    return {
        "run_dir": run_dir,
        "epoch": int(epoch),
        "world": world_name,
        "expert_margin": margin,
        "expert_slowdown": bool(slowdown),
        "states": int(conflict.size),
        "frac_conflict": round(float(conflict.mean()), 5),
        "rms_err_conflict": _rms(err, conflict),
        "rms_err_cruise": _rms(err, ~conflict),
        "rms_label_conflict": _rms(target, conflict),
        "rms_err_conflict_all": round(
            float(np.sqrt(np.mean(err[conflict] ** 2))) if conflict.any()
            else float("nan"), 4),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir")
    ap.add_argument("world")
    ap.add_argument("--ckpt_epoch", type=int, default=None)
    ap.add_argument("--margin", type=float, default=None)
    ap.add_argument("--slowdown", action="store_true")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--envs", type=int, default=16)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report = conflict_report(args.run_dir, args.world, ckpt_epoch=args.ckpt_epoch,
                             margin=args.margin, slowdown=args.slowdown,
                             steps=args.steps, envs=args.envs, seed=args.seed,
                             device=args.device)
    out = args.out or os.path.join(
        "runs_torch", "bc_evals",
        f"conflict_diag_{os.path.basename(args.run_dir.rstrip('/'))}"
        f"_{report['epoch']}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1), flush=True)
    print(f"-> {out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
