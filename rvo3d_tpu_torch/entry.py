"""The graft entry points (counterpart of __graft_entry__.py).

entry(device)          -> (module, example_args): the flagship policy
                          (biGRU-256 actor-critic) and one batch for its
                          forward, B = 256 rows with all 10 neighbour slots on
dryrun_multichip(n)    -> one training epoch (rollout, GAE, PPO update) of
                          the flagship world sharded over a (data, model) mesh
                          of n ranks: env lanes over `data`, the MLP and GRU
                          weights over `model` (tensor parallelism)

    python -m rvo3d_tpu_torch.entry [full] [--ranks 4] [--device cuda]

runs entry's forward, then dryrun_multichip(--ranks, full_size="full" given).

JAX puts n virtual devices in one process; here the mesh is n processes,
started by dryrun_multichip on this host (parallel/multihost.start_ranks):
gloo ranks sharing the one card, or the CPU. With full_size the same epoch
runs unsharded in the calling process, and the two are held together: the
metrics agree at rtol = atol = 1e-3, as in the JAX file, unless the
rollouts part; the rollouts are equal up to their first differing action,
which must be a 0.01 rounding tie (tensor-parallel partial sums round
differently from one product); and the sharded parameters equal the
one-process update on the ranks' own batch within 1e-5 (tie_rule). The
artifact says what held, and goes to runs_torch/multichip_full.json (the
root multichip_full.json is the TPU's).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import platform
import sys
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from rvo3d_tpu_torch.config import Config, EnvParams, ModelConfig, TrainConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils.device import resolve_device

B, NM = 256, 10
SEED = 0
TOL = 1e-3                  # the JAX file's sharded-vs-unsharded tolerance
PARAM_TOL = 1e-5            # sharded params against the one-process update
COMPARED = ("mean_step_reward", "pi_loss", "v_loss")
RANK_TIMEOUT_S = 900
ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "runs_torch", "multichip_full.json")


def entry(device="cuda") -> Tuple[ActorCritic, Tuple[torch.Tensor, ...]]:
    """The flagship policy (ModelConfig(): biGRU-256, (256, 256) heads)
    drawn from SEED, and (obs_self [B, 12], obs_nbr [B, NM, 9], obs_mask
    [B, NM] all True): module(*args) -> (mu, std, v)."""
    dev = resolve_device(device)
    cfg = ModelConfig()
    ac = ActorCritic(cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    g = torch.Generator().manual_seed(SEED)
    obs_self = torch.randn((B, cfg.state_dim), generator=g).to(dev)
    obs_nbr = torch.randn((B, NM, cfg.rnn_input_dim), generator=g).to(dev)
    obs_mask = torch.ones((B, NM), dtype=torch.bool, device=dev)
    return ac, (obs_self, obs_nbr, obs_mask)


def mesh_shape(n_devices: int) -> Tuple[int, int]:
    """(data, model): model 2 when n is even, as the JAX file lays it out."""
    model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    return n_devices // model, model


def dryrun_config(n_devices: int, full_size: bool) -> Config:
    data, _ = mesh_shape(n_devices)
    env = EnvParams(num_drones=8)
    if full_size:
        # the flagship shapes; minibatch bounds the update's working set
        return Config(env=env, model=ModelConfig(),
                      train=TrainConfig(steps_per_epoch=100, train_pi_iters=5,
                                        train_v_iters=5, num_envs=256, max_ep_len=150,
                                        minibatch=8192))
    # tiny shapes: 2 lanes per data rank, T = 4, a small net
    return Config(env=env,
                  model=ModelConfig(rnn_hidden_dim=32, hidden_sizes_ac=(32, 32),
                                    hidden_sizes_v=(32, 32)),
                  train=TrainConfig(steps_per_epoch=4, train_pi_iters=2, train_v_iters=2,
                                    num_envs=2 * data, max_ep_len=50))


def _trainer(cfg: Config, dev: torch.device, mesh=None):
    """A fresh Trainer on the flagship world (deterministic from
    cfg.train.seed); over `mesh`, its weights sharded over the model axis."""
    from rvo3d_tpu_torch.algo.trainer import Trainer
    from rvo3d_tpu_torch.bench.core import world_spec
    from rvo3d_tpu_torch.bench.flagship import flagship_world
    from rvo3d_tpu_torch.parallel.tensor_parallel import shard_params_tp

    trainer = Trainer(cfg, world_spec(flagship_world(), dev), device=dev, mesh=mesh)
    if mesh is not None:
        shard_params_tp(trainer.ppo_state, mesh)
    return trainer


def _run_epoch(trainer) -> dict:
    """One epoch: its metrics, the (gathered) rollout batch the update saw,
    the whole parameters after it, and the masked-GRU kernel's launches."""
    from rvo3d_tpu_torch.ops import masked_gru as mg
    from rvo3d_tpu_torch.parallel.tensor_parallel import full_state_dict

    seen = {}

    def hook(name, data):
        if name == "gae":
            seen["batch"] = {k: v.detach().cpu() for k, v in data._asdict().items()}
    trainer.phase_hook = hook
    l0 = mg.launches
    metrics = trainer.run_epoch()
    return {"metrics": metrics, "batch": seen["batch"], "launches": mg.launches - l0,
            "params": {k: v.detach().cpu() for k, v in full_state_dict(trainer.ac).items()}}


def _rank_main(out_dir: str) -> int:
    """One rank of dryrun_multichip (started with the RVO3D_* variables):
    the sharded epoch, recorded to <out_dir>/rank<r>.pt."""
    import torch.distributed as dist

    from rvo3d_tpu_torch.parallel import distributed_init_from_env, make_mesh
    from rvo3d_tpu_torch.parallel.multihost import rank_device

    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    dev = resolve_device(spec["device"])
    if not distributed_init_from_env(dev):
        raise SystemExit("--rank-worker needs the RVO3D_* variables")
    dev = rank_device(dev)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    n = dist.get_world_size()
    data, model = mesh_shape(n)
    mesh = make_mesh(data=data, model=model)
    rec = _run_epoch(_trainer(dryrun_config(n, spec["full_size"]), dev, mesh))
    rec["backend"] = dist.get_backend()
    if dist.get_rank():       # every rank gathers the same batch and params
        del rec["batch"], rec["params"]
    torch.save(rec, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def rollout_parting(batch: dict, ref: dict) -> Tuple[Optional[int], bool]:
    """(the first step at which an action of the two rollouts differs, or
    None; whether every difference at that step is one 0.01 rounding step,
    a tie of the 2-decimal rounding broken the other way)."""
    d_act = (batch["act"] - ref["act"]).abs().flatten(1).amax(1)           # [T]
    parted = torch.nonzero(d_act > 0).flatten()
    if not len(parted):
        return None, True
    t0 = int(parted[0])
    da = (batch["act"][t0] - ref["act"][t0]).abs()
    return t0, bool(((da == 0) | ((da - 0.01).abs() < 1e-5)).all())


def update_on_batch(start_state: dict, cfg: Config, batch: dict, dev: torch.device,
                    opt_states=None):
    """The one-process PPO update of one epoch on a (gathered) rollout batch
    from `start_state`, with fresh optimizers (or, given `opt_states`, the
    two optimizers' whole state dicts loaded: a trainer's later epoch) and
    the update generator seeded as Trainer seeds it: (the params after it,
    on the CPU; the update's result)."""
    from rvo3d_tpu_torch.algo.ppo import PPOUpdate, make_optimizers
    from rvo3d_tpu_torch.algo.rollout import RolloutBatch

    tr = cfg.train
    ac = ActorCritic(cfg.model, device=dev)
    ac.load_state_dict(start_state)
    pi_opt, vf_opt = make_optimizers(tr, ac)
    for opt, state in zip((pi_opt, vf_opt), opt_states or ()):
        opt.load_state_dict(copy.deepcopy(state))     # loading shares the tensors
    learner = PPOUpdate(ac, tr, pi_opt, vf_opt)       # GAE and the update, as a trainer's
    learner.prepare(RolloutBatch(**{k: v.to(dev) for k, v in batch.items()}))
    upd = learner.update(torch.Generator().manual_seed(tr.seed))
    return {k: v.detach().cpu() for k, v in ac.state_dict().items()}, upd


def tie_rule(batch: dict, params: dict, ref: dict, start_state: dict, cfg: Config,
             dev: torch.device, opt_states=None) -> dict:
    """The rule for sharded ranks held against one process (the
    tensor-parallel check): the ranks' rollout `batch` equals the
    one-process batch `ref` up to the first step where an action differs
    (val and logp aside), every difference there is one 0.01 rounding step,
    and the ranks' final `params` equal the one-process update from
    `start_state` (and `opt_states`, see update_on_batch) on the ranks' own
    batch within PARAM_TOL. Raises AssertionError otherwise; returns what
    was found."""
    t0, tie = rollout_parting(batch, ref)
    upto = batch["act"].shape[0] if t0 is None else t0
    for k in ref:
        if k not in ("val", "logp") and not torch.equal(batch[k][:upto], ref[k][:upto]):
            raise AssertionError(f"tie rule: rollout {k} differs before step {upto}")
    if not tie:
        raise AssertionError(f"tie rule: the first action difference (step {t0}) is not "
                             f"a 0.01 rounding tie")
    one, upd = update_on_batch(start_state, cfg, batch, dev, opt_states)
    err = max((params[k].double() - v.double()).abs().max().item() for k, v in one.items())
    if not err <= PARAM_TOL:
        raise AssertionError(f"tie rule: the ranks' params differ from the one-process "
                             f"update on the same batch by {err} > {PARAM_TOL}")
    return {"first_action_difference_step": t0, "first_difference_is_tie": tie,
            "params_max_abs_diff_same_batch": err, "param_tol": PARAM_TOL,
            "one_update": {"pi_loss": upd.pi_loss.tolist(), "v_loss": upd.v_loss.tolist(),
                           "kl": upd.kl.tolist(), "pi_iters": upd.pi_iters.tolist()}}


def dryrun_multichip(n_devices: int, full_size: bool = False, device="cuda") -> dict:
    """One sharded train epoch over n_devices ranks on this host, asserted
    finite; with full_size (the flagship shapes: biGRU-256, (256, 256)
    heads, 256 lanes, T = 100, 5 / 5 iterations, minibatch 8192) the same
    epoch unsharded too, held together as the module's docstring says, and
    the artifact written. Returns the summary (the artifact's keys, plus
    each rank's kernel launches; `artifact` is None for the tiny run)."""
    from rvo3d_tpu_torch.parallel.multihost import start_ranks

    dev = resolve_device(device)
    data, model = mesh_shape(n_devices)
    cfg = dryrun_config(n_devices, full_size)
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump({"device": dev.type, "full_size": full_size}, f)
        start_ranks(["-m", "rvo3d_tpu_torch.entry", "--rank-worker", tmp], n_devices,
                    RANK_TIMEOUT_S)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(n_devices)]
    metrics = ranks[0]["metrics"]
    if not np.isfinite(metrics["mean_step_reward"]):
        raise AssertionError(f"dryrun_multichip: non-finite epoch {metrics}")
    print(f"dryrun_multichip OK: mesh=({data}x{model}) envs={cfg.train.num_envs} "
          f"mean_step_reward={metrics['mean_step_reward']:.3f} "
          f"steps/s={metrics['steps_per_sec']:.1f}", flush=True)
    out = {"ok": True, "mesh": {"data": data, "model": model}, "devices": n_devices,
           "platform": dev.type, "backend": ranks[0]["backend"],
           "launches": {f"rank{r}": g["launches"] for r, g in enumerate(ranks)},
           "artifact": None}
    if not full_size:
        return out
    trainer = _trainer(cfg, dev)
    start = {k: v.detach().cpu().clone() for k, v in trainer.ac.state_dict().items()}
    one = _run_epoch(trainer)
    ref = one["metrics"]
    print(f"dryrun_multichip unsharded reference: mean_step_reward="
          f"{ref['mean_step_reward']:.3f} steps/s={ref['steps_per_sec']:.1f}", flush=True)
    compared = {k: {"sharded": np.ravel(metrics[k]).tolist(),
                    "unsharded": np.ravel(ref[k]).tolist()} for k in COMPARED}
    agree = all(np.allclose(np.asarray(metrics[k], np.float64),
                            np.asarray(ref[k], np.float64), rtol=TOL, atol=TOL)
                for k in COMPARED)
    # the metrics alone miss the update (pi_loss is taken before its first
    # step), so the tie rule's parameter check runs whether or not they agree
    held = {"metrics_agree_at_tol": agree,
            **tie_rule(ranks[0]["batch"], ranks[0]["params"], one["batch"], start, cfg,
                       dev)}
    t0 = held["first_action_difference_step"]
    if t0 is None and not agree:
        raise AssertionError(f"dryrun_multichip: equal rollouts, metrics apart at {TOL}: "
                             f"{compared}")
    print(f"dryrun_multichip full_size: metrics agree at {TOL}: {agree}; rollouts "
          + ("equal" if t0 is None else f"part at step {t0} on a 0.01 rounding tie")
          + f"; params within {held['params_max_abs_diff_same_batch']:.3g} of the "
          f"one-process update on the ranks' batch", flush=True)
    out.update({
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        "host": platform.node(),
        "shapes": {"model": "biGRU-256 + (256,256) heads",
                   "num_envs": cfg.train.num_envs,
                   "steps_per_epoch": cfg.train.steps_per_epoch,
                   "num_drones": cfg.env.num_drones,
                   "minibatch": cfg.train.minibatch},
        "tolerance": TOL, "held": held, "metrics": compared,
        "steps_per_sec": {"sharded": metrics["steps_per_sec"],
                          "unsharded": ref["steps_per_sec"]},
        "launches": {**out["launches"], "unsharded": one["launches"]},
    })
    out["artifact"] = ARTIFACT
    os.makedirs(os.path.dirname(ARTIFACT), exist_ok=True)
    with open(ARTIFACT, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {ARTIFACT}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("full", nargs="?", choices=["full"], default=None)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank-worker", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_worker:
        return _rank_main(args.rank_worker)
    module, example = entry(args.device)
    with torch.no_grad():
        outs = module(*example)
    print("entry OK:", [tuple(o.shape) for o in outs], flush=True)
    dryrun_multichip(args.ranks, full_size=args.full == "full", device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
