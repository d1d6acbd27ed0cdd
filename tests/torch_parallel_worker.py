"""One rank of the port's data-parallel checks (tests/test_torch_parallel.py
starts two, with the RVO3D_* variables, on the CPU over gloo):

    python tests/torch_parallel_worker.py <out_dir>

  - units: shard_carry, gather_lanes (float, bool, axis 1), reduce_lanes
    and replicate across the real process boundary;
  - one Trainer epoch over a 2-rank mesh in float64 and in float32
    (`epoch_case`), its gathered rollout batch, metrics and final
    parameters written to <out_dir>/<case>_rank<r>.pt;
  - `cli train --mesh_data 2` into <out_dir>/cli (rank 0 writes it);
  - `cli train --curriculum ... --mesh_model 2` into <out_dir>/curriculum,
    every epoch recorded (`curriculum_recorded`) to
    <out_dir>/curriculum_rank<r>.pt.

Prints PARALLEL_OK rank=<r> at the end.
"""

from __future__ import annotations

import copy
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from rvo3d_tpu_torch.config import Config, EnvParams, ModelConfig, TrainConfig  # noqa: E402

SMALL = dict(rnn_hidden_dim=16, hidden_sizes_ac=(32, 32), hidden_sizes_v=(32, 32))
CASES = {"f64": torch.float64, "f32": torch.float32}


def epoch_config(world: str = "gen_demo", num_envs: int = 4) -> Config:
    from rvo3d_tpu_torch.worlds import load_world

    n = load_world(world).drone_num
    return Config(env=EnvParams(num_drones=n), model=ModelConfig(**SMALL),
                  train=TrainConfig(steps_per_epoch=12, num_envs=num_envs, max_ep_len=5,
                                    train_pi_iters=3, train_v_iters=3, minibatch=96,
                                    pi_lr=3e-3, vf_lr=3e-3, batched_update=True,
                                    action_mode="direct", seed=3),
                  world=world)


def epoch_case(dtype: torch.dtype, mesh=None) -> dict:
    """One epoch of the Trainer on gen_demo (on `mesh`, or in one process):
    the rollout batch the update saw, the metrics, the final params."""
    from rvo3d_tpu_torch.algo.trainer import Trainer
    from rvo3d_tpu_torch.worlds import load_world

    cfg = epoch_config()
    world = load_world(cfg.world).spec(dtype=dtype, device="cpu")
    trainer = Trainer(cfg, world, device="cpu", mesh=mesh)
    seen = {}

    def hook(name, data):
        if name == "gae":
            seen["batch"] = {k: v.clone() for k, v in data._asdict().items()}
    trainer.phase_hook = hook
    metrics = trainer.run_epoch()
    metrics.pop("epoch_time_s"), metrics.pop("steps_per_sec")
    return {"batch": seen["batch"], "metrics": metrics,
            "params": {k: v.clone() for k, v in trainer.ac.state_dict().items()},
            "carry_lanes": int(trainer.carry.ep_len.shape[0])}


def curriculum_argv(run_dir: str) -> list:
    """A two-stage goal-threshold curriculum at the CLI's tiny sizes: one
    epoch at 1.2, one at 0.4."""
    return ["train", "--device", "cpu", "--world", "gen_demo", "--num_envs", "4",
            "--steps_per_epoch", "8", "--train_epoch", "2", "--rnn_hidden_dim", "16",
            "--train_pi_iters", "2", "--train_v_iters", "2", "--save_freq", "1",
            "--eval_episodes", "4", "--batched_update", "--action_mode", "direct",
            "--curriculum", "1.2:1,0.4:rest", "--quiet", "--run_dir", run_dir]


def curriculum_recorded(argv: list) -> dict:
    """cli.main(argv) with every Trainer epoch recorded: the stage's goal
    threshold, the whole parameters before and after it and both
    optimizers' whole states before it (gathered under tensor parallelism),
    and the rollout batch its update saw."""
    from rvo3d_tpu_torch import cli
    from rvo3d_tpu_torch.algo import trainer as trainer_mod
    from rvo3d_tpu_torch.parallel.tensor_parallel import (full_optimizer_state_dict,
                                                          full_state_dict)

    real = trainer_mod.Trainer.run_epoch
    epochs = []

    def whole(ac):
        return {k: v.clone() for k, v in full_state_dict(ac).items()}

    def run_epoch(self):
        rec = {"goal_threshold": self.cfg.env.goal_threshold, "start": whole(self.ac),
               "start_opt": [copy.deepcopy(full_optimizer_state_dict(o))
                             for o in (self.pi_opt, self.vf_opt)]}

        def hook(name, data):
            if name == "gae":
                rec["batch"] = {k: v.clone() for k, v in data._asdict().items()}
        self.phase_hook = hook
        metrics = real(self)
        rec["params"] = whole(self.ac)
        epochs.append(rec)
        return metrics
    trainer_mod.Trainer.run_epoch = run_epoch
    try:
        rc = cli.main(argv)
    finally:
        trainer_mod.Trainer.run_epoch = real
    return {"rc": rc, "epochs": epochs}


def stage_epoch(run_dir: str, goal_threshold: float, start: dict, start_opt) -> dict:
    """The rollout batch of a curriculum stage's first epoch in one process,
    from a given start: the stage's Trainer as `cli train` builds it (the
    run's config at the stage's threshold, a fresh carry from the seed),
    with the whole parameters `start` and optimizer states `start_opt`
    loaded."""
    import dataclasses
    import json

    from rvo3d_tpu_torch.algo.trainer import Trainer
    from rvo3d_tpu_torch.config import from_dict
    from rvo3d_tpu_torch.worlds import load_world

    cfg = from_dict(json.load(open(os.path.join(run_dir, "config.json"))))
    cfg = cfg.replace(env=dataclasses.replace(cfg.env, goal_threshold=goal_threshold))
    trainer = Trainer(cfg, load_world(cfg.world).spec(device="cpu"), device="cpu")
    for dst, src in zip(trainer.ppo_state, (start, *start_opt)):
        dst.load_state_dict(copy.deepcopy(src))       # loading shares the tensors
    seen = {}

    def hook(name, data):
        if name == "gae":
            seen["batch"] = {k: v.clone() for k, v in data._asdict().items()}
    trainer.phase_hook = hook
    trainer.run_epoch()
    return seen["batch"]


def units(mesh) -> None:
    from rvo3d_tpu_torch.algo.rollout import init_rollout_carry
    from rvo3d_tpu_torch.models import ActorCritic
    from rvo3d_tpu_torch.parallel import gather_lanes, reduce_lanes, replicate, shard_carry
    from rvo3d_tpu_torch.worlds import load_world

    r, w = mesh.rank, mesh.data
    x = torch.arange(6 * w, dtype=torch.float64).reshape(2 * w, 3)
    mine = shard_carry(x, mesh, 2 * w)
    assert torch.equal(mine, x[2 * r:2 * r + 2]), mine
    assert torch.equal(gather_lanes(mine, mesh), x)
    flags = x[:, 0] % 3 == 0
    assert torch.equal(gather_lanes(shard_carry(flags, mesh, 2 * w), mesh), flags)
    t = torch.arange(5 * 2 * w).reshape(5, 2 * w)                 # [T, E] int64
    assert torch.equal(gather_lanes(t[:, 2 * r:2 * r + 2], mesh, axis=1), t)
    v = torch.tensor([float(r), -float(r), 1.0])
    assert reduce_lanes(v, mesh, "min").tolist() == [0.0, -(w - 1.0), 1.0]
    assert reduce_lanes(v, mesh, "max").tolist() == [w - 1.0, 0.0, 1.0]
    assert reduce_lanes(v, mesh).tolist() == [w * (w - 1) / 2, -w * (w - 1) / 2, float(w)]

    # a carry keeps its lanes of every [E, ...] leaf; the rest (the
    # generator, the per-agent stats, a world's [N, ...] leaves) stays whole
    wd = load_world("gen_demo")                     # N = 4 drones, E = 3 lanes a rank
    spec = wd.spec(device="cpu")
    carry = init_rollout_carry(spec, EnvParams(num_drones=wd.drone_num), 3 * w,
                               torch.Generator().manual_seed(0))
    part = shard_carry(carry, mesh, 3 * w)
    assert torch.equal(part.env_state.pos, carry.env_state.pos[3 * r:3 * r + 3])
    assert torch.equal(part.obs[1], carry.obs[1][3 * r:3 * r + 3])
    assert part.generator is carry.generator
    assert torch.equal(part.stats.count, carry.stats.count)
    assert torch.equal(shard_carry(spec, mesh, 3 * w).waypoints, spec.waypoints)

    # replicate: rank 0's parameters and Adam state everywhere
    ac = ActorCritic(ModelConfig(**SMALL), generator=torch.Generator().manual_seed(r),
                     device="cpu")
    opt = torch.optim.Adam(ac.parameters())
    ac(torch.zeros(1, 12), torch.zeros(1, 10, 9), torch.zeros(1, 10, dtype=torch.bool))[2] \
        .sum().backward()
    opt.step()
    replicate(ac, mesh)
    replicate(opt, mesh)
    state = [p.detach() for p in ac.parameters()] + [
        v for p in ac.parameters() for v in opt.state[p].values()]
    for x in state:
        rows = gather_lanes(x.reshape(1, -1), mesh)
        assert all(torch.equal(rows[0], row) for row in rows), "replicas differ"


def main() -> int:
    from rvo3d_tpu_torch import cli
    from rvo3d_tpu_torch.parallel import distributed_init_from_env, make_mesh

    torch.set_num_threads(1)
    out = sys.argv[1]
    assert distributed_init_from_env("cpu"), "RVO3D_* variables not set"
    mesh = make_mesh(data=2)
    units(mesh)
    for name, dtype in CASES.items():
        torch.save(epoch_case(dtype, mesh), os.path.join(out, f"{name}_rank{mesh.rank}.pt"))
    argv = ["train", "--device", "cpu", "--world", "gen_demo", "--num_envs", "4",
            "--steps_per_epoch", "8", "--train_epoch", "1", "--rnn_hidden_dim", "16",
            "--train_pi_iters", "2", "--train_v_iters", "2", "--save_freq", "1",
            "--eval_episodes", "4", "--batched_update", "--action_mode", "direct",
            "--mesh_data", "2", "--quiet", "--run_dir", os.path.join(out, "cli")]
    assert cli.main(argv) == 0
    curr = curriculum_recorded(curriculum_argv(os.path.join(out, "curriculum"))
                               + ["--mesh_model", "2"])
    torch.save(curr, os.path.join(out, f"curriculum_rank{mesh.rank}.pt"))
    print(f"PARALLEL_OK rank={mesh.rank} backend={torch.distributed.get_backend()}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
