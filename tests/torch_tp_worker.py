"""One rank of the port's tensor-parallel checks
(tests/test_torch_tensor_parallel.py starts 2 or 4, with the RVO3D_*
variables, on the CPU over gloo):

    python tests/torch_tp_worker.py <out_dir> <data>

The mesh is <data> x 2 (model = 2). For each case of CASES (the biGRU and
the LSTM policy, float64 env) one Trainer epoch with the parameters
sharded by shard_params_tp: its gathered rollout batch, metrics, the
gathered parameters, this rank's shard shapes and the mesh layout go to
<out_dir>/<case>_rank<r>.pt, and the epoch's checkpoint (every rank
gathers, rank 0 writes) to <out_dir>/<case>_ckpt. With data = 1 it also
runs `cli train --mesh_model 2` into <out_dir>/cli. Prints
TP_OK rank=<r> at the end.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from rvo3d_tpu_torch.config import Config, EnvParams, ModelConfig, TrainConfig  # noqa: E402

# H = 32 as tests/test_sharding.py; (32, 32) heads
CASES = {"gru": "biGRU", "lstm": "LSTM"}


def tp_config(rnn_mode: str, world: str = "gen_demo", num_envs: int = 4) -> Config:
    from rvo3d_tpu_torch.worlds import load_world

    n = load_world(world).drone_num
    model = ModelConfig(rnn_hidden_dim=32, rnn_mode=rnn_mode, hidden_sizes_ac=(32, 32),
                        hidden_sizes_v=(32, 32))
    return Config(env=EnvParams(num_drones=n), model=model,
                  train=TrainConfig(steps_per_epoch=12, num_envs=num_envs, max_ep_len=5,
                                    train_pi_iters=3, train_v_iters=3, minibatch=96,
                                    pi_lr=3e-3, vf_lr=3e-3, batched_update=True,
                                    action_mode="direct", seed=3),
                  world=world)


def tp_epoch_case(rnn_mode: str, mesh=None, ckpt_dir=None) -> dict:
    """One Trainer epoch on gen_demo (float64 env), sharded over `mesh`'s
    model axis or in one process: the rollout batch the update saw, the
    metrics, the whole parameters after the epoch."""
    from rvo3d_tpu_torch.algo.trainer import Trainer
    from rvo3d_tpu_torch.parallel import replicate
    from rvo3d_tpu_torch.parallel.tensor_parallel import full_state_dict, shard_params_tp
    from rvo3d_tpu_torch.utils.checkpoint import save_checkpoint
    from rvo3d_tpu_torch.worlds import load_world

    cfg = tp_config(rnn_mode)
    world = load_world(cfg.world).spec(dtype=torch.float64, device="cpu")
    trainer = Trainer(cfg, world, device="cpu", mesh=mesh)
    shards = {}
    if mesh is not None:
        for obj in trainer.ppo_state:
            replicate(obj, mesh)
        shard_params_tp(trainer.ppo_state, mesh)
        shards = {k: tuple(v.shape) for k, v in trainer.ac.state_dict().items()}
    seen = {}

    def hook(name, data):
        if name == "gae":
            seen["batch"] = {k: v.clone() for k, v in data._asdict().items()}
    trainer.phase_hook = hook
    metrics = trainer.run_epoch()
    metrics.pop("epoch_time_s"), metrics.pop("steps_per_sec")
    if ckpt_dir is not None:
        save_checkpoint(ckpt_dir, 0, trainer.ppo_state, cfg)
    return {"batch": seen["batch"], "metrics": metrics, "shards": shards,
            "params": {k: v.clone() for k, v in full_state_dict(trainer.ac).items()}}


def main() -> int:
    import torch.distributed as dist

    from rvo3d_tpu_torch import cli
    from rvo3d_tpu_torch.parallel import distributed_init_from_env, make_mesh

    torch.set_num_threads(1)
    out, data = sys.argv[1], int(sys.argv[2])
    assert distributed_init_from_env("cpu"), "RVO3D_* variables not set"
    mesh = make_mesh(data=data, model=2)
    layout = {"data_rank": mesh.data_rank, "model_rank": mesh.model_rank,
              "model_group": dist.get_process_group_ranks(mesh.model_group),
              "data_group": (dist.get_process_group_ranks(mesh.data_group)
                             if mesh.data_group is not None else [mesh.rank])}
    for name, mode in CASES.items():
        rec = tp_epoch_case(mode, mesh, os.path.join(out, f"{name}_ckpt"))
        rec["layout"] = layout
        torch.save(rec, os.path.join(out, f"{name}_rank{mesh.rank}.pt"))
    if data == 1:
        argv = ["train", "--device", "cpu", "--world", "gen_demo", "--num_envs", "4",
                "--steps_per_epoch", "8", "--train_epoch", "1", "--rnn_hidden_dim", "32",
                "--train_pi_iters", "2", "--train_v_iters", "2", "--save_freq", "1",
                "--eval_episodes", "4", "--batched_update", "--action_mode", "direct",
                "--mesh_model", "2", "--quiet", "--run_dir", os.path.join(out, "cli")]
        assert cli.main(argv) == 0
    print(f"TP_OK rank={mesh.rank} backend={dist.get_backend()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
