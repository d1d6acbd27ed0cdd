"""Data-parallel training over env lanes (rvo3d_tpu_torch/parallel/ and
Trainer(mesh=...)) in two real processes on the CPU over gloo, started as
tests/test_multihost.py starts its workers (tests/torch_parallel_worker.py,
RVO3D_* variables, a free local port, each process with its own timeout):

  - the workers' own checks of shard_carry, gather_lanes, reduce_lanes and
    replicate across the process boundary;
  - the sharded epoch against the one-process epoch at the same seed
    (gen_demo, 4 lanes = 2 per rank, 12 steps, batched update), on both
    ranks. float64 env: the episode flags, counts, masks and actions
    exactly, observations and rewards to 1e-12. The policy is float32 in
    both packages, and its outputs (values, logp) and what the update makes
    of them (losses, KL, parameters) agree to 1e-6: the CPU's float32
    matrix products round a row's result differently for 2 lanes' rows than
    for 4 lanes' (up to 3e-8 on mu at these widths), so the policy is not
    bit-equal across lane splits. float32 env: the metrics at the rtol 1e-3
    (atol 1e-3) of tests/test_sharding.py;
  - `cli train --mesh_data 2`: rank 0 alone writes the run directory, each
    line and checkpoint once;
  - `cli train --curriculum 1.2:1,0.4:rest --mesh_model 2` (one epoch a
    stage, tensor-parallel over the two ranks) against the same curriculum
    in one process under entry.tie_rule: the first epoch's rollout equal up
    to a 0.01 rounding tie and its params equal to the one-process update
    on the ranks' batch within 1e-5; stage 2 on its own: its start equal
    to stage 1's end, its epoch under the tie rule against one process
    started from the ranks' stage-2 params and Adam state; while the
    rollouts have not parted, every later epoch's batch equal to the
    one-process curriculum's too (values and logp aside) and the final
    params within 1e-5; rank 0 writes each stage's lines once;
  - make_mesh in one process, and its refusals (a model axis of 2 needs
    processes; tensor parallelism itself is tests/test_torch_tensor_parallel.py);
  - the backend rule (gloo for a CPU run, whatever cards the host has;
    NCCL only for a CUDA run with a card per rank on each host) and the
    local rank that picks a rank's card.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from rvo3d_tpu_torch.parallel import make_mesh, multihost
from torch_parallel_worker import (CASES, curriculum_argv, curriculum_recorded, epoch_case,
                                   stage_epoch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
EXACT = ("obs_mask", "act", "cut")
ENV_F64 = ("obs_self", "obs_nbr", "rew")
POLICY = ("val", "logp")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RVO3D_COORDINATOR=f"127.0.0.1:{port}",
                   RVO3D_NUM_PROCESSES="2", RVO3D_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, WORKER, str(out)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True, cwd=REPO))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a data-parallel worker timed out")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
        assert f"PARALLEL_OK rank={rank} backend=gloo" in log, log[-2000:]
    return out, logs


@pytest.fixture(scope="module")
def one_process():
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # as the workers run
    try:
        return {name: epoch_case(dtype) for name, dtype in CASES.items()}
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def curriculum_one(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # as the workers run
    try:
        return curriculum_recorded(curriculum_argv(str(tmp_path_factory.mktemp("curr"))))
    finally:
        torch.set_num_threads(n)


def load(out, name, rank):
    return torch.load(os.path.join(out, f"{name}_rank{rank}.pt"), weights_only=False)


@pytest.mark.parametrize("rank", [0, 1])
def test_f64_sharded_epoch_matches_one_process(ranks, one_process, rank):
    got, ref = load(ranks[0], "f64", rank), one_process["f64"]
    assert got["carry_lanes"] == 2 and ref["carry_lanes"] == 4
    for k in EXACT:
        assert torch.equal(got["batch"][k], ref["batch"][k]), k
    for k in ENV_F64:
        assert got["batch"][k].dtype == torch.float64
        torch.testing.assert_close(got["batch"][k], ref["batch"][k], atol=1e-12, rtol=0)
    for k in POLICY:
        torch.testing.assert_close(got["batch"][k], ref["batch"][k], atol=1e-6, rtol=0)
    gm, rm = got["metrics"], ref["metrics"]
    for k in ("episodes", "success_episodes", "collision_episodes", "pi_iters"):
        assert gm[k] == rm[k], k
    assert sum(rm["episodes"]) > 0 and sum(rm["collision_episodes"]) > 0
    np.testing.assert_allclose(gm["mean_step_reward"], rm["mean_step_reward"], rtol=0,
                               atol=1e-12)
    for k in ("ep_ret_mean", "ep_ret_min", "ep_ret_max"):
        np.testing.assert_allclose(gm[k], rm[k], rtol=0, atol=1e-12, err_msg=k)
    for k in ("pi_loss", "v_loss", "kl"):
        np.testing.assert_allclose(gm[k], rm[k], rtol=1e-6, atol=1e-6, err_msg=k)
    for k, v in ref["params"].items():
        torch.testing.assert_close(got["params"][k], v, atol=1e-6, rtol=0)


@pytest.mark.parametrize("rank", [0, 1])
def test_f32_sharded_epoch_metrics_match_one_process(ranks, one_process, rank):
    gm, rm = load(ranks[0], "f32", rank)["metrics"], one_process["f32"]["metrics"]
    for k in ("mean_step_reward", "pi_loss", "v_loss", "kl"):
        np.testing.assert_allclose(np.asarray(gm[k], np.float64),
                                   np.asarray(rm[k], np.float64), rtol=1e-3, atol=1e-3,
                                   err_msg=k)
    assert gm["episodes"] == rm["episodes"]


def test_cli_artifacts_are_written_once_by_rank_0(ranks):
    out, logs = ranks
    run = os.path.join(out, "cli")
    assert "run dir:" in logs[0] and "run dir:" not in logs[1]
    assert "mesh: {'data': 2, 'model': 1}" in logs[0]
    lines = [json.loads(ln) for ln in open(os.path.join(run, "train.jsonl")) if ln.strip()]
    assert [ln["epoch"] for ln in lines] == [0, 1]
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["0", "1", "config.json"]
    results = open(os.path.join(run, "results.txt")).read().splitlines()
    assert [r.split(":")[0] for r in results] == ["epoch 0", "epoch 1"]
    cfg = json.load(open(os.path.join(run, "config.json")))
    assert cfg["mesh"] == {"data": 2, "model": 1} and cfg["train"]["num_envs"] == 4


def test_make_mesh_in_one_process():
    mesh = make_mesh()
    assert (mesh.data, mesh.rank) == (1, 0)
    assert mesh.lanes(6) == slice(0, 6)
    with pytest.raises(ValueError, match="model=2 does not divide the 1 processes"):
        make_mesh(model=2)
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(data=2)


def test_cli_mesh_data_needs_its_processes(tmp_path):
    from rvo3d_tpu_torch import cli

    with pytest.raises(SystemExit, match="needs 2 processes"):
        cli.main(["train", "--device", "cpu", "--world", "gen_demo", "--mesh_data", "2",
                  "--run_dir", str(tmp_path)])


@pytest.mark.parametrize("device, ranks_on_host, cards, backend", [
    ("cpu", 2, 4, "gloo"),     # --device cpu on a host with cards
    ("cpu", 1, 1, "gloo"),
    ("cuda", 2, 1, "gloo"),    # two ranks share one card: NCCL refuses it
    ("cuda", 2, 2, "nccl"),
    ("cuda", 1, 1, "nccl"),    # one rank on each of several one-card hosts
])
def test_backend_follows_the_run_device_and_the_hosts_cards(device, ranks_on_host, cards,
                                                            backend):
    assert multihost.choose_backend(device, ranks_on_host, cards) == backend


def test_local_rank_counts_the_ranks_on_this_host(monkeypatch):
    monkeypatch.setenv("RVO3D_NUM_PROCESSES", "4")
    monkeypatch.setenv("RVO3D_PROCESS_ID", "3")
    monkeypatch.delenv("RVO3D_LOCAL_PROCESSES", raising=False)
    assert (multihost.local_processes(), multihost.local_rank()) == (4, 3)
    monkeypatch.setenv("RVO3D_LOCAL_PROCESSES", "2")     # 2 hosts x 2 ranks
    assert (multihost.local_processes(), multihost.local_rank()) == (2, 1)
    assert multihost.rank_device("cpu") == torch.device("cpu")   # no process group


@pytest.mark.parametrize("rank", [0, 1])
def test_curriculum_over_a_model_mesh_holds_to_one_process(ranks, curriculum_one, rank):
    from rvo3d_tpu_torch import entry
    from rvo3d_tpu_torch.config import from_dict

    out, _ = ranks
    got, ref = load(out, "curriculum", rank), curriculum_one
    assert got["rc"] == 0 and ref["rc"] == 0
    assert [e["goal_threshold"] for e in got["epochs"]] == [1.2, 0.4]
    assert [e["goal_threshold"] for e in ref["epochs"]] == [1.2, 0.4]
    run = os.path.join(out, "curriculum")
    cfg = from_dict(json.load(open(os.path.join(run, "config.json"))))
    first, one = got["epochs"][0], ref["epochs"][0]
    for k, v in one["start"].items():
        assert torch.equal(first["start"][k], v), k
    held = entry.tie_rule(first["batch"], first["params"], one["batch"], first["start"],
                          cfg, torch.device("cpu"))
    # stage 2 on its own, whether or not stage 1's rollouts parted: its
    # trainer (sharded, then loaded from stage 1's shards) starts from
    # stage 1's final params exactly, and its epoch holds under the tie rule
    # to one process started from the ranks' stage-2 params and Adam state
    second = got["epochs"][1]
    for k, v in first["params"].items():
        assert torch.equal(second["start"][k], v), k
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # as the workers run
    try:
        own = stage_epoch(run, 0.4, second["start"], second["start_opt"])
    finally:
        torch.set_num_threads(n)
    entry.tie_rule(second["batch"], second["params"], own, second["start"], cfg,
                   torch.device("cpu"), opt_states=second["start_opt"])
    if held["first_action_difference_step"] is None:
        for e, (g, r) in enumerate(zip(got["epochs"][1:], ref["epochs"][1:]), 1):
            t0, tie = entry.rollout_parting(g["batch"], r["batch"])
            upto = g["batch"]["act"].shape[0] if t0 is None else t0
            for k in r["batch"]:
                if k not in ("val", "logp"):
                    assert torch.equal(g["batch"][k][:upto], r["batch"][k][:upto]), (e, k)
            assert tie, f"epoch {e}: the rollouts part at step {t0}, not at a tie"
            if t0 is not None:
                break
        else:
            for k, v in ref["epochs"][-1]["params"].items():
                torch.testing.assert_close(got["epochs"][-1]["params"][k], v,
                                           atol=entry.PARAM_TOL, rtol=0)
    lines = [json.loads(ln) for ln in open(os.path.join(run, "train.jsonl")) if ln.strip()]
    assert [(ln["epoch"], ln["goal_threshold"]) for ln in lines] == [(0, 1.2), (1, 0.4)]
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["0", "1", "config.json"]
    results = open(os.path.join(run, "results.txt")).read()
    # each stage ends with evaluations at its threshold and the final one
    assert results.count("stage thr=1.2 done") == 2 and results.count("stage thr=0.4 done") == 1
