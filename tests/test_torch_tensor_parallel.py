"""Tensor parallelism in the port (parallel/tensor_parallel.py, the (data,
model) Mesh, `cli train --mesh_model`) against the one-process epoch, in
real processes on the CPU over gloo, started as tests/test_torch_parallel.py
starts its workers (tests/torch_tp_worker.py):

  - the rule table shards the same leaves as the JAX package's _TP_RULES,
    mapped onto the port's names through utils/convert.py;
  - make_mesh(data=2, model=2): rank = d * 2 + m, a group per data row and
    per model column;
  - one Trainer epoch (gen_demo, float64 env, H = 32 as
    tests/test_sharding.py, (32, 32) heads, biGRU and LSTM) with model = 2
    (2 ranks) and data = 2 x model = 2 (4 ranks): the rollout's
    observations, masks and actions equal the one-process epoch's, the
    metrics agree at rtol 1e-5 and the parameters within 1e-6 (the MLP's
    row-parallel sum adds two float32 partial products where one process
    makes one, so the two differ in the last bits, as the data-parallel
    epoch's lane split does);
  - every rank holds half of each sharded tensor;
  - the TP checkpoint (gathered, written by rank 0) loads into an unsharded
    ActorCritic and PolicyServer and matches the one-process epoch;
  - `cli train --mesh_model 2` writes its artifacts once.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from rvo3d_tpu.parallel.sharding import _TP_RULES as JAX_TP_RULES
from rvo3d_tpu_torch.algo.ppo import make_optimizers
from rvo3d_tpu_torch.config import ModelConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.parallel.tensor_parallel import tp_shard_dims
from rvo3d_tpu_torch.serving import PolicyServer
from rvo3d_tpu_torch.utils.convert import flax_names, state_dict_to_flax
from torch_tp_worker import CASES, tp_config, tp_epoch_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tp_worker.py")
EXACT = ("obs_self", "obs_nbr", "obs_mask", "act", "rew", "cut")
METRIC_RTOL, METRIC_ATOL, PARAM_TOL = 1e-5, 1e-8, 1e-6
LAYOUTS = {"model2": 1, "data2_model2": 2}     # name -> data ranks (model = 2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(out, data):
    port, n = _free_port(), 2 * data
    procs = []
    for rank in range(n):
        env = dict(os.environ, RVO3D_COORDINATOR=f"127.0.0.1:{port}",
                   RVO3D_NUM_PROCESSES=str(n), RVO3D_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, WORKER, str(out), str(data)],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True, cwd=REPO))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=150)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a tensor-parallel worker timed out")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
        assert f"TP_OK rank={rank} backend=gloo" in log, log[-2000:]
    return logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, data in LAYOUTS.items():
        d = tmp_path_factory.mktemp(name)
        out[name] = (d, _start(d, data))
    return out


@pytest.fixture(scope="module")
def one_process():
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # as the workers run
    try:
        return {name: tp_epoch_case(mode) for name, mode in CASES.items()}
    finally:
        torch.set_num_threads(n)


def _load(runs, layout, case, rank):
    return torch.load(os.path.join(runs[layout][0], f"{case}_rank{rank}.pt"),
                      weights_only=False)


def _jax_sharded(flax_tree):
    """The flax paths that the JAX package's _TP_RULES shard -> the sharded
    axis of the flax array."""
    out = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(flax_tree)[0]:
        name = "/".join(getattr(k, "key", getattr(k, "name", str(k))) for k in path)
        for pat, spec in JAX_TP_RULES:
            if pat.match(name):
                out[name] = list(spec).index("model")
                break
    return out


@pytest.mark.parametrize("mode", ["GRU", "biGRU", "LSTM"])
def test_rule_table_shards_the_jax_leaves(mode):
    ac = ActorCritic(ModelConfig(rnn_mode=mode, rnn_hidden_dim=32,
                                 hidden_sizes_ac=(32, 32), hidden_sizes_v=(32, 32)),
                     device="cpu")
    sd = ac.state_dict()
    flax = state_dict_to_flax(sd)
    want = _jax_sharded(flax)
    dims = tp_shard_dims(ac)
    assert len(dims) == len(want) == {"GRU": 10, "biGRU": 14, "LSTM": 10}[mode]
    # the port's tensor split on its dim is the flax array split on the JAX axis
    names = flax_names(sd)
    for port_name, dim in dims.items():
        path, transposed = names[port_name]
        assert path in want, port_name
        leaf = flax
        for k in path.split("/"):
            leaf = leaf[k]
        a = np.split(sd[port_name].numpy(), 2, axis=dim)
        b = np.split(leaf, 2, axis=want[path])
        for x, y in zip(a, b):
            assert np.array_equal(x.T if transposed else x, y), port_name


@pytest.mark.parametrize("rank", range(4))
def test_mesh_layout_is_row_major(runs, rank):
    got = _load(runs, "data2_model2", "gru", rank)["layout"]
    d, m = divmod(rank, 2)
    assert got == {"data_rank": d, "model_rank": m, "model_group": [2 * d, 2 * d + 1],
                   "data_group": [m, 2 + m]}


def _cases():
    return [(layout, case, rank) for layout, data in LAYOUTS.items()
            for case in CASES for rank in range(2 * data)]


@pytest.mark.parametrize("layout,case,rank", _cases())
def test_sharded_epoch_matches_one_process(runs, one_process, layout, case, rank):
    got, ref = _load(runs, layout, case, rank), one_process[case]
    for k in EXACT:
        assert torch.equal(got["batch"][k], ref["batch"][k]), k
    for k in ("val", "logp"):
        torch.testing.assert_close(got["batch"][k], ref["batch"][k], atol=1e-6, rtol=0)
    gm, rm = got["metrics"], ref["metrics"]
    for k in ("episodes", "success_episodes", "collision_episodes", "pi_iters"):
        assert gm[k] == rm[k], k
    assert sum(rm["episodes"]) > 0
    for k in ("mean_step_reward", "pi_loss", "v_loss", "kl"):
        np.testing.assert_allclose(np.asarray(gm[k], np.float64),
                                   np.asarray(rm[k], np.float64),
                                   rtol=METRIC_RTOL, atol=METRIC_ATOL, err_msg=k)
    for k, v in ref["params"].items():
        torch.testing.assert_close(got["params"][k], v, atol=PARAM_TOL, rtol=0)
    # the rank held half of every sharded tensor
    dims = tp_shard_dims(ActorCritic(tp_config(CASES[case]).model, device="cpu"))
    for k, shape in got["shards"].items():
        whole = tuple(ref["params"][k].shape)
        if k in dims:
            assert shape[dims[k]] * 2 == whole[dims[k]], k
        else:
            assert shape == whole, k


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", CASES)
def test_tp_checkpoint_loads_unsharded(runs, one_process, layout, case):
    state = torch.load(os.path.join(runs[layout][0], f"{case}_ckpt", "0", "state.pt"),
                       weights_only=True)
    ac = ActorCritic(tp_config(CASES[case]).model, device="cpu")
    ac.load_state_dict(state["params"])         # strict: the one-process format
    ref = one_process[case]["params"]
    for k, v in ac.state_dict().items():
        torch.testing.assert_close(v, ref[k], atol=PARAM_TOL, rtol=0)
    # the Adam moments are whole too: they load into the one-process optimizers
    cfg = tp_config(CASES[case])
    for opt, key in zip(make_optimizers(cfg.train, ac), ("pi_opt", "vf_opt")):
        opt.load_state_dict(state[key])
        held = [p for g in opt.param_groups for p in g["params"]]
        assert held and all(opt.state[p]["exp_avg"].shape == p.shape for p in held)


def test_cli_mesh_model_writes_once_and_serves_unsharded(runs):
    out, logs = runs["model2"]
    run = os.path.join(out, "cli")
    assert "run dir:" in logs[0] and "run dir:" not in logs[1]
    assert "mesh: {'data': 1, 'model': 2}" in logs[0]
    lines = [json.loads(ln) for ln in open(os.path.join(run, "train.jsonl")) if ln.strip()]
    assert [ln["epoch"] for ln in lines] == [0, 1]
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["0", "1", "config.json"]
    results = open(os.path.join(run, "results.txt")).read().splitlines()
    assert [r.split(":")[0] for r in results] == ["epoch 0", "epoch 1"]
    cfg = json.load(open(os.path.join(run, "config.json")))
    assert cfg["mesh"] == {"data": 1, "model": 2}
    server = PolicyServer.from_torch(run, device="cpu")
    assert server.epoch == 1 and server.ac.encoder.fwd.w_hh.shape == (32, 96)
    a = server.act(np.zeros((3, 12), np.float32), np.zeros((3, 10, 9), np.float32),
                   np.zeros((3, 10), bool))
    assert a.shape == (3, 3) and np.isfinite(a).all()
