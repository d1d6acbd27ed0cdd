"""The port's trainer (rvo3d_tpu_torch/algo/trainer.py), checkpoints and
metrics logging against the JAX package's, on gen_demo with a small policy
(H = 16, heads (32, 32)), 4 lanes, T = 12.

  - make_train_epoch (rollout -> GAE -> PPO update), batched and
    sequential with log_std -1 and batched with log_std -20, against the JAX epoch from the same params and carry: the
    port's policy is handed the JAX rollout's standard-normal draws and
    the JAX agent order and minibatch offsets. With log_std -1 the policy
    phase takes steps on both sides (in the sequential schedule the second
    agent stalls at iteration 0 on both: the first agent's encoder steps
    raise its KL past the target); with log_std -20 (std 1e-4) it takes
    none on either, since the stored logp is of the unrounded sample and
    iteration 0's KL exceeds the target. Update metrics (pi_iters exactly),
    params after the update and the mean reward at rtol 1e-4 (atol 1e-6
    for params and losses, 1e-7 for kl); EpisodeStats and the carry at
    atol 1e-4 plus rtol 1e-5.
  - Trainer: two epochs are finite and give the JAX run_epoch's key set;
    an injected NaN halts, restores the cloned snapshot (params, both
    optimizer states, carry) and writes the rescue checkpoint under the
    last good epoch's index; the default device is cuda, which raises
    without a card.
  - checkpoints: save/restore round trip of params and both optimizer
    states, every epoch kept, params_only, config.json.
  - JSONLLogger and write_reward_csv write what the JAX module writes
    from the same records (exactly).
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu.algo import ppo as jppo
from rvo3d_tpu.algo.rollout import init_rollout_carry as j_init
from rvo3d_tpu.algo.trainer import Trainer as JTrainer
from rvo3d_tpu.algo.trainer import make_train_epoch as j_make_train_epoch
from rvo3d_tpu.config import Config as JConfig
from rvo3d_tpu.config import EnvParams as JEnvParams
from rvo3d_tpu.config import ModelConfig as JModelConfig
from rvo3d_tpu.config import TrainConfig as JTrainConfig
from rvo3d_tpu.env.state import make_world_spec as j_make_world_spec
from rvo3d_tpu.models import ActorCritic as JActorCritic
from rvo3d_tpu.utils import metrics as jmetrics
from rvo3d_tpu_torch.algo import ppo
from rvo3d_tpu_torch.algo.rollout import init_rollout_carry
from rvo3d_tpu_torch.algo.trainer import Trainer, make_train_epoch, metrics_finite
from rvo3d_tpu_torch.config import Config, EnvParams, ModelConfig, TrainConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils import metrics
from rvo3d_tpu_torch.utils.checkpoint import (load_config, restore_checkpoint,
                                              save_checkpoint, saved_epochs)
from rvo3d_tpu_torch.utils.convert import flax_to_state_dict
from rvo3d_tpu_torch.worlds import load_world
from test_torch_ppo import assert_metrics_match, assert_params_match, jax_offsets
from test_torch_rollout import compare_carry, inject, jax_eps, np_

E, T = 4, 12
SMALL = dict(rnn_hidden_dim=16, hidden_sizes_ac=(32, 32), hidden_sizes_v=(32, 32))
TRAIN = dict(steps_per_epoch=T, num_envs=E, max_ep_len=5, train_pi_iters=3,
             train_v_iters=3, minibatch=32, pi_lr=1e-3, vf_lr=1e-3,
             action_mode="direct", save_freq=1)


def configs(n, **train):
    kw = {**TRAIN, **train}
    env = dict(num_drones=n)
    return (JConfig(env=JEnvParams(**env), model=JModelConfig(**SMALL),
                    train=JTrainConfig(**kw)),
            Config(env=EnvParams(**env), model=ModelConfig(**SMALL),
                   train=TrainConfig(**kw)))


@pytest.mark.parametrize("batched,log_std", [(True, -1.0), (False, -1.0), (True, -20.0)])
def test_train_epoch_matches_jax(batched, log_std):
    wd = load_world("gen_demo")
    n = wd.drone_num
    jcfg, tcfg = configs(n, batched_update=batched, max_update_num=2)
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, log_std_init=log_std))
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model,
                                                                log_std_init=log_std))
    jac = JActorCritic(jcfg.model)
    params = jax.jit(jac.init)(jax.random.PRNGKey(0), jnp.zeros((1, 12)),
                               jnp.zeros((1, 10, 9)), jnp.zeros((1, 10), bool))
    pi_tx, vf_tx = jppo.make_optimizers(jcfg.train, params)
    jstate = jppo.PPOState(params, pi_tx.init(params), vf_tx.init(params))
    jspec = j_make_world_spec(wd.waypoints_list, wd.building_list, wd.map_size)
    jcarry = jax.jit(lambda k: j_init(jspec, jcfg.env, E, k))(jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    out = jax.jit(j_make_train_epoch(jac, jspec, jcfg, pi_tx, vf_tx))(
        jstate, jcarry, key)

    ac = ActorCritic(tcfg.model, device="cpu")
    ac.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    pi_opt, vf_opt = ppo.make_optimizers(tcfg.train, ac)
    tspec = wd.spec(device="cpu")
    tcarry = init_rollout_carry(tspec, tcfg.env, E, torch.Generator())
    inject(ac, jax_eps(jcarry.rng, T, n))
    if batched:
        perm, offsets = None, [jax_offsets(jcfg.train, key, T * E * n)]
    else:
        perm = np.asarray(jax.random.permutation(key, n)).tolist()
        offsets = [jax_offsets(jcfg.train, jax.random.fold_in(key, k), T * E)
                   for k in range(2)]
    phases = []
    got = make_train_epoch(ac, tspec, tcfg, pi_opt, vf_opt)(
        tcarry, torch.Generator(), perm, offsets,
        on_phase=lambda name, data: phases.append(name))
    assert phases == ["rollout", "gae", "update", "end"]

    um, jum = got.update_metrics, out.update_metrics
    if log_std == -1.0:
        assert int(um.pi_iters.max()) > 0      # policy steps ran
    else:
        # std 1e-4: the stored logp is of the unrounded sample, so
        # iteration 0's kl exceeds the target and no policy step is taken
        assert int(um.pi_iters.max()) == 0
    for k in range(um.pi_loss.shape[0]):
        assert_metrics_match([x[k] for x in um], [x[k] for x in jum])
    assert_params_match(ac, out.ppo_state.params)
    np.testing.assert_allclose(float(got.mean_reward), float(out.mean_reward), rtol=1e-4)
    compare_carry(got.carry, out.carry, 1e-4)
    for a, b in zip(got.stats, out.stats):
        np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-4, rtol=1e-5)
    assert float(np_(got.stats.collision_count).sum()) > 0
    assert float(np_(got.carry.stats.count).sum()) == 0     # stats restart


def small_trainer(**train):
    wd = load_world("gen_demo")
    _, tcfg = configs(wd.drone_num, **train)
    return wd, tcfg, Trainer(tcfg, wd.spec(device="cpu"), device="cpu")


def test_trainer_epochs_are_finite_with_the_jax_key_set():
    wd, tcfg, trainer = small_trainer()
    m1, m2 = trainer.run_epoch(), trainer.run_epoch()
    assert metrics_finite(m1) and metrics_finite(m2)
    jcfg, _ = configs(wd.drone_num)
    jm = JTrainer(jcfg, j_make_world_spec(wd.waypoints_list, wd.building_list,
                                          wd.map_size)).run_epoch()
    optional = {"pi_stalled_agents"}
    assert set(m2) - optional == set(jm) - optional
    assert ("pi_stalled_agents" in m2) == (min(m2["pi_iters"]) == 0)
    for k in set(m2) & set(jm):
        assert type(m2[k]) is type(jm[k]) or {type(m2[k]), type(jm[k])} <= {int, float}, k
        if isinstance(jm[k], list):
            assert len(m2[k]) == len(jm[k]), k
    assert m2["env_steps"] == T * E


def test_trainer_halts_on_non_finite_metrics(tmp_path):
    wd, tcfg, trainer = small_trainer()
    calls = {"n": 0}
    snap = {}
    real_run_epoch = trainer.run_epoch

    def poisoned_run_epoch():
        if calls["n"] == 1:   # the state the trainer must roll back to
            snap["params"] = {k: v.clone() for k, v in trainer.ac.state_dict().items()}
            snap["pi"] = [s["exp_avg"].clone() for s in trainer.pi_opt.state.values()]
            snap["pos"] = trainer.carry.env_state.pos.clone()
            snap["rng"] = trainer.carry.generator.get_state()
        calls["n"] += 1
        m = real_run_epoch()
        if calls["n"] >= 2:
            m["pi_loss"] = [float("nan")] * len(m["pi_loss"])
        return m

    trainer.run_epoch = poisoned_run_epoch
    logs, ckpts, evals = [], [], []

    def checkpoint_fn(epoch, state):
        ckpts.append(epoch)
        save_checkpoint(str(tmp_path), epoch, state, tcfg)

    trainer.train(epochs=10, log_fn=logs.append, checkpoint_fn=checkpoint_fn,
                  eval_fn=lambda e, s, saved: evals.append((e, saved)))
    assert calls["n"] == 2
    assert any(m.get("non_finite_halt") for m in logs)
    assert logs[-1]["halted"] == "non-finite metrics" and logs[-1]["restored_to_epoch"] == 0
    assert ckpts == [0, 0] and evals[-1] == (0, True)
    for k, v in trainer.ac.state_dict().items():
        assert torch.equal(v, snap["params"][k]), k
    for s, ref in zip(trainer.pi_opt.state.values(), snap["pi"]):
        assert torch.equal(s["exp_avg"], ref)
    assert torch.equal(trainer.carry.env_state.pos, snap["pos"])
    assert torch.equal(trainer.carry.generator.get_state(), snap["rng"])
    # the rescue checkpoint holds the restored state
    fresh = small_trainer()[2]
    restore_checkpoint(str(tmp_path), fresh.ppo_state, epoch=0)
    for k, v in fresh.ac.state_dict().items():
        assert torch.equal(v, snap["params"][k]), k


def test_checkpoint_round_trip(tmp_path):
    wd, tcfg, trainer = small_trainer()
    d = str(tmp_path / "ckpt")
    saved = []
    for epoch in range(3):
        trainer.run_epoch()
        save_checkpoint(d, epoch, trainer.ppo_state, tcfg)
        saved.append(({k: v.clone() for k, v in trainer.ac.state_dict().items()},
                      trainer.pi_opt.state_dict(), trainer.vf_opt.state_dict()))
    assert saved_epochs(d) == [0, 1, 2]                        # every epoch kept
    assert load_config(d) == tcfg

    fresh = small_trainer()[2]
    state, epoch = restore_checkpoint(d, fresh.ppo_state)
    assert epoch == 2
    params, pi_sd, vf_sd = saved[2]
    for k, v in fresh.ac.state_dict().items():
        assert torch.equal(v, params[k]), k
    for opt, ref in ((state.pi_opt, pi_sd), (state.vf_opt, vf_sd)):
        got = opt.state_dict()
        assert got["param_groups"] == ref["param_groups"]
        for i, s in ref["state"].items():
            for name, v in s.items():
                assert torch.equal(got["state"][i][name], v), (i, name)

    fresh = small_trainer()[2]
    _, epoch = restore_checkpoint(d, fresh.ppo_state, epoch=0, params_only=True)
    assert epoch == 0 and len(fresh.pi_opt.state) == 0 and len(fresh.vf_opt.state) == 0
    for k, v in fresh.ac.state_dict().items():
        assert torch.equal(v, saved[0][0][k]), k
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), fresh.ppo_state)


def test_trainer_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wd = load_world("gen_demo")
    _, tcfg = configs(wd.drone_num)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(tcfg, wd.spec(device="cpu"))


def test_metrics_files_match_jax(tmp_path):
    records = [
        {"epoch": e, "wall_time_s": 0.5 * e, "mean_step_reward": -1.25 + e,
         "ep_ret_mean": [1.5 * e, -2.0, 3.25], "pi_loss": [0.1], "note": "x"}
        for e in range(3)] + [{"epoch": 3, "halted": "non-finite metrics",
                              "wall_time_s": 2.0}]
    out = {}
    for name, mod in (("jax", jmetrics), ("port", metrics)):
        log = mod.JSONLLogger(str(tmp_path / name / "train.jsonl"), echo=False)
        for r in records:
            log.log(r)
        mod.write_reward_csv(str(tmp_path / name / "reward.csv"), log.read())
        out[name] = [(tmp_path / name / f).read_text()
                     for f in ("train.jsonl", "reward.csv")]
    assert out["port"] == out["jax"]
    assert [json.loads(line) for line in out["port"][0].splitlines()] == records
    png = metrics.plot_reward_curves(str(tmp_path / "port" / "train.jsonl"),
                                     str(tmp_path / "curves.png"))
    jpng = jmetrics.plot_reward_curves(str(tmp_path / "jax" / "train.jsonl"),
                                       str(tmp_path / "jcurves.png"))
    assert (png is None) == (jpng is None)
