"""The port's evaluator (rvo3d_tpu_torch/algo/evaluator.py) on the committed
product policy: runs/w16_r4 epoch 30, restored from Orbax on the JAX side
and carried to the port as numpy arrays.

  - product check: the port scores it on world16_dense with det success
    100 % and mean EpLen within +-1 of 30.91 (runs/w16_r4/results.txt:8);
  - the port's and the JAX package's evaluate agree on gen_demo under the
    same params. Their random streams differ, and the 1e-4 action noise
    decides the 2-decimal rounding of actions that sit near a tie, so lanes
    may part ways: episodes and success agree exactly, EpLen within 1,
    speed within 0.02;
  - noise-mode eval of the product makes distinct episodes and completes
    most of them.
"""

import dataclasses
import json
import os
from typing import Any, NamedTuple

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu.algo.evaluator import evaluate as j_evaluate
from rvo3d_tpu.config import EnvParams as JEnvParams
from rvo3d_tpu.models import ActorCritic as JActorCritic
from rvo3d_tpu.utils.checkpoint import load_config, restore_checkpoint
from rvo3d_tpu.worlds.loader import load_world_dir
from rvo3d_tpu_torch.algo.evaluator import evaluate
from rvo3d_tpu_torch.config import EnvParams, ModelConfig, from_dict
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils.convert import flax_to_state_dict
from rvo3d_tpu_torch.worlds import load_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "runs", "w16_r4")


class _Params(NamedTuple):
    params: Any


@pytest.fixture(scope="module")
def product():
    """(JAX ActorCritic, JAX params, port ActorCritic on the CPU, config)."""
    if not os.path.isdir(os.path.join(RUN, "ckpt", "30")):
        pytest.skip("runs/w16_r4 checkpoint not present")
    jcfg = load_config(RUN)
    jac = JActorCritic(jcfg.model)
    template = jac.init(jax.random.PRNGKey(0), jnp.zeros((1, 12)),
                        jnp.zeros((1, 10, 9)), jnp.zeros((1, 10), bool))
    restored, epoch = restore_checkpoint(os.path.join(RUN, "ckpt"),
                                         _Params(template), epoch=30,
                                         params_only=True)
    assert epoch == 30
    with open(os.path.join(RUN, "config.json")) as f:
        cfg = from_dict(json.load(f))
    ac = ActorCritic(cfg.model, device="cpu")
    ac.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, restored.params)))
    return jac, restored.params, ac, cfg


def test_product_policy_scores_in_the_port(product):
    _, _, ac, cfg = product
    wd = load_world("world16_dense")
    m = evaluate(ac, wd.spec(device="cpu"), EnvParams(num_drones=wd.drone_num),
                 generator=torch.Generator().manual_seed(0),
                 num_episodes=16, num_lanes=16, chunk_len=40, max_chunks=2,
                 action_mode=cfg.train.action_mode)
    assert "truncated" not in m and m["episodes"] == 16
    assert m["success_rate"] == 1.0
    assert abs(m["mean_ep_len"] - 30.91) <= 1.0, m


def test_port_and_jax_evaluate_agree(product):
    jac, jparams, ac, cfg = product
    wd = load_world("gen_demo")
    kw = dict(num_episodes=8, num_lanes=8, max_ep_len=60, chunk_len=61,
              max_chunks=2, action_mode=cfg.train.action_mode)
    mj = j_evaluate(jac, jparams, load_world_dir(wd.base_dir).spec(),
                    JEnvParams(num_drones=wd.drone_num), jax.random.PRNGKey(0), **kw)
    mt = evaluate(ac, wd.spec(device="cpu"), EnvParams(num_drones=wd.drone_num),
                  generator=torch.Generator().manual_seed(0), **kw)
    assert mt.keys() == mj.keys()
    assert mt["episodes"] == mj["episodes"] == 8
    assert mt["success_rate"] == mj["success_rate"]
    assert abs(mt["mean_ep_len"] - mj["mean_ep_len"]) <= 1.0
    assert abs(mt["mean_speed"] - mj["mean_speed"]) <= 0.02
    assert np.isinf(mt["mean_ret0"]) == np.isinf(mj["mean_ret0"])


def test_truncated_run_is_flagged():
    wd = load_world("gen_demo")
    ac = ActorCritic(ModelConfig(rnn_hidden_dim=8, hidden_sizes_ac=(8,),
                                 hidden_sizes_v=(8,)), device="cpu")
    m = evaluate(ac, wd.spec(device="cpu"), EnvParams(num_drones=wd.drone_num),
                 num_episodes=50, num_lanes=2, max_ep_len=5, chunk_len=5,
                 max_chunks=1)
    assert m["truncated"] is True and m["episodes"] == 2


def test_product_policy_under_control_noise(product):
    """Noise-mode eval (the JAX package scores 82 % over 100 episodes,
    runs/w16_r4/results.txt:9): injected noise makes the lanes' episodes
    differ, and the product still completes most of them."""
    _, _, ac, cfg = product
    wd = load_world("world16_dense")
    p = dataclasses.replace(EnvParams(num_drones=wd.drone_num), noise=True)
    m = evaluate(ac, wd.spec(device="cpu"), p,
                 generator=torch.Generator().manual_seed(0),
                 num_episodes=16, num_lanes=16, chunk_len=45, max_chunks=2,
                 action_mode=cfg.train.action_mode)
    assert m["episodes"] == 16
    assert m["std_speed"] > 0 or m["std_ep_len"] > 0
    assert m["success_rate"] >= 0.5, m
