"""The port's committed product policies (rvo3d_tpu_torch/assets/): the
params of runs/w16_r4 epoch 30 and of runs/w32_m3s epoch 5, restored from
Orbax on the JAX side and converted by rvo3d_tpu_torch/utils/convert.py,
in PolicyServer.save's format, with each run's config beside them. The
card has no Orbax and no runs/, so chip_smoke.py trains and scores from
these files. Both must equal a fresh conversion exactly.
"""

import json
import os
from typing import Any, NamedTuple

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu.models import ActorCritic as JActorCritic
from rvo3d_tpu.utils.checkpoint import load_config, restore_checkpoint
from rvo3d_tpu_torch.config import from_dict
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.serving import PolicyServer
from rvo3d_tpu_torch.utils.convert import flax_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "runs", "w16_r4")
ASSETS = os.path.join(REPO, "rvo3d_tpu_torch", "assets")
PARAMS = os.path.join(ASSETS, "w16_r4_e30.pt")
CONFIG = os.path.join(ASSETS, "w16_r4_config.json")
RUN_W32 = os.path.join(REPO, "runs", "w32_m3s")
PARAMS_W32 = os.path.join(ASSETS, "w32_m3s_e5.pt")
CONFIG_W32 = os.path.join(ASSETS, "w32_m3s_config.json")


class _Params(NamedTuple):
    params: Any


def restored_jax_product(run=RUN, epoch=30):
    """(flax ActorCritic, params) of the Orbax step <run>/ckpt/<epoch>."""
    jac = JActorCritic(load_config(run).model)
    template = jac.init(jax.random.PRNGKey(0), jnp.zeros((1, 12)),
                        jnp.zeros((1, 10, 9)), jnp.zeros((1, 10), bool))
    restored, got = restore_checkpoint(os.path.join(run, "ckpt"), _Params(template),
                                       epoch=epoch, params_only=True)
    assert got == epoch
    return jac, restored.params


def converted_product(run=RUN, epoch=30) -> PolicyServer:
    """The Orbax step as a PolicyServer on the CPU
    (`converted_product().save(PARAMS)` writes the asset;
    `converted_product(RUN_W32, 5).save(PARAMS_W32)` the w32 one)."""
    _, params = restored_jax_product(run, epoch)
    with open(os.path.join(run, "config.json")) as f:
        cfg = from_dict(json.load(f))
    ac = ActorCritic(cfg.model, device="cpu")
    ac.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return PolicyServer(ac, nm=cfg.env.neighbor_num)


@pytest.fixture(scope="module")
def product():
    if not os.path.isdir(os.path.join(RUN, "ckpt", "30")):
        pytest.skip("runs/w16_r4 checkpoint not present")
    return converted_product()


def test_committed_params_equal_the_converted_orbax_step(product):
    ref = product.ac.state_dict()
    ckpt = torch.load(PARAMS, map_location="cpu", weights_only=True)
    assert ckpt["nm"] == 10
    assert ckpt["state_dict"].keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(ckpt["state_dict"][k], v), k
    served = PolicyServer.from_checkpoint(PARAMS, device="cpu")
    assert served.ac.cfg == product.ac.cfg


def test_committed_config_equals_the_run_config():
    with open(CONFIG) as f:
        cfg = from_dict(json.load(f))
    with open(os.path.join(RUN, "config.json")) as f:
        ref = from_dict(json.load(f))
    assert cfg == ref
    assert (cfg.world, cfg.env.num_drones, cfg.train.num_envs, cfg.train.minibatch,
            cfg.model.rnn_hidden_dim) == ("world16_dense", 16, 128, 16384, 256)


@pytest.fixture(scope="module")
def product_w32():
    if not os.path.isdir(os.path.join(RUN_W32, "ckpt", "5")):
        pytest.skip("runs/w32_m3s checkpoint not present")
    return converted_product(RUN_W32, 5)


def test_committed_w32_params_equal_the_converted_orbax_step(product_w32):
    ref = product_w32.ac.state_dict()
    ckpt = torch.load(PARAMS_W32, map_location="cpu", weights_only=True)
    assert ckpt["nm"] == 10
    assert ckpt["state_dict"].keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(ckpt["state_dict"][k], v), k
    served = PolicyServer.from_checkpoint(PARAMS_W32, device="cpu")
    assert served.ac.cfg == product_w32.ac.cfg


def test_committed_w32_config_equals_the_run_config():
    with open(CONFIG_W32) as f:
        cfg = from_dict(json.load(f))
    with open(os.path.join(RUN_W32, "config.json")) as f:
        ref = from_dict(json.load(f))
    assert cfg == ref
    assert (cfg.world, cfg.env.num_drones, cfg.train.num_envs, cfg.train.minibatch,
            cfg.model.rnn_hidden_dim, cfg.train.action_mode, cfg.train.vf_encoder) == (
        "world32_mix", 32, 64, 16384, 256, "direct", False)
