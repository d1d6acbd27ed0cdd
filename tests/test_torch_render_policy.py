"""record_trajectory of the w16_r4 product in the port against the JAX
package's: gen_demo, 60 steps, float32, the product flown through the
CLI's policy controller (the training mapping, std factor 1e-3) with the
JAX controller's draws injected; positions and rewards within 1e-5 (the
float32 env's distance from the JAX step, tests/test_torch_env.py), flags
and masks equal. (The waypoint controller's run, and the tolerances'
reasons, are in tests/test_torch_render.py.)"""

import json
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from rvo3d_tpu import cli as jcli
from rvo3d_tpu.models import ActorCritic as JActorCritic
from rvo3d_tpu.render import record_trajectory as j_record
from rvo3d_tpu_torch import cli
from rvo3d_tpu_torch.config import from_dict
from rvo3d_tpu_torch.render import record_trajectory
from rvo3d_tpu_torch.serving import PolicyServer
from rvo3d_tpu_torch.utils.convert import state_dict_to_flax
from test_torch_render import STEPS, _envs, _same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "rvo3d_tpu_torch", "assets")


def test_product_trajectory_with_jax_draws_matches_jax():
    server = PolicyServer.from_checkpoint(os.path.join(ASSETS, "w16_r4_e30.pt"), device="cpu")
    with open(os.path.join(ASSETS, "w16_r4_config.json")) as f:
        cfg = from_dict(json.load(f))
    mode = cfg.train.action_mode
    env, jenv = _envs()
    n = env.world.num_drones
    # the JAX controller's draws: split the key each step, normal [N, 3]
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(STEPS):
        key, k = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(k, (n, 3), jnp.float32)))
    it = iter(draws)
    controller = cli._policy_controller(
        server.ac, env.params, action_mode=mode,
        randn=lambda shape: torch.tensor(next(it)).reshape(shape))
    got = record_trajectory(env, controller, steps=STEPS)
    jac = JActorCritic(cfg.model)
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(server.ac.state_dict()))
    jctrl = jcli._policy_controller(jac, params, jenv.params, action_mode=mode)
    ref = j_record(jenv, jctrl, steps=STEPS)
    _same(got, ref)
