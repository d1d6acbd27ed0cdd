"""The port's LSTM encoder mode against the JAX package's, with flax params
converted by rvo3d_tpu_torch/utils/convert.py (the LSTM's fwd/{w_ih, w_hh,
b_ih, b_hh} are [IN, 4H], [H, 4H], [4H], [4H] on both sides):

  - LSTMCore against flax's _LSTMCore on ragged masks, empty rows included
    (the carry moves only on valid slots; h_n is the output), at 1e-5;
  - ActorCritic(rnn_mode="LSTM") against flax's: mu, std, v and logp at
    1e-5 on ragged and empty neighbour masks, and the round trip of the
    converter is exact;
  - one ppo_update (batched and sequential) against JAX's with the JAX
    agent order and minibatch offsets injected, at the tolerances of
    tests/test_torch_ppo.py (rtol 1e-4).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu.algo import ppo as jppo
from rvo3d_tpu.config import ModelConfig as JModelConfig
from rvo3d_tpu.models import ActorCritic as JActorCritic
from rvo3d_tpu.models.encoder import _LSTMCore
from rvo3d_tpu_torch.algo import ppo
from rvo3d_tpu_torch.config import ModelConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.models.encoder import LSTMCore
from rvo3d_tpu_torch.utils.convert import flax_to_state_dict, state_dict_to_flax
from test_torch_models import ragged_obs
from test_torch_ppo import (as_jax, as_port, assert_metrics_match, assert_params_match,
                            configs, jax_offsets, jax_state, make_data)
from torch_threads import one_intra_op_thread  # noqa: F401

ATOL = 1e-5
SMALL = dict(rnn_hidden_dim=16, hidden_sizes_ac=(32, 32), hidden_sizes_v=(32, 32),
             rnn_mode="LSTM")
JAC = JActorCritic(JModelConfig(**SMALL))


@functools.lru_cache(maxsize=None)
def _init(seed):
    return jax.jit(JAC.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 12)),
                             jnp.zeros((1, 10, 9)), jnp.zeros((1, 10), bool))


def policies(seed=0):
    params = _init(seed)
    ac = ActorCritic(ModelConfig(**SMALL), device="cpu")
    ac.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return JAC, params, ac


def test_lstm_core_matches_flax():
    s_len, b, in_dim, hidden = 10, 7, 9, 24
    core = _LSTMCore(in_dim, hidden)
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((s_len, b, in_dim)).astype(np.float32)
    mask = np.zeros((s_len, b), bool)
    for col, k in enumerate([0, 1, 3, 10, 5, 0, 2]):       # valid slots at the end
        mask[s_len - k:, col] = True
    mask[2, 4] = True                                     # and one hole-y row
    params = core.init(jax.random.PRNGKey(1), jnp.asarray(xs), jnp.asarray(mask))
    ref = np.asarray(core.apply(params, jnp.asarray(xs), jnp.asarray(mask)))
    port = LSTMCore(in_dim, hidden)
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in params["params"].items()})
    with torch.no_grad():
        got = port(torch.from_numpy(xs), torch.from_numpy(mask).float())
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    assert np.all(ref[5] == 0.0) and np.all(got[5].numpy() == 0.0)   # no valid slot


def test_lstm_actor_critic_matches_flax():
    jac, params, ac = policies()
    np_params = jax.tree_util.tree_map(np.asarray, params)
    assert set(np_params["params"]["encoder"]) == {"fwd", "ln"}
    back = state_dict_to_flax(ac.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    obs = ragged_obs(seed=3)
    assert not obs[2][0].any() and not obs[2][5].any()    # empty rows
    act = np.random.default_rng(4).standard_normal((len(obs[0]), 3)).astype(np.float32)
    mu_j, std_j, v_j = jac.apply(params, *map(jnp.asarray, obs), 1.0)
    logp_j = jac.apply(params, *map(jnp.asarray, obs), jnp.asarray(act), 1.0,
                       method=JActorCritic.logp)
    with torch.no_grad():
        t_obs = [torch.from_numpy(o) for o in obs]
        mu, std, v = ac(*t_obs)
        logp = ac.logp(*t_obs, torch.from_numpy(act))
    for got, ref in ((mu, mu_j), (std, std_j), (v, v_j), (logp, logp_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("batched", [True, False])
def test_lstm_ppo_update_matches_jax(batched):
    jcfg, tcfg = configs(batched_update=batched, max_update_num=2, minibatch=24)
    jac, params, ac = policies()
    data = make_data(jac, params, (8, 2, 3))            # [T, E, N]
    key = jax.random.PRNGKey(11)
    pi_tx, vf_tx, state = jax_state(jcfg, params)
    new_state, jm = jax.jit(lambda s, d: jppo.ppo_update(
        jac, jcfg, pi_tx, vf_tx, s, d, key))(state, as_jax(data))
    if batched:
        perm, offsets = None, [jax_offsets(jcfg, key, 48)]
    else:
        perm = np.asarray(jax.random.permutation(key, 3)).tolist()
        offsets = [jax_offsets(jcfg, jax.random.fold_in(key, k), 16) for k in range(2)]
    pi_opt, vf_opt = ppo.make_optimizers(tcfg, ac)
    got = ppo.ppo_update(ac, tcfg, pi_opt, vf_opt, as_port(data), perm=perm,
                         offsets=offsets)
    for k in range(1 if batched else 2):
        assert_metrics_match([x[k] for x in got], [x[k] for x in jm])
    assert int(sum(got.pi_iters)) > 0
    assert_params_match(ac, new_state.params)
