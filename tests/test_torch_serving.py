"""The port's PolicyServer (rvo3d_tpu_torch/serving.py) against the JAX
PolicyServer on the same params: act and act_flat (the reference's flat
layout, zero blocks as padding) at atol 1e-5 in f32, plus the port's own
checkpoint round trip and stochastic serving."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu.config import ModelConfig as JModelConfig
from rvo3d_tpu.models import ActorCritic as JActorCritic
from rvo3d_tpu.serving import PolicyServer as JPolicyServer
from rvo3d_tpu_torch.config import ModelConfig
from rvo3d_tpu_torch.serving import PolicyServer

NM, ATOL = 10, 1e-5
SMALL = dict(rnn_hidden_dim=16, hidden_sizes_ac=(16,), hidden_sizes_v=(16,))


def rand_obs(rng, b, k):
    obs_self = rng.normal(size=(b, 12)).astype(np.float32)
    nbr = np.zeros((b, NM, 9), np.float32)
    mask = np.zeros((b, NM), bool)
    if k:
        nbr[:, NM - k:] = rng.normal(size=(b, k, 9))
        mask[:, NM - k:] = True
    return obs_self, nbr, mask


@pytest.fixture(scope="module")
def servers():
    jac = JActorCritic(JModelConfig(**SMALL))
    obs = rand_obs(np.random.default_rng(0), 2, 3)
    params = jac.init(jax.random.PRNGKey(0), *map(jnp.asarray, obs))
    jsrv = JPolicyServer(jac, params, nm=NM)
    tsrv = PolicyServer.from_numpy_params(
        jax.tree_util.tree_map(np.asarray, params), ModelConfig(**SMALL),
        device="cpu", nm=NM)
    return jsrv, tsrv


@pytest.mark.parametrize("b,k", [(1, 0), (5, 3), (64, NM)])
def test_act_matches_jax(servers, b, k):
    jsrv, tsrv = servers
    obs = rand_obs(np.random.default_rng(b + k), b, k)
    np.testing.assert_allclose(tsrv.act(*obs), jsrv.act(*map(jnp.asarray, obs)),
                               atol=ATOL)


@pytest.mark.parametrize("k", [0, 2, NM])
def test_act_flat_matches_jax(servers, k):
    jsrv, tsrv = servers
    b = 4
    obs_self, nbr, _ = rand_obs(np.random.default_rng(k), b, k)
    flat = np.concatenate([obs_self, nbr[:, NM - k:].reshape(b, -1)], axis=1)
    if k == 0:  # the reference's zero-fill rule: no neighbours -> one zero block
        flat = np.concatenate([obs_self, np.zeros((b, 9), np.float32)], axis=1)
    got = tsrv.act_flat(flat)
    np.testing.assert_allclose(got, jsrv.act_flat(flat), atol=ATOL)
    assert got.shape == (b, 3)


def test_checkpoint_round_trip(servers, tmp_path):
    _, tsrv = servers
    path = str(tmp_path / "policy.pt")
    tsrv.save(path)
    back = PolicyServer.from_checkpoint(path, device="cpu")
    assert back.nm == tsrv.nm and back.ac.cfg == tsrv.ac.cfg
    obs = rand_obs(np.random.default_rng(9), 6, 4)
    np.testing.assert_array_equal(back.act(*obs), tsrv.act(*obs))


def test_stochastic_serving_needs_a_generator(servers):
    _, tsrv = servers
    srv = PolicyServer(tsrv.ac, nm=NM, std_factor=1.0, deterministic=False)
    obs = rand_obs(np.random.default_rng(3), 8, 2)
    with pytest.raises(ValueError):
        srv.act(*obs)
    a1 = srv.act(*obs, generator=torch.Generator().manual_seed(1))
    a2 = srv.act(*obs, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a1, a2)
    assert not np.allclose(a1, tsrv.act(*obs))


def test_default_device_is_cuda():
    """Without a card, an entry point raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        PolicyServer.from_numpy_params({}, ModelConfig(**SMALL))
