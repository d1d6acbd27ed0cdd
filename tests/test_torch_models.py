"""The port's policy (rvo3d_tpu_torch/models) against the JAX ActorCritic
under the same weights, carried across by rvo3d_tpu_torch/utils/convert.py:
mu, std, v, logp and entropy at atol 1e-5 in f32 on ragged neighbour
masks, including all-empty rows, for GRU and biGRU; float64 observations
give the same float32 outputs as flax under jax_enable_x64, at 1e-5; the
converter round trip is exact."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu.config import ModelConfig as JModelConfig
from rvo3d_tpu.models import ActorCritic as JActorCritic
from rvo3d_tpu.models.encoder import NeighborEncoder as JNeighborEncoder
from rvo3d_tpu_torch.config import ModelConfig
from rvo3d_tpu_torch.models import ActorCritic, NeighborEncoder
from rvo3d_tpu_torch.utils.convert import flax_to_state_dict, state_dict_to_flax

NM, ATOL = 10, 1e-5
SMALL = dict(rnn_hidden_dim=32, hidden_sizes_ac=(32, 32), hidden_sizes_v=(32, 32))


def ragged_obs(seed=0, b=7):
    rng = np.random.default_rng(seed)
    obs_self = rng.standard_normal((b, 12)).astype(np.float32)
    nbr = np.zeros((b, NM, 9), np.float32)
    mask = np.zeros((b, NM), bool)
    for i, k in enumerate([0, 1, 3, NM, 5, 0, 2][:b]):
        if k:
            nbr[i, NM - k:] = rng.standard_normal((k, 9))
            mask[i, NM - k:] = True
    return obs_self, nbr, mask


def jax_policy(mode, seed=0, log_std_init=-1.0):
    cfg = JModelConfig(rnn_mode=mode, log_std_init=log_std_init, **SMALL)
    ac = JActorCritic(cfg)
    obs = ragged_obs()
    params = ac.init(jax.random.PRNGKey(seed), *map(jnp.asarray, obs))
    return ac, jax.tree_util.tree_map(np.asarray, params)


def port_policy(mode, np_params, log_std_init=-1.0):
    ac = ActorCritic(ModelConfig(rnn_mode=mode, log_std_init=log_std_init, **SMALL),
                     device="cpu")
    ac.load_state_dict(flax_to_state_dict(np_params))
    return ac


@pytest.mark.parametrize("mode", ["GRU", "biGRU"])
def test_actor_critic_matches_flax(mode):
    jac, params = jax_policy(mode)
    ac = port_policy(mode, params)
    obs = ragged_obs(seed=1)
    act = np.random.default_rng(2).standard_normal((len(obs[0]), 3)).astype(np.float32)
    for std_factor in (1.0, 1e-3):
        mu_j, std_j, v_j = jac.apply(params, *map(jnp.asarray, obs), std_factor)
        logp_j = jac.apply(params, *map(jnp.asarray, obs), jnp.asarray(act),
                           std_factor, method=JActorCritic.logp)
        ent_j = jac.apply(params, std_factor, method=JActorCritic.entropy)
        with torch.no_grad():
            t_obs = [torch.from_numpy(o) for o in obs]
            mu, std, v = ac(*t_obs, std_factor)
            logp = ac.logp(*t_obs, torch.from_numpy(act), std_factor)
            ent = ac.entropy(std_factor)
        for got, ref in ((mu, mu_j), (std, std_j), (v, v_j), (logp, logp_j),
                         (ent, ent_j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                       rtol=1e-6)
    with torch.no_grad():
        v_only = ac.value(*[torch.from_numpy(o) for o in obs])
    np.testing.assert_allclose(v_only.numpy(), np.asarray(v_j), atol=ATOL)


def test_std_clamp_matches_flax():
    jac, params = jax_policy("biGRU", log_std_init=-20.0)
    ac = port_policy("biGRU", params, log_std_init=-20.0)
    obs = ragged_obs()
    _, std_j, _ = jac.apply(params, *map(jnp.asarray, obs), 1e-3)
    with torch.no_grad():
        _, std, _ = ac(*[torch.from_numpy(o) for o in obs], 1e-3)
    np.testing.assert_array_equal(std.numpy(), np.asarray(std_j))
    assert np.all(std.numpy() == np.float32(1e-4))


def test_encoder_empty_mask_uses_last_slot():
    """An all-empty row equals a row whose only valid slot is the last one
    holding zeros (the reference's single zero-row input)."""
    enc = NeighborEncoder(12, 9, 16, "biGRU")
    enc.reset_parameters(torch.Generator().manual_seed(0))
    obs_self = torch.randn(2, 12, generator=torch.Generator().manual_seed(1))
    nbr = torch.zeros(2, NM, 9)
    mask = torch.zeros(2, NM, dtype=torch.bool)
    mask[1, -1] = True
    with torch.no_grad():
        out = enc(obs_self, nbr, mask)
        ref = enc(obs_self[[0]], nbr[[1]], mask[[1]])
    torch.testing.assert_close(out[0], ref[0], rtol=0, atol=0)


def test_encoder_matches_flax_batched_lead():
    """[E, N, nm, 9] observations (the env's layout) through the encoder."""
    jenc = JNeighborEncoder(12, 9, 16, "biGRU")
    rng = np.random.default_rng(3)
    obs_self = rng.standard_normal((3, 4, 12)).astype(np.float32)
    nbr = rng.standard_normal((3, 4, NM, 9)).astype(np.float32)
    mask = rng.random((3, 4, NM)) > 0.6
    params = jenc.init(jax.random.PRNGKey(1), *map(jnp.asarray, (obs_self, nbr, mask)))
    ref = jenc.apply(params, *map(jnp.asarray, (obs_self, nbr, mask)))
    enc = NeighborEncoder(12, 9, 16, "biGRU")
    sd = flax_to_state_dict({"params": {
        "encoder": jax.tree_util.tree_map(np.asarray, params["params"]),
        "actor": {}, "critic": {}, "log_std": np.zeros(3, np.float32)}})
    enc.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()
                         if k.startswith("encoder.")})
    with torch.no_grad():
        out = enc(*map(torch.from_numpy, (obs_self, nbr, mask)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("mode", ["GRU", "biGRU"])
def test_convert_round_trip_is_exact(mode):
    _, params = jax_policy(mode, seed=4)
    back = state_dict_to_flax(flax_to_state_dict(params))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    ac = port_policy(mode, params)
    sd = ac.state_dict()
    sd2 = flax_to_state_dict(state_dict_to_flax(sd))
    assert sd.keys() == sd2.keys()
    for k in sd:
        torch.testing.assert_close(sd[k], sd2[k], rtol=0, atol=0)


def test_init_is_reproducible_from_generator():
    cfg = ModelConfig(**SMALL)
    a = ActorCritic(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    b = ActorCritic(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    bound = 1.0 / np.sqrt(cfg.rnn_hidden_dim)
    assert a.encoder.fwd.w_hh.abs().max() <= bound


def test_unported_modes_raise():
    """LSTM and bfloat16 are ported (tests/test_torch_lstm.py,
    tests/test_torch_dtypes.py); what neither package has raises."""
    with pytest.raises(ValueError, match="rnn mode"):
        ActorCritic(ModelConfig(rnn_mode="RNN", **SMALL), device="cpu")
    for field in ("compute_dtype", "param_dtype"):
        with pytest.raises(ValueError, match="float16"):
            ActorCritic(ModelConfig(**{field: "float16"}, **SMALL), device="cpu")


@pytest.mark.parametrize("mode", ["GRU", "biGRU"])
def test_float64_observations_match_flax_under_x64(mode):
    """Float64 observations (a float64 env's) are cast to the parameters'
    float32, as the flax modules cast them: mu, std and v come back
    float32 and equal flax's under jax_enable_x64 at atol 1e-5."""
    jac, params = jax_policy(mode)
    ac = port_policy(mode, params)
    obs_self, nbr, mask = ragged_obs(seed=5)
    obs64 = (obs_self.astype(np.float64) + 1e-9, nbr.astype(np.float64), mask)
    with jax.enable_x64(True):
        ref = jac.apply(params, *map(jnp.asarray, obs64), 1.0)
        v_ref = jac.apply(params, *map(jnp.asarray, obs64), method=JActorCritic.value)
    with torch.no_grad():
        t_obs = [torch.from_numpy(o) for o in obs64]
        got = ac(*t_obs)
        v_only = ac.value(*t_obs)
    for g, r in zip(got + (v_only,), tuple(ref) + (v_ref,)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=1e-6)
