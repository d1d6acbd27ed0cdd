"""The port's bfloat16 policy configurations against the JAX package's
(ModelConfig.param_dtype / compute_dtype), with flax params converted:

  - compute_dtype bfloat16, params float32, for GRU, biGRU and LSTM: mu and
    v within 1e-2 of JAX's bfloat16 forward, and within the JAX test's own
    bounds of the float32 forward (mu 0.05, v 0.2; tests/test_models.py);
    mu, std and v are float32, the parameters stay float32, the LSTM and
    the encoder's output are bfloat16;
  - the GRU directions take bfloat16-rounded operands and run the float32
    scan (the kernel's rule): the encoder equals that emulation exactly;
  - param_dtype bfloat16: recurrent and dense weights are stored in
    bfloat16, LayerNorm and log_std in float32, and the forward is within
    1e-2 of JAX's under the same dtypes;
  - a bfloat16 LSTM policy round-trips through PolicyServer.save /
    from_checkpoint and through a training checkpoint (from_torch).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu.config import ModelConfig as JModelConfig
from rvo3d_tpu.models import ActorCritic as JActorCritic
from rvo3d_tpu_torch.config import Config, ModelConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.ops.masked_gru import masked_bigru_scan_plain
from rvo3d_tpu_torch.serving import PolicyServer
from rvo3d_tpu_torch.utils.convert import flax_to_state_dict
from torch_threads import one_intra_op_thread  # noqa: F401

B, NM = 256, 10
WIDTH = dict(rnn_hidden_dim=64, hidden_sizes_ac=(64, 64), hidden_sizes_v=(64, 64))
BF16_ATOL = 1e-2
F32_BOUND = {"mu": 0.05, "v": 0.2}


def observations(seed=0):
    rng = np.random.default_rng(seed)
    obs_self = rng.standard_normal((B, 12)).astype(np.float32)
    nbr = rng.standard_normal((B, NM, 9)).astype(np.float32)
    mask = rng.random((B, NM)) > 0.3
    mask[:8] = False                                  # rows with no neighbour
    nbr[~mask] = 0.0
    return obs_self, nbr, mask


def both(mode, param_dtype="float32", compute_dtype="bfloat16"):
    """(JAX module, its params as numpy, the port's policy with them)."""
    kw = dict(rnn_mode=mode, param_dtype=param_dtype, compute_dtype=compute_dtype, **WIDTH)
    jac = JActorCritic(JModelConfig(**kw))
    params = jac.init(jax.random.PRNGKey(0), *map(jnp.asarray, observations()))
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
    ac = ActorCritic(ModelConfig(**kw), device="cpu")
    ac.load_state_dict(flax_to_state_dict(params))
    return jac, params, ac


def forward_np(ac, obs):
    with torch.no_grad():
        mu, std, v = ac(*map(torch.from_numpy, obs))
    for x in (mu, std, v):
        assert x.dtype == torch.float32
    return mu.numpy(), v.numpy()


@pytest.mark.parametrize("mode", ["GRU", "biGRU", "LSTM"])
def test_bf16_compute_matches_jax(mode):
    jac16, params, ac = both(mode)
    jac32 = JActorCritic(dataclasses.replace(jac16.cfg, compute_dtype="float32"))
    obs = observations(seed=1)
    mu, v = forward_np(ac, obs)
    for jac, bound in ((jac16, {"mu": BF16_ATOL, "v": BF16_ATOL}), (jac32, F32_BOUND)):
        mu_j, _, v_j = jac.apply(params, *map(jnp.asarray, obs))
        np.testing.assert_allclose(mu, np.asarray(mu_j, np.float32), atol=bound["mu"], rtol=0)
        np.testing.assert_allclose(v, np.asarray(v_j, np.float32), atol=bound["v"], rtol=0)
    assert all(p.dtype == torch.float32 for p in ac.parameters())
    seen = {}
    ac.encoder.fwd.register_forward_hook(lambda m, i, o: seen.update(rnn=o.dtype))
    with torch.no_grad():
        feat = ac.encoder(*map(torch.from_numpy, obs))
    assert feat.dtype == torch.bfloat16
    if mode != "biGRU":        # the biGRU calls the scan on both cores' weights
        assert seen["rnn"] == (torch.bfloat16 if mode == "LSTM" else torch.float32)


def test_bf16_gru_operands_are_rounded_for_the_float32_scan():
    _, _, ac = both("biGRU")
    obs_self, nbr, mask = map(torch.from_numpy, observations(seed=2))
    bf = torch.bfloat16
    enc = ac.encoder

    def rounded(core):
        return [w.detach().to(bf).float() for w in (core.w_ih, core.w_hh, core.b_ih, core.b_hh)]
    m = torch.where(mask.any(-1, keepdim=True), mask, torch.arange(NM) == NM - 1)
    xs = nbr.to(bf).float().transpose(0, 1)
    hn = masked_bigru_scan_plain(xs, m.float().t(), rounded(enc.fwd), rounded(enc.bwd))
    feat = torch.cat([obs_self.to(bf), hn.to(bf)], -1)
    want = torch.nn.functional.layer_norm(feat.float(), feat.shape[-1:], enc.ln.weight,
                                          enc.ln.bias, 1e-5).to(bf)
    with torch.no_grad():
        got = enc(obs_self, nbr, mask)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["biGRU", "LSTM"])
def test_bf16_params_match_jax(mode):
    jac, params, ac = both(mode, param_dtype="bfloat16")
    dtypes = {n: p.dtype for n, p in ac.named_parameters()}
    for name, dt in dtypes.items():
        keep_f32 = name.startswith("encoder.ln") or name == "log_std"
        assert dt == (torch.float32 if keep_f32 else torch.bfloat16), name
    obs = observations(seed=3)
    mu, v = forward_np(ac, obs)
    mu_j, _, v_j = jac.apply(params, *map(jnp.asarray, obs))   # bfloat16 values
    np.testing.assert_allclose(mu, np.asarray(mu_j, np.float32), atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(v, np.asarray(v_j, np.float32), atol=BF16_ATOL, rtol=0)


def test_bf16_lstm_policy_round_trips(tmp_path):
    from rvo3d_tpu_torch.algo.ppo import make_optimizers, PPOState
    from rvo3d_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = ModelConfig(rnn_mode="LSTM", param_dtype="bfloat16", compute_dtype="bfloat16",
                      **WIDTH)
    ac = ActorCritic(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    obs = observations(seed=4)
    want = PolicyServer(ac).act(*obs)
    path = str(tmp_path / "policy.pt")
    PolicyServer(ac).save(path)
    loaded = PolicyServer.from_checkpoint(path, device="cpu")
    assert loaded.ac.cfg == cfg
    np.testing.assert_array_equal(loaded.act(*obs), want)

    run_cfg = Config(model=cfg)
    pi, vf = make_optimizers(run_cfg.train, ac)
    save_checkpoint(str(tmp_path / "run" / "ckpt"), 0, PPOState(ac, pi, vf), run_cfg)
    served = PolicyServer.from_torch(str(tmp_path / "run"), device="cpu")
    assert served.ac.cfg == cfg and served.epoch == 0
    assert served.ac.encoder.fwd.w_hh.dtype == torch.bfloat16
    np.testing.assert_array_equal(served.act(*obs), want)
