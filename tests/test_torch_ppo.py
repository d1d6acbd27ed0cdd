"""The port's PPO learner (rvo3d_tpu_torch/algo/ppo.py) against the JAX
package's (rvo3d_tpu/algo/ppo.py) with the same params (converted from
flax), the same batch (made with numpy) and the JAX minibatch offsets and
agent order injected into the port. Small policy: H = 16, heads (32, 32).

  - optimizer masks: the port's two Adams hold exactly the parameters the
    JAX optimizers move, for the default, vf_encoder=False and
    freeze_encoder settings;
  - update_one_agent (log_std -1, minibatch windows): params after the
    update, first_loss, kl, iters and v_loss at rtol 1e-4 (plus atol 1e-6
    for params and first_loss, which with adv_norm is a mean of zero-mean
    advantages, ~1e-8, and 1e-7 for kl, which starts near 0); the same with the
    gradient clipped (|g| > grad_clip_norm), and with the KL stop at
    iteration 0 and at a later iteration (iters exact);
  - ppo_update and the resume from a JAX optimizer state:
    tests/test_torch_ppo_schedule.py.
"""


import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu.algo import ppo as jppo
from rvo3d_tpu.config import ModelConfig as JModelConfig
from rvo3d_tpu.config import TrainConfig as JTrainConfig
from rvo3d_tpu.models import ActorCritic as JActorCritic
from rvo3d_tpu_torch.algo import ppo
from rvo3d_tpu_torch.config import ModelConfig, TrainConfig
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils.convert import flax_to_state_dict, state_dict_to_flax

NM = 10
SMALL = dict(rnn_hidden_dim=16, hidden_sizes_ac=(32, 32), hidden_sizes_v=(32, 32))
BASE = dict(pi_lr=3e-3, vf_lr=3e-3, train_pi_iters=4, train_v_iters=3,
            minibatch=40, target_kl=0.05)
RTOL = 1e-4


def configs(**kw):
    kw = {**BASE, **kw}
    return JTrainConfig(**kw), TrainConfig(**kw)


def obs_batch(rng, lead):
    obs_self = rng.standard_normal(lead + (12,)).astype(np.float32)
    nbr = rng.standard_normal(lead + (NM, 9)).astype(np.float32)
    k = rng.integers(0, NM + 1, lead)
    mask = np.arange(NM) >= (NM - k)[..., None]      # valid slots at the end
    nbr[~mask] = 0.0
    return obs_self, nbr, mask


JAC = JActorCritic(JModelConfig(**SMALL))


@functools.lru_cache(maxsize=None)
def _init(seed):
    return jax.jit(JAC.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 12)),
                             jnp.zeros((1, NM, 9)), jnp.zeros((1, NM), bool))


def policies(seed=0):
    """(flax module, its params, the port's policy with the same params)."""
    jac, params = JAC, _init(seed)
    ac = ActorCritic(ModelConfig(**SMALL), device="cpu")
    ac.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jac, params, ac


def make_data(jac, params, lead, seed=1, logp_shift=0.0):
    """AgentData as numpy, leaves lead + (...): rollout-like actions drawn
    around the policy mean, their logp (+ logp_shift), random adv/ret/val."""
    rng = np.random.default_rng(seed)
    obs = obs_batch(rng, lead)
    mu, std, v = jax.jit(jac.apply)(params, *map(jnp.asarray, obs))
    act = np.round(np.asarray(mu) + np.asarray(std)
                   * rng.standard_normal(lead + (3,)), 2).astype(np.float32)
    logp = np.asarray(jax.jit(functools.partial(jac.apply, method=JActorCritic.logp))(
        params, *map(jnp.asarray, obs), jnp.asarray(act))) + logp_shift
    return dict(obs_self=obs[0], obs_nbr=obs[1], obs_mask=obs[2], act=act,
                adv=rng.standard_normal(lead).astype(np.float32),
                ret=rng.standard_normal(lead).astype(np.float32),
                logp=logp.astype(np.float32),
                val=np.asarray(v) + 0.1 * rng.standard_normal(lead).astype(np.float32))


def as_jax(d):
    return jppo.AgentData(**{k: jnp.asarray(v) for k, v in d.items()})


def as_port(d):
    return ppo.AgentData(**{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _windows(key, n, salt, hi):
    return jax.vmap(lambda i: jax.random.randint(
        jax.random.fold_in(jax.random.fold_in(key, salt), i), (), 0, hi))(jnp.arange(n))


def jax_offsets(cfg, key, b):
    """The windows jppo.update_one_agent draws from `key`."""
    if not 0 < cfg.minibatch < b:
        return None
    hi = b - cfg.minibatch + 1
    return (np.asarray(_windows(key, cfg.train_pi_iters, 0, hi)).tolist(),
            np.asarray(_windows(key, cfg.train_v_iters, 1, hi)).tolist())


def jax_state(jcfg, params):
    pi_tx, vf_tx = jppo.make_optimizers(jcfg, params)
    return pi_tx, vf_tx, jppo.PPOState(params, pi_tx.init(params), vf_tx.init(params))


def assert_params_match(ac, jparams):
    got = state_dict_to_flax(ac.state_dict())
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def assert_metrics_match(got, ref):
    first_loss, v_loss, kl, iters = ref
    assert int(got[3]) == int(iters)
    np.testing.assert_allclose(float(got[0]), float(first_loss), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(float(got[1]), float(v_loss), rtol=RTOL)
    np.testing.assert_allclose(float(got[2]), float(kl), rtol=RTOL, atol=1e-7)


def run_both_one_agent(jcfg, tcfg, data, key=jax.random.PRNGKey(7), seed=0):
    jac, params, ac = policies(seed)
    pi_tx, vf_tx, state = jax_state(jcfg, params)
    jd = as_jax(data)
    new_state, jm = jax.jit(lambda s, d: jppo.update_one_agent(
        jac, jcfg, pi_tx, vf_tx, s, d, key=key))(state, jd)
    pi_opt, vf_opt = ppo.make_optimizers(tcfg, ac)
    got = ppo.update_one_agent(ac, tcfg, pi_opt, vf_opt, as_port(data),
                               offsets=jax_offsets(jcfg, key, data["act"].shape[0]))
    return ac, new_state, got, jm


@pytest.mark.parametrize("flag", ["default", "vf_encoder", "freeze_encoder"])
def test_optimizer_masks_match_jax(flag):
    kw = {"vf_encoder": {"vf_encoder": False},
          "freeze_encoder": {"freeze_encoder": True}}.get(flag, {})
    jcfg, tcfg = configs(**kw)
    jac, params, ac = policies()
    pi_tx, vf_tx = jppo.make_optimizers(jcfg, params)
    names = dict((id(p), n) for n, p in ac.named_parameters())

    def loss_like_grads(phase):
        # each loss has exact-zero gradients on the other head (what makes
        # optax.masked's passthrough harmless), ones elsewhere
        def g(path, v):
            k = jax.tree_util.keystr(path)
            other = ("critic",) if phase == "pi" else ("actor", "log_std")
            return jnp.zeros_like(v) if any(o in k for o in other) else jnp.ones_like(v)
        return jax.tree_util.tree_map_with_path(g, params)

    for phase, tx, opt in zip(("pi", "vf"), (pi_tx, vf_tx),
                              ppo.make_optimizers(tcfg, ac)):
        upd, _ = jax.jit(tx.update)(loss_like_grads(phase), tx.init(params), params)
        moved = {n for n, u in flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, upd)).items() if np.any(u.numpy() != 0)}
        held = {names[id(p)] for g in opt.param_groups for p in g["params"]}
        assert held == moved, (phase, held ^ moved)
    pi, vf = ppo.optimizer_masks(tcfg, ac)
    assert ("critic.layers.0.weight" in pi) is False
    assert ("encoder.fwd.w_hh" in vf) == (flag == "default")
    assert ("encoder.fwd.w_hh" in pi) == (flag != "freeze_encoder")


@pytest.mark.parametrize("case", ["plain", "clipped", "adv_norm_value_clip",
                                  "fresh_logp_ent"])
def test_update_one_agent_matches_jax(case):
    kw = {"clipped": dict(grad_clip_norm=1e-3),
          "adv_norm_value_clip": dict(adv_norm=True, value_clip=0.05),
          "fresh_logp_ent": dict(fresh_logp=True, ent_coef=0.01)}.get(case, {})
    jcfg, tcfg = configs(**kw)
    jac, params, _ = policies()
    data = make_data(jac, params, (96,))
    ac, new_state, got, jm = run_both_one_agent(jcfg, tcfg, data)
    assert int(got[3]) > 0                              # policy steps applied
    assert_metrics_match(got, jm)
    assert_params_match(ac, new_state.params)
    if case == "clipped":
        # the clip was active: the first step's gradient norm exceeds it
        ac0 = policies()[2]
        ac0.zero_grad()
        loss, _, _ = ppo.pi_loss_fn(ac0, as_port(data).window(
            jax_offsets(jcfg, jax.random.PRNGKey(7), 96)[0][0], 40), 0.2)
        loss.backward()
        pi_params = [p for g in ppo.make_optimizers(tcfg, ac0)[0].param_groups
                     for p in g["params"]]
        norm = ppo.clip_by_global_norm_(pi_params, tcfg.grad_clip_norm)
        assert float(norm) > tcfg.grad_clip_norm
        clipped = torch.sqrt(sum((p.grad ** 2).sum() for p in pi_params))
        np.testing.assert_allclose(float(clipped), tcfg.grad_clip_norm, rtol=1e-5)


@pytest.mark.parametrize("shift,target_kl,expect", [(0.5, 0.05, 0), (0.0, 2e-3, None)])
def test_kl_stop_matches_jax(shift, target_kl, expect):
    """shift 0.5: iteration 0's kl is 0.5 > target, nothing moves. A small
    target stops at a later iteration."""
    jcfg, tcfg = configs(target_kl=target_kl, train_pi_iters=10, pi_lr=1e-2)
    jac, params, _ = policies()
    data = make_data(jac, params, (96,), logp_shift=shift)
    ac, new_state, got, jm = run_both_one_agent(jcfg, tcfg, data)
    iters = int(got[3])
    if expect is not None:
        assert iters == expect
        # no policy step: the actor and log_std are untouched
        ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
        for n, p in ac.named_parameters():
            if n.startswith(("actor.", "log_std")):
                assert torch.equal(p.detach(), ref[n]), n
    else:
        assert 0 < iters < 10
    assert_metrics_match(got, jm)
    assert_params_match(ac, new_state.params)
