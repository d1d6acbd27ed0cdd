"""The port's behavior cloning (rvo3d_tpu_torch/algo/bc.py) against the JAX
package's rvo3d_tpu/algo/bc.py, and its behaviour on inline worlds.

  - collect_demos with JAX's draws injected (the DART normals and the
    env's control-noise normals, computed from the JAX keys) equals JAX's
    dataset on a 2-drone crossing world in float32 (JAX resets demos in
    float32): obs and targets at 1e-5, masks exactly. Cases: the waypoint
    expert in increment mode, the RVO expert (margin 0.3, slowdown) in
    direct mode with DART noise, the RVO expert in increment mode with
    the env's noise, and a behavior_fn (a converted flax policy) driving
    the rollout.
  - bc_pretrain with JAX's demo draws and minibatch indices injected
    (computed from the JAX key schedule: round, then world) equals JAX's
    params and final loss at rtol 1e-4 (atol 1e-6 on params) over 20 fit
    steps a round and one DAgger round, with conflict_weight 1 and 30.
  - Behaviour (port only, inline worlds): demo shapes and label range;
    the loss converges and the clone accelerates from rest in both action
    modes; env_noise widens the visited states; a mixed two-world set
    (a world and its reversal) fits and moves the params.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu.algo import bc as jbc
from rvo3d_tpu.config import EnvParams as JEnvParams
from rvo3d_tpu.env.state import make_world_spec as j_make_world_spec
from rvo3d_tpu.worlds.multi import reverse_routes as j_reverse_routes
from rvo3d_tpu_torch.algo import bc
from rvo3d_tpu_torch.config import EnvParams, ModelConfig
from rvo3d_tpu_torch.env import DroneEnv
from rvo3d_tpu_torch.env.state import make_world_spec
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.worlds.multi import reverse_routes
from test_torch_ppo import assert_params_match
from test_torch_rollout import close, np_, policies
from torch_threads import one_intra_op_thread  # noqa: F401

WPS = [[[1.0, 5.0, 2.0], [8.0, 5.0, 2.5]],      # near head-on: 0.3 m apart
       [[8.0, 5.3, 2.0], [1.0, 5.3, 2.5]]]
MAP = [10, 10, 5]


def worlds():
    return (j_make_world_spec(WPS, [], MAP),
            make_world_spec(WPS, [], MAP, device="cpu"))


class JaxDraws:
    """Hands out, in call order, the standard normals of the JAX
    collect_demos body for the given per-step keys (per-lane keys for the
    env noise)."""

    def __init__(self):
        self.queue = []

    def add_demo(self, key, steps, shape, explore, env_noise):
        for k in jax.random.split(key, steps):
            if explore:
                self.queue.append(("explore", np.asarray(jax.random.normal(k, shape))))
            if env_noise:
                lanes = jax.random.split(jax.random.fold_in(k, 1), shape[0])
                self.queue.append(("env", np.stack([
                    np.asarray(jax.random.normal(lk, shape[1:], jnp.float32))
                    for lk in lanes])))

    def __call__(self, kind, shape):
        got, x = self.queue.pop(0)
        assert got == kind and x.shape == shape, (got, kind, x.shape, shape)
        return torch.from_numpy(x.copy())


E, N, STEPS = 3, 2, 12
CASES = {
    "waypoint_increment": dict(expert="waypoint", action_mode="increment"),
    "rvo_direct_dart": dict(expert="rvo", action_mode="direct", explore_std=0.1,
                            expert_margin=0.3, expert_slowdown=True),
    "rvo_increment_env_noise": dict(expert="rvo", action_mode="increment",
                                    env_noise=True),
    "rvo_direct_behavior": dict(expert="rvo", action_mode="direct", explore_std=0.1,
                                behavior=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_collect_demos_matches_jax(case):
    kw = dict(CASES[case])
    behavior = kw.pop("behavior", False)
    jw, tw = worlds()
    p = dict(num_drones=N, control_std=0.06)
    key = jax.random.PRNGKey(3)
    jkw, tkw = dict(kw), dict(kw)
    if behavior:
        jac, params, ac = policies(seed=1)
        jkw["behavior_fn"] = lambda s, nb, m: jac.apply(params, s, nb, m)[0]
        tkw["behavior_fn"] = lambda s, nb, m: ac(s, nb, m)[0]
    ref = jbc.collect_demos(jw, JEnvParams(**p), E, STEPS, key, **jkw)
    draws = JaxDraws()
    draws.add_demo(key, STEPS, (E, N, 3), kw.get("explore_std", 0.0) > 0,
                   kw.get("env_noise", False))
    got = bc.collect_demos(tw, EnvParams(**p), E, STEPS, randn=draws, **tkw)
    assert not draws.queue
    for name, a, b in zip(("obs_self", "obs_nbr", "obs_mask", "target"), got, ref):
        assert a.shape == b.shape, name
        if name == "obs_mask":
            np.testing.assert_array_equal(np_(a), np.asarray(b), err_msg=name)
        else:
            close(a, b, 1e-5, msg=name)
    # the drones fly: real commands, and positions left the starts
    assert np.abs(np_(got[3])).max() > 0.1
    pos = np_(got[0]).reshape(STEPS, E * N, 12)[..., 0:3]
    assert np.abs(pos - pos[0]).max() > 1.0


@pytest.mark.parametrize("conflict_weight", [1.0, 30.0])
def test_bc_pretrain_matches_jax(conflict_weight):
    jw, tw = worlds()
    jp, tp = JEnvParams(num_drones=N), EnvParams(num_drones=N)
    jac, params, ac = policies(seed=2)
    kw = dict(num_envs=E, demo_steps=STEPS, train_steps=20, batch=64, lr=1e-3,
              expert="rvo", action_mode="direct", explore_std=0.1, expert_margin=0.3,
              dagger_rounds=1, conflict_weight=conflict_weight)
    key = jax.random.PRNGKey(5)
    jparams, jloss = jbc.bc_pretrain(jac, params, jw, jp, key, **kw)

    # the JAX key schedule: per round split(key, 3) -> (round, train, key);
    # per world split(round) -> (round', demo); per fit step split(train)
    draws, idx = JaxDraws(), {}
    cap = STEPS * E * N * 2
    k = key
    for r in range(2):
        k_round, k_train, k = jax.random.split(k, 3)
        k_round, k_demo = jax.random.split(k_round)
        draws.add_demo(k_demo, STEPS, (E, N, 3), True, False)
        n_valid = STEPS * E * N * (r + 1)
        for s in range(20):
            k_train, ks = jax.random.split(k_train)
            idx[(r, s)] = torch.from_numpy(np.asarray(
                jax.random.randint(ks, (min(64, cap),), 0, n_valid)).astype(np.int64))
    loss = bc.bc_pretrain(ac, tw, tp, torch.Generator(), randn=draws,
                          indices=lambda r, s: idx[(r, s)], **kw)
    assert not draws.queue
    assert_params_match(ac, jparams)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)


def small_policy(seed=0):
    return ActorCritic(ModelConfig(rnn_hidden_dim=16, hidden_sizes_ac=(16, 16),
                                   hidden_sizes_v=(16, 16)),
                       generator=torch.Generator().manual_seed(seed), device="cpu")


def test_collect_demos_shapes():
    _, tw = worlds()
    os_, on_, om_, tg_ = bc.collect_demos(tw, EnvParams(num_drones=N), 3, 5,
                                          torch.Generator(), action_mode="direct")
    assert os_.shape == (30, 12) and on_.shape == (30, 10, 9)
    assert om_.shape == (30, 10) and tg_.shape == (30, 3)
    assert torch.all(tg_.abs() <= 0.999)


@pytest.mark.parametrize("mode", ["direct", "increment"])
def test_bc_reduces_loss_and_moves(mode):
    _, tw = worlds()
    p = EnvParams(num_drones=N)
    ac = small_policy()
    loss = bc.bc_pretrain(ac, tw, p, torch.Generator().manual_seed(1), num_envs=4,
                          demo_steps=30, train_steps=200, batch=256, action_mode=mode)
    assert loss < 0.1, f"BC loss did not converge in {mode}: {loss}"
    # the clone commands positive acceleration from rest
    env = DroneEnv(tw, p)
    _, out = env.reset()
    with torch.no_grad():
        mu, _, _ = ac(out.obs_self[0], out.obs_nbr[0], out.obs_mask[0])
    assert float(mu[0, 0]) > 0.0, f"no acceleration from rest: {mu[0]}"


def test_collect_demos_env_noise_widens_states():
    _, tw = worlds()
    p = EnvParams(num_drones=N, control_std=0.06)
    clean = bc.collect_demos(tw, p, 3, 8, torch.Generator().manual_seed(3),
                             expert="rvo", action_mode="direct")
    noisy = bc.collect_demos(tw, p, 3, 8, torch.Generator().manual_seed(3),
                             expert="rvo", action_mode="direct", env_noise=True)
    for c, n in zip(clean, noisy):
        assert torch.isfinite(c.double()).all() and torch.isfinite(n.double()).all()
    obs_c = clean[0].reshape(8, 3, 2, -1)
    obs_n = noisy[0].reshape(8, 3, 2, -1)
    assert torch.equal(obs_c[:, 0], obs_c[:, 1])     # broadcast reset, no noise
    assert not torch.equal(obs_n[:, 0], obs_n[:, 1])
    assert not torch.equal(obs_c, obs_n)


def test_bc_pretrain_multi_world_mixed_set():
    _, tw = worlds()
    p = EnvParams(num_drones=N)
    ac = small_policy()
    before = {k: v.clone() for k, v in ac.state_dict().items()}
    loss = bc.bc_pretrain(ac, [tw, reverse_routes(tw)], p,
                          torch.Generator().manual_seed(0), num_envs=4, demo_steps=10,
                          train_steps=20, expert="rvo", action_mode="direct",
                          dagger_rounds=1)
    assert np.isfinite(loss)
    assert any(not torch.equal(before[k], v) for k, v in ac.state_dict().items())
    # the reversed world flies the other way: the set holds both populations
    assert not torch.equal(reverse_routes(tw).waypoints, tw.waypoints)
    np.testing.assert_array_equal(reverse_routes(tw).waypoints.numpy(),
                                  np.asarray(j_reverse_routes(worlds()[0]).waypoints))
