"""The port's rollout (rvo3d_tpu_torch/algo/rollout.py) against the JAX
package's rollout_epoch, on gen_demo with a small policy (H = 16, heads
(32, 32)) converted from flax, 4 lanes, epochs of T = 12 run back to back.

  - float32 (both action modes, parity rounding on): log_std = -20, so
    std clamps to 1e-4, and the port draws the same standard-normal
    samples as the JAX rollout (computed from the JAX carry's key and
    handed to the port's policy), so both round the same actions. obs,
    act, rew and val agree at atol 1e-5 (rtol 1e-5 for rewards), cut
    exactly, and at every epoch end the carry (env state, obs, ep_len,
    ep_ret) and the EpisodeStats at atol 1e-4 plus rtol 1e-5. logp is not
    compared. A float32 rounding tie may flip one action between the
    packages: the comparison then ends at that step, after asserting that
    the unrounded action sits within 1e-5 of the tie. At least 20 steps
    must have been compared, holding a collision reset, a terminal cut and
    a full reset.
  - float64 exact lifecycle (both action modes): the actor's and critic's
    last layers are zeroed and their biases set, so mu = tanh(bias) and
    the value are the same on both sides and mu is far from a rounding
    tie (and rounds to binary fractions, which both packages' float32
    roundings give exactly). With max_ep_len 5 ('direct') or 7
    ('increment') the terminal branch fires beside collisions and the
    epoch-end reset, and collisions land on steps where the length limit
    is passed (terminal reads ep_len before the collision reset). Positions, rewards and values agree to 1e-12
    at every step, and the done, finish and cut flags and the
    EpisodeStats counts exactly.
  - a lane world of the rollout's own world gives the same rollout;
    noise mode is reproducible from the generator and moves the drones
    off the noise-free path.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import rvo3d_tpu.algo.rollout as jroll_mod
from rvo3d_tpu.algo.rollout import init_rollout_carry as j_init
from rvo3d_tpu.algo.rollout import rollout_epoch as j_rollout
from rvo3d_tpu.config import EnvParams as JEnvParams
from rvo3d_tpu.config import ModelConfig as JModelConfig
from rvo3d_tpu.config import TrainConfig as JTrainConfig
from rvo3d_tpu.env import env as jenv
from rvo3d_tpu.env.state import make_world_spec as j_make_world_spec
from rvo3d_tpu.models import ActorCritic as JActorCritic
import rvo3d_tpu_torch.algo.rollout as troll_mod
from rvo3d_tpu_torch.algo.rollout import init_rollout_carry, rollout_epoch
from rvo3d_tpu_torch.config import EnvParams, ModelConfig, TrainConfig
from rvo3d_tpu_torch.models import ActorCritic, PolicyStep
from rvo3d_tpu_torch.utils.convert import flax_to_state_dict
from rvo3d_tpu_torch.worlds import load_world

E, T, EPOCHS = 4, 12, 4
SMALL = dict(rnn_hidden_dim=16, hidden_sizes_ac=(32, 32), hidden_sizes_v=(32, 32),
             log_std_init=-20.0)


def policies(seed=0, constant=None):
    """(flax module, numpy params, port policy on the CPU). `constant`
    (mu bias, value bias) zeroes the last actor and critic layers."""
    jac = JActorCritic(JModelConfig(**SMALL))
    params = jax.jit(jac.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 12)),
                               jnp.zeros((1, 10, 9)), jnp.zeros((1, 10), bool))
    params = jax.tree_util.tree_map(lambda x: np.array(x), params)
    if constant is not None:
        mu_bias, v_bias = constant
        for head, bias in (("actor", np.arctanh(mu_bias)), ("critic", [v_bias])):
            last = params["params"][head]["dense_2"]
            last["kernel"][:] = 0.0
            last["bias"][:] = np.asarray(bias, np.float32)
    ac = ActorCritic(ModelConfig(**SMALL), device="cpu")
    ac.load_state_dict(flax_to_state_dict(params))
    return jac, params, ac


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_draws(rng, t_len, n):
    def body(key, _):
        key, akey = jax.random.split(key)
        return key, jax.random.normal(akey, (E, n, 3), jnp.float32)
    return jax.lax.scan(body, rng, None, length=t_len)[1]


def jax_eps(rng, t_len, n):
    """The standard-normal draws of the JAX rollout's actions (noise off)
    over t_len steps from carry key `rng`."""
    return list(torch.from_numpy(np.array(_jax_draws(rng, t_len, n))))


def inject(ac, draws):
    """Make the port's policy use `draws` (in order) for its samples."""
    it = iter(draws)

    def step(obs_self, obs_nbr, obs_mask, std_factor=1.0, generator=None, eps=None):
        mu, std, v = ac(obs_self, obs_nbr, obs_mask, std_factor)
        a = mu + std * next(it)
        return PolicyStep(action=a, value=v, logp=ac.logp_of(mu, std, a),
                          mu=mu, std=std)
    ac.step = step


def specs(wd, dtype):
    jspec = j_make_world_spec(wd.waypoints_list, wd.building_list, wd.map_size,
                              dtype=dtype)
    return jspec, wd.spec(dtype=torch.from_numpy(np.zeros(1, dtype)).dtype,
                          device="cpu")


def np_(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def close(a, b, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(np_(a).astype(np.float64), np_(b).astype(np.float64),
                               atol=atol, rtol=rtol, err_msg=msg)


def compare_carry(tc, jc, atol):
    for name, a, b in zip(tc.env_state._fields, tc.env_state, jc.env_state):
        close(a, b, atol, msg=f"env_state.{name}")
    for a, b in zip(tc.obs, jc.obs):
        close(a, b, atol, msg="obs")
    np.testing.assert_array_equal(np_(tc.ep_len), np_(jc.ep_len))
    close(tc.ep_ret, jc.ep_ret, atol, 1e-5, "ep_ret")
    for name, a, b in zip(tc.stats._fields, tc.stats, jc.stats):
        close(a, b, atol, 1e-5, msg=f"stats.{name}")


@pytest.mark.parametrize("mode", ["direct", "increment"])
def test_f32_rollout_matches_jax(mode):
    wd = load_world("gen_demo")
    n = wd.drone_num
    jp, tp = JEnvParams(num_drones=n), EnvParams(num_drones=n)
    kw = dict(steps_per_epoch=T, max_ep_len=5, num_envs=E, action_mode=mode)
    jcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jac, params, ac = policies()
    jspec, tspec = specs(wd, np.float32)
    jcarry = jax.jit(lambda k: j_init(jspec, jp, E, k))(jax.random.PRNGKey(1))
    tcarry = init_rollout_carry(tspec, tp, E, torch.Generator().manual_seed(1))
    jrun = jax.jit(lambda c: j_rollout(jac, jspec, jp, jcfg, params, c))

    compared, collided, terminal_cut = 0, False, False
    for _ in range(EPOCHS):
        draws = jax_eps(jcarry.rng, T, n)
        inject(ac, draws)
        jcarry2, jb = jrun(jcarry)
        tcarry2, tb = rollout_epoch(ac, tspec, tp, tcfg, tcarry)
        differ = np.nonzero(np.any(np_(tb.act) != np_(jb.act), axis=(1, 2, 3)))[0]
        stop = int(differ[0]) if len(differ) else T
        for name in ("obs_self", "obs_nbr", "obs_mask"):     # up to the step's obs
            close(getattr(tb, name)[:stop + 1], getattr(jb, name)[:stop + 1], 1e-5,
                  msg=name)
        close(tb.act[:stop], jb.act[:stop], 0.0, msg="act")
        close(tb.rew[:stop], jb.rew[:stop], 1e-5, 1e-5, msg="rew")
        close(tb.val[:stop], jb.val[:stop], 1e-5, msg="val")
        np.testing.assert_array_equal(np_(tb.cut[:stop]), np_(jb.cut[:stop]))
        terminal_cut |= bool(np_(tb.cut[:min(stop, T - 1)]).any())
        compared += stop
        if stop < T:
            # a rounding tie: where the rounded actions differ, the
            # unrounded action sits within 1e-5 of x.xx5
            with torch.no_grad():
                mu, std, _ = ac(tb.obs_self[stop], tb.obs_nbr[stop], tb.obs_mask[stop])
            a = (mu + std * draws[stop]).numpy()
            flip = np_(tb.act[stop]) != np_(jb.act[stop])
            dist = np.abs(np.abs(a * 100.0) % 1.0 - 0.5) / 100.0
            assert np.all(dist[flip] < 1e-5), dist[flip]
            break
        compare_carry(tcarry2, jcarry2, 1e-4)
        collided |= bool(np_(tcarry2.stats.collision_count).sum() > 0)
        jcarry, tcarry = jcarry2, tcarry2
    # collision resets, terminal cuts and (at each compared epoch end) full
    # resets happened in the compared steps
    assert compared >= 20 and compared >= T, compared
    assert collided and terminal_cut


class _RecordingJax:
    """Stands in for the `jax` module inside rvo3d_tpu.algo.rollout: the
    vmapped env step also reports its batched done/finish flags."""

    def __init__(self, records):
        self.records = records

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *args, **kw):
        batched = jax.vmap(fn, *args, **kw)
        if getattr(fn, "func", None) is not jenv.step:
            return batched

        def run(*a):
            state, out = batched(*a)
            jax.debug.callback(
                lambda d, f: self.records.append((np.asarray(d), np.asarray(f))),
                out.done, out.finish, ordered=True)
            return state, out
        return run


@pytest.mark.parametrize("mode,max_ep_len", [("direct", 5), ("increment", 7)])
def test_f64_rollout_lifecycle_is_exact(mode, max_ep_len, monkeypatch):
    wd = load_world("gen_demo")
    n = wd.drone_num
    jp, tp = JEnvParams(num_drones=n), EnvParams(num_drones=n)
    kw = dict(steps_per_epoch=T, max_ep_len=max_ep_len, num_envs=E, action_mode=mode)
    jcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    # mu far from a tie of the 2-decimal rounding, rounding to binary
    # fractions: XLA rounds to 2 decimals by multiplying by 0.01 where
    # torch divides by 100, and for most 2-decimal values the two float32
    # results differ by one ulp; for these both are exact
    jac, params, ac = policies(constant=([0.2512, 0.4987, -0.7489], -0.75))

    j_recs, t_recs = [], []
    monkeypatch.setattr(jroll_mod, "jax", _RecordingJax(j_recs))
    real_step = troll_mod.step

    def rec_step(*a, **k):
        state, out = real_step(*a, **k)
        t_recs.append((out.done.numpy().copy(), out.finish.numpy().copy()))
        return state, out
    monkeypatch.setattr(troll_mod, "step", rec_step)

    events = {"collision": 0, "terminal": 0, "full": 0}
    with jax.enable_x64(True):
        jspec, tspec = specs(wd, np.float64)
        jcarry = jax.jit(lambda k: j_init(jspec, jp, E, k, dtype=jnp.float64))(
            jax.random.PRNGKey(1))
        # float64 stats, so that the JAX scan's carry keeps one dtype (its
        # float32 stats turn float64 on adding float64 returns)
        jcarry = jcarry._replace(stats=type(jcarry.stats)(
            *[x.astype(jnp.float64) for x in jcarry.stats]))
        tcarry = init_rollout_carry(tspec, tp, E, torch.Generator().manual_seed(1))
        assert tcarry.env_state.pos.dtype == torch.float64
        jrun = jax.jit(lambda c: j_rollout(jac, jspec, jp, jcfg, params, c))
        for _ in range(EPOCHS):
            jcarry2, jb = jrun(jcarry)
            jax.effects_barrier()
            tcarry2, tb = rollout_epoch(ac, tspec, tp, tcfg, tcarry)
            for name in ("obs_self", "obs_nbr", "rew", "val"):
                close(getattr(tb, name), getattr(jb, name), 1e-12, msg=name)
            for name in ("obs_mask", "act", "cut"):
                np.testing.assert_array_equal(np_(getattr(tb, name)),
                                              np_(getattr(jb, name)), err_msg=name)
            for name, a, b in zip(tcarry2.env_state._fields, tcarry2.env_state,
                                  jcarry2.env_state):
                close(a, b, 1e-12, msg=name)
            np.testing.assert_array_equal(np_(tcarry2.ep_len), np_(jcarry2.ep_len))
            close(tcarry2.ep_ret, jcarry2.ep_ret, 1e-12)
            for name in ("count", "finish_count", "collision_count", "len_sum"):
                np.testing.assert_array_equal(np_(getattr(tcarry2.stats, name)),
                                              np_(getattr(jcarry2.stats, name)))
            for name in ("ret_sum", "ret_min", "ret_max"):
                close(getattr(tcarry2.stats, name), getattr(jcarry2.stats, name), 1e-12)
            cut = np_(tb.cut)
            events["terminal"] += int(cut[:-1].sum())
            events["full"] += 1
            jcarry, tcarry = jcarry2, tcarry2
    assert len(t_recs) == len(j_recs) == EPOCHS * T
    for t, ((td, tf), (jd, jf)) in enumerate(zip(t_recs, j_recs)):
        np.testing.assert_array_equal(td, jd, err_msg=f"done at step {t}")
        np.testing.assert_array_equal(tf, jf, err_msg=f"finish at step {t}")
        events["collision"] += int(td.sum())
    assert all(v > 0 for v in events.values()), events


def test_lane_world_of_one_world_equals_single_world_rollout():
    """A lane world whose lanes all hold the rollout's world gives the
    single-world rollout exactly (tests/test_torch_multi.py holds lane
    worlds of different worlds against JAX)."""
    from rvo3d_tpu_torch.worlds.multi import stack_worlds, worlds_for_lanes

    wd = load_world("gen_demo")
    spec = wd.spec(device="cpu")
    p = EnvParams(num_drones=wd.drone_num)
    lanes = worlds_for_lanes(stack_worlds([spec]), [0, 0])
    cfg = TrainConfig(steps_per_epoch=6, action_mode="direct")
    ac = ActorCritic(ModelConfig(**SMALL), device="cpu")
    runs = []
    for lw in (None, lanes):
        carry = init_rollout_carry(spec, p, 2, torch.Generator().manual_seed(0),
                                   lane_worlds=lw)
        runs.append(rollout_epoch(ac, spec, p, cfg, carry, lane_worlds=lw))
    (c1, b1), (c2, b2) = runs
    for a, b in zip(b1, b2):
        assert torch.equal(a, b)
    for a, b in zip(c1.env_state, c2.env_state):
        assert torch.equal(a, b)


def test_noise_mode_is_reproducible_and_moves_the_drones():
    wd = load_world("gen_demo")
    spec = wd.spec(device="cpu")
    cfg = TrainConfig(steps_per_epoch=8, num_envs=3, action_mode="direct")
    ac = ActorCritic(ModelConfig(**SMALL), device="cpu")

    def run(noise, seed):
        p = dataclasses.replace(EnvParams(num_drones=wd.drone_num), noise=noise)
        carry = init_rollout_carry(spec, p, 3, torch.Generator().manual_seed(seed))
        return rollout_epoch(ac, spec, p, cfg, carry)

    (c1, b1), (c2, b2) = run(True, 0), run(True, 0)
    for a, b in zip(b1, b2):
        assert torch.equal(a, b)
    _, b3 = run(False, 0)
    # the control noise moves the drones off the noise-free path, and
    # each lane draws its own
    assert not torch.equal(b1.obs_self, b3.obs_self)
    assert not torch.equal(b1.obs_self[-1, 0], b1.obs_self[-1, 1])
    assert torch.isfinite(b1.val).all()
