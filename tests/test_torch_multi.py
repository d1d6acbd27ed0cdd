"""Multi-world lanes in the port (rvo3d_tpu_torch/worlds/multi.py and the
lane axis through env, rollout and trainer) against the JAX package's
rvo3d_tpu/worlds/multi.py and its vmapped lane worlds.

  - stack_worlds, reverse_routes and worlds_for_lanes equal JAX leaf for
    leaf (exactly), on world32_mix with its route-reversed variant and on
    an inline pair of 2-drone worlds with different waypoint and building
    counts (the padding: waypoints repeat the last one, buildings are
    zero rows with building_mask False).
  - The lane world's float64 step, observe and reset_where equal JAX's
    MultiWorldEnv (jit(vmap)) under jax_enable_x64 over 100 steps of the
    waypoint controller plus noise, rounded to 2 decimals: flags exactly,
    values at 1e-12. One exception, by rule: XLA compiles jnp.round in
    float64 as a product with the scale's reciprocal where the port (and
    the NumPy oracle it is held to) divides, so an observed desired-
    velocity component whose 3-decimal value ends in 5 (a tie of the
    second rounding) may differ by one 0.01 step; nothing else may (the
    same rule holds the float64 rollout's observations below).
    Every lane equals the port's single-world run of its own world
    (1e-12, no exception).
  - rollout_epoch with lane_worlds (gen_demo and gen_demo:rev in
    alternate lanes) against JAX with the JAX draws injected, as
    tests/test_torch_rollout.py does: float32 at its tolerances up to the
    first float32 rounding tie (at least 20 steps compared), float64 with
    a constant policy exactly (flags, actions, cuts, stats counts) and
    values at 1e-12.
  - make_train_epoch with lane_worlds against the JAX epoch with the
    draws, agent order and minibatch offsets injected, at
    tests/test_torch_trainer.py's tolerances; and two chained epochs at the
    w32_m3s recipe's optimizer settings, whose mean-action change (below
    the parameter tolerance at pi_lr 1e-6) must agree within 1 %.
  - A lane world with sphere obstacles (no in-repo world has any) equals
    each lane's single-world run exactly, float64.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu.algo import ppo as jppo
from rvo3d_tpu.algo.rollout import init_rollout_carry as j_init
from rvo3d_tpu.algo.rollout import rollout_epoch as j_rollout
from rvo3d_tpu.algo.trainer import make_train_epoch as j_make_train_epoch
from rvo3d_tpu.config import EnvParams as JEnvParams
from rvo3d_tpu.config import TrainConfig as JTrainConfig
from rvo3d_tpu.env.state import make_world_spec as j_make_world_spec
from rvo3d_tpu.worlds import multi as jmulti
from rvo3d_tpu_torch.algo import ppo
from rvo3d_tpu_torch.algo.rollout import init_rollout_carry, rollout_epoch
from rvo3d_tpu_torch.algo.trainer import make_train_epoch
from rvo3d_tpu_torch.config import EnvParams, TrainConfig
from rvo3d_tpu_torch.env import DroneEnv, geometry as geo
from rvo3d_tpu_torch.env.state import make_world_spec
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.utils.convert import flax_to_state_dict
from rvo3d_tpu_torch.utils.heuristic import waypoint_controller
from rvo3d_tpu_torch.worlds import load_world, multi
from test_torch_ppo import assert_metrics_match, assert_params_match, jax_offsets
from test_torch_rollout import close, compare_carry, inject, jax_eps, np_, policies
from test_torch_trainer import configs
from torch_threads import one_intra_op_thread  # noqa: F401

INLINE = (
    dict(waypoints=[[[1.0, 5.0, 2.0], [4.0, 5.2, 2.2], [8.0, 5.0, 2.5]],
                    [[8.0, 6.0, 2.0], [1.0, 6.0, 2.5]]],
         buildings=[[5.0, 2.0, 3.0, 0.5]], map_size=[10, 10, 5]),
    dict(waypoints=[[[1.0, 4.0, 2.0], [8.0, 4.0, 2.5]],
                    [[8.0, 7.0, 2.0], [5.0, 7.2, 2.2], [3.0, 6.8, 2.4], [1.0, 7.0, 2.5]]],
         buildings=[[5.0, 8.0, 3.0, 0.5], [2.0, 2.0, 4.0, 0.4], [7.0, 2.0, 2.0, 0.3]],
         map_size=[10, 10, 5]),
)


def pair(kind, dtype=np.float32):
    """([jax spec, jax spec reversed or second], same for the port on the CPU)."""
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    if kind == "inline":
        srcs = [(w["waypoints"], w["buildings"], w["map_size"]) for w in INLINE]
    else:
        wd = load_world(kind)
        srcs = [(wd.waypoints_list, wd.building_list, wd.map_size)] * 2
    js = [j_make_world_spec(*s, dtype=dtype) for s in srcs]
    ts = [make_world_spec(*s, dtype=tdt, device="cpu") for s in srcs]
    if kind != "inline":   # the population pair of a --multi_worlds run
        js[1], ts[1] = jmulti.reverse_routes(js[1]), multi.reverse_routes(ts[1])
    return js, ts


def assert_spec_equal(t, j):
    for name, a, b in zip(t._fields, t, j):
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("kind", ["world32_mix", "inline"])
def test_stack_reverse_and_lane_gather_equal_jax(kind):
    js, ts = pair(kind)
    for j, t in zip(js, ts):
        assert_spec_equal(multi.reverse_routes(t), jmulti.reverse_routes(j))
    jst, tst = jmulti.stack_worlds(js), multi.stack_worlds(ts)
    assert_spec_equal(tst, jst)
    idx = [0, 1, 1, 0, 1]
    lanes = multi.worlds_for_lanes(tst, idx)
    assert lanes.lanes == 5 and lanes.num_drones == ts[0].num_drones
    assert_spec_equal(lanes, jmulti.worlds_for_lanes(jst, np.asarray(idx)))
    if kind == "inline":     # the padding: repeated waypoints, masked-out buildings
        assert tst.waypoints.shape == (2, 2, 4, 3) and tst.buildings.shape == (2, 3, 4)
        assert not tst.building_mask[0, 1:].any() and not tst.buildings[0, 1:].any()
        assert torch.equal(tst.waypoints[0, 0, 3], tst.waypoints[0, 0, 2])


def test_stack_worlds_refuses_mixed_drone_counts():
    a = load_world("gen_demo").spec(device="cpu")
    b = load_world("world16_dense").spec(device="cpu")
    with pytest.raises(ValueError, match="drone count"):
        multi.stack_worlds([a, b])


def _jstate_close(ts, js, atol):
    for name, a, b in zip(ts._fields, ts, js):
        close(a, b, atol, msg=f"state.{name}")


def close_obs_self_f64(a, b, atol, ties=True):
    """obs_self at atol; with `ties`, the observed desired velocity
    (columns 8:11) may differ from JAX's by exactly one 0.01 step, the two
    neighbours of a 3-decimal tie (module docstring)."""
    a, b = np_(a).copy(), np_(b)
    if ties:
        step = np.isclose(np.abs(a[..., 8:11] - b[..., 8:11]), 0.01, rtol=0, atol=1e-9)
        a[..., 8:11] = np.where(step, b[..., 8:11], a[..., 8:11])
    close(a, b, atol, msg="obs_self")


def _out_equal(t, j, atol, sel=slice(None), ties=False):
    """Flags exactly, values at atol (obs_self with the tie rule if `ties`)."""
    for name in ("done", "info_arrive", "finish", "obs_mask"):
        np.testing.assert_array_equal(np_(getattr(t, name))[sel], np_(getattr(j, name)),
                                      err_msg=name)
    for name in ("obs_nbr", "reward"):
        close(np_(getattr(t, name))[sel], getattr(j, name), atol, msg=name)
    close_obs_self_f64(np_(t.obs_self)[sel], j.obs_self, atol, ties)


@pytest.mark.parametrize("kind,lanes", [("world32_mix", 4), ("inline", 6)])
def test_lane_world_f64_matches_jax_multiworld(kind, lanes):
    steps = 100
    idx = np.arange(lanes) % 2
    with jax.enable_x64(True):
        js, ts = pair(kind, np.float64)
        n = ts[0].num_drones
        jp, tp = JEnvParams(num_drones=n), EnvParams(num_drones=n)
        jenv = jmulti.MultiWorldEnv(js, idx, jp, dtype=jnp.float64)
        tenv = multi.MultiWorldEnv(ts, idx, tp)
        singles = [DroneEnv(ts[k], tp, num_envs=int((idx == k).sum())) for k in range(2)]
        jstate, jout = jenv.reset_batch()
        tstate, tout = tenv.reset_batch()
        sstates = [e.reset()[0] for e in singles]
        _out_equal(tout, jout, 1e-12)
        rng = np.random.default_rng(0)
        events = np.zeros(3, int)
        for _ in range(steps):
            noise = torch.from_numpy(0.3 * rng.standard_normal((lanes, n, 3)))
            act = geo.rnd(waypoint_controller(tstate, tenv.lane_worlds) + noise, 2)
            jstate, jout = jenv.step_batch(jstate, jnp.asarray(act.numpy()))
            tstate, tout = tenv.step_batch(tstate, act)
            _out_equal(tout, jout, 1e-12, ties=True)
            _jstate_close(tstate, jstate, 1e-12)
            need = np_(tout.done | tout.finish)
            jstate = jenv.reset_where_batch(jstate, jnp.asarray(need))
            tstate = tenv.reset_where_batch(tstate, torch.from_numpy(need))
            jre, jstate = jenv.observe_batch(jstate)
            tre, tstate = tenv.observe_batch(tstate)
            _out_equal(tre, jre, 1e-12, ties=True)
            _jstate_close(tstate, jstate, 1e-12)
            for k, env in enumerate(singles):
                sel = idx == k
                st, o = env.step(sstates[k], act[torch.from_numpy(sel)])
                _out_equal(tout, o, 1e-12, sel)
                st = env.reset_where(st, torch.from_numpy(need[sel]))
                r, sstates[k] = env.observe(st)
                _out_equal(tre, r, 1e-12, sel)
            events += [int(np_(tout.done).sum()), int(np_(tout.finish).sum()),
                       int(np_(tout.obs_mask).sum())]
    # collisions, arrivals and flagged neighbours all happened
    assert (events > 0).all(), events


E, T = 4, 12
SMALL_LOG_STD = dict(rnn_hidden_dim=16, hidden_sizes_ac=(32, 32), hidden_sizes_v=(32, 32))


def gen_demo_lanes(dtype=np.float32):
    """(jax spec, jax lane world, port spec, port lane world): gen_demo and
    gen_demo:rev in alternate lanes."""
    js, ts = pair("gen_demo", dtype)
    idx = np.arange(E) % 2
    return (js[0], jmulti.worlds_for_lanes(jmulti.stack_worlds(js), idx),
            ts[0], multi.worlds_for_lanes(multi.stack_worlds(ts), idx))


@pytest.mark.parametrize("mode", ["direct", "increment"])
def test_f32_lane_world_rollout_matches_jax(mode):
    jspec, jlw, tspec, tlw = gen_demo_lanes()
    n = tspec.num_drones
    jp, tp = JEnvParams(num_drones=n), EnvParams(num_drones=n)
    kw = dict(steps_per_epoch=T, max_ep_len=5, num_envs=E, action_mode=mode)
    jcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jac, params, ac = policies()
    jcarry = jax.jit(lambda k: j_init(jspec, jp, E, k, lane_worlds=jlw))(
        jax.random.PRNGKey(1))
    tcarry = init_rollout_carry(tspec, tp, E, torch.Generator().manual_seed(1),
                                lane_worlds=tlw)
    compare_carry(tcarry, jcarry, 1e-5)
    jrun = jax.jit(lambda c: j_rollout(jac, jspec, jp, jcfg, params, c, lane_worlds=jlw))
    compared = 0
    for _ in range(4):
        draws = jax_eps(jcarry.rng, T, n)
        inject(ac, draws)
        jcarry2, jb = jrun(jcarry)
        tcarry2, tb = rollout_epoch(ac, tspec, tp, tcfg, tcarry, lane_worlds=tlw)
        differ = np.nonzero(np.any(np_(tb.act) != np_(jb.act), axis=(1, 2, 3)))[0]
        stop = int(differ[0]) if len(differ) else T
        for name in ("obs_self", "obs_nbr", "obs_mask"):
            close(getattr(tb, name)[:stop + 1], getattr(jb, name)[:stop + 1], 1e-5,
                  msg=name)
        close(tb.rew[:stop], jb.rew[:stop], 1e-5, 1e-5, msg="rew")
        close(tb.val[:stop], jb.val[:stop], 1e-5, msg="val")
        np.testing.assert_array_equal(np_(tb.cut[:stop]), np_(jb.cut[:stop]))
        compared += stop
        if stop < T:
            # a float32 rounding tie: the unrounded action sits within 1e-5 of x.xx5
            with torch.no_grad():
                mu, std, _ = ac(tb.obs_self[stop], tb.obs_nbr[stop], tb.obs_mask[stop])
            a = (mu + std * draws[stop]).numpy()
            flip = np_(tb.act[stop]) != np_(jb.act[stop])
            dist = np.abs(np.abs(a * 100.0) % 1.0 - 0.5) / 100.0
            assert np.all(dist[flip] < 1e-5), dist[flip]
            break
        compare_carry(tcarry2, jcarry2, 1e-4)
        jcarry, tcarry = jcarry2, tcarry2
    assert compared >= 20, compared


@pytest.mark.parametrize("mode,max_ep_len", [("direct", 5), ("increment", 7)])
def test_f64_lane_world_rollout_lifecycle_is_exact(mode, max_ep_len):
    kw = dict(steps_per_epoch=T, max_ep_len=max_ep_len, num_envs=E, action_mode=mode)
    jcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jac, params, ac = policies(constant=([0.2512, 0.4987, -0.7489], -0.75))
    events = np.zeros(3, int)
    with jax.enable_x64(True):
        jspec, jlw, tspec, tlw = gen_demo_lanes(np.float64)
        n = tspec.num_drones
        jp, tp = JEnvParams(num_drones=n), EnvParams(num_drones=n)
        jcarry = jax.jit(lambda k: j_init(jspec, jp, E, k, dtype=jnp.float64,
                                          lane_worlds=jlw))(jax.random.PRNGKey(1))
        jcarry = jcarry._replace(stats=type(jcarry.stats)(
            *[x.astype(jnp.float64) for x in jcarry.stats]))
        tcarry = init_rollout_carry(tspec, tp, E, torch.Generator().manual_seed(1),
                                    lane_worlds=tlw)
        assert tcarry.env_state.pos.dtype == torch.float64
        jrun = jax.jit(lambda c: j_rollout(jac, jspec, jp, jcfg, params, c,
                                           lane_worlds=jlw))
        for _ in range(4):
            jcarry2, jb = jrun(jcarry)
            tcarry2, tb = rollout_epoch(ac, tspec, tp, tcfg, tcarry, lane_worlds=tlw)
            close_obs_self_f64(tb.obs_self, jb.obs_self, 1e-12)
            for name in ("obs_nbr", "rew", "val"):
                close(getattr(tb, name), getattr(jb, name), 1e-12, msg=name)
            for name in ("obs_mask", "act", "cut"):
                np.testing.assert_array_equal(np_(getattr(tb, name)),
                                              np_(getattr(jb, name)), err_msg=name)
            _jstate_close(tcarry2.env_state, jcarry2.env_state, 1e-12)
            close_obs_self_f64(tcarry2.obs[0], jcarry2.obs[0], 1e-12)
            np.testing.assert_array_equal(np_(tcarry2.ep_len), np_(jcarry2.ep_len))
            for name in ("count", "finish_count", "collision_count", "len_sum"):
                np.testing.assert_array_equal(np_(getattr(tcarry2.stats, name)),
                                              np_(getattr(jcarry2.stats, name)))
            for name in ("ret_sum", "ret_min", "ret_max"):
                close(getattr(tcarry2.stats, name), getattr(jcarry2.stats, name), 1e-12)
            events += [int(np_(tcarry2.stats.collision_count).sum()),
                       int(np_(tb.cut[:-1]).sum()), int(np_(tcarry2.stats.count).sum())]
            jcarry, tcarry = jcarry2, tcarry2
    assert (events > 0).all(), events


def test_lane_world_train_epoch_matches_jax():
    jspec, jlw, tspec, tlw = gen_demo_lanes()
    n = tspec.num_drones
    jcfg, tcfg = configs(n, batched_update=True, max_update_num=2)
    from rvo3d_tpu.models import ActorCritic as JActorCritic

    jac = JActorCritic(jcfg.model)
    params = jax.jit(jac.init)(jax.random.PRNGKey(0), jnp.zeros((1, 12)),
                               jnp.zeros((1, 10, 9)), jnp.zeros((1, 10), bool))
    pi_tx, vf_tx = jppo.make_optimizers(jcfg.train, params)
    jstate = jppo.PPOState(params, pi_tx.init(params), vf_tx.init(params))
    jcarry = jax.jit(lambda k: j_init(jspec, jcfg.env, E, k, lane_worlds=jlw))(
        jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    out = jax.jit(j_make_train_epoch(jac, jspec, jcfg, pi_tx, vf_tx, lane_worlds=jlw))(
        jstate, jcarry, key)

    ac = ActorCritic(tcfg.model, device="cpu")
    ac.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    pi_opt, vf_opt = ppo.make_optimizers(tcfg.train, ac)
    tcarry = init_rollout_carry(tspec, tcfg.env, E, torch.Generator(), lane_worlds=tlw)
    inject(ac, jax_eps(jcarry.rng, T, n))
    offsets = [jax_offsets(jcfg.train, key, T * E * n)]
    got = make_train_epoch(ac, tspec, tcfg, pi_opt, vf_opt, lane_worlds=tlw)(
        tcarry, torch.Generator(), None, offsets)
    um, jum = got.update_metrics, out.update_metrics
    assert int(um.pi_iters.max()) > 0
    for k in range(um.pi_loss.shape[0]):
        assert_metrics_match([x[k] for x in um], [x[k] for x in jum])
    assert_params_match(ac, out.ppo_state.params)
    np.testing.assert_allclose(float(got.mean_reward), float(out.mean_reward), rtol=1e-4)
    compare_carry(got.carry, out.carry, 1e-4)
    for a, b in zip(got.stats, out.stats):
        np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-4, rtol=1e-5)


def test_lane_world_recipe_settings_two_epochs_match_jax():
    """Two chained lane-world epochs at the w32_m3s recipe's optimizer
    settings (pi_lr 1e-6, vf_lr 5e-5, vf_encoder False, target_kl 0.01,
    log_std -2.3, batched update): the metrics as above, and the change of
    the mean action over both epochs on fixed observations, which at
    pi_lr 1e-6 is below the parameter tolerance, within 1 % of its
    largest component."""
    jspec, jlw, tspec, tlw = gen_demo_lanes()
    n = tspec.num_drones
    train = dict(batched_update=True, max_update_num=2, pi_lr=1e-6, vf_lr=5e-5,
                 vf_encoder=False, target_kl=0.01, train_pi_iters=5, train_v_iters=5)
    jcfg, tcfg = configs(n, **train)
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, log_std_init=-2.3))
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model,
                                                                log_std_init=-2.3))
    from rvo3d_tpu.models import ActorCritic as JActorCritic

    jac = JActorCritic(jcfg.model)
    params = jax.jit(jac.init)(jax.random.PRNGKey(0), jnp.zeros((1, 12)),
                               jnp.zeros((1, 10, 9)), jnp.zeros((1, 10), bool))
    pi_tx, vf_tx = jppo.make_optimizers(jcfg.train, params)
    jstate = jppo.PPOState(params, pi_tx.init(params), vf_tx.init(params))
    jcarry = jax.jit(lambda k: j_init(jspec, jcfg.env, E, k, lane_worlds=jlw))(
        jax.random.PRNGKey(1))
    j_epoch = jax.jit(j_make_train_epoch(jac, jspec, jcfg, pi_tx, vf_tx, lane_worlds=jlw))

    ac = ActorCritic(tcfg.model, device="cpu")
    ac.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    pi_opt, vf_opt = ppo.make_optimizers(tcfg.train, ac)
    tcarry = init_rollout_carry(tspec, tcfg.env, E, torch.Generator(), lane_worlds=tlw)
    t_epoch = make_train_epoch(ac, tspec, tcfg, pi_opt, vf_opt, lane_worlds=tlw)

    rng = np.random.default_rng(3)
    obs = (rng.normal(size=(64, 12)).astype(np.float32),
           rng.normal(size=(64, 10, 9)).astype(np.float32), rng.random((64, 10)) < 0.3)

    def mean_actions():
        with torch.no_grad():
            t = ac(*(torch.from_numpy(x) for x in obs))[0].numpy()
        j = np.asarray(jac.apply(jstate.params, *(jnp.asarray(x) for x in obs))[0])
        return t.astype(np.float64), j.astype(np.float64)

    t0, j0 = mean_actions()
    pi_steps = 0
    for epoch, key in enumerate((jax.random.PRNGKey(2), jax.random.PRNGKey(5))):
        inject(ac, jax_eps(jcarry.rng, T, n))
        out = j_epoch(jstate, jcarry, key)
        got = t_epoch(tcarry, torch.Generator(), None,
                      [jax_offsets(jcfg.train, key, T * E * n)])
        um, jum = got.update_metrics, out.update_metrics
        pi_steps += int(um.pi_iters.sum())
        for k in range(um.pi_loss.shape[0]):
            assert_metrics_match([x[k] for x in um], [x[k] for x in jum])
        assert_params_match(ac, out.ppo_state.params)
        compare_carry(got.carry, out.carry, 1e-4)
        jstate, jcarry, tcarry = out.ppo_state, out.carry, got.carry
    assert pi_steps > 0
    t1, j1 = mean_actions()
    dt, dj = t1 - t0, j1 - j0
    assert np.abs(dj).max() > 0
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-2 * np.abs(dj).max())


def test_lane_world_with_spheres_equals_single_worlds():
    """Sphere obstacles with a lane axis (stacked SphereSpec, motion, VO
    participants, reset): every lane equals its own world's run, float64."""
    sph = ([dict(pos=[4.0, 5.0, 2.2], radius=0.3, vel=[0.2, 0.0, 0.0], model="linear"),
            dict(pos=[6.0, 4.0, 2.0], radius=0.4)],
           [dict(pos=[5.0, 6.0, 2.1], radius=0.3, vel=[0.0, 0.3, 0.0], goal=[5.0, 1.0, 2.1],
                 model="goal"),
            dict(pos=[3.0, 7.0, 2.3], radius=0.2, vel=[0.1, 0.1, 0.0], model="linear")])
    specs = [make_world_spec(w["waypoints"], w["buildings"], w["map_size"], spheres=s,
                             dtype=torch.float64, device="cpu")
             for w, s in zip(INLINE, sph)]
    p = EnvParams(num_drones=2)
    idx = np.array([0, 1, 1, 0])
    env = multi.MultiWorldEnv(specs, idx, p)
    singles = [DroneEnv(specs[k], p, num_envs=2) for k in range(2)]
    st, _ = env.reset_batch()
    sst = [e.reset()[0] for e in singles]
    rng = np.random.default_rng(2)
    for _ in range(30):
        act = geo.rnd(waypoint_controller(st, env.lane_worlds)
                      + torch.from_numpy(0.3 * rng.standard_normal((4, 2, 3))), 2)
        st, out = env.step_batch(st, act)
        need = out.done | out.finish
        st = env.reset_where_batch(st, need)
        re, st = env.observe_batch(st)
        for k, e in enumerate(singles):
            sel = torch.from_numpy(idx == k)
            s1, o1 = e.step(sst[k], act[sel])
            _out_equal(out, o1, 0.0, sel.numpy())
            s1 = e.reset_where(s1, need[sel])
            r1, sst[k] = e.observe(s1)
            _out_equal(re, r1, 0.0, sel.numpy())
            for a, b in zip(st, sst[k]):
                assert torch.equal(a[sel], b)
