"""The port's env (rvo3d_tpu_torch/env) against the reference semantics.

  - float64 torch step against the NumPy oracle (rvo3d_tpu/env/oracle.py),
    200 steps on the four in-repo worlds: positions, rewards and
    observations to 1e-12, episode flags exactly. Steps where the two sit
    on a decision boundary to within float noise (knife-edge ties, judged
    by rvo3d_tpu.parity._boundary_margin) reset the tied drones in both.
  - float32 torch step against the JAX step on the same state and action,
    at 1e-5, for 20 steps of each world (see the test for the one rounding
    tie that f32 divisions may break either way).
  - the two-pass stable sort against jnp.lexsort on rows with ties.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__
from rvo3d_tpu.config import EnvParams as JEnvParams
from rvo3d_tpu.env import env as jenv
from rvo3d_tpu.env.oracle import OracleEnv
from rvo3d_tpu.env.state import make_world_spec as j_make_world_spec
from rvo3d_tpu.parity import _boundary_margin
from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import env as tenv
from rvo3d_tpu_torch.env.rvo import lexsort_rows
from rvo3d_tpu_torch.env.state import DroneState
from rvo3d_tpu_torch.worlds import WorldData, load_world

WORLDS = ["gen_demo", "world16_dense", "world32_mix", "flagship"]


def get_world(name: str) -> WorldData:
    if name == "flagship":
        return WorldData(name=name, **__graft_entry__._flagship_world())
    return load_world(name)


def flat_obs(out, i, nm):
    blocks = [out.obs_nbr[i, j].numpy() for j in range(nm) if out.obs_mask[i, j]]
    return np.concatenate([out.obs_self[i].numpy()] + (blocks or [np.zeros(9)]))


def run_oracle_parity(wd: WorldData, steps: int = 200, noise: bool = False,
                      env_train: bool = True, seed: int = 7):
    """Step the float64 port and the oracle in lockstep under a noisy
    desired-velocity policy; returns (max pos err, max reward err,
    max obs err, flags exact, knife-edge ties)."""
    p = EnvParams(num_drones=wd.drone_num, noise=noise, env_train=env_train)
    spec = wd.spec(dtype=torch.float64, device="cpu")
    oracle = OracleEnv(wd, env_train=env_train)
    oracle.reset()
    state = tenv.reset(spec, p, (), torch.float64)
    rng = np.random.default_rng(seed)
    n = wd.drone_num
    max_pos = max_rew = max_obs = 0.0
    flags_ok, ties = True, 0
    for t in range(steps):
        des = np.stack([d.cal_des_vel() for d in oracle.drones])
        acts = np.round(des + 0.3 * rng.standard_normal((n, 3)), 2)
        nz = rng.standard_normal((n, 3)) if noise else None
        o_obs, o_rew, o_done, o_info, o_fin = oracle.step(
            acts, None if nz is None else nz * p.control_std)
        state, out = tenv.step(spec, state, torch.tensor(acts), p,
                               None if nz is None else torch.tensor(nz))
        pos_err = np.max(np.abs(state.pos.numpy() - np.stack(
            [d.state for d in oracle.drones])), axis=-1)
        t_rew, o_rew_a = out.reward.numpy(), np.asarray(o_rew)
        # +inf for arrived drones (parity mode) must match as +inf
        assert np.array_equal(np.isposinf(t_rew), np.isposinf(o_rew_a)), t
        fin = np.isfinite(t_rew) & np.isfinite(o_rew_a)
        rew_err = np.where(fin, np.abs(t_rew - o_rew_a), 0.0)
        disagree = [i for i in range(n)
                    if (bool(out.done[i]), bool(out.finish[i]), bool(out.info_arrive[i]))
                    != (o_done[i], o_fin[i], o_info[i])]
        for i in range(n):
            if i not in disagree:
                obs = flat_obs(out, i, p.neighbor_num)
                assert obs.shape == o_obs[i].shape, (t, i)
                max_obs = max(max_obs, float(np.max(np.abs(obs - o_obs[i]))))
        if disagree and all(_boundary_margin(oracle, i, p) < 1e-9 for i in disagree):
            ties += 1
            mask = np.zeros(n, bool)
            mask[disagree] = True
            max_pos = max(max_pos, float(np.max(np.where(mask, 0.0, pos_err), initial=0.0)))
            max_rew = max(max_rew, float(np.max(np.where(mask, 0.0, rew_err), initial=0.0)))
            for i in disagree:
                oracle.reset_one(i)
            state = tenv.reset_where(spec, state, torch.tensor(mask))
            o_done = [d and not m for d, m in zip(o_done, mask)]
        else:
            max_pos = max(max_pos, float(pos_err.max()))
            max_rew = max(max_rew, float(rew_err.max()))
            flags_ok &= not disagree
        if any(o_done):
            mask = np.array(o_done)
            for i in np.flatnonzero(mask):
                oracle.reset_one(i)
            state = tenv.reset_where(spec, state, torch.tensor(mask))
        if all(o_fin):
            oracle.reset()
            state = tenv.reset(spec, p, (), torch.float64)
    return max_pos, max_rew, max_obs, flags_ok, ties


@pytest.mark.parametrize("world", WORLDS)
def test_f64_step_matches_oracle(world):
    max_pos, max_rew, max_obs, flags_ok, _ = run_oracle_parity(get_world(world))
    assert flags_ok
    assert max_pos <= 1e-12 and max_rew <= 1e-12 and max_obs <= 1e-12, (
        max_pos, max_rew, max_obs)


def _j_state_to_torch(s) -> DroneState:
    return DroneState(*[torch.from_numpy(np.array(x)) for x in s])


@pytest.mark.parametrize("rounding", [False, True])
@pytest.mark.parametrize("world", WORLDS)
def test_f32_step_matches_jax(world, rounding):
    """Teacher-forced: each step starts both from the JAX state. With
    parity rounding on, the desired velocity is rounded twice (3, then 2
    decimals in obs_self); where the 3-decimal value ends in 5 the second
    rounding is a tie, and XLA's and torch's f32 divisions may land on
    either side of it. Only those elements may differ, by one 0.01 step."""
    wd = get_world(world)
    jp = JEnvParams(num_drones=wd.drone_num, parity_rounding=rounding)
    tp = EnvParams(num_drones=wd.drone_num, parity_rounding=rounding)
    jspec = j_make_world_spec(wd.waypoints_list, wd.building_list, wd.map_size)
    tspec = wd.spec(device="cpu")
    jstep = jax.jit(lambda s, a: jenv.step(jspec, s, a, jp))
    jstate = jenv.reset(jspec, jp)
    rng = np.random.default_rng(3)
    n = wd.drone_num
    for t in range(20):
        acts = np.round(rng.uniform(-1, 1, (n, 3)), 2).astype(np.float32)
        tstate = _j_state_to_torch(jstate)
        jstate, jout = jstep(jstate, jnp.asarray(acts))
        tstate, tout = tenv.step(tspec, tstate, torch.from_numpy(acts), tp)
        for name, a, b in zip(DroneState._fields, tstate, jstate):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=0, err_msg=f"{name} t={t}")
        tie = np.zeros(tout.obs_self.shape, bool)
        if rounding:
            des3 = tenv.drone_states_12(tspec, tstate, tp)[0][..., 8:11].numpy()
            frac = np.abs(des3) * 100.0 - np.floor(np.abs(des3) * 100.0)
            tie[..., 8:11] = np.abs(frac - 0.5) < 1e-3
        for name, a, b in zip(tout._fields, tout, jout):
            a, b = a.numpy(), np.asarray(b)
            if a.dtype == bool:
                assert np.array_equal(a, b), (name, t)
                continue
            assert np.array_equal(np.isfinite(a), np.isfinite(b)), (name, t)
            fin = np.isfinite(b)
            diff = np.where(fin, np.abs(a - np.where(fin, b, 0.0)), 0.0)
            off = diff > 1e-5
            if name == "obs_self":
                assert not np.any(off & ~tie), (t, np.argwhere(off & ~tie))
                assert np.all(diff[off] <= 0.01 + 1e-6), (t, diff[off])
            else:
                assert not np.any(off), (name, t, diff.max())
        # keep the fleet flying: reset collided drones in the JAX state
        jstate = jenv.reset_where(jspec, jstate, jout.done)


def test_f32_observe_and_reset_where_match_jax():
    """Without parity rounding, so the comparison holds at 1e-5 throughout
    (the rounding itself is held to the oracle in float64 above)."""
    wd = get_world("world32_mix")
    jp = JEnvParams(num_drones=wd.drone_num, parity_rounding=False)
    tp = EnvParams(num_drones=wd.drone_num, parity_rounding=False)
    jspec = j_make_world_spec(wd.waypoints_list, wd.building_list, wd.map_size)
    tspec = wd.spec(device="cpu")
    jstate = jenv.reset(jspec, jp)
    rng = np.random.default_rng(4)
    jstep = jax.jit(lambda s, a: jenv.step(jspec, s, a, jp))
    for _ in range(3):
        jstate, _ = jstep(jstate, jnp.asarray(
            np.round(rng.uniform(-1, 1, (wd.drone_num, 3)), 2), jnp.float32))
    mask = rng.random(wd.drone_num) > 0.5
    j_reset = jenv.reset_where(jspec, jstate, jnp.asarray(mask))
    t_reset = tenv.reset_where(tspec, _j_state_to_torch(jstate), torch.from_numpy(mask))
    for a, b in zip(t_reset, j_reset):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jout, _ = jax.jit(lambda s: jenv.observe(jspec, s, jp))(j_reset)
    tout, _ = tenv.observe(tspec, t_reset, tp)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_batched_lanes_match_single_env():
    """Lane e of an [E, N] batch equals the same env stepped alone."""
    wd = get_world("gen_demo")
    p = EnvParams(num_drones=wd.drone_num)
    spec = wd.spec(device="cpu")
    env = tenv.DroneEnv(spec, p, num_envs=3)
    state_b, _ = env.reset()
    state_1 = tenv.reset(spec, p)
    rng = np.random.default_rng(5)
    for _ in range(6):
        acts = torch.from_numpy(np.round(rng.uniform(-1, 1, (3, wd.drone_num, 3)),
                                         2).astype(np.float32))
        state_b, out_b = env.step(state_b, acts)
        state_1, out_1 = tenv.step(spec, state_1, acts[1], p)
        for a, b in zip(state_b, state_1):
            torch.testing.assert_close(a[1], b, rtol=0, atol=0)
        for a, b in zip(out_b, out_1):
            torch.testing.assert_close(a[1], b, rtol=0, atol=0)
    flat = env.obs_flat(out_b)
    assert flat.shape == (3, wd.drone_num, 12 + 9 * p.neighbor_num)
    torch.testing.assert_close(flat[..., 12:21], out_b.obs_nbr[..., 0, :])


def test_lexsort_with_ties_matches_jnp():
    rng = np.random.default_rng(6)
    sort_t = rng.choice([-np.inf, 0.25, 0.5, 1.0], size=(64, 12)).astype(np.float32)
    sort_d = rng.choice([0.0, 1.5, 2.0, 3.0], size=(64, 12)).astype(np.float32)
    sort_d[sort_t == -np.inf] = 0.0
    ref = np.asarray(jnp.lexsort((-jnp.asarray(sort_d), jnp.asarray(sort_t)), axis=-1))
    got = lexsort_rows(torch.from_numpy(sort_t), torch.from_numpy(sort_d)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.lexsort((-sort_d, sort_t), axis=-1))


def test_rounding_and_yaw_modulo_match_jax():
    """torch.round(decimals) is half-to-even like jnp.round and np.round;
    torch.remainder is the floor modulo of jnp's and Python's `%`."""
    ties = np.array([0.125, -0.125, 0.375, 2.5e-3, -7.5e-3, 1.005, 0.015],
                    np.float64)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(ties), decimals=2).numpy(),
                                  np.round(ties, 2))
    yaw = np.array([-90.0, -1e-20, -360.0, -725.25, 359.5, 720.0, -3e-6], np.float64)
    got = torch.remainder(torch.from_numpy(yaw), 360.0).numpy()
    np.testing.assert_array_equal(got, np.asarray([y % 360.0 for y in yaw]))
    np.testing.assert_array_equal(
        torch.remainder(torch.from_numpy(yaw).float(), 360.0).numpy(),
        np.asarray(jnp.asarray(yaw, jnp.float32) % 360.0))


def test_waypoint_controller_matches_jax():
    from rvo3d_tpu.utils.heuristic import waypoint_controller as j_controller
    from rvo3d_tpu_torch.utils.heuristic import waypoint_controller

    wd = get_world("world16_dense")
    jp = JEnvParams(num_drones=wd.drone_num)
    jspec = j_make_world_spec(wd.waypoints_list, wd.building_list, wd.map_size)
    tspec = wd.spec(device="cpu")
    jstate = jenv.reset(jspec, jp)
    jstep = jax.jit(lambda s, a: jenv.step(jspec, s, a, jp))
    for _ in range(10):
        ref = j_controller(jstate, jspec)
        got = waypoint_controller(_j_state_to_torch(jstate), tspec)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
        jstate, _ = jstep(jstate, jnp.round(ref, 2))
