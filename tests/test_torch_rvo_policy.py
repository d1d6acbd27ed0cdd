"""The port's RVO expert (rvo3d_tpu_torch/env/rvo_policy.py) against the JAX
package's rvo3d_tpu/env/rvo_policy.py.

  - The candidate grid: 9 values per axis at the defaults (729
    candidates), equal to JAX's in float32 and float64, with the same
    minimum-speed mask.
  - float64 under jax_enable_x64, on states of a seeded flight (the
    waypoint controller plus noise, with resets) on world16_dense and
    world32_mix, for margin None, 0.3 and 0.8 with slowdown off and on:
    the chosen candidate index of every drone equals JAX's exactly (the
    JAX velocity is mapped back to its grid index), velocity_to_action of
    every chosen velocity and rvo_controller (margin 0.3, slowdown) agree
    at 1e-12.
  - float32 (both packages' default): argmin flips against JAX are counted
    over the same states and configurations and bounded: at most 1 % of
    the drone decisions (a flip needs two candidate costs within float32
    rounding of each other).
  - A lane world's expert equals each lane's single-world expert exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu.config import EnvParams as JEnvParams
from rvo3d_tpu.env import rvo_policy as jrvo
from rvo3d_tpu.env.state import DroneState as JDroneState
from rvo3d_tpu.env.state import make_world_spec as j_make_world_spec
from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import env as tenv
from rvo3d_tpu_torch.env import geometry as geo
from rvo3d_tpu_torch.env import rvo_policy
from rvo3d_tpu_torch.utils.heuristic import waypoint_controller
from rvo3d_tpu_torch.worlds import load_world, multi
from torch_threads import one_intra_op_thread  # noqa: F401

CONFIGS = [(m, s) for m in (None, 0.3, 0.8) for s in (False, True)]
LANES, STEPS, EVERY = 2, 24, 6


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("min_speed", [0.0, 0.3])
def test_candidate_grid_matches_jax(dtype, min_speed):
    with jax.enable_x64(dtype == np.float64):
        jc, jok = jrvo._candidate_grid(1.0, 0.25, min_speed)
        jc, jok = np.asarray(jc), np.asarray(jok)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tc, tok = rvo_policy.candidate_grid(1.0, 0.25, min_speed, tdt, "cpu")
    assert tc.shape == (729, 3) and jc.shape == (729, 3)
    assert jc.dtype == dtype
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tok.numpy(), jok)


def flight_states(name, dtype):
    """(port world, jax world, [port DroneState]) along a seeded flight."""
    wd = load_world(name)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tw = wd.spec(dtype=tdt, device="cpu")
    jw = j_make_world_spec(wd.waypoints_list, wd.building_list, wd.map_size, dtype=dtype)
    p = EnvParams(num_drones=wd.drone_num)
    st = tenv.reset(tw, p, (LANES,))
    g = torch.Generator().manual_seed(0)
    states = []
    for t in range(STEPS):
        noise = 0.3 * torch.randn(st.pos.shape, generator=g, dtype=tdt)
        st, out = tenv.step(tw, st, geo.rnd(waypoint_controller(st, tw) + noise, 2), p)
        st = tenv.reset_where(tw, st, out.done | out.finish)
        if t % EVERY == EVERY - 1:
            states.append(st)
    return tw, jw, p, states


def jax_state(st):
    return JDroneState(*[jnp.asarray(x.numpy()) for x in st])


def grid_index(v, cands):
    """The grid index of each velocity [..., 3] (exactly one match)."""
    hit = np.all(np.asarray(v)[..., None, :] == cands, axis=-1)
    assert np.all(hit.sum(-1) == 1)
    return hit.argmax(-1)


def choices(name, dtype):
    """{(margin, slowdown): (port indices, JAX indices)} over the states."""
    tw, jw, p, states = flight_states(name, dtype)
    jp = JEnvParams(num_drones=p.num_drones)
    cands = rvo_policy.candidate_grid(1.0, 0.25, 0.0, tw.dtype, "cpu")[0].numpy()
    out = {}
    for margin, slow in CONFIGS:
        kw = {} if margin is None else {"margin": margin}
        jfn = jax.jit(jax.vmap(lambda s: jrvo.rvo_velocity(jw, s, jp, slowdown=slow, **kw)))
        got, ref = [], []
        for st in states:
            idx, _ = rvo_policy.rvo_choice(tw, st, p, margin=margin, slowdown=slow)
            got.append(idx.numpy())
            ref.append(grid_index(jfn(jax_state(st)), cands))
        out[(margin, slow)] = (np.stack(got), np.stack(ref))
    return out, (tw, jw, p, jp, states)


@pytest.mark.parametrize("name", ["world16_dense", "world32_mix"])
def test_f64_expert_matches_jax_exactly(name):
    with jax.enable_x64(True):
        out, (tw, jw, p, jp, states) = choices(name, np.float64)
        for cfg, (got, ref) in out.items():
            np.testing.assert_array_equal(got, ref, err_msg=str(cfg))
        cands = rvo_policy.candidate_grid(1.0, 0.25, 0.0, tw.dtype, "cpu")[0]
        j_action = jax.jit(jax.vmap(lambda s, vv: jrvo.velocity_to_action(s, vv, jp)))
        j_ctrl = jax.jit(jax.vmap(lambda s: jrvo.rvo_controller(s, jw, jp, margin=0.3,
                                                                 slowdown=True)))
        for k, st in enumerate(states):
            js = jax_state(st)
            for got, _ in out.values():
                v = cands[torch.from_numpy(got[k])]
                a = rvo_policy.velocity_to_action(st, v, p)
                ja = j_action(js, jnp.asarray(v.numpy()))
                np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=1e-12)
            c = rvo_policy.rvo_controller(st, tw, p, margin=0.3, slowdown=True)
            np.testing.assert_allclose(c.numpy(), np.asarray(j_ctrl(js)), rtol=0,
                                       atol=1e-12)
    # the states hold real encounters and arrivals: the margin and the
    # slowdown change some choices
    assert (out[(None, False)][0] != out[(0.8, False)][0]).any()
    assert (out[(0.3, False)][0] != out[(0.3, True)][0]).any()


@pytest.mark.parametrize("name", ["world16_dense", "world32_mix"])
def test_f32_expert_argmin_flips_are_rare(name):
    out, _ = choices(name, np.float32)
    flips = sum(int((got != ref).sum()) for got, ref in out.values())
    total = sum(got.size for got, _ in out.values())
    assert flips <= 0.01 * total, (flips, total)


def test_lane_world_expert_equals_single_worlds():
    wd = load_world("world32_mix")
    specs = [wd.spec(dtype=torch.float64, device="cpu")]
    specs.append(multi.reverse_routes(specs[0]))
    p = EnvParams(num_drones=wd.drone_num)
    idx = torch.tensor([0, 1, 1, 0])
    env = multi.MultiWorldEnv(specs, idx, p)
    st, _ = env.reset_batch()
    g = torch.Generator().manual_seed(1)
    for _ in range(8):
        act = geo.rnd(waypoint_controller(st, env.lane_worlds)
                      + 0.3 * torch.randn(st.pos.shape, generator=g, dtype=torch.float64), 2)
        st, out = env.step_batch(st, act)
        st = env.reset_where_batch(st, out.done | out.finish)
    got = rvo_policy.rvo_controller(st, env.lane_worlds, p, margin=0.3, slowdown=True)
    for e in range(4):
        one = type(st)(*[x[e:e + 1] for x in st])
        ref = rvo_policy.rvo_controller(one, specs[int(idx[e])], p, margin=0.3,
                                        slowdown=True)
        assert torch.equal(got[e:e + 1], ref)
