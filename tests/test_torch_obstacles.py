"""Dynamic sphere obstacles in the port (rvo3d_tpu_torch/env/obstacles.py)
against the JAX package's: the motion models, the norm-cone test, the
receding-horizon prediction, and env steps of a world whose spheres join
the VO engine as extra participants (M = N + S > nm), with both reward
modes (safe_rewards off keeps the reference's +inf for arrived drones).
f32 at 1e-5, parity rounding off so no 2-decimal tie can flip (rounding
is held to the oracle in float64 by test_torch_env.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu.config import EnvParams as JEnvParams
from rvo3d_tpu.env import env as jenv
from rvo3d_tpu.env import obstacles as jobs
from rvo3d_tpu.env.state import make_world_spec as j_make_world_spec
from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import env as tenv
from rvo3d_tpu_torch.env import obstacles as tobs
from rvo3d_tpu_torch.env.state import DroneState, make_world_spec

SPHERES = [
    {"pos": (5.0, 5.0, 3.0), "radius": 0.5},
    {"pos": (2.0, 8.0, 2.0), "vel": (0.6, -0.3, 0.1), "radius": 0.4, "model": "linear"},
    {"pos": (9.0, 2.0, 4.0), "vel": (0.5, 0.0, 0.0), "radius": 0.3,
     "model": "goal", "goal": (3.0, 9.0, 2.0)},
]
# 12 drones crossing a 12 x 12 x 6 map: M = 12 + 3 others > nm = 10
WAYPOINTS = [[[1.0 + i * 0.8, 1.0, 2.0 + (i % 3)], [11.0 - i * 0.8, 11.0, 4.0 - (i % 3)]]
             for i in range(12)]
BUILDINGS = [[6.0, 6.0, 5.0, 0.8]]
MAP = [12.0, 12.0, 6.0]


def test_sphere_motion_matches_jax():
    jspec = jobs.make_sphere_spec(SPHERES)
    tspec = tobs.make_sphere_spec(SPHERES, device="cpu")
    jpos, jvel = jspec.init[:, 0:3], jspec.init[:, 3:6]
    tpos, tvel = tspec.init[:, 0:3], tspec.init[:, 3:6]
    map_size = np.asarray(MAP, np.float32)
    for _ in range(40):
        jpos, jvel = jobs.step_spheres(jpos, jvel, jspec, jnp.asarray(map_size), 1.0, 0.4)
        tpos, tvel = tobs.step_spheres(tpos, tvel, tspec, torch.from_numpy(map_size), 1.0, 0.4)
        np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), atol=1e-5)
        np.testing.assert_allclose(tvel.numpy(), np.asarray(jvel), atol=1e-5)
    np.testing.assert_array_equal(
        tobs.sphere_states8(tpos, tvel, tspec).numpy(),
        np.asarray(jobs.sphere_states8(jnp.asarray(tpos.numpy()),
                                       jnp.asarray(tvel.numpy()), jspec)))
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 12, (3, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tobs.inside_sphere(torch.from_numpy(pts), tpos, tspec.init[:, 6]).numpy(),
        np.asarray(jobs.inside_sphere(jnp.asarray(pts), jnp.asarray(tpos.numpy()),
                                      jspec.init[:, 6])))
    np.testing.assert_allclose(
        tobs.predict_states(tpos, tvel, tspec.init[:, 6], 1.0).numpy(),
        np.asarray(jobs.predict_states(jnp.asarray(tpos.numpy()),
                                       jnp.asarray(tvel.numpy()),
                                       jspec.init[:, 6], 1.0)), atol=1e-6)


@pytest.mark.parametrize("safe_rewards", [False, True])
def test_env_step_with_spheres_matches_jax(safe_rewards):
    n = len(WAYPOINTS)
    jp = JEnvParams(num_drones=n, parity_rounding=False, safe_rewards=safe_rewards)
    tp = EnvParams(num_drones=n, parity_rounding=False, safe_rewards=safe_rewards)
    jspec = j_make_world_spec(WAYPOINTS, BUILDINGS, MAP, spheres=SPHERES)
    tspec = make_world_spec(WAYPOINTS, BUILDINGS, MAP, spheres=SPHERES, device="cpu")
    jstep = jax.jit(lambda s, a: jenv.step(jspec, s, a, jp))
    jstate = jenv.reset(jspec, jp)
    rng = np.random.default_rng(1)
    flagged = 0
    for t in range(15):
        acts = np.round(rng.uniform(-1, 1, (n, 3)), 2).astype(np.float32)
        tstate = DroneState(*[torch.from_numpy(np.array(x)) for x in jstate])
        jstate, jout = jstep(jstate, jnp.asarray(acts))
        tstate, tout = tenv.step(tspec, tstate, torch.from_numpy(acts), tp)
        for a, b in list(zip(tstate, jstate)) + list(zip(tout, jout)):
            a, b = a.numpy(), np.asarray(b)
            assert np.array_equal(np.isfinite(a), np.isfinite(b)), t
            fin = np.isfinite(b)
            np.testing.assert_allclose(a[fin], b[fin], atol=1e-5, rtol=0, err_msg=str(t))
        flagged += int(tout.obs_mask.sum())
        jstate = jenv.reset_where(jspec, jstate, jout.done)
    assert flagged > 0  # the VO top-nm path was exercised
