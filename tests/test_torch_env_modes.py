"""The port's env in its other two modes against the NumPy oracle, 200
float64 steps, positions/rewards/observations to 1e-12, flags exact:

  - noise: the same pre-drawn control-noise samples go into both (the
    port scales standard normals by control_std, as the JAX env does);
  - eval (env_train=False): the shrunk collision radius. world16_dense is
    left out: on its trajectory the oracle itself raises (math domain
    error in asin at oracle.py:276, a pair inside r_a + r_b but outside
    the shrunk radius), where the JAX package and the port clamp.

On world16_dense the eval mode is held against the JAX step instead
(float64 under jax_enable_x64, 200 steps in lockstep of the waypoint
controller plus noise, with resets):
positions and rewards to 1e-12, flags exactly, observations to 1e-12
except an observed desired-velocity component at a 3-decimal tie, which
may differ by one 0.01 step (XLA rounds in float64 by multiplying with
the scale's reciprocal; the port divides, as the oracle does).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu.config import EnvParams as JEnvParams
from rvo3d_tpu.env import env as jenv
from rvo3d_tpu.env.state import make_world_spec as j_make_world_spec
from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import env as tenv
from rvo3d_tpu_torch.utils.heuristic import waypoint_controller
from test_torch_env import WORLDS, get_world, run_oracle_parity
from test_torch_multi import close_obs_self_f64

CASES = ([("noise", w) for w in WORLDS]
         + [("eval", w) for w in WORLDS if w != "world16_dense"])


@pytest.mark.parametrize("mode,world", CASES)
def test_f64_step_matches_oracle_in_mode(mode, world):
    max_pos, max_rew, max_obs, flags_ok, _ = run_oracle_parity(
        get_world(world), noise=mode == "noise", env_train=mode != "eval")
    assert flags_ok
    assert max_pos <= 1e-12 and max_rew <= 1e-12 and max_obs <= 1e-12, (
        max_pos, max_rew, max_obs)


def test_f64_eval_mode_matches_jax_on_world16_dense():
    wd = get_world("world16_dense")
    n = wd.drone_num
    tp = EnvParams(num_drones=n, env_train=False)
    rng = np.random.default_rng(7)
    events = np.zeros(3, int)
    with jax.enable_x64(True):
        jp = JEnvParams(num_drones=n, env_train=False)
        jspec = j_make_world_spec(wd.waypoints_list, wd.building_list, wd.map_size,
                                  dtype=np.float64)
        tspec = wd.spec(dtype=torch.float64, device="cpu")
        jstep = jax.jit(lambda s, a: jenv.step(jspec, s, a, jp))
        jreset = jax.jit(lambda s, m: jenv.reset_where(jspec, s, m))
        jstate = jenv.reset(jspec, jp, jnp.float64)
        tstate = tenv.reset(tspec, tp, (), torch.float64)
        for t in range(200):
            cmd = waypoint_controller(tstate, tspec).numpy()
            acts = np.round(cmd + 0.2 * rng.standard_normal((n, 3)), 2)
            jstate, jout = jstep(jstate, jnp.asarray(acts))
            tstate, tout = tenv.step(tspec, tstate, torch.from_numpy(acts), tp)
            for name in ("done", "info_arrive", "finish", "obs_mask"):
                np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                              np.asarray(getattr(jout, name)),
                                              err_msg=f"{name} at step {t}")
            for name in ("reward", "obs_nbr"):
                np.testing.assert_allclose(getattr(tout, name).numpy(),
                                           np.asarray(getattr(jout, name)), rtol=0,
                                           atol=1e-12, err_msg=f"{name} at step {t}")
            close_obs_self_f64(tout.obs_self, jout.obs_self, 1e-12)
            for name, a, b in zip(tstate._fields, tstate, jstate):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12,
                                           err_msg=f"state.{name} at step {t}")
            done = tout.done.numpy()
            events += [int(done.sum()), int(tout.finish.numpy().sum()),
                       int(tout.obs_mask.numpy().sum())]
            if tout.finish.numpy().all():
                jstate = jenv.reset(jspec, jp, jnp.float64)
                tstate = tenv.reset(tspec, tp, (), torch.float64)
            elif done.any():
                jstate = jreset(jstate, jnp.asarray(done))
                tstate = tenv.reset_where(tspec, tstate, torch.from_numpy(done))
    # collisions under the shrunk radius, arrivals and flagged neighbours
    assert (events > 0).all(), events
