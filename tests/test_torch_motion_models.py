"""The port's motion models (rvo3d_tpu_torch/env/motion_models.py) and the
kinematic variant (config.kinematic_variant_params) against the JAX
package's, on seeded inputs:

  - each of motion_omni (with noise: the port's draws through the JAX
    function's formula, the JAX key draws other numbers), euler_rotation, motion_euler,
    ackermann_preview and ackermann_step, over leading batch axes: float32
    at 1e-5, float64 (jax_enable_x64) at 1e-12; ackermann_step's 4-decimal
    rounding lands on the same values in float64 (no input at a tie);
  - kinematic_variant_params() equals JAX's field by field, overrides too;
  - 200 float64 env steps on world16_dense under it (max_acc 10) match the
    JAX step in lockstep: positions and rewards to 1e-12, flags exactly,
    observations as tests/test_torch_env_modes.py holds them.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu import config as jconfig
from rvo3d_tpu.env import env as jenv
from rvo3d_tpu.env import motion_models as jmm
from rvo3d_tpu.env.state import make_world_spec as j_make_world_spec
from rvo3d_tpu_torch import config as tconfig
from rvo3d_tpu_torch.env import env as tenv
from rvo3d_tpu_torch.env import motion_models as mm
from rvo3d_tpu_torch.utils.heuristic import waypoint_controller
from rvo3d_tpu_torch.worlds import load_world
from test_torch_multi import close_obs_self_f64
from torch_threads import one_intra_op_thread  # noqa: F401

TOL = {np.float32: 1e-5, np.float64: 1e-12}
LEAD = (4, 5)


def inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "pos": rng.uniform(-5, 5, LEAD + (3,)).astype(dtype),
        "vel": rng.uniform(-1, 1, LEAD + (3,)).astype(dtype),
        "angles": rng.uniform(-200, 200, LEAD + (3,)).astype(dtype),
        "acker4": np.concatenate([rng.uniform(-3, 3, LEAD + (2,)),
                                  rng.uniform(-3, 3, LEAD + (1,)),
                                  np.zeros(LEAD + (1,))], -1).astype(dtype),
        "acker3": np.concatenate([rng.uniform(-3, 3, LEAD + (2,)),
                                  rng.uniform(0, 6.2, LEAD + (1,))], -1).astype(dtype),
        "psi": rng.uniform(-1.2, 1.2, LEAD).astype(dtype),
    }


def port_and_jax(dtype, x):
    """(port outputs, JAX outputs) of every function on the inputs `x`."""
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    j = {k: jnp.asarray(v) for k, v in x.items()}
    g = torch.Generator().manual_seed(3)
    noisy = mm.motion_omni(t["pos"], t["vel"], 0.5, g, control_std=0.1)
    eps = torch.randn(t["vel"].shape, generator=torch.Generator().manual_seed(3),
                      dtype=t["vel"].dtype)
    port = {
        "omni": mm.motion_omni(t["pos"], t["vel"], 0.5),
        "omni_noise": noisy,
        "rotation": mm.euler_rotation(t["angles"][..., 0], t["angles"][..., 1],
                                      t["angles"][..., 2]),
        "euler": torch.cat(mm.motion_euler(t["pos"], t["angles"], t["vel"], 0.5, 60.0), -1),
        "preview": mm.ackermann_preview(t["acker4"], wheelbase=1.5, vel=0.8, psi=0.3),
        "preview_psi": mm.ackermann_preview(t["acker4"], psi=t["psi"], pre_time=1.0,
                                            dt=0.05),
    }
    ref = {
        "omni": jmm.motion_omni(j["pos"], j["vel"], 0.5),
        # the port's draws, scaled as the JAX function scales its own
        "omni_noise": j["pos"] + (j["vel"] + jnp.asarray(eps.numpy()) * 0.1) * 0.5,
        "rotation": jmm.euler_rotation(j["angles"][..., 0], j["angles"][..., 1],
                                       j["angles"][..., 2]),
        "euler": jnp.concatenate(jmm.motion_euler(j["pos"], j["angles"], j["vel"], 0.5,
                                                  60.0), -1),
        "preview": jmm.ackermann_preview(j["acker4"], wheelbase=1.5, vel=0.8, psi=0.3),
        "preview_psi": jmm.ackermann_preview(j["acker4"], psi=j["psi"], pre_time=1.0,
                                             dt=0.05),
    }
    for gear in (1.0, -1.0):
        for steer in (-1.0, 0.0, 1.0):
            key = f"step_g{gear}_s{steer}"
            port[key] = mm.ackermann_step(t["acker3"], gear, steer, step_size=0.7,
                                          min_radius=1.3)
            ref[key] = jmm.ackermann_step(j["acker3"], gear, steer, step_size=0.7,
                                          min_radius=1.3)
    return port, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_motion_models_match_jax(dtype):
    with jax.enable_x64(dtype == np.float64):
        port, ref = port_and_jax(dtype, inputs(dtype))
    for name, want in ref.items():
        got = port[name]
        assert got.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype, name
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, atol=TOL[dtype], rtol=0, err_msg=name)
        if name.startswith("step") and dtype == np.float64:
            np.testing.assert_array_equal(np.round(got.numpy(), 4), np.round(want, 4),
                                          err_msg=name)
    # the noise moved the drones, and is reproducible from the generator
    assert not torch.equal(port["omni_noise"], port["omni"])
    assert torch.allclose(port["rotation"] @ port["rotation"].transpose(-1, -2),
                          torch.eye(3, dtype=port["rotation"].dtype), atol=TOL[dtype] * 10)


def test_kinematic_variant_params_equal_jax():
    for kw in ({}, {"num_drones": 16, "max_acc": 4.0, "noise": True}):
        t, j = tconfig.kinematic_variant_params(**kw), jconfig.kinematic_variant_params(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tconfig.kinematic_variant_params().max_acc == 10.0


def test_f64_kinematic_variant_steps_match_jax():
    wd = load_world("world16_dense")
    n = wd.drone_num
    tp = tconfig.kinematic_variant_params(num_drones=n)
    rng = np.random.default_rng(11)
    events = np.zeros(3, int)
    with jax.enable_x64(True):
        jp = jconfig.kinematic_variant_params(num_drones=n)
        jspec = j_make_world_spec(wd.waypoints_list, wd.building_list, wd.map_size,
                                  dtype=np.float64)
        tspec = wd.spec(dtype=torch.float64, device="cpu")
        jstep = jax.jit(lambda s, a: jenv.step(jspec, s, a, jp))
        jreset = jax.jit(lambda s, m: jenv.reset_where(jspec, s, m))
        jstate = jenv.reset(jspec, jp, jnp.float64)
        tstate = tenv.reset(tspec, tp, (), torch.float64)
        for t in range(200):
            cmd = waypoint_controller(tstate, tspec).numpy()
            acts = np.round(1.5 * cmd + 0.6 * rng.standard_normal((n, 3)), 2)
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
                       int(np.abs(tstate.vel.numpy()).max() > 1.0)]
            if tout.finish.numpy().all():
                jstate = jenv.reset(jspec, jp, jnp.float64)
                tstate = tenv.reset(tspec, tp, (), torch.float64)
            elif done.any():
                jstate = jreset(jstate, jnp.asarray(done))
                tstate = tenv.reset_where(tspec, tstate, torch.from_numpy(done))
    # collisions, arrivals, and steps past the default max_acc's speeds
    assert (events > 0).all(), events
