"""Trajectory recording and rendering in the port (rvo3d_tpu_torch/render/,
cli render, train --render_every) against the JAX package's:

  - record_trajectory on gen_demo, 60 steps, float32, with the waypoint
    controller (the w16_r4 product's run is tests/test_torch_render_policy.py):
    positions and rewards within 1e-5 (the float32 env's distance from the
    JAX step, tests/test_torch_env.py), flags and masks equal. Each
    waypoint controller flies its own env with positions within 1e-5 and
    actions within 1e-6; the rewards are compared with the JAX actions
    replayed into the port, because the reward's angle bucket is a step
    function: where the controller's speed term crosses zero a 1-ulp
    velocity difference makes one action 0 and the other -6e-8, and the
    bucket of the two rewards differs by 4 (a float32 tie across backends,
    ROADMAP C3);
  - cones_from_obs exactly;
  - ScenePlotter.render_trajectory (Agg) writes the same PNG files, byte
    for byte, from the same trajectory;
  - `cli render` and `cli train --render_every 1` end to end on the CPU.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from rvo3d_tpu.config import EnvParams as JEnvParams
from rvo3d_tpu.env import DroneEnv as JDroneEnv
from rvo3d_tpu.render import ScenePlotter as JScenePlotter
from rvo3d_tpu.render import cones_from_obs as j_cones
from rvo3d_tpu.render import record_trajectory as j_record
from rvo3d_tpu.utils import waypoint_controller as j_waypoint
from rvo3d_tpu.worlds import load_world as j_load_world
from rvo3d_tpu_torch import cli
from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env import DroneEnv
from rvo3d_tpu_torch.render import ScenePlotter, cones_from_obs, record_trajectory
from rvo3d_tpu_torch.utils.heuristic import waypoint_controller
from rvo3d_tpu_torch.worlds import load_world

WORLD, STEPS, TOL = "gen_demo", 60, 1e-5
EXACT = ("done", "finish", "obs_mask")
CLOSE = ("pos", "vel", "reward")


def _envs():
    wd = load_world(WORLD)
    p = EnvParams(num_drones=wd.drone_num)
    jwd = j_load_world(WORLD)
    return (DroneEnv(wd.spec(device="cpu"), p),
            JDroneEnv(jwd.spec(), JEnvParams(num_drones=jwd.drone_num)))


def _same(got, ref, close=CLOSE):
    for k in EXACT:
        assert np.array_equal(got[k], ref[k]), k
    for k in close:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=TOL, err_msg=k)
    assert got["done"].any() or got["finish"].any(), "no collision and no arrival"


def _recorded(controller, acts):
    def run(state, world):
        a = controller(state, world)
        acts.append(np.asarray(a).reshape(-1, 3))
        return a
    return run


@pytest.fixture(scope="module")
def waypoint_records():
    env, jenv = _envs()
    acts, jacts = [], []
    got = record_trajectory(env, _recorded(waypoint_controller, acts), steps=STEPS)
    ref = j_record(jenv, _recorded(j_waypoint, jacts), steps=STEPS)
    it = iter(jacts)
    replay = record_trajectory(env, lambda s, w: torch.tensor(next(it))[None],
                               steps=STEPS)
    return got, ref, replay, np.stack(acts), np.stack(jacts)


def test_waypoint_trajectory_matches_jax(waypoint_records):
    got, ref, replay, acts, jacts = waypoint_records
    assert got["pos"].shape == ref["pos"].shape == (STEPS, 4, 3)
    _same(got, ref, close=("pos", "vel"))
    np.testing.assert_allclose(acts, jacts, rtol=0, atol=1e-6)
    _same(replay, ref)


def test_cones_from_obs_is_exact(waypoint_records):
    ref = waypoint_records[1]
    for t in range(STEPS):
        a = cones_from_obs(ref["obs_nbr"][t], ref["obs_mask"][t])
        b = j_cones(ref["obs_nbr"][t], ref["obs_mask"][t])
        assert len(a) == len(b)
        for (va, xa, aa), (vb, xb, ab) in zip(a, b):
            assert np.array_equal(va, vb) and np.array_equal(xa, xb) and aa == ab


def test_scene_plotter_writes_the_jax_frames(tmp_path, waypoint_records):
    ref = waypoint_records[1]
    wd = load_world(WORLD)
    out = {}
    for name, cls in (("port", ScenePlotter), ("jax", JScenePlotter)):
        plotter = cls(wd.map_size, wd.building_list, wd.waypoints_list)
        try:
            out[name] = plotter.render_trajectory(ref, str(tmp_path / name), every=25,
                                                  draw_cones=True)
        finally:
            plotter.close()
    assert [os.path.basename(p) for p in out["port"]] == \
        [os.path.basename(p) for p in out["jax"]] == [f"frame_{t:04d}.png" for t in (0, 25, 50)]
    for a, b in zip(out["port"], out["jax"]):
        assert filecmp.cmp(a, b, shallow=False), (a, b)


def test_cli_render_runs_on_the_cpu(tmp_path, capsys):
    assert cli.main(["render", "--device", "cpu", "--world", WORLD, "--steps", "12",
                     "--every", "6", "--cones", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("2 frames ->")
    assert sorted(os.listdir(tmp_path))[:2] == ["episode.gif", "episode.mp4"]


def test_cli_train_render_every_writes_gifs(tmp_path, capsys):
    run = tmp_path / "run"
    assert cli.main(["train", "--device", "cpu", "--world", WORLD, "--num_envs", "2",
                     "--steps_per_epoch", "8", "--train_epoch", "0", "--rnn_hidden_dim",
                     "16", "--train_pi_iters", "2", "--train_v_iters", "2",
                     "--batched_update", "--action_mode", "direct", "--save_freq", "5",
                     "--eval_episodes", "2", "--render_every", "1", "--quiet",
                     "--run_dir", str(run)]) == 0
    out = capsys.readouterr().out
    assert f"render_every: epoch 0 -> {run / 'media' / 'epoch_0.gif'}" in out
    assert (run / "media" / "epoch_0.gif").exists()
    assert len(os.listdir(run / "media" / "epoch_0")) == 30   # 60 steps, every 2
