"""The port's benchmarks (rvo3d_tpu_torch/bench/) against the JAX package's
bench.py and scripts/*_bench.py, on the CPU at small sizes:

  - flagship_world() equals __graft_entry__._flagship_world();
  - core.run_chunk (the loop `cli bench` times) equals bench.py's loop,
    rebuilt here from rvo3d_tpu.env.env.{reset, step, reset_where} and
    the heuristic waypoint_controller under jit(vmap(scan)), step by step
    over 40 steps of 3 lanes: float64 (jax_enable_x64) at 1e-12 and float32
    at 1e-5, flags exactly. The loop rounds no action, so no 0.01 rounding
    tie can part the two (ROADMAP C3): every step is compared;
  - the ladder's rung-5 lane worlds (world32_mix and its flipped padded
    routes in alternate lanes) equal ladder_bench.py's construction leaf
    for leaf, and 20 float64 steps of them its vmapped loop;
  - `cli bench --device cpu` prints bench.py's keys plus `device` on its
    last line; detail's sections 1-3, serving and rung 5 run end to end at
    tiny sizes; the GRU bench refuses the CPU.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__
from rvo3d_tpu.config import EnvParams as JEnvParams
from rvo3d_tpu.env.env import reset as j_reset
from rvo3d_tpu.env.env import reset_where as j_reset_where
from rvo3d_tpu.env.env import step as j_step
from rvo3d_tpu.env.state import make_world_spec as j_make_world_spec
from rvo3d_tpu.utils.heuristic import waypoint_controller as j_controller
from rvo3d_tpu.worlds import load_world as j_load_world
from rvo3d_tpu.worlds import multi as jmulti
from rvo3d_tpu_torch import cli
from rvo3d_tpu_torch.bench import core, detail, gru, ladder, serving
from rvo3d_tpu_torch.bench.flagship import flagship_world
from rvo3d_tpu_torch.config import EnvParams, ModelConfig, TrainConfig
from rvo3d_tpu_torch.env.env import reset
from torch_threads import one_intra_op_thread  # noqa: F401

# bench.py:140-148
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "repeats", "min", "median", "max"}
SMALL = dict(rnn_hidden_dim=16, hidden_sizes_ac=(16, 16), hidden_sizes_v=(16, 16))


def assert_state_close(t, j, atol, msg=""):
    """Every DroneState leaf: integers and flags exactly, values at atol."""
    for name, a, b in zip(t._fields, t, j):
        a, b = a.numpy(), np.asarray(b)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name}")
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"{msg} {name}")


def jax_trajectory(jworld, jp, state, steps):
    """bench.py's loop under jit(vmap(scan)): the state after each step
    ([lanes, steps, ...] leaves)."""
    def one_step(st, _):
        st, out = j_step(jworld, st, j_controller(st, jworld), jp)
        st = j_reset_where(jworld, st, out.done | out.finish)
        return st, st

    return jax.jit(jax.vmap(lambda s: jax.lax.scan(one_step, s, None, length=steps)[1]))(
        state)


def test_flagship_world_equals_graft_entry():
    assert flagship_world() == __graft_entry__._flagship_world()


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 1e-5)],
                         ids=["float64", "float32"])
def test_run_chunk_matches_the_jax_bench_loop(dtype, atol):
    lanes, steps = 3, 40
    wd = flagship_world()
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    with jax.enable_x64(dtype == np.float64):
        jworld = j_make_world_spec(wd["waypoints_list"], wd["building_list"],
                                   wd["map_size"], dtype=dtype)
        jp = JEnvParams(num_drones=wd["drone_num"])
        s0 = j_reset(jworld, jp, dtype=dtype)
        jstate = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (lanes,) + x.shape).copy(), s0)
        traj = jax_trajectory(jworld, jp, jstate, steps)
        traj = jax.tree_util.tree_map(np.asarray, traj)
    world = core.world_spec(wd, "cpu", tdt)
    p = EnvParams(num_drones=wd["drone_num"])
    start = reset(world, p, lead=(lanes,))
    state, resets = start, 0
    for t in range(steps):
        state = core.run_chunk(world, state, p, 1)
        assert_state_close(state, [x[:, t] for x in traj], atol, f"step {t}")
        resets += int((state.real_route_len == 0).sum())     # reset this step
    assert resets > 0          # drones collided and were reset
    assert_state_close(core.run_chunk(world, start, p, steps),
                       [x[:, -1] for x in traj], atol, "one chunk")


def test_rung5_lane_worlds_match_the_ladder_script():
    lanes, steps = 4, 20
    with jax.enable_x64(True):
        spec32 = j_load_world("world32_mix").spec(dtype=np.float64)
        rev = spec32._replace(waypoints=spec32.waypoints[:, ::-1, :])
        jlanes = jmulti.worlds_for_lanes(jmulti.stack_worlds([spec32, rev]),
                                         np.arange(lanes) % 2)
        tlanes = ladder.rung5_lane_worlds(lanes, "cpu", torch.float64)
        for name, a, b in zip(tlanes._fields, tlanes, jlanes):
            if b is None:
                assert a is None, name
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        # the flip is of the padded array: a 2-point route starts on its end
        two = int(np.flatnonzero(np.asarray(spec32.n_points) == 2)[0])
        np.testing.assert_array_equal(tlanes.waypoints[1, two, 0].numpy(),
                                      np.asarray(spec32.waypoints)[two, -1])

        jp = JEnvParams(num_drones=32)

        def body(st, _):
            a = jax.vmap(j_controller)(st, jlanes)
            st, o = jax.vmap(lambda w, s, aa: j_step(w, s, aa, jp))(jlanes, st, a)
            st = jax.vmap(j_reset_where)(jlanes, st, o.done | o.finish)
            return st, None

        jstate = jax.vmap(lambda w: j_reset(w, jp, dtype=jnp.float64))(jlanes)
        jfinal = jax.jit(lambda s: jax.lax.scan(body, s, None, length=steps)[0])(jstate)
        jfinal = jax.tree_util.tree_map(np.asarray, jfinal)
    p = EnvParams(num_drones=32)
    final = core.run_chunk(tlanes, reset(tlanes, p, (lanes,)), p, steps)
    assert_state_close(final, jfinal, 1e-12)
    assert ladder.rung5("cpu", num_envs=2, steps=2, repeats=1) > 0


def test_cli_bench_prints_the_bench_py_line(monkeypatch, capsys):
    for name, value in (("ENVS", "4"), ("STEPS", "3"), ("REPEATS", "2")):
        monkeypatch.setenv(f"RVO3D_BENCH_{name}", value)
    assert cli.main(["bench", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == BENCH_KEYS | {"device"}
    assert line["metric"] == "env_steps_per_sec" and line["device"] == "cpu"
    assert line["repeats"] == 2 and line["vs_baseline"] > 0
    assert 0 < line["min"] <= line["median"] <= line["max"] == line["value"]


def test_detail_sections_run_on_the_cpu(monkeypatch):
    wd = flagship_world()
    sweep = detail.env_sweep(wd, lanes=(2, 3), steps=2, repeats=1, device="cpu")
    assert set(sweep) == {"2", "3"} and all(r > 0 for r in sweep.values())
    assert detail.policy_rollout(wd, num_envs=2, steps=3, repeats=1, device="cpu") > 0
    # the epoch's update runs 8 agents x (50 pi + 50 v) iterations of the
    # biGRU-256: a narrow policy and 2 + 2 iterations keep it to seconds here
    monkeypatch.setattr(detail, "ModelConfig", lambda: ModelConfig(**SMALL))
    monkeypatch.setattr(detail, "TrainConfig",
                        lambda **kw: TrainConfig(train_pi_iters=2, train_v_iters=2, **kw))
    epoch = detail.ppo_epoch(wd, steps_per_epoch=4, num_envs=2, device="cpu")
    assert epoch["ppo_epoch_seconds"] > 0 and epoch["ppo_env_steps_per_sec"] > 0
    assert len(epoch["pi_iters"]) == wd["drone_num"]
    assert all(0 <= i <= 2 for i in epoch["pi_iters"])


def test_serving_bench_runs_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(core, "OUT_DIR", str(tmp_path))
    assert serving.main(["--device", "cpu", "1", "4"]) == 0
    with open(tmp_path / "serving_bench.json") as f:
        res = json.load(f)
    assert res["device"] == "cpu" and set(res["batches"]) == {"1", "4"}
    for b, row in res["batches"].items():
        assert row["calls"] == 50
        assert row["latency_ms_plain"] > 0 and row["p50_ms_plain"] > 0
        assert row["actions_per_sec_plain"] == pytest.approx(
            int(b) / row["latency_ms_plain"] * 1e3)


def test_gru_bench_refuses_the_cpu():
    with pytest.raises(ValueError, match="no CPU"):
        gru.main(["--device", "cpu", "1"])
