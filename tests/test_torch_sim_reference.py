"""The `flagship8` configuration's plain reference and the port's records
for the `sim` cell, on the CPU:

  - the frozen world file (benchmark/configs/worlds/flagship8) is
    bench/flagship.flagship_world();
  - the reference's controller (benchmark/reference/controller.py) gives
    utils/heuristic.waypoint_controller's bits on seeded random states;
  - the port's eager run_chunk in float64 on 4 staggered flagship lanes
    flies 60 steps as the reference flies them (the controller copy on the
    frozen oracle, bench_step's lifecycle): positions and velocities at
    1e-9, waypoint indices, flags and each step's resets exactly;
  - the VO kernel's launch counters (ops/vo_pairs.py) stay empty with the
    recorder off, and with it on count eager launches and, through a
    StepGraph (stubbed as tests/test_torch_graphs.py stubs it), the
    captured launches once a replay (profiler.capturing); the capture's
    own launches count nothing;
  - benchmark/reference/vo_counts.py's bound equals chip_smoke.py's
    vo_bound for the same launches.
The counters and the bench loop's stamps on a card: tests/test_torch_cuda.py.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference import controller as ref_ctrl
from benchmark.reference import envcheck
from benchmark.reference import vo_counts
from rvo3d_tpu_torch.bench import core
from rvo3d_tpu_torch.bench.flagship import flagship_world
from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env.env import reset
from rvo3d_tpu_torch.env.state import DroneState
from rvo3d_tpu_torch.ops import vo_pairs as vp
from rvo3d_tpu_torch.utils import graphs, profiler
from rvo3d_tpu_torch.utils.heuristic import waypoint_controller

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_DIR = os.path.join(REPO, "benchmark", "configs", "worlds", "flagship8")


def test_frozen_world_file_is_the_flagship_world():
    with open(os.path.join(WORLD_DIR, "data_1.json")) as f:
        assert json.load(f) == flagship_world()
    with open(os.path.join(REPO, "benchmark", "configs", "flagship8.json")) as f:
        cfg = json.load(f)
    assert cfg["program"]["env"] == {
        k: getattr(EnvParams(num_drones=8), k) for k in cfg["program"]["env"]}
    assert set(cfg["program"]["env"]) == set(EnvParams.__dataclass_fields__)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_controller_copy_gives_the_port_controllers_bits(dtype):
    world = core.world_spec(flagship_world(), "cpu", dtype)
    g = torch.Generator().manual_seed(11)
    lead = (64, 8)
    state = reset(world, EnvParams(num_drones=8), lead=(64,))
    state = state._replace(
        pos=(torch.rand(lead + (3,), generator=g, dtype=torch.float64) * 12).to(dtype),
        vel=(torch.randn(lead + (3,), generator=g, dtype=torch.float64) * 0.6).to(dtype),
        yaw=(torch.rand(lead, generator=g, dtype=torch.float64) * 360).to(dtype),
        pitch=(torch.rand(lead, generator=g, dtype=torch.float64) * 180 - 90).to(dtype),
        wp_idx=torch.randint(0, 3, lead, generator=g, dtype=torch.int32))
    want = waypoint_controller(state, world)
    got = ref_ctrl.waypoint_controller(state.pos, state.vel, state.yaw, state.pitch,
                                       state.current_des(world))
    assert got.dtype == dtype and torch.equal(got, want)


def test_run_chunk_f64_flies_as_the_reference():
    phases, steps = (0, 5, 17, 42), 60
    wd = flagship_world()
    world = core.world_spec(wd, "cpu", torch.float64)
    p = EnvParams(num_drones=8)
    env = {**{k: getattr(p, k) for k in EnvParams.__dataclass_fields__}, "safe_rewards": True}
    oracles = [envcheck.make_oracle(envcheck.load_world(WORLD_DIR), env) for _ in phases]
    for o, phase in zip(oracles, phases):
        o.reset()
        ref_ctrl.fly(o, phase)
    pick = torch.tensor(phases)
    state = reset(world, p, lead=(len(phases),))
    kept = state
    for t in range(max(phases) + 1):
        m = pick == t
        kept = DroneState(*[torch.where(m.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
                            for a, b in zip(state, kept)])
        state = core.run_chunk(world, state, p, 1)
    resets = 0
    for t in range(steps):
        kept = core.run_chunk(world, kept, p, 1)
        for lane, o in enumerate(oracles):
            res = ref_ctrl.step(o)
            ds = o.drones
            msg = f"lane {lane}, step {t}"
            np.testing.assert_allclose(kept.pos[lane].numpy(), [d.state for d in ds],
                                       rtol=0, atol=1e-9, err_msg=msg)
            np.testing.assert_allclose(kept.vel[lane].numpy(), [d.vel for d in ds],
                                       rtol=0, atol=1e-9, err_msg=msg)
            assert kept.wp_idx[lane].tolist() == [d.i for d in ds], msg
            assert kept.arrive_flag[lane].tolist() == [d.arrive_flag for d in ds], msg
            assert kept.dest_arrive_flag[lane].tolist() == [d.dest_arrive_flag for d in ds]
            # a drone reset this step has flown nothing since
            assert (kept.real_route_len[lane] == 0).tolist() == res["reset"].tolist(), msg
            resets += int(res["reset"].sum())
    assert resets > 0


# ---- the VO kernel's launch counters ----

def _params(rows, n, m, nm=0, b=0, others=False):
    q = vp._Params()
    q.rows, q.N, q.M, q.nm, q.B, q.b_lanes = rows, n, m, nm, b, 1
    q.o_row = 8 if others else 12
    q.o_lane = m * q.o_row
    return q


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture
def stub_graphs(monkeypatch):
    """StepGraph's stream, capture and graph replaced by stubs (no card)."""
    class Graph:
        def replay(self):
            pass

    def capture(fn, stream, pool=None):
        fn()
        return Graph()
    monkeypatch.setattr(graphs, "_side_stream", lambda dev: None)
    monkeypatch.setattr(graphs, "_on_stream", lambda stream, fn: fn())
    monkeypatch.setattr(graphs, "_capture", capture)


def _body():
    """A step that launches the kernel in both modes, as the env step does."""
    vp._note(_params(64, 8, 8), False)
    vp._note(_params(64, 8, 8, nm=10, b=1), True)


def test_vo_counters_stay_empty_with_the_recorder_off(stub_graphs):
    profiler.clear()
    g = graphs.StepGraph(_body, "cuda")
    for _ in range(4):                  # warm-up, capture + replay, 2 replays
        g.step()
    assert not profiler.counting() and len(g.counts) == 2 * 6   # 6 counters a launch
    assert profiler.recorded().counters == {}


def test_vo_counters_count_eager_and_replayed_launches(stub_graphs):
    profiler.clear()
    with _profiled():
        g = graphs.StepGraph(_body, "cuda")
        for _ in range(4):              # eager warm-up, then 3 replays
            g.step()
        _body()                         # an eager step outside the graph
    c = profiler.recorded().counters
    profiler.clear()
    launches = 1 + 3 + 1
    assert c["vo_pairs.reward.launches"] == c["vo_pairs.observe.launches"] == launches
    assert c["vo_pairs.reward.rows"] == c["vo_pairs.observe.rows"] == 64 * launches
    assert c["vo_pairs.reward.pairs"] == 64 * 8 * launches
    assert c["vo_pairs.observe.slots"] == 64 * 10 * launches
    assert c["vo_pairs.observe.buildings"] == launches
    assert c["vo_pairs.reward.slots"] == c["vo_pairs.reward.others"] == 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("others", [False, True], ids=["drones", "spheres"])
def test_vo_counts_bound_is_chip_smokes(others):
    cs = _chip_smoke()
    e, n, m, nm, b = 16, 8, 11 if others else 8, 10, 3
    states, actions = torch.zeros(e, n, 12), torch.zeros(e, n, 3)
    oth = torch.zeros(e, m, 8) if others else None
    bld, mask = torch.zeros(b, 4), torch.zeros(b, dtype=torch.bool)
    profiler.clear()
    with _profiled():
        vp._note(_params(e * n, n, m, others=others), False)
        vp._note(_params(e * n, n, m, nm=nm, b=b, others=others), True)
    c = profiler.recorded().counters
    profiler.clear()
    for mode, want in (("reward", cs.vo_bound(states, actions, oth)),
                       ("observe", cs.vo_bound(states, actions, oth, nm, bld, mask))):
        got = vo_counts.vo_bound(vo_counts.mode_counts(c, mode), mode, 4)
        assert (got["flops"], got["bytes"]) == (want["flops"], want["bytes"])
        assert got["bound_s"] * 1e3 == pytest.approx(want["bound_ms"], rel=1e-12)
    assert vo_counts.bound_seconds({}, 4) is None
