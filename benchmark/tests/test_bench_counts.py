"""The yardstick's arithmetic on hand-worked cases: the kernel's bound, the
model FLOPs, the statistics and shares, the trace's busy union and gaps,
the window's rates, the observation layout, GAE and Adam."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import stats
from benchmark.harness.record import Run
from benchmark.harness.trace import TraceSummary, merge, summarize
from benchmark.harness.main import load_module
from benchmark.reference import counts, envcheck, learner


def test_gru_bound_hand_worked():
    # S = 3 slots, B = 2 rows: row 0 runs slots 0 and 1, row 1 slot 2
    mask = torch.tensor([[1, 0], [1, 0], [0, 1]], dtype=torch.bool)
    got = counts.gru_bound(mask, in_dim=9, hidden=256)
    # 3 active slots, 2 rows with one: the hidden product only at row 0's second slot
    assert got["flops"] == 2 * 2 * (3 * 9 + 1 * 256) * 768
    weights = 9 * 768 + 256 * 768 + 2 * 768
    assert got["bytes"] == 4 * (3 * 2 * 9 + 3 * 2 + 2 * weights + 2 * 2 * 256)
    assert got["bound_by"] == "bytes"
    assert got["bound_s"] == pytest.approx(got["bytes"] / 3.35e12)


def test_policy_flops_hand_worked():
    model = {"rnn_hidden_dim": 4, "rnn_input_dim": 2, "state_dim": 3,
             "hidden_sizes_ac": [5], "hidden_sizes_v": [6]}
    mask = torch.tensor([[1, 1], [1, 0]], dtype=torch.bool)     # 3 active, 2 rows
    enc = 2 * 2 * (3 * 2 + 1 * 4) * 12
    actor = 2 * 2 * (7 * 5 + 5 * 3)
    critic = 2 * 2 * (7 * 6 + 6 * 1)
    assert counts.policy_flops(mask, model, "actor") == enc + actor
    assert counts.policy_flops(mask, model, "both") == enc + actor + critic
    assert counts.policy_flops(mask, model, "critic", backward=True) == 3 * (enc + critic)
    assert counts.head_flops(2, model, "critic", backward=True) == 3 * critic


def test_nearest_rank_and_share():
    v = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert stats.nearest_rank(v, 0.5) == 3.0
    assert stats.nearest_rank(v, 0.95) == 5.0
    assert stats.nearest_rank(list(range(1, 101)), 0.95) == 95
    assert stats.nearest_rank([], 0.95) is None
    assert stats.share(1.0, 4.0) == 25.0
    assert stats.share(0.0, 4.0) is None and stats.share(1.0, 0.0) is None


class Ev:
    def __init__(self, name, start, dur, kind):
        self._n, self._s, self._d, self._k = name, start, dur, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def activity_type(self):
        return self._k

    def device_type(self):
        return "DeviceType.CPU" if self._k in ("user_annotation", "cpu_op") else \
            "DeviceType.CUDA"

    def is_user_annotation(self):
        return "annotation" in self._k


def test_merge_and_summarize():
    assert merge([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    events = [Ev("k1", 0, 30, "kernel"), Ev("k1", 20, 30, "kernel"),   # busy 0-50
              Ev("copy", 70, 10, "gpu_memcpy"),                         # busy 70-80
              Ev("span.a", 45, 30, "user_annotation"),                  # covers 50-70
              Ev("span.a", 45, 30, "gpu_user_annotation"),              # not an op
              Ev("span.b", 80, 40, "user_annotation"),                  # covers 80-100
              Ev("k2", 90, 20, "kernel")]                               # clipped to 90-100
    t = summarize(events, 100e-9, {"span.a", "span.b"}, 0, 100)
    assert t.busy_s == pytest.approx(70e-9)
    assert t.idle_share == pytest.approx(0.3)
    assert t.ops == pytest.approx({"k1": 60e-9, "copy": 10e-9, "k2": 10e-9})
    assert t.gaps == [("span.a", pytest.approx(20e-9)), ("span.b", pytest.approx(10e-9))]
    assert t.op_seconds("k") == pytest.approx(70e-9)


def fake_run(window, trace=None, **kw):
    r = Run(cell="c", seed=1, seconds=1.0, trace=trace is not None, config={},
            workload={}, root="", out_dir="")
    r.window.update(window)
    r.trace_summary = trace
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_window_rates_and_tails():
    rate = load_module("metrics", "train_env_steps_per_s")
    run = fake_run({"start": 10.0, "epoch_ends": [12.0, 14.5, 16.0],
                    "env_steps_per_epoch": 38400})
    assert rate.read(run) == pytest.approx(3 * 38400 / 6.0)
    assert rate.read(fake_run({})) is None
    sim = load_module("metrics", "sim_env_steps_per_s")
    assert sim.read(fake_run({"start": 1.0, "end": 3.0, "env_steps": 1000})) == 500.0
    p95 = load_module("metrics", "act_p95_ms")
    lat = [i * 1e-4 for i in range(1, 201)]                  # 0.1 .. 20 ms
    assert p95.read(fake_run({"latency_s": lat})) == pytest.approx(19.0)
    p50 = load_module("metrics", "act_p50_ms.serve")
    assert p50.read(fake_run({"latency_s": lat})) == pytest.approx(10.0)


def test_trace_shares():
    t = TraceSummary(window_s=2.0, busy_s=1.5, ops={"masked_gru_cluster_kernel": 0.3,
                                                    "gemm": 1.2})
    assert load_module("metrics", "idle_share.sim").read(
        fake_run({"traced_env_steps": 1000}, t)) == pytest.approx(25.0)
    assert load_module("metrics", "gru_busy_share.sim").read(
        fake_run({"traced_env_steps": 1000}, t)) == pytest.approx(20.0)
    assert load_module("metrics", "busy_ms_per_step.sim").read(
        fake_run({"traced_env_steps": 1000}, t)) == pytest.approx(1.5)
    roof = load_module("metrics", "gru_roofline.train")
    assert roof.read(fake_run({"traced_gru_bound_s": 0.03}, t)) == pytest.approx(10.0)
    assert roof.read(fake_run({"traced_gru_bound_s": 0.03},
                              TraceSummary(1.0, 1.0, {"gemm": 1.0}))) is None
    mfu = load_module("metrics", "mfu.train")
    assert mfu.read(fake_run({"traced_flops": 67e12, "traced_epoch_s": 2.0})) == \
        pytest.approx(50.0)


def test_policy_obs_layout_and_mismatch():
    obs = [np.r_[np.arange(12.0), np.ones(9), 2 * np.ones(9)], np.r_[np.arange(12.0),
                                                                  np.zeros(9)]]
    s, n, m = envcheck.policy_obs(obs, 4)
    assert m.tolist() == [[False, False, True, True], [False, False, False, False]]
    assert n[0, 2].tolist() == [1.0] * 9 and n[0, 3].tolist() == [2.0] * 9
    prog = (s.copy(), n.copy(), m.copy())
    prog[0][0, 0] += 0.01          # one rounding step: a flip
    prog[1][0, 3, 1] += 0.5        # beyond
    prog[2][1, 0] = True           # a mask entry: beyond
    assert envcheck.obs_mismatch((s, n, m), prog) == (2, 1)


def test_obs_check_explains_listed_neighbours():
    """Two drones of world32_mix flying head on: the oracle's own
    observation after an action that keeps drone 1 in drone 0's cone
    passes; a listed neighbour's feature moved, a drone listed twice, an
    expected time out of range, or the slots out of order do not."""
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = json.load(open(os.path.join(root, "benchmark", "configs", "w32_m3s.json")))
    env = env["program"]["env"]
    world = envcheck.load_world(os.path.join(root, "benchmark", "configs", "worlds",
                                             "world32_mix"))
    o = envcheck.make_oracle(world, env)
    o.reset()
    o.drones[0].state, o.drones[0].vel = np.array([12.0, 3.0, 6.0]), np.array([0.8, 0, 0])
    o.drones[1].state, o.drones[1].vel = np.array([13.5, 3.0, 6.0]), np.array([-0.8, 0, 0])
    states = o.total_states()
    act = np.zeros((world.drone_num, 3))
    act[0] = [0.5, 0.0, 0.0]
    obs = [o._observation_reward(d, [s for j, s in enumerate(states) if j != i], act[i])[0]
           for i, d in enumerate(o.drones)]
    prog = envcheck.policy_obs(obs, env["neighbor_num"])
    assert prog[2][0].sum() == 1
    beyond, _, slots = envcheck.obs_state_mismatch(o, prog, env["ctime_threshold"])
    assert beyond == 0 and slots >= 1

    def changed(fn):
        p = [x.copy() for x in prog]
        fn(*p)
        return envcheck.obs_state_mismatch(o, p, env["ctime_threshold"])[0]

    def twice(s, n, m):
        n[0, -2], m[0, -2] = n[0, -1], True

    def moved(s, n, m):
        n[0, -1, 3] += 0.5

    def late(s, n, m):
        n[0, -1, 8] = 0.3

    def own(s, n, m):
        s[0, 3] += 0.5
    assert all(changed(f) > 0 for f in (twice, moved, late, own))


def test_tie_search_moves_the_action():
    """A step decided by the sign of a dot product that is 0 in decimals
    (1e-9 here, float32's and float64's disagreeing sign) agrees with the
    program's opposite sign once the action moves by ACT_DELTA."""
    class Snap:
        drones = []

    def advance(snap, jitter):
        return 1e-9 + (0.0 if jitter is None else float(jitter[0, 0]))
    assert advance(Snap(), None) > 0
    found = envcheck.tie_search(Snap(), advance, lambda dot: dot < 0,
                                np.random.default_rng(0), 3e-5, 16, n_act=2)
    assert found is not None and found[1] < 0
    assert envcheck.tie_search(Snap(), advance, lambda dot: dot < 0,
                               np.random.default_rng(0), 3e-5, 16) is None


def test_gae_hand_worked():
    rew = torch.tensor([[[1.0]], [[2.0]], [[3.0]]])          # [T=3, E=1, N=1]
    val = torch.tensor([[[0.5]], [[1.0]], [[1.5]]])
    cut = torch.tensor([[False], [True], [False]])
    g, lam = 0.9, 0.5
    adv, ret = learner.gae(rew, val, cut, g, lam)
    d2 = 3.0 - 1.5
    d1 = 2.0 - 1.0                       # cut after step 1: no bootstrap
    d0 = 1.0 + g * 1.0 - 0.5
    assert adv.flatten().tolist() == pytest.approx([d0 + g * lam * d1, d1, d2])
    assert ret.flatten().tolist() == pytest.approx([1.0 + g * 2.0, 2.0, 3.0])


def test_adam_is_torch_adam():
    torch.manual_seed(0)
    p = {"w": torch.randn(5)}
    ref_p = torch.nn.Parameter(p["w"].clone())
    opt = learner.Adam(p, ["w"], lr=0.01)
    topt = torch.optim.Adam([ref_p], lr=0.01)
    for _ in range(4):
        g = torch.randn(5)
        opt.step({"w": g}, torch.ones((), dtype=torch.bool))
        ref_p.grad = g.clone()
        topt.step()
    assert torch.allclose(p["w"], ref_p.detach(), atol=1e-7)
    held = p["w"].clone()
    opt.step({"w": torch.randn(5)}, torch.zeros((), dtype=torch.bool))
    assert torch.equal(p["w"], held) and float(opt.count) == 4.0


def test_lifecycle_breaks():
    from benchmark.checks import lifecycle_breaks

    ended = np.array([[False], [True], [False], [False]])
    ep_len = np.array([[4], [5], [1], [2]])
    assert lifecycle_breaks(ended, ep_len, np.array([3]), 150) == 0
    assert lifecycle_breaks(ended, np.array([[4], [4], [4], [4]]), np.array([3]), 150) == 3
    assert lifecycle_breaks(np.array([[False]]), np.array([[5]]), np.array([4]), 5) == 1
