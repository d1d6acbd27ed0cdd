"""The port's tracing and profiling helpers (rvo3d_tpu_torch/utils/profiler.py)
on the CPU:

  - `trace` writes a Chrome trace holding the named regions and the ops
    under them, yields the profiler for key_averages(), and its trace.json
    names the program's own spans; `debug_nans` raises on the first
    non-finite module output and restores autograd's anomaly mode on exit;
  - the recorder is off with no profiler running: a tiny training epoch,
    served requests, an eval chunk and a garbage collection leave it empty
    and open no profiler range;
  - under a CPU torch.profiler.profile: a tiny Trainer epoch records the
    `train.*` and `update.*` spans under their parents, the graphed
    rollout's `rollout.*` spans (graphs.StepGraph replaced by an eager
    stand-in and graphs.on_card saying yes, as tests/test_torch_graphs.py
    does) and both KL-stop counters, the applied count equal to the
    epoch's `pi_iters`; PolicyServer.act records `serve.act` with its
    request id shared by its children, with and without the stand-in
    graphs, and one `serve.evict` past MAX_GRAPHS shapes; the CPU
    `eval_chunk` keeps one mask a step, each the one its step ran; a
    collection is a `gc.collect` span with its generation;
  - every in-memory span lies inside its profiler range in the
    profiler's own events, widened by 1 ms: the two share a clock.
The device stamps and the timed replays run only on a card
(tests/test_torch_cuda.py).
"""

import gc
import json

import numpy as np
import pytest
import torch

from rvo3d_tpu_torch import serving
from rvo3d_tpu_torch.algo.evaluator import eval_chunk, init_eval_carry
from rvo3d_tpu_torch.algo.trainer import Trainer
from rvo3d_tpu_torch.config import Config, EnvParams, ModelConfig, TrainConfig
from rvo3d_tpu_torch.env import DroneEnv
from rvo3d_tpu_torch.models import ActorCritic
from rvo3d_tpu_torch.serving import PolicyServer
from rvo3d_tpu_torch.utils import graphs, profiler
from rvo3d_tpu_torch.utils.profiler import debug_nans, trace
from rvo3d_tpu_torch.worlds import load_world

SMALL = ModelConfig(rnn_hidden_dim=16, hidden_sizes_ac=(16,), hidden_sizes_v=(16,))
TRAIN = TrainConfig(steps_per_epoch=6, num_envs=2, max_ep_len=5, train_pi_iters=3,
                    train_v_iters=2, minibatch=16, pi_lr=1e-3, vf_lr=1e-3,
                    action_mode="direct", batched_update=False, max_update_num=2)


class EagerSteps:
    """Stands in for graphs.StepGraph on the CPU: the body at every step."""

    def __init__(self, body, device, pool=None):
        self.body = body

    def step(self):
        with torch.no_grad():
            self.body()


@pytest.fixture
def graph_stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "StepGraph", EagerSteps)
    monkeypatch.setattr(graphs, "on_card", lambda device: True)


@pytest.fixture
def recorder():
    profiler.clear()
    yield profiler
    profiler.clear()


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def trainer():
    wd = load_world("gen_demo")
    cfg = Config(env=EnvParams(num_drones=wd.drone_num), model=SMALL, train=TRAIN)
    return Trainer(cfg, wd.spec(device="cpu"), device="cpu")


def rand_obs(b, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 12)).astype(np.float32),
            rng.normal(size=(b, 10, 9)).astype(np.float32), rng.random((b, 10)) > 0.5)


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_trace_writes_the_named_regions(tmp_path):
    wd = load_world("gen_demo")
    env = DroneEnv(wd.spec(device="cpu"), EnvParams(num_drones=wd.drone_num), num_envs=2)
    ac = ActorCritic(SMALL, device="cpu")
    state, out = env.reset()
    with trace(str(tmp_path)) as prof:
        for _ in range(2):
            with torch.profiler.record_function("policy"), torch.no_grad():
                act = ac(out.obs_self, out.obs_nbr, out.obs_mask)[0]
            with torch.profiler.record_function("env_step"):
                state, out = env.step(state, act)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("policy") == 2 and names.count("env_step") == 2
    ops = {e.key: e.count for e in prof.key_averages()}
    assert ops["policy"] == 2 and ops.get("aten::linear", 0) > 0


def test_debug_nans_raises_and_restores():
    ac = ActorCritic(SMALL, device="cpu")
    obs = (torch.zeros(3, 12), torch.zeros(3, 10, 9), torch.zeros(3, 10, dtype=torch.bool))
    with debug_nans():
        ac(*obs)                                    # finite: nothing raised
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        bad = (obs[0].clone().fill_(float("nan")),) + obs[1:]
        with pytest.raises(FloatingPointError, match="non-finite output of LayerNorm"):
            ac(*bad)
    assert not torch.is_anomaly_enabled()
    ac(obs[0].clone().fill_(float("nan")), *obs[1:])   # off again: no hook left
    with debug_nans(False):
        assert not torch.is_anomaly_enabled()


def test_off_the_recorder_holds_nothing_and_opens_no_range(recorder, graph_stand_in,
                                                          monkeypatch):
    def no_range(name):
        raise AssertionError(f"a profiler range {name!r} while off")
    monkeypatch.setattr(profiler, "profiler_range", no_range)
    assert not profiler.on()
    tr = trainer()
    tr.run_epoch()
    srv = PolicyServer(tr.ac)
    for b in (3, 5, 3):
        srv.act(*rand_obs(b))
    wd = load_world("gen_demo")
    world, p = wd.spec(device="cpu"), EnvParams(num_drones=wd.drone_num)
    eval_chunk(tr.ac, world, p, init_eval_carry(world, p, 2), torch.Generator(), 3)
    gc.collect()
    assert profiler.span("x", a=1).__enter__() is None
    profiler.count("x")
    profiler.keep("x", torch.zeros(2))
    rec = profiler.recorded()
    assert rec.spans == [] and rec.counters == {} and rec.kept == {}


def test_training_epoch_records_its_spans_and_the_kl_counters(recorder, graph_stand_in):
    tr = trainer()
    with profiled():
        m = tr.run_epoch()
    rec = profiler.recorded()
    spans = rec.spans
    (epoch,) = by_name(spans, "train.epoch")
    top = spans.index(epoch)
    assert epoch.parent is None
    phases = ["train.rollout", "train.gae", "train.update", "train.readback"]
    got = [s.name for s in spans if s.parent == top]
    assert got == phases
    idx = {name: spans.index(by_name(spans, name)[0]) for name in phases}
    agents = len(m["pi_iters"])
    assert agents == TRAIN.max_update_num
    assert [s.name for s in spans if s.parent == idx["train.update"]] == (
        ["update.plan"] + ["update.pi", "update.v"] * agents)
    steps = TRAIN.steps_per_epoch
    for name in ("rollout.draw", "rollout.copy_in", "rollout.replay"):
        assert [s.parent for s in by_name(spans, name)] == [idx["train.rollout"]] * steps
    assert [s.parent for s in by_name(spans, "rollout.copy_out")] == [idx["train.rollout"]]
    for s in spans:
        assert s.start <= s.end
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
    assert rec.counters["ppo.pi_iters_applied"] == sum(m["pi_iters"])
    assert rec.counters["ppo.pi_iters_replayed"] == TRAIN.train_pi_iters * agents
    assert rec.kept == {}          # no stamps on CPU tensors


@pytest.mark.parametrize("graphed", [False, True])
def test_served_requests_record_their_spans(recorder, monkeypatch, graphed):
    if graphed:
        monkeypatch.setattr(graphs, "StepGraph", EagerSteps)
        monkeypatch.setattr(graphs, "on_card", lambda device: True)
    srv = PolicyServer(ActorCritic(SMALL, device="cpu"))
    with profiled():
        for b in (4, 7):
            srv.act(*rand_obs(b))
    spans = profiler.recorded().spans
    acts = by_name(spans, "serve.act")
    assert [(s.attrs["batch"], s.attrs["request"]) for s in acts] == [(4, 1), (7, 2)]
    children = (["serve.inputs", "serve.lookup", "serve.draw", "serve.copy_in",
                 "serve.replay", "serve.copy_out", "serve.copy_out"] if graphed
                else ["serve.inputs", "serve.copy_out"])
    for s in acts:
        i = spans.index(s)
        kids = [c for c in spans if c.parent == i]
        assert [c.name for c in kids] == children
        for c in kids:
            assert c.attrs["request"] == s.attrs["request"]


def test_past_max_graphs_the_least_recent_shape_is_evicted(recorder, graph_stand_in,
                                                            monkeypatch):
    monkeypatch.setattr(serving, "MAX_GRAPHS", 2)
    srv = PolicyServer(ActorCritic(SMALL, device="cpu"))
    with profiled():
        for b in (2, 3, 2, 4):
            srv.act(*rand_obs(b))
    spans = profiler.recorded().spans
    (evict,) = by_name(spans, "serve.evict")
    assert evict.attrs["shape"][0] == (3, 12) and evict.attrs["request"] == 4
    assert spans[evict.parent].name == "serve.lookup"
    assert len(srv._graphs) == 2


def test_cpu_eval_chunk_keeps_one_mask_a_step(recorder):
    wd = load_world("world16_dense")
    world, p = wd.spec(device="cpu"), EnvParams(num_drones=wd.drone_num)
    ac = ActorCritic(SMALL, generator=torch.Generator().manual_seed(0), device="cpu")
    c0 = init_eval_carry(world, p, 3)
    kw = dict(max_ep_len=2, std_factor=1.0, action_mode="direct")
    with profiled():
        eval_chunk(ac, world, p, c0, torch.Generator().manual_seed(1), 4, **kw)
    kept = profiler.recorded().kept["eval.obs_mask"]
    assert len(kept) == 4
    c, g = c0, torch.Generator().manual_seed(1)
    for m in kept:                  # each the mask its step ran
        assert torch.equal(m, c.obs[2])
        c, _ = eval_chunk(ac, world, p, c, g, 1, **kw)


def test_a_collection_is_a_gc_span(recorder):
    with profiled():
        gc.collect()
    spans = by_name(profiler.recorded().spans, "gc.collect")
    assert spans and spans[-1].attrs["generation"] == 2


def test_spans_lie_inside_their_profiler_ranges(recorder, graph_stand_in):
    tr = trainer()
    srv = PolicyServer(tr.ac)
    with profiled() as prof:
        tr.run_epoch()
        for b in (3, 5):
            srv.act(*rand_obs(b))
    spans = profiler.recorded().spans
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).endswith("CPU"):
            ranges.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    names = {s.name for s in spans}
    assert {"train.rollout", "update.pi", "serve.act", "serve.replay"} <= names
    wide = 1_000_000                # 1 ms, in ns
    for name in names:
        mine = sorted((s.start, s.end) for s in spans if s.name == name)
        theirs = sorted(ranges.get(name, []))
        assert len(mine) == len(theirs), name
        for (s, e), (rs, re) in zip(mine, theirs):
            assert rs - wide <= s <= e <= re + wide, name


def test_trace_json_names_the_program_spans(tmp_path, recorder, graph_stand_in):
    srv = PolicyServer(ActorCritic(SMALL, device="cpu"))
    tr = trainer()
    with trace(str(tmp_path)):
        srv.act(*rand_obs(4))
        tr.run_epoch()
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    want = {"serve.act", "serve.inputs", "serve.replay", "train.epoch", "train.rollout",
            "train.update", "update.pi", "rollout.replay"}
    assert want <= names
    assert want <= {s.name for s in profiler.recorded().spans}
