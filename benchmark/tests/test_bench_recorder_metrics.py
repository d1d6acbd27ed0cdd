"""The readers of the port's recorder (rvo3d_tpu_torch/utils/profiler.py) on
synthetic runs: each of the twelve metrics reads what it should from a
made-up recording (device stamps, kept masks, counters, spans, replay
device times), and reads None where the recorder holds nothing or the port
has no recorder, as before it had one."""

from __future__ import annotations

import pytest
import torch

from conftest import small_run
from benchmark.harness import main as hm
from benchmark.harness.trace import TraceSummary
from benchmark.reference import counts
from benchmark.reference.policy import encoder_mask
from rvo3d_tpu_torch.utils import profiler

MS = 1_000_000       # ns in a ms
STAMPS = torch.tensor([[0, 10, 30], [40, 55, 70], [100, 120, 150]]) * MS
NEW = {"w16_r4.train": ["rollout_gap_ms.train", "rollout_env_ms.train",
                        "pi_applied_share.train", "gc_ms.train"],
       "w32_m3s.eval": ["env_ms_per_step.sim", "policy_ms_per_step.sim",
                        "gru_roofline.sim", "mfu.sim"],
       "w16_r4.serve": ["act_copy_in_ms.serve", "act_replay_ms.serve",
                        "act_copy_out_ms.serve", "graph_captures.serve"]}
CELL_OF = {m: cell for cell, ms in NEW.items() for m in ms}
GRU_S = 2e-3         # the kernel's traced device seconds


def span(name, start_ms, end_ms, parent=None, **attrs):
    return profiler.Span(name, int(start_ms * MS), int(end_ms * MS), parent, attrs)


def masks():
    g = torch.Generator().manual_seed(0)
    return [torch.rand(4, 32, 10, generator=g) < 0.3 for _ in range(3)]


def recording(cell):
    if cell == "w16_r4.train":
        spans = [span("train.epoch", 0, 1000), span("gc.collect", 10, 12, 0, generation=0),
                 span("gc.collect", 500, 503, 0, generation=2),
                 span("gc.collect", 1001, 1010, None, generation=0)]
        return profiler.Recording(spans, {"ppo.pi_iters_applied": 30,
                                          "ppo.pi_iters_replayed": 40},
                                  {"rollout.stamps": [STAMPS]})
    if cell == "w32_m3s.eval":
        return profiler.Recording([], {}, {"eval.stamps": [STAMPS], "eval.obs_mask": masks()})
    spans = []
    for req, (inp, cin, out, dev) in enumerate([(1.0, 0.5, 0.2, 0.3), (2.0, 0.5, 0.4, 0.5)],
                                               start=1):
        top = len(spans)
        t = 10.0 * req
        spans += [span("serve.act", t, t + 5, None, batch=16, request=req),
                  span("serve.inputs", t, t + inp, top, request=req),
                  span("serve.lookup", t + inp, t + inp, top, request=req),
                  span("serve.copy_in", t + 2, t + 2 + cin, top, request=req),
                  span("serve.replay", t + 3, t + 3.1, top, request=req, device_ms=dev),
                  span("serve.copy_out", t + 3.5, t + 3.6, top, request=req),
                  span("serve.copy_out", t + 4, t + 4 + out, top, request=req)]
    spans.append(span("serve.capture", 40, 41, None, shape=[[16, 12]]))
    return profiler.Recording(spans, {}, {})


def run_of(cell):
    run, _ = small_run(cell)
    run.window.update({"w16_r4.train": {"epoch_ends": [1.0]},
                       "w32_m3s.eval": {"traced_env_steps": 12},
                       "w16_r4.serve": {"traced_masks": []}}[cell])
    run.trace_summary = TraceSummary(window_s=0.5, busy_s=0.4,
                                     ops={"masked_gru_cluster_kernel": GRU_S, "other": 0.1})
    return run


def expected(name):
    model = small_run("w32_m3s.eval")[0].config["program"]["model"]
    rows = [encoder_mask(m.reshape(-1, 10)).t() for m in masks()]
    bound = sum(counts.gru_bound(m, model["rnn_input_dim"],
                                 model["rnn_hidden_dim"])["bound_s"] for m in rows)
    flops = sum(counts.policy_flops(m, model, "both") for m in rows)
    return {"rollout_gap_ms.train": 10 + 30, "rollout_env_ms.train": 20 + 15 + 30,
            "pi_applied_share.train": 75.0, "gc_ms.train": 2 + 3,
            "env_ms_per_step.sim": 65 / 3, "policy_ms_per_step.sim": 45 / 3,
            "gru_roofline.sim": 100 * bound / GRU_S,
            "mfu.sim": 100 * flops / 0.5 / counts.F32_PEAK,
            "act_copy_in_ms.serve": 1.5, "act_replay_ms.serve": 0.3,
            "act_copy_out_ms.serve": 0.3, "graph_captures.serve": 1}[name]


ALL = sorted(CELL_OF)


@pytest.mark.parametrize("name", ALL)
def test_reader_on_a_synthetic_recording(name, monkeypatch):
    cell = CELL_OF[name]
    monkeypatch.setattr(profiler, "recorded", lambda: recording(cell))
    got = hm.load_module("metrics", name).read(run_of(cell))
    assert got == pytest.approx(expected(name), rel=1e-9)


@pytest.mark.parametrize("name", ALL)
def test_reader_is_none_without_records(name, monkeypatch):
    run = run_of(CELL_OF[name])
    reader = hm.load_module("metrics", name)
    profiler.clear()
    assert reader.read(run) is None              # the recorder holds nothing
    monkeypatch.delattr(profiler, "recorded")    # a port without a recorder
    assert reader.read(run) is None


def test_the_new_metrics_are_the_cells_per_layer_entries():
    import json
    import os

    from conftest import ROOT
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for cell, names in NEW.items():
        layer = {m["name"] for m in hm.metrics_of(bench, cell, trace=True)}
        assert set(names) <= layer
