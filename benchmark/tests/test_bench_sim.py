"""The `sim` driver and the `flagship8.sim` cell on the CPU: the cell at a
CPU's size reads correct through the harness; each fault
benchmark/calibrate_sim.py plants reads not correct, and so does the
control (the reference flown in float16 in the program's place); the three
readers of the cell, and the eval cell's two trace readers it shares,
read what they should from a made-up recording, and the three None
without one; and the new entries, with those two, are the cell's
per-layer metrics."""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import ROOT, small_run
from test_bench_harness import drive
from benchmark import calibrate_sim
from benchmark.harness import main as hm
from benchmark.harness.trace import TraceSummary
from benchmark.reference import vo_counts
from rvo3d_tpu_torch.utils import profiler

CELL = "flagship8.sim"
# the cell cut to a CPU's size: (program config overrides, params overrides)
SIZES = {CELL: ({}, {"lanes": 8, "chunk": 30, "stagger": 40, "warm_seconds": 0,
                     "check_calls": 3, "check_lanes": 2})}
METRICS = ["ctrl_ms_per_step.flag", "env_ms_per_step.flag", "vo_roofline.flag"]
# the eval cell's trace readers, which read any run that writes traced_env_steps
TRACE_METRICS = ["idle_share.sim", "busy_ms_per_step.sim"]
MS = 1_000_000       # ns in a ms
STAMPS = torch.tensor([[0, 1, 30], [40, 42, 70], [100, 103, 150]]) * MS
VO_S = 1e-3          # the VO kernel's traced device seconds
COUNTERS = {"vo_pairs.reward.launches": 3, "vo_pairs.reward.rows": 3 * 131072,
            "vo_pairs.reward.pairs": 3 * 131072 * 8, "vo_pairs.reward.slots": 0,
            "vo_pairs.reward.others": 0, "vo_pairs.reward.buildings": 0,
            "vo_pairs.observe.launches": 3, "vo_pairs.observe.rows": 3 * 131072,
            "vo_pairs.observe.pairs": 3 * 131072 * 8,
            "vo_pairs.observe.slots": 3 * 131072 * 10, "vo_pairs.observe.others": 0,
            "vo_pairs.observe.buildings": 3}


def sim_run(seconds=0.3):
    return small_run(CELL, seed=2**31 + 12345, seconds=seconds, sizes=SIZES)


def test_small_cell_is_correct_on_cpu():
    run, driver = sim_run(0.05)
    rc, line = drive(run, driver)
    assert rc == 0
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1
    assert run.window["readings"]["sim_checked"] >= 2
    assert run.window["readings"]["sim_resets"] > 0


@pytest.mark.parametrize("fault", calibrate_sim.FAULTS)
def test_planted_fault_is_not_correct(fault):
    run, driver = sim_run()
    with calibrate_sim.planted(fault):
        rc, line = drive(run, driver)
    assert rc == 0
    assert line["correct"] is False, line["checks"]


def test_control_is_not_correct():
    run, driver = sim_run()
    program, control = calibrate_sim.readings(run, driver)
    limits = run.workload["limits"]
    assert all(program[k] <= v for k, v in limits.items()), program
    assert control["side"] == "control"
    assert any(control[k] > v for k, v in limits.items()), control


def recording():
    return profiler.Recording([], dict(COUNTERS), {"bench.stamps": [STAMPS]})


def run_of():
    run, _ = sim_run()
    run.window["traced_env_steps"] = 3 * 8
    run.trace_summary = TraceSummary(window_s=0.5, busy_s=0.4,
                                     ops={"vo_pairs_kernel_float": VO_S, "other": 0.1})
    return run


def expected(name):
    bound = sum(vo_counts.vo_bound(vo_counts.mode_counts(COUNTERS, m), m, 4)["bound_s"]
                for m in vo_counts.MODES)
    return {"ctrl_ms_per_step.flag": 6 / 3, "env_ms_per_step.flag": (29 + 28 + 47) / 3,
            "vo_roofline.flag": 100 * bound / VO_S, "idle_share.sim": 100 * (1 - 0.4 / 0.5),
            "busy_ms_per_step.sim": 0.4e3 / (3 * 8)}[name]


@pytest.mark.parametrize("name", METRICS + TRACE_METRICS)
def test_reader_on_a_synthetic_recording(name, monkeypatch):
    monkeypatch.setattr(profiler, "recorded", recording)
    got = hm.load_module("metrics", name).read(run_of())
    assert got == pytest.approx(expected(name), rel=1e-9)
    if name == "vo_roofline.flag":
        assert 0 < got <= 100


@pytest.mark.parametrize("name", METRICS)
def test_reader_is_none_without_records(name, monkeypatch):
    run = run_of()
    reader = hm.load_module("metrics", name)
    profiler.clear()
    assert reader.read(run) is None              # the recorder holds nothing
    monkeypatch.delattr(profiler, "recorded")    # a port without a recorder
    assert reader.read(run) is None


def test_the_new_entries_are_the_cells_per_layer_metrics():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    layer = {m["name"] for m in hm.metrics_of(bench, CELL, trace=True)}
    assert layer == set(METRICS + TRACE_METRICS)
    e2e = {m["name"] for m in hm.metrics_of(bench, CELL, trace=False)}
    assert e2e == {"setup_s", "sim_env_steps_per_s"}
    assert {m["moves"] for m in hm.metrics_of(bench, CELL, trace=True)} <= e2e
    for m in METRICS + TRACE_METRICS:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m + ".py"))
