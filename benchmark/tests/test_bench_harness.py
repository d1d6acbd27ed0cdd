"""The harness on the CPU: cells found from files alone, the result line,
the look for JAX, small runs of every cell through the rest of a run
(correct), the same with each fault planted (not correct), and, on a card,
the control failing every cell's check."""

from __future__ import annotations

import ast
import io
import json
import os
import shutil
from contextlib import redirect_stdout

import pytest

from conftest import CARD, ROOT, SMALL, small_run
from benchmark import calibrate
from benchmark.harness import main as hm

BENCH = os.path.join(ROOT, "benchmark")
CPU_DEVICE = {"platform": "cpu", "kind": "test", "count": 1}


def drive(run, driver, metrics=()):
    """hm.drive after the look for a card: (exit code, the last stdout line)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = hm.drive(run, driver, list(metrics), dict(CPU_DEVICE), t_start=0.0)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


TOY_DRIVER = '''
import time


def setup(run):
    return {"units": 0}


def window(st, run):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        st["units"] += 1
    run.window.update(start=t0, end=time.perf_counter(), units=st["units"])
    run.count("attempted", st["units"])


def release(st):
    pass


def check(st, run):
    return [{"name": "toy_gap", "value": 0.0, "limit": run.workload["limits"]["toy_gap"]}]
'''

TOY_METRIC = '''
def read(run):
    w = run.window
    return w["units"] / (w["end"] - w["start"]) if "units" in w else None
'''


@pytest.fixture
def toy_root(tmp_path):
    """A checkout whose benchmark gained a configuration, a workload, a
    driver kind and a metric by new files alone (and BENCHMARK.json
    entries)."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "benchmark"
    (b / "configs" / "toy.json").write_text(json.dumps({"name": "toy"}))
    (b / "workloads" / "toy.spin.json").write_text(json.dumps(
        {"config": "toy", "traffic": "spin", "driver": "toy", "params": {},
         "limits": {"toy_gap": 0.0}}))
    (b / "drivers" / "toy.py").write_text(TOY_DRIVER)
    (b / "metrics" / "toy_rate.py").write_text(TOY_METRIC)
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    bench["configs"].append({"name": "toy", "source": "https://example.org/toy",
                             "file": "benchmark/configs/toy.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "toy.spin", "config": "toy", "traffic": "spin",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "toy_rate", "unit": "units/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["toy.spin"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for name in os.listdir(BENCH):
        assert not name.startswith("toy")
    return str(tmp_path)


def toy_run(root):
    args = hm.parse(["--workload", "toy.spin", "--seed", "1", "--seconds", "0.02"])
    bench, entry, run = hm.make_run(args, root)
    run.device = "cpu"
    return bench, run, hm.load_module("drivers", "toy", root)


def test_added_files_make_a_cell(toy_root):
    bench, run, driver = toy_run(toy_root)
    metrics = hm.metrics_of(bench, "toy.spin", trace=False)
    assert [m["name"] for m in metrics] == ["setup_s", "toy_rate"]
    rc, line = drive(run, driver, metrics)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["toy_rate"]["value"] > 0
    assert line["metrics"]["toy_rate"]["unit"] == "units/s"


def test_last_line_shape(toy_root):
    bench, run, driver = toy_run(toy_root)
    rc, line = drive(run, driver, hm.metrics_of(bench, "toy.spin", trace=False))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["checks"] == {"toy_gap": {"value": 0.0, "limit": 0.0}}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["memory_peak_bytes"] >= 0
    assert os.path.exists(os.path.join(run.out_dir, "spans.jsonl"))


def test_metrics_follow_benchmark_json():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for cell in SMALL:
        e2e = {m["name"] for m in hm.metrics_of(bench, cell, trace=False)}
        layer = hm.metrics_of(bench, cell, trace=True)
        assert "setup_s" in e2e and len(e2e) == 2 and layer
        assert {m["moves"] for m in layer} <= e2e
        for m in hm.metrics_of(bench, cell, True) + hm.metrics_of(bench, cell, False):
            assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))


def test_forbidden_modules_by_whole_top_level_name():
    found = hm.forbidden_modules(["rvo3d_tpu_torch", "rvo3d_tpu_torch.algo", "jaxtyping",
                                  "numpy", "flax.linen", "rvo3d_tpu.env", "jax"])
    assert found == ["flax", "jax", "rvo3d_tpu"]


def imports_of(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_jax_and_a_plain_reference():
    seen = 0
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in imports_of(path)}
            assert not tops & {"jax", "jaxlib", "flax", "rvo3d_tpu"}, path
            if os.path.basename(dirpath) == "reference":
                assert "rvo3d_tpu_torch" not in tops, path
                seen += 1
    assert seen >= 5


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_small_cell_is_correct_on_cpu(cell):
    run, driver = small_run(cell)
    rc, line = drive(run, driver)
    assert rc == 0
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1


FAULT_CASES = [(cell, f) for cell in sorted(SMALL)
               for f in calibrate.FAULTS[json.load(open(os.path.join(
                   BENCH, "workloads", cell + ".json")))["driver"]]]


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_planted_fault_is_not_correct(cell, fault):
    run, driver = small_run(cell)
    with calibrate.planted(run.workload["driver"], fault):
        rc, line = drive(run, driver)
    assert rc == 0
    assert line["correct"] is False, line["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct_on_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32, the control's precision, exists only there")
    run, driver = small_run(cell, seconds=2.0, sizes=CARD)
    run.device = "cuda"
    lines = calibrate.readings(run, driver)
    control = lines[-1]
    assert control["side"] == "control"
    assert any(control[k] > v for k, v in run.workload["limits"].items()), control
