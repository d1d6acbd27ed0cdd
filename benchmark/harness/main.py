"""One run of one cell: `python3 benchmark/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>` from the checkout's root.

Everything a cell is made of is found by name (benchmark/README.md):
  BENCHMARK.json               the cell's configuration and traffic names,
                               its metrics, their units
  benchmark/workloads/<cell>.json   the driver kind, the traffic's
                               parameters and the limits of the check
  benchmark/configs/<config>.json   the configuration as it is run
  benchmark/drivers/<kind>.py  setup(run) -> state, window(state, run),
                               release(state), check(state, run)
  benchmark/metrics/<name>.py  read(run) -> a number, or None where the run
                               holds nothing to read

The run: look for the card (none, or fewer than the cell asks for: exit 2,
no result); set-up (the driver's: building, loading, warming up every shape
the cell uses); the window of --seconds; the peak memory read; the
program's state freed; the check against the plain reference; a look for
JAX in sys.modules; the metrics; the result as the last line of stdout,
the numbers compared with their limits as the last lines of stderr.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from benchmark.harness.record import Run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = ("jax", "jaxlib", "flax", "rvo3d_tpu")


def process_start_time() -> float:
    """This process's start, seconds since the epoch (Linux /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: str = ROOT):
    """<root>/benchmark/<kind>/<name>.py as a module of its own."""
    path = os.path.join(root, "benchmark", kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {cell!r}")


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's per-layer metrics (trace 1): those whose `workloads`
    names it, a key every per-layer entry has; or its end-to-end ones
    (trace 0): those whose `workloads` names it, or that have no such key
    (setup_s)."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose whole top-level name is a JAX one or the JAX
    package's (rvo3d_tpu_torch's top-level name is not rvo3d_tpu)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def device_info() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    info = {"platform": "gpu", "kind": name, "count": 1}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(smi.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def breakdown(run: Run) -> Optional[dict]:
    t = run.trace_summary
    if t is None:
        return None
    return {"device_ops": [[n, s] for n, s in t.top_ops(10)],
            "idle_gaps": [[n, s] for n, s in t.gaps[:10]]}


def result_line(run: Run, metrics: List[dict], checks: List[dict], device: dict,
                correct: bool) -> dict:
    values: Dict[str, dict] = {}
    for m in metrics:
        v = load_module("metrics", m["name"], run.root).read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": int(run.counters.get("attempted", 0)),
           "failed": int(run.counters.get("failed", 0)), "metrics": values,
           "device": device}
    if run.trace:
        out["device"] = {**device, "busy_s": run.trace_summary.busy_s,
                         "window_s": run.trace_summary.window_s}
        out["breakdown"] = breakdown(run)
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def make_run(args, root: str = ROOT) -> tuple:
    bench = load_json(root, "BENCHMARK.json")
    entry = cell_entry(bench, args.workload)
    wl = load_json(root, "benchmark", "workloads", args.workload + ".json")
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{args.workload}.json names {wl['config']}/"
                         f"{wl['traffic']}, BENCHMARK.json {entry['config']}/"
                         f"{entry['traffic']}")
    cfg = load_json(root, "benchmark", "configs", entry["config"] + ".json")
    out_dir = os.path.join(root, "bench_out", args.workload,
                           f"seed{args.seed}_trace{args.trace}")
    run = Run(cell=args.workload, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), config=cfg, workload=wl, root=root,
              out_dir=out_dir)
    return bench, entry, run


def check_limits(checks: List[dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = t_start if t_start is not None else process_start_time()
    args = parse(argv)
    bench, entry, run = make_run(args)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"the cell needs {entry['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    driver = load_module("drivers", run.workload["driver"], run.root)
    metrics = metrics_of(bench, run.cell, run.trace)
    device = device_info()
    return drive(run, driver, metrics, device, t_start)


def drive(run: Run, driver, metrics: List[dict], device: dict, t_start: float) -> int:
    """Set-up, window, check, result: the run after the look for a chip."""
    import torch

    with run.span("setup"):
        state = driver.setup(run)
    run.setup_s = time.time() - t_start
    with run.span("window"):
        driver.window(state, run)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        device = {**device, "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    else:
        device = {**device, "memory_peak_bytes": 0}
    driver.release(state)
    with run.span("check"):
        checks = driver.check(state, run)
    found = forbidden_modules(sys.modules)
    run.write_spans()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    correct = check_limits(checks)
    line = result_line(run, metrics, checks, device, correct)
    print("readings " + json.dumps(run.window.get("readings", {})), file=sys.stderr)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
