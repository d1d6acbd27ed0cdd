"""Env-stepping throughput on the flagship world: the port's counterpart of
the JAX package's root bench.py, run by `python -m rvo3d_tpu_torch.cli
bench [--device D]`.

Metric: aggregate env-steps/s (one env-step = one step of one env lane
with all N drones), stepping the 8-drone flagship world (flagship.py) with
the analytic waypoint controller, so drones fly, interact, collide and
reset: the full step pipeline, all-pairs VO observation assembly and the
per-drone lifecycle included. Baseline: the same world stepped by the
NumPy oracle (env/oracle.py) on the host, one env in one process, as the
reference runs. On a card the timed loop replays one step captured as a
CUDA graph (make_chunk), as bench.py times one jitted scan.

The environment variables RVO3D_BENCH_ENVS (16384), RVO3D_BENCH_STEPS
(100) and RVO3D_BENCH_REPEATS (3) set the size, as for bench.py. The last
line printed is one JSON object with bench.py's keys (metric, value, unit,
vs_baseline, repeats, min, median, max) and `device`, the card's name.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, List, Optional, Tuple

import torch

from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.env.env import reset, reset_where, step
from rvo3d_tpu_torch.env.state import DroneState, WorldSpec, make_world_spec
from rvo3d_tpu_torch.utils import graphs
from rvo3d_tpu_torch.utils.device import resolve_device
from rvo3d_tpu_torch.utils.heuristic import waypoint_controller

STAMPS = 1024    # device stamps a graphed chunk call keeps, of its first steps
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "runs_torch", "bench")


def device_name(dev: torch.device) -> str:
    """What the results name as their device: the card, or 'cpu'."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def sync(dev: torch.device) -> None:
    """Wait for the card: eager launches return before the work is done."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def best_seconds(fn, dev: torch.device, repeats: int) -> float:
    """Best wall seconds of `repeats` calls of fn() after one warm-up call,
    each closed by a synchronization (the JAX scripts' time_fn)."""
    fn()
    sync(dev)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def write_results(results: dict, name: str) -> str:
    """results as indented JSON in OUT_DIR/name; returns the path."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, name)
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    return path


def world_spec(world_dict: dict, device, dtype=torch.float32) -> WorldSpec:
    return make_world_spec(world_dict["waypoints_list"], world_dict["building_list"],
                           world_dict["map_size"], dtype=dtype, device=device)


@torch.no_grad()
def bench_step(world: WorldSpec, state: DroneState, p: EnvParams,
               mark: Optional[Callable[[], None]] = None) -> DroneState:
    """One step of every lane: the analytic controller (bench.py:44-59,
    equal to waypoint_controller at cruise 0.8 and dt 1), `step` with its
    output as the absolute action unchanged (bench.py:62), then the
    trainer's lifecycle, a reset of collided or finished drones. `world`
    is one world or a lane world (worlds/multi.py). `mark`, when given, is
    called between the controller and the env step (the graphed chunk's
    device stamp)."""
    act = waypoint_controller(state, world)
    if mark is not None:
        mark()
    state, out = step(world, state, act, p)
    return reset_where(world, state, out.done | out.finish)


def run_chunk(world: WorldSpec, state: DroneState, p: EnvParams,
              steps: int) -> DroneState:
    """`steps` eager steps of bench_step: the loop on CPU tensors, and the
    plain version the card's graph is held against."""
    for _ in range(steps):
        state = bench_step(world, state, p)
    return state


def make_chunk(world: WorldSpec, p: EnvParams):
    """chunk(state, steps) -> state, the loop the benchmarks time: on a card
    bench_step captured once as a CUDA graph and replayed `steps` times a
    call (utils/graphs.GraphedLoop; the static state's shape is fixed by
    the first call), run_chunk on the CPU. The graphed step writes device
    stamps (step start, controller end, step end) for a call's first
    STAMPS steps, kept as `bench.stamps` while the recorder is on."""
    if graphs.on_card(world.device):
        loop = graphs.GraphedLoop(
            lambda s, x, t: (bench_step(world, s, p, loop.mark), None),
            world.device, name="bench", stamps=STAMPS)
        return lambda state, steps: loop(state, steps)[0]
    return lambda state, steps: run_chunk(world, state, p, steps)


def bench_env(world_dict: dict, num_envs: int, steps: int, repeats: int = 3,
              device="cuda") -> Tuple[float, List[float]]:
    """(best env-steps/s, every repeat's) of `num_envs` lanes reset alike:
    one warm-up chunk of `steps` steps (on a card it captures the step),
    then `repeats` timed chunks, each going on from the last one's state
    (bench.py:28-88)."""
    dev = resolve_device(device)
    world = world_spec(world_dict, dev)
    p = EnvParams(num_drones=world_dict["drone_num"])
    chunk = make_chunk(world, p)
    state = chunk(reset(world, p, lead=(num_envs,)), steps)      # warm-up
    sync(dev)
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        state = chunk(state, steps)
        sync(dev)
        rates.append(num_envs * steps / (time.perf_counter() - t0))
    return max(rates), rates


def bench_oracle(world_dict: dict, steps: int = 60) -> float:
    """Steps/s of the NumPy oracle on the host: one env, the oracle's own
    desired velocity as the action, a drone reset where it collided or
    finished (bench.py:91-110)."""
    from rvo3d_tpu_torch.env.oracle import OracleEnv
    from rvo3d_tpu_torch.worlds.loader import WorldData

    wd = WorldData(name="flagship", drone_num=world_dict["drone_num"],
                   map_size=world_dict["map_size"],
                   waypoints_list=world_dict["waypoints_list"],
                   n_points_list=world_dict["n_points_list"],
                   building_list=world_dict["building_list"])
    env = OracleEnv(wd)
    env.reset()
    t0 = time.perf_counter()
    for _ in range(steps):
        acts = [d.cal_des_vel() for d in env.drones]
        _, _, done, _, fin = env.step(acts)
        for i in range(wd.drone_num):
            if done[i] or fin[i]:
                env.reset_one(i)
    return steps / (time.perf_counter() - t0)


def main(argv=None) -> int:
    from rvo3d_tpu_torch.bench.flagship import flagship_world

    ap = argparse.ArgumentParser(prog="rvo3d_tpu_torch bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    world_dict = flagship_world()
    num_envs = int(os.environ.get("RVO3D_BENCH_ENVS", "16384"))
    steps = int(os.environ.get("RVO3D_BENCH_STEPS", "100"))
    repeats = int(os.environ.get("RVO3D_BENCH_REPEATS", "3"))

    value, rates = bench_env(world_dict, num_envs, steps, repeats, dev)
    baseline = bench_oracle(world_dict)
    rates_sorted = sorted(rates)
    print(json.dumps({
        "metric": "env_steps_per_sec",
        "value": round(value, 1),
        "unit": "env-steps/s (8-drone flagship world, full step pipeline)",
        "vs_baseline": round(value / baseline, 1),
        "repeats": len(rates),
        "min": round(rates_sorted[0], 1),
        "median": round(rates_sorted[len(rates_sorted) // 2], 1),
        "max": round(rates_sorted[-1], 1),
        "device": device_name(dev),
    }), flush=True)
    return 0
