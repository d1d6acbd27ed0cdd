"""Driver `sim`: the env alone, flown by the analytic waypoint controller
with no policy, as bench.py's loop runs it (`bench/core.make_chunk`: the
controller, the env step and the reset of collided or finished drones,
one graphed step replayed `chunk` times a call).

Set-up loads the configuration's world file, builds the chunk and resets
every lane. It staggers the lanes: each draws a phase from 0 to
`stagger` - 1 from --seed, `stagger` steps are flown one call of one step
at a time, and each lane keeps its state at its own phase (without it
every lane would be one identical copy). Warm calls of `chunk` steps follow
for `warm_seconds`: on the H100 the first seconds of steady load in a
process (none to ~40 s, 30 s at most but once) ran 13-15 % slower a call at
the same reported SM clock, then switched once to the steady rate
(PERF.md §5), so the window starts past them. With one warm chunk alone, a
set of 6 runs spread 3.6 %, over half the rate's bound; the 30 s are paid
in `setup_s` (PERF.md §2). The window calls the chunk
until --seconds have passed; the rate
counts every step of every call begun before the time ran out. A traced
run profiles the window's second call.

For the check, each of the first `check_calls` calls keeps `check_lanes`
lanes drawn from the seed, with the state the call started from and the
one it returned. After the window the reference (reference/controller.py
on the frozen oracle, float64) flies each kept lane the call's steps from
its start, and its end is compared with the program's:
  state_gap      the widest gap of a drone's position, velocity or route
                 length flown since its last reset, over the 2-decimal
                 rounding step (0.01)
  flag_mismatch  waypoint indices, waypoint-arrival, destination and
                 collision flags that differ
A lane that disagrees (a flag, or state_gap over its limit) is flown again
and each step is tried from perturbed copies of the reference's state
(reference/envcheck.perturb, `tie_delta`, `tie_tries` copies a step, at
most `tie_searches` lanes a run): a step whose decisions (done, finish,
resets, waypoint advances, the flags, or an action jumping by more than
ACT_JUMP) change under a perturbation is a knife edge of float32 against
float64, and its lane is counted as a tie and left out. Otherwise the lane
counts as it reads. The program keeps no count of resets or collisions, so
a reset at another step shows as a position and route-length gap; the
reference's own counts are printed among the readings.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import checks
from benchmark.reference import controller, envcheck

ROUND_STEP = 0.01     # the observation's 2-decimal rounding step
# a change of a flying drone's action that no perturbation of tie_delta makes
# smoothly (a frozen drone's action moves nothing)
ACT_JUMP = 0.1
STATE_FIELDS = ("pos", "prev_pos", "vel", "yaw", "pitch", "wp_idx", "arrive_flag",
                "dest_arrive_flag", "collision_flag", "real_route_len", "extra_len",
                "max_deviation")


class State:
    pass


def world_dict(run) -> dict:
    with open(os.path.join(run.root, run.config["world_file"])) as f:
        return json.load(f)


def select(pick: torch.Tensor, fresh, kept):
    """kept's lanes replaced by fresh's where pick [E] holds."""
    def where(a, b):
        return torch.where(pick.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    return type(kept)(*[where(a, b) for a, b in zip(fresh, kept)])


def setup(run):
    from rvo3d_tpu_torch.bench.core import make_chunk, world_spec
    from rvo3d_tpu_torch.config import EnvParams
    from rvo3d_tpu_torch.env.env import reset

    tr = run.workload["params"]
    prog = run.config["program"]
    dev = torch.device(run.device)
    st = State()
    world = world_spec(world_dict(run), dev, getattr(torch, prog["dtype"]))
    p = EnvParams(**prog["env"])
    st.chunk = make_chunk(world, p)
    rng = np.random.default_rng([run.seed, 0])
    phase = torch.as_tensor(rng.integers(0, tr["stagger"], tr["lanes"]), device=dev)
    state = reset(world, p, lead=(tr["lanes"],))
    kept = state
    with run.span("stagger", warmup=True):
        for t in range(tr["stagger"]):
            kept = select(phase == t, state, kept)
            state = st.chunk(state, 1)
    with run.span("chunk", warmup=True):
        st.state = st.chunk(kept, tr["chunk"])
    run.sync()
    with run.span("warm", warmup=True):
        end = time.perf_counter() + tr["warm_seconds"]
        while time.perf_counter() < end:
            st.state = st.chunk(st.state, tr["chunk"])
            run.sync()
    st.rng = np.random.default_rng([run.seed, 1])
    st.kept = []
    return st


def _keep(st, run, start, end) -> None:
    """The sampled lanes' start and end states of a call, on the device."""
    tr = run.workload["params"]
    lanes = torch.as_tensor(st.rng.choice(tr["lanes"], tr["check_lanes"], replace=False),
                            device=start.pos.device)
    pick = lambda s: {f: getattr(s, f).index_select(0, lanes) for f in STATE_FIELDS}  # noqa: E731
    st.kept.append({"lanes": lanes, "start": pick(start), "end": pick(end)})


def window(st, run):
    tr = run.workload["params"]
    calls = 0
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    end = t0
    while end < deadline:
        start = st.state
        if run.trace and calls == 1:
            from benchmark.harness.trace import Tracer
            with Tracer(run), run.span("chunk"):
                st.state = st.chunk(st.state, tr["chunk"])
            run.window["traced_env_steps"] = tr["chunk"] * tr["lanes"]
        else:
            with run.span("chunk"):
                st.state = st.chunk(st.state, tr["chunk"])
        if calls < tr["check_calls"]:
            _keep(st, run, start, st.state)
        calls += 1
        run.sync()
        end = time.perf_counter()
    run.window.update(start=t0, end=end, env_steps=calls * tr["chunk"] * tr["lanes"])
    run.count("attempted", calls)


def release(st):
    import gc

    for k in st.kept:
        for key in ("start", "end"):
            k[key] = {n: v.cpu() for n, v in k[key].items()}
        k["lanes"] = k["lanes"].cpu()
    st.chunk = st.state = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---- the check ----

def oracle_at(world, env: dict, state: Dict[str, np.ndarray]):
    """The oracle with every drone in the program's lane state. Its rewards
    are computed with `safe_rewards` on: no reward enters the state, and
    the parity rule divides by a zero desired speed (a Python float
    division, which raises) for a drone left at its destination."""
    oracle = envcheck.make_oracle(world, {**env, "safe_rewards": True})
    for i in range(world.drone_num):
        envcheck.set_drone(oracle, i, {k: v[i] for k, v in state.items()})
    return oracle


def compare(oracle, got: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The end state `got` (one lane's program state) against the oracle's:
    state_gap, flag_mismatch, and the widest yaw or pitch gap in degrees
    over the rounding step (angle_gap, printed, not limited)."""
    ds = oracle.drones
    ref = {"pos": [d.state for d in ds], "vel": [d.vel for d in ds],
           "real_route_len": [d.real_route_len for d in ds]}
    gap = max(float(np.max(np.abs(np.asarray(got[k], float) - np.asarray(v, float))))
              for k, v in ref.items())
    flags = {"wp_idx": [d.i for d in ds], "arrive_flag": [d.arrive_flag for d in ds],
             "dest_arrive_flag": [d.dest_arrive_flag for d in ds],
             "collision_flag": [d.collision_flag for d in ds]}
    mismatch = sum(int(np.sum(np.asarray(got[k]).astype(np.int64)
                              != np.asarray(v).astype(np.int64))) for k, v in flags.items())
    yaw = np.abs(np.asarray(got["yaw"], float) - [d.yaw for d in ds]) % 360.0
    angle = max(float(np.max(np.minimum(yaw, 360.0 - yaw))),
                float(np.max(np.abs(np.asarray(got["pitch"], float) - [d.pitch for d in ds]))))
    return {"state_gap": gap / ROUND_STEP, "flag_mismatch": mismatch,
            "angle_gap": angle / ROUND_STEP}


def decided(oracle, res: dict) -> tuple:
    return (tuple(res["done"]), tuple(res["finish"]), tuple(res["advanced"]),
            tuple((d.i, d.arrive_flag, d.dest_arrive_flag) for d in oracle.drones))


def knife_edge(world, env: dict, start: Dict[str, np.ndarray], steps: int,
               tie: dict) -> Optional[int]:
    """The first step of the lane's reference flight from `start` whose
    decisions change under a perturbation of the state by tie["delta"]
    (tie["tries"] copies a step, seeded by tie["seed"]), or None."""
    oracle = oracle_at(world, env, start)
    rng = np.random.default_rng(tie["seed"])
    n = world.drone_num
    for t in range(steps):
        before = copy.deepcopy(oracle)
        flying = ~np.array([d.dest_arrive_flag or d.collision_flag for d in before.drones])
        res = controller.step(oracle)
        want = decided(oracle, res)
        for _ in range(tie["tries"]):
            trial = copy.deepcopy(before)
            envcheck.perturb(trial, rng, tie["delta"])
            r = controller.step(trial, jitter=rng.uniform(-envcheck.ACT_DELTA,
                                                          envcheck.ACT_DELTA, (n, 3)))
            jump = np.abs(r["act"] - res["act"])[flying]
            if decided(trial, r) != want or np.max(jump, initial=0.0) > ACT_JUMP:
                return t
    return None


def readings(st, run, control: bool = False) -> dict:
    """The check's numbers for the program's kept lanes, or (`control`) for
    the reference flown in float16 (controller.fly's `precision`) in the
    program's place, from the same start states."""
    tr = run.workload["params"]
    env = run.config["program"]["env"]
    world = envcheck.load_world(os.path.dirname(os.path.join(run.root,
                                                             run.config["world_file"])))
    limit = run.workload["limits"]["state_gap"]
    out = {"state_gap": 0.0, "flag_mismatch": 0, "angle_gap": 0.0, "sim_checked": 0,
           "sim_ties": 0, "sim_tie_at": [], "sim_resets": 0, "sim_collisions": 0,
           "sim_finishes": 0, "sim_advances": 0}
    searches = 0
    for k, kept in enumerate(st.kept):
        for j in range(len(kept["lanes"])):
            start = {f: v[j].numpy() for f, v in kept["start"].items()}
            ref = oracle_at(world, env, start)
            n = controller.fly(ref, tr["chunk"])
            if control:
                c = oracle_at(world, env, start)
                controller.fly(c, tr["chunk"], precision=torch.float16)
                got = {"pos": [d.state for d in c.drones], "vel": [d.vel for d in c.drones],
                       "yaw": [d.yaw for d in c.drones], "pitch": [d.pitch for d in c.drones],
                       "real_route_len": [d.real_route_len for d in c.drones],
                       "wp_idx": [d.i for d in c.drones],
                       "arrive_flag": [d.arrive_flag for d in c.drones],
                       "dest_arrive_flag": [d.dest_arrive_flag for d in c.drones],
                       "collision_flag": [d.collision_flag for d in c.drones]}
            else:
                got = {f: v[j].numpy() for f, v in kept["end"].items()}
            r = compare(ref, got)
            if (r["flag_mismatch"] or r["state_gap"] > limit) and searches < tr["tie_searches"]:
                searches += 1
                tie = {"delta": tr["tie_delta"], "tries": tr["tie_tries"],
                       "seed": [run.seed, 2, k, j]}
                at = knife_edge(world, env, start, tr["chunk"], tie)
                if at is not None:
                    out["sim_ties"] += 1
                    out["sim_tie_at"].append([k, j, at])
                    continue
            out["state_gap"] = max(out["state_gap"], r["state_gap"])
            out["angle_gap"] = max(out["angle_gap"], r["angle_gap"])
            out["flag_mismatch"] += r["flag_mismatch"]
            out["sim_checked"] += 1
            for key, v in n.items():
                out["sim_" + key] += v
    return out


def check(st, run):
    return checks.limits_of(run, readings(st, run))
