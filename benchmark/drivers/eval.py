"""Driver `eval`: the graphed evaluation chunk (`algo/evaluator.
make_eval_chunk`) flying the product policy closed loop over many lanes.

Set-up loads the product (its sha256 checked) into an ActorCritic, resets
every lane of the world (`init_eval_carry`), and runs one chunk, which
warms up and captures the chunk's step. The window then calls the chunk
until --seconds have passed, each call `chunk` steps of every lane with
the standard normals drawn from one CUDA generator seeded from --seed;
lanes reset as their episodes end. The rate counts every step of every
call begun before the time ran out. A traced run profiles the window's
second call.

For the check, each call keeps, for `check_lanes` lanes drawn from the
seed, the program's state the call started from (the carry the previous
call returned), the generator's state before it, the records of its
first step, and the episode lengths and ends of all its steps. After the
window the reference flies those lanes one step from that state: its own
policy on the program's observations with the same standard normals, the
oracle env (reference/envcheck.step_from); and holds the lengths of every
step to the evaluator's lifecycle.
Compared numbers (workload `limits`): speed_gap, ret0_gap,
record_mismatch (benchmark/checks.py).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import checks
from benchmark.reference import policy as ref


class State:
    pass


def setup(run):
    from rvo3d_tpu_torch.algo.evaluator import init_eval_carry, make_eval_chunk
    from rvo3d_tpu_torch.config import from_dict
    from rvo3d_tpu_torch.serving import PolicyServer
    from rvo3d_tpu_torch.worlds.loader import load_world_dir

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = run.workload["params"]
    cfg = from_dict(run.config["program"])
    dev = torch.device(run.device)
    path = os.path.join(run.root, run.config["product"]["path"])
    if ref.sha256_of(path) != run.config["product"]["sha256"]:
        raise ValueError(f"{path} is not the configuration's product")
    st = State()
    world = load_world_dir(os.path.join(run.root, "benchmark", "configs", "worlds",
                                        cfg.world)).spec(device=dev)
    with run.span("policy.load"):
        st.ac = PolicyServer.from_checkpoint(path, device=dev).ac
    st.chunk = make_eval_chunk(st.ac, world, cfg.env, max_ep_len=tr["max_ep_len"],
                               std_factor=tr["std_factor"], chunk=tr["chunk"],
                               action_mode=cfg.train.action_mode)
    st.gen = torch.Generator(device=dev).manual_seed(run.seed)
    st.carry = init_eval_carry(world, cfg.env, tr["lanes"])
    with run.span("chunk", warmup=True):
        st.carry, _ = st.chunk(st.carry, st.gen)
    run.sync()
    st.rng = np.random.default_rng([run.seed, 1])
    st.kept = []
    return st


def _keep(st, run, gen_state, carry, rec):
    """The sampled lanes' start state, draws and first-step records of a
    call, on the device (copied to the host after the window)."""
    tr = run.workload["params"]
    lanes = torch.as_tensor(st.rng.choice(tr["lanes"], tr["check_lanes"], replace=False),
                            device=rec.ended.device)
    pick = lambda x: x.index_select(0, lanes)  # noqa: E731
    st.kept.append({
        "lanes": lanes, "gen_state": gen_state,
        "state": {k: pick(v) for k, v in carry.env_state._asdict().items()
                  if k not in ("sphere_pos", "sphere_vel")},
        "obs": tuple(pick(x) for x in carry.obs),
        "carry": {"ep_len": pick(carry.ep_len), "speed_sum": pick(carry.speed_sum),
                  "ret0": pick(carry.ret0)},
        "rec": {k: v[0].index_select(0, lanes) for k, v in rec._asdict().items()},
        "lengths": {k: getattr(rec, k).index_select(1, lanes) for k in ("ended", "ep_len")},
    })


def window(st, run):
    tr = run.workload["params"]
    calls = 0
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    end = t0
    while end < deadline:
        gen_state = st.gen.get_state()
        start = st.carry
        if run.trace and calls == 1:
            from benchmark.harness.trace import Tracer
            with Tracer(run), run.span("chunk"):
                st.carry, rec = st.chunk(st.carry, st.gen)
            st.traced_steps = tr["chunk"] * tr["lanes"]
        else:
            with run.span("chunk"):
                st.carry, rec = st.chunk(st.carry, st.gen)
        _keep(st, run, gen_state, start, rec)
        calls += 1
        run.sync()
        end = time.perf_counter()
    run.window.update(start=t0, end=end, env_steps=calls * tr["chunk"] * tr["lanes"])
    if run.trace:
        run.window["traced_env_steps"] = st.traced_steps
    run.count("attempted", calls)


def release(st):
    import gc

    for k in st.kept:
        for key in ("state", "carry", "rec", "lengths"):
            k[key] = {n: v.cpu() for n, v in k[key].items()}
        k["obs"] = tuple(x.cpu() for x in k["obs"])
    st.chunk = st.carry = st.ac = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(st, run):
    return checks.eval_checks(st, run)
