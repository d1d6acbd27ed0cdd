"""Fixtures of the benchmark's CPU tests: a run of a cell at a size a CPU
holds (the configuration's widths and product, a few lanes and steps),
driven through the harness after its look for a card."""

from __future__ import annotations

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the cells cut to a CPU's size: (program config overrides, params overrides)
SMALL = {
    "w16_r4.train": ({"train": {"num_envs": 2, "steps_per_epoch": 12, "minibatch": 96,
                                "train_pi_iters": 3, "train_v_iters": 3}},
                     {"checked_epochs": 3, "rollout_rows": 64, "replay_lanes": 2,
                      "replay_steps": 12}),
    "w32_m3s.eval": ({}, {"lanes": 4, "chunk": 6, "max_ep_len": 5, "check_lanes": 2}),
    "w16_r4.serve": ({}, {"batch_sizes": [4, 16], "pool": 2, "check_requests": 4}),
}


# the cells cut to what a short test on a card holds: enough of the
# evaluation's lanes and steps that the TF32 control flips some actions
CARD = {
    "w16_r4.train": SMALL["w16_r4.train"],
    "w32_m3s.eval": ({}, {"lanes": 256, "chunk": 40, "max_ep_len": 30, "check_lanes": 64}),
    "w16_r4.serve": SMALL["w16_r4.serve"],
}


def small_run(cell: str, seed: int = 3, seconds: float = 0.05, sizes=SMALL):
    """(run, driver) of `cell` at its SMALL (or `sizes`) size on the CPU."""
    from benchmark.harness import main as hm

    args = hm.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds)])
    _, _, run = hm.make_run(args)
    prog, params = sizes[cell]
    run.config = copy.deepcopy(run.config)
    for block, kv in prog.items():
        run.config["program"][block].update(kv)
    run.workload = copy.deepcopy(run.workload)
    run.workload["params"].update(params)
    run.device = "cpu"
    return run, hm.load_module("drivers", run.workload["driver"])


@pytest.fixture
def small():
    return small_run
