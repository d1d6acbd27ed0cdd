"""The readings the limits of a `sim` cell's check are set from, on the card:

    python3 benchmark/calibrate_sim.py --workload <cell> --seeds <n> [<n> ...]
        [--fault-seeds <n> ...] [--faults <f> ...] [--seconds <s>] [--out <file.jsonl>]

For each seed, in this one process: the cell's set-up, a window of
--seconds, and the check's numbers for the program (the lower readings)
and for the control, the reference flown in float16 (the precision below
the configuration's float32) in the program's place (an upper reading).
For each fault seed, a run with each fault planted in the program, and its
numbers:
  `unchanged`  the chunk hands back the state it was given;
  `altered`    drone 0's position raised by 0.5 m where the env step
               writes it;
  `no_reset`   the reset of collided and finished drones skipped.
One JSON line per reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FAULTS = ("unchanged", "altered", "no_reset")


@contextlib.contextmanager
def planted(fault: str):
    """The fault planted in the port's bench loop while the block runs."""
    import torch

    from rvo3d_tpu_torch.bench import core

    undo = []

    def patch(name, new):
        undo.append((name, getattr(core, name)))
        setattr(core, name, new)

    if fault == "unchanged":
        make = core.make_chunk

        def make_unchanged(*a, **k):
            chunk = make(*a, **k)

            def unchanged(state, steps):
                chunk(state, steps)
                return state
            return unchanged
        patch("make_chunk", make_unchanged)
    elif fault == "altered":
        step = core.step

        def altered(*a, **k):
            state, out = step(*a, **k)
            bump = torch.zeros_like(state.pos)
            bump[..., 0, 2] = 0.5
            return state._replace(pos=state.pos + bump), out
        patch("step", altered)
    elif fault == "no_reset":
        patch("reset_where", lambda world, state, mask: state)
    else:
        raise ValueError(f"no fault {fault!r} for the sim driver")
    try:
        yield
    finally:
        for name, old in reversed(undo):
            setattr(core, name, old)


def readings(run, driver, fault=None, control=True):
    """The numbers of one run of `run`'s cell: the program's (or, with
    `fault`, the faulty program's) and, unless a fault runs, the control's."""
    with planted(fault) if fault else contextlib.nullcontext():
        st = driver.setup(run)
        driver.window(st, run)
        driver.release(st)
    lines = [{"cell": run.cell, "seed": run.seed, "side": fault or "program",
              **driver.readings(st, run)}]
    if control and not fault:
        lines.append({"cell": run.cell, "seed": run.seed, "side": "control",
                      **driver.readings(st, run, control=True)})
    return lines


def one(cell: str, seed: int, seconds: float, fault=None, control=True):
    import torch

    from benchmark.harness import main as hm

    args = hm.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds)])
    _, _, run = hm.make_run(args)
    lines = readings(run, hm.load_module("drivers", run.workload["driver"]), fault, control)
    torch.cuda.empty_cache()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/calibrate_sim.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=list(FAULTS))
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-control", action="store_true",
                    help="read the program alone, not the control")
    a = ap.parse_args(argv)
    jobs = [(s, None) for s in a.seeds] + [(s, f) for s in a.fault_seeds for f in a.faults]
    for seed, fault in jobs:
        for line in one(a.workload, seed, a.seconds, fault, not a.no_control):
            text = json.dumps(line)
            print(text, flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
