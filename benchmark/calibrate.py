"""The readings the limits of a cell's check are set from, on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--fault-seeds <n> ...] [--seconds <s>] [--out <file.jsonl>]

For each seed, in this one process: the cell's set-up, a window of
--seconds, and the check's numbers for the program (the lower readings)
and for the control, the plain reference in TF32 put in the program's
place (the upper readings). For each fault seed, a run with each fault the
cell can have planted in the program, and its numbers:
  train: `half` (every policy and value iteration's loss taken over the
         first half of its window's rows), `altered` (drone 0's reward of
         every step raised by 1 where the env produces it), `altered_obs`
         (drone 0's first observed coordinate raised by 0.5 where the env
         produces it), `stale` (the rollout acts on a copy of the weights
         taken at its first call, so from the second epoch on it acts on
         stale ones); a state left unchanged reads 1 on change_gap by its
         definition and needs no run;
  eval:  `unchanged` (the evaluation step hands back the carry it was
         given), `altered` (drone 0's episode return in every record
         raised by 1 where the step writes it), `altered_obs` (drone 0's
         first observed coordinate raised by 0.5 where the env step
         produces it);
  serve: `altered` (the first row of every answer moved by 0.5).
One JSON line per reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FAULTS = {"train": ("half", "altered", "altered_obs", "stale"),
          "eval": ("unchanged", "altered", "altered_obs"), "serve": ("altered",)}


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """The fault planted in the program's modules while the block runs."""
    import torch

    undo = []

    def patch(mod, name, new):
        undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, new)

    if kind == "train" and fault == "half":
        from rvo3d_tpu_torch.algo import ppo

        def half(batch):
            n = batch.act.shape[0] // 2
            return type(batch)(*[x[:n] for x in batch])
        pi, v = ppo.pi_loss_fn, ppo.v_loss_fn
        patch(ppo, "pi_loss_fn", lambda ac, b, *a, **k: pi(ac, half(b), *a, **k))
        patch(ppo, "v_loss_fn", lambda ac, b, *a, **k: v(ac, half(b), *a, **k))
    elif kind == "train" and fault in ("altered", "altered_obs"):
        from rvo3d_tpu_torch.algo import rollout
        step = rollout.step

        def altered_step(*a, **k):
            state, out = step(*a, **k)
            if fault == "altered":
                bump = torch.zeros_like(out.reward)
                bump[..., :1] = 1.0
                return state, out._replace(reward=out.reward + bump)
            bump = torch.zeros_like(out.obs_self)
            bump[..., :1, :1] = 0.5
            return state, out._replace(obs_self=out.obs_self + bump)
        patch(rollout, "step", altered_step)
    elif kind == "train" and fault == "stale":
        from rvo3d_tpu_torch.algo import trainer
        make = trainer.make_rollout

        def stale(ac, *a, **k):
            made = []

            def rollout(carry):
                if not made:
                    made.append(make(copy.deepcopy(ac), *a, **k))
                return made[0](carry)
            return rollout
        patch(trainer, "make_rollout", stale)
    elif kind == "eval" and fault == "altered_obs":
        from rvo3d_tpu_torch.algo import evaluator
        env_step = evaluator.step

        def altered_env(*a, **k):
            state, out = env_step(*a, **k)
            bump = torch.zeros_like(out.obs_self)
            bump[..., :1, :1] = 0.5
            return state, out._replace(obs_self=out.obs_self + bump)
        patch(evaluator, "step", altered_env)
    elif kind == "eval":
        from rvo3d_tpu_torch.algo import evaluator
        step = evaluator.eval_step

        def faulty(ac, world, p, c, *a, **k):
            carry, rec = step(ac, world, p, c, *a, **k)
            if fault == "unchanged":
                return c, rec
            return carry, rec._replace(ret0=rec.ret0 + 1.0)
        patch(evaluator, "eval_step", faulty)
    elif kind == "serve" and fault == "altered":
        from rvo3d_tpu_torch.serving import PolicyServer
        policy = PolicyServer.policy

        def altered(self, *a, **k):
            out = policy(self, *a, **k)
            bump = torch.zeros_like(out)
            bump[:1, :1] = 0.5
            return out + bump
        patch(PolicyServer, "policy", altered)
    else:
        raise ValueError(f"no fault {fault!r} for the {kind} driver")
    try:
        yield
    finally:
        for mod, name, old in reversed(undo):
            setattr(mod, name, old)


def readings(run, driver, fault=None, control=True):
    """The numbers of one run of `run`'s cell: the program's (or, with
    `fault`, the faulty program's) and, unless a fault runs, the control's."""
    from benchmark import checks

    kind = run.workload["driver"]
    with planted(kind, fault) if fault else contextlib.nullcontext():
        st = driver.setup(run)
        driver.window(st, run)
        driver.release(st)
    read = {"train": lambda c: checks.train_readings(st, run, driver.program_config(run), c),
            "eval": lambda c: checks.eval_readings(st, run, c),
            "serve": lambda c: checks.serve_readings(st, run, c)}[kind]
    lines = [{"cell": run.cell, "seed": run.seed, "side": fault or "program", **read(False)}]
    if control and not fault:
        lines.append({"cell": run.cell, "seed": run.seed, "side": "control", **read(True)})
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
    ap = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--faults", nargs="*", default=None,
                    help="the faults to plant (default: all the cell can have)")
    ap.add_argument("--no-control", action="store_true",
                    help="read the program alone, not the control")
    a = ap.parse_args(argv)
    from benchmark.harness import main as hm

    kind = hm.load_json(ROOT, "benchmark", "workloads", a.workload + ".json")["driver"]
    faults = FAULTS[kind] if a.faults is None else a.faults
    jobs = [(s, None) for s in a.seeds] + [(s, f) for s in a.fault_seeds for f in faults]
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
