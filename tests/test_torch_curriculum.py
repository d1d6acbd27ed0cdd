"""The port's goal-threshold curriculum (`cli train --curriculum`) against
the JAX CLI on gen_demo, both run for real at the smallest size (2 lanes,
4 steps, H = 4), with the stages 1.2:1,0.4:rest over 3 epochs:

  - the same stage boundaries: train.jsonl's epochs and goal_threshold
    line by line, with the same keys; checkpoints 0, 1 and 2;
  - the same results.txt lines in order and format (the per-stage
    evaluations at the stage's threshold, and each stage's end evaluated
    at {stage thr, final thr});
  - each stage's Trainer and evaluations run under env params that carry
    the stage's threshold, on both sides (recorded by wrappers that call
    the real Trainer and evaluator);
  - --curriculum with --multi_worlds is refused, as in the JAX CLI.

The JAX run compiles its epochs and evaluations: ~60 s on a CPU.
"""

import json
import os
import re

import pytest

import rvo3d_tpu.algo.evaluator as jevaluator
import rvo3d_tpu.algo.trainer as jtrainer
from rvo3d_tpu import cli as jcli
from rvo3d_tpu_torch import cli
from rvo3d_tpu_torch.algo import evaluator, trainer
from torch_threads import one_intra_op_thread  # noqa: F401

FLAGS = ["--world", "gen_demo", "--num_envs", "2", "--steps_per_epoch", "4",
         "--train_epoch", "3", "--rnn_hidden_dim", "4", "--train_pi_iters", "2",
         "--train_v_iters", "2", "--save_freq", "1", "--eval_episodes", "2",
         "--batched_update", "--action_mode", "direct", "--curriculum", "1.2:1,0.4:rest",
         "--quiet"]
NUM = r"-?[\d.]+(?:e-?\d+)?"
STAGE_EVAL = re.compile(rf"^epoch (\d+) \(stage thr=({NUM})\): success {NUM}% "
                        rf"EpLen {NUM}±{NUM}$")
STAGE_END = re.compile(rf"^stage thr=({NUM}) done \(epoch (\d+)\): eval@({NUM}) "
                       rf"success {NUM}% EpLen {NUM}±{NUM}$")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("curriculum")
    seen = {side: {"trainer": [], "evaluate": []} for side in ("jax", "port")}
    wrapped = {}
    for side, tmod, emod, thr_arg in (("jax", jtrainer, jevaluator, 3),
                                      ("port", trainer, evaluator, 2)):
        class Recording(tmod.Trainer):
            record = seen[side]["trainer"]

            def __init__(self, cfg, *a, **k):
                self.record.append(cfg.env.goal_threshold)
                super().__init__(cfg, *a, **k)

        def recording_eval(*a, _real=emod.evaluate, _seen=seen[side], _i=thr_arg, **k):
            _seen["evaluate"].append(a[_i].goal_threshold)   # the env params
            return _real(*a, **k)
        wrapped[side] = ((tmod, "Trainer", Recording), (emod, "evaluate", recording_eval))

    mp = pytest.MonkeyPatch()
    try:
        for side in wrapped.values():
            for mod, name, fn in side:
                mp.setattr(mod, name, fn)
        out = {}
        for name, main, extra in (("jax", jcli.main, []),
                                  ("port", cli.main, ["--device", "cpu"])):
            run = str(root / name)
            assert main(["train", *FLAGS, "--run_dir", run, *extra]) == 0
            out[name] = run
    finally:
        mp.undo()
    return out, seen


def read_lines(run, name):
    with open(os.path.join(run, name)) as f:
        return f.read().splitlines()


def test_stage_boundaries_and_train_jsonl_match_jax(runs):
    out, _ = runs
    lines = {k: [json.loads(ln) for ln in read_lines(out[k], "train.jsonl") if ln.strip()]
             for k in out}
    assert [(ln["epoch"], ln["goal_threshold"]) for ln in lines["port"]] == [
        (ln["epoch"], ln["goal_threshold"]) for ln in lines["jax"]] == [
        (0, 1.2), (1, 0.4), (2, 0.4)]
    for t, j in zip(lines["port"], lines["jax"]):
        assert set(t) == set(j)
    for run in out.values():
        ckpts = sorted(d for d in os.listdir(os.path.join(run, "ckpt")) if d.isdigit())
        assert ckpts == ["0", "1", "2"]


def test_results_lines_match_jax(runs):
    out, _ = runs
    parsed = {}
    for k, run in out.items():
        rows = []
        for ln in read_lines(run, "results.txt"):
            m = STAGE_EVAL.match(ln) or STAGE_END.match(ln)
            assert m, ln
            rows.append(("eval" if m.re is STAGE_EVAL else "end",) + m.groups())
        parsed[k] = rows
    assert parsed["port"] == parsed["jax"] == [
        ("eval", "0", "1.2"), ("end", "1.2", "1", "0.4"), ("end", "1.2", "1", "1.2"),
        ("eval", "1", "0.4"), ("eval", "2", "0.4"), ("end", "0.4", "3", "0.4")]


def test_each_stage_runs_at_its_threshold(runs):
    _, seen = runs
    # the run's first Trainer (default threshold), then one per stage
    assert seen["port"]["trainer"] == seen["jax"]["trainer"] == [0.4, 1.2, 0.4]
    assert seen["port"]["evaluate"] == seen["jax"]["evaluate"] == [
        1.2, 0.4, 1.2, 0.4, 0.4, 0.4]


def test_curriculum_refuses_multi_worlds(tmp_path):
    with pytest.raises(SystemExit, match="not combinable"):
        cli.main(["train", "--device", "cpu", "--world", "gen_demo", "--curriculum",
                  "1.2:1,0.4:rest", "--multi_worlds", "gen_demo,gen_demo:rev",
                  "--run_dir", str(tmp_path)])
