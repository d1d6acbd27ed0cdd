"""The port's CLI (python -m rvo3d_tpu_torch.cli train|eval) against the JAX
package's CLI on the same flags, on the CPU at a small width: gen_demo and
gen_demo:rev in alternate lanes, BC on the RVO expert (margin 0.3,
slowdown, DART noise, one DAgger round, a few fit steps), then two PPO
epochs (0 and 1, both saved), then `eval --reverse` of the run.

The two runs draw different random numbers, so their numbers differ;
what must agree is what a user or a script reads: the run directory's
files and checkpoint epochs, train.jsonl's keys line by line, the
results.txt lines (one per population and evaluated epoch, same order,
same format), best_checkpoint.json's keys and hint, config.json's keys,
and the format of eval's line (--curriculum, --torch_checkpoint and the
data-parallel flags are held by tests/test_torch_{curriculum,ref_import,
parallel}.py, `bench` by tests/test_torch_bench.py).
"""

import json
import os
import re

import pytest

from rvo3d_tpu import cli as jcli
from rvo3d_tpu_torch import cli
from torch_threads import one_intra_op_thread  # noqa: F401

FLAGS = ["--world", "gen_demo", "--multi_worlds", "gen_demo,gen_demo:rev",
         "--num_envs", "4", "--steps_per_epoch", "8", "--train_epoch", "1",
         "--rnn_hidden_dim", "16", "--bc_steps", "5", "--bc_expert", "rvo",
         "--bc_dagger", "1", "--bc_noise", "0.1", "--bc_margin", "0.3", "--bc_slowdown",
         "--bc_demo_steps", "6", "--action_mode", "direct", "--batched_update",
         "--minibatch", "64", "--train_pi_iters", "2", "--train_v_iters", "2",
         "--save_freq", "1", "--eval_episodes", "4", "--quiet"]
NUM = r"-?[\d.]+(?:e-?\d+)?"
RESULT = re.compile(rf"^epoch (\d+) \[([^\]]+)\]: success {NUM}% EpLen {NUM}±{NUM} "
                    rf"speed {NUM}±{NUM}$")
EVAL = re.compile(rf"^world=gen_demo routes=reversed success_rate={NUM}% "
                  rf"EpLen={NUM}±{NUM} speed={NUM}±{NUM} ret0=(?:{NUM}|inf|-inf|nan) "
                  rf"\((\d+) episodes\)$")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    out = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        run = str(root / name)
        assert main(["train", *FLAGS, "--run_dir", run, *extra]) == 0
        res = str(root / f"{name}_eval.txt")
        assert main(["eval", "--world", "gen_demo", "--checkpoint", run, "--ckpt_epoch",
                     "0", "--reverse", "--episodes", "4", "--lanes", "4",
                     "--results_file", res, *extra]) == 0
        out[name] = (run, res)
    return out


def read(path):
    with open(path) as f:
        return f.read()


def test_run_dirs_hold_the_same_files_and_epochs(runs):
    (jrun, _), (trun, _) = runs["jax"], runs["port"]
    need = {"config.json", "train.jsonl", "results.txt", "best_checkpoint.json",
            "reward_curves.csv", "ckpt"}
    assert need <= set(os.listdir(trun)) and need <= set(os.listdir(jrun))
    epochs = [sorted(d for d in os.listdir(os.path.join(r, "ckpt")) if d.isdigit())
              for r in (jrun, trun)]
    assert epochs[0] == epochs[1] == ["0", "1"]
    jcfg, tcfg = (json.loads(read(os.path.join(r, "config.json"))) for r in (jrun, trun))
    assert {k: set(v) if isinstance(v, dict) else v for k, v in jcfg.items()} == {
        k: set(v) if isinstance(v, dict) else v for k, v in tcfg.items()}
    assert tcfg == jcfg        # the same Config, field for field


def test_train_jsonl_has_the_jax_keys(runs):
    lines = [[json.loads(ln) for ln in read(os.path.join(runs[k][0], "train.jsonl"))
              .splitlines() if ln.strip()] for k in ("jax", "port")]
    assert len(lines[0]) == len(lines[1]) == 2
    for j, t in zip(*lines):
        assert set(t) == set(j)
        assert t["epoch"] == j["epoch"]


def test_results_and_best_checkpoint_match_the_jax_format(runs):
    parsed = []
    for k in ("jax", "port"):
        run = runs[k][0]
        lines = read(os.path.join(run, "results.txt")).splitlines()
        matches = [RESULT.match(ln) for ln in lines]
        assert all(matches), lines
        parsed.append([m.groups() for m in matches])
        best = json.loads(read(os.path.join(run, "best_checkpoint.json")))
        assert set(best) == {"epoch", "min_success_rate", "hint"}
        assert best["hint"] == f"cli eval --checkpoint {run} --ckpt_epoch {best['epoch']}"
        assert best["epoch"] in (0, 1)
    assert parsed[0] == parsed[1] == [("0", "gen_demo"), ("0", "gen_demo:rev"),
                                      ("1", "gen_demo"), ("1", "gen_demo:rev")]


def test_eval_reverse_line_matches_the_jax_format(runs):
    for k in ("jax", "port"):
        lines = read(runs[k][1]).splitlines()
        assert len(lines) == 1 and EVAL.match(lines[0]), lines
        assert int(EVAL.match(lines[0]).group(1)) == 4


def test_bc_flag_checks_match_the_jax_cli(tmp_path):
    for bad in (["--bc_slowdown"], ["--bc_margin", "0.3"]):
        with pytest.raises(SystemExit, match="'rvo' expert"):
            cli.main(["train", "--device", "cpu", "--world", "gen_demo",
                      "--run_dir", str(tmp_path), *bad])


def test_default_device_is_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["train", "--world", "gen_demo", "--run_dir", str(tmp_path)])
