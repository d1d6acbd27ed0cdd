"""The port's graft entry points (rvo3d_tpu_torch/entry.py), section 4 of
its detail bench and its env_smoke example:

  - entry(): the flagship policy's (mu, std, v) against
    __graft_entry__.entry()'s on the JAX example batch (B = 256, every
    neighbour slot on) with the flax params converted, within 1e-5; the
    port's own example batch has the same shapes and a full mask.
  - dryrun_multichip(2) at the tiny config on two gloo ranks on this CPU
    (a 1 x 2 mesh: tensor-parallel weights): it runs, the metrics are
    finite, and the full-size artifact's path is under runs_torch/, not
    the root multichip_full.json (the TPU's).
  - the full-size comparison's tie rule (shared with chip_smoke.py's
    tensor-parallel phase) on a one-process epoch at the tiny config: the
    epoch's own batch passes with the params equal; a
    batch whose action is one 0.01 step off (and later rewards differ)
    passes the tie test and then fails on the params; two steps off is
    not a tie.
  - bench.detail section 4 (train_split) and its main end to end at a
    tiny size (gen_demo, 4 and 8 lanes, T = 4; only with --world), and env_smoke's lines
    equal to the JAX example's on gen_demo, but for the rewards: a drone's
    angle between its command and its desired velocity lands on pi/2,
    where the float32 angle bucket (-4 or 0) differs between the
    frameworks (ROADMAP C3; in float64 the two trajectories agree over all
    300 steps).
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest

import jax
import torch

from rvo3d_tpu_torch import entry
from rvo3d_tpu_torch.bench import core, detail
from rvo3d_tpu_torch.examples import env_smoke
from rvo3d_tpu_torch.utils.convert import flax_to_state_dict
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_module(relpath, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


def test_entry_matches_graft_entry():
    fn, (params, obs_self, obs_nbr, obs_mask) = jax_module(
        "__graft_entry__.py", "graft_entry").entry()
    ref = jax.jit(fn)(params, obs_self, obs_nbr, obs_mask)
    module, example = entry.entry("cpu")
    assert [tuple(x.shape) for x in example] == [(256, 12), (256, 10, 9), (256, 10)]
    assert example[2].dtype == torch.bool and bool(example[2].all())
    module.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = module(*[torch.from_numpy(np.array(x)) for x in (obs_self, obs_nbr,
                                                               obs_mask)])
    for name, a, b in zip(("mu", "std", "v"), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0, err_msg=name)


def test_entry_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        entry.entry()


def test_dryrun_multichip_two_gloo_ranks():
    out, lines = printed(entry.dryrun_multichip, 2, device="cpu")
    assert out["mesh"] == {"data": 1, "model": 2} and out["backend"] == "gloo"
    assert out["artifact"] is None
    assert lines[0].startswith("dryrun_multichip OK: mesh=(1x2) envs=2 mean_step_reward=")
    assert np.isfinite(float(lines[0].split("mean_step_reward=")[1].split()[0]))
    assert os.path.dirname(entry.ARTIFACT) == os.path.join(REPO, "runs_torch")
    assert entry.ARTIFACT != os.path.join(REPO, "multichip_full.json")


@pytest.fixture(scope="module")
def tiny_epoch():
    """(config, the epoch's starting params, the epoch's record)."""
    cfg = entry.dryrun_config(2, full_size=False)
    trainer = entry._trainer(cfg, torch.device("cpu"))
    start = {k: v.clone() for k, v in trainer.ac.state_dict().items()}
    return cfg, start, entry._run_epoch(trainer)


def test_tie_rule_on_the_same_batch(tiny_epoch):
    cfg, start, rec = tiny_epoch
    assert np.isfinite(rec["metrics"]["mean_step_reward"])
    held = entry.tie_rule(rec["batch"], rec["params"], rec["batch"], start, cfg,
                          torch.device("cpu"))
    assert held["first_action_difference_step"] is None
    assert held["params_max_abs_diff_same_batch"] == 0.0
    assert held["one_update"]["pi_iters"] == np.ravel(rec["metrics"]["pi_iters"]).tolist()


@pytest.mark.parametrize("steps_off,error", [(1, "one-process update"),
                                             (2, "not a 0.01 rounding tie")])
def test_tie_rule_refuses(tiny_epoch, steps_off, error):
    """The ranks' batch parts from the reference at step 2 by one (a tie)
    or two 0.01 steps of an action, and later rewards differ: the update
    on that batch is not the one the recorded params came from."""
    cfg, start, rec = tiny_epoch
    parted = {k: v.clone() for k, v in rec["batch"].items()}
    parted["act"][2, 0, 0, 0] += 0.01 * steps_off
    parted["rew"][3:] += 1.0
    assert entry.rollout_parting(parted, rec["batch"]) == (2, steps_off == 1)
    with pytest.raises(AssertionError, match=error):
        entry.tie_rule(parted, rec["params"], rec["batch"], start, cfg, torch.device("cpu"))


TINY_TAGS = (("E256_reference_schedule", 4, {}),
             ("E4096_minibatch_batched", 8, {"minibatch": 64, "batched_update": True}))


def test_train_split_and_detail_main(monkeypatch, tmp_path):
    """Section 4 runs only with --world (after sections 1-3, stubbed here:
    tests/test_torch_bench.py runs them), at a tiny size."""
    monkeypatch.setattr(detail, "SPLIT_TAGS", TINY_TAGS)
    monkeypatch.setattr(detail, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(core, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(detail, "env_sweep", lambda wd, device: {"2": 1.0})
    monkeypatch.setattr(detail, "policy_rollout", lambda wd, device: 2.0)
    monkeypatch.setattr(detail, "ppo_epoch", lambda wd, device: {
        "ppo_epoch_seconds": 3.0, "ppo_env_steps_per_sec": 4.0})
    real = detail.train_split
    monkeypatch.setattr(detail, "train_split", lambda world, dev: real(
        world, dev, steps_per_epoch=4, train_pi_iters=1, train_v_iters=1))
    sections_1_3 = {"device", "env_only_steps_per_sec", "rollout_policy_steps_per_sec_plain",
                    "rollout_policy_note", "ppo_epoch_seconds", "ppo_env_steps_per_sec"}
    _, lines = printed(detail.main, ["--device", "cpu"])
    assert set(json.loads(lines[-1])) == sections_1_3
    _, lines = printed(detail.main, ["--world", "gen_demo", "--device", "cpu"])
    with open(tmp_path / "bench_details.json") as f:
        res = json.load(f)
    assert json.loads(lines[-1]) == res
    assert set(res) == sections_1_3 | {"gen_demo_E256_reference_schedule",
                                       "gen_demo_E4096_minibatch_batched"}
    for row in (res["gen_demo_E256_reference_schedule"],
                res["gen_demo_E4096_minibatch_batched"]):
        assert row["full_epoch_seconds"] > 0 and row["rollout_seconds"] > 0
        assert row["update_seconds_approx"] == pytest.approx(
            row["full_epoch_seconds"] - row["rollout_seconds"], abs=2e-3)
    assert (tmp_path / "profiles" / "gen_demo_train_epoch" / "trace.json").exists()
    # the JAX script's world, world_2, is a reference fixture this repository lacks
    with pytest.raises(FileNotFoundError, match="world_2"):
        detail.main(["--world", "world_2", "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="world_2"):
        real(device="cpu")


def test_env_smoke_summary_matches_jax(monkeypatch):
    jax_example = jax_module(os.path.join("examples", "env_smoke.py"), "jax_env_smoke")
    monkeypatch.setattr("sys.argv", ["env_smoke.py", "gen_demo"])
    _, ref = printed(jax_example.main)
    _, got = printed(env_smoke.main, ["gen_demo", "--device", "cpu"])
    assert got[-1] == ref[-1]
    assert got[-1].startswith("done: ") and got[-1].endswith("on gen_demo (4 drones)")
    assert [ln.split(" reward=")[0] for ln in got[:-1]] == [
        ln.split(" reward=")[0] for ln in ref[:-1]]
