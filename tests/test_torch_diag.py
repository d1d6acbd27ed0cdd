"""The port's BC and expert diagnostics (rvo3d_tpu_torch/diag/) and the
restored bc_pretrain(on_round=...) against the JAX side's scripts/ and
rvo3d_tpu/algo/bc.py, on the same inputs:

  - on_round: the round indices and losses of JAX's callback, under the
    injected draws of tests/test_torch_bc.py (losses at rtol 1e-4); a
    callback that evaluates the clone leaves the result bit-for-bit as it
    is without one.
  - expert_eval.expert_episode against the script's, float32, both
    controllers on gen_demo and world16_dense: (success, ep_len,
    collided) exact.
  - expert_noise_sweep.sweep_world against the script's on world32_mix:rev
    and world16_dense at 3 lanes, MAX_EP_LEN 20, two margins, fed the JAX
    normals (jax.random.normal(k, [N, 3]) per lane and step, as
    rvo3d_tpu/env/env.py:175-176 draws them): the rows exact.
  - conflict_diag on runs/w32_m3s epoch 5 (restored by the JAX script) and
    the port on the converted asset in a port run directory, world32_mix,
    envs 2, the JAX control-noise draws injected: states and frac_conflict
    exact, the RMS values (unrounded) within 1e-5. Steps 8: the clone's
    unrounded mean is executed, so the two float32 rollouts carry ~1e-7
    differences in position, and with these draws an observed position
    lands on a 2-decimal rounding tie at step 9 that the two frameworks
    break differently (ROADMAP C3); from there the closed loops part, and
    at 20 steps the RMS values differ by 1.8e-5.
  - bc_trace and w3_diag: the JAX scripts' per-step lines with the w32_m3s
    clone (JAX: bc_pretrain replaced by the restored params, or --reuse of
    a pickle of them) against the port's with the converted params, on
    world32_mix: the first steps' lines equal.
  - bc_eval's main against the JAX script's, bc_pretrain and evaluate
    recorded on both sides: the same fit arguments, evaluations and lines.
"""

import contextlib
import functools
import importlib.util
import io
import json
import os
import pickle
import re
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvo3d_tpu.algo import bc as jbc
from rvo3d_tpu.config import EnvParams as JEnvParams
from rvo3d_tpu.utils.heuristic import waypoint_controller as j_waypoint_controller
from rvo3d_tpu.env.rvo_policy import rvo_controller as j_rvo_controller
from rvo3d_tpu.worlds import load_world as j_load_world
from rvo3d_tpu_torch.algo import bc
from rvo3d_tpu_torch.algo.evaluator import evaluate
from rvo3d_tpu_torch.config import EnvParams
from rvo3d_tpu_torch.diag import bc_eval, bc_trace, conflict_diag, expert_eval
from rvo3d_tpu_torch.diag import expert_noise_sweep, w3_diag
from rvo3d_tpu_torch.utils.convert import flax_to_state_dict
from rvo3d_tpu_torch.worlds import load_world
from test_torch_bc import E, N, STEPS, JaxDraws, worlds
from test_torch_product_asset import CONFIG_W32, RUN_W32, restored_jax_product
from test_torch_rollout import policies
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_STEPS = 10     # per-step lines compared (later steps may part at a float32 tie)


def jax_script(name):
    """scripts/<name>.py of the JAX side as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn, *args, **kw):
    """(fn's result, the lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


# ---- bc_pretrain's on_round ----

def test_on_round_matches_jax_and_leaves_the_clone_unchanged():
    jw, tw = worlds()
    jp, tp = JEnvParams(num_drones=N), EnvParams(num_drones=N)
    kw = dict(num_envs=E, demo_steps=STEPS, train_steps=20, batch=64, lr=1e-3,
              expert="rvo", action_mode="direct", explore_std=0.1, expert_margin=0.3,
              dagger_rounds=1)
    key = jax.random.PRNGKey(5)
    jac, params, _ = policies(seed=2)
    j_rounds = []
    jbc.bc_pretrain(jac, params, jw, jp, key,
                    on_round=lambda r, p, loss: j_rounds.append((r, loss)), **kw)

    def injected():
        draws, idx, k = JaxDraws(), {}, key
        for r in range(2):
            k_round, k_train, k = jax.random.split(k, 3)
            draws.add_demo(jax.random.split(k_round)[1], STEPS, (E, N, 3), True, False)
            for s in range(20):
                k_train, ks = jax.random.split(k_train)
                idx[(r, s)] = torch.from_numpy(np.asarray(jax.random.randint(
                    ks, (64,), 0, STEPS * E * N * (r + 1))).astype(np.int64))
        return dict(randn=draws, indices=lambda r, s: idx[(r, s)])

    rounds, evals = [], []

    def on_round(r, ac, loss):
        rounds.append((r, loss))
        evals.append(evaluate(ac, tw, tp, num_episodes=2, num_lanes=2, max_ep_len=10,
                              action_mode="direct")["episodes"])

    _, _, with_cb = policies(seed=2)
    loss = bc.bc_pretrain(with_cb, tw, tp, torch.Generator(), on_round=on_round,
                          **injected(), **kw)
    _, _, without = policies(seed=2)
    loss_plain = bc.bc_pretrain(without, tw, tp, torch.Generator(), **injected(), **kw)
    assert [r for r, _ in rounds] == [r for r, _ in j_rounds] == [0, 1]
    np.testing.assert_allclose([x for _, x in rounds], [x for _, x in j_rounds], rtol=1e-4)
    assert rounds[-1][1] == loss == loss_plain and evals == [2, 2]
    for k, v in without.state_dict().items():
        assert torch.equal(with_cb.state_dict()[k], v), k


# ---- expert_eval ----

@pytest.mark.parametrize("world_name", ["gen_demo", "world16_dense"])
@pytest.mark.parametrize("controller", ["waypoint", "rvo"])
def test_expert_episode_matches_jax(world_name, controller):
    jscript = jax_script("expert_eval")
    wd = j_load_world(world_name)
    jw, jp = wd.spec(), JEnvParams(num_drones=wd.drone_num)
    jctrl = {"waypoint": functools.partial(j_waypoint_controller, world=jw),
             "rvo": lambda st: j_rvo_controller(st, jw, jp)}[controller]
    s, t, c = jax.jit(functools.partial(jscript.expert_episode, jw, jp, jctrl))()
    tw = load_world(world_name).spec(device="cpu")
    tp = EnvParams(num_drones=wd.drone_num)
    ctrl = dict(expert_eval.controllers(tw, tp))[controller]
    assert expert_eval.expert_episode(tw, tp, ctrl) == (bool(s), int(t), bool(c))


# ---- expert_noise_sweep ----

SWEEP_LANES, SWEEP_MARGINS = 2, [0.0, 0.3]


# world16_dense long enough for episodes to end (successes at both margins
# with slowdown, the latch); world32_mix:rev short (a step of its 32 drones
# is the costliest on this CPU)
@pytest.mark.parametrize("world_name,reverse,max_ep_len", [("world32_mix", True, 8),
                                                           ("world16_dense", False, 40)])
def test_sweep_world_matches_jax(world_name, reverse, max_ep_len, monkeypatch):
    jscript = jax_script("expert_noise_sweep")
    for mod in (jscript, expert_noise_sweep):
        monkeypatch.setattr(mod, "LANES", SWEEP_LANES)
        monkeypatch.setattr(mod, "MAX_EP_LEN", max_ep_len)
    n = load_world(world_name).drone_num
    keys = jax.random.split(jax.random.PRNGKey(expert_noise_sweep.NOISE_SEED), SWEEP_LANES)
    noise = np.stack([np.stack([np.asarray(jax.random.normal(k, (n, 3), jnp.float32))
                                for k in jax.random.split(lane, max_ep_len)])
                      for lane in keys], axis=1)                     # [T, L, N, 3]
    jrows, jlines = printed(jscript.sweep_world, world_name, SWEEP_MARGINS,
                            reverse=reverse)
    rows, lines = printed(expert_noise_sweep.sweep_world, world_name, SWEEP_MARGINS,
                          reverse=reverse, device="cpu", noise=torch.from_numpy(noise))
    assert len(rows) == 2 * len(SWEEP_MARGINS)
    assert rows == jrows
    # the printed rows agree up to the seconds each took
    assert [ln.rsplit("(", 1)[0] for ln in lines] == [ln.rsplit("(", 1)[0] for ln in jlines]


# ---- conflict_diag ----

CONFLICT_STEPS = 8

@pytest.fixture(scope="module")
def w32_params():
    if not os.path.isdir(os.path.join(RUN_W32, "ckpt", "5")):
        pytest.skip("runs/w32_m3s checkpoint not present")
    _, params = restored_jax_product(RUN_W32, 5)
    return jax.tree_util.tree_map(np.asarray, params)


def port_run_dir(tmp_path, params):
    """A port run directory holding the w32_m3s clone at epoch 5."""
    run = tmp_path / "w32_m3s"
    (run / "ckpt" / "5").mkdir(parents=True)
    with open(CONFIG_W32) as f:
        cfg = json.load(f)
    with open(run / "config.json", "w") as f:
        json.dump(cfg, f)
    torch.save({"epoch": 5, "params": flax_to_state_dict(params)},
               run / "ckpt" / "5" / "state.pt")
    return str(run)


class _Unrounded(np.ndarray):
    def round(self, decimals=0, out=None):
        return np.asarray(self)


class _NumpyUnrounded:
    """numpy, but np.sqrt's result ignores .round(): the reports' RMS
    values unrounded, so that they can be held at 1e-5."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def sqrt(x):
        return np.sqrt(x).view(_Unrounded)


def unrounded(monkeypatch, module):
    monkeypatch.setattr(module, "np", _NumpyUnrounded())
    monkeypatch.setattr(module, "round", lambda x, n=None: x, raising=False)


def test_conflict_diag_matches_jax(tmp_path, monkeypatch, w32_params):
    jscript = jax_script("conflict_diag")
    unrounded(monkeypatch, jscript)
    unrounded(monkeypatch, conflict_diag)
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["conflict_diag.py", RUN_W32, "world32_mix",
                                      "--envs", "2", "--steps", str(CONFLICT_STEPS),
                                      "--out", str(out)])
    printed(jscript.main)
    with open(out) as f:
        ref = json.load(f)
    n = load_world("world32_mix").drone_num
    draws = JaxDraws()
    draws.add_demo(jax.random.PRNGKey(3), CONFLICT_STEPS, (2, n, 3), False, True)
    got = conflict_diag.conflict_report(port_run_dir(tmp_path, w32_params), "world32_mix",
                                        envs=2, steps=CONFLICT_STEPS, device="cpu",
                                        randn=draws)
    assert not draws.queue
    assert got["states"] == ref["states"] == CONFLICT_STEPS * 2 * n
    assert got["frac_conflict"] == ref["frac_conflict"]     # unrounded too
    assert got["epoch"] == ref["epoch"] == 5
    for k in ("rms_err_conflict", "rms_err_cruise", "rms_label_conflict",
              "rms_err_conflict_all"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)
    assert np.isfinite(got["rms_err_cruise"]).all()


# ---- bc_trace and w3_diag ----

def canonical(line):
    """The line with every number as a float and single spaces: np.round
    prints the sign of a zero, so a value within ~1e-7 of 0 prints '-0.'
    in one framework and '0.' in the other."""
    line = re.sub(r"-?\d+\.?\d*", lambda m: repr(float(m.group()) + 0.0), line)
    return " ".join(line.replace("[", "[ ").split())


def step_lines(lines, steps=TRACE_STEPS):
    """The lines of the first `steps` steps (a step's line starts 't='),
    canonical."""
    starts = [i for i, ln in enumerate(lines) if ln.startswith("t=")]
    end = starts[steps] if len(starts) > steps else len(lines)
    return [canonical(ln) for ln in lines[starts[0]:end]]


def port_clone(params):
    """(policy, world, env params) of bc_trace's setup on world32_mix, the
    policy holding the converted params."""
    ac, world, p = bc_trace.fresh_policy("world32_mix", bc_trace.ModelConfig(), "cpu")
    ac.load_state_dict(flax_to_state_dict(params))
    return ac, world, p


def test_bc_trace_lines_match_jax(monkeypatch, w32_params):
    jscript = jax_script("bc_trace")
    monkeypatch.setattr(jscript, "bc_pretrain", lambda *a, **k: (w32_params, 0.0))
    monkeypatch.setattr(sys, "argv", ["bc_trace.py", "world32_mix"])
    _, ref = printed(jscript.main)
    _, got = printed(bc_trace.trace, *port_clone(w32_params), steps=TRACE_STEPS)
    assert len(step_lines(ref)) >= TRACE_STEPS
    assert step_lines(got) == step_lines(ref)


def test_w3_diag_lines_match_jax(tmp_path, monkeypatch, w32_params):
    jscript = jax_script("w3_diag")
    pkl = tmp_path / "clone.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(w32_params, f)
    monkeypatch.setattr(sys, "argv", ["w3_diag.py", "world32_mix", str(pkl), "--reuse"])
    _, ref = printed(jscript.main)
    # the port's --reuse reads the clone's state dict
    pt = tmp_path / "clone.pt"
    torch.save(flax_to_state_dict(w32_params), pt)
    _, got = printed(w3_diag.main, ["world32_mix", str(pt), "--reuse", "--device", "cpu"])
    assert got[0] == f"reused params from {pt}"
    assert len(step_lines(ref)) >= TRACE_STEPS
    assert step_lines(got) == step_lines(ref)


# ---- bc_eval ----

def test_bc_eval_rounds_and_evaluations(monkeypatch):
    """bc_eval's main against the JAX script's on gen_demo with the same
    arguments: bc_pretrain and evaluate are recorded on both sides, not
    run (tests/test_torch_bc.py and test_torch_eval.py hold them; at the
    script's 32 lanes x 400 demo steps and biGRU-256 they take minutes on
    this CPU, and run on the card in chip_smoke.py's bc_diag). The fits'
    arguments (the framework's params and key aside, their seeds kept),
    the evaluations after each round (on_round) and at the end, and the
    printed lines are equal."""
    argv = ["gen_demo", "rvo", "2", "-1.0", "0.0", "1"]

    def recorder(jax_side):
        fits, calls = [], []

        def fake_bc_pretrain(ac, *args, **kw):
            world, p, key = args[-3:]
            seed = int(np.asarray(key)[-1]) if jax_side else key.initial_seed()
            fits.append({"seed": seed, "num_drones": p.num_drones,
                         "safe_rewards": p.safe_rewards,
                         **{k: v for k, v in kw.items() if k != "on_round"}})
            for r in range(kw["dagger_rounds"] + 1):
                kw["on_round"](r, args[0] if jax_side else ac, 0.25 / (r + 1))
            return (args[0], 0.125) if jax_side else 0.125

        def fake_evaluate(ac, *args, **kw):
            seed = (int(np.asarray(args[-1])[-1]) if jax_side
                    else kw.pop("generator").initial_seed())
            calls.append({"seed": seed, **kw})
            return {"success_rate": 0.5, "mean_ep_len": 12.0, "mean_speed": 0.7}
        return fits, calls, fake_bc_pretrain, fake_evaluate

    jscript = jax_script("bc_eval")
    j_fits, j_calls, j_fit, j_eval = recorder(True)
    monkeypatch.setattr(jscript, "bc_pretrain", j_fit)
    monkeypatch.setattr(jscript, "evaluate", j_eval)
    monkeypatch.setattr(sys, "argv", ["bc_eval.py", *argv])
    _, ref = printed(jscript.main)
    fits, calls, fit, ev = recorder(False)
    monkeypatch.setattr(bc_eval, "bc_pretrain", fit)
    monkeypatch.setattr(bc_eval, "evaluate", ev)
    _, got = printed(bc_eval.main, [*argv, "--device", "cpu"])
    assert len(fits) == 1 and fits == j_fits
    assert [(c["num_episodes"], c["std_factor"]) for c in calls] == [
        (8, 1e-3), (8, 1e-3), (100, 1e-3), (100, 1.0)]
    assert calls == j_calls
    assert len(got) == 5 and got == ref
