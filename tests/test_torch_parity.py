"""The port's parity harness (rvo3d_tpu_torch/parity.py) and its own copy
of the NumPy oracle (rvo3d_tpu_torch/env/oracle.py):

  - the oracle copy steps bitwise equal to rvo3d_tpu/env/oracle.py over
    100 scripted steps (with control noise) on gen_demo and world16_dense;
  - run_parity on the CPU passes on both worlds in train, eval and noise
    modes, in float64 (pos and reward within 1e-12, flags exact) and
    float32 (pos 3e-5, reward 6e-3);
  - it fails when the env's positions are perturbed by 1e-9;
  - world16_dense in eval mode reaches a state the reference leaves
    undefined (its asin domain error): the harness reports it on the line;
  - the `parity` command's line has the JAX CLI's format, field for field.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from rvo3d_tpu.env.oracle import OracleEnv as JaxOracle
from rvo3d_tpu.worlds import load_world as jax_load_world
from rvo3d_tpu_torch import cli, parity
from rvo3d_tpu_torch.env.oracle import OracleEnv
from rvo3d_tpu_torch.worlds import load_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = ["gen_demo", "world16_dense"]
NUM = r"[0-9.]+e[-+][0-9]+"
LINE = re.compile(rf"^\[(OK |FAIL)\] (\S+) \[(\w+(?:\+noise)?)\]: (\d+) steps, (\d+) episode "
                  rf"boundaries, max \|pos err\|=({NUM}), max \|reward err\|=({NUM}), "
                  rf"flags (exact|MISMATCH)(.*) \((x64|f32)\)$")


@pytest.mark.parametrize("world", WORLDS)
def test_oracle_copy_is_bitwise_the_jax_oracle(world):
    a = OracleEnv(load_world(world))
    b = JaxOracle(jax_load_world(world))
    obs_a, obs_b = a.reset(), b.reset()
    assert all(np.array_equal(x, y) for x, y in zip(obs_a, obs_b))
    rng = np.random.default_rng(3)
    n = len(a.drones)
    for t in range(100):
        des = np.stack([d.cal_des_vel() for d in a.drones])
        assert np.array_equal(des, np.stack([d.cal_des_vel() for d in b.drones]))
        acts = np.round(des + 0.3 * rng.standard_normal((n, 3)), 2)
        noise = 0.06 * rng.standard_normal((n, 3))
        out_a, out_b = a.step(acts, noise), b.step(acts, noise)
        for x, y in zip(out_a, out_b):
            assert np.array_equal(np.asarray(x, dtype=object), np.asarray(y, dtype=object)), t
        for da, db in zip(a.drones, b.drones):
            assert np.array_equal(da.state, db.state) and np.array_equal(da.vel, db.vel)
        for i, done in enumerate(out_a[2]):
            if done:
                a.reset_one(i), b.reset_one(i)
        if all(out_a[4]):
            a.reset(), b.reset()


@pytest.mark.parametrize("x64", [True, False], ids=["x64", "f32"])
@pytest.mark.parametrize("mode", ["train", "eval", "noise"])
def test_run_parity_passes_on_the_cpu(capsys, x64, mode):
    rc = parity.run_parity(WORLDS, steps=200, x64=x64, env_train=mode != "eval",
                           noise=mode == "noise", device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0, lines
    assert len(lines) == 2 and all(LINE.match(ln).group(1) == "OK " for ln in lines)
    for ln in lines:
        m = LINE.match(ln)
        pos, rew = float(m.group(6)), float(m.group(7))
        assert m.group(8) == "exact"
        if x64:
            assert pos <= 1e-12 and rew <= 1e-12
        else:
            assert pos <= 3e-5 and rew <= 6e-3
    # in eval mode world16_dense reaches a state that the reference leaves
    # undefined (its asin domain error); the line says so
    undefined = "1 step(s) the reference leaves undefined"
    assert (undefined in lines[1]) == (mode == "eval"), lines[1]


def test_a_perturbed_env_fails(capsys, monkeypatch):
    real = parity.step

    def nudged(*a, **k):
        state, out = real(*a, **k)
        return state._replace(pos=state.pos + 1e-9), out
    monkeypatch.setattr(parity, "step", nudged)
    assert parity.run_parity(["gen_demo"], steps=20, x64=True, device="cpu") == 1
    m = LINE.match(capsys.readouterr().out.strip())
    assert m.group(1) == "FAIL" and float(m.group(6)) >= 1e-9


def test_parity_line_matches_the_jax_cli(capsys):
    argv = ["parity", "--worlds", "gen_demo", "--steps", "30", "--noise"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out.strip()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "rvo3d_tpu.cli", "--cpu", *argv],
                          capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    jax_line = proc.stdout.strip().splitlines()[-1]
    pm, jm = LINE.match(port), LINE.match(jax_line)
    assert pm and jm, (port, jax_line)
    # everything but the float32 error magnitudes is the same
    for g in (1, 2, 3, 4, 8, 9, 10):
        assert pm.group(g) == jm.group(g), (g, port, jax_line)
